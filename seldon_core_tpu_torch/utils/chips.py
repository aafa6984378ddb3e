"""Card spec table — advertised peaks of the cards the port runs on.

The port's counterpart of ``seldon_core_tpu/utils/chips.py``, with the
same API: ``chip_peak_tflops`` and ``chip_peak_hbm_gbs`` each return
``(peak, assumed)`` for a device-kind string, matched by substring.  The
runtime performance observatory (``utils/perf.py``) and the generation
lane's served-efficiency figures (``utils/genperf.py``) divide by these.

Values are NVIDIA's H100 datasheet figures, dense (not sparse) bf16
tensor-core throughput and HBM bandwidth.  ``torch.cuda.get_device_name``
of an SXM card reads "NVIDIA H100 80GB HBM3"; the more specific kinds
("H100 PCIe", "H100 NVL") come first so they match before the bare
"H100".  An unknown kind (the CPU, another card) falls back to the JAX
package's conservative default, flagged ``assumed`` so downstream figures
are labelled as such rather than wrong.
"""

from __future__ import annotations

from typing import Tuple

__all__ = [
    "PEAK_BF16_TFLOPS",
    "PEAK_HBM_GBS",
    "chip_peak_tflops",
    "chip_peak_hbm_gbs",
]

#: advertised peak dense bf16 tensor-core throughput per card, TFLOP/s
#: (device-kind substring -> peak, the more specific kinds first)
PEAK_BF16_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.0),
)

#: advertised HBM bandwidth per card, GB/s — the memory side of the
#: roofline.  Decode-shaped dispatches are bound by this, not by FLOPs.
PEAK_HBM_GBS = (
    ("h100 pcie", 2000.0),
    ("h100 nvl", 3900.0),
    ("h100", 3350.0),
)

#: the defaults used when the device kind matches no table row (the JAX
#: package's, kept so both packages report the same figures for an
#: unknown kind) — always flagged assumed by the lookup helpers
_DEFAULT_TFLOPS = 197.0
_DEFAULT_HBM_GBS = 819.0


def _lookup(table, device_kind: str, default: float) -> Tuple[float, bool]:
    dk = (device_kind or "").lower()
    for frag, peak in table:
        if frag in dk:
            return peak, False
    return default, True  # conservative default, flagged as assumed


def chip_peak_tflops(device_kind: str) -> Tuple[float, bool]:
    """(peak dense bf16 TFLOP/s, assumed?) for a device kind string."""
    return _lookup(PEAK_BF16_TFLOPS, device_kind, _DEFAULT_TFLOPS)


def chip_peak_hbm_gbs(device_kind: str) -> Tuple[float, bool]:
    """(peak HBM GB/s, assumed?) for a device kind string."""
    return _lookup(PEAK_HBM_GBS, device_kind, _DEFAULT_HBM_GBS)
