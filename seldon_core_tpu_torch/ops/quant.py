"""Int8 post-training quantization for the serving path — the port of
``seldon_core_tpu/ops/quant.py``.

  * ``quantize_weight``: symmetric per-output-channel int8 weights with f32
    scales (no zero points), computed in host numpy at load time, as the
    reference does: its output is the reference's, bit for bit, on the
    same array.
  * ``dequant_matmul``: weight-only int8 ("W8A16"), the serving path.  The
    bf16 operands (int8 codes are exact in bf16) multiply exactly and
    accumulate in f32; the f32 per-channel scale multiplies the f32
    output, which is cast to ``out_dtype`` once.  The reference leaves this
    product to XLA, outside any Pallas kernel, so the port leaves it to
    PyTorch: on CUDA one ``torch.mm(..., out_dtype=torch.float32)``
    (``aten::mm.dtype``, bf16 in, f32 out), on the CPU the same products
    in f32.  ``chip_smoke.py`` times it against the dense bf16 matmul.
  * ``quant_matmul``: the W8A8 formulation (dynamic per-row activation
    quantization, int8 x int8 -> int32), kept for completeness as the
    reference keeps it; on no served path.  The integer product runs in
    float64, exact for any sum below 2^53, on both devices.
  * ``quantize_mlp_params`` / ``QuantizedMLP``: the dense-MLP layout
    (``models/mnist.py``) quantized once at load, served through
    ``dequant_matmul``.
  * ``quantize_lm_params`` / ``lm_matmul``: the transformer layers'
    ``wqkv``, ``wo``, ``w1`` and ``w2`` as ``{name}_q`` int8 plus
    ``{name}_s`` f32 scales; embed, unembed and the norms stay.
    ``lm_matmul`` takes ``dequant_matmul`` for a quantized weight and the
    dense product otherwise.

Serving only: int8 weights are not differentiable, and ``lm_train_step``
refuses ``quant="int8"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["quantize_weight", "quant_matmul", "dequant_matmul", "quantize_mlp_params",
           "QuantizedMLP", "quantize_lm_params", "lm_matmul", "LM_QUANT_NAMES"]

#: transformer-layer weights that quantize (``models/transformer.py`` layout)
LM_QUANT_NAMES = ("wqkv", "wo", "w1", "w2")


def _host_f32(w) -> np.ndarray:
    """A weight as float32 numpy on the host: a tensor from any device (its
    values exactly: bf16 and f16 widen to f32 without rounding), or an
    array (a bf16 one from ``ml_dtypes`` by its bit pattern)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    a = np.asarray(w)
    if a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, dtype=np.float32)


def quantize_weight(w, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] -> (w_q int8 [in, out], scales f32 [out]) on ``device``
    (default: w's own, or the CPU for an array).  Symmetric per output
    channel: scale = max(absmax, 1e-12) / 127, w_q = clip(round(w / scale),
    -127, 127), all in host numpy, as ``quant.py:40``."""
    if device is None:
        device = w.device if isinstance(w, torch.Tensor) else "cpu"
    w_np = _host_f32(w)
    absmax = np.abs(w_np).max(axis=0)
    scales = np.maximum(absmax, 1e-12) / 127.0
    w_q = np.clip(np.round(w_np / scales), -127, 127).astype(np.int8)
    return (torch.from_numpy(w_q).to(device),
            torch.from_numpy(scales.astype(np.float32)).to(device))


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scales: torch.Tensor) -> torch.Tensor:
    """x [..., in] (float) @ int8 weights -> f32 [..., out], the W8A8
    formulation (``quant.py:58``): each row of x quantized by its absmax,
    the integer product exact (float64: |sum| <= in * 127^2 < 2^53), cast
    to f32 as the reference casts its int32, times the row scale and the
    channel scale."""
    lead = x.shape[:-1]
    x32 = x.reshape(-1, x.shape[-1]).float()
    absmax = x32.abs().amax(dim=1, keepdim=True)
    # a 0-dim tensor divisor: CUDA torch multiplies by a Python number's reciprocal
    row_scales = torch.clamp_min(absmax, 1e-12) / absmax.new_full((), 127.0)
    x_q = torch.clamp(torch.round(x32 / row_scales), -127, 127)
    acc = torch.matmul(x_q.double(), w_q.double())
    y = acc.float() * row_scales * w_scales[None, :]
    return y.reshape(*lead, w_q.shape[1])


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N], half-precision operands, f32 accumulation and
    output on CUDA (``aten::mm.dtype``; raises where this torch lacks it)."""
    if not hasattr(torch.ops.aten.mm, "dtype"):
        raise RuntimeError("dequant_matmul on CUDA needs aten::mm.dtype (torch.mm with "
                           "out_dtype); this torch has no such overload")
    return torch.mm(a, b, out_dtype=torch.float32)


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scales: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight-only int8 (W8A16), ``quant.py:78``: x [..., in] @ w_q [in,
    out] -> [..., out].  The operands in x's dtype where that is bf16 or
    f16, else bf16 (x rounds to it, as the reference casts); their products
    exact and summed in f32; times the f32 per-channel scales on the f32
    output; cast to ``out_dtype`` once when given (else f32).  A rank-1 x
    gives a rank-1 result."""
    ct = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else torch.bfloat16
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    if x.device.type == "cuda":
        y = _mm_f32_out(x2, w_q.to(ct))
    else:
        y = torch.matmul(x2.float(), w_q.float())
    y = (y * w_scales).reshape(*lead, w_q.shape[1])
    return y.to(out_dtype) if out_dtype is not None else y


def quantize_mlp_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """``models/mnist.py`` MLP layout {w0, b0, ..., wL, bL} -> {w0_q, w0_s,
    b0, ...}; biases stay, as f32 (``quant.py:102``)."""
    out: Dict[str, Any] = {}
    for i in range(len(params) // 2):
        out[f"w{i}_q"], out[f"w{i}_s"] = quantize_weight(params[f"w{i}"])
        out[f"b{i}"] = params[f"b{i}"].float()
    return out


def quantize_lm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """``lm_init`` tree -> its int8 serving variant (``quant.py:122``): in
    each layer, every weight named in ``LM_QUANT_NAMES`` becomes ``{name}_q``
    and ``{name}_s``; everything else passes through."""
    out: Dict[str, Any] = {}
    for key, val in params.items():
        if not (isinstance(val, dict) and "wqkv" in val):
            out[key] = val
            continue
        lp: Dict[str, Any] = {}
        for name, w in val.items():
            if name in LM_QUANT_NAMES:
                lp[f"{name}_q"], lp[f"{name}_s"] = quantize_weight(w)
            else:
                lp[name] = w
        out[key] = lp
    return out


def lm_matmul(lp: Dict[str, torch.Tensor], name: str, h: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``h @ lp[name]`` (``quant.py:149``): a layer quantized by
    ``quantize_lm_params`` (``{name}_q`` / ``{name}_s``) takes
    ``dequant_matmul``; a dense one the product in the weights' dtype, as
    XLA computes it (a bf16 product is rounded to bf16), cast to
    ``out_dtype`` when given."""
    if f"{name}_q" in lp:
        return dequant_matmul(h, lp[f"{name}_q"], lp[f"{name}_s"], out_dtype=out_dtype)
    y = h @ lp[name]
    if out_dtype is not None and y.dtype != out_dtype:
        y = y.to(out_dtype)
    return y


class QuantizedMLP:
    """The int8 forward of the dense-MLP layout (``quant.py:165``): relu
    hidden layers, an f32 softmax head, every layer ``dequant_matmul`` plus
    its f32 bias."""

    @staticmethod
    def apply(qparams: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        n_layers = len(qparams) // 3
        h = x
        for i in range(n_layers):
            h = dequant_matmul(h, qparams[f"w{i}_q"], qparams[f"w{i}_s"]) + qparams[f"b{i}"]
            if i < n_layers - 1:
                h = torch.clamp_min(h, 0.0)
        return torch.softmax(h, dim=-1)
