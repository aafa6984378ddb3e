"""LM layer matmuls — the dense half of ``seldon_core_tpu/ops/quant.py``.

``lm_matmul`` (``quant.py:149-162``) is ``h @ w`` cast to ``out_dtype``.
The JAX package also serves layers quantized by ``quantize_lm_params``
(``{name}_q`` int8 weights with ``{name}_s`` scales, weight-only W8A16);
the port has not ported that path yet and refuses such a layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["lm_matmul"]


def lm_matmul(lp: Dict[str, torch.Tensor], name: str, h: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``h @ lp[name]``, cast to ``out_dtype`` when given.  In the weights'
    dtype, as XLA computes it: a bf16 product is rounded to bf16."""
    if f"{name}_q" in lp:
        raise ValueError(
            f"layer weight {name!r} is int8-quantized ({name}_q / {name}_s); the "
            f"port serves dense weights only (int8 LM quantization: ROADMAP "
            f"Queue 1 item [2q])"
        )
    y = h @ lp[name]
    if out_dtype is not None and y.dtype != out_dtype:
        y = y.to(out_dtype)
    return y
