#!/usr/bin/env python3
"""Time fused_mlp_softmax beside an earlier design of it, in turns, on one
NVIDIA card.

    git show 30a1d89:seldon_core_tpu_torch/ops/csrc/fused_mlp.cu \\
        > build/dev/fused_mlp_30a1d89.cu
    python3 mlp_turns.py build/dev/fused_mlp_30a1d89.cu

The earlier source is the fused-MLP library of commit 30a1d89: one block
per 32 batch rows, all the weights streamed through one 64-row stage of
shared memory, WMMA products.  This script builds it with the port's nvcc
flags into ``build/dev/``, holds both designs' answers to each other
within ``chip_smoke.KERNEL_ATOL`` at the served 784-256-256-10 stack, then
times them in turns (earlier, present, present, earlier) at B = 1, 32, 64
and 1024 with the weights warm in L2, and at B = 1 rotating over 256 MiB
of weight copies (cold L2, as a request finds them after other work).  It
prints the card, one line per batch and a final JSON object.
``chip_smoke.py`` runs the same turns in its phase 5 when the earlier
source is at ``EARLIER`` (or ``git`` can write it there).  It imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EARLIER_COMMIT = "30a1d89"
EARLIER = ROOT / "build" / "dev" / f"fused_mlp_{EARLIER_COMMIT}.cu"
TIMED_B = (1, 32, 64, 1024)
COLD_BYTES = 256 * 2**20


def earlier_source() -> Path | None:
    """``EARLIER``, written from git when the checkout has its history and
    the file is not there yet; None when neither gives it."""
    if not EARLIER.is_file():
        try:
            text = subprocess.run(
                ["git", "-C", str(ROOT), "show",
                 f"{EARLIER_COMMIT}:seldon_core_tpu_torch/ops/csrc/fused_mlp.cu"],
                capture_output=True, text=True, timeout=60, check=True).stdout
        except (OSError, subprocess.SubprocessError):
            return None
        EARLIER.parent.mkdir(parents=True, exist_ok=True)
        EARLIER.write_text(text)
    return EARLIER


def build_earlier(source: Path):
    """The earlier library's launch function, built with the port's flags."""
    from seldon_core_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "dev" / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).fused_mlp_softmax_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def turns(torch, dev, smi: str, source: Path, log=print) -> dict:
    """The turns of the module docstring; returns {"warm": [...], "cold":
    {...}} with each design's times (ms, four turns each: ABBA twice)."""
    import chip_smoke as cs
    from seldon_core_tpu_torch.models.mnist import mlp_init
    from seldon_core_tpu_torch.ops import fused_mlp as fm

    launch = build_earlier(source)
    dims = (784, 256, 256, 10)
    gen = torch.Generator().manual_seed(cs.SEED + 20)

    def earlier(params, x):
        layers = fm._layer_params(params)
        out = torch.empty(x.shape[0], dims[-1], dtype=torch.float32, device=dev)
        dims_arr = (ctypes.c_int * 4)(*dims)
        w_arr = (ctypes.c_void_p * 3)(*[w.data_ptr() for w, _ in layers])
        b_arr = (ctypes.c_void_p * 3)(*[b.data_ptr() for _, b in layers])
        rc = launch(x.data_ptr(), out.data_ptr(), x.shape[0], 3, ctypes.addressof(dims_arr),
                    ctypes.addressof(w_arr), ctypes.addressof(b_arr),
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier kernel's launch failed: CUDA error {rc}")
        return out

    params = cs.random_params(torch, mlp_init, 256, gen, dev)
    fns = {"earlier": earlier, "present": fm.fused_mlp_softmax}
    rows = []
    for B in TIMED_B:
        x = torch.rand(B, 784, generator=gen).to(dev)
        diff = float((earlier(params, x) - fm.fused_mlp_softmax(params, x)).abs().max())
        if diff > cs.KERNEL_ATOL:
            raise AssertionError(f"the designs disagree at B={B}: {diff:.3e}")
        ms = {k: [] for k in fns}
        for _ in range(2):
            for name in ("earlier", "present", "present", "earlier"):
                ms[name].append(cs.device_ms(torch, lambda: fns[name](params, x), 300))
        rows.append({"B": B, "max_abs_diff": diff, **{f"{k}_ms": v for k, v in ms.items()}})
        log(f"[turns] fused MLP 784-256-256-10 B={B}, warm: earlier {ms['earlier']} ms, "
            f"present {ms['present']} ms; answers within {diff:.3e} on {smi}")
    per_set = sum(t.numel() * t.element_size() for t in params.values())
    sets = [{k: v.clone() for k, v in params.items()} for _ in range(-(-COLD_BYTES // per_set))]
    x = torch.rand(1, 784, generator=gen).to(dev)
    cold = {k: [] for k in fns}
    for name in ("earlier", "present", "present", "earlier"):
        cold[name].append(cs.device_ms(
            torch, cs.rotating([(p, x) for p in sets], fns[name]), 2 * len(sets)))
    log(f"[turns] fused MLP 784-256-256-10 B=1, cold L2 ({len(sets)} weight sets): earlier "
        f"{cold['earlier']} ms, present {cold['present']} ms on {smi}")
    return {"warm": rows, "cold": {"B": 1, "weight_sets": len(sets),
                                   **{f"{k}_ms": v for k, v in cold.items()}}}


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1]).is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("mlp_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all(["fused_mlp"])
    out = turns(torch, torch.device("cuda"), smi, Path(sys.argv[1]).resolve(),
                log=lambda m: print(m, flush=True))
    print(json.dumps({"card": smi, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
