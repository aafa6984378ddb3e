#!/usr/bin/env python3
"""Time flash_decode_paged beside an earlier design of it, in turns, on one
NVIDIA card.

    git show 666a662:seldon_core_tpu_torch/ops/csrc/flash_decode.cu \\
        > build/dev/flash_decode_table_split.cu
    python3 paged_decode_turns.py build/dev/flash_decode_table_split.cu

The earlier source is the flash-decode library of commit 666a662, whose
``flash_decode_paged_launch`` splits the table's width over a cluster
(CUDA cores, a bulk-copy ring) and takes the decode step's write as a
separate ``kv_write_paged`` launch.  This script builds it with the
port's nvcc flags into ``build/dev/``, then, on the inputs of
``chip_smoke.py`` (``paged_sets``: cold L2), at the served round (B=32,
560 positions a row over 64 blocks of 16), one row, and the ragged batch
(lengths 1, 17, 300, 560, 1009), times in turns (earlier, present,
present, earlier) the attention alone and the decode step (the earlier
design's write launch plus its attention against the present fused
call), after holding both designs' answers to each other within
``FLASH_O_ATOL``.  It prints the card, one line per measurement and a
final JSON object.  It imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build_earlier(source: Path) -> ctypes.CDLL:
    from seldon_core_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "dev" / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {source.name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.flash_decode_paged_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1]).is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("paged_decode_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build, flash_decode as fd, kv_write as kw

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all(["flash_decode_paged", "kv_write"])
    for line in _build.BUILD_INFO["flash_decode_paged"]["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] flash_decode_paged.cu: {line.strip()}", flush=True)
    lib = build_earlier(Path(sys.argv[1]).resolve())
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def earlier(q, pk, pv, t, lens, *_):
        """The earlier design's attention: its split of the table's width."""
        B, KV, G, hd = q.shape
        N, _, bs, _ = pk.shape
        o = torch.empty_like(q)
        split, span = fd.decode_split_plan(B, KV, G, t.shape[1] * bs, sm_count)
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *pk.stride()[:3], *pv.stride()[:3])
        rc = lib.flash_decode_paged_launch(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), t.data_ptr(), lens.data_ptr(), N,
            t.shape[1], bs, o.data_ptr(), B, KV, G, hd, split, span, ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the earlier kernel's launch failed: CUDA error {rc}")
        return o

    cases = [(B, KV, G, hd, nblk, [n] * B) for B, KV, G, hd, nblk, n in cs.PAGED_TIMED]
    cases.append((len(cs.PAGED_RAGGED), 4, 4, 64, cs.PAGED_NBLK, cs.PAGED_RAGGED))
    rows = []
    for B, KV, G, hd, nblk, lens in cases:
        sets = cs.paged_sets(torch, B, KV, G, hd, nblk, lens, dev, cs.SEED + 16)
        attend = [x[:5] for x in sets]
        q, pk, pv, t, ln = attend[0]
        err = float((earlier(q, pk, pv, t, ln).float()
                     - fd.flash_decode_paged(q, pk, pv, t, ln).float()).abs().max())
        if err > cs.FLASH_O_ATOL:
            raise AssertionError(f"the designs disagree at B={B}: {err:.3e}")
        ones = torch.ones(B, 1, dtype=torch.bool, device=dev)

        def earlier_step(q, pk, pv, t, ln, kn, vn, start):
            kw.kv_write_paged(pk, pv, kn, vn, t, start, ones)
            return earlier(q, pk, pv, t, ln)

        steps = [(*x, x[4] - 1) for x in sets]
        fns = {"earlier": (attend, earlier), "present": (attend, fd.flash_decode_paged),
               "earlier_step": (steps, earlier_step),
               "present_fused": (sets, fd.flash_decode_paged)}
        ms = {k: [] for k in fns}
        for a, b in (("earlier", "present"), ("earlier_step", "present_fused")):
            for name in (a, b, b, a):
                data, fn = fns[name]
                ms[name].append(cs.device_ms(torch, cs.rotating(data, fn), 200))
        bound, _ = cs.paged_decode_bound(B, KV, G, hd, nblk, lens)
        row = {"B": B, "lens": lens if len(set(lens)) > 1 else lens[0], "max_abs_diff": err,
               "bound_ms": bound, **{f"{k}_ms": v for k, v in ms.items()}}
        rows.append(row)
        print(f"[turns] B={B} lengths {row['lens']}: attention earlier {ms['earlier']} ms, "
              f"present {ms['present']} ms; the decode step (write + attention) earlier "
              f"{ms['earlier_step']} ms, present fused {ms['present_fused']} ms; bound "
              f"{bound:.6f} ms; answers within {err:.3e} on {smi}", flush=True)
        del sets, attend, steps
    print(json.dumps({"card": smi, "turns": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
