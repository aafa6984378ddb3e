#!/usr/bin/env python3
"""Time flash_decode_paged's float32 path beside an earlier design of it, in
turns, on one NVIDIA card.

    git show f79eec8:seldon_core_tpu_torch/ops/csrc/flash_decode_paged.cu \\
        > build/dev/flash_decode_paged_f79eec8.cu
    python3 paged_f32_turns.py build/dev/flash_decode_paged_f79eec8.cu

The earlier source is the paged decode library of commit f79eec8, whose
float32 walk takes one position a lane, 32 a warp, and loads each
position's V row from global memory inside its PV loop.  Its C interface
is the present one, so this script builds it with the port's nvcc flags
into ``build/dev/`` and runs it through the present wrapper
(``flash_decode_paged``) by swapping the wrapper's library.  On the inputs
of ``chip_smoke.py`` (``paged_sets`` in float32: cold L2) at the draft's
head shape (2 kv heads of hd 32, one query head each, pool blocks of 16),
for B in (32, 1) and n in (64, 512, 2048) positions a row, it holds both
designs' answers to each other within ``chip_smoke.F32_O_ATOL`` (unfused
and with the step's write fused in), then times each design in turns
(earlier, present, present, earlier), unfused and fused, beside the
call's byte bound.  Then it times the present design at each cluster size
(1, 2, 4, 8) at the same shapes, also with every row's length 0 (nothing
walked: the launch, the length's load and the combine), and serves
``examples/speculative_deployment.json`` (float32; its draft steps take
this path) on the continuous lane with each design in turns: the 32-row
24-token request's tokens/s.  It prints the card, one line per
measurement and a final JSON object.  It imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SWEEP_B = (32, 1)
SWEEP_N = (64, 512, 2048)
SPLITS = (1, 2, 4, 8)
ITERS = 200               # launches a device time is read over
EXAMPLE_WALLS = 3         # walls of the example's request a turn (after one warm-up)


def build_earlier(source: Path) -> SimpleNamespace:
    """The earlier library's entry points, bound as ``_paged_library`` binds
    the present one."""
    from seldon_core_tpu_torch.ops._build import CSRC, NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "dev" / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    # its flash_common.cuh is the checkout's (the header is unchanged since)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    launch = lib.flash_decode_paged_launch
    launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    smem = lib.flash_decode_paged_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
    smem.restype = ctypes.c_int
    err = lib.flash_decode_paged_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return SimpleNamespace(launch=launch, smem_bytes=smem, error_string=err)


def f32_sets(torch, cs, B: int, n: int, dev, seed: int):
    """``chip_smoke.paged_sets`` at the draft's head shape in float32, with
    a table wide enough for n positions; returns (nblk, sets)."""
    nblk = max(cs.PAGED_NBLK, -(-n // cs.PAGED_BS))
    sets = [tuple(t.float() if t.is_floating_point() else t for t in x)
            for x in cs.paged_sets(torch, B, 2, 1, 32, nblk, [n] * B, dev, seed)]
    return nblk, sets


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1]).is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("paged_f32_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import numpy as np
    from seldon_core_tpu_torch.ops import _build, flash_decode as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all(["flash_decode_paged", "kv_write"])
    for line in _build.BUILD_INFO["flash_decode_paged"]["ptxas"].splitlines():
        if "f32" in line or "registers" in line or "spill" in line:
            print(f"[build] flash_decode_paged.cu: {line.strip()}", flush=True)
    libs = {"earlier": build_earlier(Path(sys.argv[1]).resolve()),
            "present": fd._paged_library()}

    def on(name):
        def call(*args):
            fd._paged_lib = libs[name]
            return fd.flash_decode_paged(*args)
        return call

    rows = []
    for B in SWEEP_B:
        for n in SWEEP_N:
            nblk, sets = f32_sets(torch, cs, B, n, dev, cs.SEED + 40)
            attend = [x[:5] for x in sets]
            q, pk, pv, t, ln, kn, vn = sets[0]
            diff = float((on("earlier")(q, pk, pv, t, ln) - on("present")(q, pk, pv, t, ln))
                         .abs().max())
            pools = [(pk.clone(), pv.clone()) for _ in range(2)]
            fused = [on(name)(q, *pools[i], t, ln, kn, vn)
                     for i, name in enumerate(("earlier", "present"))]
            fdiff = float((fused[0] - fused[1]).abs().max())
            if max(diff, fdiff) > cs.F32_O_ATOL or not all(
                    torch.equal(pools[0][i], pools[1][i]) for i in (0, 1)):
                raise AssertionError(f"the designs disagree at B={B}, n={n}: {diff:.3e}, fused "
                                     f"{fdiff:.3e}, or their writes differ")
            ms = {k: [] for k in ("earlier", "present", "earlier_fused", "present_fused")}
            for a, b, data in (("earlier", "present", attend),
                               ("earlier_fused", "present_fused", sets)):
                for name in (a, b, b, a):
                    fn = on(name.split("_")[0])
                    ms[name].append(cs.device_ms(torch, cs.rotating(data, fn), ITERS))
            bound, by = cs.paged_decode_bound(B, 2, 1, 32, nblk, [n] * B, elt=4,
                                              peak=cs.F32_FLOPS)
            fbound, _ = cs.paged_decode_bound(B, 2, 1, 32, nblk, [n] * B, fused=True, elt=4,
                                              peak=cs.F32_FLOPS)
            fd._paged_lib = libs["present"]
            split = fd.paged_cluster(B, 2, 1, nblk * cs.PAGED_BS,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
            by_split, floor = {}, {}
            empty = [(q, pk, pv, t, torch.zeros_like(ln)) for q, pk, pv, t, ln in attend]
            plan = fd.paged_cluster
            try:
                for C in SPLITS:
                    fd.paged_cluster = lambda *_a, _c=C: _c
                    by_split[C] = cs.device_ms(torch, cs.rotating(attend, fd.flash_decode_paged),
                                               ITERS)
                    floor[C] = cs.device_ms(torch, cs.rotating(empty, fd.flash_decode_paged),
                                            ITERS)
            finally:
                fd.paged_cluster = plan
            row = {"B": B, "n": n, "nblk": nblk, "cluster": split, "input_sets": len(sets),
                   "max_abs_diff": max(diff, fdiff), "bound_ms": bound, "bound_by": by,
                   "fused_bound_ms": fbound, **{f"{k}_ms": v for k, v in ms.items()},
                   "present_ms_by_cluster": by_split, "empty_rows_ms_by_cluster": floor}
            rows.append(row)
            print(f"[turns] flash_decode_paged float32 (B,KV,G,hd)=({B},2,1,32), n={n}, "
                  f"{nblk} table blocks, cold L2 ({len(sets)} input sets), a cluster of {split}: "
                  f"earlier {ms['earlier']} ms, present {ms['present']} ms; fused earlier "
                  f"{ms['earlier_fused']} ms, present {ms['present_fused']} ms; bound "
                  f"{bound:.6f} ms ({by}), fused {fbound:.6f} ms; the present design by cluster "
                  f"size {by_split}, with every row empty {floor}; answers within "
                  f"{max(diff, fdiff):.3e} on {smi}", flush=True)
            del sets, attend, pools, fused, empty

    # the float32 speculative example's 32-row request, each design in turns
    doc = cs.example_doc("speculative")
    fd._paged_lib = libs["present"]
    engine = cs.mode_engine(torch, dev, doc, continuous=True)
    unit = engine.compiled.units["gen"]
    rng = np.random.default_rng(cs.SEED + 61)
    p32 = rng.integers(0, unit.target_cfg.vocab, size=(cs.GEN_B, cs.SPEC_EX_P))
    server = cs.ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    walls = {"earlier": [], "present": []}
    answers = {}
    try:
        for name in ("earlier", "present", "present", "earlier"):
            fd._paged_lib = libs[name]  # the lane is idle between requests
            fd.PAGED_F32_LAUNCHES = 0
            got = []
            for i in range(EXAMPLE_WALLS + 1):  # the first is the warm-up
                t0 = time.perf_counter()
                status, raw = cs.request("POST", url, cs.ndarray(p32))
                if i:
                    got.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"the example answered {status}: {raw[:200]!r}")
                answers[name] = np.asarray(json.loads(raw)["data"]["ndarray"])
            if fd.PAGED_F32_LAUNCHES == 0:
                raise AssertionError("the example's draft steps did not take the float32 path")
            walls[name].append(float(np.median(got)))
    finally:
        server.stop()
        fd._paged_lib = libs["present"]
    new = unit.max_new_tokens
    tok_s = {k: [cs.GEN_B * new / w for w in v] for k, v in walls.items()}
    same = int((answers["earlier"] == answers["present"]).sum())
    example = {"rows": cs.GEN_B, "prompt": cs.SPEC_EX_P, "new_tokens": new,
               "walls_a_turn": EXAMPLE_WALLS, "tokens_per_s": tok_s,
               "p50_ms": {k: [w * 1e3 for w in v] for k, v in walls.items()},
               "same_tokens": same, "tokens": int(answers["present"].size)}
    print(f"[turns] examples/speculative_deployment.json, the 32-row {cs.SPEC_EX_P}-token "
          f"request ({new} new tokens), p50 of {EXAMPLE_WALLS} walls a turn: earlier "
          f"{tok_s['earlier']} tokens/s, present {tok_s['present']} tokens/s; {same} of "
          f"{answers['present'].size} tokens the same under both designs on {smi}", flush=True)
    print(json.dumps({"card": smi, "turns": rows, "example": example}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
