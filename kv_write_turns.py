#!/usr/bin/env python3
"""Time kv_write_paged's two kernels (the bf16 copy and the int8 variant)
beside an earlier design of both, in turns, on one NVIDIA card.

    mkdir -p build/dev/kv_write_14c1eac
    for f in kv_write.cu kv_int8.cuh; do
      git show 14c1eac:seldon_core_tpu_torch/ops/csrc/$f > build/dev/kv_write_14c1eac/$f; done
    python3 kv_write_turns.py build/dev/kv_write_14c1eac/kv_write.cu

The earlier source is the kv_write library of commit 14c1eac, whose paged
kernels take one thread per 16-byte unit of K or of V (a lane group per
row for int8, K then V), divide 64-bit indices by runtime counts and
resolve each thread's slot before loading its source.  Its C interfaces
are the present ones, so this script builds it with the port's nvcc flags
into ``build/dev/`` (its own ``kv_int8.cuh`` beside it) and runs it through
the present wrapper by swapping ``kv_write._lib`` (a chip copy has no
``.git``: write the files before the call).

On ``chip_smoke.py``'s checked inputs (``KV_PAGED_CASES`` and
``I8_KV_CASES`` through ``kv_write.paged_write_inputs``) it holds both
designs bit for bit to each other and to the plain version (outside the
scratch block).  Then it times each design in turns (earlier, present,
present, earlier) with ``chip_smoke.device_ms`` at B=32 rows into pools of
2,049 blocks of 16: bf16 at (KV, hd, W) = (4, 64, 128), (4, 64, 512), (16,
64, 5) and (8, 32, 128), float32 at the speculative example's verify (4,
32, 5), the int8 variant quantizing and copying at (4, 64, 128) and (4,
64, 512); beside each, an empty kernel at the present plan's grid (the
floor) and the byte bound.  From ``cuobjdump -sass`` it counts each paged
write kernel's calls to the 64-bit integer division and remainder
routines and its integer divisions' reciprocal steps (``I2F.*.RP``), and
its conversions (``FRND``, ``F2I``) and ``MUFU`` steps, for both designs.  Last it serves the self-draft speculative 32-row request
(``chip_smoke.spec_deployment(True)``, the most W=5 verifies) with each
design in turns: tokens/s and the verifies' launches.  It prints the card,
one line per measurement and a final JSON object.  It imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
B, NBLK = 32, 64
ITERS = 200
# (label, KV, hd, W, dtype name, int8 mode): the timed writes
TIMED = [("bf16", 4, 64, 128, "bf16", None), ("bf16", 4, 64, 512, "bf16", None),
         ("bf16", 16, 64, 5, "bf16", None), ("bf16", 8, 32, 128, "bf16", None),
         ("f32", 4, 32, 5, "f32", None), ("int8 quantize", 4, 64, 128, "bf16", "quantize"),
         ("int8 quantize", 4, 64, 512, "bf16", "quantize"),
         ("int8 copy", 4, 64, 128, "int8", "copy"), ("int8 copy", 4, 64, 512, "int8", "copy")]
SERVE_TURNS = 2   # ABBA turns of the served request (4 walls a design)


def build_earlier(source: Path) -> tuple:
    """nvcc of the earlier source with the port's flags into build/dev/: the
    library's path and ptxas's report."""
    from seldon_core_tpu_torch.ops._build import CSRC, NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "dev" / f"lib{source.stem}_earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return str(out), proc.stderr


def bind(path: str) -> SimpleNamespace:
    """The library's entry points, bound as ``kv_write._library`` binds them."""
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    launch = lib.kv_write_launch
    launch.argtypes = [P] * 4 + [I] * 3 + [ctypes.c_longlong, P, I, P]
    paged = lib.kv_write_paged_launch
    paged.argtypes = [P] * 7 + [I] * 7 + [P, I, P]
    paged_i8 = lib.kv_write_paged_i8_launch
    paged_i8.argtypes = [P] * 11 + [I] * 7 + [P, P]
    for f in (launch, paged, paged_i8):
        f.restype = ctypes.c_int
    err = lib.kv_write_error_string
    err.argtypes = [I]
    err.restype = ctypes.c_char_p
    return SimpleNamespace(launch=launch, paged=paged, paged_i8=paged_i8, error_string=err)


def sass_functions(path: str) -> dict:
    """{kernel's mangled name: (its instructions [(address, text without its
    predicate)], {label: address})} from ``cuobjdump -sass``."""
    from seldon_core_tpu_torch.ops._build import find_nvcc

    tool = str(Path(find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs, name, pending = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:  # the anonymous namespace's name differs from build to build
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)", m.group(1))
            funcs[name] = ([], {})
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and name:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            addr = int(m.group(1), 16)
            funcs[name][0].append((addr, re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
            for label in pending:
                funcs[name][1][label] = addr
            pending = []
    return funcs


def division_counts(funcs: dict) -> dict:
    """Per paged write kernel (mangled name): its CALLs, those of them whose
    routine (the target up to its RET) holds an I2F.U64.RP (the reciprocal
    step of a 64-bit integer division by a runtime value: the 64-bit
    division and remainder routines), and the reciprocal steps in the
    kernel: I2F.U64.RP (64-bit) and the other I2F.*.RP (32-bit divisions),
    a routine's counted once however many calls reach it."""
    out = {}
    for name, (instrs, labels) in funcs.items():
        if "kv_write_paged" not in name or "empty" in name:
            continue
        at = {a: k for k, (a, _) in enumerate(instrs)}
        ops = Counter(i.split()[0] for _, i in instrs)
        calls = div64 = 0
        for _, i in instrs:
            if not i.startswith("CALL"):
                continue
            calls += 1
            m = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", i)
            target = (labels.get(m.group(1)) if m and m.group(1) else
                      int(m.group(2), 16) if m else None)
            if target not in at:
                continue
            for _, j in instrs[at[target]:]:
                if j.startswith("I2F") and "U64" in j.split()[0] and ".RP" in j.split()[0]:
                    div64 += 1
                    break
                if j.startswith("RET"):
                    break
        out[name] = {
            "calls": calls, "calls_div64": div64,
            "I2F.U64.RP": sum(v for op, v in ops.items() if op.startswith("I2F") and "64" in op
                              and ".RP" in op),
            "I2F.RP 32-bit": sum(v for op, v in ops.items() if op.startswith("I2F")
                                 and ".RP" in op and "64" not in op),
            "FRND": sum(v for op, v in ops.items() if op.startswith("FRND")),
            "F2I": sum(v for op, v in ops.items() if op.startswith("F2I")),
            "MUFU": sum(v for op, v in ops.items() if op.startswith("MUFU")),
            "instructions": len(instrs)}
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1]).is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kv_write_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build, kv_write as kw

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all(["kv_write"])
    earlier_path, _ = build_earlier(Path(sys.argv[1]).resolve())
    present_path = _build.BUILD_INFO["kv_write"]["path"]
    libs = {"earlier": bind(earlier_path), "present": kw._library()}
    empty = ctypes.CDLL(present_path).kv_write_paged_empty_launch
    empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def use(design):
        kw._lib = libs[design]

    # the instructions of both builds
    sass_rows = {d: division_counts(sass_functions(p))
                 for d, p in (("earlier", earlier_path), ("present", present_path))}
    for d, rows in sass_rows.items():
        for name, c in rows.items():
            print(f"[sass] {d} {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()),
                  flush=True)

    # both designs bit for bit on the smoke's checked inputs
    checked = 0
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    cases = ([(KV, hd, W, dt, mis, False, False) for KV, hd, W, dt, mis in cs.KV_PAGED_CASES]
             + [(KV, hd, W, "bf16", 0, True, copy) for KV, hd, W in cs.I8_KV_CASES
                for copy in (False, True)])
    for KV, hd, W, dt, mis, int8, copy in cases:
        x = kw.paged_write_inputs(B, KV, W, hd, NBLK, gen, dev, misalign=mis, int8=int8,
                                  copy=copy,
                                  dtype=torch.float32 if dt == "f32" else torch.bfloat16)
        want = kw.paged_write_expected(x)
        got = {}
        for d in ("earlier", "present"):
            use(d)
            pools = [t.clone() for t in x.pools + (x.planes or [])]
            kw.kv_write_paged(pools[0], pools[1], x.k, x.v, x.tables, x.start, x.valid,
                              tuple(pools[2:]) if int8 else None, x.k_s, x.v_s)
            got[d] = pools
        torch.cuda.synchronize()
        for d, pools in got.items():
            if not all(torch.equal(a[1:], b[1:x.N]) for a, b in zip(pools, want)):
                raise AssertionError(f"the {d} design at KV={KV} hd={hd} W={W} {dt} misalign "
                                     f"{mis} int8 {int8} copy {copy} is not the plain scatter")
        if not all(torch.equal(a[1:], b[1:]) for a, b in zip(got["earlier"], got["present"])):
            raise AssertionError(f"the designs differ at KV={KV} hd={hd} W={W}")
        checked += 1
    use("present")
    print(f"[turns] both designs bit for bit with each other and the plain version outside the "
          f"scratch block at {checked} checked cases (chip_smoke's KV_PAGED_CASES and "
          f"I8_KV_CASES, quantize and copy)", flush=True)

    # the timed writes, in turns
    rows = []
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
    N = B * NBLK + 1
    tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * NBLK] + 1)
    tables = tables.reshape(B, NBLK).to(torch.int32)
    for label, KV, hd, W, dt, mode in TIMED:
        valid = torch.ones(B, W, dtype=torch.bool, device=dev)
        if mode is None:  # as chip_smoke's KV_PAGED_TIMED: positions 512 - W .. 511
            dtype = torch.float32 if dt == "f32" else torch.bfloat16
            pk, pv = (torch.randn(N, KV, cs.PAGED_BS, hd, generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            k, v = cs.head_views(torch, B, W, KV, hd, torch.Generator().manual_seed(W), dev)
            k, v = k.to(dtype), v.to(dtype)
            start = torch.full((B,), 512 - W, dtype=torch.int32, device=dev)
            planes, k_s, v_s = None, None, None
            nbytes = 2 * 2 * B * KV * W * hd * pk.element_size()
        else:  # as chip_smoke's int8_kernel_times
            (pk, pks), (pv, pvs) = (kw.int8_kv_rows((N, KV, cs.PAGED_BS, hd), gen, dev)
                                    for _ in range(2))
            planes = (pks, pvs)
            start = (torch.randint(0, NBLK * cs.PAGED_BS // W, (B,), generator=gen, device=dev)
                     * W).to(torch.int32)
            if mode == "copy":
                (k, k_s), (v, v_s) = (kw.int8_kv_rows((B, KV, W, hd), gen, dev)
                                      for _ in range(2))
                nbytes = B * KV * W * 2 * 2 * (hd + 4)
            else:
                k, v = cs.head_views(torch, B, W, KV, hd, torch.Generator().manual_seed(W), dev)
                k_s = v_s = None
                nbytes = B * KV * W * (2 * hd * 2 + 2 * (hd + 4))
            nbytes += 4 * (B * NBLK + B) + B * W
        lanes = kw.paged_write_lanes(pk, pv, k, v)
        plan = kw.paged_write_plan(B, KV, W, lanes)

        def write():
            kw.kv_write_paged(pk, pv, k, v, tables, start, valid, planes, k_s, v_s)

        def floor():
            rc = empty(B, KV, W, lanes, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc != 0:
                raise RuntimeError(f"the empty launch failed: CUDA error {rc}")

        ms = {"earlier": [], "present": []}
        floor_ms = []
        for d in ("earlier", "present", "present", "earlier"):
            use(d)
            ms[d].append(cs.device_ms(torch, write, ITERS))
            if d == "present" and not floor_ms:
                floor_ms.append(cs.device_ms(torch, floor, ITERS))
        use("present")
        floor_ms.append(cs.device_ms(torch, floor, ITERS))
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        fl = float(np.median(floor_ms))
        row = {"kernel": label, "KV": KV, "hd": hd, "W": W, "B": B, "plan": plan, "ms": ms,
               "floor_ms": floor_ms, "bound_ms": bound, "bound_by": "bytes",
               "above_floor_ms": {d: [t - fl for t in v] for d, v in ms.items()}}
        rows.append(row)
        print(f"[turns] kv_write_paged {label}, B={B} rows of W={W} into ({N},{KV},{cs.PAGED_BS},"
              f"{hd}) (plan {plan}), in turns: earlier {ms['earlier']} ms, present "
              f"{ms['present']} ms; empty launch at the present plan's grid {floor_ms} ms; above "
              f"it: earlier {[round(t - fl, 6) for t in ms['earlier']]}, present "
              f"{[round(t - fl, 6) for t in ms['present']]} ms; bound {bound:.6f} ms (bytes) on "
              f"{smi}", flush=True)
        del pk, pv, k, v, planes

    served = serve_in_turns(torch, cs, kw, dev, smi, use)
    print(json.dumps({"card": smi, "checked_cases": checked, "turns": rows, "sass": sass_rows,
                      "served": served}), flush=True)
    return 0


def serve_in_turns(torch, cs, kw, dev, smi, use) -> dict:
    """The self-draft speculative 32-row request (chip_smoke's phase 10f)
    with each design in turns: tokens/s over its wall, the verifies'
    launches, and whether both designs serve the same tokens."""
    engine = cs.mode_engine(torch, dev, cs.spec_deployment(True), continuous=True,
                            env=cs.SPEC_ENV)
    target = engine.states()["gen"]["target"]
    engine.load_states({"gen": {"target": target, "draft": target}})
    rng = np.random.default_rng(cs.SEED + 41)
    p32 = rng.integers(0, cs.GEN_DIMS["vocab"], size=(cs.GEN_B, cs.GEN_S))
    new = cs.GEN_DIMS["max_new_tokens"]
    server = cs.ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    walls = {"earlier": [], "present": []}
    launches, tokens = {}, {}
    try:
        for d in ("earlier", "present"):  # warm-up, the launches and the tokens
            use(d)
            kw.PAGED_LAUNCHES = 0
            status, raw = cs.request("POST", url, cs.ndarray(p32))
            launches[d] = kw.PAGED_LAUNCHES
            tokens[d] = cs.check_tokens(status, raw, p32, "ndarray")
        for _ in range(SERVE_TURNS):
            for d in ("earlier", "present", "present", "earlier"):
                use(d)
                t = time.perf_counter()
                status, _raw = cs.request("POST", url, cs.ndarray(p32))
                walls[d].append(time.perf_counter() - t)
                if status != 200:
                    raise AssertionError(f"the served request answered HTTP {status}")
    finally:
        use("present")
        server.stop()
    rates = {d: [cs.GEN_B * new / w for w in v] for d, v in walls.items()}
    same = float((tokens["earlier"] == tokens["present"]).mean())
    print(f"[turns] the self-draft speculative 32-row {cs.GEN_S}-token request, {new} new "
          f"tokens, in turns: earlier {['%.1f' % r for r in rates['earlier']]} tokens/s, present "
          f"{['%.1f' % r for r in rates['present']]} tokens/s; kv_write_paged launches a request "
          f"{launches}; tokens the same under both designs: {same} on {smi}", flush=True)
    return {"tokens_per_s": rates, "walls_s": walls, "kv_write_paged_launches": launches,
            "same_tokens": same}


if __name__ == "__main__":
    sys.exit(main())
