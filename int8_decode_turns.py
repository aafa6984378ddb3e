#!/usr/bin/env python3
"""Time the int8-K/V variants of flash_decode_two_tier and flash_decode_paged
beside an earlier design of both, in turns, on one NVIDIA card.

    mkdir -p build/dev
    for f in flash_decode.cu flash_decode_paged.cu kv_int8.cuh; do
      git show da270b9:seldon_core_tpu_torch/ops/csrc/$f > build/dev/$f; done
    python3 int8_decode_turns.py build/dev/flash_decode.cu build/dev/flash_decode_paged.cu

The earlier sources are the two decode libraries of commit da270b9, whose
int8 variants convert every code with I2F and read their scales or their V
codes with scalar loads (the two-tier kernel a slot walk on the CUDA cores,
the paged one mma.sync over unswizzled bulk-copied stages).  Their C
interfaces are the present ones, so this script builds them with the
port's nvcc flags into ``build/dev/`` (their own ``kv_int8.cuh`` beside
them, ``flash_common.cuh`` from the checkout, unchanged since) and runs them
through the present wrappers by swapping the wrappers' libraries (the
earlier two-tier variant with the earlier split, ``decode_split_plan``).

On ``chip_smoke.py``'s inputs (``decode_sets`` and ``paged_sets``: cold
L2, the step's write fused in) at the flagship's heads (B=32, 4 kv heads
of 4 query heads, hd 64) at n = 560 and 4,160 positions and at B=1, n =
560, it holds the two designs to each other (o within
``chip_smoke.FLASH_O_ATOL`` of max(1, |o|), the written codes and scales
bit for bit), then times each int8 variant and each bf16 kernel of both
builds in turns (earlier, present, present, earlier) beside the call's
byte bound.  It counts the conversion and shared-memory instructions of
every decode kernel in both builds (``cuobjdump -sass``), prints the
registers and spills ``ptxas`` reports for the int8 kernels, and sets the
bf16 two-tier kernels' SASS of both builds side by side (the present
source took the cache element out of their template).  Last it serves
the static lane's long-context int8 decode (B=32, S=4096, 64 new tokens,
``bench.py:547-560``) with each design in turns: decode tokens/s from the
wall of generate(64) less that of generate(1).  It prints the card, one
line per measurement and a final JSON object.  It imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import difflib
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
B, KV, G, HD = 32, 4, 4, 64
# (B, n, main positions): the served round, the long-context arm, one row
SHAPES = [(B, 560, 512), (B, 4160, 4096), (1, 560, 512)]
ITERS = 50                # launches a device time is read over
LC_S, LC_NEW = 4096, 64   # the long-context arm
COUNTED = ("F2FP", "LDS.U8", "LDS.S8", "LDS.U16", "LDS", "LDG", "LDGSTS", "HMMA", "PRMT", "LOP3",
           "HADD2", "HFMA2", "FFMA", "SHFL")


def build_earlier(source: Path) -> tuple:
    """nvcc of an earlier source with the port's flags into build/dev/: the
    library's path and ptxas's report."""
    from seldon_core_tpu_torch.ops._build import CSRC, NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "dev" / f"lib{source.stem}_earlier.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return str(out), proc.stderr


def bind(path: str, paged: bool) -> SimpleNamespace:
    """A library's entry points, bound as the wrappers bind theirs."""
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    if paged:
        launch = lib.flash_decode_paged_launch
        launch.argtypes = [P] * 9 + [I] * 9 + [P, P]
        launch_i8 = lib.flash_decode_paged_i8_launch
        launch_i8.argtypes = [P] * 11 + [I] * 8 + [P, P]
        smem = lib.flash_decode_paged_smem_bytes
        smem.argtypes = [I] * 4 + [P, I]
        err = lib.flash_decode_paged_error_string
    else:
        launch = lib.flash_decode_launch
        launch.argtypes = [P] * 3 + [I] + [P] * 2 + [I] + [P] * 3 + [I] * 6 + [P, P]
        launch_i8 = lib.flash_decode_i8_launch
        launch_i8.argtypes = [P] * 5 + [I] + [P] * 4 + [I] + [P] * 3 + [I] * 6 + [P] * 3
        smem = lib.flash_decode_smem_bytes
        smem.argtypes = [I, I, I, P, I]
        err = lib.flash_decode_error_string
    for f in (launch, launch_i8, smem):
        f.restype = ctypes.c_int
    err.argtypes = [I]
    err.restype = ctypes.c_char_p
    return SimpleNamespace(launch=launch, launch_i8=launch_i8, smem_bytes=smem,
                           error_string=err)


def sass(path: str) -> dict:
    """{kernel's mangled name: [its instructions]} from ``cuobjdump -sass``,
    each instruction (address, text without encoding and predicate)."""
    from seldon_core_tpu_torch.ops._build import find_nvcc

    tool = str(Path(find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:  # the anonymous namespace's name differs from build to build
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anon)", m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
    return funcs


def walk_loop(instrs) -> list:
    """The instructions of the loop that holds every HMMA of a kernel (the
    tightest backward branch around them): the walk over the tiles."""
    mma = [a for a, i in instrs if i.startswith("HMMA")]
    if not mma:
        return []
    spans = []
    for a, i in instrs:
        m = re.match(r"BRA(?:\.\w+)*\s+(?:\S+,\s*)?(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", i)
        if m and m.group(1) and int(m.group(1), 16) <= min(mma) and a >= max(mma):
            spans.append((int(m.group(1), 16), a))
    if not spans:
        return []
    lo, hi = max(spans)
    return [(a, i) for a, i in instrs if lo <= a <= hi]


def counts(instrs) -> dict:
    """Instructions by opcode family (LDS every shared load, LDS.U8 and the
    rest also on their own, and so on); "I2F" the integer-to-float
    conversions (I2F.*, I2FP.*) but those of rounding mode .RP, the
    reciprocal step of an integer division by a value known only at run
    time, which "I2F.RP" counts."""
    ops = Counter(i.split()[0] for _, i in instrs)
    out = {"I2F": sum(v for op, v in ops.items() if op.startswith("I2F") and ".RP" not in op),
           "I2F.RP": sum(v for op, v in ops.items() if op.startswith("I2F") and ".RP" in op)}
    out.update({key: sum(v for op, v in ops.items() if op == key or op.startswith(key + "."))
                for key in COUNTED})
    out["instructions"] = len(instrs)
    out["I2F variants"] = {op: v for op, v in ops.items() if op.startswith("I2F")}
    return out


def kernel_counts(funcs: dict, *names) -> dict:
    """Counts of every function whose mangled name holds one of names: the
    whole kernel's, and its walk loop's (``walk_loop``)."""
    return {f: {"kernel": counts(ins), "walk": counts(walk_loop(ins))}
            for f, ins in funcs.items() if any(n in f for n in names)}


def bf16_sass_diff(earlier: dict, present: dict) -> list:
    """The bf16 two-tier instances of both builds (the earlier one's
    mangled with its __nv_bfloat16 cache element) side by side: per (row
    tile, fused) the instructions of each and how many differ once the
    parameters' constant-bank offsets are taken out (the present Params
    holds no scale fields)."""
    def instances(funcs, pat):
        got = {}
        for f, ins in funcs.items():
            m = re.search(pat, f)
            if m:
                got[(int(m.group(1)), int(m.group(2)))] = [
                    re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", i) for _, i in ins]
        return got

    e = instances(earlier, r"flash_decode_kernelILi(\d+)ELb([01])E13__nv_bfloat16E")
    p = instances(present, r"flash_decode_kernelILi(\d+)ELb([01])EE")
    rows = []
    for key in sorted(e):
        a, b = e[key], p.get(key, [])
        sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
        same = sum(blk.size for blk in sm.get_matching_blocks())
        rows.append({"row_tile": key[0], "fused": bool(key[1]), "earlier": len(a),
                     "present": len(b), "differing": max(len(a), len(b)) - same})
    return rows


def ptxas_lines(report: str, pattern: str) -> list:
    """ptxas's report on the kernels whose mangled names match pattern:
    each one's name, then its spill and register lines."""
    lines = report.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and re.search(pattern, m.group(1)):
            out += [m.group(1)] + [ln.strip() for ln in lines[i + 1:i + 4]
                                   if "registers" in ln or "spill" in ln]
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 3 or not all(Path(a).is_file() for a in sys.argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("int8_decode_turns: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build, flash_decode as fd

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all(["flash_decode", "flash_decode_paged", "kv_write"])
    two_path, two_ptxas = build_earlier(Path(sys.argv[1]).resolve())
    paged_path, paged_ptxas = build_earlier(Path(sys.argv[2]).resolve())
    present = {"two": fd._library(), "paged": fd._paged_library()}
    earlier = {"two": bind(two_path, False), "paged": bind(paged_path, True)}
    libs = {"earlier": earlier, "present": present}
    present_plan = fd.i8_split_plan

    def use(design):
        fd._lib, fd._paged_lib = libs[design]["two"], libs[design]["paged"]
        fd.i8_split_plan = present_plan if design == "present" else fd.decode_split_plan

    # the instructions of both builds
    paths = {"earlier": {"two": two_path, "paged": paged_path},
             "present": {"two": _build.BUILD_INFO["flash_decode"]["path"],
                         "paged": _build.BUILD_INFO["flash_decode_paged"]["path"]}}
    funcs = {d: {k: sass(p) for k, p in v.items()} for d, v in paths.items()}
    sass_rows = {}
    for d in ("earlier", "present"):
        sass_rows[d] = {**kernel_counts(funcs[d]["two"], "flash_decode_kernel",
                                        "flash_decode_i8_kernel"),
                        **kernel_counts(funcs[d]["paged"], "paged_decode_kernel",
                                        "paged_decode_i8_kernel")}
        for name, c in sass_rows[d].items():
            for part in ("kernel", "walk"):
                print(f"[sass] {d} {name} {part}: "
                      + ", ".join(f"{k} {v}" for k, v in c[part].items()), flush=True)
    diff = bf16_sass_diff(funcs["earlier"]["two"], funcs["present"]["two"])
    paged_same = {f: funcs["earlier"]["paged"].get(f) == ins
                  for f, ins in funcs["present"]["paged"].items()
                  if "paged_decode_kernel" in f or "paged_decode_f32_kernel" in f}
    print(f"[sass] the bf16 two-tier instances, earlier against present (constant-bank "
          f"offsets aside): {diff}; the bf16 and f32 paged instances identical: "
          f"{sum(paged_same.values())} of {len(paged_same)}", flush=True)
    regs = {"earlier": ptxas_lines(two_ptxas, r"flash_decode_kernelILi\d+ELb[01]EaE")
            + ptxas_lines(paged_ptxas, "i8_kernel"),
            "present": ptxas_lines(_build.BUILD_INFO["flash_decode"]["ptxas"], "i8_kernel")
            + ptxas_lines(_build.BUILD_INFO["flash_decode_paged"]["ptxas"], "i8_kernel")}
    for d, lines in regs.items():
        for ln in lines:
            print(f"[ptxas] {d}: {ln}", flush=True)

    rows = []
    for Bn, n, n_main in SHAPES:
        n_chunk = n - n_main
        C = 64 if n > 1024 else 63
        shape = (Bn, KV, G, HD, n_main, n_main, C, n_chunk)
        nblk = -(-n // cs.PAGED_BS) + 4
        two = {"int8": cs.decode_sets(torch, shape, dev, cs.SEED + 171, fused=True, int8=True),
               "bf16": cs.decode_sets(torch, shape, dev, cs.SEED + 171, fused=True)}
        paged = {"int8": cs.paged_sets(torch, Bn, KV, G, HD, nblk, [n] * Bn, dev, cs.SEED + 172,
                                       True),
                 "bf16": cs.paged_sets(torch, Bn, KV, G, HD, nblk, [n] * Bn, dev, cs.SEED + 172)}

        def two_call(q, mk, mv, ck, cv, kn, vn, sc):
            return fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, kn, vn, sc)

        def paged_call(q, pk, pv, tb, ln, kn, vn, sc=None):
            return fd.flash_decode_paged(q, pk, pv, tb, ln, kn, vn, None, sc)

        # the two designs on the same inputs, each on its own copies
        agree = {}
        for kernel, sets, call in (("flash_decode_two_tier", two["int8"], two_call),
                                   ("flash_decode_paged", paged["int8"], paged_call)):
            got, written = {}, {}
            for d in ("earlier", "present"):
                use(d)
                x = [t.clone() if torch.is_tensor(t) else tuple(s.clone() for s in t)
                     for t in sets[0]]
                got[d] = call(*x)
                written[d] = x
            torch.cuda.synchronize()
            err = cs.o_errs(got["earlier"], got["present"])[1]
            same = all(torch.equal(a, b) if torch.is_tensor(a) else
                       all(torch.equal(u, v) for u, v in zip(a, b))
                       for a, b in zip(written["earlier"], written["present"]))
            if err > cs.FLASH_O_ATOL or not same:
                raise AssertionError(f"the designs of {kernel} int8 disagree at B={Bn}, n={n}: "
                                     f"{err:.3e}, or their writes differ")
            agree[kernel] = err
        ms = {}
        for kernel, sets, call in (("flash_decode_two_tier", two, two_call),
                                   ("flash_decode_paged", paged, paged_call)):
            for kind in ("int8", "bf16"):
                for d in ("earlier", "present", "present", "earlier"):
                    use(d)
                    ms.setdefault(f"{kernel} {kind}", {}).setdefault(d, []).append(
                        cs.device_ms(torch, cs.rotating(sets[kind], call), ITERS))
        use("present")
        bounds = {
            "flash_decode_two_tier int8": cs.i8_bound(Bn, KV, G, HD, Bn * n, True)[0],
            "flash_decode_two_tier bf16": cs.decode_bound((Bn, KV, G, HD, 0, n_main, 0,
                                                           n_chunk))[0],
            "flash_decode_paged int8": cs.i8_bound(Bn, KV, G, HD, Bn * n, True,
                                                   4 * (Bn * nblk + Bn))[0],
            "flash_decode_paged bf16": cs.paged_decode_bound(Bn, KV, G, HD, nblk, [n] * Bn,
                                                             fused=True)[0]}
        row = {"B": Bn, "n": n, "n_main": n_main, "designs_max_rel_diff": agree,
               "ms": ms, "bound_ms": bounds,
               "split": {"present": fd.i8_split_plan(Bn, KV, G, n, 132),
                         "earlier": fd.decode_split_plan(Bn, KV, G, n, 132)}}
        rows.append(row)
        for key, t in ms.items():
            print(f"[turns] {key} fused, (B,KV,G,hd)=({Bn},{KV},{G},{HD}), n={n}, cold L2: "
                  f"earlier {t['earlier']} ms, present {t['present']} ms; bound "
                  f"{bounds[key]:.6f} ms (bytes) on {smi}", flush=True)
        print(f"[turns] the designs agree within {agree} of max(1, |o|), their writes bit for "
              f"bit, at B={Bn}, n={n}", flush=True)
        del two, paged

    # the static lane's long-context int8 decode, each design in turns
    from seldon_core_tpu_torch.models.generate import generate
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    dims = {k: v for k, v in cs.GEN_DIMS.items() if k != "max_new_tokens"}
    cfg = LMConfig(**dims, kv_quant="int8")
    params = lm_init(torch.Generator().manual_seed(cs.SEED + 181), cfg, dev)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, size=(B, LC_S)),
                             dtype=torch.int32, device=dev)

    def wall(new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            out = generate(params, prompt, cfg, max_new_tokens=new, use_flash=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    walls, tokens = {"earlier": [], "present": []}, {}
    for d in ("earlier", "present"):  # warm-up
        use(d)
        wall(2)
    for d in ("earlier", "present", "present", "earlier"):
        use(d)
        (a, out), (b1, _) = wall(LC_NEW), wall(1)
        walls[d].append((a, b1))
        tokens[d] = out
    use("present")
    rates = {d: [B * (LC_NEW - 1) / (a - b1) for a, b1 in w] for d, w in walls.items()}
    same = int((tokens["earlier"] == tokens["present"]).sum())
    print(f"[turns] long-context static int8 decode, B={B}, S={LC_S}, {LC_NEW} new tokens, in "
          f"turns: earlier {['%.1f' % r for r in rates['earlier']]} tokens/s, present "
          f"{['%.1f' % r for r in rates['present']]} tokens/s; {same} of "
          f"{tokens['present'].numel()} tokens the same under both designs on {smi}", flush=True)
    print(json.dumps({"card": smi, "turns": rows, "sass": sass_rows, "bf16_two_tier_sass": diff,
                      "paged_bf16_f32_sass_identical": paged_same, "ptxas": regs,
                      "long_context": {"tokens_per_s": rates, "walls_s": walls,
                                       "same_tokens": same}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
