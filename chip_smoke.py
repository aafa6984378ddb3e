#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of the served and trained paths from the sources in
this checkout (three libraries, built at once), holds each kernel against
its plain PyTorch version on the card, serves two deployments through the
port's engine and REST lane on a localhost port, trains the flagship LM a
few steps and serves its checkpoint, checks the answers, shows that each
run went through its kernels, and times each kernel beside its plain
version, a PyTorch library call and its bound.  Weights are random, from
a seed.  Phases, in order; any failure exits non-zero without the final
line, and each phase prints its wall:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    nvcc of ops/csrc/fused_mlp.cu, ops/csrc/flash_attention.cu
              and ops/csrc/flash_attention_bwd.cu at once, with ptxas's
              report; each kernel's own shape check asked for shapes it
              takes and shapes it must refuse
  3. kernel   fused_mlp_softmax vs fused_mlp_softmax_reference at
              784-256-256-10 and 784-512-512-10 with non-zero biases,
              B in {1, 7, 32, 64, 128, 1024} (32 and 64 are the served
              stacks)
  4. serve    examples/mnist_deployment.json: engine construction (the
              unit probes the kernel), then 1-row ndarray, 64-row tensor,
              32 concurrent 1-row requests and a 1-row latency loop over
              one keepalive connection, all through POST
              /api/v0.1/predictions; launch counts reset just before, read
              just after; then the same request's p50 inside the engine
              and at the dispatch
  5. times    fused-MLP kernel / plain / library device times and the
              bound at B=1 and B=1024
  6. flash    flash_attention kernel vs flash_attention_reference, o and
              lse, causal and not, at five shapes (the served prefill layer
              among them)
  7. gen      the flagship TransformerGenerator of bench.py:3342-3344
              (vocab 32768, d_model 1024, 16 heads over 4 kv heads, 12
              layers, d_ff 4096, 64 new tokens, bf16): engine construction
              (the unit probes the flash kernel), then a 1-row 512-token
              ndarray prompt, a 32-row 512-token tensor request, 8
              concurrent 1-row requests and a 1-row 100-token prompt (S %
              128 != 0: the plain attention, no launch), launch counts reset
              before and read after; every served token teacher-forced
              through the plain path; prefill logits kernel vs plain
  8. times    flash kernel / plain / SDPA device times and the bound at the
              served prefill shape and at S=2048, 4096 (B=4); served TTFT,
              32-row request wall, decode tokens/s, the kernel's share of
              the prefill
  9. flash-bwd the dQ and dK/dV kernels vs flash_attention_bwd_reference,
              dq/dk/dv, causal and not, at five shapes (the training layer
              among them); each call moves each launch counter by 1, and a
              second call gives the same bits
 10. train    the flagship config (GEN_DIMS) in bf16 on the copy task of
              bench.py:2105-2108 at B=16, S=512 with adam(3e-4): one step's
              loss and per-leaf gradients, kernel path vs plain path; then
              20 steps with counts reset before and read after (12 forward,
              12 dQ and 12 dK/dV launches per step), losses finite and
              falling; step wall, trained tokens/s, a profiled step
 11. hand-off save_lm_weights / load_lm_weights bit-identical; a
              TransformerGenerator with weights_path served over REST
              answers a 512-token copy-task prompt as an in-process
              generate on the trained params does
 12. times    dQ and dK/dV kernel / plain / SDPA-backward device times and
              their bounds at the training layer and at S=2048 (B=4); then
              the {"kernels": [...]} line with all four kernels
 13. last line {"ok": true, "device": {"platform": "gpu", ...}}

It needs one card and exits non-zero when CUDA is absent or when the
port's package is not beside it.  It imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_SOURCES = ("fused_mlp", "flash_attention", "flash_attention_bwd")
KERNEL_ATOL = 2e-3   # kernel vs plain, probabilities: both round at the same
#                      bf16 casts, only the order of the f32 sums differs.
#                      Served answers are the same kernel against the same
#                      plain version, so they are held to it too.
FLASH_O_ATOL = 1.6e-2   # kernel vs plain, bf16 o (|o| < 2): p rounds to bf16
#                         at the kernel's running row max and at the plain
#                         version's final one, sums run in another order,
#                         and o is rounded to bf16 -- 2 bf16 ulps at |o| ~ 1
FLASH_LSE_ATOL = 1e-4   # lse is an f32 max + log of an f32 sum on both sides
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
SERVE_P50_REQUESTS = 200
# bench.py:3342-3344, gen_lm_deployment(smoke=False), quant none
GEN_DIMS = {"vocab": 32768, "d_model": 1024, "n_heads": 16, "n_kv_heads": 4,
            "n_layers": 12, "d_ff": 4096, "max_new_tokens": 64}
GEN_S = 512            # the flagship traffic: B=32 prompts of 512 tokens
GEN_B = 32
FLASH_SHAPES = [(1, 2, 2, 256, 64), (1, 1, 1, 384, 32), (32, 16, 4, 512, 64),
                (2, 8, 2, 1024, 128), (1, 4, 4, 256, 256)]   # (B, H, KV, S, D)
FLASH_TIMED = [(32, 16, 4, 512, 64), (4, 16, 4, 2048, 64), (4, 16, 4, 4096, 64)]
# (B, H, KV, S, D): MHA, the 3-tile carry with D padded to the 64-wide
# tile, the training layer, GQA at D=128, and D=256 (the two-walk dK/dV)
FLASH_BWD_SHAPES = [(1, 2, 2, 256, 64), (1, 1, 1, 384, 32), (16, 16, 4, 512, 64),
                    (2, 8, 2, 1024, 128), (1, 4, 4, 256, 256)]
FLASH_BWD_TIMED = [(16, 16, 4, 512, 64), (4, 16, 4, 2048, 64)]
BWD_REL_TOL = 2.0 ** -5   # kernel vs plain backward, each of dq, dk, dv, as
#                           a share of that gradient's largest element: both
#                           round p and ds to bf16 at the same places, but
#                           their f32 scores and sums run in other orders, so
#                           a rounding of p, ds or the bf16 result can move by
#                           an ulp; under GQA the plain version also rounds
#                           each query head's dK/dV before the group sum, the
#                           kernel once after it.  4 bf16 ulps of the largest
#                           element (an ulp is 2^-8 to 2^-7 of it).
# The served path (flash prefill, two-tier cached decode) and the plain
# path (attention="xla", the whole sequence at once) round at other places:
# the attention output by 1-2 bf16 ulps (p rounds at the running vs the final
# row max), the S=1 and S=575 matmuls by cuBLAS's choice of algorithm.  Over
# 12 layers that moves the bf16 logits near the row maximum (|logit| in
# [4, 8) at vocab 32768, ulp 2^-5) by a few ulps: the first card run
# measured 0.047 (token gap) and 0.051 (prefill logits).  Both are held to
# 4 ulps there.  A token that is not the plain argmax must still be within
# TOKEN_DELTA of it.
PREFILL_LOGIT_ATOL = 0.125
TOKEN_DELTA = 0.125
# Training: the flagship generator's config (GEN_DIMS) in bf16 on the copy
# task of bench.py:2105-2108 (rows head|head|head, bhalf = 171, so tokens
# [16, 513] and S = 512), adam(3e-4) as bench.py:2118
TRAIN_B, TRAIN_HALF, TRAIN_STEPS, TRAIN_LR = 16, 171, 20, 3e-4
# One step's gradients, kernel path vs plain path (use_flash=False), per
# leaf as ||g_kernel - g_plain|| / ||g_plain||.  Both are bf16 training, but
# the plain path's autograd rounds dP to bf16 and keeps ds and dq in f32,
# where the kernels keep dP in f32 and round ds to bf16, and the forward's o
# differs by 1-2 bf16 ulps (p rounded at the running vs the final row max):
# each element moves by about 2^-8 of itself, independently, and 12 layers
# of bf16 activations carry it down.  5e-2 (~13 x 2^-8) leaves room for
# that and still catches a wrong term (a wrong head's dQ/dK/dV is O(1)).
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_LOSS_RTOL = 1e-3   # the loss is a mean over 8,192 tokens of f32 nll


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``fn`` enqueued ``iters`` times behind a GPU
    sleep, so the host's enqueue cost never shows between the events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mlp_bound(dims, batch: int):
    """Least time for the work: bytes (x read once, weights + biases read
    once, probabilities written once) over HBM bandwidth, against the
    matmul FLOPs over the bf16 peak; the larger one bounds."""
    layer_bytes = sum(k * n * 2 + n * 2 for k, n in zip(dims[:-1], dims[1:]))
    nbytes = batch * dims[0] * 4 + layer_bytes + batch * dims[-1] * 4
    flops = 2 * batch * sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def random_params(torch, mlp_init, hidden: int, gen, device):
    params = mlp_init(gen, hidden=hidden, depth=2, device=device)
    for k in list(params):
        if k.startswith("b"):  # non-zero biases, so the bias add is checked
            params[k] = (torch.randn(params[k].shape, generator=gen) * 0.1).to(
                torch.bfloat16).to(device)
    return params


class ServerThread:
    """The port's REST lane on its own event loop and thread."""

    def __init__(self, engine):
        self.engine = engine
        self.loop = asyncio.new_event_loop()
        self.server = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self._up = threading.Event()
        self._error = None

    def _run(self):
        from seldon_core_tpu_torch.runtime.rest import serve_fast

        asyncio.set_event_loop(self.loop)
        try:
            self.server = self.loop.run_until_complete(
                serve_fast(self.engine, "127.0.0.1", 0))
        except BaseException as e:  # noqa: BLE001 - reported to start()
            self._error = e
            self._up.set()
            return
        self._up.set()
        self.loop.run_forever()

    def start(self) -> int:
        self.thread.start()
        if not self._up.wait(60) or self._error is not None:
            raise RuntimeError(f"REST lane did not start: {self._error!r}")
        return self.server.port

    def stop(self):
        if self.server is not None:
            asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.engine.close()


def request(method: str, url: str, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def check_answer(status, raw, n_rows: int, kind: str):
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    doc = json.loads(raw)
    data = doc["data"]
    if kind not in data:
        raise AssertionError(f"response lost the request's wire kind {kind!r}: {list(data)}")
    if kind == "ndarray":
        y = np.asarray(data["ndarray"], dtype=np.float64)
    else:
        y = np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
            data["tensor"]["shape"])
    if y.shape != (n_rows, 10):
        raise AssertionError(f"answer shape {y.shape} != {(n_rows, 10)}")
    if not np.isfinite(y).all() or np.abs(y.sum(axis=1) - 1.0).max() > 1e-3:
        raise AssertionError("answer rows are not finite probabilities summing to 1")
    return y


def flash_build_checks(torch, fa) -> None:
    """The flash kernels' own shape checks (flash_attention_smem_bytes and
    flash_attention_bwd_smem_bytes): the served and trained head shape is
    taken, two others refused, and the backward takes every head dim the
    forward takes."""
    smem, why = fa._smem_bytes(64, GEN_S, torch.bfloat16)
    if why is not None or smem != 3 * 64 * (64 + 8) * 2:
        raise AssertionError(f"flash shape check at D=64 S={GEN_S}: {smem} bytes, {why!r}")
    for head_dim, dtype, match in ((40, torch.bfloat16, "multiple of 16"),
                                   (64, torch.float32, "bfloat16")):
        why = fa.kernel_shape_error(head_dim, dtype)
        if why is None or match not in why:
            raise AssertionError(f"flash shape check let D={head_dim} {dtype} through: {why!r}")
    log(f"[build] flash shape check: D=64 bf16 takes {smem} bytes of shared memory; "
        f"D=40 and float32 refused")
    bwd = {d: fa._smem_bytes(d, GEN_S, torch.bfloat16, bwd=True) for d in (16, 64, 128, 256)}
    if bwd[64] != (4 * 64 * (64 + 8) * 2 + 2 * 64 * 4, None) or any(w for _, w in bwd.values()):
        raise AssertionError(f"flash backward shape check: {bwd}")
    for head_dim, dtype, match in ((40, torch.bfloat16, "multiple of 16"),
                                   (64, torch.float32, "bfloat16")):
        why = fa.bwd_kernel_shape_error(head_dim, dtype)
        if why is None or match not in why:
            raise AssertionError(f"flash backward shape check let D={head_dim} {dtype} "
                                 f"through: {why!r}")
    log(f"[build] flash backward shape check: D=16, 64, 128, 256 bf16 take "
        f"{[bwd[d][0] for d in (16, 64, 128, 256)]} bytes of shared memory; D=40 and float32 "
        f"refused")


def flash_bound(shape, causal: bool = True):
    """Least time for the work: q, k, v read once and o, lse written once
    over HBM bandwidth, against the score and PV FLOPs this run needs (the
    causal pairs only) over the bf16 peak; the larger one bounds."""
    B, H, KV, S, D = shape
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_inputs(torch, shape, gen, dev):
    B, H, KV, S, D = shape
    return (torch.randn(B, H, S, D, generator=gen).to(torch.bfloat16).to(dev),
            torch.randn(B, KV, S, D, generator=gen).to(torch.bfloat16).to(dev),
            torch.randn(B, KV, S, D, generator=gen).to(torch.bfloat16).to(dev))


def flash_kernel_phase(torch, fa, dev) -> float:
    """Phase 6: the kernel against its plain version; returns the max abs
    error of o over every shape."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 1)
    max_err = 0.0
    for shape in FLASH_SHAPES:
        q, k, v = flash_inputs(torch, shape, gen, dev)
        for causal in (True, False):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            o_err = float((o.float() - ro.float()).abs().max())
            lse_err = float((lse - rlse).abs().max())
            if (not bool(torch.isfinite(o.float()).all()) or o_err > FLASH_O_ATOL
                    or lse_err > FLASH_LSE_ATOL or o.dtype != torch.bfloat16):
                raise AssertionError(
                    f"flash kernel vs plain at {shape} causal={causal}: o err {o_err:.3e} "
                    f"(tolerance {FLASH_O_ATOL}), lse err {lse_err:.3e} "
                    f"(tolerance {FLASH_LSE_ATOL})")
            max_err = max(max_err, o_err)
            log(f"[flash] (B,H,KV,S,D)={shape} causal={causal}: o max abs err {o_err:.3e} "
                f"(tolerance {FLASH_O_ATOL}), lse {lse_err:.3e} (tolerance {FLASH_LSE_ATOL})")
    log(f"[flash] phase wall {time.perf_counter() - t0:.2f} s")
    return max_err


def flash_bwd_bound(shape, kernel: str, causal: bool = True):
    """Least time for one backward kernel's work: its inputs read once and
    its outputs written once over HBM bandwidth (dQ: q, k, v, dO, lse,
    dsum in, dq out; dK/dV: the same in, dk and dv out), against the FLOPs
    of its products over the causal pairs this run needs (dQ: q.k, dO.v,
    ds.k; dK/dV: those of p^T dO, dO.v, ds^T q and q.k) over the bf16
    peak; the larger one bounds."""
    B, H, KV, S, D = shape
    rows = 2 * 4 * B * H * S                  # lse and dsum, f32
    q_side, kv_side = 2 * B * H * S * D, 2 * B * KV * S * D
    if kernel == "dq":
        nbytes, products = 3 * q_side + 2 * kv_side + rows, 3
    else:
        nbytes, products = 2 * q_side + 4 * kv_side + rows, 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = products * 2 * B * H * D * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_bwd_inputs(torch, fa, shape, gen, dev, causal: bool = True):
    """q, k, v, dO from ``gen`` on the card, and o, lse from the forward
    kernel, as a training step hands them to the backward."""
    q, k, v = flash_inputs(torch, shape, gen, dev)
    do = torch.randn(q.shape, generator=gen).to(torch.bfloat16).to(dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, o, lse, do


def flash_bwd_phase(torch, fa, dev) -> dict:
    """Phase 9: the dQ and dK/dV kernels against the plain backward: dq,
    dk, dv at every shape, causal and not; each call moves each counter by
    exactly 1, and a second call on the same inputs gives the same bits.
    Returns each kernel's largest absolute error."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {"dq": 0.0, "dkv": 0.0}
    for shape in FLASH_BWD_SHAPES:
        for causal in (True, False):
            q, k, v, o, lse, do = flash_bwd_inputs(torch, fa, shape, gen, dev, causal)
            n_dq, n_dkv = fa.DQ_LAUNCHES, fa.DKV_LAUNCHES
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            if (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) != (n_dq + 1, n_dkv + 1):
                raise AssertionError(f"one backward at {shape} moved the counters by "
                                     f"{fa.DQ_LAUNCHES - n_dq}, {fa.DKV_LAUNCHES - n_dkv}")
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            errs = []
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                scale = float(w.float().abs().max())
                abs_err = float((g.float() - w.float()).abs().max())
                err = abs_err / scale
                if (g.dtype != torch.bfloat16 or g.shape != w.shape
                        or not bool(torch.isfinite(g.float()).all()) or err > BWD_REL_TOL):
                    raise AssertionError(
                        f"flash backward {name} vs plain at {shape} causal={causal}: error "
                        f"{err:.3e} of its largest element {scale:.3e} (tolerance {BWD_REL_TOL})")
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash backward {name} at {shape} causal={causal} "
                                         f"differs between two calls on the same inputs")
                errs.append(err)
                kern = "dq" if name == "dq" else "dkv"
                worst[kern] = max(worst[kern], abs_err)
            log(f"[flash-bwd] (B,H,KV,S,D)={shape} causal={causal}: dq {errs[0]:.3e}, dk "
                f"{errs[1]:.3e}, dv {errs[2]:.3e} of each gradient's largest element "
                f"(tolerance {BWD_REL_TOL}); a second call bit-identical")
            del q, k, v, o, lse, do, got, again, want
    log(f"[flash-bwd] phase wall {time.perf_counter() - t0:.2f} s")
    return worst


def kernel_ms_by_name(torch, fn, iters: int) -> dict:
    """Device time per call of each kernel ``fn`` launches, from
    torch.profiler's kernel records over ``iters`` calls (after a warm-up
    call): how a wrapper that launches two kernels is timed kernel by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {k: v / iters for k, v in trace_kernels(prof, "kernel_times")[0].items()}


def trace_kernels(prof, name: str):
    """({kernel name: summed device ms}, launches) from a profiler's
    exported trace."""
    path = ROOT / "build" / f"trace_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    by_name: dict = {}
    n_kernels = 0
    for e in events:
        if e.get("cat") == "kernel":
            n_kernels += 1
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e3
    return by_name, n_kernels


def gen_deployment(weights_path: str = "") -> dict:
    parameters = [{"name": k, "value": str(v), "type": "INT"} for k, v in GEN_DIMS.items()]
    parameters.append({"name": "quant", "value": "none", "type": "STRING"})
    if weights_path:
        parameters.append({"name": "weights_path", "value": weights_path, "type": "STRING"})
    return {"spec": {"name": "gen-flagship", "predictors": [{
        "name": "main",
        "graph": {"name": "gen", "type": "MODEL"},
        "components": [{"name": "gen", "runtime": "inprocess",
                        "class_path": "TransformerGenerator", "parameters": parameters}],
    }]}}


def check_tokens(status, raw, prompts: np.ndarray, kind: str) -> np.ndarray:
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    data = json.loads(raw)["data"]
    if kind not in data:
        raise AssertionError(f"response lost the request's wire kind {kind!r}: {list(data)}")
    if kind == "ndarray":
        y = np.asarray(data["ndarray"], dtype=np.float64)
    else:
        y = np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
            data["tensor"]["shape"])
    want = (len(prompts), GEN_DIMS["max_new_tokens"])
    if y.shape != want:
        raise AssertionError(f"answer shape {y.shape} != {want}")
    if (not np.isfinite(y).all() or (y != np.round(y)).any() or y.min() < 0
            or y.max() >= GEN_DIMS["vocab"]):
        raise AssertionError("answer rows are not token ids in [0, vocab)")
    return y.astype(np.int64)


def teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev):
    """Each generated token's gap to the plain path's maximum logit at its
    position (prompt + the tokens before it, attention="xla"), and whether
    it is that maximum."""
    S, n = prompts.shape[1], toks.shape[1]
    seq = np.concatenate([prompts, toks[:, :-1]], axis=1)
    with torch.inference_mode():
        logits = lm_apply(params, torch.as_tensor(seq, dtype=torch.int32, device=dev), cfg,
                          use_flash=False)
        rows = logits[:, S - 1:S - 1 + n, :]
        tok = torch.as_tensor(toks, dtype=torch.long, device=dev)
        gap = rows.amax(dim=-1) - rows.gather(-1, tok[..., None])[..., 0]
        exact = rows.argmax(dim=-1) == tok
    return gap.cpu().numpy(), exact.cpu().numpy()


def wall_p50(torch, fn, runs: int) -> float:
    """Host-clock p50 in ms of ``fn`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls) * 1e3)


def device_profile(torch, fn, name: str) -> dict:
    """One call of ``fn`` (after a warm-up call) under torch.profiler: the
    host wall, the summed device time of its kernels, their count, and the
    kernels that took the most device time, read from the exported trace's
    kernel events.  The profiler's own host cost lengthens the wall, so the
    busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name, n_kernels = trace_kernels(prof, name)
    kernel_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
            "kernels": n_kernels, "top_ms": [[k[:90], v] for k, v in top]}


def generation_phases(torch, dev, smi) -> dict:
    """Phases 6-8; returns the flash_attention row of the kernels line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.generate import init_cache, prefill, sample_token, generate
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, fused_mlp

    max_err = flash_kernel_phase(torch, fa, dev)

    # -- 7. gen ---------------------------------------------------------------
    t_phase = time.perf_counter()
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(gen_deployment()))
    from seldon_core_tpu_torch.runtime.engine import EngineService

    t0 = time.perf_counter()
    probes_before = fa.LAUNCHES
    engine = EngineService(spec, device=dev)
    unit = engine.compiled.units["gen"]
    if not unit.use_flash or fa.LAUNCHES != probes_before + 1:
        raise AssertionError(f"the generator did not probe and take the flash kernel "
                             f"(use_flash={unit.use_flash}, probe launches "
                             f"{fa.LAUNCHES - probes_before})")
    cfg = unit.cfg
    params = engine.states()["gen"]["params"]
    n_params = sum(t.numel() for layer in params.values()
                   for t in (layer.values() if isinstance(layer, dict) else [layer]))
    log(f"[gen] engine built in {time.perf_counter() - t0:.2f} s: {n_params / 1e6:.1f} M "
        f"params ({cfg.dtype}), the unit probed the flash kernel once")
    dispatches = []
    batched = engine._batched_predict_sync

    def counted(stacked):  # every stacked dispatch's shape, in order
        dispatches.append(tuple(stacked.shape))
        return batched(stacked)

    engine._batched_predict_sync = counted
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED)
    vocab = GEN_DIMS["vocab"]
    p1 = rng.integers(0, vocab, size=(1, GEN_S))
    p32 = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    p8 = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(8)]
    p100 = rng.integers(0, vocab, size=(1, 100))
    try:
        fa.LAUNCHES = 0
        fused_mlp.LAUNCHES = 0
        s1 = request("POST", url, {"data": {"ndarray": p1.tolist()}})
        s32 = request("POST", url, {"data": {"tensor": {"shape": list(p32.shape),
                                                         "values": p32.ravel().tolist()}}})
        with ThreadPoolExecutor(8) as pool:
            s8 = list(pool.map(lambda x: request("POST", url, {"data": {"ndarray": x.tolist()}}),
                               p8))
        launches = fa.LAUNCHES
        eligible = sum(1 for d in dispatches if d[1] % 128 == 0)
        s100 = request("POST", url, {"data": {"ndarray": p100.tolist()}})
        launches_after_100 = fa.LAUNCHES
        mlp_launches = fused_mlp.LAUNCHES
        st_stats, raw_stats = request("GET", f"http://127.0.0.1:{port}/stats")
        # the 32-row request's wall, after the counts were read
        body32 = {"data": {"tensor": {"shape": list(p32.shape), "values": p32.ravel().tolist()}}}
        walls32 = []
        for _ in range(3):
            t = time.perf_counter()
            st, _raw = request("POST", url, body32)
            walls32.append(time.perf_counter() - t)
            if st != 200:
                raise AssertionError(f"32-row latency loop: HTTP {st}")
    finally:
        server.stop()
    if launches != 12 * eligible or eligible < 3:
        raise AssertionError(f"flash launches {launches} != 12 x {eligible} kernel-eligible "
                             f"prefill dispatches ({dispatches})")
    if launches_after_100 != launches:
        raise AssertionError(f"the 100-token prompt launched the flash kernel "
                             f"{launches_after_100 - launches} times")
    if mlp_launches != 0:
        raise AssertionError(f"the generation run launched the fused-MLP kernel {mlp_launches} times")
    stats = json.loads(raw_stats)
    if st_stats != 200 or stats["kernels"]["flash_attention"]["launches"] != launches_after_100:
        raise AssertionError(f"/stats does not report the flash launches: {raw_stats[:300]!r}")
    log(f"[gen] dispatches {dispatches}: {eligible} kernel-eligible prefills; flash launches "
        f"{launches} = 12 x {eligible}; the 100-token prompt launched none "
        f"({launches_after_100} after it); fused-MLP launches 0")

    # correctness: every served token teacher-forced through the plain path
    y1 = check_tokens(*s1, p1, "ndarray")
    y32 = check_tokens(*s32, p32, "tensor")
    y8 = np.concatenate([check_tokens(*r, x, "ndarray") for r, x in zip(s8, p8)])
    y100 = check_tokens(*s100, p100, "ndarray")
    gaps, exacts = [], []
    for prompts, toks in ((p32, y32), (np.concatenate([p1] + p8), np.concatenate([y1, y8])),
                          (p100, y100)):
        gap, exact = teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev)
        gaps.append(gap.ravel())
        exacts.append(exact.ravel())
    gaps, exacts = np.concatenate(gaps), np.concatenate(exacts)
    log(f"[gen] teacher-forced, {gaps.size} served tokens: gap to the plain maximum "
        f"max {gaps.max():.5f}, p99 {np.quantile(gaps, 0.99):.5f}, mean {gaps.mean():.6f} "
        f"(delta {TOKEN_DELTA}); {exacts.mean() * 100:.2f}% equal the plain argmax")
    if gaps.max() > TOKEN_DELTA:
        raise AssertionError(f"a served token is {gaps.max():.4f} below the plain maximum "
                             f"(delta {TOKEN_DELTA})")
    tok32 = torch.as_tensor(p32, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lk, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg, use_flash=True)
        lp, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg, use_flash=False)
        logit_err = float((lk - lp).abs().max())
        same_first = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"[gen] prefill last-position logits, kernel vs plain attention: max abs err "
        f"{logit_err:.5f} (tolerance {PREFILL_LOGIT_ATOL}), first tokens equal "
        f"{same_first * 100:.1f}%")
    if not bool(torch.isfinite(lk).all()) or logit_err > PREFILL_LOGIT_ATOL:
        raise AssertionError(f"prefill logits differ by {logit_err} > {PREFILL_LOGIT_ATOL}")
    log(f"[gen] phase wall {time.perf_counter() - t_phase:.2f} s")

    # -- 8. times -------------------------------------------------------------
    t_phase = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 2)
    timings = []
    for shape in FLASH_TIMED:
        q, k, v = flash_inputs(torch, shape, gen, dev)
        k_ms = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        p_ms = device_ms(torch, lambda: fa.flash_attention_reference(q, k, v, True), 10)
        l_ms = device_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(shape)
        timings.append({"shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by})
        log(f"[times] flash (B,H,KV,S,D)={shape} causal: kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, SDPA {l_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}) on {smi}")
        del q, k, v
    with torch.inference_mode():
        def first_token():
            logits, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg,
                                use_flash=True)
            return sample_token(logits)

        ttft_ms = wall_p50(torch, first_token, 5)
        gen_ms = wall_p50(torch, lambda: generate(params, tok32, cfg, GEN_DIMS["max_new_tokens"],
                                                  use_flash=True), 3)
    new = GEN_DIMS["max_new_tokens"]
    served = {
        "ttft_p50_ms": ttft_ms,
        "generate_p50_ms": gen_ms,
        "request32_wall_p50_ms": float(np.median(walls32) * 1e3),
        "decode_tokens_per_s": GEN_B * (new - 1) / ((gen_ms - ttft_ms) / 1e3),
        "kernel_share_of_prefill": 12 * timings[0]["ms"] / ttft_ms,
        "card": smi,
    }
    log(f"[times] {GEN_B}x{GEN_S} prefill (TTFT) p50 {ttft_ms:.3f} ms; generate({new} new) p50 "
        f"{gen_ms:.3f} ms; the 32-row REST request p50 {served['request32_wall_p50_ms']:.3f} "
        f"ms; decode {served['decode_tokens_per_s']:.1f} tokens/s; flash kernel "
        f"{served['kernel_share_of_prefill'] * 100:.2f}% of the prefill, on {smi}")
    log(json.dumps({"served_generation": served}))
    with torch.inference_mode():
        for name, fn in (("prefill", first_token),
                         ("generate", lambda: generate(params, tok32, cfg, new, use_flash=True))):
            prof = device_profile(torch, fn, name)
            log(f"[times] profiled {name} (B={GEN_B}, S={GEN_S}): wall {prof['wall_ms']:.3f} ms, "
                f"device kernels {prof['kernel_ms']:.3f} ms in {prof['kernels']} launches, "
                f"busy {prof['busy_share'] * 100:.1f}% on {smi}")
            log(json.dumps({f"profile_{name}": prof}))
    log(f"[times] phase wall {time.perf_counter() - t_phase:.2f} s")
    top = timings[0]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/flash_attention.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": "B=32 H=16 KV=4 S=512 D=64 causal bf16",
        "at": timings,
        "served": served,
    }


def copy_batch(rng, vocab: int):
    """bench.py:2105-2108: each row a random head repeated three times."""
    head = rng.integers(1, vocab, size=(TRAIN_B, TRAIN_HALF))
    return np.concatenate([head, head, head], axis=1)


def loss_and_grads(torch, lm_loss, params, batch, cfg, use_flash: bool):
    from seldon_core_tpu_torch.tree import leaves_with_paths, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = lm_loss(live, batch, cfg, use_flash=use_flash)
    leaves = leaves_with_paths(live)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {k: g for (k, _), g in zip(leaves, grads)}


def training_phases(torch, dev, smi):
    """Phases 9-12: the backward kernels against their plain version, the
    flagship config trained 20 steps through them, its checkpoint served
    through weights_path, and their times.  Returns the dQ and dK/dV rows
    of the kernels line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.generate import generate
    from seldon_core_tpu_torch.models.transformer import (
        LMConfig, lm_init, lm_loss, lm_train_step, load_lm_weights, resolve_train_flash,
        save_lm_weights)
    from seldon_core_tpu_torch.ops import flash_attention as fa, fused_mlp
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.tree import leaves_with_paths

    bwd_errs = flash_bwd_phase(torch, fa, dev)

    # -- 10. train --------------------------------------------------------
    t_phase = time.perf_counter()
    dims = {k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"}
    cfg = LMConfig(**dims, dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(SEED), cfg, dev)
    if not resolve_train_flash(cfg, dev):  # asks both shape checks; probes both once
        raise AssertionError("training did not take the flash kernels at the flagship config")
    rng = np.random.default_rng(SEED)
    vocab = cfg.vocab

    def batch():
        return {"tokens": torch.as_tensor(copy_batch(rng, vocab), dtype=torch.int32, device=dev)}

    first = batch()
    loss_k, grads_k = loss_and_grads(torch, lm_loss, params, first, cfg, True)
    loss_p, grads_p = loss_and_grads(torch, lm_loss, params, first, cfg, False)
    rel = {k: float((grads_k[k].float() - grads_p[k].float()).norm()
                    / grads_p[k].float().norm()) for k in grads_p}
    worst_leaf = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[train] one step at B={TRAIN_B}, S={first['tokens'].shape[1] - 1}: loss kernel path "
        f"{loss_k:.6f}, plain path {loss_p:.6f} (relative {loss_rel:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); gradients, relative L2 per leaf: max {rel[worst_leaf]:.3e} at "
        f"{worst_leaf}, median {float(np.median(list(rel.values()))):.3e} over {len(rel)} "
        f"leaves (tolerance {TRAIN_GRAD_REL_L2})")
    if (loss_rel > TRAIN_LOSS_RTOL or rel[worst_leaf] > TRAIN_GRAD_REL_L2
            or not all(bool(torch.isfinite(g.float()).all()) for g in grads_k.values())):
        raise AssertionError(f"kernel-path gradients differ from the plain path: {rel}")
    del grads_k, grads_p

    opt = adam(TRAIN_LR)
    opt_state = opt.init(params)
    losses, walls = [], []
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fused_mlp.LAUNCHES = 0
    for _ in range(TRAIN_STEPS):
        b = batch()
        t = time.perf_counter()
        params, opt_state, loss = lm_train_step(params, opt_state, b, opt, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = {"fwd": fa.LAUNCHES, "dq": fa.DQ_LAUNCHES, "dkv": fa.DKV_LAUNCHES,
                "fused_mlp": fused_mlp.LAUNCHES}
    want = cfg.n_layers * TRAIN_STEPS
    if launches != {"fwd": want, "dq": want, "dkv": want, "fused_mlp": 0}:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}, not "
                             f"{cfg.n_layers} of each flash kernel per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    step_ms = float(np.median(walls) * 1e3)
    tokens = TRAIN_B * (first["tokens"].shape[1] - 1)
    log(f"[train] {TRAIN_STEPS} steps of adam({TRAIN_LR}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, all finite; launches {launches} = {cfg.n_layers} forward + "
        f"{cfg.n_layers} dQ + {cfg.n_layers} dK/dV per step")
    prof = device_profile(torch, lambda: lm_train_step(params, opt_state, first, opt, cfg),
                          "train_step")
    trained = {"step_wall_p50_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
               "losses": losses, "launches": launches, "profile": prof, "card": smi}
    log(f"[train] step wall p50 {step_ms:.3f} ms, {trained['tokens_per_s']:.1f} trained "
        f"tokens/s; profiled step: wall {prof['wall_ms']:.3f} ms, device kernels "
        f"{prof['kernel_ms']:.3f} ms in {prof['kernels']} launches, busy "
        f"{prof['busy_share'] * 100:.1f}% on {smi}")
    log(json.dumps({"training": trained}))
    log(f"[train] phase wall {time.perf_counter() - t_phase:.2f} s")

    # -- 11. hand-off -----------------------------------------------------
    t_phase = time.perf_counter()
    path = ROOT / "build" / "chip_smoke_trained_lm.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        save_lm_weights(params, str(path))
        back = load_lm_weights(lm_init(torch.Generator().manual_seed(SEED + 1), cfg, dev),
                               str(path))
        for (key, got), (_, want_t) in zip(leaves_with_paths(back), leaves_with_paths(params)):
            if got.dtype != torch.bfloat16 or not torch.equal(got, want_t):
                raise AssertionError(f"checkpoint round trip changed {key}")
        log(f"[hand-off] save_lm_weights -> load_lm_weights: {path.stat().st_size / 1e6:.1f} MB, "
            f"every bf16 leaf bit-identical")
        del back
        spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(
            gen_deployment(weights_path=str(path))))
        engine = EngineService(spec, device=dev)
    finally:
        path.unlink(missing_ok=True)
    served_params = engine.states()["gen"]["params"]
    if not all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves_with_paths(served_params), leaves_with_paths(params))):
        raise AssertionError("the generator's weights are not the trained weights")
    prompt = copy_batch(np.random.default_rng(SEED + 1), vocab)[:1, :GEN_S]
    server = ServerThread(engine)
    port = server.start()
    try:
        fa.LAUNCHES = 0
        st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                          {"data": {"ndarray": prompt.tolist()}})
        served_launches = fa.LAUNCHES
    finally:
        server.stop()
    served = check_tokens(st, raw, prompt, "ndarray")
    if served_launches != cfg.n_layers:
        raise AssertionError(f"the served prefill launched the flash kernel {served_launches} "
                             f"times, not {cfg.n_layers}")
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        local = generate(params, tok, cfg, GEN_DIMS["max_new_tokens"], use_flash=True).cpu().numpy()
    if np.array_equal(served, local):
        held = "identical to an in-process generate on the trained params"
    else:
        from seldon_core_tpu_torch.models.transformer import lm_apply

        gap, _ = teacher_forced(torch, lm_apply, params, cfg, prompt, served, dev)
        if gap.max() > TOKEN_DELTA:
            raise AssertionError(f"served tokens differ from generate and a served token is "
                                 f"{gap.max():.4f} below the plain maximum")
        held = (f"not identical to generate ({int((served != local).sum())} tokens differ); "
                f"each within {gap.max():.5f} of the plain maximum (delta {TOKEN_DELTA})")
    log(f"[hand-off] a TransformerGenerator with weights_path, over REST: 1x{GEN_S} copy-task "
        f"prompt -> {served.shape[1]} tokens, {held}; {served_launches} flash launches")
    log(f"[hand-off] phase wall {time.perf_counter() - t_phase:.2f} s")
    del params, opt_state, served_params

    # -- 12. times --------------------------------------------------------
    t_phase = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 4)
    rows = {"dq": [], "dkv": []}
    for shape in FLASH_BWD_TIMED:
        q, k, v, o, lse, do = flash_bwd_inputs(torch, fa, shape, gen, dev)
        by_name = kernel_ms_by_name(
            torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), 20)
        g = shape[1] // shape[2]
        krep, vrep = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        dsum = torch.sum(do.float() * o.float(), dim=-1)
        plain = {
            "dq": device_ms(torch, lambda: fa._dq_reference(q, krep, vrep, do, lse, dsum, True), 5),
            "dkv": device_ms(torch, lambda: fa._dkv_reference(q, krep, vrep, do, lse, dsum, True),
                             5),
        }
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        lib_ms = device_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                              retain_graph=True), 20)
        for kern, tag in (("dq", "flash_bwd_dq_kernel"), ("dkv", "flash_bwd_dkv_kernel")):
            ms = sum(v for name, v in by_name.items() if tag in name)
            b_ms, b_by = flash_bwd_bound(shape, kern)
            rows[kern].append({"shape": list(shape), "ms": ms, "plain_ms": plain[kern],
                               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
            log(f"[times] {kern} (B,H,KV,S,D)={shape} causal: kernel {ms:.5f} ms, plain "
                f"{plain[kern]:.5f} ms, SDPA backward (dq, dk and dv) {lib_ms:.5f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}) on {smi}")
        del q, k, v, o, lse, do, krep, vrep, qs, ks, vs, out
    log(f"[times] phase wall {time.perf_counter() - t_phase:.2f} s")
    out_rows = []
    for kern, name, line, launches_k in (
            ("dq", "flash_attention_bwd_dq", 208, launches["dq"]),
            ("dkv", "flash_attention_bwd_dkv", 252, launches["dkv"])):
        top = rows[kern][0]
        out_rows.append({
            "name": name,
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": f"seldon_core_tpu/ops/flash_attention.py:{line}",
            "launches": launches_k,
            "max_abs_err": bwd_errs[kern],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": "B=16 H=16 KV=4 S=512 D=64 causal bf16",
            "at": rows[kern],
        })
    return out_rows


def mnist_phases(torch, dev, smi) -> dict:
    """Phases 3-5 on examples/mnist_deployment.json; returns the fused-MLP
    row of the {"kernels": [...]} line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.mnist import mlp_apply, mlp_init
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.engine import EngineService

    # -- 3. kernel vs plain --------------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    max_err = 0.0
    shapes = {}
    for hidden in (256, 512):
        params = random_params(torch, mlp_init, hidden, gen, dev)
        shapes[hidden] = params
        for batch in (1, 7, 32, 64, 128, 1024):
            x = torch.rand(batch, 784, generator=gen).to(dev)
            got = fused_mlp.fused_mlp_softmax(params, x)
            want = fused_mlp.fused_mlp_softmax_reference(params, x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.isfinite(got).all() or err > KERNEL_ATOL:
                raise AssertionError(
                    f"kernel vs plain at 784-{hidden}-{hidden}-10 B={batch}: "
                    f"max abs err {err:.3e} > {KERNEL_ATOL}")
            max_err = max(max_err, err)
            log(f"[kernel] 784-{hidden}-{hidden}-10 B={batch:5d}: max abs err "
                f"{err:.3e} (tolerance {KERNEL_ATOL})")

    # -- 4. serve ------------------------------------------------------------
    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
    t0 = time.perf_counter()
    engine = EngineService(spec, device="cuda")
    log(f"[serve] engine built in {time.perf_counter() - t0:.3f} s; its unit "
        f"probed the kernel ({fused_mlp.LAUNCHES} launches so far, all before "
        f"the serve run)")
    unit = engine.compiled.units["mnist"]
    if unit.path != "kernel":
        raise AssertionError(f"the served unit took path {unit.path!r}, not the kernel")
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(SEED)
    x1 = rng.random((1, 784))
    x64 = rng.random((64, 784))
    xs32 = [rng.random((1, 784)) for _ in range(32)]
    try:
        fused_mlp.LAUNCHES = 0
        s1 = request("POST", f"{url}/api/v0.1/predictions", {"data": {"ndarray": x1.tolist()}})
        s64 = request("POST", f"{url}/api/v0.1/predictions",
                   {"data": {"tensor": {"shape": [64, 784], "values": x64.ravel().tolist()}}})
        with ThreadPoolExecutor(32) as pool:
            s32 = list(pool.map(
                lambda x: request("POST", f"{url}/api/v0.1/predictions",
                               {"data": {"ndarray": x.tolist()}}), xs32))
        body = json.dumps({"data": {"ndarray": x1.tolist()}})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:  # one keepalive connection, as a load balancer or SDK holds
            http_walls = []
            for _ in range(SERVE_P50_REQUESTS):
                t = time.perf_counter()
                conn.request("POST", "/api/v0.1/predictions", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                http_walls.append(time.perf_counter() - t)
                if resp.status != 200:
                    raise AssertionError(f"latency loop: HTTP {resp.status}")
        finally:
            conn.close()
        launches = fused_mlp.LAUNCHES
        st_stats, raw_stats = request("GET", f"{url}/stats")
        # where the served request's time goes, layer by layer (these
        # calls launch the kernel too, after the count was read)
        engine_walls, dispatch_walls = [], []
        for _ in range(SERVE_P50_REQUESTS):
            t = time.perf_counter()
            text, st = asyncio.run_coroutine_threadsafe(
                engine.predict_json(body), server.loop).result(120)
            engine_walls.append(time.perf_counter() - t)
            if st != 200:
                raise AssertionError(f"in-process predict_json: {st}")
        for _ in range(SERVE_P50_REQUESTS):
            t = time.perf_counter()
            engine._batched_predict_sync(x1)
            dispatch_walls.append(time.perf_counter() - t)
    finally:
        server.stop()
    if launches <= 0:
        raise AssertionError("the serve phase launched the fused-MLP kernel 0 times")
    stats = json.loads(raw_stats)
    if st_stats != 200 or stats.get("device") != "cuda":
        raise AssertionError(f"/stats does not report device cuda: {raw_stats[:300]!r}")

    state = engine.states()["mnist"]

    def plain(x):
        return fused_mlp.fused_mlp_softmax_reference(
            state, torch.as_tensor(x, dtype=torch.float32, device=dev)).cpu().numpy()

    serve_err = 0.0
    for x, (st, raw), kind in ([(x1, s1, "ndarray"), (x64, s64, "tensor")]
                               + [(x, r, "ndarray") for x, r in zip(xs32, s32)]):
        y = check_answer(st, raw, len(x), kind)
        serve_err = max(serve_err, float(np.abs(y - plain(x)).max()))
    if serve_err > KERNEL_ATOL:
        raise AssertionError(f"served answers differ from the plain version by "
                             f"{serve_err:.3e} > {KERNEL_ATOL}")
    p50_ms = float(np.median(http_walls) * 1e3)
    log(f"[serve] 1-row ndarray, 64-row tensor, 32 concurrent 1-row and "
        f"{SERVE_P50_REQUESTS} sequential 1-row requests: all 200, wire kinds "
        f"kept, max abs err vs plain {serve_err:.3e} (tolerance {KERNEL_ATOL})")
    log(f"[serve] fused_mlp_softmax launches during the serve run: {launches} "
        f"(/stats reports {stats['kernels']['fused_mlp_softmax']['launches']}) "
        f"for {2 + len(xs32) + SERVE_P50_REQUESTS} requests")
    served = {
        "http_p50_ms": p50_ms,
        "engine_predict_json_p50_ms": float(np.median(engine_walls) * 1e3),
        "dispatch_p50_ms": float(np.median(dispatch_walls) * 1e3),
        "requests": SERVE_P50_REQUESTS,
        "card": smi,
    }
    log(f"[serve] 1-row request p50: HTTP keepalive {served['http_p50_ms']:.3f} ms; "
        f"engine.predict_json {served['engine_predict_json_p50_ms']:.3f} ms; "
        f"dispatch (graph + readback) {served['dispatch_p50_ms']:.3f} ms")
    log(json.dumps({"served": served}))

    # -- 5. times ------------------------------------------------------------
    params = shapes[256]
    dims = [784, 256, 256, 10]
    timings = {}
    for batch, iters in ((1, 500), (1024, 200)):
        x = torch.rand(batch, 784, generator=gen).to(dev)
        k_ms = device_ms(torch, lambda: fused_mlp.fused_mlp_softmax(params, x), iters)
        p_ms = device_ms(torch, lambda: fused_mlp.fused_mlp_softmax_reference(params, x), iters)
        l_ms = device_ms(torch, lambda: torch.softmax(mlp_apply(params, x), dim=-1), iters)
        b_ms, b_by = mlp_bound(dims, batch)
        timings[batch] = {"B": batch, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                          "bound_ms": b_ms, "bound_by": b_by}
        log(f"[times] 784-256-256-10 B={batch}: kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, library {l_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}) "
            f"on {smi}")

    top = timings[1]
    row = {
        "name": "fused_mlp_softmax",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "seldon_core_tpu/ops/fused_mlp.py:44",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": "784-256-256-10",
        "at": [timings[1], timings[1024]],
        "served_p50_ms": p50_ms,
    }
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from seldon_core_tpu_torch.ops import _build, flash_attention, fused_mlp
        from seldon_core_tpu_torch.runtime.engine import EngineService  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 1

    # the plain version's f32 products must be true f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    log(f"[device] phase wall {time.perf_counter() - T_START:.2f} s since start")
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)  # one nvcc per source, all started together
    log(f"[build] {', '.join(KERNEL_SOURCES)}: {time.perf_counter() - t0:.2f} s wall")
    for name in KERNEL_SOURCES:
        info = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")
    smem, why = fused_mlp._smem_bytes([784, 256, 256, 10])
    if why is not None or smem != 50688 + 16896 + 33792 + 8192 + 2048:
        raise AssertionError(f"shape check at 784-256-256-10: {smem} bytes, {why!r}")
    for dims, dtype, match in (([4096, 4096, 4096, 10], torch.bfloat16, "shared memory"),
                               ([24, 64, 10], torch.bfloat16, "multiple of 16"),
                               ([16] * 10 + [10], torch.bfloat16, "at most 8")):
        why = fused_mlp.kernel_shape_error(dims, [dtype] * (2 * len(dims) - 2))
        if why is None or match not in why:
            raise AssertionError(f"shape check let {dims} through: {why!r}")
    log(f"[build] shape check: 784-256-256-10 takes {smem} bytes of shared memory; "
        f"4096-wide, 24-wide and 10-layer MLPs refused")
    flash_build_checks(torch, flash_attention)
    log(f"[build] phase wall {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mlp_row = mnist_phases(torch, dev, smi)
    log(f"[mnist] phases 3-5 wall {time.perf_counter() - t0:.2f} s")
    flash_row = generation_phases(torch, dev, smi)
    dq_row, dkv_row = training_phases(torch, dev, smi)

    log(smi)
    log(json.dumps({"kernels": [mlp_row, flash_row, dq_row, dkv_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
