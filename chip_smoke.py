#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of the served path from the sources in this checkout,
holds each against its plain PyTorch version on the card, serves
``examples/mnist_deployment.json`` (784 -> 256 -> 256 -> 10, bf16, random
weights from a seed) through the port's engine and REST lane on a
localhost port, checks the answers, shows that the serving run went
through the kernel, and times the kernel beside its plain version, a
PyTorch library chain and its bound.  Phases, in order; any failure exits
non-zero without the final line:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    nvcc build of ops/csrc/fused_mlp.cu, with ptxas's report, and
              the kernel's own shape check (fused_mlp_smem_bytes) asked
              for the served widths and for three it must refuse
  3. kernel   fused_mlp_softmax vs fused_mlp_softmax_reference at
              784-256-256-10 and 784-512-512-10 with non-zero biases,
              B in {1, 7, 32, 64, 128, 1024} (32 and 64 are the served
              stacks)
  4. serve    engine construction (the unit probes the kernel), then
              1-row ndarray, 64-row tensor, 32 concurrent 1-row requests
              and a 1-row latency loop over one keepalive connection, all
              through POST /api/v0.1/predictions; kernel launch counts
              reset just before, read just after; then the same request's
              p50 inside the engine and at the dispatch, layer by layer
  5. times    kernel / plain / library device times and the bound at
              B=1 and B=1024, one JSON line {"kernels": [...]}
  6. last line {"ok": true, "device": {"platform": "gpu", ...}}

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

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_ATOL = 2e-3   # kernel vs plain, probabilities: both round at the same
#                      bf16 casts, only the order of the f32 sums differs.
#                      Served answers are the same kernel against the same
#                      plain version, so they are held to it too.
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
SERVE_P50_REQUESTS = 200


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from seldon_core_tpu_torch.graph.defaulting import default_and_validate
        from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
        from seldon_core_tpu_torch.models.mnist import mlp_apply, mlp_init
        from seldon_core_tpu_torch.ops import _build, fused_mlp
        from seldon_core_tpu_torch.runtime.engine import EngineService
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
    t0 = time.perf_counter()
    _build.load_library("fused_mlp")
    info = _build.BUILD_INFO["fused_mlp"]
    log(f"[build] fused_mlp: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
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
    log(smi)
    log(json.dumps({"kernels": [row]}))
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
