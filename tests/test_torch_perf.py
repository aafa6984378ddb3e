"""The port's perf observatory and generation-lane recorder
(``seldon_core_tpu_torch/utils/{perf,genperf}.py``) against the JAX
package's, with the peaks, cost features and times injected: equal rows,
roofline classes, anomaly counts, seeds and documents.  Then what only
the port has: ``executable_key`` without ``jax.dtypes`` (one request, one
key in both packages), the analytic cost the fused MLP's dispatch
registers (``ops/fused_mlp.py:dispatch_cost``), the card's peaks and
memory rows read through ``torch.cuda``, and a CPU engine's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seldon_core_tpu.utils import genperf as jgp
from seldon_core_tpu.utils import perf as jperf
from seldon_core_tpu_torch.graph.compiled import CompiledGraph
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.ops import fused_mlp
from seldon_core_tpu_torch.utils import genperf as pgp
from seldon_core_tpu_torch.utils import perf as pperf

PEAKS = {"device_kind": "test card", "platform": "gpu", "peak_bf16_tflops": 989.0,
         "peak_hbm_gbs": 3350.0, "peak_assumed": False}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shape", [(1, 784), (64, 784), (3, 2, 5), ()])
@pytest.mark.parametrize("np_dtype,torch_dtype,jax_dtype", [
    (np.float64, torch.float64, None),
    (np.float32, torch.float32, jnp.float32),
    (np.int64, torch.int64, None),
    (np.int32, torch.int32, jnp.int32),
    (None, torch.bfloat16, jnp.bfloat16),
])
def test_executable_key_equals_the_jax_key(shape, np_dtype, torch_dtype, jax_dtype):
    """The JAX key canonicalizes through jax.dtypes with x64 off; the
    port's demotes by itself and names torch dtypes as numpy does."""
    ref_dtype = np_dtype if np_dtype is not None else jnp.bfloat16
    want = jperf.executable_key("predict", shape, ref_dtype)
    assert pperf.executable_key("predict", shape, torch_dtype) == want
    if np_dtype is not None:
        assert pperf.executable_key("predict", shape, np_dtype) == want
    if jax_dtype is not None:
        assert pperf.executable_key("predict", shape, np.dtype(jax_dtype)) == want


@pytest.mark.parametrize("cost", [
    None, {}, [], {"flops": -1.0}, {"flops": 2.0e9, "bytes accessed": 1.0e6},
    [{"flops": 5.0, "bytes accessed": 7.0, "bytes accessed output": 3.0}],
    {"flops": 0, "bytes accessedout{}": 9.0},
])
def test_extract_cost_features_matches(cost):
    assert pperf.extract_cost_features(cost) == jperf.extract_cost_features(cost)


def _observatories(**kw):
    j, p = jperf.PerfObservatory(enabled=True, **kw), pperf.PerfObservatory(enabled=True, **kw)
    j._peaks, p._peaks = dict(PEAKS), dict(PEAKS)
    return j, p


def _feed(obs, seed: int):
    """A seeded dispatch stream over three executables: a compute-shaped
    one, a memory-shaped one and a latency-only one, with slow outliers
    that trip both anomaly kinds."""
    rng = np.random.default_rng(seed)
    obs.record_compile("predict[64x784/float32]",
                       {"flops": 2.6e7, "bytes_accessed": 6.0e5, "output_bytes": 2560.0}, 0.8)
    obs.record_compile("gen_decode_step",
                       {"flops": 1.7e8, "bytes_accessed": 1.7e8, "output_bytes": 0.0}, None)
    obs.record_compile("predict[1x4/float32]", None, 0.01)
    out = []
    for i in range(60):
        for key in ("predict[64x784/float32]", "gen_decode_step", "predict[1x4/float32]"):
            secs = float(rng.lognormal(-7.0, 0.2))
            if i in (40, 51):
                secs *= 25.0  # outliers
            out.append(obs.observe_dispatch(key, secs, rows=64))
    obs.note_padding(37, 64)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_dispatch_rows_classes_and_anomalies_match(seed):
    j, p = _observatories(min_calls=10)
    dj, dp = _feed(j, seed), _feed(p, seed)
    assert dp == dj  # every derived figure, bound and anomaly, exact
    assert p.document()["executables"] == j.document()["executables"]
    assert {k: v for k, v in p.document().items() if k not in ("hbm",)} == \
        {k: v for k, v in j.document().items() if k not in ("hbm",)}
    assert p.snapshot() == j.snapshot()
    for key in ("predict[64x784/float32]", "gen_decode_step", "predict[1x4/float32]"):
        assert p.seed_predicted_s(key) == j.seed_predicted_s(key)
        assert p.cost_features(key) == j.cost_features(key)
    assert {d.get("bound") for d in dp} - {None}  # classified rows exist
    assert any("anomaly" in d for d in dp)


@pytest.mark.parametrize("overhead_x", [1e9, 10.0, 0.5])
def test_roofline_classes_follow_the_binding_peak(overhead_x):
    j, p = _observatories(overhead_x=overhead_x)
    for obs in (j, p):
        obs.record_compile("c", {"flops": 1e12, "bytes_accessed": 1e6}, None)
        obs.record_compile("m", {"flops": 1e6, "bytes_accessed": 1e10}, None)
    for key in ("c", "m"):
        assert p.observe_dispatch(key, 0.01) == j.observe_dispatch(key, 0.01)


def test_disabled_observatory_records_nothing():
    p = pperf.PerfObservatory(enabled=False)
    p.record_compile("k", {"flops": 1.0}, 1.0)
    assert p.observe_dispatch("k", 0.1) == {}
    assert p.hbm_watermarks(force=True) == []
    assert p.document()["executables"] == []


def test_a_cpu_engine_reports_assumed_peaks_and_null_memory_rows():
    p = pperf.PerfObservatory(enabled=True)
    p.set_device(torch.device("cpu"))
    peaks = p.peaks()
    assert peaks["platform"] == "cpu" and peaks["peak_assumed"] is True
    rows = p.hbm_watermarks(force=True)
    assert rows == [{"device": "cpu:0", "memory_stats": None}]


def test_a_cuda_engine_reads_the_card_s_name_and_memory(monkeypatch):
    """``peaks()`` and ``hbm_watermarks`` through ``torch.cuda`` (stubbed
    here: the CPU has no card): the H100 table's peaks, not assumed, and
    the caching allocator's bytes beside the card's total."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i=0: {
        "allocated_bytes.all.current": 123, "allocated_bytes.all.peak": 456})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i=0: (1000, 85899345920))
    p = pperf.PerfObservatory(enabled=True)
    p.set_device(torch.device("cuda"))
    peaks = p.peaks()
    assert peaks == {"device_kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
                     "peak_bf16_tflops": 989.0, "peak_hbm_gbs": 3350.0, "peak_assumed": False}
    rows = p.hbm_watermarks(force=True)
    assert rows == [{"device": "cuda:0", "bytes_in_use": 123, "peak_bytes_in_use": 456,
                     "bytes_limit": 85899345920}]
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    assert RECORDER.hbm["cuda:0"]["bytes_limit"] == 85899345920


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_fused_mlp_dispatch_cost_is_the_hand_count(rows):
    g = torch.Generator().manual_seed(0)
    dims = [784, 256, 256, 10]
    params = {}
    for i in range(3):
        params[f"w{i}"] = torch.randn(dims[i], dims[i + 1], generator=g).to(torch.bfloat16)
        params[f"b{i}"] = torch.zeros(dims[i + 1], dtype=torch.bfloat16)
    cost = fused_mlp.dispatch_cost(params, rows)
    flops = 2 * rows * (784 * 256 + 256 * 256 + 256 * 10)
    weights = 2 * (784 * 256 + 256 + 256 * 256 + 256 + 256 * 10 + 10)
    assert cost == {"flops": float(flops),
                    "bytes_accessed": float(weights + 4 * rows * 784 + 4 * rows * 10),
                    "output_bytes": float(4 * rows * 10)}


def test_compiled_graph_registers_its_cost_at_the_first_walk(monkeypatch):
    obs = pperf.PerfObservatory(enabled=True)
    monkeypatch.setattr("seldon_core_tpu_torch.graph.compiled.OBSERVATORY", obs)
    spec = SeldonDeploymentSpec.from_json_dict({"spec": {"name": "d", "predictors": [{
        "name": "p",
        "components": [{"name": "m", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": "32", "type": "INT"}]}],
        "graph": {"name": "m", "type": "MODEL", "children": []}}]}})
    cg = CompiledGraph(spec.predictor(), device="cpu")
    x = np.zeros((4, 784))
    cg.predict_arrays(x)
    cg.predict_arrays(x)
    key = cg.executable_key(x)
    assert key == "predict[4x784/float32]"
    ent = obs._execs[key]
    want = fused_mlp.dispatch_cost(cg.states["m"], 4)
    assert ent.cost == want and ent.compile_s is not None and ent.compile_s > 0
    assert cg.phases is None  # one node: nothing to decompose


def _tick_details(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        kind = ["prefill", "decode", "mixed", "idle", "decode"][i % 5]
        wall = float(rng.uniform(1e-4, 5e-3))
        dev = {} if kind == "idle" else {"decode": wall * 0.6} if kind != "prefill" \
            else {"prefill": wall * 0.7}
        d = {"wall_s": wall, "device_s": sum(dev.values()),
             "phases": {"admit": wall * 0.05, "decode": wall * 0.8, "retire": wall * 0.05},
             "device_phases": dev, "rows": 8, "real_rows": int(rng.integers(1, 9)),
             "tokens": int(rng.integers(0, 64)), "steps": 8 if kind != "prefill" else 0,
             "kv_positions": int(rng.integers(0, 4096)), "kv_blocks": int(rng.integers(0, 64)),
             "kv_ages": ((int(rng.integers(1, 5)), float(rng.uniform(0, 2))),) if i % 7 == 0
             else ()}
        if i % 3:
            d["bubble_s"] = float(rng.uniform(0, 1e-3))
            d["bubble_cause"] = ["host", "admission_stall", "pool_exhaustion", "idle"][i % 4]
        out.append((kind, d))
    return out


@pytest.fixture
def _decode_costs():
    """The same decode-step features and peaks in both packages' global
    observatories, restored after."""
    feats = {"flops": 2.0e8, "bytes_accessed": 1.7e8, "output_bytes": 0.0,
             "kv_bytes_per_position": 49152.0}
    saved = []
    for mod in (jperf, pperf):
        obs = mod.OBSERVATORY
        saved.append((obs, obs._peaks, obs.enabled))
        obs.enabled = True
        obs._peaks = dict(PEAKS)
        obs.record_compile("gen_decode_step", feats, None)
    yield
    for obs, peaks, enabled in saved:
        obs._peaks, obs.enabled = peaks, enabled
        with obs._lock:
            obs._execs.pop("gen_decode_step", None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_genperf_document_equals_the_jax_recorder_s(seed, _decode_costs):
    j, p = jgp.GenPerf(), pgp.GenPerf()
    for kind, d in _tick_details(seed):
        j.observe_tick(kind, dict(d))
        p.observe_tick(kind, dict(d))
    j.observe_tick_error()
    p.observe_tick_error()
    assert p.document() == j.document()
    assert p.bubble_fraction() == j.bubble_fraction()
    served = p.document()["served_decode"]
    assert 0 < served["served_decode_mfu_pct"] and 0 < served["served_decode_hbm_bw_util_pct"]
    acc = p.document()["accounting"]
    assert acc["accounted_fraction"] >= 0.95  # host + device + bubble cover the wall
