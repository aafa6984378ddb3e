"""The port's quality observatory (``seldon_core_tpu_torch/utils/quality.py``)
against the JAX package's on the same inputs, made with numpy from a seed:
the score math to 1e-12, the reference window's quantile thresholds
exactly, the torch summarizer's counts equal to the numpy twin's exactly
(NaN, +-inf, pad rows and ``n`` below the rows among the cases) and its
sums within 1e-5 relative, ``document()`` drift scores within 1e-9 after
the same batches, the SLO burn rates, the router read-back on torch state
(a ``cuda`` case on the card), the agreement rule and the reference
action's errors.  Then end to end: the JAX engine and the port's engine on
``examples/mnist_deployment.json`` (weights carried across) fed the same
seeded batches give the same x-drift scores, and the port's routes answer
the quality documents, with ``/stats``' ``quality`` and ``routers``."""

import asyncio
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.utils import hotrecord as jhr
from seldon_core_tpu.utils import quality as jq
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models.mab import EpsilonGreedyRouter
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.utils import hotrecord as phr
from seldon_core_tpu_torch.utils import quality as pq
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    # the autopilot's table, the brownout ladder, the fleet burn view and the
    # cost ledger are process-global and change decisions: what one test
    # trained must not steer the next
    reset_learned_singletons()
    yield


# ---------------------------------------------------------------------------
# score math and the summarizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_psi_and_ks_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 50, size=(7, 10)).astype(np.float64)
    live = rng.integers(0, 50, size=(7, 10)).astype(np.float64)
    live[0, :3] = 0  # empty bins: the 1e-6 floor
    np.testing.assert_allclose(pq.psi(ref, live), jq.psi(ref, live), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pq.ks_statistic(ref, live), jq.ks_statistic(ref, live),
                               rtol=0, atol=1e-12)


def _nodes(rows, y_cols=3, n_bins=10):
    """A reference and a port node window fed the same reference rows."""
    rng = np.random.default_rng(5)
    X = rng.normal(0.0, 1.0, (rows, 6))
    Y = rng.random((rows, y_cols))
    jn = jq._NodeQuality("n", n_bins, rows, 64)
    pn = pq._NodeQuality("n", n_bins, rows, 64)
    for lo in range(0, rows, 16):
        jn._collect_reference(X[lo:lo + 16], Y[lo:lo + 16])
        pn._collect_reference(X[lo:lo + 16], Y[lo:lo + 16])
    return jn, pn


@pytest.mark.parametrize("rows", [64, 256])
def test_freeze_thresholds_equal_the_reference_exactly(rows):
    jn, pn = _nodes(rows)
    assert jn.frozen and pn.frozen
    for attr in ("x_thr", "y_thr", "ref_x_counts", "ref_y_counts", "ref_x_mean", "ref_x_std"):
        assert np.array_equal(getattr(pn, attr), getattr(jn, attr)), attr


def _batch(case, rng, F=6, C=3):
    X = rng.normal(0.0, 1.0, (48, F)).astype(np.float64)
    Y = rng.random((48, C))
    n = 48
    if case == "nan":
        X[3, 1] = np.nan
        X[7, :] = np.nan
        Y[2, 0] = np.nan
    elif case == "inf":
        X[0, 0], X[1, 2], X[5, 5] = np.inf, -np.inf, np.inf
        Y[4, 1] = -np.inf
    elif case == "pad_rows":
        # the batcher's pad rows repeat the last real row; n masks them
        n = 37
        X[n:] = X[n - 1]
        Y[n:] = Y[n - 1]
    elif case == "short_n":
        n = 5
        X[n:] = np.inf  # never read
    elif case == "int_y":
        Y = rng.integers(0, 10, size=(48, 1)).astype(np.int64)
    elif case == "one_col":
        Y = rng.random((48,))
    return X, Y, n


@pytest.mark.parametrize("case", ["plain", "nan", "inf", "pad_rows", "short_n", "int_y",
                                  "one_col"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_torch_summarizer_counts_equal_the_numpy_twin(case, as_tensor):
    jn, _ = _nodes(64)
    rng = np.random.default_rng(11)
    X, Y, n = _batch(case, rng)
    Yr = Y.reshape(len(Y), -1)
    thr_y = jn.y_thr if Yr.shape[1] == 3 else np.quantile(Yr[:n], np.arange(1, 10) / 10).astype(
        np.float32)
    want = jq._summarize_np(X, Yr, jn.x_thr, thr_y, n)
    args = (torch.from_numpy(X), torch.from_numpy(np.asarray(Y))) if as_tensor else (X, Y)
    got = pq._summarize_torch(*args, jn.x_thr, thr_y, n)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[3], want[3])
    for g, w in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=1e-5, atol=0, equal_nan=True)
    # the port's numpy twin is the reference's, bit for bit
    for g, w in zip(pq._summarize_np(X, Yr, jn.x_thr, thr_y, n), want):
        assert np.array_equal(np.asarray(g), np.asarray(w), equal_nan=True)


def _feed(obs, ref, batches):
    for lo in range(0, len(ref), 32):
        obs.observe_batch("m", ref[lo:lo + 32], ref[lo:lo + 32, :2])
    for X in batches:
        obs.observe_batch("m", X, X[:, :2], real_rows=len(X) - 3)


@pytest.mark.parametrize("use_numpy", [False, True])
def test_document_drift_equals_the_reference_after_the_same_batches(use_numpy):
    rng = np.random.default_rng(3)
    ref = rng.normal(0.0, 1.0, (128, 5))
    batches = [rng.normal(0.0, 1.0, (40, 5)), rng.normal(0.5, 1.5, (40, 5)),
               rng.normal(1.0, 1.0, (8, 5))]
    kw = dict(enabled=True, sample=1.0, n_bins=8, ref_target=128)
    j = jq.QualityObservatory(use_numpy=True, **kw)
    p = pq.QualityObservatory(use_numpy=use_numpy, **kw)
    _feed(j, ref, batches)
    _feed(p, ref, batches)
    jd, pd = j.document(), p.document()
    jrow, prow = jd["nodes"][0], pd["nodes"][0]
    assert set(prow) == set(jrow) and prow["status"] == "live"
    for k, v in jrow["drift"].items():
        assert abs(prow["drift"][k] - v) <= 1e-9, k
    # live_mean is a float32 sum over the live window: within 1e-5 relative
    strip = [{k: v for k, v in f.items() if k != "live_mean"} for f in prow["top_features"]]
    assert strip == [{k: v for k, v in f.items() if k != "live_mean"}
                     for f in jrow["top_features"]]
    np.testing.assert_allclose([f["live_mean"] for f in prow["top_features"]],
                               [f["live_mean"] for f in jrow["top_features"]], rtol=1e-5,
                               atol=1e-6)
    assert prow["prediction_quantiles"] == jrow["prediction_quantiles"]
    assert {k: prow[k] for k in ("sampled_batches", "sampled_rows", "ref_rows", "live_rows")} \
        == {k: jrow[k] for k in ("sampled_batches", "sampled_rows", "ref_rows", "live_rows")}
    assert set(pd) == set(jd)
    # 40-row batches take the torch path unless use_numpy; the 8-row one
    # and the reference window never do
    assert p.summarizer_rows == ({"torch": 0, "numpy": 79} if use_numpy
                                 else {"torch": 74, "numpy": 5})
    assert p.snapshot().keys() == j.snapshot().keys()


@pytest.mark.parametrize("objectives", [(250.0, None), (None, 0.05), (100.0, 0.0), (None, None)])
def test_slo_burn_rates_equal_the_reference(objectives):
    p99, err = objectives
    jt, pt = jq.SloTracker(p99_ms=p99, error_rate=err), pq.SloTracker(p99_ms=p99, error_rate=err)
    jten = jq.SloTracker(p99_ms=p99, error_rate=err, horizon=300)
    pten = pq.SloTracker(p99_ms=p99, error_rate=err, horizon=300)
    rng = np.random.default_rng(7)
    now = 1_000_000.0
    for i in range(400):
        lat, bad = float(rng.exponential(0.1)), bool(rng.random() < 0.03)
        for t in (jt, pt, jten, pten):
            t.record(lat, error=bad, now=now - 2000 + 5 * i)
    assert pt.burn_rates(now) == jt.burn_rates(now)
    assert pt.window_counts(now) == jt.window_counts(now)
    assert pten.burn_rates(now) == jten.burn_rates(now)
    assert pt.configured == jt.configured


def test_router_quality_reads_torch_state_on_the_cpu():
    router = EpsilonGreedyRouter(n_branches=3)
    st = router.init_state(None)
    X = torch.zeros((4, 2))
    for branch, reward in ((0, 1.0), (1, 0.25), (1, 0.5), (2, 0.0), (0, 0.75)):
        st = router.send_feedback(st, X, branch, reward, None)
    got = pq.router_quality({"eg": st, "other": {"w": torch.ones(2)}})
    want = jq.router_quality({"eg": {k: st[k].numpy() for k in ("success", "tries")}})
    assert got == want and got["eg"]["total_tries"] == 20.0


@pytest.mark.cuda
def test_router_quality_reads_torch_state_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    router = EpsilonGreedyRouter(n_branches=2)
    st = {k: v.to("cuda") for k, v in router.init_state(None).items()}
    st = router.send_feedback(st, torch.zeros((8, 2), device="cuda"), 1, 0.5, None)
    got = pq.router_quality({"eg": st})
    # the same state on the CPU: the read the CPU test holds to the reference's
    want = pq.router_quality({"eg": {k: v.cpu() for k, v in st.items()}})
    assert got == want and got["eg"]["branches"][1]["tries"] == 8.0


@pytest.mark.parametrize("pair", [
    ([[0.1, 0.9], [0.8, 0.2]], [[0, 1], [0, 1]]),          # argmax rows
    ([[1.0], [2.0005], [3.5]], [[1.0], [2.0], [3.0]]),      # value tolerance
    ([1.0, 2.0, 3.0], [[1.0, 2.0]]),                        # sizes differ
    (None, [[1.0]]),
    ([[0.2, 0.3, 0.5]], [[0.0, 0.0, 1.0]]),
])
def test_agreement_equals_the_reference(pair):
    pred, truth = pair
    want = jq._agreement(pred, truth)
    assert pq._agreement(pred, truth) == want
    if pred is not None:
        assert pq._agreement(torch.tensor(pred), torch.tensor(truth)) == want


@pytest.mark.parametrize("args", [
    (b'{"action": "reset", "node": "m"}', None, None),
    (b"", "freeze", None),
    (b'"reset"', None, None),
    (b"", None, None),
    (b"not json", None, None),
    (b'{"action": "thaw"}', None, None),
    (b"", "explode", "m"),
])
def test_parse_reference_action_equals_the_reference(args):
    def outcome(mod):
        try:
            return mod.parse_reference_action(*args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(pq) == outcome(jq)


def test_feedback_and_outlier_blocks_equal_the_reference():
    kw = dict(enabled=True, sample=1.0, outlier_threshold=2.0)
    j, p = jq.QualityObservatory(**kw), pq.QualityObservatory(**kw)
    rng = np.random.default_rng(4)
    for i in range(6):
        pred = rng.random((3, 4))
        truth = np.eye(4)[rng.integers(0, 4, 3)] if i % 2 else None
        j.record_feedback("main", i / 5, truth=truth, prediction=pred)
        p.record_feedback("main", i / 5, truth=None if truth is None else torch.tensor(truth),
                          prediction=torch.tensor(pred))
        scores = rng.exponential(1.5, 5)
        j.record_outlier_tags({"outlierScore": scores}, real_rows=4)
        p.record_outlier_tags({"outlierScore": torch.tensor(scores)}, real_rows=4)
    assert p.document()["feedback"] == j.document()["feedback"]
    assert p.outlier_block() == j.outlier_block()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_quality(monkeypatch):
    """Both packages' QUALITY singletons drained and reset, on at sample 1,
    a 256-row reference window, rescored on every read; reset after."""
    for hr, q in ((jhr, jq), (phr, pq)):
        hr.SPINE.drain()
        q.QUALITY.reset()
        monkeypatch.setattr(q.QUALITY, "enabled", True)
        monkeypatch.setattr(q.QUALITY, "sample", 1.0)
        monkeypatch.setattr(q.QUALITY, "ref_target", 256)
    yield
    for hr, q in ((jhr, jq), (phr, pq)):
        hr.SPINE.drain()
        q.QUALITY.reset()


def _mnist_doc():
    return json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())


def _body(x, puid=""):
    return json.dumps({"meta": {"puid": puid} if puid else {}, "data": {"ndarray": x.tolist()}})


def test_engines_give_the_same_x_drift(fresh_quality):
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")
    engine.load_states({"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in jax_engine.states()["mnist"].items()}, device="cpu")})
    rng = np.random.default_rng(8)
    ref = [rng.random((64, 784)) for _ in range(4)]
    same = [rng.random((64, 784)) for _ in range(3)]
    shifted = [rng.random((64, 784)) * 1.5 + 0.3 for _ in range(3)]

    async def run():
        for x in ref + same + shifted + [rng.random((5, 784))]:
            for e in (engine, jax_engine):
                assert (await e.predict_json(_body(x)))[1] == 200

    try:
        asyncio.run(run())
        jd, pd = jax_engine.quality_document(), engine.quality_document()
    finally:
        engine.close()
        asyncio.run(jax_engine.close())
    jrow, prow = jd["nodes"][0], pd["nodes"][0]
    assert prow["node"] == jrow["node"] == "mnist" and prow["status"] == "live"
    for k in ("psi_max", "psi_mean", "ks_max"):
        assert prow["drift"][k] == jrow["drift"][k], k
    assert [f["feature"] for f in prow["top_features"]] == \
        [f["feature"] for f in jrow["top_features"]]
    assert prow["drift"]["psi_max"] > 0.25
    # Y differs by the two MLPs' rounding (bf16 weights, f32 sums in
    # another order): the prediction histogram's PSI within 0.02
    assert abs(prow["drift"]["prediction_psi"] - jrow["drift"]["prediction_psi"]) <= 0.02
    assert {k: prow[k] for k in ("sampled_rows", "ref_rows", "live_rows")} == \
        {k: jrow[k] for k in ("sampled_rows", "ref_rows", "live_rows")}
    assert set(pd) == set(jd)


class _Server:
    """The port's REST lane for ``engine`` on a private loop thread."""

    def __init__(self, engine):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = asyncio.run_coroutine_threadsafe(
            serve_fast(engine, "127.0.0.1", 0), self.loop).result(30)
        self.base = f"http://127.0.0.1:{self.server.port}"

    def call(self, path, body=None, headers=None, method=None):
        req = urllib.request.Request(self.base + path, data=body, headers=headers or {},
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def test_routes_answer_the_quality_documents(fresh_quality, monkeypatch):
    monkeypatch.setattr(pq.QUALITY, "ref_target", 64)
    doc = json.loads((ROOT / "examples" / "epsilon_greedy_deployment.json").read_text())
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    srv = _Server(engine)
    try:
        x = np.random.default_rng(9).random((16, 784))
        for i in range(5):
            st, body = srv.call("/api/v0.1/predictions", _body(x, f"q{i}").encode())
            assert st == 200, body
            resp = json.loads(body)
            fb = {"request": json.loads(_body(x)), "response": resp, "reward": 0.5}
            assert srv.call("/api/v0.1/feedback", json.dumps(fb).encode())[0] == 200
        st, body = srv.call("/quality")
        qd = json.loads(body)
        assert st == 200 and set(qd) >= {"engine", "routers", "nodes", "feedback", "slo",
                                         "outliers", "tenant_slo", "fleet_burn"}
        (name, row), = qd["routers"].items()
        assert row["total_tries"] == 5 * 16 and len(row["branches"]) == 2
        assert qd["feedback"]["main"]["count"] == 5
        assert qd["feedback"]["main"]["mean_reward"] == 0.5
        stats = json.loads(srv.call("/stats")[1])
        assert stats["routers"] == qd["routers"] and stats["quality"]["feedback_count"] == 5
        assert srv.call("/quality/reference")[0] == 405
        st, body = srv.call("/quality/reference?action=thaw", b"", method="POST")
        assert st == 400 and b"thaw" in body
        st, body = srv.call("/quality/reference?action=reset", b"", method="POST")
        assert st == 200 and json.loads(body)["action"] == "reset"
    finally:
        srv.close()
        engine.close()


def test_a_unit_pod_answers_its_own_drift_window(fresh_quality, monkeypatch):
    """The unit microservice's ``/quality``: each in-process ``predict``
    writes one quality record of the node's own input and output (host
    mode's and a unit pod's per-node identity)."""
    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.runtime.microservice import build_runtime
    from seldon_core_tpu_torch.runtime.rest import serve_unit

    monkeypatch.setattr(pq.QUALITY, "ref_target", 64)
    rt = build_runtime("MnistClassifier", parameters=[Parameter.from_json_dict(
        {"name": "hidden", "value": "32", "type": "INT"})], unit_name="pod-m", device="cpu")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = asyncio.run_coroutine_threadsafe(serve_unit(rt, "127.0.0.1", 0), loop).result(30)
    base = f"http://127.0.0.1:{server.port}"

    def call(path, body=None, method=None):
        req = urllib.request.Request(base + path, data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    rng = np.random.default_rng(12)
    try:
        for i in range(3):
            st, _ = call("/predict", _body(rng.random((32, 784)), f"u{i}").encode())
            assert st == 200
        st, doc = call("/quality")
        assert st == 200 and doc["unit"]["name"] == "pod-m"
        row = next(r for r in doc["nodes"] if r["node"] == "pod-m")
        assert row["status"] == "live" and row["ref_rows"] == 64 and row["live_rows"] == 32
        assert set(row["drift"]) == {"psi_max", "psi_mean", "ks_max", "prediction_psi"}
        st, out = call("/quality/reference?node=pod-m&action=reset", b"", method="POST")
        assert st == 200 and out["nodes"] == {"pod-m": "reset"}
        assert call("/quality/reference?action=nope", b"", method="POST")[0] == 400
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
