"""The port's telemetry spine (``seldon_core_tpu_torch/utils/hotrecord.py``)
against the JAX package's: one fixed sequence of hop records written to
each package's ``SPINE`` and drained gives equal folds (the recorder's
batch and generation blocks, the observatory's rows, the tracer's spans
by name, kind, method, duration and attributes, the records counted) and
an ``overhead_document`` of the same shape.  Then the port's own engine:
with every observatory off a dispatch makes zero ring writes and zero
observatory calls, each consumer degrades on its own, the ring drops and
counts when full, and a dead thread's ring is retired."""

import asyncio
import json
import threading

import numpy as np
import pytest
import torch

from seldon_core_tpu.utils import genperf as jgp
from seldon_core_tpu.utils import hotrecord as jhr
from seldon_core_tpu.utils import perf as jperf
from seldon_core_tpu.utils import telemetry as jtel
from seldon_core_tpu.utils import tracing as jtr
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.utils import genperf as pgp
from seldon_core_tpu_torch.utils import hotrecord as phr
from seldon_core_tpu_torch.utils import perf as pperf
from seldon_core_tpu_torch.utils import quality as pquality
from seldon_core_tpu_torch.utils import telemetry as ptel
from seldon_core_tpu_torch.utils import tracing as ptr
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

PEAKS = {"device_kind": "test card", "platform": "gpu", "peak_bf16_tflops": 989.0,
         "peak_hbm_gbs": 3350.0, "peak_assumed": False}
PKGS = {"jax": (jhr, jtel, jperf, jgp, jtr), "port": (phr, ptel, pperf, pgp, ptr)}


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


@pytest.fixture
def _fresh(monkeypatch):
    """Both packages' singletons drained, reset, tracing on at sample 1,
    the observatories on with the test peaks; restored after."""
    for hr, tel, perf, gp, tr in PKGS.values():
        hr.SPINE.drain()
        hr.SPINE.reset()
        tr.TRACER.clear()
        tel.RECORDER.reset()
        perf.OBSERVATORY.reset()
        gp.GENPERF.reset()
        monkeypatch.setattr(tr.TRACER, "enabled", True)
        monkeypatch.setattr(tr.TRACER, "sample", 1.0)
        monkeypatch.setattr(perf.OBSERVATORY, "enabled", True)
        monkeypatch.setattr(perf.OBSERVATORY, "_peaks", dict(PEAKS))
        monkeypatch.setattr(hr.SPINE, "telemetry_enabled", True)
    yield
    for hr, tel, perf, gp, tr in PKGS.values():
        hr.SPINE.drain()
        hr.SPINE.reset()
        tr.TRACER.clear()
        perf.OBSERVATORY.reset()
        gp.GENPERF.reset()


def _write(pkg: str, seed: int) -> None:
    """One fixed, seeded sequence of hop records, all on this thread."""
    hr, tel, perf, gp, tr = PKGS[pkg]
    rng = np.random.default_rng(seed)
    perf.OBSERVATORY.record_compile(
        "predict[8x784/float32]",
        {"flops": 4.2e6, "bytes_accessed": 6.0e5, "output_bytes": 320.0}, 0.5)
    perf.OBSERVATORY.record_compile(
        "gen_decode_step", {"flops": 2.0e8, "bytes_accessed": 1.7e8, "output_bytes": 0.0,
                            "kv_bytes_per_position": 49152.0}, None)
    ctx = tr.TraceContext(trace_id="ab" * 16, span_id="cd" * 8, sampled=True, puid="req-1")
    for i in range(12):
        wait = float(rng.exponential(1e-3))
        hr.SPINE.record_queue(wait, ctx=ctx, rows=1, start_s=1.7e9 + i)
        hr.SPINE.record_flush(rows=int(rng.integers(1, 9)), requests=1, start_s=1.7e9 + i,
                              duration_s=float(rng.exponential(2e-3)))
        wants = hr.Wants(trace=True, quality=False, perf=True, recorder=False)
        with tr.trace_scope(ctx):
            hr.SPINE.record_dispatch(
                wants, executable="predict[8x784/float32]",
                seconds=float(rng.lognormal(-7, 0.2)), start_s=1.7e9 + i, rows=8, real_rows=8,
                method="predict")
    for i in range(6):
        wall = float(rng.uniform(1e-4, 3e-3))
        hr.SPINE.record_gen_step(
            kind="decode", duration_s=wall, active=4, waiting=0, admitted=0, retired=i % 2,
            blocks_used=9, blocks_total=1023, tokens=32, executable="gen_step:decode",
            detail={"wall_s": wall, "device_s": wall / 2,
                    "phases": {"admit": wall / 10, "decode": wall * 0.8},
                    "device_phases": {"decode": wall / 2}, "rows": 4, "real_rows": 4,
                    "tokens": 32, "steps": 8, "kv_positions": 2048, "kv_blocks": 9,
                    "kv_ages": ((2, 0.5),), "bubble_s": 1e-4, "bubble_cause": "host"})
    hr.SPINE.drain()


def _spans(tr):
    out = []
    for s in tr.TRACER.recent(1000):
        d = s.to_json_dict()
        out.append((d["name"], d["kind"], d["method"], d["duration_ms"],
                    json.dumps({k: v for k, v in (d.get("attrs") or {}).items()
                                if k not in ("autopilot_predicted_ms",)}, sort_keys=True),
                    d["puid"], bool(d.get("parent_span_id"))))
    return sorted(out)


def _unthrottled(doc):
    if isinstance(doc, dict):
        return {k: _unthrottled(v) for k, v in doc.items() if k != "served_mfu"}
    return doc


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


@pytest.mark.parametrize("seed", [0, 1])
def test_drained_folds_equal_the_jax_spine_s(seed, _fresh):
    for pkg in PKGS:
        _write(pkg, seed)
    (jhr_, jtel_, jperf_, jgp_, jtr_), (phr_, ptel_, pperf_, pgp_, ptr_) = PKGS.values()
    js, ps = jtel_.RECORDER.snapshot(), ptel_.RECORDER.snapshot()
    # the JAX observatory records a compile's seconds only while its
    # jax.monitoring listener is not installed (process state another test
    # may have changed); the port has no such listener and always records
    assert ps["perf"]["compile_s"]["count"] == 1
    for snap in (js, ps):
        snap["perf"].pop("compile_s")
    for block in ("batch", "generation", "trace_spans", "perf"):
        # the served-MFU gauge moves on the spine's 1/s throttled refresh,
        # whenever that falls: not part of the fold
        assert _unthrottled(ps[block]) == _unthrottled(js[block]), block
    assert pperf_.OBSERVATORY.document()["executables"] == \
        jperf_.OBSERVATORY.document()["executables"]
    assert pgp_.GENPERF.document() == jgp_.GENPERF.document()
    assert _spans(ptr_) == _spans(jtr_)
    assert phr_.SPINE.records_total == jhr_.SPINE.records_total
    po, jo = phr_.SPINE.overhead_document(), jhr_.SPINE.overhead_document()
    assert _keys(po) == _keys(jo)
    assert po["records_folded"] == jo["records_folded"]
    assert po["hops_ms"]["dispatch_count"] == jo["hops_ms"]["dispatch_count"] == 12


def _mnist_engine():
    doc = {"spec": {"name": "spine-dep", "predictors": [{
        "name": "p",
        "components": [{"name": "m", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": "16", "type": "INT"}]}],
        "graph": {"name": "m", "type": "MODEL", "children": []}}]}}
    return EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")


def _drive(engine, n=3, rows=2):
    payload = json.dumps({"data": {"ndarray": np.ones((rows, 784)).tolist()}})

    async def run():
        for _ in range(n):
            text, status = await engine.predict_json(payload)
            assert status == 200, text

    asyncio.run(run())


def _counted(monkeypatch):
    counts = {"ring": 0, "perf": 0, "quality": 0, "tracer": 0}
    spine, obs, tracer = phr.SPINE, pperf.OBSERVATORY, ptr.TRACER
    real_append, real_perf, real_fold = spine._append, obs.observe_dispatch, tracer._fold
    real_quality = pquality.QUALITY.fold_batch

    def quality(*a, **k):
        counts["quality"] += 1
        return real_quality(*a, **k)

    def append(rec):
        counts["ring"] += 1
        return real_append(rec)

    def perf(*a, **k):
        counts["perf"] += 1
        return real_perf(*a, **k)

    def fold(span):
        counts["tracer"] += 1
        return real_fold(span)

    monkeypatch.setattr(spine, "_append", append)
    monkeypatch.setattr(obs, "observe_dispatch", perf)
    monkeypatch.setattr(tracer, "_fold", fold)
    monkeypatch.setattr(pquality.QUALITY, "fold_batch", quality)
    return counts


def _switch(monkeypatch, telemetry, trace, perf, quality=False):
    monkeypatch.setattr(phr.SPINE, "telemetry_enabled", telemetry)
    monkeypatch.setattr(ptr.TRACER, "enabled", trace)
    monkeypatch.setattr(ptr.TRACER, "sample", 1.0)
    monkeypatch.setattr(pperf.OBSERVATORY, "enabled", perf)
    monkeypatch.setattr(pquality.QUALITY, "enabled", quality)


@pytest.fixture
def engine():
    phr.SPINE.drain()
    phr.SPINE.reset()
    ptr.TRACER.clear()
    e = _mnist_engine()
    yield e
    e.close()
    phr.SPINE.drain()
    phr.SPINE.reset()
    ptr.TRACER.clear()


def test_all_kill_switches_mean_zero_ring_writes(engine, monkeypatch):
    """SELDON_TPU_TELEMETRY=0, SELDON_TPU_TRACE=0, SELDON_TPU_PERF=0,
    SELDON_TPU_QUALITY=0 and SELDON_TPU_COSTLEDGER=0: the served path
    performs zero ring writes and zero observatory calls (the cost ledger
    is the fifth consumer: its flush payloads keep records flowing with
    the other four off, so it is cut here too)."""
    _switch(monkeypatch, False, False, False)
    monkeypatch.setenv("SELDON_TPU_COSTLEDGER", "0")
    counts = _counted(monkeypatch)
    _drive(engine)
    phr.SPINE.drain()
    assert counts == {"ring": 0, "perf": 0, "quality": 0, "tracer": 0}


@pytest.mark.parametrize("on", ["telemetry", "trace", "perf", "quality"])
def test_each_consumer_degrades_on_its_own(engine, monkeypatch, on):
    _switch(monkeypatch, on == "telemetry", on == "trace", on == "perf", on == "quality")
    counts = _counted(monkeypatch)
    batches = ptel.RECORDER.batch_occupancy.snapshot()["count"]
    _drive(engine)
    phr.SPINE.drain()
    assert counts["ring"] >= 3
    assert (counts["perf"] > 0) == (on == "perf")
    assert (counts["tracer"] > 0) == (on == "trace")
    assert (counts["quality"] > 0) == (on == "quality")
    grew = ptel.RECORDER.batch_occupancy.snapshot()["count"] > batches
    assert grew == (on == "telemetry")


def test_env_kill_switch_parses(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_TELEMETRY", "0")
    assert phr.TelemetrySpine().telemetry_enabled is False
    monkeypatch.setenv("SELDON_TPU_TELEMETRY", "1")
    assert phr.TelemetrySpine().telemetry_enabled is True


def test_ring_overflow_drops_and_counts():
    ring = phr.ThreadRing(4)
    for _ in range(7):
        ring.push(phr.HotRecord("span", 0))
    assert ring.dropped == 3
    out = []
    ring.pop_into(out)
    assert len(out) == 4 and ring.push(phr.HotRecord("span", 0)) is True


def test_spine_drop_accounting_reaches_the_recorder():
    spine = phr.TelemetrySpine(ring_capacity=2)
    before = ptel.RECORDER.telemetry_ring_dropped
    for _ in range(10):
        spine.record_flush(rows=1, requests=1, start_s=0.0, duration_s=0.001)
    spine.drain()
    assert ptel.RECORDER.telemetry_ring_dropped - before == 8
    assert "seldon_tpu_telemetry_ring_dropped_total" in ptel.RECORDER.exposition().decode()
    spine.quiesce()


def test_dead_thread_rings_are_retired():
    spine = phr.TelemetrySpine()

    def write():
        spine.record_flush(rows=1, requests=1, start_s=0.0, duration_s=0.001)

    threads = [threading.Thread(target=write) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(spine._rings) == 4
    spine.drain()   # folds
    spine.drain()   # retires the drained dead rings
    assert len(spine._rings) == 0
    assert spine.overhead_document()["ring"]["writes"] == 4
    spine.quiesce()


def test_a_drain_waits_for_another_drains_fold(monkeypatch):
    """A reader's drain that finds the rings empty while another drain
    (the drainer thread) is still folding the records it popped waits for
    that fold: it returns only once the record is folded, so a query
    surface never reads the state from before a request it answered."""
    spine = phr.TelemetrySpine()
    spine.record_flush(rows=1, requests=1, start_s=0.0, duration_s=0.001)
    folding, release, folded = threading.Event(), threading.Event(), []
    real_fold = spine._fold

    def slow_fold(rec):
        folding.set()
        assert release.wait(10)
        real_fold(rec)
        folded.append(rec)

    monkeypatch.setattr(spine, "_fold", slow_fold)
    drainer = threading.Thread(target=spine.drain)
    drainer.start()
    assert folding.wait(10)  # the record is popped: every ring is empty
    assert all(r.head == r.tail for r in spine._rings)
    reader_done = threading.Event()
    reader = threading.Thread(target=lambda: (spine.drain(), reader_done.set()))
    reader.start()
    assert not reader_done.wait(0.2)  # the reader waits on the fold
    release.set()
    drainer.join(10)
    reader.join(10)
    assert reader_done.is_set() and len(folded) == 1
    assert spine.records_total == {"flush": 1}
    spine.quiesce()


def test_query_surfaces_drain_lazily(engine, monkeypatch):
    """No drainer tick needed: a recorder snapshot, the observatory's
    document and a tracer lookup each fold what is pending first."""
    _switch(monkeypatch, True, True, True)
    monkeypatch.setattr(phr.SPINE, "drain_interval_s", 3600.0)
    _drive(engine, n=2)
    assert any(s.kind == "dispatch" for s in ptr.TRACER.recent(100))
    assert any(r["calls"] for r in pperf.OBSERVATORY.document()["executables"])
