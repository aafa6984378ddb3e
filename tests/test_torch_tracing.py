"""The port's causal tracer (``seldon_core_tpu_torch/utils/tracing.py``)
against the JAX package's: W3C ``traceparent`` formatting and parsing,
head sampling, the bounded ring's lookups, and the documents built from a
span set (``assemble_tree``, ``critical_path``, ``phase_decomposition``,
``chrome_trace``, ``trace_document``), compared exactly on the same
seeded spans loaded through each package's ``span_from_json_dict``.  Then
the profile window, which takes ``torch.profiler`` where the JAX package
takes ``jax.profiler``: start, a second start refused (409 at the route),
stop with a Chrome trace artifact, and a typed refusal when the profiler
cannot trace the card."""

import json
import os
import random

import numpy as np
import pytest
import torch

from seldon_core_tpu.utils import tracing as jtr
from seldon_core_tpu_torch.utils import tracing as ptr


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ids(rng):
    return (f"{int(rng.integers(1, 2 ** 63)):016x}{int(rng.integers(1, 2 ** 63)):016x}",
            f"{int(rng.integers(1, 2 ** 63)):016x}")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sampled", [True, False])
def test_traceparent_formats_and_parses_alike(seed, sampled):
    rng = np.random.default_rng(seed)
    tid, sid = _ids(rng)
    for mod in (jtr, ptr):
        ctx = mod.TraceContext(trace_id=tid, span_id=sid, sampled=sampled, puid="p")
        with mod.trace_scope(ctx):
            hdr = mod.traceparent_header_value()
        assert hdr is not None
    with jtr.trace_scope(jtr.TraceContext(tid, sid, sampled)):
        want = jtr.traceparent_header_value()
    with ptr.trace_scope(ptr.TraceContext(tid, sid, sampled)):
        got = ptr.traceparent_header_value()
    assert got == want
    a, b = jtr.parse_traceparent(want), ptr.parse_traceparent(want)
    assert (b.trace_id, b.span_id, b.sampled, b.pm) == (a.trace_id, a.span_id, a.sampled, a.pm)
    assert ptr.traceparent_header_value() is None  # no scope, no header


@pytest.mark.parametrize("raw", [
    None, "", "garbage", "00-abc-def-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",       # all-zero trace id
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",       # all-zero span id
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",       # forbidden version
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",       # upper case
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",       # short trace id
    "00-" + "a" * 32 + "-" + "b" * 16 + "-0z",       # bad flags
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-03-future",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-03",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
])
def test_malformed_and_edge_headers_are_refused_alike(raw):
    a, b = jtr.parse_traceparent(raw), ptr.parse_traceparent(raw)
    if a is None:
        assert b is None
    else:
        assert (b.trace_id, b.span_id, b.sampled, b.pm) == (a.trace_id, a.span_id, a.sampled,
                                                            a.pm)


def _span_dicts(seed: int):
    """One request's span set: a request root, queue, node spans with a
    retry event, a client hop and a dispatch, plus an annotation span and
    one span of another trace."""
    rng = np.random.default_rng(seed)
    tid, root = _ids(rng)
    t0 = 1_700_000_000.0 + float(rng.uniform(0, 1000))
    out = [{"puid": "req-1", "name": "request", "kind": "request", "method": "predict",
            "start_s": t0, "duration_ms": 20.0 + float(rng.uniform(0, 5)),
            "trace_id": tid, "span_id": root, "parent_span_id": "", "attrs": {"mode": "host"}}]
    cursor = t0
    for i, (name, kind) in enumerate([("batch_queue", "queue"), ("m1", "node"),
                                      ("m3", "client"), ("m3", "server"),
                                      ("dispatch", "dispatch"), ("gen_sequence", "gen_seq")]):
        sid = f"{int(rng.integers(1, 2 ** 63)):016x}"
        dur = float(rng.uniform(0.5, 4.0))
        parent = out[-1]["span_id"] if kind == "server" else root
        d = {"puid": "req-1", "name": name, "kind": kind, "method": "predict",
             "start_s": cursor, "duration_ms": dur, "trace_id": tid, "span_id": sid,
             "parent_span_id": parent, "attrs": {"i": i}}
        if kind == "client":
            d["events"] = [{"name": "retry", "ts": cursor + 0.0005,
                            "attrs": {"backoff_ms": 0.3}}]
        out.append(d)
        cursor += dur / 1e3 * float(rng.uniform(0.3, 1.0))
    other, osid = _ids(rng)
    out.append({"puid": "req-2", "name": "request", "kind": "request", "method": "predict",
                "start_s": t0 + 1, "duration_ms": 3.0, "trace_id": other, "span_id": osid,
                "parent_span_id": "", "attrs": {}})
    return out


def _loaded(mod, dicts):
    return [mod.span_from_json_dict(dict(d)) for d in dicts]


def _seg(segments):
    return [(sp.span_id, round(ms, 9)) for sp, ms in segments]


@pytest.mark.parametrize("seed", range(4))
def test_span_documents_equal_the_jax_tracer_s(seed):
    dicts = _span_dicts(seed)
    js, ps = _loaded(jtr, dicts), _loaded(ptr, dicts)
    assert [s.to_json_dict() for s in ps] == [s.to_json_dict() for s in js]
    one = [d for d in dicts if d["puid"] == "req-1"]
    jone, pone = _loaded(jtr, one), _loaded(ptr, one)
    assert ptr.assemble_tree(pone) == jtr.assemble_tree(jone)
    jroot, jsegs = jtr.critical_path(jone)
    proot, psegs = ptr.critical_path(pone)
    assert proot.span_id == jroot.span_id and _seg(psegs) == _seg(jsegs)
    assert ptr.phase_decomposition(psegs) == jtr.phase_decomposition(jsegs)
    assert ptr.chrome_trace(ps, process_name="x", base_s=1.7e9) == \
        jtr.chrome_trace(js, process_name="x", base_s=1.7e9)
    assert ptr.assembly_fields(pone) == jtr.assembly_fields(jone)


@pytest.mark.parametrize("query", [{"puid": "req-1"}, {"trace_id": None}, {}])
def test_trace_document_equal_on_equal_tracers(query):
    dicts = _span_dicts(11)
    jt, pt = jtr.Tracer(capacity=64, enabled=True), ptr.Tracer(capacity=64, enabled=True)
    for d in dicts:
        jt.add(jtr.span_from_json_dict(dict(d)))
        pt.add(ptr.span_from_json_dict(dict(d)))
    if "trace_id" in query:
        query = {"trace_id": dicts[0]["trace_id"]}
    assert ptr.trace_document(pt, **query) == jtr.trace_document(jt, **query)
    assert ptr.export_document(pt, process_name="e", **query) == \
        jtr.export_document(jt, process_name="e", **query)


def test_ring_eviction_and_indexes_match():
    dicts = [dict(d, puid=f"r{i % 3}") for i, d in enumerate(_span_dicts(3) * 4)]
    jt, pt = jtr.Tracer(capacity=7, enabled=True), ptr.Tracer(capacity=7, enabled=True)
    for d in dicts:
        jt.add(jtr.span_from_json_dict(dict(d)))
        pt.add(ptr.span_from_json_dict(dict(d)))
    for puid in ("r0", "r1", "r2"):
        assert [s.to_json_dict() for s in pt.trace(puid)] == \
            [s.to_json_dict() for s in jt.trace(puid)]
    assert pt.snapshot() == jt.snapshot()


@pytest.mark.parametrize("sample", [0.0, 0.3, 1.0])
def test_head_sampling_decided_once_at_the_root(sample):
    """The same injected draws give the same verdicts, and a sampled-out
    root records nothing below it."""
    jt = jtr.Tracer(enabled=True, sample=sample)
    pt = ptr.Tracer(enabled=True, sample=sample)
    jt._rng, pt._rng = random.Random(5), random.Random(5)
    verdicts = []
    for t in (jt, pt):
        got = []
        for i in range(40):
            with t.span(f"p{i}", "request", kind="request"):
                with t.span(f"p{i}", "child"):
                    pass
            got.append(len(t.trace(f"p{i}")))
        verdicts.append(got)
    assert verdicts[0] == verdicts[1]
    assert set(verdicts[1]) <= {0, 2}


def test_span_opened_inside_another_is_its_child():
    t = ptr.Tracer(enabled=True)
    with t.span("p", "request", kind="request"):
        outer = ptr.current_trace_context()
        with t.span("p", "node"):
            inner = ptr.current_trace_context()
    spans = {s.name: s for s in t.trace("p")}
    assert spans["node"].parent_span_id == spans["request"].span_id == outer.span_id
    assert spans["node"].trace_id == outer.trace_id == inner.trace_id


# ---------------------------------------------------------------------------
# the profile window (torch.profiler)
# ---------------------------------------------------------------------------


@pytest.fixture
def _profile_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PROFILE_DIR", str(tmp_path))
    yield tmp_path
    ptr.profile_window_stop()


def test_profile_window_contract(_profile_dir):
    doc = ptr.profile_window_start_request({"duration_s": 30.0})
    assert doc["active"] is True and doc["artifact"]
    assert doc["artifact"].startswith(str(_profile_dir)) and doc["artifact"].endswith(".json")
    assert ptr.profile_window_status()["active"] is True
    with pytest.raises(ptr.ProfileBusyError):
        ptr.profile_window_start_request({})
    x = torch.randn(64, 64)
    for _ in range(3):
        x = x @ x.T / 64
    stopped = ptr.profile_window_stop()
    last = stopped["last"]
    assert stopped["active"] is False and "error" not in last
    # no card here: no device or launch records
    assert last["events"] > 0 and last["device_events"] == last["launch_records"] == 0
    with open(last["artifact"]) as f:
        assert len(json.load(f)["traceEvents"]) == last["events"]
    status = ptr.profile_window_status()
    assert status["active"] is False and status["last"]["window"] == doc["window"]
    # idempotent
    assert ptr.profile_window_stop()["last"] == status["last"]


def test_profile_window_refuses_while_another_profile_is_open(_profile_dir):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ptr.ProfileBusyError):
            ptr.profile_window_start_request({})
    assert ptr.profile_window_status()["active"] is False


def test_profile_window_without_cuda_tracing_is_a_typed_error(_profile_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.autograd, "kineto_available", lambda: False)
    with pytest.raises(ptr.ProfileUnavailableError):
        ptr.profile_window_start_request({})
    # the lock was given back: a later window can open, and it closes by
    # itself at its duration, on its own thread
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ptr.profile_window_start_request({"duration_s": 0.2})["active"] is True
    import time

    deadline = time.time() + 30
    while ptr.profile_window_status()["active"] and time.time() < deadline:
        time.sleep(0.05)
    status = ptr.profile_window_status()
    assert status["active"] is False and status["last"]["events"] > 0


def test_device_profile_degrades_to_an_event_during_a_window(_profile_dir):
    t = ptr.TRACER
    was = t.enabled
    t.enabled = True
    try:
        ptr.profile_window_start_request({})
        with t.span("dp", "request", kind="request"):
            with ptr.device_profile(str(_profile_dir / "nested")):
                pass
        spans = t.trace("dp")
        assert any(ev["name"] == "device_profile_skipped"
                   for s in spans for ev in s.events)
    finally:
        t.enabled = was
    ptr.profile_window_stop()
    with ptr.device_profile(str(_profile_dir / "alone")):
        torch.ones(8).sum()
    assert os.path.exists(_profile_dir / "alone" / ptr.PROFILE_ARTIFACT)


def test_a_caller_logdir_outside_the_profile_dir_is_ignored(_profile_dir):
    doc = ptr.profile_window_start_request({"logdir": "../../escape"})
    assert doc["artifact"].startswith(str(_profile_dir))
