"""The port's tail-sampled postmortem recorder
(``seldon_core_tpu_torch/utils/postmortem.py``) against the JAX package's:
the same span sequences, built by hand, offered to a fresh recorder of
each package give the same kept reasons, the same explained phases (the
guilty phase, its excess, the rolling baseline, the ``gen_seq`` ledger, the
``/costs`` row), the same counters, the same healthy baseline under one
seeded draw, and the same ``exemplar_puids``.  Then the port's wiring:
``TRACER.pm_hook`` is the recorder's ``offer``, and a continuous-lane
request sampled out at the head, slower than the SLO budget and
preempted, is kept with its ``gen_sequence`` slice and its tenant's cost
row."""

import asyncio
import json
import random

import numpy as np
import pytest
import torch

from seldon_core_tpu.utils import costledger as jcl
from seldon_core_tpu.utils import postmortem as jpm
from seldon_core_tpu.utils import tracing as jtr
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.qos import qos_scope
from seldon_core_tpu_torch.utils import costledger as pcl
from seldon_core_tpu_torch.utils import hotrecord as phr
from seldon_core_tpu_torch.utils import postmortem as ppm
from seldon_core_tpu_torch.utils import tracing as ptr
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

PKGS = {"jax": (jpm, jtr, jcl), "port": (ppm, ptr, pcl)}
T0 = 1_700_000_000.0


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


def _span(tr, name, kind, method, start, dur, tid, sid, parent="", attrs=None, events=None,
          puid=""):
    return tr.Span(puid=puid, name=name, kind=kind, method=method, start_s=T0 + start,
                   duration_ms=dur, attrs=dict(attrs or {}), trace_id=tid, span_id=sid,
                   parent_span_id=parent, events=list(events or ()))


def _request(tr, i, dur, root_attrs=None, child=None, queue_ms=1.0, dispatch_ms=None,
             extra=()):
    """One request's spans, children first and the root last: request ->
    (batch_queue, dispatch) plus any ``extra`` children."""
    tid, rid = f"{i:032x}", f"{i:08x}aaaaaaaa"
    dispatch_ms = dur - queue_ms - 0.5 if dispatch_ms is None else dispatch_ms
    spans = [
        _span(tr, "batch_queue", "queue", "wait", 0.0001, queue_ms, tid, f"{i:08x}bbbbbbbb", rid,
              puid=f"p{i}"),
        _span(tr, "dispatch", "dispatch", "predict", 0.0001 + queue_ms / 1e3, dispatch_ms, tid,
              f"{i:08x}cccccccc", rid, attrs=child, puid=f"p{i}"),
    ]
    for k, (name, kind, method, ms, attrs, events) in enumerate(extra):
        spans.append(_span(tr, name, kind, method, 0.0002, ms, tid, f"{i:08x}{k:08x}", rid,
                           attrs=attrs, events=events, puid=f"p{i}"))
    spans.append(_span(tr, "request", "request", "predict", 0.0, dur, tid, rid,
                       attrs=root_attrs, puid=f"p{i}"))
    return spans


def _scenario(tr):
    """The same traffic for either package: healthy requests, then every
    anomaly the retention policy names."""
    traces = []
    for i in range(12):  # healthy: the rolling baseline and the reservoir
        traces.append(_request(tr, i, 10.0 + (i % 3)))
    traces.append(_request(tr, 100, 12.0, root_attrs={"status": 500, "error": "Boom"}))
    traces.append(_request(tr, 101, 3.0, root_attrs={"shed": True, "status": 503}))
    traces.append(_request(tr, 102, 90.0, dispatch_ms=80.0))                  # over the SLO
    traces.append(_request(tr, 103, 90.0, root_attrs={"tier": "batch"}))     # within 4x
    traces.append(_request(tr, 104, 20.0, root_attrs={"tenant": "acme", "tier": "batch"},
                           extra=[("gen_sequence", "gen_seq", "length", 18.0,
                                   {"sid": 1, "tokens": 4},
                                   [{"name": "admit", "ts": T0}, {"name": "preempt", "ts": T0},
                                    {"name": "retire", "ts": T0}])]))
    traces.append(_request(tr, 105, 15.0, extra=[("m3", "client", "predict", 1.0, {},
                                                  [{"name": "breaker_open", "ts": T0}])]))
    traces.append(_request(tr, 106, 20.0, child={"autopilot_predicted_ms": 2.0}))
    traces.append(_request(tr, 107, 11.0))  # healthy, then rescued by a late note
    return traces


def _strip(doc):
    """A postmortem document without its wall-clock stamps (the keep time
    and the notes' times differ between two runs by construction)."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in ("kept_at_s", "ts")}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _run(pkg):
    pm, tr, cl = PKGS[pkg]
    cl.LEDGER.reset()
    cl.LEDGER.fold_flush({"dep": "d", "padded": 4, "tenants": [("acme", "batch", 3.0, 1.0, 0)]},
                         0.004)
    rec = pm.PostmortemRecorder(enabled=True, excess_x=3.0, slo_ms=50.0, ttl_s=30.0,
                                pending_traces=64, pending_spans=8, keep=16, baseline=4)
    rec._rng = random.Random(1234)
    for spans in _scenario(tr):
        for s in spans:
            rec.offer(s)
    rec.note(f"{107:032x}", "failover", replica="r2")
    rec.note("", "lease", holder="g1")
    out = {"summary": _strip(rec.document()), "puids": rec.exemplar_puids(limit=10),
           "snapshot": {k: v for k, v in rec.snapshot().items() if k != "offer_p50_ms"}}
    out["summary"].pop("capture_overhead_ms")
    out["full"] = {p: _strip(rec.document(puid=p)) for p in
                   ("p100", "p101", "p102", "p103", "p104", "p105", "p106", "p107")}
    cl.LEDGER.reset()
    return out


def test_the_same_spans_give_the_same_verdicts_and_explanations():
    j, p = _run("jax"), _run("port")
    assert p["summary"] == j["summary"]
    assert p["full"] == j["full"]
    assert p["puids"] == j["puids"]
    assert p["snapshot"] == j["snapshot"]
    reasons = {s["puid"]: s["reasons"] for s in p["summary"]["kept"]}
    assert reasons == {"p100": ["error"], "p101": ["shed"], "p102": ["slo"],
                       "p104": ["preemption"], "p105": ["breaker"],
                       "p106": ["autopilot_excess"], "p107": ["failover"]}
    # a batch-tier request within 4x the budget is healthy: at most a baseline
    assert p["full"]["p103"]["postmortem"] is None or \
        p["full"]["p103"]["postmortem"]["reasons"] == ["baseline"]
    doc = p["full"]["p104"]["postmortem"]
    assert doc["explain"]["gen_ledger"][0]["name"] == "gen_sequence"
    assert doc["explain"]["cost_row"]["tenant"] == "acme"
    assert p["full"]["p102"]["postmortem"]["explain"]["guilty_phase"] is not None
    assert [s["reason"] for s in p["summary"]["synthetic"]] == ["lease"]


@pytest.mark.parametrize("cap", [1, 3])
def test_pending_bounds_and_the_ttl_sweep_count_the_same_drops(cap):
    def run(pkg):
        pm, tr, _ = PKGS[pkg]
        rec = pm.PostmortemRecorder(enabled=True, slo_ms=0.0, ttl_s=0.0, pending_traces=cap,
                                    pending_spans=2, keep=4, baseline=0)
        for spans in _scenario(tr)[:5]:
            for s in spans[:-1]:  # children only: nothing completes
                rec.offer(s)
        rec._sweep()
        d = rec.document()
        return d["counters"], d["pending"]

    assert run("port") == run("jax")


def test_pm_hook_is_the_recorder_s_offer():
    assert ptr.TRACER.pm_hook == ppm.POSTMORTEM.offer
    assert ppm.postmortem_enabled() == jpm.postmortem_enabled()


def _gen_doc():
    return {"spec": {"name": "gen-pm", "predictors": [{
        "name": "main",
        "components": [{"name": "gen", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": [{"name": n, "value": str(v), "type": "INT"} for n, v in (
                            ("vocab", 64), ("d_model", 32), ("n_heads", 4), ("n_kv_heads", 2),
                            ("n_layers", 2), ("d_ff", 64), ("max_new_tokens", 24))]}],
        "graph": {"name": "gen", "type": "MODEL", "children": []}}]}}


def test_a_sampled_out_slow_preempted_request_is_kept_with_its_ledger(monkeypatch):
    """The continuous lane on the CPU, tracing on at sample 0 and an SLO
    budget of 1 ms: a pool of 6 blocks of 8 makes the 4-row request preempt
    a row; its postmortem names a phase and carries the gen_sequence spans
    and the tenant's /costs row."""
    monkeypatch.setenv("SELDON_TPU_GEN_POOL_BLOCKS", "6")
    monkeypatch.setenv("SELDON_TPU_GEN_BLOCK_SIZE", "8")
    monkeypatch.setenv("SELDON_TPU_GEN_SPAN", "4")
    phr.SPINE.drain()
    ppm.POSTMORTEM.reset()
    pcl.LEDGER.reset()
    monkeypatch.setattr(ptr.TRACER, "enabled", True)
    monkeypatch.setattr(ptr.TRACER, "sample", 0.0)
    monkeypatch.setattr(ppm.POSTMORTEM, "slo_ms", 1.0)
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_gen_doc()), device="cpu")
    assert engine.genserver is not None
    rows = np.random.default_rng(0).integers(0, 64, size=(4, 12)).astype(float)
    body = json.dumps({"meta": {"puid": "pm-slow"}, "data": {"ndarray": rows.tolist()}})

    async def run():
        with qos_scope("globex", None):
            return await engine.predict_json(body)

    try:
        text, status = asyncio.run(run())
        assert status == 200, text
        assert engine.genserver.preempted_total > 0
        assert ptr.TRACER.trace("pm-slow") == []  # the head sampler dropped it
        doc = engine.postmortems_document(puid="pm-slow")
        costs = engine.costs_document()
    finally:
        engine.close()
        ppm.POSTMORTEM.reset()
    assert doc["found"], doc
    pm = doc["postmortem"]
    assert "slo" in pm["reasons"] and "preemption" in pm["reasons"]
    assert pm["explain"]["guilty_phase"] is not None
    ledger = pm["explain"]["gen_ledger"]
    assert len(ledger) == 4 and all(e["name"] == "gen_sequence" for e in ledger)
    assert any(ev["name"] == "preempt" for e in ledger for ev in e["events"])
    row = pm["explain"]["cost_row"]
    assert row["tenant"] == "globex" and row["device_s"].get("decode", 0) > 0
    assert [r["tenant"] for r in costs["tenants"]] == ["globex"]
