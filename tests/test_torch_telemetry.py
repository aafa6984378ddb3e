"""The port's flight recorder, Prometheus writer, metrics registry, card
table and audit log (``seldon_core_tpu_torch/utils/{telemetry,promtext,
metrics,chips}.py``) against the JAX package's, which build their
families with ``prometheus_client``.  Each case drives both packages with
the same seeded call sequence and compares exactly: snapshots, families,
types, label sets and sample values (``_created`` timestamps aside)."""

import json
import math
import stat
import sys

import numpy as np
import pytest
import torch
from prometheus_client.openmetrics.parser import text_string_to_metric_families as om_parse
from prometheus_client.parser import text_string_to_metric_families as text_parse
from prometheus_client.utils import floatToGoString

from seldon_core_tpu.utils import telemetry as jtel
from seldon_core_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.utils import chips, promtext
from seldon_core_tpu_torch.utils import telemetry as ptel
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _drive(rec, seed: int) -> None:
    """One seeded sequence of recorder calls touching every kind of family
    (histograms with and without labels, labelled counters and gauges,
    an exemplar-carrying dispatch)."""
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(5, 20))):
        rec.observe_batch(int(rng.integers(1, 300)))
        rec.observe_queue_wait(float(rng.exponential(0.002)))
        rec.request_latency("server:predictions", float(rng.exponential(0.003)))
    for i in range(int(rng.integers(2, 6))):
        key = f"predict[{2 ** i}x784/float32]"
        rec.observe_dispatch(key, float(rng.exponential(0.004)),
                             mfu=float(rng.uniform(0, 1)),
                             trace_id=f"{int(rng.integers(1, 2 ** 62)):032x}")
    rec.set_inflight(int(rng.integers(0, 8)))
    rec.observe_ttft(float(rng.exponential(0.05)))
    rec.observe_decode_rate(float(rng.uniform(10, 5000)))
    rec.observe_accept_ratio(float(rng.uniform(0, 1)))
    rec.record_compile_cache("hit", int(rng.integers(1, 4)))
    rec.record_compile_cache("miss")
    rec.record_compile_seconds(float(rng.uniform(1, 20)))
    rec.set_kv_slots(active=int(rng.integers(0, 1000)), reserved=int(rng.integers(0, 1000)))
    rec.set_breaker_state("m3", "open", 1.0)
    rec.record_breaker_transition("m3", "open")
    rec.record_retry("predict", "retry")
    rec.record_retry("predict", "exhausted")
    rec.record_retry_budget_exhausted()
    rec.record_deadline_exceeded("dispatch")
    rec.record_degraded("quorum")
    rec.record_trace_span("request")
    rec.record_trace_span("dispatch")
    rec.record_perf_anomaly("slow_dispatch")
    rec.set_hbm("gpu:0", bytes_in_use=int(rng.integers(1, 2 ** 30)),
                peak_bytes_in_use=2 ** 31, bytes_limit=2 ** 36)
    rec.set_gen_scheduler(inflight=3, waiting=int(rng.integers(0, 9)), blocks_used=17,
                          blocks_total=1023, blocks_high_water=40)
    rec.record_gen_admitted(int(rng.integers(1, 9)))
    rec.record_gen_retired("length", 2)
    rec.record_gen_step("decode")
    rec.record_gen_step_seconds("decode", "decode_device", float(rng.exponential(0.001)))
    rec.record_gen_bubble("host", float(rng.exponential(0.001)))
    rec.record_gen_kv_block_age(float(rng.exponential(1.0)))
    rec.set_gen_served_mfu(float(rng.uniform(0, 1)))
    rec.record_gen_tick_error()
    rec.record_ring_dropped(int(rng.integers(0, 3)))
    rec.set_telemetry_records("dispatch", int(rng.integers(1, 100)))
    rec.set_framework_overhead("total", float(rng.uniform(0, 2)))
    rec.record_lane_request("rest")
    rec.record_wire_request("fast", "binary")
    rec.record_wire_copy(int(rng.integers(1, 10 ** 6)))
    rec.record_audit("written")


def _strip_timestamps(doc):
    """A snapshot with the wall-clock fields dropped (none are expected;
    the helper keeps the comparison honest if one appears)."""
    if isinstance(doc, dict):
        return {k: _strip_timestamps(v) for k, v in doc.items()
                if not k.endswith(("_ts", "timestamp", "started_s"))}
    if isinstance(doc, list):
        return [_strip_timestamps(v) for v in doc]
    return doc


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_recorder_snapshot_equals_the_jax_recorder(seed):
    j, p = jtel.FlightRecorder(), ptel.FlightRecorder()
    _drive(j, seed)
    _drive(p, seed)
    assert _strip_timestamps(p.snapshot()) == _strip_timestamps(j.snapshot())  # exact


def _families(text: str, openmetrics: bool) -> dict:
    """name -> (type, sorted (sample, labels, value, exemplar labels)),
    ``_created`` samples and families aside."""
    out = {}
    for fam in (om_parse if openmetrics else text_parse)(text):
        if fam.name.endswith("_created"):
            continue
        out[fam.name] = (fam.type, sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value,
             tuple(sorted(s.exemplar.labels.items())) if s.exemplar else None)
            for s in fam.samples if not s.name.endswith("_created")))
    return out


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text", "openmetrics"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_exposition_parses_to_the_jax_families(seed, openmetrics):
    j, p = jtel.FlightRecorder(), ptel.FlightRecorder()
    _drive(j, seed)
    _drive(p, seed)
    want = _families(j.exposition(openmetrics=openmetrics).decode(), openmetrics)
    got = _families(p.exposition(openmetrics=openmetrics).decode(), openmetrics)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name  # types, label sets, values: exact


def test_exemplars_ride_only_dispatch_buckets():
    p = ptel.FlightRecorder()
    _drive(p, 5)
    text = p.exposition(openmetrics=True).decode()
    with_exemplar = [ln for ln in text.splitlines() if " # {" in ln]
    assert with_exemplar
    assert all(ln.startswith("seldon_tpu_dispatch_seconds_bucket{") for ln in with_exemplar)
    assert text.endswith("# EOF\n") and text.count("# EOF") == 1
    # the text format carries none, and every histogram's buckets end at +Inf
    plain = p.exposition().decode()
    assert " # {" not in plain
    for fam in text_parse(plain):
        if fam.type == "histogram":
            les = [s.labels["le"] for s in fam.samples if s.name.endswith("_bucket")]
            assert not les or les[-1] == "+Inf"


def _drive_registry(reg, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(3, 12))):
        with reg.time_server("predictions", "POST"):
            pass
    try:
        with reg.time_server("predictions", "POST") as code:
            code["code"] = "400"
            raise ValueError("typed failure")
    except ValueError:
        pass
    with reg.time_client("m3", "predict"):
        pass
    reg.record_feedback(float(rng.uniform(0, 1)))


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text", "openmetrics"])
def test_metrics_registry_families_and_label_sets_match(openmetrics):
    """Own families merged with the recorder's under one ``# EOF``; the
    timed values differ run to run, so counts and label sets are compared
    (the sums only as non-negative)."""
    j = JaxRegistry(deployment_name="d", predictor_name="p", project_name="x")
    p = MetricsRegistry(deployment_name="d", predictor_name="p", project_name="x")
    _drive_registry(j, 7)
    _drive_registry(p, 7)
    want = _families(j.exposition(openmetrics=openmetrics).decode(), openmetrics)
    got = _families(p.exposition(openmetrics=openmetrics).decode(), openmetrics)
    assert set(got) == set(want)

    def shape(fam):
        typ, samples = fam
        return typ, sorted((n, lbl, v if n.endswith(("_count", "_total")) or "_bucket" not in n
                            and not n.endswith("_sum") else None)
                           for n, lbl, v, _ in samples if not n.endswith("_bucket"))

    for name in ("seldon_api_engine_server_requests_duration_seconds",
                 "seldon_api_engine_client_requests_duration_seconds",
                 "seldon_api_model_feedback"):
        gt, wt = shape(got[name]), shape(want[name])
        assert gt[0] == wt[0]
        assert [(n, lbl) for n, lbl, _ in gt[1]] == [(n, lbl) for n, lbl, _ in wt[1]]
        assert [v for n, _, v in gt[1] if n.endswith(("_count", "_total"))] == \
            [v for n, _, v in wt[1] if n.endswith(("_count", "_total"))]
    if openmetrics:
        assert p.exposition(openmetrics=True).count(b"# EOF") == 1


def test_family_names_equal_the_jax_registry():
    assert MetricsRegistry.family_names() == JaxRegistry.family_names()
    assert ptel.TPU_METRIC_FAMILIES == jtel.TPU_METRIC_FAMILIES


@pytest.mark.parametrize("check", [
    "test_alert_rules_reference_exported_families",
    "test_grafana_dashboards_reference_exported_families",
    "test_new_tpu_families_are_dashboarded",
])
def test_monitoring_configs_check_passes_against_port_names(check, monkeypatch):
    """``tests/test_monitoring_configs.py``'s checks, run with the port's
    ``MetricsRegistry`` in the JAX one's place."""
    import tests.test_monitoring_configs as mc

    monkeypatch.setattr(mc, "MetricsRegistry", MetricsRegistry)
    getattr(mc, check)()


def test_every_family_is_in_the_exposition():
    text = MetricsRegistry().exposition().decode()
    exported = {f.name for f in text_parse(text)}
    for base in MetricsRegistry.family_names():
        root = base[: -len("_total")] if base.endswith("_total") else base
        assert root in exported, base


@pytest.mark.parametrize("value", [0.0, 1.0, -1.0, 0.5, 1e-9, 2.5e-4, 123456.0, 1234567.0,
                                   1e21, 7.25e8, math.inf, -math.inf, math.nan, 3, 10 ** 7])
def test_float_spelling_is_go_s(value):
    assert promtext.float_to_go_string(value) == floatToGoString(value)


@pytest.mark.parametrize("kind,tflops,gbs", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", 756.0, 2000.0),
    ("NVIDIA H100 NVL", 835.0, 3900.0),
])
def test_card_table_matches_the_datasheet(kind, tflops, gbs):
    assert chips.chip_peak_tflops(kind) == (tflops, False)
    assert chips.chip_peak_hbm_gbs(kind) == (gbs, False)


@pytest.mark.parametrize("kind", ["cpu", "", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"])
def test_unknown_kind_takes_the_jax_default_flagged_assumed(kind):
    from seldon_core_tpu.utils import chips as jchips

    want_t = jchips._DEFAULT_TFLOPS
    want_b = jchips._DEFAULT_HBM_GBS
    assert chips.chip_peak_tflops(kind) == (want_t, True)
    assert chips.chip_peak_hbm_gbs(kind) == (want_b, True)


def test_audit_log_records_to_a_sink_and_counts():
    got = []
    log = ptel.AuditLog(sink=got.append)
    assert log.enabled
    assert log.record(puid="p1", method="predict", status=200)
    snap = log.snapshot()
    ref = jtel.AuditLog(sink=lambda e: None).snapshot()
    assert set(snap) == set(ref)
    assert ptel.AuditLog().enabled == jtel.AuditLog().enabled


def _fake_nvcc(tmp_path):
    """An ``nvcc`` stand-in that writes its ``-o`` file: builds without a
    compiler, so the build's report to the recorder can be seen."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv\n"
        "open(a[a.index('-o') + 1], 'wb').write(b'not a library')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_kernel_builds_report_a_miss_then_a_hit(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    rec = ptel.RECORDER
    before = dict(rec.compile_cache_events)
    n_secs = rec.compile_seconds.snapshot()["count"]
    _build._build("fused_mlp")   # not on disk: built
    _build._build("fused_mlp")   # keyed by the same hash: on disk
    after = rec.compile_cache_events
    assert after.get("miss", 0) - before.get("miss", 0) == 1
    assert after.get("hit", 0) - before.get("hit", 0) == 1
    assert rec.compile_seconds.snapshot()["count"] == n_secs + 1
    assert "seldon_tpu_compile_cache_events_total" in rec.exposition().decode()


def test_wire_copies_land_in_the_recorder():
    from seldon_core_tpu_torch.runtime import wire

    before = ptel.RECORDER.wire_bytes_copied
    wire.account_copy(1234)
    assert wire.bytes_copied() == ptel.RECORDER.wire_bytes_copied == before + 1234
    assert json.loads(json.dumps(ptel.RECORDER.snapshot()))["wire"]["bytes_copied"] == before + 1234
