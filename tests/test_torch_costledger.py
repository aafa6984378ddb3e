"""The port's cost ledger (``seldon_core_tpu_torch/utils/costledger.py``)
against the JAX package's: the same flush and tick payloads, folded into a
fresh ledger of each package, give the same ``/costs`` document (``devices``
set equal on both sides; the window and the capacity's time-based fields
aside), the same usage advance and the same fleet merge.  Then the
producers: the tenant and tier of ``Seldon-Tenant`` / ``Seldon-Tier`` reach
the micro-batcher's flush record over REST, gRPC and the binary wire, and a
generator engine on the CPU serving two tenants over the REST lane bills
both through the continuous lane with the accounting identity holding and
``accounted_fraction`` 1.0."""

import asyncio
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.utils import costledger as jcl
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import Meta, SeldonMessage
from seldon_core_tpu_torch.runtime import wire
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel, FastGrpcServer
from seldon_core_tpu_torch.runtime.qos import (
    current_tenant,
    current_tier,
    parse_tier,
    qos_scope,
    resolve_tenant,
    tier_rank,
)
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.utils import costledger as pcl
from seldon_core_tpu_torch.utils import hotrecord as phr
from seldon_core_tpu_torch.utils.telemetry import RECORDER
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


def _payloads(seed):
    """Seeded flush and tick payloads: tenants, tiers, padded capacity,
    device walls, bubbles, KV releases, a phase with no attribution."""
    rng = np.random.default_rng(seed)
    tenants = ["acme", "globex", ""]
    flushes, ticks = [], []
    for _ in range(6):
        rows = [(str(rng.choice(tenants)), str(rng.choice(["interactive", "batch"])),
                 float(rng.integers(1, 9)), float(rng.integers(1, 3)), 0)
                for _ in range(int(rng.integers(1, 4)))]
        flushes.append(({"dep": "mnist", "padded": float(sum(r[2] for r in rows) * 2),
                         "tenants": rows}, float(rng.random() * 0.01)))
    for k in range(8):
        phases = {}
        for ph in ("prefill", "decode"):
            if rng.random() < 0.8:
                rows = [(str(rng.choice(tenants)), "interactive", float(rng.integers(0, 5)),
                         float(rng.integers(0, 2)), int(rng.integers(0, 9)))
                        for _ in range(int(rng.integers(1, 4)))]
                phases[ph] = {"padded": float(rng.integers(4, 32)), "tenants": rows}
        detail = {"device_phases": {"prefill": float(rng.random() * 0.02),
                                    "decode": float(rng.random() * 0.02)},
                  "attr": {"dep": "gen", "phases": phases,
                           "kv": tuple((str(rng.choice(tenants)), float(rng.random()))
                                       for _ in range(int(rng.integers(0, 3))))}}
        if k % 3:
            detail["bubble_s"] = float(rng.random() * 0.001)
        ticks.append(detail)
    return flushes, ticks


def _fill(ledger, seed):
    flushes, ticks = _payloads(seed)
    for cost, dev in flushes:
        ledger.fold_flush(cost, dev)
    for detail in ticks:
        ledger.fold_gen_tick(detail)
    ledger.note_bytes("acme", "mnist", "wire", 4096)
    ledger.note_bytes("", "", "wire_copy", 100)
    ledger.note_bytes("globex", "gen", "relay", 0)  # nothing: n <= 0
    ledger.devices = 4
    return ledger


def _comparable(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("window_s")
    for k in ("available_chip_s", "utilization"):
        doc["capacity"].pop(k)
    return doc


@pytest.mark.parametrize("seed", range(3))
def test_the_same_payloads_give_the_same_document(seed):
    j, p = _fill(jcl.CostLedger(), seed), _fill(pcl.CostLedger(), seed)
    jd, pd = j.document(), p.document()
    assert _comparable(pd) == _comparable(jd)
    assert pd["capacity"]["chips"] == 4
    acct = pd["accounting"]
    # the identity, by construction
    total = sum(p.device_s.values()) + sum(p.pad_tax_s.values()) + p.idle_s + p.unattributed_s
    assert abs(total - p.wall_s) < 1e-9
    assert acct["accounted_fraction"] < 1.0 or acct["unattributed_s"] == 0.0
    for tenant in ("acme", "globex", "", "nobody"):
        assert p.usage_advance(tenant) == j.usage_advance(tenant)
    merged_j = jcl.merge_cost_documents([jd, None, jd])
    merged_p = pcl.merge_cost_documents([pd, None, pd])
    merged_j.pop("window_s")
    merged_p.pop("window_s")
    for m in (merged_j, merged_p):
        m["capacity"] = {k: v for k, v in m["capacity"].items()
                         if k not in ("available_chip_s", "utilization")}
    assert merged_p == merged_j


def test_publish_gauges_push_the_fraction_and_reset_clears():
    led = _fill(pcl.CostLedger(), 1)
    led.publish_gauges()
    assert RECORDER.cost_attributed_fraction == led.document()["accounting"]["accounted_fraction"]
    led.reset()
    assert led.document()["tenants"] == [] and led.wall_s == 0.0


def test_the_identity_half_of_qos_matches_the_reference():
    from seldon_core_tpu.runtime import qos as jqos
    from seldon_core_tpu_torch.runtime import qos as pqos

    for name in ("TENANT_HEADER", "TIER_HEADER", "TIERS", "THROTTLE_INFO_PREFIX"):
        assert getattr(pqos, name) == getattr(jqos, name)
    for v in (None, "", "BATCH", " offline ", "gold"):
        assert parse_tier(v) == jqos.parse_tier(v)
        assert tier_rank(v) == jqos.tier_rank(v)
    for h, pr in ((None, None), ("  ", "svc"), ("t" * 80, None), ("acme", "svc")):
        assert resolve_tenant(h, pr) == jqos.resolve_tenant(h, pr)
    assert (current_tenant(), current_tier()) == (None, "interactive")
    with qos_scope("acme", "batch"):
        assert (current_tenant(), current_tier()) == ("acme", "batch")
    assert (current_tenant(), current_tier()) == (None, "interactive")


# ---------------------------------------------------------------------------
# the producers
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_ledger():
    phr.SPINE.drain()
    pcl.LEDGER.reset()
    yield pcl.LEDGER
    phr.SPINE.drain()
    pcl.LEDGER.reset()


class _Server:
    """The port's REST lane for ``engine`` on a private loop thread, with a
    gRPC server beside it."""

    def __init__(self, engine):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = self.run(serve_fast(engine, "127.0.0.1", 0))
        self.grpc = FastGrpcServer.for_engine(engine)
        self.run(self.grpc.start("127.0.0.1", 0))
        self.base = f"http://127.0.0.1:{self.server.port}"

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(WAIT_S)

    def call(self, path, body, headers=None):
        req = urllib.request.Request(self.base + path, data=body, headers=headers or {})
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, r.read()

    def grpc_call(self, body, metadata):
        async def go():
            ch = await FastGrpcChannel().connect("127.0.0.1", self.grpc.port)
            try:
                return await ch.call(b"/seldon.protos.Seldon/Predict", body, metadata)
            finally:
                await ch.close()

        return self.run(go())

    def close(self):
        self.run(self.server.stop())
        self.run(self.grpc.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _rows(doc):
    return {(r["tenant"], ph): v for r in doc["tenants"] for ph, v in r["device_s"].items()}


def test_tenants_reach_the_flush_record_over_rest_grpc_and_the_wire(fresh_ledger):
    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    srv = _Server(engine)
    x = np.random.default_rng(6).random((3, 784))
    try:
        st, _ = srv.call("/api/v0.1/predictions",
                         json.dumps({"data": {"ndarray": x.tolist()}}).encode(),
                         {"Seldon-Tenant": "Rest-T", "Seldon-Tier": "batch"})
        assert st == 200
        body = protoconv.msg_to_proto(SeldonMessage.from_array(x, meta=Meta(puid="g1")))
        out = protoconv.msg_from_proto(srv.grpc_call(body, ((b"seldon-tenant", b"grpc-t"),)))
        assert out.array().shape == (3, 10)
        frame = wire.join_parts(wire.encode_frame(
            x.astype(np.float32), meta_bytes=wire.pack_wire_meta(tenant="wire-t", tier="offline")))
        st, raw = srv.call("/api/v0.1/predictions", frame,
                           {"Content-Type": wire.WIRE_CONTENT_TYPE})
        assert st == 200 and wire.decode_frame(raw).array.shape == (3, 10)
        costs = engine.costs_document()
    finally:
        srv.close()
        engine.close()
    rows = _rows(costs)
    assert {t for t, ph in rows} == {"Rest-T", "grpc-t", "wire-t"}
    assert all(ph == "batch" and v > 0 for (t, ph), v in rows.items())
    assert set(costs["tiers"]) == {"batch/batch", "interactive/batch", "offline/batch"}
    wire_row = next(r for r in costs["tenants"] if r["tenant"] == "wire-t")
    assert wire_row["bytes"]["wire"] == x.astype(np.float32).nbytes
    acct = costs["accounting"]
    assert acct["accounted_fraction"] == 1.0 and acct["folds"] == 3
    assert costs["capacity"]["chips"] == 1 and costs["engine"]["deployment"] == "mnist-deployment"


def _gen_doc():
    return {"spec": {"name": "gen-costs", "predictors": [{
        "name": "main",
        "components": [{"name": "gen", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": [{"name": n, "value": str(v), "type": "INT"} for n, v in (
                            ("vocab", 64), ("d_model", 32), ("n_heads", 4), ("n_kv_heads", 2),
                            ("n_layers", 2), ("d_ff", 64), ("max_new_tokens", 12))]}],
        "graph": {"name": "gen", "type": "MODEL", "children": []}}]}}


def test_two_tenants_on_the_continuous_lane_are_billed_with_the_identity(fresh_ledger):
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_gen_doc()), device="cpu")
    assert engine.genserver is not None
    srv = _Server(engine)
    rng = np.random.default_rng(2)
    try:
        def send(tenant, rows):
            body = json.dumps({"data": {"ndarray": rows.tolist()}}).encode()
            return srv.call("/api/v0.1/predictions", body, {"Seldon-Tenant": tenant})

        threads = [threading.Thread(target=send, args=(t, rng.integers(0, 64, (b, 20))))
                   for t, b in (("acme", 1), ("globex", 1), ("acme", 1), ("globex", 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        st, body = srv.call("/costs", None)
        costs = json.loads(body)
    finally:
        srv.close()
        engine.close()
    led = fresh_ledger
    total = sum(led.device_s.values()) + sum(led.pad_tax_s.values()) + led.idle_s \
        + led.unattributed_s
    assert st == 200 and abs(total - led.wall_s) < 1e-6
    assert costs["accounting"]["accounted_fraction"] == 1.0
    assert costs["accounting"]["unattributed_s"] == 0.0
    by_tenant = {r["tenant"]: r for r in costs["tenants"]}
    assert set(by_tenant) == {"acme", "globex"}
    rows = {"acme": 2, "globex": 4}
    for tenant, r in by_tenant.items():
        assert r["device_s"]["prefill"] > 0 and r["device_s"]["decode"] > 0
        assert r["kv_block_s"] > 0 and r["deployment"] == "gen-costs"
        # every served token billed: the first at prefill, the rest at decode
        assert sum(r["served_tokens"].values()) == 12 * rows[tenant]
