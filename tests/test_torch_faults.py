"""The port's ``testing/faults.py`` against the JAX package's
(``seldon_core_tpu/testing/faults.py``): the same seeded scenarios through
both packages' ``FaultyNodeRuntime`` / ``FaultyEngine`` on both packages'
``EngineService`` draw the same injections (``calls`` and ``injected``
equal, call for call) and the engines degrade alike (the same statuses,
degraded branches and served branches): ``tests/test_chaos.py``'s
quorum-survives, below-quorum, malformed-child, fallback and
open-breaker-fallback cases, a seeded mix of faults, and the engine-edge
wrapper.  Then ``ThrottledEngine``'s concurrency cap driven by
``drive_tenant`` through the port's QoS scope, ``PartitionedStore``'s
partition, heal and ``fail_next``, and ``kill_engine`` on a child process."""

import asyncio
import json
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import units as jax_units
from seldon_core_tpu.graph.interpreter import GraphExecutor as JaxExecutor
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.testing import faults as jf
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.interpreter import GraphExecutor
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.qos import current_tenant
from seldon_core_tpu_torch.testing import faults as tf


@pytest.fixture(autouse=True)
def _isolated():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_learned_singletons()
    yield
    torch.set_num_threads(prev)
    reset_learned_singletons()
    from seldon_core_tpu.runtime.autopilot import AUTOPILOT
    from seldon_core_tpu.runtime.brownout import BROWNOUT

    AUTOPILOT.reset()
    BROWNOUT.reset()


@jax_units.register_unit("tfault.Router0")
class _JaxRouter0(jax_units.Unit):
    """Always branch 0 (the branch the scenarios break)."""

    def route(self, state, X):
        return jnp.int32(0)


@tunits.register_unit("tfault.Router0")
class _Router0(tunits.Unit):
    def route(self, state, X):
        return 0


COMBINER = {"name": "ens", "implementation": "AVERAGE_COMBINER", "quorum": 2,
            "children": [{"name": c, "implementation": "SIMPLE_MODEL"} for c in "abc"]}
ROUTER = {"name": "r", "type": "ROUTER", "fallback": 1,
          "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                       {"name": "b", "implementation": "SIMPLE_MODEL"}]}
ROUTER_COMPONENTS = [{"name": "r", "runtime": "inprocess", "class_path": "tfault.Router0"}]
# the open-breaker case: child a bound as a REST remote nobody listens on
BREAKER = {"name": "r", "type": "ROUTER", "fallback": 1,
           "children": [{"name": "a", "type": "MODEL"},
                        {"name": "b", "implementation": "SIMPLE_MODEL"}]}
BREAKER_COMPONENTS = ROUTER_COMPONENTS + [{"name": "a", "runtime": "rest",
                                           "host": "127.0.0.1", "port": 1}]


def _doc(graph, components=None):
    return {"spec": {"name": "chaos", "predictors": [
        {"name": "p", "graph": graph, "components": components or []}]}}


PACKAGES = {
    "jax": dict(spec=JaxSpec, executor=JaxExecutor, engine=JaxEngine, msg=JaxMessage,
                faults=jf, kw={}),
    "port": dict(spec=SeldonDeploymentSpec, executor=GraphExecutor, engine=EngineService,
                 msg=SeldonMessage, faults=tf, kw={"device": "cpu"}),
}


def _outcome(resp):
    """What a scenario compares: status, code, degraded and fallback tags,
    the served route, the answer's shape."""
    st = resp.status
    meta = resp.meta
    tags = {k: v for k, v in (meta.tags if meta else {}).items()
            if k.startswith(("seldon.degraded", "seldon.fallback"))}
    arr = resp.array() if st is None or st.status == "SUCCESS" else None
    return {"status": None if st is None else st.status, "code": None if st is None else st.code,
            "tags": tags, "routing": dict(meta.routing) if meta else {},
            "shape": None if arr is None else list(np.asarray(arr).shape)}


async def _close(engine):
    out = engine.close()
    if asyncio.iscoroutine(out):
        await out


def _scenario(pkg, graph, components, wrap, n, rows=((1.0, 2.0),)):
    """``n`` predicts through ``pkg``'s host-mode engine over executor
    runtimes wrapped by ``wrap(faults_module, runtimes)`` -> (outcomes,
    {node: (calls, injected)})."""
    p = PACKAGES[pkg]
    spec = p["spec"].from_json_dict(json.loads(json.dumps(_doc(graph, components))))
    executor = p["executor"](spec.predictor(), **p["kw"])
    wrapped = wrap(p["faults"], executor.runtimes)

    async def run():
        engine = p["engine"](spec, extra_runtimes=executor.runtimes, force_host=True, **p["kw"])
        try:
            return [_outcome(await engine.predict(p["msg"].from_array(np.array(rows))))
                    for _ in range(n)]
        finally:
            await _close(engine)

    outs = asyncio.run(run())
    return outs, {k: (dict(w.calls), dict(w.injected)) for k, w in wrapped.items()}


def _wrap(specs, seed=7):
    def wrap(fm, runtimes):
        out = {}
        for node, spec in specs.items():
            runtimes[node] = out[node] = fm.FaultyNodeRuntime(
                runtimes[node], fm.FaultSpec(**spec), seed=seed)
        return out
    return wrap


def _both(*args, **kw):
    got = {pkg: _scenario(pkg, *args, **kw) for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]


CASES = {
    # one of three members dead: 200s under quorum 2, the dropped branch tagged
    "quorum_survives": (COMBINER, None, {"b": dict(error_rate=1.0)}, 5),
    # two of three dead (an error and a timeout): below quorum, the request fails
    "below_quorum": (COMBINER, None, {"a": dict(error_rate=1.0), "b": dict(timeout_rate=1.0)},
                     3),
    # a member answering garbage is a failed branch, not a poisoned mean
    "malformed_child": (COMBINER, None, {"c": dict(malformed_rate=1.0)}, 3),
    # the routed branch fails: the fallback serves, routing names it
    "fallback": (ROUTER, ROUTER_COMPONENTS, {"a": dict(error_rate=1.0)}, 3),
    # a seeded mix on one member: which request degrades is the RNG's draw
    "seeded_mix": (COMBINER, None, {"b": dict(error_rate=0.25, timeout_rate=0.2,
                                             malformed_rate=0.15)}, 24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chaos_scenarios_inject_and_degrade_alike(case):
    graph, components, specs, n = CASES[case]
    outs, counts = _both(graph, components, _wrap(specs), n)
    for node, (calls, injected) in counts.items():
        assert calls == {"predict": n}, (node, calls)
        if min(specs[node].values()) == 1.0:
            assert injected == {"predict": n}, (node, injected)
    if case == "below_quorum":
        assert all(o["status"] == "FAILURE" for o in outs)
        return
    assert all(o["status"] in (None, "SUCCESS") for o in outs), outs
    if case in ("quorum_survives", "malformed_child"):
        node = next(iter(specs))
        assert all(o["tags"] == {"seldon.degraded.ens": [node]} and o["shape"] == [1, 3]
                   for o in outs), outs
    if case == "fallback":
        assert all(o["routing"] == {"r": 1} and o["tags"]["seldon.fallback.r"] == 1
                   for o in outs), outs
    if case == "seeded_mix":
        degraded = [bool(o["tags"]) for o in outs]
        assert 0 < sum(degraded) < n and sum(degraded) == sum(counts["b"][1].values())


def test_open_breaker_branch_serves_via_fallback():
    """The routed branch's breaker is open: the call fails fast and the
    fallback serves, on both engines; a counting wrapper (no faults) sees
    the one call reach the branch's runtime."""
    got = {}
    for pkg, p in PACKAGES.items():
        spec = p["spec"].from_json_dict(json.loads(json.dumps(_doc(BREAKER,
                                                                   BREAKER_COMPONENTS))))

        async def run():
            engine = p["engine"](spec, **p["kw"])
            try:
                assert engine.mode == "host"
                engine.breakers["a"].trip()
                counter = p["faults"].FaultyNodeRuntime(engine.executor.runtimes["a"], {})
                engine.executor.runtimes["a"] = counter
                resp = await engine.predict(p["msg"].from_array(np.array([[1.0, 2.0]])))
                return (_outcome(resp), engine.open_breakers(), dict(counter.calls),
                        dict(counter.injected))
            finally:
                await _close(engine)

        got[pkg] = asyncio.run(run())
    assert got["port"] == got["jax"]
    out, open_, calls, injected = got["port"]
    assert out["routing"] == {"r": 1} and out["tags"]["seldon.fallback.r"] == 1
    assert "BreakerOpenError" in out["tags"]["seldon.fallback.r.reason"]
    assert open_ == ["a"] and calls == {"predict": 1} and injected == {}


def test_faulty_engine_fails_as_seeded():
    """The engine-edge wrapper: a seeded half of the predicts answer the
    503 failure message, the rest delegate; the same requests on both."""
    got = {}
    for pkg, p in PACKAGES.items():
        spec = p["spec"].from_json_dict(_doc({"name": "m", "implementation": "SIMPLE_MODEL"}))

        async def run():
            engine = p["engine"](spec, **p["kw"])
            faulty = p["faults"].FaultyEngine(engine, p["faults"].FaultSpec(error_rate=0.3,
                                                                          malformed_rate=0.2),
                                              seed=3)
            try:
                outs = [_outcome(await faulty.predict(p["msg"].from_array(np.ones((1, 2)))))
                        for _ in range(16)]
                return outs, dict(faulty.calls), dict(faulty.injected), faulty.mode
            finally:
                await _close(engine)

        got[pkg] = asyncio.run(run())
    assert got["port"] == got["jax"]
    outs, calls, injected, _ = got["port"]
    failed = [o["code"] for o in outs if o["status"] == "FAILURE"]
    assert calls == {"predict": 16} and len(failed) == injected["predict"] > 0
    assert set(failed) == {503}


class _Counting:
    """An engine stand-in that records its peak concurrency and tenants."""

    def __init__(self, msg):
        self.msg, self.inflight, self.peak, self.tenants = msg, 0, 0, []

    async def predict(self, msg):
        self.inflight += 1
        self.peak = max(self.peak, self.inflight)
        self.tenants.append(current_tenant())
        await asyncio.sleep(0)
        self.inflight -= 1
        return self.msg.from_array(np.zeros((1, 2)))


def test_throttled_engine_caps_concurrency_under_drive_tenant():
    """``ThrottledEngine(concurrency=2)`` under ``drive_tenant`` with 6
    requests kept in flight: at most 2 in service, all 6 served with 200
    inside the tenant's QoS scope, in three waves of ``delay_s``."""
    inner = _Counting(SeldonMessage)
    throttled = tf.ThrottledEngine(inner, concurrency=2, delay_s=0.05)
    lat, outcomes = asyncio.run(tf.drive_tenant(throttled, "acme", 6, tier="gold",
                                                concurrency=6))
    assert outcomes == [200] * 6 and throttled.served == 6 and inner.peak <= 2
    assert inner.tenants == ["acme"] * 6
    assert sorted(lat)[-1] >= 3 * 0.05 * 0.9  # the last waited two waves
    # the engine's other attributes pass through
    assert throttled.msg is SeldonMessage


class _Store:
    def __init__(self):
        self.rows = {}

    def set_lease(self, k, v):
        self.rows[k] = v

    def list_peers(self):
        return sorted(self.rows)


@pytest.mark.parametrize("mode", ["partition", "reads_only", "fail_next"])
def test_partitioned_store_modes_match(mode):
    """The same script of calls through both packages' wrappers raises at
    the same calls (each package's ``InjectedFault``) and counts alike."""
    got = {}
    for pkg, fm in (("jax", jf), ("port", tf)):
        store = fm.PartitionedStore(_Store())
        trace = []

        def call(name, *a):
            try:
                getattr(store, name)(*a)
                trace.append((name, "ok"))
            except fm.InjectedFault as e:
                trace.append((name, str(e)))

        call("set_lease", "a", 1)
        if mode == "partition":
            store.partition()
        elif mode == "reads_only":
            store.partition(reads=True, writes=False)
        else:
            store.fail_next(2)
        for _ in range(2):
            call("set_lease", "b", 2)
            call("list_peers")
        store.heal()
        call("list_peers")
        got[pkg] = (trace, dict(store.calls), store.faults_injected, store.inner.rows)
    assert got["port"] == got["jax"]
    trace, calls, faults, _ = got["port"]
    assert trace[-1] == ("list_peers", "ok") and calls == {"set_lease": 3, "list_peers": 3}
    assert faults == {"partition": 4, "reads_only": 2, "fail_next": 2}[mode]


def test_kill_engine_kills_a_child_process():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        tf.kill_engine(proc)
        assert proc.wait(timeout=10) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
