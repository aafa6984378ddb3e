"""Deterministic fault injection for the inference graph — the port's
counterpart of ``seldon_core_tpu/testing/faults.py``, over the port's
``NodeRuntime`` (``graph/interpreter.py``), ``RemoteCallError``
(``runtime/client.py``), messages and QoS scope.  The same seed and specs
draw the same injections as the JAX package's harness, call for call.

``FaultyNodeRuntime`` wraps any ``NodeRuntime`` (in-process or remote) and
injects seeded delays, errors, client-style timeouts, and malformed
responses per method — the chaos harness the resilience layer's contracts
are tested against (tests/test_chaos.py; the port's in
tests/test_torch_faults.py).  Determinism is the whole point:
every injection decision comes from one ``random.Random(seed)`` stream per
wrapper, so a failing chaos scenario replays exactly.

Usage::

    faulty = FaultyNodeRuntime(
        inner,
        FaultSpec(error_rate=1.0),                 # every method
        seed=7,
    )
    faulty = FaultyNodeRuntime(
        inner,
        {"predict": FaultSpec(delay_s=0.2, error_rate=0.3)},  # per method
    )

Wire it into a graph via ``GraphExecutor``/``EngineService``
``extra_runtimes`` — the engine then exercises real degradation paths
(combiner quorum, router fallback, retries, breakers) with zero network
setup.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Union

from seldon_core_tpu_torch.graph.interpreter import NodeRuntime
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage

__all__ = [
    "FaultSpec",
    "FaultyNodeRuntime",
    "FaultyEngine",
    "InjectedFault",
    "PartitionedStore",
    "drive_tenant",
    "kill_engine",
]


class InjectedFault(Exception):
    """Raised by an injected error/timeout.  Defined standalone (imported
    as a ``RemoteCallError`` peer at the call site) so the chaos suite can
    assert the failure came from the harness, not the system under test."""


@dataclass
class FaultSpec:
    """Per-method fault probabilities, evaluated in order: delay always
    applies, then timeout / error / malformed draw one uniform sample
    (mutually exclusive per call)."""

    delay_s: float = 0.0        # added latency on every call
    error_rate: float = 0.0     # P(raise InjectedFault-as-RemoteCallError)
    timeout_rate: float = 0.0   # P(raise asyncio.TimeoutError — client view)
    malformed_rate: float = 0.0  # P(return a payload-free garbage message)

    @property
    def total_failure_rate(self) -> float:
        return self.error_rate + self.timeout_rate + self.malformed_rate


class FaultyNodeRuntime(NodeRuntime):
    """A NodeRuntime wrapper injecting faults BEFORE delegating.

    ``faults`` is either one ``FaultSpec`` (applied to every method) or a
    mapping ``method-name -> FaultSpec`` (methods absent from the mapping
    pass through untouched).  Calls are counted per method
    (``self.calls``) so tests can assert how often the system under test
    actually reached the node (retry counts, breaker fail-fast)."""

    def __init__(
        self,
        inner: NodeRuntime,
        faults: Union[FaultSpec, Mapping[str, FaultSpec]],
        seed: int = 0,
    ):
        self.inner = inner
        self.node = getattr(inner, "node", None)
        self._faults = faults
        self._rng = random.Random(seed)
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    def _spec_for(self, method: str) -> Optional[FaultSpec]:
        if isinstance(self._faults, FaultSpec):
            return self._faults
        return self._faults.get(method)

    def _name(self) -> str:
        node = self.node
        return getattr(node, "name", None) or "faulty-node"

    async def _maybe_fault(self, method: str) -> bool:
        """Apply the method's fault spec; True means "return a malformed
        response instead of delegating"."""
        self.calls[method] = self.calls.get(method, 0) + 1
        spec = self._spec_for(method)
        if spec is None:
            return False
        if spec.delay_s > 0:
            await asyncio.sleep(spec.delay_s)
        r = self._rng.random()
        if r < spec.error_rate:
            self.injected[method] = self.injected.get(method, 0) + 1
            from seldon_core_tpu_torch.runtime.client import RemoteCallError

            # raised AS a RemoteCallError so the system under test treats
            # it exactly like a real remote failure (degradable, breaker-
            # countable); InjectedFault mixin marks the provenance
            class _Injected(InjectedFault, RemoteCallError):
                pass

            raise _Injected(self._name(), method, "injected fault")
        r -= spec.error_rate
        if r < spec.timeout_rate:
            self.injected[method] = self.injected.get(method, 0) + 1
            raise asyncio.TimeoutError(f"injected timeout: {self._name()}.{method}")
        r -= spec.timeout_rate
        if r < spec.malformed_rate:
            self.injected[method] = self.injected.get(method, 0) + 1
            return True
        return False

    # -- NodeRuntime API ----------------------------------------------------

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if await self._maybe_fault("predict"):
            return SeldonMessage(str_data="\x00not-a-tensor")
        return await self.inner.predict(msg)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if await self._maybe_fault("transform_input"):
            return SeldonMessage(str_data="\x00not-a-tensor")
        return await self.inner.transform_input(msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        if await self._maybe_fault("transform_output"):
            return SeldonMessage(str_data="\x00not-a-tensor")
        return await self.inner.transform_output(msg)

    async def route(self, msg: SeldonMessage) -> int:
        if await self._maybe_fault("route"):
            from seldon_core_tpu_torch.runtime.client import RemoteCallError

            raise RemoteCallError(self._name(), "route", "injected bad branch")
        return await self.inner.route(msg)

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        if await self._maybe_fault("aggregate"):
            return SeldonMessage(str_data="\x00not-a-tensor")
        return await self.inner.aggregate(msgs)

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        if await self._maybe_fault("send_feedback"):
            return None
        return await self.inner.send_feedback(feedback, branch)

    def close(self) -> None:
        # the port's engine closes its runtimes synchronously
        closer = getattr(self.inner, "close", None)
        if closer is not None:
            closer()


class FaultyEngine:
    """An ``EngineService`` wrapper injecting faults at the ENGINE edge —
    the replica-set counterpart of :class:`FaultyNodeRuntime` (which wraps
    graph-node hops).  A replica set built over
    ``[engine, FaultyEngine(engine2, delay_s=...)]`` exercises a balancer
    against a deterministically slow or failing replica (the JAX
    package's gateway does so in tests/test_replica_balancer.py).

    Same determinism contract as the node wrapper: one seeded RNG stream,
    per-method call counts in ``self.calls``."""

    def __init__(self, inner, faults: Union[FaultSpec, Mapping[str, FaultSpec]],
                 seed: int = 0):
        self.inner = inner
        self._faults = faults
        self._rng = random.Random(seed)
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    def _spec_for(self, method: str) -> Optional[FaultSpec]:
        if isinstance(self._faults, FaultSpec):
            return self._faults
        return self._faults.get(method)

    async def _maybe_fault(self, method: str) -> bool:
        """Delay always applies; one uniform draw decides error vs
        malformed (timeouts collapse into errors at this edge — the
        gateway sees a failure message either way).  True = respond with
        a FAILURE message instead of delegating."""
        self.calls[method] = self.calls.get(method, 0) + 1
        spec = self._spec_for(method)
        if spec is None:
            return False
        if spec.delay_s > 0:
            await asyncio.sleep(spec.delay_s)
        if self._rng.random() < spec.total_failure_rate:
            self.injected[method] = self.injected.get(method, 0) + 1
            return True
        return False

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if await self._maybe_fault("predict"):
            return SeldonMessage.failure("injected engine fault", code=503)
        return await self.inner.predict(msg)

    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        if await self._maybe_fault("send_feedback"):
            return SeldonMessage.failure("injected engine fault", code=503)
        return await self.inner.send_feedback(feedback)

    def __getattr__(self, name):
        # stats/ready/open_breakers/predict_json/... delegate untouched so
        # the wrapper stays a drop-in EngineService wherever one is used
        return getattr(self.inner, name)


class ThrottledEngine:
    """An ``EngineService`` wrapper with FIXED capacity: at most
    ``concurrency`` predicts in service, each taking ``delay_s`` — a
    deterministic stand-in for a saturated device, so overload tests
    (tests/test_chaos.py fairness arm) have a real bottleneck to fight
    over.  Excess callers queue FIFO on the
    semaphore, which is exactly the starvation the QoS layer exists to
    prevent."""

    def __init__(self, inner, concurrency: int = 8,
                 delay_s: float = 0.04):
        self.inner = inner
        self.delay_s = float(delay_s)
        self._sem = asyncio.Semaphore(int(concurrency))
        self.served = 0

    async def predict(self, msg):
        async with self._sem:
            await asyncio.sleep(self.delay_s)
            self.served += 1
            return await self.inner.predict(msg)

    async def send_feedback(self, feedback):
        return await self.inner.send_feedback(feedback)

    def __getattr__(self, name):
        return getattr(self.inner, name)


async def drive_tenant(
    gateway,
    tenant: str,
    n: int,
    *,
    tier: Optional[str] = None,
    concurrency: int = 1,
    n_features: int = 4,
    msg_factory=None,
):
    """Fire ``n`` predicts at an in-process gateway (anything with an
    async ``predict``: the port's ``EngineService``) AS one tenant —
    the overload-fairness harness (tests/test_chaos.py hog/victim arms).

    Returns ``(latencies_s, outcomes)``: per-request wall seconds and
    the response status code (200 for SUCCESS).  ``concurrency`` > 1
    models a greedy caller that keeps that many requests permanently in
    flight; 1 models a polite sequential client."""
    import time as _time

    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.qos import qos_scope

    if msg_factory is None:
        def msg_factory():
            return SeldonMessage.from_array(
                np.zeros((1, n_features), dtype=np.float64))

    latencies: List[float] = []
    outcomes: List[int] = []
    sem = asyncio.Semaphore(max(int(concurrency), 1))

    async def one():
        async with sem:
            t0 = _time.perf_counter()
            with qos_scope(tenant, tier):
                resp = await gateway.predict(msg_factory())
            latencies.append(_time.perf_counter() - t0)
            st = resp.status
            outcomes.append(
                200 if st is None or st.status == "SUCCESS"
                else (st.code or 500))

    await asyncio.gather(*(one() for _ in range(int(n))))
    return latencies, outcomes


def kill_engine(proc, sig: Optional[int] = None) -> None:
    """Kill an engine subprocess mid-request / mid-stream.

    ``proc`` is anything with ``.pid`` (``subprocess.Popen``,
    ``asyncio.subprocess.Process``); ``sig`` defaults to SIGKILL — the
    interesting case, since SIGTERM triggers the engine's own graceful
    drain and the mesh never sees an abrupt death.  The call returns
    immediately (no wait); chaos harnesses assert on the FLEET's
    recovery, not the corpse's exit code."""
    import os as _os
    import signal as _signal

    if sig is None:
        sig = getattr(_signal, "SIGKILL", _signal.SIGTERM)
    _os.kill(proc.pid, sig)


class PartitionedStore:
    """A deployment-store wrapper that partitions / lags sqlite traffic,
    deterministically scriptable — the chaos harness for the federation
    layer (a coordinator whose store vanishes must demote itself and keep
    serving ingress, as the JAX package's gateway federation does).

    Modes, settable at any time mid-test:

    * ``store.partition()``       — every call raises ``InjectedFault``
    * ``store.heal()``            — calls pass through again
    * ``store.lag(seconds)``      — every call sleeps first (sync sleep:
      the store API is sync; callers on an event loop feel it as a stall,
      which is exactly what a slow disk does to them)
    * ``store.fail_next(n)``      — the next ``n`` calls raise, then heal
      (deterministic flap, no RNG involved)

    Reads and writes can be partitioned independently via
    ``partition(reads=..., writes=...)`` — a read-only partition models a
    replica that can renew its lease (write) but not list peers, and vice
    versa.  Method classification: anything starting with a mutating verb
    is a write, the rest are reads (``_WRITE_PREFIXES``)."""

    _WRITE_PREFIXES = ("set_", "register", "unregister", "issue_",
                       "acquire_", "release_", "heartbeat_", "drop_",
                       "fenced_", "delete", "revoke")

    def __init__(self, inner):
        self.inner = inner
        self._read_down = False
        self._write_down = False
        self._lag_s = 0.0
        self._fail_next = 0
        self.calls: Dict[str, int] = {}
        self.faults_injected = 0

    # -- the control surface (test-side) ---------------------------------

    def partition(self, *, reads: bool = True, writes: bool = True) -> None:
        self._read_down = bool(reads)
        self._write_down = bool(writes)

    def heal(self) -> None:
        self._read_down = self._write_down = False
        self._lag_s = 0.0
        self._fail_next = 0

    def lag(self, seconds: float) -> None:
        self._lag_s = max(float(seconds), 0.0)

    def fail_next(self, n: int = 1) -> None:
        self._fail_next = max(int(n), 0)

    # -- the data path (system-under-test side) --------------------------

    def _gate(self, name: str) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        if self._lag_s:
            import time as _time

            _time.sleep(self._lag_s)
        if self._fail_next > 0:
            self._fail_next -= 1
            self.faults_injected += 1
            raise InjectedFault(f"store fault injected on {name}")
        is_write = name.startswith(self._WRITE_PREFIXES)
        if (is_write and self._write_down) or \
                (not is_write and self._read_down):
            self.faults_injected += 1
            raise InjectedFault(
                f"store partitioned ({'write' if is_write else 'read'} "
                f"path down) on {name}")

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def gated(*args, **kwargs):
            self._gate(name)
            return attr(*args, **kwargs)

        return gated
