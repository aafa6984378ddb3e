"""API gateway — the reference's ``api-frontend`` ("apife"); the port's copy
of ``seldon_core_tpu/gateway/apife.py``.

  * OAuth2-style client-credentials auth: each deployment registers an
    (oauth_key, oauth_secret) pair; POST /oauth/token with HTTP basic auth
    (or the form fields) issues a bearer token, and the principal selects
    the target graph (api-frontend RestClientController.java:126-177).
  * Prediction routing: principal -> deployment -> predictor.  With several
    predictors the gateway splits traffic by replica weight with
    ``np.random.default_rng(seed)``, so a seed picks the same predictors as
    the JAX gateway's (the canary pattern); within the predictor it
    balances its replica set by power-of-two-choices (gateway/balancer.py).
  * Shadow mirroring (gateway/shadow.py), the request/response firehose
    (gateway/firehose.py), hedged re-dispatch of a failed unary predict and
    re-homing of a broken stream (with federation on), tenant admission and
    the brownout ladder, ingress metrics.

Targets are in-process port ``EngineService``s (called directly; their
answers are host numpy), remote engine base URLs (JSON or the binary wire
over the gateway's one upstream client, ``runtime/client.py``
``HttpClient``), ``uds:`` socket paths (the ``runtime/udsrelay.py`` lane,
binary frames coalesced per socket), or lists of those (a replica set).
The HTTP surface is ``GatewayRoutes`` on the port's ``FastHttpServer``
(``serve_gateway``); the gRPC one ``FastGrpcServer.for_gateway``.  The
gateway holds no tensors of its own.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import random
import secrets
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from seldon_core_tpu_torch.gateway.balancer import (
    PickDecision,
    ReplicaEndpoint,
    ReplicaSet,
    parse_endpoint_spec,
    replicas_enabled,
    scrape_interval_s,
    uds_enabled,
)

from seldon_core_tpu_torch.gateway.firehose import Firehose
from seldon_core_tpu_torch.gateway.shadow import (
    ShadowConfig,
    ShadowMirror,
    shadow_config_from_spec,
)
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, SeldonMessageError
from seldon_core_tpu_torch.runtime.brownout import BROWNOUT, BROWNOUT_INFO_PREFIX
from seldon_core_tpu_torch.runtime.client import HttpClient, UpstreamConnectError
from seldon_core_tpu_torch.runtime.grpcfast import Unauthenticated
from seldon_core_tpu_torch.runtime.qos import (
    THROTTLE_INFO_PREFIX,
    TenantGovernor,
    current_tenant,
    current_tier,
    qos_scope,
    resolve_tenant,
)
from seldon_core_tpu_torch.runtime.rest import (
    FastHttpServer,
    StreamResult,
    _payload_text,
    _request_header,
    _request_query,
)
from seldon_core_tpu_torch.runtime.udsrelay import OP_FEEDBACK, OP_PREDICT, OP_WIRE
from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir
# importing the spine at module load wires the global TRACER's ring sink
# BEFORE the gateway serves its first request — a gateway-only process
# must not flip span routing mid-serving when someone first polls
# /overhead (the ingress hop's request spans are its fused records)
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.runtime.resilience import (
    DEADLINE_HEADER,
    IDEMPOTENT_METHODS,
    RetryBudget,
    deadline_header_value,
    maybe_deadline_scope,
    remaining_s,
)
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch.utils.promtext import CONTENT_TYPE_LATEST

__all__ = ["ApiGateway", "DeploymentStore", "AuthError", "GatewayRoutes", "serve_gateway"]

TOKEN_TTL_S = 3600.0


class AuthError(Unauthenticated):
    """A refused credential or token: 401 over HTTP; over gRPC the
    runtime's ``Unauthenticated`` ends the call UNAUTHENTICATED."""


def _not_decode(ep) -> bool:
    """Client traffic never lands on a decode-only replica — decode
    replicas serve KV handoffs from prefill peers, nothing else
    (runtime/servingmesh.py phase routing)."""
    return getattr(ep, "role", "unified") != "decode"


def _release_brownout_sink(sink) -> None:
    """Detach a gateway's firehose event sink from the global brownout
    controller — only if it is still the installed one (a later gateway
    may have taken over already)."""
    if sink is not None and BROWNOUT.event_sink is sink:
        BROWNOUT.event_sink = None


@dataclass
class _Registration:
    deployment_id: str
    oauth_key: str
    oauth_secret: str
    #: [(predictor_name, weight, engine)] where engine is an
    #: EngineService, an endpoint spec string (base URL / ``uds:`` path /
    #: ``url+uds:path``), or a LIST of those — a replica set
    engines: List
    #: mirror policy when one predictor is annotated seldon.io/shadow
    #: (gateway/shadow.py) — that predictor serves weight-0 live traffic
    #: and receives the sampled fire-and-forget copies instead
    shadow: Optional[ShadowConfig] = None


class _WireCoalescer:
    """Co-arriving binary predicts for ONE engine socket ride a single
    multi-tensor relay frame (runtime/wire.py MULTI): the first arrival
    opens a ``SELDON_TPU_WIRE_COALESCE_US`` window; everything that
    lands inside it (capped at ``SELDON_TPU_WIRE_COALESCE_MAX``) is
    packed into one ``OP_WIRE`` hop and de-coalesced positionally from
    the response's sub-frames — per-request hop cost amortizes exactly
    where the engine's MicroBatcher would have re-batched the rows
    anyway.  A window of 0 sends every frame solo.  Sub-request failures
    are per-slot typed frames; a transport failure fails the whole batch
    with the error every caller would have seen solo."""

    def __init__(self, client, window_s: float, max_n: int):
        self.client = client
        self.window_s = window_s
        self.max_n = max_n
        self._pending: list = []  # [(frame_bytes, future)]
        self._flush_task: Optional[asyncio.Task] = None
        # STRONG refs to in-flight flush/send tasks: the event loop only
        # holds tasks weakly, and a task whose last reference is dropped
        # mid-await is garbage-collected mid-flight (GeneratorExit) —
        # every waiter would then hang to its deadline
        self._tasks: set = set()

    def _track(self, task: asyncio.Task) -> asyncio.Task:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        task.add_done_callback(
            lambda t: None if t.cancelled() else t.exception())
        return task

    async def call(self, frame: bytes) -> "tuple[bytes, int]":
        if self.window_s <= 0:
            return await self.client.call(OP_WIRE, frame)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((frame, fut))
        if len(self._pending) >= self.max_n:
            batch = self._take()
            self._track(loop.create_task(self._send(batch)))
        elif self._flush_task is None:
            self._flush_task = self._track(
                loop.create_task(self._delayed_flush()))
        return await fut

    def _take(self) -> list:
        batch, self._pending = self._pending, []
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        return batch

    async def _delayed_flush(self) -> None:
        try:
            await asyncio.sleep(self.window_s)
        except asyncio.CancelledError:
            raise
        self._flush_task = None
        batch, self._pending = self._pending, []
        if batch:
            await self._send(batch)

    async def _send(self, batch: list) -> None:
        from seldon_core_tpu_torch.runtime import wire as wirelib

        try:
            if len(batch) == 1:
                body, status = await self.client.call(OP_WIRE, batch[0][0])
                self._resolve(batch[0][1], (body, status))
                return
            RECORDER.record_wire_coalesced(len(batch))
            multi = wirelib.join_parts(
                wirelib.encode_multi([f for f, _fut in batch]))
            body, status = await self.client.call(OP_WIRE, multi)
            if status == 415:
                # peer doesn't speak OP_WIRE: hand every caller the 415
                # so each negotiates down to its JSON fallback
                for _f, fut in batch:
                    self._resolve(fut, (body, status))
                return
            try:
                frame = wirelib.decode_frame(body)
            except wirelib.WireError:
                # a NON-FRAME answer (e.g. a pre-wire relay's JSON
                # 'unknown relay op' 400): hand every caller the raw
                # body+status so each runs the solo path's JSON-parse /
                # negotiate-down logic — raising here would 502 the
                # whole batch and never trigger the fallback
                for _f, fut in batch:
                    self._resolve(fut, (body, status))
                return
            if not frame.is_multi or len(frame.subframes) != len(batch):
                # a frame, but not our batch — every caller gets the
                # typed 502 it would have gotten solo
                raise wirelib.WireError(
                    "coalesced response is not a %d-frame multi"
                    % len(batch)
                )
            for (_f, fut), sub in zip(batch, frame.subframes):
                # materialize each slot out of the shared buffer: the
                # response bytearray is one wire read, the slot copy is
                # what lets callers outlive it
                self._resolve(fut, (bytes(sub), status))
        except asyncio.CancelledError:
            # gateway shutdown cancelled the flush mid-call: every
            # waiter must fail FAST, not sit out its 20 s deadline
            self._fail_batch(batch, ConnectionError(
                "wire coalescer cancelled (gateway shutting down)"))
            raise
        except Exception as e:  # noqa: BLE001 - fan the failure out typed
            self._fail_batch(batch, e)
            # the exceptions ARE consumed (every caller awaits its
            # future) — but a caller that timed out already has a
            # cancelled future, and its slot's exception dies here
            return

    def shutdown(self) -> None:
        """Cancel in-flight flush/send tasks and fail everything still
        pending — callers get an immediate typed 503, not a 20 s hang."""
        for t in list(self._tasks):
            t.cancel()
        batch, self._pending = self._pending, []
        self._flush_task = None
        self._fail_batch(batch, ConnectionError(
            "wire coalescer closed (gateway shutting down)"))

    @staticmethod
    def _fail_batch(batch: list, exc: Exception) -> None:
        for _f, fut in batch:
            if not fut.done():
                fut.set_exception(exc)

    @staticmethod
    def _resolve(fut, result) -> None:
        if not fut.done():
            fut.set_result(result)


class DeploymentStore:
    """client-id -> deployment registry + token store — the reference's
    DeploymentStore + InMemoryClientDetailsService + Redis token store
    (api-frontend deployments/DeploymentStore.java:33-80)."""

    def __init__(self):
        self._by_key: Dict[str, _Registration] = {}
        self._tokens: Dict[str, Tuple[str, float]] = {}  # token -> (key, expiry)
        self._revision = 0

    def register(
        self,
        spec: SeldonDeploymentSpec,
        engines: Dict[str, object],
    ) -> None:
        """``engines``: predictor name -> EngineService (or URL)."""
        shadow = shadow_config_from_spec(spec)
        weighted = []
        for p in spec.predictors:
            if p.name in engines:
                # a shadow predictor never serves live traffic: weight 0
                # regardless of its replica count (replicas still size
                # its engines — it must absorb the mirrored fraction)
                weight = (
                    0 if shadow is not None and p.name == shadow.predictor
                    else max(int(p.replicas), 0)
                )
                weighted.append((p.name, weight, engines[p.name]))
        if not weighted:
            raise ValueError(f"no engines supplied for deployment {spec.name!r}")
        if shadow is not None and shadow.predictor not in (
            w[0] for w in weighted
        ):
            shadow = None  # annotated predictor has no engine: no mirror
        key = spec.oauth_key or spec.name
        self._by_key[key] = _Registration(
            deployment_id=spec.name,
            oauth_key=key,
            oauth_secret=spec.oauth_secret,
            engines=weighted,
            shadow=shadow,
        )
        self._revision += 1

    def set_weights(self, deployment_id: str,
                    weights: Dict[str, int]) -> None:
        """Reassign the live traffic split of one deployment in place —
        the rollout controller's single lever (operator/rollouts.py).
        Predictors absent from ``weights`` keep their weight; unknown
        predictor names are a typed error (a rollout must never silently
        shift 0% instead of 5%).  Bumps the revision so gateway caches
        notice."""
        reg = None
        for r in self._by_key.values():
            if r.deployment_id == deployment_id:
                reg = r
                break
        if reg is None:
            raise KeyError(f"deployment not registered: {deployment_id!r}")
        known = {name for name, _, _ in reg.engines}
        unknown = set(weights) - known
        if unknown:
            raise KeyError(
                f"unknown predictors for {deployment_id!r}: {sorted(unknown)}"
            )
        reg.engines = [
            (name, max(int(weights.get(name, w)), 0), engine)
            for name, w, engine in reg.engines
        ]
        self._revision += 1

    def weights(self, deployment_id: str) -> Dict[str, int]:
        """The live traffic split by predictor name — the read side of
        ``set_weights`` (a freshly elected coordinator's rollout
        controller resumes a predecessor's rollout from this instead of
        restarting at stage 0)."""
        for r in self._by_key.values():
            if r.deployment_id == deployment_id:
                return {name: w for name, w, _ in r.engines}
        raise KeyError(f"deployment not registered: {deployment_id!r}")

    def unregister(self, oauth_key: str) -> None:
        self._by_key.pop(oauth_key, None)
        self._tokens = {
            t: (k, exp) for t, (k, exp) in self._tokens.items() if k != oauth_key
        }
        self._revision += 1

    def revision(self) -> int:
        """Monotone registration-change counter: bumps on every register
        and unregister, including a re-registration of the SAME deployment
        (whose content may have changed) — the gateway's prune gate."""
        return self._revision

    # -- auth ---------------------------------------------------------------

    def issue_token(self, oauth_key: str, oauth_secret: str) -> str:
        reg = self._by_key.get(oauth_key)
        if reg is None or (reg.oauth_secret and reg.oauth_secret != oauth_secret):
            raise AuthError("invalid client credentials")
        if len(self._tokens) > 4096:
            # clients that fetch a fresh token per session would otherwise
            # grow the store without bound (expiry eviction is lazy)
            now = time.time()
            self._tokens = {
                t: (k, exp) for t, (k, exp) in self._tokens.items() if exp > now
            }
        token = secrets.token_urlsafe(24)
        self._tokens[token] = (oauth_key, time.time() + TOKEN_TTL_S)
        return token

    def principal_for_token(self, token: str) -> _Registration:
        entry = self._tokens.get(token)
        if entry is None:
            raise AuthError("invalid token")
        key, expiry = entry
        if time.time() > expiry:
            self._tokens.pop(token, None)
            raise AuthError("token expired")
        reg = self._by_key.get(key)
        if reg is None:
            raise AuthError("client no longer registered")
        return reg

    def deployments(self) -> List[str]:
        return [r.deployment_id for r in self._by_key.values()]

    def active_token_count(self) -> int:
        """Unexpired issued tokens (expiry eviction is lazy, so this
        counts live entries, not strictly valid ones)."""
        return len(self._tokens)


class ApiGateway:
    def __init__(
        self,
        store: Optional[DeploymentStore] = None,
        firehose: Optional[Firehose] = None,
        require_auth: bool = True,
        seed: int = 0,
    ):
        self.store = store or DeploymentStore()
        self.firehose = firehose
        self.require_auth = require_auth
        self.metrics = MetricsRegistry(deployment_name="gateway")
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._session = None  # lazy shared upstream client (remote engines)
        # replica sets built lazily per (deployment, predictor) from the
        # registration's engines entry; rebuilt when a re-registration
        # changes the endpoint list.  The scrape task feeds their passive
        # health off the engines' /stats surfaces.
        self._replica_sets: Dict[Tuple[str, str], Tuple[tuple, ReplicaSet]] = {}
        self._uds_clients: Dict[str, object] = {}
        # binary wire lane (runtime/wire.py): one coalescer per engine
        # socket (co-arriving predicts ride ONE multi-tensor relay
        # frame), plus the TCP endpoints that declined binary (a 4xx
        # non-frame answer) so we stop offering it to them
        self._wire_coalescers: Dict[str, "_WireCoalescer"] = {}
        self._wire_json_only: set = set()
        self._scrape_task: Optional[asyncio.Task] = None
        self._pruned_for = None  # store-change marker at last prune
        # feedback ingress accounting: engines may live in other
        # processes, so the gateway keeps its own view of the reward
        # stream it routed (surfaced in /stats; the process-global
        # seldon_tpu_feedback_* families are fed engine-side where
        # truth-vs-prediction agreement is computed)
        self.feedback_count = 0
        self.feedback_reward_sum = 0.0
        self.feedback_truth_count = 0
        # shadow mirroring (gateway/shadow.py): sampled fire-and-forget
        # duplication of live predicts to a weight-0 shadow predictor,
        # dispatched through the same pick/lane machinery live uses
        self.shadow = ShadowMirror(self._shadow_dispatch, seed=seed)
        # per-(deployment, predictor) live traffic accounting — the
        # canary observability the rollout controller gates stages on
        # (requests/errors since boot + rolling latency); bounded by the
        # registration table, not by traffic
        self._traffic: Dict[Tuple[str, str], dict] = {}
        #: optional RolloutController (operator/rollouts.py) — attach to
        #: serve its status on GET /rollouts
        self.rollouts = None
        #: optional GatewayFederation (gateway/federation.py) — attached
        #: by gateway_main when N replicas share a sqlite store.  Feeds
        #: engine-lease liveness into the balancer, gates singleton
        #: duties, and federates /fleet across peers.  None = this
        #: replica is its own coordinator (single-gateway behavior)
        self.federation = None
        # hedged-recovery budget (runtime/resilience.py RetryBudget,
        # Finagle semantics): every successful predict deposits a
        # fraction of a token, every hedged re-dispatch withdraws one —
        # a fleet-wide outage can't stampede 2x traffic onto survivors
        self._hedge_budget = RetryBudget()
        #: inflight work re-homed after a replica death, by kind —
        #: the gateway-local mirror of seldon_tpu_failover_total
        self.failovers: Dict[str, int] = {}
        # multi-tenant fair admission (runtime/qos.py): per-tenant token
        # buckets + weighted fair queueing over dispatch slots, LRU-
        # bounded accounting.  Inert with default knobs (no rate limit,
        # fair queue off) — today's behaviour bit-for-bit
        self.tenants = TenantGovernor()
        #: the coordinated-profiling manifest (gateway/fleet.py): the
        #: latest window's per-source artifact paths; None until the
        #: first POST /profile/start
        self._profile_manifest = None
        # the fair queue's backlog is an overload signal for the
        # brownout ladder; the firehose carries its typed transitions
        self._brownout_key = f"gateway:{id(self)}"
        # late-bound through a weakref: a swapped-in governor (tests,
        # demos) keeps feeding the signal, and the registry never pins
        # a gateway that was dropped without close()
        import weakref

        _ref = weakref.ref(self)
        BROWNOUT.register_depth(
            self._brownout_key,
            lambda: (lambda g: 0 if g is None
                     else g.tenants.queue_depth())(_ref()),
        )
        weakref.finalize(self, BROWNOUT.unregister_depth,
                         self._brownout_key)
        self._brownout_sink = None
        if firehose is not None and BROWNOUT.event_sink is None:
            self._brownout_sink = (
                lambda kind, **fields: firehose.publish_event(
                    "_gateway", kind, **fields)
            )
            BROWNOUT.event_sink = self._brownout_sink
            # released on close() (and by finalize if close is skipped)
            # so a later gateway's firehose can take over instead of
            # transitions publishing to a closed queue forever
            weakref.finalize(self, _release_brownout_sink,
                             self._brownout_sink)

    # -- principal resolution ----------------------------------------------

    def _resolve(self, token: Optional[str]) -> _Registration:
        if token:
            return self.store.principal_for_token(token)
        if self.require_auth:
            raise AuthError("missing bearer token")
        regs = list(self.store._by_key.values())
        if len(regs) != 1:
            raise AuthError("auth disabled but no unique deployment registered")
        return regs[0]

    def _replica_set(self, reg: _Registration, predictor_name: str,
                     engine) -> ReplicaSet:
        """The (cached) ReplicaSet behind one predictor's engines entry.
        The fingerprint catches re-registrations that changed the endpoint
        list — the set (and its learned EWMA state) is rebuilt only then."""
        targets = (
            list(engine) if isinstance(engine, (list, tuple)) else [engine]
        )
        # the fingerprint holds the TARGETS themselves: strings compare
        # by value (same-URL re-registration keeps learned EWMA state),
        # objects by identity — and the strong reference means a freed
        # engine's address can never be recycled into a false cache hit
        # (id() alone allowed exactly that)
        fp = tuple(targets)
        key = (reg.deployment_id, predictor_name)
        cached = self._replica_sets.get(key)
        if cached is None or cached[0] != fp:
            rs = ReplicaSet(
                targets,
                # deterministic per (seed, deployment, predictor): str
                # seeding is hash-randomization-proof
                rng=random.Random(
                    f"{self._seed}:{reg.deployment_id}:{predictor_name}"
                ),
                name=f"{reg.deployment_id}/{predictor_name}",
            )
            self._replica_sets[key] = (fp, rs)
            cached = (fp, rs)
        return cached[1]

    def _pick_engine(
        self, reg: _Registration, predictor: Optional[str] = None,
        eligible=None, rows: Optional[int] = None,
    ) -> Tuple[str, ReplicaSet, ReplicaEndpoint, Optional[PickDecision]]:
        """Two-level choice: replica-weighted predictor split (canary,
        unchanged), then power-of-two-choices over THAT predictor's
        replica endpoints (gateway/balancer.py).  ``decision`` is None on
        the pre-replica-set paths (single endpoint / kill switch).
        ``eligible`` narrows the p2c pool (ReplicaSet.pick) to endpoints
        the caller's lane can use.  ``rows`` makes each candidate's score
        shape-aware (autopilot cost-aware routing)."""
        entry = None
        if predictor is not None:
            for name, _, engine in reg.engines:
                if name == predictor:
                    entry = (name, engine)
                    break
        if entry is None:
            names = [e[0] for e in reg.engines]
            weights = np.asarray(
                [e[1] for e in reg.engines], dtype=np.float64
            )
            if weights.sum() <= 0:
                # degenerate all-zero split: serve uniformly — but never
                # from the shadow predictor (weight-0 BY DESIGN) unless
                # it is the only predictor there is
                weights = np.ones_like(weights)
                if reg.shadow is not None and len(names) > 1:
                    for i, n in enumerate(names):
                        if n == reg.shadow.predictor:
                            weights[i] = 0.0
                if weights.sum() <= 0:
                    weights = np.ones_like(weights)
            idx = int(self._rng.choice(len(names), p=weights / weights.sum()))
            entry = (reg.engines[idx][0], reg.engines[idx][2])
        name, engine = entry
        rs = self._replica_set(reg, name, engine)
        # phase-aware routing (runtime/servingmesh.py): decode-role
        # replicas only import KV handoffs from prefill peers — client
        # traffic routes prefill-first, never to a decode replica
        if eligible is None:
            elig = _not_decode
        else:
            def elig(ep, _e=eligible):
                return _not_decode(ep) and _e(ep)
        endpoint, decision = rs.pick(elig, rows=rows)
        self._ensure_scraper(rs)
        return name, rs, endpoint, decision

    @staticmethod
    def _request_rows(msg: SeldonMessage) -> Optional[int]:
        """Row count of a predict payload — the shape signal the
        autopilot-blended p2c score prices candidates with.  None (the
        shape-blind legacy score) for non-tensor payloads.  The shared
        rule (runtime/autopilot.py message_rows) so gateway buckets
        match interpreter branch buckets."""
        from seldon_core_tpu_torch.runtime.autopilot import message_rows

        return message_rows(msg)

    # -- data plane ---------------------------------------------------------

    @staticmethod
    def _replica_fault(resp: SeldonMessage) -> bool:
        """Did the REPLICA fail?  Only transport-shaped failures (bad
        gateway / unreachable / timeout) feed the balancer's failure
        degradation — an engine-side validation FAILURE for a malformed
        client payload says nothing about replica health, and blaming it
        would let one bad client cycle every healthy replica through the
        degraded state."""
        st = resp.status
        return (
            st is not None
            and st.status == "FAILURE"
            and (st.code or 0) in (502, 503, 504)
            # a predictive load shed (runtime/autopilot.py) is the engine
            # DECIDING, not the replica dying: blaming it would cycle
            # every correctly-shedding replica through fail-degradation
            # exactly under the tight-deadline bursts sheds exist for
            and not ApiGateway._is_autopilot_shed(resp)
        )

    @staticmethod
    def _is_autopilot_shed(resp: SeldonMessage) -> bool:
        """A predictive/policy shed — autopilot admission OR a brownout
        tier shed.  Both are the engine DECIDING, not dying: they count
        as load for routing but feed neither fail-degradation nor the
        latency EWMA."""
        from seldon_core_tpu_torch.runtime.autopilot import SHED_INFO_PREFIX

        st = resp.status
        if st is None or (st.code or 0) != 503:
            return False
        info = str(st.info or "")
        return (info.startswith(SHED_INFO_PREFIX)
                or info.startswith(BROWNOUT_INFO_PREFIX))

    @staticmethod
    def _decision_attrs(decision: Optional[PickDecision]) -> dict:
        """The routing decision as span attrs — chosen replica plus both
        candidates' scores, so a misprediction is auditable straight off
        the trace.  Empty on the pre-replica paths."""
        if decision is None:
            return {}
        return {
            "replica": decision.replica,
            "p2c_candidates": ",".join(decision.candidates),
            "p2c_scores": ",".join(str(s) for s in decision.scores),
        }

    async def predict(
        self, msg: SeldonMessage, token: Optional[str] = None
    ) -> SeldonMessage:
        from seldon_core_tpu_torch.utils.tracing import (
            TRACER,
            current_trace_context,
        )

        reg = self._resolve(token)
        # tenant identity (runtime/qos.py): the Seldon-Tenant header
        # (bound to the context by the HTTP lane), else the auth
        # principal, else "anon"; the tier header picks the lane
        tenant = resolve_tenant(
            current_tenant(), reg.oauth_key if token else None
        )
        tier = current_tier()
        with self.metrics.time_ingress("predictions", "POST") as code:
            BROWNOUT.maybe_tick()
            # fair admission FIRST: a hog's excess is refused before it
            # holds a queue slot, a deadline check, or a replica pick
            throttled = self.tenants.admit(tenant, tier)
            if throttled is not None:
                code["code"] = "429"
                return SeldonMessage.failure(
                    f"{THROTTLE_INFO_PREFIX}: tenant {tenant!r} over its "
                    f"{throttled} limit — retry later", code=429,
                )
            if BROWNOUT.sheds_tier(tier):
                # staged degradation: lower tiers answer a typed
                # retryable 503 while the ladder is engaged
                RECORDER.record_brownout_shed(tier)
                self.tenants.note_shed(tenant)
                code["code"] = "503"
                return SeldonMessage.failure(
                    f"{BROWNOUT_INFO_PREFIX}: {tier!r} tier shed at "
                    f"brownout stage {BROWNOUT.stage()} — retry later",
                    code=503,
                )
            # a request that arrives with its deadline already spent is
            # the CALLER's failure — answer before picking so it can't
            # feed any replica's failure degradation
            rem = remaining_s()
            if rem is not None and rem <= 0:
                code["code"] = "504"
                return SeldonMessage.failure(
                    "request deadline exhausted at gateway", code=504
                )
            # a hop clamped BELOW its normal timeout by the caller's
            # budget can fail because the budget was too small, not
            # because the replica is sick — such failures are accounted
            # neutrally (inflight released, no EWMA, no failure streak)
            # or one impatient client would cycle every healthy replica
            # through fail-degradation
            blameable = rem is None or rem >= 20.0
            rows = self._request_rows(msg)
            # the fair-queue slot covers pick + dispatch: a freed slot
            # always goes to the pending request with the smallest
            # virtual tag, so a hog's backlog cannot starve a
            # well-behaved tenant's next request (inert when
            # SELDON_TPU_GW_FAIR_INFLIGHT is unset)
            async with self.tenants.slot(tenant):
                predictor_name, rs, endpoint, decision = self._pick_engine(
                    reg, rows=rows
                )
                # the ingress span roots the request tree (or joins the
                # caller's trace when it sent a traceparent); the engine
                # hop — in-process, UDS or HTTP — becomes its child
                track = replicas_enabled()
                if track:
                    endpoint.begin()
                t0 = time.perf_counter()
                ok = False
                raised = True
                shed = False
                pm_trace_id = ""
                try:
                    with TRACER.span(
                        msg.meta.puid, "gateway", kind="request",
                        method="predict", deployment=reg.deployment_id,
                        predictor=predictor_name,
                        tenant=tenant, tier=tier,
                        **self._decision_attrs(decision),
                    ), qos_scope(tenant, tier):
                        # the RESOLVED identity (principal fallback
                        # included) binds the dispatch scope, so the
                        # remote lanes forward what the gateway resolved
                        # — the raw header is absent exactly for
                        # authenticated callers
                        resp = await self._dispatch_predict(endpoint, msg)
                        # verdict stamped while the ingress span is still
                        # OPEN: the postmortem retention policy judges the
                        # root span at fold time, and a replica fault or
                        # policy shed travels as a healthy-looking 200
                        # envelope the span would otherwise never show
                        shed = self._is_autopilot_shed(resp)
                        ok = not self._replica_fault(resp)
                        _ctx = current_trace_context()
                        if _ctx is not None:
                            pm_trace_id = _ctx.trace_id
                        if shed:
                            TRACER.annotate(shed=True, status=503)
                        elif not ok:
                            TRACER.annotate(
                                status=503, error="replica_fault")
                    raised = False
                finally:
                    if track:
                        if raised:
                            # the dispatch never returned — client hung up
                            # (CancelledError) or a gateway-side bug,
                            # neither of which says anything about REPLICA
                            # health: account neutrally or three impatient
                            # clients fail-degrade a healthy replica (real
                            # transport failures return a typed 503, they
                            # don't raise)
                            endpoint.release(batcher=True)
                        elif shed:
                            # predictive/policy shed: neutral accounting —
                            # not a failure streak (the replica is
                            # deciding, not dying) and not a latency
                            # sample (a ~1 ms refusal fed into the EWMA
                            # would make the shedding replica look FAST
                            # and herd more traffic onto it)
                            endpoint.release(batcher=True)
                        elif ok or blameable:
                            rs.complete(endpoint, decision,
                                        time.perf_counter() - t0, ok=ok,
                                        rows=rows)
                        else:
                            endpoint.release(batcher=True)
                if not raised:
                    if ok and not shed:
                        # fund the hedge budget off real successes so a
                        # fleet-wide outage can't stampede retries
                        self._hedge_budget.deposit()
                    elif not ok:
                        # the replica failed transport-style (dead
                        # process, lapsed lease, timeout): re-dispatch
                        # the idempotent predict ONCE to a peer replica
                        failed_resp = resp
                        resp = await self._maybe_hedge(
                            rs, endpoint, msg, rows, resp)
                        shed = self._is_autopilot_shed(resp)
                        if pm_trace_id:
                            # out-of-band: the ingress span already
                            # closed, so the hedge verdict joins the
                            # pending trace as a note and re-triggers
                            # the postmortem keep/drop decision
                            try:
                                from seldon_core_tpu_torch.utils.postmortem \
                                    import POSTMORTEM
                                POSTMORTEM.note(
                                    pm_trace_id, "failover",
                                    lane="unary",
                                    recovered=(
                                        resp is not failed_resp
                                        and not
                                        self._replica_fault(resp)),
                                )
                            except Exception:  # noqa: BLE001
                                pass
            # record which predictor served (canary observability; feedback
            # routes back to the same predictor)
            resp.meta.requestPath.setdefault("predictor", predictor_name)
            live_error = (
                resp.status is not None and resp.status.status == "FAILURE"
            )
            if live_error:
                code["code"] = str(resp.status.code or 500)
            live_latency_s = time.perf_counter() - t0
            self._note_traffic(
                reg.deployment_id, predictor_name, live_latency_s, live_error
            )
            # per-tenant accounting: the governor's /stats row and the
            # quality observatory's per-tenant SLO ring (GET /quality).
            # An engine-side policy shed (autopilot/brownout 503) is
            # flow control, not a tenant error — same rule as the
            # global SLO feed (utils/metrics.py) — or a brownout would
            # latch the per-tenant burn at the cap during exactly the
            # event this view exists to attribute
            tenant_error = live_error and not shed
            self.tenants.note_result(tenant, live_latency_s, tenant_error)
            self._note_tenant_slo(tenant, live_latency_s, tenant_error)
            # shadow mirroring rides AFTER the live answer exists — one
            # RNG draw for the unsampled path, one create_task for the
            # sampled one; the mirror dispatch/diff never touches this
            # request's latency (gateway/shadow.py invariants)
            self.shadow.maybe_mirror(
                reg, predictor_name, msg, resp, live_latency_s
            )
        if self.firehose is not None:
            self.firehose.publish(reg.deployment_id, msg, resp,
                                  tenant=tenant, tier=tier)
        return resp

    async def _maybe_hedge(self, rs: ReplicaSet, failed: ReplicaEndpoint,
                           msg: SeldonMessage, rows: Optional[int],
                           resp: SeldonMessage) -> SeldonMessage:
        """Hedged recovery after a transport-shaped replica failure: one
        re-dispatch of the (idempotent) predict to a peer replica.

        Guard rails, in order: the federation kill switch (the hedge is
        part of the mesh-recovery layer — ``SELDON_TPU_FEDERATION=0``
        restores fail-to-caller bit-for-bit), idempotency (predict is in
        the resilience layer's IDEMPOTENT_METHODS — the dead engine may
        have half-executed it), a live peer to hedge to, remaining
        deadline, and the Finagle-style retry budget (funded by
        successes, so a fleet-wide outage degrades to the original
        failure instead of doubling traffic on survivors).  Returns the
        peer's response when it is not itself a replica fault, else the
        original failure."""
        from seldon_core_tpu_torch.gateway.federation import federation_enabled

        if (
            not federation_enabled()
            or not replicas_enabled()
            or "predict" not in IDEMPOTENT_METHODS
            or len(rs) < 2
        ):
            return resp
        rem = remaining_s()
        if rem is not None and rem <= 0.05:
            return resp
        if not self._hedge_budget.withdraw():
            RECORDER.record_retry_budget_exhausted()
            return resp
        endpoint, decision = rs.pick(
            lambda ep, _f=failed: _not_decode(ep) and ep is not _f,
            rows=rows,
        )
        if endpoint is failed:
            # pick() falls back to the full pool when the filter empties
            # it — no live peer, nothing to hedge to
            return resp
        endpoint.begin()
        t0 = time.perf_counter()
        ok = False
        raised = True
        shed = False
        try:
            resp2 = await self._dispatch_predict(endpoint, msg)
            shed = self._is_autopilot_shed(resp2)
            ok = not self._replica_fault(resp2)
            raised = False
        finally:
            if raised or shed:
                endpoint.release(batcher=True)
            else:
                rs.complete(endpoint, decision,
                            time.perf_counter() - t0, ok=ok, rows=rows)
        if not ok:
            return resp  # peer no better: surface the ORIGINAL failure
        if not shed:
            self.failovers["unary"] = self.failovers.get("unary", 0) + 1
            RECORDER.record_failover("unary")
        return resp2

    @staticmethod
    def _note_tenant_slo(tenant: str, latency_s: float,
                         error: bool) -> None:
        from seldon_core_tpu_torch.utils.quality import QUALITY

        QUALITY.record_tenant_request(tenant, latency_s, error=error)

    def _note_traffic(self, deployment: str, predictor: str,
                      latency_s: float, error: bool) -> None:
        key = (deployment, predictor)
        entry = self._traffic.get(key)
        if entry is None:
            entry = self._traffic[key] = {
                "count": 0, "errors": 0, "latency_ms": Reservoir(1024),
            }
        entry["count"] += 1
        if error:
            entry["errors"] += 1
        entry["latency_ms"].observe(latency_s * 1e3)

    def predictor_traffic(self, deployment: str,
                          predictor: str) -> Tuple[int, int]:
        """(requests, errors) served so far for one predictor — the
        error-rate signal the rollout controller diffs per stage."""
        entry = self._traffic.get((deployment, predictor))
        if entry is None:
            return (0, 0)
        return (entry["count"], entry["errors"])

    async def _shadow_dispatch(self, reg, predictor: str,
                               msg: SeldonMessage) -> SeldonMessage:
        """One mirrored hop to the shadow predictor, through the real
        replica-set pick + lane machinery.  Inflight-only accounting
        (release, not complete): mirrored traffic must keep the shadow
        set's load visible without letting mirror latencies feed routing
        EWMAs or failure streaks — the shadow predictor is under test,
        not under management."""
        _name, _rs, endpoint, _decision = self._pick_engine(reg, predictor)
        track = replicas_enabled()
        if track:
            endpoint.begin(batcher=False)
        try:
            return await self._dispatch_predict(endpoint, msg)
        finally:
            if track:
                endpoint.release()

    async def send_feedback(
        self, feedback: Feedback, token: Optional[str] = None
    ) -> SeldonMessage:
        from seldon_core_tpu_torch.utils.tracing import TRACER

        reg = self._resolve(token)
        with self.metrics.time_ingress("feedback", "POST"):
            predictor = None
            if feedback.response is not None:
                predictor = feedback.response.meta.requestPath.get("predictor")
            fb_puid = feedback.puid()
            _, rs, endpoint, decision = self._pick_engine(reg, predictor)
            self.feedback_count += 1
            self.feedback_reward_sum += float(feedback.reward)
            if feedback.truth is not None:
                self.feedback_truth_count += 1
            # inflight-only accounting (release, not complete): a
            # feedback ack is a ~1 ms bookkeeping hop — folding it into
            # the EWMA that routes PREDICT traffic would drag a replica
            # with a steady feedback stream toward "fastest" regardless
            # of its real predict latency (same argument as streams)
            track = replicas_enabled()
            if track:
                endpoint.begin(batcher=False)
            try:
                with TRACER.span(
                    fb_puid, "gateway", kind="request", method="feedback",
                    deployment=reg.deployment_id,
                    **self._decision_attrs(decision),
                ):
                    return await self._dispatch_feedback(endpoint, feedback)
            finally:
                if track:
                    endpoint.release()

    def _uds_client(self, path: str):
        """Pooled relay client per socket path (runtime/udsrelay.py)."""
        client = self._uds_clients.get(path)
        if client is None or client.closed:
            from seldon_core_tpu_torch.runtime.udsrelay import UdsRelayClient

            client = UdsRelayClient(path)
            self._uds_clients[path] = client
            # a re-dialed client is a NEW peer process: invalidate the
            # coalescer bound to the old one AND forget a stale json-only
            # negotiation — an engine restarted wire-enabled must not
            # stay pinned to the slow lane for the gateway's lifetime
            self._wire_coalescers.pop(path, None)
            self._wire_json_only.discard(path)
        return client

    def _wire_coalescer(self, path: str) -> _WireCoalescer:
        from seldon_core_tpu_torch.runtime import wire as wirelib

        client = self._uds_client(path)
        co = self._wire_coalescers.get(path)
        window, max_n = wirelib.coalesce_window_s(), wirelib.coalesce_max()
        if (co is None or co.client is not client
                or co.window_s != window or co.max_n != max_n):
            co = _WireCoalescer(client, window, max_n)
            self._wire_coalescers[path] = co
        return co

    def _lane_for(self, endpoint: ReplicaEndpoint) -> str:
        if hasattr(endpoint.target, "predict"):
            return "inprocess"
        if endpoint.uds_path is not None and uds_enabled():
            return "uds"
        return "tcp"

    async def _dispatch(
        self, endpoint: ReplicaEndpoint, obj, method: str, relay_op: int,
        path: str,
    ) -> SeldonMessage:
        """One gateway->engine hop over whichever lane the endpoint
        advertises: in-process call, framed UDS relay, or HTTP POST.
        ``obj`` is the SeldonMessage/Feedback, ``method`` its in-process
        method name, ``relay_op``/``path`` the lane-specific addresses."""
        from seldon_core_tpu_torch.runtime import wire as wirelib

        lane = self._lane_for(endpoint)
        RECORDER.record_lane_request(lane)
        if lane == "inprocess":
            return await getattr(endpoint.target, method)(obj)
        # the binary tensor lane (runtime/wire.py) carries unary predicts
        # with a numeric payload — no JSON composition, no JSON parse on
        # either side; feedback and non-tensor payloads stay on JSON
        wire_ok = (
            method == "predict"
            and wirelib.wire_enabled()
            and wirelib.frame_eligible(obj)
        )
        if lane == "uds":
            if wire_ok and endpoint.uds_path not in self._wire_json_only:
                return await self._wire_uds_call(endpoint.uds_path, obj)
            return await self._uds_call(
                endpoint.uds_path, relay_op, obj.to_json()
            )
        if endpoint.base_url is None:
            return SeldonMessage.failure(
                "endpoint has no TCP url and the UDS lane is disabled "
                "(SELDON_TPU_UDS=0)", code=503,
            )
        if wire_ok and endpoint.base_url not in self._wire_json_only:
            return await self._wire_http_post(endpoint.base_url, path, obj)
        return await self._http_post(
            endpoint.base_url + path, obj.to_json()
        )

    async def _dispatch_predict(
        self, endpoint: ReplicaEndpoint, msg: SeldonMessage
    ) -> SeldonMessage:
        return await self._dispatch(
            endpoint, msg, "predict", OP_PREDICT, "/api/v0.1/predictions"
        )

    async def _dispatch_feedback(
        self, endpoint: ReplicaEndpoint, fb: Feedback
    ) -> SeldonMessage:
        return await self._dispatch(
            endpoint, fb, "send_feedback", OP_FEEDBACK, "/api/v0.1/feedback"
        )

    async def _uds_call(self, path: str, op: int, payload: str) -> SeldonMessage:
        """One zero-copy relay round trip; transport failures surface the
        same 503 shape the TCP lane produces, and the caller's remaining
        deadline budget clamps the hop the same way _http_post's does (a
        wedged engine fails at the deadline, not never).  The request
        frame now carries the metadata sidecar (udsrelay.py
        current_relay_meta): deadline, traceparent and tenant/tier reach
        the engine like they do on the HTTP lane, so engine-side clamps,
        joined spans and tenant accounting survive the relay hop.  The
        gateway-side clamp stays as the backstop."""
        from seldon_core_tpu_torch.runtime.udsrelay import current_relay_meta

        total = 20.0
        rem = remaining_s()
        if rem is not None:
            if rem <= 0:
                return SeldonMessage.failure(
                    "request deadline exhausted at gateway", code=504
                )
            total = min(total, rem)
        try:
            body, _status = await asyncio.wait_for(
                self._uds_client(path).call(
                    op, payload.encode(), meta=current_relay_meta()
                ),
                timeout=total,
            )
            return SeldonMessage.from_json(body.decode("utf-8", "replace"))
        except asyncio.TimeoutError:
            return SeldonMessage.failure(
                f"engine timeout after {total:.1f}s on uds relay", code=504
            )
        except (ConnectionError, OSError) as e:
            return SeldonMessage.failure(
                f"engine unreachable: {e}", code=503
            )
        except SeldonMessageError as e:
            return SeldonMessage.failure(
                f"engine error: bad relay response: {e}", code=502
            )

    async def _wire_uds_call(self, path: str,
                             msg: SeldonMessage) -> SeldonMessage:
        """One binary predict over the framed relay — the zero-JSON hop.
        The request frame's sidecar carries puid/deadline/traceparent/
        tenant/tier (the relay-meta semantics, wire-native); co-arriving
        calls for the same socket coalesce into one multi-tensor frame
        and de-coalesce by slot, verified against the echoed puid.  The
        gateway-side deadline clamp stays as the backstop, exactly like
        ``_uds_call``."""
        from seldon_core_tpu_torch.messages import new_puid
        from seldon_core_tpu_torch.runtime import wire as wirelib

        total = 20.0
        rem = remaining_s()
        if rem is not None:
            if rem <= 0:
                return SeldonMessage.failure(
                    "request deadline exhausted at gateway", code=504
                )
            total = min(total, rem)
        if not msg.meta.puid:
            # the echo the de-coalescer is verified against
            msg.meta.puid = new_puid()
        frame = wirelib.join_parts(
            wirelib.frame_from_message(msg, sidecar=True))
        RECORDER.record_wire_request("dispatch-uds", "binary")
        try:
            body, _status = await asyncio.wait_for(
                self._wire_coalescer(path).call(frame), timeout=total,
            )
        except asyncio.TimeoutError:
            return SeldonMessage.failure(
                f"engine timeout after {total:.1f}s on uds relay", code=504
            )
        except (ConnectionError, OSError) as e:
            return SeldonMessage.failure(
                f"engine unreachable: {e}", code=503
            )
        except wirelib.WireError as e:
            return SeldonMessage.failure(
                f"engine error: bad wire response: {e}", code=502
            )
        if _status == 415:
            # the peer doesn't speak OP_WIRE (kill-switched engine):
            # negotiate down PERMANENTLY for this socket and serve the
            # request over JSON
            self._wire_json_only.add(path)
            return await self._uds_call(path, OP_PREDICT, msg.to_json())
        try:
            resp = wirelib.message_from_frame(wirelib.decode_frame(body))
        except wirelib.WireError:
            # not a frame: a relay-writer-level failure body is JSON
            try:
                parsed = SeldonMessage.from_json(
                    body.decode("utf-8", "replace"))
            except SeldonMessageError as e:
                return SeldonMessage.failure(
                    f"engine error: bad wire response: {e}", code=502
                )
            if (
                parsed.status is not None
                and "unknown relay op" in (parsed.status.info or "")
            ):
                # a PRE-WIRE engine build: its relay answers op 6 with
                # the unknown-op 400 — same negotiate-down as 415, or a
                # rolling upgrade would fail every predict to it forever
                self._wire_json_only.add(path)
                return await self._uds_call(
                    path, OP_PREDICT, msg.to_json())
            return parsed
        if resp.meta.puid and resp.meta.puid != msg.meta.puid:
            return SeldonMessage.failure(
                "coalesced wire response puid mismatch (got "
                f"{resp.meta.puid!r})", code=502,
            )
        return resp

    async def _wire_http_post(self, base_url: str, path: str,
                              msg: SeldonMessage) -> SeldonMessage:
        """Binary predict over the TCP lane: same pooled client and
        deadline clamp as ``_http_post``, body = one wire frame instead
        of JSON.  A peer that answers 4xx with a non-frame body doesn't
        speak the contract — it is remembered as json-only and this call
        (and every later one) rides the JSON path."""
        from seldon_core_tpu_torch.runtime import wire as wirelib

        session = self._get_session()
        total = 20.0
        headers = {"Content-Type": wirelib.WIRE_CONTENT_TYPE}
        rem = remaining_s()
        if rem is not None:
            if rem <= 0:
                return SeldonMessage.failure(
                    "request deadline exhausted at gateway", code=504
                )
            total = min(total, rem)
            headers[DEADLINE_HEADER] = deadline_header_value()
        RECORDER.record_wire_request("dispatch-tcp", "binary")
        frame = wirelib.join_parts(
            wirelib.frame_from_message(msg, sidecar=True))
        try:
            r = await session.post(base_url + path, frame, headers,
                                   timeout=total)
            if r.ctype == wirelib.WIRE_CONTENT_TYPE:
                return wirelib.message_from_frame(
                    wirelib.decode_frame(r.body))
            if r.status in (400, 404, 405, 415, 501):
                # the peer declined the contract (older build or
                # kill-switched): negotiate down PERMANENTLY and
                # serve this request over JSON
                self._wire_json_only.add(base_url)
                return await self._http_post(
                    base_url + path, msg.to_json())
            return SeldonMessage.from_json(r.text())
        except UpstreamConnectError:
            # connection establishment failed before any bytes moved:
            # delegate to the JSON lane, which owns the connect-retry
            # choreography (3 attempts) — no double-apply risk
            return await self._http_post(base_url + path, msg.to_json())
        except (wirelib.WireError, SeldonMessageError) as e:
            return SeldonMessage.failure(
                f"engine error: bad wire response: {e}", code=502
            )
        except (OSError, asyncio.TimeoutError) as e:
            return SeldonMessage.failure(f"engine error: {e!r}", code=503)

    def _get_session(self) -> HttpClient:
        """The gateway's one pooled upstream client
        (``runtime/client.py`` ``HttpClient``); timeouts are PER REQUEST,
        so unary calls and long-lived SSE relays never share a deadline.
        ``SELDON_TPU_GW_POOL`` caps concurrent upstream connections
        (default 100) and ``SELDON_TPU_GW_KEEPALIVE_S`` holds idle
        keep-alives (default 15 s)."""
        if self._session is None or self._session.closed:
            self._session = HttpClient()
        return self._session

    def _ensure_scraper(self, rs: ReplicaSet) -> None:
        """Start the passive-health scrape loop once a URL-backed multi-
        replica set exists (in-process sets read health directly; solo
        sets have nothing to balance)."""
        if (
            self._scrape_task is not None
            or not replicas_enabled()
            or len(rs) < 2
            or not any(ep.base_url for ep in rs.endpoints)
        ):
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tests): scores run on local state only
        self._scrape_task = loop.create_task(self._scrape_loop())

    def _prune_stale_sets(self) -> list:
        """Drop replica sets (and return the relay clients) of
        deployments no longer registered — without this an unregister
        leaves the cached set alive forever: in-process EngineServices
        pinned by the fingerprint's strong refs, URL sets perpetually
        scraped, relay connections pooled to sockets nothing routes to.

        Gated on the store actually changing: the full pass re-reads
        every registration (one query + JSON parse each on the sqlite
        store), which is pure waste on the every-2s scrape tick and every
        /stats poll of a stable topology.  The gate reads the store's
        revision counter — a re-registration of the SAME deployment (a
        predictor dropped, a uds path moved) bumps it, where a
        deployment-ID diff would miss the change and leave the stale set
        scraped forever.  Stores without a revision() fall back to the
        ID diff (they can at least prune on add/remove)."""
        rev = getattr(self.store, "revision", None)
        marker = (
            ("rev", rev()) if callable(rev)
            else ("ids", tuple(sorted(self.store.deployments())))
        )
        if marker == self._pruned_for:
            return []
        self._pruned_for = marker
        live_pairs = set()
        live_uds = set()
        for reg in list(self.store._by_key.values()):
            if reg is None:
                continue
            for name, _w, engine in reg.engines:
                live_pairs.add((reg.deployment_id, name))
                targets = (
                    engine if isinstance(engine, (list, tuple))
                    else [engine]
                )
                for t in targets:
                    if isinstance(t, str):
                        _base, uds = parse_endpoint_spec(t)
                        if uds:
                            live_uds.add(uds)
        for key in list(self._replica_sets):
            if key not in live_pairs:
                del self._replica_sets[key]
        for key in list(self._traffic):
            if key not in live_pairs:
                del self._traffic[key]
        self.shadow.prune({dep for dep, _ in live_pairs})
        stale_clients = [
            c for p, c in self._uds_clients.items() if p not in live_uds
        ]
        self._uds_clients = {
            p: c for p, c in self._uds_clients.items() if p in live_uds
        }
        return stale_clients

    async def _scrape_loop(self) -> None:
        interval = scrape_interval_s()
        while True:
            try:
                for client in self._prune_stale_sets():
                    await client.close()
                # engine-lease liveness rides the same tick: a lapsed
                # lease marks a replica dead within one TTL instead of
                # waiting out three failed scrapes (gateway/federation.py)
                leases = (
                    self.federation.engine_leases()
                    if self.federation is not None else None
                )
                for _fp, rs in list(self._replica_sets.values()):
                    if leases is not None:
                        rs.apply_leases(leases)
                    if len(rs) > 1:
                        await rs.scrape_once(self._get_session())
                # fleet outlier gauges refresh off the docs the pass
                # just stashed — zero extra polling (gateway/fleet.py)
                from seldon_core_tpu_torch.gateway.fleet import (
                    refresh_outlier_gauges,
                )

                refresh_outlier_gauges(self)
            except Exception:
                # a malformed /stats body (proxy interposing, engine
                # mid-deploy) must not kill the loop: the task is never
                # restarted, so an escape here would freeze every
                # replica's health at its last value for the gateway's
                # lifetime
                pass
            await asyncio.sleep(interval)

    async def _http_post(self, url: str, payload: str) -> SeldonMessage:
        # one pooled client per gateway + 3 attempts, mirroring apife's
        # pooling client with HttpRetryHandler (InternalPredictionService.
        # java:60-72, HttpRetryHandler.java:34-45).  Retries fire only on
        # connection-establishment failures — once bytes may have reached the
        # engine, re-POSTing could double-apply feedback training
        session = self._get_session()
        last = "unreachable"
        for _ in range(3):
            # deadline propagation (runtime/resilience.py): recomputed per
            # attempt — the caller's REMAINING budget clamps this hop's
            # timeout and rides to the engine as milliseconds
            total = 20.0
            headers = {"Content-Type": "application/json"}
            rem = remaining_s()
            if rem is not None:
                if rem <= 0:
                    return SeldonMessage.failure(
                        "request deadline exhausted at gateway", code=504
                    )
                total = min(total, rem)
                headers[DEADLINE_HEADER] = deadline_header_value()
            # trace context rides to the remote engine alongside the
            # deadline, so its spans join the gateway's tree
            from seldon_core_tpu_torch.utils.tracing import (
                TRACEPARENT_HEADER,
                traceparent_header_value,
            )

            tp = traceparent_header_value()
            if tp is not None:
                headers[TRACEPARENT_HEADER] = tp
            # tenant/tier ride to the remote engine so its admission
            # (brownout tier sheds, genserver lanes) and its spans see
            # the same identity the gateway resolved
            from seldon_core_tpu_torch.runtime.qos import (
                TENANT_HEADER,
                TIER_HEADER,
                TIER_INTERACTIVE,
            )

            tenant = current_tenant()
            if tenant:
                headers[TENANT_HEADER] = tenant
            tier = current_tier()
            if tier != TIER_INTERACTIVE:
                headers[TIER_HEADER] = tier
            try:
                r = await session.post(url, payload.encode(), headers,
                                       timeout=total)
                return SeldonMessage.from_json(r.text())
            except UpstreamConnectError as e:
                last = str(e)
                await asyncio.sleep(0.05)
            except (OSError, asyncio.TimeoutError) as e:
                return SeldonMessage.failure(f"engine error: {e!r}", code=503)
        return SeldonMessage.failure(f"engine unreachable: {last}", code=503)

    def stats(self) -> dict:
        """Zero-dependency JSON snapshot for ``GET /stats`` — ingress
        latency percentiles, routing table, firehose backpressure, and the
        process-level flight-recorder telemetry (engines sharing this
        process report their batcher/generation internals here too)."""
        return {
            "gateway": {
                "require_auth": self.require_auth,
                "deployments": self.store.deployments(),
                "active_tokens": self.store.active_token_count(),
            },
            # per-predictor replica sets: endpoints, gateway-side
            # inflight/EWMA, picks, passive health, mispicks, imbalance.
            # Pruned here as well as in the scrape loop — gateways whose
            # sets are all in-process/uds-only never start the scraper,
            # and an unregistered deployment must not pin its engines
            "replicas": self._stats_replicas(),
            # per-predictor live traffic + the shadow mirror's compact
            # health block (full divergence table on GET /shadow) + the
            # attached rollout controller's state when one is wired
            "traffic": {
                f"{dep}/{pred}": {
                    "count": e["count"],
                    "errors": e["errors"],
                    "latency_ms": e["latency_ms"].snapshot(),
                }
                for (dep, pred), e in sorted(self._traffic.items())
            },
            "shadow": self.shadow.snapshot(),
            # per-tenant admission accounting (runtime/qos.py): bounded
            # rows (LRU past 256 tenants), token-bucket refusals, fair-
            # queue depth — plus the brownout ladder's stage/transitions
            "tenants": self.tenants.snapshot(),
            "brownout": BROWNOUT.snapshot(),
            "rollouts": (
                None if self.rollouts is None else self.rollouts.snapshot()
            ),
            # coordinator election + re-homed-work accounting: which
            # replica owns singleton duties, the fencing token, live
            # peers, and how much inflight work this replica recovered
            "federation": {
                **(
                    {} if self.federation is None
                    else self.federation.snapshot()
                ),
                "failovers": dict(self.failovers),
            },
            "feedback": {
                "count": self.feedback_count,
                "mean_reward": round(
                    self.feedback_reward_sum / self.feedback_count, 6
                ) if self.feedback_count else 0.0,
                "truth_provided": self.feedback_truth_count,
            },
            "firehose": (
                None if self.firehose is None else self.firehose.snapshot()
            ),
            "telemetry": RECORDER.snapshot(),
        }

    def _stats_replicas(self) -> dict:
        stale = self._prune_stale_sets()
        if stale:
            try:
                loop = asyncio.get_running_loop()
                for client in stale:
                    loop.create_task(client.close())
            except RuntimeError:
                pass  # sync caller: connections close with the gateway
        return {
            f"{dep}/{pred}": rs.snapshot()
            for (dep, pred), (_fp, rs) in sorted(
                self._replica_sets.items()
            )
        }

    async def close(self) -> None:
        BROWNOUT.unregister_depth(self._brownout_key)
        _release_brownout_sink(self._brownout_sink)
        if self.federation is not None:
            # hand the coordinator lease over NOW — the surviving
            # replicas must not wait out the TTL on a graceful exit
            self.federation.resign()
        self.shadow.cancel_all()
        if self._scrape_task is not None:
            self._scrape_task.cancel()
            self._scrape_task = None
        for co in self._wire_coalescers.values():
            co.shutdown()
        self._wire_coalescers = {}
        for client in self._uds_clients.values():
            await client.close()
        self._uds_clients = {}
        if self._session is not None and not self._session.closed:
            await self._session.close()


# ---------------------------------------------------------------------------
# HTTP routes
# ---------------------------------------------------------------------------

_JSON = "application/json"
_SSE_PATH = "/api/v0.1/generate/stream"


def _json_result(doc, status: int = 200):
    return status, json.dumps(doc).encode(), _JSON


def _msg_result(msg: SeldonMessage, status: int = 200):
    return status, msg.to_json().encode(), _JSON


def _error_result(info: str, code: int = 400):
    return _msg_result(SeldonMessage.failure(info, code=code), status=code)


def _sse_error(e) -> bytes:
    """The in-band terminal event of a stream that broke after its 200."""
    return b'data: {"done": true, "error": %s}\n\n' % json.dumps(str(e)).encode()


class GatewayRoutes:
    """The gateway's route table on the port's ``FastHttpServer``
    (``runtime/rest.py``): the 21 routes of the JAX package's
    ``make_gateway_app`` under the same paths, methods, status codes and
    documents.  A mutation route answers a GET with 405."""

    def __init__(self, gateway: "ApiGateway"):
        self.gateway = gateway
        self.post = {
            b"/oauth/token": self._token,
            b"/api/v0.1/predictions": self._predictions,
            b"/api/v0.1/feedback": self._feedback,
            _SSE_PATH.encode(): self._generate_stream,
            b"/profile/start": self._profile_start,
            b"/profile/stop": self._profile_stop,
        }
        self.post_only = frozenset(self.post)
        self.get = {
            b"/ping": self._ping,
            b"/ready": self._ready,
            b"/prometheus": self._prometheus,
            b"/stats": self._stats,
            b"/shadow": self._shadow,
            b"/rollouts": self._rollouts,
            b"/quality": self._quality,
            b"/overhead": self._overhead,
            b"/trace": self._trace,
            b"/trace/export": self._trace_export,
            b"/fleet": self._fleet,
            b"/corpus": self._corpus,
            b"/costs": self._costs,
            b"/postmortems": self._postmortems,
            b"/profile": self._profile_get,
        }

    @staticmethod
    def _bearer() -> Optional[str]:
        auth = _request_header(b"authorization:", exact=True) or ""
        if auth.startswith("Bearer "):
            return auth[len("Bearer "):]
        return None

    @staticmethod
    def _query(name: str, default: str = "") -> str:
        return _request_query().get(name, [default])[0]

    async def _token(self, body, ctype):
        auth = _request_header(b"authorization:", exact=True) or ""
        key = secret = None
        if auth.startswith("Basic "):
            try:
                decoded = base64.b64decode(auth[len("Basic "):]).decode()
                key, _, secret = decoded.partition(":")
            except Exception:
                pass
        if key is None:
            form = parse_qs(body.decode("utf-8", "replace"), keep_blank_values=True)
            key = form.get("client_id", [None])[0]
            secret = form.get("client_secret", [""])[0]
        try:
            tok = self.gateway.store.issue_token(key or "", secret or "")
        except AuthError as e:
            return _json_result({"error": str(e)}, status=401)
        return _json_result(
            {"access_token": tok, "token_type": "bearer", "expires_in": int(TOKEN_TTL_S)})

    async def _predictions(self, body, ctype):
        from seldon_core_tpu_torch.runtime import wire as wirelib
        from seldon_core_tpu_torch.utils.costledger import LEDGER, costledger_enabled

        if ctype.split(";", 1)[0].strip() == wirelib.WIRE_CONTENT_TYPE:
            return await self._predictions_wire(body)
        try:
            msg = SeldonMessage.from_json(_payload_text(body, ctype))
        except SeldonMessageError as e:
            return _error_result(str(e))
        RECORDER.record_wire_request("ingress", "json")
        if costledger_enabled():
            # tenant-attributed ingress bytes; deployment is unresolved
            # this early, so gateway rows key on the lane alone
            LEDGER.note_bytes(_request_header(b"seldon-tenant:", exact=True) or "", "",
                              "gateway_json", len(body))
        # the request's deadline, traceparent and tenant/tier headers are
        # bound to this handler's context by the HTTP lane
        try:
            resp = await self.gateway.predict(msg, self._bearer())
        except AuthError as e:
            return _error_result(str(e), code=401)
        status = 200 if resp.status is None or resp.status.status == "SUCCESS" else (
            resp.status.code or 500)
        return _msg_result(resp, status=status)

    async def _predictions_wire(self, body):
        """Binary tensor ingress: the client's frame parses into the routing
        layer with one view; the frame's sidecar carries deadline, trace and
        tenant/tier (the HTTP headers are the fallback); the answer is a
        frame of the engine's response tensor."""
        from seldon_core_tpu_torch.runtime import wire as wirelib
        from seldon_core_tpu_torch.utils.costledger import LEDGER, costledger_enabled
        from seldon_core_tpu_torch.utils.tracing import parse_traceparent, trace_scope

        if not wirelib.wire_enabled():
            return _error_result("binary wire lane disabled (SELDON_TPU_WIRE=0)", code=415)
        RECORDER.record_wire_request("ingress", "binary")
        wirelib.account_copy(len(body))
        try:
            frame = wirelib.decode_frame(body)
            if frame.is_multi:
                raise wirelib.WireError(
                    "multi frames are a gateway->engine contract; ingress takes single frames")
            msg = wirelib.message_from_frame(frame)
        except wirelib.WireError as e:
            return _error_result(str(e), code=e.http_code)
        smeta = frame.meta
        if costledger_enabled():
            LEDGER.note_bytes(smeta.get("tenant")
                              or _request_header(b"seldon-tenant:", exact=True) or "",
                              "", "gateway_wire", len(body))
        # the sidecar's deadline, trace and tenant/tier; the HTTP headers,
        # bound by the lane, stay the fallback
        scopes = contextlib.ExitStack()
        if smeta.get("traceparent"):
            scopes.enter_context(trace_scope(parse_traceparent(smeta["traceparent"])))
        if smeta.get("deadline_ms"):
            scopes.enter_context(maybe_deadline_scope(smeta["deadline_ms"] / 1e3))
        if smeta.get("tenant") or smeta.get("tier"):
            scopes.enter_context(qos_scope(smeta.get("tenant") or current_tenant(),
                                           smeta.get("tier") or current_tier()))
        try:
            with scopes:
                resp = await self.gateway.predict(msg, self._bearer())
        except AuthError as e:
            return _error_result(str(e), code=401)
        status = 200 if resp.status is None or resp.status.status == "SUCCESS" else (
            resp.status.code or 500)
        if resp.data is not None and not wirelib.frame_eligible(resp):
            # a non-tensor answer can't frame: degrade to JSON
            return _msg_result(resp, status=status)
        parts = wirelib.frame_from_message(resp, response=True, sidecar=False)
        return status, wirelib.join_parts(parts), wirelib.WIRE_CONTENT_TYPE

    async def _feedback(self, body, ctype):
        try:
            fb = Feedback.from_json(_payload_text(body, ctype))
        except SeldonMessageError as e:
            return _error_result(str(e))
        try:
            ack = await self.gateway.send_feedback(fb, self._bearer())
        except AuthError as e:
            return _error_result(str(e), code=401)
        return _msg_result(ack)

    async def _generate_stream(self, body, ctype):
        """SSE token streaming through the ingress: auth + canary pick,
        then the engine's event stream — an in-process engine's streamed
        from its generator (the first chunk primed before the 200, so an
        admission shed answers a typed 503), a remote engine's relayed
        chunk for chunk, and with federation on re-homed to a peer replica
        mid-generation (the peer re-prefills prompt + tokens so far)."""
        from seldon_core_tpu_torch.runtime.qos import (
            TENANT_HEADER,
            TIER_HEADER,
            bind_qos,
            parse_tier,
        )

        gateway = self.gateway
        payload = _payload_text(body, ctype)
        bearer = self._bearer()
        try:
            reg = gateway._resolve(bearer)
        except AuthError as e:
            return _error_result(str(e), code=401)
        # QoS admission for streams: the tenant bucket and the brownout tier
        # shed of unary predicts (the fair queue governs unary slots only)
        tenant = resolve_tenant(
            _request_header(b"seldon-tenant:", exact=True), reg.oauth_key if bearer else None)
        tier = parse_tier(_request_header(b"seldon-tier:"))
        BROWNOUT.maybe_tick()
        throttled = gateway.tenants.admit(tenant, tier)
        if throttled is not None:
            return _error_result(
                f"{THROTTLE_INFO_PREFIX}: tenant {tenant!r} over its "
                f"{throttled} limit — retry later", code=429)
        if BROWNOUT.sheds_tier(tier):
            RECORDER.record_brownout_shed(tier)
            gateway.tenants.note_shed(tenant)
            return _error_result(
                f"{BROWNOUT_INFO_PREFIX}: {tier!r} tier stream shed at "
                f"brownout stage {BROWNOUT.stage()}", code=503)
        # bound in this handler's own context: the engine's stream request
        # takes the identity at admission
        bind_qos(tenant, tier)

        def _streamable(ep):
            return hasattr(ep.target, "generate_stream") or ep.base_url is not None

        # streams stay on TCP (the relay lane is unary-only); the replica
        # pick still applies, narrowed to endpoints that can stream
        _, rs, endpoint, _decision = gateway._pick_engine(reg, eligible=_streamable)
        if not _streamable(endpoint):
            capable = [ep for ep in rs.endpoints if _streamable(ep)]
            if not capable:
                return _error_result(
                    "streaming requires a TCP endpoint (every replica is uds-only)", code=503)
            now = time.monotonic()
            endpoint = min(capable, key=lambda ep: ep.score(now, rs.stale_after_s))
        # a live stream counts as load while it runs, with no EWMA sample
        track = replicas_enabled()
        if track:
            endpoint.begin(batcher=False)
        # the endpoint the stream holds: a re-home moves it
        holder = [endpoint]
        try:
            if hasattr(endpoint.target, "generate_stream"):
                result = await self._stream_inprocess(endpoint.target, payload)
            else:
                headers = {"Content-Type": _JSON, TENANT_HEADER: tenant, TIER_HEADER: tier}
                result = await self._stream_remote(reg, rs, holder, payload, headers,
                                                   _streamable, track)
        except BaseException:
            if track:
                holder[0].release()
            raise
        if not isinstance(result, StreamResult):
            if track:
                holder[0].release()
            return result
        if not track:
            return result
        inner = result.agen

        async def released():
            try:
                async for item in inner:
                    yield item
            finally:
                await inner.aclose()
                holder[0].release()

        return StreamResult(result.status, result.ctype, released(), raw=True)

    async def _stream_inprocess(self, engine, payload: str):
        """An in-process engine's stream, driven by one task in this
        request's context (the engine's scopes open and close in it); the
        first chunk is read before the 200."""
        try:
            request = engine.prepare_stream_request(payload)
        except SeldonMessageError as e:
            return _error_result(str(e))
        events: asyncio.Queue = asyncio.Queue(maxsize=4)
        end = object()

        async def pump():
            agen = engine.generate_stream(request)
            try:
                async for event in agen:
                    await events.put(event)
                await events.put(end)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - handed to the reader
                await events.put(e)
            finally:
                await agen.aclose()

        task = asyncio.get_running_loop().create_task(pump())
        first = await events.get()
        if isinstance(first, SeldonMessageError):
            # an admission shed (or a refusal) before any token: a typed
            # status, not an in-band frame on a 200
            await task
            return _error_result(str(first), code=first.http_code)
        if isinstance(first, Exception):
            await task
            raise first

        async def frames():
            item = first
            try:
                while item is not end:
                    if isinstance(item, Exception):
                        # mid-stream: the in-band terminal event
                        yield _sse_error(item)
                        return
                    yield b"data: " + item.encode() + b"\n\n"
                    item = await events.get()
            finally:
                if not task.done():
                    task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass

        return StreamResult(200, "text/event-stream", frames(), raw=True)

    async def _stream_remote(self, reg, rs, holder: list, payload: str, headers: dict,
                             streamable, track: bool):
        """Relay a remote engine's SSE stream.  With federation on, the
        events are parsed as they pass (each row's tokens so far) so a
        mid-stream engine death re-homes the stream to a peer replica,
        which re-prefills prompt + emitted tokens with the token budget
        cut by what was served."""
        from seldon_core_tpu_torch.gateway.federation import federation_enabled

        gateway = self.gateway
        session = gateway._get_session()
        endpoint = holder[0]
        url = str(endpoint.base_url) + _SSE_PATH
        prompt = doc0 = max_new0 = None
        if federation_enabled():
            try:
                doc0 = json.loads(payload)
                prompt = np.asarray(SeldonMessage.from_json(payload).data.array,
                                    dtype=np.float64)
                if prompt.ndim < 2:
                    prompt = prompt.reshape(1, -1)
                if isinstance(doc0, dict) and doc0.get("max_new") is not None:
                    max_new0 = int(doc0["max_new"])
            except Exception:
                prompt = None  # unparseable payload: no resume, plain proxy
        if prompt is None:
            # resume unavailable (kill switch / non-tensor payload): the
            # raw byte relay
            try:
                up = await session.stream(url, payload.encode(), headers, connect_timeout=20.0)
            except (OSError, asyncio.TimeoutError) as e:
                return _error_result(f"engine unreachable: {e!r}", code=503)
            if up.status != 200:
                try:
                    text = (await up.read()).decode("utf-8", "replace")
                finally:
                    up.close()
                return _error_result(text, code=up.status)

            async def proxy():
                try:
                    async for chunk in up.chunks():
                        yield chunk
                except (OSError, asyncio.TimeoutError) as e:
                    # upstream broke mid-stream: the terminal error event
                    yield _sse_error(e)
                finally:
                    up.close()

            return StreamResult(200, "text/event-stream", proxy(), raw=True)

        emitted: list = []  # [B, <=chunk] arrays, in emit order
        state = {"endpoint": endpoint, "url": url, "body": payload, "attempts": 0,
                 "done": False}
        failed_eps: list = []

        def note_event(event: bytes) -> None:
            _, _, data = event.partition(b"data:")
            try:
                obj = json.loads(data)
            except ValueError:
                return
            if not isinstance(obj, dict):
                return
            if obj.get("done"):
                state["done"] = True
                return
            toks = obj.get("tokens")
            if toks:
                emitted.append(np.asarray(toks, dtype=np.float64))

        def resume_payload() -> str:
            doc = dict(doc0) if isinstance(doc0, dict) else {}
            new_prompt = np.concatenate([prompt] + emitted, axis=1) if emitted else prompt
            doc["data"] = {"ndarray": new_prompt.tolist()}
            if max_new0 is not None:
                served = sum(a.shape[1] for a in emitted)
                doc["max_new"] = max(max_new0 - served, 1)
            return json.dumps(doc)

        def stream_peer(exclude):
            capable = [ep for ep in rs.endpoints
                       if ep not in exclude and ep.base_url is not None
                       and streamable(ep) and _not_decode(ep)]
            if not capable:
                return None
            now = time.monotonic()
            return min(capable, key=lambda ep: ep.score(now, rs.stale_after_s))

        def rehome(e) -> bool:
            state["attempts"] += 1
            peer = None
            if state["attempts"] <= 2:
                failed_eps.append(state["endpoint"])
                peer = stream_peer(failed_eps)
            if peer is None:
                return False
            # the load accounting moves with the stream
            if track:
                state["endpoint"].release()
                peer.begin(batcher=False)
            state["endpoint"] = holder[0] = peer
            state["url"] = str(peer.base_url) + _SSE_PATH
            state["body"] = resume_payload()
            gateway.failovers["stream"] = gateway.failovers.get("stream", 0) + 1
            RECORDER.record_failover("stream")
            try:
                from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

                POSTMORTEM.note("", "rehome", lane="stream", deployment=reg.deployment_id,
                                attempts=state["attempts"], error=str(e)[:200])
            except Exception:  # noqa: BLE001
                pass
            return True

        async def connect(prepared: bool):
            """(upstream, None) on a 200; (None, an error result) when
            the first attempt's answer is the client's; (None, the
            exception) when no peer is left."""
            while True:
                try:
                    up = await session.stream(state["url"], state["body"].encode(), headers,
                                              connect_timeout=20.0)
                except (OSError, asyncio.TimeoutError) as e:
                    err = e
                else:
                    if up.status == 200:
                        return up, None
                    try:
                        text = (await up.read()).decode("utf-8", "replace")
                    except (OSError, asyncio.TimeoutError):
                        text = ""
                    finally:
                        up.close()
                    if not prepared and state["attempts"] == 0:
                        return None, _error_result(text, code=up.status)
                    err = RuntimeError(f"upstream answered {up.status}")
                if not rehome(err):
                    if not prepared:
                        return None, _error_result(f"engine unreachable: {err!r}", code=503)
                    return None, err

        up, err = await connect(prepared=False)
        if up is None:
            return err

        async def relay():
            nonlocal up
            while True:
                buf = b""
                try:
                    try:
                        async for chunk in up.chunks():
                            buf += chunk
                            # forward COMPLETE events only: a half-event
                            # from a dying engine must not reach the client
                            # (the resumed peer re-emits those tokens)
                            while b"\n\n" in buf:
                                event, _, buf = buf.partition(b"\n\n")
                                note_event(event)
                                yield event + b"\n\n"
                    finally:
                        up.close()
                    if not state["done"]:
                        raise RuntimeError("upstream ended without a terminal event")
                    return
                except (OSError, asyncio.TimeoutError, RuntimeError) as e:
                    if state["done"]:
                        return  # the stream had already finished cleanly
                    if not rehome(e):
                        yield _sse_error(e)
                        return
                    up, err = await connect(prepared=True)
                    if up is None:
                        yield _sse_error(err)
                        return

        return StreamResult(200, "text/event-stream", relay(), raw=True)

    async def _ping(self, body, ctype):
        return 200, b"pong", "text/plain"

    async def _ready(self, body, ctype):
        # readiness = a registered routing table, regardless of auth mode
        if self.gateway.store.deployments():
            return 200, b"ready", "text/plain"
        return 503, b"no deployments registered", "text/plain"

    async def _prometheus(self, body, ctype):
        return 200, self.gateway.metrics.exposition(), CONTENT_TYPE_LATEST

    async def _stats(self, body, ctype):
        return _json_result(self.gateway.stats())

    async def _shadow(self, body, ctype):
        return _json_result(self.gateway.shadow.document())

    async def _rollouts(self, body, ctype):
        # present when a rollout controller is attached to this gateway
        if self.gateway.rollouts is None:
            return _json_result({"error": "no rollout controller attached"}, status=404)
        return _json_result(self.gateway.rollouts.document())

    async def _quality(self, body, ctype):
        from seldon_core_tpu_torch.utils.quality import QUALITY

        return _json_result(QUALITY.document())

    async def _overhead(self, body, ctype):
        return _json_result({"gateway": {"deployments": self.gateway.store.deployments()},
                             **SPINE.overhead_document()})

    async def _trace(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import federated_trace_document

        return _json_result(await federated_trace_document(
            self.gateway, trace_id=self._query("trace_id"), puid=self._query("puid"),
            limit=int(self._query("limit", "100") or 100)))

    async def _trace_export(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import federated_export_document

        return _json_result(await federated_export_document(
            self.gateway, trace_id=self._query("trace_id"), puid=self._query("puid"),
            limit=int(self._query("limit", "1000") or 1000)))

    async def _fleet(self, body, ctype):
        # with federation live the view fans out to every sibling gateway
        # replica too (?local=1 stops the recursion)
        from seldon_core_tpu_torch.gateway.fleet import fleet_document

        gateway = self.gateway
        doc = await fleet_document(gateway)
        fed = gateway.federation
        if fed is not None and fed.enabled and self._query("local") != "1":
            doc["replica_id"] = fed.replica_id
            peer_docs = {}
            for rid, url in fed.peers():
                try:
                    r = await gateway._get_session().get(
                        url.rstrip("/") + "/fleet?local=1", timeout=2.0)
                    peer_docs[rid] = r.json()
                except Exception as e:  # noqa: BLE001 - a dead peer is data
                    peer_docs[rid] = {"error": f"{type(e).__name__}: {e}"}
            if peer_docs:
                doc["gateway_peers"] = peer_docs
        return _json_result(doc)

    async def _corpus(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import corpus_document

        return _json_result(await corpus_document(self.gateway))

    async def _costs(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import costs_document

        return _json_result(await costs_document(self.gateway))

    async def _postmortems(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import postmortems_document

        return _json_result(await postmortems_document(self.gateway,
                                                       puid=self._query("puid")))

    async def _profile_start(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import profile_start

        try:
            doc = json.loads(body.decode("utf-8", "replace") or "{}")
        except ValueError:
            doc = {}
        if not isinstance(doc, dict):
            doc = {}
        status, manifest = await profile_start(
            self.gateway, deployment=doc.get("deployment"), duration_s=doc.get("duration_s"))
        return _json_result(manifest, status=status)

    async def _profile_stop(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import profile_stop

        status, manifest = await profile_stop(self.gateway)
        return _json_result(manifest, status=status)

    async def _profile_get(self, body, ctype):
        from seldon_core_tpu_torch.gateway.fleet import profile_status

        return _json_result(profile_status(self.gateway))


async def serve_gateway(gateway: "ApiGateway", host: str, port: int) -> FastHttpServer:
    """The gateway's routes on ``host:port`` (0 picks a free port:
    ``server.port``).  ``await server.stop()`` then ``await gateway.close()``
    shut it down."""
    server = FastHttpServer(routes=GatewayRoutes(gateway))
    await server.start(host, port)
    return server
