"""Host-mode graph interpreter — the port's counterpart of
``seldon_core_tpu/graph/interpreter.py``.

Async recursive evaluation of the inference graph with the reference
engine's semantics (engine PredictiveUnitBean.java:58-168):

    transform_input -> route (-1 = broadcast) -> children concurrently
        -> aggregate -> transform_output

with each router's branch recorded into ``meta.routing``, tags merged
across nodes (later writers win), and the feedback pass replaying
``meta.routing`` so only the branch that served a request trains.

This is the host path: any node may be an in-process unit
(``InProcessNodeRuntime``) or a remote microservice (a ``NodeRuntime`` of
``runtime/client.py``), and a COMBINER's ``quorum`` or a ROUTER's
``fallback`` absorbs a failed branch.  With partial fusion on, each
maximal fusible subtree runs as one ``graph.fuse.FusedSubtreeRuntime``.
A graph whose every node is in-process and pure is served by
``CompiledGraph`` or ``FusedGraph`` instead.

Units are fed ``msg.array()`` narrowed as the JAX package's
``jnp.asarray`` narrows with 64-bit mode off (float64 to float32, int64
to int32), as tensors on the executor's device; a unit's output stays a
device tensor from hop to hop until a serialization edge reads it back.
Given a thread pool, each in-process call runs there, under inference
mode and the runtime's own lock, so a blocking unit (a kernel's readback,
a user object) never holds the event loop and two requests never race on
one unit's state.  Each node method runs in a tracer span of the node's
name (``method`` the unit method, ``fused`` for a fused subtree's one
dispatch), children of the request's span, so the fan-out's branches,
a ``quorum``'s and a ``fallback``'s appear as sibling subtrees; a
fallback that served and a quorum that dropped branches add a span event
(``fallback``, ``quorum_degraded``) and count in
``seldon_tpu_degraded_requests_total``, and an expired deadline at a hop
in ``seldon_tpu_deadline_exceeded_total``.  Quality (``interpreter.py:188``,
``:215-225`` there): every unit method's tags pass ``_respond``, where the
outlier scores bridge into the quality observatory, and each in-process
``predict`` writes one telemetry-spine quality record of the node's own
input and output (device tensors; the drainer summarizes them), so the
drift table of a host-mode engine or a unit pod resolves to the node that
drifted.  The autopilot (``interpreter.py:441-536`` there): a router's
branch predicted to overrun the request's deadline is demoted to the
fastest branch predicted to fit (``_autopilot_branch``), and each served
branch learns the wall of its children's dispatch for the request's pad
bucket (its children answer host messages, so that wall is whole).

The helpers shared with the compiled executors live here too: the
method-dispatch table (engine PredictorConfigBean.java:33-82), tag
conversion, the per-unit random generators and the input narrowing.
"""

from __future__ import annotations

import asyncio
import threading
import time
import warnings
import zlib
from concurrent.futures import Executor
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device
from seldon_core_tpu_torch.graph.spec import (
    GraphSpecError,
    PredictiveUnit,
    PredictorSpec,
    UnitImplementation,
    UnitMethod,
    UnitType,
    params_to_kwargs,
)
from seldon_core_tpu_torch.graph.units import UNIT_REGISTRY, Unit, normalize_output
from seldon_core_tpu_torch.messages import (
    DeadlineExceededError,
    Feedback,
    Meta,
    SeldonMessage,
    SeldonMessageError,
    Status,
)
from seldon_core_tpu_torch.runtime.autopilot import (
    AUTOPILOT,
    autopilot_enabled,
    branch_key,
    message_rows,
    shed_margin,
)
from seldon_core_tpu_torch.runtime.resilience import current_deadline
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.quality import QUALITY
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import TRACER

__all__ = [
    "NodeRuntime",
    "InProcessNodeRuntime",
    "GraphExecutor",
    "effective_type",
    "methods_for",
    "pythonize_tags",
    "unit_rngs",
    "as_input",
    "to_device",
]


def unit_rngs(names: Iterable[str], seed: Optional[int] = None) -> Dict[str, torch.Generator]:
    """One CPU ``torch.Generator`` per unit, seeded from the graph seed and
    the crc32 of the unit's NAME (the JAX package folds the same crc32 into
    its key), so a unit's state never depends on which other units share
    its graph.  torch and ``jax.random`` draw different numbers from the
    same seed: carry weights across with ``convert.params_from_jax`` where
    the two must agree."""
    base = 0 if seed is None else int(seed)
    out = {}
    for name in names:
        g = torch.Generator(device="cpu")
        g.manual_seed(((base & 0xFFFFFFFF) << 32) | zlib.crc32(name.encode()))
        out[name] = g
    return out


_TYPE_METHODS = {
    UnitType.MODEL: [UnitMethod.TRANSFORM_INPUT],
    UnitType.ROUTER: [UnitMethod.ROUTE, UnitMethod.SEND_FEEDBACK],
    UnitType.COMBINER: [UnitMethod.AGGREGATE],
    UnitType.TRANSFORMER: [UnitMethod.TRANSFORM_INPUT],
    UnitType.OUTPUT_TRANSFORMER: [UnitMethod.TRANSFORM_OUTPUT],
}

_IMPL_TYPES = {
    UnitImplementation.SIMPLE_MODEL: UnitType.MODEL,
    UnitImplementation.SIMPLE_ROUTER: UnitType.ROUTER,
    UnitImplementation.RANDOM_ABTEST: UnitType.ROUTER,
    UnitImplementation.AVERAGE_COMBINER: UnitType.COMBINER,
}


def effective_type(node: PredictiveUnit) -> Optional[UnitType]:
    if node.type is not None:
        return node.type
    return _IMPL_TYPES.get(node.implementation)


def methods_for(node: PredictiveUnit) -> List[UnitMethod]:
    """Explicit ``methods`` win; otherwise the type's default set."""
    if node.methods is not None:
        return list(node.methods)
    return list(_TYPE_METHODS.get(effective_type(node), []))


def pythonize_tags(tags: Dict[str, Any]) -> Dict[str, Any]:
    """Tag values (tensors on any device, numpy, scalars) -> JSON-safe
    python values."""
    out: Dict[str, Any] = {}
    for k, v in (tags or {}).items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        out[k] = a.item() if a.ndim == 0 else a.tolist()
    return out


def to_device(state, device: torch.device):
    """A unit state (tensor, dict of states, or anything else) on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {k: to_device(v, device) for k, v in state.items()}
    return state


def as_input(X, device: torch.device) -> torch.Tensor:
    """Rows (numpy or a tensor) -> a tensor on the device.  float64 from the
    JSON codec becomes float32 and int64 int32, as ``jnp.asarray`` does with
    64-bit mode off in the JAX package.  A read-only array (a binary frame's
    view over its request bytes) is never written through: on the CPU it
    is copied, on a card the tensor over it lives only until its
    host-to-device copy (synchronous from pageable memory) has read it."""
    if not isinstance(X, torch.Tensor):
        X = np.ascontiguousarray(X)
        if not X.flags.writeable:
            if device.type == "cpu":
                X = X.copy()
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)  # "not writable"
                    view = torch.from_numpy(X)
                return as_input(view.to(device), device)
        X = torch.from_numpy(X)
    if X.dtype == torch.float64:
        X = X.float()
    elif X.dtype == torch.int64:
        X = X.int()
    return X.to(device)


def _payload(msg: SeldonMessage):
    """A message's payload as it is held (a device tensor stays one), or a
    SeldonMessageError when it has none."""
    if msg.data is None:
        raise SeldonMessageError("message has no DefaultData payload")
    a = msg.data.array
    return a if isinstance(a, torch.Tensor) else msg.array()


# ---------------------------------------------------------------------------
# Node runtimes
# ---------------------------------------------------------------------------


class NodeRuntime:
    """Transport-agnostic node interface: what the engine's
    ``InternalPredictionService`` is to the reference (engine
    InternalPredictionService.java:132-203)."""

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        raise NotImplementedError

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        raise NotImplementedError

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        raise NotImplementedError

    async def route(self, msg: SeldonMessage) -> int:
        raise NotImplementedError

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        raise NotImplementedError

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        raise NotImplementedError


class _Serialized:
    """Runs an object's calls one at a time under inference mode, on
    ``executor`` when one is given, inline on the loop otherwise."""

    def __init__(self, executor: Optional[Executor] = None):
        self.executor = executor
        self._lock = threading.Lock()

    async def _run(self, fn, *args):
        if self.executor is None:
            return self._locked(fn, *args)
        return await asyncio.get_running_loop().run_in_executor(
            self.executor, self._locked, fn, *args)

    def _locked(self, fn, *args):
        with self._lock, torch.inference_mode():
            return fn(*args)


class InProcessNodeRuntime(_Serialized, NodeRuntime):
    """A graph node backed by an in-process ``Unit``: holds the unit's state
    (on ``device``) and threads it through every call.  With ``executor``,
    each call runs on that thread pool; without one, inline on the loop."""

    def __init__(self, node: PredictiveUnit, unit: Unit, rng=None, device: DeviceLike = None,
                 executor: Optional[Executor] = None):
        super().__init__(executor)
        self.node = node
        self.unit = unit
        self.device = resolve_device(device)
        self.state = to_device(unit.init_state(rng), self.device)

    # -- helpers ------------------------------------------------------------

    def _respond(self, req: SeldonMessage, y, tags) -> SeldonMessage:
        resp = req.with_array(y, names=self.unit.class_names)
        all_tags = dict(self.unit.static_tags or {})
        all_tags.update(pythonize_tags(tags))
        # the outlier TRANSFORMER's scores bridge out of the tags here:
        # every unit method's tags pass this one spot
        QUALITY.record_outlier_tags(all_tags)
        if all_tags:
            resp.meta = Meta(puid=req.meta.puid, tags={**req.meta.tags, **all_tags},
                             routing=dict(req.meta.routing),
                             requestPath=dict(req.meta.requestPath))
        return resp

    def _input_array(self, msg: SeldonMessage) -> torch.Tensor:
        return as_input(_payload(msg), self.device)

    def _call(self, method: str, msg: SeldonMessage, X):
        """The unit's method; a unit with ``accepts_names`` (the user-object
        adapter) also gets the payload's feature names."""
        fn = getattr(self.unit, method)
        if getattr(self.unit, "accepts_names", False):
            return fn(self.state, X, msg.names())
        return fn(self.state, X)

    def _apply(self, method: str, msg: SeldonMessage) -> SeldonMessage:
        X = self._input_array(msg)
        out = self._call(method, msg, X)
        y, self.state, tags = normalize_output(out, self.state)
        if method == "predict" and QUALITY.enabled:
            # one quality record a sampled batch, keyed on this node
            SPINE.record_quality(self.node.name, X, y)
        return self._respond(msg, y, tags)

    def _route(self, msg: SeldonMessage) -> int:
        out = self._call("route", msg, self._input_array(msg))
        branch, self.state, _ = normalize_output(out, self.state)
        return int(branch)

    def _aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        arrays = [self._input_array(m) for m in msgs]
        shapes = {tuple(a.shape) for a in arrays}
        if len(shapes) != 1:
            # the reference's per-row shape check (AverageCombinerUnit.java:44-68)
            raise GraphSpecError(
                f"combiner {self.node.name!r}: child output shapes differ: {sorted(shapes)}")
        stacked = torch.stack(arrays, dim=0)
        if getattr(self.unit, "accepts_names", False):
            out = self.unit.aggregate(self.state, stacked, [m.names() for m in msgs])
        else:
            out = self.unit.aggregate(self.state, stacked)
        y, self.state, tags = normalize_output(out, self.state)
        return self._respond(msgs[0], y, tags)

    def _send_feedback(self, feedback: Feedback, branch: int) -> None:
        X, names, truth = None, [], None
        if feedback.request is not None and feedback.request.data is not None:
            X = self._input_array(feedback.request)
            names = feedback.request.names()
        if feedback.truth is not None and feedback.truth.data is not None:
            truth = self._input_array(feedback.truth)
        if getattr(self.unit, "accepts_names", False):
            new = self.unit.send_feedback(self.state, X, branch, feedback.reward, truth, names)
        else:
            new = self.unit.send_feedback(self.state, X, branch, feedback.reward, truth)
        self.state = new

    # -- NodeRuntime API ----------------------------------------------------

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._run(self._apply, "predict", msg)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._run(self._apply, "transform_input", msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._run(self._apply, "transform_output", msg)

    async def route(self, msg: SeldonMessage) -> int:
        return await self._run(self._route, msg)

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        return await self._run(self._aggregate, msgs)

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        await self._run(self._send_feedback, feedback, branch)


# ---------------------------------------------------------------------------
# Graph executor
# ---------------------------------------------------------------------------


def _impl_unit(node: PredictiveUnit) -> Optional[Unit]:
    """The unit of a hardcoded implementation (the engine's built-in beans)."""
    if node.implementation is UnitImplementation.UNKNOWN_IMPLEMENTATION:
        return None
    cls = UNIT_REGISTRY.get(node.implementation.value)
    if cls is None:
        raise GraphSpecError(f"no registered unit for {node.implementation.value}")
    return cls(**params_to_kwargs(node.parameters))


class GraphExecutor:
    """Builds each node's runtime from a PredictorSpec and executes the graph
    — the reference's PredictorBean + PredictiveUnitBean pair (engine
    PredictorBean.java:50-80, PredictiveUnitBean.java:58-168).

    ``extra_runtimes`` supplies node runtimes from outside (the engine's
    remote clients, a test's stand-ins); every other node must be a
    built-in or an in-process binding.  ``fuse=True`` (the engine's
    default) collapses each maximal fusible subtree into one
    ``FusedSubtreeRuntime``; a directly built executor stays the pure
    per-node interpreter.  ``rng`` is the graph seed of ``unit_rngs``."""

    def __init__(self, predictor: PredictorSpec,
                 extra_runtimes: Optional[Dict[str, NodeRuntime]] = None,
                 rng: Optional[int] = None, fuse: bool = False, device: DeviceLike = None,
                 executor: Optional[Executor] = None, tracer=None):
        self.predictor = predictor
        self.tracer = tracer if tracer is not None else TRACER
        self.device = resolve_device(device)
        self.runtimes: Dict[str, NodeRuntime] = {}
        self.fused: Dict[str, Any] = {}
        self.fusion_plan = None
        if fuse:
            from seldon_core_tpu_torch.graph.fuse import build_partial_fusion

            self.fused, self.fusion_plan = build_partial_fusion(
                predictor, skip=set(extra_runtimes or ()), rng=rng, device=self.device,
                executor=executor)
        covered = {u.name for frt in self.fused.values() for u in frt.root.walk()}
        comp_map = predictor.component_map()
        rngs = unit_rngs([u.name for u in predictor.graph.walk()], rng)
        for node in predictor.graph.walk():
            if node.name in covered:
                continue  # the fused subtree's runtime owns this node
            if extra_runtimes and node.name in extra_runtimes:
                self.runtimes[node.name] = extra_runtimes[node.name]
                continue
            unit = _impl_unit(node)
            if unit is None:
                binding = comp_map.get(node.name)
                if binding is None:
                    raise GraphSpecError(
                        f"node {node.name!r} has no implementation, binding, or runtime")
                if binding.runtime != "inprocess":
                    # remote clients come from the engine (runtime/client.py)
                    raise GraphSpecError(f"node {node.name!r} is remote ({binding.runtime}) "
                                         f"but no remote runtime was provided")
                from seldon_core_tpu_torch.graph.units import instantiate_bound_unit

                unit = instantiate_bound_unit(binding, node, device=self.device)
            self.runtimes[node.name] = InProcessNodeRuntime(
                node, unit, rngs[node.name], device=self.device, executor=executor)

    # -- predict path -------------------------------------------------------

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        out = await self._get_output(self.predictor.graph, msg)
        # the puid carries onto the final response (PredictionService.java:69-90)
        out.meta.puid = msg.meta.puid
        if out.status is None:
            out.status = Status()
        return out

    async def _get_output(self, node: PredictiveUnit, msg: SeldonMessage) -> SeldonMessage:
        # the request's budget is checked at every hop: an expired one fails
        # here instead of starting work its caller has given up on
        dl = current_deadline()
        if dl is not None and dl.expired:
            RECORDER.record_deadline_exceeded(f"node:{node.name}")
            raise DeadlineExceededError(f"request deadline exhausted before node {node.name!r}")
        frt = self.fused.get(node.name)
        if frt is not None:
            # one dispatch for the whole subtree
            with self.tracer.span(msg.meta.puid, node.name, method="fused"):
                return await frt.run(msg)

        methods = methods_for(node)
        rt = self.runtimes[node.name]
        tracer = self.tracer
        puid = msg.meta.puid
        # 1. transform input (a MODEL's predict, as InternalPredictionService's
        #    type switch, engine InternalPredictionService.java:132-161)
        if UnitMethod.TRANSFORM_INPUT in methods:
            if effective_type(node) is UnitType.MODEL:
                with tracer.span(puid, node.name, method="predict"):
                    msg = await rt.predict(msg)
            else:
                with tracer.span(puid, node.name, method="transform_input"):
                    msg = await rt.transform_input(msg)

        # 2. route + children (engine PredictiveUnitBean.java:91-112)
        if node.children:
            routed_branch: Optional[int] = None
            if UnitMethod.ROUTE in methods:
                with tracer.span(puid, node.name, method="route") as sp:
                    branch = await rt.route(msg)
                    if isinstance(sp, dict):
                        sp["branch"] = branch
                if branch >= len(node.children) or branch < -1:
                    # PredictiveUnitBean.java:244-250: -1 is broadcast, other
                    # negatives must never index a child from the end
                    raise GraphSpecError(f"router {node.name!r} chose branch {branch} but has "
                                         f"{len(node.children)} children")
                if branch != -1:
                    branch = self._autopilot_branch(node, msg, branch)
                msg.meta.routing[node.name] = branch
                routed_branch = branch
                selected = node.children if branch == -1 else [node.children[branch]]
            else:
                selected = node.children
            t_children = time.perf_counter()
            child_msgs = await self._dispatch_children(node, msg, selected, routed_branch,
                                                       methods)
            if routed_branch is not None and routed_branch != -1:
                # per-branch learning for the request's shape; a fallback
                # mid-dispatch updates meta.routing, so the branch that
                # served gets the sample
                AUTOPILOT.observe(
                    branch_key(node.name, msg.meta.routing.get(node.name, routed_branch),
                               message_rows(msg)),
                    time.perf_counter() - t_children)
            # 3. merge (engine PredictiveUnitBean.java:115-124)
            if UnitMethod.AGGREGATE in methods:
                merged_meta = msg.meta
                for cm in child_msgs:
                    merged_meta = merged_meta.merged_with(cm.meta)
                with tracer.span(puid, node.name, method="aggregate"):
                    out = await rt.aggregate(list(child_msgs))
                out.meta = merged_meta.merged_with(out.meta)
            else:
                if len(child_msgs) != 1:
                    raise GraphSpecError(
                        f"node {node.name!r} fanned out to {len(child_msgs)} children but has "
                        f"no AGGREGATE method to merge them")
                out = child_msgs[0]
                out.meta = msg.meta.merged_with(out.meta)
        else:
            out = msg

        # 4. transform output (engine PredictiveUnitBean.java:115-124)
        if UnitMethod.TRANSFORM_OUTPUT in methods:
            with tracer.span(puid, node.name, method="transform_output"):
                out = await rt.transform_output(out)
        return out

    def _autopilot_branch(self, node: PredictiveUnit, msg: SeldonMessage, branch: int) -> int:
        """Cost-aware routing: price the routed branch with its learned
        wall for this request's pad bucket.  When a deadline is in force
        and the prediction says the branch cannot answer within
        ``remaining * shed_margin()`` while another branch can, demote to
        the fastest predicted branch that fits: counted, marked by an
        ``autopilot_reroute`` span event and tagged
        ``seldon.autopilot.reroute.<router>`` in ``meta.tags``.  No
        deadline, no prediction or the kill switch off: the router's choice
        stands."""
        if not autopilot_enabled():
            return branch
        dl = current_deadline()
        if dl is None:
            return branch
        rows = message_rows(msg)
        pred = AUTOPILOT.predict_s(branch_key(node.name, branch, rows))
        rem = dl.remaining_s()
        margin = shed_margin()
        if pred is None or pred <= rem * margin:
            return branch
        best = None
        for b in range(len(node.children)):
            if b == branch:
                continue
            p = AUTOPILOT.predict_s(branch_key(node.name, b, rows))
            if p is not None and p <= rem * margin and (best is None or p < best[1]):
                best = (b, p)
        if best is None:
            return branch  # nothing predicted to fit: the pick rides
        RECORDER.record_autopilot_decision("route")
        self.tracer.event("autopilot_reroute", node=node.name, from_branch=int(branch),
                          to_branch=int(best[0]), predicted_ms=round(pred * 1e3, 3),
                          to_predicted_ms=round(best[1] * 1e3, 3),
                          remaining_ms=round(rem * 1e3, 3))
        msg.meta.tags[f"seldon.autopilot.reroute.{node.name}"] = int(best[0])
        return best[0]

    # -- graceful degradation -----------------------------------------------

    @staticmethod
    def _degradable(exc: BaseException) -> bool:
        """Failures a declared degradation policy may absorb: remote call
        errors, open breakers, an expired deadline or an attempt's timeout
        (``TimeoutError``, which ``asyncio.TimeoutError`` is since Python
        3.11, and an ``OSError`` itself), transport errors.  A
        GraphSpecError (misconfiguration) and anything unexpected always
        propagate: degrading over a bug would hide it."""
        if isinstance(exc, GraphSpecError):
            return False
        return isinstance(exc, (SeldonMessageError, TimeoutError, OSError))

    async def _dispatch_children(self, node: PredictiveUnit, msg: SeldonMessage,
                                 selected: List[PredictiveUnit], routed_branch: Optional[int],
                                 methods: List[UnitMethod]) -> List[SeldonMessage]:
        """Fan out to the selected children under the node's declared
        degradation policy (a COMBINER's ``quorum``, a ROUTER's ``fallback``)."""
        if node.quorum is not None and UnitMethod.AGGREGATE in methods and len(selected) > 1:
            return await self._gather_quorum(node, msg, selected)
        fallback = node.fallback
        if (fallback is not None and routed_branch is not None and routed_branch != -1
                and 0 <= fallback < len(node.children) and fallback != routed_branch):
            try:
                return [await self._get_output(selected[0], _fork_message(msg))]
            except BaseException as e:  # noqa: BLE001 - filtered below
                if not self._degradable(e):
                    raise
                # the routed branch failed (or its breaker is open): serve the
                # declared fallback.  The degradation is recorded only once
                # the fallback has served: a failed fallback fails the request
                fb_msg = _fork_message(msg)
                fb_msg.meta.routing[node.name] = fallback
                out = await self._get_output(node.children[fallback], fb_msg)
                RECORDER.record_degraded("fallback")
                self.tracer.event(
                    "fallback", node=node.name,
                    from_branch=routed_branch, to_branch=int(fallback),
                    reason=f"{type(e).__name__}: {str(e)[:120]}",
                )
                msg.meta.routing[node.name] = fallback
                msg.meta.tags[f"seldon.fallback.{node.name}"] = int(fallback)
                msg.meta.tags[f"seldon.fallback.{node.name}.reason"] = (
                    f"branch {routed_branch}: {type(e).__name__}: {str(e)[:160]}")
                return [out]
        return list(await asyncio.gather(
            *[self._get_output(c, _fork_message(msg)) for c in selected]))

    async def _gather_quorum(self, node: PredictiveUnit, msg: SeldonMessage,
                             selected: List[PredictiveUnit]) -> List[SeldonMessage]:
        """A COMBINER's quorum: aggregate over the children that answered
        when at least ``node.quorum`` did; the dropped branches are named in
        ``meta.tags['seldon.degraded.<node>']``.  Below quorum the first
        child failure propagates unchanged."""
        results = await asyncio.gather(
            *[self._get_output(c, _fork_message(msg)) for c in selected],
            return_exceptions=True)
        ok_msgs: List[SeldonMessage] = []
        dropped: List[str] = []
        first_err: Optional[BaseException] = None
        for child, res in zip(selected, results):
            if isinstance(res, BaseException):
                if not self._degradable(res):
                    raise res
                dropped.append(child.name)
                first_err = first_err or res
            elif res.data is None:
                # a payload-free answer would poison the aggregate: under a
                # declared quorum it is a failed branch
                dropped.append(child.name)
                first_err = first_err or SeldonMessageError(
                    f"combiner {node.name!r}: child {child.name!r} returned no tensor payload")
            else:
                ok_msgs.append(res)
        if len(ok_msgs) < int(node.quorum):
            raise first_err
        if dropped:
            RECORDER.record_degraded("quorum")
            msg.meta.tags[f"seldon.degraded.{node.name}"] = sorted(dropped)
            self.tracer.event("quorum_degraded", node=node.name, dropped=sorted(dropped))
        return ok_msgs

    # -- feedback path ------------------------------------------------------

    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        await self._send_feedback(self.predictor.graph, feedback)
        ack = SeldonMessage(status=Status())
        if feedback.response is not None:
            ack.meta.puid = feedback.response.meta.puid
        return ack

    async def _send_feedback(self, node: PredictiveUnit, feedback: Feedback) -> None:
        frt = self.fused.get(node.name)
        if frt is not None:
            # the whole fused subtree replays the routing on the device
            await frt.feedback(feedback)
            return
        methods = methods_for(node)
        rt = self.runtimes[node.name]
        routing = feedback.response.meta.routing if feedback.response is not None else {}
        try:
            branch = int(routing.get(node.name, -1))
        except (TypeError, ValueError):
            raise GraphSpecError(f"feedback routing {routing!r} is not a branch index") from None
        if UnitMethod.SEND_FEEDBACK in methods:
            await rt.send_feedback(feedback, branch)
        if not node.children:
            return
        if UnitMethod.ROUTE in methods:
            # replay the recorded route: only the serving branch trains
            # (engine PredictiveUnitBean.java:141-149)
            if branch >= len(node.children) or branch < -1:
                raise GraphSpecError(f"feedback routing for {node.name!r} names branch {branch} "
                                     f"but node has {len(node.children)} children")
            selected = node.children if branch == -1 else [node.children[branch]]
        else:
            selected = node.children
        await asyncio.gather(*[self._send_feedback(c, feedback) for c in selected])

    # -- state access -------------------------------------------------------

    def states(self) -> Dict[str, Any]:
        out = {name: rt.state for name, rt in self.runtimes.items()
               if isinstance(rt, InProcessNodeRuntime) and rt.state is not None}
        for frt in self.fused.values():
            out.update(frt.graph.states)
        return out

    def load_states(self, states: Dict[str, Any]) -> None:
        """Replace in-process unit states (moved to the device); names of
        remote nodes are ignored."""
        for name, st in states.items():
            rt = self.runtimes.get(name)
            if isinstance(rt, InProcessNodeRuntime):
                rt.state = to_device(st, rt.device)
        for frt in self.fused.values():
            for name in list(frt.graph.states):
                if name in states:
                    frt.graph.states[name] = to_device(states[name], frt.graph.device)


def _fork_message(msg: SeldonMessage) -> SeldonMessage:
    """A child call's own copy of the meta, so sibling branches cannot race
    on the shared dicts; the merge happens explicitly afterwards."""
    return SeldonMessage(
        data=msg.data, bin_data=msg.bin_data, str_data=msg.str_data,
        meta=Meta(puid=msg.meta.puid, tags=dict(msg.meta.tags), routing=dict(msg.meta.routing),
                  requestPath=dict(msg.meta.requestPath)),
        status=msg.status)
