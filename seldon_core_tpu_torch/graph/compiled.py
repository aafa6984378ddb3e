"""Compiled-graph executor — the port's counterpart of
``seldon_core_tpu/graph/compiled.py:84-501``.

The JAX package traces a whole in-process graph into one jitted XLA
program.  The port evaluates the same tree eagerly, in PyTorch, walking
it in the same order:

    transform_input -> route -> children -> aggregate -> transform_output

with unit states held in one dict (node name -> state) and threaded
through ``UnitAux`` updates, tags merged with later writers winning.
Each unit's tensors stay on the engine's device.  A router's branch is
one device-to-host read per request, and then only the chosen child runs:
the eager counterpart of the reference's ``lax.switch``.  An out-of-range
branch raises before any child runs, and the states stay as they were
(the reference raises after the program, without writing its states
back).  ``routing`` records each visited router's branch; routers off the
executed path report ``NOT_ROUTED`` and are left out of ``meta.routing``.
The feedback pass (``feedback_arrays``) replays a response's
``meta.routing``: each unit with SEND_FEEDBACK takes the reward, and a
router's feedback reaches only the child it routed to (all of them for a
router it does not record).  A remote node, a node without a unit and an
impure unit (a plain user object behind its adapter) are refused with a
``GraphSpecError``, which the engine takes as its cue to serve the graph
through the host interpreter (``graph/interpreter.py``).

The perf observatory (``utils/perf.py``) sees every walk under
``executable_key`` (``predict[1x784/float32]``, the JAX package's key for
the same request): the first walk of a shape registers the shape's cost
features where the JAX executor's AOT capture does, with the first call's
wall as its compile time, since the port runs eagerly.  The features are
the analytic count the units give (``Unit.dispatch_cost``, the fused MLP's
``2·B·Σ d_in·d_out``) when every unit of a router-free graph gives one,
else none: a latency-only row, as on a JAX backend without cost
analysis.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device
from seldon_core_tpu_torch.graph.interpreter import (
    as_input,
    effective_type,
    methods_for,
    pythonize_tags,
    to_device,
    unit_rngs,
)
from seldon_core_tpu_torch.graph.spec import (
    GraphSpecError,
    PredictiveUnit,
    PredictorSpec,
    UnitMethod,
    UnitType,
    params_to_kwargs,
)
from seldon_core_tpu_torch.graph.units import (
    UNIT_REGISTRY,
    Unit,
    host_only_reason,
    instantiate_bound_unit,
    normalize_output,
)
from seldon_core_tpu_torch.messages import Meta, SeldonMessage, Status
from seldon_core_tpu_torch.utils.perf import OBSERVATORY, executable_key

__all__ = ["CompiledGraph", "NOT_ROUTED", "build_units", "to_device"]

# routing's sentinel for a router off the executed path: far outside any
# plausible branch index, so a router's negative answer cannot collide
NOT_ROUTED = -(2**30)


def _set_state(states: Dict[str, Any], name: str, new_state) -> Dict[str, Any]:
    """State write: a unit may only write state it declared via
    ``init_state`` (its key already exists), as in the JAX executor."""
    if new_state is None or new_state is states.get(name):
        return states
    if name not in states:
        raise GraphSpecError(
            f"unit {name!r} returned a state update but init_state() was None"
        )
    out = dict(states)
    out[name] = new_state
    return out


def build_units(predictor: PredictorSpec, device: Optional[torch.device] = None) -> Dict[str, Unit]:
    """Instantiate an in-process Unit for every graph node.  A node that is
    not an in-process pure unit (``host_only_reason``: a remote binding or
    none, a plain user object, an impure class) raises ``GraphSpecError``
    before any unit is built."""
    comp_map = predictor.component_map()
    for node in predictor.graph.walk():
        reason = host_only_reason(node, comp_map.get(node.name))
        if reason is not None:
            raise GraphSpecError(f"node {node.name!r}: {reason}; the host interpreter serves it")
    units: Dict[str, Unit] = {}
    for node in predictor.graph.walk():
        if node.implementation.value in UNIT_REGISTRY:
            unit = UNIT_REGISTRY[node.implementation.value](
                **params_to_kwargs(node.parameters)
            )
        else:
            unit = instantiate_bound_unit(comp_map[node.name], node, device=device)
        if not unit.pure:
            raise GraphSpecError(
                f"unit {node.name!r} ({type(unit).__name__}) is not pure; "
                f"compiled mode requires pure units"
            )
        units[node.name] = unit
    return units


def _routers_in(node: PredictiveUnit) -> List[str]:
    return [u.name for u in node.walk() if UnitMethod.ROUTE in methods_for(u) and u.children]


class CompiledGraph:
    """Evaluate a PredictorSpec's graph eagerly on one device.

    Usage::

        cg = CompiledGraph(predictor, device="cuda")
        y, routing, tags = cg.predict_arrays(x)   # y stays on the device
        resp = cg.predict(msg)                    # SeldonMessage in/out
    """

    def __init__(self, predictor: PredictorSpec, rng: Optional[int] = None,
                 device: DeviceLike = None):
        self.predictor = predictor
        self.device = resolve_device(device)
        self.units = build_units(predictor, device=self.device)
        rngs = unit_rngs(list(self.units), rng)
        self.states: Dict[str, Any] = {}
        for name, unit in sorted(self.units.items()):
            st = unit.init_state(rngs[name])
            if st is not None:
                self.states[name] = to_device(st, self.device)
        self._all_routers = _routers_in(predictor.graph)
        #: the perf observatory's program name (a fused subtree's is
        #: ``fused:<root>``) and the shapes whose costs it has registered
        self.key_name = "predict"
        self._registered: set = set()
        #: per-node share of a multi-node graph's cost, stamped on every
        #: dispatch record (computed at the first registration)
        self.phases: Optional[Dict[str, float]] = None
        self._predict_fn = self._build_predict(predictor.graph)
        self._feedback_fn = self._build_feedback(predictor.graph)

    def _build_predict(self, node: PredictiveUnit) -> Callable:
        unit = self.units[node.name]
        methods = methods_for(node)
        is_model = effective_type(node) is UnitType.MODEL
        child_fns = [self._build_predict(c) for c in node.children]
        name = node.name
        static_tags = dict(unit.static_tags or {})

        def fn(states, X, ctx):
            routing: Dict[str, int] = {}
            tags: Dict[str, Any] = dict(static_tags)
            y = X
            if UnitMethod.TRANSFORM_INPUT in methods:
                m = unit.predict if is_model else unit.transform_input
                y, new_state, t = normalize_output(m(states.get(name), y), states.get(name))
                states = _set_state(states, name, new_state)
                tags.update(t)
            if child_fns and UnitMethod.ROUTE in methods:
                out = unit.route(states.get(name), y)
                branch, new_state, _ = normalize_output(out, states.get(name))
                states = _set_state(states, name, new_state)
                branch = int(branch)  # the request's one device-to-host read here
                if not 0 <= branch < len(child_fns):
                    raise GraphSpecError(
                        f"router {name!r} chose branch {branch} but has {len(child_fns)} "
                        f"children (broadcast routing is host-mode only)"
                    )
                branch = self._serve_branch(name, branch, ctx)
                y, states, child_routing, t = child_fns[branch](states, y, ctx)
                routing[name] = branch
                routing.update(child_routing)
                tags.update(t)
            elif child_fns:
                ys = []
                for cf in child_fns:
                    yc, states, r, t = cf(states, y, ctx)
                    ys.append(yc)
                    routing.update(r)
                    tags.update(t)
                if UnitMethod.AGGREGATE in methods:
                    out = unit.aggregate(states.get(name), torch.stack(ys, dim=0))
                    y, new_state, t = normalize_output(out, states.get(name))
                    states = _set_state(states, name, new_state)
                    tags.update(t)
                elif len(ys) == 1:
                    y = ys[0]
                else:
                    raise GraphSpecError(
                        f"node {name!r} has {len(ys)} children but no "
                        f"AGGREGATE method to merge them"
                    )
            if UnitMethod.TRANSFORM_OUTPUT in methods:
                out = unit.transform_output(states.get(name), y)
                y, new_state, t = normalize_output(out, states.get(name))
                states = _set_state(states, name, new_state)
                tags.update(t)
            return y, states, routing, tags

        return fn

    def _build_feedback(self, node: PredictiveUnit) -> Callable:
        unit = self.units[node.name]
        methods = methods_for(node)
        child_fbs = [self._build_feedback(c) for c in node.children]
        name = node.name
        is_router = UnitMethod.ROUTE in methods and bool(node.children)

        def fn(states, X, routing, reward, truth):
            branch = routing.get(name, -1)
            if UnitMethod.SEND_FEEDBACK in methods:
                new_state = unit.send_feedback(states.get(name), X, branch, reward, truth)
                states = _set_state(states, name, new_state)
            for idx, cfb in enumerate(child_fbs):
                # a router's feedback reaches the child it routed to, or
                # every child when it recorded no branch
                if not is_router or branch in (idx, -1):
                    states = cfb(states, X, routing, reward, truth)
            return states

        return fn

    def _serve_branch(self, name: str, branch: int, ctx) -> int:
        """The branch that serves when router ``name`` picks ``branch``
        (already range-checked); ``ctx`` is the value the call handed the
        walk.  The compiled executor serves the router's own choice; a
        ``FusedGraph`` applies its demotion rule here."""
        return branch

    def predict_arrays(self, X, update_states: bool = True
                       ) -> Tuple[torch.Tensor, Dict[str, int], Dict[str, Any]]:
        """Run the graph; returns (Y on the device, routing, tags) and
        advances the held unit states (not on a failure, nor with
        ``update_states=False``: a prewarm's walk)."""
        return self._walk(X, None, update_states)

    def executable_key(self, X) -> str:
        """Stable per-shape executable identity (the perf observatory's
        key); reads only the shape and dtype, never the values."""
        dtype = getattr(X, "dtype", None)
        if dtype is None:  # plain lists etc. — cold paths only
            dtype = np.asarray(X).dtype
        return self.shape_key(tuple(np.shape(X)), dtype)

    def shape_key(self, shape, dtype) -> str:
        """``executable_key`` of an input of ``shape`` and ``dtype`` that
        does not exist yet: the key the autopilot prices a planned pad
        bucket by is the one the dispatch's record will train."""
        return executable_key(self.key_name, tuple(shape), dtype)

    def cost_features(self, rows: int) -> Optional[Dict[str, float]]:
        """The analytic cost of one walk on ``rows`` rows: the sum of the
        units' ``dispatch_cost`` when the graph has no router and every
        unit gives one, else None (a latency-only row)."""
        if self._all_routers:
            return None
        total: Dict[str, float] = {}
        for name, unit in self.units.items():
            cost = unit.dispatch_cost(self.states.get(name), rows)
            if cost is None:
                return None
            for k, v in cost.items():
                total[k] = total.get(k, 0.0) + float(v)
        return total or None

    def _phase_shares(self, rows: int) -> Optional[Dict[str, float]]:
        """Each unit's share of a multi-node graph's FLOPs (a uniform split
        when a unit gives no count); None for a single node."""
        names = list(self.units)
        if len(names) < 2:
            return None
        flops = {}
        for n in names:
            cost = self.units[n].dispatch_cost(self.states.get(n), rows)
            flops[n] = float((cost or {}).get("flops", 0.0))
        total = sum(flops.values())
        if total <= 0:
            return {n: round(1.0 / len(names), 4) for n in names}
        return {n: round(v / total, 4) for n, v in flops.items()}

    def _walk(self, X, ctx, update_states: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, int], Dict[str, Any]]:
        key = None
        if OBSERVATORY.enabled:
            key = self.executable_key(X)
            if key in self._registered:
                key = None
            t0 = time.perf_counter()
        X = as_input(X, self.device)
        with torch.inference_mode():
            y, states, routing, tags = self._predict_fn(self.states, X, ctx)
        if key is not None:
            self._register(key, int(X.shape[0]) if X.ndim else 1,
                           time.perf_counter() - t0)
        if update_states:
            self.states = states
        routing = {r: routing.get(r, NOT_ROUTED) for r in self._all_routers}
        return y, {r: v for r, v in routing.items() if v != NOT_ROUTED}, tags

    def _register(self, key: str, rows: int, first_call_s: float) -> None:
        """A shape's first walk: its cost features and first-call wall into
        the perf observatory (the JAX executor's ``_aot_build`` point),
        and a multi-node graph's phase shares."""
        self._registered.add(key)
        OBSERVATORY.record_compile(key, self.cost_features(rows), first_call_s)
        if self.phases is None:
            self.phases = self._phase_shares(rows)
        if self.phases is not None:
            OBSERVATORY.note_phases(key, self.phases)

    def feedback_arrays(self, X, routing: Dict[str, Any], reward: float, truth=None) -> None:
        """The feedback pass: the units' state updates for a reward on rows
        ``X`` (None: one row), replaying the recorded ``routing``; a router
        it does not name counts as -1 (no recorded branch)."""
        try:
            replay = {r: int(routing.get(r, -1)) for r in self._all_routers}
        except (TypeError, ValueError) as e:
            raise GraphSpecError(f"feedback routing {routing!r} is not a branch index: "
                                 f"{e}") from None
        if X is not None:
            X = as_input(np.atleast_2d(X), self.device)
        if truth is not None:
            truth = as_input(truth, self.device)
        with torch.inference_mode():
            self.states = self._feedback_fn(self.states, X, replay, float(reward), truth)

    def predict(self, msg: SeldonMessage) -> SeldonMessage:
        """SeldonMessage in and out."""
        # 1-D wire payloads mean a single sample
        y, routing, tags = self.predict_arrays(np.atleast_2d(msg.array()))
        resp = msg.with_array(
            y.detach().cpu().numpy(),
            names=self._output_names(self.predictor.graph, routing),
        )
        resp.meta = Meta(
            puid=msg.meta.puid,
            tags={**msg.meta.tags, **pythonize_tags(tags)},
            routing={**msg.meta.routing, **routing},
            requestPath=dict(msg.meta.requestPath),
        )
        resp.status = Status()
        return resp

    def _output_names(self, node: PredictiveUnit, routing: Dict[str, int]) -> Optional[list]:
        """Names of the unit that produced the output: the last unit on the
        executed path, following the recorded routing, that sets class
        names (graph/compiled.py:477)."""
        unit = self.units[node.name]
        methods = methods_for(node)
        names: Optional[list] = None
        if UnitMethod.TRANSFORM_INPUT in methods and unit.class_names is not None:
            names = list(unit.class_names)
        if node.children:
            if UnitMethod.ROUTE in methods and node.name in routing:
                child = node.children[routing[node.name]]
                names = self._output_names(child, routing) or names
            elif UnitMethod.AGGREGATE in methods and unit.class_names is not None:
                names = list(unit.class_names)
            else:
                names = self._output_names(node.children[0], routing) or names
        if UnitMethod.TRANSFORM_OUTPUT in methods and unit.class_names is not None:
            names = list(unit.class_names)
        return names
