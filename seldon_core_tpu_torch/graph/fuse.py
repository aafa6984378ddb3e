"""Whole-graph and partial fusion — the port's counterpart of
``seldon_core_tpu/graph/fuse.py``.

The JAX package compiles a fusible graph into one XLA program.  The port
runs eagerly, so "fused" keeps the reference's contract rather than its
mechanism: a fusible (sub)graph is one ``CompiledGraph`` call per request,
its intermediates staying device tensors, and the planning, eligibility
rules and branch-demotion rule are the reference's:

  * **Planning** (``plan_fusion``): a subtree fuses when its root and
    every descendant is an in-process pure unit with no ``quorum`` or
    ``fallback`` (a degradation policy is host-mode only), read from
    class-level facts, so planning builds no unit.  ``FusionPlan`` names
    why each blocking node blocks and counts the hops a fused subtree
    saves per request.
  * **Full fusion** (``FusedGraph``, engine mode ``fused``): the compiled
    walk with each router's branch passed through the demotion rule of
    ``fuse.py:420-430`` there.  A raw branch predicted over budget moves to
    the cheapest alternative predicted within budget; NaN predictions
    neither trigger nor receive a move.  The rule runs on the branch the
    router already reads back once a request, so it adds no device sync.
    The per-router cost vectors are the autopilot's learned branch walls
    (``runtime/autopilot.py`` ``branch_cost_vector``) and the budget the
    request's remaining deadline times ``shed_margin()`` (``_cost_args``,
    ``fuse.py:514-545`` there), when a budget is in force and the kill
    switch is on; otherwise NaN and +inf, and the walk is the compiled one.
    A demoted router is counted (``seldon_tpu_autopilot_decisions_total
    {site="route"}``), marked by an ``autopilot_reroute`` span event and
    tagged ``seldon.autopilot.reroute.<router>``.  Each served branch
    learns its wall (``learn_branches``) from a wall that ends at the
    readback the response pays: ``predict``'s own, or a fused subtree's
    dispatch wall (never the launch time ``predict_arrays`` returns
    after, with Y still on the device).
  * **Partial fusion** (``build_partial_fusion``): in a host-mode graph
    each maximal fusible subtree of 2 or more nodes becomes one
    ``FusedSubtreeRuntime``; the interpreter's recursion stops at its root.
  * **Kill switch**: ``SELDON_TPU_GRAPH_FUSE=0`` turns the pass off (the
    compiled executor for an in-process pure graph, the per-node
    interpreter for any other); the predictor annotation
    ``seldon.io/graph-fuse: "false"`` opts one deployment out.

The perf observatory keys a fused graph as the compiled executor does
(``predict[...]`` for a whole graph, ``fused:<root>[...]`` for a
subtree); its phase decomposition is each unit's share of the analytic
FLOPs (``CompiledGraph._phase_shares``, a uniform split without counts),
where the JAX package lowers each node for XLA's ``cost_analysis``.  A
fused subtree's dispatch writes one telemetry-spine record
(``utils/hotrecord.py``), as the JAX one does.  Left out, having no eager
counterpart: the per-shape AOT cache and the request buffer's donation.
Unit states derive from unit names
(``unit_rngs``), so a fused subtree initialises exactly as the same units
do under the interpreter.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike
from seldon_core_tpu_torch.graph.compiled import CompiledGraph
from seldon_core_tpu_torch.graph.interpreter import _payload, _Serialized, methods_for, pythonize_tags
from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    GraphSpecError,
    PredictiveUnit,
    PredictorSpec,
    UnitMethod,
)
from seldon_core_tpu_torch.graph.units import host_only_reason
from seldon_core_tpu_torch.messages import Meta, SeldonMessage, Status
from seldon_core_tpu_torch.runtime.autopilot import (
    AUTOPILOT,
    autopilot_enabled,
    branch_cost_vector,
    branch_key,
    shed_margin,
)
from seldon_core_tpu_torch.runtime.resilience import remaining_s
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import TRACER

__all__ = [
    "fuse_enabled",
    "FUSE_ANNOTATION",
    "FusionPlan",
    "plan_fusion",
    "demoted_branch",
    "FusedGraph",
    "FusedSubtreeRuntime",
    "build_partial_fusion",
]

logger = logging.getLogger(__name__)

#: predictor annotation opting one deployment out of fusion
FUSE_ANNOTATION = "seldon.io/graph-fuse"


def fuse_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_GRAPH_FUSE=0`` turns the fusion pass off."""
    return os.environ.get("SELDON_TPU_GRAPH_FUSE", "1") != "0"


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


@dataclass
class FusionPlan:
    """Per-node eligibility and the maximal fused subtrees of one graph.

    ``reasons`` names why a node itself blocks fusion; ``fused_roots`` are
    the maximal subtrees of 2 or more nodes; ``fused_dispatches`` counts the
    unit dispatches the interpreter would pay a request for them (a ROUTER
    runs itself and one branch, the cheapest counted), so
    ``hops_eliminated`` is the per-request saving."""

    n_nodes: int = 0
    reasons: Dict[str, str] = field(default_factory=dict)
    fused_roots: List[str] = field(default_factory=list)
    fused_nodes: int = 0
    fused_dispatches: int = 0
    full: bool = False

    @property
    def hops_eliminated(self) -> int:
        return max(self.fused_dispatches - len(self.fused_roots), 0)

    def summary(self) -> Dict[str, Any]:
        """The plan as the engine's ``/stats`` shows it."""
        return {"full": self.full, "nodes": self.n_nodes, "fused_nodes": self.fused_nodes,
                "fused_roots": list(self.fused_roots), "hops_eliminated": self.hops_eliminated,
                "blocked": dict(self.reasons)}


def _node_block_reason(node: PredictiveUnit, comp_map: Dict[str, ComponentBinding],
                       skip: frozenset) -> Optional[str]:
    """Why this node cannot enter a fused walk (None: eligible), from
    class-level facts only: no unit is built here."""
    if node.name in skip:
        return "external node runtime supplied"
    if node.quorum is not None:
        return "quorum degradation policy is host-mode only"
    if node.fallback is not None:
        return "fallback degradation policy is host-mode only"
    return host_only_reason(node, comp_map.get(node.name))


def _per_request_dispatches(node: PredictiveUnit) -> int:
    """Unit dispatches the interpreter pays for one request through this
    subtree: a ROUTER runs itself and exactly one branch (the cheapest is
    the guaranteed floor), any other node itself and all its children."""
    if not node.children:
        return 1
    if UnitMethod.ROUTE in methods_for(node):
        return 1 + min(_per_request_dispatches(c) for c in node.children)
    return 1 + sum(_per_request_dispatches(c) for c in node.children)


def plan_fusion(predictor: PredictorSpec, skip: Optional[set] = None) -> FusionPlan:
    """Mark every maximal fusible subtree of the spec.  ``skip`` names nodes
    whose runtime the caller supplies (remote clients, test stand-ins):
    they pin their subtree to the host path."""
    plan = FusionPlan(n_nodes=sum(1 for _ in predictor.graph.walk()))
    if str(predictor.annotations.get(FUSE_ANNOTATION, "")).lower() in ("false", "0", "off"):
        plan.reasons[predictor.graph.name] = f"predictor annotation {FUSE_ANNOTATION}=false"
        return plan
    comp_map = predictor.component_map()
    skip_f = frozenset(skip or ())
    fusible: Dict[str, bool] = {}

    def visit(node: PredictiveUnit) -> bool:
        reason = _node_block_reason(node, comp_map, skip_f)
        if reason is not None:
            plan.reasons[node.name] = reason
        ok = reason is None
        for c in node.children:
            ok = visit(c) and ok
        fusible[node.name] = ok
        return ok

    plan.full = visit(predictor.graph)

    def collect_roots(node: PredictiveUnit) -> None:
        n_sub = sum(1 for _ in node.walk())
        if fusible[node.name] and n_sub >= 2:
            plan.fused_roots.append(node.name)
            plan.fused_nodes += n_sub
            plan.fused_dispatches += _per_request_dispatches(node)
            return  # maximal: never descend into a fused subtree
        for c in node.children:
            collect_roots(c)

    collect_roots(predictor.graph)
    return plan


# ---------------------------------------------------------------------------
# The fused executor
# ---------------------------------------------------------------------------


def demoted_branch(branch: int, costs: Optional[np.ndarray], budget: np.float32) -> int:
    """The branch that serves when a router picks ``branch`` under the
    predicted branch walls ``costs`` (float32, NaN = no prediction) and the
    demotion ``budget`` (float32): ``branch`` itself unless its prediction
    exceeds the budget and another branch's fits, then the cheapest that
    fits (the first of equals), as ``jnp.argmin`` picks it there."""
    if costs is None or not costs[branch] > budget:  # a NaN prediction keeps the branch
        return branch
    best = None
    for b, c in enumerate(costs):
        if b == branch or np.isnan(c) or c > budget:
            continue
        if best is None or c < costs[best]:
            best = b
    return branch if best is None else best


class _Demotion(NamedTuple):
    """One fused call's demotion arguments, and the raw branch each router
    picked before the rule ran."""

    costs: Dict[str, np.ndarray]
    budget: np.float32
    raw: Dict[str, int]


class FusedGraph(CompiledGraph):
    """A ``CompiledGraph`` whose walk passes each router's branch through
    the demotion rule under per-router cost vectors and a budget.  The
    walk is the compiled executor's own: only its branch hook differs.
    ``routing`` holds the branch that served, which is what lands in
    ``meta.routing`` so feedback trains it; a router's own choice is
    range-checked before any child runs, and a demotion is stamped as the
    tag ``seldon.autopilot.reroute.<router>``.  ``plan`` is the predictor's
    ``plan_fusion``, when the caller made it already."""

    def __init__(self, predictor: PredictorSpec, rng: Optional[int] = None,
                 device: DeviceLike = None, plan: Optional[FusionPlan] = None):
        plan = plan_fusion(predictor) if plan is None else plan
        if not plan.full:
            blocked = "; ".join(f"{n}: {r}" for n, r in sorted(plan.reasons.items()))
            raise GraphSpecError(f"graph {predictor.graph.name!r} is not fully fuse-eligible "
                                 f"({blocked or 'ineligible subtree'})")
        self.plan = plan
        super().__init__(predictor, rng=rng, device=device)
        self._router_children = {r: len(predictor.graph.find(r).children)
                                 for r in self._all_routers}

    def _serve_branch(self, name: str, branch: int, ctx: _Demotion) -> int:
        ctx.raw[name] = branch
        return demoted_branch(branch, ctx.costs.get(name), ctx.budget)

    def _cost_args(self, rows: int = 1, budget_s: Optional[float] = None
                   ) -> Tuple[Dict[str, np.ndarray], np.float32]:
        """The request's (costs, budget): each router's learned branch walls
        at the request's pad bucket and ``budget_s * shed_margin()`` when a
        budget is in force and the autopilot is on, else (no budget, the
        default) NaN vectors and +inf: no branch is demoted."""
        active = (budget_s is not None and budget_s > 0 and autopilot_enabled()
                  and bool(self._router_children))
        costs = {}
        for r, n in self._router_children.items():
            if active:
                costs[r] = np.asarray([math.nan if v is None else float(v)
                                       for v in branch_cost_vector(r, n, rows)], np.float32)
            else:
                costs[r] = np.full((n,), math.nan, np.float32)
        return costs, np.float32(budget_s * shed_margin() if active else math.inf)

    def predict_arrays(self, X, costs: Optional[Dict[str, Any]] = None,
                       budget: Optional[float] = None, update_states: bool = True,
                       budget_s: Optional[float] = None, rows: Optional[int] = None):
        """Run the fused walk; returns ``(Y on the device, routing, tags)``
        as the compiled executor does, ``routing`` holding the branches that
        served.  ``budget_s`` is the request's remaining deadline (read on
        the request's side: the dispatch thread is another), ``rows`` its
        row count for the branch keys (X's by default); ``costs`` (router
        name -> per-branch predicted walls) and ``budget`` override what
        ``_cost_args`` makes of them."""
        if rows is None:
            shape = np.shape(X)
            rows = int(shape[0]) if len(shape) >= 2 else 1
        default_costs, default_budget = self._cost_args(rows, budget_s)
        if costs is not None:
            default_costs.update({r: np.asarray(c, np.float32) for r, c in costs.items()})
        ctx = _Demotion(default_costs, default_budget if budget is None else np.float32(budget),
                        {})
        y, routing, tags = self._walk(X, ctx, update_states)
        demoted = {r: b for r, b in routing.items() if ctx.raw[r] != b}
        if demoted:
            tags = dict(tags)
            for r, b in demoted.items():
                RECORDER.record_autopilot_decision("route")
                TRACER.event("autopilot_reroute", node=r, from_branch=int(ctx.raw[r]),
                             to_branch=int(b), in_program=True)
                tags[f"seldon.autopilot.reroute.{r}"] = int(b)
        return y, routing, tags

    @staticmethod
    def learn_branches(routing: Dict[str, int], rows: int, seconds: float) -> None:
        """Fold one request's wall into each served branch's model at its
        pad bucket (learning is not gated by the kill switch).  ``seconds``
        must end at a readback the response pays: the walk returns with Y
        still on the device, so its own wall is launch time."""
        for r, b in routing.items():
            AUTOPILOT.observe(branch_key(r, b, rows), seconds)

    def predict(self, msg: SeldonMessage, budget_s: Optional[float] = None) -> SeldonMessage:
        """SeldonMessage in and out under the demotion ``budget_s``; the
        served branches learn the wall that ends at the answer's readback."""
        X = np.atleast_2d(msg.array())
        t0 = time.perf_counter()
        y, routing, tags = self.predict_arrays(X, budget_s=budget_s)
        y = y.detach().cpu().numpy()
        if routing:
            self.learn_branches(routing, len(X), time.perf_counter() - t0)
        resp = msg.with_array(y, names=self._output_names(self.predictor.graph, routing))
        resp.meta = Meta(puid=msg.meta.puid, tags={**msg.meta.tags, **pythonize_tags(tags)},
                         routing={**msg.meta.routing, **routing},
                         requestPath=dict(msg.meta.requestPath))
        resp.status = Status()
        return resp


# ---------------------------------------------------------------------------
# Partial fusion: fused subtrees inside the host interpreter
# ---------------------------------------------------------------------------


def _subtree_spec(predictor: PredictorSpec, root: PredictiveUnit) -> PredictorSpec:
    """A PredictorSpec scoped to one subtree.  Unit states derive from unit
    names, so its units initialise exactly as inside the full graph."""
    names = {u.name for u in root.walk()}
    return PredictorSpec(name=f"{predictor.name}/{root.name}", graph=root,
                         components=[c for c in predictor.components if c.name in names],
                         annotations=dict(predictor.annotations))


class FusedSubtreeRuntime(_Serialized):
    """One fused subtree run as a single ``FusedGraph`` call from inside
    the host interpreter, on ``executor`` when one is given, one call at a
    time (its states move per request)."""

    def __init__(self, predictor: PredictorSpec, root: PredictiveUnit, rng: Optional[int] = None,
                 device: DeviceLike = None, executor: Optional[Executor] = None):
        super().__init__(executor)
        self.root = root
        self.graph = FusedGraph(_subtree_spec(predictor, root), rng=rng, device=device)
        self.graph.key_name = f"fused:{root.name}"

    async def run(self, msg: SeldonMessage) -> SeldonMessage:
        X = _payload(msg)
        X = torch.atleast_2d(X) if isinstance(X, torch.Tensor) else np.atleast_2d(X)
        # one fused dispatch record for the subtree (the perf observatory's
        # row and the dispatch span under the node's ``fused`` span)
        wants = SPINE.dispatch_wants()
        t0 = time.perf_counter()
        start_s = time.time()
        # the demotion budget is read here, on the request's side, and handed
        # across to the dispatch thread
        call = functools.partial(self.graph.predict_arrays, budget_s=remaining_s(),
                                 rows=int(X.shape[0]))
        try:
            y, routing, tags = await self._run(call, X)
        except GraphSpecError:
            raise
        except (TypeError, ValueError) as e:
            # name the subtree, so the 400 stays actionable
            raise GraphSpecError(f"fused subtree {self.root.name!r} rejected input of shape "
                                 f"{tuple(X.shape)}: {e}") from e
        seconds = time.perf_counter() - t0
        if routing:
            self.graph.learn_branches(routing, int(X.shape[0]), seconds)
        if wants.any:
            SPINE.record_dispatch(
                wants, executable=self.graph.executable_key(X),
                seconds=seconds, start_s=start_s,
                rows=int(X.shape[0]), real_rows=int(X.shape[0]), method="fused",
                quality_node=self.root.name, phases=self.graph.phases)
        resp = msg.with_array(y, names=self.graph._output_names(self.root, routing))
        resp.meta = Meta(puid=msg.meta.puid, tags={**msg.meta.tags, **pythonize_tags(tags)},
                         routing={**msg.meta.routing, **routing},
                         requestPath=dict(msg.meta.requestPath))
        return resp

    async def feedback(self, feedback) -> None:
        routing = feedback.response.meta.routing if feedback.response is not None else {}
        X = None
        if feedback.request is not None and feedback.request.data is not None:
            X = feedback.request.array()
        await self._run(self.graph.feedback_arrays, X, routing, feedback.reward,
                        feedback.truth_array())


def build_partial_fusion(predictor: PredictorSpec, skip: Optional[set] = None,
                         rng: Optional[int] = None, device: DeviceLike = None,
                         executor: Optional[Executor] = None
                         ) -> Tuple[Dict[str, FusedSubtreeRuntime], FusionPlan]:
    """Plan and build the fused subtree runtimes of a host-mode graph:
    ``({root name: runtime}, plan)``.  A subtree that fails to build stays
    on the interpreter, and the plan's counts are unwound."""
    plan = plan_fusion(predictor, skip=skip)
    fused: Dict[str, FusedSubtreeRuntime] = {}
    for root_name in list(plan.fused_roots):
        root = predictor.graph.find(root_name)
        try:
            fused[root_name] = FusedSubtreeRuntime(predictor, root, rng=rng, device=device,
                                                   executor=executor)
        except Exception:  # noqa: BLE001 - the interpreter keeps the subtree
            logger.exception("partial fusion of subtree %r failed; interpreter keeps it",
                             root_name)
            plan.reasons[root_name] = "fused build failed (see logs)"
            plan.fused_nodes -= sum(1 for _ in root.walk())
            plan.fused_dispatches -= _per_request_dispatches(root)
            plan.fused_roots = [r for r in plan.fused_roots if r != root_name]
    return fused, plan
