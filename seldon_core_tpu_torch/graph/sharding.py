"""Graph sharding — one engine process per graph node; the port's copy of
``seldon_core_tpu/graph/sharding.py``.

The reference materializes one pod per graph node (every PredictiveUnit
gets its own microservice Deployment, wired by the engine's internal
dispatch).  The engine collapses that into one process, the right call for
latency and the wrong one for scale-out, where a hot MODEL leaf should
grow replicas independently of its siblings.  This module wins the
reference topology back at process granularity:

* :func:`shardable_nodes` — the MODEL leaves with inprocess bindings.
  Only those shard: the engine's cross-process surface speaks ``POST
  /predict``, while routers, combiners and transformers are per-request
  control flow that stays in the root engine.
* :func:`node_subspec` — a standalone single-node SeldonDeployment for
  one leaf, served by ``engine_main --node`` / ``ENGINE_GRAPH_NODE``.
* :func:`shard_predictor` — the root engine's rewritten spec: sharded
  leaves' bindings become ``rest`` endpoints at the node engines, so the
  remote-dispatch client (``runtime/client.py``: pooled keep-alive,
  retries, breakers, deadline propagation, traceparent) wires the graph
  with no new transport code.

The operator half, the manifest renderer that materializes one node
engine Deployment+Service per sharded leaf under ``seldon.io/shard-graph``,
is ``seldon_core_tpu_torch/operator/manifests.py``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from seldon_core_tpu_torch.graph.interpreter import effective_type
from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    GraphSpecError,
    PredictiveUnit,
    PredictorSpec,
    SeldonDeploymentSpec,
    UnitType,
)

__all__ = [
    "shardable_nodes",
    "node_subspec",
    "shard_predictor",
]


def shardable_nodes(predictor: PredictorSpec) -> List[PredictiveUnit]:
    """MODEL leaves with an inprocess binding — the nodes that can run as
    standalone engine processes behind ``POST /predict``."""
    comp_map = predictor.component_map()
    out = []
    for unit in predictor.graph.walk():
        if unit.children:
            continue
        if effective_type(unit) is not UnitType.MODEL:
            continue
        binding = comp_map.get(unit.name)
        if binding is not None and binding.runtime == "inprocess":
            out.append(unit)
    return out


def node_subspec(spec: SeldonDeploymentSpec, node_name: str,
                 predictor_name: Optional[str] = None) -> SeldonDeploymentSpec:
    """A standalone deployment serving ONE node of ``spec``'s graph — what
    an ``ENGINE_GRAPH_NODE=<name>`` engine process boots.  The node keeps
    its name, parameters and binding, so its compiled unit (and therefore
    its predictions) are identical to the collapsed in-engine form."""
    predictor = spec.predictor(predictor_name)
    unit = predictor.graph.find(node_name)
    if unit is None:
        raise GraphSpecError(
            f"graph node {node_name!r} not found in predictor "
            f"{predictor.name!r}"
        )
    if unit.children:
        raise GraphSpecError(
            f"graph node {node_name!r} has children — only leaves shard "
            f"into node engines"
        )
    binding = predictor.component_map().get(node_name)
    if binding is None or binding.runtime != "inprocess":
        raise GraphSpecError(
            f"graph node {node_name!r} has no inprocess binding to serve"
        )
    node_unit = copy.deepcopy(unit)
    annotations = dict(spec.annotations)
    # the subspec is a plain single-node deployment; carrying the shard
    # marker forward would re-shard it on the next materialization pass
    annotations.pop("seldon.io/shard-graph", None)
    # predictor-qualified name: a canary pair sharing a leaf name must
    # materialize DISTINCT node Deployments/Services per predictor, or
    # the second `kubectl apply` silently rewires the first predictor's
    # traffic onto the other's node engine
    return SeldonDeploymentSpec(
        name=f"{spec.name}-{predictor.name}-{node_name}",
        predictors=[
            PredictorSpec(
                name=predictor.name,
                graph=node_unit,
                components=[copy.deepcopy(binding)],
                replicas=predictor.replicas,
                annotations=dict(predictor.annotations),
            )
        ],
        annotations=annotations,
    )


def shard_predictor(
    spec: SeldonDeploymentSpec,
    endpoints: Dict[str, Tuple[str, int]],
    predictor_name: Optional[str] = None,
) -> SeldonDeploymentSpec:
    """The root engine's spec with each node in ``endpoints`` rewritten to
    a ``rest`` binding at ``(host, port)`` — the node engine materialized
    by :func:`node_subspec`.  The root then serves the graph in host mode
    through the resilient remote-dispatch client (per-node breakers,
    shared retry budget, deadline propagation ride along for free).

    ``endpoints`` keys must be shardable nodes; anything else is a
    config error surfaced at materialization, not at first request."""
    out = copy.deepcopy(spec)
    predictor = out.predictor(predictor_name)
    legal = {u.name for u in shardable_nodes(predictor)}
    comp_map = predictor.component_map()
    for node_name, (host, port) in endpoints.items():
        if node_name not in legal:
            raise GraphSpecError(
                f"node {node_name!r} is not shardable (must be a MODEL "
                f"leaf with an inprocess binding)"
            )
        old = comp_map[node_name]
        predictor.components[predictor.components.index(old)] = \
            ComponentBinding(
                name=node_name,
                runtime="rest",
                host=host,
                port=int(port),
                image=old.image,
            )
    return out
