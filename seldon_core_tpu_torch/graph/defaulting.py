"""Deployment defaulting + validation — the port's copy of
``seldon_core_tpu/graph/defaulting.py``.

Mirrors the reference operator's ``defaulting``/``validate`` steps
(cluster-manager SeldonDeploymentOperatorImpl.java:346-441): assign each
remote graph node a cluster-unique service port from a base, back-fill
``PredictiveUnit.endpoint`` from its component binding, inject the standard
unit env/config (unit id, predictor id, deployment id, typed parameters as
JSON), and reject structurally invalid graphs before anything materialises.

An ``inprocess`` binding gets no port — the node runs inside the engine,
so its "endpoint" is the in-memory unit registry.  Port assignment only
happens for ``rest``/``grpc`` bindings.
"""

from __future__ import annotations

import json
from typing import List

from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    Endpoint,
    EndpointType,
    GraphSpecError,
    PredictiveUnit,
    PredictorSpec,
    SeldonDeploymentSpec,
    UnitImplementation,
    UnitMethod,
    UnitType,
)

PU_PORT_BASE = 9000  # cluster-manager application.properties:7 pu-container-port-base

# env names the reference injects into every unit container
# (SeldonDeploymentOperatorImpl.java:260-279)
ENV_SERVICE_PORT = "PREDICTIVE_UNIT_SERVICE_PORT"
ENV_PARAMETERS = "PREDICTIVE_UNIT_PARAMETERS"
ENV_UNIT_ID = "PREDICTIVE_UNIT_ID"
ENV_PREDICTOR_ID = "PREDICTOR_ID"
ENV_DEPLOYMENT_ID = "SELDON_DEPLOYMENT_ID"


def defaulting(spec: SeldonDeploymentSpec) -> SeldonDeploymentSpec:
    """Rewrite the spec in place (and return it) with ports/endpoints/env."""
    port_counter = PU_PORT_BASE
    for predictor in spec.predictors:
        comp_map = predictor.component_map()
        for unit in predictor.graph.walk():
            binding = comp_map.get(unit.name)
            if binding is None:
                continue  # hardcoded-impl units have no binding
            # -- port assignment (remote runtimes only) ---------------------
            if binding.runtime in ("rest", "grpc") and not binding.port:
                binding.port = port_counter
                port_counter += 1
            if not binding.host and binding.runtime in ("rest", "grpc"):
                binding.host = "localhost"
            # -- endpoint back-fill ----------------------------------------
            if binding.runtime == "inprocess":
                unit.endpoint = None  # compiled into the engine program
            else:
                ep_type = (
                    EndpointType.GRPC if binding.runtime == "grpc" else EndpointType.REST
                )
                if unit.endpoint is None:
                    unit.endpoint = Endpoint(type=ep_type)
                unit.endpoint.service_host = binding.host
                unit.endpoint.service_port = binding.port
                unit.endpoint.type = ep_type
            # -- parameter propagation: unit params flow to the binding ----
            if unit.parameters and not binding.parameters:
                binding.parameters = list(unit.parameters)
            # -- standard env ----------------------------------------------
            binding.env.setdefault(ENV_SERVICE_PORT, str(binding.port))
            binding.env.setdefault(
                ENV_PARAMETERS,
                json.dumps([p.to_json_dict() for p in binding.parameters]),
            )
            binding.env.setdefault(ENV_UNIT_ID, unit.name)
            binding.env.setdefault(ENV_PREDICTOR_ID, predictor.name)
            binding.env.setdefault(ENV_DEPLOYMENT_ID, spec.name)
    return spec


def _check_unit(unit: PredictiveUnit, comp_names: set, errors: List[str]) -> None:
    has_impl = unit.implementation is not UnitImplementation.UNKNOWN_IMPLEMENTATION
    has_methods = unit.methods is not None
    has_type = unit.type is not None
    # every unit must define what it does (SeldonDeploymentOperatorImpl.java:422-430)
    if not (has_impl or has_methods or has_type):
        errors.append(
            f"unit {unit.name!r} must declare type, implementation, or methods"
        )
    # non-hardcoded units must resolve to a component binding
    # (SeldonDeploymentOperatorImpl.java:390-413)
    if not has_impl and unit.name not in comp_names:
        errors.append(
            f"unit {unit.name!r} has no hardcoded implementation and no matching "
            f"component binding"
        )
    # built-in structural constraints
    if unit.implementation is UnitImplementation.RANDOM_ABTEST:
        if len(unit.children) != 2:
            errors.append(
                f"RANDOM_ABTEST unit {unit.name!r} needs exactly 2 children, "
                f"has {len(unit.children)}"
            )
        if not any(p.name == "ratioA" for p in unit.parameters):
            errors.append(f"RANDOM_ABTEST unit {unit.name!r} needs a 'ratioA' parameter")
    if unit.implementation is UnitImplementation.AVERAGE_COMBINER and not unit.children:
        errors.append(f"AVERAGE_COMBINER unit {unit.name!r} needs children to combine")
    if unit.type is UnitType.COMBINER and not unit.children:
        errors.append(f"COMBINER unit {unit.name!r} needs children to combine")
    if unit.type is UnitType.ROUTER and not unit.children:
        errors.append(f"ROUTER unit {unit.name!r} needs children to route to")
    # degradation declarations (resilience layer): structural sanity
    if unit.quorum is not None:
        combinerish = (
            unit.type is UnitType.COMBINER
            or unit.implementation is UnitImplementation.AVERAGE_COMBINER
            or (unit.methods is not None and UnitMethod.AGGREGATE in unit.methods)
        )
        if not combinerish:
            errors.append(
                f"unit {unit.name!r} declares a quorum but has no AGGREGATE "
                f"method (quorum only applies to combiners)"
            )
        if not (1 <= unit.quorum <= len(unit.children)):
            errors.append(
                f"unit {unit.name!r}: quorum {unit.quorum} out of range for "
                f"{len(unit.children)} children"
            )
    if unit.fallback is not None:
        routerish = (
            unit.type is UnitType.ROUTER
            or unit.implementation
            in (UnitImplementation.SIMPLE_ROUTER, UnitImplementation.RANDOM_ABTEST)
            or (unit.methods is not None and UnitMethod.ROUTE in unit.methods)
        )
        if not routerish:
            errors.append(
                f"unit {unit.name!r} declares a fallback branch but has no "
                f"ROUTE method (fallback only applies to routers)"
            )
        if not (0 <= unit.fallback < len(unit.children)):
            errors.append(
                f"unit {unit.name!r}: fallback branch {unit.fallback} out of "
                f"range for {len(unit.children)} children"
            )
    for child in unit.children:
        _check_unit(child, comp_names, errors)


def validate(spec: SeldonDeploymentSpec) -> None:
    """Raise GraphSpecError listing every violation (reference validate,
    SeldonDeploymentOperatorImpl.java:432-441)."""
    errors: List[str] = []
    if not spec.predictors:
        errors.append("deployment has no predictors")
    seen_predictors = set()
    for predictor in spec.predictors:
        if predictor.name in seen_predictors:
            errors.append(f"duplicate predictor name {predictor.name!r}")
        seen_predictors.add(predictor.name)
        names = [u.name for u in predictor.graph.walk()]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            errors.append(
                f"predictor {predictor.name!r}: duplicate unit names {sorted(dupes)}"
            )
        comp_names = set(predictor.component_map())
        _check_unit(predictor.graph, comp_names, errors)
        for binding in predictor.components:
            if binding.runtime == "inprocess" and not binding.class_path:
                errors.append(
                    f"inprocess binding {binding.name!r} needs a class_path "
                    f"(module:Class or registered unit name)"
                )
    if errors:
        raise GraphSpecError("; ".join(errors))


def default_and_validate(spec: SeldonDeploymentSpec) -> SeldonDeploymentSpec:
    defaulting(spec)
    validate(spec)
    return spec
