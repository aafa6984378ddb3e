"""Inference-graph specification — the port's copy of
``seldon_core_tpu/graph/spec.py``.

The reference's ``SeldonDeployment`` custom resource
(reference: proto/seldon_deployment.proto:10-125) as plain dataclasses that
parse the same JSON the JAX package accepts (``apiVersion
machinelearning.seldon.io/v1alpha2``, ``spec.predictors[].graph`` tree of
``PredictiveUnit``s), including the in-process binding (``runtime:
inprocess``): a graph node bound to a registered unit class that the engine
runs in its own process on the device, instead of a remote microservice.
The JSON contract is the JAX package's, field for field, so one deployment
file serves on either package.

Mirrored semantics:
  * unit types  ROUTER/COMBINER/MODEL/TRANSFORMER/OUTPUT_TRANSFORMER
    (seldon_deployment.proto:63-71)
  * hardcoded implementations SIMPLE_MODEL/SIMPLE_ROUTER/RANDOM_ABTEST/
    AVERAGE_COMBINER (seldon_deployment.proto:73-80)
  * methods TRANSFORM_INPUT/TRANSFORM_OUTPUT/ROUTE/AGGREGATE/SEND_FEEDBACK
    (seldon_deployment.proto:82-88)
  * ``Endpoint{service_host, service_port, type REST|GRPC}``
    (seldon_deployment.proto:99-109)
  * typed ``Parameter{name, value, type}`` (seldon_deployment.proto:111-125),
    parsed identically to the python wrapper (wrappers/python/microservice.py:122-136)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterator, List, Mapping, Optional

__all__ = [
    "GraphSpecError",
    "UnitType",
    "UnitImplementation",
    "UnitMethod",
    "EndpointType",
    "Endpoint",
    "Parameter",
    "PredictiveUnit",
    "ComponentBinding",
    "PredictorSpec",
    "SeldonDeploymentSpec",
]


class GraphSpecError(ValueError):
    """Invalid graph/deployment spec (the reference's SeldonDeploymentException).

    ``http_code`` lets the serving edge map it to a FAILURE status without
    special-casing (same contract as messages.SeldonMessageError)."""

    http_code = 400


class UnitType(Enum):
    UNKNOWN_TYPE = "UNKNOWN_TYPE"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    MODEL = "MODEL"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"


class UnitImplementation(Enum):
    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"


class UnitMethod(Enum):
    TRANSFORM_INPUT = "TRANSFORM_INPUT"
    TRANSFORM_OUTPUT = "TRANSFORM_OUTPUT"
    ROUTE = "ROUTE"
    AGGREGATE = "AGGREGATE"
    SEND_FEEDBACK = "SEND_FEEDBACK"


class EndpointType(Enum):
    REST = "REST"
    GRPC = "GRPC"


@dataclass
class Endpoint:
    service_host: str = ""
    service_port: int = 0
    type: EndpointType = EndpointType.REST

    def to_json_dict(self) -> dict:
        out: dict = {"type": self.type.value}
        if self.service_host:
            out["service_host"] = self.service_host
        if self.service_port:
            out["service_port"] = self.service_port
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Endpoint":
        return Endpoint(
            service_host=str(d.get("service_host", "") or ""),
            service_port=int(d.get("service_port", 0) or 0),
            type=EndpointType(str(d.get("type", "REST") or "REST")),
        )


_PARAM_CASTS = {
    "INT": int,
    "FLOAT": float,
    "DOUBLE": float,
    "STRING": str,
    "BOOL": lambda v: str(v).lower() in ("true", "1"),
}


@dataclass
class Parameter:
    """Typed unit parameter; ``value`` is a string on the wire, cast on read
    (wrappers/python/microservice.py:122-136)."""

    name: str
    value: str
    type: str = "STRING"  # INT | FLOAT | DOUBLE | STRING | BOOL

    def typed_value(self):
        try:
            return _PARAM_CASTS[self.type](self.value)
        except KeyError as e:
            raise GraphSpecError(f"unknown parameter type {self.type!r}") from e
        except (TypeError, ValueError) as e:
            raise GraphSpecError(
                f"parameter {self.name!r}: cannot cast {self.value!r} to {self.type}"
            ) from e

    def to_json_dict(self) -> dict:
        return {"name": self.name, "value": str(self.value), "type": self.type}

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Parameter":
        if "name" not in d:
            raise GraphSpecError("parameter missing 'name'")
        return Parameter(
            name=str(d["name"]),
            value=str(d.get("value", "")),
            type=str(d.get("type", "STRING") or "STRING"),
        )


def params_to_kwargs(params: List[Parameter]) -> dict:
    """Typed parameters -> constructor kwargs for a unit implementation."""
    return {p.name: p.typed_value() for p in params}


@dataclass
class PredictiveUnit:
    """One node of the inference graph (seldon_deployment.proto:90-97).

    Degradation extensions of the JAX package's resilience layer (parsed
    and validated here; the port's executors honour them once routers and
    combiners with quorum are ported):

    * ``quorum`` (COMBINER/AGGREGATE nodes): aggregate over the children
      that answered when at least ``quorum`` of them succeed, instead of
      failing the whole request on the first child error; dropped branches
      are annotated into ``meta.tags``.
    * ``fallback`` (ROUTER nodes): child index served when the routed
      branch's call fails or its circuit breaker is open.
    """

    name: str
    children: List["PredictiveUnit"] = field(default_factory=list)
    type: Optional[UnitType] = None
    implementation: UnitImplementation = UnitImplementation.UNKNOWN_IMPLEMENTATION
    methods: Optional[List[UnitMethod]] = None
    endpoint: Optional[Endpoint] = None
    parameters: List[Parameter] = field(default_factory=list)
    quorum: Optional[int] = None
    fallback: Optional[int] = None

    # -- traversal ----------------------------------------------------------

    def walk(self) -> Iterator["PredictiveUnit"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> Optional["PredictiveUnit"]:
        for u in self.walk():
            if u.name == name:
                return u
        return None

    # -- codecs -------------------------------------------------------------

    def to_json_dict(self) -> dict:
        out: dict = {"name": self.name}
        if self.children:
            out["children"] = [c.to_json_dict() for c in self.children]
        if self.type is not None:
            out["type"] = self.type.value
        if self.implementation is not UnitImplementation.UNKNOWN_IMPLEMENTATION:
            out["implementation"] = self.implementation.value
        if self.methods is not None:
            out["methods"] = [m.value for m in self.methods]
        if self.endpoint is not None:
            out["endpoint"] = self.endpoint.to_json_dict()
        if self.parameters:
            out["parameters"] = [p.to_json_dict() for p in self.parameters]
        if self.quorum is not None:
            out["quorum"] = int(self.quorum)
        if self.fallback is not None:
            out["fallback"] = int(self.fallback)
        return out

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "PredictiveUnit":
        if not isinstance(d, Mapping) or "name" not in d:
            raise GraphSpecError("graph node missing 'name'")
        try:
            unit_type = UnitType(d["type"]) if "type" in d else None
            impl = (
                UnitImplementation(d["implementation"])
                if "implementation" in d
                else UnitImplementation.UNKNOWN_IMPLEMENTATION
            )
            methods = (
                [UnitMethod(m) for m in d["methods"]] if "methods" in d else None
            )
            quorum = int(d["quorum"]) if d.get("quorum") is not None else None
            fallback = (
                int(d["fallback"]) if d.get("fallback") is not None else None
            )
        except (ValueError, TypeError) as e:
            raise GraphSpecError(f"graph node {d['name']!r}: {e}") from e
        return PredictiveUnit(
            name=str(d["name"]),
            children=[PredictiveUnit.from_json_dict(c) for c in d.get("children", []) or []],
            type=unit_type,
            implementation=impl,
            methods=methods,
            endpoint=Endpoint.from_json_dict(d["endpoint"]) if d.get("endpoint") else None,
            parameters=[Parameter.from_json_dict(p) for p in d.get("parameters", []) or []],
            quorum=quorum,
            fallback=fallback,
        )


@dataclass
class ComponentBinding:
    """What the reference calls a *container* (one microservice image per graph
    node, seldon_deployment.proto:55-58 componentSpecs): here, the runtime
    binding of a graph node.  Three runtimes:

    * ``inprocess`` — node is a registered/importable unit class whose
      methods take torch tensors; the engine runs it in its own process.
      ``class_path`` is ``module:Class`` or a name registered in the unit
      registry.
    * ``rest`` / ``grpc`` — node is a remote microservice, reference-style;
      ``host``/``port`` filled by defaulting.

    ``device`` is parsed and kept so the JSON round-trips unchanged; the
    port places every unit on the engine's device.  ``mesh_axes`` builds a
    device mesh on the engine's platform for a unit that takes one
    (``graph/units.py`` ``instantiate_bound_unit``).
    """

    name: str
    runtime: str = "inprocess"  # inprocess | rest | grpc
    class_path: str = ""
    image: str = ""
    device: str = "tpu"
    mesh_axes: Optional[dict] = None
    parameters: List[Parameter] = field(default_factory=list)
    env: dict = field(default_factory=dict)
    host: str = ""
    port: int = 0

    def to_json_dict(self) -> dict:
        out: dict = {"name": self.name, "runtime": self.runtime}
        for k in ("class_path", "image", "device", "host"):
            if getattr(self, k):
                out[k] = getattr(self, k)
        if self.mesh_axes:
            out["mesh_axes"] = dict(self.mesh_axes)
        if self.parameters:
            out["parameters"] = [p.to_json_dict() for p in self.parameters]
        if self.env:
            out["env"] = dict(self.env)
        if self.port:
            out["port"] = self.port
        return out

    @staticmethod
    def from_container_json(d: Mapping[str, Any]) -> "ComponentBinding":
        """Parse either a reference k8s container entry ({name, image, ...})
        or an in-process binding ({name, runtime, class_path, device, ...})."""
        if "name" not in d:
            raise GraphSpecError("component/container missing 'name'")
        runtime = str(d.get("runtime", "") or "")
        if not runtime:
            # reference-style container: remote REST microservice by default
            runtime = "inprocess" if d.get("class_path") else "rest"
        if runtime not in ("inprocess", "rest", "grpc"):
            raise GraphSpecError(f"unknown runtime {runtime!r} for {d['name']!r}")
        return ComponentBinding(
            name=str(d["name"]),
            runtime=runtime,
            class_path=str(d.get("class_path", "") or ""),
            image=str(d.get("image", "") or ""),
            device=str(d.get("device", "tpu") or "tpu"),
            mesh_axes=dict(d["mesh_axes"]) if d.get("mesh_axes") else None,
            parameters=[Parameter.from_json_dict(p) for p in d.get("parameters", []) or []],
            env={str(e["name"]): str(e.get("value", "")) for e in d.get("env", []) or []}
            if isinstance(d.get("env"), list)
            else dict(d.get("env", {}) or {}),
            host=str(d.get("host", "") or ""),
            port=int(d.get("port", 0) or 0),
        )


@dataclass
class PredictorSpec:
    """One predictor = one servable instance of the graph
    (seldon_deployment.proto:44-53).  Canary/AB setups deploy several
    predictors with different replica weights."""

    name: str
    graph: PredictiveUnit
    components: List[ComponentBinding] = field(default_factory=list)
    replicas: int = 1
    annotations: dict = field(default_factory=dict)
    labels: dict = field(default_factory=dict)

    def component_map(self) -> dict:
        return {c.name: c for c in self.components}

    def to_json_dict(self) -> dict:
        return {
            "name": self.name,
            "graph": self.graph.to_json_dict(),
            "componentSpecs": [
                {"spec": {"containers": [c.to_json_dict() for c in self.components]}}
            ]
            if self.components
            else [],
            "replicas": self.replicas,
            "annotations": dict(self.annotations),
            "labels": dict(self.labels),
        }

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "PredictorSpec":
        if "name" not in d or "graph" not in d:
            raise GraphSpecError("predictor needs 'name' and 'graph'")
        components: List[ComponentBinding] = []
        # reference layout: componentSpecs[].spec.containers[]
        for cs in d.get("componentSpecs", []) or []:
            containers = (cs.get("spec", {}) or {}).get("containers", []) or []
            for c in containers:
                components.append(ComponentBinding.from_container_json(c))
        # the JAX package's shorthand: components[]
        for c in d.get("components", []) or []:
            components.append(ComponentBinding.from_container_json(c))
        return PredictorSpec(
            name=str(d["name"]),
            graph=PredictiveUnit.from_json_dict(d["graph"]),
            components=components,
            replicas=int(d.get("replicas", 1) or 1),
            annotations=dict(d.get("annotations", {}) or {}),
            labels=dict(d.get("labels", {}) or {}),
        )


@dataclass
class SeldonDeploymentSpec:
    """The full deployment resource (metadata + spec.predictors[])."""

    name: str  # spec.name — the per-deployment service name
    metadata_name: str = ""  # metadata.name — the resource name
    predictors: List[PredictorSpec] = field(default_factory=list)
    annotations: dict = field(default_factory=dict)
    oauth_key: str = ""
    oauth_secret: str = ""
    labels: dict = field(default_factory=dict)
    api_version: str = "machinelearning.seldon.io/v1alpha2"

    def predictor(self, name: Optional[str] = None) -> PredictorSpec:
        if name is None:
            if not self.predictors:
                raise GraphSpecError("deployment has no predictors")
            return self.predictors[0]
        for p in self.predictors:
            if p.name == name:
                return p
        raise GraphSpecError(f"no predictor named {name!r}")

    def to_json_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": "SeldonDeployment",
            "metadata": {"name": self.metadata_name or self.name, "labels": dict(self.labels)},
            "spec": {
                "name": self.name,
                "annotations": dict(self.annotations),
                "oauth_key": self.oauth_key,
                "oauth_secret": self.oauth_secret,
                "predictors": [p.to_json_dict() for p in self.predictors],
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), separators=(",", ":"))

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "SeldonDeploymentSpec":
        if not isinstance(d, Mapping):
            raise GraphSpecError("deployment JSON must be an object")
        spec = d.get("spec") if d.get("spec") is not None else d  # bare spec ok
        if not isinstance(spec, Mapping) or "predictors" not in spec:
            raise GraphSpecError("deployment spec missing 'predictors'")
        meta = d.get("metadata", {}) or {}
        # annotations live in BOTH standard places: metadata.annotations is
        # where `kubectl annotate` writes; spec.annotations is the
        # reference's location.  Merge, spec-level winning on conflict
        # (more specific to this framework's schema).
        annotations = dict(meta.get("annotations", {}) or {})
        annotations.update(dict(spec.get("annotations", {}) or {}))
        return SeldonDeploymentSpec(
            name=str(spec.get("name", meta.get("name", "")) or ""),
            metadata_name=str(meta.get("name", "") or ""),
            predictors=[PredictorSpec.from_json_dict(p) for p in spec["predictors"]],
            annotations=annotations,
            oauth_key=str(spec.get("oauth_key", "") or ""),
            oauth_secret=str(spec.get("oauth_secret", "") or ""),
            labels=dict(meta.get("labels", {}) or {}),
        )

    @staticmethod
    def from_json(s) -> "SeldonDeploymentSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise GraphSpecError(f"invalid JSON: {e}") from e
        return SeldonDeploymentSpec.from_json_dict(d)
