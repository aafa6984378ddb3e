"""Protobuf bytes <-> dataclass conversion for the deployment resource; the
port's copy of ``seldon_core_tpu/deployproto.py``.

The JSON form (graph/spec.py) is canonical; this gives gRPC control-plane
clients a typed contract (proto/seldon_deployment.proto, mirroring the
reference CRD schema reference proto/seldon_deployment.proto:10-125 with
accelerator-native ComponentBindings in place of embedded k8s
PodTemplateSpecs).  The port writes and reads the message's bytes itself,
with ``protoconv``'s wire helpers and that file's field numbers: no
generated code and no protobuf runtime.  ``deployment_to_proto`` returns the
serialized ``SeldonDeployment``; ``deployment_from_proto`` takes those bytes."""

from __future__ import annotations

from typing import List

from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    Endpoint,
    EndpointType,
    Parameter,
    PredictiveUnit,
    PredictorSpec,
    SeldonDeploymentSpec,
    UnitImplementation,
    UnitMethod,
    UnitType,
)
from seldon_core_tpu_torch.native.protowire import read_varint
from seldon_core_tpu_torch.protoconv import (
    ProtoDecodeError,
    _Merged,
    _int32,
    _int_varint,
    _len,
    _str,
    _tag,
)

__all__ = ["deployment_to_proto", "deployment_from_proto"]

# the enums of proto/seldon_deployment.proto, in declaration order
_RUNTIMES = ["inprocess", "rest", "grpc"]                       # ComponentBinding.Runtime
_UNIT_TYPES = ["UNKNOWN_TYPE", "ROUTER", "COMBINER", "MODEL", "TRANSFORMER",
               "OUTPUT_TRANSFORMER"]                            # PredictiveUnitType
_IMPLEMENTATIONS = ["UNKNOWN_IMPLEMENTATION", "SIMPLE_MODEL", "SIMPLE_ROUTER",
                    "RANDOM_ABTEST", "AVERAGE_COMBINER"]        # PredictiveUnitImplementation
_METHODS = ["TRANSFORM_INPUT", "TRANSFORM_OUTPUT", "ROUTE", "AGGREGATE",
            "SEND_FEEDBACK"]                                    # PredictiveUnitMethod
_ENDPOINT_TYPES = ["REST", "GRPC"]                              # Endpoint.EndpointType
_PARM_TYPES = ["INT", "FLOAT", "DOUBLE", "STRING", "BOOL"]      # Parameter.ParmType


def _enum(field: int, index: int) -> bytes:
    """A singular enum or int32 field; the zero value is not written."""
    return _tag(field, 0) + _int_varint(index) if index else b""


def _name(names: List[str], index: int, what: str) -> str:
    if not 0 <= index < len(names):
        raise ProtoDecodeError(f"unknown {what} enum value {index}")
    return names[index]


def _string_map(field: int, d: dict) -> bytes:
    return b"".join(_len(field, _str(1, str(k)) + _str(2, str(v))) for k, v in d.items())


def _string_map_from(entries: List[bytes]) -> dict:
    out = {}
    for raw in entries:
        m = _Merged(raw)
        out[m.string(1)] = m.string(2)
    return out


# -- writing ------------------------------------------------------------------


def _param_to_proto(p: Parameter) -> bytes:
    return _str(1, p.name) + _str(2, str(p.value)) + _enum(3, _PARM_TYPES.index(p.type))


def _unit_to_proto(u: PredictiveUnit) -> bytes:
    out = _str(1, u.name)
    for c in u.children:
        out += _len(2, _unit_to_proto(c))
    if u.type is not None:
        out += _enum(3, _UNIT_TYPES.index(u.type.value))
    out += _enum(4, _IMPLEMENTATIONS.index(u.implementation.value))
    if u.methods:  # a repeated enum: packed, as proto3 writes it
        out += _len(5, b"".join(_int_varint(_METHODS.index(m.value)) for m in u.methods))
    if u.endpoint is not None:
        ep = u.endpoint
        out += _len(6, _str(1, ep.service_host) + _enum(2, ep.service_port)
                    + _enum(3, _ENDPOINT_TYPES.index(ep.type.value)))
    for p in u.parameters:
        out += _len(7, _param_to_proto(p))
    return out


def _binding_to_proto(c: ComponentBinding) -> bytes:
    out = (_str(1, c.name) + _enum(2, _RUNTIMES.index(c.runtime)) + _str(3, c.class_path)
           + _str(4, c.image) + _str(5, c.device))
    for k, v in (c.mesh_axes or {}).items():
        out += _len(6, _str(1, str(k)) + _enum(2, int(v)))
    for p in c.parameters:
        out += _len(7, _param_to_proto(p))
    out += _string_map(8, c.env)
    return out + _str(9, c.host) + _enum(10, c.port)


def _predictor_to_proto(p: PredictorSpec) -> bytes:
    out = _str(1, p.name) + _len(2, _unit_to_proto(p.graph))
    for c in p.components:
        out += _len(3, _binding_to_proto(c))
    return (out + _enum(4, p.replicas) + _string_map(5, p.annotations)
            + _string_map(6, p.labels))


def deployment_to_proto(spec: SeldonDeploymentSpec) -> bytes:
    """The serialized ``seldon.protos.SeldonDeployment`` of ``spec``."""
    metadata = _str(1, spec.metadata_name or spec.name) + _string_map(2, spec.labels)
    body = _str(1, spec.name)
    for p in spec.predictors:
        body += _len(2, _predictor_to_proto(p))
    body += _string_map(3, spec.annotations) + _str(4, spec.oauth_key) + _str(5, spec.oauth_secret)
    return (_str(1, spec.api_version) + _str(2, "SeldonDeployment") + _len(3, metadata)
            + _len(4, body))


# -- reading ------------------------------------------------------------------


def _param_from_proto(raw: bytes) -> Parameter:
    m = _Merged(raw)
    return Parameter(name=m.string(1), value=m.string(2),
                     type=_name(_PARM_TYPES, m.varint(3), "ParmType"))


def _methods_from(m: _Merged) -> List[UnitMethod]:
    """Field 5, packed (as proto3 writes it) or one varint an element."""
    out: List[int] = []
    for wt, v in m.all.get(5, ()):
        if wt == 0:
            out.append(v)
        elif wt == 2:
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(x)
    return [UnitMethod(_name(_METHODS, i, "PredictiveUnitMethod")) for i in out]


def _unit_from_proto(raw: bytes) -> PredictiveUnit:
    m = _Merged(raw)
    # proto3 scalar defaults are indistinguishable from unset; treat type 0
    # (UNKNOWN_TYPE) as "not given" the way the JSON codec omits the key
    unit_type = None
    if m.varint(3):
        unit_type = UnitType(_name(_UNIT_TYPES, m.varint(3), "PredictiveUnitType"))
    methods = _methods_from(m) or None
    endpoint = None
    ep_raw = m.message(6)
    if ep_raw is not None:
        e = _Merged(ep_raw)
        endpoint = Endpoint(
            service_host=e.string(1),
            service_port=_int32(e.varint(2)),
            type=EndpointType(_name(_ENDPOINT_TYPES, e.varint(3), "EndpointType")),
        )
    return PredictiveUnit(
        name=m.string(1),
        children=[_unit_from_proto(c) for c in m.entries(2)],
        type=unit_type,
        implementation=UnitImplementation(
            _name(_IMPLEMENTATIONS, m.varint(4), "PredictiveUnitImplementation")),
        methods=methods,
        endpoint=endpoint,
        parameters=[_param_from_proto(p) for p in m.entries(7)],
    )


def _binding_from_proto(raw: bytes) -> ComponentBinding:
    m = _Merged(raw)
    mesh = {}
    for entry in m.entries(6):
        e = _Merged(entry)
        mesh[e.string(1)] = _int32(e.varint(2))
    return ComponentBinding(
        name=m.string(1),
        runtime=_name(_RUNTIMES, m.varint(2), "Runtime"),
        class_path=m.string(3),
        image=m.string(4),
        device=m.string(5) or "tpu",
        mesh_axes=mesh or None,
        parameters=[_param_from_proto(p) for p in m.entries(7)],
        env=_string_map_from(m.entries(8)),
        host=m.string(9),
        port=_int32(m.varint(10)),
    )


def deployment_from_proto(wire: bytes) -> SeldonDeploymentSpec:
    """``spec`` back from the serialized ``seldon.protos.SeldonDeployment``."""
    d = _Merged(wire)
    md = _Merged(d.message(3) or b"")
    sp = _Merged(d.message(4) or b"")
    predictors = []
    for raw in sp.entries(2):
        p = _Merged(raw)
        predictors.append(PredictorSpec(
            name=p.string(1),
            graph=_unit_from_proto(p.message(2) or b""),
            components=[_binding_from_proto(c) for c in p.entries(3)],
            replicas=_int32(p.varint(4)) or 1,
            annotations=_string_map_from(p.entries(5)),
            labels=_string_map_from(p.entries(6)),
        ))
    return SeldonDeploymentSpec(
        name=sp.string(1) or md.string(1),
        metadata_name=md.string(1),
        predictors=predictors,
        annotations=_string_map_from(sp.entries(3)),
        oauth_key=sp.string(4),
        oauth_secret=sp.string(5),
        labels=_string_map_from(md.entries(2)),
        api_version=d.string(1) or "machinelearning.seldon.io/v1alpha2",
    )
