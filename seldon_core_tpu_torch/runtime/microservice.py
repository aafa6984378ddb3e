"""Unit microservice — serve one unit as a remote graph node; the port's
counterpart of ``seldon_core_tpu/runtime/microservice.py``.

    python -m seldon_core_tpu_torch.runtime.microservice MnistClassifier REST \\
        --port 9000 --parameters '[{"name":"seed","value":"3","type":"INT"}]'

serves the internal microservice API (``/predict``, ``/transform-input``,
``/transform-output``, ``/route``, ``/aggregate``, ``/send-feedback``,
``runtime/rest.py``; JSON, or a binary tensor frame where one message is
the body) on the port's stdlib HTTP server, on ``cuda`` unless ``--device
cpu`` is given (CUDA asked for and absent is an error).  An engine binds it
as a component ``{"name": ..., "runtime": "rest", "host": ..., "port":
...}``.  With ``GRPC`` in place of ``REST`` the unit's node services
(Generic, Model, Router, Transformer, OutputTransformer, Combiner: the map
of the reference's ``make_unit_grpc_server``) are served on the port's own
HTTP/2 lane (``runtime/grpcfast.py`` ``FastGrpcServer.for_unit``; no
``grpcio``), bound as ``{"runtime": "grpc", ...}``.

Env contract (injected by defaulting, ``graph/defaulting.py``):
``PREDICTIVE_UNIT_SERVICE_PORT`` (default 5000), ``PREDICTIVE_UNIT_PARAMETERS``
(a JSON list of typed parameters), ``PREDICTIVE_UNIT_ID``.  With
``MICROSERVICE_SMOKE_EXIT`` set, ``main`` builds the unit (import, init and,
for a kernel unit on the card, its kernel's probe), says ``smoke ok`` and
exits 0 without binding the port.

Two kinds of class are served: a port ``Unit``, or a reference-style plain
object (``predict(X, feature_names)``, ``route``, ``aggregate``,
``transform_input`` / ``transform_output``, ``send_feedback``, ``score`` for
an OUTLIER_DETECTOR) behind ``UserObjectUnit``, which hands it numpy rows.
With ``--persistence 1`` (REST or GRPC, as the reference's
``microservice.py:211-221`` and ``grpc_server.py:340-344`` wire it) the
unit's state is restored from its checkpoint at boot and saved every
``PERSISTENCE_FREQUENCY`` seconds (``runtime/persistence.py``:
``SELDON_TPU_STATE_DIR``, ``SELDON_DEPLOYMENT_ID``, ``PREDICTOR_ID``).

Observability: a REST unit also answers ``GET /stats`` (with the flight
recorder's snapshot), ``/perf``, ``/overhead``, ``/quality`` (the unit's
own drift window: each ``predict`` records one, ``rest.py:564-573`` there),
``POST /quality/reference``, ``/autopilot`` (the per-key model that the
unit's own dispatches train, ``rest.py:587-598`` there), ``/trace`` and
``/trace/export``, and each call
runs in a ``server`` span of the node's name, the caller's child through
its ``traceparent`` (``SELDON_TPU_TRACE=1`` turns tracing on), with the
caller's ``Seldon-Tenant`` / ``Seldon-Tier`` bound.  A gRPC unit takes the
``traceparent``, ``seldon-tenant`` and ``seldon-tier`` metadata the same
way, and with ``--http-port N`` (or ``PREDICTIVE_UNIT_HTTP_PORT``) serves
those routes over HTTP on port N too, so its ``/stats`` states its kernel
launches and its ``/trace`` its spans.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import json
import os
import signal
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device
from seldon_core_tpu_torch.graph.interpreter import InProcessNodeRuntime
from seldon_core_tpu_torch.graph.spec import Parameter, PredictiveUnit, UnitType, params_to_kwargs
from seldon_core_tpu_torch.graph.units import (
    Unit,
    UnitAux,
    resolve_unit_class,
    speaks_unit_protocol,
)

__all__ = ["UserObjectUnit", "as_unit", "build_unit", "build_runtime", "main"]

SERVICE_TYPES = ("MODEL", "ROUTER", "TRANSFORMER", "COMBINER", "OUTLIER_DETECTOR")

_SERVICE_UNIT_TYPE = {
    "MODEL": UnitType.MODEL,
    "ROUTER": UnitType.ROUTER,
    "TRANSFORMER": UnitType.TRANSFORMER,
    "COMBINER": UnitType.COMBINER,
    "OUTLIER_DETECTOR": UnitType.TRANSFORMER,
}


def _host(X):
    """Rows as numpy, read back from the device when they are a tensor; a
    read-only array (a binary frame's view over its bytes) is copied, since
    user code may write into what it is given."""
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy()
    X = np.asarray(X)
    return X if X.flags.writeable else X.copy()


class UserObjectUnit(Unit):
    """Gives a reference-style user object the Unit protocol; the object
    gets numpy rows and its answers stay numpy."""

    pure = False  # arbitrary Python: the host interpreter only
    accepts_names = True

    def __init__(self, user_object: Any, service_type: str = "MODEL"):
        self.user = user_object
        self.service_type = service_type
        self.class_names = list(getattr(user_object, "class_names", None) or []) or None

    # NB: every method takes the extra `names` argument (accepts_names)

    def predict(self, state, X, names):
        return np.asarray(self.user.predict(_host(X), names))

    def transform_input(self, state, X, names):
        if self.service_type == "OUTLIER_DETECTOR" or (
                hasattr(self.user, "score") and not hasattr(self.user, "transform_input")
                and not hasattr(self.user, "predict")):
            # score and tag, pass the data through
            # (outlier_detector_microservice.py:36-56); the duck check fires
            # only for a pure scorer, never for an sklearn-style score(X, y)
            scores = np.asarray(self.user.score(_host(X), names))
            return _host(X), UnitAux(tags={"outlierScore": scores})
        if hasattr(self.user, "transform_input"):
            return np.asarray(self.user.transform_input(_host(X), names))
        # the reference's transformer falls back to predict
        return np.asarray(self.user.predict(_host(X), names))

    def transform_output(self, state, X, names):
        return np.asarray(self.user.transform_output(_host(X), names))

    def route(self, state, X, names):
        return int(self.user.route(_host(X), names))

    def aggregate(self, state, Ys, names_list):
        return np.asarray(self.user.aggregate([_host(y) for y in Ys], names_list))

    def send_feedback(self, state, X, branch, reward, truth, names):
        if hasattr(self.user, "send_feedback"):
            X_np = _host(X) if X is not None else None
            truth_np = _host(truth) if truth is not None else None
            if self.service_type == "ROUTER":
                # the reference's router gets the routed branch
                # (router_microservice.py:93-125)
                self.user.send_feedback(X_np, names, int(branch), reward, truth_np)
            else:
                self.user.send_feedback(X_np, names, reward, truth_np)
        return state


def as_unit(obj: Any, service_type: str = "MODEL") -> Unit:
    """A Unit (or an object declaring the protocol's ``pure`` marker) as it
    is; any other object behind ``UserObjectUnit``.  The one wrap policy of
    the microservice and of in-process bindings."""
    if speaks_unit_protocol(obj):
        return obj
    return UserObjectUnit(obj, service_type)


def build_unit(user_class, parameters: List[Parameter], service_type: str,
               device: Optional[torch.device] = None, mesh=None) -> Unit:
    """The class built from typed parameters (and ``device``, when its
    constructor takes one, so it can choose its kernel path at
    construction from static shapes; and ``mesh``, a binding's device
    mesh, for a unit that takes one), as a Unit."""
    kwargs = params_to_kwargs(parameters)
    if device is not None and "device" in inspect.signature(user_class.__init__).parameters:
        kwargs["device"] = device
    if mesh is not None:
        kwargs["mesh"] = mesh
    return as_unit(user_class(**kwargs), service_type)


def build_runtime(class_path: str, service_type: str = "MODEL",
                  parameters: Optional[List[Parameter]] = None, unit_name: Optional[str] = None,
                  rng=None, device: DeviceLike = None,
                  executor: Optional[ThreadPoolExecutor] = None) -> InProcessNodeRuntime:
    """Load a unit class (a registered name or ``module:Class``) and wrap it
    as a servable node runtime on ``device`` (default ``cuda``)."""
    if service_type not in SERVICE_TYPES:
        raise ValueError(f"unknown service type {service_type!r}")
    device = resolve_device(device)
    cls = resolve_unit_class(class_path)
    unit = build_unit(cls, parameters or _env_parameters(), service_type, device)
    node = PredictiveUnit(name=unit_name or os.environ.get("PREDICTIVE_UNIT_ID", class_path),
                          type=_SERVICE_UNIT_TYPE[service_type])
    return InProcessNodeRuntime(node, unit, rng, device=device, executor=executor)


def _env_parameters() -> List[Parameter]:
    raw = os.environ.get("PREDICTIVE_UNIT_PARAMETERS", "[]")
    try:
        return [Parameter.from_json_dict(p) for p in json.loads(raw)]
    except (json.JSONDecodeError, TypeError) as e:
        raise ValueError(f"bad PREDICTIVE_UNIT_PARAMETERS: {e}") from e


async def _serve(runtime: InProcessNodeRuntime, host: str, port: int, api: str = "REST",
                 http_port: Optional[int] = None, persistence: int = 0) -> None:
    """Serve over ``api`` (REST or GRPC) until SIGTERM or SIGINT; a gRPC
    unit with ``http_port`` also serves its HTTP routes there.  With
    ``persistence`` the state is restored first and checkpointed in the
    background while serving."""
    side = None
    saver = None
    if persistence:
        from seldon_core_tpu_torch.runtime.persistence import persist_loop, restore_runtime

        restore_runtime(runtime)
        saver = asyncio.get_running_loop().create_task(persist_loop(runtime))
    if api == "GRPC":
        from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcServer

        server = FastGrpcServer.for_unit(runtime)
        await server.start(host, port)
        if http_port:
            from seldon_core_tpu_torch.runtime.rest import serve_unit

            side = await serve_unit(runtime, host, http_port)
    else:
        from seldon_core_tpu_torch.runtime.rest import serve_unit

        server = await serve_unit(runtime, host, port)
    print(f"unit up: {runtime.node.name} ({type(runtime.unit).__name__}) "
          f"device={runtime.device} {api.lower()}=:{server.port}"
          + (f" http=:{side.port}" if side is not None else ""), flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass  # platforms without signal support: external kill only
    await stop.wait()
    if saver is not None:
        saver.cancel()
    await server.stop()
    if side is not None:
        await side.stop()
    from seldon_core_tpu_torch.ops import fused_mlp

    # a gRPC unit has no /stats: its kernel's launches are said here
    print(f"unit stopped (fused_mlp_softmax launches: {fused_mlp.LAUNCHES})", flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="seldon_core_tpu_torch unit microservice")
    parser.add_argument("interface_name", help="module:Class or registered unit name")
    parser.add_argument("api", nargs="?", default="REST", choices=["REST", "GRPC"])
    parser.add_argument("--service-type", default="MODEL", choices=SERVICE_TYPES)
    parser.add_argument("--parameters", default=None, help="JSON typed parameter list")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--persistence", type=int, default=0,
                        help="1: restore the unit's state at boot and checkpoint it every "
                             "PERSISTENCE_FREQUENCY seconds")
    parser.add_argument("--http-port", type=int, default=None,
                        help="GRPC: also serve /stats /perf /overhead /quality /autopilot /trace "
                             "on this port")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card is an error")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"microservice: {e}\n")
    params = ([Parameter.from_json_dict(p) for p in json.loads(args.parameters)]
              if args.parameters else _env_parameters())
    port = args.port or int(os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", "5000"))
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="unit-dispatch")
    runtime = build_runtime(args.interface_name, args.service_type, params, device=device,
                            executor=pool)
    try:
        if os.environ.get("MICROSERVICE_SMOKE_EXIT"):
            # the image-build smoke contract: the unit imports, builds and (a
            # kernel unit on the card) probes its kernel; the port stays unbound
            print(f"smoke ok: {args.interface_name} as {args.service_type} on {device}",
                  flush=True)
            return
        http_port = args.http_port or int(os.environ.get("PREDICTIVE_UNIT_HTTP_PORT", "0") or 0)
        asyncio.run(_serve(runtime, args.host, port, args.api, http_port or None,
                           persistence=args.persistence))
    finally:
        pool.shutdown(wait=True)


if __name__ == "__main__":
    main()
