"""Engine process entry point — the port's counterpart of
``seldon_core_tpu/runtime/engine_main.py``.

Config resolution order (engine EnginePredictor.java:56-150):

  1. ``ENGINE_PREDICTOR``          base64(JSON PredictorSpec)
  2. ``ENGINE_SELDON_DEPLOYMENT``  base64(JSON SeldonDeployment)
  3. ``--file`` (else ``./deploymentdef.json``)
  4. the default SIMPLE_MODEL stub graph

The engine picks its mode from the spec (``runtime/engine.py``): a spec
whose nodes include REST bindings (``{"runtime": "rest", "host": ...,
"port": ...}``, e.g. in ``ENGINE_PREDICTOR``) serves in host mode, each
remote node through a pooled client.

Env knobs, as in the JAX package: ``ENGINE_SERVER_PORT`` (8000),
``ENGINE_MAX_BATCH`` (1024), ``ENGINE_BATCH_WAIT_MS`` (2.0),
``ENGINE_PIPELINE_DEPTH`` (8), ``ENGINE_DISPATCH_TIMEOUT_S`` (30) and
``ENGINE_SHUTDOWN_DRAIN_S`` (20).  ``ENGINE_PREWARM_WIDTHS`` (comma-separated
feature widths, e.g. ``784``) runs every batch bucket of those widths
before the server binds (``EngineService.prewarm``; ``engine_main.py:120-131``
there), with the reference's "prewarmed ..." line.  ``SELDON_TPU_CORPUS_DIR``
names the perf corpus's directory, which warms the autopilot at start
(``utils/perfcorpus.py``).  ``--device`` picks the device: ``cuda``
by default; asking for CUDA without it exits with an error.  SIGTERM or
SIGINT flips readiness to 503 and drains before exit; a second signal
skips the drain.

The data plane's lanes (``engine_main.py:99``, ``:133-228`` there):

* REST on ``ENGINE_SERVER_PORT`` (JSON and the binary tensor wire), by
  ``ENGINE_HTTP_IMPL``: ``native`` (the default: the C++ data plane,
  ``runtime/nativeplane.py``; when the plane is unavailable or the graph
  is ineligible, a line says why and ``fast`` serves), ``fast`` (the
  Python lane, ``runtime/rest.py``) or ``aiohttp`` (refused: the port
  leans on no ``aiohttp``); another name serves ``fast`` with a line
  saying so;
* gRPC on ``ENGINE_SERVER_GRPC_PORT`` (5001), by ``ENGINE_GRPC_IMPL``
  (default ``native`` when the HTTP lane is native, else ``fast``):
  ``native`` rides the plane's h2 lane, ``fast`` is the stdlib HTTP/2 lane
  (``runtime/grpcfast.py``), ``aio`` (the stock ``grpcio`` server) is
  refused; ``native`` without a plane says so and serves ``fast``, as
  does another name;
* the relay (``runtime/udsrelay.py``) on ``ENGINE_UDS_PATH`` /
  ``--uds-path``, and the HTTP routes on a unix socket on
  ``ENGINE_HTTP_UDS_PATH`` / ``--http-uds-path`` (the lane a ``unix:``
  node binding dials); ``SELDON_TPU_UDS=0`` skips both.  The same relay on
  a TCP port with ``ENGINE_RELAY_TCP_PORT`` / ``--relay-tcp-port``: the
  lane a decode replica receives KV hand-offs on from another host;
* the generation role, ``--gen-role {unified,prefill,decode}``
  (``ENGINE_GEN_ROLE``, default unified; ``SELDON_TPU_DISAGG=0`` forces
  unified), and a prefill replica's decode peers, ``--decode-peers``
  (``ENGINE_DECODE_PEERS``, comma-separated ``uds:/path`` or
  ``tcp:host:port`` relay specs): ``runtime/servingmesh.py``;
* ``--node NAME`` (``ENGINE_GRAPH_NODE``): serve ONE leaf of the loaded
  deployment's graph as a standalone node engine (``graph/sharding.py``
  ``node_subspec``), the pod-per-node topology: a root engine whose spec
  ``shard_predictor`` rewrote dispatches to it over ``POST /predict``.

The "engine up" line names every lane bound and which serves HTTP
(``http=native`` or ``http=fast``); ``/stats`` has it as
``engine.http_impl``, beside the JSON codec's ``engine.codec``.

    python -m seldon_core_tpu_torch.runtime.engine_main --file examples/mnist_deployment.json
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import signal
from typing import Optional

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.servingmesh import parse_decode_peers

__all__ = ["load_deployment_from_env", "check_http_impl", "check_grpc_impl", "serve", "main"]

DEFAULT_GRAPH = {
    "spec": {
        "name": "default",
        "predictors": [
            {
                "name": "default",
                "graph": {
                    "name": "simple-model",
                    "implementation": "SIMPLE_MODEL",
                    "type": "MODEL",
                },
            }
        ],
    }
}


def load_deployment_from_env(file_path: Optional[str] = None) -> SeldonDeploymentSpec:
    raw = os.environ.get("ENGINE_PREDICTOR")
    if raw:
        predictor = json.loads(base64.b64decode(raw))
        spec = SeldonDeploymentSpec(
            name=os.environ.get("SELDON_DEPLOYMENT_ID", "engine"),
            predictors=[PredictorSpec.from_json_dict(predictor)],
        )
        return default_and_validate(spec)
    raw = os.environ.get("ENGINE_SELDON_DEPLOYMENT")
    if raw:
        return default_and_validate(SeldonDeploymentSpec.from_json(base64.b64decode(raw)))
    path = file_path or "./deploymentdef.json"
    if os.path.exists(path):
        with open(path) as f:
            return default_and_validate(SeldonDeploymentSpec.from_json(f.read()))
    return default_and_validate(SeldonDeploymentSpec.from_json_dict(DEFAULT_GRAPH))


_NO_PLANE_GRPC = "native gRPC lane unavailable (no native plane); serving the Python fast lane"


def check_http_impl() -> str:
    """``ENGINE_HTTP_IMPL`` (default ``native``): ``native`` or ``fast``; an
    unknown name is ``fast`` with a line saying so, and ``aiohttp`` raises
    ``SystemExit`` (it needs ``aiohttp``)."""
    impl = os.environ.get("ENGINE_HTTP_IMPL", "native").strip().lower()
    if impl == "aiohttp":
        raise SystemExit("engine_main: ENGINE_HTTP_IMPL=aiohttp is the aiohttp app, which the "
                         "port does not serve (it leans on no aiohttp); use native or fast")
    if impl not in ("native", "fast"):
        print(f"unknown ENGINE_HTTP_IMPL={impl!r}; serving the Python fast lane", flush=True)
        impl = "fast"
    return impl


def check_grpc_impl(http_impl: str = "fast") -> str:
    """``ENGINE_GRPC_IMPL`` (default ``native`` when the HTTP lane is
    ``native``, else ``fast``): ``native`` or ``fast``.  ``native`` rides
    the plane, so without a native HTTP lane it is ``fast`` with a line
    saying so, as is an unknown name; ``aio`` raises ``SystemExit`` (it
    needs ``grpcio``)."""
    impl = os.environ.get("ENGINE_GRPC_IMPL",
                          "native" if http_impl == "native" else "fast").strip().lower()
    if impl == "aio":
        raise SystemExit("engine_main: ENGINE_GRPC_IMPL=aio is the stock grpcio server, which "
                         "the port does not serve (it leans on no grpcio); use fast")
    if impl not in ("native", "fast"):
        print(f"unknown ENGINE_GRPC_IMPL={impl!r}; serving fast lane", flush=True)
        impl = "fast"
    if impl == "native" and http_impl != "native":
        print(_NO_PLANE_GRPC, flush=True)
        impl = "fast"
    return impl


async def serve(deployment: SeldonDeploymentSpec, predictor_name=None,
                host: str = "0.0.0.0", rest_port: Optional[int] = None,
                device=None, grpc_port: Optional[int] = None,
                uds_path: Optional[str] = None,
                http_uds_path: Optional[str] = None, gen_role: Optional[str] = None,
                decode_peers: Optional[list] = None,
                relay_tcp_port: Optional[int] = None) -> None:
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.runtime.grpcfast import serve_grpc_fast
    from seldon_core_tpu_torch.runtime.rest import serve_fast
    from seldon_core_tpu_torch.runtime.udsrelay import serve_relay_tcp, serve_uds

    http_impl = check_http_impl()
    grpc_impl = check_grpc_impl(http_impl)
    rest_port = rest_port or int(os.environ.get("ENGINE_SERVER_PORT", "8000"))
    grpc_port = grpc_port if grpc_port is not None else int(
        os.environ.get("ENGINE_SERVER_GRPC_PORT", "5001"))
    uds_on = os.environ.get("SELDON_TPU_UDS", "1") != "0"
    uds_path = (uds_path or os.environ.get("ENGINE_UDS_PATH", "").strip()) if uds_on else ""
    http_uds_path = (http_uds_path or os.environ.get("ENGINE_HTTP_UDS_PATH", "").strip()
                     if uds_on else "")
    engine = EngineService(
        deployment,
        predictor_name,
        max_batch=int(os.environ.get("ENGINE_MAX_BATCH", "1024")),
        max_wait_ms=float(os.environ.get("ENGINE_BATCH_WAIT_MS", "2.0")),
        pipeline_depth=int(os.environ.get("ENGINE_PIPELINE_DEPTH", "8")),
        dispatch_timeout_s=float(os.environ.get("ENGINE_DISPATCH_TIMEOUT_S", "30")),
        device=device,
        gen_role=gen_role,
        decode_peers=decode_peers,
    )
    # every batch bucket of these feature widths runs once before the server
    # binds: live traffic never pays a kernel's first use
    prewarm_raw = os.environ.get("ENGINE_PREWARM_WIDTHS", "")
    if prewarm_raw.strip():
        widths = [int(w) for w in prewarm_raw.split(",") if w.strip()]
        t0 = asyncio.get_running_loop().time()
        n = engine.prewarm(widths)
        print(f"prewarmed {n} batch shapes for widths {widths} in "
              f"{asyncio.get_running_loop().time() - t0:.1f}s", flush=True)
    plane = None
    if http_impl == "native":
        from seldon_core_tpu_torch.runtime.nativeplane import serve_native

        try:
            # the C++ listener binds one IPv4 address; 0.0.0.0 is any
            plane = await serve_native(engine, host, rest_port,
                                       grpc_port=grpc_port if grpc_impl == "native" else None)
        except (RuntimeError, OSError) as e:
            print(f"native data plane unavailable ({e}); serving the Python fast lane",
                  flush=True)
            http_impl = "fast"
    if grpc_impl == "native" and plane is None:
        print(_NO_PLANE_GRPC, flush=True)
        grpc_impl = "fast"
    # the plane cannot listen on a unix socket (engine_main.py:220 there):
    # the HTTP routes there are the Python lane's, whichever serves TCP
    if plane is None:
        http_server = await serve_fast(engine, host, rest_port, uds_path=http_uds_path or None)
    elif http_uds_path:
        from seldon_core_tpu_torch.runtime.rest import FastHttpServer

        http_server = FastHttpServer(engine)
        await http_server.start_uds(http_uds_path)
    else:
        http_server = None
    grpc_server = await serve_grpc_fast(engine, host, grpc_port) if grpc_impl == "fast" else None
    uds_server = await serve_uds(engine, uds_path) if uds_path else None
    # the relay on a TCP port: the lane decode replicas take KV hand-offs on
    relay_tcp_port = relay_tcp_port if relay_tcp_port is not None else int(
        os.environ.get("ENGINE_RELAY_TCP_PORT", "0") or 0)
    relay_tcp_server = (await serve_relay_tcp(engine, host, relay_tcp_port)
                        if relay_tcp_port else None)
    print(f"engine up: predictor={engine.predictor.name} mode={engine.mode} "
          f"device={engine.device} http={http_impl} "
          f"rest=:{plane.port if plane is not None else http_server.port} "
          f"grpc=:{plane.grpc_port if grpc_server is None else grpc_server.port} ({grpc_impl}) "
          f"codec={engine.codec}"
          + (f" uds={uds_path}" if uds_server is not None else "")
          + (f" http-uds={http_uds_path}" if http_uds_path else "")
          + (f" relay-tcp=:{relay_tcp_server.port}" if relay_tcp_server is not None else "")
          + f" role={engine.gen_role}", flush=True)

    stop = asyncio.Event()
    hurry = asyncio.Event()  # second signal: skip the drain
    loop = asyncio.get_running_loop()

    def _on_signal():
        if stop.is_set():
            hurry.set()
        else:
            stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, _on_signal)
        except (NotImplementedError, RuntimeError):
            pass  # platforms without signal support: external kill only
    await stop.wait()
    drain_s = float(os.environ.get("ENGINE_SHUTDOWN_DRAIN_S", "20"))
    print(f"engine draining: up to {drain_s:.0f}s (readiness now 503; "
          f"signal again to skip)", flush=True)
    engine.pause()  # /ready -> 503; the load balancer stops routing here
    deadline = loop.time() + drain_s
    while loop.time() < deadline and not hurry.is_set():
        if engine.drained():
            break
        try:
            await asyncio.wait_for(hurry.wait(), min(0.1, max(deadline - loop.time(), 0.01)))
        except asyncio.TimeoutError:
            pass
    for srv in (plane, http_server, grpc_server, uds_server, relay_tcp_server):
        if srv is not None:
            await srv.stop()
    engine.close()
    print("engine stopped", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="seldon_core_tpu_torch engine")
    parser.add_argument("--file", default=None, help="deployment JSON path")
    parser.add_argument("--predictor", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--rest-port", type=int, default=None)
    parser.add_argument("--grpc-port", type=int, default=None)
    parser.add_argument("--uds-path", default=None, help="the relay's unix socket")
    parser.add_argument("--http-uds-path", default=None,
                        help="the HTTP routes on this unix socket too")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card is an error")
    parser.add_argument("--gen-role", default=None, choices=["unified", "prefill", "decode"],
                        help="generation role in a disaggregated pair (env ENGINE_GEN_ROLE; "
                             "SELDON_TPU_DISAGG=0 forces unified)")
    parser.add_argument("--decode-peers", default=None,
                        help="comma-separated relay specs (uds:/path or tcp:host:port) of the "
                             "decode replicas a prefill replica hands KV blocks to (env "
                             "ENGINE_DECODE_PEERS)")
    parser.add_argument("--relay-tcp-port", type=int, default=None,
                        help="also serve the relay on this TCP port, the KV hand-off "
                             "receiver (env ENGINE_RELAY_TCP_PORT)")
    parser.add_argument("--node", default=None,
                        help="serve ONE graph node of the deployment as a standalone node "
                             "engine (graph sharding; env ENGINE_GRAPH_NODE)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"engine_main: {e}\n")
    deployment = load_deployment_from_env(args.file)
    node = args.node or os.environ.get("ENGINE_GRAPH_NODE", "").strip()
    if node:
        # this process serves one leaf: every node engine is shipped the
        # whole deployment, and the node name selects its slice
        from seldon_core_tpu_torch.graph.sharding import node_subspec

        deployment = default_and_validate(node_subspec(deployment, node, args.predictor))
    decode_peers = (parse_decode_peers(args.decode_peers) if args.decode_peers is not None
                    else None)
    asyncio.run(serve(deployment, args.predictor, args.host, args.rest_port, device,
                      grpc_port=args.grpc_port, uds_path=args.uds_path,
                      http_uds_path=args.http_uds_path, gen_role=args.gen_role,
                      decode_peers=decode_peers, relay_tcp_port=args.relay_tcp_port))


if __name__ == "__main__":
    main()
