"""Gateway process entrypoint — the reference's apife pod boot; the port's
copy of ``seldon_core_tpu/gateway/gateway_main.py``, serving the gateway's
routes on the port's HTTP server (``runtime/rest.py`` ``FastHttpServer``)
and its Seldon gRPC service on ``runtime/grpcfast.py``
(``FastGrpcServer.for_gateway``: the bearer token in the call's
``oauth_token`` or ``authorization`` metadata).

Env contract (rendered by operator/bundle.py, mirroring the apife chart
values):

  GATEWAY_REST_PORT / GATEWAY_GRPC_PORT   listen ports (8080 / 5000)
  GATEWAY_OAUTH_ENABLED                   "0" disables auth (open gateway;
                                          tenant identity then comes from
                                          the Seldon-Tenant header alone)

Multi-tenant QoS (runtime/qos.py; docs/operations.md "Surviving
overload"): requests carry Seldon-Tenant / Seldon-Tier headers, and the
SELDON_TPU_TENANT_* / SELDON_TPU_GW_FAIR_INFLIGHT env knobs turn on
per-tenant token buckets and weighted-fair admission; the brownout
ladder (SELDON_TPU_BROWNOUT_*) sheds lower tiers under overload.
  GATEWAY_STATE_PATH                      sqlite file for replica-shared
                                          tokens/registrations (the
                                          reference's Redis role,
                                          gateway/state.py); empty =
                                          per-process in-memory store
  GATEWAY_SPEC_DIR                        directory of SeldonDeployment
                                          JSONs to register, polled like
                                          the operator's watch_dir
  GATEWAY_ENGINE_URL_TEMPLATE             engine base URL per deployment,
                                          default "http://{name}:8000"
                                          ({name} = deployment Service;
                                          {predictor} and {replica} are
                                          also substituted)
  GATEWAY_ENGINE_REPLICAS                 N>1 expands a {replica}-bearing
                                          template into an N-endpoint
                                          replica set per predictor
                                          (power-of-two-choices balancing,
                                          gateway/balancer.py)
  GATEWAY_ENGINE_URL_MAP                  per-predictor overrides; a JSON
                                          LIST value registers a replica
                                          set, and endpoint specs may
                                          carry a "+uds:/path" suffix for
                                          the zero-copy co-located lane
                                          (runtime/udsrelay.py)

  GATEWAY_ADVERTISE_URL                   this replica's URL in the shared
                                          peer directory (federation)
  GATEWAY_FIREHOSE_DIR                    request/response JSONL directory

    python -m seldon_core_tpu_torch.gateway.gateway_main [--spec-dir DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os

from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
from seldon_core_tpu_torch.gateway.firehose import Firehose
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec

__all__ = ["main"]


def _build_store():
    path = os.environ.get("GATEWAY_STATE_PATH", "").strip()
    if path:
        from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return SqliteDeploymentStore(path)
    return DeploymentStore()


def _engine_url_map() -> dict:
    """Explicit per-predictor overrides: '{"<deployment>/<predictor>":
    url-or-list}' — topologies where predictor engines don't follow one
    URL pattern (canary pairs on distinct ports, split-cluster serving).
    A LIST value registers a replica set the gateway balances over.
    Parsed once at boot; a malformed value is a fatal config error with a
    clear message, not a crash-loop in the poll tick."""
    raw_map = os.environ.get("GATEWAY_ENGINE_URL_MAP", "").strip()
    if not raw_map:
        return {}
    try:
        out = {}
        for k, v in json.loads(raw_map).items():
            if isinstance(v, list):
                if not v or not all(isinstance(u, str) for u in v):
                    raise ValueError(
                        f"{k!r}: a replica list must be non-empty strings"
                    )
                out[str(k)] = [str(u) for u in v]
            else:
                out[str(k)] = str(v)
        return out
    except (json.JSONDecodeError, AttributeError, ValueError) as e:
        raise SystemExit(
            f"GATEWAY_ENGINE_URL_MAP is not a JSON object of "
            f"'deployment/predictor' -> url (or list of urls): {e}"
        ) from e


def _engine_url_template() -> str:
    """Validated once at boot: a template with placeholders other than
    {name}/{predictor}/{replica} is a fatal config error with a clear
    message — NOT a KeyError escaping from the poll loop on the first
    matching spec."""
    template = os.environ.get(
        "GATEWAY_ENGINE_URL_TEMPLATE", "http://{name}:8000"
    )
    try:
        template.format(name="x", predictor="y", replica=0)
    except (KeyError, IndexError, ValueError) as e:
        raise SystemExit(
            f"GATEWAY_ENGINE_URL_TEMPLATE {template!r} is invalid: only "
            f"{{name}}, {{predictor}} and {{replica}} placeholders are "
            f"supported ({e})"
        ) from e
    return template


def _engine_replicas() -> int:
    """``GATEWAY_ENGINE_REPLICAS``: endpoints per predictor rendered from
    a {replica}-bearing template (validated at boot, same policy as the
    template itself)."""
    raw = os.environ.get("GATEWAY_ENGINE_REPLICAS", "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError as e:
        raise SystemExit(
            f"GATEWAY_ENGINE_REPLICAS {raw!r} is not an integer"
        ) from e
    if n < 1:
        raise SystemExit(f"GATEWAY_ENGINE_REPLICAS must be >= 1, got {n}")
    return n


def _check_replica_template(replicas: int, template: str) -> int:
    """Same fatal-at-boot policy as every other misconfig here: a replica
    count the template can't render would otherwise register
    single-endpoint sets and the scale-out would silently not exist."""
    if replicas > 1 and "{replica}" not in template:
        raise SystemExit(
            f"GATEWAY_ENGINE_REPLICAS={replicas} needs a {{replica}} "
            f"placeholder in GATEWAY_ENGINE_URL_TEMPLATE (got {template!r})"
        )
    return replicas


def _render_endpoints(template: str, name: str, predictor: str,
                      replicas: int):
    """One URL, or — when a {replica} template meets replicas>1 — a
    replica-set list the gateway p2c-balances over."""
    if replicas > 1 and "{replica}" in template:
        return [
            template.format(name=name, predictor=predictor, replica=i)
            for i in range(replicas)
        ]
    return template.format(name=name, predictor=predictor, replica=0)


def _register_specs(store, spec_dir: str, seen: dict, url_map: dict,
                    template: str, replicas: int = 1) -> None:
    for path in sorted(glob.glob(os.path.join(spec_dir, "*.json"))):
        mtime = os.path.getmtime(path)
        if seen.get(path) == mtime:
            continue
        try:
            with open(path) as f:
                spec = SeldonDeploymentSpec.from_json_dict(json.load(f))
            # {predictor} in the template routes each predictor to its own
            # engine Service — the canary topology (one engine pod per
            # predictor, replica-weighted split in ApiGateway._pick_engine);
            # {replica} x GATEWAY_ENGINE_REPLICAS renders a replica SET
            # per predictor instead (p2c balancing within the predictor)
            engines = {
                p.name: url_map.get(
                    f"{spec.name}/{p.name}",
                    _render_endpoints(template, spec.name, p.name, replicas),
                )
                for p in spec.predictors
            }
            store.register(spec, engines)
            seen[path] = mtime
            print(f"registered {spec.name} -> "
                  f"{sorted(str(v) for v in engines.values())}",
                  flush=True)
        except (GraphSpecError, ValueError, OSError,
                json.JSONDecodeError) as e:
            print(f"skipping {path}: {e}", flush=True)
            seen[path] = mtime


async def serve(spec_dir: str = "", host: str = "0.0.0.0",
                ready: "asyncio.Event | None" = None,
                stop: "asyncio.Event | None" = None) -> None:
    """Boot the gateway and serve until SIGTERM / SIGINT (or ``stop``);
    ``ready`` is set once both servers listen."""
    from seldon_core_tpu_torch.gateway.apife import serve_gateway
    from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcServer

    rest_port = int(os.environ.get("GATEWAY_REST_PORT", "8080"))
    grpc_port = int(os.environ.get("GATEWAY_GRPC_PORT", "5000"))
    store = _build_store()
    firehose_dir = os.environ.get("GATEWAY_FIREHOSE_DIR", "").strip()
    gateway = ApiGateway(
        store=store,
        firehose=Firehose(firehose_dir) if firehose_dir else None,
        require_auth=os.environ.get("GATEWAY_OAUTH_ENABLED", "1") != "0",
    )
    if gateway.firehose is not None:
        gateway.firehose.start()  # drain task needs the running loop
    # gateway federation (gateway/federation.py): with a shared sqlite
    # state file and SELDON_TPU_FEDERATION unset/1, this replica joins
    # the coordinator election + peer directory.  In-memory store or
    # SELDON_TPU_FEDERATION=0: no-op, single-gateway behavior
    from seldon_core_tpu_torch.gateway.federation import GatewayFederation

    advertise = os.environ.get("GATEWAY_ADVERTISE_URL", "").strip() or \
        f"http://127.0.0.1:{rest_port}"
    federation = GatewayFederation(store, base_url=advertise)
    # the burn publisher reads this replica's QoS throttle/shed totals
    # off the gateway's tenant governor (fleet-truth burn accounting)
    federation.governor = gateway.tenants
    gateway.federation = federation
    fed_stop = asyncio.Event()
    fed_task = None
    if federation.enabled:
        fed_task = asyncio.get_running_loop().create_task(
            federation.run(fed_stop))
        print(f"federation: replica={federation.replica_id} "
              f"ttl={federation.ttl_s:.1f}s advertise={advertise}",
              flush=True)
    seen: dict = {}
    url_map = _engine_url_map()
    template = _engine_url_template()  # fatal at boot if malformed
    replicas = _check_replica_template(_engine_replicas(), template)
    if spec_dir:
        _register_specs(store, spec_dir, seen, url_map, template, replicas)
    http_server = await serve_gateway(gateway, host, rest_port)
    grpc_server = FastGrpcServer.for_gateway(gateway)
    await grpc_server.start(host, grpc_port)
    print(
        f"gateway up: deployments={store.deployments()} "
        f"rest=:{http_server.port} grpc=:{grpc_server.port}",
        flush=True,
    )
    if ready is not None:
        ready.set()

    import signal

    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError, ValueError):
            pass
    try:
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                if spec_dir:  # poll for new/changed deployment specs
                    _register_specs(store, spec_dir, seen, url_map, template,
                                    replicas)
    finally:
        if fed_task is not None:
            fed_stop.set()
            await fed_task
        await grpc_server.stop()
        await http_server.stop()
        # resigns the federation lease NOW (not at TTL expiry) and closes
        # the upstream client and relay connections
        await gateway.close()
        if gateway.firehose is not None:
            await gateway.firehose.stop()  # flush queued events before exit
        print("gateway stopped", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="seldon_core_tpu_torch gateway")
    parser.add_argument(
        "--spec-dir", default=os.environ.get("GATEWAY_SPEC_DIR", "")
    )
    parser.add_argument("--host", default="0.0.0.0")
    args = parser.parse_args(argv)
    asyncio.run(serve(args.spec_dir, args.host))


if __name__ == "__main__":
    main()
