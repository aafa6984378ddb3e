"""A minimal, killable engine process for mesh-kill chaos drills; the port's
copy of ``seldon_core_tpu/testing/toy_engine.py``, on the port's stdlib HTTP
server (``runtime/rest.py`` ``FastHttpServer`` with a route table of its
own).

Real engines (runtime/engine_main.py) need a built graph and a device;
chaos drills need the opposite — a process cheap enough to spawn per test
that speaks just enough of the engine wire surface to carry live traffic,
and that can be SIGKILLed mid-stream without ceremony (testing/faults.py
``kill_engine``).  It serves:

  POST /api/v0.1/predictions       unary SUCCESS echo
  POST /api/v0.1/generate/stream   SSE token stream continuing the
                                   arithmetic run of the prompt: token
                                   k is ``prompt[-1] + k``.  A resumed
                                   stream (prompt = original + emitted
                                   so far, reduced ``max_new`` — the
                                   gateway's re-prefill contract)
                                   therefore continues the SAME run, so
                                   a client can verify exactly-once
                                   cumulative output across a failover
                                   by checking for one consecutive
                                   sequence.
  GET  /stats                      {"boot_id": ...} for restart-epoch
                                   detection in the balancer scrape

With ``ENGINE_ADVERTISE_URL`` + ``GATEWAY_STATE_PATH`` set it
heartbeats an engine liveness lease through the shared sqlite store
(the port's ``gateway/state.py``) exactly like engine_main does — a
SIGKILL lapses the lease and the balancer marks the corpse dead within
one TTL.

    python -m seldon_core_tpu_torch.testing.toy_engine --port 8000
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import secrets

__all__ = ["main", "serve"]

_JSON = "application/json"


class _ToyRoutes:
    """The toy engine's route table (``FastHttpServer``'s contract: path ->
    ``async handler(body, ctype)``)."""

    def __init__(self, boot_id: str, token_sleep_s: float):
        self.boot_id = boot_id
        self.token_sleep_s = token_sleep_s
        self.post = {b"/api/v0.1/predictions": self._predictions,
                     b"/api/v0.1/generate/stream": self._generate_stream}
        self.get = {b"/stats": self._stats}

    async def _predictions(self, body, ctype):
        if ctype.startswith("application/x-seldon-tensor"):
            # decline the binary wire lane like an engine build without
            # it: the gateway negotiates down to JSON permanently
            return 415, b"json only", "text/plain"
        return 200, b'{"meta": {}, "data": {"ndarray": [[0.5]]}}', _JSON

    async def _generate_stream(self, body, ctype):
        from seldon_core_tpu_torch.runtime.rest import StreamResult

        doc = json.loads(body)
        prompt = doc["data"]["ndarray"][0]
        max_new = max(1, int(doc.get("max_new", 4)))
        last = float(prompt[-1])

        async def events():
            for k in range(1, max_new + 1):
                await asyncio.sleep(self.token_sleep_s)
                yield '{"tokens": [[%s]]}' % repr(last + k)
            yield '{"done": true}'

        return StreamResult(200, "text/event-stream", events())

    async def _stats(self, body, ctype):
        return 200, json.dumps({"boot_id": self.boot_id, "toy": True}).encode(), _JSON


async def serve(port: int, token_sleep_s: float = 0.05,
                host: str = "127.0.0.1") -> None:
    from seldon_core_tpu_torch.runtime.rest import FastHttpServer

    boot_id = secrets.token_hex(8)
    server = FastHttpServer(routes=_ToyRoutes(boot_id, token_sleep_s))
    await server.start(host, port)
    print(f"toy-engine listening :{server.port} boot={boot_id}", flush=True)

    heartbeat_task = None
    advertise = os.environ.get("ENGINE_ADVERTISE_URL", "").strip()
    state_path = os.environ.get("GATEWAY_STATE_PATH", "").strip()
    if advertise and state_path:
        from seldon_core_tpu_torch.gateway.federation import lease_ttl_s
        from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

        store = SqliteDeploymentStore(state_path)
        ttl = lease_ttl_s()

        async def _heartbeat() -> None:
            while True:
                try:
                    store.heartbeat_engine(advertise, boot_id, ttl)
                except Exception as e:  # noqa: BLE001 — liveness is best-effort
                    print(f"toy-engine heartbeat failed: {e}", flush=True)
                await asyncio.sleep(ttl / 3.0)

        heartbeat_task = asyncio.get_running_loop().create_task(_heartbeat())

    try:
        await asyncio.Event().wait()  # serve until killed — that's the point
    finally:
        if heartbeat_task is not None:
            heartbeat_task.cancel()
        await server.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="toy engine for mesh-kill chaos drills")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--token-sleep-s", type=float, default=0.05)
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)
    asyncio.run(serve(args.port, args.token_sleep_s, args.host))


if __name__ == "__main__":
    main()
