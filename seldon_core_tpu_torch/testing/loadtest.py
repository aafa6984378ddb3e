"""Async load rig — the locust-equivalent (util/loadtester/scripts/
predict_rest_locust.py, helm-charts/seldon-core-loadtesting); the port's copy
of ``seldon_core_tpu/testing/loadtest.py``, on the port's stdlib clients.
The native rig (``--native``) is ``native/csrc/loadgen.cpp`` of this package,
built at first use by ``native/_build.build("loadgen")`` into the checkout's
``build/native/``; a failed build raises.  gRPC runs on the port's
``runtime/grpcfast.py`` client (``--fast`` or ``--native``): the stock
``grpc.aio`` lane is refused, as the engine's ``ENGINE_GRPC_IMPL=aio`` is.

K closed-loop clients fire contract-generated requests at a REST or gRPC
endpoint for a fixed duration; reports qps + latency percentiles as one JSON
line (the shape ``docs/benchmarking.md`` tabulates)::

    python -m seldon_core_tpu_torch.testing.loadtest contract.json 127.0.0.1 8000 \
        --clients 64 --duration 10 [--api grpc] [--batch-size 1]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from typing import Optional

import numpy as np

from seldon_core_tpu_torch.testing.contract import Contract, generate_batch

__all__ = ["run_load", "run_load_native", "main"]


# ---------------------------------------------------------------------------
# Native load generator (native/csrc/loadgen.cpp) — plays the role of the
# reference's DEDICATED loadtest nodes (docs/benchmarking.md drives the
# engine from 3 separate locust machines).  A Python client charges its own
# per-request cost to the cores the server shares; the native client costs
# a few microseconds a request, so the measured number is the server's.
# ---------------------------------------------------------------------------

#: the refusal of the stock grpc.aio lane
GRPC_AIO_REFUSED = ("the stock grpc.aio lane is not part of the port (as "
                    "ENGINE_GRPC_IMPL=aio is not): pass --fast or --native for gRPC")


def loadgen_binary() -> str:
    """Path to the compiled native load generator, building it on first use
    (``native/_build.build("loadgen")``); raises RuntimeError with the
    compiler's message when it cannot be built."""
    from seldon_core_tpu_torch.native import _build

    return str(_build.build("loadgen"))


def _rounded_payload(contract: Contract, batch_size: int,
                     decimals: Optional[int]):
    # the reference's locust rig sends round(random(), 2)
    # (util/loadtester/scripts/predict_rest_locust.py:129) — full-precision
    # random doubles would make the payload ~2.4x larger than anything the
    # reference's benchmark ever parsed
    payload_msg = generate_batch(contract, batch_size, seed=0)
    if decimals is not None:
        try:
            arr = np.round(np.asarray(payload_msg.array(), np.float64), decimals)
            payload_msg = payload_msg.with_array(arr)
        except Exception:
            pass  # non-numeric contract: send as generated
    return payload_msg


async def run_load_native(
    contract: Contract,
    host: str,
    port: int,
    api: str = "rest",
    clients: int = 16,
    duration_s: float = 10.0,
    warmup_s: float = 2.0,
    batch_size: int = 1,
    decimals: Optional[int] = 2,
    conns: Optional[int] = None,
    oauth_key: Optional[str] = None,
    oauth_secret: Optional[str] = None,
) -> dict:
    """Drive the endpoint with the native closed-loop client.  Same report
    shape as :func:`run_load`.  ``conns`` caps gRPC connection count (REST is
    one connection per client, locust-style).  With ``oauth_key`` a token is
    fetched once and embedded in every request (the reference locust scripts
    authenticate the same way, once per worker)."""
    import json as _json
    import tempfile

    token = None
    if oauth_key:
        from seldon_core_tpu_torch.testing.api_tester import _rest_token

        token = await _rest_token(host, port, oauth_key, oauth_secret or "")

    binary = loadgen_binary()
    payload_msg = _rounded_payload(contract, batch_size, decimals)
    with tempfile.TemporaryDirectory() as td:
        req_path = os.path.join(td, "request.bin")
        argv = [
            binary, "--host", host, "--port", str(port), "--api", api,
            "--clients", str(clients), "--duration", str(duration_s),
            "--warmup", str(warmup_s), "--request-file", req_path,
        ]
        if api == "grpc":
            from seldon_core_tpu_torch import protoconv
            from seldon_core_tpu_torch.native.hpackcodec import encode_headers

            proto = protoconv.msg_to_proto(payload_msg)
            import struct

            with open(req_path, "wb") as f:  # gRPC message frame
                f.write(b"\x00" + struct.pack(">I", len(proto)) + proto)
            hdr_path = os.path.join(td, "headers.bin")
            headers = [
                (b":method", b"POST"),
                (b":scheme", b"http"),
                (b":path", b"/seldon.protos.Seldon/Predict"),
                (b"content-type", b"application/grpc"),
                (b"te", b"trailers"),
            ]
            if token:
                headers.append((b"oauth_token", token.encode()))
            with open(hdr_path, "wb") as f:
                f.write(encode_headers(headers))
            argv += ["--headers-file", hdr_path]
            if conns is not None:
                argv += ["--conns", str(conns)]
        else:
            body = payload_msg.to_json().encode()
            auth = f"Authorization: Bearer {token}\r\n" if token else ""
            with open(req_path, "wb") as f:
                f.write(
                    (
                        f"POST /api/v0.1/predictions HTTP/1.1\r\nHost: {host}\r\n"
                        f"Content-Type: application/json\r\n{auth}"
                        f"Content-Length: {len(body)}\r\n\r\n"
                    ).encode() + body
                )
        proc = await asyncio.create_subprocess_exec(
            *argv, stdout=asyncio.subprocess.PIPE,
        )
        out, _ = await proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"loadgen exited {proc.returncode}")
    return _json.loads(out)


async def run_load(
    contract: Contract,
    host: str,
    port: int,
    api: str = "rest",
    clients: int = 16,
    duration_s: float = 10.0,
    batch_size: int = 1,
    oauth_key: Optional[str] = None,
    oauth_secret: Optional[str] = None,
    fast: bool = False,
    decimals: Optional[int] = 2,
) -> dict:
    payload_msg = _rounded_payload(contract, batch_size, decimals)
    stop_at = time.perf_counter() + duration_s
    latencies: list = []
    failures = 0

    token = None
    if oauth_key:
        from seldon_core_tpu_torch.testing.api_tester import _rest_token

        token = await _rest_token(host, port, oauth_key, oauth_secret or "")

    if api == "rest" and fast:
        # locust FastHttpUser analogue: raw keepalive HTTP/1.1 connections,
        # one per client, minimal parsing: the least client CPU a request,
        # which matters when clients and server share cores
        # (docs/benchmarking.md methodology note)
        body = payload_msg.to_json().encode()
        auth = f"Authorization: Bearer {token}\r\n" if token else ""
        request = (
            f"POST /api/v0.1/predictions HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n{auth}"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode() + body

        async def client():
            nonlocal failures
            reader = writer = None
            while time.perf_counter() < stop_at:
                if writer is None:
                    try:
                        reader, writer = await asyncio.open_connection(
                            host, port
                        )
                    except OSError:
                        failures += 1
                        await asyncio.sleep(0.05)  # connect storm relief
                        continue
                t0 = time.perf_counter()
                try:
                    writer.write(request)
                    head = await reader.readuntil(b"\r\n\r\n")
                    lower = head.lower()
                    j = lower.find(b"content-length:")
                    clen = int(lower[j + 15: lower.find(b"\r", j)])
                    await reader.readexactly(clen)
                except (OSError, asyncio.IncompleteReadError, ValueError):
                    # transient: count it, reconnect, keep loading (the
                    # pooled lane behaves the same way)
                    failures += 1
                    writer.close()
                    reader = writer = None
                    continue
                if head[9:12] == b"200":
                    latencies.append(time.perf_counter() - t0)
                else:
                    failures += 1
            if writer is not None:
                writer.close()

        t_start = time.perf_counter()
        await asyncio.gather(*[client() for _ in range(clients)])
        wall = time.perf_counter() - t_start
        return _report(latencies, failures, wall, clients, duration_s)

    if api == "grpc" and fast:
        # wire-level gRPC client (runtime/grpcfast.py): multiplexed streams
        # over a few connections
        from seldon_core_tpu_torch import protoconv
        from seldon_core_tpu_torch.runtime.grpcfast import (
            FastGrpcChannel,
            GrpcCallError,
        )

        wire = protoconv.msg_to_proto(payload_msg)
        path = b"/seldon.protos.Seldon/Predict"
        n_conns = max(1, min(4, clients // 64))
        channels = []
        for _ in range(n_conns):
            channels.append(await FastGrpcChannel().connect(host, port))
        locks = [asyncio.Lock() for _ in range(n_conns)]

        async def client(i):
            nonlocal failures
            slot = i % n_conns
            while time.perf_counter() < stop_at:
                ch = channels[slot]
                t0 = time.perf_counter()
                try:
                    # same 30s deadline as the stock-lane stub calls
                    await asyncio.wait_for(ch.call(path, wire), 30)
                    latencies.append(time.perf_counter() - t0)
                except (GrpcCallError, OSError, asyncio.TimeoutError):
                    failures += 1
                    async with locks[slot]:  # one reconnect per dead conn
                        if not channels[slot].is_open:
                            try:
                                channels[slot] = (
                                    await FastGrpcChannel().connect(host, port)
                                )
                            except OSError:
                                await asyncio.sleep(0.05)

        t_start = time.perf_counter()
        await asyncio.gather(*[client(i) for i in range(clients)])
        wall = time.perf_counter() - t_start
        for ch in channels:
            await ch.close()
        return _report(latencies, failures, wall, clients, duration_s)

    if api == "grpc":
        raise ValueError(GRPC_AIO_REFUSED)

    from seldon_core_tpu_torch.runtime.client import HttpClient

    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    session = HttpClient(pool=clients)
    payload = payload_msg.to_json().encode()
    url = f"http://{host}:{port}/api/v0.1/predictions"

    async def one_request():
        r = await session.post(url, payload, headers, timeout=30)
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status}")

    async def client():
        nonlocal failures
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                await one_request()
                latencies.append(time.perf_counter() - t0)
            except Exception:
                failures += 1

    t_start = time.perf_counter()
    try:
        await asyncio.gather(*[client() for _ in range(clients)])
    finally:
        wall = time.perf_counter() - t_start
        await session.close()

    return _report(latencies, failures, wall, clients, duration_s)


def _report(latencies, failures, wall, clients, duration_s) -> dict:
    lat = np.asarray(latencies)
    pct = (
        {
            f"p{p}_ms": round(float(np.percentile(lat, p)) * 1e3, 2)
            for p in (50, 75, 90, 95, 99)
        }
        if len(lat)
        else {}
    )
    return {
        "requests": len(latencies),
        "failures": failures,
        "qps": round(len(latencies) / max(wall, 1e-9), 1),
        "clients": clients,
        "duration_s": duration_s,
        **pct,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="async load tester")
    parser.add_argument("contract")
    parser.add_argument("host")
    parser.add_argument("port", type=int)
    parser.add_argument("--api", choices=["rest", "grpc"], default="rest")
    parser.add_argument(
        "--fast", action="store_true",
        help="REST: raw keepalive connections (locust FastHttpUser analogue)",
    )
    parser.add_argument(
        "--native", action="store_true",
        help="drive with the native C++ closed-loop client (native/csrc/loadgen.cpp)",
    )
    parser.add_argument(
        "--decimals", type=int, default=2,
        help="round generated features (reference locust: 2); -1 = full precision",
    )
    parser.add_argument("--clients", type=int, default=16)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--oauth-key", default=None)
    parser.add_argument("--oauth-secret", default=None)
    args = parser.parse_args(argv)
    if args.api == "grpc" and not (args.fast or args.native):
        parser.error(GRPC_AIO_REFUSED)
    if args.native:
        result = asyncio.run(
            run_load_native(
                Contract.from_file(args.contract), args.host, args.port,
                api=args.api, clients=args.clients, duration_s=args.duration,
                batch_size=args.batch_size,
                decimals=None if args.decimals < 0 else args.decimals,
                oauth_key=args.oauth_key, oauth_secret=args.oauth_secret,
            )
        )
    else:
        result = asyncio.run(
            run_load(
                Contract.from_file(args.contract), args.host, args.port,
                api=args.api, clients=args.clients, duration_s=args.duration,
                batch_size=args.batch_size, oauth_key=args.oauth_key,
                oauth_secret=args.oauth_secret, fast=args.fast,
                decimals=None if args.decimals < 0 else args.decimals,
            )
        )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
