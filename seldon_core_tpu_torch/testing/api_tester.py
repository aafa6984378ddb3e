"""Contract API tester CLI — fire generated batches at a running service;
the port's copy of ``seldon_core_tpu/testing/api_tester.py``, on the port's
stdlib clients (``runtime/client.py`` ``HttpClient`` for REST,
``runtime/grpcfast.py`` ``FastGrpcChannel`` and ``protoconv`` for gRPC).

Parity with ``util/api_tester/api-tester.py:24-120``::

    python -m seldon_core_tpu_torch.testing.api_tester contract.json 127.0.0.1 8000 \\
        --api rest --endpoint predict -n 8 --ndarray \\
        [--oauth-key k --oauth-secret s]   # via gateway
    python -m seldon_core_tpu_torch.testing.api_tester contract.json 127.0.0.1 5001 \\
        --api grpc

Sends ``n`` randomly generated rows, validates the response against the
contract's targets, prints one JSON result line, exit code 0/1.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import sys
import time
from typing import Optional

from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
from seldon_core_tpu_torch.testing.contract import Contract, generate_batch, validate_response

__all__ = ["run_test", "main"]

PREDICT_PATH = b"/seldon.protos.Seldon/Predict"


async def _rest_call(host, port, path, payload, token=None):
    from seldon_core_tpu_torch.runtime.client import HttpClient

    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    client = HttpClient()
    try:
        r = await client.post(f"http://{host}:{port}{path}",
                              payload.encode() if isinstance(payload, str) else payload,
                              headers)
        return r.status, r.text()
    finally:
        await client.close()


async def _rest_token(host, port, key, secret):
    from seldon_core_tpu_torch.runtime.client import HttpClient

    basic = base64.b64encode(f"{key}:{secret}".encode()).decode()
    client = HttpClient()
    try:
        r = await client.post(f"http://{host}:{port}/oauth/token", b"",
                              {"Authorization": f"Basic {basic}"})
        if r.status != 200:
            raise RuntimeError(f"token request failed: HTTP {r.status}")
        return r.json()["access_token"]
    finally:
        await client.close()


async def _grpc_call(host, port, msg: SeldonMessage, token=None) -> SeldonMessage:
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel

    ch = await FastGrpcChannel().connect(host, port)
    try:
        metadata = ((b"oauth_token", token.encode()),) if token else ()
        resp = await asyncio.wait_for(
            ch.call(PREDICT_PATH, protoconv.msg_to_proto(msg), metadata), 30)
        return protoconv.msg_from_proto(resp)
    finally:
        await ch.close()


async def run_test(
    contract: Contract,
    host: str,
    port: int,
    api: str = "rest",
    endpoint: str = "predict",
    n: int = 1,
    tensor: bool = True,
    oauth_key: Optional[str] = None,
    oauth_secret: Optional[str] = None,
    seed: Optional[int] = None,
) -> dict:
    msg = generate_batch(contract, n, seed=seed)
    if not tensor and msg.data is not None:
        msg.data.kind = "ndarray"
    token = None
    if oauth_key:
        token = await _rest_token(host, port, oauth_key, oauth_secret or "")
    t0 = time.perf_counter()
    if api == "grpc":
        resp = await _grpc_call(host, port, msg, token)
        status_code = 200
    else:
        if endpoint == "send-feedback":
            payload = Feedback(request=msg, reward=1.0).to_json()
            path = "/api/v0.1/feedback"
        else:
            payload = msg.to_json()
            path = "/api/v0.1/predictions"
        status_code, body = await _rest_call(host, port, path, payload, token)
        resp = SeldonMessage.from_json(body)
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    problems = [] if endpoint == "send-feedback" else validate_response(contract, resp)
    if status_code != 200:
        problems.append(f"HTTP {status_code}")
    return {
        "ok": not problems,
        "problems": problems,
        "latency_ms": round(elapsed_ms, 2),
        "rows": n,
        "response_meta": resp.meta.to_json_dict(),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="contract-based API tester")
    parser.add_argument("contract")
    parser.add_argument("host")
    parser.add_argument("port", type=int)
    parser.add_argument("--api", choices=["rest", "grpc"], default="rest")
    parser.add_argument("--endpoint", choices=["predict", "send-feedback"],
                        default="predict")
    parser.add_argument("-n", "--batch-size", type=int, default=1)
    parser.add_argument("--ndarray", action="store_true",
                        help="send ndarray wire form instead of tensor")
    parser.add_argument("--oauth-key", default=None)
    parser.add_argument("--oauth-secret", default=None)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    contract = Contract.from_file(args.contract)
    result = asyncio.run(
        run_test(
            contract, args.host, args.port, api=args.api, endpoint=args.endpoint,
            n=args.batch_size, tensor=not args.ndarray,
            oauth_key=args.oauth_key, oauth_secret=args.oauth_secret,
            seed=args.seed,
        )
    )
    print(json.dumps(result))
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
