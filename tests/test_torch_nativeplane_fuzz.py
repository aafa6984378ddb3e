"""Adversarial input against the port's native data plane
(seldon_core_tpu_torch/native/csrc/dataplane.cpp), the cases of
tests/test_nativeplane_fuzz.py on a CPU engine: malformed HTTP, truncated
and oversized bodies, hostile JSON, broken HTTP/2 frames.  The plane
answers with a clean 4xx/5xx or closes the offending connection, never
crashes or wedges, and a well-formed request right after still succeeds."""

import asyncio
import json
import shutil
import struct

import pytest
import torch

from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.nativeplane import serve_native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the plane")

STUB = SeldonDeploymentSpec.from_json_dict({
    "spec": {
        "name": "fuzz",
        "predictors": [{
            "name": "p",
            "graph": {"name": "stub", "implementation": "SIMPLE_MODEL", "type": "MODEL"},
        }],
    }
})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


@pytest.fixture()
def engine():
    e = EngineService(STUB, max_batch=32, max_wait_ms=1.0, pipeline_depth=2, device="cpu")
    e.prewarm([1])
    yield e
    e.close()


async def _good_request(port) -> bool:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = b'{"data":{"ndarray":[[0.5]]}}'
    writer.write(
        b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
        b"Content-Length: %d\r\n\r\n" % len(body) + body
    )
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
    ok = b" 200 " in head.split(b"\r\n")[0]
    writer.close()
    return ok


async def _send_raw(port, payload: bytes, timeout=5.0) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    try:
        data = await asyncio.wait_for(reader.read(4096), timeout)
    except asyncio.TimeoutError:
        data = b""
    writer.close()
    return data


HTTP_ATTACKS = [
    b"\x00\x01\x02\x03garbage\r\n\r\n",
    b"GET\r\n\r\n",  # malformed request line
    b"POST /api/v0.1/predictions HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"POST /api/v0.1/predictions HTTP/1.1\r\nContent-Length: 1_0\r\n\r\nx",
    b"POST /api/v0.1/predictions HTTP/1.1\r\n"
    b"Transfer-Encoding: chunked\r\nContent-Length: 3\r\n\r\nabc",  # smuggle
    b"POST /api/v0.1/predictions HTTP/1.1\r\nContent-Length: 10\r\n\r\n"
    b'{"data":{',  # truncated body vs declared length is NOT sent fully
    b"X" * (70 * 1024),  # oversized headers, no terminator
    b"DELETE /api/v0.1/predictions HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
    b"POST /nope HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
]

BODY_ATTACKS = [
    b"{",  # truncated JSON
    b'{"data":{"ndarray":[[1,2],[3]]}}',  # ragged
    b'{"data":{"ndarray":[[1e999]]}}',  # overflow double
    b'{"data":{"tensor":{"shape":[2,2],"values":[1.0]}}}',  # shape mismatch
    b'{"data":{"tensor":{"shape":[-1,8],"values":[1,2,3,4,5,6,7,8]}}}',
    b'{"data":{"ndarray":' + b"[" * 64 + b"]" * 64 + b"}}",  # deep nesting
    b'{"meta":12,"data":{"ndarray":[[0.5]]}}',  # non-object meta
    b'{"data":{"ndarray":[["a","b"]]}}',  # strings
    b'\xff\xfe{"data":{"ndarray":[[0.5]]}}',  # invalid utf8 prefix
    json.dumps({"data": {"ndarray": [[0.5] * 100000]}}).encode(),  # huge row
]


def test_http_frame_attacks_never_wedge(engine):
    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            for attack in HTTP_ATTACKS:
                # several attacks legitimately get NO response (the server
                # waits for a body that never comes) — don't idle 5s each
                await _send_raw(plane.port, attack, timeout=0.5)
                assert await _good_request(plane.port), attack[:40]
        finally:
            await plane.stop()

    asyncio.run(run())


def test_hostile_bodies_get_clean_errors(engine):
    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            for body in BODY_ATTACKS:
                req = (
                    b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body) + body
                )
                resp = await _send_raw(plane.port, req)
                # a complete HTTP response with a definite status
                assert resp.startswith(b"HTTP/1.1 "), (body[:40], resp[:40])
                status = int(resp.split(b" ", 2)[1])
                assert status in (200, 400, 404, 413, 500, 503), body[:40]
                assert await _good_request(plane.port), body[:40]
        finally:
            await plane.stop()

    asyncio.run(run())


H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


def _frame(ftype, flags, sid, payload=b""):
    return (
        struct.pack(">I", len(payload))[1:] + bytes([ftype, flags])
        + struct.pack(">I", sid & 0x7FFFFFFF) + payload
    )


H2_ATTACKS = [
    b"NOT A PREFACE AT ALL!!!!",  # bad preface (24 bytes)
    H2_PREFACE + _frame(1, 4, 1, b"\xff" * 40),  # hopeless HPACK block
    H2_PREFACE + _frame(4, 0, 0, b"\x00"),  # SETTINGS not %6
    H2_PREFACE + _frame(8, 0, 0, b"\x00\x00"),  # short WINDOW_UPDATE
    H2_PREFACE + _frame(9, 4, 1, b"x"),  # CONTINUATION with no HEADERS
    H2_PREFACE + _frame(0, 0, 99, b"data-for-nobody"),  # DATA unknown stream
    H2_PREFACE + b"\xff\xff\xff\x00\x00\x00\x00\x00\x01",  # 16MB frame decl
]


def test_h2_frame_attacks_never_crash(engine):
    import grpc

    from seldon_core_tpu.proto_gen import prediction_pb2 as pb

    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0, grpc_port=0)
        try:
            for attack in H2_ATTACKS:
                await _send_raw(plane.grpc_port, attack)
            # the lane still serves a stock client afterwards
            ch = grpc.aio.insecure_channel(f"127.0.0.1:{plane.grpc_port}")
            stub = ch.unary_unary(
                "/seldon.protos.Seldon/Predict",
                request_serializer=pb.SeldonMessage.SerializeToString,
                response_deserializer=pb.SeldonMessage.FromString,
            )
            r = await stub(
                pb.SeldonMessage(
                    data=pb.DefaultData(
                        tensor=pb.Tensor(shape=[1, 1], values=[0.5])
                    )
                ),
                timeout=30,
            )
            assert r.status.code == 200
            await ch.close()
        finally:
            await plane.stop()

    asyncio.run(run())


def test_random_mutations_seeded(engine):
    """Seeded random mutations of a valid request: flip/insert/delete
    bytes anywhere (headers or body).  Every mutation must produce either
    a complete HTTP response or a clean close — and the connection pool
    must stay serviceable throughout.  (A mutation that breaks framing
    legitimately gets NO response — the server waits for the declared
    body — so the read timeout is short.)"""
    import random

    rng = random.Random(0xC0FFEE)
    body = b'{"meta":{"puid":"x"},"data":{"ndarray":[[0.5,1.5]]}}'
    base = (
        b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: %d\r\n\r\n" % len(body) + body
    )

    def mutate(data: bytes) -> bytes:
        b = bytearray(data)
        for _ in range(rng.randint(1, 6)):
            op = rng.randrange(3)
            pos = rng.randrange(len(b))
            if op == 0:
                b[pos] = rng.randrange(256)
            elif op == 1:
                b.insert(pos, rng.randrange(256))
            elif len(b) > 1:
                del b[pos]
        return bytes(b)

    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            for i in range(80):
                await _send_raw(plane.port, mutate(base), timeout=0.3)
                if i % 20 == 19:  # periodic liveness probe
                    assert await _good_request(plane.port), f"iteration {i}"
            assert await _good_request(plane.port)
        finally:
            await plane.stop()

    asyncio.run(run())


def test_slowloris_partial_requests(engine):
    """Bytes dribbling in across many writes must frame correctly."""
    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", plane.port
            )
            body = b'{"data":{"ndarray":[[0.25]]}}'
            full = (
                b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
                b"Content-Length: %d\r\n\r\n" % len(body) + body
            )
            for i in range(0, len(full), 7):
                writer.write(full[i: i + 7])
                await writer.drain()
                await asyncio.sleep(0.01)
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
            assert b" 200 " in head.split(b"\r\n")[0]
            writer.close()
        finally:
            await plane.stop()

    asyncio.run(run())


def test_pipelined_burst_orders_responses(engine):
    """N pipelined requests on one connection come back in order."""
    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", plane.port
            )
            N = 24
            for i in range(N):
                body = json.dumps(
                    {"meta": {"puid": f"r{i}"},
                     "data": {"ndarray": [[i * 1.0]]}}
                ).encode()
                writer.write(
                    b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body) + body
                )
            await writer.drain()
            for i in range(N):
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), 30
                )
                lower = head.lower()
                j = lower.find(b"content-length:")
                clen = int(lower[j + 15: lower.find(b"\r", j)])
                resp = await reader.readexactly(clen)
                assert json.loads(resp)["meta"]["puid"] == f"r{i}"
            writer.close()
        finally:
            await plane.stop()

    asyncio.run(run())
