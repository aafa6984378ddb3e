"""The port's gRPC lane on the CPU (``native/hpackcodec.py``,
``runtime/grpcfast.py``, ``GrpcNodeRuntime`` and the microservice's
``GRPC``): HPACK against the reference's codec and RFC 7541's Huffman
examples; the port's ``FastGrpcServer`` on a CPU engine called by the
stock ``grpc.aio`` client (the JAX engine's answer within MNIST's
tolerance, 64-row requests and answers past the 65,535-byte window,
UNIMPLEMENTED, the FAILURE echo of the puid); the port's
``FastGrpcChannel`` against the reference's ``FastGrpcServer`` and the
stock ``grpc.aio`` server; a ``grpc`` node in ensemble4 against an
in-process microservice within 1e-6 of fused; retries and the breaker
against a closed port."""

import asyncio
import json
import random
import socket

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.native import hpackcodec as ref_hpack
from seldon_core_tpu.proto_gen import prediction_pb2 as pb
from seldon_core_tpu.runtime import grpcfast as ref_grpcfast
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.runtime.grpc_server import make_engine_grpc_server
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.interpreter import to_device
from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    Parameter,
    PredictiveUnit,
    SeldonDeploymentSpec,
    UnitType,
)
from seldon_core_tpu_torch.messages import Meta, SeldonMessage
from seldon_core_tpu_torch.native import hpackcodec
from seldon_core_tpu_torch.runtime import microservice
from seldon_core_tpu_torch.runtime.client import (
    GrpcNodeRuntime,
    RemoteCallError,
    make_node_runtime,
)
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.grpcfast import (
    FastGrpcChannel,
    FastGrpcServer,
    GrpcCallError,
    serve_grpc_fast,
)
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.resilience import (
    BreakerOpenError,
    CircuitBreaker,
    RetryBudget,
    RetryPolicy,
)
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

grpc = pytest.importorskip("grpc")

ATOL = 2e-2  # bf16 MNIST weights: the reference's tolerance (tests/test_ops_pallas.py:56)
HOST_ATOL = 1e-6  # a remote node's float32 answer crosses as float64 values
PREDICT = b"/seldon.protos.Seldon/Predict"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    # the autopilot's table, the brownout ladder, the fleet burn view and the
    # cost ledger are process-global and change decisions: what one test
    # trained must not steer the next
    reset_learned_singletons()
    yield


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- HPACK ------------------------------------------------------------------

HEADERS = [
    [(b":method", b"POST"), (b":scheme", b"http"), (b":path", b"/seldon.protos.Seldon/Predict"),
     (b":authority", b"127.0.0.1:5001"), (b"content-type", b"application/grpc"),
     (b"te", b"trailers")],
    [(b":status", b"200"), (b"content-type", b"application/grpc")],
    [(b"grpc-status", b"0"), (b"grpc-message", b"")],
    [(b"x-long", b"v" * 300), (b":path", b"/"), (b"accept-encoding", b"gzip, deflate")],
]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_hpack_encoder_is_the_reference_bytes(i):
    block = hpackcodec.encode_headers(HEADERS[i])
    assert block == ref_hpack.encode_headers(HEADERS[i])
    assert hpackcodec.HpackDecoder().decode(block) == HEADERS[i]


# RFC 7541 Appendix C.4: three requests with Huffman-coded strings sharing
# one dynamic table
RFC_C4 = [
    ("828684418cf1e3c2e5f23a6ba0ab90f4ff",
     [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
      (b":authority", b"www.example.com")]),
    ("828684be5886a8eb10649cbf",
     [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
      (b":authority", b"www.example.com"), (b"cache-control", b"no-cache")]),
    ("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
     [(b":method", b"GET"), (b":scheme", b"https"), (b":path", b"/index.html"),
      (b":authority", b"www.example.com"), (b"custom-key", b"custom-value")]),
]


def test_hpack_decoder_takes_huffman_and_the_dynamic_table():
    ours, theirs = hpackcodec.HpackDecoder(), ref_hpack.HpackDecoder()
    for block, want in RFC_C4:
        raw = bytes.fromhex(block)
        assert ours.decode(raw) == theirs.decode(raw) == want
    assert ours.dynamic == theirs.dynamic and ours.size == theirs.size == 164
    # a size update to 0 empties the table; a bad index is an HpackError
    assert ours.decode(b"\x20") == [] and ours.dynamic == []
    with pytest.raises(hpackcodec.HpackError):
        ours.decode(b"\xbe")


# -- engines ----------------------------------------------------------------


def _mnist_doc(hidden=32):
    return {"spec": {"name": "mnist", "predictors": [{
        "name": "main",
        "components": [{"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": str(hidden),
                                        "type": "INT"}]}],
        "graph": {"name": "mnist", "type": "MODEL", "children": []}}]}}


def _engines():
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")
    engine.load_states({"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in jax_engine.states()["mnist"].items()}, device="cpu")})
    return jax_engine, engine


def _tensor_request(x, puid=""):
    req = pb.SeldonMessage(data=pb.DefaultData(tensor=pb.Tensor(
        shape=list(x.shape), values=x.ravel().tolist())))
    if puid:
        req.meta.puid = puid
    return req


def test_stock_grpc_client_against_the_port_server():
    """grpc.aio (C-core HTTP/2, HPACK with Huffman and the dynamic table) on
    the port's FastGrpcServer over a CPU engine: 1-row and 64-row tensor
    requests (the 64-row one, 401 kB, past the 65,535-byte window) and an
    ndarray one answer the JAX engine's probabilities within MNIST's
    tolerance, with its status and names; an unknown path is
    UNIMPLEMENTED; a dispatch failure answers FAILURE with the request's
    puid, as the JAX engine's does; SendFeedback answers an ack."""
    jax_engine, engine = _engines()
    rng = np.random.default_rng(0)
    xs = [rng.random((1, 784)), rng.random((64, 784))]

    async def run():
        server = await serve_grpc_fast(engine, "127.0.0.1", 0)
        channel = grpc.aio.insecure_channel(f"127.0.0.1:{server.port}")
        try:
            def stub(path, req_cls=pb.SeldonMessage):
                return channel.unary_unary(path, request_serializer=req_cls.SerializeToString,
                                           response_deserializer=pb.SeldonMessage.FromString)

            predict = stub("/seldon.protos.Seldon/Predict")
            alias = stub("/seldon.protos.Model/Predict")
            out = {"tensor": [await asyncio.wait_for(predict(_tensor_request(x, f"p{i}")), 30)
                              for i, x in enumerate(xs)]}
            nd = pb.SeldonMessage()
            nd.data.ndarray.extend(xs[0].tolist())
            out["ndarray"] = await asyncio.wait_for(alias(nd), 30)
            out["fail"] = await asyncio.wait_for(predict(_tensor_request(
                np.zeros((1, 5)), "echo-me")), 30)
            with pytest.raises(grpc.aio.AioRpcError) as e:
                await asyncio.wait_for(stub("/seldon.protos.Nope/X")(nd), 30)
            out["unimplemented"] = e.value.code()
            fb = pb.Feedback(request=_tensor_request(xs[0]), reward=1.0)
            out["feedback"] = await asyncio.wait_for(
                stub("/seldon.protos.Seldon/SendFeedback", pb.Feedback)(fb), 30)
            return out
        finally:
            await channel.close()
            await server.stop()

    try:
        out = asyncio.run(run())
    finally:
        engine.close()
    for i, (x, resp) in enumerate(zip(xs, out["tensor"])):
        want = asyncio.run(jax_engine.predict_proto_wire(_tensor_request(
            x, f"p{i}").SerializeToString()))
        want = pb.SeldonMessage.FromString(want)
        assert resp.status == want.status and resp.meta.puid == f"p{i}"
        assert list(resp.data.names) == list(want.data.names)
        assert list(resp.data.tensor.shape) == list(want.data.tensor.shape) == [len(x), 10]
        assert np.abs(np.asarray(resp.data.tensor.values)
                      - np.asarray(want.data.tensor.values)).max() < ATOL
    nd = out["ndarray"]
    assert nd.data.WhichOneof("data_oneof") == "ndarray" and nd.status.code == 200
    assert np.abs(np.asarray(json.loads(json.dumps(list(nd.data.ndarray[0])))) -
                  np.asarray(out["tensor"][0].data.tensor.values)).max() < 1e-12
    assert out["fail"].status.status == pb.Status.FAILURE and out["fail"].status.code == 400
    assert out["fail"].meta.puid == "echo-me"
    want_fail = pb.SeldonMessage.FromString(asyncio.run(jax_engine.predict_proto_wire(
        _tensor_request(np.zeros((1, 5)), "echo-me").SerializeToString())))
    assert want_fail.status.status == pb.Status.FAILURE and want_fail.meta.puid == "echo-me"
    assert out["unimplemented"] == grpc.StatusCode.UNIMPLEMENTED
    assert out["feedback"].status.status == pb.Status.SUCCESS


def test_port_channel_against_the_reference_servers():
    """The port's FastGrpcChannel on the reference's FastGrpcServer and on
    its stock grpc.aio server (which opens a 65,535-byte window, so the
    64-row request stalls and resumes on WINDOW_UPDATE): the same answer
    bytes from both, decoded by the port's protoconv."""
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    x = np.random.default_rng(1).random((64, 784))
    body = protoconv.msg_to_proto(SeldonMessage.from_array(x, meta=Meta(puid="c")))

    async def run():
        fast = await ref_grpcfast.serve_grpc_fast(jax_engine, "127.0.0.1", _free_port())
        stock_port = _free_port()
        stock = make_engine_grpc_server(jax_engine, "127.0.0.1", stock_port)
        await stock.start()
        try:
            port_fast = [s.getsockname()[1] for s in fast._server.sockets][0]
            answers = []
            for port in (port_fast, stock_port):
                ch = await FastGrpcChannel().connect("127.0.0.1", port)
                try:
                    answers.append(await asyncio.wait_for(ch.call(PREDICT, body), 30))
                    with pytest.raises(GrpcCallError) as e:
                        await asyncio.wait_for(ch.call(b"/seldon.protos.Nope/X", body), 30)
                    answers.append(e.value.code_name)
                finally:
                    await ch.close()
            return answers
        finally:
            await fast.stop()
            await stock.stop(None)

    fast_answer, fast_unimpl, stock_answer, stock_unimpl = asyncio.run(run())
    assert fast_answer == stock_answer
    msg = protoconv.msg_from_proto(fast_answer)
    assert msg.meta.puid == "c" and msg.array().shape == (64, 10)
    assert np.allclose(msg.array().sum(axis=1), 1.0, atol=1e-3)
    assert fast_unimpl == stock_unimpl == "UNIMPLEMENTED"


def test_stock_client_reads_a_large_answer_from_a_unit_server():
    """A unit's node services (``FastGrpcServer.for_unit``): a 64x784 float64
    answer (401 kB) goes out through the port server's flow control to a
    stock grpc.aio client, twice on one connection; Route answers the
    branch as a 1x1 tensor; a method the unit lacks is UNIMPLEMENTED."""
    import tests.test_torch_fusion  # noqa: F401  (registers the port's test.* units)

    rt = build_runtime("test.Scale", "MODEL", [Parameter.from_json_dict(
        {"name": "factor", "value": "2.0", "type": "FLOAT"})], unit_name="s", device="cpu")
    router = build_runtime("test.CountingRouter", "ROUTER", [], unit_name="r", device="cpu")
    x = np.random.default_rng(2).random((64, 784))

    async def run():
        servers = [FastGrpcServer.for_unit(rt), FastGrpcServer.for_unit(router)]
        for s in servers:
            await s.start("127.0.0.1", 0)
        chans = [grpc.aio.insecure_channel(f"127.0.0.1:{s.port}") for s in servers]
        try:
            def stub(ch, path):
                return ch.unary_unary(path, request_serializer=pb.SeldonMessage.SerializeToString,
                                      response_deserializer=pb.SeldonMessage.FromString)

            predict = stub(chans[0], "/seldon.protos.Model/Predict")
            big = [await asyncio.wait_for(predict(_tensor_request(x)), 30) for _ in range(2)]
            route = await asyncio.wait_for(stub(chans[1], "/seldon.protos.Generic/Route")(
                _tensor_request(x[:1])), 30)
            with pytest.raises(grpc.aio.AioRpcError) as e:  # Scale has no transform_input
                await asyncio.wait_for(stub(chans[0], "/seldon.protos.Transformer/"
                                                      "TransformInput")(_tensor_request(x)), 30)
            return big, route, e.value.code()
        finally:
            for ch in chans:
                await ch.close()
            for s in servers:
                await s.stop()

    (big, again), route, missing = asyncio.run(run())
    assert big.ByteSize() > 65535 and big == again
    # the unit computes in float32, as the port's units take float64 rows
    assert np.array_equal(np.asarray(big.data.tensor.values).reshape(64, 784),
                          (x.astype(np.float32) * 2.0).astype(np.float64))
    assert list(route.data.tensor.shape) == [1, 1] and list(route.data.tensor.values) == [0.0]
    assert missing == grpc.StatusCode.UNIMPLEMENTED


def test_a_grpc_node_in_ensemble4_is_within_1e6_of_fused():
    """ensemble4 with m3 bound ``grpc`` to the port's microservice served in
    process (``FastGrpcServer.for_unit``, m3's weights): the host engine's
    answer is the fused one's within 1e-6, and the node's calls go over
    one pooled connection."""
    doc = json.load(open("examples/ensemble4_deployment.json"))
    fused = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    rt = build_runtime("MnistClassifier", "MODEL", [Parameter.from_json_dict(
        {"name": "seed", "value": "3", "type": "INT"})], unit_name="m3", device="cpu")
    rt.state = to_device(fused.states()["m3"], "cpu")
    x = np.random.default_rng(3).random((5, 784))
    body = json.dumps({"data": {"ndarray": x.tolist()}, "meta": {"puid": "e4"}})
    dials = []

    async def run():
        server = FastGrpcServer.for_unit(rt)
        await server.start("127.0.0.1", 0)
        comps = doc["spec"]["predictors"][0]["components"]
        comps[3] = {"name": "m3", "runtime": "grpc", "host": "127.0.0.1", "port": server.port}
        host = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
        node = host.executor.runtimes["m3"]
        connect = FastGrpcChannel.connect

        async def counted(self, *a):
            dials.append(a)
            return await connect(self, *a)

        FastGrpcChannel.connect = counted
        try:
            return host, [await host.predict_json(body) for _ in range(3)], node
        finally:
            FastGrpcChannel.connect = connect
            host.close()
            await server.stop()

    try:
        want = json.loads(asyncio.run(fused.predict_json(body))[0])
        host, answers, node = asyncio.run(run())
    finally:
        fused.close()
    assert host.mode == "host" and isinstance(node, GrpcNodeRuntime) and len(dials) == 1
    for text, status in answers:
        got = json.loads(text)
        assert status == 200 and got["meta"]["puid"] == "e4"
        assert np.abs(np.asarray(got["data"]["ndarray"])
                      - np.asarray(want["data"]["ndarray"])).max() <= HOST_ATOL
    assert host.stats()["resilience"]["breakers"]["m3"]["state"] == "closed"


def _grpc_node(port, type_=UnitType.MODEL, breaker=None, budget=None):
    return make_node_runtime(
        PredictiveUnit(name="g", type=type_),
        ComponentBinding(name="g", runtime="grpc", host="127.0.0.1", port=port),
        retry_policy=RetryPolicy(max_attempts=3, base_backoff_s=0.001, max_backoff_s=0.002,
                                 rng=random.Random(0)),
        breaker=breaker, retry_budget=budget)


def test_retries_and_the_breaker_on_a_closed_port():
    """A closed port is UNAVAILABLE: predict tries three times (the shared
    budget pays two), route once; ten failed attempts open the breaker, and
    then a call is refused before any dial."""
    port = _free_port()
    breaker = CircuitBreaker("g", min_calls=10, open_s=60.0)
    budget = RetryBudget(initial_tokens=10.0)
    node = _grpc_node(port, breaker=breaker, budget=budget)
    assert isinstance(node, GrpcNodeRuntime)
    dials = []
    connect = FastGrpcChannel.connect

    async def counted(self, *a):
        dials.append(a)
        return await connect(self, *a)

    msg = SeldonMessage.from_array(np.zeros((1, 3)))

    async def run():
        FastGrpcChannel.connect = counted
        try:
            with pytest.raises(RemoteCallError, match="UNAVAILABLE"):
                await node.predict(msg)
            attempts_predict = len(dials)
            with pytest.raises(RemoteCallError, match="UNAVAILABLE"):
                await node.route(msg)
            attempts_route = len(dials) - attempts_predict
            while breaker.state != CircuitBreaker.OPEN:
                with pytest.raises(RemoteCallError):
                    await node.predict(msg)
            before = len(dials)
            with pytest.raises(BreakerOpenError):
                await node.predict(msg)
            return attempts_predict, attempts_route, len(dials) - before
        finally:
            FastGrpcChannel.connect = connect
            node.close()

    attempts_predict, attempts_route, refused_dials = asyncio.run(run())
    assert attempts_predict == 3 and attempts_route == 1 and refused_dials == 0
    assert budget.tokens < 10.0


def test_a_failure_message_is_an_answer_never_retried():
    """A server answering a FAILURE SeldonMessage (status OK on the wire) is
    called once; the failure comes back as the message it is."""
    calls = []

    async def handler(wire):
        calls.append(wire)
        return protoconv.msg_to_proto(SeldonMessage.failure("nope", code=503,
                                                            meta=Meta(puid="f")))

    async def run():
        server = FastGrpcServer({b"/seldon.protos.Model/Predict": handler})
        await server.start("127.0.0.1", 0)
        node = _grpc_node(server.port)
        try:
            return await node.predict(SeldonMessage.from_array(np.zeros((1, 2))))
        finally:
            node.close()
            await server.stop()

    resp = asyncio.run(run())
    assert len(calls) == 1 and resp.status.status == "FAILURE" and resp.status.code == 503


def test_a_lost_connection_is_dialled_again():
    """The pooled connection dropped by the server (UNAVAILABLE) is
    replaced on the retry, and the call succeeds."""
    async def echo(wire):
        return wire

    async def run():
        server = FastGrpcServer({b"/seldon.protos.Model/Predict": echo})
        await server.start("127.0.0.1", 0)
        node = _grpc_node(server.port)
        msg = SeldonMessage.from_array(np.ones((1, 2)))
        try:
            first = await node.predict(msg)
            for proto in list(server._protocols):  # the server drops the connection
                proto.transport.close()
            await asyncio.sleep(0.05)
            second = await node.predict(msg)
            return first, second
        finally:
            node.close()
            await server.stop()

    first, second = asyncio.run(run())
    assert np.array_equal(first.array(), second.array()) and first.array().tolist() == [[1, 1]]


def test_microservice_grpc_serves_and_refuses_persistence(capsys, monkeypatch):
    # --persistence 1 is taken now (runtime/persistence.py): the unit builds
    # for it; the served restore and checkpoints are in
    # tests/test_torch_persistence.py
    monkeypatch.setenv("MICROSERVICE_SMOKE_EXIT", "1")
    microservice.main(["MnistClassifier", "GRPC", "--persistence", "1", "--device", "cpu"])
    assert "smoke ok: MnistClassifier as MODEL on cpu" in capsys.readouterr().out


@pytest.mark.cuda
def test_grpc_and_wire_lanes_on_a_cuda_engine_answer_the_json_lane():
    """On the card: one engine's JSON, binary wire and gRPC answers are the
    same float64 values, and each request launches the fused MLP once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime import wire

    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc(256)), device="cuda")
    x = np.random.default_rng(4).random((64, 784))
    try:
        fused_mlp.LAUNCHES = 0
        text, _ = asyncio.run(engine.predict_json(json.dumps(
            {"data": {"tensor": {"shape": [64, 784], "values": x.ravel().tolist()}}})))
        st, parts = asyncio.run(engine.predict_wire(wire.join_parts(wire.encode_frame(x))))
        proto = asyncio.run(engine.predict_proto_wire(protoconv.msg_to_proto(
            SeldonMessage.from_array(x))))
        launches = fused_mlp.LAUNCHES
    finally:
        engine.close()
    yj = np.asarray(json.loads(text)["data"]["tensor"]["values"]).reshape(64, 10)
    yw = wire.decode_frame(wire.join_parts(parts)).array.astype(np.float64)
    yg = protoconv.msg_from_proto(proto).array()
    assert st == 200 and np.array_equal(yw, yj) and np.array_equal(yg, yj)
    assert launches == 3
