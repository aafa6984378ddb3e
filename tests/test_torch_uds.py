"""Unix sockets and the engine's lanes on the CPU: ``FastHttpServer.start_uds``
(the engine's routes, JSON and the binary wire, on a socket), the relay
(``runtime/udsrelay.py``) against the JAX package's both ways, a ``unix:``
node in a graph, and ``engine_main``'s lane contract (gRPC, the relay on
its socket and on ``ENGINE_RELAY_TCP_PORT``, the HTTP socket from the
env, ``SELDON_TPU_UDS=0``, and the refusals of ``ENGINE_GRPC_IMPL=aio`` and
of an unknown generation role)."""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.runtime import udsrelay as ref_relay
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import Parameter, SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime import engine_main, kvstream, udsrelay, wire
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.rest import FastHttpServer, _UnitRoutes, serve_fast
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-2  # bf16 MNIST weights: the reference's tolerance (tests/test_ops_pallas.py:56)


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


@pytest.fixture
def sock_dir():
    """A short directory for socket files (sun_path holds 108 bytes)."""
    d = tempfile.mkdtemp(prefix="sct")
    if len(d) > 80:
        d = tempfile.mkdtemp(prefix="sct", dir=str(ROOT / "build"))
    yield d
    for name in os.listdir(d):
        os.unlink(os.path.join(d, name))
    os.rmdir(d)


def _mnist_doc(hidden=32):
    return {"spec": {"name": "mnist", "predictors": [{
        "name": "main",
        "components": [{"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": str(hidden),
                                        "type": "INT"}]}],
        "graph": {"name": "mnist", "type": "MODEL", "children": []}}]}}


def _engine():
    return EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")


class _UnixConnection(http.client.HTTPConnection):
    def __init__(self, path):
        super().__init__("localhost", timeout=30)
        self.path_ = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(30)
        self.sock.connect(self.path_)


def _post(conn, body, ctype, path="/api/v0.1/predictions"):
    conn.request("POST", path, body, {"Content-Type": ctype})
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def _get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read()


def test_start_uds_serves_the_engine_routes(sock_dir):
    """The same routes on TCP and on the socket (a stale file replaced): a
    JSON and a binary-wire predict answer alike; stop removes the file."""
    path = os.path.join(sock_dir, "h.sock")
    Path(path).write_text("stale")
    engine = _engine()
    x = np.random.default_rng(0).random((2, 784))

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0, uds_path=path)

        def client():
            conn = _UnixConnection(path)
            try:
                return (_post(conn, json.dumps({"data": {"ndarray": x.tolist()}}),
                              "application/json"),
                        _post(conn, wire.join_parts(wire.encode_frame(x)),
                              wire.WIRE_CONTENT_TYPE),
                        _get(conn, "/ping"))
            finally:
                conn.close()

        try:
            return await asyncio.get_running_loop().run_in_executor(None, client)
        finally:
            await server.stop()

    try:
        (js, ct, raw), (wst, wct, wraw), ping = asyncio.run(run())
    finally:
        engine.close()
    assert js == wst == 200 and wct == wire.WIRE_CONTENT_TYPE
    assert np.array_equal(np.asarray(json.loads(raw)["data"]["ndarray"]),
                          wire.decode_frame(wraw).array.astype(np.float64))
    assert ping == (200, b"pong")
    assert not os.path.exists(path)


def test_relay_meta_is_the_reference_bytes():
    meta = udsrelay.pack_relay_meta(deadline_ms=120.0, tenant="t", tier="batch")
    assert meta == ref_relay.pack_relay_meta(deadline_ms=120.0, tenant="t", tier="batch")
    assert udsrelay.unpack_relay_meta(meta) == ref_relay.unpack_relay_meta(meta)
    assert udsrelay.unpack_relay_meta(b"\x07junk")["deadline_ms"] is None
    assert udsrelay.current_relay_meta() is None


def test_relay_ops_on_the_port_server(sock_dir):
    """The port's relay client on the port's server: JSON predict, the
    binary wire, ping, feedback, the unported ops' typed answers, an
    unknown op 400, a sidecar with a spent deadline, and a frame larger
    than the cap answering 413 and closing the connection."""
    path = os.path.join(sock_dir, "r.sock")
    engine = _engine()
    x = np.random.default_rng(1).random((3, 784))
    spent = udsrelay.pack_relay_meta(deadline_ms=0.001)

    async def run():
        server = await udsrelay.serve_uds(engine, path)
        client = udsrelay.make_relay_client(f"uds:{path}", pool=2)
        try:
            out = {
                "predict": await client.predict(json.dumps({"data": {"ndarray": x.tolist()}})),
                "wire": await client.call(udsrelay.OP_WIRE, wire.join_parts(wire.encode_frame(x))),
                "ping": await client.ping(),
                "feedback": await client.feedback(json.dumps(
                    {"request": {"data": {"ndarray": x[:1].tolist()}}, "reward": 1.0})),
                "kv": await client.call(udsrelay.OP_KVSTREAM, b"x"),
                "kv_stats": await client.call(udsrelay.OP_KVSTREAM, kvstream.stats_frame()),
                "trace": await client.call(udsrelay.OP_TRACE, b"{}"),
                "unknown": await client.call(42, b""),
                "torn": await client.call(udsrelay.OP_WIRE, b"SLDT\x01"),
                "late": await client.call(udsrelay.OP_WIRE, wire.join_parts(
                    wire.encode_frame(x)), meta=spent),
            }
            reader, writer = await asyncio.open_unix_connection(path)
            writer.write(udsrelay._REQ_HEAD.pack(udsrelay._MAX_FRAME + 1, udsrelay.OP_PREDICT))
            await writer.drain()
            head = await reader.readexactly(udsrelay._RESP_HEAD.size)
            out["too_large"] = udsrelay._RESP_HEAD.unpack(head)[1]
            await reader.readexactly(udsrelay._RESP_HEAD.unpack(head)[0])
            out["closed"] = await reader.read() == b""
            writer.close()
            return out
        finally:
            await client.close()
            await server.stop()

    try:
        out = asyncio.run(run())
    finally:
        engine.close()
    text, status = out["predict"]
    body, wst = out["wire"]
    assert status == wst == 200 and out["ping"]
    assert np.array_equal(np.asarray(json.loads(text)["data"]["ndarray"]),
                          wire.decode_frame(body).array.astype(np.float64))
    assert out["feedback"][1] == 200
    # KV frames reach the engine's kv_frame: a torn one is a 400, and an
    # engine with no generation scheduler takes no hand-off
    assert out["kv"][1] == 400 and b"short KV-stream frame" in out["kv"][0]
    assert out["kv_stats"][1] == 503 and b"no generation scheduler" in out["kv_stats"][0]
    # OP_TRACE answers the engine's local trace document
    assert out["trace"][1] == 200 and "spans" in json.loads(out["trace"][0])
    assert out["unknown"][1] == 400 and out["torn"][1] == 400
    # the sidecar's spent deadline: a 504 frame before any dispatch
    assert out["late"][1] == 504 and wire.decode_frame(out["late"][0]).status == 504
    assert out["too_large"] == 413 and out["closed"] and not os.path.exists(path)


@pytest.mark.parametrize("direction", ["reference-client", "port-client"])
def test_relay_interoperates_with_the_reference(direction, sock_dir):
    """The reference's relay client on the port's server, and the port's
    client on the reference's server (the JAX engine), answer the same
    probabilities within MNIST's tolerance over OP_WIRE and OP_PREDICT."""
    path = os.path.join(sock_dir, "i.sock")
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    engine = _engine()
    engine.load_states({"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in jax_engine.states()["mnist"].items()}, device="cpu")})
    x = np.random.default_rng(2).random((4, 784))
    frame = wire.join_parts(wire.encode_frame(x))

    async def run():
        if direction == "reference-client":
            server = await udsrelay.serve_uds(engine, path)
            client = ref_relay.UdsRelayClient(path)
        else:
            server = await ref_relay.serve_uds(jax_engine, path)
            client = udsrelay.UdsRelayClient(path)
        try:
            return (await client.call(udsrelay.OP_WIRE, frame),
                    await client.predict(json.dumps({"data": {"ndarray": x.tolist()}})))
        finally:
            await client.close()
            await server.stop()

    try:
        (body, st), (text, jst) = asyncio.run(run())
        want = json.loads(asyncio.run(engine.predict_json(
            json.dumps({"data": {"ndarray": x.tolist()}})))[0])["data"]["ndarray"]
    finally:
        engine.close()
    assert st == jst == 200
    assert np.abs(wire.decode_frame(body).array - np.asarray(want)).max() < ATOL
    assert np.abs(np.asarray(json.loads(text)["data"]["ndarray"]) - want).max() < ATOL


def test_tcp_relay_specs_are_refused_naming_item_6():
    """Since the TCP relay was ported ([6d]) a ``tcp:host:port`` spec dials
    it; a malformed one is still refused."""
    client = udsrelay.make_relay_client("tcp:127.0.0.1:9")
    assert isinstance(client, udsrelay.TcpRelayClient)
    assert (client.host, client.port, client.path) == ("127.0.0.1", 9, "tcp:127.0.0.1:9")
    for bad in ("tcp:127.0.0.1", "tcp::9", "tcp:h:x"):
        with pytest.raises(ValueError, match="bad tcp relay spec"):
            udsrelay.make_relay_client(bad)
    assert udsrelay.make_relay_client("uds:/tmp/x.sock").path == "/tmp/x.sock"
    assert udsrelay.make_relay_client("/tmp/y.sock").path == "/tmp/y.sock"
    with pytest.raises(ValueError):
        udsrelay.make_relay_client("uds:")


def test_a_unix_node_in_a_graph(sock_dir):
    """A REST node whose host is ``unix:/path``: the unit microservice's
    routes on a socket; the engine's answer is its all-in-process answer,
    the predict riding the binary wire."""
    import tests.test_torch_fusion  # noqa: F401  (registers the port's test.* units)

    path = os.path.join(sock_dir, "n.sock")
    graph = {"name": "t", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
    comps = [{"name": "t", "runtime": "inprocess", "class_path": "test.AddTag"},
             {"name": "m", "runtime": "inprocess", "class_path": "test.Scale",
              "parameters": [{"name": "factor", "value": "3.0", "type": "FLOAT"}]}]
    doc = {"spec": {"name": "u", "predictors": [{"name": "p", "graph": graph,
                                                 "components": comps}]}}
    local = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu",
                          batching=False)
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    want = json.loads(asyncio.run(local.predict_json(body))[0])
    local.close()
    rt = build_runtime("test.Scale", "MODEL", [Parameter.from_json_dict(
        {"name": "factor", "value": "3.0", "type": "FLOAT"})], unit_name="m", device="cpu")

    async def run():
        server = FastHttpServer(routes=_UnitRoutes(rt))
        await server.start_uds(path)
        remote = json.loads(json.dumps(doc))
        remote["spec"]["predictors"][0]["components"][1] = {
            "name": "m", "runtime": "rest", "host": f"unix:{path}"}
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(remote), device="cpu")
        try:
            answers = [await engine.predict_json(body) for _ in range(2)]
            return engine, answers
        finally:
            engine.close()
            await server.stop()

    engine, answers = asyncio.run(run())
    node = engine.executor.runtimes["m"]
    assert engine.mode == "host" and node._wire_ok
    for text, status in answers:
        got = json.loads(text)
        assert status == 200 and got["data"] == want["data"]
        assert got["meta"]["tags"] == want["meta"]["tags"]


def test_engine_main_refuses_aio_and_the_tcp_relay(monkeypatch, capsys):
    deployment = engine_main.load_deployment_from_env("examples/mnist_deployment.json")
    monkeypatch.setenv("ENGINE_GRPC_IMPL", "aio")
    with pytest.raises(SystemExit, match="grpcio"):
        asyncio.run(engine_main.serve(deployment, device="cpu"))
    monkeypatch.setenv("ENGINE_GRPC_IMPL", "native")
    engine_main.check_grpc_impl()
    assert "native gRPC lane unavailable" in capsys.readouterr().out
    monkeypatch.setenv("ENGINE_GRPC_IMPL", "fast")
    # ENGINE_RELAY_TCP_PORT binds the relay since [6d] (the lane test
    # below); an unknown generation role is refused, by the flag and the env
    with pytest.raises(SystemExit):
        engine_main.main(["--gen-role", "both"])
    monkeypatch.setenv("ENGINE_GEN_ROLE", "both")
    with pytest.raises(ValueError, match="unknown generation role 'both'"):
        asyncio.run(engine_main.serve(deployment, device="cpu"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("uds", ["on", "off"])
def test_engine_main_binds_every_lane_from_the_env(uds, sock_dir):
    """engine_main with ENGINE_SERVER_GRPC_PORT, ENGINE_UDS_PATH and
    ENGINE_HTTP_UDS_PATH: the "engine up" line names every lane, each
    answers, and SIGTERM removes the sockets; with SELDON_TPU_UDS=0 neither
    socket is bound."""
    rest, grpc_port, relay_tcp = _free_port(), _free_port(), _free_port()
    relay, http_uds = os.path.join(sock_dir, "r.sock"), os.path.join(sock_dir, "h.sock")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", ENGINE_SHUTDOWN_DRAIN_S="5",
               ENGINE_SERVER_GRPC_PORT=str(grpc_port), ENGINE_RELAY_TCP_PORT=str(relay_tcp),
               ENGINE_UDS_PATH=relay,
               ENGINE_HTTP_UDS_PATH=http_uds, SELDON_TPU_UDS="1" if uds == "on" else "0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main", "--file",
         "examples/mnist_deployment.json", "--device", "cpu", "--host", "127.0.0.1",
         "--rest-port", str(rest)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    x = np.random.default_rng(3).random((1, 784))
    try:
        line = proc.stdout.readline()
        assert line.startswith("engine up:") and f"grpc=:{grpc_port}" in line, line
        assert f"relay-tcp=:{relay_tcp}" in line and "role=unified" in line, line
        assert (f"uds={relay}" in line and f"http-uds={http_uds}" in line) == (uds == "on")
        assert os.path.exists(relay) == os.path.exists(http_uds) == (uds == "on")

        async def lanes():
            ch = await FastGrpcChannel().connect("127.0.0.1", grpc_port)
            try:
                out = [protoconv.msg_from_proto(await ch.call(
                    b"/seldon.protos.Seldon/Predict",
                    protoconv.msg_to_proto(SeldonMessage.from_array(x)))).array()]
            finally:
                await ch.close()
            client = udsrelay.make_relay_client(f"tcp:127.0.0.1:{relay_tcp}")
            try:
                body, st = await client.call(udsrelay.OP_WIRE, wire.join_parts(
                    wire.encode_frame(x)))
                out.append(wire.decode_frame(body).array)
            finally:
                await client.close()
            if uds == "on":
                client = udsrelay.UdsRelayClient(relay)
                try:
                    body, st = await client.call(udsrelay.OP_WIRE, wire.join_parts(
                        wire.encode_frame(x)))
                    out.append(wire.decode_frame(body).array)
                finally:
                    await client.close()
            return out

        answers = asyncio.run(lanes())
        conn = http.client.HTTPConnection("127.0.0.1", rest, timeout=30)
        st, _, raw = _post(conn, json.dumps({"data": {"ndarray": x.tolist()}}),
                           "application/json")
        conn.close()
        want = np.asarray(json.loads(raw)["data"]["ndarray"])
        if uds == "on":
            conn = _UnixConnection(http_uds)
            answers.append(np.asarray(json.loads(_post(conn, json.dumps(
                {"data": {"ndarray": x.tolist()}}), "application/json")[2])["data"]["ndarray"]))
            conn.close()
        assert st == 200 and len(answers) == (4 if uds == "on" else 2)
        for a in answers:
            assert np.array_equal(np.asarray(a, np.float64), want)
        proc.send_signal(signal.SIGTERM)
        rest_out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0 and "engine stopped" in rest_out
    assert not os.path.exists(relay) and not os.path.exists(http_uds)
