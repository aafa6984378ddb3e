"""Remote REST nodes on the CPU: the wire held both ways on localhost (the
port's engine dialing the JAX package's ``make_unit_app``, and the JAX
engine dialing the port's unit microservice) against the all-in-process
answers, the client's deadline, retry, idempotency and breaker rules
against a stub server, a stale keep-alive socket, quorum with a dead node
in the engine's ``/ready`` and ``/stats``, and the microservice's entry
point."""

import asyncio
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.test_graph_fusion  # noqa: F401  (registers the JAX fuse.* units)
import tests.test_torch_fusion  # noqa: F401  (registers the port's test.* and fuse.* units)
from seldon_core_tpu.graph.interpreter import InProcessNodeRuntime as JaxInProcess
from seldon_core_tpu.graph.spec import PredictiveUnit as JaxUnitNode
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.graph.spec import UnitType as JaxUnitType
from seldon_core_tpu.graph.units import UNIT_REGISTRY as JAX_UNITS
from seldon_core_tpu.messages import Feedback as JaxFeedback
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.runtime.rest import make_unit_app, serve_app
from seldon_core_tpu_torch.graph.spec import (
    ComponentBinding,
    Parameter,
    PredictiveUnit,
    SeldonDeploymentSpec,
    UnitType,
)
from seldon_core_tpu_torch.messages import DeadlineExceededError, Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime import microservice
from seldon_core_tpu_torch.runtime.client import RemoteCallError, RestNodeRuntime
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.resilience import (
    BreakerOpenError,
    CircuitBreaker,
    RetryBudget,
    RetryPolicy,
    deadline_scope,
)
from seldon_core_tpu_torch.runtime.rest import serve_fast, serve_unit
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ROOT = Path(__file__).resolve().parents[1]


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


def _doc(graph, components):
    return {"spec": {"name": "wire", "predictors": [{"name": "p", "graph": graph,
                                                     "components": components}]}}


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(-8, 8, size=shape).astype(np.float64)


# the wire graph: every internal-API method crosses it
#   out (OUTPUT_TRANSFORMER) -> t (TRANSFORMER) -> comb (COMBINER) -> [s1, s2]
WIRE = {"name": "out", "type": "OUTPUT_TRANSFORMER", "children": [{
    "name": "t", "type": "TRANSFORMER", "children": [{
        "name": "comb", "type": "COMBINER", "children": [
            {"name": "s1", "type": "MODEL"}, {"name": "s2", "type": "MODEL"}]}]}]}
WIRE_UNITS = {  # node -> (class path, parameters, type)
    "out": ("fuse.Bias", [{"name": "bias", "value": "0.5", "type": "FLOAT"}],
            "OUTPUT_TRANSFORMER"),
    "t": ("test.AddTag", [], "TRANSFORMER"),
    "comb": ("AVERAGE_COMBINER", [], "COMBINER"),
    "s1": ("test.Scale", [{"name": "factor", "value": "3.0", "type": "FLOAT"}], "MODEL"),
    "s2": ("test.Scale", [{"name": "factor", "value": "-1.0", "type": "FLOAT"}], "MODEL"),
}
REMOTE = ("out", "t", "comb", "s1")  # s2 stays in process on the engine's side
ROUTER = {"name": "r", "type": "ROUTER", "children": [{"name": "a", "type": "MODEL"},
                                                     {"name": "b", "type": "MODEL"}]}
ROUTER_UNITS = {"r": ("test.CountingRouter", [], "ROUTER"),
                "a": ("test.Scale", [{"name": "factor", "value": "10.0", "type": "FLOAT"}],
                      "MODEL"),
                "b": ("test.Scale", [{"name": "factor", "value": "-10.0", "type": "FLOAT"}],
                      "MODEL")}


def _components(units, remote=(), ports=None):
    comps = []
    for name, (cls, params, _) in units.items():
        if name in remote:
            comps.append({"name": name, "runtime": "rest", "host": "127.0.0.1",
                          "port": ports[name]})
        else:
            comps.append({"name": name, "runtime": "inprocess", "class_path": cls,
                          "parameters": params})
    return comps


async def _jax_unit_servers(units, names):
    """One JAX ``make_unit_app`` per named node, on free localhost ports."""
    runners, ports = [], {}
    for name in names:
        cls, params, typ = units[name]
        from seldon_core_tpu.graph.spec import Parameter as JaxParameter
        from seldon_core_tpu.graph.spec import params_to_kwargs as jax_kwargs

        unit = JAX_UNITS[cls](**jax_kwargs([JaxParameter.from_json_dict(p) for p in params]))
        rt = JaxInProcess(JaxUnitNode(name=name, type=JaxUnitType[typ]), unit)
        ports[name] = _free_port()
        runners.append(await serve_app(make_unit_app(rt), "127.0.0.1", ports[name]))
    return runners, ports


async def _port_unit_servers(units, names):
    """One port unit microservice per named node, on free localhost ports."""
    servers, ports, runtimes = [], {}, {}
    for name in names:
        cls, params, typ = units[name]
        from seldon_core_tpu_torch.graph.spec import Parameter

        # the wrapper's service types have no OUTPUT_TRANSFORMER (the
        # reference's neither): /transform-output serves whatever the type
        service = "TRANSFORMER" if typ == "OUTPUT_TRANSFORMER" else typ
        runtimes[name] = build_runtime(cls, service, [Parameter.from_json_dict(p)
                                                      for p in params],
                                       unit_name=name, device="cpu")
        server = await serve_unit(runtimes[name], "127.0.0.1", 0)
        servers.append(server)
        ports[name] = server.port
    return servers, ports, runtimes


def _answer(text):
    doc = json.loads(text)
    return doc["data"], doc["meta"].get("routing", {}), doc["meta"].get("tags", {})


def test_port_engine_dials_the_jax_unit_app():
    """The port's host-mode engine with four REST nodes served by the JAX
    package's unit app answers the JAX engine's all-in-process answer:
    the same data, names, routing and tags (predict, transform-input,
    transform-output and aggregate all cross the wire)."""
    x = _ints(0, (3, 4))
    body = json.dumps({"data": {"ndarray": x.tolist()}, "meta": {"puid": "w"}})
    # no batcher on the reference side: its padded rows would enter the
    # batch mean that AddTag tags
    want = asyncio.run(JaxEngine(JaxSpec.from_json_dict(
        _doc(WIRE, _components(WIRE_UNITS))), batching=False).predict_json(body))

    async def run():
        runners, ports = await _jax_unit_servers(WIRE_UNITS, REMOTE)
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(
            _doc(WIRE, _components(WIRE_UNITS, REMOTE, ports))), device="cpu")
        try:
            return engine, [await engine.predict_json(body) for _ in range(2)]
        finally:
            engine.close()
            for r in runners:
                await r.cleanup()

    engine, answers = asyncio.run(run())
    assert engine.mode == "host" and set(engine.breakers) == set(REMOTE)
    for text, status in answers:
        assert status == 200 == want[1]
        assert _answer(text) == _answer(want[0])
    assert json.loads(answers[0][0])["meta"]["puid"] == "w"


def test_jax_engine_dials_the_port_unit_microservice():
    """The JAX engine with four REST nodes served by the port's unit
    microservice (its predicts ride the binary wire, which the port's unit
    answers in kind)
    answers the port's all-in-process answer, and the JAX one."""
    x = _ints(1, (2, 4))
    body = json.dumps({"data": {"tensor": {"shape": [2, 4], "values": x.ravel().tolist()}}})
    local = EngineService(SeldonDeploymentSpec.from_json_dict(
        _doc(WIRE, _components(WIRE_UNITS))), device="cpu", batching=False)
    want = asyncio.run(local.predict_json(body))
    local.close()
    jwant = asyncio.run(JaxEngine(JaxSpec.from_json_dict(
        _doc(WIRE, _components(WIRE_UNITS))), batching=False).predict_json(body))

    async def run():
        servers, ports, _ = await _port_unit_servers(WIRE_UNITS, REMOTE)
        engine = JaxEngine(JaxSpec.from_json_dict(_doc(WIRE, _components(WIRE_UNITS, REMOTE,
                                                                          ports))))
        try:
            return engine, [await engine.predict_json(body) for _ in range(2)]
        finally:
            await engine.close()
            for s in servers:
                await s.stop()

    engine, answers = asyncio.run(run())
    assert engine.mode == "host"
    for text, status in answers:
        assert status == 200 == want[1] == jwant[1]
        assert _answer(text) == _answer(want[0]) == _answer(jwant[0])


def test_a_transformer_tensor_crosses_the_wire_encoded_off_the_loop(monkeypatch):
    """An in-process TRANSFORMER in front of a REST MODEL: the transformer's
    output, still a tensor, is encoded on the engine's dispatch threads,
    never on the event loop, and the answer is the port's and the JAX
    engine's all-in-process answer.  The JSON lane (the binary wire's
    switch off: its encoder is held the same way in
    ``test_a_transformer_tensor_rides_the_binary_wire_encoded_off_the_loop``)."""
    monkeypatch.setenv("SELDON_TPU_WIRE", "0")
    graph = {"name": "t", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
    units = {"t": WIRE_UNITS["t"], "m": WIRE_UNITS["s1"]}
    x = _ints(5, (3, 4))
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    local = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(graph, _components(units))),
                          device="cpu", batching=False)
    want = asyncio.run(local.predict_json(body))
    local.close()
    jwant = asyncio.run(JaxEngine(JaxSpec.from_json_dict(_doc(graph, _components(units))),
                                  batching=False).predict_json(body))
    encoded = []  # (thread, whether the payload was a tensor) of each encode
    to_json = SeldonMessage.to_json

    def spy(msg):
        encoded.append((threading.get_ident(),
                        msg.data is not None and isinstance(msg.data.array, torch.Tensor)))
        return to_json(msg)

    monkeypatch.setattr(SeldonMessage, "to_json", spy)

    async def run():
        # the unit server gets a pool too, so no side encodes on the loop
        cls, params, typ = units["m"]
        server = await serve_unit(build_runtime(
            cls, typ, [Parameter.from_json_dict(p) for p in params], unit_name="m",
            device="cpu", executor=pool), "127.0.0.1", 0)
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(
            _doc(graph, _components(units, ("m",), {"m": server.port}))), device="cpu")
        try:
            return engine, threading.get_ident(), await engine.predict_json(body)
        finally:
            engine.close()
            await server.stop()

    with ThreadPoolExecutor(1) as pool:
        engine, loop_thread, (text, status) = asyncio.run(run())
    assert engine.mode == "host" and set(engine.breakers) == {"m"}
    assert status == 200 == want[1] == jwant[1]
    assert _answer(text) == _answer(want[0]) == _answer(jwant[0])
    tensor_threads = [thread for thread, tensor in encoded if tensor]
    assert tensor_threads and loop_thread not in tensor_threads


def test_a_transformer_tensor_rides_the_binary_wire_encoded_off_the_loop(monkeypatch):
    """The same graph with the binary wire on (the default): the REST
    MODEL's predict goes as a frame, framed from the transformer's tensor
    on the engine's dispatch threads, never on the event loop; the unit
    answers a frame, and the answer is the JSON lane's."""
    from seldon_core_tpu_torch.runtime import wire

    graph = {"name": "t", "type": "TRANSFORMER", "children": [{"name": "m", "type": "MODEL"}]}
    units = {"t": WIRE_UNITS["t"], "m": WIRE_UNITS["s1"]}
    x = _ints(5, (3, 4))
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    local = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(graph, _components(units))),
                          device="cpu", batching=False)
    want = asyncio.run(local.predict_json(body))
    local.close()
    framed = []  # (thread, whether the payload was a tensor) of each request frame
    frame_from_message = wire.frame_from_message

    def spy(msg, **kw):
        if not kw.get("response"):
            framed.append((threading.get_ident(), isinstance(msg.data.array, torch.Tensor)))
        return frame_from_message(msg, **kw)

    monkeypatch.setattr(wire, "frame_from_message", spy)

    async def run():
        cls, params, typ = units["m"]
        server = await serve_unit(build_runtime(
            cls, typ, [Parameter.from_json_dict(p) for p in params], unit_name="m",
            device="cpu", executor=pool), "127.0.0.1", 0)
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(
            _doc(graph, _components(units, ("m",), {"m": server.port}))), device="cpu")
        try:
            return engine, threading.get_ident(), await engine.predict_json(body)
        finally:
            engine.close()
            await server.stop()

    with ThreadPoolExecutor(1) as pool:
        engine, loop_thread, (text, status) = asyncio.run(run())
    assert engine.executor.runtimes["m"]._wire_ok
    assert status == 200 == want[1] and _answer(text) == _answer(want[0])
    assert framed and all(tensor for _, tensor in framed)
    assert loop_thread not in [thread for thread, _ in framed]


@pytest.mark.parametrize("direction", ["port-engine", "jax-engine"])
def test_remote_router_routes_and_trains_over_the_wire(direction):
    """A REST-bound router: /route picks the branch, /send-feedback trains
    the remote router (never retried), and the next request routes where
    the reward went, whichever side serves the unit."""
    x = _ints(2, (2, 3))
    body = json.dumps({"data": {"ndarray": x.tolist()}})

    async def run():
        if direction == "port-engine":
            runners, ports = await _jax_unit_servers(ROUTER_UNITS, ("r", "a"))
            make = lambda d: EngineService(SeldonDeploymentSpec.from_json_dict(d),  # noqa: E731
                                           device="cpu")
            fb_type = Feedback
        else:
            servers, ports, runtimes = await _port_unit_servers(ROUTER_UNITS, ("r", "a"))
            make = lambda d: JaxEngine(JaxSpec.from_json_dict(d))  # noqa: E731
            fb_type = JaxFeedback
        engine = make(_doc(ROUTER, _components(ROUTER_UNITS, ("r", "a"), ports)))
        try:
            first = await engine.predict_json(body)
            resp = json.loads(first[0])
            resp["meta"]["routing"]["r"] = 1
            fb = fb_type.from_json(json.dumps({"request": json.loads(body), "response": resp,
                                               "reward": 4.0}))
            ack = await engine.send_feedback(fb)
            second = await engine.predict_json(body)
        finally:
            if direction == "port-engine":
                engine.close()
                for r in runners:
                    await r.cleanup()
            else:
                await engine.close()
                for s in servers:
                    await s.stop()
        state = None if direction == "port-engine" else runtimes["r"].state
        return engine, first, ack, second, state

    engine, first, ack, second, state = asyncio.run(run())
    assert engine.mode == "host"
    assert first[1] == second[1] == 200
    assert json.loads(first[0])["meta"]["routing"] == {"r": 0}
    assert json.loads(first[0])["data"]["ndarray"] == (x * 10.0).tolist()
    assert ack.status.status == "SUCCESS" and ack.status.code == 200  # host mode's ack
    assert json.loads(second[0])["meta"]["routing"] == {"r": 1}
    assert json.loads(second[0])["data"]["ndarray"] == (x * -10.0).tolist()
    if state is not None:
        assert state["rewards"].tolist() == [0.0, 4.0] and state["counts"].tolist() == [0.0, 1.0]


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body, {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_unit_microservice_routes_deadline_and_media_type():
    """The unit API answers each route; a spent Seldon-Deadline-Ms budget on
    arrival is a 504, a torn binary tensor frame a typed 400 (a whole one is
    answered in kind: tests/test_torch_wire.py), a malformed body a 400, a
    method the unit lacks a 501; /ping and /stats answer."""
    async def run():
        servers, ports, _ = await _port_unit_servers(ROUTER_UNITS, ("r", "a"))
        loop = asyncio.get_running_loop()
        msg = json.dumps({"data": {"ndarray": [[1.0, 2.0]]}, "meta": {"puid": "q"}})

        def client():
            pa, pr = ports["a"], ports["r"]
            return {
                "predict": _post(pa, "/predict", msg),
                "form": _post(pa, "/predict", "json=" + json.dumps({"data": {"ndarray": [[3.0]]}}),
                              {"Content-Type": "application/x-www-form-urlencoded"}),
                "route": _post(pr, "/route", msg),
                "late": _post(pa, "/predict", msg, {"Seldon-Deadline-Ms": "0.001"}),
                "budget": _post(pa, "/predict", msg, {"Seldon-Deadline-Ms": "60000"}),
                "wire": _post(pa, "/predict", b"\x00\x01",
                              {"Content-Type": "application/x-seldon-tensor"}),
                "bad": _post(pa, "/predict", "{oops"),
                "lacking": _post(pa, "/route", msg),
                "feedback": _post(pr, "/send-feedback", json.dumps(
                    {"request": json.loads(msg), "response": {"meta": {"routing": {"r": 1}}},
                     "reward": 2.0})),
            }

        try:
            out = await loop.run_in_executor(None, client)
            conn_out = await loop.run_in_executor(None, lambda: [
                _get(ports["a"], "/ping"), _get(ports["a"], "/stats")])
        finally:
            for s in servers:
                await s.stop()
        return out, conn_out

    out, (ping, stats) = asyncio.run(run())
    assert out["predict"][0] == 200
    assert json.loads(out["predict"][1])["data"]["ndarray"] == [[10.0, 20.0]]
    assert json.loads(out["predict"][1])["meta"]["puid"] == "q"
    assert json.loads(out["form"][1])["data"]["ndarray"] == [[30.0]]
    assert json.loads(out["route"][1])["data"]["ndarray"] == [[0.0]]
    assert out["late"][0] == 504 and b"exhausted on arrival" in out["late"][1]
    assert out["budget"][0] == 200
    assert out["wire"][0] == 400 and b"truncated wire header" in out["wire"][1]
    assert out["bad"][0] == 400 and out["lacking"][0] == 501
    assert out["feedback"][0] == 200
    assert ping == (200, b"pong")
    assert json.loads(stats[1])["unit"]["name"] == "a" and json.loads(stats[1])["device"] == "cpu"


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# the client's rules against a stub server
# ---------------------------------------------------------------------------

OK = json.dumps({"data": {"ndarray": [[1.0]]}, "meta": {"puid": "s"}}).encode()


class Stub:
    """A scripted HTTP/1.1 peer: each request takes the next action, (status,
    body), "hang" or "reply-then-close"; past the script it answers 200.
    It records each request's path, headers and body."""

    def __init__(self, script=()):
        self.script = list(script)
        self.requests = []
        self.server = None
        self.port = None

    async def start(self):
        self.server = await asyncio.start_server(self._serve, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        self.server.close()

    async def _serve(self, reader, writer):
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                headers = {k.strip().lower(): v.strip() for k, _, v in
                           (ln.partition(":") for ln in lines[1:] if ln)}
                body = await reader.readexactly(int(headers.get("content-length", 0)))
                self.requests.append((lines[0].split(" ")[1], headers, body))
                action = self.script.pop(0) if self.script else (200, OK)
                if action == "hang":
                    await asyncio.sleep(30)
                    return
                close = action == "reply-then-close"
                status, payload = (200, OK) if close else action
                writer.write(b"HTTP/1.1 %d X\r\nContent-Length: %d\r\n"
                             b"Content-Type: application/json\r\n\r\n%s"
                             % (status, len(payload), payload))
                await writer.drain()
                if close:
                    writer.close()
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            return


def _client(port, breaker=None, budget=None, policy=None, name="n"):
    return RestNodeRuntime(
        PredictiveUnit(name=name, type=UnitType.MODEL),
        ComponentBinding(name=name, runtime="rest", host="127.0.0.1", port=port,
                         image="seldonio/model:0.4"),
        timeout_s=2.0, breaker=breaker, retry_budget=budget,
        retry_policy=policy or RetryPolicy(rng=random.Random(0), base_backoff_s=0.001))


def _msg():
    return SeldonMessage.from_array(np.ones((1, 2)))


def test_transient_statuses_retry_idempotent_methods_only(monkeypatch):
    """503s retry a predict to its answer, each request with the identity
    headers; a route and a send-feedback get one attempt; a 500 is never
    retried.  On the JSON lane (the wire's negotiation has its own test)."""
    monkeypatch.setenv("SELDON_TPU_WIRE", "0")
    async def run():
        stub = await Stub([(503, b"busy"), (503, b"busy"), (200, OK),
                           (503, b"busy"), (503, b"busy"), (500, b"bug")]).start()
        breaker = CircuitBreaker("n")
        rt = _client(stub.port, breaker=breaker, budget=RetryBudget())
        try:
            out = await rt.predict(_msg())
            errors = []
            for call in (rt.route(_msg()), rt.send_feedback(Feedback(reward=1.0), 0),
                         rt.transform_input(_msg())):
                try:
                    await call
                except RemoteCallError as e:
                    errors.append(str(e))
        finally:
            rt.close()
            await stub.stop()
        return out, errors, stub.requests, breaker

    out, errors, requests, breaker = asyncio.run(run())
    assert out.array().tolist() == [[1.0]]
    assert [r[0] for r in requests] == ["/predict"] * 3 + ["/route", "/send-feedback",
                                                           "/transform-input"]
    assert len(errors) == 3 and "HTTP 503" in errors[0] and "HTTP 500" in errors[2]
    headers = requests[0][1]
    assert (headers["seldon-model-name"], headers["seldon-model-image"],
            headers["seldon-model-version"]) == ("n", "seldonio/model", "0.4")
    assert headers["content-type"] == "application/json"
    assert "seldon-deadline-ms" not in headers
    assert breaker.snapshot()["window_failures"] == 5  # four 503s and the 500


def test_the_binary_wire_negotiates_down_to_json():
    """A predict goes as a frame first (the reference's negotiation): a 503
    to a frame is retried as a frame; a JSON 415 turns the node's wire off
    and the same attempt goes again as JSON (a breaker success, not a
    failure); later predicts are JSON.  A JSON 200 to a frame is taken, and
    also turns the wire off."""
    from seldon_core_tpu_torch.runtime import wire

    async def run():
        stub = await Stub([(503, b"busy"), (415, b"no frames"), (200, OK), (200, OK),
                           (200, OK)]).start()
        lenient = await Stub([(200, OK)]).start()
        breaker = CircuitBreaker("n")
        rt = _client(stub.port, breaker=breaker, budget=RetryBudget())
        rt2 = _client(lenient.port)
        try:
            first = await rt.predict(_msg())
            second = await rt.predict(_msg())
            taken = await rt2.predict(_msg())
            return first, second, taken, stub.requests, lenient.requests, rt, rt2, breaker
        finally:
            rt.close()
            rt2.close()
            await stub.stop()
            await lenient.stop()

    first, second, taken, requests, lenient, rt, rt2, breaker = asyncio.run(run())
    assert first.array().tolist() == second.array().tolist() == taken.array().tolist() == [[1.0]]
    ctypes = [r[1]["content-type"] for r in requests]
    assert ctypes == [wire.WIRE_CONTENT_TYPE] * 2 + ["application/json"] * 2
    assert wire.decode_frame(requests[0][2]).array.tolist() == [[1.0, 1.0]]
    assert not rt._wire_ok and not rt2._wire_ok
    assert lenient[0][1]["content-type"] == wire.WIRE_CONTENT_TYPE
    assert breaker.snapshot()["window_failures"] == 1  # the 503; the 415 is no failure


def test_a_4xx_is_the_callers_fault_and_the_budget_caps_retries(monkeypatch):
    # on the JSON lane: a 400 to a frame would negotiate the wire down
    monkeypatch.setenv("SELDON_TPU_WIRE", "0")

    async def run():
        stub = await Stub([(400, b"bad"), (503, b"busy"), (503, b"busy")]).start()
        breaker = CircuitBreaker("n")
        rt = _client(stub.port, breaker=breaker, budget=RetryBudget(initial_tokens=0.0))
        errs = []
        try:
            for _ in range(2):
                try:
                    await rt.predict(_msg())
                except RemoteCallError as e:
                    errs.append(str(e))
        finally:
            rt.close()
            await stub.stop()
        return errs, stub.requests, breaker

    errs, requests, breaker = asyncio.run(run())
    assert "HTTP 400" in errs[0] and "HTTP 503" in errs[1]
    assert len(requests) == 2  # no token in the budget: the 503 is not retried
    assert breaker.snapshot()["window_failures"] == 1 and breaker.snapshot()["window_calls"] == 2


def test_deadline_is_forwarded_and_clamps_each_attempt():
    """With a deadline in force the header carries the remainder; a hung
    peer costs the remaining budget, not a fresh timeout, and an expired
    budget raises DeadlineExceededError before any I/O."""
    async def run():
        stub = await Stub([(200, OK), "hang"]).start()
        rt = _client(stub.port)
        loop = asyncio.get_running_loop()
        try:
            with deadline_scope(5.0):
                await rt.predict(_msg())
            t0 = loop.time()
            with deadline_scope(0.2):
                try:
                    await rt.predict(_msg())
                except RemoteCallError as e:
                    hung = (str(e), loop.time() - t0)
            with deadline_scope(-1.0):
                try:
                    await rt.predict(_msg())
                except DeadlineExceededError as e:
                    expired = str(e)
        finally:
            rt.close()
            await stub.stop()
        return stub.requests, hung, expired

    requests, (hung_err, hung_s), expired = asyncio.run(run())
    assert 0 < int(requests[0][1]["seldon-deadline-ms"]) <= 5000
    assert "TimeoutError" in hung_err and hung_s < 1.5
    assert len(requests) == 2 and "exhausted before rest:n" in expired


@pytest.mark.parametrize("case", ["test_breaker_opens_on_failure_rate",
                                  "test_breaker_half_open_probe_closes_or_reopens",
                                  "test_breaker_window_slides"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_references_breaker_cases_pass_on_both_breakers(case, package, monkeypatch):
    """``tests/test_resilience.py``'s three breaker cases, which call
    ``record_success`` and ``record_failure`` (the reference's aliases of
    ``record(True)`` and ``record(False)``), run against the reference's
    ``CircuitBreaker`` and against the port's in its place."""
    import tests.test_resilience as ref

    if package == "torch":
        monkeypatch.setattr(ref, "CircuitBreaker", CircuitBreaker)
    getattr(ref, case)()


def test_breaker_opens_fails_fast_and_closes_on_a_probe():
    """Failures open the breaker; an open breaker refuses with no request
    (503); after its cooldown one probe is let through and its success
    closes it."""
    now = [0.0]

    async def run():
        dead = _free_port()  # nothing listens: refused connections
        breaker = CircuitBreaker("n", min_calls=3, open_s=5.0, clock=lambda: now[0])
        rt = _client(dead, breaker=breaker, budget=RetryBudget())
        try:
            with pytest.raises(RemoteCallError, match="ConnectionRefusedError"):
                await rt.predict(_msg())
            assert breaker.state == "open"
            with pytest.raises(BreakerOpenError) as e:
                await rt.predict(_msg())
            assert e.value.http_code == 503
            stub = await Stub().start()
            rt.port = stub.port
            now[0] += 6.0  # past the cooldown: half-open, one probe
            out = await rt.predict(_msg())
            await stub.stop()
        finally:
            rt.close()
        return out, breaker, stub.requests

    out, breaker, requests = asyncio.run(run())
    assert out.array().tolist() == [[1.0]] and len(requests) == 1
    assert breaker.state == "closed" and breaker.transitions == {"open": 1, "half_open": 1,
                                                                 "closed": 1}


def test_a_stale_keepalive_socket_is_dropped_not_counted():
    """A pooled connection the peer closed is found dead before reuse: the
    next call dials afresh and the breaker records no failure."""
    async def run():
        stub = await Stub([(200, OK), "reply-then-close", (200, OK)]).start()
        breaker = CircuitBreaker("n")
        rt = _client(stub.port, breaker=breaker)
        try:
            await rt.predict(_msg())
            await rt.predict(_msg())  # the peer closes after answering
            await asyncio.sleep(0.05)
            await rt.predict(_msg())
        finally:
            rt.close()
            await stub.stop()
        return breaker, stub.requests

    breaker, requests = asyncio.run(run())
    assert len(requests) == 3
    assert breaker.snapshot()["window_failures"] == 0


# ---------------------------------------------------------------------------
# the engine with a dead node, and the microservice's entry point
# ---------------------------------------------------------------------------


def test_quorum_absorbs_a_dead_node_and_the_breaker_shows_in_ready_and_stats():
    """A COMBINER with quorum 1 over an in-process child and a REST node
    nobody serves answers 200 with seldon.degraded naming the node; the
    failures open its breaker, which /ready and /stats then show."""
    comps = [{"name": "s1", "runtime": "inprocess", "class_path": "test.Scale"},
             {"name": "s2", "runtime": "rest", "host": "127.0.0.1", "port": _free_port()}]
    graph = {"name": "comb", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
             "quorum": 1, "children": [{"name": "s1", "type": "MODEL"},
                                       {"name": "s2", "type": "MODEL"}]}
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_doc(graph, comps)),
                           device="cpu")
    body = json.dumps({"data": {"ndarray": [[1.0, 2.0]]}})

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        answers = [await engine.predict_json(body) for _ in range(6)]
        loop = asyncio.get_running_loop()
        try:
            ready, stats = await loop.run_in_executor(None, lambda: (
                _get(server.port, "/ready"), _get(server.port, "/stats")))
        finally:
            await server.stop()
        return answers, ready, stats

    try:
        answers, ready, stats = asyncio.run(run())
    finally:
        engine.close()
    for text, status in answers:
        assert status == 200
        assert json.loads(text)["meta"]["tags"] == {"seldon.degraded.comb": ["s2"]}
        assert json.loads(text)["data"]["ndarray"] == [[2.0, 4.0]]
    assert engine.mode == "host" and engine.open_breakers() == ["s2"]
    assert ready == (200, b"ready (breakers open: s2)")
    doc = json.loads(stats[1])
    assert doc["engine"]["mode"] == "host"
    assert doc["resilience"]["breakers"]["s2"]["state"] == "open"
    assert doc["engine"]["graph_fuse"]["plan"]["blocked"]["comb"].startswith("quorum")


def test_microservice_main_refuses_what_is_not_ported(capsys, monkeypatch):
    # --persistence 1 is served now (tests/test_torch_persistence.py): the
    # unit builds for it on both APIs
    monkeypatch.setenv("MICROSERVICE_SMOKE_EXIT", "1")
    for api in ("REST", "GRPC"):
        microservice.main(["MnistClassifier", api, "--persistence", "1", "--device", "cpu"])
        assert "smoke ok: MnistClassifier as MODEL on cpu" in capsys.readouterr().out
    # GRPC is served now (tests/test_torch_grpc.py): the unit builds for it
    microservice.main(["MnistClassifier", "GRPC", "--device", "cpu"])
    assert "smoke ok: MnistClassifier as MODEL on cpu" in capsys.readouterr().out
    monkeypatch.delenv("MICROSERVICE_SMOKE_EXIT")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            microservice.main(["MnistClassifier", "REST"])  # cuda by default
        assert e.value.code == 2 and "CUDA is not available" in capsys.readouterr().err


def test_microservice_smoke_exit_and_a_served_subprocess():
    """MICROSERVICE_SMOKE_EXIT builds the unit and exits 0; a served
    subprocess answers an engine's REST node with the same unit's answer,
    and stops on SIGTERM."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MICROSERVICE_SMOKE_EXIT": "1",
           "PREDICTIVE_UNIT_PARAMETERS": json.dumps(
               [{"name": "hidden", "value": "32", "type": "INT"}])}
    smoke = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
                            "MnistClassifier", "REST", "--device", "cpu"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
    assert smoke.returncode == 0 and "smoke ok: MnistClassifier as MODEL on cpu" in smoke.stdout
    env.pop("MICROSERVICE_SMOKE_EXIT")
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
                             "MnistClassifier", "REST", "--device", "cpu", "--host",
                             "127.0.0.1", "--port", str(port)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("unit up: MnistClassifier") and "device=cpu" in line, line
        comps = [{"name": "m", "runtime": "rest", "host": "127.0.0.1", "port": port}]
        engine = EngineService(SeldonDeploymentSpec.from_json_dict(
            _doc({"name": "m", "type": "MODEL"}, comps)), device="cpu")
        x = np.random.default_rng(4).random((2, 784))
        try:
            text, status = asyncio.run(engine.predict_json(
                json.dumps({"data": {"ndarray": x.tolist()}})))
        finally:
            engine.close()
        from seldon_core_tpu_torch.graph.spec import Parameter

        local = build_runtime("MnistClassifier", parameters=[Parameter.from_json_dict(
            {"name": "hidden", "value": "32", "type": "INT"})], device="cpu")
        want = asyncio.run(local.predict(SeldonMessage.from_array(x)))
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert engine.mode == "host" and status == 200
    np.testing.assert_array_equal(np.asarray(json.loads(text)["data"]["ndarray"]),
                                  want.array().astype(np.float64))
    assert proc.returncode == 0 and "unit stopped" in rest


@pytest.mark.cuda
def test_host_mode_ensemble4_on_the_card():
    """ensemble4 with m3 served by the unit microservice on the card: the
    host-mode answer equals the fused engine's within 1e-6, and the fused
    MLP runs three times in the engine and once in the microservice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the fused-MLP kernel has no CPU mode)")
    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.ops._build import find_nvcc

    try:
        find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    doc = json.loads((ROOT / "examples" / "ensemble4_deployment.json").read_text())
    fused = EngineService(SeldonDeploymentSpec.from_json_dict(json.loads(json.dumps(doc))))
    x = np.random.default_rng(5).random((4, 784))
    body = json.dumps({"data": {"ndarray": x.tolist()}})

    async def run():
        rt = build_runtime("MnistClassifier", parameters=[Parameter.from_json_dict(
            {"name": "seed", "value": "3", "type": "INT"})], unit_name="m3")
        rt.state = fused.states()["m3"]
        server = await serve_unit(rt, "127.0.0.1", 0)
        doc["spec"]["predictors"][0]["components"][3] = {
            "name": "m3", "runtime": "rest", "host": "127.0.0.1", "port": server.port}
        host = EngineService(SeldonDeploymentSpec.from_json_dict(doc))
        host.load_states(fused.states())
        try:
            want = await fused.predict_json(body)
            before = fused_mlp.LAUNCHES
            got = await host.predict_json(body)
            return host, want, got, fused_mlp.LAUNCHES - before
        finally:
            host.close()
            await server.stop()

    try:
        host, want, got, launches = asyncio.run(run())
    finally:
        fused.close()
    assert host.mode == "host" and fused.mode == "fused" and launches == 4
    np.testing.assert_allclose(np.asarray(json.loads(got[0])["data"]["ndarray"]),
                               np.asarray(json.loads(want[0])["data"]["ndarray"]), atol=1e-6)
