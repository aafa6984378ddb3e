"""The port's served slice on the CPU — CompiledGraph, MicroBatcher,
EngineService, the asyncio REST lane and engine_main — against the JAX
package's engine on the same spec, with the weights carried across."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.compiled import CompiledGraph as JaxCompiledGraph
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.compiled import CompiledGraph
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime import engine_main
from seldon_core_tpu_torch.runtime.batching import MicroBatcher, pad_rows
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

ATOL = 2e-2  # bf16 weights: the reference's tolerance (tests/test_ops_pallas.py:56)


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


def _mnist_doc(hidden=32):
    return {
        "spec": {
            "name": "mnist-deployment",
            "predictors": [{
                "name": "main",
                "components": [{
                    "name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                    "parameters": [{"name": "hidden", "value": str(hidden), "type": "INT"}],
                }],
                "graph": {"name": "mnist", "type": "MODEL", "children": []},
            }],
        }
    }


def _port_engine(**kw):
    return EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu", **kw)


def _carry(jax_states, engine):
    engine.load_states({
        "mnist": params_from_jax({k: np.asarray(v) for k, v in jax_states["mnist"].items()},
                                 device="cpu")
    })


def _ndarray(x):
    return json.dumps({"data": {"ndarray": x.tolist()}})


def _tensor(x):
    return json.dumps({"data": {"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}})


def _rows(doc):
    data = doc["data"]
    if "ndarray" in data:
        return np.asarray(data["ndarray"])
    return np.asarray(data["tensor"]["values"]).reshape(data["tensor"]["shape"])


def test_compiled_graph_matches_jax_compiled_graph():
    jspec = JaxSpec.from_json_dict(_mnist_doc())
    ref = JaxCompiledGraph(jspec.predictor())
    port = CompiledGraph(SeldonDeploymentSpec.from_json_dict(_mnist_doc()).predictor(),
                         device="cpu")
    port.states = {"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in ref.states["mnist"].items()}, device="cpu")}
    x = np.random.default_rng(0).random((7, 784))
    y, routing, tags = port.predict_arrays(x)
    want, _, _ = ref.predict_arrays(x)
    assert y.dtype == torch.float32 and tuple(y.shape) == (7, 10)
    assert routing == {} and tags == {}
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=ATOL)
    assert port._output_names(port.predictor.graph, {}) == [f"class:{i}" for i in range(10)]


def test_engine_matches_jax_engine_both_wire_kinds():
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()))
    engine = _port_engine()
    _carry(jax_engine.states(), engine)
    x = np.random.default_rng(1).random((5, 784))

    async def run():
        out = []
        for body in (_ndarray(x), _tensor(x)):
            ours = await engine.predict_json(body)
            theirs = await jax_engine.predict_json(body)
            out.append((ours, theirs))
        return out

    try:
        results = asyncio.run(run())
    finally:
        engine.close()
    for kind, ((text, status), (ref_text, ref_status)) in zip(("ndarray", "tensor"), results):
        assert status == ref_status == 200
        doc, ref_doc = json.loads(text), json.loads(ref_text)
        assert kind in doc["data"]  # the response keeps the request's kind
        assert doc["data"]["names"] == ref_doc["data"]["names"]
        assert doc["status"] == {"code": 200, "status": "SUCCESS"}
        np.testing.assert_allclose(_rows(doc), _rows(ref_doc), atol=ATOL)


def test_engine_keeps_meta_and_answers_400_on_bad_input():
    engine = _port_engine()
    x = np.random.default_rng(2).random((1, 784))

    async def run():
        body = json.dumps({"meta": {"puid": "abc", "tags": {"t": 1}},
                           "data": {"ndarray": x.tolist()}})
        ok = await engine.predict_json(body)
        one_d = await engine.predict_json(json.dumps({"data": {"ndarray": x[0].tolist()}}))
        width = await engine.predict_json(_ndarray(np.ones((2, 5))))
        ragged = await engine.predict_json(json.dumps({"data": {"ndarray": [[1, 2], [3]]}}))
        broken = await engine.predict_json("{not json")
        return ok, one_d, width, ragged, broken

    try:
        ok, one_d, width, ragged, broken = asyncio.run(run())
    finally:
        engine.close()
    doc = json.loads(ok[0])
    assert ok[1] == 200 and doc["meta"]["puid"] == "abc" and doc["meta"]["tags"] == {"t": 1}
    assert one_d[1] == 200 and _rows(json.loads(one_d[0])).shape == (1, 10)
    for text, status in (width, ragged, broken):
        assert status == 400
        assert json.loads(text)["status"]["status"] == "FAILURE"
    assert "in_dim" in json.loads(width[0])["status"]["info"]


def test_dispatch_timeout_answers_504():
    engine = _port_engine(dispatch_timeout_s=0.05)
    slow = engine.compiled.predict_arrays

    def stall(*a, **kw):
        time.sleep(0.3)
        return slow(*a, **kw)

    engine.compiled.predict_arrays = stall
    try:
        text, status = asyncio.run(engine.predict_json(_ndarray(np.zeros((1, 784)))))
    finally:
        engine.close()
    assert status == 504 and "dispatch exceeded" in json.loads(text)["status"]["info"]


def test_batcher_pads_and_slices_under_concurrent_submits():
    seen = []

    async def batch_fn(chunk):
        seen.append(len(chunk))
        await asyncio.sleep(0.001)
        return chunk * 2.0, ({}, {})

    sizes = [1, 2, 3, 1, 5, 2, 1, 1, 4, 7, 1, 3]

    async def run():
        b = MicroBatcher(batch_fn, max_batch=8, max_inflight=2, coalesce_ms=1.0)
        xs = [np.full((n, 3), float(i)) + np.arange(n)[:, None] for i, n in enumerate(sizes)]
        outs = await asyncio.gather(*[b.submit(x) for x in xs])
        return xs, outs, b.snapshot()

    xs, outs, snap = asyncio.run(run())
    for x, (y, aux) in zip(xs, outs):
        np.testing.assert_array_equal(y, x * 2.0)  # exactly the caller's rows
        assert aux == ({}, {})
    # every dispatch is a power of two no larger than max_batch
    assert all(n <= 8 and n & (n - 1) == 0 for n in seen)
    assert sum(seen) >= sum(sizes)
    assert snap["buckets"] == {} and snap["inflight_dispatches"] == 0
    assert [pad_rows(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]


def test_engine_coalesces_concurrent_requests_exactly():
    engine = _port_engine()
    rng = np.random.default_rng(3)
    xs = [rng.random((int(n), 784)) for n in rng.integers(1, 4, size=24)]
    state = engine.states()["mnist"]

    async def run():
        return await asyncio.gather(*[engine.predict_json(_ndarray(x)) for x in xs])

    try:
        results = asyncio.run(run())
    finally:
        engine.close()
    unit = engine.compiled.units["mnist"]
    for x, (text, status) in zip(xs, results):
        assert status == 200
        want = unit.predict(state, torch.from_numpy(x).float()).numpy()
        # a row's answer must not depend on its stack-mates or padding
        np.testing.assert_allclose(_rows(json.loads(text)), want, atol=1e-6)
    assert engine.drained()


def test_unbatched_engine_serves_concurrent_requests_exactly():
    engine = _port_engine(batching=False)
    assert engine.batcher is None
    rng = np.random.default_rng(5)
    xs = [rng.random((int(n), 784)) for n in rng.integers(1, 4, size=12)]
    state = engine.states()["mnist"]

    async def run():
        return await asyncio.gather(*[engine.predict_json(_tensor(x)) for x in xs])

    try:
        results = asyncio.run(run())
    finally:
        engine.close()
    unit = engine.compiled.units["mnist"]
    for x, (text, status) in zip(xs, results):
        assert status == 200
        doc = json.loads(text)
        assert "tensor" in doc["data"]
        want = unit.predict(state, torch.from_numpy(x).float()).numpy()
        # concurrent dispatches on the pool share no mutable state
        np.testing.assert_allclose(_rows(doc), want, atol=1e-6)


def _http(method, url, body=None, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method=method, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_rest_lane_routes():
    engine = _port_engine()
    x = np.random.default_rng(4).random((2, 784))

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()

        def client():
            from urllib.parse import urlencode

            out = {
                "predict": _http("POST", f"{url}/api/v0.1/predictions", _ndarray(x).encode()),
                "alias": _http("POST", f"{url}/predict", _tensor(x).encode()),
                "form": _http("POST", f"{url}/api/v0.1/predictions",
                              urlencode({"json": _ndarray(x)}).encode(),
                              "application/x-www-form-urlencoded"),
                "bad": _http("POST", f"{url}/api/v0.1/predictions", b"{oops"),
                "ping": _http("GET", f"{url}/ping"),
                "ready": _http("GET", f"{url}/ready"),
                "pause": _http("GET", f"{url}/pause"),
                "paused": _http("GET", f"{url}/ready"),
                "unpause": _http("GET", f"{url}/unpause"),
                "stats": _http("GET", f"{url}/stats"),
                "missing": _http("GET", f"{url}/nope"),
                "method": _http("PUT", f"{url}/ping"),
            }
            with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
                s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                          b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n")
                out["chunked"] = s.recv(4096)
            return out

        try:
            return await loop.run_in_executor(None, client)
        finally:
            await server.stop()

    try:
        out = asyncio.run(run())
    finally:
        engine.close()
    for key in ("predict", "alias", "form"):
        status, raw = out[key]
        assert status == 200, raw
        assert _rows(json.loads(raw)).shape == (2, 10)
    assert "tensor" in json.loads(out["alias"][1])["data"]
    assert out["bad"][0] == 400
    assert out["ping"] == (200, b"pong")
    assert out["ready"] == (200, b"ready")
    assert out["pause"][0] == 200 and out["paused"] == (503, b"paused")
    assert out["unpause"][0] == 200
    stats = json.loads(out["stats"][1])
    assert stats["engine"]["mode"] == "compiled" and stats["device"] == "cpu"
    assert stats["kernels"]["fused_mlp_softmax"]["launches"] >= 0
    assert out["missing"][0] == 404 and out["method"][0] == 405
    assert out["chunked"].startswith(b"HTTP/1.1 501")


def test_router_graphs_wait_for_the_router_executor():
    """An in-process router graph serves fused, the mode the JAX engine
    picks for it (one request at a time, no batcher, the branch in
    meta.routing); a router over a REST-bound node serves in host mode
    through the GraphExecutor, its routed child answered by the port's unit
    microservice over localhost."""
    from seldon_core_tpu_torch.runtime.microservice import build_runtime
    from seldon_core_tpu_torch.runtime.rest import serve_unit

    doc = {"spec": {"name": "d", "predictors": [{
        "name": "p",
        "graph": {"name": "r", "implementation": "SIMPLE_ROUTER", "children": [
            {"name": "a", "implementation": "SIMPLE_MODEL"},
            {"name": "b", "implementation": "SIMPLE_MODEL"}]}}]}}
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    try:
        text, status = asyncio.run(engine.predict_json(_ndarray(np.ones((2, 3)))))
    finally:
        engine.close()
    assert status == 200 and engine.batcher is None
    assert engine.mode == "fused" == JaxEngine(JaxSpec.from_json_dict(doc)).mode
    assert json.loads(text)["meta"]["routing"] == {"r": 0}
    remote = json.loads(json.dumps(doc))
    pred = remote["spec"]["predictors"][0]
    pred["graph"]["children"][0] = {"name": "a", "type": "MODEL"}

    async def run():
        unit = build_runtime("SIMPLE_MODEL", unit_name="a", device="cpu")
        server = await serve_unit(unit, "127.0.0.1", 0)
        pred["components"] = [{"name": "a", "runtime": "rest", "host": "127.0.0.1",
                               "port": server.port}]
        host = EngineService(SeldonDeploymentSpec.from_json_dict(remote), device="cpu")
        try:
            return host, await host.predict_json(_ndarray(np.ones((2, 3))))
        finally:
            host.close()
            await server.stop()

    host, (text, status) = asyncio.run(run())
    out = json.loads(text)
    assert status == 200 and host.mode == "host" and host.batcher is None
    assert out["meta"]["routing"] == {"r": 0}
    assert out["data"]["names"] == ["class0", "class1", "class2"]
    np.testing.assert_allclose(out["data"]["ndarray"], [[0.1, 0.9, 0.5]] * 2)
    assert host.stats()["resilience"]["breakers"]["a"]["state"] == "closed"


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()))
    with pytest.raises(SystemExit) as exc:
        engine_main.main(["--device", "cuda", "--file", "examples/mnist_deployment.json"])
    assert exc.value.code == 2


def test_engine_main_serves_on_cpu_and_drains_on_sigterm(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        grpc_port = s.getsockname()[1]
    # the engine binds its gRPC lane too: a free port, not the default 5001
    env = {**os.environ, "ENGINE_SHUTDOWN_DRAIN_S": "5", "OMP_NUM_THREADS": "1",
           "ENGINE_SERVER_GRPC_PORT": str(grpc_port)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main",
         "--file", "examples/mnist_deployment.json", "--device", "cpu",
         "--host", "127.0.0.1", "--rest-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("engine up:") and "device=cpu" in line, line
        status, raw = _http("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                            _ndarray(np.zeros((1, 784))).encode())
        assert status == 200 and _rows(json.loads(raw)).shape == (1, 10)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0
    assert "engine stopped" in rest


# -- a wrong width is the client's error (ROADMAP Queue 3 item 4) -------------

# per example: a good request, then payloads of the wrong shape: too narrow,
# too wide, 3-D, empty
_WRONG_WIDTH = {
    "iris": ([[1.0, 2.0, 3.0, 4.0]], [[[1.0, 2.0]], [[1.0] * 7], [], [[]]]),
    "outlier_pipeline": ([[0.5] * 784], [[[1.0, 2.0]], [[1.0] * 787], [[[0.0] * 784] * 2], []]),
    "gbm": ([[0.0] * 8], [[[1.0, 2.0]], [[[0.0] * 8] * 2], []]),
    # a 1-D request serves first: then `[]` is a width that never served
    "epsilon_greedy": ([0.0] * 784, [[[1.0, 2.0]], []]),
}


def _example_engines(name):
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate

    path = os.path.join(os.path.dirname(__file__), "..", "examples", f"{name}_deployment.json")
    with open(path) as f:
        doc = json.load(f)
    return (JaxEngine(JaxSpec.from_json_dict(doc)),
            EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                          device="cpu"))


@pytest.mark.parametrize("after", [False, True], ids=["fresh", "after_a_good_request"])
@pytest.mark.parametrize("name", sorted(_WRONG_WIDTH))
def test_a_wrong_width_answers_400_on_every_lane(name, after):
    """Queue 3 item 4: each wrong-shape payload answers 400 "graph rejected
    input of shape ..." on the port's JSON, binary-wire and gRPC lanes, on
    a fresh engine and after a good request; the reference answers 400
    too, but for gbm's too-narrow row, which it answers 200 (its own
    fault: XLA's gather clamps the feature indices)."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime import wire

    good, bad = _WRONG_WIDTH[name]
    jax_engine, engine = _example_engines(name)

    async def run():
        out = []
        if after:
            body = json.dumps({"data": {"ndarray": good}})
            assert (await jax_engine.predict_json(body))[1] == 200
            assert (await engine.predict_json(body))[1] == 200
        for x in bad:
            body = json.dumps({"data": {"ndarray": x}})
            ref = (await jax_engine.predict_json(body))[1]
            text, status = await engine.predict_json(body)
            arr = np.asarray(x, dtype=np.float64)
            w_status, parts = await engine.predict_wire(wire.join_parts(wire.encode_frame(arr)))
            frame = wire.decode_frame(wire.join_parts(parts))
            proto = protoconv.msg_from_proto(await engine.predict_proto_wire(
                protoconv.msg_to_proto(SeldonMessage.from_array(arr))))
            out.append((np.shape(arr), ref, status, json.loads(text)["status"], w_status,
                        frame.extra().get("error", ""), proto.status))
        return out

    try:
        results = asyncio.run(run())
    finally:
        engine.close()
    for shape, ref, status, st, w_status, w_error, proto_status in results:
        assert ref == (200 if name == "gbm" and shape == (1, 2) else 400), (shape, ref)
        assert status == 400 and st["info"].startswith("graph rejected input of shape"), st
        assert w_status == 400 and w_error.startswith("graph rejected input of shape"), w_error
        assert proto_status.code == 400 and proto_status.status == "FAILURE"
        assert proto_status.info.startswith("graph rejected input of shape"), proto_status


def test_a_width_that_has_served_still_answers_500_and_a_card_error_is_never_400():
    """The known-good-width rule: a shape error on a width that has served
    is the server's fault (the lane's 500), and so is an error of the card
    on any width, while the same error text of a shape mismatch on a new
    width is a 400."""
    from seldon_core_tpu_torch.runtime.engine import is_client_shape_error

    _, engine = _example_engines("iris")
    mismatch = RuntimeError("The size of tensor a (4) must match the size of tensor b (3) at "
                            "non-singleton dimension 1")

    def failing(err):
        def predict_arrays(*args, **kwargs):
            raise err
        return predict_arrays

    async def run():
        assert (await engine.predict_json('{"data":{"ndarray":[[1,2,3,4]]}}'))[1] == 200
        engine.compiled.predict_arrays = failing(mismatch)
        with pytest.raises(RuntimeError, match="size of tensor"):
            await engine.predict_json('{"data":{"ndarray":[[1,2,3,5]]}}')  # served width
        novel = await engine.predict_json('{"data":{"ndarray":[[1,2,3]]}}')
        engine.compiled.predict_arrays = failing(RuntimeError(
            "CUDA error: an illegal memory access was encountered"))
        with pytest.raises(RuntimeError, match="CUDA"):
            await engine.predict_json('{"data":{"ndarray":[[1,2]]}}')  # novel width
        return novel

    try:
        text, status = asyncio.run(run())
    finally:
        engine.close()
    assert status == 400 and "graph rejected input of shape (1, 3)" in text
    for e in (TypeError("x"), ValueError("x"), IndexError("index 2 is out of bounds"),
              mismatch, RuntimeError("mat1 and mat2 shapes cannot be multiplied (1x2 and 4x8)")):
        assert is_client_shape_error(e), e
    for e in (RuntimeError("CUDA error: device-side assert triggered"),
              RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"),
              RuntimeError("fused_mlp kernel launch failed: invalid argument"),
              RuntimeError("Expected all tensors to be on the same device"),
              torch.cuda.OutOfMemoryError("out of memory"), NotImplementedError("x"),
              KeyError("x"), OSError("x")):
        assert not is_client_shape_error(e), e
