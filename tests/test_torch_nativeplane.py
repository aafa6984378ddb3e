"""The port's native data plane (seldon_core_tpu_torch/native/csrc/
dataplane.cpp through runtime/nativeplane.py) on a CPU engine: the cases
of tests/test_nativeplane.py against the port's plane, the fast lane's
answers held to the Python lane's, item 4's 400 on the plane, and the
JAX engine's plane and the port's answering the same MNIST payloads."""

import asyncio
import json
import re
import shutil
from urllib.parse import quote

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.runtime.nativeplane import serve_native as jax_serve_native
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.nativeplane import native_plane_available, serve_native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the plane")

ATOL = 2e-2  # bf16 MNIST weights: the reference's tolerance (tests/test_ops_pallas.py:56)

STUB = {"spec": {"name": "np-test", "predictors": [{"name": "p", "graph": {
    "name": "stub", "implementation": "SIMPLE_MODEL", "type": "MODEL"}}]}}


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
def plane_engine():
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(STUB), max_batch=64,
                           max_wait_ms=1.0, pipeline_depth=4, device="cpu")
    engine.prewarm([1])
    yield engine
    engine.close()


async def _read_response(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    lower = head.lower()
    j = lower.find(b"content-length:")
    return status, head, await reader.readexactly(int(lower[j + 15: lower.find(b"\r", j)]))


async def _post(port, path, body, ctype="application/json", headers=""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = body.encode() if isinstance(body, str) else body
    writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}\r\n{headers}"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    status, _, resp = await _read_response(reader)
    writer.close()
    return status, resp


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    status, _, resp = await _read_response(reader)
    writer.close()
    return status, resp


def test_the_plane_builds_in_the_checkout():
    from seldon_core_tpu_torch.native import _build

    assert native_plane_available()
    path = _build.BUILD_INFO["dataplane"]["path"]
    assert "/build/native/libdataplane-" in path and "seldon_core_tpu_torch" not in path


def test_fast_lane_parity_with_python_path(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            req = '{"data":{"ndarray":[[0.25]]}}'
            status, native = await _post(plane.port, "/api/v0.1/predictions", req)
            py_text, py_status = await plane_engine.predict_json(req)
            stats = plane_engine.stats()["engine"]
            return status, json.loads(native), py_status, json.loads(py_text), stats, \
                plane.stats()
        finally:
            await plane.stop()

    status, nd, py_status, pd, engine_block, dp = asyncio.run(run())
    assert status == py_status == 200
    assert nd["data"]["names"] == pd["data"]["names"] and nd["status"] == pd["status"]
    assert np.asarray(nd["data"]["ndarray"]).tobytes() == np.asarray(
        pd["data"]["ndarray"]).tobytes()
    assert len(nd["meta"]["puid"]) == 26 and set(nd["meta"]) == {"puid"}
    assert engine_block["http_impl"] == "native" and engine_block["codec"] == "native"
    assert dp[0] == 1 and plane_engine.http_impl == "python"  # the fast lane; stopped


def test_tensor_kind_meta_echo_and_multirow(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            out = []
            for meta in ({"puid": "keep-me", "tags": {"a": 1}}, {"puid": "keep-me"}):
                req = json.dumps({"meta": meta, "data": {"tensor": {
                    "shape": [3, 1], "values": [0.1, 0.2, 0.3]}}})
                out.append((await _post(plane.port, "/api/v0.1/predictions", req),
                            await plane_engine.predict_json(req)))
            return out, plane.stats()
        finally:
            await plane.stop()

    out, dp = asyncio.run(run())
    for (status, resp), (py_text, _) in out:
        doc, py = json.loads(resp), json.loads(py_text)
        assert status == 200 and doc["meta"] == py["meta"]
        assert doc["meta"]["puid"] == "keep-me"
        assert doc["data"]["tensor"]["shape"] == [3, 3] and doc["data"] == py["data"]
    assert json.loads(out[0][0][1])["meta"]["tags"] == {"a": 1}
    assert dp[0] == 2 and dp[4:19].sum() == 1  # the tagged request took the misc lane


def test_misc_lane_routes(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            body = "json=" + quote('{"data":{"ndarray":[[0.5]]}}')
            return [await _get(plane.port, "/ping"), await _get(plane.port, "/ready"),
                    await _get(plane.port, "/nope"),
                    await _post(plane.port, "/api/v0.1/predictions", body,
                                ctype="application/x-www-form-urlencoded"),
                    await _post(plane.port, "/api/v0.1/predictions", "nope"),
                    await _post(plane.port, "/api/v0.1/generate/stream",
                                '{"data":{"ndarray":[[1]]}}'),
                    await _get(plane.port, "/trace/enable"),
                    await _post(plane.port, "/api/v0.1/predictions",
                                '{"data":{"ndarray":[[0.5]]}}',
                                headers="Seldon-Deadline-Ms: 0.0001\r\n")]
        finally:
            await plane.stop()

    ping, ready, missing, form, bad, stream, get_mutation, spent = asyncio.run(run())
    assert ping == (200, b"pong") and ready[0] == 200 and missing[0] == 404
    assert form[0] == 200 and json.loads(form[1])["status"]["status"] == "SUCCESS"
    assert bad[0] == 400 and json.loads(bad[1])["status"]["status"] == "FAILURE"
    # the SSE route is the Python lane's (a stub graph cannot stream at all)
    assert stream[0] in (400, 501)
    assert get_mutation[0] == 405
    # a deadline header binds on the misc lane as on the Python lane
    assert spent[0] == 504 and "deadline" in json.loads(spent[1])["status"]["info"]


def test_feedback_via_misc_lane(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            fb = json.dumps({"request": {"data": {"ndarray": [[0.5]]}},
                             "response": {"meta": {"puid": "p1"},
                                          "data": {"ndarray": [[0.1, 0.9, 0.5]]}},
                             "reward": 1.0})
            return await _post(plane.port, "/api/v0.1/feedback", fb)
        finally:
            await plane.stop()

    status, resp = asyncio.run(run())
    assert status == 200 and json.loads(resp)["meta"]["puid"] == "p1"


def test_concurrent_burst_batches(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            out = await asyncio.gather(*[
                _post(plane.port, "/api/v0.1/predictions",
                      json.dumps({"data": {"ndarray": [[i / 100.0]]}})) for i in range(96)])
            return out, plane.stats()
        finally:
            await plane.stop()

    out, dp = asyncio.run(run())
    for status, resp in out:
        assert status == 200
        np.testing.assert_allclose(json.loads(resp)["data"]["ndarray"], [[0.1, 0.9, 0.5]],
                                   atol=1e-6)
    assert dp[0] == 96


def test_prometheus_reports_native_lane(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            for _ in range(4):
                await _post(plane.port, "/api/v0.1/predictions", '{"data":{"ndarray":[[0.5]]}}')
            return await _get(plane.port, "/prometheus")
        finally:
            await plane.stop()

    status, resp = asyncio.run(run())
    assert status == 200
    for line in resp.decode().splitlines():
        if (line.startswith("seldon_api_engine_server_requests_duration_seconds_count")
                and 'service="predictions"' in line):
            assert float(line.rsplit(" ", 1)[1]) >= 4
            break
    else:
        pytest.fail("no predictions histogram in exposition")


def test_keepalive_and_connection_close(plane_engine):
    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", plane.port)
            body = b'{"data":{"ndarray":[[0.5]]}}'
            req = (b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
                   b"Content-Length: %d\r\n\r\n" % len(body) + body)
            for _ in range(3):  # keepalive reuse
                writer.write(req)
                status, _, _ = await _read_response(reader)
                assert status == 200
            writer.write(b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: t\r\n"
                         b"Connection: close\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
            _, head, _ = await _read_response(reader)
            assert b"connection: close" in head.lower()
            assert await reader.read(1) == b""  # the server closed
            writer.close()
        finally:
            await plane.stop()

    asyncio.run(run())


def _stock_stub(port, method="/seldon.protos.Seldon/Predict"):
    import grpc

    from seldon_core_tpu.proto_gen import prediction_pb2 as pb

    ch = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
    return ch, ch.unary_unary(method, request_serializer=pb.SeldonMessage.SerializeToString,
                              response_deserializer=pb.SeldonMessage.FromString)


def test_grpc_lane_stock_client(plane_engine):
    """The plane's h2 lane against an unmodified grpc.aio client: the
    tensor fast lane, puid echo, ndarray through the misc lane, a
    traceparent through the misc lane, an unknown method UNIMPLEMENTED."""
    import grpc
    from google.protobuf import struct_pb2

    from seldon_core_tpu.proto_gen import prediction_pb2 as pb

    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0, grpc_port=0)
        ch, stub = _stock_stub(plane.grpc_port)
        try:
            r = await stub(pb.SeldonMessage(data=pb.DefaultData(
                tensor=pb.Tensor(shape=[2, 1], values=[0.5, 0.6]))), timeout=30)
            assert list(r.data.tensor.shape) == [2, 3] and len(r.data.tensor.values) == 6
            assert r.status.code == 200 and len(r.meta.puid) == 26
            assert list(r.data.names) == plane_engine._static_names
            r2 = await stub(pb.SeldonMessage(meta=pb.Meta(puid="echo-me"), data=pb.DefaultData(
                tensor=pb.Tensor(shape=[1, 1], values=[0.1]))), timeout=30)
            assert r2.meta.puid == "echo-me"
            lv, row = struct_pb2.ListValue(), struct_pb2.ListValue()
            row.values.add().number_value = 0.7
            lv.values.add().list_value.CopyFrom(row)
            r3 = await stub(pb.SeldonMessage(data=pb.DefaultData(ndarray=lv)), timeout=30)
            assert r3.status.code == 200 and r3.data.WhichOneof("data_oneof") == "ndarray"
            r4 = await stub(pb.SeldonMessage(data=pb.DefaultData(
                tensor=pb.Tensor(shape=[1, 1], values=[0.1]))), timeout=30,
                metadata=(("traceparent", "00-" + "1" * 32 + "-" + "2" * 16 + "-01"),))
            assert r4.status.code == 200
            _, bad = _stock_stub(plane.grpc_port, "/seldon.protos.Seldon/Nope")
            with pytest.raises(grpc.aio.AioRpcError) as ei:
                await bad(pb.SeldonMessage(), timeout=30)
            assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
            return plane.stats()
        finally:
            await ch.close()
            await plane.stop()

    dp = asyncio.run(run())
    assert dp[19] == 4  # 2 fast, then ndarray and traceparent misc (2xx), UNIMPLEMENTED


def test_grpc_lane_concurrent_burst(plane_engine):
    from seldon_core_tpu.proto_gen import prediction_pb2 as pb

    async def run():
        plane = await serve_native(plane_engine, "127.0.0.1", 0, grpc_port=0)
        ch, stub = _stock_stub(plane.grpc_port)
        try:
            return await asyncio.gather(*[stub(pb.SeldonMessage(data=pb.DefaultData(
                tensor=pb.Tensor(shape=[1, 1], values=[i / 64]))), timeout=30)
                for i in range(80)])
        finally:
            await ch.close()
            await plane.stop()

    for r in asyncio.run(run()):
        np.testing.assert_allclose(list(r.data.tensor.values), [0.1, 0.9, 0.5], atol=1e-6)


def test_ineligible_graph_rejected():
    """A router graph (per-request routing, a stateful key) refuses the
    plane; the Python lanes serve it with full meta."""
    spec = SeldonDeploymentSpec.from_json_dict({"spec": {"name": "abtest", "predictors": [{
        "name": "p", "graph": {"name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
                               "children": [
                                   {"name": "a", "type": "MODEL",
                                    "implementation": "SIMPLE_MODEL"},
                                   {"name": "b", "type": "MODEL",
                                    "implementation": "SIMPLE_MODEL"}]}}]}})
    engine = EngineService(spec, device="cpu")

    async def run():
        with pytest.raises(RuntimeError, match="pipelined batchable"):
            await serve_native(engine, "127.0.0.1", 0)

    try:
        asyncio.run(run())
    finally:
        engine.close()


# -- MNIST: the port's plane against the Python lane and the JAX plane ------


def _mnist_doc(hidden=32):
    return {"spec": {"name": "mnist-deployment", "predictors": [{
        "name": "main",
        "components": [{"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": str(hidden),
                                        "type": "INT"}]}],
        "graph": {"name": "mnist", "type": "MODEL", "children": []}}]}}


def _mnist_payloads():
    x = np.random.default_rng(7).random((3, 784))
    return {
        "good": {"data": {"ndarray": x.tolist()}},
        "one_d": {"data": {"ndarray": x[0].tolist()}},
        "tensor": {"data": {"tensor": {"shape": [2, 784], "values": x[:2].ravel().tolist()}}},
        "too_narrow": {"data": {"ndarray": [[1.0, 2.0]]}},
        "too_wide": {"data": {"ndarray": [[0.5] * 787]}},
        "empty": {"data": {"ndarray": []}},
        "nan": {"data": {"ndarray": [[float("nan")] + [0.5] * 783]}},
        "huge": {"data": {"ndarray": [[1e300] * 784]}},
        "names": {"data": {"names": [f"f{i}" for i in range(784)], "ndarray": x[:1].tolist()}},
        "str_data": {"strData": "hello"},
    }


def _loads(text):
    # the reference's native writer prints NaN as `nan` / `-nan` (its fault,
    # ROADMAP): read those as NaN to compare its numbers
    return json.loads(re.sub(rb"-?nan", b"NaN", text if isinstance(text, bytes)
                             else text.encode()))


def test_mnist_on_the_port_s_plane_answers_the_python_lane_and_the_jax_plane():
    """The same MNIST payloads (good, 1-D, a tensor, too narrow, too wide,
    empty, NaN, 1e300, with names, strData) to the JAX engine's native
    plane, the port's native plane and the port's Python lane: every
    status equal; the port's plane answers json.loads reads, whose values
    are the Python lane's bit for bit and the reference's within the bf16
    tolerance; a wrong width answers 400 "graph rejected input of shape"."""
    jax_engine = JaxEngine(JaxSpec.from_json_dict(_mnist_doc()), max_batch=64,
                           max_wait_ms=1.0, pipeline_depth=4)
    jax_engine.prewarm([784])
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), max_batch=64,
                           max_wait_ms=1.0, pipeline_depth=4, device="cpu")
    engine.load_states({"mnist": params_from_jax(
        {k: np.asarray(v) for k, v in jax_engine.states()["mnist"].items()}, device="cpu")})
    engine.prewarm([784])
    payloads = {k: json.dumps(v) for k, v in _mnist_payloads().items()}

    async def run():
        ref_plane = await jax_serve_native(jax_engine, "127.0.0.1", 0)
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            out = {}
            for name, body in payloads.items():
                out[name] = (await _post(plane.port, "/api/v0.1/predictions", body),
                             await _post(ref_plane.port, "/api/v0.1/predictions", body),
                             await engine.predict_json(body))
            return out, plane.stats()
        finally:
            await plane.stop()
            await ref_plane.stop()

    try:
        out, dp = asyncio.run(run())
    finally:
        engine.close()
    for name, ((status, raw), (ref_status, ref_raw), (py_text, py_status)) in out.items():
        assert status == ref_status == py_status, (name, status, ref_status, py_status)
        doc, py, ref = json.loads(raw), json.loads(py_text), _loads(ref_raw)
        assert doc["status"] == py["status"], name
        if status != 200:
            assert doc["status"]["status"] == "FAILURE"
            if name in ("too_narrow", "too_wide", "empty"):
                assert doc["status"]["info"].startswith("graph rejected input of shape"), doc
            continue
        assert doc["data"].get("names") == py["data"].get("names") == ref["data"].get("names")
        key = "ndarray" if "ndarray" in py["data"] else "tensor"
        got, want = np.asarray(_rows(doc, key)), np.asarray(_rows(py, key))
        assert got.tobytes() == want.tobytes(), name
        np.testing.assert_allclose(got, np.asarray(_rows(ref, key)), atol=ATOL)
    assert np.isnan(np.asarray(_rows(json.loads(out["huge"][0][1]), "ndarray"))).all()
    # good, 1-D, tensor and 1e300 were answered by the fast lane (its
    # latency histogram), names and NaN by the misc lane; too narrow and
    # too wide failed on the fast lane, empty and strData on the misc lane
    assert dp[0] == 4 + 2 and dp[4:19].sum() == 4 and dp[1] == 2 + 2


def _rows(doc, key):
    data = doc["data"]
    return data["ndarray"] if key == "ndarray" else data["tensor"]["values"]


def test_the_sse_route_answers_501_on_the_plane(monkeypatch):
    """A graph that streams (a generator on the static lane, which the
    plane takes) answers the SSE route 501 through the misc lane, naming
    the Python lane, as the reference's plane does; its unary answer is
    the Python lane's."""
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    dims = dict(vocab=48, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_new_tokens=4)
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in dims.items()]
    params.append({"name": "dtype", "value": "float32", "type": "STRING"})
    engine = EngineService(SeldonDeploymentSpec.from_json_dict({"spec": {"name": "g", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": params}]}]}}), device="cpu")

    async def run():
        plane = await serve_native(engine, "127.0.0.1", 0)
        try:
            return (await _post(plane.port, "/api/v0.1/generate/stream",
                                '{"data":{"ndarray":[[1,2,3]]}}'),
                    await _post(plane.port, "/api/v0.1/predictions",
                                '{"data":{"ndarray":[[1,2,3]]}}'),
                    await engine.predict_json('{"data":{"ndarray":[[1,2,3]]}}'))
        finally:
            await plane.stop()

    try:
        (status, resp), (p_status, p_resp), (py_text, py_status) = asyncio.run(run())
    finally:
        engine.close()
    assert status == 501 and "ENGINE_HTTP_IMPL=fast" in json.loads(resp)["status"]["reason"]
    assert p_status == py_status == 200
    assert json.loads(p_resp)["data"] == json.loads(py_text)["data"]
