"""The binary tensor wire on the CPU: the port's ``runtime/wire.py`` against
the JAX package's on the same bytes (frames both ways, bf16 by bits, the
MULTI frame, the sidecar, the typed 400/413s), the engine's ``predict_wire``
against the JAX engine's with the weights carried across, and the REST
lanes' wire routes (the engine's predictions route and the unit routes)."""

import asyncio
import http.client
import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import wire as ref_wire
from seldon_core_tpu.runtime.engine import EngineService as JaxEngine
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.messages import SeldonMessage as JaxMessage
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import Meta, SeldonMessage, Status
from seldon_core_tpu_torch.runtime import wire
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.rest import serve_fast, serve_unit
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

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


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "float32": rng.standard_normal((3, 5)).astype(np.float32),
        "float64": rng.standard_normal((2, 7)),
        "float64_3d": rng.standard_normal((2, 3, 4)),
        "float64_1d": rng.standard_normal(6),
        "float16": rng.standard_normal((4, 2)).astype(np.float16),
        "int8": rng.integers(-128, 127, (3, 4)).astype(np.int8),
        "int16": rng.integers(-999, 999, (2, 2)).astype(np.int16),
        "int32": rng.integers(-9999, 9999, (5, 1)).astype(np.int32),
        "int64": rng.integers(-99999, 99999, (1, 3)).astype(np.int64),
        "uint8": rng.integers(0, 255, (2, 8)).astype(np.uint8),
        "bool": rng.random((3, 3)) > 0.5,
        "empty": np.zeros((0, 4)),
    }


def _meta(puid="p1"):
    return dict(puid=puid, deadline_ms=250.0,
                extra={"names": ["a", "b"], "tags": {"t": 1}, "routing": {"r": 2}})


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_frames_are_byte_identical_and_decode_alike(name):
    """For the same array and sidecar the port writes the reference's
    bytes, and each side decodes the other's frame to the same array and
    meta."""
    a = _arrays()[name]
    meta = ref_wire.pack_wire_meta(**_meta())
    assert wire.pack_wire_meta(**_meta()) == meta
    frame = wire.join_parts(wire.encode_frame(a, meta_bytes=meta, status=7, response=True))
    if a.size:  # the reference cannot encode an empty array (memoryview.cast refuses it)
        assert frame == ref_wire.join_parts(ref_wire.encode_frame(
            a, meta_bytes=meta, status=7, response=True))
    got, want = wire.decode_frame(frame), ref_wire.decode_frame(frame)
    assert got.array.dtype == want.array.dtype and np.array_equal(got.array, want.array)
    assert got.meta == want.meta and got.status == want.status == 7 and got.is_response
    assert not got.array.flags.writeable  # a view over the frame's bytes
    assert np.array_equal(got.rows(), want.rows())


def test_int8_scale_plane_and_quantize_rows():
    x = np.random.default_rng(1).standard_normal((5, 9))
    q, s = wire.quantize_rows(x)
    rq, rs = ref_wire.quantize_rows(x)
    assert np.array_equal(q, rq) and np.array_equal(s, rs)
    ref = ref_wire.join_parts(ref_wire.encode_frame(rq, scales=rs))
    assert wire.join_parts(wire.encode_frame(q, scales=s)) == ref
    got = wire.decode_frame(ref)
    assert np.array_equal(got.rows(), ref_wire.decode_frame(ref).rows())
    # within half a quantization step of the values
    assert (np.abs(got.rows() - x) <= s[:, None] / 2 + 1e-6).all()
    msg = wire.message_from_frame(got)
    assert np.array_equal(msg.array(), ref_wire.message_from_frame(
        ref_wire.decode_frame(ref)).array())


def _ref_bf16_frame(a_bf16: np.ndarray, meta: bytes) -> bytes:
    """A code-10 frame laid out by the reference's header struct (its
    ``encode_frame`` cannot write bf16: ``memoryview`` rejects the
    ``ml_dtypes`` dtype)."""
    head = ref_wire._HEAD.pack(ref_wire.WIRE_MAGIC, ref_wire.WIRE_VERSION, 0, 10, a_bf16.ndim,
                               0, len(meta))
    shape = struct.pack("!%dI" % a_bf16.ndim, *a_bf16.shape)
    off = len(head) + len(shape) + len(meta)
    return head + shape + meta + b"\x00" * ((-off) % 8) + a_bf16.tobytes()


def test_bf16_frames_by_bit_pattern():
    """A bf16 frame the reference decodes with ml_dtypes is the port's frame
    of the same values as a torch.bfloat16 tensor; the port decodes it to
    the bits and widens them to float32 exactly, with no ml_dtypes."""
    a = np.random.default_rng(2).standard_normal((3, 6)).astype(ml_dtypes.bfloat16)
    meta = ref_wire.pack_wire_meta(puid="bf")
    frame = _ref_bf16_frame(a, meta)
    ref = ref_wire.decode_frame(frame)
    assert ref.array.dtype == a.dtype and np.array_equal(ref.array, a)
    got = wire.decode_frame(frame)
    assert got.bf16 and got.array.dtype == np.uint16
    assert np.array_equal(got.array, a.view(np.uint16))
    assert got.rows().dtype == np.float32 and np.array_equal(got.rows(), a.astype(np.float32))
    t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    assert wire.join_parts(wire.encode_frame(t, meta_bytes=meta)) == frame
    assert wire.join_parts(wire.encode_frame(a, meta_bytes=meta)) == frame
    msg = wire.message_from_frame(got)
    assert np.array_equal(msg.array(), a.astype(np.float32))
    # a plain uint16 array has no code, as in the reference
    with pytest.raises(wire.WireError):
        wire.encode_frame(np.zeros((2, 2), dtype=np.uint16))
    with pytest.raises(ref_wire.WireError):
        ref_wire.encode_frame(np.zeros((2, 2), dtype=np.uint16))


def test_multi_frames_alike():
    rng = np.random.default_rng(3)
    frames = [ref_wire.join_parts(ref_wire.encode_frame(
        rng.random((1, 4)), meta_bytes=ref_wire.pack_wire_meta(puid=f"s{i}"))) for i in range(5)]
    ref = ref_wire.join_parts(ref_wire.encode_multi(frames))
    assert wire.join_parts(wire.encode_multi(frames)) == ref
    got = wire.decode_frame(ref)
    assert got.is_multi and [bytes(s) for s in got.subframes] == frames
    assert [wire.decode_frame(s).meta["puid"] for s in got.subframes] == [
        f"s{i}" for i in range(5)]


def test_sidecar_versions_and_tears():
    meta = wire.pack_wire_meta(**_meta())
    assert wire.unpack_wire_meta(meta) == ref_wire.unpack_wire_meta(meta)
    future = bytes([2]) + meta[1:]
    assert wire.unpack_wire_meta(future) == ref_wire.unpack_wire_meta(future)
    assert wire.unpack_wire_meta(future)["puid"] is None
    for torn in (meta[:5], meta[:-3]):
        with pytest.raises(wire.WireError) as e:
            wire.unpack_wire_meta(torn)
        with pytest.raises(ref_wire.WireError):
            ref_wire.unpack_wire_meta(torn)
        assert e.value.http_code == 400


def _malformed():
    good = ref_wire.join_parts(ref_wire.encode_frame(np.zeros((2, 3))))
    multi = ref_wire.join_parts(ref_wire.encode_multi([good, good]))
    huge = bytearray(good)
    huge[14:22] = struct.pack("!II", 70000, 70000)
    return {
        "truncated_header": good[:10],
        "bad_magic": b"XXXX" + good[4:],
        "bad_version": good[:4] + bytes([9]) + good[5:],
        "unknown_dtype": good[:6] + bytes([11]) + good[7:],
        "short_payload": good[:-8],
        "trailing_bytes": good + b"\x00" * 8,
        "ndim_over_8": good[:7] + bytes([9]) + good[8:],
        "torn_multi": multi[:-4],
        "declared_too_large": bytes(huge),
        "scale_plane_on_float64": good[:5] + bytes([2]) + good[6:],
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_frames_raise_the_same_http_code(name):
    body = _malformed()[name]
    with pytest.raises(ref_wire.WireError) as want:
        ref_wire.decode_frame(body)
    with pytest.raises(wire.WireError) as got:
        wire.decode_frame(body)
    assert got.value.http_code == want.value.http_code
    assert got.value.http_code == (413 if name == "declared_too_large" else 400)


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_message_bridges_match_the_reference(kind):
    x = np.random.default_rng(4).random((2, 3))
    doc = {"data": {"names": ["a", "b", "c"], kind: (
        {"shape": [2, 3], "values": x.ravel().tolist()} if kind == "tensor" else x.tolist())},
        "meta": {"puid": "z", "tags": {"k": "v"}, "routing": {"r": 1},
                 "requestPath": {"m": "img"}},
        "status": {"code": 500, "info": "boom", "status": "FAILURE"}}
    ours, theirs = SeldonMessage.from_json_dict(doc), JaxMessage.from_json_dict(doc)
    frame = wire.join_parts(wire.frame_from_message(ours, response=True, sidecar=False))
    assert frame == ref_wire.join_parts(ref_wire.frame_from_message(theirs, response=True,
                                                                     sidecar=False))
    back = wire.message_from_frame(wire.decode_frame(frame))
    want = ref_wire.message_from_frame(ref_wire.decode_frame(frame))
    assert json.loads(back.to_json()) == json.loads(want.to_json())
    assert back.status.status == "FAILURE" and back.status.code == 500
    assert wire.frame_eligible(ours) and not wire.frame_eligible(SeldonMessage(str_data="s"))
    assert wire.frame_eligible(SeldonMessage.from_array(torch.zeros(2, 2, dtype=torch.bfloat16)))


def test_client_sidecar_carries_the_deadline():
    from seldon_core_tpu_torch.runtime.resilience import deadline_scope

    msg = SeldonMessage.from_array(np.zeros((1, 2)), meta=Meta(puid="d"))
    with deadline_scope(2.0):
        meta = wire.decode_frame(wire.join_parts(wire.frame_from_message(msg))).meta
    assert meta["puid"] == "d" and 1000.0 < meta["deadline_ms"] <= 2000.0
    assert meta["tenant"] is meta["tier"] is meta["traceparent"] is None


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


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8"])
def test_engine_predict_wire_matches_the_jax_engine(dtype):
    """The same frame through both engines: the same status, puid and
    names, probabilities within the MNIST tolerance (int8 with its scale
    plane), and a MULTI frame whose torn slot answers its own 400 frame."""
    x = np.random.default_rng(5).random((4, 784))
    if dtype == "int8":
        q, s = wire.quantize_rows(x)
        parts = wire.encode_frame(q, scales=s, meta_bytes=wire.pack_wire_meta(puid="w8"))
    else:
        parts = wire.encode_frame(x.astype(dtype), meta_bytes=wire.pack_wire_meta(puid="w8"))
    body = wire.join_parts(parts)
    torn = body[:-16]
    multi = wire.join_parts(wire.encode_multi([body, torn, body]))
    jax_engine, engine = _engines()

    async def both(payload):
        return (await engine.predict_wire(payload), await jax_engine.predict_wire(payload))

    try:
        (st, got), (jst, want) = asyncio.run(both(body))
        (mst, mgot), (jmst, mwant) = asyncio.run(both(multi))
    finally:
        engine.close()
    g, w = wire.decode_frame(wire.join_parts(got)), ref_wire.decode_frame(
        ref_wire.join_parts(want))
    assert st == jst == 200 and g.status == w.status == 200
    assert g.meta["puid"] == w.meta["puid"] == "w8" and g.extra() == w.extra()
    assert np.abs(g.array.astype(np.float64) - np.asarray(w.array, np.float64)).max() < ATOL
    assert mst == jmst == 200
    gs = [wire.decode_frame(s) for s in wire.decode_frame(wire.join_parts(mgot)).subframes]
    ws = [ref_wire.decode_frame(s) for s in ref_wire.decode_frame(
        ref_wire.join_parts(mwant)).subframes]
    assert [s.status for s in gs] == [s.status for s in ws] == [200, 400, 200]
    assert gs[1].extra()["error"] == ws[1].extra()["error"]
    assert np.array_equal(gs[0].array, g.array)


def test_engine_predict_wire_without_a_batcher_takes_the_object_path():
    """A graph with no batcher (batching off here; a router graph has none)
    answers a frame through ``predict``, the same rows as the batched
    lane's; a shape the graph rejects answers its own 400 frame."""
    x = np.random.default_rng(6).random((2, 784))
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu",
                           batching=False)
    batched = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")
    batched.load_states(engine.states())
    try:
        st, parts = asyncio.run(engine.predict_wire(wire.join_parts(wire.encode_frame(x))))
        bst, bparts = asyncio.run(batched.predict_wire(wire.join_parts(wire.encode_frame(x))))
        bad_st, bad = asyncio.run(engine.predict_wire(wire.join_parts(wire.encode_frame(
            np.zeros((1, 5))))))
    finally:
        engine.close()
        batched.close()
    assert engine.batcher is None and st == bst == 200
    f, bf = wire.decode_frame(wire.join_parts(parts)), wire.decode_frame(wire.join_parts(bparts))
    assert np.array_equal(f.values(), bf.values()) and f.extra()["names"] == bf.extra()["names"]
    assert bad_st == 400 and wire.decode_frame(wire.join_parts(bad)).status == 400


def _post(port, path, body, ctype, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", path, body, {"Content-Type": ctype})
    r = c.getresponse()
    out = r.status, r.getheader("Content-Type"), r.read()
    if conn is None:
        c.close()
    return out


def test_rest_predictions_route_speaks_the_wire(monkeypatch):
    """POST a frame to /api/v0.1/predictions and /predict: a frame back with
    the JSON answer's values; a torn frame a typed JSON 400 and an
    oversized one 413 on a connection that keeps serving; the kill switch
    415 while JSON still serves."""
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_mnist_doc()), device="cpu")
    x = np.random.default_rng(7).random((3, 784))
    frame = wire.join_parts(wire.encode_frame(x, meta_bytes=wire.pack_wire_meta(puid="rq")))
    huge = bytearray(frame)
    huge[14:22] = struct.pack("!II", 90000, 90000)

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        loop = asyncio.get_running_loop()

        def client():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
            try:
                out = {p: _post(server.port, p, frame, wire.WIRE_CONTENT_TYPE, conn)
                       for p in ("/api/v0.1/predictions", "/predict")}
                out["json"] = _post(server.port, "/api/v0.1/predictions", json.dumps(
                    {"data": {"tensor": {"shape": [3, 784], "values": x.ravel().tolist()}}}),
                    "application/json", conn)
                out["torn"] = _post(server.port, "/predict", frame[:-5],
                                    wire.WIRE_CONTENT_TYPE, conn)
                out["huge"] = _post(server.port, "/predict", bytes(huge),
                                    wire.WIRE_CONTENT_TYPE, conn)
                out["after"] = _post(server.port, "/predict", frame, wire.WIRE_CONTENT_TYPE,
                                     conn)
                monkeypatch.setenv("SELDON_TPU_WIRE", "0")
                out["off"] = _post(server.port, "/predict", frame, wire.WIRE_CONTENT_TYPE,
                                   conn)
                return out
            finally:
                conn.close()

        try:
            return await loop.run_in_executor(None, client)
        finally:
            await server.stop()

    try:
        out = asyncio.run(run())
    finally:
        engine.close()
    yj = np.asarray(json.loads(out["json"][2])["data"]["tensor"]["values"]).reshape(3, 10)
    for path in ("/api/v0.1/predictions", "/predict", "after"):
        st, ct, raw = out[path]
        f = wire.decode_frame(raw)
        assert st == 200 and ct == wire.WIRE_CONTENT_TYPE and f.meta["puid"] == "rq"
        assert np.array_equal(f.array.astype(np.float64), yj)
    assert out["torn"][0] == 400 and out["torn"][1] == "application/json"
    assert json.loads(out["torn"][2])["status"]["code"] == 400
    assert out["huge"][0] == 413 and json.loads(out["huge"][2])["status"]["code"] == 413
    assert out["off"][0] == 415 and b"SELDON_TPU_WIRE" in out["off"][2]
    assert engine.stats()["wire"]["bytes_copied"] > 0


def test_unit_routes_speak_the_wire():
    """The unit microservice: a frame on /predict and /route answers a frame
    (the route its 1x1 branch tensor), the same values as the JSON
    answer's; /aggregate answers a frame with 415; a torn frame 400."""
    import tests.test_torch_fusion  # noqa: F401  (registers the port's test.* units)

    rt = build_runtime("test.Scale", "MODEL", [], unit_name="s", device="cpu")
    router = build_runtime("test.CountingRouter", "ROUTER", [], unit_name="r", device="cpu")
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    frame = wire.join_parts(wire.encode_frame(x, meta_bytes=wire.pack_wire_meta(
        puid="u", extra={"names": ["a", "b", "c"], "kind": "ndarray"})))

    async def run():
        servers = [await serve_unit(rt, "127.0.0.1", 0), await serve_unit(router, "127.0.0.1", 0)]
        ports = [s.port for s in servers]

        def client():
            return {
                "predict": _post(ports[0], "/predict", frame, wire.WIRE_CONTENT_TYPE),
                "json": _post(ports[0], "/predict", json.dumps(
                    {"data": {"names": ["a", "b", "c"], "ndarray": x.tolist()}}),
                    "application/json"),
                "route": _post(ports[1], "/route", frame, wire.WIRE_CONTENT_TYPE),
                "aggregate": _post(ports[0], "/aggregate", frame, wire.WIRE_CONTENT_TYPE),
                "torn": _post(ports[0], "/predict", frame[:-4], wire.WIRE_CONTENT_TYPE),
            }

        try:
            return await asyncio.get_running_loop().run_in_executor(None, client)
        finally:
            for s in servers:
                await s.stop()

    out = asyncio.run(run())
    st, ct, raw = out["predict"]
    f = wire.decode_frame(raw)
    doc = json.loads(out["json"][2])
    assert st == 200 and ct == wire.WIRE_CONTENT_TYPE and f.is_response and f.status == 200
    assert np.array_equal(np.asarray(f.values(), np.float64), np.asarray(doc["data"]["ndarray"]))
    assert f.extra()["kind"] == "ndarray" and f.extra()["names"] == doc["data"]["names"]
    st, ct, raw = out["route"]
    assert st == 200 and ct == wire.WIRE_CONTENT_TYPE
    assert wire.decode_frame(raw).values().tolist() == [[0.0]]
    assert out["aggregate"][0] == 415 and out["torn"][0] == 400


def test_status_of_a_failed_unit_answer_rides_the_frame():
    msg = SeldonMessage.failure("nope", code=503, meta=Meta(puid="f"))
    f = wire.decode_frame(wire.join_parts(wire.frame_from_message(msg, response=True)))
    assert f.status == 503 and f.extra()["error"] == "nope" and f.array is None
    back = wire.message_from_frame(f)
    assert back.status == Status.failure("nope", code=503) and back.meta.puid == "f"
