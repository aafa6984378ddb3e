"""The port's token streaming (seldon_core_tpu_torch/models/generate.py
``stream_chunks``, the engine's ``generate_stream`` and the REST lane's
``POST /api/v0.1/generate/stream``) against the JAX package, on the same
weights (carried across with convert.params_from_jax) and prompts (numpy,
from a seed).  In f32 the greedy streamed tokens must be identical to the
JAX package's stream and to the port's own ``generate``."""

import asyncio
import importlib
import itertools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.transformer import LMConfig as JConfig
from seldon_core_tpu.models.transformer import lm_init as jax_lm_init
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.messages import SeldonMessageError
from seldon_core_tpu_torch.models.transformer import LMConfig as TConfig
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

jgen = importlib.import_module("seldon_core_tpu.models.generate")
tgen = importlib.import_module("seldon_core_tpu_torch.models.generate")
DIMS = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)
JCFG = JConfig(**DIMS, dtype=jnp.float32)
TCFG = TConfig(**DIMS, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
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


def _weights(seed=0):
    jp = jax_lm_init(jax.random.key(seed), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _prompt(shape, seed):
    return np.random.default_rng(seed).integers(0, DIMS["vocab"], size=shape).astype(np.int32)


def _port_stream(tp, prompt, **kw):
    return [c.cpu().numpy() for c in tgen.stream_chunks(tp, torch.from_numpy(prompt), TCFG, **kw)]


def _jax_stream(jp, prompt, **kw):
    return [np.asarray(c) for c in jgen.stream_chunks(jp, jnp.asarray(prompt), JCFG, **kw)]


@pytest.mark.parametrize("max_new,chunk,sizes", [
    (21, 8, [8, 8, 5]),
    (10, 4, [4, 4, 2]),            # the tail chunk is smaller
    (140, 8, [8] * 17 + [4]),      # longer than STREAM_CHUNK_CAP: grow_merge runs
])
def test_stream_chunks_match_jax_stream_and_generate(max_new, chunk, sizes, monkeypatch):
    jp, tp = _weights(1)
    prompt = _prompt((2, 5), 2)
    merges = []
    orig = tgen.grow_merge
    monkeypatch.setattr(tgen, "grow_merge", lambda *a: merges.append(a[3]) or orig(*a))
    got = _port_stream(tp, prompt, max_new_tokens=max_new, chunk=chunk)
    assert [c.shape[1] for c in got] == sizes and all(c.dtype == np.int32 for c in got)
    streamed = np.concatenate(got, axis=1)
    want = np.concatenate(_jax_stream(jp, prompt, max_new_tokens=max_new, chunk=chunk), axis=1)
    np.testing.assert_array_equal(streamed, want)
    one_shot = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=max_new)
    np.testing.assert_array_equal(streamed, one_shot.numpy())
    # a merge folds in the 127 buffered tokens when the next 8 would overflow
    assert merges == ([127] if max_new > tgen.STREAM_CHUNK_CAP else [])


@pytest.mark.parametrize("B", [1, 2])
def test_eos_latch_and_host_padding_match_jax(B, monkeypatch):
    """eos is row 0's third greedy token: the device latch masks after it,
    and once every row has stopped (B=1) the host pads the remaining
    chunks without a decode step."""
    jp, tp = _weights(3)
    prompt = _prompt((B, 4), 4)
    plain = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=20).numpy()
    eos = int(plain[0, 2])
    steps = []
    orig = tgen._chunk_step
    monkeypatch.setattr(tgen, "_chunk_step", lambda *a, **k: steps.append(a[7]) or orig(*a, **k))
    got = _port_stream(tp, prompt, max_new_tokens=20, chunk=4, eos_token=eos)
    stream_steps = list(steps)
    streamed = np.concatenate(got, axis=1)
    want = np.concatenate(_jax_stream(jp, prompt, max_new_tokens=20, chunk=4, eos_token=eos),
                          axis=1)
    np.testing.assert_array_equal(streamed, want)
    one_shot = tgen.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=20,
                             eos_token=eos).numpy()
    np.testing.assert_array_equal(streamed, one_shot)
    assert (streamed[0, 3:] == eos).all()
    if B == 1:  # stopped inside the first chunk: no decode step after it
        assert stream_steps == [3]


def test_chunk_eos_mask_matches_jax():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 4, size=(5, 6)).astype(np.int32)
    seen = np.array([False, True, False, False, True])
    want = jgen._chunk_eos_mask(jnp.asarray(toks), jnp.asarray(seen), 2)
    got = tgen._chunk_eos_mask(torch.from_numpy(toks), torch.from_numpy(seen), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].ndim == 0


def test_grow_merge_matches_jax():
    rng = np.random.default_rng(6)
    main = {f"l{i}": {kk: rng.normal(size=(2, 2, 5, 8)).astype(np.float32) for kk in "kv"}
            for i in range(2)}
    chunk = {f"l{i}": {kk: rng.normal(size=(2, 2, 7, 8)).astype(np.float32) for kk in "kv"}
             for i in range(2)}
    cfg = JConfig(**{**DIMS, "n_layers": 2})
    want = jgen.grow_merge(jax.tree_util.tree_map(jnp.asarray, main),
                           jax.tree_util.tree_map(jnp.asarray, chunk), cfg, 3)
    got = tgen.grow_merge(jax.tree_util.tree_map(torch.from_numpy, main),
                          jax.tree_util.tree_map(torch.from_numpy, chunk), TCFG, 3)
    for li in want:
        for kk in "kv":
            assert got[li][kk].shape == (2, 2, 8, 8)
            np.testing.assert_array_equal(got[li][kk].numpy(), np.asarray(want[li][kk]))


def _gen_doc(max_new=16, extra=()):
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in DIMS.items()]
    params += [{"name": "max_new_tokens", "value": str(max_new), "type": "INT"},
               {"name": "dtype", "value": "float32", "type": "STRING"}]
    params += [{"name": k, "value": v, "type": t} for k, v, t in extra]
    return {"spec": {"name": "sg", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": params}]}]}}


def _gen_engine(max_new=16, seed=7):
    """A port engine serving the tiny generator with a JAX unit's weights,
    and that JAX unit and its state."""
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_gen_doc(max_new)), device="cpu")
    junit = jgen.TransformerGenerator(**DIMS, max_new_tokens=max_new, dtype="float32")
    jstate = junit.init_state(jax.random.key(seed))
    engine.load_states({"g": params_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                             device="cpu")})
    return engine, junit, jstate


async def _collect(agen):
    events = []
    async for event in agen:
        events.append(json.loads(event))
    return events


def test_engine_stream_equals_predict_json_and_the_jax_unit(monkeypatch):
    # the static lane's stream: the unit's stream_tokens, max_new unused
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    engine, junit, jstate = _gen_engine()
    try:
        assert engine.can_stream()
        X = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
        payload = json.dumps({"data": {"ndarray": X}, "meta": {"puid": "p-1"}, "max_new": 3,
                              "chunk": 5})

        async def run():
            text, status = await engine.predict_json(json.dumps({"data": {"ndarray": X}}))
            assert status == 200
            request = engine.prepare_stream_request(payload)
            return json.loads(text), await _collect(engine.generate_stream(request))

        doc, events = asyncio.run(run())
    finally:
        engine.close()
    assert events[-1] == {"done": True, "meta": {"puid": "p-1"}}
    chunks = [np.asarray(e["tokens"]) for e in events[:-1]]
    assert [c.shape for c in chunks] == [(2, 5), (2, 5), (2, 5), (2, 1)]
    assert all(not e["done"] for e in events[:-1])
    streamed = np.concatenate(chunks, axis=1)  # max_new is accepted and not used
    np.testing.assert_array_equal(streamed, np.asarray(doc["data"]["ndarray"]))
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(X, jnp.float32)))
    np.testing.assert_array_equal(streamed, want)
    assert engine.stats()["kernels"]["flash_decode"] == {"launches": 0}  # CPU: no kernel
    assert engine.stats()["kernels"]["kv_write"] == {"launches": 0}


@pytest.mark.parametrize("extra", [
    [("temperature", "0.7", "FLOAT"), ("top_k", "20", "INT"), ("top_p", "0.9", "FLOAT")],
    [("prefix_tokens", "5,1,9,2,7", "STRING")],
], ids=["sampled", "prefix"])
def test_stream_refuses_sampling_and_a_prefix(extra, monkeypatch):
    """Sampled and prefix streams, once refused, are served: on the static
    lane the engine's stream of a sampled unit equals the unit's own
    ``stream_tokens`` under the same stream counter, and a second stream
    draws anew; a prefix unit's stream equals its ``predict_json`` answer."""
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(_gen_doc(extra=extra)),
                           device="cpu")
    sampled = extra[0][0] == "temperature"
    try:
        X = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
        payload = json.dumps({"data": {"ndarray": X}, "chunk": 5})
        monkeypatch.setattr(tgen, "_stream_counter", itertools.count(11))

        async def run():
            text, status = await engine.predict_json(json.dumps({"data": {"ndarray": X}}))
            assert status == 200
            streams = [await _collect(engine.generate_stream(engine.prepare_stream_request(
                payload))) for _ in range(2)]
            return np.asarray(json.loads(text)["data"]["ndarray"]), streams

        answer, streams = asyncio.run(run())
        got = []
        for events in streams:
            assert events[-1]["done"] and not any(e["done"] for e in events[:-1])
            got.append(np.concatenate([np.asarray(e["tokens"]) for e in events[:-1]], axis=1))
        assert got[0].shape == (2, 16)
        if sampled:
            monkeypatch.setattr(tgen, "_stream_counter", itertools.count(11))
            unit, state = engine.compiled.units["g"], engine.states()["g"]
            for streamed in got:
                want = torch.cat(list(unit.stream_tokens(state, np.asarray(X), chunk=5)), dim=1)
                np.testing.assert_array_equal(streamed, want.numpy())
            assert (got[0] != got[1]).any()
        else:
            for streamed in got:
                np.testing.assert_array_equal(streamed, answer)
    finally:
        engine.close()


def test_stream_request_validation_is_pre_flight():
    """Anything wrong with a streaming request is a SeldonMessageError (a
    plain 400) before any stream exists; chunk is clamped to 1..256."""
    engine, _, _ = _gen_engine(max_new=4)
    try:
        req = engine.prepare_stream_request('{"data":{"ndarray":[[1, 2]]},"chunk":3}')
        assert req.chunk == 3 and req.rows.tolist() == [[1.0, 2.0]] and req.puid
        assert engine.prepare_stream_request('{"data":{"ndarray":[[1]]},"chunk":999}').chunk == 256
        assert engine.prepare_stream_request('{"data":{"ndarray":[[1]]},"chunk":0}').chunk == 1
        assert engine.prepare_stream_request('{"data":{"ndarray":[[1]]}}').chunk == 8
        for bad, match in (("not json", "invalid JSON"),
                           ('{"data":{"ndarray":[[1]]},"chunk":"many"}', "chunk must be"),
                           ('{"data":{"ndarray":[[1]]},"max_new":"x"}', "max_new"),
                           ('{"strData":"hi"}', "numeric prompt"),
                           ('{"data":{"ndarray":[[]]}}', "numeric prompt"),
                           ('{"data":{"ndarray":[[[1, 2]]]}}', "numeric prompt")):
            with pytest.raises(SeldonMessageError, match=match):
                engine.prepare_stream_request(bad)
    finally:
        engine.close()


def test_non_generator_graph_cannot_stream():
    doc = {"spec": {"name": "m", "predictors": [{
        "name": "p", "graph": {"name": "mnist", "type": "MODEL"},
        "components": [{"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": "16", "type": "INT"}]}]}]}}
    engine = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    try:
        assert not engine.can_stream()
        with pytest.raises(SeldonMessageError, match="single generator node"):
            engine.prepare_stream_request('{"data":{"ndarray":[[1]]}}')
    finally:
        engine.close()


async def _post_stream(port, payload: bytes, read_all=True):
    """POST to the stream route on a raw connection: (status line, head,
    SSE events de-chunked, whether the terminal 0-length chunk came)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"POST /api/v0.1/generate/stream HTTP/1.1\r\nHost: t\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
    status = head.split(b"\r\n")[0]
    body, terminal = b"", False
    if b" 200 " in status:
        while True:
            size_line = await asyncio.wait_for(reader.readuntil(b"\r\n"), 30)
            n = int(size_line.strip(), 16)
            if n == 0:
                assert await reader.readexactly(2) == b"\r\n"
                terminal = True
                break
            body += await reader.readexactly(n)
            assert await reader.readexactly(2) == b"\r\n"
            if not read_all:
                break
    else:
        clen = int([ln for ln in head.split(b"\r\n") if ln.lower().startswith(b"content-length")][0]
                   .split(b":")[1])
        body = await reader.readexactly(clen)
    writer.close()
    if b" 200 " not in status:
        return status, head, json.loads(body), terminal
    events = [json.loads(block[len("data: "):]) for block in body.decode().split("\n\n")
              if block.startswith("data: ")]
    assert body.decode().count("data: ") == len(events)  # every frame parses
    return status, head, events, terminal


def test_sse_route_frames_equal_predict_and_refuse_bad_requests_with_400():
    engine, _, _ = _gen_engine(max_new=12)

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        try:
            ok = await _post_stream(server.port, json.dumps(
                {"data": {"ndarray": [[9, 8, 7]]}, "chunk": 4, "meta": {"puid": "s-1"}}).encode())
            bad = await _post_stream(server.port, b'{"data":{"ndarray":[[1]]},"chunk":"x"}')
            text, _ = await engine.predict_json(json.dumps({"data": {"ndarray": [[9, 8, 7]]}}))
            return ok, bad, json.loads(text)
        finally:
            await server.stop()

    try:
        (status, head, events, terminal), bad, doc = asyncio.run(run())
    finally:
        engine.close()
    assert status == b"HTTP/1.1 200 OK"
    assert b"content-type: text/event-stream" in head.lower()
    assert b"transfer-encoding: chunked" in head.lower() and b"content-length" not in head.lower()
    assert terminal and events[-1] == {"done": True, "meta": {"puid": "s-1"}}
    streamed = np.concatenate([np.asarray(e["tokens"]) for e in events[:-1]], axis=1)
    assert [len(e["tokens"][0]) for e in events[:-1]] == [4, 4, 4]
    np.testing.assert_array_equal(streamed, np.asarray(doc["data"]["ndarray"]))
    b_status, _, b_doc, _ = bad
    assert b_status.startswith(b"HTTP/1.1 400")
    assert b_doc["status"]["status"] == "FAILURE" and "chunk" in b_doc["status"]["info"]


class _FakeStreamer:
    """A stand-in ``stream_tokens``: ``fail_after`` chunks, then it raises
    (or, with ``fail_after`` None, yields slowly forever); it records its
    close."""

    def __init__(self, fail_after=None):
        self.fail_after = fail_after
        self.closed = False

    def __call__(self, state, X, chunk=8):
        try:
            i = 0
            while True:
                if self.fail_after is not None and i == self.fail_after:
                    raise RuntimeError("device fault in chunk")
                if self.fail_after is None and i:
                    time.sleep(0.05)
                yield torch.full((1, 2), i, dtype=torch.int32)
                i += 1
        finally:
            self.closed = True


def _engine_with(streamer):
    engine, _, _ = _gen_engine(max_new=4)
    engine.compiled.units["g"].stream_tokens = streamer
    return engine


def test_a_failure_mid_stream_ends_with_an_error_frame_and_closes(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")  # the static lane's stream_tokens
    streamer = _FakeStreamer(fail_after=2)
    engine = _engine_with(streamer)
    payload = b'{"data":{"ndarray":[[1, 2]]}}'

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            writer.write(b"POST /api/v0.1/generate/stream HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
            raw = await asyncio.wait_for(reader.read(), 30)  # until the server closes
            writer.close()
            return raw
        finally:
            await server.stop()

    try:
        raw = asyncio.run(run())
    finally:
        engine.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    frames = []
    while True:  # de-chunk: the server sent the terminal chunk, then closed
        size, _, body = body.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            assert body == b"\r\n"
            break
        frames.append(json.loads(body[:n].decode()[len("data: "):]))
        body = body[n + 2:]
    assert [f.get("tokens") for f in frames[:2]] == [[[0.0, 0.0]], [[1.0, 1.0]]]
    assert frames[2:] == [{"done": True, "error": "device fault in chunk"}]
    assert streamer.closed


def test_a_client_that_disconnects_closes_the_generator(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_GEN_CONTINUOUS", "0")  # the static lane's stream_tokens
    streamer = _FakeStreamer()
    engine = _engine_with(streamer)

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        try:
            status, _, events, terminal = await _post_stream(
                server.port, b'{"data":{"ndarray":[[1, 2]]}}', read_all=False)
            assert status == b"HTTP/1.1 200 OK" and not terminal and len(events) == 1
            for _ in range(200):  # the connection is gone: the writer stops
                if streamer.closed:
                    break
                await asyncio.sleep(0.05)
            return streamer.closed
        finally:
            await server.stop()

    try:
        closed = asyncio.run(run())
    finally:
        engine.close()
    assert closed


def test_chunked_request_bodies_are_still_declined():
    engine, _, _ = _gen_engine(max_new=4)

    async def run():
        server = await serve_fast(engine, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            writer.write(b"POST /api/v0.1/generate/stream HTTP/1.1\r\nHost: x\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n")
            line = await asyncio.wait_for(reader.readline(), 30)
            writer.close()
            return line
        finally:
            await server.stop()

    try:
        assert asyncio.run(run()).startswith(b"HTTP/1.1 501")
    finally:
        engine.close()
