"""The port's checkpoint hand-off (seldon_core_tpu_torch/runtime/
persistence.py and models/transformer.py ``save_lm_weights`` /
``load_lm_weights``) against the JAX package's: the same ``.npz`` format,
files that cross between the packages in f32 both ways, the same strict
errors, and a generator served from a ``weights_path``."""

import asyncio
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.models.generate import TransformerGenerator
from seldon_core_tpu_torch.runtime import persistence
from seldon_core_tpu_torch.tree import leaves_with_paths

# the module itself: the package re-exports a class of the same name
jgen = importlib.import_module("seldon_core_tpu.models.generate")

DIMS = dict(vocab=48, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tier-1 runs under several xdist workers: keep torch's CPU pool small
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_params(dtype, seed=0, **dims):
    cfg = ttr.LMConfig(**{**DIMS, **dims}, dtype=dtype)
    return ttr.lm_init(torch.Generator().manual_seed(seed), cfg, "cpu")


def _jax_params(seed=0, **dims):
    cfg = jtr.LMConfig(**{**DIMS, **dims}, dtype=jnp.float32)
    return jtr.lm_init(jax.random.key(seed), cfg)


def _same(a, b):
    for (ka, ta), (kb, tb) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert ka == kb and ta.dtype == tb.dtype and torch.equal(ta, tb), ka


def test_keys_are_jax_keystr_paths(tmp_path):
    params = _port_params(torch.float32)
    path = ttr.save_lm_weights(params, str(tmp_path / "w.npz"))
    with np.load(path) as data:
        keys = sorted(data.files)
    want = sorted(jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(_jax_params())[0])
    assert keys == want and "['l0']['wqkv']" in keys and "['embed']" in keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_in_the_port_is_bit_identical(dtype, tmp_path):
    trained = _port_params(dtype, seed=1)
    path = ttr.save_lm_weights(trained, str(tmp_path / "w.npz"))
    if dtype == torch.bfloat16:  # the bit pattern the JAX package writes
        with np.load(path) as data:
            assert data["['embed']"].dtype.str == "|V2"
    _same(ttr.load_lm_weights(_port_params(dtype, seed=2), path), trained)
    # state_to_host / state_from_host without a file, any nesting
    state = {"params": trained, "count": torch.tensor(3, dtype=torch.int32)}
    _same(persistence.state_from_host(persistence.state_to_host(state), state), state)


def test_bf16_checkpoint_serves_an_f32_config_and_f32_serves_bf16(tmp_path):
    bf = _port_params(torch.bfloat16, seed=3)
    path = ttr.save_lm_weights(bf, str(tmp_path / "bf.npz"))
    as_f32 = ttr.load_lm_weights(_port_params(torch.float32), path)
    _same(as_f32, {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                       else v.float()) for k, v in bf.items()})
    f32 = _port_params(torch.float32, seed=4)
    path = ttr.save_lm_weights(f32, str(tmp_path / "f32.npz"))
    as_bf16 = ttr.load_lm_weights(_port_params(torch.bfloat16), path)
    for (_, got), (_, src) in zip(leaves_with_paths(as_bf16), leaves_with_paths(f32)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, src.to(torch.bfloat16))  # RNE


def test_f32_checkpoints_cross_between_the_packages(tmp_path):
    # port -> JAX
    port = _port_params(torch.float32, seed=5)
    path = ttr.save_lm_weights(port, str(tmp_path / "port.npz"))
    loaded = jtr.load_lm_weights(_jax_params(seed=6), path)
    for (key, leaf) in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        want = dict(leaves_with_paths(port))[jax.tree_util.keystr(key)]
        np.testing.assert_array_equal(np.asarray(leaf), want.numpy())
    # JAX -> port
    jp = _jax_params(seed=7)
    path = jtr.save_lm_weights(jp, str(tmp_path / "jax.npz"))
    got = ttr.load_lm_weights(_port_params(torch.float32), path)
    _same(got, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


def test_strict_errors_carry_the_jax_messages(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError) as got:
        ttr.load_lm_weights(_port_params(torch.float32), missing)
    with pytest.raises(FileNotFoundError) as want:
        jtr.load_lm_weights(_jax_params(), missing)
    assert str(got.value) == str(want.value)
    # a one-layer checkpoint does not cover a two-layer config
    short = ttr.save_lm_weights(_port_params(torch.float32, n_layers=1), str(tmp_path / "s.npz"))
    # a narrower d_ff: every w1/w2 leaf has another shape
    narrow = ttr.save_lm_weights(_port_params(torch.float32, d_ff=32), str(tmp_path / "n.npz"))
    for path, match in ((short, "does not cover"), (narrow, "shape mismatch")):
        with pytest.raises(ValueError, match=match) as got:
            ttr.load_lm_weights(_port_params(torch.float32), path)
        with pytest.raises(ValueError, match=match) as want:
            jtr.load_lm_weights(_jax_params(), path)
        assert str(got.value) == str(want.value)


def test_generator_serves_a_checkpoint_like_the_jax_unit(tmp_path):
    path = jtr.save_lm_weights(_jax_params(seed=8), str(tmp_path / "trained.npz"))
    kw = dict(**DIMS, max_new_tokens=6, dtype="float32", weights_path=path)
    junit = jgen.TransformerGenerator(**kw)
    jstate = junit.init_state(jax.random.key(0))
    unit = TransformerGenerator(**kw, device="cpu")
    state = unit.init_state(None)
    prompt = np.random.default_rng(9).integers(0, DIMS["vocab"], size=(2, 8)).astype(np.float32)
    want = np.asarray(jax.jit(junit.predict)(jstate, jnp.asarray(prompt)))
    got = unit.predict(state, torch.from_numpy(prompt)).numpy()
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got, want)  # greedy f32 tokens
    # the TransformerLM unit loads the same file
    lm = ttr.TransformerLM(**DIMS, dtype="float32", weights_path=path, device="cpu")
    _same(lm.init_state(None), state["params"])


# -- unit-state persistence (runtime/persistence.py, [4d]) -----------------------


@pytest.fixture
def state_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("SELDON_DEPLOYMENT_ID", "dep")
    monkeypatch.setenv("PREDICTOR_ID", "pred")
    return tmp_path


def _bandit_runtime(seed=0):
    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.runtime.microservice import build_runtime

    params = [Parameter.from_json_dict(p) for p in (
        {"name": "n_branches", "value": "3", "type": "INT"},
        {"name": "epsilon", "value": "0.5", "type": "FLOAT"},
        {"name": "seed", "value": str(seed), "type": "INT"})]
    return build_runtime("EpsilonGreedyRouter", "ROUTER", params, unit_name="eg", device="cpu")


def _route_and_reward(rt, n):
    """n routes, each rewarded 1 when its branch is 0: the state moves."""
    branches = []
    for i in range(n):
        branch, aux = rt.unit.route(rt.state, torch.zeros(2, 4))
        rt.state = aux.state
        rt.state = rt.unit.send_feedback(rt.state, torch.zeros(2, 4), int(branch),
                                         float(int(branch) == 0), None)
        branches.append(int(branch))
    return branches


def test_unit_state_round_trips_bit_for_bit_and_the_key_stream_continues(state_dir):
    """save_state / load_state / restore_runtime in the port: a bandit's
    counters and key come back bit for bit under the reference's file name,
    the key as the reference's ``__prngkey__:`` uint32 words, and the
    restored unit's next routes are the saving unit's."""
    rt = _bandit_runtime()
    _route_and_reward(rt, 7)
    path = persistence.save_state("eg", rt.state)
    assert path == str(state_dir / "dep_pred_eg.ckpt.npz") == persistence.checkpoint_path("eg")
    with np.load(path) as data:
        assert sorted(data.files) == ["['success']", "['tries']", "__prngkey__:['key']"]
        assert data["__prngkey__:['key']"].dtype == np.uint32
    fresh = _bandit_runtime(seed=99)
    persistence.restore_runtime(fresh)
    for k in ("success", "tries", "key"):
        assert fresh.state[k].dtype == rt.state[k].dtype and torch.equal(fresh.state[k],
                                                                          rt.state[k]), k
    assert _route_and_reward(fresh, 12) == _route_and_reward(rt, 12)
    assert persistence.load_state("absent", {"x": torch.ones(2)})["x"].tolist() == [1.0, 1.0]
    assert persistence.save_state("stateless", None) is None


def test_persist_loop_saves_on_a_worker_thread_until_cancelled(state_dir):
    rt = _bandit_runtime()
    _route_and_reward(rt, 3)
    threads = []
    real = persistence.save_state

    def save(name, state):
        import threading

        threads.append(threading.current_thread() is threading.main_thread())
        return real(name, state)

    async def run():
        persistence.save_state = save
        try:
            task = asyncio.get_running_loop().create_task(persistence.persist_loop(rt, 0.05))
            while not threads:
                await asyncio.sleep(0.02)
            task.cancel()
        finally:
            persistence.save_state = real

    asyncio.run(asyncio.wait_for(run(), 20))
    assert threads and not any(threads)  # never the loop's thread
    loaded = persistence.load_state("eg", _bandit_runtime(seed=5).state)
    assert torch.equal(loaded["tries"], rt.state["tries"]) and float(rt.state["tries"].sum()) == 6


def test_a_bandit_file_crosses_between_the_packages(state_dir):
    """A file the JAX package's save_state wrote loads into the port's
    EpsilonGreedyRouter with success and tries exact and the key's words;
    the port's file loads into the JAX unit the same way."""
    from seldon_core_tpu.models.mab import EpsilonGreedyRouter as JaxRouter
    from seldon_core_tpu.runtime import persistence as jpersist

    jstate = JaxRouter(n_branches=3).init_state(None)
    jstate = {**jstate, "success": jnp.asarray([2.0, 0.0, 5.0], jnp.float32),
              "tries": jnp.asarray([4.0, 1.0, 9.0], jnp.float32)}
    jpersist.save_state("eg", jstate)
    got = persistence.load_state("eg", _bandit_runtime().state)
    assert got["success"].tolist() == [2.0, 0.0, 5.0] and got["tries"].tolist() == [4.0, 1.0, 9.0]
    assert got["key"].tolist() == np.asarray(jax.random.key_data(jstate["key"])).tolist()
    # the port's file into the JAX unit
    rt = _bandit_runtime()
    _route_and_reward(rt, 9)
    persistence.save_state("eg", rt.state)
    back = jpersist.load_state("eg", JaxRouter(n_branches=3).init_state(None))
    np.testing.assert_array_equal(np.asarray(back["success"]), rt.state["success"].numpy())
    np.testing.assert_array_equal(np.asarray(back["tries"]), rt.state["tries"].numpy())
    assert np.asarray(jax.random.key_data(back["key"])).tolist() == rt.state["key"].tolist()


def test_the_microservice_serves_persistence_over_rest(state_dir):
    """``microservice EpsilonGreedyRouter ROUTER --persistence 1``: routes
    and feedback move the state, a periodic save writes it, and a restart
    restores it (its /route answers continue the same key stream as an
    in-process unit restored from the same file)."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1",
           "PERSISTENCE_FREQUENCY": "0.2", "PREDICTIVE_UNIT_ID": "eg",
           "PREDICTIVE_UNIT_PARAMETERS": json.dumps(
               [{"name": "n_branches", "value": "3", "type": "INT"},
                {"name": "epsilon", "value": "0.5", "type": "FLOAT"}])}
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
           "EpsilonGreedyRouter", "REST", "--service-type", "ROUTER", "--persistence", "1",
           "--device", "cpu", "--host", "127.0.0.1", "--port", str(port)]
    body = json.dumps({"data": {"ndarray": [[0.0] * 4]}}).encode()

    def post(path, data):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def serve(n_routes, feedback):
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            assert proc.stdout.readline().startswith("unit up:")
            routes = []
            for _ in range(n_routes):
                routes.append(int(post("/route", body)["data"]["ndarray"][0][0]))
                if feedback:
                    post("/send-feedback", json.dumps({
                        "request": json.loads(body), "reward": float(routes[-1] == 0),
                        "response": {"meta": {"routing": {"eg": routes[-1]}},
                                     "data": {"ndarray": [[routes[-1]]]}}}).encode())
            ckpt = Path(persistence.checkpoint_path("eg"))
            t0 = time.time()
            while feedback and time.time() - t0 < 20:
                if ckpt.exists():
                    with np.load(ckpt) as data:
                        if float(data["['tries']"].sum()) == n_routes:
                            break
                time.sleep(0.1)
            return routes
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=30)

    first = serve(10, feedback=True)
    with np.load(persistence.checkpoint_path("eg")) as data:
        saved = {k: np.array(data[k]) for k in data.files}
    assert float(saved["['tries']"].sum()) == 10
    twin = _bandit_runtime()
    persistence.restore_runtime(twin)
    want = []
    for _ in range(10):
        branch, aux = twin.unit.route(twin.state, torch.zeros(1, 4))
        twin.state = aux.state
        want.append(int(branch))
    assert serve(10, feedback=False) == want and len(first) == 10
