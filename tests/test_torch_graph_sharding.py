"""Graph sharding in the port (``seldon_core_tpu_torch/graph/sharding.py``,
``engine_main --node``) against the JAX package's
(``tests/test_graph_sharding.py``): ``shardable_nodes``, ``node_subspec``
and ``shard_predictor`` give the JAX functions' specs, field for field, and
their errors; a combiner served by a sharded root (node engines behind
``POST /predict`` over TCP and a ``unix:`` socket) answers what the
collapsed engine answers; ``ENGINE_GRAPH_NODE`` / ``--node`` slice the
shipped deployment to one leaf and serve it."""

import asyncio
import copy
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import sharding as jsh
from seldon_core_tpu.graph.spec import GraphSpecError as JGraphSpecError
from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
from seldon_core_tpu_torch.graph import sharding as psh
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.rest import serve_fast

ROOT = Path(__file__).resolve().parent.parent
SHARD_ANNOTATION = "seldon.io/shard-graph"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_learned_singletons()
    yield
    reset_learned_singletons()
    torch.set_num_threads(prev)


def combiner_doc(name="shard-dep", annotate=False, n_members=2):
    doc = {"spec": {"name": name, "predictors": [{
        "name": "p",
        "graph": {"name": "ens", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                  "children": [{"name": f"m{i}", "type": "MODEL"} for i in range(n_members)]},
        "components": [{"name": f"m{i}", "runtime": "inprocess",
                        "class_path": "SigmoidPredictor",
                        "parameters": [{"name": "n_features", "value": "4", "type": "INT"},
                                       {"name": "seed", "value": str(i), "type": "INT"}]}
                       for i in range(n_members)],
    }]}}
    if annotate:
        doc["spec"]["annotations"] = {SHARD_ANNOTATION: "true"}
    return doc


def both(doc):
    return JSpec.from_json_dict(copy.deepcopy(doc)), SeldonDeploymentSpec.from_json_dict(
        copy.deepcopy(doc))


def _same(port_spec, jax_spec):
    assert port_spec.to_json_dict() == jax_spec.to_json_dict()


@pytest.mark.parametrize("remote", [False, True])
def test_shardable_nodes_match_reference(remote):
    """The MODEL leaves with inprocess bindings; a leaf already bound
    remotely is not shardable."""
    j, p = both(combiner_doc(n_members=3))
    for spec in (j, p):
        if remote:
            b = spec.predictors[0].components[0]
            b.runtime, b.host, b.port = "rest", "h", 9000
    got = [u.name for u in psh.shardable_nodes(p.predictor("p"))]
    assert got == [u.name for u in jsh.shardable_nodes(j.predictor("p"))]
    assert got == (["m1", "m2"] if remote else ["m0", "m1", "m2"])


@pytest.mark.parametrize("node", ["m0", "m1"])
def test_node_subspec_matches_reference(node):
    j, p = both(combiner_doc(annotate=True))
    sub = psh.node_subspec(p, node)
    _same(sub, jsh.node_subspec(j, node))
    assert sub.name == f"shard-dep-p-{node}"
    pred = sub.predictors[0]
    assert pred.graph.name == node and not pred.graph.children
    assert [b.name for b in pred.components] == [node]
    assert SHARD_ANNOTATION not in sub.annotations
    assert p.predictor("p").graph.find(node) is not None  # the source is untouched


@pytest.mark.parametrize("bad,match", [("nope", "not found"), ("ens", "children")])
def test_node_subspec_refusals_match_reference(bad, match):
    j, p = both(combiner_doc())
    with pytest.raises(JGraphSpecError, match=match) as jerr:
        jsh.node_subspec(j, bad)
    with pytest.raises(GraphSpecError, match=match) as perr:
        psh.node_subspec(p, bad)
    assert str(perr.value) == str(jerr.value)


def test_shard_predictor_matches_reference():
    j, p = both(combiner_doc())
    ends = {"m0": ("node-a", 8000), "m1": ("unix:/run/m1.sock", 0)}
    sharded = psh.shard_predictor(p, ends)
    _same(sharded, jsh.shard_predictor(j, ends))
    comp = {b.name: b for b in sharded.predictor("p").components}
    assert comp["m0"].runtime == "rest" and (comp["m0"].host, comp["m0"].port) == ("node-a", 8000)
    assert comp["m1"].host == "unix:/run/m1.sock"
    assert all(b.runtime == "inprocess" for b in p.predictor("p").components)
    with pytest.raises(JGraphSpecError, match="not shardable") as jerr:
        jsh.shard_predictor(j, {"ens": ("h", 1)})
    with pytest.raises(GraphSpecError, match="not shardable") as perr:
        psh.shard_predictor(p, {"ens": ("h", 1)})
    assert str(perr.value) == str(jerr.value)


def test_sharded_serving_matches_collapsed(tmp_path):
    """m0 behind a TCP node engine, m1 behind a ``unix:`` socket node
    engine, the root dispatching both in host mode: the same answers as the
    collapsed engine."""
    spec = SeldonDeploymentSpec.from_json_dict(combiner_doc())

    async def run():
        collapsed = EngineService(spec, max_batch=8, max_wait_ms=0.5, device="cpu")
        e0 = EngineService(psh.node_subspec(spec, "m0"), max_batch=8, max_wait_ms=0.5,
                           device="cpu")
        e1 = EngineService(psh.node_subspec(spec, "m1"), max_batch=8, max_wait_ms=0.5,
                           device="cpu")
        s0 = await serve_fast(e0, "127.0.0.1", 0)
        uds = str(tmp_path / "m1.sock")
        s1 = await serve_fast(e1, "127.0.0.1", 0, uds_path=uds)
        root = EngineService(psh.shard_predictor(spec, {"m0": ("127.0.0.1", s0.port),
                                                        "m1": (f"unix:{uds}", 0)}),
                             max_batch=8, max_wait_ms=0.5, device="cpu")
        try:
            assert root.mode == "host" and collapsed.mode != "host"
            rng = np.random.default_rng(0)
            for rows in (1, 3):
                payload = json.dumps({"data": {"ndarray": rng.normal(size=(rows, 4)).tolist()}})
                want_text, want_status = await collapsed.predict_json(payload)
                got_text, got_status = await root.predict_json(payload)
                assert want_status == 200 and got_status == 200, got_text
                want = np.asarray(json.loads(want_text)["data"]["ndarray"])
                got = np.asarray(json.loads(got_text)["data"]["ndarray"])
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        finally:
            root.close()
            await s0.stop()
            await s1.stop()
            e0.close()
            e1.close()
            collapsed.close()

    asyncio.run(run())


def test_engine_main_node_selection(tmp_path, monkeypatch):
    """``ENGINE_GRAPH_NODE`` slices the shipped deployment down to one leaf
    (engine_main's path: load -> node_subspec -> default_and_validate), and
    the slice boots an engine that answers."""
    from seldon_core_tpu_torch.runtime.engine_main import load_deployment_from_env

    monkeypatch.delenv("ENGINE_PREDICTOR", raising=False)
    monkeypatch.delenv("ENGINE_SELDON_DEPLOYMENT", raising=False)
    spec_path = tmp_path / "dep.json"
    spec_path.write_text(json.dumps(combiner_doc()))
    full = load_deployment_from_env(str(spec_path))
    sliced = default_and_validate(psh.node_subspec(full, "m1", None))
    pred = sliced.predictors[0]
    assert sliced.name == "shard-dep-p-m1"
    assert pred.graph.name == "m1" and not pred.graph.children
    assert [b.name for b in pred.components] == ["m1"]
    engine = EngineService(sliced, max_batch=4, max_wait_ms=0.5, device="cpu")
    try:
        text, status = asyncio.run(engine.predict_json(json.dumps(
            {"data": {"ndarray": [[0.0, 0.1, 0.2, 0.3]]}})))
        assert status == 200, text
    finally:
        engine.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["flag", "env"])
def test_engine_main_serves_one_node(how, tmp_path):
    """``engine_main --node m1`` (or ``ENGINE_GRAPH_NODE=m1``) on the whole
    deployment serves leaf m1 alone: its answer is the m1 node engine's."""
    spec_path = tmp_path / "dep.json"
    spec_path.write_text(json.dumps(combiner_doc()))
    port = _free_port()
    env = dict(os.environ, ENGINE_SERVER_PORT=str(port), ENGINE_HTTP_IMPL="fast",
               ENGINE_SERVER_GRPC_PORT=str(_free_port()), SELDON_TPU_UDS="0",
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    args = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main", "--file",
            str(spec_path), "--device", "cpu"]
    if how == "flag":
        args += ["--node", "m1"]
    else:
        env["ENGINE_GRAPH_NODE"] = "m1"
    proc = subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            cwd=str(tmp_path))
    x = [[0.3, -0.2, 0.1, 0.5]]
    try:
        deadline = time.monotonic() + 90
        body = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/api/v0.1/predictions",
                    data=json.dumps({"data": {"ndarray": x}}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as resp:
                    body = json.loads(resp.read())
                break
            except OSError:
                time.sleep(0.3)
        assert body is not None, proc.stdout.read().decode() if proc.poll() is not None else ""
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    spec = SeldonDeploymentSpec.from_json_dict(combiner_doc())
    node = EngineService(psh.node_subspec(spec, "m1"), device="cpu")
    try:
        want, _ = asyncio.run(node.predict_json(json.dumps({"data": {"ndarray": x}})))
    finally:
        node.close()
    np.testing.assert_allclose(body["data"]["ndarray"], json.loads(want)["data"]["ndarray"],
                               rtol=1e-6)
