"""The port stands alone: no module of seldon_core_tpu_torch, and not
chip_smoke.py or the turns scripts (paged_decode_turns.py, mlp_turns.py,
paged_f32_turns.py, int8_decode_turns.py, kv_write_turns.py), imports JAX or anything of
the JAX package, nor aiohttp, grpc, google.protobuf, ml_dtypes or
prometheus_client (its lanes are stdlib: the HTTP client and servers,
HTTP/2 and HPACK, the protobuf codec, bf16 by bit pattern, the
Prometheus text and OpenMetrics writer), and the port
serves the MNIST and generator examples (MNIST also over the binary
tensor wire and over gRPC) (the generator through the
continuous lane, runtime/genserver.py, greedy and sampled), the iris
example (its rows from the bundled csv) and the epsilon-greedy router
example with a feedback, one host-mode request through a REST node served
by the port's unit microservice, streams the generator's tokens, takes a
training step, round-trips a checkpoint, and over its REST lane scrapes
``/prometheus``, reads a request's ``/trace`` and, after a request sent
with a ``Seldon-Tenant`` header, ``/quality``, ``/costs``,
``/postmortems``, ``/autopilot`` and ``/corpus``, answers one request
the autopilot predicts past its deadline with a 503 shed, and serves one
request through the native data plane, hands a generation from a prefill
engine to a decode engine over the unix relay (the unified engine's
tokens), and serves an MoE generator, with all of them blocked.  The
port's native sources are its own: nothing of it names or builds the JAX
package's ``native/`` directory."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "seldon_core_tpu")
# the port's lanes need none of these (its REST and gRPC clients and
# servers, its protobuf codec and its bf16 frames are stdlib and numpy)
SERVING_BLOCKED = ("aiohttp", "grpc", "google", "ml_dtypes", "prometheus_client")


def _blocked(name: str) -> bool:
    # exact names or dotted children: "seldon_core_tpu_torch" is allowed
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def _port_files():
    files = sorted((ROOT / "seldon_core_tpu_torch").rglob("*.py"))
    assert len(files) >= 18
    # the training, decode-lane and continuous-lane slices' modules are
    # scanned with the rest
    names = {str(f.relative_to(ROOT / "seldon_core_tpu_torch")) for f in files}
    assert {"optim.py", "tree.py", "runtime/persistence.py",
            "ops/flash_attention.py", "models/transformer.py",
            "ops/flash_decode.py", "ops/kv_write.py", "runtime/genserver.py",
            "models/speculative.py", "models/prng.py", "models/tabular.py",
            "models/iris.py", "models/outlier.py", "models/mab.py",
            "graph/fuse.py", "runtime/client.py", "runtime/resilience.py",
            "runtime/microservice.py", "native/protowire.py", "native/hpackcodec.py",
            "runtime/wire.py", "protoconv.py", "runtime/grpcfast.py",
            "runtime/udsrelay.py", "utils/telemetry.py", "utils/promtext.py",
            "utils/metrics.py", "utils/tracing.py", "utils/perf.py", "utils/hotrecord.py",
            "utils/genperf.py", "utils/chips.py", "utils/quality.py", "utils/postmortem.py",
            "utils/costledger.py", "runtime/qos.py", "runtime/autopilot.py",
            "runtime/brownout.py", "utils/perfcorpus.py", "native/fastcodec.py",
            "native/_build.py", "runtime/nativeplane.py", "parallel/moe.py",
            "runtime/kvstream.py", "runtime/servingmesh.py", "parallel/mesh.py",
            "parallel/ensemble.py", "graph/sharding.py", "parallel/ring_attention.py",
            "parallel/pipeline.py", "parallel/multihost.py", "testing/faults.py"} <= names
    return files + [ROOT / name for name in ("chip_smoke.py", "paged_decode_turns.py",
                                             "mlp_turns.py", "paged_f32_turns.py",
                                             "int8_decode_turns.py", "kv_write_turns.py",
                                             "multihost_turns.py")]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_blocker_names():
    assert {"aiohttp", "grpc", "google", "ml_dtypes", "prometheus_client"} <= set(
        SERVING_BLOCKED)
    assert _blocked("jax") and _blocked("jax.numpy")
    assert _blocked("seldon_core_tpu") and _blocked("seldon_core_tpu.graph.spec")
    assert not _blocked("seldon_core_tpu_torch") and not _blocked("jaxlib_free")


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(ROOT)}:{line} {name}"
                for line, name in _imports(tree)
                if _blocked(name) or name.split(".")[0] in SERVING_BLOCKED]
    assert bad == []


def _docstrings(tree):
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def _path_parts(node):
    """The string constants of a path expression: ``a / "b" / "c"`` or
    ``os.path.join(a, "b", "c")``."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        return _path_parts(node.left) + _path_parts(node.right)
    if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "join"
            and getattr(getattr(node.func, "value", None), "attr", "") == "path"):
        return [p for a in node.args for p in _path_parts(a)]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    return []


def test_no_port_source_or_build_path_names_the_jax_package_s_native_sources():
    """The codec and the plane build from ``seldon_core_tpu_torch/native/
    csrc`` into ``build/native`` only: no path the port or the smoke makes
    names the root ``native/`` directory or ``seldon_core_tpu/native``,
    and the C++ sources include nothing outside their own directory."""
    from seldon_core_tpu_torch.native import _build

    csrc = ROOT / "seldon_core_tpu_torch" / "native" / "csrc"
    assert _build.CSRC == csrc and _build.BUILD_DIR == ROOT / "build" / "native"
    for name in ("fastcodec", "fastcodec_pymod", "dataplane"):
        srcs, args, _ = _build._recipe(name)
        assert srcs and all(p.parent == csrc for p in srcs), name
        assert all(not a.endswith(".cpp") or Path(a).parent == csrc for a in args), name
    named = re.compile(r"(^|[^\w])(native/[\w.]+\.(cpp|so)|seldon_core_tpu/native)")
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and named.search(node.value)):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {node.value!r}")
            parts = _path_parts(node) if isinstance(node, (ast.BinOp, ast.Call)) else []
            if "native" in parts and parts[parts.index("native") - 1:][:1] != ["build"]:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} path {parts}")
    for src in sorted(csrc.glob("*.cpp")):
        for line in src.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
            if m and not (csrc / m.group(1)).exists():
                bad.append(f"{src.name}: {line.strip()}")
    assert bad == []


_SERVE_WITH_JAX_BLOCKED = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".")
               for b in ("jax", "seldon_core_tpu", "aiohttp", "grpc", "google.protobuf",
                         "ml_dtypes", "prometheus_client")):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import asyncio
import torch
torch.set_num_threads(1)
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.runtime.engine_main import load_deployment_from_env

engine = EngineService(load_deployment_from_env("examples/mnist_deployment.json"), device="cpu")
text, status = asyncio.run(engine.predict_json(json.dumps({"data": {"ndarray": [[0.5] * 784]}})))
import numpy as np
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime import wire
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel, serve_grpc_fast
wire_status, parts = asyncio.run(engine.predict_wire(wire.join_parts(wire.encode_frame(
    np.full((1, 784), 0.5)))))
wire_rows = wire.decode_frame(wire.join_parts(parts)).values()

async def grpc_call():
    server = await serve_grpc_fast(engine, "127.0.0.1", 0)
    ch = await FastGrpcChannel().connect("127.0.0.1", server.port)
    try:
        return protoconv.msg_from_proto(await ch.call(
            b"/seldon.protos.Seldon/Predict",
            protoconv.msg_to_proto(SeldonMessage.from_array(np.full((1, 784), 0.5)))))
    finally:
        await ch.close()
        await server.stop()

grpc_msg = asyncio.run(grpc_call())
json_rows = json.loads(text)["data"]["ndarray"]
lanes = [wire_status, grpc_msg.status.code, bool((wire_rows == json_rows).all()),
         bool((grpc_msg.array() == json_rows).all())]
engine.close()
gen = EngineService(load_deployment_from_env("examples/generator_deployment.json"), device="cpu")
gen_text, gen_status = asyncio.run(gen.predict_json(
    json.dumps({"data": {"ndarray": [list(range(128))]}})))
gen_rows = json.loads(gen_text)["data"]["ndarray"]

async def stream():
    return [json.loads(e) async for e in gen.generate_stream(gen.prepare_stream_request(
        json.dumps({"data": {"ndarray": [list(range(128))]}, "chunk": 5})))]

events = asyncio.run(stream())
gen_stats = gen.stats()
lane = [gen_stats["batcher"]["mode"], gen_stats["genserver"]["admitted_total"]]
gen.close()
doc = json.load(open("examples/generator_deployment.json"))
doc["spec"]["predictors"][0]["components"][0]["parameters"] += [
    {"name": "temperature", "value": "0.8", "type": "FLOAT"},
    {"name": "top_k", "value": "20", "type": "INT"}]
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
sampler = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                        device="cpu")
sampled_text, sampled_status = asyncio.run(sampler.predict_json(
    json.dumps({"data": {"ndarray": [list(range(5))]}})))
sampled = [sampled_status, len(json.loads(sampled_text)["data"]["ndarray"][0]),
           sampler.genserver.snapshot()["admitted_total"]]
sampler.close()
streamed = [t for e in events[:-1] for t in e["tokens"][0]]
import os, tempfile
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.optim import adam
cfg = T.LMConfig(vocab=32, d_model=32, n_heads=2, n_layers=1, d_ff=64)
params = T.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
opt = adam(1e-3)
params, _, loss = T.lm_train_step(params, opt.init(params),
                                  {"tokens": torch.randint(0, 32, (2, 129))}, opt, cfg)
path = T.save_lm_weights(params, os.path.join(tempfile.mkdtemp(), "w.npz"))
back = T.load_lm_weights(T.lm_init(torch.Generator().manual_seed(1), cfg, "cpu"), path)
trained = bool(torch.isfinite(loss)) and all(
    torch.equal(back[k], params[k]) for k in ("embed", "ln_f"))
iris = EngineService(load_deployment_from_env("examples/iris_deployment.json"), device="cpu")
iris_text, iris_status = asyncio.run(iris.predict_json(
    json.dumps({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}})))
iris.close()
eg = EngineService(load_deployment_from_env("examples/epsilon_greedy_deployment.json"),
                   device="cpu")
eg_text, eg_status = asyncio.run(eg.predict_json(json.dumps({"data": {"ndarray": [[0.5] * 784]}})))
from seldon_core_tpu_torch.messages import Feedback
ack = asyncio.run(eg.send_feedback(Feedback.from_json(json.dumps(
    {"request": {"data": {"ndarray": [[0.5] * 784]}}, "response": json.loads(eg_text),
     "reward": 1.0}))))
eg_tries = eg.states()["eg-router"]["tries"].tolist()
eg.close()
new_examples = [iris_status, json.loads(iris_text)["data"]["names"], eg_status,
                ack.status is None, sum(eg_tries)]
from seldon_core_tpu_torch.graph.spec import Parameter
from seldon_core_tpu_torch.runtime.microservice import build_runtime
from seldon_core_tpu_torch.runtime.rest import serve_unit

async def host_mode():
    unit = build_runtime("MnistClassifier", parameters=[Parameter.from_json_dict(
        {"name": "hidden", "value": "32", "type": "INT"})], unit_name="m", device="cpu")
    server = await serve_unit(unit, "127.0.0.1", 0)
    doc = {"spec": {"name": "h", "predictors": [{"name": "p", "graph": {
        "name": "m", "type": "MODEL"}, "components": [{"name": "m", "runtime": "rest",
                                                       "host": "127.0.0.1",
                                                       "port": server.port}]}]}}
    host = EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")
    try:
        text, status = await host.predict_json(json.dumps({"data": {"ndarray": [[0.5] * 784]}}))
    finally:
        host.close()
        await server.stop()
    return [host.mode, status, len(json.loads(text)["data"]["ndarray"][0])]

remote = asyncio.run(host_mode())
import urllib.error
import urllib.request
from seldon_core_tpu_torch.runtime.rest import serve_fast
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch.utils.tracing import TRACER

async def observed():
    TRACER.enable()
    mnist = EngineService(load_deployment_from_env("examples/mnist_deployment.json"),
                          device="cpu")
    server = await serve_fast(mnist, "127.0.0.1", 0)
    loop = asyncio.get_running_loop()

    def get(path, body=None, headers=None):
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}", data=body, headers=headers or {}),
                timeout=60) as r:
            return r.status, r.read().decode()

    try:
        await loop.run_in_executor(None, get, "/api/v0.1/predictions", json.dumps(
            {"meta": {"puid": "iso"}, "data": {"ndarray": [[0.5] * 784]}}).encode(),
            {"Seldon-Tenant": "iso-t"})
        prom_status, prom = await loop.run_in_executor(None, get, "/prometheus")
        trace_status, trace = await loop.run_in_executor(None, get, "/trace?puid=iso")
        quality_status, quality = await loop.run_in_executor(None, get, "/quality")
        costs_status, costs = await loop.run_in_executor(None, get, "/costs")
        pm_status, pm = await loop.run_in_executor(None, get, "/postmortems")
        ap_status, ap = await loop.run_in_executor(None, get, "/autopilot")
        corpus_status, corpus = await loop.run_in_executor(None, get, "/corpus")
        # one shed: a dispatch predicted far past the request's deadline
        mnist.batcher.predict_s_fn = lambda padded, x: 10.0
        try:
            await loop.run_in_executor(None, get, "/api/v0.1/predictions", json.dumps(
                {"data": {"ndarray": [[0.5] * 784]}}).encode(), {"Seldon-Deadline-Ms": "1000"})
            shed = None
        except urllib.error.HTTPError as e:
            shed = [e.code, json.loads(e.read())["status"]["info"].split(":")[0]]
    finally:
        await server.stop()
        mnist.close()
    families = {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE ")}
    want = {n[:-6] + "_total" if n.endswith("_total") else n
            for n in MetricsRegistry.family_names()}
    tenants = {r["tenant"] for r in json.loads(costs)["tenants"]}
    return [prom_status, want <= families, trace_status,
            sorted({s["name"] for s in json.loads(trace)["spans"]}),
            quality_status, [n["node"] for n in json.loads(quality)["nodes"]],
            costs_status, "iso-t" in tenants, pm_status, "counters" in json.loads(pm),
            ap_status, "predict[1x784/float32]" in {r["key"] for r in json.loads(ap)["keys"]},
            corpus_status,
            json.loads(corpus)["enabled"], shed]

obs = asyncio.run(observed())
from seldon_core_tpu_torch.runtime.nativeplane import serve_native

async def native_plane():
    mnist = EngineService(load_deployment_from_env("examples/mnist_deployment.json"),
                          device="cpu")
    plane = await serve_native(mnist, "127.0.0.1", 0)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", plane.port)
        body = json.dumps({"data": {"ndarray": [[0.5] * 784]}}).encode()
        writer.write(b"POST /api/v0.1/predictions HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
                     % len(body) + body)
        head = await reader.readuntil(b"\r\n\r\n")
        n = int(head.lower().split(b"content-length:")[1].split(b"\r\n")[0])
        doc = json.loads(await reader.readexactly(n))
        writer.close()
        return [int(head.split()[1]), doc["data"]["ndarray"] == json_rows,
                mnist.stats()["engine"]["http_impl"], int(plane.stats()[0])]
    finally:
        await plane.stop()
        mnist.close()

native = asyncio.run(native_plane())
import threading
from seldon_core_tpu_torch.runtime.udsrelay import serve_uds
gdoc = json.load(open("examples/generator_deployment.json"))
gdoc["spec"]["predictors"][0]["components"][0]["parameters"] = [
    {"name": k, "value": v, "type": t} for k, v, t in (
        ("vocab", "64", "INT"), ("d_model", "32", "INT"), ("n_heads", "2", "INT"),
        ("n_layers", "2", "INT"), ("d_ff", "64", "INT"), ("max_new_tokens", "8", "INT"),
        ("dtype", "float32", "STRING"))]
gspec = lambda: default_and_validate(SeldonDeploymentSpec.from_json_dict(gdoc))
decode = EngineService(gspec(), device="cpu", gen_role="decode")
relay_loop = asyncio.new_event_loop()
threading.Thread(target=relay_loop.run_forever, daemon=True).start()
sock = os.path.join(tempfile.mkdtemp(), "d.sock")
relay = asyncio.run_coroutine_threadsafe(serve_uds(decode, sock), relay_loop).result(10)
prefill = EngineService(gspec(), device="cpu", gen_role="prefill", decode_peers=[f"uds:{sock}"])
unified = EngineService(gspec(), device="cpu")
body = json.dumps({"data": {"ndarray": [list(range(1, 20))]}})
(h_text, h_status), (u_text, _) = [asyncio.run(e.predict_json(body)) for e in (prefill, unified)]
handoff = [h_status, json.loads(h_text)["data"] == json.loads(u_text)["data"],
           decode.stats()["genserver"]["imports"]["committed_total"]]
asyncio.run_coroutine_threadsafe(relay.stop(), relay_loop).result(10)
for e in (decode, prefill, unified):
    e.close()
gdoc["spec"]["predictors"][0]["components"][0]["parameters"] += [
    {"name": "moe_every", "value": "1", "type": "INT"},
    {"name": "n_experts", "value": "4", "type": "INT"}]
moe_engine = EngineService(gspec(), device="cpu")
m_text, m_status = asyncio.run(moe_engine.predict_json(json.dumps(
    {"data": {"ndarray": [[1, 2, 3], [4, 5, 6]]}})))
moe = [m_status, len(json.loads(m_text)["data"]["ndarray"]), moe_engine.genserver is None]
moe_engine.close()
from seldon_core_tpu_torch.parallel import mesh as pmesh, multihost
from seldon_core_tpu_torch.testing import faults
os.environ.pop(multihost.ENV_COORDINATOR, None)
pmesh.set_cpu_device_count(2)
gmesh = multihost.global_mesh({"tp": 2}, platform="cpu")
mh = [multihost.initialize(), multihost.process_info("cpu")["global_device_count"],
      gmesh.shape, gmesh.spans_processes, faults.FaultSpec(error_rate=0.5).total_failure_rate]
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "seldon_core_tpu", "aiohttp", "grpc",
                                       "ml_dtypes", "prometheus_client")
                or m.startswith("google.protobuf"))
print(json.dumps({"status": status, "shape": len(json.loads(text)["data"]["ndarray"][0]),
                  "gen_status": gen_status, "gen_shape": [len(gen_rows), len(gen_rows[0])],
                  "lane": lane, "sampled": sampled,
                  "streamed": streamed == gen_rows[0] and events[-1]["done"],
                  "trained": trained, "new_examples": new_examples, "remote": remote,
                  "lanes": lanes, "obs": obs, "native": native, "handoff": handoff,
                  "moe": moe, "multihost": mh, "leaked": leaked}))
"""


def test_port_serves_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _SERVE_WITH_JAX_BLOCKED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == (
        '{"status": 200, "shape": 10, "gen_status": 200, "gen_shape": [1, 16], '
        '"lane": ["genserver", 2], "sampled": [200, 16, 1], "streamed": true, "trained": true, '
        '"new_examples": [200, ["setosa", "versicolor", "virginica"], 200, true, 1.0], '
        '"remote": ["host", 200, 10], "lanes": [200, 200, true, true], '
        '"obs": [200, true, 200, ["batch_queue", "dispatch", "request"], 200, ["iris", "m", "mnist"], '
        '200, true, 200, true, 200, true, 200, false, '
        '[503, "autopilot load shed"]], "native": [200, true, "native", 1], '
        '"handoff": [200, true, 1], "moe": [200, 2, true], '
        '"multihost": [false, 2, {"tp": 2}, false, 0.5], "leaked": []}')
