"""The port's load rig, deployment protobuf and toy engine against the JAX
package's, on the CPU:

  * testing/contract.py, api_tester.py: tests/test_contract_tester.py's eight
    cases on the port (the api tester through the port's stdlib client
    against a port engine's REST lane), and ``generate_batch`` giving the
    JAX arrays for the same seed, for every example contract;
  * testing/loadtest.py: the Python rig for about a second, raw keepalive
    and pooled, and the native rig (``native/csrc/loadgen.cpp``, built by
    ``native/_build.build("loadgen")``) against a port ``engine_main`` on the
    CPU (one subprocess for the module), with zero failures; the stock
    ``grpc.aio`` lane refused;
  * deployproto.py: tests/test_deployproto.py's four cases, the port's bytes
    parsed by the JAX ``seldon_deployment_pb2`` equal to the JAX
    ``deployment_to_proto`` for every example;
  * testing/toy_engine.py: its routes, stream and refusal of the binary
    wire, as a killable process."""

import asyncio
import glob
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from seldon_core_tpu_torch.testing.contract import (
    Contract,
    ContractError,
    generate_batch,
    validate_response,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
WAIT_S = 120


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _await_line(proc, prefix: str, timeout: float = WAIT_S) -> str:
    start = time.monotonic()
    while True:
        line = proc.stdout.readline()
        if line.startswith(prefix):
            return line
        if not line or time.monotonic() - start > timeout:
            raise AssertionError(f"no {prefix!r} line: {line + proc.stdout.read()[-1500:]}")


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# contract generation and the api tester (tests/test_contract_tester.py)
# ---------------------------------------------------------------------------


def test_generate_batch_continuous_repeat():
    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    msg = generate_batch(contract, 8, seed=0)
    arr = msg.array()
    assert arr.shape == (8, 784)
    assert arr.min() >= 0 and arr.max() <= 1
    assert len(msg.names()) == 784
    # deterministic for a fixed seed
    again = generate_batch(contract, 8, seed=0)
    np.testing.assert_array_equal(arr, again.array())


def test_generate_batch_named_columns():
    contract = Contract.from_file(str(EXAMPLES / "iris_contract.json"))
    msg = generate_batch(contract, 4, seed=1)
    assert msg.array().shape == (4, 4)
    assert msg.names() == ["sepal_length", "sepal_width", "petal_length", "petal_width"]


def test_generate_batch_categorical_and_int():
    contract = Contract.from_json(
        json.dumps(
            {
                "features": [
                    {"name": "n", "dtype": "INT", "ftype": "continuous",
                     "range": [0, 9]},
                    {"name": "color", "ftype": "categorical",
                     "values": ["red", "green"]},
                ]
            }
        )
    )
    msg = generate_batch(contract, 16, seed=2)
    arr = msg.array()
    assert arr.shape == (16, 2)
    assert msg.data.kind == "ndarray"  # mixed types -> ndarray wire form
    ints = arr[:, 0].astype(float)
    assert np.all(ints == np.floor(ints))
    assert set(arr[:, 1]) <= {"red", "green"}


def test_contract_errors():
    with pytest.raises(ContractError):
        Contract.from_json("{}")
    with pytest.raises(ContractError):
        Contract.from_json("not json")
    with pytest.raises(ContractError):
        generate_batch(
            Contract(features=[{"name": "x", "ftype": "categorical"}]), 1
        )
    with pytest.raises(ContractError):
        generate_batch(Contract(features=[{"ftype": "continuous"}]), 1)


def test_validate_response():
    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    good = SeldonMessage.from_array(np.full((2, 10), 0.1))
    assert validate_response(contract, good) == []
    wrong_width = SeldonMessage.from_array(np.full((2, 3), 0.1))
    assert any("width" in p for p in validate_response(contract, wrong_width))
    out_of_range = SeldonMessage.from_array(np.full((2, 10), 7.0))
    assert any("above range" in p for p in validate_response(contract, out_of_range))
    failure = SeldonMessage.failure("boom")
    assert validate_response(contract, failure) == ["FAILURE status: boom"]


def test_api_tester_against_live_engine():
    """Full api-tester flow against a port engine serving the MNIST example
    on its REST lane, through the port's stdlib client."""
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.runtime.rest import serve_fast
    from seldon_core_tpu_torch.testing.api_tester import run_test

    async def run():
        spec = SeldonDeploymentSpec.from_json((EXAMPLES / "mnist_deployment.json").read_text())
        engine = EngineService(spec, device="cpu")
        server = await serve_fast(engine, "127.0.0.1", 0)
        try:
            contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
            result = await run_test(contract, "127.0.0.1", server.port, n=4, seed=0)
            assert result["ok"], result
            assert result["rows"] == 4
            # feedback endpoint returns cleanly too
            result_fb = await run_test(contract, "127.0.0.1", server.port,
                                       endpoint="send-feedback", n=2)
            assert result_fb["ok"], result_fb
        finally:
            await server.stop()
            engine.close()

    asyncio.run(run())


def test_example_deployments_parse_and_validate():
    """Every shipped example spec passes defaulting + validation."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

    for f in EXAMPLES.glob("*_deployment.json"):
        spec = SeldonDeploymentSpec.from_json(f.read_text())
        default_and_validate(spec)
        assert spec.predictors, f.name


def test_every_example_contract_conforms():
    """Contract fuzz -> predict -> validate for every contract that has a
    matching example deployment (the reference's api-tester loop,
    util/api_tester/api-tester.py:24-120)."""
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService

    pairs = []
    for cpath in sorted(EXAMPLES.glob("*_contract.json")):
        dpath = EXAMPLES / cpath.name.replace("_contract", "_deployment")
        if dpath.exists():
            pairs.append((cpath, dpath))
    assert len(pairs) >= 4, [p[0].name for p in pairs]
    for cpath, dpath in pairs:
        contract = Contract.from_file(str(cpath))
        spec = SeldonDeploymentSpec.from_json(dpath.read_text())
        engine = EngineService(spec, device="cpu")
        msg = generate_batch(contract, 4, seed=0)
        resp = asyncio.run(engine.predict(msg))
        errs = validate_response(contract, resp)
        assert not errs, (cpath.name, errs)
        assert np.asarray(resp.data.array).shape[0] == 4
        engine.close()


CONTRACTS = sorted(p.name for p in EXAMPLES.glob("*_contract.json"))


@pytest.mark.parametrize("name", CONTRACTS)
def test_generate_batch_equals_the_jax_arrays(name):
    """The same numpy draws: for the same seed the port's batch is the JAX
    batch, its names and wire kind too."""
    from seldon_core_tpu.testing import contract as jcontract

    path = str(EXAMPLES / name)
    for seed, n in ((0, 1), (3, 8)):
        got = generate_batch(Contract.from_file(path), n, seed=seed)
        want = jcontract.generate_batch(jcontract.Contract.from_file(path), n, seed=seed)
        assert got.data.kind == want.data.kind
        assert got.names() == want.names()
        np.testing.assert_array_equal(np.asarray(got.array()), np.asarray(want.array()))
        assert validate_response(Contract.from_file(path), got) == \
            jcontract.validate_response(jcontract.Contract.from_file(path), want)


def test_generate_batch_mixed_columns_equal_the_jax_arrays():
    from seldon_core_tpu.testing import contract as jcontract

    doc = json.dumps({"features": [
        {"name": "n", "dtype": "INT", "ftype": "continuous", "range": [0, 9]},
        {"name": "t", "ftype": "continuous", "range": ["inf", 2]},
        {"name": "u", "ftype": "continuous", "range": [1, "inf"], "shape": [2, 2]},
        {"name": "color", "ftype": "categorical", "values": ["red", "green", "blue"],
         "repeat": 2}]})
    got = generate_batch(Contract.from_json(doc), 16, seed=2)
    want = jcontract.generate_batch(jcontract.Contract.from_json(doc), 16, seed=2)
    assert got.names() == want.names() and got.data.kind == want.data.kind == "ndarray"
    assert np.asarray(got.array()).tolist() == np.asarray(want.array()).tolist()


# ---------------------------------------------------------------------------
# the load rig against a port engine_main on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_main():
    """examples/mnist_deployment.json on a port ``engine_main`` subprocess
    (the Python REST lane, the CPU)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main", "--file",
         str(EXAMPLES / "mnist_deployment.json"), "--device", "cpu", "--host", "127.0.0.1",
         "--rest-port", str(port)], cwd=str(ROOT),
        env={**os.environ, "ENGINE_HTTP_IMPL": "fast", "OMP_NUM_THREADS": "1",
             "ENGINE_SERVER_GRPC_PORT": str(_free_port())},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _await_line(proc, "engine up:")
        yield port
    finally:
        _stop(proc)


@pytest.mark.parametrize("fast", [True, False], ids=["raw-keepalive", "pooled-client"])
def test_python_rig_against_a_port_engine_main(engine_main, fast):
    from seldon_core_tpu_torch.testing.loadtest import run_load

    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    report = asyncio.run(run_load(contract, "127.0.0.1", engine_main, clients=4,
                                  duration_s=1.0, fast=fast))
    assert report["failures"] == 0, report
    assert report["requests"] > 0 and report["qps"] > 0
    assert {"p50_ms", "p99_ms"} <= set(report)


def test_native_rig_against_a_port_engine_main(engine_main):
    """``--native`` builds this package's ``loadgen.cpp`` into
    ``build/native/`` and drives the engine with it."""
    from seldon_core_tpu_torch.native import _build
    from seldon_core_tpu_torch.testing.loadtest import loadgen_binary, run_load_native

    exe = loadgen_binary()
    assert exe.startswith(str(_build.BUILD_DIR)) and os.access(exe, os.X_OK)
    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    report = asyncio.run(run_load_native(contract, "127.0.0.1", engine_main, clients=4,
                                         duration_s=1.0, warmup_s=0.2))
    assert report["failures"] == 0, report
    assert report["requests"] > 0


def test_native_rig_raises_when_the_build_fails(monkeypatch):
    from seldon_core_tpu_torch.native import _build
    from seldon_core_tpu_torch.testing import loadtest

    def broken(name):
        raise RuntimeError(f"g++ failed building {name}")

    monkeypatch.setattr(_build, "build", broken)
    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        asyncio.run(loadtest.run_load_native(contract, "127.0.0.1", 9, duration_s=0.1))


def test_stock_grpc_lane_is_refused(capsys):
    from seldon_core_tpu_torch.testing import loadtest

    contract = Contract.from_file(str(EXAMPLES / "mnist_contract.json"))
    with pytest.raises(ValueError, match="grpc.aio"):
        asyncio.run(loadtest.run_load(contract, "127.0.0.1", 9, api="grpc", duration_s=0.1))
    with pytest.raises(SystemExit):
        loadtest.main([str(EXAMPLES / "mnist_contract.json"), "127.0.0.1", "9", "--api", "grpc"])
    assert "grpc.aio" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# deployment protobuf (tests/test_deployproto.py)
# ---------------------------------------------------------------------------


SPEC_JSON = {
    "apiVersion": "machinelearning.seldon.io/v1alpha2",
    "kind": "SeldonDeployment",
    "metadata": {"name": "mnist-canary", "labels": {"team": "serving"}},
    "spec": {
        "name": "mnist-canary",
        "oauth_key": "key1",
        "oauth_secret": "sec1",
        "annotations": {"project_name": "demo"},
        "predictors": [
            {
                "name": "main",
                "replicas": 3,
                "labels": {"version": "v1"},
                "graph": {
                    "name": "ab",
                    "type": "ROUTER",
                    "implementation": "RANDOM_ABTEST",
                    "parameters": [
                        {"name": "ratioA", "value": "0.8", "type": "FLOAT"}
                    ],
                    "children": [
                        {"name": "a", "type": "MODEL",
                         "endpoint": {"service_host": "h1",
                                      "service_port": 9000, "type": "GRPC"}},
                        {"name": "b", "type": "MODEL",
                         "methods": ["TRANSFORM_INPUT"]},
                    ],
                },
                "components": [
                    {"name": "a", "runtime": "inprocess",
                     "class_path": "MnistClassifier",
                     "mesh_axes": {"tp": 2, "sp": 2},
                     "parameters": [{"name": "hidden", "value": "64",
                                     "type": "INT"}]},
                    {"name": "b", "runtime": "grpc", "image": "img:1",
                     "host": "b-host", "port": 9001,
                     "env": {"FOO": "bar"}},
                ],
            }
        ],
    },
}




def test_roundtrip_spec_proto_spec():
    from seldon_core_tpu_torch.deployproto import deployment_from_proto, deployment_to_proto
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

    spec = SeldonDeploymentSpec.from_json_dict(SPEC_JSON)
    back = deployment_from_proto(deployment_to_proto(spec))
    assert back.to_json_dict() == spec.to_json_dict()


def test_proto_wire_roundtrip():
    """The port's bytes parse with the JAX generated message, equal the JAX
    ``deployment_to_proto``; the JAX bytes read back through the port."""
    from seldon_core_tpu.deployproto import deployment_to_proto as jax_to_proto
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
    from seldon_core_tpu.proto_gen import seldon_deployment_pb2 as pb
    from seldon_core_tpu_torch.deployproto import deployment_from_proto, deployment_to_proto
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

    wire = deployment_to_proto(SeldonDeploymentSpec.from_json_dict(SPEC_JSON))
    assert pb.SeldonDeployment.FromString(wire) == jax_to_proto(JSpec.from_json_dict(SPEC_JSON))
    back = deployment_from_proto(jax_to_proto(JSpec.from_json_dict(SPEC_JSON)).SerializeToString())
    assert back.predictor("main").graph.find("a").endpoint.service_port == 9000
    assert back.predictor("main").component_map()["a"].mesh_axes == {"tp": 2, "sp": 2}
    assert back.oauth_key == "key1"
    # typed parameter survives with its type tag
    ps = back.predictor("main").graph.parameters
    assert ps[0].typed_value() == 0.8


def test_enum_name_parity_with_spec_enums():
    """Every spec enum value is in the proto at the port's number (schema
    drift guard, against the JAX generated enums)."""
    from seldon_core_tpu.proto_gen import seldon_deployment_pb2 as pb
    from seldon_core_tpu_torch import deployproto as dp
    from seldon_core_tpu_torch.graph.spec import UnitImplementation, UnitMethod, UnitType

    for names, enum, spec_enum in (
            (dp._UNIT_TYPES, pb.PredictiveUnit.PredictiveUnitType, UnitType),
            (dp._IMPLEMENTATIONS, pb.PredictiveUnit.PredictiveUnitImplementation,
             UnitImplementation),
            (dp._METHODS, pb.PredictiveUnit.PredictiveUnitMethod, UnitMethod)):
        for v in spec_enum:
            assert names.index(v.value) == enum.Value(v.value)
    for names, enum in ((dp._ENDPOINT_TYPES, pb.Endpoint.EndpointType),
                        (dp._PARM_TYPES, pb.Parameter.ParmType)):
        assert [enum.Value(n) for n in names] == list(range(len(names)))
    assert [pb.ComponentBinding.Runtime.Value(n.upper()) for n in dp._RUNTIMES] == [0, 1, 2]


@pytest.mark.parametrize("example", sorted(os.path.basename(p) for p in glob.glob(
    str(EXAMPLES / "*_deployment.json"))))
def test_every_example_is_the_jax_message(example):
    """Every example's bytes, parsed by the JAX generated message, equal the
    JAX ``deployment_to_proto``; its JSON survives the port's round trip."""
    from seldon_core_tpu.deployproto import deployment_to_proto as jax_to_proto
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
    from seldon_core_tpu.proto_gen import seldon_deployment_pb2 as pb
    from seldon_core_tpu_torch.deployproto import deployment_from_proto, deployment_to_proto
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

    doc = json.loads((EXAMPLES / example).read_text())
    spec = SeldonDeploymentSpec.from_json_dict(doc)
    wire = deployment_to_proto(spec)
    assert pb.SeldonDeployment.FromString(wire) == jax_to_proto(JSpec.from_json_dict(doc))
    assert deployment_from_proto(wire).to_json_dict() == spec.to_json_dict()


# ---------------------------------------------------------------------------
# the toy engine
# ---------------------------------------------------------------------------


def test_toy_engine_serves_the_drill_surface(tmp_path):
    """The port's toy engine as a process: the unary echo, a refusal of the
    binary wire (415), the arithmetic SSE run, ``/stats``'s boot id, and its
    lease in the port's sqlite store."""
    import http.client

    from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

    port = _free_port()
    db = str(tmp_path / "gw.db")
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.testing.toy_engine", "--port", str(port),
         "--token-sleep-s", "0.001"], cwd=str(ROOT),
        env={**os.environ, "ENGINE_ADVERTISE_URL": url, "GATEWAY_STATE_PATH": db,
             "SELDON_TPU_LEASE_TTL_S": "1.0"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        boot = _await_line(proc, "toy-engine listening").split("boot=")[1].strip()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/api/v0.1/predictions", body=b'{"data": {"ndarray": [[1]]}}',
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["data"]["ndarray"] == [[0.5]]
        conn.request("POST", "/api/v0.1/predictions", body=b"\0",
                     headers={"Content-Type": "application/x-seldon-tensor"})
        r = conn.getresponse()
        assert r.status == 415 and r.read() == b"json only"
        conn.request("POST", "/api/v0.1/generate/stream",
                     body=json.dumps({"data": {"ndarray": [[3, 7]]}, "max_new": 3}).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
        events = [json.loads(e[6:]) for e in r.read().split(b"\n\n") if e.startswith(b"data: ")]
        assert events == [{"tokens": [[8.0]]}, {"tokens": [[9.0]]}, {"tokens": [[10.0]]},
                          {"done": True}]
        conn.request("GET", "/stats")
        r = conn.getresponse()
        assert json.loads(r.read()) == {"boot_id": boot, "toy": True}
        store = SqliteDeploymentStore(db)
        deadline = time.monotonic() + 10
        while url not in store.engine_leases() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.engine_leases()[url][0] == boot
        store.close()
    finally:
        _stop(proc)
