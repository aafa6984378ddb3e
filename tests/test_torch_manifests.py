"""The port's manifest renderer and packager (``seldon_core_tpu_torch/
operator/``) against the JAX package's: for every example deployment, the
reference test's mixed spec and the shard-graph specs, the port renders the
reference's documents in its order, equal once the accelerator's resource
name and node selector and the default images are mapped (a GPU request
of as many cards as the reference asks chips); its stream parses back; the
packager writes the reference's files with the port's module and base
image, and its ``run.sh`` boots the port's microservice."""

import base64
import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest
import yaml

from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
from seldon_core_tpu.operator import manifests as jman
from seldon_core_tpu.operator.packaging import ImageSpec as JImageSpec
from seldon_core_tpu.operator.packaging import package_model as jpackage
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec as PSpec
from seldon_core_tpu_torch.operator import manifests as pman
from seldon_core_tpu_torch.operator.packaging import ImageSpec, package_model
from tests.test_graph_sharding import combiner_spec
from tests.test_manifests import _mixed_spec

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*_deployment.json"))

#: the reference's names -> the port's: the only differences allowed
IMAGES = {jman.ENGINE_IMAGE: pman.ENGINE_IMAGE,
          "seldon-core-tpu/microservice:latest": pman.MICROSERVICE_IMAGE}


def _mapped(doc):
    """A reference document with the accelerator's resource name, its node
    selector and the default images mapped to the port's."""
    doc = copy.deepcopy(doc)

    def walk(node):
        if isinstance(node, dict):
            for key in list(node):
                if key == "google.com/tpu":
                    node[pman.GPU_RESOURCE] = node.pop(key)
                elif key == "nodeSelector":
                    assert set(node[key]) == {"cloud.google.com/gke-tpu-topology"}
                    node[key] = dict(pman.GPU_SELECTOR)
                elif key == "image" and node[key] in IMAGES:
                    node[key] = IMAGES[node[key]]
                else:
                    walk(node[key])
        elif isinstance(node, list):
            for item in node:
                walk(item)

    walk(doc)
    return doc


def _both(doc):
    return JSpec.from_json_dict(copy.deepcopy(doc)), PSpec.from_json_dict(copy.deepcopy(doc))


def _specs():
    cases = [(p.name, json.loads(p.read_text())) for p in EXAMPLES]
    cases.append(("mixed", _mixed_spec().to_json_dict()))
    cases += [(f"shard_graph_{n}", combiner_spec(annotate=True, n_members=n).to_json_dict())
              for n in (1, 2, 3)]
    return cases


CASES = _specs()


def test_every_example_is_a_case():
    assert len(EXAMPLES) == 15
    assert len(CASES) == 19


@pytest.mark.parametrize("name,doc", CASES, ids=[c[0] for c in CASES])
def test_documents_are_the_references_with_the_card_mapped(name, doc):
    """Documents equal the reference's one for one, in ``createResources``
    order, after ``_mapped``; an accelerator binding's engine asks
    ``nvidia.com/gpu`` in its requests and limits and selects the H100
    pool.  The shard-graph cases render node engines from the port's
    ``graph/sharding.py``."""
    jspec, pspec = _both(doc)
    want = [_mapped(m) for m in jman.generate_manifests(jspec)]
    got = pman.generate_manifests(pspec)
    assert [(m["kind"], m["metadata"]["name"]) for m in got] == \
        [(m["kind"], m["metadata"]["name"]) for m in want]
    for g, w in zip(got, want):
        assert g == w, g["metadata"]["name"]
    for m in got:
        if m["kind"] != "Deployment" or m["metadata"]["labels"].get("seldon-type") != "engine":
            continue
        res = m["spec"]["template"]["spec"]["containers"][0]["resources"]
        if pman.GPU_RESOURCE in res.get("limits", {}):
            assert res["requests"][pman.GPU_RESOURCE] == res["limits"][pman.GPU_RESOURCE]
            assert m["spec"]["template"]["spec"]["nodeSelector"] == \
                {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}


def test_mixed_spec_asks_the_meshs_cards():
    """The reference test's mixed spec: its inprocess binding's tp x sp = 4
    mesh gives the engine pod four cards."""
    _, pspec = _both(_mixed_spec().to_json_dict())
    eng = next(m for m in pman.generate_manifests(pspec) if m["kind"] == "Deployment"
               and m["metadata"]["labels"].get("seldon-type") == "engine")
    c = eng["spec"]["template"]["spec"]["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "4"}
    assert c["image"] == "seldon-core-tpu-torch/engine:latest"
    pred = json.loads(base64.b64decode(
        {e["name"]: e["value"] for e in c["env"]}["ENGINE_PREDICTOR"]))
    assert pred["graph"]["name"] == "tf"


@pytest.mark.parametrize("name,doc", CASES[:3] + CASES[-3:], ids=[c[0] for c in CASES[:3] +
                                                                   CASES[-3:]])
def test_the_stream_parses_back(name, doc):
    """The multi-document stream (JSON documents, which are YAML) parses
    back to the documents, and the Ambassador annotation's text is the
    reference's."""
    jspec, pspec = _both(doc)
    docs = pman.generate_manifests(pspec)
    assert list(yaml.safe_load_all(pman.to_yaml_stream(docs))) == docs
    front = docs[-1]
    want = jman.generate_manifests(jspec)[-1]
    key = "getambassador.io/config"
    assert front["metadata"]["annotations"][key] == want["metadata"]["annotations"][key]
    assert yaml.safe_load(front["metadata"]["annotations"][key])["prefix"] == \
        f"/seldon/{pspec.name}/"


def test_the_cli_renders_an_example():
    out = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.operator.manifests",
                          str(ROOT / "examples" / "generator_tp_deployment.json")],
                         capture_output=True, text=True, timeout=60, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stderr == ""
    docs = list(yaml.safe_load_all(out.stdout))
    eng = docs[0]["spec"]["template"]["spec"]["containers"][0]
    assert eng["resources"]["limits"] == {"nvidia.com/gpu": "4"}


def test_prewarm_and_reserved_name_as_the_reference():
    doc = _mixed_spec().to_json_dict()
    doc["spec"]["annotations"]["seldon.io/prewarm-widths"] = "784,16"
    env = {e["name"]: e["value"] for e in pman.generate_manifests(PSpec.from_json_dict(doc))[0]
           ["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["ENGINE_PREWARM_WIDTHS"] == "784,16"
    doc["spec"]["annotations"]["seldon.io/prewarm-widths"] = "0,x"
    with pytest.raises(ValueError, match="prewarm-widths"):
        pman.generate_manifests(PSpec.from_json_dict(doc))
    bad = {"spec": {"name": "d", "predictors": [{
        "name": "p", "graph": {"name": "engine", "type": "MODEL"},
        "components": [{"name": "engine", "runtime": "rest", "image": "x:1"}]}]}}
    with pytest.raises(ValueError, match="reserved"):
        pman.generate_manifests(PSpec.from_json_dict(bad))


def _model_dir(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    (d / "EchoModel.py").write_text("import numpy as np\n"
                                    "class EchoModel:\n"
                                    "    def predict(self, X, names):\n"
                                    "        return np.asarray(X)\n")
    return d


def test_package_model_writes_the_references_files(tmp_path):
    """The packager's files equal the reference's with the module name
    and the base image mapped, and it stages the port's package (its
    kernel sources too) into the build context, which the base image lacks;
    ``validate`` reads the port microservice's ``SERVICE_TYPES``."""
    kw = dict(model_name="EchoModel:EchoModel", api_type="GRPC", service_type="ROUTER",
              persistence=1)
    got = package_model(str(_model_dir(tmp_path, "port")), ImageSpec(**kw))
    want = jpackage(str(_model_dir(tmp_path, "ref")), JImageSpec(**kw))
    assert set(want) == {"Dockerfile", "run.sh", ".s2i/environment"}
    assert set(got) == set(want) | {"seldon_core_tpu_torch"}
    for rel in want:
        text = pathlib.Path(got[rel]).read_text()
        ref = pathlib.Path(want[rel]).read_text()
        ref = ref.replace("seldon_core_tpu.runtime.microservice",
                          "seldon_core_tpu_torch.runtime.microservice")
        ref = ref.replace("seldon-core-tpu/base:latest", "nvcr.io/nvidia/pytorch:24.05-py3")
        assert text == ref, rel
    assert os.access(got["run.sh"], os.X_OK)
    pkg = pathlib.Path(got["seldon_core_tpu_torch"])
    assert pkg == tmp_path / "port" / "seldon_core_tpu_torch"
    for rel in ("__init__.py", "runtime/microservice.py", "ops/csrc/flash_attention.cu"):
        assert (pkg / rel).read_bytes() == (ROOT / "seldon_core_tpu_torch" / rel).read_bytes()
    assert not list(pkg.rglob("__pycache__"))
    with pytest.raises(ValueError, match="service_type"):
        ImageSpec(model_name="M", service_type="NOPE").validate()
    with pytest.raises(ValueError, match="api_type"):
        ImageSpec(model_name="M", api_type="SOAP").validate()


def test_the_packaged_run_sh_boots_the_ports_microservice(tmp_path):
    """``run.sh``'s env contract starts the port's microservice from the
    build context alone, as the container runs it (working directory the
    context, the repo on no path): on a machine without a card it reaches
    the microservice, which refuses ``cuda`` in its words; the same line
    with ``--device cpu`` boots it (``MICROSERVICE_SMOKE_EXIT``: build the
    runtime, then exit)."""
    ctx = tmp_path / "ctx"
    package_model(str(_model_dir(tmp_path, "m")), ImageSpec(model_name="EchoModel:EchoModel"),
                  out_dir=str(ctx))
    paths = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
             if p and pathlib.Path(p).resolve() != ROOT]
    env = {**os.environ, "MODEL_NAME": "EchoModel:EchoModel", "API_TYPE": "REST",
           "SERVICE_TYPE": "MODEL", "PERSISTENCE": "0", "PYTHONPATH": os.pathsep.join(paths),
           "PREDICTIVE_UNIT_SERVICE_PORT": "0", "MICROSERVICE_SMOKE_EXIT": "1"}
    where = subprocess.run([sys.executable, "-c", "import seldon_core_tpu_torch as p; "
                            "print(p.__file__)"], env=env, capture_output=True, text=True,
                           timeout=60, cwd=str(ctx))
    assert where.returncode == 0, where.stderr[-2000:]
    assert pathlib.Path(where.stdout.strip()).resolve().parent == (ctx / "seldon_core_tpu_torch")
    run = (ctx / "run.sh").read_text()
    assert "seldon_core_tpu_torch.runtime.microservice" in run
    (ctx / "run_cpu.sh").write_text(
        run.replace('--persistence "$PERSISTENCE"', '--persistence "$PERSISTENCE" --device cpu'))
    for script, ok in (("run.sh", False), ("run_cpu.sh", True)):
        out = subprocess.run(["/bin/sh", str(ctx / script)], env=env, capture_output=True,
                             text=True, timeout=120, cwd=str(ctx))
        if ok:
            assert out.returncode == 0, out.stderr[-2000:]
            assert "smoke ok: EchoModel:EchoModel as MODEL on cpu" in out.stdout
        else:
            import torch

            if torch.cuda.is_available():
                continue
            assert out.returncode == 2 and "device 'cuda' requested" in out.stderr, out.stderr
