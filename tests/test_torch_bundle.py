"""The port's platform bundle (seldon_core_tpu_torch/operator/bundle.py)
against the JAX package's, on the CPU: the twelve cases of
tests/test_bundle.py on the port (its golden-file pin replaced by the JAX
render mapped), and ``render_bundle`` equal to the JAX ``render_bundle``
after the image, module-name and accelerator mapping for the default values
and for every override those cases use; ``main --values`` reads JSON and
refuses YAML clearly where PyYAML is missing."""

import json

import pytest

from seldon_core_tpu_torch.operator.bundle import (
    default_values,
    merge_values,
    render_bundle,
)
from seldon_core_tpu_torch.operator.manifests import GPU_RESOURCE, GPU_SELECTOR

#: the overrides tests/test_bundle.py renders with
OVERRIDES = [
    None,
    {"analytics": {"enabled": True}},
    {"loadtest": {"enabled": True, "target_host": "iris-deployment", "clients": 64,
                  "api": "grpc"}},
    {"engine": {"image": "registry/engine:v9", "max_batch": 256}},
    {"namespace": "prod"},
    {"rbac": {"enabled": False}},
    {"gateway": {"replicas": 2, "state_pvc": {"enabled": True}}},
    {"gateway": {"rest_port": 9000, "grpc_port": 9001}},
    {"analytics": {"enabled": True}, "namespace": "stage"},
    {"firehose": {"consumer_enabled": True, "deployment": "iris"},
     "gateway": {"state_pvc": {"enabled": True, "storage_class": "fast"}}},
]


def _mapped(doc):
    """A JAX bundle document with the port's images, the port's modules in
    its commands and the card's resource and node-selector label."""
    if isinstance(doc, dict):
        return {_mapped(k): _mapped(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mapped(v) for v in doc]
    if isinstance(doc, str):
        if doc.startswith("seldon-core-tpu/"):
            return "seldon-core-tpu-torch/" + doc[len("seldon-core-tpu/"):]
        if doc.startswith("seldon_core_tpu."):
            return "seldon_core_tpu_torch." + doc[len("seldon_core_tpu."):]
        return {"google.com/tpu": GPU_RESOURCE,
                "cloud.google.com/gke-tpu-topology": next(iter(GPU_SELECTOR))}.get(doc, doc)
    return doc


def _documents(stream: str) -> list:
    """The port's ``to_yaml_stream`` output: one JSON document a part."""
    return [json.loads(part) for part in stream.split("\n---\n") if part.strip()]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: json.dumps(o)[:40])
def test_render_bundle_is_the_jax_render_mapped(overrides):
    from seldon_core_tpu.operator import bundle as jbundle

    want = [_mapped(m) for m in jbundle.render_bundle(overrides)]
    got = render_bundle(overrides)
    assert [(m["kind"], m["metadata"]["name"]) for m in got] == \
        [(m["kind"], m["metadata"]["name"]) for m in want]
    assert got == want


def test_values_keep_the_jax_keys_and_map_the_accelerator():
    """Every values key keeps its name (a JAX values file renders here); the
    accelerator block holds the card's resource and node-selector label."""
    from seldon_core_tpu.operator import bundle as jbundle

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    assert keys(default_values()) == keys(jbundle.default_values())
    assert default_values() == _mapped(jbundle.default_values())
    assert default_values()["tpu"] == {"resource": "nvidia.com/gpu", "default_chips": 1,
                                       "topology_selector": "cloud.google.com/gke-accelerator"}
    cmds = [m["spec"]["template"]["spec"]["containers"][0]["command"][2]
            for m in render_bundle(OVERRIDES[-1] | {"loadtest": {"enabled": True}})
            if m["kind"] in ("Deployment", "Job")]
    assert sorted(cmds) == sorted([
        "seldon_core_tpu_torch.operator.reconciler", "seldon_core_tpu_torch.gateway.gateway_main",
        "seldon_core_tpu_torch.testing.loadtest", "seldon_core_tpu_torch.gateway.firehose"])


def test_cli_values_json_file(tmp_path, capsys):
    from seldon_core_tpu_torch.operator.bundle import main

    values = tmp_path / "values.json"
    values.write_text(json.dumps({"namespace": "json-ns", "loadtest": {"enabled": True}}))
    main(["--values", str(values)])
    docs = _documents(capsys.readouterr().out)
    assert docs == render_bundle({"namespace": "json-ns", "loadtest": {"enabled": True}})


def test_cli_values_yaml_needs_pyyaml(tmp_path, capsys, monkeypatch):
    """A YAML values file imports ``yaml`` only then; without PyYAML the
    error says so (the card's machine lists no PyYAML)."""
    import builtins

    from seldon_core_tpu_torch.operator.bundle import main

    values = tmp_path / "values.yaml"
    values.write_text("namespace: yaml-ns\n")
    real_import = builtins.__import__

    def no_yaml(name, *args, **kw):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(SystemExit, match="PyYAML"):
        main(["--values", str(values)])




def kinds(manifests):
    return [(m["kind"], m["metadata"]["name"]) for m in manifests]


def test_default_bundle_shape():
    ms = render_bundle()
    ks = kinds(ms)
    assert ("CustomResourceDefinition",
            "seldondeployments.machinelearning.seldon.io") in ks
    assert ("Deployment", "seldon-operator") in ks
    assert ("Deployment", "seldon-gateway") in ks
    assert ("Service", "seldon-gateway") in ks
    assert ("ServiceAccount", "seldon") in ks
    assert ("Role", "seldon-operator") in ks
    assert ("RoleBinding", "seldon-operator") in ks
    # analytics/loadtest/firehose default off
    assert not any(n.startswith("seldon-prometheus") for _, n in ks)
    assert not any(k == "Job" for k, _ in ks)


def test_golden_default_render():
    """The reference pins its default render in a golden file; the port's
    pin is the JAX render itself, mapped (no golden file of its own)."""
    from seldon_core_tpu.operator.bundle import render_bundle as jax_render

    assert render_bundle() == [_mapped(m) for m in jax_render()]


def test_analytics_toggle_renders_monitoring_stack():
    ms = render_bundle({"analytics": {"enabled": True}})
    ks = kinds(ms)
    assert ("Deployment", "seldon-prometheus") in ks
    assert ("Deployment", "seldon-grafana") in ks
    cm = next(m for m in ms
              if m["metadata"]["name"] == "seldon-prometheus-config")
    assert "prometheus.yml" in cm["data"] and "alerts.yml" in cm["data"]
    dash = next(m for m in ms
                if m["metadata"]["name"] == "seldon-grafana-dashboards")
    assert "predictions-analytics-dashboard.json" in dash["data"]


def test_loadtest_job_parameterized():
    ms = render_bundle({
        "loadtest": {
            "enabled": True,
            "target_host": "iris-deployment",
            "clients": 64,
            "api": "grpc",
        }
    })
    job = next(m for m in ms if m["kind"] == "Job")
    cmd = job["spec"]["template"]["spec"]["containers"][0]["command"]
    assert "iris-deployment" in cmd
    assert "grpc" in cmd and "64" in cmd


def test_engine_values_flow_to_operator_env():
    ms = render_bundle({
        "engine": {"image": "registry/engine:v9", "max_batch": 256}
    })
    op = next(m for m in ms if m["kind"] == "Deployment"
              and m["metadata"]["name"] == "seldon-operator")
    env = {
        e["name"]: e["value"]
        for e in op["spec"]["template"]["spec"]["containers"][0]["env"]
    }
    assert env["SELDON_ENGINE_IMAGE"] == "registry/engine:v9"
    assert json.loads(env["SELDON_ENGINE_ENV"])["ENGINE_MAX_BATCH"] == "256"


def test_merge_values_scalar_replace_map_merge():
    v = merge_values({"gateway": {"replicas": 3}})
    assert v["gateway"]["replicas"] == 3
    assert v["gateway"]["oauth"]["enabled"] is True  # untouched sibling
    assert v["namespace"] == default_values()["namespace"]


def test_namespace_applies_everywhere():
    ms = render_bundle({"namespace": "prod"})
    for m in ms:
        if m["kind"] == "CustomResourceDefinition":
            continue  # cluster-scoped
        assert m["metadata"]["namespace"] == "prod", m["metadata"]["name"]


def test_rbac_disabled_drops_rbac_and_service_account():
    ms = render_bundle({"rbac": {"enabled": False}})
    ks = kinds(ms)
    assert not any(k in ("ServiceAccount", "Role", "RoleBinding")
                   for k, _ in ks)
    op = next(m for m in ms if m["kind"] == "Deployment"
              and m["metadata"]["name"] == "seldon-operator")
    assert "serviceAccountName" not in op["spec"]["template"]["spec"]


def test_engine_env_reaches_rendered_engine_pods():
    # the operator plumb: values.engine -> reconciler -> engine Deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.operator.manifests import generate_manifests

    spec = SeldonDeploymentSpec.from_json_dict({
        "spec": {
            "name": "d",
            "predictors": [
                {"name": "p",
                 "graph": {"name": "m", "type": "MODEL",
                           "implementation": "SIMPLE_MODEL"}}
            ],
        }
    })
    ms = generate_manifests(
        spec, engine_image="registry/engine:v9",
        engine_env={"ENGINE_MAX_BATCH": "256"},
    )
    engine = next(m for m in ms if m["kind"] == "Deployment")
    container = engine["spec"]["template"]["spec"]["containers"][0]
    assert container["image"] == "registry/engine:v9"
    env = {e["name"]: e["value"] for e in container["env"]}
    assert env["ENGINE_MAX_BATCH"] == "256"


def test_gateway_replicas_require_shared_state_pvc():
    with pytest.raises(ValueError, match="state_pvc"):
        render_bundle({"gateway": {"replicas": 2}})
    ms = render_bundle({
        "gateway": {"replicas": 2, "state_pvc": {"enabled": True}}
    })
    pvc = next(m for m in ms if m["kind"] == "PersistentVolumeClaim")
    assert pvc["spec"]["accessModes"] == ["ReadWriteMany"]
    gw = next(m for m in ms if m["kind"] == "Deployment"
              and m["metadata"]["name"] == "seldon-gateway")
    vols = gw["spec"]["template"]["spec"]["volumes"]
    assert vols[0]["persistentVolumeClaim"]["claimName"] == \
        "seldon-gateway-state"


def test_gateway_ports_flow_to_process_env():
    ms = render_bundle({"gateway": {"rest_port": 9000, "grpc_port": 9001}})
    gw = next(m for m in ms if m["kind"] == "Deployment"
              and m["metadata"]["name"] == "seldon-gateway")
    env = {
        e["name"]: e["value"]
        for e in gw["spec"]["template"]["spec"]["containers"][0]["env"]
    }
    assert env["GATEWAY_REST_PORT"] == "9000"
    assert env["GATEWAY_GRPC_PORT"] == "9001"
    probe = gw["spec"]["template"]["spec"]["containers"][0]["readinessProbe"]
    assert probe["httpGet"]["port"] == 9000


def test_cli_set_overrides(capsys):
    from seldon_core_tpu_torch.operator.bundle import main

    main(["--set", "analytics.enabled=true", "--set", "namespace=stage"])
    docs = _documents(capsys.readouterr().out)
    assert any(d["metadata"]["name"] == "seldon-prometheus" for d in docs)
    assert {d["metadata"].get("namespace") for d in docs} == {"stage", None}
