"""Parameterized platform bundle — the helm-values / ksonnet-prototype
packaging layer; the port's copy of ``seldon_core_tpu/operator/bundle.py``.
The documents are the reference's, in the same order, with the port's
images, the port's modules in every ``command`` and the card's resource and
node-selector label in the accelerator block; every values key keeps its
name, so a values file written for the JAX bundle renders here.

The reference ships its platform as templated charts: ``seldon-core``
(apife + cluster-manager + engine image + redis + RBAC,
helm-charts/seldon-core/values.yaml), ``seldon-core-crd``,
``seldon-core-analytics`` (prometheus + grafana),
``seldon-core-loadtesting``, ``seldon-core-kafka``, with the same knobs
mirrored in ksonnet (seldon-core/seldon-core/core.libsonnet:35-141).

``render_bundle(values)`` is that layer for this framework: one values
dict (or YAML file) parameterizes images, replicas, ports, RBAC, OAuth,
accelerator resources, analytics on/off, a loadtest job, and the firehose
consumer (this framework's Kafka-role component); the output is a list of
Kubernetes manifests ready for ``kubectl apply -f -`` via
``manifests.to_yaml_stream``.  Per-model resources stay with
``manifests.generate_manifests`` — this module renders the PLATFORM, the
same split the reference kept between its charts and the operator's
per-deployment resources.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Mapping, Optional

from seldon_core_tpu_torch.operator.manifests import GPU_RESOURCE, GPU_SELECTOR
from seldon_core_tpu_torch.operator.reconciler import SELDON_CRD

__all__ = ["default_values", "merge_values", "render_bundle", "main"]

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_values() -> Dict[str, Any]:
    """The chart's tunable surface, reference values.yaml roles mapped to
    this framework's components."""
    return {
        "namespace": "seldon",
        "rbac": {"enabled": True, "service_account": "seldon"},
        "crd": {"create": True},
        "operator": {  # cluster-manager role
            "image": "seldon-core-tpu-torch/operator:latest",
            "replicas": 1,
            "reconcile_interval_s": 10,
        },
        "gateway": {  # apife role
            "enabled": True,
            "image": "seldon-core-tpu-torch/gateway:latest",
            "replicas": 1,
            "service_type": "NodePort",
            "rest_port": 8080,
            "grpc_port": 5000,
            "oauth": {"enabled": True},
            # shared token/deployment state (the reference's redis role):
            # a PVC (ReadWriteMany) makes the sqlite file replica-shared;
            # without it replicas>1 is refused at render time, because
            # per-pod token stores would 401 cross-replica traffic
            "state_path": "/var/run/seldon/gateway.db",
            "state_pvc": {"enabled": False, "size": "1Gi",
                          "storage_class": ""},
        },
        "engine": {  # image + env every engine pod gets
            "image": "seldon-core-tpu-torch/engine:latest",
            "http_impl": "native",
            "grpc_impl": "native",
            "max_batch": 1024,
            "batch_wait_ms": 2.0,
            "pipeline_depth": 8,
        },
        "tpu": {  # accelerator scheduling defaults for engine pods (the
            # key keeps the reference's name; the values are the card's)
            "resource": GPU_RESOURCE,
            "default_chips": 1,
            "topology_selector": next(iter(GPU_SELECTOR)),
        },
        "analytics": {  # seldon-core-analytics chart role
            "enabled": False,
            "prometheus_image": "prom/prometheus:v2.45.0",
            "grafana_image": "grafana/grafana:10.0.0",
            "grafana_service_type": "NodePort",
        },
        "loadtest": {  # seldon-core-loadtesting chart role
            "enabled": False,
            "image": "seldon-core-tpu-torch/loadtest:latest",
            "target_host": "",
            "target_port": 8000,
            "contract": "/contracts/contract.json",
            "clients": 256,
            "duration_s": 60,
            "api": "rest",
        },
        "firehose": {  # seldon-core-kafka chart role (JSONL firehose)
            "consumer_enabled": False,
            "image": "seldon-core-tpu-torch/gateway:latest",
            "base_dir": "/var/run/seldon/firehose",
            "deployment": "",  # deployment id (topic) the consumer follows
        },
    }


def merge_values(overrides: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    """Defaults deep-merged with user overrides (helm's values semantics:
    scalars replace, maps merge)."""
    def deep(base: Dict[str, Any], over: Mapping[str, Any]):
        for k, v in over.items():
            if isinstance(v, Mapping) and isinstance(base.get(k), dict):
                deep(base[k], v)
            else:
                base[k] = copy.deepcopy(v)

    values = default_values()
    if overrides:
        deep(values, overrides)
    return values


def _metadata(name: str, values: Dict[str, Any],
              labels: Optional[Dict[str, str]] = None) -> dict:
    return {
        "name": name,
        "namespace": values["namespace"],
        "labels": {"app": "seldon", "seldon-platform": name, **(labels or {})},
    }


def _deployment(name: str, values: Dict[str, Any], image: str, replicas: int,
                container: dict) -> dict:
    container = {"name": name, "image": image, **container}
    spec_pod: Dict[str, Any] = {"containers": [container]}
    if values["rbac"]["enabled"]:
        spec_pod["serviceAccountName"] = values["rbac"]["service_account"]
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _metadata(name, values),
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"seldon-platform": name}},
            "template": {
                "metadata": {
                    "labels": {"app": "seldon", "seldon-platform": name}
                },
                "spec": spec_pod,
            },
        },
    }


def _service(name: str, values: Dict[str, Any], ports: List[dict],
             service_type: str = "ClusterIP") -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _metadata(name, values),
        "spec": {
            "type": service_type,
            "selector": {"seldon-platform": name},
            "ports": ports,
        },
    }


def _rbac(values: Dict[str, Any]) -> List[dict]:
    sa = values["rbac"]["service_account"]
    return [
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": _metadata(sa, values),
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "Role",
            "metadata": _metadata("seldon-operator", values),
            "rules": [
                {
                    "apiGroups": ["machinelearning.seldon.io"],
                    "resources": ["seldondeployments",
                                  "seldondeployments/status"],
                    "verbs": ["get", "list", "watch", "create", "update",
                              "patch", "delete"],
                },
                {
                    "apiGroups": ["apps", ""],
                    "resources": ["deployments", "services"],
                    "verbs": ["get", "list", "watch", "create", "update",
                              "patch", "delete"],
                },
                {
                    "apiGroups": ["apiextensions.k8s.io"],
                    "resources": ["customresourcedefinitions"],
                    "verbs": ["get", "create"],
                },
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": _metadata("seldon-operator", values),
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "Role",
                "name": "seldon-operator",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": sa,
                    "namespace": values["namespace"],
                }
            ],
        },
    ]


def _operator(values: Dict[str, Any]) -> dict:
    v = values["operator"]
    e = values["engine"]
    # the engine knobs ride the operator pod's env into every rendered
    # engine Deployment (reconciler.main reads these two variables)
    engine_env = {
        "ENGINE_HTTP_IMPL": e["http_impl"],
        "ENGINE_GRPC_IMPL": e["grpc_impl"],
        "ENGINE_MAX_BATCH": str(e["max_batch"]),
        "ENGINE_BATCH_WAIT_MS": str(e["batch_wait_ms"]),
        "ENGINE_PIPELINE_DEPTH": str(e["pipeline_depth"]),
    }
    return _deployment(
        "seldon-operator", values, v["image"], v["replicas"],
        {
            "command": ["python", "-m",
                        "seldon_core_tpu_torch.operator.reconciler",
                        "--namespace", values["namespace"],
                        "--interval", str(v["reconcile_interval_s"])],
            "env": [
                {"name": "SELDON_ENGINE_IMAGE", "value": e["image"]},
                {"name": "SELDON_ENGINE_ENV",
                 "value": json.dumps(engine_env, sort_keys=True)},
            ],
        },
    )


def _gateway(values: Dict[str, Any]) -> List[dict]:
    v = values["gateway"]
    env = [
        {"name": "GATEWAY_OAUTH_ENABLED",
         "value": "1" if v["oauth"]["enabled"] else "0"},
        {"name": "GATEWAY_STATE_PATH", "value": v["state_path"]},
        {"name": "GATEWAY_REST_PORT", "value": str(v["rest_port"])},
        {"name": "GATEWAY_GRPC_PORT", "value": str(v["grpc_port"])},
    ]
    pvc_on = v["state_pvc"]["enabled"]
    if v["replicas"] > 1 and not pvc_on:
        raise ValueError(
            "gateway.replicas > 1 requires gateway.state_pvc.enabled: "
            "per-pod sqlite stores would reject tokens issued by other "
            "replicas (see gateway/state.py)"
        )
    state_dir = os.path.dirname(v["state_path"]) or "/var/run/seldon"
    dep = _deployment(
        "seldon-gateway", values, v["image"], v["replicas"],
        {
            "command": ["python", "-m",
                        "seldon_core_tpu_torch.gateway.gateway_main"],
            "env": env,
            "ports": [
                {"containerPort": v["rest_port"], "name": "http"},
                {"containerPort": v["grpc_port"], "name": "grpc"},
            ],
            # /ready is 503 until a deployment registers; gateway_main
            # registers file specs BEFORE binding the server, so a probe
            # can only stay red while the spec source is genuinely empty.
            # Pin period/threshold explicitly: unready (no restart) for as
            # long as that lasts, green within ~5 s of the first register.
            "readinessProbe": {
                "httpGet": {"path": "/ready", "port": v["rest_port"]},
                "initialDelaySeconds": 5,
                "periodSeconds": 5,
                "failureThreshold": 3,
            },
            "volumeMounts": [{"name": "gateway-state",
                              "mountPath": state_dir}],
        },
    )
    dep["spec"]["template"]["spec"]["volumes"] = [
        {"name": "gateway-state",
         **({"persistentVolumeClaim": {"claimName": "seldon-gateway-state"}}
            if pvc_on else {"emptyDir": {}})}
    ]
    out: List[dict] = []
    if pvc_on:
        pvc_spec: Dict[str, Any] = {
            "accessModes": ["ReadWriteMany"],
            "resources": {"requests": {"storage": v["state_pvc"]["size"]}},
        }
        if v["state_pvc"]["storage_class"]:
            pvc_spec["storageClassName"] = v["state_pvc"]["storage_class"]
        out.append({
            "apiVersion": "v1",
            "kind": "PersistentVolumeClaim",
            "metadata": _metadata("seldon-gateway-state", values),
            "spec": pvc_spec,
        })
    svc = _service(
        "seldon-gateway", values,
        [
            {"port": v["rest_port"], "targetPort": v["rest_port"],
             "name": "http"},
            {"port": v["grpc_port"], "targetPort": v["grpc_port"],
             "name": "grpc"},
        ],
        v["service_type"],
    )
    return [*out, dep, svc]


def _analytics(values: Dict[str, Any]) -> List[dict]:
    v = values["analytics"]

    def read(rel: str) -> str:
        with open(os.path.join(_REPO, "monitoring", rel)) as f:
            return f.read()

    prom_cm = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": _metadata("seldon-prometheus-config", values),
        "data": {
            "prometheus.yml": read("prometheus.yml"),
            "alerts.yml": read("alerts.yml"),
        },
    }
    graf_cm = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": _metadata("seldon-grafana-dashboards", values),
        "data": {
            "predictions-analytics-dashboard.json": read(
                os.path.join("grafana",
                             "predictions-analytics-dashboard.json")
            ),
        },
    }
    prom = _deployment(
        "seldon-prometheus", values, v["prometheus_image"], 1,
        {
            "args": ["--config.file=/etc/prometheus/prometheus.yml"],
            "ports": [{"containerPort": 9090}],
            "volumeMounts": [
                {"name": "config", "mountPath": "/etc/prometheus"}
            ],
        },
    )
    prom["spec"]["template"]["spec"]["volumes"] = [
        {"name": "config",
         "configMap": {"name": "seldon-prometheus-config"}}
    ]
    graf = _deployment(
        "seldon-grafana", values, v["grafana_image"], 1,
        {
            "ports": [{"containerPort": 3000}],
            "volumeMounts": [
                {"name": "dashboards",
                 "mountPath": "/var/lib/grafana/dashboards"}
            ],
        },
    )
    graf["spec"]["template"]["spec"]["volumes"] = [
        {"name": "dashboards",
         "configMap": {"name": "seldon-grafana-dashboards"}}
    ]
    return [
        prom_cm, graf_cm, prom,
        _service("seldon-prometheus", values,
                 [{"port": 9090, "targetPort": 9090}]),
        graf,
        _service("seldon-grafana", values,
                 [{"port": 3000, "targetPort": 3000}],
                 v["grafana_service_type"]),
    ]


def _loadtest_job(values: Dict[str, Any]) -> dict:
    v = values["loadtest"]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": _metadata("seldon-loadtest", values),
        "spec": {
            "backoffLimit": 0,
            "template": {
                "metadata": {"labels": {"app": "seldon",
                                        "seldon-platform": "loadtest"}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [
                        {
                            "name": "loadtest",
                            "image": v["image"],
                            "command": [
                                "python", "-m",
                                "seldon_core_tpu_torch.testing.loadtest",
                                v["contract"], v["target_host"],
                                str(v["target_port"]),
                                "--native", "--api", v["api"],
                                "--clients", str(v["clients"]),
                                "--duration", str(v["duration_s"]),
                            ],
                        }
                    ],
                },
            },
        },
    }


def _firehose_consumer(values: Dict[str, Any]) -> dict:
    v = values["firehose"]
    return _deployment(
        "seldon-firehose-consumer", values, v["image"], 1,
        {
            "command": ["python", "-m", "seldon_core_tpu_torch.gateway.firehose",
                        v["deployment"], "--dir", v["base_dir"], "--follow"],
        },
    )


def render_bundle(overrides: Optional[Mapping[str, Any]] = None) -> List[dict]:
    """Values -> full platform manifest list (reference chart-set parity:
    crd, core, analytics, loadtesting, kafka-role firehose)."""
    values = merge_values(overrides)
    out: List[dict] = []
    if values["crd"]["create"]:
        crd = copy.deepcopy(SELDON_CRD)
        out.append(crd)
    if values["rbac"]["enabled"]:
        out.extend(_rbac(values))
    out.append(_operator(values))
    if values["gateway"]["enabled"]:
        out.extend(_gateway(values))
    if values["analytics"]["enabled"]:
        out.extend(_analytics(values))
    if values["loadtest"]["enabled"]:
        out.append(_loadtest_job(values))
    if values["firehose"]["consumer_enabled"]:
        out.append(_firehose_consumer(values))
    return out


def main(argv=None) -> None:
    """Render the platform bundle to YAML.

        python -m seldon_core_tpu_torch.operator.bundle \
            [--values values.yaml] [--set analytics.enabled=true ...]
    """
    import argparse

    from seldon_core_tpu_torch.operator.manifests import to_yaml_stream

    parser = argparse.ArgumentParser(description="platform bundle renderer")
    parser.add_argument("--values", default=None,
                        help="values JSON file (YAML needs PyYAML)")
    parser.add_argument(
        "--set", action="append", default=[],
        help="dotted override, e.g. analytics.enabled=true",
    )
    args = parser.parse_args(argv)
    overrides: Dict[str, Any] = {}
    if args.values:
        with open(args.values) as f:
            text = f.read()
        try:
            overrides = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError:
                raise SystemExit(
                    f"{args.values}: not JSON, and reading YAML needs PyYAML, "
                    f"which this Python lacks; write the values as JSON"
                ) from None
            overrides = yaml.safe_load(text) or {}
    for item in args.set:
        key, _, raw = item.partition("=")
        value: Any = raw
        if raw.lower() in ("true", "false"):
            value = raw.lower() == "true"
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    pass
        node = overrides
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    print(to_yaml_stream(render_bundle(overrides)), end="")


if __name__ == "__main__":
    main()
