"""Kubernetes manifest generation for the port's engine — the operator's
resource-creation pass, emitted as data instead of API calls; the port's
copy of ``seldon_core_tpu/operator/manifests.py``.

Mirrors the reference operator's ``createResources`` (cluster-manager
SeldonDeploymentOperatorImpl.java:520-666) and the helm/ksonnet packaging
(helm-charts/, seldon-core/ core.libsonnet:35-141): per predictor an engine
Deployment (graph shipped as ``ENGINE_PREDICTOR`` base64 JSON env —
SeldonDeploymentOperatorImpl.java:105 — prometheus scrape annotations,
``/ready`` readiness probe, pre-stop ``/pause`` drain, rolling update
maxUnavailable 10%), one Deployment + ClusterIP Service per remote component
binding (TCP readiness probe on the assigned port, ``seldon-app-<name>``
selector labels), and one per-deployment Service fronting the engine with
Ambassador-style route annotations.

GPU additions: engine pods for predictors with accelerator inprocess
bindings (``device`` "tpu", the spec's default, which the port reads as
"the accelerator") request ``nvidia.com/gpu``: as many cards as the largest ``mesh_axes`` product over
those bindings, the count the JAX renderer asks of ``google.com/tpu``.  They
carry an H100 node selector (GKE's ``cloud.google.com/gke-accelerator:
nvidia-h100-80gb``) where the JAX renderer selects a ``tpu-topology`` (the
graph compiles INTO the engine, so the engine pod — not the model pods —
owns the cards; remote bindings keep the reference's CPU layout).  The
default images are the port's engine and microservice.

Everything returns plain dicts; ``to_yaml_stream`` renders the multi-doc
stream that ``kubectl apply -f -`` consumes, each document as JSON (which
is YAML), so rendering needs no YAML library.  ``seldon.io/shard-graph``
node engines come from the port's ``graph/sharding.py``.
"""

from __future__ import annotations

import base64
import json
import re
from typing import Dict, List

from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.sharding import node_subspec, shard_predictor, shardable_nodes
from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeploymentSpec

__all__ = ["generate_manifests", "engine_deployment", "to_yaml_stream",
           "SHARD_ANNOTATION", "GPU_RESOURCE", "GPU_SELECTOR"]

ENGINE_IMAGE = "seldon-core-tpu-torch/engine:latest"
MICROSERVICE_IMAGE = "seldon-core-tpu-torch/microservice:latest"
#: the extended resource the NVIDIA device plugin advertises
GPU_RESOURCE = "nvidia.com/gpu"
#: the node selector of an H100 node pool (GKE's accelerator label)
GPU_SELECTOR = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
ENGINE_REST_PORT = 8000   # cluster-manager application.properties:5
ENGINE_GRPC_PORT = 5001   # cluster-manager application.properties:6
ENGINE_METRICS_PATH = "/prometheus"

#: ``seldon.io/shard-graph: "true"`` materializes one engine
#: Deployment+Service per shardable MODEL leaf (graph/sharding.py) — the
#: reference's pod-per-node topology (PAPER.md §1) won back at scale-out
SHARD_ANNOTATION = "seldon.io/shard-graph"


def _labels(spec: SeldonDeploymentSpec, predictor: PredictorSpec,
            component: str = "") -> Dict[str, str]:
    lab = {
        "app": "seldon",
        "seldon-deployment-id": spec.name,
        "seldon-predictor": predictor.name,
    }
    if component:
        # the reference labels model pods seldon-app-<container> so the
        # per-container Service can select them
        # (SeldonDeploymentOperatorImpl.java:254-258)
        lab[f"seldon-app-{component}"] = "true"
    else:
        lab["seldon-type"] = "engine"
    return lab


def _gpu_request(predictor: PredictorSpec) -> Dict[str, str]:
    """Cards the engine pod needs: max mesh size over inprocess
    accelerator bindings (``device`` "tpu")."""
    cards = 0
    for b in predictor.components:
        if b.runtime == "inprocess" and b.device == "tpu":
            n = 1
            for v in (b.mesh_axes or {}).values():
                n *= int(v)
            cards = max(cards, n)
    return {GPU_RESOURCE: str(cards)} if cards else {}


def engine_deployment(spec: SeldonDeploymentSpec,
                      predictor: PredictorSpec,
                      engine_image: str = "",
                      engine_env: "Dict[str, str] | None" = None) -> dict:
    """``engine_image`` / ``engine_env`` are the chart-level knobs the
    reference wires through its operator properties
    (ENGINE_CONTAINER_IMAGE_AND_VERSION, cluster-manager
    application.properties) — rendered values flow operator -> here."""
    pred_b64 = base64.b64encode(
        json.dumps(predictor.to_json_dict(), separators=(",", ":")).encode()
    ).decode()
    # validated here so a malformed annotation fails the RECONCILE (CR goes
    # Failed with a clear message) instead of crash-looping engine pods
    prewarm = spec.annotations.get("seldon.io/prewarm-widths")
    if prewarm is not None:
        prewarm = str(prewarm)
        parts = [w.strip() for w in prewarm.split(",") if w.strip()]
        if not parts or any(not w.isdigit() or int(w) <= 0 for w in parts):
            raise ValueError(
                f"annotation seldon.io/prewarm-widths must be "
                f"comma-separated positive integers, got {prewarm!r}"
            )
    labels = _labels(spec, predictor)
    resources: dict = {"requests": {"cpu": "0.1"}}
    gpu = _gpu_request(predictor)
    if gpu:
        resources["limits"] = dict(gpu)
        resources["requests"].update(gpu)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{spec.name}-{predictor.name}-engine",
            "labels": labels,
            "annotations": dict(spec.annotations),
        },
        "spec": {
            "replicas": predictor.replicas,
            "selector": {"matchLabels": labels},
            # reference rolling policy (SeldonDeploymentOperatorImpl.java:564)
            "strategy": {
                "type": "RollingUpdate",
                "rollingUpdate": {"maxUnavailable": "10%"},
            },
            "template": {
                "metadata": {
                    "labels": labels,
                    "annotations": {
                        # scrape annotations the reference injects
                        # (SeldonDeploymentOperatorImpl.java:542-544)
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": ENGINE_METRICS_PATH,
                        "prometheus.io/port": str(ENGINE_REST_PORT),
                    },
                },
                "spec": {
                    "containers": [
                        {
                            "name": "seldon-engine",
                            "image": engine_image or ENGINE_IMAGE,
                            "env": [
                                {"name": "ENGINE_PREDICTOR", "value": pred_b64},
                                {"name": "SELDON_DEPLOYMENT_ID",
                                 "value": spec.name},
                                {"name": "ENGINE_SERVER_PORT",
                                 "value": str(ENGINE_REST_PORT)},
                                {"name": "ENGINE_SERVER_GRPC_PORT",
                                 "value": str(ENGINE_GRPC_PORT)},
                                *(
                                    {"name": k, "value": str(v)}
                                    for k, v in sorted(
                                        (engine_env or {}).items()
                                    )
                                    # the per-CR annotation must beat a
                                    # chart-wide default; drop the dup
                                    if not (prewarm is not None
                                            and k == "ENGINE_PREWARM_WIDTHS")
                                ),
                                *(
                                    [{"name": "ENGINE_PREWARM_WIDTHS",
                                      "value": prewarm}]
                                    if prewarm is not None else []
                                ),
                            ],
                            "ports": [
                                {"containerPort": ENGINE_REST_PORT,
                                 "name": "rest"},
                                {"containerPort": ENGINE_GRPC_PORT,
                                 "name": "grpc"},
                            ],
                            "readinessProbe": {
                                "httpGet": {"path": "/ready",
                                            "port": ENGINE_REST_PORT},
                                "initialDelaySeconds": 5,
                                "periodSeconds": 5,
                            },
                            "lifecycle": {
                                # pre-stop drain: flip readiness then sleep
                                # (SeldonDeploymentOperatorImpl.java:130-134)
                                "preStop": {
                                    "exec": {
                                        "command": [
                                            "/bin/sh", "-c",
                                            f"curl -s localhost:"
                                            f"{ENGINE_REST_PORT}/pause "
                                            f"&& sleep 5",
                                        ]
                                    }
                                }
                            },
                            "resources": resources,
                        }
                    ],
                    **({"nodeSelector": dict(GPU_SELECTOR)} if gpu else {}),
                },
            },
        },
    }


def component_deployment(spec: SeldonDeploymentSpec, predictor: PredictorSpec,
                         binding) -> dict:
    labels = _labels(spec, predictor, binding.name)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{spec.name}-{predictor.name}-{binding.name}",
            "labels": labels,
        },
        "spec": {
            "replicas": predictor.replicas,
            "selector": {"matchLabels": labels},
            "strategy": {
                "type": "RollingUpdate",
                "rollingUpdate": {"maxUnavailable": "10%"},
            },
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "containers": [
                        {
                            "name": binding.name,
                            "image": binding.image or MICROSERVICE_IMAGE,
                            "env": [
                                {"name": k, "value": str(v)}
                                for k, v in sorted(binding.env.items())
                            ],
                            "ports": [
                                {"containerPort": binding.port,
                                 "name": "http"
                                 if binding.runtime == "rest" else "grpc"}
                            ],
                            # TCP probe on the assigned unit port
                            # (SeldonDeploymentOperatorImpl.java:210-250)
                            "readinessProbe": {
                                "tcpSocket": {"port": binding.port},
                                "initialDelaySeconds": 10,
                                "periodSeconds": 5,
                            },
                            "livenessProbe": {
                                "tcpSocket": {"port": binding.port},
                                "initialDelaySeconds": 60,
                                "periodSeconds": 5,
                            },
                            "lifecycle": {
                                "preStop": {
                                    "exec": {"command": ["/bin/sh", "-c",
                                                         "sleep 10"]}
                                }
                            },
                        }
                    ]
                },
            },
        },
    }


def component_service(spec: SeldonDeploymentSpec, predictor: PredictorSpec,
                      binding) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{spec.name}-{predictor.name}-{binding.name}",
            "labels": {"seldon-deployment-id": spec.name},
        },
        "spec": {
            "type": "ClusterIP",
            # scope by deployment AND predictor: a bare seldon-app-<name>
            # selector would grab same-named components of other deployments
            "selector": {
                "seldon-deployment-id": spec.name,
                "seldon-predictor": predictor.name,
                f"seldon-app-{binding.name}": "true",
            },
            "ports": [
                {
                    "port": binding.port,
                    "targetPort": binding.port,
                    "protocol": "TCP",
                    "name": "http" if binding.runtime == "rest" else "grpc",
                }
            ],
        },
    }


def deployment_service(spec: SeldonDeploymentSpec) -> dict:
    """Per-deployment Service fronting the engines, with Ambassador-style
    route annotations (SeldonDeploymentOperatorImpl.java:465-484)."""
    ambassador = {
        "apiVersion": "ambassador/v0",
        "kind": "Mapping",
        "name": f"seldon_{spec.name}_mapping",
        "prefix": f"/seldon/{spec.name}/",
        "service": f"{spec.name}:{ENGINE_REST_PORT}",
    }
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": spec.name,
            "labels": {"seldon-deployment-id": spec.name},
            "annotations": {
                "getambassador.io/config": _yaml_mapping(ambassador)
            },
        },
        "spec": {
            "type": "ClusterIP",
            "selector": {"seldon-deployment-id": spec.name,
                         "seldon-type": "engine"},
            "ports": [
                {"port": ENGINE_REST_PORT, "targetPort": ENGINE_REST_PORT,
                 "name": "rest"},
                {"port": ENGINE_GRPC_PORT, "targetPort": ENGINE_GRPC_PORT,
                 "name": "grpc"},
            ],
        },
    }


def node_engine_service(node_spec: SeldonDeploymentSpec,
                        predictor: PredictorSpec) -> dict:
    """ClusterIP Service fronting one node engine (graph sharding).  No
    Ambassador route: node engines are internal mesh hops, only the root
    engine's deployment Service is externally routable."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": node_spec.name,
            "labels": {"seldon-deployment-id": node_spec.name},
        },
        "spec": {
            "type": "ClusterIP",
            "selector": {"seldon-deployment-id": node_spec.name,
                         "seldon-predictor": predictor.name,
                         "seldon-type": "engine"},
            "ports": [
                {"port": ENGINE_REST_PORT, "targetPort": ENGINE_REST_PORT,
                 "name": "rest"},
                {"port": ENGINE_GRPC_PORT, "targetPort": ENGINE_GRPC_PORT,
                 "name": "grpc"},
            ],
        },
    }


def _shard_enabled(spec: SeldonDeploymentSpec) -> bool:
    return str(
        spec.annotations.get(SHARD_ANNOTATION, "")
    ).strip().lower() in ("1", "true", "yes")


def generate_manifests(spec: SeldonDeploymentSpec,
                       run_defaulting: bool = True,
                       engine_image: str = "",
                       engine_env: "Dict[str, str] | None" = None) -> List[dict]:
    """All resources for a deployment, reference createResources order:
    engine Deployments, component Deployments/Services, deployment Service.

    With ``seldon.io/shard-graph: "true"`` and >= 2 shardable MODEL
    leaves, each leaf becomes its OWN engine Deployment+Service (the
    reference's pod-per-node topology) and the root engine's graph is
    rewritten to dispatch to them over the resilient remote client —
    graph/sharding.py.  A single-leaf graph is served collapsed even when
    annotated: sharding it would only add a network hop."""
    if run_defaulting:
        default_and_validate(spec)
    out: List[dict] = []
    for predictor in spec.predictors:
        for binding in predictor.components:
            if binding.name == "engine" and binding.runtime in ("rest", "grpc"):
                # its Deployment name would collide with (and on kubectl
                # apply, overwrite) the predictor's engine Deployment
                raise ValueError(
                    f"component name 'engine' is reserved "
                    f"(predictor {predictor.name!r})"
                )
        sharded_names: set = set()
        engine_pred = predictor
        if _shard_enabled(spec):
            nodes = shardable_nodes(predictor)
            if len(nodes) >= 2:
                endpoints = {}
                for unit in nodes:
                    nspec = node_subspec(spec, unit.name, predictor.name)
                    node_pred = nspec.predictors[0]
                    out.append(
                        engine_deployment(nspec, node_pred,
                                          engine_image=engine_image,
                                          engine_env=engine_env)
                    )
                    out.append(node_engine_service(nspec, node_pred))
                    # the node Service's DNS name is the nspec name
                    endpoints[unit.name] = (nspec.name, ENGINE_REST_PORT)
                engine_pred = shard_predictor(
                    spec, endpoints, predictor.name
                ).predictor(predictor.name)
                sharded_names = set(endpoints)
        out.append(
            engine_deployment(spec, engine_pred, engine_image=engine_image,
                              engine_env=engine_env)
        )
        for binding in engine_pred.components:
            if (
                binding.runtime in ("rest", "grpc")
                and binding.name not in sharded_names
            ):
                # genuinely-remote components keep their microservice
                # Deployment; sharded leaves are node ENGINES above, not
                # generic model pods
                out.append(component_deployment(spec, predictor, binding))
                out.append(component_service(spec, predictor, binding))
    out.append(deployment_service(spec))
    return out


#: a plain YAML scalar: safe characters, and not one that YAML would read
#: as a bool, null or number
_PLAIN = re.compile(r"[A-Za-z_./][A-Za-z0-9_./:-]*\Z")
_IMPLICIT = re.compile(r"(?i)(y|n|yes|no|true|false|on|off|null|~)\Z")


def _yaml_scalar(v) -> str:
    s = str(v)
    if _PLAIN.match(s) and not _IMPLICIT.match(s) and not s.endswith(":"):
        return s
    return json.dumps(s)  # a double-quoted YAML scalar


def _yaml_mapping(d: Dict[str, str]) -> str:
    """A flat mapping of strings as block YAML, one ``key: value`` a line
    in order (the Ambassador annotation's text)."""
    return "".join(f"{_yaml_scalar(k)}: {_yaml_scalar(v)}\n" for k, v in d.items())


def to_yaml_stream(manifests: List[dict]) -> str:
    """Multi-document YAML for ``kubectl apply -f -``: each document as
    indented JSON, which is YAML, keys in order."""
    return "---\n".join(json.dumps(m, indent=2) + "\n" for m in manifests)


def main(argv=None) -> None:
    """CLI: render a deployment spec to k8s YAML (the helm-template
    equivalent): ``python -m seldon_core_tpu_torch.operator.manifests
    spec.json``.
    """
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="render deployment manifests")
    parser.add_argument("spec", help="SeldonDeployment JSON file")
    args = parser.parse_args(argv)
    with open(args.spec) as f:
        spec = SeldonDeploymentSpec.from_json(f.read())
    sys.stdout.write(to_yaml_stream(generate_manifests(spec)))


if __name__ == "__main__":
    main()
