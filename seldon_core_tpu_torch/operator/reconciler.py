"""Live reconciliation loop — the operator's cluster-facing half; the
port's copy of ``seldon_core_tpu/operator/reconciler.py``.  Desired state
renders through the port's ``manifests.generate_manifests``, so engine pods
ask for ``nvidia.com/gpu`` on H100 nodes; a rendered object's
``seldon.io/config-hash`` therefore differs from the JAX reconciler's by the
mapped accelerator fields, while the rollout's quarantine identity (a hash of
the CR's ``spec`` alone) is the same string in both packages.

The reference operator is a control loop against the Kubernetes API:
``CRDCreator`` registers the SeldonDeployment CRD at boot (cluster-manager
k8s/CRDCreator.java:33-60), ``SeldonDeploymentControllerImpl`` LISTs owned
resources and issues create/update/delete to converge them on the CR's
desired state (k8s/SeldonDeploymentControllerImpl.java:69-111), and
``SeldonDeploymentStatusUpdateImpl`` writes progress back onto the CR's
``status`` (k8s/SeldonDeploymentStatusUpdateImpl.java:49-104).

This module is that loop with the API server behind a small pluggable
client interface:

  * :class:`KubeClient` — the five verbs the loop needs (list / get /
    create / replace / delete + status patch).  :class:`FakeKubeApi` is an
    in-memory implementation for tests and local runs;
    :class:`KubectlClient` shells out to ``kubectl`` for a real cluster.
  * :class:`Reconciler` — desired state comes from
    ``manifests.generate_manifests`` (the same rendering ``kubectl apply``
    consumers use); convergence is hash-driven: every rendered resource
    carries a ``seldon.io/config-hash`` annotation, and an observed
    resource is replaced only when its hash differs, so a steady-state
    reconcile is zero API writes (the reference compares resource
    versions the same way).  Resources owned by the CR but no longer
    rendered — a removed predictor or component — are pruned.
  * Status write-back: ``Creating`` until every owned Deployment reports
    ``readyReplicas >= replicas``, then ``Available``; per-predictor
    replica counts mirror the reference's ``PredictorStatus`` list.
"""

from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.operator.manifests import generate_manifests

__all__ = [
    "KubeClient",
    "KubeConflict",
    "FakeKubeApi",
    "HostileKubeApi",
    "KubectlClient",
    "Reconciler",
    "SELDON_CRD",
    "HASH_ANNOTATION",
    "OWNER_LABEL",
]

HASH_ANNOTATION = "seldon.io/config-hash"
OWNER_LABEL = "seldon-deployment-id"

GROUP = "machinelearning.seldon.io"
CRD_NAME = f"seldondeployments.{GROUP}"

#: CustomResourceDefinition for SeldonDeployment — the resource
#: CRDCreator.java registers at operator boot.  Schema kept permissive the
#: way the reference's was (validation happens in graph/defaulting.py, the
#: same split the reference used between the CRD and ClusterManager).
SELDON_CRD = {
    "apiVersion": "apiextensions.k8s.io/v1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": CRD_NAME},
    "spec": {
        "group": GROUP,
        "names": {
            "kind": "SeldonDeployment",
            "listKind": "SeldonDeploymentList",
            "plural": "seldondeployments",
            "singular": "seldondeployment",
            "shortNames": ["sdep"],
        },
        "scope": "Namespaced",
        "versions": [
            {
                "name": "v1alpha2",
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "schema": {
                    "openAPIV3Schema": {
                        "type": "object",
                        "properties": {
                            "spec": {
                                "type": "object",
                                "x-kubernetes-preserve-unknown-fields": True,
                            },
                            "status": {
                                "type": "object",
                                "x-kubernetes-preserve-unknown-fields": True,
                            },
                        },
                    }
                },
            }
        ],
    },
}


class KubeConflict(Exception):
    """HTTP 409 — optimistic-concurrency conflict (stale resourceVersion)
    or a write colliding with another actor's.  The real API server
    returns these routinely under controller races; the reconcile loop
    resolves them by re-reading and retrying
    (SeldonDeploymentControllerImpl.java:69-111 takes the same
    LIST -> CREATE(404)/UPDATE shape for the same reason)."""


class KubeClient:
    """The API-server verbs the reconcile loop needs.  Implementations must
    be idempotent-friendly: create on an existing object raises KeyError,
    replace/delete on a missing one raises KeyError; optimistic-concurrency
    failures raise KubeConflict."""

    def list(self, kind: str, namespace: str,
             label_selector: Optional[Dict[str, str]] = None) -> List[dict]:
        raise NotImplementedError

    def get(self, kind: str, namespace: str, name: str) -> Optional[dict]:
        raise NotImplementedError

    def create(self, obj: dict) -> None:
        raise NotImplementedError

    def replace(self, obj: dict) -> None:
        raise NotImplementedError

    def delete(self, kind: str, namespace: str, name: str) -> None:
        raise NotImplementedError

    def patch_status(self, kind: str, namespace: str, name: str,
                     status: dict) -> None:
        raise NotImplementedError


def _meta(obj: dict) -> Tuple[str, str, str]:
    md = obj.get("metadata", {})
    return obj.get("kind", ""), md.get("namespace", "default"), md.get("name", "")


@dataclass
class FakeKubeApi(KubeClient):
    """In-memory API server for tests and local dry-runs — the role minikube
    played in the reference's E2E notebooks
    (notebooks/kubectl_demo_minikube_rbac.ipynb), without a cluster.

    Records every mutating verb in ``ops`` so tests can assert convergence
    properties (e.g. steady-state reconciles issue zero writes)."""

    objects: Dict[Tuple[str, str, str], dict] = field(default_factory=dict)
    ops: List[Tuple[str, str]] = field(default_factory=list)
    _rv: int = 0

    def _bump_rv(self, obj: dict) -> None:
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)

    def list(self, kind, namespace, label_selector=None):
        out = []
        for (k, ns, _), obj in sorted(self.objects.items()):
            if k != kind or ns != namespace:
                continue
            if label_selector:
                labels = obj.get("metadata", {}).get("labels", {})
                if any(labels.get(lk) != lv
                       for lk, lv in label_selector.items()):
                    continue
            out.append(copy.deepcopy(obj))
        return out

    def get(self, kind, namespace, name):
        obj = self.objects.get((kind, namespace, name))
        return copy.deepcopy(obj) if obj is not None else None

    def create(self, obj):
        key = _meta(obj)
        if key in self.objects:
            raise KeyError(f"already exists: {key}")
        stored = copy.deepcopy(obj)
        self._bump_rv(stored)
        self.objects[key] = stored
        self.ops.append(("create", f"{key[0]}/{key[2]}"))

    def replace(self, obj):
        key = _meta(obj)
        if key not in self.objects:
            raise KeyError(f"not found: {key}")
        live = self.objects[key]
        # optimistic concurrency, real-API-server semantics: a caller that
        # echoes a resourceVersion must echo the CURRENT one; objects
        # rendered fresh (no resourceVersion) behave like server-side
        # apply and win (KubectlClient.replace uses exactly that)
        sent_rv = obj.get("metadata", {}).get("resourceVersion")
        live_rv = live.get("metadata", {}).get("resourceVersion")
        if sent_rv is not None and live_rv is not None and sent_rv != live_rv:
            raise KubeConflict(
                f"conflict: {key} resourceVersion {sent_rv} != {live_rv}"
            )
        prior_status = live.get("status")
        stored = copy.deepcopy(obj)
        self._bump_rv(stored)
        self.objects[key] = stored
        if prior_status is not None and "status" not in obj:
            self.objects[key]["status"] = prior_status  # replace keeps status
        self.ops.append(("replace", f"{key[0]}/{key[2]}"))

    def delete(self, kind, namespace, name):
        key = (kind, namespace, name)
        if key not in self.objects:
            raise KeyError(f"not found: {key}")
        del self.objects[key]
        self.ops.append(("delete", f"{kind}/{name}"))

    def patch_status(self, kind, namespace, name, status):
        key = (kind, namespace, name)
        if key not in self.objects:
            raise KeyError(f"not found: {key}")
        self.objects[key].setdefault("status", {}).update(
            copy.deepcopy(status)
        )
        self._bump_rv(self.objects[key])
        self.ops.append(("patch_status", f"{kind}/{name}"))

    # -- test conveniences ---------------------------------------------

    def mark_deployments_ready(self, namespace: str = "default") -> None:
        """Simulate kubelet convergence: every Deployment reports its
        desired replica count ready."""
        for (kind, ns, _), obj in self.objects.items():
            if kind == "Deployment" and ns == namespace:
                want = obj.get("spec", {}).get("replicas", 1)
                obj["status"] = {"replicas": want, "readyReplicas": want}

    def clear_ops(self) -> None:
        self.ops.clear()


@dataclass
class HostileKubeApi(FakeKubeApi):
    """FakeKubeApi with the real API server's failure modes, injectable —
    the semantics the reference controller hardens against
    (SeldonDeploymentControllerImpl.java:69-111 create-vs-update races,
    SeldonDeploymentWatcher.java:89-153 stale resourceVersions).

    Knobs:
      * ``fail_queue`` — list of (verb, kind_or_name_substring, exception);
        the next matching call consumes the entry and raises.  Use for
        transient 500s (RuntimeError) and injected 409s (KubeConflict).
      * ``race_on_get_miss`` — when get() misses for a (kind, name) listed
        here, a phantom controller creates the object BEFORE returning, so
        the caller's get->create window always loses the race.
      * ``delete_crs_after_writes`` — once this many mutating verbs have
        landed, every SeldonDeployment CR vanishes (mid-reconcile CR
        deletion)."""

    fail_queue: List[Tuple[str, str, Exception]] = field(default_factory=list)
    race_on_get_miss: List[Tuple[str, str]] = field(default_factory=list)
    delete_crs_after_writes: Optional[int] = None
    _writes: int = 0

    def _maybe_fail(self, verb: str, ident: str) -> None:
        for i, (v, frag, exc) in enumerate(self.fail_queue):
            if v == verb and frag in ident:
                del self.fail_queue[i]
                raise exc

    def _count_write(self) -> None:
        self._writes += 1
        if (self.delete_crs_after_writes is not None
                and self._writes >= self.delete_crs_after_writes):
            self.delete_crs_after_writes = None
            for key in [k for k in self.objects
                        if k[0] == "SeldonDeployment"]:
                del self.objects[key]
                self.ops.append(("hostile_delete", f"{key[0]}/{key[2]}"))

    def list(self, kind, namespace, label_selector=None):
        self._maybe_fail("list", kind)
        return super().list(kind, namespace, label_selector)

    def get(self, kind, namespace, name):
        self._maybe_fail("get", f"{kind}/{name}")
        obj = super().get(kind, namespace, name)
        if obj is None and (kind, name) in self.race_on_get_miss:
            self.race_on_get_miss.remove((kind, name))
            phantom = {
                "kind": kind,
                "metadata": {"namespace": namespace, "name": name,
                             "annotations": {HASH_ANNOTATION: "phantom"},
                             "labels": {}},
            }
            super().create(phantom)
            self.ops.append(("hostile_create", f"{kind}/{name}"))
        return obj

    def create(self, obj):
        key = _meta(obj)
        self._maybe_fail("create", f"{key[0]}/{key[2]}")
        super().create(obj)
        self._count_write()

    def replace(self, obj):
        key = _meta(obj)
        self._maybe_fail("replace", f"{key[0]}/{key[2]}")
        super().replace(obj)
        self._count_write()

    def delete(self, kind, namespace, name):
        self._maybe_fail("delete", f"{kind}/{name}")
        super().delete(kind, namespace, name)
        self._count_write()

    def patch_status(self, kind, namespace, name, status):
        self._maybe_fail("patch_status", f"{kind}/{name}")
        super().patch_status(kind, namespace, name, status)


class KubectlClient(KubeClient):
    """Real-cluster client: each verb shells to ``kubectl`` with JSON IO.
    Used when the operator runs against an actual API server; everything
    the Reconciler needs from a cluster rides these five subcommands."""

    def __init__(self, kubectl: str = "kubectl"):
        self.kubectl = kubectl

    def _run(self, args: List[str], stdin: Optional[str] = None) -> str:
        import subprocess

        proc = subprocess.run(
            [self.kubectl, *args], input=stdin, capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            if "NotFound" in proc.stderr or "AlreadyExists" in proc.stderr:
                raise KeyError(proc.stderr.strip())
            if "Conflict" in proc.stderr or "conflict" in proc.stderr:
                raise KubeConflict(proc.stderr.strip())
            raise RuntimeError(proc.stderr.strip())
        return proc.stdout

    def list(self, kind, namespace, label_selector=None):
        args = ["get", kind, "-n", namespace, "-o", "json"]
        if label_selector:
            args += ["-l", ",".join(f"{k}={v}"
                                    for k, v in label_selector.items())]
        return json.loads(self._run(args)).get("items", [])

    def get(self, kind, namespace, name):
        try:
            return json.loads(
                self._run(["get", kind, name, "-n", namespace, "-o", "json"])
            )
        except KeyError:
            return None

    def create(self, obj):
        self._run(["create", "-f", "-"], stdin=json.dumps(obj))

    def replace(self, obj):
        # server-side apply, not PUT: a freshly rendered Service carries no
        # clusterIP/resourceVersion and a bare replace would be rejected
        # ("field is immutable"); apply merges onto the live object
        self._run(
            ["apply", "--server-side", "--force-conflicts", "-f", "-"],
            stdin=json.dumps(obj),
        )

    def delete(self, kind, namespace, name):
        self._run(["delete", kind, name, "-n", namespace, "--wait=false"])

    def patch_status(self, kind, namespace, name, status):
        self._run(
            ["patch", kind, name, "-n", namespace, "--subresource=status",
             "--type=merge", "-p", json.dumps({"status": status})]
        )


def _config_hash(obj: dict) -> str:
    """Content hash over everything but status/annotations-hash — the
    convergence test (the reference compared generated vs live specs
    field-by-field; a hash of our own rendering is equivalent and cheap)."""
    trimmed = copy.deepcopy(obj)
    trimmed.pop("status", None)
    md = trimmed.get("metadata", {})
    md.get("annotations", {}).pop(HASH_ANNOTATION, None)
    return hashlib.sha256(
        json.dumps(trimmed, sort_keys=True).encode()
    ).hexdigest()[:16]


class Reconciler:
    """Converge owned resources on each SeldonDeployment CR."""

    def __init__(self, client: KubeClient, namespace: str = "default",
                 engine_image: str = "",
                 engine_env: Optional[Dict[str, str]] = None,
                 rollouts=None, autoscaler=None):
        # engine_image/engine_env: the chart-level engine knobs
        # (bundle.py values.engine) flowing into every rendered engine pod,
        # the reference's ENGINE_CONTAINER_IMAGE_AND_VERSION property role
        self.client = client
        self.namespace = namespace
        self.engine_image = engine_image
        self.engine_env = dict(engine_env or {})
        #: optional RolloutController (operator/rollouts.py): CRs
        #: annotated ``seldon.io/canary`` get staged traffic shifts with
        #: gate-checked auto-rollback, driven one tick per reconcile and
        #: written back onto the CR status as ``status.rollout``
        self.rollouts = rollouts
        #: optional ScaleAheadPlanner (operator/scaleahead.py): CRs
        #: annotated ``seldon.io/autoscale`` get their rendered engine
        #: Deployments' spec.replicas written from the planner's
        #: queue-growth forecast — scale-out lands ahead of the 5m burn
        #: window, scale-in is gated on the rollout controller
        self.autoscaler = autoscaler
        self._autoscale_status: Dict[str, dict] = {}

    # -- CRD bootstrap ---------------------------------------------------

    def ensure_crd(self) -> bool:
        """Register the SeldonDeployment CRD if absent (CRDCreator.java's
        boot path).  Returns True when it had to be created.

        CRDs are cluster-scoped: the lookup must use the same namespace
        key the (namespace-less) SELDON_CRD manifest stores under, NOT
        this reconciler's working namespace — kubectl ignores -n for
        cluster-scoped kinds, and the fake API defaults them to
        'default'."""
        existing = self.client.get(
            "CustomResourceDefinition", "default", CRD_NAME
        )
        if existing is not None:
            return False
        self.client.create(copy.deepcopy(SELDON_CRD))
        return True

    # -- one CR ------------------------------------------------------------

    def _desired(self, cr: dict) -> List[dict]:
        spec = SeldonDeploymentSpec.from_json_dict(cr)
        manifests = generate_manifests(
            spec, engine_image=self.engine_image, engine_env=self.engine_env
        )
        name = cr.get("metadata", {}).get("name", spec.name)
        uid = cr.get("metadata", {}).get("uid", "")
        # predictive scale-ahead BEFORE hashing: the replica override is
        # part of the desired state, so convergence sees it like any
        # other spec change (steady forecast = steady hash = zero writes)
        self._apply_autoscale(spec, name, manifests)
        for m in manifests:
            md = m.setdefault("metadata", {})
            md["namespace"] = self.namespace
            md.setdefault("labels", {})[OWNER_LABEL] = name
            # ownerReferences: the cluster GC's prune contract; our own
            # prune pass below covers API servers without GC (fake, tests)
            md["ownerReferences"] = [
                {
                    "apiVersion": f"{GROUP}/v1alpha2",
                    "kind": "SeldonDeployment",
                    "name": name,
                    "uid": uid,
                    "controller": True,
                }
            ]
            md.setdefault("annotations", {})[HASH_ANNOTATION] = \
                _config_hash(m)
        return manifests

    def reconcile(self, cr: dict) -> Dict[str, int]:
        """One convergence pass for one CR.  Returns the verb counts
        (creates/updates/deletes) so callers and tests can see the work."""
        name = cr.get("metadata", {}).get("name", "")
        try:
            desired = self._desired(cr)
        except Exception as e:
            # invalid spec: surface on the CR like the reference's FAILED
            # state (SeldonDeploymentStatusUpdateImpl failure path).  The
            # permissive CRD schema admits arbitrary JSON, so ANY parse/
            # render error must land here — one malformed CR must never
            # take down reconciliation for the rest of the cluster
            self._patch_cr_status(name, {
                "state": "Failed",
                "description": f"{type(e).__name__}: {e}",
            })
            return {"creates": 0, "updates": 0, "deletes": 0, "failed": 1}
        counts = {"creates": 0, "updates": 0, "deletes": 0}
        desired_keys = set()
        for m in desired:
            kind, _, res_name = _meta(m)
            desired_keys.add((kind, res_name))
            live = self.client.get(kind, self.namespace, res_name)
            if live is None:
                try:
                    self.client.create(m)
                    counts["creates"] += 1
                except KeyError:
                    # lost a create race (another controller/kubelet actor
                    # landed it between our GET miss and the POST) —
                    # converge onto the racer's object in the same pass
                    # (the reference's CREATE(404)-vs-UPDATE split,
                    # SeldonDeploymentControllerImpl.java:69-111)
                    try:
                        self._replace_converged(m)
                        counts["updates"] += 1
                    except KeyError:
                        # racer's object vanished again before our replace
                        # (create-then-delete churn): take the create path
                        self.client.create(m)
                        counts["creates"] += 1
                continue
            live_hash = (
                live.get("metadata", {}).get("annotations", {})
                .get(HASH_ANNOTATION)
            )
            if live_hash != m["metadata"]["annotations"][HASH_ANNOTATION]:
                try:
                    self._replace_converged(m)
                    counts["updates"] += 1
                except KeyError:
                    # deleted under us mid-pass: recreate
                    self.client.create(m)
                    counts["creates"] += 1
        # prune: owned resources no longer rendered (removed predictors /
        # components) — SeldonDeploymentControllerImpl's removeDeployments
        for kind in ("Deployment", "Service"):
            for live in self.client.list(
                kind, self.namespace, {OWNER_LABEL: name}
            ):
                _, _, res_name = _meta(live)
                if (kind, res_name) not in desired_keys:
                    self.client.delete(kind, self.namespace, res_name)
                    counts["deletes"] += 1
        self._update_status(
            name, rollout=self._reconcile_rollout(cr),
            autoscale=self._autoscale_status.get(name),
        )
        return counts

    def _apply_autoscale(self, spec, name: str,
                         manifests: List[dict]) -> None:
        """Override rendered engine Deployments' ``spec.replicas`` with
        the scale-ahead planner's decision (operator/scaleahead.py).
        No-op without a planner or the ``seldon.io/autoscale``
        annotation; a malformed annotation raises (the caller surfaces
        it as a Failed CR, same contract as a malformed graph)."""
        self._autoscale_status.pop(name, None)
        if self.autoscaler is None:
            return
        from seldon_core_tpu_torch.operator.scaleahead import AutoscalePolicy

        policy = AutoscalePolicy.from_spec(spec)  # raises on malformed
        if policy is None:
            return
        # a live canary gates scale-IN: shrinking the fleet mid-rollout
        # would let a capacity cut mask (or masquerade as) a candidate
        # regression.  Scale-out stays allowed — a rollout under load
        # needs capacity more, not less.
        rollout_active = False
        if self.rollouts is not None:
            block = self.rollouts.status_block(name)
            rollout_active = bool(
                block and block.get("state") in ("pending", "running")
            )
        decisions = []
        for m in manifests:
            if m.get("kind") != "Deployment":
                continue
            if m.get("metadata", {}).get("labels", {}).get(
                    "seldon-type") != "engine":
                continue  # component pods scale with their own story
            # "current" is the LIVE Deployment's count — the previous
            # autoscale decision — not the freshly rendered CR baseline:
            # judging scale-in against the baseline would reset an 8-
            # replica fleet to the CR's 1 in a single tick with neither
            # the hysteresis nor the rollout gate ever seeing a
            # want < current transition
            current = int(m.get("spec", {}).get("replicas", 1))
            live = self.client.get(
                "Deployment", self.namespace,
                m.get("metadata", {}).get("name", ""),
            )
            if live is not None:
                current = int(
                    live.get("spec", {}).get("replicas", current))
            decision = self.autoscaler.desired_replicas(
                name, current, policy, rollout_active=rollout_active,
            )
            m["spec"]["replicas"] = decision["desired_replicas"]
            decisions.append({
                "deployment": m["metadata"].get("name", ""),
                "current_replicas": decision["current_replicas"],
                "desired_replicas": decision["desired_replicas"],
                "reason": decision["reason"],
                # integer-rounded so a steady load reads as an unchanged
                # status (the write-suppression gate compares values)
                "load_now": int(round(decision["load_now"])),
                "load_forecast": int(round(decision["load_forecast"])),
            })
        if decisions:
            self._autoscale_status[name] = {
                "enabled": True,
                "rollout_gated": rollout_active,
                "decisions": decisions,
            }

    def _reconcile_rollout(self, cr: dict) -> Optional[dict]:
        """One rollout-controller tick for an annotated CR: desired-state
        intake (idempotent; the CR's config hash is the quarantine
        identity) then a stage decision.  Returns the status block to
        write back, None when no controller is wired or the CR doesn't
        opt in."""
        if self.rollouts is None:
            return None
        from seldon_core_tpu_torch.operator.rollouts import plan_from_annotations

        try:
            spec = SeldonDeploymentSpec.from_json_dict(cr)
            # hash over the CR spec only — status/annotation churn (our
            # own write-backs included) must not read as "spec changed"
            # and reopen a quarantine
            plan = plan_from_annotations(
                spec, config_hash=_config_hash({"spec": cr.get("spec")})
            )
        except Exception as e:
            return {"state": "invalid",
                    "error": f"{type(e).__name__}: {e}"}
        if plan is None:
            return None
        self.rollouts.apply(plan)
        self.rollouts.tick_deployment(plan.deployment)
        return self.rollouts.status_block(plan.deployment)

    def _replace_converged(self, m: dict, retries: int = 2) -> None:
        """Replace with 409 resolution: our rendering is authoritative for
        owned resources, so a conflict just means the live resourceVersion
        moved — re-issue the (version-less, server-side-apply-like) write.
        Bounded retries: a persistently conflicting object surfaces as an
        error rather than a livelock."""
        for attempt in range(retries + 1):
            try:
                self.client.replace(m)
                return
            except KubeConflict:
                if attempt == retries:
                    raise
                # refresh our view; the next write supersedes the racer's
                kind, _, res_name = _meta(m)
                if self.client.get(kind, self.namespace, res_name) is None:
                    raise KeyError(f"not found: {res_name}")

    def reconcile_deleted(self, name: str) -> int:
        """CR removed: prune everything it owned."""
        if self.rollouts is not None:
            # the quarantine dies with the CR — a re-created deployment
            # is a new spec by definition
            self.rollouts.forget(name)
        deleted = 0
        for kind in ("Deployment", "Service"):
            for live in self.client.list(
                kind, self.namespace, {OWNER_LABEL: name}
            ):
                _, _, res_name = _meta(live)
                self.client.delete(kind, self.namespace, res_name)
                deleted += 1
        return deleted

    # -- status ------------------------------------------------------------

    def _update_status(self, name: str,
                       rollout: Optional[dict] = None,
                       autoscale: Optional[dict] = None) -> None:
        """CR status from observed Deployment readiness — the write-back
        half (SeldonDeploymentStatusUpdateImpl.java:49-104) — plus the
        rollout controller's state for canary-annotated CRs."""
        deployments = self.client.list(
            "Deployment", self.namespace, {OWNER_LABEL: name}
        )
        predictor_status = []
        available = bool(deployments)
        for d in deployments:
            want = d.get("spec", {}).get("replicas", 1)
            ready = d.get("status", {}).get("readyReplicas", 0)
            predictor_status.append({
                "name": d["metadata"]["name"],
                "replicas": want,
                "replicasAvailable": ready,
            })
            if ready < want:
                available = False
        status = {
            "state": "Available" if available else "Creating",
            "predictorStatus": sorted(
                predictor_status, key=lambda p: p["name"]
            ),
        }
        if rollout is not None:
            status["rollout"] = rollout
        if autoscale is not None:
            # decision timestamps are stripped for write-suppression: a
            # steady decision must read as an unchanged status
            status["autoscale"] = autoscale
        self._patch_cr_status(name, status)

    def _patch_cr_status(self, name: str, status: dict) -> None:
        # write-suppression: a status patch bumps the CR's resourceVersion,
        # so patching an unchanged status every tick turns the steady state
        # into a write loop (and retriggers level-based watchers cluster-
        # wide).  Compare against the live status first.
        live = self.client.get("SeldonDeployment", self.namespace, name)
        if live is None:
            return  # CR deleted mid-reconcile: nothing to write back to
        live_status = live.get("status", {})
        if all(live_status.get(k) == v for k, v in status.items()):
            return
        try:
            self.client.patch_status(
                "SeldonDeployment", self.namespace, name, status
            )
        except KeyError:
            pass  # CR deleted between the read and the patch
        except KubeConflict:
            # another writer bumped the CR between read and patch; one
            # retry — status is derived state, next tick rewrites it anyway
            try:
                self.client.patch_status(
                    "SeldonDeployment", self.namespace, name, status
                )
            except (KeyError, KubeConflict):
                pass

    # -- control loop --------------------------------------------------------

    def run_once(self) -> Dict[str, Dict[str, int]]:
        """LIST all CRs, reconcile each, prune orphans of deleted CRs —
        one tick of the reference's watch-driven controller, poll-driven
        the way materializer.watch_dir already is."""
        crs = self.client.list("SeldonDeployment", self.namespace)
        seen = set()
        results = {}
        for cr in crs:
            name = cr.get("metadata", {}).get("name", "")
            seen.add(name)
            try:
                results[name] = self.reconcile(cr)
            except Exception as e:  # API flake mid-reconcile: isolate the CR
                results[name] = {
                    "creates": 0, "updates": 0, "deletes": 0, "failed": 1,
                    "error": f"{type(e).__name__}: {e}",
                }
        # resources whose owning CR is gone
        owners = set()
        for kind in ("Deployment", "Service"):
            for live in self.client.list(kind, self.namespace):
                owner = (
                    live.get("metadata", {}).get("labels", {})
                    .get(OWNER_LABEL)
                )
                if owner:
                    owners.add(owner)
        for orphan in owners - seen:
            results[orphan] = {
                "creates": 0, "updates": 0,
                "deletes": self.reconcile_deleted(orphan),
            }
        return results


def main(argv=None) -> None:
    """Operator process: CRD bootstrap then the poll-reconcile loop.

        python -m seldon_core_tpu_torch.operator.reconciler \
            [--namespace default] [--interval 10] [--once]
    """
    import argparse
    import time

    parser = argparse.ArgumentParser(description="seldon_core_tpu_torch operator")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--interval", type=float, default=10.0)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--kubectl", default="kubectl",
                        help="kubectl binary for the cluster client")
    args = parser.parse_args(argv)
    import os

    engine_env = {}
    raw = os.environ.get("SELDON_ENGINE_ENV", "")
    if raw.strip():
        engine_env = {str(k): str(v) for k, v in json.loads(raw).items()}
    rec = Reconciler(
        KubectlClient(args.kubectl), namespace=args.namespace,
        engine_image=os.environ.get("SELDON_ENGINE_IMAGE", ""),
        engine_env=engine_env,
    )
    if rec.ensure_crd():
        print(f"registered CRD {CRD_NAME}", flush=True)
    while True:
        results = rec.run_once()
        work = {k: v for k, v in results.items()
                if any(v.get(x) for x in ("creates", "updates", "deletes",
                                          "failed"))}
        if work:
            print(json.dumps(work), flush=True)
        if args.once:
            return
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
