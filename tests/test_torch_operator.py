"""The port's operator (seldon_core_tpu_torch/operator/{materializer,reconciler,
scaleahead}.py) against the JAX package's, on the CPU.

  * the materializer: the reference's five cases (apply, status and delete
    behind the port's gateway store; an invalid spec refused; the watch loop's
    ADDED/MODIFIED/DELETED; supervise's restarts and backoff; the status
    files), with engines on the CPU and one real port microservice spawned
    with ``--device cpu`` (a module-scoped fixture);
  * the reconciler: the reference's cases of tests/test_reconciler.py and
    tests/test_reconciler_conflicts.py on the port's ``FakeKubeApi`` and
    ``HostileKubeApi``, tests/test_kubectl_replay.py's three on its scripted
    ``kubectl`` (and the port's transcript has the JAX client's argv
    sequence); for every example the port's desired objects equal the JAX
    reconciler's once the hash annotation is dropped and the accelerator
    mapped, and the rollout's spec hash is the same string in both;
  * scale-ahead: the planner and reconciler cases of tests/test_qos.py, and
    ``forecast`` / ``desired_replicas`` equal to the JAX planner's over one
    seeded sample sequence."""

import asyncio
import copy
import glob
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seldon_core_tpu_torch.gateway.apife import AuthError
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec
from seldon_core_tpu_torch.operator.materializer import Materializer, _UnitProc
from seldon_core_tpu_torch.operator.reconciler import (
    CRD_NAME,
    HASH_ANNOTATION,
    FakeKubeApi,
    HostileKubeApi,
    KubeConflict,
    KubectlClient,
    OWNER_LABEL,
    Reconciler,
    _config_hash,
)
from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
from tests.test_kubectl_replay import CR, FAKE_KUBECTL, read_transcript, seed_cr
from tests.test_torch_manifests import _mapped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
RESOURCES = os.path.join(ROOT, "tests", "resources")


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


# ---------------------------------------------------------------------------
# materializer (tests/test_gateway_operator.py:212-342)
# ---------------------------------------------------------------------------


def two_predictor_spec(name="canary-dep", main_replicas=3, canary_replicas=1):
    """Main + canary predictors — the reference's canary pattern."""

    def predictor(pname, seed, replicas):
        return {"name": pname, "replicas": replicas,
                "components": [{"name": "m", "runtime": "inprocess",
                                "class_path": "MnistClassifier",
                                "parameters": [
                                    {"name": "hidden", "value": "32", "type": "INT"},
                                    {"name": "seed", "value": str(seed), "type": "INT"}]}],
                "graph": {"name": "m", "type": "MODEL"}}

    return SeldonDeploymentSpec.from_json_dict({"spec": {
        "name": name, "oauth_key": "key1", "oauth_secret": "secret1",
        "predictors": [predictor("main", 0, main_replicas),
                       predictor("canary", 1, canary_replicas)]}})


def test_materializer_apply_status_delete():
    mat = Materializer(spawn_units=False, device="cpu")
    spec = two_predictor_spec(name="dep-a")
    md = mat.apply(spec)
    assert set(md.engines) == {"main", "canary"}
    assert all(e.device.type == "cpu" for e in md.engines.values())
    st = mat.status("dep-a")
    assert st["state"] == "Available"
    assert st["predictorStatus"][0] == {"name": "main", "replicas": 3, "replicasAvailable": 3}
    # gateway store was wired
    token = mat.store.issue_token("key1", "secret1")
    assert mat.store.principal_for_token(token).deployment_id == "dep-a"
    mat.delete("dep-a")
    assert mat.status("dep-a") == {"state": "absent"}
    with pytest.raises(AuthError):
        mat.store.principal_for_token(token)


def test_materializer_rejects_invalid_spec():
    mat = Materializer(spawn_units=False, device="cpu")
    with open(os.path.join(RESOURCES, "model_invalid_graph.json")) as f:
        bad = SeldonDeploymentSpec.from_json(f.read())
    with pytest.raises(GraphSpecError):
        mat.apply(bad)
    assert bad.name not in mat.deployments


def test_materializer_defaults_to_the_card():
    """Without ``device`` the engines go on ``cuda``: on a machine without
    a card the apply raises, and nothing is registered."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU refusal cannot show here")
    mat = Materializer(spawn_units=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mat.apply(two_predictor_spec(name="dep-c"))
    assert "dep-c" not in mat.deployments


def test_materializer_watch_dir(tmp_path):
    async def run():
        mat = Materializer(spawn_units=False, device="cpu")
        spec_file = tmp_path / "dep.json"
        spec_file.write_text(json.dumps(two_predictor_spec(name="dep-w").to_json_dict()))

        t = asyncio.create_task(mat.watch_dir(str(tmp_path), interval_s=0.05))
        await asyncio.sleep(0.3)
        assert "dep-w" in mat.deployments  # ADDED

        # unchanged file across many ticks -> no re-apply (mtime dedup)
        applied_at = mat.deployments["dep-w"].applied_at
        await asyncio.sleep(0.3)
        assert mat.deployments["dep-w"].applied_at == applied_at

        # modified file -> re-apply
        spec_file.write_text(
            json.dumps(two_predictor_spec(name="dep-w", main_replicas=5).to_json_dict()))
        os.utime(spec_file, (applied_at + 10, applied_at + 10))
        await asyncio.sleep(0.3)
        assert mat.deployments["dep-w"].spec.predictor("main").replicas == 5

        # file removed -> deployment deleted (ownerReference GC)
        spec_file.unlink()
        await asyncio.sleep(0.3)
        assert "dep-w" not in mat.deployments
        t.cancel()

    asyncio.run(run())


def test_materializer_supervise_restarts_dead_units(tmp_path):
    """The reference leans on kubelet restart policy; the local materializer
    must supervise its own unit subprocesses (SURVEY.md 2.7 elasticity)."""
    from seldon_core_tpu_torch.graph.spec import ComponentBinding

    m = Materializer(spawn_units=False, device="cpu")
    spec = SeldonDeploymentSpec.from_json_dict({"spec": {"name": "sup", "predictors": [{
        "name": "p",
        "graph": {"name": "m0", "implementation": "SIMPLE_MODEL", "type": "MODEL"}}]}})
    md = m.apply(spec)
    # attach a fake unit process that dies immediately
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    binding = ComponentBinding(name="u0", runtime="rest", class_path="MnistClassifier", port=0)
    proc = _UnitProc(name="u0", popen=dead, port=0, binding=binding,
                     predictor_id="p", deployment_id="sup")
    # patch _spawn_unit so no real server starts
    spawned = []

    def fake_spawn(b, pid, did):
        live = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
        spawned.append(live)
        return _UnitProc(name=b.name, popen=live, port=0, binding=b,
                         predictor_id=pid, deployment_id=did)

    m._spawn_unit = fake_spawn
    md.unit_procs.append(proc)
    try:
        assert m.status("sup")["state"] == "Degraded"
        assert m.supervise() == 1
        assert proc.restarts == 1
        assert proc.popen.poll() is None  # replaced by a live process
        assert m.status("sup")["state"] == "Available"
        assert m.status("sup")["unitRestarts"] == 1
        # backoff: immediate second death doesn't restart instantly
        proc.popen.terminate()
        proc.popen.wait()
        assert m.supervise() == 0
    finally:
        for p in spawned:
            p.terminate()
            p.wait()
        m.shutdown()


def test_watch_dir_writes_status_files(tmp_path):
    m = Materializer(spawn_units=False, device="cpu")
    spec = {"spec": {"name": "st", "predictors": [{
        "name": "p", "graph": {"name": "m0", "implementation": "SIMPLE_MODEL", "type": "MODEL"}}]}}
    f = tmp_path / "st.json"
    f.write_text(json.dumps(spec))
    asyncio.run(m.watch_dir(str(tmp_path), once=True))
    try:
        status = json.loads((tmp_path / "st.json.status").read_text())
        assert status["state"] == "Available"
        assert status["predictorStatus"][0]["name"] == "p"
    finally:
        m.shutdown()


def rest_unit_spec(name: str, port: int) -> dict:
    """One ``runtime: "rest"`` MnistClassifier binding (hidden 32)."""
    return {"spec": {"name": name, "oauth_key": name, "oauth_secret": "s", "predictors": [{
        "name": "p", "graph": {"name": "m", "type": "MODEL"},
        "components": [{"name": "m", "runtime": "rest", "class_path": "MnistClassifier",
                        "port": port,
                        "parameters": [{"name": "hidden", "value": "32", "type": "INT"},
                                       {"name": "seed", "value": "3", "type": "INT"}]}]}]}}


@pytest.fixture(scope="module")
def spawned_unit():
    """One materializer that has spawned a real port microservice with
    ``--device cpu`` (applied once for the module)."""
    reset_learned_singletons()
    m = Materializer(device="cpu")
    port = _free_port()
    md = m.apply(SeldonDeploymentSpec.from_json_dict(rest_unit_spec("spawned", port)))
    try:
        yield m, md, port
    finally:
        m.shutdown()


def test_materializer_spawns_the_ports_microservice(spawned_unit):
    """The spawned unit is the port's microservice on the CPU: the engine's
    answers through it are the unit's own (built as the microservice builds
    it, in this process); it dies as a process, turns the status Degraded,
    and ``supervise`` restarts it after the backoff."""
    import torch

    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.microservice import build_runtime

    m, md, port = spawned_unit
    [proc] = md.unit_procs
    argv = proc.popen.args
    assert argv[1:4] == ["-m", "seldon_core_tpu_torch.runtime.microservice", "MnistClassifier"]
    assert argv[-2:] == ["--device", "cpu"]
    assert m.status("spawned")["state"] == "Available"
    params = [Parameter.from_json_dict(p)
              for p in json.loads(proc.binding.env["PREDICTIVE_UNIT_PARAMETERS"])]
    twin = build_runtime("MnistClassifier", "MODEL", params, device=torch.device("cpu"))
    x = np.random.default_rng(0).random((2, 784))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)

    async def both():
        got = await md.engines["p"].predict(SeldonMessage.from_array(x))
        want = await twin.predict(SeldonMessage.from_array(x))
        return got, want

    try:
        got, want = asyncio.run(both())
    finally:
        torch.set_num_threads(prev)
    assert got.status is None or got.status.status != "FAILURE", got.status
    np.testing.assert_allclose(np.asarray(got.array()), np.asarray(want.array()), atol=1e-5)
    proc.popen.kill()
    proc.popen.wait()
    assert m.status("spawned")["state"] == "Degraded"
    proc.last_restart = time.time()
    assert m.supervise() == 0  # inside the backoff
    proc.last_restart -= 2.0
    assert m.supervise() == 1
    assert m.status("spawned") == {"state": "Available", "predictorStatus": [
        {"name": "p", "replicas": 1, "replicasAvailable": 1}], "unitRestarts": 1}
    m._await_unit(proc)


def test_a_unit_that_fails_to_start_leaves_the_status_degraded(tmp_path):
    """A unit whose process exits before it serves (here an unknown class)
    fails the apply and leaves the deployment registered as Degraded; the
    watch loop writes that status."""
    doc = rest_unit_spec("broken", _free_port())
    doc["spec"]["predictors"][0]["components"][0]["class_path"] = "no.such:Unit"
    (tmp_path / "broken.json").write_text(json.dumps(doc))
    m = Materializer(device="cpu")
    try:
        asyncio.run(m.watch_dir(str(tmp_path), once=True))
        status = json.loads((tmp_path / "broken.json.status").read_text())
        assert status["state"] == "Degraded"
        with pytest.raises(RuntimeError, match="exited with code"):
            m.apply(SeldonDeploymentSpec.from_json_dict(doc))
        assert m.status("broken")["state"] == "Degraded"
    finally:
        m.shutdown()


# ---------------------------------------------------------------------------
# reconciler (tests/test_reconciler.py)
# ---------------------------------------------------------------------------


def load_example(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return json.load(f)


def make_cr(doc, name=None):
    cr = copy.deepcopy(doc)
    md = cr.setdefault("metadata", {})
    if name:
        md["name"] = name
    md.setdefault("name", "cr")
    md.setdefault("namespace", "default")
    cr.setdefault("kind", "SeldonDeployment")
    return cr


@pytest.fixture()
def api():
    return FakeKubeApi()


@pytest.fixture()
def rec(api):
    return Reconciler(api)


def test_crd_bootstrap_idempotent(api, rec):
    assert rec.ensure_crd() is True
    assert api.get("CustomResourceDefinition", "default", CRD_NAME)
    assert rec.ensure_crd() is False  # second boot: already registered
    crd = api.get("CustomResourceDefinition", "default", CRD_NAME)
    version = crd["spec"]["versions"][0]
    assert version["subresources"] == {"status": {}}


def test_apply_create_status_and_converge(api, rec):
    cr = make_cr(load_example("iris_deployment.json"), "iris")
    api.create(cr)
    results = rec.run_once()
    assert results["iris"]["creates"] >= 2  # engine Deployment + Service
    deployments = api.list("Deployment", "default", {OWNER_LABEL: "iris"})
    assert len(deployments) == 1
    owner = deployments[0]["metadata"]["ownerReferences"][0]
    assert owner["kind"] == "SeldonDeployment" and owner["name"] == "iris"
    # not ready yet -> Creating
    status = api.get("SeldonDeployment", "default", "iris")["status"]
    assert status["state"] == "Creating"
    assert status["predictorStatus"][0]["replicasAvailable"] == 0
    # kubelet converges -> Available with replica counts
    api.mark_deployments_ready()
    rec.run_once()
    status = api.get("SeldonDeployment", "default", "iris")["status"]
    assert status["state"] == "Available"
    ps = status["predictorStatus"][0]
    assert ps["replicasAvailable"] == ps["replicas"] >= 1


def test_steady_state_issues_no_writes(api, rec):
    api.create(make_cr(load_example("iris_deployment.json"), "iris"))
    rec.run_once()
    api.mark_deployments_ready()
    rec.run_once()
    api.clear_ops()
    rec.run_once()
    writes = [op for op in api.ops
              if op[0] in ("create", "replace", "delete")]
    assert writes == []  # converged: zero resource mutations per tick


def test_spec_change_triggers_update(api, rec):
    cr = make_cr(load_example("iris_deployment.json"), "iris")
    api.create(cr)
    rec.run_once()
    api.clear_ops()
    changed = copy.deepcopy(api.get("SeldonDeployment", "default", "iris"))
    changed["spec"]["predictors"][0]["replicas"] = 3
    api.replace(changed)
    api.clear_ops()
    results = rec.run_once()
    assert results["iris"]["updates"] >= 1
    dep = api.list("Deployment", "default", {OWNER_LABEL: "iris"})[0]
    assert dep["spec"]["replicas"] == 3


def test_shrinking_graph_prunes_resources(api, rec):
    # 4-member remote-runtime ensemble -> single model: the orphaned
    # component Deployments/Services must be deleted
    cr = make_cr(load_example("ensemble4_deployment.json"), "ens")
    api.create(cr)
    rec.run_once()
    n_before = len(api.list("Deployment", "default", {OWNER_LABEL: "ens"}))
    single = make_cr(load_example("iris_deployment.json"), "ens")
    api.replace(single)
    results = rec.run_once()
    n_after = len(api.list("Deployment", "default", {OWNER_LABEL: "ens"}))
    if n_before > 1:
        assert results["ens"]["deletes"] >= 1
        assert n_after < n_before
    assert n_after >= 1


def test_deleted_cr_prunes_everything(api, rec):
    api.create(make_cr(load_example("iris_deployment.json"), "iris"))
    rec.run_once()
    assert api.list("Deployment", "default", {OWNER_LABEL: "iris"})
    api.delete("SeldonDeployment", "default", "iris")
    results = rec.run_once()
    assert results["iris"]["deletes"] >= 2
    assert not api.list("Deployment", "default", {OWNER_LABEL: "iris"})
    assert not api.list("Service", "default", {OWNER_LABEL: "iris"})


def test_invalid_spec_marks_cr_failed(api, rec):
    cr = make_cr({"spec": {"name": "bad", "predictors": []}}, "bad")
    api.create(cr)
    rec.run_once()
    status = api.get("SeldonDeployment", "default", "bad")["status"]
    assert status["state"] == "Failed"
    assert status["description"]


def test_every_example_reconciles_end_to_end(api, rec):
    rec.ensure_crd()
    names = []
    for i, path in enumerate(
        sorted(glob.glob(os.path.join(EXAMPLES, "*_deployment.json")))
    ):
        with open(path) as f:
            doc = json.load(f)
        name = f"ex{i}-{os.path.basename(path).split('_')[0]}"
        names.append(name)
        api.create(make_cr(doc, name))
    results = rec.run_once()
    for name in names:
        assert results[name].get("failed", 0) == 0, name
        assert api.list("Deployment", "default", {OWNER_LABEL: name}), name
        status = api.get("SeldonDeployment", "default", name)["status"]
        assert status["state"] == "Creating"
    api.mark_deployments_ready()
    rec.run_once()
    for name in names:
        status = api.get("SeldonDeployment", "default", name)["status"]
        assert status["state"] == "Available", name


# ---------------------------------------------------------------------------
# reconciler against a hostile API server (tests/test_reconciler_conflicts.py)
# ---------------------------------------------------------------------------


def load_cr(name="iris", example="iris_deployment.json"):
    cr = load_example(example)
    md = cr.setdefault("metadata", {})
    md["name"] = name
    md.setdefault("namespace", "default")
    cr.setdefault("kind", "SeldonDeployment")
    return cr



def converged(api, rec, name):
    """Steady-state check: a reconcile tick issues zero resource writes and
    every desired resource exists with a non-phantom hash."""
    api.clear_ops()
    rec.run_once()
    writes = [op for op in api.ops
              if op[0] in ("create", "replace", "delete")]
    assert writes == [], f"not converged: {writes}"
    for obj in api.list("Deployment", "default", {OWNER_LABEL: name}):
        h = obj["metadata"]["annotations"].get(HASH_ANNOTATION)
        assert h and h != "phantom"


class TestHostileApi:
    @pytest.fixture()
    def api(self):
        return HostileKubeApi()

    @pytest.fixture()
    def rec(self, api):
        return Reconciler(api)

    # -- failure mode 1: create race -------------------------------------------

    def test_create_race_converges_same_pass(self, api, rec):
        """Another actor creates the engine Deployment between the reconciler's
        GET miss and its POST: the create's AlreadyExists must fall back to
        replace, converging in the SAME pass (no failed tick)."""
        api.create(load_cr())
        # discover the first rendered names with a throwaway reconcile on a
        # pristine clone, then arm the race for every one of them
        probe_api = HostileKubeApi()
        probe_api.create(load_cr())
        Reconciler(probe_api).run_once()
        for (kind, _, name) in list(probe_api.objects):
            if kind in ("Deployment", "Service"):
                api.race_on_get_miss.append((kind, name))

        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 0
        # every racer's phantom got replaced by the real rendering
        assert results["iris"]["updates"] >= 1
        converged(api, rec, "iris")


    # -- failure mode 2: stale-resourceVersion conflict on replace -------------

    def test_stale_rv_conflict_retried(self, api, rec):
        api.create(load_cr())
        rec.run_once()
        # change the spec so the next tick must replace, and inject a 409 on
        # the engine Deployment write
        cr = api.get("SeldonDeployment", "default", "iris")
        cr["spec"]["predictors"][0]["replicas"] = 3
        api.replace(cr)
        api.fail_queue.append(("replace", "Deployment/", KubeConflict("409")))
        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 0
        dep = api.list("Deployment", "default", {OWNER_LABEL: "iris"})[0]
        assert dep["spec"]["replicas"] == 3
        converged(api, rec, "iris")


    def test_persistent_conflict_isolates_cr_then_recovers(self, api, rec):
        """A conflict that outlives the retry budget fails the CR's tick
        without crashing the loop; the next clean tick converges."""
        api.create(load_cr())
        rec.run_once()
        cr = api.get("SeldonDeployment", "default", "iris")
        cr["spec"]["predictors"][0]["replicas"] = 5
        api.replace(cr)
        for _ in range(4):  # more than the retry budget
            api.fail_queue.append(("replace", "Deployment/", KubeConflict("409")))
        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 1
        api.fail_queue.clear()
        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 0
        dep = api.list("Deployment", "default", {OWNER_LABEL: "iris"})[0]
        assert dep["spec"]["replicas"] == 5
        converged(api, rec, "iris")


    # -- failure mode 3: resource deleted under the reconciler -----------------

    def test_resource_deleted_mid_pass_recreated(self, api, rec):
        """replace() hits NotFound because a hostile actor deleted the live
        object after the GET: the reconciler must fall back to create."""
        api.create(load_cr())
        rec.run_once()
        cr = api.get("SeldonDeployment", "default", "iris")
        cr["spec"]["predictors"][0]["replicas"] = 2
        api.replace(cr)
        dep_name = api.list(
            "Deployment", "default", {OWNER_LABEL: "iris"}
        )[0]["metadata"]["name"]

        # delete the Deployment between the reconciler's GET and its replace:
        # emulate by a fail hook that deletes then raises KeyError (NotFound)
        class Vanish(KeyError):
            pass

        del api.objects[("Deployment", "default", dep_name)]
        api.fail_queue.append(("replace", f"Deployment/{dep_name}",
                               Vanish("not found")))
        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 0
        dep = api.get("Deployment", "default", dep_name)
        assert dep is not None and dep["spec"]["replicas"] == 2
        converged(api, rec, "iris")


    # -- failure mode 4: CR deleted mid-reconcile ------------------------------

    def test_cr_deleted_mid_reconcile_no_crash_then_prune(self, api, rec):
        """The CR vanishes after rendering but before the status write-back:
        the tick must not crash, and the NEXT tick prunes every orphan."""
        api.create(load_cr())
        api.delete_crs_after_writes = 1  # vanish after the first created child
        results = rec.run_once()
        assert "iris" in results  # tick completed
        # owned resources exist but the CR is gone
        assert api.get("SeldonDeployment", "default", "iris") is None
        results = rec.run_once()
        assert results["iris"]["deletes"] >= 1
        assert api.list("Deployment", "default", {OWNER_LABEL: "iris"}) == []
        assert api.list("Service", "default", {OWNER_LABEL: "iris"}) == []


    # -- failure mode 5: status-patch conflict ---------------------------------

    def test_status_patch_conflict_retried(self, api, rec):
        api.create(load_cr())
        api.fail_queue.append(
            ("patch_status", "SeldonDeployment/iris", KubeConflict("409"))
        )
        results = rec.run_once()
        assert results["iris"].get("failed", 0) == 0
        status = api.get("SeldonDeployment", "default", "iris").get("status")
        assert status and status["state"] in ("Creating", "Available")


    # -- failure mode 6: transient API 500s ------------------------------------

    def test_transient_api_error_isolates_cr_and_recovers(self, api, rec):
        """An API flake mid-reconcile fails only that CR's tick (run_once's
        isolation contract) and the next tick converges with no orphans."""
        api.create(load_cr("a"))
        api.create(load_cr("b", "mnist_deployment.json"))
        api.fail_queue.append(("create", "Deployment/", RuntimeError("API 500")))
        results = rec.run_once()
        failed = [n for n, r in results.items() if r.get("failed")]
        ok = [n for n, r in results.items() if not r.get("failed")]
        assert len(failed) == 1 and len(ok) == 1  # isolation
        results = rec.run_once()
        assert all(not r.get("failed") for r in results.values())
        for name in ("a", "b"):
            assert api.list("Deployment", "default", {OWNER_LABEL: name})
            converged(api, rec, name)


    # -- steady state stays zero-write under RV bookkeeping --------------------

    def test_steady_state_zero_writes_including_status(self, api, rec):
        """With resourceVersions live, an unchanged status must NOT be patched
        every tick (each patch bumps the CR RV and would retrigger watchers) —
        total write silence at steady state."""
        api.create(load_cr())
        rec.run_once()
        api.mark_deployments_ready()
        rec.run_once()
        api.clear_ops()
        rec.run_once()
        writes = [op for op in api.ops
                  if op[0] in ("create", "replace", "delete", "patch_status")]
        assert writes == []


# ---------------------------------------------------------------------------
# KubectlClient against the scripted kubectl (tests/test_kubectl_replay.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    kubectl = tmp_path / "kubectl"
    kubectl.write_text(FAKE_KUBECTL)
    kubectl.chmod(0o755)
    state = tmp_path / "state.json"
    transcript = tmp_path / "transcript.jsonl"
    monkeypatch.setenv("FAKE_KUBE_STATE", str(state))
    monkeypatch.setenv("FAKE_KUBE_TRANSCRIPT", str(transcript))
    client = KubectlClient(kubectl=str(kubectl))
    return client, state, transcript


def test_full_lifecycle_transcript(cluster):
    client, state, transcript = cluster
    rec = Reconciler(client, namespace="default")

    # --- CRD bootstrap -----------------------------------------------------
    assert rec.ensure_crd() is True
    assert rec.ensure_crd() is False  # idempotent second boot
    tr = read_transcript(transcript)
    creates = [t for t in tr if t["argv"][0] == "create"]
    assert len(creates) == 1 and json.loads(
        creates[0]["stdin"])["metadata"]["name"] == CRD_NAME

    # --- CR appears: resources created ------------------------------------
    seed_cr(state, CR)
    results = rec.run_once()
    assert results["replay"]["creates"] >= 2  # Deployment + Service
    live = json.loads(state.read_text())
    kinds = sorted(k.split("/", 1)[0] for k in live)
    assert "Deployment" in kinds and "Service" in kinds
    # status written back through the REAL --subresource=status flag
    cr_live = live["SeldonDeployment/default/replay"]
    assert cr_live.get("status", {}).get("state")

    # --- steady state: ZERO writes -----------------------------------------
    before = len(read_transcript(transcript))
    results = rec.run_once()
    assert results["replay"] == {"creates": 0, "updates": 0, "deletes": 0}
    steady = read_transcript(transcript)[before:]
    write_verbs = [t["argv"][0] for t in steady
                   if t["argv"][0] in ("create", "apply", "delete")]
    assert write_verbs == [], f"steady state wrote: {write_verbs}"

    # --- spec change: server-side apply with the exact flag set ------------
    bumped = json.loads(json.dumps(CR))
    bumped["spec"]["predictors"][0]["replicas"] = 3
    seed_cr(state, bumped)
    before = len(read_transcript(transcript))
    results = rec.run_once()
    assert results["replay"]["updates"] >= 1
    applies = [t for t in read_transcript(transcript)[before:]
               if t["argv"][0] == "apply"]
    assert applies, "spec change produced no apply"
    for t in applies:
        assert "--server-side" in t["argv"]
        assert "--force-conflicts" in t["argv"]
    # the merged Deployment really carries the new replica count
    live = json.loads(state.read_text())
    deps = [v for k, v in live.items() if k.startswith("Deployment/")]
    assert any(d["spec"]["replicas"] == 3 for d in deps)

    # --- CR deleted: owned resources pruned --------------------------------
    doc = json.loads(state.read_text())
    del doc["SeldonDeployment/default/replay"]
    state.write_text(json.dumps(doc))
    results = rec.run_once()
    assert results["replay"]["deletes"] >= 2
    live = json.loads(state.read_text())
    assert not any(k.startswith(("Deployment/", "Service/")) for k in live)


def test_service_clusterip_immutability_respected(cluster):
    """A re-rendered Service (no clusterIP) must APPLY cleanly onto a live
    Service that has one — the exact failure a bare ``kubectl replace``
    hits on a real cluster (the reason KubectlClient uses server-side
    apply)."""
    client, state, transcript = cluster
    rec = Reconciler(client, namespace="default")
    rec.ensure_crd()
    seed_cr(state, CR)
    rec.run_once()
    # force a respec so every owned resource re-applies
    bumped = json.loads(json.dumps(CR))
    bumped["spec"]["predictors"][0]["annotations"] = {"rev": "2"}
    seed_cr(state, bumped)
    results = rec.run_once()
    assert results["replay"].get("failed", 0) == 0
    live = json.loads(state.read_text())
    svcs = [v for k, v in live.items() if k.startswith("Service/")]
    assert svcs and all(
        s["spec"].get("clusterIP") == "10.0.0.1" for s in svcs
    ), "server-side apply must preserve the live clusterIP"


def test_error_string_contract(cluster):
    """KubectlClient's stderr-string matching against the scripted
    apiserver wording: NotFound -> None/KeyError, AlreadyExists ->
    KeyError, unknown -> RuntimeError."""
    client, state, transcript = cluster
    assert client.get("Deployment", "default", "nope") is None
    with pytest.raises(KeyError):
        client.delete("Deployment", "default", "nope")
    client.create({"kind": "Deployment", "apiVersion": "apps/v1",
                   "metadata": {"name": "x", "namespace": "default"}})
    with pytest.raises(KeyError):
        client.create({"kind": "Deployment", "apiVersion": "apps/v1",
                       "metadata": {"name": "x", "namespace": "default"}})


# ---------------------------------------------------------------------------
# the port's reconciler against the JAX reconciler
# ---------------------------------------------------------------------------


def _lifecycle(client, state, rec_cls):
    """tests/test_kubectl_replay.py's lifecycle: CRD bootstrap, CR create,
    a steady tick, a spec bump, CR delete."""
    rec = rec_cls(client, namespace="default")
    rec.ensure_crd()
    rec.ensure_crd()
    seed_cr(state, CR)
    rec.run_once()
    rec.run_once()
    bumped = json.loads(json.dumps(CR))
    bumped["spec"]["predictors"][0]["replicas"] = 3
    seed_cr(state, bumped)
    rec.run_once()
    doc = json.loads(state.read_text())
    del doc["SeldonDeployment/default/replay"]
    state.write_text(json.dumps(doc))
    rec.run_once()


def test_kubectl_transcript_is_the_jax_clients(tmp_path, monkeypatch):
    """The same lifecycle through each package's KubectlClient and Reconciler
    calls the scripted kubectl with the same argv, in the same order."""
    from seldon_core_tpu.operator import reconciler as jrec

    argvs = {}
    for name, client_cls, rec_cls in (("jax", jrec.KubectlClient, jrec.Reconciler),
                                      ("torch", KubectlClient, Reconciler)):
        d = tmp_path / name
        d.mkdir()
        kubectl = d / "kubectl"
        kubectl.write_text(FAKE_KUBECTL)
        kubectl.chmod(0o755)
        monkeypatch.setenv("FAKE_KUBE_STATE", str(d / "state.json"))
        monkeypatch.setenv("FAKE_KUBE_TRANSCRIPT", str(d / "transcript.jsonl"))
        _lifecycle(client_cls(kubectl=str(kubectl)), d / "state.json", rec_cls)
        argvs[name] = [t["argv"] for t in read_transcript(str(d / "transcript.jsonl"))]
    assert len(argvs["torch"]) > 10
    assert argvs["torch"] == argvs["jax"]


def _unhashed(objs):
    out = copy.deepcopy(objs)
    for m in out:
        m["metadata"]["annotations"].pop(HASH_ANNOTATION)
    return out


EXAMPLE_FILES = sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(EXAMPLES, "*_deployment.json")))


@pytest.mark.parametrize("example", EXAMPLE_FILES)
def test_desired_objects_are_the_jax_reconcilers_mapped(example):
    """Every example's desired objects equal the JAX reconciler's once the
    hash annotation is dropped and the accelerator mapped (the hash covers
    the mapped fields, so it differs); the port's hash is its own rendering's."""
    from seldon_core_tpu.operator import reconciler as jrec

    cr = make_cr(load_example(example), "ex")
    cr["metadata"]["uid"] = "u-1"
    want = [_mapped(m) for m in _unhashed(jrec.Reconciler(jrec.FakeKubeApi())._desired(
        copy.deepcopy(cr)))]
    got = Reconciler(FakeKubeApi())._desired(copy.deepcopy(cr))
    assert _unhashed(got) == want
    for m in got:
        assert m["metadata"]["annotations"][HASH_ANNOTATION] == _config_hash(m)


def test_the_rollouts_spec_hash_is_the_jax_string():
    """The rollout's quarantine identity hashes the CR's spec alone: the same
    string in both packages, read off each reconciler's status write-back."""
    from seldon_core_tpu.gateway.apife import DeploymentStore as JStore
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
    from seldon_core_tpu.operator import reconciler as jrec
    from seldon_core_tpu.operator import rollouts as jro
    from seldon_core_tpu_torch.gateway.apife import DeploymentStore
    from seldon_core_tpu_torch.operator.rollouts import RolloutController

    cr = make_cr(load_example("canary_deployment.json"), "mnist-canary")
    cr["spec"]["annotations"] = {"seldon.io/canary": "canary", "seldon.io/canary-hold-s": "0"}
    hashes = []
    for store_cls, spec_cls, ctrl_cls, api_cls, rec_cls in (
            (JStore, JSpec, jro.RolloutController, jrec.FakeKubeApi, jrec.Reconciler),
            (DeploymentStore, SeldonDeploymentSpec, RolloutController, FakeKubeApi,
             Reconciler)):
        store = store_cls()
        store.register(spec_cls.from_json_dict(cr), {"main": "http://a", "canary": "http://b"})
        api = api_cls()
        api.create(copy.deepcopy(cr))
        rec_cls(api, rollouts=ctrl_cls(store, lambda plan: {"requests": 0})).run_once()
        hashes.append(api.get("SeldonDeployment", "default", "mnist-canary")
                      ["status"]["rollout"]["config_hash"])
    assert hashes[0] == hashes[1] == _config_hash({"spec": cr["spec"]})
    assert len(hashes[1]) == 16


def test_reconciler_main_reads_the_engine_knobs(monkeypatch, tmp_path):
    """``main`` builds the reconciler from ``SELDON_ENGINE_IMAGE`` and
    ``SELDON_ENGINE_ENV`` and registers the CRD through kubectl."""
    from seldon_core_tpu_torch.operator import reconciler as prec

    kubectl = tmp_path / "kubectl"
    kubectl.write_text(FAKE_KUBECTL)
    kubectl.chmod(0o755)
    state = tmp_path / "state.json"
    monkeypatch.setenv("FAKE_KUBE_STATE", str(state))
    monkeypatch.setenv("FAKE_KUBE_TRANSCRIPT", str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("SELDON_ENGINE_IMAGE", "eng:1")
    monkeypatch.setenv("SELDON_ENGINE_ENV", json.dumps({"ENGINE_MAX_BATCH": "64"}))
    seed_cr(state, CR)
    prec.main(["--once", "--kubectl", str(kubectl)])
    live = json.loads(state.read_text())
    [eng] = [v for k, v in live.items() if k.startswith("Deployment/")]
    c = eng["spec"]["template"]["spec"]["containers"][0]
    assert c["image"] == "eng:1"
    assert {"name": "ENGINE_MAX_BATCH", "value": "64"} in c["env"]
    assert f"CustomResourceDefinition/default/{CRD_NAME}" in live


# ---------------------------------------------------------------------------
# scale-ahead (tests/test_qos.py:615-931)
# ---------------------------------------------------------------------------



def test_planner_forecast_hand_math():
    from seldon_core_tpu_torch.operator.scaleahead import ScaleAheadPlanner

    p = ScaleAheadPlanner(now_fn=lambda: 0.0)
    # load 0 at t=0, 10 at t=10: slope exactly 1/s
    p.observe("d", queue_depth=0, now=0.0)
    p.observe("d", queue_depth=10, now=10.0)
    fc = p.forecast("d", horizon_s=30.0, now=10.0)
    assert fc["slope_per_s"] == pytest.approx(1.0)
    assert fc["current"] == 10.0
    assert fc["predicted"] == pytest.approx(40.0)
    # single sample: no trend, forecast = last observation
    p2 = ScaleAheadPlanner(now_fn=lambda: 0.0)
    p2.observe("d", queue_depth=7, now=0.0)
    assert p2.forecast("d", 300.0)["predicted"] == 7.0


def test_planner_scales_out_ahead_of_burn_and_gates_scale_in():
    from seldon_core_tpu_torch.operator.scaleahead import (
        AutoscalePolicy,
        ScaleAheadPlanner,
    )

    policy = AutoscalePolicy(min_replicas=1, max_replicas=8,
                             target_inflight=4.0, horizon_s=100.0)
    p = ScaleAheadPlanner(now_fn=lambda: 0.0)
    p.observe("d", queue_depth=2, now=0.0)
    p.observe("d", queue_depth=6, now=10.0)  # +0.4/s -> 46 at +100s
    d = p.desired_replicas("d", 1, policy)
    assert d["desired_replicas"] == 8  # ceil(46/4)=12, clamped to max
    assert d["reason"] == "queue-growth forecast"
    # load recedes -> scale-in ... unless a rollout is active
    p2 = ScaleAheadPlanner(now_fn=lambda: 0.0)
    p2.observe("d", queue_depth=2, now=0.0)
    p2.observe("d", queue_depth=2, now=10.0)
    gated = p2.desired_replicas("d", 6, policy, rollout_active=True)
    assert gated["desired_replicas"] == 6
    assert gated["reason"] == "scale-in rollout-gated"
    free = p2.desired_replicas("d", 6, policy, rollout_active=False)
    assert free["desired_replicas"] == 1
    assert free["reason"] == "load receded"


def test_planner_holds_fleet_on_missing_load_signal():
    """No samples = no signal, not 'idle': an operator restart or a dead
    scrape feed must hold the fleet at its current size, never write it
    down to min_replicas mid-overload."""
    from seldon_core_tpu_torch.operator.scaleahead import (
        AutoscalePolicy,
        ScaleAheadPlanner,
    )

    policy = AutoscalePolicy(min_replicas=1, max_replicas=8,
                             target_inflight=4.0, horizon_s=300.0)
    p = ScaleAheadPlanner(now_fn=lambda: 0.0)  # fresh: zero samples
    d = p.desired_replicas("d", 8, policy)
    assert d["desired_replicas"] == 8
    assert d["reason"] == "no load signal (hold)"


def test_planner_scale_in_hysteresis_holds_at_the_boundary():
    from seldon_core_tpu_torch.operator.scaleahead import (
        AutoscalePolicy,
        ScaleAheadPlanner,
    )

    policy = AutoscalePolicy(target_inflight=4.0, horizon_s=10.0,
                             max_replicas=8)
    p = ScaleAheadPlanner(now_fn=lambda: 0.0)
    # steady load 7.0: want = ceil(7/4) = 2, but 2 replicas' margin
    # capacity is 2*4*0.85 = 6.8 < 7 -> hold the 3rd replica
    p.observe("d", queue_depth=7, now=0.0)
    p.observe("d", queue_depth=7, now=10.0)
    d = p.desired_replicas("d", 3, policy)
    assert d["desired_replicas"] == 3
    assert d["reason"] == "scale-in hysteresis"


def test_reconciler_writes_replicas_ahead_of_burn():
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler
    from seldon_core_tpu_torch.operator.scaleahead import ScaleAheadPlanner

    planner = ScaleAheadPlanner(now_fn=lambda: 0.0)
    api = FakeKubeApi()
    rec = Reconciler(api, autoscaler=planner)
    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "dep", "namespace": "default"},
        "spec": {
            "name": "dep",
            "annotations": {
                "seldon.io/autoscale": "true",
                "seldon.io/autoscale-max": "6",
                "seldon.io/autoscale-target-inflight": "4",
            },
            "predictors": [{
                "name": "p", "replicas": 1,
                "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
            }],
        },
    }
    api.create(cr)
    for t, load in ((0.0, 2), (10.0, 10), (20.0, 20)):
        planner.observe("dep", queue_depth=load, now=t)
    rec.reconcile(api.get("SeldonDeployment", "default", "dep"))
    dep = api.get("Deployment", "default", "dep-p-engine")
    assert dep["spec"]["replicas"] == 6  # written BEFORE any burn
    status = api.get("SeldonDeployment", "default", "dep")["status"]
    assert status["autoscale"]["decisions"][0]["reason"] \
        == "queue-growth forecast"
    # steady state: a second reconcile with the same forecast is
    # convergent (hash unchanged -> no Deployment writes)
    api.clear_ops()
    rec.reconcile(api.get("SeldonDeployment", "default", "dep"))
    assert not any(op == "replace" and "Deployment" in ident
                   for op, ident in api.ops)


def test_reconciler_malformed_autoscale_annotation_fails_cr():
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler
    from seldon_core_tpu_torch.operator.scaleahead import ScaleAheadPlanner

    api = FakeKubeApi()
    rec = Reconciler(api, autoscaler=ScaleAheadPlanner())
    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "bad", "namespace": "default"},
        "spec": {
            "name": "bad",
            "annotations": {"seldon.io/autoscale": "true",
                            "seldon.io/autoscale-min": "zero"},
            "predictors": [{
                "name": "p",
                "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
            }],
        },
    }
    api.create(cr)
    out = rec.reconcile(api.get("SeldonDeployment", "default", "bad"))
    assert out.get("failed") == 1
    status = api.get("SeldonDeployment", "default", "bad")["status"]
    assert status["state"] == "Failed"
    assert "autoscale" in status["description"]


def test_reconciler_without_autoscaler_is_unchanged():
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler

    api = FakeKubeApi()
    rec = Reconciler(api)
    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "plain", "namespace": "default"},
        "spec": {
            "name": "plain",
            "annotations": {"seldon.io/autoscale": "true"},
            "predictors": [{
                "name": "p", "replicas": 2,
                "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
            }],
        },
    }
    api.create(cr)
    rec.reconcile(api.get("SeldonDeployment", "default", "plain"))
    dep = api.get("Deployment", "default", "plain-p-engine")
    assert dep["spec"]["replicas"] == 2  # spec copied verbatim, as ever


def test_reconciler_scale_in_judges_live_replicas_not_cr_baseline():
    """Scale-in decisions compare against the LIVE Deployment's count
    (the previous autoscale decision), not the re-rendered CR baseline —
    else a receding load would snap an 8-replica fleet back to the CR's
    1 in one tick with neither hysteresis nor the rollout gate ever
    seeing a want < current transition."""
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler
    from seldon_core_tpu_torch.operator.scaleahead import ScaleAheadPlanner

    class ActiveRollouts:
        def status_block(self, _dep):
            return {"state": "running"}

    planner = ScaleAheadPlanner(now_fn=lambda: 0.0)
    api = FakeKubeApi()
    rec = Reconciler(api, autoscaler=planner, rollouts=None)
    cr = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2",
        "kind": "SeldonDeployment",
        "metadata": {"name": "dep", "namespace": "default"},
        "spec": {
            "name": "dep",
            "annotations": {
                "seldon.io/autoscale": "true",
                "seldon.io/autoscale-max": "6",
                "seldon.io/autoscale-target-inflight": "4",
            },
            "predictors": [{
                "name": "p", "replicas": 1,
                "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
            }],
        },
    }
    api.create(cr)
    for t, load in ((0.0, 2), (10.0, 10), (20.0, 20)):
        planner.observe("dep", queue_depth=load, now=t)
    rec.reconcile(api.get("SeldonDeployment", "default", "dep"))
    assert api.get("Deployment", "default",
                   "dep-p-engine")["spec"]["replicas"] == 6
    # load recedes, a rollout is now active: the fleet must HOLD at the
    # live 6, not snap back to the CR's rendered 1
    rec.rollouts = ActiveRollouts()
    planner.reset()
    for t in (30.0, 40.0):
        planner.observe("dep", queue_depth=1, now=t)
    rec.reconcile(api.get("SeldonDeployment", "default", "dep"))
    dep = api.get("Deployment", "default", "dep-p-engine")
    assert dep["spec"]["replicas"] == 6
    status = api.get("SeldonDeployment", "default", "dep")["status"]
    assert status["autoscale"]["decisions"][0]["reason"] \
        == "scale-in rollout-gated"



def _samples(seed: int = 5, n: int = 40):
    """A seeded load series: a trend, noise and a burst (time, depth, inflight)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 3.0, n))
    depth = np.maximum(0.0, 0.4 * t + rng.normal(0, 3, n))
    depth[n // 2: n // 2 + 4] += 40.0
    inflight = rng.integers(0, 6, n)
    return list(zip(t.tolist(), depth.tolist(), inflight.tolist()))


def test_planner_equals_the_jax_planner_over_a_seeded_series():
    """``forecast`` and ``desired_replicas`` after every sample of one seeded
    series, with and without a rollout in flight, equal the JAX planner's
    (the decision records once their wall stamps are dropped)."""
    from seldon_core_tpu.operator import scaleahead as jsa
    from seldon_core_tpu_torch.operator import scaleahead as psa

    planners = [m.ScaleAheadPlanner(now_fn=lambda: 0.0) for m in (jsa, psa)]
    policies = [m.AutoscalePolicy(min_replicas=2, max_replicas=12, target_inflight=3.0,
                                  horizon_s=60.0) for m in (jsa, psa)]
    replicas = [2, 2]
    for i, (t, depth, inflight) in enumerate(_samples()):
        got = []
        for k in (0, 1):
            planners[k].observe("d", queue_depth=depth, inflight=inflight, now=t)
            fc = planners[k].forecast("d", 60.0, now=t)
            dec = planners[k].desired_replicas("d", replicas[k], policies[k],
                                               rollout_active=i % 7 == 3, now=t)
            dec.pop("ts")
            replicas[k] = dec["desired_replicas"]
            got.append((fc, dec))
        assert got[0] == got[1], i
    snap = [p.snapshot() for p in planners]
    for s in snap:
        for d in s["decisions"]:
            d.pop("ts", None)  # the records returned above, already stripped
    assert snap[0] == snap[1]
    assert len(snap[1]["decisions"]) >= 3


def test_autoscale_policy_from_spec_matches_the_jax_parser():
    from seldon_core_tpu.graph.spec import SeldonDeploymentSpec as JSpec
    from seldon_core_tpu.operator import scaleahead as jsa
    from seldon_core_tpu_torch.operator import scaleahead as psa

    base = {"spec": {"name": "d", "predictors": [{
        "name": "p", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"}}]}}
    cases = [{}, {"seldon.io/autoscale": "true"},
             {"seldon.io/autoscale": "TRUE", "seldon.io/autoscale-min": "2",
              "seldon.io/autoscale-max": "5", "seldon.io/autoscale-target-inflight": "2.5",
              "seldon.io/autoscale-horizon-s": "90"},
             {"seldon.io/autoscale": "true", "seldon.io/autoscale-min": "zero"},
             {"seldon.io/autoscale": "true", "seldon.io/autoscale-min": "4",
              "seldon.io/autoscale-max": "2"},
             {"seldon.io/autoscale": "true", "seldon.io/autoscale-horizon-s": "0"}]
    for ann in cases:
        doc = copy.deepcopy(base)
        doc["spec"]["annotations"] = ann
        out = []
        for mod, spec_cls in ((jsa, JSpec), (psa, SeldonDeploymentSpec)):
            try:
                pol = mod.AutoscalePolicy.from_spec(spec_cls.from_json_dict(doc))
                out.append(None if pol is None else vars(pol))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        assert out[0] == out[1], ann


def test_gateway_load_sample_reads_the_ports_gateway():
    """``gateway_load_sample`` sums the port gateway's replica-set inflight
    for the deployment and reads its tenants' queue depth."""
    from types import SimpleNamespace

    from seldon_core_tpu_torch.operator.scaleahead import gateway_load_sample

    eps = [SimpleNamespace(inflight=3), SimpleNamespace(inflight=-1), SimpleNamespace(inflight=2)]
    other = [SimpleNamespace(inflight=9)]
    gw = SimpleNamespace(
        _replica_sets={("d", "main"): ((), SimpleNamespace(endpoints=eps[:2])),
                       ("d", "canary"): ((), SimpleNamespace(endpoints=eps[2:])),
                       ("x", "main"): ((), SimpleNamespace(endpoints=other))},
        tenants=SimpleNamespace(queue_depth=lambda: 4))
    sample = gateway_load_sample(gw, "d")
    assert sample["inflight"] == 5.0 and sample["queue_depth"] == 4.0
    assert sample["burn_5m"] >= 0.0
