"""The port's shared gateway state and federation
(seldon_core_tpu_torch/gateway/state.py, gateway/federation.py) against
the JAX package's: the cases of tests/test_gateway_state.py and the store
and election cases of tests/test_federation.py, each run against both
packages (``package`` "jax" and "torch"), and one sqlite file shared by a
JAX store and a port store — a token issued by either validates on the
other, a registration, a weight shift, a lease or a peer row written by one
reads the same on the other, and a JAX federation and a port federation on
the file elect exactly one coordinator, the survivor taking over within
one TTL.  Lease time runs on a fake clock patched into each module's own
``time`` attribute, so no test sleeps out a TTL."""

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest

from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    reset_learned_singletons()
    yield


def _package(name: str) -> SimpleNamespace:
    if name == "jax":
        from seldon_core_tpu.gateway import apife, federation, state
        from seldon_core_tpu.graph import spec
        from seldon_core_tpu.testing import faults
    else:
        from seldon_core_tpu_torch.gateway import apife, federation, state
        from seldon_core_tpu_torch.graph import spec
        from seldon_core_tpu_torch.testing import faults
    return SimpleNamespace(name=name, apife=apife, federation=federation, state=state,
                           spec=spec, faults=faults)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


class FakeClock:
    """A ``time`` stand-in whose wall clock a test advances; everything
    else is the real module's."""

    def __init__(self):
        self.offset = 0.0

    def time(self) -> float:
        return time.time() + self.offset

    def advance(self, s: float) -> None:
        self.offset += s

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def clock(monkeypatch):
    """One fake clock in every state and federation module of both
    packages: leases written by one package expire for the other."""
    c = FakeClock()
    for name in ("jax", "torch"):
        p = _package(name)
        monkeypatch.setattr(p.state, "time", c)
        monkeypatch.setattr(p.federation, "time", c)
    return c


@pytest.fixture()
def db_path(tmp_path):
    return str(tmp_path / "gateway.db")


def make_spec(pkg, name="dep", oauth_key="key", oauth_secret="secret"):
    return pkg.spec.SeldonDeploymentSpec.from_json_dict({"spec": {
        "name": name, "oauth_key": oauth_key, "oauth_secret": oauth_secret,
        "predictors": [{"name": "main", "replicas": 1,
                        "graph": {"name": "m", "type": "MODEL",
                                  "implementation": "SIMPLE_MODEL"}}]}})


def canary_spec(pkg, name="dep", key="key"):
    return pkg.spec.SeldonDeploymentSpec.from_json_dict({"spec": {
        "name": name, "oauth_key": key, "oauth_secret": "s",
        "predictors": [{"name": pname, "replicas": reps,
                        "graph": {"name": "m", "type": "MODEL",
                                  "implementation": "SIMPLE_MODEL"}}
                       for pname, reps in (("baseline", 9), ("candidate", 1))]}})


def _weights(store, key="key"):
    return {name: w for name, w, _ in store._registration(key).engines}


# -- tests/test_gateway_state.py -------------------------------------------------


def test_token_on_one_replica_validates_on_another(pkg, db_path):
    a, b = pkg.state.SqliteDeploymentStore(db_path), pkg.state.SqliteDeploymentStore(db_path)
    a.register(make_spec(pkg), {"main": "http://dep:8000"})
    token = a.issue_token("key", "secret")
    reg = b.principal_for_token(token)
    assert reg.deployment_id == "dep" and reg.engines == [("main", 1, "http://dep:8000")]
    with pytest.raises(pkg.apife.AuthError):
        a.issue_token("key", "wrong")
    with pytest.raises(pkg.apife.AuthError):
        a.principal_for_token("no-such-token")
    b.unregister("key")
    with pytest.raises(pkg.apife.AuthError):
        a.principal_for_token(token)
    assert a.deployments() == []


def test_expired_token_reregistration_and_rejections(pkg, db_path, clock):
    a = pkg.state.SqliteDeploymentStore(db_path)
    a.register(make_spec(pkg), {"main": "http://old:8000"})
    a.register(make_spec(pkg), {"main": "http://new:8000"})
    token = a.issue_token("key", "secret")
    assert a.principal_for_token(token).engines[0][2] == "http://new:8000"
    assert a.active_token_count() == 1
    clock.advance(3601.0)
    with pytest.raises(pkg.apife.AuthError, match="expired"):
        a.principal_for_token(token)
    with pytest.raises(TypeError):
        a.register(make_spec(pkg), {"main": object()})
    # the auth-disabled gateway resolves through the store's _by_key view
    gw = pkg.apife.ApiGateway(store=a, require_auth=False)
    assert gw._resolve(None).deployment_id == "dep"


# -- one file, two packages ---------------------------------------------------------


@pytest.mark.parametrize("issuer", ["jax", "torch"])
def test_one_sqlite_file_shared_by_both_packages(db_path, issuer):
    """A JAX store and a port store on one file: the issuer registers and
    issues, the other validates the token, reads the same registration
    (shadow policy and replica lists included), shifts weights the issuer
    reads back, and unregisters."""
    other = "torch" if issuer == "jax" else "jax"
    pi, po = _package(issuer), _package(other)
    si, so = pi.state.SqliteDeploymentStore(db_path), po.state.SqliteDeploymentStore(db_path)
    spec = pi.spec.SeldonDeploymentSpec.from_json_dict({"spec": {
        "name": "dep", "oauth_key": "key", "oauth_secret": "s",
        "annotations": {"seldon.io/shadow-sample": "0.5"},
        "predictors": [
            {"name": "main", "replicas": 3,
             "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}},
            {"name": "cand", "replicas": 1, "annotations": {"seldon.io/shadow": "true"},
             "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}]}})
    si.register(spec, {"main": ["http://a:1", "http://b:1+uds:/run/b.sock"],
                       "cand": "http://c:1"})
    token = si.issue_token("key", "s")
    reg_i, reg_o = si.principal_for_token(token), so.principal_for_token(token)
    assert reg_o.deployment_id == reg_i.deployment_id == "dep"
    assert reg_o.engines == reg_i.engines == [
        ("main", 3, ["http://a:1", "http://b:1+uds:/run/b.sock"]), ("cand", 0, "http://c:1")]
    assert reg_o.shadow.to_json_dict() == reg_i.shadow.to_json_dict()
    assert so.revision() == si.revision() and so.deployments() == ["dep"]
    so.set_weights("dep", {"main": 1})
    assert si.weights("dep") == {"main": 1, "cand": 0}
    token2 = so.issue_token("key", "s")
    assert si.principal_for_token(token2).oauth_key == "key"
    assert si.active_token_count() == so.active_token_count() == 2
    so.heartbeat_engine("http://a:1", "boot-1", 5.0)
    so.heartbeat_peer("gw-o", "http://o:8080", 5.0)
    so.publish_burn("gw-o", [("_global", "5m", 10, 1, 2, 0, 0)])
    assert si.engine_leases() == so.engine_leases()
    assert si.peers() == so.peers() == [("gw-o", "http://o:8080")]
    assert [r["total"] for r in si.burn_rows()] == [10]
    si.unregister("key")
    with pytest.raises(po.apife.AuthError):
        so.principal_for_token(token2)
    si.close()
    so.close()


def test_mixed_package_election_and_failover_within_one_ttl(db_path, clock):
    """A JAX federation and a port federation on one file elect exactly one
    coordinator; when it stops ticking the other takes over within one TTL
    with the fencing token bumped, and the zombie's fenced write is
    rejected in either package's store."""
    jx, tx = _package("jax"), _package("torch")
    for first, second in ((jx, tx), (tx, jx)):
        fa = first.federation.GatewayFederation(first.state.SqliteDeploymentStore(db_path),
                                                f"gw-{first.name}", ttl_s=0.2,
                                                base_url="http://a:8080", clock=clock.time)
        fb = second.federation.GatewayFederation(second.state.SqliteDeploymentStore(db_path),
                                                 f"gw-{second.name}", ttl_s=0.2,
                                                 base_url="http://b:8080", clock=clock.time)
        fa.store.register(canary_spec(first), {"baseline": "http://b:8000",
                                               "candidate": "http://c:8000"})
        assert fa.tick() is True and fb.tick() is False
        assert [fa.is_coordinator, fb.is_coordinator] == [True, False]
        assert fa.peers() == [(f"gw-{second.name}", "http://b:8080")]
        old = fa.fencing_token
        clock.advance(0.1)
        assert fb.tick() is False  # still inside the coordinator's TTL
        clock.advance(0.11)        # one TTL since the coordinator's last tick
        assert fb.tick() is True and fb.fencing_token == old + 1
        assert fb.snapshot()["coordinator"] and fb.snapshot()["lease"]["holder"] == fb.replica_id
        with pytest.raises(Exception, match="stale"):
            fa.store.fenced_set_weights("dep", {"candidate": 90}, lease="coordinator",
                                        holder=fa.replica_id, token=old)
        fb.set_weights("dep", {"candidate": 25, "baseline": 75})
        assert _weights(fa.store)["candidate"] == 25
        fb.resign()
        assert fa.store.lease("coordinator") is None
        fa.store.unregister("key")


# -- tests/test_federation.py: the store and the election ---------------------------


def test_two_store_instances_concurrent_writes_no_lost_updates(pkg, db_path):
    a, b = pkg.state.SqliteDeploymentStore(db_path), pkg.state.SqliteDeploymentStore(db_path)
    a.register(canary_spec(pkg), {"baseline": "http://b:8000", "candidate": "http://c:8000"})
    base, n, errors = a.revision(), 20, []

    def worker(store, flip):
        try:
            for i in range(n):
                pct = (i * 7) % 101 if flip else (100 - (i * 3) % 101)
                store.set_weights("dep", {"candidate": pct, "baseline": 100 - pct})
        except Exception as e:  # noqa: BLE001 - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(a, True)),
               threading.Thread(target=worker, args=(b, False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and a.revision() == base + 2 * n
    w = _weights(a)
    assert w["candidate"] + w["baseline"] == 100


def test_busy_writer_retries_instead_of_raising(pkg, db_path):
    import sqlite3

    a = pkg.state.SqliteDeploymentStore(db_path)
    a.register(canary_spec(pkg), {"baseline": "http://b:8000", "candidate": "http://c:8000"})
    held = threading.Event()

    def hold_lock():
        rogue = sqlite3.connect(db_path, isolation_level=None)
        rogue.execute("BEGIN IMMEDIATE")
        held.set()
        time.sleep(0.3)
        rogue.execute("COMMIT")
        rogue.close()

    t = threading.Thread(target=hold_lock)
    t.start()
    assert held.wait(10)
    a.set_weights("dep", {"candidate": 50, "baseline": 50})
    t.join(10)
    assert _weights(a)["candidate"] == 50


def test_lease_tokens_release_and_fence(pkg, db_path, clock):
    s = pkg.state.SqliteDeploymentStore(db_path)
    assert s.acquire_lease("coord", "A", ttl_s=0.2) == 1
    assert s.acquire_lease("coord", "A", ttl_s=0.2) == 1
    assert s.acquire_lease("coord", "B", ttl_s=0.2) is None
    clock.advance(0.25)
    assert s.acquire_lease("coord", "B", ttl_s=0.2) == 2
    clock.advance(0.25)
    assert s.acquire_lease("coord", "B", ttl_s=0.2) == 3
    s.release_lease("coord", "B", token=99)
    assert s.lease("coord")["holder"] == "B"
    s.release_lease("coord", "B", token=3)
    assert s.lease("coord") is None
    s.register(canary_spec(pkg), {"baseline": "http://b:8000", "candidate": "http://c:8000"})
    old = s.acquire_lease("coord", "A", ttl_s=0.2)
    clock.advance(0.25)
    new = s.acquire_lease("coord", "B", ttl_s=5.0)
    assert new == old + 1
    with pytest.raises(pkg.state.StaleFenceError):
        s.fenced_set_weights("dep", {"candidate": 90, "baseline": 10}, lease="coord",
                             holder="A", token=old)
    assert _weights(s)["candidate"] == 1
    s.fenced_set_weights("dep", {"candidate": 25, "baseline": 75}, lease="coord",
                         holder="B", token=new)
    assert _weights(s)["candidate"] == 25


def test_federation_demotes_on_store_error_and_kill_switch(pkg, db_path, monkeypatch):
    store = pkg.faults.PartitionedStore(pkg.state.SqliteDeploymentStore(db_path))
    fed = pkg.federation.GatewayFederation(store, "gw-a", ttl_s=5.0)
    assert fed.tick() is True
    store.partition()
    assert fed.tick() is False and not fed.is_coordinator
    assert "InjectedFault" in fed.snapshot().get("store_error", "")
    store.heal()
    assert fed.tick() is True
    monkeypatch.setenv("SELDON_TPU_FEDERATION", "0")
    fed = pkg.federation.GatewayFederation(pkg.state.SqliteDeploymentStore(db_path), "gw-b")
    assert not fed.enabled and fed.tick() is True and fed.is_coordinator
    monkeypatch.delenv("SELDON_TPU_FEDERATION")
    fed2 = pkg.federation.GatewayFederation(pkg.apife.DeploymentStore(), "gw-c")
    assert not fed2.enabled and fed2.is_coordinator


def test_engine_leases_feed_the_balancer(db_path, clock, monkeypatch):
    from seldon_core_tpu_torch.gateway import balancer
    from seldon_core_tpu_torch.gateway.state import SqliteDeploymentStore

    monkeypatch.setattr(balancer, "time", clock)
    s = SqliteDeploymentStore(db_path)
    rs = balancer.ReplicaSet(["http://a:1", "http://b:1"])
    a, b = rs.endpoints
    rs.apply_leases(s.engine_leases())
    assert a.lease_state is None and not a.degraded(time.monotonic(), 10.0)
    s.heartbeat_engine("http://a:1", "boot-1", ttl_s=0.2)
    rs.apply_leases(s.engine_leases())
    assert (a.lease_state, a.boot_id, b.lease_state) == ("live", "boot-1", None)
    a.ewma_ms, a.consec_failures = 500.0, 2
    clock.advance(0.25)  # the lease lapses: the engine is dead
    rs.apply_leases(s.engine_leases())
    assert a.lease_state == "dead" and a.degraded(time.monotonic(), 10.0)
    s.heartbeat_engine("http://a:1", "boot-2", ttl_s=5.0)  # restarted
    rs.apply_leases(s.engine_leases())
    assert (a.lease_state, a.boot_id, a.ewma_ms, a.consec_failures, a.epoch_resets) == (
        "live", "boot-2", 0.0, 0, 1)
    s.drop_engine("http://a:1")
    rs.apply_leases(s.engine_leases())
    assert a.lease_state == "dead"


def test_gateway_stats_federation_block(pkg, db_path):
    async def run():
        store = pkg.state.SqliteDeploymentStore(db_path)
        store.register(canary_spec(pkg), {"baseline": "http://b:8000",
                                          "candidate": "http://c:8000"})
        gw = pkg.apife.ApiGateway(store=store, require_auth=False)
        fed = pkg.federation.GatewayFederation(store, "gw-a", ttl_s=5.0,
                                               base_url="http://a:8080")
        gw.federation = fed
        fed.tick()
        try:
            doc = gw.stats()["federation"]
            assert (doc["replica_id"], doc["coordinator"], doc["fencing_token"],
                    doc["lease"]["holder"], doc["failovers"]) == ("gw-a", True, 1, "gw-a", {})
        finally:
            await gw.close()  # resigns the lease
        assert store.lease(pkg.federation.COORDINATOR_LEASE) is None

    asyncio.run(asyncio.wait_for(run(), 30))
