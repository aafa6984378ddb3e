"""The enforcement half of the port's ``runtime/qos.py`` (``TokenBucket``,
``TenantGovernor``, the fair queue) against the JAX package's: the same
admit and slot sequences, made with numpy from a seed under one injected
clock, give the same 429 decisions, the same grant order and the same
``snapshot()``, with and without ``SELDON_TPU_QOS_USAGE_WEIGHTED`` (the cost
ledgers of both packages fed the same flush payloads); ``SELDON_TPU_TENANCY=0``
admits everything and makes the fair queue inert."""

import asyncio
import time

import numpy as np
import pytest

from seldon_core_tpu.runtime import qos as jq
from seldon_core_tpu.utils import costledger as jcl
from seldon_core_tpu_torch.runtime import autopilot as pap
from seldon_core_tpu_torch.runtime import qos as pq
from seldon_core_tpu_torch.utils import costledger as pcl
from seldon_core_tpu_torch.utils.telemetry import RECORDER


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    pap.reset_learned_singletons()
    jcl.LEDGER.reset()
    yield
    pap.reset_learned_singletons()
    jcl.LEDGER.reset()


class _Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    # the buckets stamp their birth with time.monotonic(); the governor
    # reads its now_fn: both are this one clock
    monkeypatch.setattr(time, "monotonic", c)
    return c


def _governors(clock, **kw):
    return jq.TenantGovernor(now_fn=clock, **kw), pq.TenantGovernor(now_fn=clock, **kw)


def test_token_bucket_matches(clock):
    rng = np.random.default_rng(0)
    for rate, burst in ((0.0, 0.0), (5.0, 10.0), (1.0, 0.5), (50.0, 3.0)):
        j, p = jq.TokenBucket(rate, burst), pq.TokenBucket(rate, burst)
        for _ in range(200):
            clock.t += float(rng.exponential(0.1))
            n = float(rng.choice([1.0, 2.0]))
            assert p.take(n) == j.take(n)
            assert p.tokens == pytest.approx(j.tokens, abs=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_admit_sequences_match(seed, clock):
    """Seeded tenants, tiers and arrival gaps against per-tenant overrides
    and weights: the same refusals, the same counters and snapshot."""
    rng = np.random.default_rng(seed)
    kw = dict(rate=4.0, burst=6.0, weights={"acme": 2.0},
              overrides={"hog": {"rate": 1.0, "burst": 2.0}, "vip": {"rate": 0.0}})
    j, p = _governors(clock, **kw)
    thr0 = sum(RECORDER.tenant_throttled.values())
    refused = 0
    for _ in range(400):
        clock.t += float(rng.exponential(0.05))
        tenant = str(rng.choice(["acme", "hog", "vip", "anon", "globex"]))
        tier = str(rng.choice(pq.TIERS))
        a, b = j.admit(tenant, tier), p.admit(tenant, tier)
        assert a == b
        refused += b == "rate"
        if b is None:
            lat, err = float(rng.gamma(2.0, 0.01)), bool(rng.random() < 0.1)
            j.note_result(tenant, lat, err)
            p.note_result(tenant, lat, err)
        elif rng.random() < 0.3:
            j.note_shed(tenant)
            p.note_shed(tenant)
    assert refused > 0
    assert p.snapshot() == j.snapshot()
    assert p.burn_totals() == j.burn_totals()
    # every refusal counted in the port's recorder family
    assert sum(RECORDER.tenant_throttled.values()) - thr0 == refused
    j.set_policy("hog", rate=0.0)
    p.set_policy("hog", rate=0.0)
    assert p.admit("hog", "batch") is j.admit("hog", "batch") is None
    assert p.snapshot() == j.snapshot()


def test_lru_bound_matches(clock):
    j, p = _governors(clock)
    for i in range(pq.TenantGovernor.MAX_TENANTS + 30):
        assert p.admit(f"t{i}", "interactive") == j.admit(f"t{i}", "interactive")
    assert p.evicted == j.evicted == 30
    assert p.snapshot() == j.snapshot()


def _feed_ledgers():
    """The same flush payloads into both packages' cost ledgers: acme's
    requests burn 4x globex's device time a request."""
    for ledger in (jcl.LEDGER, pcl.LEDGER):
        for _ in range(4):
            ledger.fold_flush({"dep": "d", "padded": 8.0,
                               "tenants": [("acme", "interactive", 4.0, 1.0, 0),
                                           ("globex", "interactive", 1.0, 1.0, 0)]}, 0.01)


async def _grant_order(gov, arrivals):
    """One slot held while ``arrivals`` queue, then released: the order
    the queued requests were granted."""
    order = []
    hold = asyncio.Event()

    async def one(i, tenant, first=False):
        async with gov.slot(tenant):
            if first:
                await hold.wait()
            order.append(i)
            await asyncio.sleep(0)

    first = asyncio.create_task(one(-1, "seed", first=True))
    await asyncio.sleep(0)
    tasks = []
    for i, tenant in enumerate(arrivals):
        tasks.append(asyncio.create_task(one(i, tenant)))
        await asyncio.sleep(0)
    depth = gov.queue_depth()
    hold.set()
    await asyncio.gather(first, *tasks)
    return order, depth


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_fair_queue_grant_order_matches(seed, weighted, clock, monkeypatch):
    if weighted:
        monkeypatch.setenv("SELDON_TPU_QOS_USAGE_WEIGHTED", "1")
        _feed_ledgers()
        assert pcl.LEDGER.usage_advance("acme") == jcl.LEDGER.usage_advance("acme") != 1.0
    rng = np.random.default_rng(seed)
    arrivals = [str(rng.choice(["acme", "acme", "acme", "globex", "initech"]))
                for _ in range(24)]
    results = []
    for mod in (jq, pq):
        gov = mod.TenantGovernor(now_fn=clock, fair_inflight=1, weights={"initech": 3.0})
        results.append(asyncio.run(_grant_order(gov, arrivals)))
        results.append(gov.snapshot())
    (jorder, jdepth), jsnap, (porder, pdepth), psnap = results
    assert porder == jorder and pdepth == jdepth == len(arrivals)
    assert porder != sorted(porder)  # fair queueing reordered the backlog
    assert psnap == jsnap


def test_tenancy_kill_switch(clock, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_TENANCY", "0")
    j, p = _governors(clock, rate=1.0, burst=1.0, fair_inflight=1)
    assert [p.admit("hog", "interactive") for _ in range(5)] == \
        [j.admit("hog", "interactive") for _ in range(5)] == [None] * 5

    async def many(gov):
        async def one():
            async with gov.slot("hog"):
                await asyncio.sleep(0)
        await asyncio.gather(*(one() for _ in range(4)))
        return gov._inflight, gov.queue_depth()

    assert asyncio.run(many(p)) == asyncio.run(many(j)) == (0, 0)
    assert p.snapshot() == j.snapshot() and p.snapshot()["enabled"] is False
