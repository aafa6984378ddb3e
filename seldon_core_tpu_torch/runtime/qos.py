"""Multi-tenant QoS — the port's counterpart of
``seldon_core_tpu/runtime/qos.py``: tenant identity, latency tiers and fair
admission.

  * **Tenant identity**: the ``Seldon-Tenant`` header, falling back to the
    auth principal and finally ``"anon"`` (``resolve_tenant``).  The id
    rides a contextvar parallel to the deadline budget
    (``runtime/resilience.py``), so every layer below the lane reads it
    without signature churn: the micro-batcher's entries, the generation
    scheduler's requests, the wire sidecar and the relay carry it, and the
    cost ledger (``utils/costledger.py``) bills by it.
  * **Latency tiers**: ``interactive`` > ``batch`` > ``offline`` (the
    ``Seldon-Tier`` header); an unknown tier reads as ``interactive``, so
    mislabelled traffic is never silently deprioritized.  Tiers schedule:
    the micro-batcher keys its buckets by tier and a lower tier's pump
    yields a dispatch slot while a higher tier waits
    (``runtime/batching.py``), the generation scheduler admits by tier and
    preempts the lowest tier first (``runtime/genserver.py``), and the
    brownout ladder sheds lower tiers first (``runtime/brownout.py``).
  * **Fair admission** (:class:`TenantGovernor`): per-tenant token buckets
    (a hog's excess answers a typed 429, its message led by
    ``THROTTLE_INFO_PREFIX``, before it queues anywhere) and weighted
    start-time fair queueing over dispatch slots
    (``SELDON_TPU_GW_FAIR_INFLIGHT`` > 0): each tenant's requests carry
    virtual start tags advanced by ``1/weight`` a request (scaled by the
    cost ledger's ``usage_advance`` under ``SELDON_TPU_QOS_USAGE_WEIGHTED=1``),
    and a freed slot goes to the pending request with the smallest tag.  In
    the JAX package the gateway holds the governor; the engines it drives
    hold none, and neither do the port's.

The lanes bind identity: the REST lane in every request's handler context,
the gRPC lane from the call's metadata, the binary wire and the relay from
their sidecars; the REST and gRPC node clients forward it to remote nodes.

Kill switch: ``SELDON_TPU_TENANCY=0`` disables admission enforcement (and
the fair queue); identity still resolves.  Knobs: ``SELDON_TPU_TENANCY``,
``SELDON_TPU_TENANT_RATE`` (req/s, 0 = unlimited, the default),
``SELDON_TPU_TENANT_BURST`` (default 2x rate), ``SELDON_TPU_TENANT_WEIGHTS``
(JSON {tenant: weight}), ``SELDON_TPU_TENANT_OVERRIDES`` (JSON {tenant:
{rate, burst, weight}}), ``SELDON_TPU_GW_FAIR_INFLIGHT`` (0 = fair queue
off, the default).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, Optional

from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = [
    "TENANT_HEADER",
    "TIER_HEADER",
    "TIER_INTERACTIVE",
    "TIER_BATCH",
    "TIER_OFFLINE",
    "TIERS",
    "THROTTLE_INFO_PREFIX",
    "tenancy_enabled",
    "parse_tier",
    "tier_rank",
    "current_tenant",
    "current_tier",
    "qos_scope",
    "bind_qos",
    "resolve_tenant",
    "TokenBucket",
    "TenantGovernor",
]

TENANT_HEADER = "Seldon-Tenant"
TIER_HEADER = "Seldon-Tier"

TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"
TIER_OFFLINE = "offline"
#: priority order: lower rank preempts higher rank
_TIER_RANK = {TIER_INTERACTIVE: 0, TIER_BATCH: 1, TIER_OFFLINE: 2}
TIERS = (TIER_INTERACTIVE, TIER_BATCH, TIER_OFFLINE)

#: every tenant-throttle failure message starts with this: how the wire
#: recognizes a policy refusal (429, retry later) rather than a sick replica
THROTTLE_INFO_PREFIX = "tenant throttled"

_TENANT: ContextVar[Optional[str]] = ContextVar("seldon_torch_tenant", default=None)
_TIER: ContextVar[str] = ContextVar("seldon_torch_tier", default=TIER_INTERACTIVE)


def tenancy_enabled() -> bool:
    """``SELDON_TPU_TENANCY=0`` disables admission enforcement (token
    buckets, fair queue, throttle 429s).  Identity still resolves: the
    per-tenant accounting rows stay, only enforcement stops."""
    return os.environ.get("SELDON_TPU_TENANCY", "1").strip() != "0"


def parse_tier(value: Optional[str]) -> str:
    """Header value -> tier name; anything unknown is ``interactive``."""
    if not value:
        return TIER_INTERACTIVE
    tier = str(value).strip().lower()
    return tier if tier in _TIER_RANK else TIER_INTERACTIVE


def tier_rank(tier: Optional[str]) -> int:
    """0 = interactive (highest priority).  Unknown -> 0."""
    return _TIER_RANK.get(tier or "", 0)


def current_tenant() -> Optional[str]:
    return _TENANT.get()


def current_tier() -> str:
    return _TIER.get()


@contextmanager
def qos_scope(tenant: Optional[str], tier: Optional[str] = None):
    """Bind tenant and tier for the enclosed request, parallel to
    ``deadline_scope`` and ``trace_scope``."""
    t_tok = _TENANT.set(tenant or None)
    l_tok = _TIER.set(parse_tier(tier))
    try:
        yield
    finally:
        _TENANT.reset(t_tok)
        _TIER.reset(l_tok)


def bind_qos(tenant: Optional[str], tier: Optional[str] = None) -> None:
    """Set tenant and tier in the CURRENT context without a scope: for a
    handler that runs in a task (or a copied context) of its own, where the
    binding dies with it."""
    _TENANT.set(tenant or None)
    _TIER.set(parse_tier(tier))


def resolve_tenant(header_value: Optional[str], principal: Optional[str] = None) -> str:
    """The tenant-identity rule: explicit header, else the auth principal,
    else ``anon``; ids are cut to 64 characters so a header-spraying client
    cannot explode label width downstream."""
    tenant = (header_value or "").strip()
    if not tenant:
        tenant = (principal or "").strip() or "anon"
    return tenant[:64]


class TokenBucket:
    """Monotonic-clock token bucket.  ``rate <= 0`` means unlimited —
    the default, so an unconfigured governor admits everything."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0) if rate > 0 else 0.0
        # starts FULL: the first requests of a well-behaved tenant must
        # be admitted, not bootstrap the refill (the shadow-mirror
        # budget learned this the hard way)
        self.tokens = self.burst
        self._t = now if now is not None else time.monotonic()

    def take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True
        now = now if now is not None else time.monotonic()
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_json(name: str) -> dict:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return {}
    try:
        doc = json.loads(raw)
        return doc if isinstance(doc, dict) else {}
    except ValueError:
        return {}


class _Tenant:
    """One tenant's admission state + accounting row."""

    __slots__ = (
        "name", "bucket", "weight", "vfinish", "requests", "throttled",
        "shed", "errors", "latency_ms", "tiers", "last_seen",
    )

    def __init__(self, name: str, rate: float, burst: float,
                 weight: float):
        self.name = name
        self.bucket = TokenBucket(rate, burst)
        self.weight = max(float(weight), 1e-6)
        self.vfinish = 0.0          # fair-queue virtual clock
        self.requests = 0
        self.throttled = 0
        self.shed = 0
        self.errors = 0
        self.latency_ms = Reservoir(512)
        self.tiers: Dict[str, int] = {}
        self.last_seen = 0.0


class TenantGovernor:
    """Per-tenant token buckets + weighted start-time fair queueing.

    Bounded: at most ``MAX_TENANTS`` rows, LRU-evicted — an
    id-spraying client recycles rows instead of ballooning the gateway.
    All bucket/accounting ops are plain dict work under the GIL; the
    fair queue is event-loop-only state (futures created and resolved
    on the gateway's loop)."""

    MAX_TENANTS = 256

    def __init__(
        self,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        overrides: Optional[Dict[str, dict]] = None,
        fair_inflight: Optional[int] = None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self.rate = (
            rate if rate is not None
            else _env_float("SELDON_TPU_TENANT_RATE", 0.0)
        )
        self.burst = (
            burst if burst is not None
            else _env_float("SELDON_TPU_TENANT_BURST",
                            2.0 * self.rate if self.rate > 0 else 0.0)
        )
        self.weights = dict(
            weights if weights is not None
            else _env_json("SELDON_TPU_TENANT_WEIGHTS")
        )
        self.overrides = dict(
            overrides if overrides is not None
            else _env_json("SELDON_TPU_TENANT_OVERRIDES")
        )
        self.fair_inflight = int(
            fair_inflight if fair_inflight is not None
            else _env_float("SELDON_TPU_GW_FAIR_INFLIGHT", 0)
        )
        self._now = now_fn
        self._tenants: "OrderedDict[str, _Tenant]" = OrderedDict()
        self.evicted = 0
        # fair-queue state (event loop only)
        self._inflight = 0
        self._vtime = 0.0
        self._queues: Dict[str, deque] = {}  # tenant -> [(tag, future)]

    # -- tenant table ----------------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is not None:
            self._tenants.move_to_end(name)
            return t
        while len(self._tenants) >= self.MAX_TENANTS:
            # LRU eviction: the id-spraying hog recycles ITS rows; a
            # steadily-active tenant is always recently used
            self._tenants.popitem(last=False)
            self.evicted += 1
        ov = self.overrides.get(name) or {}
        rate = float(ov.get("rate", self.rate))
        t = self._tenants[name] = _Tenant(
            name,
            rate,
            float(ov.get("burst",
                         self.burst if rate == self.rate
                         else 2.0 * rate)),
            float(ov.get("weight", self.weights.get(name, 1.0))),
        )
        return t

    def set_policy(self, tenant: str, *, rate: Optional[float] = None,
                   burst: Optional[float] = None,
                   weight: Optional[float] = None) -> None:
        """Programmatic per-tenant override (tests / control plane)."""
        ov = self.overrides.setdefault(tenant, {})
        if rate is not None:
            ov["rate"] = float(rate)
        if burst is not None:
            ov["burst"] = float(burst)
        if weight is not None:
            ov["weight"] = float(weight)
        self._tenants.pop(tenant, None)  # rebuilt with the new policy

    # -- admission -------------------------------------------------------

    def admit(self, tenant: str, tier: str) -> Optional[str]:
        """One admission decision.  Returns ``None`` (admitted) or the
        refusal reason (``"rate"``).  Always accounts the attempt."""
        t = self._tenant(tenant)
        t.requests += 1
        t.tiers[tier] = t.tiers.get(tier, 0) + 1
        t.last_seen = self._now()
        RECORDER.record_tenant_request(tenant)
        if not tenancy_enabled():
            return None
        if not t.bucket.take(1.0, self._now()):
            t.throttled += 1
            RECORDER.record_tenant_throttled(tenant)
            return "rate"
        return None

    def note_result(self, tenant: str, latency_s: float,
                    error: bool) -> None:
        t = self._tenant(tenant)
        t.latency_ms.observe(latency_s * 1e3)
        if error:
            t.errors += 1

    def note_shed(self, tenant: str) -> None:
        self._tenant(tenant).shed += 1

    def burn_totals(self) -> Dict[str, Dict[str, int]]:
        """``{tenant: {throttled, shed}}`` cumulative counters — the QoS
        half of the federated burn delta (gateway/federation.py
        publishes these through the shared store; cumulative totals sum
        meaningfully across replicas where rates would not)."""
        return {
            name: {"requests": t.requests, "throttled": t.throttled,
                   "shed": t.shed}
            for name, t in self._tenants.items()
        }

    # -- weighted fair queue ---------------------------------------------

    def queue_depth(self) -> int:
        """Requests parked in the fair queue — a brownout depth signal."""
        return sum(len(q) for q in self._queues.values())

    def slot(self, tenant: str):
        """``async with governor.slot(tenant):`` — a dispatch slot under
        start-time fair queueing.  With ``fair_inflight <= 0`` (default)
        or tenancy off this is an inert context manager: zero added
        awaits, today's behaviour bit-for-bit."""
        return _FairSlot(self, tenant)

    def _tag(self, tenant: str) -> float:
        """Virtual start-tag for one request: ``max(vtime, tenant's last
        finish)``; the tenant's finish clock then advances ``1/weight``
        — the SFQ rule.  A tenant pushing 10x its share advances its own
        clock 10x faster, so its backlog always sorts behind a
        well-behaved tenant's next request.

        With ``SELDON_TPU_QOS_USAGE_WEIGHTED=1`` the advance is scaled
        by the cost ledger's per-request device-seconds ratio for this
        tenant, so a tenant whose requests burn 3x the fleet-average
        device time drains its queue 3x slower — fair share measured in
        chip-seconds, not request counts."""
        t = self._tenant(tenant)
        start = max(self._vtime, t.vfinish)
        advance = 1.0
        from seldon_core_tpu_torch.utils.costledger import LEDGER, usage_weighted_enabled

        if usage_weighted_enabled():
            advance = LEDGER.usage_advance(tenant)
        t.vfinish = start + advance / t.weight
        return start

    def _acquire_nowait(self, tenant: str) -> bool:
        if self._inflight < self.fair_inflight:
            self._inflight += 1
            self._vtime = max(self._vtime, self._tag(tenant))
            return True
        return False

    def _enqueue(self, tenant: str) -> "asyncio.Future":
        fut = asyncio.get_running_loop().create_future()
        tag = self._tag(tenant)
        self._queues.setdefault(tenant, deque()).append((tag, fut))
        return fut

    def _release(self) -> None:
        self._inflight -= 1
        # hand the freed slot to the pending request with the smallest
        # virtual tag across tenants (FIFO within a tenant)
        best_key, best_tag = None, None
        for name, q in self._queues.items():
            while q and q[0][1].cancelled():
                q.popleft()
            if q and (best_tag is None or q[0][0] < best_tag):
                best_key, best_tag = name, q[0][0]
        if best_key is None:
            self._queues = {k: q for k, q in self._queues.items() if q}
            return
        _tag, fut = self._queues[best_key].popleft()
        if not self._queues[best_key]:
            del self._queues[best_key]
        self._inflight += 1
        self._vtime = max(self._vtime, best_tag)
        fut.set_result(None)

    # -- surfaces --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The tenants block (the JAX gateway's ``/stats``) — bounded by
        MAX_TENANTS by construction."""
        rows = {}
        for name, t in self._tenants.items():
            rows[name] = {
                "requests": t.requests,
                "throttled": t.throttled,
                "shed": t.shed,
                "errors": t.errors,
                "tiers": dict(t.tiers),
                "weight": t.weight,
                "rate": t.bucket.rate,
                "latency_ms": t.latency_ms.snapshot(),
            }
        return {
            "enabled": tenancy_enabled(),
            "fair_inflight": self.fair_inflight,
            "queue_depth": self.queue_depth(),
            "tenants_tracked": len(self._tenants),
            "evicted": self.evicted,
            "tenants": rows,
        }

    def reset(self) -> None:
        """Tests only."""
        self._tenants = OrderedDict()
        self._queues = {}
        self._inflight = 0
        self._vtime = 0.0
        self.evicted = 0


class _FairSlot:
    """Async context manager for one fair-queue slot."""

    __slots__ = ("gov", "tenant", "_held")

    def __init__(self, gov: TenantGovernor, tenant: str):
        self.gov = gov
        self.tenant = tenant
        self._held = False

    async def __aenter__(self):
        gov = self.gov
        if gov.fair_inflight <= 0 or not tenancy_enabled():
            return self
        if gov._acquire_nowait(self.tenant):
            self._held = True
            return self
        fut = gov._enqueue(self.tenant)
        try:
            await fut
        except asyncio.CancelledError:
            # cancelled while queued: the future may have been resolved
            # (slot granted) in the same tick — give the slot back so
            # the queue drains instead of leaking capacity
            if fut.done() and not fut.cancelled():
                gov._release()
            raise
        self._held = True
        return self

    async def __aexit__(self, *exc):
        if self._held:
            self.gov._release()
        return False
