"""Tenant identity and latency tiers — the identity half of
``seldon_core_tpu/runtime/qos.py`` (``:86-165`` there).

  * **Tenant identity**: the ``Seldon-Tenant`` header, falling back to the
    auth principal and finally ``"anon"`` (``resolve_tenant``).  The id
    rides a contextvar parallel to the deadline budget
    (``runtime/resilience.py``), so every layer below the lane reads it
    without signature churn: the micro-batcher's entries, the generation
    scheduler's requests, the wire sidecar and the relay carry it, and the
    cost ledger (``utils/costledger.py``) bills by it.
  * **Latency tiers**: ``interactive`` > ``batch`` > ``offline`` (the
    ``Seldon-Tier`` header); an unknown tier reads as ``interactive``, so
    mislabelled traffic is never silently deprioritized.  The tier is
    carried and billed (the ledger's per-tier rows, the postmortem budget's
    tier factor); its scheduling effect is not ported yet.

The lanes bind both: the REST lane in every request's handler context, the
gRPC lane from the call's metadata, the binary wire and the relay from
their sidecars; the REST and gRPC node clients forward them to remote
nodes.

Not ported yet (ROADMAP Queue 1 item [4c]): the enforcement half —
``TokenBucket``, ``TenantGovernor``, admission, the fair queue and the
throttle 429s.  ``SELDON_TPU_TENANCY=0`` switches that enforcement off in
the reference; identity resolves either way, so here the knob is read by
``tenancy_enabled`` and changes nothing yet.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

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
    """``SELDON_TPU_TENANCY=0`` disables admission enforcement (not ported
    yet).  Identity still resolves: the per-tenant accounting rows stay."""
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
