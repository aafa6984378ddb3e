"""Gateway federation — N apife replicas over one shared sqlite store; the
port's copy of ``seldon_core_tpu/gateway/federation.py`` (a port replica and
a JAX replica on one file take part in one election).

The reference architecture runs the api-frontend as a Deployment behind a
Service: every replica serves ingress statelessly, and anything stateful
(OAuth tokens) lives in Redis.  Our gateway grew singleton duties the
reference never had — rollout controllers, scale-ahead, shadow budget
accounting — which must run EXACTLY ONCE across the fleet or two replicas
fight over the same traffic split.

This module is the election that picks the one replica allowed to run
them.  It is deliberately boring: a single row in the shared sqlite file
(``leases`` table, gateway/state.py) holds ``(holder, token, expires)``;
every replica ticks ``acquire_lease`` at ttl/3, the holder renews, the
rest observe.  When the coordinator dies or stalls past the TTL, the next
ticker takes over and the **fencing token** bumps — any write the
ex-coordinator issues afterwards carries the old token and is rejected
inside the store's own write transaction (``fenced_set_weights``), the
classic lock-service fence (cf. Chubby; HashiCorp's leader election over
a session-bound KV key).

Failure semantics by design:

* ingress never depends on the lease — every replica serves requests the
  whole time, only singleton DUTIES move;
* QoS token buckets stay per-replica (a shed decision is
  latency-critical; sharing them through sqlite would put a disk write
  on the admission path), but SLO burn and throttle/shed ACCOUNTING
  federates off-path: every tick publishes this replica's window counts
  into the shared ``burn_deltas`` table and folds every peer's last
  counts into the process-global fleet-truth view
  (utils/quality.py ``FLEET_BURN``) that the brownout ladder and
  rollout burn gates judge — so a 3-replica mesh reacts to the fleet's
  burn, not a 1/3 slice.  ``SELDON_TPU_FLEET_BURN=0`` kills just this
  layer (per-replica burn bit-for-bit);
* a store outage demotes the replica (it cannot prove tenure, so it must
  not act as coordinator) but keeps serving ingress; the fleet-burn view
  goes stale and consumers fall back to their local rings.

Kill switch: ``SELDON_TPU_FEDERATION=0`` (or an in-memory store, which
has no lease API) makes every replica its own coordinator — bit-for-bit
the pre-federation single-gateway behavior.
"""

from __future__ import annotations

import asyncio
import os
import secrets
import time
from typing import Callable, List, Optional, Tuple

from seldon_core_tpu_torch.utils.telemetry import RECORDER

__all__ = [
    "GatewayFederation",
    "federation_enabled",
    "lease_ttl_s",
    "COORDINATOR_LEASE",
]

#: the singleton-duty lease's row name in the shared ``leases`` table
COORDINATOR_LEASE = "coordinator"


def federation_enabled() -> bool:
    """``SELDON_TPU_FEDERATION=0`` restores single-gateway behavior."""
    return os.environ.get("SELDON_TPU_FEDERATION", "1") != "0"


def lease_ttl_s() -> float:
    """Coordinator + engine lease TTL (``SELDON_TPU_LEASE_TTL_S``,
    default 3s) — the upper bound on coordinator-failover time and on
    how long a dead engine keeps attracting picks before the balancer
    declares it via the lease (scrape fail-degrade needs 3 consecutive
    failures; the lease usually loses the race only when scrapes are
    faster than heartbeats)."""
    try:
        return max(float(os.environ.get("SELDON_TPU_LEASE_TTL_S", "3")), 0.2)
    except ValueError:
        return 3.0


class GatewayFederation:
    """One gateway replica's view of the federation.

    ``tick()`` is the whole protocol: claim-or-renew the coordinator
    lease, heartbeat this replica into the peer directory, notice
    transitions.  Everything else is read-side sugar (``is_coordinator``
    gates singleton duties; ``set_weights`` routes a coordinator's
    traffic-split writes through the fenced path; ``peers`` feeds the
    /fleet federation).

    Degrades to a no-op "always coordinator" when federation is off or
    the store has no lease API (the in-memory store) — callers never
    branch on the mode themselves."""

    def __init__(self, store, replica_id: Optional[str] = None, *,
                 ttl_s: Optional[float] = None,
                 base_url: Optional[str] = None,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.replica_id = (
            replica_id
            or os.environ.get("SELDON_TPU_GW_REPLICA_ID")
            or f"gw-{secrets.token_hex(4)}"
        )
        self.ttl_s = float(ttl_s if ttl_s is not None else lease_ttl_s())
        self.base_url = base_url
        self.clock = clock
        self.enabled = (
            federation_enabled() and hasattr(store, "acquire_lease")
        )
        self._token: Optional[int] = None
        self._store_error: Optional[str] = None
        self._last_tick = 0.0
        self._transitions = 0
        #: the gateway's TenantGovernor (set by gateway_main / tests) —
        #: source of the throttle/shed half of the burn delta
        self.governor = None
        self._burn_publishes = 0
        self._burn_folds = 0
        self._burn_errors = 0

    # -- the protocol ------------------------------------------------------

    def tick(self) -> bool:
        """Claim or renew the coordinator lease + heartbeat the peer row;
        returns whether this replica is the coordinator NOW."""
        if not self.enabled:
            return True
        was = self._token is not None
        try:
            token = self.store.acquire_lease(
                COORDINATOR_LEASE, self.replica_id, self.ttl_s)
            if self.base_url:
                self.store.heartbeat_peer(
                    self.replica_id, self.base_url, self.ttl_s)
            self._store_error = None
        except Exception as e:  # noqa: BLE001 — a partitioned store must
            # demote (tenure can't be proven) without crashing the loop
            token = None
            self._store_error = f"{type(e).__name__}: {e}"
            RECORDER.record_lease_transition("store_error")
        self._last_tick = self.clock()
        if token is not None and not was:
            RECORDER.record_lease_transition("acquired")
            self._transitions += 1
        elif token is None and was:
            RECORDER.record_lease_transition("lost")
            self._transitions += 1
        self._token = token
        # fleet-truth burn rides the same cadence (ttl/3): publish this
        # replica's deltas, fold every peer's — EVERY replica folds (the
        # view feeds local brownout/rollout decisions, not a singleton
        # duty), so it does not gate on the coordinator lease
        self._burn_tick()
        return token is not None

    # -- fleet-truth burn (federated SLO/QoS accounting) -------------------

    #: how far back one window's published counts stay credible: a dead
    #: replica's last delta keeps counting until the window it measured
    #: has fully aged out — failover cannot amnesia away burned budget
    #: "admission" is a synthetic window: per-tenant token-bucket
    #: admission totals (requests/throttled/shed) riding the same
    #: burn_deltas lane so /fleet can show fleet-wide per-tenant
    #: admission rates without a second store table
    _WINDOW_SPANS = {"5m": 300.0, "1h": 3600.0, "admission": 300.0}

    def _burn_tick(self) -> None:
        """Publish this replica's SLO window counts + QoS throttle/shed
        totals into the shared ``burn_deltas`` table, then fold EVERY
        replica's last published counts into the process-global
        :data:`~seldon_core_tpu_torch.utils.quality.FLEET_BURN` view.  Rides
        ``tick()`` — off every request path.  No SLO configured means no
        SLO burn rows (exactly the local tracker's contract), but
        per-tenant ADMISSION rows (synthetic window ``"admission"``:
        total=requests, throttled/shed from the token buckets) still
        publish whenever a governor is live — admission truth does not
        require an SLO.  Store errors are counted and the stale view
        degrades consumers to their per-replica rings (fail-closed
        toward pre-fleet behaviour)."""
        from seldon_core_tpu_torch.utils.quality import (
            QUALITY,
            fleet_burn_enabled,
        )

        if (not fleet_burn_enabled()
                or not hasattr(self.store, "publish_burn")):
            return
        gov = self.governor
        tenants_qos = gov.burn_totals() if gov is not None else {}
        if not QUALITY.slo.configured and not tenants_qos:
            return
        try:
            throttled = sum(
                v["throttled"] for v in tenants_qos.values())
            shed = sum(v["shed"] for v in tenants_qos.values())
            rows = []
            if QUALITY.slo.configured:
                for window, c in QUALITY.slo.window_counts().items():
                    rows.append(
                        ("_global", window, c["total"], c["slow"],
                         c["errors"], throttled, shed))
                for tenant, wins in (
                        QUALITY.tenant_window_counts().items()):
                    qos = tenants_qos.get(tenant, {})
                    for window, c in wins.items():
                        rows.append(
                            (tenant, window, c["total"], c["slow"],
                             c["errors"], qos.get("throttled", 0),
                             qos.get("shed", 0)))
            for tenant, qos in tenants_qos.items():
                rows.append((tenant, "admission",
                             qos.get("requests", 0), 0, 0,
                             qos.get("throttled", 0),
                             qos.get("shed", 0)))
            self.store.publish_burn(self.replica_id, rows)
            self._burn_publishes += 1
            self._burn_fold()
        except Exception:  # noqa: BLE001 — a sick store already demoted
            # us above; burn degrades to the per-replica view via
            # staleness, never by crashing the tick loop
            self._burn_errors += 1

    def _burn_fold(self) -> None:
        """Sum every replica's fresh-enough counts per (scope, window)
        and publish the aggregate — the SAME burn math as the local ring
        (``SloTracker.burn_entry``) over summed counts, so fleet and
        local views cannot diverge in formula, only in scope."""
        from seldon_core_tpu_torch.utils.quality import (
            FLEET_BURN,
            QUALITY,
            SloTracker,
        )

        now = time.time()
        agg: dict = {}
        admission: dict = {}
        replicas = set()
        for r in self.store.burn_rows():
            span = self._WINDOW_SPANS.get(r["window"], 300.0)
            if now - r["updated"] > span:
                continue
            replicas.add(r["replica_id"])
            if r["window"] == "admission":
                # synthetic window: cumulative admission counts, no
                # burn-rate math — total carries the request counter
                adm = admission.setdefault(
                    r["scope"], {"requests": 0, "throttled": 0,
                                 "shed": 0})
                adm["requests"] += r["total"]
                adm["throttled"] += r["throttled"]
                adm["shed"] += r["shed"]
                continue
            a = agg.setdefault(
                (r["scope"], r["window"]), [0, 0, 0, 0, 0])
            a[0] += r["total"]
            a[1] += r["slow"]
            a[2] += r["errors"]
            a[3] += r["throttled"]
            a[4] += r["shed"]
        p99_ms = QUALITY.slo.p99_ms
        error_rate = QUALITY.slo.error_rate
        windows: dict = {}
        tenants: dict = {}
        for (scope, window), a in sorted(agg.items()):
            entry = SloTracker.burn_entry(
                a[0], a[1], a[2], p99_ms, error_rate)
            entry["throttled"] = a[3]
            entry["shed"] = a[4]
            if scope == "_global":
                windows[window] = entry
            else:
                tenants.setdefault(scope, {})[window] = entry
        for scope, adm in sorted(admission.items()):
            tenants.setdefault(scope, {})["admission"] = adm
        FLEET_BURN.publish({
            "replicas": sorted(replicas),
            "windows": windows,
            "tenants": tenants,
            "folded_at": round(now, 3),
            "folded_by": self.replica_id,
        })
        self._burn_folds += 1
        for window, entry in windows.items():
            RECORDER.set_fleet_burn(window, entry["burn_rate"])

    def resign(self) -> None:
        """Graceful shutdown: hand the lease over NOW instead of making
        the fleet wait out the TTL, and leave the peer directory."""
        if not self.enabled:
            return
        try:
            if self._token is not None:
                self.store.release_lease(
                    COORDINATOR_LEASE, self.replica_id, self._token)
                RECORDER.record_lease_transition("released")
                self._transitions += 1
            self.store.drop_peer(self.replica_id)
        except Exception:  # noqa: BLE001 — best effort on the way out
            pass
        self._token = None

    async def run(self, stop: Optional[asyncio.Event] = None) -> None:
        """Tick at ttl/3 (two missable heartbeats before the lease
        lapses) until ``stop`` is set."""
        interval = max(self.ttl_s / 3.0, 0.05)
        while stop is None or not stop.is_set():
            self.tick()
            if stop is None:
                await asyncio.sleep(interval)
            else:
                try:
                    await asyncio.wait_for(stop.wait(), interval)
                except asyncio.TimeoutError:
                    pass

    # -- read side ---------------------------------------------------------

    @property
    def is_coordinator(self) -> bool:
        return True if not self.enabled else self._token is not None

    @property
    def fencing_token(self) -> Optional[int]:
        return self._token

    def set_weights(self, deployment_id: str, weights) -> None:
        """The rollout controller's traffic-split lever, fenced: when
        federation is live the write proves tenure inside the store's
        own transaction; otherwise it is the plain store write."""
        if self.enabled and self._token is not None:
            self.store.fenced_set_weights(
                deployment_id, weights,
                lease=COORDINATOR_LEASE,
                holder=self.replica_id, token=self._token)
        else:
            self.store.set_weights(deployment_id, weights)

    def peers(self) -> List[Tuple[str, str]]:
        """Live sibling replicas as (replica_id, base_url) — the /fleet
        federation's fan-out list (this replica excluded)."""
        if not self.enabled:
            return []
        try:
            return list(self.store.peers(exclude=self.replica_id))
        except Exception:  # noqa: BLE001
            return []

    def engine_leases(self):
        """All engine leases (url -> (boot_id, expires)), {} when the
        store has none or is unreachable — the balancer's liveness feed."""
        if not self.enabled or not hasattr(self.store, "engine_leases"):
            return {}
        try:
            return dict(self.store.engine_leases())
        except Exception:  # noqa: BLE001
            return {}

    def snapshot(self) -> dict:
        """The /stats ``federation`` block."""
        doc = {
            "enabled": self.enabled,
            "replica_id": self.replica_id,
            "coordinator": self.is_coordinator,
            "lease_ttl_s": self.ttl_s,
            "transitions": self._transitions,
        }
        if self.enabled:
            doc["fencing_token"] = self._token
            doc["fleet_burn"] = {
                "publishes": self._burn_publishes,
                "folds": self._burn_folds,
                "errors": self._burn_errors,
            }
            doc["peers"] = [
                {"replica_id": rid, "url": url} for rid, url in self.peers()
            ]
            if self._store_error:
                doc["store_error"] = self._store_error
            try:
                lease = self.store.lease(COORDINATOR_LEASE)
            except Exception:  # noqa: BLE001
                lease = None
            if lease is not None:
                doc["lease"] = {
                    "holder": lease["holder"],
                    "token": lease["token"],
                    "expires_in_s": round(lease["expires"] - time.time(), 3),
                }
        return doc
