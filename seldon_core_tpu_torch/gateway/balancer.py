"""Engine replica sets and power-of-two-choices balancing at the gateway —
the port's copy of ``seldon_core_tpu/gateway/balancer.py``.

* a :class:`ReplicaSet` holds N endpoints of one predictor: engine base
  URLs, ``uds:`` socket paths (the ``runtime/udsrelay.py`` lane) or
  in-process ``EngineService`` objects (whose ``gen_role`` is the
  endpoint's role);
* :meth:`ReplicaSet.pick` samples two distinct replicas with the set's
  ``random.Random`` and takes the lower score, ``(outstanding requests) x
  (EWMA latency)``, shape-aware when the request's rows are known and the
  autopilot is on;
* health is passive: :meth:`ReplicaSet.scrape_once` reads every URL
  endpoint's ``GET /stats`` concurrently through the gateway's one upstream
  client (``runtime/client.py`` ``HttpClient``), each under a 1 s timeout,
  and subtracts only this gateway's own batcher-bound inflight from the
  engine's figure; a failed or stale scrape, an open breaker, a run of
  fast failures or a lapsed engine lease degrades a replica by a score
  penalty;
* picks, gateway-side inflight and hindsight mispicks land in the
  ``seldon_tpu_replica_*`` families, and the chosen replica with both
  candidates' scores rides the request span.

``SELDON_TPU_REPLICAS=0`` is the kill switch: every pick returns the first
endpoint with no sampling, no scoring and no metrics.
"""

from __future__ import annotations

import os
import random
import re
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from seldon_core_tpu_torch.runtime.autopilot import autopilot_enabled, pad_bucket
from seldon_core_tpu_torch.utils.telemetry import RECORDER

__all__ = [
    "ReplicaEndpoint",
    "ReplicaSet",
    "PickDecision",
    "parse_endpoint_spec",
    "replicas_enabled",
    "uds_enabled",
]

#: EWMA smoothing for per-replica latency; small enough to remember a
#: slow spell for ~10 requests, large enough to converge fast after boot
_EWMA_ALPHA = 0.2
#: score floor so a no-sample-yet replica isn't infinitely attractive
_EWMA_FLOOR_MS = 0.1
#: additive score penalty for a degraded replica (breaker open / scrape
#: failed / scrape stale / fast-failing): it still serves when EVERY
#: candidate is degraded, but never beats a healthy one
_UNHEALTHY_PENALTY = 1e9
#: an idle, healthy endpoint whose last completed sample is older than
#: this prices at the floor so p2c sends it ONE probe, and a probe that
#: wildly disagrees with the stale EWMA RESEEDS it instead of blending.
#: Without this an endpoint whose first sample ate a one-off cost (kernel
#: build, cold page cache) can be starved FOREVER: p2c never re-picks
#: it, so its poisoned EWMA never gets a correcting sample.  Cost of the
#: escape hatch: at most one redirected request per window per idle
#: endpoint.  SELDON_TPU_REPROBE_S overrides; 0 disables
_REPROBE_AFTER_S = 0.1
#: blend-vs-reseed trust region: a fresh sample within this factor of
#: the stale EWMA still blends (low-traffic endpoints keep smoothing);
#: beyond it the history is judged wrong and replaced
_REPROBE_RESEED_X = 4.0


def reprobe_after_s() -> float:
    try:
        return float(os.environ.get(
            "SELDON_TPU_REPROBE_S", str(_REPROBE_AFTER_S)))
    except ValueError:
        return _REPROBE_AFTER_S
#: consecutive dispatch failures before a replica is degraded — without
#: this a replica that FAILS in microseconds drains its inflight
#: instantly, scores at the EWMA floor, and becomes a traffic black hole
#: (failures don't update the EWMA, so nothing else raises its score)
_FAIL_DEGRADE_AFTER = 3
#: how long the failure degradation lasts after the latest failure — the
#: passive half-open: after a quiet cooldown the replica gets sampled
#: again, and one success clears it (one more failure re-arms it)
_FAIL_DEGRADE_COOLDOWN_S = 5.0


def replicas_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_REPLICAS=0`` restores the single-engine
    path (first registered endpoint, no p2c, no replica metrics)."""
    return os.environ.get("SELDON_TPU_REPLICAS", "1") != "0"


def uds_enabled() -> bool:
    """Kill switch: ``SELDON_TPU_UDS=0`` keeps every dispatch on TCP even
    when an endpoint advertises a ``uds:`` socket path."""
    return os.environ.get("SELDON_TPU_UDS", "1") != "0"


def _pm_note(reason: str, **attrs) -> None:
    """Out-of-band postmortem breadcrumb for fleet-health transitions
    (lease flips, breaker opens).  These events have no open request
    span, so they land as traceless synthetic exemplars — bounded, and
    inert when the recorder is disabled.  Never raises: replica health
    bookkeeping must not depend on the observability layer."""
    try:
        from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

        POSTMORTEM.note("", reason, **attrs)
    except Exception:  # noqa: BLE001 - breadcrumbs are best-effort
        pass


def fleet_scrape_enabled() -> bool:
    """Should the scrape pass retain fleet documents (gateway/fleet.py)?
    Off with the federation kill switch (``SELDON_TPU_FLEET=0``) or
    explicitly via ``SELDON_TPU_FLEET_SCRAPE=0`` (health scraping keeps
    its original, lighter shape in both cases)."""
    if os.environ.get("SELDON_TPU_FLEET_SCRAPE", "1") == "0":
        return False
    from seldon_core_tpu_torch.gateway.fleet import fleet_enabled

    return fleet_enabled()


def parse_endpoint_spec(spec: str) -> Tuple[Optional[str], Optional[str]]:
    """``(base_url, uds_path)`` from an endpoint spec string.

    Three forms (gateway_main env contract, docs/operations.md):

    * ``http://host:port``                   TCP only
    * ``uds:/path/to.sock``                  UDS only (no /stats scrape,
                                             no SSE proxy — hot path only)
    * ``http://host:port+uds:/path/to.sock`` TCP for scrape/stream, UDS
                                             for the predict/feedback hot
                                             path
    """
    spec = spec.strip()
    if "+uds:" in spec:
        base, _, uds = spec.partition("+uds:")
        return base.rstrip("/") or None, uds or None
    if spec.startswith("uds:"):
        return None, spec[len("uds:"):] or None
    return spec.rstrip("/") or None, None


class ReplicaEndpoint:
    """One engine replica as the gateway sees it: the dispatch target plus
    the live score inputs (gateway-side inflight, EWMA latency, scraped
    engine-side inflight + breaker state)."""

    __slots__ = (
        "target", "base_url", "uds_path", "name", "index", "set_name",
        "role", "inflight", "batcher_inflight", "ewma_ms", "shape_ms",
        "picks", "failures", "consec_failures", "fail_degraded_until",
        "scraped_inflight", "scraped_free_kv", "scrape_ts",
        "scrape_failed", "breaker_open", "fleet_docs",
        "boot_id", "epoch_resets", "lease_state",
        "last_sample_ts", "ewma_reseeds",
    )

    #: minimum samples before a shape bucket's own EWMA is trusted
    #: outright; below it the prediction blends toward the global EWMA
    SHAPE_MIN_SAMPLES = 5
    #: bounded per-shape table — pow2 buckets give ~20 keys max anyway
    SHAPE_MAX_BUCKETS = 32

    def __init__(self, target, index: int = 0, set_name: str = "default"):
        self.index = index
        self.set_name = set_name
        #: generation role in a disaggregated mesh
        #: (runtime/servingmesh.py): "prefill" / "decode" / "unified".
        #: Decode replicas only import KV handoffs — the gateway's picks
        #: exclude them from client traffic (phase-aware routing)
        self.role = "unified"
        if isinstance(target, str):
            spec = target
            # the +role: segment may sit anywhere among the spec's
            # + suffixes (e.g. url+role:decode+uds:/e.sock): extract the
            # segment, keep the rest — an order-sensitive parse would
            # silently swallow whatever follows it
            m = re.search(r"\+role:([a-zA-Z]+)", spec)
            if m:
                role = m.group(1).lower()
                if role in ("prefill", "decode", "unified"):
                    self.role = role
                spec = spec[:m.start()] + spec[m.end():]
            self.base_url, self.uds_path = parse_endpoint_spec(spec)
            self.target = target
            self.name = self.base_url or f"uds:{self.uds_path}"
        else:  # in-process EngineService-like object
            self.base_url = None
            self.uds_path = None
            self.target = target
            self.name = f"inprocess-{index}"
            role = getattr(target, "gen_role", "unified")
            if role in ("prefill", "decode", "unified"):
                self.role = role
        self.inflight = 0
        # the subset of ``inflight`` that rides the engine's MicroBatcher
        # (unary predicts) — the only part the scraped engine-side
        # ``inflight_dispatches`` figure can also contain
        self.batcher_inflight = 0
        self.ewma_ms = 0.0  # 0 = no successful sample yet
        #: free paged-KV blocks scraped off the /stats genserver block —
        #: the decode-capacity headroom signal (None = not a generator)
        self.scraped_free_kv: Optional[int] = None
        # per-request-shape latency models (autopilot cost-aware routing):
        # pad bucket (pow2 of row count) -> [ewma_ms, samples].  A 1-row
        # predict and a 512-row predict have wildly different walls; a
        # shape-blind EWMA averages them into a score that mispredicts
        # both.  SELDON_TPU_AUTOPILOT=0 restores the blind EWMA
        self.shape_ms: dict = {}
        self.picks = 0
        #: monotonic time of the last SUCCESSFUL completed sample; 0 =
        #: never sampled.  Drives the stale-EWMA re-probe (see
        #: _REPROBE_AFTER_S)
        self.last_sample_ts = 0.0
        #: times a re-probe sample replaced (not blended into) a stale
        #: EWMA that disagreed beyond the trust region
        self.ewma_reseeds = 0
        self.failures = 0
        self.consec_failures = 0
        self.fail_degraded_until = 0.0
        # passive health, fed by ReplicaSet.scrape_once
        self.scraped_inflight = 0
        self.scrape_ts = 0.0
        self.scrape_failed = False
        self.breaker_open = False
        #: fleet-observability document stash (gateway/fleet.py): the
        #: full /stats (+ /perf + /quality) docs the LAST scrape pass
        #: retained, with a monotonic timestamp — /fleet rollups and the
        #: seldon_tpu_fleet_* outlier gauges read from here so the
        #: aggregation adds zero polling of its own
        self.fleet_docs: Optional[dict] = None
        #: engine boot epoch, scraped off /stats (or carried by the
        #: engine's liveness lease).  A CHANGE at the same URL means the
        #: process restarted: every score input learned about the dead
        #: process (EWMA, shape models, failure streaks, scraped load)
        #: describes nobody and is reset instead of poisoning picks
        self.boot_id: Optional[str] = None
        self.epoch_resets = 0
        #: store-lease liveness (gateway/federation.py feed): None until
        #: the engine ever heartbeats a lease, then "live"/"dead".  A
        #: lapsed or dropped lease marks the replica dead within one
        #: lease TTL — faster than 3 failed scrapes
        self.lease_state: Optional[str] = None

    def observe_boot_id(self, boot_id: Optional[str]) -> None:
        """Record the engine's boot epoch; on a change at the same URL,
        reset every score input the previous process earned."""
        if not boot_id:
            return
        if self.boot_id is not None and boot_id != self.boot_id:
            self.ewma_ms = 0.0
            self.last_sample_ts = 0.0
            self.shape_ms = {}
            self.consec_failures = 0
            self.fail_degraded_until = 0.0
            self.scraped_inflight = 0
            self.breaker_open = False
            self.epoch_resets += 1
        self.boot_id = boot_id

    # -- health ----------------------------------------------------------

    def degraded(self, now: float, stale_after_s: float) -> bool:
        if self.lease_state == "dead":
            return True
        # fast-failure degradation applies to EVERY target kind — it is
        # the only health signal a uds-only or in-process endpoint has,
        # and the cooldown expiring is the passive half-open probe
        if now < self.fail_degraded_until:
            return True
        if isinstance(self.target, str):
            if self.breaker_open or self.scrape_failed:
                return True
            # staleness only counts once a scrape ever succeeded — sets
            # that never run the scraper (tests, in-bench single shots)
            # must not read as degraded
            return (
                self.scrape_ts > 0.0
                and now - self.scrape_ts > stale_after_s
            )
        # in-process: breaker state is readable directly, no scrape needed
        open_breakers = getattr(self.target, "open_breakers", None)
        return bool(open_breakers()) if callable(open_breakers) else False

    def predicted_ms(self, rows: Optional[int] = None) -> float:
        """Per-request latency prediction for a request of ``rows`` rows:
        the pad bucket's own EWMA once it has ``SHAPE_MIN_SAMPLES``,
        blended toward the shape-blind global EWMA below that, and the
        global EWMA when the shape is unknown or the autopilot is off —
        bit-for-bit the pre-autopilot score input in that case."""
        if rows is None or not autopilot_enabled():
            return self.ewma_ms
        model = self.shape_ms.get(pad_bucket(rows))
        if model is None or model[1] == 0:
            return self.ewma_ms
        ms, n = model
        if n >= self.SHAPE_MIN_SAMPLES or self.ewma_ms == 0.0:
            return ms
        w = n / self.SHAPE_MIN_SAMPLES
        return w * ms + (1.0 - w) * self.ewma_ms

    def score(self, now: float, stale_after_s: float,
              rows: Optional[int] = None) -> float:
        """Expected wait: (queued work) x (per-request cost).  Gateway-side
        inflight is authoritative for work THIS gateway queued; the scraped
        engine-side inflight adds load other gateways put there.  The
        per-request cost is shape-aware when the caller passes the request
        row count (autopilot cost-aware routing)."""
        ms = max(self.predicted_ms(rows), _EWMA_FLOOR_MS)
        degraded = self.degraded(now, stale_after_s)
        reprobe = reprobe_after_s()
        if (
            not degraded
            and reprobe > 0.0
            and self.inflight == 0
            and self.last_sample_ts > 0.0
            and now - self.last_sample_ts > reprobe
        ):
            # idle + healthy + no fresh sample: the EWMA is hearsay.
            # Price at the floor so p2c sends ONE probe (the inflight
            # gate stops a pile-on while the probe is out) — the
            # completion either confirms the history or reseeds it
            ms = _EWMA_FLOOR_MS
        s = (self.inflight + self.scraped_inflight + 1) * ms
        if degraded:
            s += _UNHEALTHY_PENALTY
        return s

    # -- dispatch accounting ---------------------------------------------

    def begin(self, batcher: bool = True) -> None:
        """``batcher=False`` for dispatches that do NOT enter the engine's
        MicroBatcher (streams, feedback acks) — they count as load but must
        not be subtracted from the scraped engine-side figure."""
        self.inflight += 1
        if batcher:
            self.batcher_inflight += 1
        RECORDER.set_replica_inflight(self.set_name, self.name, self.inflight)

    def complete(self, latency_s: float, ok: bool = True,
                 rows: Optional[int] = None) -> None:
        self.inflight = max(0, self.inflight - 1)
        self.batcher_inflight = max(0, self.batcher_inflight - 1)
        RECORDER.set_replica_inflight(self.set_name, self.name, self.inflight)
        if ok:
            ms = latency_s * 1e3
            now = time.monotonic()
            reprobe = reprobe_after_s()
            stale = (
                reprobe > 0.0
                and self.last_sample_ts > 0.0
                and now - self.last_sample_ts > reprobe
            )
            if self.ewma_ms == 0.0:
                self.ewma_ms = ms
            elif stale and not (
                self.ewma_ms / _REPROBE_RESEED_X
                <= ms
                <= self.ewma_ms * _REPROBE_RESEED_X
            ):
                # stale history that a fresh probe contradicts beyond
                # the trust region is judged WRONG, not smoothed: a
                # compile-poisoned 400ms first sample blended at
                # alpha=0.2 needs ~10 probes to converge, and p2c only
                # grants one probe per re-probe window — reseed instead
                self.ewma_ms = ms
                self.ewma_reseeds += 1
            else:
                self.ewma_ms = (
                    (1 - _EWMA_ALPHA) * self.ewma_ms + _EWMA_ALPHA * ms
                )
            self.last_sample_ts = now
            if rows is not None:
                bucket = pad_bucket(rows)
                model = self.shape_ms.get(bucket)
                if model is not None:
                    model[0] = (
                        (1 - _EWMA_ALPHA) * model[0] + _EWMA_ALPHA * ms
                    )
                    model[1] += 1
                elif len(self.shape_ms) < self.SHAPE_MAX_BUCKETS:
                    self.shape_ms[bucket] = [ms, 1]
            self.consec_failures = 0
            self.fail_degraded_until = 0.0
        else:
            self.failures += 1
            self.consec_failures += 1
            if self.consec_failures >= _FAIL_DEGRADE_AFTER:
                # a fast-failing replica would otherwise WIN every pick:
                # failures drain inflight instantly and never raise the
                # EWMA, pinning its score at the floor — degrade it for a
                # cooldown instead of letting it eat the traffic
                self.fail_degraded_until = (
                    time.monotonic() + _FAIL_DEGRADE_COOLDOWN_S
                )

    def release(self, batcher: bool = False) -> None:
        """End a dispatch WITHOUT a latency sample — long-lived streams
        and feedback acks: their wall time isn't comparable to a unary
        EWMA, but while they run they must count as load or p2c keeps
        stacking unary traffic onto a stream-saturated replica.
        ``batcher=True`` when closing a dispatch that was begun as
        batcher-bound (the neutral-accounting unary path)."""
        self.inflight = max(0, self.inflight - 1)
        if batcher:
            self.batcher_inflight = max(0, self.batcher_inflight - 1)
        RECORDER.set_replica_inflight(self.set_name, self.name, self.inflight)

    def snapshot(self) -> dict:
        return {
            "endpoint": self.name,
            "uds_path": self.uds_path,
            "role": self.role,
            "free_kv_blocks": self.scraped_free_kv,
            "inflight": self.inflight,
            "scraped_inflight": self.scraped_inflight,
            "ewma_ms": round(self.ewma_ms, 3),
            "ewma_reseeds": self.ewma_reseeds,
            "picks": self.picks,
            "failures": self.failures,
            "consec_failures": self.consec_failures,
            "fail_degraded": time.monotonic() < self.fail_degraded_until,
            "breaker_open": self.breaker_open,
            "scrape_failed": self.scrape_failed,
            "boot_id": self.boot_id,
            "epoch_resets": self.epoch_resets,
            "lease_state": self.lease_state,
        }


@dataclass
class PickDecision:
    """Why a replica was chosen — stamped onto the request span and used
    for hindsight mispick accounting at completion."""

    replica: str
    candidates: List[str]
    scores: List[float]
    #: losing candidate's EWMA at decision time (0 = no sample / solo pick)
    loser_ewma_ms: float = 0.0


class ReplicaSet:
    """N engine endpoints for one predictor + the p2c pick over them."""

    def __init__(self, targets, rng: Optional[random.Random] = None,
                 stale_after_s: Optional[float] = None,
                 name: str = "default"):
        if not targets:
            raise ValueError("ReplicaSet needs at least one endpoint")
        #: replica-set identity (deployment/predictor at the gateway) —
        #: the `set` label on the seldon_tpu_replica_* families, so
        #: imbalance is judged WITHIN a set, never across sets
        self.name = name
        self.endpoints = [
            ReplicaEndpoint(t, i, set_name=name)
            for i, t in enumerate(targets)
        ]
        self._rng = rng or random.Random(0)
        if stale_after_s is None:
            stale_after_s = 3.0 * scrape_interval_s()
        self.stale_after_s = float(stale_after_s)
        self.mispicks = 0

    def __len__(self) -> int:
        return len(self.endpoints)

    # -- the balancer ----------------------------------------------------

    def pick(
        self, eligible=None, rows: Optional[int] = None
    ) -> Tuple[ReplicaEndpoint, Optional[PickDecision]]:
        """Power-of-two-choices; ``decision`` is None exactly on the paths
        that predate replica sets (kill switch / single endpoint), so the
        span stays byte-identical there.  ``eligible`` narrows the p2c
        pool to endpoints a caller can actually use (e.g. streams need a
        TCP/in-process lane) so the pick — and its metrics — land on the
        endpoint that serves; an empty filtered pool falls back to the
        full set and the caller handles the capability miss.  ``rows``
        makes the score's latency term shape-aware (autopilot cost-aware
        routing): each candidate is priced for THIS request's pad bucket
        instead of its shape-blind EWMA."""
        if not replicas_enabled() or len(self.endpoints) == 1:
            return self.endpoints[0], None
        pool = self.endpoints
        if eligible is not None:
            pool = [ep for ep in pool if eligible(ep)] or self.endpoints
        now = time.monotonic()
        if len(pool) == 1:
            chosen = pool[0]
            chosen.picks += 1
            RECORDER.record_replica_pick(self.name, chosen.name)
            return chosen, PickDecision(
                replica=chosen.name, candidates=[chosen.name],
                scores=[round(
                    chosen.score(now, self.stale_after_s, rows), 4
                )],
                loser_ewma_ms=0.0,
            )
        i, j = self._rng.sample(range(len(pool)), 2)
        a, b = pool[i], pool[j]
        sa, sb = (
            a.score(now, self.stale_after_s, rows),
            b.score(now, self.stale_after_s, rows),
        )
        chosen, loser = (a, b) if sa <= sb else (b, a)
        chosen.picks += 1
        RECORDER.record_replica_pick(self.name, chosen.name)
        if rows is not None and autopilot_enabled():
            # count only picks a shape model actually informed — a pick
            # that fell back to the shape-blind EWMA on both candidates
            # is not a predictive decision
            bucket = pad_bucket(rows)
            if a.shape_ms.get(bucket) or b.shape_ms.get(bucket):
                RECORDER.record_autopilot_decision("p2c")
        return chosen, PickDecision(
            replica=chosen.name,
            candidates=[a.name, b.name],
            scores=[round(sa, 4), round(sb, 4)],
            # a degraded loser doesn't judge the pick: beating a sick
            # replica's historical EWMA is not a prediction error, and
            # counting it would pin the mispick ratio at 1.0 exactly
            # while the balancer steers correctly.  Hindsight uses the
            # same shape-aware prediction the pick scored with
            loser_ewma_ms=(
                0.0 if loser.degraded(now, self.stale_after_s)
                else loser.predicted_ms(rows)
            ),
        )

    def complete(self, endpoint: ReplicaEndpoint,
                 decision: Optional[PickDecision],
                 latency_s: float, ok: bool = True,
                 rows: Optional[int] = None) -> None:
        """Close one dispatch: update the endpoint's score inputs and judge
        the pick in hindsight (mispick = a successful request that ran
        longer than the losing candidate's EWMA at decision time — the
        loser would LIKELY have been faster)."""
        endpoint.complete(latency_s, ok=ok, rows=rows)
        if (
            ok
            and decision is not None
            and decision.loser_ewma_ms > 0.0
            and latency_s * 1e3 > decision.loser_ewma_ms
        ):
            self.mispicks += 1
            RECORDER.record_replica_mispick()

    # -- store-lease liveness (gateway/federation.py feed) ---------------

    def apply_leases(self, leases) -> None:
        """Fold the shared store's engine-lease table (url -> (boot_id,
        expires)) into endpoint health.  Only engines that EVER
        heartbeated participate — an endpoint with no lease row keeps
        scrape-based health untouched (mixed fleets, tests, engines
        started without a store).  A lapsed or dropped lease marks the
        replica dead within one lease TTL, long before three scrapes
        fail; the lease's boot_id doubles as an early epoch signal."""
        if not leases and not any(
            ep.lease_state is not None for ep in self.endpoints
        ):
            return
        now = time.time()
        for ep in self.endpoints:
            if ep.base_url is None:
                continue
            row = leases.get(ep.base_url) or leases.get(ep.base_url + "/")
            prev = ep.lease_state
            if row is None:
                # an engine that once held a lease and now has NO row
                # deregistered (graceful drain) — dead until it returns
                if ep.lease_state is not None:
                    ep.lease_state = "dead"
                    if prev == "live":
                        _pm_note("lease", endpoint=ep.base_url,
                                 transition="live->dead", cause="dropped")
                continue
            boot_id, expires = row
            if float(expires) > now:
                ep.lease_state = "live"
                ep.observe_boot_id(boot_id)
                if prev == "dead":
                    _pm_note("lease", endpoint=ep.base_url,
                             transition="dead->live")
            else:
                ep.lease_state = "dead"
                if prev == "live":
                    _pm_note("lease", endpoint=ep.base_url,
                             transition="live->dead", cause="lapsed")

    # -- passive health (the /stats scrape) ------------------------------

    async def scrape_once(self, client) -> int:
        """One scrape pass over the URL-backed endpoints: engine-side
        inflight dispatches + breaker state out of ``GET /stats``, through
        ``client`` (an ``HttpClient``).  Returns how many endpoints
        answered.  Never raises — a dead replica marks itself degraded.
        Endpoints scrape CONCURRENTLY, each under a 1 s timeout, so a pass
        is bounded by one timeout, not by how many replicas are down."""
        import asyncio

        async def one(ep) -> int:
            try:
                timeout = 1.0
                _status, doc = await client.get_json(ep.base_url + "/stats", timeout)
                if not isinstance(doc, dict):
                    raise ValueError("stats body is not an object")
                # boot epoch FIRST: a restarted engine at the same URL
                # resets the dead process's learned state before this
                # scrape's fresh readings land on top
                ep.observe_boot_id(doc.get("boot_id"))
                batch = (doc.get("telemetry") or {}).get("batch") or {}
                # subtract OWN batcher-bound inflight: the engine's
                # figure includes unary work THIS gateway queued, which
                # the score already counts live — double-counting a stale
                # snapshot of our own burst makes picks herd away from a
                # replica for a whole scrape interval after the burst
                # drained.  Only the batcher-bound subset is subtracted:
                # streams and feedback acks raise ep.inflight but never
                # appear in inflight_dispatches, and subtracting them
                # would erase OTHER gateways' real load from the signal
                ep.scraped_inflight = max(
                    0,
                    int(batch.get("inflight_dispatches", 0) or 0)
                    - ep.batcher_inflight,
                )
                breakers = (
                    (doc.get("resilience") or {}).get("breakers") or {}
                )
                was_open = ep.breaker_open
                ep.breaker_open = any(
                    (br or {}).get("state") not in (None, "closed")
                    for br in breakers.values()
                )
                if ep.breaker_open and not was_open:
                    _pm_note("breaker", endpoint=ep.base_url,
                             transition="closed->open")
                # free-KV-block headroom + role off the genserver block
                # (disaggregated mesh: the decode-capacity signal and
                # the role the endpoint actually serves)
                gs = doc.get("genserver")
                if isinstance(gs, dict):
                    kvb = gs.get("kv_blocks") or {}
                    try:
                        ep.scraped_free_kv = max(
                            0, int(kvb.get("total", 0))
                            - int(kvb.get("used", 0)))
                    except (TypeError, ValueError):
                        ep.scraped_free_kv = None
                    role = gs.get("role")
                    if role in ("prefill", "decode", "unified"):
                        ep.role = role
                # health is settled HERE — the optional fleet-document
                # fetches below must not delay the freshness stamp (two
                # hung 1 s GETs per pass would age scrape_ts past the
                # staleness window and falsely degrade a replica whose
                # /stats answered fine)
                ep.scrape_ts = time.monotonic()
                ep.scrape_failed = False
                # fleet observability rides the SAME pass: retain the
                # /stats doc and pull /perf + /quality alongside it
                # (concurrently — the pass stays bounded by ONE extra
                # timeout, not two) so /fleet rollups and the outlier
                # gauges need no polling of their own.  Failure here
                # must not mark the replica degraded.
                if fleet_scrape_enabled():
                    docs = {"stats": doc, "perf": None, "quality": None,
                            "postmortems": None, "ts": ep.scrape_ts}

                    async def _doc(path):
                        return (await client.get_json(ep.base_url + path, timeout))[1]

                    # return_exceptions: one surface erroring (quality
                    # observatory disabled, transient 500) must not
                    # throw away the OTHER doc that fetched fine
                    perf, quality, postmortems = await asyncio.gather(
                        _doc("/perf"), _doc("/quality"),
                        _doc("/postmortems"),
                        return_exceptions=True,
                    )
                    if isinstance(perf, asyncio.CancelledError) or \
                            isinstance(quality, asyncio.CancelledError) or \
                            isinstance(postmortems, asyncio.CancelledError):
                        raise asyncio.CancelledError
                    if not isinstance(perf, BaseException):
                        docs["perf"] = perf
                    if not isinstance(quality, BaseException):
                        docs["quality"] = quality
                    if not isinstance(postmortems, BaseException):
                        docs["postmortems"] = postmortems
                    ep.fleet_docs = docs
                return 1
            except asyncio.CancelledError:
                raise
            except Exception:
                # passive health: ANY scrape problem just marks the
                # replica degraded — an exception type we didn't predict
                # must not differ in effect from one we did
                ep.scrape_failed = True
                return 0

        # in-process / uds-only endpoints have no scrape surface
        targets = [ep for ep in self.endpoints if ep.base_url is not None]
        if not targets:
            return 0
        return sum(await asyncio.gather(*(one(ep) for ep in targets)))

    def snapshot(self) -> dict:
        inflight = [ep.inflight for ep in self.endpoints]
        mean = sum(inflight) / max(len(inflight), 1)
        return {
            "endpoints": [ep.snapshot() for ep in self.endpoints],
            "mispicks": self.mispicks,
            # max/mean of the gateway-side inflight — the imbalance the
            # bench arm and the SeldonTPUReplicaImbalance alert judge
            "inflight_max_over_mean": round(
                (max(inflight) / mean) if mean > 0 else 1.0, 3
            ),
        }


def scrape_interval_s() -> float:
    """``SELDON_TPU_GW_SCRAPE_S`` — how often the gateway refreshes each
    replica's /stats-derived health (default 2 s; stale = 3 intervals)."""
    try:
        return float(os.environ.get("SELDON_TPU_GW_SCRAPE_S", "") or 2.0)
    except ValueError:
        return 2.0
