"""Resource-attribution ledger — the aggregator behind ``GET /costs``;
the port's counterpart of ``seldon_core_tpu/utils/costledger.py``.

This layer answers **who** is consuming the card.  Producers (the
micro-batcher's flush record, the continuous-batching scheduler's tick
record, its block-release path, the wire / relay byte counters) attach a
small attribution payload to records they already write into the telemetry
spine (``utils/hotrecord.py``), and the spine's drainer folds them here,
off the serving path.  The identity comes from ``runtime/qos.py``
(``Seldon-Tenant`` / ``Seldon-Tier``).

Attribution rule:

  * each dispatch's or tick phase's **device wall** splits across its
    requests in proportion to real units (prefill: real prompt tokens;
    decode: live sequences; micro-batch: real rows).  The port's device
    wall is the wall its records already carry: from the dispatch's start
    to the readback the response (or the round) pays, not kernel time, and
    no synchronization is added to measure it;
  * the padded remainder (power-of-two capacity minus real units) goes to a
    per-tenant **pad-tax** bucket, split by the same real shares;
  * inter-tick bubbles go to ``idle``;
  * device wall that arrives with NO attribution payload goes to
    ``unattributed`` and lowers ``accounted_fraction`` (the
    ``seldon_tpu_cost_attributed_fraction`` gauge).

So the accounting identity

    sum(attributed) + pad_tax + idle + unattributed == device wall

holds BY CONSTRUCTION, and ``accounted_fraction`` is 1.0 whenever every fold
carried attribution.  Beyond device-seconds the ledger integrates
per-sequence **KV-block-seconds** (blocks x held time, stamped by the
scheduler at retire and preempt) and tenant-attributed **bytes** per lane,
and prices a ``capacity`` block (consumed vs available chip-seconds;
``devices`` is ``torch.cuda.device_count()`` for a CUDA engine, 1 on the
CPU).

``SELDON_TPU_QOS_USAGE_WEIGHTED=1`` makes the tenant governor's fair queue
(``runtime/qos.py`` ``TenantGovernor._tag``) advance each tenant's virtual
clock by :meth:`CostLedger.usage_advance`, its device-seconds a request
against the fleet average: fair share in card-seconds, not requests.  ``SELDON_TPU_COSTLEDGER=0`` is
the kill switch: producers build no payload and this module sees nothing;
serving is unchanged.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "CostLedger",
    "LEDGER",
    "costledger_enabled",
    "usage_weighted_enabled",
    "merge_cost_documents",
]

#: closed phase vocabulary for device-seconds attribution (Prometheus
#: label values on seldon_tpu_cost_device_seconds_total{phase=...})
COST_PHASES = ("batch", "prefill", "decode")


def costledger_enabled() -> bool:
    """Kill switch — read dynamically so tests can flip it per-case."""
    return os.environ.get("SELDON_TPU_COSTLEDGER", "1") != "0"


def usage_weighted_enabled() -> bool:
    """Opt-in: WFQ virtual clock advances by attributed cost."""
    return os.environ.get("SELDON_TPU_QOS_USAGE_WEIGHTED", "0") == "1"


class CostLedger:
    """Lock-protected fold target for attribution payloads.

    All ``fold_*`` methods run on the spine's drainer thread only;
    ``note_bytes`` is the one producer-side entry point (a dict
    increment under the lock, same price as the MetricsRecorder
    counters it rides next to).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._t0 = time.time()
        # (tenant, deployment, phase) -> attributed device seconds
        self.device_s: Dict[Tuple[str, str, str], float] = {}
        # (tenant, deployment) -> pad-tax seconds
        self.pad_tax_s: Dict[Tuple[str, str], float] = {}
        # (tenant, deployment) -> KV block-seconds (blocks x held-time)
        self.kv_block_s: Dict[Tuple[str, str], float] = {}
        # (tenant, deployment, lane) -> bytes
        self.bytes_by: Dict[Tuple[str, str, str], int] = {}
        # (tenant, deployment, phase) -> served tokens
        self.served_tokens: Dict[Tuple[str, str, str], int] = {}
        # (tier, phase) -> (device seconds incl. pad share, served tokens)
        self.tier_device_s: Dict[Tuple[str, str], float] = {}
        self.tier_tokens: Dict[Tuple[str, str], int] = {}
        # tenant -> [attributed seconds incl. pad share, request count]
        self._usage: Dict[str, List[float]] = {}
        self.idle_s = 0.0
        self.unattributed_s = 0.0
        self.wall_s = 0.0
        self.folds = 0
        #: chips this process drives (engine stamps it at device init);
        #: prices the capacity block's available chip-seconds
        self.devices = 1
        # deltas already pushed to Prometheus (publish_gauges)
        self._pub: Dict[Tuple[str, str, str], float] = {}
        self._pub_kv: Dict[Tuple[str, str], float] = {}
        self._pub_pad: Dict[Tuple[str, str], float] = {}

    # ---- fold side (drainer thread) ---------------------------------

    def _fold_phase(
        self,
        deployment: str,
        phase: str,
        device_s: float,
        padded_units: float,
        tenants: Iterable[Tuple[str, str, float, float, float]],
    ) -> None:
        """Split one dispatch's device wall (to its readback).

        ``tenants`` rows are ``(tenant, tier, real_units, requests,
        served_tokens)``; ``padded_units`` is the dispatched capacity
        (pow-2 bucket) the real units were padded up to.
        """
        rows = list(tenants)
        real = sum(t[2] for t in rows)
        with self._lock:
            self.wall_s += device_s
            self.folds += 1
            attributable = real > 0
            if device_s > 0 and not attributable:
                self.unattributed_s += device_s
            if not rows:
                return
            cap = max(float(padded_units), float(real), 1.0)
            pad_s = (device_s * (cap - real) / cap
                     if attributable else 0.0)
            for tenant, tier, units, requests, toks in rows:
                # zero-unit rows still book their request/served-token
                # counts (token emission is noted separately from the
                # device dispatch that produced it)
                share = (device_s * units / cap) if attributable else 0.0
                pad_share = (pad_s * units / real) if attributable else 0.0
                self.device_s[(tenant, deployment, phase)] = (
                    self.device_s.get((tenant, deployment, phase), 0.0)
                    + share
                )
                if pad_share > 0:
                    self.pad_tax_s[(tenant, deployment)] = (
                        self.pad_tax_s.get((tenant, deployment), 0.0)
                        + pad_share
                    )
                if toks:
                    self.served_tokens[(tenant, deployment, phase)] = (
                        self.served_tokens.get(
                            (tenant, deployment, phase), 0)
                        + int(toks)
                    )
                tier = tier or "batch"
                self.tier_device_s[(tier, phase)] = (
                    self.tier_device_s.get((tier, phase), 0.0)
                    + share + pad_share
                )
                if toks:
                    self.tier_tokens[(tier, phase)] = (
                        self.tier_tokens.get((tier, phase), 0) + int(toks)
                    )
                u = self._usage.setdefault(tenant, [0.0, 0.0])
                u[0] += share + pad_share
                u[1] += float(requests)

    def fold_flush(self, cost: Dict[str, Any],
                   device_s: float) -> None:
        """One micro-batcher flush (HOP_FLUSH with WANT_COST).

        The flush wall is readback-synced (the dispatch helper fetches
        outputs before the bracket closes), so it is this lane's honest
        device wall.
        """
        self._fold_phase(
            cost.get("dep", "") or "",
            "batch",
            float(device_s),
            float(cost.get("padded", 0.0)),
            cost.get("tenants") or (),
        )

    def fold_gen_tick(self, detail: Dict[str, Any]) -> None:
        """One scheduler tick (HOP_GEN_STEP with WANT_COST).

        ``detail["attr"]`` carries per-phase tenant splits and the
        tick's KV releases; ``detail["device_phases"]`` is the
        per-phase device wall; ``detail["bubble_s"]`` is the inter-tick
        gap (booked to idle whatever its bubble-ledger cause).
        """
        attr = detail.get("attr") or {}
        deployment = attr.get("dep", "") or ""
        phases = attr.get("phases") or {}
        for phase, dev in (detail.get("device_phases") or {}).items():
            dev = float(dev)
            if dev <= 0:
                continue
            pa = phases.get(phase)
            if pa:
                self._fold_phase(deployment, phase, dev,
                                 float(pa.get("padded", 0.0)),
                                 pa.get("tenants") or ())
            else:
                with self._lock:
                    self.wall_s += dev
                    self.unattributed_s += dev
        bubble = float(detail.get("bubble_s") or 0.0)
        kv = attr.get("kv") or ()
        with self._lock:
            if bubble > 0:
                self.wall_s += bubble
                self.idle_s += bubble
            for tenant, block_s in kv:
                if block_s > 0:
                    self.kv_block_s[(tenant, deployment)] = (
                        self.kv_block_s.get((tenant, deployment), 0.0)
                        + float(block_s)
                    )

    # ---- producer side ----------------------------------------------

    def note_bytes(self, tenant: str, deployment: str, lane: str,
                   n: int) -> None:
        """Attribute ingress/egress bytes.  Hot-path-cheap; callers
        gate on :func:`costledger_enabled`."""
        if n <= 0:
            return
        key = (tenant or "", deployment or "", lane)
        with self._lock:
            self.bytes_by[key] = self.bytes_by.get(key, 0) + int(n)

    def usage_advance(self, tenant: str) -> float:
        """Normalized per-request WFQ advance for ``tenant``.

        Ratio of the tenant's attributed cost per request to the
        process-wide mean, clamped to [0.25, 20] — heavy tenants'
        virtual clocks run faster, so WFQ stops treating a 10-token and
        a 10k-token request as equal.  1.0 until the ledger has data.
        """
        with self._lock:
            u = self._usage.get(tenant or "")
            if not u or u[1] <= 0:
                return 1.0
            g_cost = sum(v[0] for v in self._usage.values())
            g_req = sum(v[1] for v in self._usage.values())
            if g_cost <= 0 or g_req <= 0:
                return 1.0
            ratio = (u[0] / u[1]) / (g_cost / g_req)
        return min(20.0, max(0.25, ratio))

    # ---- read side --------------------------------------------------

    def _accounting_locked(self) -> Dict[str, Any]:
        attributed = sum(self.device_s.values())
        pad = sum(self.pad_tax_s.values())
        wall = self.wall_s
        frac = 1.0
        if wall > 0:
            frac = (attributed + pad + self.idle_s) / wall
        return {
            "device_wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "pad_tax_s": round(pad, 6),
            "idle_s": round(self.idle_s, 6),
            "unattributed_s": round(self.unattributed_s, 6),
            "accounted_fraction": round(frac, 6),
            "folds": self.folds,
        }

    def document(self) -> Dict[str, Any]:
        """The ``GET /costs`` body (engine-local; the gateway federates
        these with :func:`merge_cost_documents`)."""
        with self._lock:
            elapsed = max(time.time() - self._t0, 1e-9)
            rows: Dict[Tuple[str, str], Dict[str, Any]] = {}

            def row(tenant: str, dep: str) -> Dict[str, Any]:
                r = rows.get((tenant, dep))
                if r is None:
                    r = rows[(tenant, dep)] = {
                        "tenant": tenant,
                        "deployment": dep,
                        "device_s": {},
                        "pad_tax_s": 0.0,
                        "kv_block_s": 0.0,
                        "bytes": {},
                        "served_tokens": {},
                    }
                return r

            for (t, d, ph), v in self.device_s.items():
                row(t, d)["device_s"][ph] = round(v, 6)
            for (t, d), v in self.pad_tax_s.items():
                row(t, d)["pad_tax_s"] = round(v, 6)
            for (t, d), v in self.kv_block_s.items():
                row(t, d)["kv_block_s"] = round(v, 3)
            for (t, d, lane), v in self.bytes_by.items():
                row(t, d)["bytes"][lane] = v
            for (t, d, ph), v in self.served_tokens.items():
                row(t, d)["served_tokens"][ph] = v
            for r in rows.values():
                toks = sum(r["served_tokens"].values())
                cost = sum(r["device_s"].values()) + r["pad_tax_s"]
                r["cost_per_1k_served_tokens_s"] = (
                    round(1000.0 * cost / toks, 6) if toks else None
                )
            acct = self._accounting_locked()
            busy = (acct["attributed_s"] + acct["pad_tax_s"]
                    + acct["unattributed_s"])
            tiers = {
                f"{tier}/{ph}": {
                    "device_s": round(v, 6),
                    "served_tokens": self.tier_tokens.get((tier, ph), 0),
                }
                for (tier, ph), v in self.tier_device_s.items()
            }
        return {
            "enabled": costledger_enabled(),
            "window_s": round(elapsed, 3),
            "tenants": sorted(
                rows.values(),
                key=lambda r: (r["tenant"], r["deployment"]),
            ),
            "tiers": tiers,
            "accounting": acct,
            "capacity": {
                "chips": self.devices,
                "available_chip_s": round(self.devices * elapsed, 3),
                "consumed_chip_s": round(busy, 6),
                "utilization": round(
                    busy / (self.devices * elapsed), 6),
            },
        }

    def publish_gauges(self) -> None:
        """Push monotone deltas into the MetricsRecorder (called from
        the spine's throttled gauge refresh, ~1/s)."""
        from seldon_core_tpu_torch.utils.telemetry import RECORDER
        with self._lock:
            dev = [(k, v - self._pub.get(k, 0.0))
                   for k, v in self.device_s.items()]
            for k, v in self.device_s.items():
                self._pub[k] = v
            kv = [(k, v - self._pub_kv.get(k, 0.0))
                  for k, v in self.kv_block_s.items()]
            for k, v in self.kv_block_s.items():
                self._pub_kv[k] = v
            pad = [(k, v - self._pub_pad.get(k, 0.0))
                   for k, v in self.pad_tax_s.items()]
            for k, v in self.pad_tax_s.items():
                self._pub_pad[k] = v
            frac = self._accounting_locked()["accounted_fraction"]
        for (tenant, dep, phase), d in dev:
            if d > 0:
                RECORDER.record_cost_device_seconds(tenant, dep, phase, d)
        for (tenant, dep), d in kv:
            if d > 0:
                RECORDER.record_cost_kv_block_seconds(tenant, dep, d)
        for (tenant, dep), d in pad:
            if d > 0:
                RECORDER.record_cost_pad_tax_seconds(tenant, dep, d)
        RECORDER.record_cost_attributed_fraction(frac)

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.time()
            self.device_s.clear()
            self.pad_tax_s.clear()
            self.kv_block_s.clear()
            self.bytes_by.clear()
            self.served_tokens.clear()
            self.tier_device_s.clear()
            self.tier_tokens.clear()
            self._usage.clear()
            self._pub.clear()
            self._pub_kv.clear()
            self._pub_pad.clear()
            self.idle_s = 0.0
            self.unattributed_s = 0.0
            self.wall_s = 0.0
            self.folds = 0


def merge_cost_documents(
    docs: Iterable[Optional[Dict[str, Any]]],
) -> Dict[str, Any]:
    """Fold N ``/costs`` documents into one fleet rollup.

    Pure summation over the tenant table, accounting block, and
    capacity block — so a single-engine fleet's federated rollup equals
    the engine's own document (modulo the gateway's empty local rows),
    which the acceptance test pins.
    """
    rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
    acct = {"device_wall_s": 0.0, "attributed_s": 0.0, "pad_tax_s": 0.0,
            "idle_s": 0.0, "unattributed_s": 0.0, "folds": 0}
    cap = {"chips": 0, "available_chip_s": 0.0, "consumed_chip_s": 0.0}
    tiers: Dict[str, Dict[str, Any]] = {}
    window = 0.0
    for doc in docs:
        if not doc:
            continue
        window = max(window, float(doc.get("window_s") or 0.0))
        for r in doc.get("tenants") or ():
            key = (r.get("tenant", ""), r.get("deployment", ""))
            out = rows.setdefault(key, {
                "tenant": key[0], "deployment": key[1],
                "device_s": {}, "pad_tax_s": 0.0, "kv_block_s": 0.0,
                "bytes": {}, "served_tokens": {},
            })
            for ph, v in (r.get("device_s") or {}).items():
                out["device_s"][ph] = round(
                    out["device_s"].get(ph, 0.0) + v, 6)
            out["pad_tax_s"] = round(
                out["pad_tax_s"] + (r.get("pad_tax_s") or 0.0), 6)
            out["kv_block_s"] = round(
                out["kv_block_s"] + (r.get("kv_block_s") or 0.0), 3)
            for lane, v in (r.get("bytes") or {}).items():
                out["bytes"][lane] = out["bytes"].get(lane, 0) + v
            for ph, v in (r.get("served_tokens") or {}).items():
                out["served_tokens"][ph] = (
                    out["served_tokens"].get(ph, 0) + v)
        a = doc.get("accounting") or {}
        for k in acct:
            acct[k] = round(acct[k] + (a.get(k) or 0), 6)
        c = doc.get("capacity") or {}
        cap["chips"] += int(c.get("chips") or 0)
        cap["available_chip_s"] = round(
            cap["available_chip_s"] + (c.get("available_chip_s") or 0.0), 3)
        cap["consumed_chip_s"] = round(
            cap["consumed_chip_s"] + (c.get("consumed_chip_s") or 0.0), 6)
        for name, t in (doc.get("tiers") or {}).items():
            out_t = tiers.setdefault(
                name, {"device_s": 0.0, "served_tokens": 0})
            out_t["device_s"] = round(
                out_t["device_s"] + (t.get("device_s") or 0.0), 6)
            out_t["served_tokens"] += int(t.get("served_tokens") or 0)
    for r in rows.values():
        toks = sum(r["served_tokens"].values())
        cost = sum(r["device_s"].values()) + r["pad_tax_s"]
        r["cost_per_1k_served_tokens_s"] = (
            round(1000.0 * cost / toks, 6) if toks else None
        )
    wall = acct["device_wall_s"]
    acct["accounted_fraction"] = round(
        (acct["attributed_s"] + acct["pad_tax_s"] + acct["idle_s"]) / wall,
        6) if wall > 0 else 1.0
    cap["utilization"] = round(
        cap["consumed_chip_s"] / cap["available_chip_s"], 6
    ) if cap["available_chip_s"] > 0 else 0.0
    return {
        "tenants": sorted(rows.values(),
                          key=lambda r: (r["tenant"], r["deployment"])),
        "tiers": tiers,
        "accounting": acct,
        "capacity": cap,
        "window_s": round(window, 3),
    }


#: process-global ledger (the spine drainer folds into it; /costs reads it)
LEDGER = CostLedger()
