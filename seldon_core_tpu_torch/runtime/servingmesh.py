"""The disaggregated prefill/decode roles and their KV hand-off, and the
generation lane's tensor-parallel pool — the port's counterpart of
``seldon_core_tpu/runtime/servingmesh.py``.

* **Roles.** ``engine_main --gen-role {prefill,decode,unified}``
  (``ENGINE_GEN_ROLE``) boots a role-specialised ``GenServer``
  (``runtime/genserver.py``).  A prefill replica runs the chunked prefill
  only, and exports each finished sequence's KV blocks and sampling state;
  a decode replica imports them (reserve, receive, commit; a torn
  hand-off is reclaimed) and runs the decode loop; a unified replica is
  the plain continuous lane.  ``SELDON_TPU_DISAGG=0`` turns every role
  back to unified.
* **The coordinator.** ``DisaggCoordinator`` runs on the prefill side: it
  scores the decode peers by free KV blocks (the KV_STATS frame over the
  relay), picks the target by power-of-two choices, walks on to the next
  peer when one refuses the BEGIN, streams the blocks in chunks over the
  relay lane (``runtime/kvstream.py``) and hands the decoded tokens back
  to the waiting request.

A generation request at a decode-only replica, a hand-off at a replica
that is not a decode one, and a prefill replica with no reachable decode
peer answer a typed, retryable 503 (``RoleMismatchError``,
``HandoffError``).  Two replicas on one card run side by side: each has
its own pool and process.

* **Tensor-parallel dispatch.** ``shard_gen_pool`` allocates the
  genserver's paged pool by shard over the generator unit's mesh (a
  binding's ``mesh_axes``, ``graph/units.py``): its K/V heads over ``tp``
  by ``kv_head_range`` (``models/transformer.py`` ``tp_local``), so each
  shard holds the blocks of the kv heads its query heads read beside its
  params (``param_shardings``); a head is held by every shard whose query
  heads read it: every shard of its group when ``tp`` is a multiple of the
  kv heads, both neighbours when ``tp`` neither divides nor is a multiple
  of them and its readers lie on two shards (whose pools then hold
  different numbers of heads).  Either role runs over such a mesh: the hand-off reads
  each head once and writes it into every shard that holds it
  (``kvstream.export_blocks``, ``scatter_staged``).  The reference's
  ``resolve_gen_mesh`` (a mesh built from an env knob, called by no code of
  either package) has no counterpart: the binding is the one way to give a
  generator a mesh.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from seldon_core_tpu_torch.messages import SeldonMessageError
from seldon_core_tpu_torch.runtime import kvstream
from seldon_core_tpu_torch.utils.telemetry import RECORDER, Reservoir

__all__ = ["GEN_ROLES", "RoleMismatchError", "HandoffError", "disagg_enabled",
           "resolve_gen_role", "parse_decode_peers", "DisaggCoordinator",
           "shard_gen_pool"]

logger = logging.getLogger(__name__)

GEN_ROLES = ("unified", "prefill", "decode")


class RoleMismatchError(SeldonMessageError):
    """A request at a replica whose role cannot serve it: retryable (503),
    the right replica exists and routing has to find it."""

    http_code = 503


class HandoffError(SeldonMessageError):
    """A prefill-to-decode hand-off could not complete (no reachable peer,
    every peer's pool full, a torn stream): retryable (503)."""

    http_code = 503


def disagg_enabled() -> bool:
    """The kill switch: ``SELDON_TPU_DISAGG=0`` makes every replica
    unified."""
    return os.environ.get("SELDON_TPU_DISAGG", "1") != "0"


def resolve_gen_role(requested: Optional[str]) -> str:
    role = (requested or os.environ.get("ENGINE_GEN_ROLE", "")).strip().lower() or "unified"
    if role not in GEN_ROLES:
        raise ValueError(f"unknown generation role {role!r} (expected one of {GEN_ROLES})")
    if not disagg_enabled():
        return "unified"
    return role


def parse_decode_peers(raw: Optional[str] = None) -> List[str]:
    """``ENGINE_DECODE_PEERS``: comma-separated relay specs (``uds:/path``
    or ``tcp:host:port``) of the decode replicas a prefill replica hands
    off to."""
    raw = raw if raw is not None else os.environ.get("ENGINE_DECODE_PEERS", "")
    return [p.strip() for p in raw.split(",") if p.strip()]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def shard_gen_pool(mesh, cfg, num_blocks: int, block_size: int):
    """The genserver's paged pool over ``mesh``, a ``ShardedTree``
    allocated by shard on each shard's device (``init_block_pool`` at
    ``cfg.for_shard``: per layer {k, v} ``[num_blocks, KV_local,
    block_size, hd]``, an int8 pool's scale planes ``[num_blocks,
    KV_local, block_size]``); no whole pool is built.  Shard ``i`` holds
    the kv heads ``kv_heads_held`` names: those its query heads read (its
    block of them when ``tp`` divides them; the one head of its group when
    ``tp`` is a multiple of them; otherwise the heads its query heads
    span, a head on two shards held by both, so shards may hold different
    counts).  The reference replicates the pool unless ``tp`` divides the
    heads."""
    from seldon_core_tpu_torch.models.generate import init_block_pool

    return mesh.map_shards(lambda sh: init_block_pool(cfg.for_shard(sh), num_blocks,
                                                      block_size, sh.device))


class DisaggCoordinator:
    """Drives the hand-offs of one prefill-role ``GenServer`` from a
    private asyncio loop on a daemon thread (the scheduler thread never
    waits on a peer).  ``submit`` takes a finished prefill's export and a
    completion callback, which receives the decoded tokens or an
    exception on the coordinator's thread.

    Peer choice is power-of-two choices over the decode replicas' free
    KV blocks (KV_STATS, cached ``SELDON_TPU_KV_STATS_TTL_S``); a peer
    that refuses the BEGIN costs one round trip and the next is tried; a
    stream torn mid-flight sends a best-effort ABORT (the decode side's
    TTL reaper is the backstop) and fails the request typed."""

    def __init__(self, peers: List[str], *, chunk_blocks: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 event_sink: Optional[Callable[..., None]] = None):
        if not peers:
            raise ValueError("DisaggCoordinator needs at least one peer")
        self.peers = list(peers)
        self.chunk_blocks = chunk_blocks or kvstream.chunk_blocks_default()
        self.timeout_s = timeout_s or _env_float("SELDON_TPU_KV_HANDOFF_TIMEOUT_S", 120.0)
        self.stats_ttl_s = _env_float("SELDON_TPU_KV_STATS_TTL_S", 1.0)
        self._event_sink = event_sink
        self._rng = random.Random(0xD15A66)
        self._clients: Dict[str, Any] = {}
        self._free: Dict[str, "tuple[int, float]"] = {}  # peer -> (free, ts)
        self._lock = threading.Lock()
        self.handoffs: Dict[str, int] = {}
        self.inflight = 0
        self.bytes_total = 0
        self.tokens_total = 0
        self.latency_ms = Reservoir(512)
        #: the whole chain's running mean (export, stream, remote decode)
        self.chain_ewma_s = 0.0
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="disagg-coordinator", daemon=True)
        self._thread.start()

    # -- the scheduler's surface ------------------------------------------

    def submit(self, export: kvstream.KvExport, done_cb: Callable[[Any], None]) -> None:
        """Fire one hand-off; ``done_cb`` gets the decoded int32 tokens
        [max_new] or an exception."""
        asyncio.run_coroutine_threadsafe(self._handoff(export, done_cb), self._loop)

    def chain_estimate_s(self) -> Optional[float]:
        """The chain's running mean, None until a hand-off has completed."""
        return self.chain_ewma_s or None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = self.latency_ms.snapshot()
            return {
                "peers": list(self.peers),
                "peer_free_blocks": {p: f for p, (f, _) in self._free.items()},
                "handoffs": dict(self.handoffs),
                "inflight": self.inflight,
                "bytes_total": self.bytes_total,
                "tokens_total": self.tokens_total,
                "handoff_ms_p50": lat.get("p50"),
                "handoff_ms_p99": lat.get("p99"),
                "bytes_per_tok": (round(self.bytes_total / self.tokens_total, 1)
                                  if self.tokens_total else None),
                "chain_ewma_ms": round(self.chain_ewma_s * 1e3, 3),
            }

    def close(self) -> None:
        async def _shutdown():
            for c in self._clients.values():
                try:
                    await c.close()
                except Exception:  # noqa: BLE001 - teardown is best effort
                    pass
            self._loop.stop()

        if self._loop.is_running():
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
            self._thread.join(timeout=5)
        if not self._loop.is_running():
            self._loop.close()

    # -- the coordinator's loop ---------------------------------------------

    def _client(self, peer: str):
        client = self._clients.get(peer)
        if client is None or client.closed:
            from seldon_core_tpu_torch.runtime.udsrelay import make_relay_client

            client = make_relay_client(peer)
            self._clients[peer] = client
        return client

    def _account(self, outcome: str) -> None:
        with self._lock:
            self.handoffs[outcome] = self.handoffs.get(outcome, 0) + 1
        RECORDER.record_kv_handoff(outcome)

    async def _refresh_free(self, peer: str) -> int:
        """A peer's cached free-block score; a failed scrape scores 0 (the
        peer still serves when every candidate failed)."""
        now = time.monotonic()
        cached = self._free.get(peer)
        if cached is not None and now - cached[1] < self.stats_ttl_s:
            return cached[0]
        free = 0
        try:
            body, status = await asyncio.wait_for(
                self._client(peer).call(_op_kvstream(), kvstream.stats_frame()), timeout=2.0)
            if status == 200:
                free = kvstream.unpack_stats(body)["free"]
        except Exception:  # noqa: BLE001 - a degraded peer scores 0
            free = 0
        with self._lock:
            self._free[peer] = (free, now)
        return free

    async def _pick_order(self) -> List[str]:
        """The peers in the order to try: p2c by free blocks, the rest after
        (a refused BEGIN walks down the list)."""
        if len(self.peers) == 1:
            return list(self.peers)
        i, j = self._rng.sample(range(len(self.peers)), 2)
        a, b = self.peers[i], self.peers[j]
        fa = await self._refresh_free(a)
        fb = await self._refresh_free(b)
        first, second = (a, b) if fa >= fb else (b, a)
        return [first, second] + [p for p in self.peers if p not in (first, second)]

    @staticmethod
    def _handoff_meta(export: kvstream.KvExport) -> "bytes | None":
        """The relay sidecar of the hand-off's BEGIN and COMMIT: the
        hand-off span's traceparent, the tenant and the tier; None when
        there is nothing to carry (the frames are then the bare ones)."""
        from seldon_core_tpu_torch.runtime.udsrelay import pack_relay_meta

        ctx = export.trace_ctx
        traceparent = None
        if ctx is not None and ctx.trace_id and ctx.span_id:
            traceparent = "00-%s-%s-01" % (ctx.trace_id, ctx.span_id)
        tenant = export.tenant or None
        tier = export.meta.tier or None
        if traceparent is None and tenant is None and tier in (None, "interactive"):
            return None
        return pack_relay_meta(traceparent=traceparent, tenant=tenant, tier=tier)

    def _record_handoff_span(self, export: kvstream.KvExport, peer: str, nbytes: int,
                             tokens: int, start_s: float, wall_s: float, outcome: str) -> None:
        """The prefill side's ``kv_handoff`` span, under the span id its
        sidecar announced, so the decode replica's spans land under it."""
        from seldon_core_tpu_torch.utils.tracing import TRACER, Span

        ctx = export.trace_ctx
        if ctx is None or not TRACER.enabled:
            return
        TRACER.add(Span(
            puid=export.puid, name="kv_handoff", kind="kv_handoff", method="kv_handoff",
            start_s=start_s, duration_ms=wall_s * 1e3,
            attrs={"peer": peer or "", "bytes": int(nbytes), "tokens": int(tokens),
                   "outcome": outcome},
            trace_id=ctx.trace_id, span_id=ctx.span_id, parent_span_id=export.parent_span_id))

    async def _handoff(self, export: kvstream.KvExport, done_cb) -> None:
        t0 = time.perf_counter()
        start_epoch = time.time()
        with self._lock:
            self.inflight += 1
        RECORDER.set_kv_handoff_inflight(self.inflight)
        hid = uuid.uuid4().bytes
        trace_id = export.trace_ctx.trace_id if export.trace_ctx is not None else ""
        try:
            tokens, peer, nbytes = await self._stream(export, hid)
            wall = time.perf_counter() - t0
            with self._lock:
                self.inflight -= 1
                self.bytes_total += nbytes
                self.tokens_total += int(tokens.size)
                self.latency_ms.observe(wall * 1e3)
                a = 0.2
                self.chain_ewma_s = (wall if self.chain_ewma_s == 0.0
                                     else (1 - a) * self.chain_ewma_s + a * wall)
            self._account("ok")
            RECORDER.observe_kv_handoff(wall, nbytes)
            RECORDER.set_kv_handoff_inflight(self.inflight)
            self._record_handoff_span(export, peer, nbytes, int(tokens.size), start_epoch,
                                      wall, "ok")
            if self._event_sink is not None:
                try:
                    self._event_sink(event="kv_handoff", peer=peer, tokens=int(tokens.size),
                                     bytes=nbytes, latency_ms=round(wall * 1e3, 3),
                                     trace_id=trace_id, puid=export.puid, tenant=export.tenant,
                                     tier=export.meta.tier)
                except Exception:  # noqa: BLE001 - a sink must not fail the hop
                    pass
            done_cb(tokens)
        except Exception as e:  # noqa: BLE001 - surfaced typed, per request
            wall = time.perf_counter() - t0
            with self._lock:
                self.inflight -= 1
            outcome = "torn" if isinstance(e, ConnectionError) else "error"
            self._account(outcome)
            RECORDER.set_kv_handoff_inflight(self.inflight)
            self._record_handoff_span(export, "", 0, 0, start_epoch, wall, outcome)
            done_cb(e if isinstance(e, SeldonMessageError)
                    else HandoffError(f"prefill->decode handoff failed: {e}"))

    async def _stream(self, export: kvstream.KvExport, hid: bytes):
        """BEGIN at the best peer (walking the p2c order on refusals), then
        the chunked blocks and the COMMIT, which answers the tokens."""
        order = await self._pick_order()
        begin = kvstream.begin_frame(export, hid)
        # the sidecar rides the BEGIN (the decode side's spans parent under
        # the hand-off span) and the COMMIT (the decode runs inside it)
        meta = self._handoff_meta(export)
        client = peer = None
        last_refusal = "no decode peers configured"
        for candidate in order:
            try:
                c = self._client(candidate)
                body, status = await asyncio.wait_for(
                    c.call(_op_kvstream(), begin, meta=meta), timeout=10.0)
            except Exception as e:  # noqa: BLE001 - a dead peer: the next one
                last_refusal = f"{candidate}: {e}"
                continue
            if status == 200:
                client, peer = c, candidate
                break
            last_refusal = f"{candidate}: {body.decode('utf-8', 'replace')[:200]}"
            self._account("refused")
        if client is None:
            raise HandoffError(f"no decode peer accepted the handoff ({last_refusal})")
        nbytes = len(begin)
        try:
            for frame in kvstream.block_frames(export, hid, self.chunk_blocks):
                nbytes += len(frame)
                body, status = await asyncio.wait_for(client.call(_op_kvstream(), frame),
                                                      timeout=self.timeout_s)
                if status != 200:
                    raise HandoffError(f"decode peer {peer} rejected a block frame: "
                                       f"{body.decode('utf-8', 'replace')[:200]}")
            body, status = await asyncio.wait_for(
                client.call(_op_kvstream(), kvstream.commit_frame(hid), meta=meta),
                timeout=self.timeout_s)
            if status != 200:
                raise HandoffError(f"decode peer {peer} failed the commit: "
                                   f"{body.decode('utf-8', 'replace')[:200]}")
            return kvstream.unpack_tokens(body), peer, nbytes
        except (Exception, asyncio.CancelledError):
            # torn mid-stream: a best-effort abort frees the reservation now;
            # the decode side's TTL reaper is the backstop
            try:
                await asyncio.wait_for(client.call(_op_kvstream(), kvstream.abort_frame(hid)),
                                       timeout=2.0)
            except Exception:  # noqa: BLE001 - the reaper covers this
                pass
            raise


def _op_kvstream() -> int:
    from seldon_core_tpu_torch.runtime.udsrelay import OP_KVSTREAM

    return OP_KVSTREAM
