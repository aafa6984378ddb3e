"""Micro-batching queue — the port's counterpart of
``seldon_core_tpu/runtime/batching.py:59-300``.

Coalesces concurrent requests that share a feature shape into one stacked
device dispatch and hands each caller back exactly its rows, and its own
rows of any per-row array in the aux (a tag whose leading dim is the
stack's rows, such as an outlier score: ``_aux_has_per_row``,
``_slice_aux``); a chunked dispatch concatenates its chunks' per-row
arrays (``_concat_aux``), everything else in the aux is shared.  Stacks are
padded to power-of-two row counts (a handful of shapes instead of one per
row total) and cut at ``max_batch``.  Up to ``max_inflight`` stacked
dispatches run at once; a bucket flushes the moment a slot frees, so the
batch size grows with load.  A freshly runnable flush waits
``coalesce_ms`` (bounded by ``max_wait_ms``) while a burst is landing.

Batching is transparent only for graphs whose per-request decisions do
not change under concatenation, so the engine batches router-free graphs
only (``graph_is_batchable``).

Telemetry (``batching.py:132``, ``:374``, ``:423``, ``:470`` there): each
caller's trace context is captured at submit, and each flush writes one
telemetry-spine record per caller (its queue wait, and its ``batch_queue``
span under its request span) and one for the flush (occupancy, and the
standalone ``flush`` span), in a ``finally`` so failed dispatches count
too; the in-flight slots are the ``seldon_tpu_inflight_dispatches`` gauge
and pad rows go to the perf observatory.  A flush that serves one caller
runs its dispatch in that caller's context (its trace context and
deadline), so the dispatch span joins the request's tree across the
dispatch thread; a flush of several callers runs in a fresh context and
its dispatch span stands alone, as every stacked dispatch does in the
JAX package.  Each entry carries its caller's tenant and tier
(``runtime/qos.py``), and with the cost ledger on (``SELDON_TPU_COSTLEDGER``)
the flush record carries the attribution payload (``batching.py:378-402``
there): real rows and requests per (tenant, tier) and the padded capacity
the chunks run at (``utils/costledger.py``).

The autopilot (``runtime/autopilot.py``; ``batching.py:80-361`` there):
with a ``predict_s_fn`` (``(padded_rows, sample_x) -> seconds or None``,
the engine's ``_predict_dispatch_s``) each flush takes the queue prefix
with the best predicted goodput (real rows per predicted second, so pad
waste prices itself) among those whose predicted wall fits the included
requests' tightest remaining deadline (``_plan_flush``); its prediction
rides the flush record (``predicted_s``), which the spine counts as a
``flush`` decision.  ``predicted_latency_s`` prices a request before it
enqueues, for the engine's admission shed.  With the kill switch off, no
``predict_s_fn`` or a bucket the model does not cover, the flush takes
everything that fits under ``max_batch``, as before.  The latency tier is
part of the bucket key, so tiers never share a flush, and a lower tier's
pump hands a dispatch slot back while a higher tier's bucket waits
(``_higher_tier_waiting``); all-interactive traffic buckets as it did.

``GenLane`` (``batching.py:507-563`` there) takes the batcher's place for
a generator served by the continuous lane (``runtime/genserver.py``): each
request's rows become sequences of the scheduler, with the same
``submit(rows) -> (y_rows, aux)`` contract.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import time
from collections import deque
from itertools import islice
from typing import Any, Awaitable, Callable, Deque, Dict, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.graph.interpreter import methods_for
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, UnitMethod
from seldon_core_tpu_torch.messages import DispatchTimeoutError
from seldon_core_tpu_torch.runtime.autopilot import autopilot_enabled, pad_bucket
from seldon_core_tpu_torch.runtime.qos import (
    TIER_INTERACTIVE,
    current_tenant,
    current_tier,
    tier_rank,
)
from seldon_core_tpu_torch.runtime.resilience import current_deadline
from seldon_core_tpu_torch.utils.costledger import costledger_enabled
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.perf import OBSERVATORY
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import current_trace_context

__all__ = ["GenLane", "MicroBatcher", "graph_is_batchable"]


def graph_is_batchable(graph: PredictiveUnit) -> bool:
    """True when no node routes (per-request decisions)."""
    return not any(
        UnitMethod.ROUTE in methods_for(u) and u.children for u in graph.walk()
    )


def pad_rows(n: int, max_batch: int) -> int:
    """Rows a chunk of ``n`` real rows is padded to: the next power of two,
    capped at ``max_batch``."""
    return min(1 << (n - 1).bit_length(), max_batch) if n > 1 else n


class MicroBatcher:
    """Coalesce concurrent ``submit(rows)`` calls into stacked calls of
    ``batch_fn`` (an ``async ([B, ...]) -> ([B, ...], aux)`` callable)."""

    def __init__(
        self,
        batch_fn: Callable[[np.ndarray], Awaitable[Tuple[Any, Any]]],
        max_batch: int = 1024,
        max_wait_ms: float = 2.0,
        max_inflight: int = 1,
        coalesce_ms: float = 0.5,
        dispatch_timeout_s: float = 0.0,
        predict_s_fn: Optional[Callable[[int, Any], Optional[float]]] = None,
    ):
        self.batch_fn = batch_fn
        # the autopilot's hook: predicted dispatch wall of one pad bucket;
        # None keeps the flush-all take
        self.predict_s_fn = predict_s_fn
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.coalesce_s = min(float(coalesce_ms), float(max_wait_ms)) / 1e3
        self.max_inflight = int(max_inflight)
        # >0: abandon a dispatch after this long so its slot frees (a wedged
        # device must not wedge the whole queue)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._sem = asyncio.Semaphore(self.max_inflight)
        self._buckets: Dict[Tuple, Deque] = {}
        self._pumps: Dict[Tuple, asyncio.Task] = {}
        self._inflight: set = set()  # strong refs: bare create_task is GC-able
        # rolling wall of recent flushes (any bucket): what a busy dispatch
        # slot costs to wait out, the admission predictor's slot-wait term
        self._flush_ewma_s = 0.0
        self.recorder = RECORDER  # flight-recorder hub (occupancy/wait/slots)
        #: deployment identity on /costs rows; the engine stamps it
        self.cost_deployment = ""
        self._rows_fn = None
        self._rows_kw = False

    async def submit(self, x: np.ndarray):
        """x: [b, ...feature] rows of one request.  Returns (y_rows, aux)."""
        x = np.asarray(x)
        if x.ndim < 2:
            # a 1-D payload is one sample, not len(x) scalar rows
            x = np.atleast_2d(x)
        # the tier is part of the key: tiers never share a flush
        tier = current_tier()
        key = (x.shape[1:], x.dtype, tier)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # enqueue time, trace context and the caller's whole context: the
        # flush records each caller's queue wait under ITS request span,
        # and a one-caller flush dispatches in the caller's context; the
        # tenant and tier let the flush record split its wall across the
        # tenants whose rows shared the dispatch; the deadline is what the
        # flush planner reads
        self._buckets.setdefault(key, deque()).append(
            (x, fut, time.perf_counter(), current_trace_context(),
             contextvars.copy_context(), current_tenant() or "", tier, current_deadline()))
        if key not in self._pumps:
            self._pumps[key] = asyncio.create_task(self._pump(key))
        return await fut

    def predicted_latency_s(self, x) -> Optional[float]:
        """Predicted submit-to-response latency of a request shaped like
        ``x`` before it enqueues (``batching.py:168-202`` there): the
        predicted dispatch wall of the pad bucket it would land in (the
        rows already waiting included), one flush rotation for each full
        flush queued ahead and one more when every slot is busy, plus the
        coalesce window.  None when no model covers the bucket."""
        if self.predict_s_fn is None:
            return None
        x = np.asarray(x)
        if x.ndim < 2:
            x = np.atleast_2d(x)
        key = (x.shape[1:], x.dtype, current_tier())
        waiting = sum(len(e[0]) for e in self._buckets.get(key, ()))
        flushes_ahead = waiting // self.max_batch
        total = min(waiting - flushes_ahead * self.max_batch + len(x), self.max_batch)
        disp = self.predict_s_fn(min(pad_bucket(total), self.max_batch), x)
        if disp is None or disp <= 0:
            return None
        # a rotation is whatever has been flushing lately, not our bucket
        rotation = self._flush_ewma_s or disp
        wait = flushes_ahead * rotation
        if len(self._inflight) >= self.max_inflight:
            wait += rotation
        return wait + disp + self.coalesce_s

    def snapshot(self) -> dict:
        """Queued rows per shape bucket plus the dispatch-slot picture; a
        non-interactive tier's bucket label ends in ``/<tier>``."""
        buckets = {}
        for (shape, dtype, tier), entries in self._buckets.items():
            label = f"{tuple(shape)}/{dtype}"
            if tier != TIER_INTERACTIVE:
                label += f"/{tier}"
            buckets[label] = {"requests": len(entries),
                              "rows": sum(len(e[0]) for e in entries)}
        return {
            "buckets": buckets,
            "inflight_dispatches": len(self._inflight),
            "max_inflight": self.max_inflight,
            "max_batch": self.max_batch,
            "coalesce_ms": self.coalesce_s * 1e3,
            # the reference's knobs (batching.py there): the port gives a
            # unit that updates state on predict no batcher, so a batcher
            # always pads to the buckets and never needs atomic chunks
            "pad_to_buckets": True,
            "atomic_chunks": False,
        }

    def _higher_tier_waiting(self, tier: str) -> bool:
        """Whether a bucket of a strictly higher tier has queued requests;
        interactive (rank 0) answers False at once."""
        rank = tier_rank(tier)
        if rank == 0:
            return False
        return any(entries and tier_rank(k[2]) < rank for k, entries in self._buckets.items())

    async def _pump(self, key) -> None:
        """One pump per (shape, tier) bucket: take a dispatch slot, give
        same-burst submitters a beat to land, stack what is waiting,
        dispatch, repeat.  A lower tier's pump hands a slot it just took
        back while a higher tier's bucket waits, so interactive traffic
        takes freed slots first and lower tiers drain when it is idle.
        Exits when its bucket drains (a later submit restarts it)."""
        try:
            while self._buckets.get(key):
                await self._sem.acquire()
                if self._higher_tier_waiting(key[2]):
                    # the sleep bounds re-contention instead of spinning
                    self._sem.release()
                    await asyncio.sleep(self.coalesce_s or 0.0005)
                    continue
                if self.coalesce_s > 0:
                    # a lone request on an idle device pays no window; one
                    # zero-sleep yield still lets same-tick submitters land
                    waiting = self._buckets.get(key)
                    if self._inflight or (waiting and len(waiting) > 1):
                        await asyncio.sleep(self.coalesce_s)
                    else:
                        await asyncio.sleep(0)
                bucket = self._buckets.get(key)
                take, predicted_s = [], None
                if bucket:
                    n_take, predicted_s = self._plan_flush(bucket)
                    take = [bucket.popleft() for _ in range(n_take)]
                if bucket is not None and not bucket:
                    del self._buckets[key]
                if not take:
                    self._sem.release()
                    continue
                # one caller: its own context; several: a fresh one (the
                # pump itself runs in its first submitter's context)
                ctx = take[0][4] if len(take) == 1 else contextvars.Context()
                t = asyncio.get_running_loop().create_task(self._run_batch(take, predicted_s),
                                                           context=ctx)
                self._inflight.add(t)
                self.recorder.set_inflight(len(self._inflight))
                t.add_done_callback(self._inflight.discard)
                t.add_done_callback(
                    lambda _t: self.recorder.set_inflight(len(self._inflight)))
                t.add_done_callback(lambda _t: self._sem.release())
        finally:
            # reached only with the bucket empty and no awaits since that
            # check, so a concurrent submit cannot be orphaned
            self._pumps.pop(key, None)

    def _take_count(self, bucket) -> int:
        """As many whole requests as fit under max_batch (a single oversized
        request may exceed it, and then rides alone)."""
        k, rows = 0, 0
        for x, *_ in bucket:
            if k and rows + len(x) > self.max_batch:
                break
            k += 1
            rows += len(x)
            if rows >= self.max_batch:
                break
        return k

    def _plan_flush(self, bucket) -> Tuple[int, Optional[float]]:
        """How many waiting requests this flush takes, and the predicted
        wall of that choice (None: the legacy take).  Every prefix of the
        queue (FIFO: a flush cannot skip the head) is scored by predicted
        goodput, real rows per predicted second at its pad bucket; among
        the prefixes whose predicted wall fits the tightest remaining
        deadline of the requests they include (all of them when none
        fits) the best goodput wins, the longer of equals.  The kill
        switch, a one-request take, no model or a bucket the model does
        not cover: the legacy take, bit for bit."""
        k_max = self._take_count(bucket)
        if self.predict_s_fn is None or k_max <= 1 or not autopilot_enabled():
            return k_max, None
        sample = bucket[0][0]
        rows = 0
        tightest = None
        preds: Dict[int, float] = {}  # padded rows -> predicted seconds
        scored = []  # (k, rows, predicted, tightest remaining)
        # islice: indexing a deque is O(n), enumeration would go quadratic
        for k, entry in enumerate(islice(bucket, k_max), 1):
            rows += len(entry[0])
            dl = entry[7]
            if dl is not None:
                rem = dl.remaining_s()
                tightest = rem if tightest is None else min(tightest, rem)
            padded = min(pad_bucket(rows), self.max_batch)
            t = preds.get(padded)
            if t is None:
                t = self.predict_s_fn(padded, sample)
                if t is None or t <= 0:
                    return k_max, None
                preds[padded] = t
            scored.append((k, rows, t, tightest))
        fits = [sc for sc in scored if sc[3] is None or sc[2] <= sc[3]]
        k, _rows, t, _dl = max(fits or scored, key=lambda sc: (sc[1] / sc[2], sc[0]))
        return k, t

    async def _run_batch(self, entries, predicted_s: Optional[float] = None) -> None:
        xs = [e[0] for e in entries]
        futs = [e[1] for e in entries]
        now = time.perf_counter()
        now_epoch = time.time()
        for x, _, t_enq, ctx, *_ in entries:
            # ONE ring record per caller: the queue-wait observation and
            # the caller's queue span, folded off-path from the same write
            SPINE.record_queue(now - t_enq, ctx=ctx, rows=len(x),
                               start_s=now_epoch - (now - t_enq))
        cost = self._cost_payload(entries) if costledger_enabled() else None
        try:
            stacked = np.concatenate(xs, axis=0)
            total = len(stacked)
            t_flush = time.perf_counter()
            try:
                ys, aux = await self._dispatch_chunked(stacked)
            finally:
                # one record per flush: occupancy (real rows), the standalone
                # flush span and a planned flush's prediction, failed
                # dispatches included
                flush_s = time.perf_counter() - t_flush
                self._flush_ewma_s = (flush_s if self._flush_ewma_s == 0.0
                                      else 0.7 * self._flush_ewma_s + 0.3 * flush_s)
                SPINE.record_flush(rows=total, requests=len(entries), start_s=now_epoch,
                                   duration_s=flush_s, predicted_s=predicted_s, cost=cost)
            # one walk decides whether the aux holds per-row arrays at all
            per_row = _aux_has_per_row(aux, total)
            offset = 0
            for x, fut in zip(xs, futs):
                if not fut.cancelled():
                    rows = slice(offset, offset + len(x))
                    fut.set_result((ys[rows], _slice_aux(aux, rows, total) if per_row else aux))
                offset += len(x)
        except Exception as e:  # propagate to every waiter
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _takes_real_rows(self) -> bool:
        """Whether ``batch_fn`` has a ``real_rows`` parameter (read once a
        function)."""
        fn = self.batch_fn
        if fn is not self._rows_fn:
            self._rows_fn = fn
            try:
                self._rows_kw = "real_rows" in inspect.signature(fn).parameters
            except (TypeError, ValueError):
                self._rows_kw = False
        return self._rows_kw

    def _cost_payload(self, entries) -> dict:
        """The flush record's attribution payload: real rows and requests
        per (tenant, tier), and the capacity the chunks are padded to
        (``_dispatch_chunked``'s arithmetic)."""
        agg: Dict[Tuple[str, str], list] = {}
        for e in entries:
            row = agg.setdefault((e[5], e[6]), [0.0, 0.0])
            row[0] += len(e[0])
            row[1] += 1.0
        n_rows = sum(len(e[0]) for e in entries)
        padded = sum(pad_rows(min(self.max_batch, n_rows - start), self.max_batch)
                     for start in range(0, n_rows, self.max_batch))
        return {"dep": self.cost_deployment, "padded": padded,
                "tenants": [(tenant, tier, units, requests, 0)
                            for (tenant, tier), (units, requests) in agg.items()]}

    async def _dispatch_chunked(self, stacked: np.ndarray):
        """Dispatch in <= max_batch chunks, each padded up to a power of two
        (repeating its last row); pad rows are cut from the answer and from
        each chunk's per-row aux.  Units that move their state on predict
        get no batcher, so pad rows can change no state."""
        ys_parts = []
        aux = None
        for start in range(0, len(stacked), self.max_batch):
            chunk = stacked[start: start + self.max_batch]
            n = len(chunk)
            target = pad_rows(n, self.max_batch)
            if target > n:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], target - n, axis=0)], axis=0
                )
            # pad rows burn device work without serving traffic
            OBSERVATORY.note_padding(n, len(chunk))
            # a dispatch that takes ``real_rows`` learns the chunk's real
            # rows, which keeps the pad rows out of its quality statistics
            dispatch = (self.batch_fn(chunk, real_rows=n) if self._takes_real_rows()
                        else self.batch_fn(chunk))
            if self.dispatch_timeout_s > 0:
                try:
                    ys, chunk_aux = await asyncio.wait_for(dispatch, self.dispatch_timeout_s)
                except asyncio.TimeoutError:
                    raise DispatchTimeoutError(
                        f"device dispatch exceeded {self.dispatch_timeout_s:.1f}s"
                    ) from None
            else:
                ys, chunk_aux = await dispatch
            ys_parts.append(np.asarray(ys)[:n])
            chunk_aux = _slice_aux(chunk_aux, slice(0, n), len(chunk))
            aux = chunk_aux if aux is None else _concat_aux(aux, chunk_aux)
        return np.concatenate(ys_parts, axis=0), aux


def _concat_aux(a, b):
    """Merge chunked aux: per-row arrays concatenate, everything else keeps
    the latest value (the last chunk's routing and shared tags)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _concat_aux(a.get(k), b.get(k)) for k in {**a, **b}}
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return tuple(_concat_aux(x, y) for x, y in zip(a, b))
    if getattr(a, "ndim", 0) >= 1 and getattr(b, "ndim", 0) >= 1:
        return np.concatenate([np.asarray(a), np.asarray(b)], axis=0)
    return b if b is not None else a


def _aux_has_per_row(aux, total: int) -> bool:
    """True when the aux tree holds an array whose leading dim is the
    stack's ``total`` rows: per-row data to slice per caller."""
    if isinstance(aux, dict):
        return any(_aux_has_per_row(v, total) for v in aux.values())
    if isinstance(aux, tuple):
        return any(_aux_has_per_row(v, total) for v in aux)
    return getattr(aux, "ndim", 0) >= 1 and aux.shape[0] == total


def _slice_aux(aux, rows: slice, total: int):
    """Each caller's own rows of the aux's per-row arrays (leading dim ==
    ``total``); everything else is shared as it is."""
    if isinstance(aux, dict):
        return {k: _slice_aux(v, rows, total) for k, v in aux.items()}
    if isinstance(aux, tuple):
        return tuple(_slice_aux(v, rows, total) for v in aux)
    if getattr(aux, "ndim", 0) >= 1 and aux.shape[0] == total:
        return np.asarray(aux)[rows]
    return aux


class GenLane:
    """The generation lane's bypass of the MicroBatcher.  The batcher's
    unit of work is one stacked dispatch that holds the device until every
    row's whole generation is done; a continuous scheduler admits each
    row into the running decode batch at its next tick and retires rows
    one by one.  Unary predicts of a generator take this lane, with the
    batcher's ``submit(rows) -> (y_rows, aux)`` contract."""

    def __init__(self, genserver):
        self.genserver = genserver

    async def submit(self, x: np.ndarray):
        x = np.asarray(x)
        if x.ndim < 2:
            x = np.atleast_2d(x)
        req = self.genserver.submit(x)
        try:
            y = await asyncio.wrap_future(req.future)
        except asyncio.CancelledError:
            # the engine's deadline fired (or the caller left): stop the
            # request, so its sequences free their blocks
            req.cancel()
            raise
        return y.astype(np.float64), ({}, {})

    def predicted_latency_s(self, x) -> Optional[float]:
        """The admission shed's hook (``batching.py:548-558`` there): on a
        prefill replica a request pays the whole prefill, hand-off and
        remote decode chain, so admission prices the coordinator's running
        mean of it (``DisaggCoordinator.chain_estimate_s``), and a budget
        that cannot cover the chain sheds before any prefill; None on a
        unified or decode replica, which has no coordinator."""
        coord = getattr(self.genserver, "coordinator", None)
        if coord is None:
            return None
        return coord.chain_estimate_s()

    def snapshot(self) -> dict:
        # the scheduler's own block is stats()["genserver"]
        return {"mode": "genserver"}
