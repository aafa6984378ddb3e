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
the chunks run at (``utils/costledger.py``).  The autopilot's flush
planning and the tiers' scheduling effect (tier-keyed buckets) are not
ported yet (ROADMAP Queue 1 item [4c]).

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
from typing import Any, Awaitable, Callable, Deque, Dict, Tuple

import numpy as np

from seldon_core_tpu_torch.graph.interpreter import methods_for
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, UnitMethod
from seldon_core_tpu_torch.messages import DispatchTimeoutError
from seldon_core_tpu_torch.runtime.qos import current_tenant, current_tier
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
    ):
        self.batch_fn = batch_fn
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
        key = (x.shape[1:], x.dtype)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # enqueue time, trace context and the caller's whole context: the
        # flush records each caller's queue wait under ITS request span,
        # and a one-caller flush dispatches in the caller's context; the
        # tenant and tier let the flush record split its wall across the
        # tenants whose rows shared the dispatch
        self._buckets.setdefault(key, deque()).append(
            (x, fut, time.perf_counter(), current_trace_context(),
             contextvars.copy_context(), current_tenant() or "", current_tier()))
        if key not in self._pumps:
            self._pumps[key] = asyncio.create_task(self._pump(key))
        return await fut

    def snapshot(self) -> dict:
        """Queued rows per shape bucket plus the dispatch-slot picture."""
        return {
            "buckets": {
                f"{tuple(shape)}/{dtype}": {
                    "requests": len(entries),
                    "rows": sum(len(e[0]) for e in entries),
                }
                for (shape, dtype), entries in self._buckets.items()
            },
            "inflight_dispatches": len(self._inflight),
            "max_inflight": self.max_inflight,
            "max_batch": self.max_batch,
            "coalesce_ms": self.coalesce_s * 1e3,
        }

    async def _pump(self, key) -> None:
        """One pump per shape bucket: take a dispatch slot, give same-burst
        submitters a beat to land, stack what is waiting, dispatch, repeat.
        Exits when its bucket drains (a later submit restarts it)."""
        try:
            while self._buckets.get(key):
                await self._sem.acquire()
                if self.coalesce_s > 0:
                    # a lone request on an idle device pays no window; one
                    # zero-sleep yield still lets same-tick submitters land
                    waiting = self._buckets.get(key)
                    if self._inflight or (waiting and len(waiting) > 1):
                        await asyncio.sleep(self.coalesce_s)
                    else:
                        await asyncio.sleep(0)
                bucket = self._buckets.get(key)
                take = []
                if bucket:
                    take = [bucket.popleft() for _ in range(self._take_count(bucket))]
                if bucket is not None and not bucket:
                    del self._buckets[key]
                if not take:
                    self._sem.release()
                    continue
                # one caller: its own context; several: a fresh one (the
                # pump itself runs in its first submitter's context)
                ctx = take[0][4] if len(take) == 1 else contextvars.Context()
                t = asyncio.get_running_loop().create_task(self._run_batch(take), context=ctx)
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

    async def _run_batch(self, entries) -> None:
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
                # one record per flush: occupancy (real rows) and the
                # standalone flush span, failed dispatches included
                SPINE.record_flush(rows=total, requests=len(entries), start_s=now_epoch,
                                   duration_s=time.perf_counter() - t_flush, cost=cost)
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

    def snapshot(self) -> dict:
        # the scheduler's own block is stats()["genserver"]
        return {"mode": "genserver"}
