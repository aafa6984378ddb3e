"""Engine service — the port's counterpart of
``seldon_core_tpu/runtime/engine.py:103-1720``, compiled mode only.

One engine per predictor.  The graph runs in the eager ``CompiledGraph``
on the engine's device; router-free graphs go through the
``MicroBatcher``, which stacks concurrent requests into one dispatch.
A dispatch runs on an executor thread (``_batched_predict_sync``): the
kernels launch on that thread's current CUDA stream, and the ``.cpu()``
readback synchronises it.  Rows arrive as float64 from the JSON codec and
are cast to float32 on the way in.

Kept from the JAX engine: ``predict`` / ``predict_json``, ``_submit``
with the dispatch deadline (``DispatchTimeoutError``, 504), the
known-good-width rule (a failure on a feature width that has served
before is a server fault and propagates; on a novel width it is the
client's shape error, a 400), ``ready`` / ``pause`` / ``drained``, and
``states`` / ``load_states``.  Not ported yet: the host interpreter for
remote nodes and routers, fused graphs, feedback, the continuous generation lane,
admission control and the observatories.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from seldon_core_tpu_torch.device import DeviceLike, resolve_device
from seldon_core_tpu_torch.graph.compiled import CompiledGraph, to_device
from seldon_core_tpu_torch.graph.interpreter import pythonize_tags
from seldon_core_tpu_torch.graph.spec import (
    GraphSpecError,
    PredictorSpec,
    SeldonDeploymentSpec,
)
from seldon_core_tpu_torch.messages import (
    DispatchTimeoutError,
    Meta,
    SeldonMessage,
    SeldonMessageError,
    Status,
    new_puid,
)
from seldon_core_tpu_torch.ops import flash_attention, fused_mlp
from seldon_core_tpu_torch.runtime.batching import MicroBatcher, graph_is_batchable

__all__ = ["EngineService"]


class EngineService:
    """One engine per predictor; used from a single asyncio loop."""

    def __init__(
        self,
        deployment: SeldonDeploymentSpec,
        predictor_name: Optional[str] = None,
        rng: Optional[int] = None,
        batching: bool = True,
        max_batch: int = 1024,
        max_wait_ms: float = 2.0,
        pipeline_depth: int = 8,
        dispatch_timeout_s: float = 30.0,
        device: DeviceLike = None,
    ):
        self.deployment = deployment
        self.predictor: PredictorSpec = deployment.predictor(predictor_name)
        self.device = resolve_device(device)
        self.paused = False
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        # feature widths that have served successfully: a dispatch failure
        # on a known-good width is a server bug (500), on a novel width a
        # client shape error (400)
        self._known_good_widths: set = set()
        # dispatch threads of the engine's own: blocking work that others
        # put on the loop's default executor can never starve a dispatch
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(pipeline_depth)), thread_name_prefix="engine-dispatch"
        )
        self.compiled = CompiledGraph(self.predictor, rng=rng, device=self.device)
        self.mode = "compiled"
        self.batcher: Optional[MicroBatcher] = None
        if batching and graph_is_batchable(self.predictor.graph):
            # the ported units are stateless and row-independent, so
            # dispatches are order-independent reads: they pipeline through
            # the batcher's in-flight slots, padded rows and all
            self.batcher = MicroBatcher(
                self._batched_predict,
                max_batch=max_batch,
                max_wait_ms=max_wait_ms,
                max_inflight=pipeline_depth,
                # frees the slot of a wedged dispatch after callers got
                # their 504s
                dispatch_timeout_s=self.dispatch_timeout_s * 1.5,
            )
            # router-free: the output names never vary per request
            self._static_names = self.compiled._output_names(self.predictor.graph, {})

    # -- dispatch -------------------------------------------------------

    async def _submit(self, rows):
        """Batched dispatch under the engine's per-dispatch deadline: a hung
        device surfaces as a 504 instead of a request that never returns."""
        try:
            return await asyncio.wait_for(self.batcher.submit(rows), self.dispatch_timeout_s)
        except asyncio.TimeoutError:
            raise DispatchTimeoutError(
                f"device dispatch exceeded {self.dispatch_timeout_s:.0f}s"
            ) from None

    async def _batched_predict(self, stacked):
        # concurrency is bounded by the batcher's in-flight slots
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._batched_predict_sync, stacked)

    def _guarded(self, width, fn, *args):
        """Run a dispatch under the known-good-width rule."""
        try:
            out = fn(*args)
        except SeldonMessageError:
            raise
        except (TypeError, ValueError) as e:
            if width in self._known_good_widths:
                raise
            raise SeldonMessageError(f"graph rejected input of feature shape {width}: {e}") from e
        self._known_good_widths.add(width)
        return out

    def _batched_predict_sync(self, stacked):
        # executor thread: the kernels launch on this thread's current stream
        y, routing, tags = self._guarded(
            stacked.shape[1:], self.compiled.predict_arrays, stacked
        )
        # the readback synchronises this thread's stream
        return y.detach().cpu().numpy(), (routing, tags)

    # -- request API ----------------------------------------------------

    async def predict_json(self, raw) -> "tuple[str, int]":
        """Wire-to-wire predict: JSON in, ``(JSON out, http_status)``."""
        try:
            msg = SeldonMessage.from_json(raw)
        except SeldonMessageError as e:
            return SeldonMessage.failure(str(e), code=e.http_code).to_json(), e.http_code
        resp = await self.predict(msg)
        ok = resp.status is None or resp.status.status == "SUCCESS"
        return resp.to_json(), 200 if ok else (resp.status.code or 400)

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if not msg.meta.puid:
            msg.meta.puid = new_puid()
        try:
            if msg.data is not None and msg.array().dtype == object:
                # a ragged/string ndarray must fail as a 400 FAILURE message
                raise SeldonMessageError("data payload is not a numeric rectangular tensor")
            if self.batcher is not None and msg.data is not None:
                rows = np.atleast_2d(msg.array())
                y_rows, (routing, tags) = await self._submit(rows)
                resp = msg.with_array(y_rows, names=self._static_names)
                resp.meta = Meta(
                    puid=msg.meta.puid,
                    tags={**msg.meta.tags, **pythonize_tags(tags)},
                    routing={**msg.meta.routing, **routing},
                    requestPath=dict(msg.meta.requestPath),
                )
                resp.status = Status()
                return resp
            width = np.shape(msg.array())[1:] if msg.data is not None else None
            resp = await asyncio.get_running_loop().run_in_executor(
                self._executor, self._guarded, width, self.compiled.predict, msg
            )
        except (SeldonMessageError, GraphSpecError) as e:
            return SeldonMessage.failure(str(e), code=e.http_code, meta=msg.meta)
        resp.meta.puid = msg.meta.puid
        return resp

    # -- admin (engine RestClientController.java:57-99) -------------------

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "device": self.device.type,
            "predictor": self.predictor.name,
            "batcher": self.batcher.snapshot() if self.batcher is not None else None,
            "kernels": {"fused_mlp_softmax": {"launches": fused_mlp.LAUNCHES},
                        "flash_attention": {"launches": flash_attention.LAUNCHES}},
        }

    def close(self) -> None:
        """Stop the dispatch threads (after the last request)."""
        self._executor.shutdown(wait=True)

    def ready(self) -> bool:
        return not self.paused

    def pause(self) -> None:
        self.paused = True

    def unpause(self) -> None:
        self.paused = False

    def drained(self) -> bool:
        """No queued or in-flight work — the shutdown drain's exit probe."""
        if self.batcher is None:
            return True
        b = self.batcher.snapshot()
        return not b["inflight_dispatches"] and not any(
            v["requests"] for v in b["buckets"].values()
        )

    # -- state handoff ----------------------------------------------------

    def states(self) -> dict:
        return dict(self.compiled.states)

    def load_states(self, states) -> None:
        """Replace unit states (e.g. ``{"mnist": convert.params_from_jax(...)}``),
        moved to the engine's device."""
        self.compiled.states.update(
            {name: to_device(st, self.device) for name, st in states.items()}
        )
