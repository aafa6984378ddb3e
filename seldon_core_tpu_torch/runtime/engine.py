"""Engine service — the port's counterpart of
``seldon_core_tpu/runtime/engine.py:103-1760``.

One engine per predictor, in one of three modes chosen at construction as
the JAX engine chooses (``engine.py:182-251`` there):

* ``fused``: a multi-node graph whose every node is an in-process pure
  unit runs as one ``FusedGraph`` (``graph/fuse.py``) on the engine's
  device, its routers' demotion budget the request's remaining deadline,
  read on the request's side and handed to the dispatch thread;
* ``compiled``: a single node, a graph the fusion pass refuses (a
  ``quorum`` or ``fallback`` over pure units, the predictor annotation
  ``seldon.io/graph-fuse: "false"``) or any eligible graph with
  ``SELDON_TPU_GRAPH_FUSE=0``, runs as one ``CompiledGraph``;
* ``host``: any other graph (a REST-bound node, a plain user object, or
  ``force_host``, or ``extra_runtimes`` given) runs through the
  ``GraphExecutor`` (``graph/interpreter.py``) with partial fusion of its
  eligible subtrees (unless fusion is off); every REST node gets a pooled
  client (``runtime/client.py``) with a ``CircuitBreaker`` of its own and
  the predictor's one ``RetryBudget``.  In-process nodes run on the
  engine's dispatch threads; a remote node's request body is encoded and
  the answer read back there too, never on the loop.

In the fused and compiled modes router-free graphs go through the
``MicroBatcher``, which stacks concurrent requests into one dispatch and
hands each caller its own rows of any per-row tag (an outlier score).
A graph with a router gets no batcher (the branch is a per-request
choice, as in the reference, ``engine.py:316-320`` there): its requests
run one at a time under the engine's state lock, since the router's key
moves on every predict, and ``send_feedback`` (``POST
/api/v0.1/feedback``) takes the same lock to replay a response's
``meta.routing`` through the graph's feedback pass.
A single generator node is served by the continuous lane instead
(``engine.py:273-325`` there): the engine builds a ``GenServer`` from the
unit's ``continuous_spec`` and puts the ``GenLane`` in the batcher's
place, and streams join the running batch (``genserver.stream``).
``SELDON_TPU_GEN_CONTINUOUS=0`` keeps the static lane (``MicroBatcher``
and the unit's ``stream_tokens``).  The scheduler takes the engine's
generation role (``gen_role`` or ``ENGINE_GEN_ROLE``; ``decode_peers`` or
``ENGINE_DECODE_PEERS`` give a prefill replica its ``DisaggCoordinator``,
``engine.py:261-315`` there), and ``kv_frame`` answers the relay's KV
hand-off frames (``runtime/servingmesh.py``); an engine with no scheduler
reports the unified role.  A ``batch_coupled`` unit (a
sampled generator) gets no ``MicroBatcher``, as in the reference
(``engine.py:323-338`` there); nor does a unit that
``updates_state_on_predict``, whose dispatches run one at a time, each
writing its state back (the reference batches such a unit unpadded;
every such unit the port has is batch-coupled too).  Unlike the reference, a scheduler
that fails to build (or whose kernels fail their probe) raises here: the
engine never falls back to the static lane quietly.
A dispatch runs on an executor thread (``_batched_predict_sync``): the
kernels launch on that thread's current CUDA stream, and the ``.cpu()``
readback synchronises it.  Rows arrive as float64 from the JSON codec and
are cast to float32 on the way in.

Kept from the JAX engine: ``predict`` / ``predict_json``, the binary
wire's ``predict_wire`` (one bad slot of a MULTI frame answers its own
error frame; a graph without a batcher takes the object path, where the
reference has none), the gRPC lanes' ``predict_proto_wire`` (the tensor
scan, its failure echoing the puid) and ``predict_proto`` (bytes in and
out, ``protoconv``), ``_submit`` with the dispatch deadline
(``DispatchTimeoutError``, 504) clamped to the request's own, the
known-good-width rule (a failure on a feature width that has served
before is a server fault and propagates; on a novel width it is the
client's shape error, a 400), ``ready`` / ``pause`` / ``drained``,
``open_breakers`` (named in ``/ready``), ``states`` / ``load_states``, and
token streaming for a single generator node (``can_stream``,
``prepare_stream_request``, ``generate_stream``, ``engine.py:690-849``):
each chunk is read on the dispatch executor, streams bypass the batcher
and write no state back.

Observability (``engine.py:122-134``, ``:417-592``, ``:940``,
``:1134-1205`` there): each predictions, feedback and stream request is
timed by the predictor's ``MetricsRegistry`` (the
``seldon_api_engine_server_requests_duration_seconds`` family) and runs in
a ``request`` span, the child of an incoming ``traceparent`` the lane
bound; the request-audit log (``AuditLog``, off unless
``SELDON_TPU_AUDIT=1``) gets one entry per request.  A dispatch writes
one telemetry-spine record (``utils/hotrecord.py``), or a failed one's
span, timed from its start to the end of the readback the response
already makes, on the thread the dispatch ran on: the batcher hands a
one-caller flush the caller's context, and ``_batched_predict`` carries
it onto the dispatch thread (``run_in_executor`` does not), so the
dispatch span is the request's child.  ``stats()`` adds the cached
``telemetry`` / ``perf`` / ``quality`` / ``tracer`` walks with
``staleness_s`` (``SELDON_TPU_STATS_TTL_S``), ``routers`` (the MAB router
state read back, ``utils/quality.py`` ``router_quality``) and ``audit``;
``overhead_document``, ``perf_document``, ``genperf_document``,
``quality_document``, ``costs_document``, ``postmortems_document`` and
``trace_json`` (the relay's ``OP_TRACE``) are the routes' documents.

Quality, postmortems and costs (``engine.py:155-158``, ``:427-430``,
``:620-676``, ``:1187-1205``, ``:1759-1763`` there): the compiled and fused
lanes dispatch the whole graph as one program, so their drift windows key
on the graph root (``_quality_node``): each dispatch record carries the
stacked rows and the readback the dispatch already holds (host arrays) for
the drainer's summarize, and the outlier scores in its tags bridge inline.
Audit lines carry the last drift score, ``send_feedback`` folds its reward
and truth, the binary wire lane binds its sidecar's tenant and tier
(``runtime/qos.py``) and bills its bytes to them, and the request span
carries the bound tenant and tier (a postmortem's cost row and SLO
budget).  ``LEDGER.devices`` is ``torch.cuda.device_count()`` on a CUDA
engine, 1 on the CPU.

The autopilot and the policies (``engine.py:400-407``, ``:523-618``,
``:851-909``, ``:1026-1110`` there): the batcher prices a pad bucket by
``_predict_dispatch_s``, whose key is the one the dispatch's record trains
(``CompiledGraph.shape_key``).  ``_submit`` ticks the brownout ladder,
sheds a tier the ladder sheds, and sheds a request whose predicted queue +
dispatch wall exceeds its remaining budget times ``shed_margin()`` times the
ladder's margin scale: a typed 503 (``LoadShedError``) before any dispatch
slot, queue entry or device time, counted by
``seldon_tpu_brownout_shed_total{tier}`` or
``seldon_tpu_autopilot_shed_total{where="admission"}``, marked ``shed`` on
the request span (the postmortem keeps it for ``shed``) and left out of the
SLO feed.  The engine warms the autopilot from the perf corpus at
construction (``SELDON_TPU_CORPUS_DIR``), ``prewarm`` runs every batch
bucket before the server binds, and ``autopilot_document`` /
``corpus_document`` are ``GET /autopilot`` / ``/corpus``; ``/stats`` has
``autopilot`` and ``brownout``.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import functools
import json
import logging
import os
import secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import DeviceLike, resolve_device
from seldon_core_tpu_torch.graph.compiled import CompiledGraph, to_device
from seldon_core_tpu_torch.graph.fuse import FusedGraph, fuse_enabled, plan_fusion
from seldon_core_tpu_torch.graph.interpreter import GraphExecutor, NodeRuntime, pythonize_tags
from seldon_core_tpu_torch.graph.spec import (
    GraphSpecError,
    PredictorSpec,
    SeldonDeploymentSpec,
)
from seldon_core_tpu_torch.messages import (
    DeadlineExceededError,
    DefaultData,
    DispatchTimeoutError,
    Feedback,
    LoadShedError,
    Meta,
    SeldonMessage,
    SeldonMessageError,
    Status,
    new_puid,
)
from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.native import fastcodec, protowire
from seldon_core_tpu_torch.ops import flash_attention, flash_decode, fused_mlp, kv_write
from seldon_core_tpu_torch.runtime import kvstream, wire
from seldon_core_tpu_torch.runtime.autopilot import (
    AUTOPILOT,
    SHED_INFO_PREFIX,
    autopilot_enabled,
    shed_margin,
)
from seldon_core_tpu_torch.runtime.batching import GenLane, MicroBatcher, graph_is_batchable
from seldon_core_tpu_torch.runtime.brownout import BROWNOUT, BROWNOUT_INFO_PREFIX
from seldon_core_tpu_torch.runtime.genserver import GenServer
from seldon_core_tpu_torch.runtime.qos import current_tenant, current_tier, qos_scope
from seldon_core_tpu_torch.runtime.servingmesh import (
    DisaggCoordinator,
    parse_decode_peers,
    resolve_gen_role,
)
from seldon_core_tpu_torch.runtime.resilience import (
    CircuitBreaker,
    RetryBudget,
    maybe_deadline_scope,
    remaining_s,
)
from seldon_core_tpu_torch.utils.costledger import LEDGER, costledger_enabled
from seldon_core_tpu_torch.utils.genperf import GENPERF
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch.utils.perf import OBSERVATORY
from seldon_core_tpu_torch.utils.perfcorpus import CORPUS
from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM
from seldon_core_tpu_torch.utils.quality import QUALITY, router_quality
from seldon_core_tpu_torch.utils.telemetry import RECORDER, AuditLog
from seldon_core_tpu_torch.utils.tracing import (
    TRACER,
    current_trace_context,
    parse_traceparent,
    trace_document,
    trace_scope,
)

__all__ = ["EngineService", "StreamRequest", "is_client_shape_error"]

logger = logging.getLogger(__name__)

# words of a RuntimeError raised by the card, its runtime or its libraries,
# never by a tensor's shape
_DEVICE_ERROR_WORDS = ("cuda", "cublas", "cudnn", "cufft", "curand", "cusolver", "cusparse",
                       "nccl", "device", "out of memory", "kernel", "illegal", "driver",
                       "launch")


def _plane_errors() -> dict:
    """The native plane's build or load error, if its load failed."""
    from seldon_core_tpu_torch.runtime import nativeplane

    return nativeplane.build_errors()


def is_client_shape_error(e: BaseException) -> bool:
    """Whether a dispatch failure is what torch raises on an input of the
    wrong shape, so that on a feature width that has never served it is
    the client's error (a 400, as the reference's trace-time ``TypeError``
    / ``ValueError`` is, ``engine.py:1157-1176`` there).

    ``TypeError``, ``ValueError`` and ``IndexError`` (an out-of-range index
    into a too-narrow row) are; so is a plain ``RuntimeError`` (torch's
    broadcast and matmul shape mismatches), unless it comes from the card:
    a ``torch.cuda`` error class, a ``NotImplementedError`` or
    ``RecursionError``, or a message that names CUDA, a CUDA library, the
    device, memory, a kernel or a launch stays a server fault (a 500)."""
    if isinstance(e, (TypeError, ValueError, IndexError)):
        return True
    if not isinstance(e, RuntimeError) or isinstance(e, (NotImplementedError, RecursionError)):
        return False
    cuda_errors = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError", None),
                                    getattr(torch.cuda, "CudaError", None),
                                    getattr(torch, "AcceleratorError", None))
                        if isinstance(t, type))
    if cuda_errors and isinstance(e, cuda_errors):
        return False
    text = str(e).lower()
    return not any(word in text for word in _DEVICE_ERROR_WORDS)


class StreamRequest(NamedTuple):
    """A validated streaming request: prompt rows [B, S] float64, puid,
    tokens per frame, the request's ``max_new`` (None: the unit's), and
    the trace context, tenant and tier the lane bound when it was prepared
    (the stream is iterated by the connection's writer, outside the
    handler's context)."""

    rows: np.ndarray
    puid: str
    chunk: int
    max_new: Optional[int] = None
    trace: Optional[object] = None
    tenant: Optional[str] = None
    tier: Optional[str] = None


def _max_new(value) -> int:
    """A stream's ``max_new``, at least 1, as the JAX engine reads it: the
    continuous lane generates that many tokens, the static lane the
    unit's ``max_new_tokens``."""
    try:
        return max(1, int(value))
    except (TypeError, ValueError):
        raise SeldonMessageError("max_new must be an integer") from None


def _prompt_rows(msg: SeldonMessage) -> np.ndarray:
    """A stream's prompt as [B, S] float64 rows, S >= 1, or a
    SeldonMessageError."""
    rows = None if msg.data is None else np.atleast_2d(msg.array())
    if rows is None or rows.dtype == object or rows.ndim != 2 or rows.shape[1] == 0:
        raise SeldonMessageError("streaming needs a numeric prompt of token rows")
    return rows.astype(np.float64)


def _host_payload(resp: SeldonMessage) -> SeldonMessage:
    """A host-mode answer with its device tensor read back to numpy."""
    if resp.data is not None and isinstance(resp.data.array, torch.Tensor):
        resp.data.array = resp.data.array.detach().cpu().numpy()
    return resp


class EngineService:
    """One engine per predictor; used from a single asyncio loop."""

    def __init__(
        self,
        deployment: SeldonDeploymentSpec,
        predictor_name: Optional[str] = None,
        extra_runtimes: Optional[Dict[str, NodeRuntime]] = None,
        rng: Optional[int] = None,
        force_host: bool = False,
        batching: bool = True,
        max_batch: int = 1024,
        max_wait_ms: float = 2.0,
        pipeline_depth: int = 8,
        dispatch_timeout_s: float = 30.0,
        device: DeviceLike = None,
        audit: Optional[AuditLog] = None,
        gen_role: Optional[str] = None,
        decode_peers: Optional[list] = None,
    ):
        # the replica's generation role (runtime/servingmesh.py): "prefill"
        # hands finished KV blocks to decode peers over the relay, "decode"
        # only imports hand-offs; SELDON_TPU_DISAGG=0 forces "unified"
        self.gen_role = resolve_gen_role(gen_role)
        self._decode_peers = (list(decode_peers) if decode_peers is not None
                              else parse_decode_peers())
        self.deployment = deployment
        self.tracer = TRACER
        self.predictor: PredictorSpec = deployment.predictor(predictor_name)
        self.device = resolve_device(device)
        # the perf observatory's peaks and memory watermarks read this card,
        # and the quality observatory summarizes host batches on it
        OBSERVATORY.set_device(self.device)
        QUALITY.set_device(self.device)
        self.metrics = MetricsRegistry(
            deployment_name=deployment.name,
            predictor_name=self.predictor.name,
            project_name=str(deployment.annotations.get("project_name", "")),
        )
        # request-audit log: off unless configured (SELDON_TPU_AUDIT /
        # SELDON_TPU_AUDIT_DIR)
        self.audit = audit if audit is not None else AuditLog()
        self._graph_path = "/".join(n.name for n in self.predictor.graph.walk())
        # the compiled and fused lanes dispatch the whole graph as one
        # program: their drift windows key on the graph root (host mode and
        # unit pods record per node)
        self._quality_node = self.predictor.graph.name
        # a fresh id per construction: a scraper that sees it change at the
        # same URL knows the process restarted
        self.boot_id = secrets.token_hex(8)
        # /stats assembly cache: the observatory walks are rebuilt only when
        # the folded state moved or the TTL passed
        self._stats_cache = None
        try:
            self._stats_ttl_s = float(os.environ.get("SELDON_TPU_STATS_TTL_S", "") or 1.0)
        except ValueError:
            self._stats_ttl_s = 1.0
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
        self.mode = "host"
        self.compiled: Optional[CompiledGraph] = None
        self.executor: Optional[GraphExecutor] = None
        self._fuse = fuse_enabled() and not force_host
        self.fusion_plan = None
        if not force_host and not extra_runtimes:
            if self._fuse and self.predictor.graph.children:
                # a multi-node graph tries the fused walk first (a single
                # node has no hops to fuse: the compiled executor is its one
                # program already); the plan stays either way, so /stats
                # names what blocked fusion
                self.fusion_plan = plan_fusion(self.predictor)
                try:
                    self.compiled = FusedGraph(self.predictor, rng=rng, device=self.device,
                                               plan=self.fusion_plan)
                    self.mode = "fused"
                except GraphSpecError:
                    pass
            if self.compiled is None:
                try:
                    self.compiled = CompiledGraph(self.predictor, rng=rng, device=self.device)
                    self.mode = "compiled"
                except GraphSpecError:
                    pass
        # one retry budget for every node client of the predictor, so
        # retries cannot amplify an outage across the fan-out, and one
        # breaker per remote node
        self.retry_budget = RetryBudget()
        self.breakers: Dict[str, CircuitBreaker] = {}
        if self.compiled is None:
            self._build_host(extra_runtimes, rng)
        # router-free: the output names never vary per request
        self._static_names = (self.compiled._output_names(self.predictor.graph, {})
                              if self.compiled is not None
                              and graph_is_batchable(self.predictor.graph) else None)
        # the names field of the gRPC tensor lane's answers, made once
        self._proto_names_frag = protowire.names_fragment(self._static_names or [])
        self.genserver: Optional[GenServer] = None
        # the lane is chosen once: a later load_states rebuilds the same one
        self._continuous = os.environ.get("SELDON_TPU_GEN_CONTINUOUS", "1") != "0"
        self._build_genserver()
        if self.genserver is None:
            # a role without a scheduler cannot serve its contract: unified,
            # so routing and metrics stay truthful
            self.gen_role = "unified"
        units = list(self.compiled.units.values()) if self.compiled is not None else []
        # a unit whose predict moves its state (a sampled generator's
        # request counter, an outlier's running covariance) runs one
        # dispatch at a time, its state written back after each
        # (engine.py:323-338 there); so does a graph with a router, whose
        # key moves on every predict, and feedback takes the same lock
        self._stateful = (any(u.updates_state_on_predict for u in units)
                          or not graph_is_batchable(self.predictor.graph))
        self._state_lock = threading.Lock()
        self.batcher = None
        if batching and self.genserver is not None:
            self.batcher = GenLane(self.genserver)
        elif (batching and self.compiled is not None and graph_is_batchable(self.predictor.graph)
              and not self._stateful and not any(u.batch_coupled for u in units)):
            # a batch-coupled unit gets no batcher: coalesced rows would
            # change another caller's answer.  Stateless units' dispatches
            # are order-independent reads: they pipeline through the
            # batcher's in-flight slots, padded rows and all
            self.batcher = MicroBatcher(
                self._batched_predict,
                max_batch=max_batch,
                max_wait_ms=max_wait_ms,
                max_inflight=pipeline_depth,
                # frees the slot of a wedged dispatch after callers got
                # their 504s
                dispatch_timeout_s=self.dispatch_timeout_s * 1.5,
                predict_s_fn=self._predict_dispatch_s,
            )
            self.batcher.cost_deployment = self.deployment.name
        # the reference's meaning (engine.py:346 there): a batcher whose
        # dispatches are order-independent reads (no unit updates state on
        # predict) with more than one in flight; the native plane's
        # eligibility reads it
        self._pipelined = isinstance(self.batcher, MicroBatcher) and int(pipeline_depth) > 1
        # the answer's names field as JSON text, for the composed answers of
        # the codec's fast path and the native plane
        self._names_fragment = ('"names":%s,' % json.dumps(list(self._static_names),
                                                          separators=(",", ":"))
                                if self._static_names else "")
        # the native codec, built (g++, at its first use in the process) and
        # loaded here, at construction: a first-call build inside a request
        # coroutine would block the event loop (engine.py:390-399 there)
        self.codec = "native" if fastcodec.native_available() else "python"
        # the lane serving the engine's HTTP routes: the native plane sets
        # "native" while it serves (runtime/nativeplane.py)
        self.http_impl = "python"
        # warm the autopilot from the durable perf corpus, so a restarted
        # engine prices the keys it has seen before its first dispatch (a
        # no-op when SELDON_TPU_CORPUS_DIR is unset)
        try:
            CORPUS.warm_start_autopilot()
        except Exception:  # noqa: BLE001 - the corpus must never block serving
            logger.exception("perf-corpus warm start failed (serving anyway)")

    def _build_host(self, extra_runtimes, rng) -> None:
        """Host mode: a pooled client for each REST node the caller did not
        supply, then the ``GraphExecutor`` (with partial fusion unless the
        pass is off)."""
        from seldon_core_tpu_torch.runtime.client import make_node_runtime

        runtimes = dict(extra_runtimes or {})
        comp_map = self.predictor.component_map()
        for node in self.predictor.graph.walk():
            binding = comp_map.get(node.name)
            if (node.name not in runtimes and binding is not None
                    and binding.runtime in ("rest", "grpc")):
                breaker = CircuitBreaker(node.name)
                self.breakers[node.name] = breaker
                runtimes[node.name] = make_node_runtime(node, binding, breaker=breaker,
                                                        retry_budget=self.retry_budget,
                                                        executor=self._executor)
        # a caller's runtime may carry its own breaker: /stats and /ready
        # show it too
        for name, rt in runtimes.items():
            br = getattr(rt, "breaker", None)
            if br is not None and name not in self.breakers:
                self.breakers[name] = br
        try:
            self.executor = GraphExecutor(self.predictor, extra_runtimes=runtimes, rng=rng,
                                          fuse=self._fuse, device=self.device,
                                          executor=self._executor)
        except BaseException:
            for rt in runtimes.values():
                getattr(rt, "close", lambda: None)()
            raise
        self.fusion_plan = self.executor.fusion_plan

    def _build_genserver(self, knobs=None) -> None:
        """The continuous lane's scheduler for a single unit whose
        ``continuous_spec`` is not None, unless ``SELDON_TPU_GEN_CONTINUOUS``
        was 0 when the engine was built; ``knobs`` (a rebuild's) keep the
        pool and round sizes of the scheduler it replaces.  A failure
        raises."""
        if not self._continuous or self.compiled is None or len(self.compiled.units) != 1:
            return
        name, unit = next(iter(self.compiled.units.items()))
        spec_fn = getattr(unit, "continuous_spec", None)
        spec = None if spec_fn is None else spec_fn(self.compiled.states[name])
        if spec is not None:
            coordinator = None
            if self.gen_role == "prefill" and self._decode_peers:
                coordinator = DisaggCoordinator(self._decode_peers,
                                                event_sink=self._handoff_event)
            self.genserver = GenServer(**spec, **(knobs or {}), role=self.gen_role,
                                       coordinator=coordinator)
            self.genserver.cost_deployment = self.deployment.name

    # -- dispatch -------------------------------------------------------

    def _predict_dispatch_s(self, padded_rows: int, x) -> Optional[float]:
        """The autopilot's predicted dispatch wall of this graph at one pad
        bucket of ``x``'s feature shape and dtype, keyed as the dispatch's
        record will be (``shape_key``), so the prediction reads the row
        that the record trains."""
        shape = (int(padded_rows),) + tuple(np.shape(x)[1:])
        return AUTOPILOT.predict_s(self.compiled.shape_key(shape, getattr(x, "dtype", np.float64)))

    async def _submit(self, rows):
        """Batched dispatch under the engine's per-dispatch deadline: a hung
        device surfaces as a 504 instead of a request that never returns.
        The request's own deadline (a header's or a frame's sidecar's)
        clamps the wait further, and an exhausted one is a 504 before any
        dispatch (``engine.py:1035-1108`` there).  Admission control first:
        a tier the brownout ladder sheds, and a request the autopilot
        predicts cannot finish inside its budget, answer a typed 503 before
        they take a dispatch slot or device time."""
        BROWNOUT.maybe_tick()
        tier = current_tier()
        if BROWNOUT.sheds_tier(tier):
            RECORDER.record_brownout_shed(tier)
            raise LoadShedError(f"{BROWNOUT_INFO_PREFIX}: {tier!r}-tier request shed at "
                                f"brownout stage {BROWNOUT.stage()} — retry later")
        timeout = self.dispatch_timeout_s
        rem = remaining_s()
        if rem is not None:
            if rem <= 0:
                RECORDER.record_deadline_exceeded("dispatch")
                raise DeadlineExceededError("request deadline exhausted before device dispatch")
            if autopilot_enabled():
                est = self.batcher.predicted_latency_s(rows)
                # brownout stage 3 tightens the margin: marginal requests
                # shed earlier, certain ones still run
                if est is not None and est > rem * shed_margin() * BROWNOUT.shed_margin_scale():
                    RECORDER.record_autopilot_shed("admission")
                    self.tracer.event("autopilot_shed", predicted_ms=round(est * 1e3, 3),
                                      remaining_ms=round(rem * 1e3, 3))
                    raise LoadShedError(
                        f"{SHED_INFO_PREFIX}: predicted queue+dispatch {est * 1e3:.1f} ms "
                        f"exceeds the remaining deadline budget ({rem * 1e3:.1f} ms)")
            timeout = min(timeout, rem)
        try:
            return await asyncio.wait_for(self.batcher.submit(rows), timeout)
        except asyncio.TimeoutError:
            if timeout < self.dispatch_timeout_s:
                RECORDER.record_deadline_exceeded("dispatch")
                raise DeadlineExceededError(
                    f"request deadline ({timeout:.2f}s remaining) exceeded during device "
                    f"dispatch") from None
            raise DispatchTimeoutError(
                f"device dispatch exceeded {self.dispatch_timeout_s:.0f}s"
            ) from None

    async def _batched_predict(self, stacked, real_rows=None):
        # concurrency is bounded by the batcher's in-flight slots; the
        # flush's context (a one-caller flush's is the caller's) rides
        # onto the dispatch thread, which run_in_executor does not carry
        ctx = contextvars.copy_context()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, ctx.run, self._batched_predict_sync, stacked, real_rows)

    def _guarded(self, shape, fn, *args):
        """Run a dispatch of rows of ``shape`` (None: no array payload) under
        the known-good-width rule: on a feature width (``shape[1:]``) that
        has never served, a shape error (``is_client_shape_error``) is the
        client's, a 400 "graph rejected input of shape ..."; on one that
        has, it is the server's and propagates (a 500)."""
        width = None if shape is None else tuple(shape[1:])
        try:
            out = fn(*args)
        except SeldonMessageError:
            raise
        except Exception as e:  # noqa: BLE001 - split by the predicate
            if width in self._known_good_widths or not is_client_shape_error(e):
                raise
            raise SeldonMessageError(
                f"graph rejected input of shape {tuple(shape or ())}: {e}") from e
        self._known_good_widths.add(width)
        return out

    def _serial(self, fn, *args):
        """``fn(*args)``, one at a time when a unit updates state on
        predict or the graph routes: each dispatch reads the state the last
        one wrote back."""
        if not self._stateful:
            return fn(*args)
        return self._locked(fn, *args)

    def _locked(self, fn, *args):
        """``fn(*args)`` under the engine's state lock."""
        with self._state_lock:
            return fn(*args)

    def _batched_predict_sync(self, stacked, real_rows=None):
        # executor thread: the kernels launch on this thread's current stream.
        # Observability is ONE telemetry-spine record per dispatch: the
        # sample verdict is decided once, the record carries the span
        # identity, the wall and the executable key, and the folds (span,
        # MFU, roofline) run in the drainer, off this path
        wants = SPINE.dispatch_wants()
        t_dispatch = time.perf_counter()
        start_s = time.time()
        try:
            y, routing, tags = self._guarded(
                tuple(stacked.shape), self.compiled.predict_arrays, stacked
            )
            # the readback synchronises this thread's stream: the response
            # needs it, and it is where the dispatch's wall ends (no sync is
            # added to measure); tags come back as numpy, so the batcher can
            # give each caller its rows of a per-row one
            tags = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in tags.items()}
            y = y.detach().cpu().numpy()
        except BaseException as e:
            if wants.trace:
                SPINE.record_failed_dispatch(
                    executable=self.compiled.executable_key(stacked),
                    seconds=time.perf_counter() - t_dispatch, start_s=start_s,
                    rows=len(stacked), method="predict", error=type(e).__name__)
            raise
        seconds = time.perf_counter() - t_dispatch
        n_real = real_rows if real_rows is not None else len(stacked)
        # the outlier-score bridge stays inline: a key check when absent,
        # and the scores are host tags the callers slice anyway
        if QUALITY.enabled and tags:
            QUALITY.record_outlier_tags(tags, real_rows=n_real)
        if wants.any:
            SPINE.record_dispatch(
                wants, executable=self.compiled.executable_key(stacked),
                seconds=seconds, start_s=start_s,
                rows=len(stacked), real_rows=n_real, method="predict",
                # the drainer's quality fold reads the host arrays the
                # dispatch already holds: the stacked rows and the readback
                quality_node=self._quality_node, X=stacked, Y=y,
                # a fused graph's one record carries its per-node shares
                phases=self.compiled.phases)
        return y, (routing, tags)

    # -- request API ----------------------------------------------------

    async def predict_json(self, raw) -> "tuple[str, int]":
        """Wire-to-wire predict: JSON in, ``(JSON out, http_status)``.

        A graph with a batcher takes the codec's fast path
        (``engine.py:1219-1320`` there) when the native codec parses the
        body and it holds nothing but a numeric payload and a meta: the
        rows go to the batcher without a SeldonMessage, and the answer is
        composed from the payload fragment the C++ formatter writes.  It
        is the object path's answer (the same meta, names, status and
        values; a request's own ``names`` or any other member takes the
        object path, as does an answer whose values are not floats)."""
        if self.batcher is not None and self.codec == "native":
            fast = self._parse_fast(raw)
            if fast is not None:
                return await self._predict_rows_json(*fast)
        try:
            msg = SeldonMessage.from_json(raw)
        except SeldonMessageError as e:
            return SeldonMessage.failure(str(e), code=e.http_code).to_json(), e.http_code
        resp = await self.predict(msg)
        ok = resp.status is None or resp.status.status == "SUCCESS"
        return resp.to_json(), 200 if ok else (resp.status.code or 400)

    @staticmethod
    def _parse_fast(raw):
        """``(meta, kind, rows)`` of a body whose only members are a numeric
        ``data`` payload (no ``names``) and a well-formed ``meta``, or None
        (the object path answers)."""
        fast = fastcodec.parse_message_fast(raw)
        if fast is None:
            return None
        envelope, kind, arr = fast
        if kind is None or envelope.get("data") or not set(envelope) <= {"meta", "data"}:
            return None
        meta_in = envelope.get("meta") or {}
        if not isinstance(meta_in, dict):
            return None
        try:
            meta = Meta.from_json_dict(meta_in)
        except SeldonMessageError:
            return None
        meta.puid = meta.puid or new_puid()
        return meta, kind, np.atleast_2d(arr)

    async def _predict_rows_json(self, meta: Meta, kind: str, rows) -> "tuple[str, int]":
        """The fast path's request: ``predict``'s timing, span and audit
        around ``_submit``, the answer written as the object path writes
        it."""
        t0 = time.perf_counter()
        with self.metrics.time_server("predictions", "POST") as code, self._request_span(
                meta.puid, "predict", mode=self.mode):
            try:
                y_rows, (routing, tags) = await self._submit(rows)
            except (SeldonMessageError, GraphSpecError) as e:
                self._request_failed(code, e, meta.puid, t0, len(rows), "rest")
                return SeldonMessage.failure(str(e), code=e.http_code, meta=meta).to_json(), \
                    e.http_code
            self._audit_request(meta.puid, "predict", 200, t0, rows=len(rows), lane="rest")
        out_meta = Meta(puid=meta.puid, tags={**meta.tags, **pythonize_tags(tags)},
                        routing={**meta.routing, **routing}, requestPath=dict(meta.requestPath))
        y = np.asarray(y_rows)
        frag = (fastcodec.format_data_fragment(y, kind)
                if y.dtype.kind == "f" and y.ndim == 2 else None)
        if frag is None:
            resp = SeldonMessage(data=DefaultData(array=y_rows, names=list(self._static_names or []),
                                                  kind=kind), meta=out_meta, status=Status())
            return resp.to_json(), 200
        return ('{"meta":%s,"status":{"code":200,"status":"SUCCESS"},"data":{%s%s}}'
                % (json.dumps(out_meta.to_json_dict(), separators=(",", ":")),
                   self._names_fragment, frag.decode("ascii"))), 200

    # -- the binary wire (runtime/wire.py) ------------------------------

    async def predict_wire(self, payload) -> "tuple[int, list]":
        """One binary frame in, ``(http status, response frame parts)`` out
        (``engine.py:1341`` there).  The request tensor is a view over the
        frame's bytes and the answer is framed from the dispatch's
        readback.  A MULTI frame's sub-frames run at once (the batcher
        merges their rows as it would separate arrivals), each answering
        its own frame.  Raises ``WireError`` (400) or ``WireFrameTooLarge``
        (413) for bytes that are not a frame at all."""
        frame = wire.decode_frame(payload)
        if frame.is_multi:
            results = await asyncio.gather(*(self._predict_wire_sub(sub)
                                             for sub in frame.subframes))
            return 200, wire.encode_multi([wire.join_parts(parts) for _, parts in results])
        return await self._predict_wire_single(frame)

    async def _predict_wire_sub(self, buf) -> "tuple[int, list]":
        """One sub-frame of a MULTI frame: any failure (torn bytes, an
        unexpected exception) answers its own error frame, never its
        co-travellers'."""
        try:
            frame = wire.decode_frame(buf)
            if frame.is_multi:
                raise wire.WireError("nested multi frames are not allowed")
        except wire.WireError as e:
            return self._wire_error_frame(None, e, e.http_code)
        try:
            return await self._predict_wire_single(frame)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - slot-isolated 500
            return self._wire_error_frame(frame.meta.get("puid"), e, 500)

    @staticmethod
    def _wire_error_frame(puid, e, code: int) -> "tuple[int, list]":
        return code, wire.encode_frame(
            None, status=code, response=True,
            meta_bytes=wire.pack_wire_meta(puid=puid, extra={"error": str(e)}))

    async def _predict_wire_single(self, frame) -> "tuple[int, list]":
        """One frame under its sidecar's deadline (tighten-only) and trace
        context (the caller's tree joined).  Rows go to the batcher; a
        graph without one (a router, host mode) takes the object path, its
        answer framed on a dispatch thread."""
        meta = frame.meta
        puid = meta.get("puid") or new_puid()
        dl = meta.get("deadline_ms")
        # the sidecar's tenant and tier bind as the headers do on the JSON
        # lanes; a sidecar without them keeps the lane's binding
        qos = (qos_scope(meta.get("tenant"), meta.get("tier"))
               if meta.get("tenant") is not None or meta.get("tier") is not None
               else contextlib.nullcontext())
        with maybe_deadline_scope(dl / 1e3 if dl else None), \
                trace_scope(parse_traceparent(meta.get("traceparent"))), qos:
            if self.batcher is None:
                msg = wire.message_from_frame(frame)
                msg.meta.puid = puid
                resp = await self.predict(msg)
                ok = resp.status is None or resp.status.status == "SUCCESS"
                parts = await self._in_executor(
                    lambda: wire.frame_from_message(resp, response=True, sidecar=False))
                return (200 if ok else (resp.status.code or 400)), parts
            t0 = time.perf_counter()
            with self.metrics.time_server("predictions", "POST") as code, self._request_span(
                    puid, "predict", mode=self.mode):
                try:
                    rows = frame.rows()
                except wire.WireError as e:
                    code["code"] = "400"
                    return self._wire_error_frame(puid, e, 400)
                if costledger_enabled():
                    # tenant-attributed ingress bytes of the wire lane: the
                    # tensor's bytes, billed to the tenant that shipped it
                    LEDGER.note_bytes(current_tenant() or "", self.deployment.name, "wire",
                                      int(getattr(rows, "nbytes", 0)))
                try:
                    y_rows, (routing, tags) = await self._submit(rows)
                except (SeldonMessageError, GraphSpecError) as e:
                    self._request_failed(code, e, puid, t0, len(rows), "wire")
                    return self._wire_error_frame(puid, e, e.http_code)
                self._audit_request(puid, "predict", 200, t0, rows=len(rows), lane="wire")
        in_extra = frame.extra()
        extra: dict = {}
        if self._static_names:
            extra["names"] = list(self._static_names)
        if in_extra.get("kind"):
            extra["kind"] = in_extra["kind"]
        if tags or in_extra.get("tags"):
            extra["tags"] = {**(in_extra.get("tags") or {}), **pythonize_tags(tags or {})}
        if routing or in_extra.get("routing"):
            extra["routing"] = {**(in_extra.get("routing") or {}),
                                **{k: int(v) for k, v in (routing or {}).items()}}
        return 200, wire.encode_frame(np.asarray(y_rows), status=200, response=True,
                                      meta_bytes=wire.pack_wire_meta(puid=puid,
                                                                     extra=extra or None))

    # -- the gRPC lanes (runtime/grpcfast.py) ------------------------------

    async def predict_proto_wire(self, wire_bytes: bytes) -> bytes:
        """SeldonMessage bytes in, SeldonMessage bytes out: the zero-object
        gRPC lane (``engine.py:1498`` there).  A common tensor request is
        scanned at the wire level (``native/protowire.py``) and answered
        with composed bytes; anything else takes ``predict_proto``.  A
        dispatch failure answers a FAILURE message echoing the puid."""
        if self.batcher is not None:
            parsed = protowire.parse_tensor_request(wire_bytes)
            if parsed is not None:
                puid, rows = parsed
                return await self._proto_rows(puid or new_puid(), rows)
        return await self.predict_proto(wire_bytes)

    async def predict_proto(self, req: bytes) -> bytes:
        """The object gRPC lane (``engine.py:1558`` there): the bytes decoded
        by ``protoconv`` (``ProtoDecodeError`` if they do not parse); a
        tensor request with a bare meta still skips the object path, the
        rest goes through ``predict``."""
        msg = protoconv.msg_from_proto(req)
        meta = msg.meta
        if (self.batcher is not None and msg.data is not None and msg.data.kind == "tensor"
                and not (meta.tags or meta.routing or meta.requestPath)):
            return await self._proto_rows(meta.puid or new_puid(), np.atleast_2d(msg.data.array))
        resp = await self.predict(msg)
        return await self._in_executor(protoconv.msg_to_proto, resp)

    async def _proto_rows(self, puid: str, rows) -> bytes:
        """Rows through the batcher, answered as SeldonMessage bytes: the
        fixed tensor layout (``build_tensor_response``) when the answer
        carries no routing or tags, else composed (the same bytes)."""
        t0 = time.perf_counter()
        with self.metrics.time_server("predictions", "POST") as code, self._request_span(
                puid, "predict", mode=self.mode):
            try:
                y, (routing, tags) = await self._submit(rows)
            except (SeldonMessageError, GraphSpecError) as e:
                self._request_failed(code, e, puid, t0, len(rows), "grpc")
                return protoconv.msg_to_proto(
                    SeldonMessage.failure(str(e), code=e.http_code, meta=Meta(puid=puid)))
            self._audit_request(puid, "predict", 200, t0, rows=len(rows), lane="grpc")
        if not routing and not tags:
            return protowire.build_tensor_response(puid, y, self._proto_names_frag)
        return self._compose_proto_response(puid, y, routing, tags)

    def _compose_proto_response(self, puid, y, routing, tags) -> bytes:
        """A SUCCESS SeldonMessage's bytes with a float64 tensor payload and
        the meta merged (``engine.py:1617`` there)."""
        return protoconv.msg_to_proto(SeldonMessage(
            data=DefaultData(array=np.asarray(y, dtype=np.float64),
                             names=list(self._static_names or []), kind="tensor"),
            meta=Meta(puid=puid, routing={k: int(v) for k, v in (routing or {}).items()},
                      tags=pythonize_tags(tags or {})),
            status=Status()))

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if not msg.meta.puid:
            msg.meta.puid = new_puid()
        t0 = time.perf_counter()
        with self.metrics.time_server("predictions", "POST") as code, self._request_span(
                msg.meta.puid, "predict", mode=self.mode):
            resp, status, n_rows, shed = await self._predict(msg)
            if status != 200:
                code["code"] = str(status)
                # a shed is flow control, not an SLO error (time_server)
                code["shed"] = shed
            self._audit_request(msg.meta.puid, "predict", status, t0, rows=n_rows,
                                lane="object")
            return resp

    async def _predict(self, msg: SeldonMessage
                       ) -> "tuple[SeldonMessage, int, Optional[int], bool]":
        """``predict``'s body: ``(response, http status, rows, shed)``."""
        n_rows = None
        try:
            if self.compiled is not None and msg.data is not None \
                    and msg.array().dtype == object:
                # a ragged/string ndarray must fail as a 400 FAILURE message
                raise SeldonMessageError("data payload is not a numeric rectangular tensor")
            if self.batcher is not None and msg.data is not None:
                rows = np.atleast_2d(msg.array())
                n_rows = len(rows)
                y_rows, (routing, tags) = await self._submit(rows)
                resp = msg.with_array(y_rows, names=self._static_names)
                resp.meta = Meta(
                    puid=msg.meta.puid,
                    tags={**msg.meta.tags, **pythonize_tags(tags)},
                    routing={**msg.meta.routing, **routing},
                    requestPath=dict(msg.meta.requestPath),
                )
                resp.status = Status()
                return resp, 200, n_rows, False
            if self.compiled is None:
                resp = await self.executor.predict(msg)
                # the answer's readback on a dispatch thread, off the loop
                resp = await self._in_executor(_host_payload, resp)
            else:
                # rows as the batcher stacks them: a 1-D payload is one row
                shape = np.shape(np.atleast_2d(msg.array())) if msg.data is not None else None
                call = self.compiled.predict
                if isinstance(self.compiled, FusedGraph):
                    # the demotion budget, read on the request's side and
                    # passed across to the dispatch thread
                    call = functools.partial(call, budget_s=remaining_s())
                resp = await self._in_executor(self._guarded, shape, self._serial, call, msg)
                # the outlier bridge of a dispatch that takes no batcher (a
                # unit that updates its state on predict, a router graph)
                if QUALITY.enabled and resp.meta.tags:
                    QUALITY.record_outlier_tags(resp.meta.tags)
        except (SeldonMessageError, GraphSpecError) as e:
            shed = isinstance(e, LoadShedError)
            self.tracer.annotate(status=e.http_code, error=type(e).__name__, shed=shed)
            return (SeldonMessage.failure(str(e), code=e.http_code, meta=msg.meta),
                    e.http_code, n_rows, shed)
        resp.meta.puid = msg.meta.puid
        ok = resp.status is None or resp.status.status == "SUCCESS"
        return resp, 200 if ok else (resp.status.code or 400), n_rows, False

    async def _in_executor(self, fn, *args):
        """``fn(*args)`` on a dispatch thread in the caller's context (its
        tenant, tier, deadline and trace), which ``run_in_executor`` alone
        does not carry."""
        ctx = contextvars.copy_context()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, ctx.run, fn, *args)

    def _request_span(self, puid: str, method: str, **attrs):
        """The request's ``request`` span; a bound tenant and tier ride it
        as attributes (the postmortem explainer's cost row and SLO budget
        read them)."""
        tenant = current_tenant()
        if tenant is not None:
            attrs.update(tenant=tenant, tier=current_tier())
        return self.tracer.span(puid, "request", kind="request", method=method, **attrs)

    def _request_failed(self, code: dict, e, puid: str, t0: float, rows, lane: str) -> None:
        """A typed failure inside a request span: the server timer's code,
        the span's status and the audit entry."""
        code["code"] = str(e.http_code)
        # a shed is flow control, not an SLO error (time_server)
        code["shed"] = isinstance(e, LoadShedError)
        self.tracer.annotate(status=e.http_code, error=type(e).__name__, shed=code["shed"])
        self._audit_request(puid, "predict", e.http_code, t0, rows=rows, lane=lane)

    def _audit_request(self, puid: str, method: str, status: int, t0: float,
                       rows: Optional[int] = None, **extra) -> None:
        """One puid-correlated audit entry per served request (``engine.py
        :417-440`` there); a disabled log costs one attribute load."""
        if not self.audit.enabled:
            return
        # the trace id links an audit line to its /trace tree (sampled only)
        ctx = current_trace_context()
        if ctx is not None and ctx.sampled and "trace_id" not in extra:
            extra["trace_id"] = ctx.trace_id
        # the drift score inline, as the dispatch span carries it
        if method == "predict" and "drift" not in extra:
            drift = QUALITY.last_drift(self._quality_node)
            if drift is not None:
                extra["drift"] = drift
        self.audit.record(
            puid=puid, deployment=self.deployment.name, predictor=self.predictor.name,
            graph=self._graph_path, method=method, status=int(status), rows=rows,
            latency_ms=round((time.perf_counter() - t0) * 1e3, 3), mode=self.mode, **extra)

    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        """The feedback pass (engine.py:1720-1760 there): replay the
        response's ``meta.routing`` with the reward on the request's rows,
        under the engine's state lock in the fused and compiled modes,
        through the executor's routed replay in host mode (remote nodes
        get ``/send-feedback``).  Answers an ack with the response's puid,
        or a 400 FAILURE for a feedback the graph cannot take."""
        fb_puid = feedback.puid()
        t0 = time.perf_counter()
        truth_arr = feedback.truth_array()
        with self.metrics.time_server("feedback", "POST") as code, self.tracer.span(
                fb_puid, "request", kind="request", method="feedback"):
            try:
                if self.compiled is None:
                    ack = await self.executor.send_feedback(feedback)
                else:
                    routing = (feedback.response.meta.routing
                               if feedback.response is not None else {})
                    X = None
                    if feedback.request is not None and feedback.request.data is not None:
                        X = feedback.request.array()
                    await self._in_executor(self._locked, self.compiled.feedback_arrays, X,
                                            routing, feedback.reward, truth_arr)
                    ack = SeldonMessage()
                    if feedback.response is not None:
                        ack.meta.puid = feedback.response.meta.puid
            except (SeldonMessageError, GraphSpecError) as e:
                code["code"] = "400"
                self._audit_request(fb_puid, "feedback", 400, t0,
                                    reward=float(feedback.reward))
                return SeldonMessage.failure(str(e), code=400)
        self.metrics.record_feedback(feedback.reward)
        # rolling per-predictor reward and truth-vs-prediction accuracy
        QUALITY.record_feedback(self.predictor.name, feedback.reward, truth=truth_arr,
                                prediction=feedback.prediction_array())
        self._audit_request(fb_puid, "feedback", 200, t0, reward=float(feedback.reward),
                            truth_provided=truth_arr is not None)
        return ack

    # -- streaming generation (engine.py:690-849) -----------------------

    def can_stream(self) -> bool:
        """True when the continuous lane serves the graph, or the graph is a
        single unit that streams tokens (a generator exposing
        ``stream_tokens``)."""
        if self.compiled is None:
            return False
        units = self.compiled.units
        return self.genserver is not None or (
            len(units) == 1 and hasattr(next(iter(units.values())), "stream_tokens"))

    def prepare_stream_request(self, text) -> StreamRequest:
        """Validate a streaming request before any response byte exists, so
        the lane can answer a plain 400 instead of a 200 that dies.  One
        JSON parse; returns the prompt rows, the puid and ``chunk``
        (default 8, clamped to 1..256), and a top-level ``max_new`` (at
        least 1), which the continuous lane generates and the static lane,
        as the JAX engine's, validates and ignores.
        Raises SeldonMessageError on bad JSON, a bad chunk or ``max_new``,
        a graph that cannot stream or a payload without a non-empty
        numeric prompt of token rows."""
        chunk, max_new = 8, None
        try:
            doc = json.loads(text)
        except (TypeError, ValueError) as e:
            raise SeldonMessageError(f"invalid JSON: {e}") from None
        if isinstance(doc, dict) and "chunk" in doc:
            try:
                chunk = max(1, min(256, int(doc["chunk"])))
            except (TypeError, ValueError):
                raise SeldonMessageError("chunk must be an integer") from None
        if isinstance(doc, dict) and doc.get("max_new") is not None:
            max_new = _max_new(doc["max_new"])
        if not self.can_stream():
            raise SeldonMessageError(
                "graph does not support streaming generation (need a single generator node)")
        msg = SeldonMessage.from_json_dict(doc)
        return StreamRequest(_prompt_rows(msg), msg.meta.puid or new_puid(), chunk, max_new,
                             current_trace_context(), current_tenant(), current_tier())

    def _next_chunk(self, gen):
        """One chunk of a stream on the host, or None at its end.  Runs on
        the dispatch executor, in inference mode as a dispatch runs: a
        static stream's kernels launch on its thread and the readback
        synchronises its stream; a continuous stream waits there for the
        scheduler's next chunk."""
        with torch.inference_mode():
            toks = next(gen, None)
        if toks is None:
            return None
        return toks.cpu().numpy() if isinstance(toks, torch.Tensor) else np.asarray(toks)

    async def generate_stream(self, request: StreamRequest):
        """Incremental generation of a request that
        ``prepare_stream_request`` validated: yields JSON strings
        ``{"tokens": [[...]], "done": false}`` per chunk, then ``{"done":
        true, "meta": {"puid": ...}}``.  Greedy streams concatenate to
        exactly the ``predict_json`` output.  On the continuous lane the
        stream joins the running batch (``genserver.stream``); on the static
        lane it runs the unit's ``stream_tokens`` and bypasses the batcher.
        Streams never write unit state back; closing this generator closes
        the lane's (a continuous stream's request is then cancelled)."""
        gen = pending = None
        t0 = time.perf_counter()
        ttft_s, tokens, status = None, 0, 200
        try:
            with trace_scope(request.trace), qos_scope(request.tenant, request.tier), \
                    self.metrics.time_server("generate-stream", "POST"), \
                    self._request_span(request.puid, "generate_stream"):
                # opened inside the span: the continuous lane's sequences
                # take the request span's context at submit
                if self.genserver is not None:
                    gen = self.genserver.stream(request.rows, chunk=request.chunk,
                                                max_new=request.max_new)
                else:
                    name, unit = next(iter(self.compiled.units.items()))
                    gen = unit.stream_tokens(self.compiled.states[name], request.rows,
                                             chunk=request.chunk)
                try:
                    while True:
                        pending = self._executor.submit(self._next_chunk, gen)
                        toks = await asyncio.wrap_future(pending)
                        if toks is None:
                            break
                        if ttft_s is None:
                            ttft_s = time.perf_counter() - t0
                        tokens += int(toks.size)
                        yield json.dumps({"tokens": toks.astype(float).tolist(),
                                          "done": False})
                except GeneratorExit:
                    status = 499  # the client left mid-stream
                    self.tracer.annotate(status=499)
                    raise
                except Exception as e:
                    status = 500  # reported in-band by the lane's error frame
                    self.tracer.annotate(status=500, error=type(e).__name__)
                    raise
        finally:
            # closed when no chunk is running: now, or as soon as the one
            # still on the executor (a cancelled stream's) returns
            if gen is None:
                pass
            elif pending is None:
                gen.close()
            else:
                pending.add_done_callback(lambda _: gen.close())
            elapsed = time.perf_counter() - t0
            self._audit_request(
                request.puid, "generate_stream", status, t0, rows=int(request.rows.shape[0]),
                tokens=tokens, ttft_ms=None if ttft_s is None else round(ttft_s * 1e3, 3),
                tokens_per_s=None if elapsed <= 0 else round(tokens / elapsed, 1),
                **({"trace_id": request.trace.trace_id}
                   if request.trace is not None and request.trace.sampled else {}))
        yield json.dumps({"done": True, "meta": {"puid": request.puid}})

    # -- prewarm (engine.py:851-909) --------------------------------------

    def prewarm(self, widths) -> int:
        """Run every batch-bucket shape of the given feature widths once
        before the server binds; returns the number of shapes run.

        The batcher pads to powers of two capped at ``max_batch``, so a
        stateless graph's shapes per width are {1, 2, 4, ..., max_batch}; a
        stateful graph takes no batcher (its rows are not padded) and runs
        one row.  Each walk leaves the unit states as they were
        (``update_states=False``) and reads its answer back.  The port
        compiles nothing here, as XLA would: what a prewarm buys is the
        kernels' first-use cost (the ``ops/_build.py`` load, a source-hash
        hit or nvcc on a cold cache, the CUDA context, cuBLAS handles and
        the caching allocator's first blocks), and a perf-observatory row
        for every bucket, which is the autopilot's seed prior before the
        bucket's first dispatch.  A width the graph rejects is logged and
        skipped.  The continuous lane prewarms through its scheduler
        (``GenServer.prewarm``)."""
        if self.compiled is None:
            return 0
        if self.genserver is not None:
            return self.genserver.prewarm(widths)
        if isinstance(self.batcher, MicroBatcher):
            mb = self.batcher.max_batch
            # a non-power-of-two max_batch is itself a bucket
            sizes = [1 << i for i in range(mb.bit_length()) if (1 << i) < mb] + [mb]
        elif self._stateful:
            sizes = [1]
        else:
            return 0
        done = 0
        for width in widths:
            shape = (width,) if isinstance(width, int) else tuple(width)
            # the smallest batch first: a width the graph cannot take must
            # not stop the server from binding
            for b in sizes:
                x = np.zeros((b,) + shape, dtype=np.float64)
                try:
                    y, _, _ = self.compiled.predict_arrays(x, update_states=False)
                    y.detach().cpu()
                except Exception as e:  # noqa: BLE001 - any shape error
                    logger.warning("prewarm: width %s rejected by the graph at batch %d "
                                   "(%s: %s); skipping this width", shape, b,
                                   type(e).__name__, e)
                    break
                self._known_good_widths.add(x.shape[1:])
                done += 1
        return done

    # -- admin (engine RestClientController.java:57-99) -------------------

    def stats(self) -> dict:
        """The JSON behind ``GET /stats``: the engine's live blocks (mode,
        batcher, fusion plan, wire, breakers, kernel launches, scheduler)
        and the reference's observatory walks (``engine.py:446-531``
        there).  The walks are served from a cached assembly after
        draining the spine's pending records, reused while nothing under
        them moved (the spine's fold generation and the recorder's
        mutation generation unchanged) and younger than
        ``SELDON_TPU_STATS_TTL_S``; ``staleness_s`` is the cache's age."""
        SPINE.drain()
        now = time.monotonic()
        key = (SPINE.fold_generation, RECORDER._gen, TRACER.enabled, TRACER.sample,
               OBSERVATORY.enabled, QUALITY.enabled, QUALITY.sample)
        cached = self._stats_cache
        if cached is not None and cached[0] == key and now - cached[1] < self._stats_ttl_s:
            walks, staleness = cached[2], now - cached[1]
        else:
            walks = {
                "telemetry": RECORDER.snapshot(),
                "perf": OBSERVATORY.snapshot(),
                "quality": QUALITY.snapshot(),
                "tracer": TRACER.snapshot(),
            }
            self._stats_cache = (key, now, walks)
            staleness = 0.0
        codec = fastcodec.codec_status()
        out = {
            "boot_id": self.boot_id,
            "engine": {
                "deployment": self.deployment.name,
                "predictor": self.predictor.name,
                "mode": self.mode,
                "paused": self.paused,
                "pipelined": self._pipelined,
                "dispatch_timeout_s": self.dispatch_timeout_s,
                "known_good_widths": sorted(str(w) for w in self._known_good_widths),
                # the fusion pass and its plan: fused roots, blocked nodes
                # and the per-request hops saved
                "graph_fuse": {"enabled": self._fuse,
                               "plan": None if self.fusion_plan is None
                               else self.fusion_plan.summary()},
                # the port's additions: the lane serving the HTTP routes,
                # the JSON codec and its binding, and any native build error
                "http_impl": self.http_impl,
                "codec": self.codec,
                "codec_binding": codec["binding"],
                "native_errors": {**codec["errors"], **_plane_errors()},
            },
            "batcher": self.batcher.snapshot() if self.batcher is not None else None,
            "genserver": None if self.genserver is None else self.genserver.snapshot(),
            "resilience": {"retry_budget": self.retry_budget.snapshot(),
                           "breakers": {name: br.snapshot()
                                        for name, br in self.breakers.items()}},
            "device": self.device.type,
            # each unit's device mesh (a binding's mesh_axes): its axes and
            # its devices in the flat order its shards follow
            "meshes": {name: {"axes": dict(unit.mesh.shape),
                              "devices": [str(d) for d in unit.mesh.device_list]}
                       for name, unit in (self.compiled.units.items()
                                          if self.compiled is not None else ())
                       if getattr(unit, "mesh", None) is not None},
            "wire": {"enabled": wire.wire_enabled(),
                     "bytes_copied": RECORDER.wire_bytes_copied},
            "kernels": {"fused_mlp_softmax": {"launches": fused_mlp.LAUNCHES},
                        "flash_attention": {"launches": flash_attention.LAUNCHES},
                        "flash_decode": {"launches": flash_decode.LAUNCHES},
                        "kv_write": {"launches": kv_write.LAUNCHES},
                        "flash_decode_paged": {
                            "launches": flash_decode.PAGED_LAUNCHES,
                            "float32_launches": flash_decode.PAGED_F32_LAUNCHES},
                        "kv_write_paged": {"launches": kv_write.PAGED_LAUNCHES}},
        }
        out.update(walks)
        # the MAB router state read back from the card (per-branch
        # success and tries)
        out["routers"] = router_quality(self.states())
        # the learned cost model's health (the table is GET /autopilot) and
        # the brownout ladder: stage, live signals, recent transitions
        out["autopilot"] = AUTOPILOT.snapshot()
        out["brownout"] = BROWNOUT.snapshot()
        out["audit"] = self.audit.snapshot()
        out["staleness_s"] = round(staleness, 3)
        return out

    def _identity(self) -> dict:
        return {"deployment": self.deployment.name, "predictor": self.predictor.name,
                "mode": self.mode}

    def overhead_document(self) -> dict:
        """``GET /overhead``: the telemetry budget as a self-observed SLO,
        per-subsystem framework time from the spine's records."""
        return {"engine": self._identity(), **SPINE.overhead_document()}

    def perf_document(self) -> dict:
        """``GET /perf``: the perf observatory's per-executable table, the
        card's peaks and memory watermarks, under this engine's identity."""
        return {"engine": self._identity(), **OBSERVATORY.document()}

    def genperf_document(self) -> dict:
        """``GET /genperf``: the generation-lane recorder (per-tick-kind
        latency, host/device phase splits, the bubble ledger, served decode
        MFU and HBM-bandwidth share over real rows, KV-block residency)
        with the live scheduler picture and its prefill-chunk state.  A
        lane without a scheduler answers an empty recorder, not a 500."""
        SPINE.drain()  # pending tick records fold into GENPERF first
        return {
            "engine": self._identity(),
            "scheduler": None if self.genserver is None else self.genserver.snapshot(),
            "adaptive_chunk": (None if self.genserver is None
                               else self.genserver.chunk_history()),
            **GENPERF.document(),
        }

    def autopilot_document(self) -> dict:
        """``GET /autopilot``: the learned cost model (the per-key latency
        table, knobs, misprediction distribution, shed and decision
        counters) under this engine's identity."""
        SPINE.drain()  # pending dispatch records train the model first
        return {"engine": self._identity(), **AUTOPILOT.document()}

    def corpus_document(self) -> dict:
        """``GET /corpus``: the durable perf corpus (per-key sketches,
        segments, rotations, warm-start counters) under this engine's
        identity."""
        SPINE.drain()  # pending dispatch records land in the corpus first
        return {"engine": self._identity(), **CORPUS.document()}

    def quality_document(self) -> dict:
        """``GET /quality``: the quality observatory (per-node drift table,
        feedback reward and accuracy, the outlier bridge, SLO burn rates)
        under this engine's identity, with the MAB router state read back."""
        return {"engine": self._identity(), "routers": router_quality(self.states()),
                **QUALITY.document()}

    def costs_document(self) -> dict:
        """``GET /costs``: the resource ledger (device-seconds per tenant x
        deployment x phase, pad tax, KV-block-seconds, attributed bytes,
        the accounting identity and the capacity block) under this
        engine's identity."""
        LEDGER.devices = max(1, torch.cuda.device_count()) if self.device.type == "cuda" else 1
        SPINE.drain()  # pending flush and tick records land in the ledger first
        return {"engine": self._identity(), **LEDGER.document()}

    def postmortems_document(self, puid: str = "") -> dict:
        """``GET /postmortems``: the tail-sampled postmortem recorder (kept
        exemplars and their explanations, retention counters, the pending
        buffer) under this engine's identity; ``puid`` (or a trace id)
        answers one full exemplar."""
        SPINE.drain()  # pending request spans complete their verdicts first
        return {"engine": self._identity(), **POSTMORTEM.document(puid=puid)}

    def process_track_name(self) -> str:
        """The Perfetto process-track label of ``/trace/export``."""
        return f"{self.deployment.name}/{self.predictor.name} (unified)"

    async def kv_frame(self, payload: bytes) -> "tuple[int, bytes]":
        """One KV-stream frame off the relay (``runtime/kvstream.py``,
        ``engine.py:966-1019`` there).  Only a decode replica imports
        blocks; any other answers a typed 503.  KV_STATS answers on every
        role."""
        try:
            sub_op, hid, body = kvstream.parse_frame(payload)
        except kvstream.KvWireError as e:
            return 400, str(e).encode()
        gs = self.genserver
        if gs is None:
            return 503, (b"this replica runs no generation scheduler "
                         b"(KV handoffs need --gen-role decode)")
        if sub_op == kvstream.KV_STATS:
            st = gs.kv_stats()
            return 200, kvstream.pack_stats(st["free"], st["total"], st["waiting"],
                                            st["inflight"])
        if gs.role != "decode":
            RECORDER.record_kv_handoff("refused")
            return 503, (f"role misconfig: this replica is {gs.role!r}, KV handoffs import "
                         f"only at --gen-role decode replicas").encode()
        try:
            if sub_op == kvstream.KV_BEGIN:
                gs.kv_reserve(hid, kvstream.parse_begin(body))
                return 200, b""
            if sub_op == kvstream.KV_BLOCKS:
                imp = gs._imports.get(hid)
                if imp is None:
                    raise kvstream.KvWireError("unknown or expired handoff id")
                first, layers = kvstream.parse_blocks(body, imp.meta)
                gs.kv_receive(hid, first, layers)
                return 200, b""
            if sub_op == kvstream.KV_COMMIT:
                req = gs.kv_commit(hid)
                toks = await asyncio.wrap_future(req.future)
                return 200, kvstream.pack_tokens(toks[0])
            if sub_op == kvstream.KV_ABORT:
                gs.kv_abort(hid)
                return 200, b""
        except LoadShedError as e:
            return 503, str(e).encode()
        except kvstream.KvWireError as e:
            return 409, str(e).encode()
        except Exception as e:  # noqa: BLE001 - answered typed, the engine keeps serving
            logger.exception("KV handoff frame failed")
            return 500, f"{type(e).__name__}: {e}".encode()
        return 400, f"unknown KV sub-op {sub_op}".encode()

    def _handoff_event(self, **fields) -> None:
        """One audit line per completed hand-off (none with the audit log
        off); the coordinator stamps the trace, puid, tenant and tier."""
        if not self.audit.enabled:
            return
        self.audit.record(puid=fields.pop("puid", "") or "", deployment=self.deployment.name,
                          predictor=self.predictor.name, method="kv_handoff", status=200,
                          rows=None, latency_ms=fields.pop("latency_ms", None), mode=self.mode,
                          **fields)

    def trace_json(self, query: str) -> str:
        """The relay's trace surface (``OP_TRACE``): the local trace
        document for a JSON query ``{"trace_id"|"puid"|"limit"}``."""
        try:
            q = json.loads(query) if query.strip() else {}
            if not isinstance(q, dict):
                q = {}
        except ValueError:
            q = {}
        doc = trace_document(TRACER, puid=str(q.get("puid", "") or ""),
                             trace_id=str(q.get("trace_id", "") or ""),
                             limit=int(q.get("limit", 100) or 100))
        return json.dumps(doc)

    def close(self) -> None:
        """Stop the generation scheduler, close the remote nodes' pooled
        connections and stop the dispatch threads (after the last request)."""
        if self.genserver is not None:
            self.genserver.stop()
        if self.executor is not None:
            for rt in self.executor.runtimes.values():
                closer = getattr(rt, "close", None)
                if closer is not None:
                    closer()
        self._executor.shutdown(wait=True)

    def ready(self) -> bool:
        return not self.paused

    def open_breakers(self) -> "list[str]":
        """Remote nodes whose breaker is not closed, shown in ``/ready``."""
        return sorted(name for name, br in self.breakers.items()
                      if br.state != CircuitBreaker.CLOSED)

    def pause(self) -> None:
        self.paused = True

    def unpause(self) -> None:
        self.paused = False

    def drained(self) -> bool:
        """No queued or in-flight work — the shutdown drain's exit probe."""
        if self.genserver is not None:
            g = self.genserver.snapshot()
            return not g["inflight_sequences"] and not g["waiting_sequences"]
        if self.batcher is None:
            return True
        b = self.batcher.snapshot()
        return not b["inflight_dispatches"] and not any(
            v["requests"] for v in b["buckets"].values()
        )

    # -- state handoff ----------------------------------------------------

    def states(self) -> dict:
        if self.compiled is None:
            return self.executor.states()
        return dict(self.compiled.states)

    def load_states(self, states) -> None:
        """Replace unit states (e.g. ``{"mnist": convert.params_from_jax(...)}``),
        moved to the engine's device.  The continuous lane's scheduler is
        built again over the new weights, with the old one's pool and round
        sizes (the old one is stopped).  In host mode the names of remote
        nodes are ignored."""
        if self.compiled is None:
            self.executor.load_states(states)
            return
        self.compiled.states.update(
            {name: to_device(st, self.device) for name, st in states.items()}
        )
        if self.genserver is not None:
            old = self.genserver
            old.stop()
            self.genserver = None
            self._build_genserver({k: getattr(old, k) for k in (
                "block_size", "num_blocks", "slots", "span", "prefill_chunk")})
            self.batcher = GenLane(self.genserver) if self.batcher is not None else None
