"""The native data plane — the port's counterpart of
``seldon_core_tpu/runtime/nativeplane.py``, a ctypes driver for
``native/csrc/dataplane.cpp`` (built with g++ at first use,
``native/_build.py``).

The C++ IO thread terminates HTTP/1.1 and h2/gRPC, parses numeric predict
payloads (``fastcodec.cpp``) and coalesces rows into width-keyed batches;
Python's part of a request is one blocking FFI call per BATCH:

    dp_next_batch() -> float64 view -> pad to the batcher's bucket ->
        compiled.predict_arrays on the engine's device -> readback
        (the one sync, where the dispatch wall ends) -> dp_complete_batch(y)

So served MNIST reaches the fused-MLP kernel once per native batch.  The
C++ composer answers what the Python lane would (its header states the
rule); every other request arrives on the misc queue with its head and is
served by the same route table as the Python lane (``runtime/rest.py``
``_EngineRoutes``, bound with the request's deadline, trace parent and
QoS identity as that lane binds them), and gRPC calls off the tensor lane
by ``FastGrpcServer.for_engine(engine).handlers`` (``runtime/grpcfast.py``).
The SSE route answers 501 there, as the reference's plane does.

A dispatch failure is split by ``is_client_shape_error`` under the
known-good-width rule, as the engine's lanes split it: a 400 "graph
rejected input of shape ..." with each caller's meta (a FAILURE message
answered OK on gRPC, as the Python gRPC lane answers), or a 500.  Each
batch writes the batcher lane's telemetry: a ``plane_batch`` span,
``OBSERVATORY.note_padding``, ``SPINE.record_flush`` with the cost payload,
``record_dispatch`` (the quality fold's rows a copy, since the view is
recycled when the batch completes) or ``record_failed_dispatch``.

Eligibility (``nativeplane.py:204-266`` there): a compiled, batchable and
pipelined graph (``EngineService._pipelined``) with no unit declaring
``static_tags``, whose probe dispatch on a prewarmed width emits no
routing or tags.  ``serve_native`` raises RuntimeError otherwise, or when
the library does not build (the error carries g++'s stderr and is kept
for ``/stats``, ``build_errors()``); ``engine_main`` then serves the
Python lane and says so.  Not bound on the native lanes: the Python
lanes' per-request SLO feed and latency reservoirs (the C++ lanes' own
histograms are merged into ``/prometheus``), and gRPC's ``grpc-timeout``.
"""

from __future__ import annotations

import asyncio
import contextvars
import ctypes
import json
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.graph.spec import GraphSpecError
from seldon_core_tpu_torch.messages import SeldonMessageError, Status
from seldon_core_tpu_torch.native import _build
from seldon_core_tpu_torch.runtime.batching import MicroBatcher, pad_rows
from seldon_core_tpu_torch.runtime.engine import is_client_shape_error
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcServer, call_context
from seldon_core_tpu_torch.runtime.qos import TIER_INTERACTIVE
from seldon_core_tpu_torch.runtime.rest import (
    StreamResult,
    _EngineRoutes,
    _failure,
    _header_value,
    request_context,
    route_handler,
)
from seldon_core_tpu_torch.utils.costledger import costledger_enabled
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.perf import OBSERVATORY

__all__ = ["NativeDataPlane", "serve_native", "native_plane_available", "build_errors"]

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_attempted = False
_ERRORS: Dict[str, str] = {}

#: dp_stats: two blocks, HTTP/1.1 then h2/gRPC, each 2xx/4xx/5xx, the
#: latency sum in us and 15 histogram buckets (the 14 edges of
#: utils/metrics.py and +Inf)
_STATS_SLOTS = 38
_LANE_SLOTS = 19


class _DpBatchView(ctypes.Structure):
    _fields_ = [
        ("id", ctypes.c_longlong),
        ("rows", ctypes.c_longlong),
        ("width", ctypes.c_longlong),
        ("data", ctypes.POINTER(ctypes.c_double)),
    ]


class _DpMiscView(ctypes.Structure):
    _fields_ = [
        ("id", ctypes.c_longlong),
        ("method", ctypes.c_void_p), ("method_len", ctypes.c_longlong),
        ("path", ctypes.c_void_p), ("path_len", ctypes.c_longlong),
        ("query", ctypes.c_void_p), ("query_len", ctypes.c_longlong),
        ("ctype", ctypes.c_void_p), ("ctype_len", ctypes.c_longlong),
        ("body", ctypes.c_void_p), ("body_len", ctypes.c_longlong),
        ("head", ctypes.c_void_p), ("head_len", ctypes.c_longlong),
    ]


def _bind(lib) -> None:
    c_ll, c_int, c_p, c_s = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "dp_start": (c_p, [c_s, c_int, c_int, c_ll, ctypes.c_double, c_int, c_s, c_ll, c_s,
                           c_ll]),
        "dp_port": (c_int, [c_p]),
        "dp_grpc_port": (c_int, [c_p]),
        "dp_next_batch": (c_int, [c_p, ctypes.POINTER(_DpBatchView)]),
        "dp_complete_batch": (c_int, [c_p, c_ll, ctypes.POINTER(ctypes.c_double), c_ll, c_ll]),
        "dp_fail_batch": (c_int, [c_p, c_ll, c_int, c_s, c_ll, c_s, c_ll]),
        "dp_next_misc": (c_int, [c_p, ctypes.POINTER(_DpMiscView)]),
        "dp_respond_misc": (c_int, [c_p, c_ll, c_int, c_s, c_s, c_ll]),
        "dp_respond_grpc": (c_int, [c_p, c_ll, c_int, c_s, c_ll, c_s, c_ll]),
        "dp_stats": (None, [c_p, ctypes.POINTER(c_ll)]),
        "dp_stop": (None, [c_p]),
        "dp_shutdown": (None, [c_p]),
        "dp_destroy": (None, [c_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _load():
    """The plane's library, built and bound once; raises RuntimeError (with
    the build's error) when it cannot be had."""
    global _lib, _attempted
    with _lock:
        if _lib is None and not _attempted:
            _attempted = True
            try:
                lib = ctypes.CDLL(str(_build.build("dataplane")))
                _bind(lib)
                _lib = lib
            except Exception as e:  # noqa: BLE001 - kept for /stats and re-raised below
                _ERRORS["dataplane"] = f"{type(e).__name__}: {e}"
        if _lib is None:
            raise RuntimeError(f"native data plane unavailable ({_ERRORS.get('dataplane')})")
        return _lib


def native_plane_available() -> bool:
    """Whether the plane's library builds and loads (building it at the
    first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def build_errors() -> Dict[str, str]:
    """The plane's build or load error, if its load was tried and failed."""
    return dict(_ERRORS)


def _failure_body(info: str, code: int) -> "tuple[bytes, bytes]":
    """A failed batch's answers without their meta: the JSON lane's
    ``{"status": ...}`` (the C++ side prepends each caller's meta) and
    the gRPC message's status field."""
    status = Status.failure(info, code=code)
    body = json.dumps({"status": status.to_json_dict()}, separators=(",", ":")).encode()
    return body, protoconv.status_field(status)


class NativeDataPlane:
    """Owns the C++ plane handle and the Python dispatch and misc threads."""

    def __init__(self, engine, host: str, port: int, grpc_port: Optional[int] = None,
                 workers: Optional[int] = None):
        self.engine = engine
        self.lib = _load()
        if (engine.compiled is None or not isinstance(engine.batcher, MicroBatcher)
                or not engine._pipelined):
            raise RuntimeError("native data plane requires a pipelined batchable compiled "
                               "graph (stateless predict); use the Python plane")
        if any(getattr(u, "static_tags", None) for u in engine.compiled.units.values()):
            raise RuntimeError("graph units declare static_tags; the native composer does "
                               "not merge tags into meta — use the Python plane")
        self._probe_no_tags()
        names = (engine._names_fragment or "").encode()
        proto_names = bytes(engine._proto_names_frag or b"")
        self.max_batch = engine.batcher.max_batch
        self._workers = workers or engine.batcher.max_inflight
        self.handle = self.lib.dp_start(
            host.encode(), int(port), -1 if grpc_port is None else int(grpc_port),
            # the batcher's coalescing window (its wait while a slot is
            # free), so a lone request waits on neither lane longer than
            # on the other
            int(self.max_batch), float(engine.batcher.coalesce_s * 1e3), int(self._workers),
            names, len(names), proto_names, len(proto_names))
        if not self.handle:
            raise RuntimeError(f"native data plane failed to bind {host}:{port}")
        self.port = self.lib.dp_port(self.handle)
        self.grpc_port = self.lib.dp_grpc_port(self.handle) if grpc_port is not None else None
        self._loop = None
        self._threads = []
        self._stopped = False
        self._last_stats = np.zeros(_STATS_SLOTS, dtype=np.int64)
        self._stats_lock = threading.Lock()

    def _probe_no_tags(self) -> None:
        """A graph that emits per-request routing or tags needs meta the C++
        composer does not write: refused up front on any prewarmed
        width."""
        widths = [w for w in self.engine._known_good_widths if w is not None and len(w) == 1]
        if not widths:
            return
        x = np.zeros((1,) + tuple(widths[0]), dtype=np.float64)
        _, routing, tags = self.engine.compiled.predict_arrays(x, update_states=False)
        if routing or tags:
            raise RuntimeError("graph emits per-request routing/tags; native plane disabled "
                               "(the Python plane serves it with full meta)")

    # -- threads ---------------------------------------------------------

    def start(self, loop) -> None:
        """Start the dispatch threads and the misc lane's bridge onto
        ``loop``, the running loop that serves the engine's routes."""
        self._loop = loop
        self._routes = _EngineRoutes(self.engine)
        self._grpc_handlers = (FastGrpcServer.for_engine(self.engine).handlers
                               if self.grpc_port is not None else {})
        self.engine.http_impl = "native"
        for i in range(self._workers):
            t = threading.Thread(target=self._dispatch_loop, name=f"dp-dispatch-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._misc_loop, name="dp-misc", daemon=True)
        t.start()
        self._threads.append(t)

    def _dispatch_loop(self) -> None:
        lib, handle, view = self.lib, self.handle, _DpBatchView()
        while lib.dp_next_batch(handle, ctypes.byref(view)):
            self._dispatch_one(view)

    def _dispatch_one(self, view) -> None:
        """One native batch: pad, dispatch, read back, answer."""
        engine, lib, handle = self.engine, self.lib, self.handle
        bid, rows, width = int(view.id), int(view.rows), int(view.width)
        # a view of the C++ batch buffer, recycled when the batch completes
        x = np.ctypeslib.as_array(view.data, shape=(rows, width))
        padded = x
        try:
            with engine.tracer.span("", "plane_batch", kind="plane", rows=rows):
                target = pad_rows(rows, self.max_batch)
                if target > rows:  # the batcher's buckets: its prewarm covers them
                    padded = np.concatenate([x, np.repeat(x[-1:], target - rows, axis=0)])
                OBSERVATORY.note_padding(rows, len(padded))
                wants = SPINE.dispatch_wants()
                t_dispatch = time.perf_counter()
                start_s = time.time()
                try:
                    y, routing, tags = engine.compiled.predict_arrays(padded,
                                                                      update_states=False)
                    # the readback: the response needs it, and the dispatch
                    # wall ends here
                    y = y.detach().cpu().numpy()
                except BaseException as e:
                    engine.tracer.annotate(status=500, error=type(e).__name__)
                    if wants.trace:
                        SPINE.record_failed_dispatch(
                            executable=engine.compiled.executable_key(padded),
                            seconds=time.perf_counter() - t_dispatch, start_s=start_s,
                            rows=rows, method="native", error=type(e).__name__)
                    raise
                dispatch_s = time.perf_counter() - t_dispatch
                # a native batch is a stacked flush: the C++ coalescer does
                # not surface request boundaries or tenants, so the wall
                # books to the anonymous tenant at the default tier and
                # requests=0 marks the count unknown
                cost = None
                if costledger_enabled():
                    cost = {"dep": engine.deployment.name, "padded": len(padded),
                            "tenants": [("", TIER_INTERACTIVE, float(rows), 0, 0)]}
                SPINE.record_flush(rows=rows, requests=0, start_s=start_s,
                                   duration_s=dispatch_s, cost=cost)
                if wants.any:
                    SPINE.record_dispatch(
                        wants, executable=engine.compiled.executable_key(padded),
                        seconds=dispatch_s, start_s=start_s, rows=len(padded), real_rows=rows,
                        method="native", quality_node=engine._quality_node,
                        # the view is recycled at completion: a deferred
                        # quality fold holds its own copy
                        X=(np.array(x) if padded is x else padded) if wants.quality else None,
                        Y=y, phases=engine.compiled.phases)
                if routing or tags or y.dtype.kind != "f":
                    # the C++ composer writes neither per-request meta nor
                    # integer values: refused loudly, never stripped
                    logger.error("native plane cannot compose this graph's answer (routing, "
                                 "tags or a non-float output); set ENGINE_HTTP_IMPL=fast")
                    body, proto = _failure_body(
                        "graph emits per-request routing/tags or a non-float output; "
                        "restart with ENGINE_HTTP_IMPL=fast", 500)
                    lib.dp_fail_batch(handle, bid, 500, body, len(body), None, 0)
                    return
                y = np.ascontiguousarray(y[:rows], dtype=np.float64).reshape(rows, -1)
                engine._known_good_widths.add((width,))
                lib.dp_complete_batch(handle, bid,
                                      y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                      y.shape[0], y.shape[1])
        except Exception as e:  # noqa: BLE001 - split as the engine's lanes split it
            if (width,) not in engine._known_good_widths and is_client_shape_error(e):
                body, proto = _failure_body(
                    f"graph rejected input of shape {tuple(padded.shape)}: {e}", 400)
                lib.dp_fail_batch(handle, bid, 400, body, len(body), proto, len(proto))
            else:
                logger.exception("native plane dispatch failed")
                body, _ = _failure_body(str(e), 500)
                lib.dp_fail_batch(handle, bid, 500, body, len(body), None, 0)

    def _misc_loop(self) -> None:
        lib, handle, view = self.lib, self.handle, _DpMiscView()
        while lib.dp_next_misc(handle, ctypes.byref(view)):
            mid = int(view.id)
            method, path, query, ctype, body, head = (
                ctypes.string_at(getattr(view, f), getattr(view, f + "_len"))
                for f in ("method", "path", "query", "ctype", "body", "head"))
            if method == b"GRPC":
                self._spawn(self._handle_grpc(path, body), self._grpc_context(head),
                            lambda t, mid=mid: self._grpc_done(mid, t))
            else:
                ctx = request_context(query, head.lower(), head)
                self._spawn(self._handle_misc(method, path, ctype, body), ctx,
                            lambda t, mid=mid: self._misc_done(mid, t))

    def _spawn(self, coro, ctx, done) -> None:
        """Run ``coro`` as a task on the engine's loop in ``ctx``; ``done``
        answers from the task's completion, so one slow handler never
        holds the misc lane."""
        def start():
            task = self._loop.create_task(coro, context=ctx)
            task.add_done_callback(done)

        self._loop.call_soon_threadsafe(start)

    @staticmethod
    def _grpc_context(meta_head: bytes) -> contextvars.Context:
        """The gRPC lane's binding of a call's metadata (the C++ side passes
        it as ``"\r\nname: value"`` lines): its trace parent and QoS
        identity."""
        tp, tenant, tier = (_header_value(meta_head, name) for name in (
            b"traceparent:", b"seldon-tenant:", b"seldon-tier:"))
        return call_context(*(None if v is None else v.decode("latin-1")
                              for v in (tp, tenant, tier)))

    async def _handle_misc(self, method: bytes, path: bytes, ctype: bytes, body: bytes):
        """The Python lane's route table, with its method and 404/405
        rules; the SSE route answers 501."""
        handler, status = route_handler(self._routes, method, path)
        if handler is None:
            return status, (b"method not allowed" if status == 405 else b"not found"), \
                "text/plain"
        if path == b"/prometheus":
            self._merge_native_metrics()
        result = await handler(body, ctype.decode("latin-1"))
        if isinstance(result, StreamResult):
            # the misc bridge sends single complete responses; streaming is
            # the Python lane's (ENGINE_HTTP_IMPL=fast)
            await result.agen.aclose()
            return (501, b'{"status":{"code":501,"status":"FAILURE","reason":"streaming is '
                         b'served by the Python data plane (ENGINE_HTTP_IMPL=fast)"}}',
                    "application/json")
        return result

    def _misc_done(self, mid: int, task) -> None:
        if self._stopped or self.handle is None:
            return
        try:
            status, resp, rctype = task.result()
        except (SeldonMessageError, GraphSpecError) as e:
            status, resp, rctype = e.http_code, _failure(e, e.http_code), "application/json"
        except Exception as e:  # noqa: BLE001 - the Python lane's catch-all: a 500
            logger.exception("misc handler failed")
            status, resp, rctype = 500, _failure(e, 500), "application/json"
        if isinstance(resp, list):  # a binary frame's parts
            resp = b"".join(bytes(p) for p in resp)
        self.lib.dp_respond_misc(self.handle, mid, int(status), rctype.encode(), resp,
                                 len(resp))

    async def _handle_grpc(self, path: bytes, message: bytes):
        """The gRPC misc lane: the Python gRPC lane's handler table and
        status mapping (``grpcfast._ServerConnection._run``)."""
        handler = self._grpc_handlers.get(path)
        if handler is None:
            return 12, b"unknown method " + path, b""  # UNIMPLEMENTED
        try:
            response = await handler(message)
        except NotImplementedError as e:
            return 12, str(e).encode(), b""
        except Exception as e:  # noqa: BLE001 - a handler bug: INTERNAL
            logger.exception("grpc misc handler failed")
            return 13, str(e).encode(), b""
        return 0, b"", response

    def _grpc_done(self, mid: int, task) -> None:
        if self._stopped or self.handle is None:
            return
        try:
            status, message, payload = task.result()
        except Exception as e:  # noqa: BLE001 - INTERNAL
            status, message, payload = 13, str(e).encode(), b""
        self.lib.dp_respond_grpc(self.handle, mid, int(status), message, len(message),
                                 payload, len(payload))

    # -- metrics -----------------------------------------------------------

    def stats(self) -> np.ndarray:
        """``dp_stats``: the C++ lanes' counters (``_STATS_SLOTS`` int64)."""
        arr = (ctypes.c_longlong * _STATS_SLOTS)()
        self.lib.dp_stats(self.handle, arr)
        return np.frombuffer(arr, dtype=np.int64).copy()

    def _merge_native_metrics(self) -> None:
        """Fold the C++ lanes' latency histograms into the engine's
        ``seldon_api_engine_server_requests_duration_seconds`` family (the
        predictions child the Python lanes time, code 200), bucket by
        bucket, as the deltas since the last scrape."""
        with self._stats_lock:
            stats = self.stats()
            delta = stats - self._last_stats
            self._last_stats = stats
        for lane in (delta[:_LANE_SLOTS], delta[_LANE_SLOTS:]):
            if lane[0] > 0:
                self.engine.metrics.merge_server_counts(
                    "predictions", "POST", "200", [int(n) for n in lane[4:]],
                    float(lane[3]) / 1e6)

    # -- lifecycle -----------------------------------------------------------

    async def stop(self) -> None:
        """Two-phase: ``dp_shutdown`` wakes every blocked thread and stops IO
        (the plane stays allocated, so a thread mid-dispatch stays safe);
        ``dp_destroy`` frees it only after the threads joined.  A thread
        wedged past the join timeout leaks the plane on purpose: a small
        leak at exit beats a use-after-free."""
        if self._stopped or self.handle is None:
            return
        self._stopped = True
        loop = asyncio.get_running_loop()
        handle = self.handle
        await loop.run_in_executor(None, self.lib.dp_shutdown, handle)

        def join_all() -> bool:
            deadline = time.monotonic() + max(35.0, self.engine.dispatch_timeout_s + 5.0)
            for t in self._threads:
                t.join(timeout=max(1.0, deadline - time.monotonic()))
                if t.is_alive():
                    return False
            return True

        joined = await loop.run_in_executor(None, join_all)
        self.handle = None
        self.engine.http_impl = "python"
        if joined:
            self.lib.dp_destroy(handle)
        else:
            logger.warning("native plane worker wedged; leaking the plane at shutdown")


async def serve_native(engine, host: str, port: int,
                       grpc_port: Optional[int] = None) -> NativeDataPlane:
    """Start the native plane for ``engine`` on ``host:port`` (and its gRPC
    lane on ``grpc_port``; 0 picks a free port).  Raises RuntimeError when
    the plane is unavailable or the graph is ineligible."""
    plane = NativeDataPlane(engine, host, port, grpc_port=grpc_port)
    plane.start(asyncio.get_running_loop())
    return plane
