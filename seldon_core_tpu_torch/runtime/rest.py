"""REST lane — stdlib asyncio HTTP/1.1, the port's counterpart of
``seldon_core_tpu/runtime/httpfast.py`` (no aiohttp dependency).

Routes:

  POST /api/v0.1/predictions       JSON body or form field ``json=``; with
                                   ``Content-Type: application/x-seldon-tensor``
                                   a binary tensor frame (``runtime/wire.py``,
                                   ``engine.predict_wire``) answered by a frame
  POST /predict                    internal-API alias (engine as a MODEL leaf)
  POST /api/v0.1/feedback          a Feedback JSON (reward, request, response
                                   with its meta.routing, truth): the graph's
                                   feedback pass; a malformed one is a 400
  POST /api/v0.1/generate/stream   SSE token streaming (``httpfast.py:219-232``)
  ANY  /api/v0.1/events            the reference's stub: 200 "Not Implemented"
  GET  /ping /ready /pause /unpause /stats
  GET  /prometheus                 the Prometheus text format, or OpenMetrics
                                   (exemplars) on ``Accept:
                                   application/openmetrics-text`` or
                                   ``?format=openmetrics``
  GET  /perf /genperf /overhead    the perf observatory, the generation-lane
                                   recorder, the telemetry overhead budget
  GET  /quality                    the quality observatory (drift, feedback,
                                   outliers, SLO burn) and the router state
  POST /quality/reference          ``?action=freeze|reset`` / ``?node=`` or a
                                   JSON body: the drift reference window (a
                                   bad action answers 400)
  GET  /postmortems                the tail-sampled postmortems; ``?puid=``
                                   one full exemplar
  GET  /costs                      the resource ledger
  GET  /autopilot                  the learned cost model's per-key table
  GET  /corpus                     the durable perf corpus's sketches
  GET  /trace /trace/export        ``?puid=`` / ``?trace_id=`` / ``?limit=``:
                                   the trace document, Chrome trace JSON
  POST /trace/enable /trace/disable   (a GET answers 405)
  GET  /profile, POST /profile/start /profile/stop   the torch.profiler
                                   window (a second start answers 409, a
                                   window that cannot start 503)

The unit microservice's routes (``FastHttpServer(routes=_UnitRoutes(...))``,
``serve_unit``; ``make_unit_app`` of the JAX package's ``runtime/rest.py``):

  POST /predict /transform-input /transform-output /route /aggregate
       /send-feedback          a SeldonMessage (an /aggregate a
                               SeldonMessageList, a /send-feedback a
                               Feedback), JSON body or form ``json=``;
                               the answer a SeldonMessage (/route's a 1x1
                               tensor holding the branch)
  GET  /ping /stats /perf /overhead /quality /autopilot /trace
       /trace/export
  POST /quality/reference

A request's ``Seldon-Deadline-Ms`` header becomes its deadline scope
(``runtime/resilience.py``) for every route; a unit route whose budget is
spent on arrival answers 504.  The binary tensor wire: on the predictions
route and on the unit routes that carry one SeldonMessage (``/predict``,
``/transform-input``, ``/transform-output``, ``/route``) a frame in
answers a frame (a unit's non-numeric answer goes back as JSON, which the
caller's negotiation takes); a frame that does not parse answers a typed
JSON 400 or 413; ``/aggregate`` and ``/send-feedback`` take no frame and,
like every route with ``SELDON_TPU_WIRE=0``, answer a frame with 415.  A
frame answer goes out as its parts (header, then the payload view).
``FastHttpServer.start_uds`` serves the same routes on a unix socket.

Protocol scope: HTTP/1.1 with keepalive and Content-Length request
bodies.  Pipelined requests are answered in order (each request's handler
runs concurrently; a per-connection writer sends responses FIFO).  A
request with ``Transfer-Encoding: chunked`` is declined with 501.  The
stream route answers every problem with a plain 400 before any byte;
otherwise its response is chunked, one ``data: {...}`` SSE frame per
token chunk, then the terminal ``{"done": true, "meta": {"puid": ...}}``
frame.  A failure mid-stream sends a terminal error frame and closes the
connection; a client that goes away closes the engine's generator.

Every request's ``traceparent`` header is its trace context, as its
``Seldon-Deadline-Ms`` header is its deadline scope and its
``Seldon-Tenant`` / ``Seldon-Tier`` headers its QoS identity
(``runtime/qos.py``, bound in the handler task's own context, so the
binding ends with the request): the engine's ``request`` span and a unit's
``server`` span become the caller's children, and the cost ledger bills the
tenant.  A unit route's latency lands in the recorder's ``unit:<method>``
reservoir and histogram.  A load shed (the autopilot's admission, the
brownout ladder, a full generation queue) answers 503 with its prefix on
every lane: a FAILURE message on the JSON and gRPC lanes, an error frame on
the binary wire.  Not ported: the writer's transport flow control.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import os
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from seldon_core_tpu_torch.graph.spec import GraphSpecError
from seldon_core_tpu_torch.messages import (
    Feedback,
    SeldonMessage,
    SeldonMessageError,
    SeldonMessageList,
)
from seldon_core_tpu_torch.runtime import wire
from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT
from seldon_core_tpu_torch.runtime.qos import bind_qos
from seldon_core_tpu_torch.runtime.resilience import (
    DEADLINE_VAR,
    Deadline,
    current_deadline,
    deadline_ms_header,
)
from seldon_core_tpu_torch.utils.hotrecord import SPINE
from seldon_core_tpu_torch.utils.metrics import (
    CONTENT_TYPE_LATEST,
    OPENMETRICS_CONTENT_TYPE,
)
from seldon_core_tpu_torch.utils.perf import OBSERVATORY
from seldon_core_tpu_torch.utils.quality import QUALITY, parse_reference_action
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import (
    TRACE_VAR,
    TRACER,
    ProfileBusyError,
    ProfileUnavailableError,
    current_trace_puid,
    export_document,
    parse_traceparent,
    profile_window_start_request,
    profile_window_status,
    profile_window_stop,
    trace_document,
)

__all__ = ["FastHttpServer", "StreamResult", "serve_fast", "serve_unit", "request_context",
           "route_handler"]

_JSON = "application/json"
_MAX_BODY = 256 * 1024 * 1024
_MAX_HEAD = 64 * 1024
_MAX_INFLIGHT = 128  # per-connection pipelined requests before pause_reading

Result = Tuple[int, Any, str]  # (status, body: bytes or a list of parts, content-type)
_WIRE = wire.WIRE_CONTENT_TYPE
# unit routes whose body is one SeldonMessage: a frame may carry it
_WIRE_UNIT_METHODS = ("predict", "transform_input", "transform_output", "route")
Handler = Callable[[bytes, str], Awaitable[Result]]

#: the request's query string, lower-cased head and head as received, bound
#: in the handler task's context (``_request_query``, ``_request_header``)
_REQUEST: "contextvars.ContextVar[Tuple[str, bytes, bytes]]" = contextvars.ContextVar(
    "seldon_torch_http_request", default=("", b"", b""))

_STATUS_LINE = {
    code: f"HTTP/1.1 {code} {text}\r\n".encode()
    for code, text in {
        200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
        405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
        415: "Unsupported Media Type", 429: "Too Many Requests",
        500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
        503: "Service Unavailable", 504: "Gateway Timeout",
    }.items()
}


class StreamResult:
    """Handler result of a streaming route: the writer sends a chunked
    response, one SSE ``data:`` frame per item of the async generator (a
    str), or with ``raw`` each item's bytes as they are (a relayed SSE
    stream, already framed)."""

    __slots__ = ("status", "ctype", "agen", "raw")

    def __init__(self, status: int, ctype: str, agen, raw: bool = False):
        self.status = status
        self.ctype = ctype
        self.agen = agen
        self.raw = raw


def _payload_text(body: bytes, ctype: str) -> str:
    """JSON body or form-encoded ``json=`` field (httpfast.py:109)."""
    if "form" in ctype:
        form = parse_qs(body.decode("utf-8", "replace"), keep_blank_values=True)
        if "json" in form:
            return form["json"][0]
    return body.decode("utf-8", "replace")


def _failure(e: Exception, code: int) -> bytes:
    return SeldonMessage.failure(str(e), code=code).to_json().encode()


def _request_query() -> Dict[str, list]:
    """The current request's query string, parsed."""
    return parse_qs(_REQUEST.get()[0])


def _request_header(name: bytes, exact: bool = False) -> Optional[str]:
    """A header of the current request (``name`` lower-case with its
    colon), or None; lower-cased unless ``exact`` (a credential's case
    matters)."""
    _query, lower, head = _REQUEST.get()
    v = _header_value(lower, name, head if exact else None)
    return None if v is None else v.decode("latin-1")


def _json_doc(doc) -> Result:
    return 200, json.dumps(doc).encode(), _JSON


async def _quality_reference(body, ctype) -> Result:
    """``POST /quality/reference``: freeze or reset the drift reference
    window (one handler for the engine and unit routes)."""
    q = _request_query()
    try:
        action, node = parse_reference_action(body, q.get("action", [None])[0],
                                              q.get("node", [None])[0])
    except ValueError as e:
        return 400, _failure(SeldonMessageError(str(e)), 400), _JSON
    return _json_doc(QUALITY.reference_control(action, node=node))


def _trace_doc(default_limit: int, process_name: Optional[str] = None) -> Result:
    """``/trace`` (``process_name`` None) or ``/trace/export``."""
    q = _request_query()
    try:
        limit = int(q.get("limit", [str(default_limit)])[0])
    except ValueError:
        return 400, _failure(SeldonMessageError("limit must be an integer"), 400), _JSON
    args = dict(puid=q.get("puid", [""])[0], trace_id=q.get("trace_id", [""])[0], limit=limit)
    if process_name is None:
        return _json_doc(trace_document(TRACER, **args))
    return _json_doc(export_document(TRACER, process_name=process_name, **args))


class _EngineRoutes:
    """The engine route table shared by every connection."""

    def __init__(self, engine):
        self.engine = engine
        self.post: Dict[bytes, Handler] = {
            b"/api/v0.1/predictions": self._predictions,
            b"/predict": self._predictions,
            b"/api/v0.1/feedback": self._feedback,
            b"/api/v0.1/generate/stream": self._generate_stream,
            b"/trace/enable": self._trace_enable,
            b"/trace/disable": self._trace_disable,
            b"/profile/start": self._profile_start,
            b"/profile/stop": self._profile_stop,
            b"/quality/reference": _quality_reference,
        }
        # mutations: a GET answers 405, not 404
        self.post_only = frozenset((b"/trace/enable", b"/trace/disable", b"/profile/start",
                                    b"/profile/stop", b"/quality/reference"))
        # any method (engine RestClientController.java:177-180)
        self.any: Dict[bytes, Handler] = {b"/api/v0.1/events": self._events}
        self.get: Dict[bytes, Handler] = {
            b"/ping": self._ping,
            b"/ready": self._ready,
            b"/pause": self._pause,
            b"/unpause": self._unpause,
            b"/stats": self._stats,
            b"/prometheus": self._prometheus,
            b"/perf": self._perf,
            b"/genperf": self._genperf,
            b"/overhead": self._overhead,
            b"/quality": self._quality,
            b"/postmortems": self._postmortems,
            b"/costs": self._costs,
            b"/autopilot": self._autopilot,
            b"/corpus": self._corpus,
            b"/trace": self._trace,
            b"/trace/export": self._trace_export,
            b"/profile": self._profile,
        }

    async def _predictions(self, body, ctype) -> Result:
        RECORDER.record_lane_request("rest")
        if ctype.startswith(_WIRE):
            return await self._predictions_wire(body)
        text, status = await self.engine.predict_json(_payload_text(body, ctype))
        return status or 200, text.encode(), _JSON

    async def _predictions_wire(self, body) -> Result:
        """A binary frame in, a frame out (``httpfast.py:181-214`` there).
        The receive buffer's copy is the lane's one copy, accounted; bytes
        that are not a frame answer a typed JSON 400 or 413, which any peer
        can read."""
        if not wire.wire_enabled():
            return 415, _failure(SeldonMessageError(
                "binary wire lane disabled (SELDON_TPU_WIRE=0)"), 415), _JSON
        RECORDER.record_wire_request("fast", "binary")
        wire.account_copy(len(body))
        try:
            status, parts = await self.engine.predict_wire(body)
        except wire.WireError as e:
            return e.http_code, _failure(e, e.http_code), _JSON
        return status, parts, _WIRE

    async def _feedback(self, body, ctype) -> Result:
        try:
            fb = Feedback.from_json(_payload_text(body, ctype))
        except SeldonMessageError as e:
            return 400, _failure(e, 400), _JSON
        ack = await self.engine.send_feedback(fb)
        ok = ack.status is None or ack.status.status == "SUCCESS"
        return 200 if ok else (ack.status.code or 400), ack.to_json().encode(), _JSON

    async def _events(self, body, ctype) -> Result:
        # the reference's stub, exactly: 200 on any method
        return 200, b"Not Implemented", "text/plain"

    async def _generate_stream(self, body, ctype):
        """SSE token streaming: a SeldonMessage with the prompt rows and an
        optional top-level ``chunk`` (tokens per frame)."""
        try:  # every problem is a plain 400 before any byte is sent
            request = self.engine.prepare_stream_request(_payload_text(body, ctype))
        except SeldonMessageError as e:
            return 400, _failure(e, 400), _JSON
        return StreamResult(200, "text/event-stream",
                            self.engine.generate_stream(request))

    async def _ping(self, body, ctype) -> Result:
        return 200, b"pong", "text/plain"

    async def _ready(self, body, ctype) -> Result:
        if not self.engine.ready():
            return 503, b"paused", "text/plain"
        open_breakers = self.engine.open_breakers()
        if open_breakers:
            # still ready (the graph serves, degraded), but the condition
            # shows where orchestration probes look first
            return 200, b"ready (breakers open: %s)" % ",".join(open_breakers).encode(), \
                "text/plain"
        return 200, b"ready", "text/plain"

    async def _pause(self, body, ctype) -> Result:
        self.engine.pause()
        return 200, b"paused", "text/plain"

    async def _unpause(self, body, ctype) -> Result:
        self.engine.unpause()
        return 200, b"unpaused", "text/plain"

    async def _stats(self, body, ctype) -> Result:
        return 200, json.dumps(self.engine.stats()).encode(), _JSON

    # -- observability (httpfast.py:268-470 there) ------------------------

    async def _prometheus(self, body, ctype) -> Result:
        openmetrics = ("application/openmetrics-text" in (_request_header(b"accept:") or "")
                       or _request_query().get("format", [""])[0] == "openmetrics")
        if openmetrics:
            return 200, self.engine.metrics.exposition(openmetrics=True), \
                OPENMETRICS_CONTENT_TYPE
        return 200, self.engine.metrics.exposition(), CONTENT_TYPE_LATEST

    async def _perf(self, body, ctype) -> Result:
        return _json_doc(self.engine.perf_document())

    async def _genperf(self, body, ctype) -> Result:
        return _json_doc(self.engine.genperf_document())

    async def _overhead(self, body, ctype) -> Result:
        return _json_doc(self.engine.overhead_document())

    async def _quality(self, body, ctype) -> Result:
        return _json_doc(self.engine.quality_document())

    async def _postmortems(self, body, ctype) -> Result:
        return _json_doc(self.engine.postmortems_document(
            puid=_request_query().get("puid", [""])[0]))

    async def _costs(self, body, ctype) -> Result:
        return _json_doc(self.engine.costs_document())

    async def _autopilot(self, body, ctype) -> Result:
        return _json_doc(self.engine.autopilot_document())

    async def _corpus(self, body, ctype) -> Result:
        return _json_doc(self.engine.corpus_document())

    async def _trace(self, body, ctype) -> Result:
        return _trace_doc(100)

    async def _trace_export(self, body, ctype) -> Result:
        return _trace_doc(1000, self.engine.process_track_name())

    async def _trace_enable(self, body, ctype) -> Result:
        TRACER.enable()
        return 200, b"tracing enabled", "text/plain"

    async def _trace_disable(self, body, ctype) -> Result:
        TRACER.disable()
        return 200, b"tracing disabled", "text/plain"

    async def _profile(self, body, ctype) -> Result:
        return _json_doc(profile_window_status())

    async def _profile_start(self, body, ctype) -> Result:
        """A bounded ``torch.profiler`` window in this process: 409 on
        overlap, never queued; 503 when the profiler cannot start."""
        try:
            payload = json.loads(body.decode("utf-8", "replace") or "{}")
        except ValueError:
            payload = {}
        if not isinstance(payload, dict):
            payload = {}
        try:
            doc = profile_window_start_request(payload)
        except ProfileBusyError as e:
            return 409, json.dumps({"error": str(e)}).encode(), _JSON
        except ProfileUnavailableError as e:
            return 503, json.dumps({"error": str(e)}).encode(), _JSON
        return _json_doc(doc)

    async def _profile_stop(self, body, ctype) -> Result:
        # the artifact is written here: off the loop
        return _json_doc(await asyncio.get_running_loop().run_in_executor(
            None, profile_window_stop))


class _UnitRoutes:
    """The unit microservice's route table (``make_unit_app`` there): one
    ``InProcessNodeRuntime`` behind the internal API.  A runtime with a
    thread pool runs there, and the answer's JSON (with the device
    readback) is encoded there too."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.post: Dict[bytes, Handler] = {
            b"/predict": self._handler("predict"),
            b"/transform-input": self._handler("transform_input"),
            b"/transform-output": self._handler("transform_output"),
            b"/route": self._handler("route"),
            b"/aggregate": self._handler("aggregate"),
            b"/send-feedback": self._handler("send_feedback"),
            b"/quality/reference": _quality_reference,
        }
        self.post_only = frozenset((b"/quality/reference",))
        self.any: Dict[bytes, Handler] = {}
        self.get: Dict[bytes, Handler] = {
            b"/ping": self._ping, b"/stats": self._stats, b"/perf": self._perf,
            b"/overhead": self._overhead, b"/quality": self._quality, b"/trace": self._trace,
            b"/trace/export": self._trace_export, b"/autopilot": self._autopilot,
        }

    def _handler(self, method: str) -> Handler:
        async def handle(body, ctype) -> Result:
            t0 = time.perf_counter()
            try:
                return await handle_timed(body, ctype)
            finally:
                RECORDER.request_latency(f"unit:{method}", time.perf_counter() - t0)

        async def handle_timed(body, ctype) -> Result:
            framed = ctype.startswith(_WIRE)
            if framed and not wire.wire_enabled():
                return 415, _failure(SeldonMessageError(
                    "binary wire lane disabled (SELDON_TPU_WIRE=0)"), 415), _JSON
            if framed and method not in _WIRE_UNIT_METHODS:
                return 415, _failure(SeldonMessageError(
                    f"{method} takes no binary tensor frame; send JSON"), 415), _JSON
            dl = current_deadline()
            if dl is not None and dl.expired:
                return 504, _failure(SeldonMessageError(
                    "request deadline exhausted on arrival"), 504), _JSON
            try:
                if framed:
                    wire.account_copy(len(body))
                    resp = await self._dispatch(method, wire.message_from_frame(
                        wire.decode_frame(body)))
                else:
                    resp = await self._dispatch(method, _payload_text(body, ctype))
            except (SeldonMessageError, GraphSpecError) as e:
                return e.http_code, _failure(e, e.http_code), _JSON
            except NotImplementedError as e:
                return 501, _failure(e, 501), _JSON
            if framed and (resp.data is None or wire.frame_eligible(resp)):
                # in the request's context: the frame's copies bill its tenant
                parts = await asyncio.get_running_loop().run_in_executor(
                    getattr(self.runtime, "executor", None), contextvars.copy_context().run,
                    lambda: wire.frame_from_message(resp, response=True, sidecar=False))
                return 200, parts, _WIRE
            pool = getattr(self.runtime, "executor", None)
            if pool is None:
                return 200, resp.to_json().encode(), _JSON
            text = await asyncio.get_running_loop().run_in_executor(pool, resp.to_json)
            return 200, text.encode(), _JSON

        return handle

    async def _dispatch(self, method: str, payload) -> SeldonMessage:
        """One call of the runtime in its ``server`` span (the caller's
        child when a traceparent came in); ``payload`` is the body's JSON
        text, or a SeldonMessage a frame carried."""
        rt = self.runtime
        name = rt.node.name
        if method == "aggregate":
            msgs = SeldonMessageList.from_json(payload).messages
            puid = current_trace_puid() or (msgs[0].meta.puid if msgs else "")
            with TRACER.span(puid, name, kind="server", method=method):
                return await rt.aggregate(msgs)
        if method == "send_feedback":
            fb = Feedback.from_json(payload)
            routing = fb.response.meta.routing if fb.response is not None else {}
            with TRACER.span(fb.puid() or current_trace_puid(), name, kind="server",
                             method=method):
                await rt.send_feedback(fb, int(routing.get(name, -1)))
            return SeldonMessage()
        msg = payload if isinstance(payload, SeldonMessage) else SeldonMessage.from_json(payload)
        if method == "route":
            with TRACER.span(msg.meta.puid, name, kind="server", method=method) as sp:
                branch = await rt.route(msg)
                if isinstance(sp, dict):
                    sp["branch"] = branch
            # the branch as a 1x1 tensor, as the reference's router wrapper
            # answers (wrappers/python/router_microservice.py:39-56)
            return msg.with_array(np.array([[branch]], dtype=np.float64))
        with TRACER.span(msg.meta.puid, name, kind="server", method=method):
            return await getattr(rt, method)(msg)

    async def _ping(self, body, ctype) -> Result:
        return 200, b"pong", "text/plain"

    def _unit(self) -> dict:
        node = self.runtime.node
        return {"name": node.name, "type": getattr(node.type, "name", None)}

    async def _stats(self, body, ctype) -> Result:
        from seldon_core_tpu_torch.ops import fused_mlp

        return _json_doc({
            "unit": {**self._unit(), "class": type(self.runtime.unit).__name__},
            "device": self.runtime.device.type,
            "kernels": {"fused_mlp_softmax": {"launches": fused_mlp.LAUNCHES}},
            # the process-level flight recorder (rest.py:599-605 there)
            "telemetry": RECORDER.snapshot(),
        })

    async def _perf(self, body, ctype) -> Result:
        return _json_doc({"unit": self._unit(), **OBSERVATORY.document()})

    async def _overhead(self, body, ctype) -> Result:
        return _json_doc({"unit": self._unit(), **SPINE.overhead_document()})

    async def _autopilot(self, body, ctype) -> Result:
        # what this unit process dispatched trains the process-global model
        SPINE.drain()
        return _json_doc({"unit": self._unit(), **AUTOPILOT.document()})

    async def _quality(self, body, ctype) -> Result:
        # the node's own drift window: InProcessNodeRuntime.predict records
        # it in the process-global observatory
        return _json_doc({"unit": self._unit(), **QUALITY.document()})

    async def _trace(self, body, ctype) -> Result:
        return _trace_doc(100)

    async def _trace_export(self, body, ctype) -> Result:
        return _trace_doc(1000, f"unit {self.runtime.node.name}")


def _header_value(lower: bytes, name: bytes, head: Optional[bytes] = None) -> Optional[bytes]:
    """Value of header ``name`` (lower-case, colon included) anchored at a
    line start, so it never matches inside another header's name; cut from
    ``head`` (the head as received) when given, else lower-cased."""
    j = lower.find(b"\r\n" + name)
    if j < 0:
        return None
    start = j + 2 + len(name)
    stop = lower.find(b"\r", start)
    return (lower if head is None else head)[start: stop if stop > 0 else None].strip()


def route_handler(routes, method: bytes, path: bytes) -> "Tuple[Optional[Handler], int]":
    """``(handler, 200)`` for a request, or ``(None, 405)`` for a method the
    lane does not serve or a GET of a mutation route (``/trace/enable``:
    the reference's aiohttp lane answers 405), or ``(None, 404)``."""
    table = {b"POST": routes.post, b"GET": routes.get}.get(method, {})
    handler = getattr(routes, "any", {}).get(path) or table.get(path)
    if handler is not None:
        return handler, 200
    if not table or path in getattr(routes, "post_only", ()):
        return None, 405
    return None, 404


def request_context(query: bytes, lower: bytes, head: bytes) -> contextvars.Context:
    """The context a request's handler task runs in: the request's query
    and lower-cased head, its ``Seldon-Deadline-Ms`` deadline scope, its
    ``traceparent`` trace context and its ``Seldon-Tenant`` /
    ``Seldon-Tier`` QoS identity; every task it starts inherits them."""
    ctx = contextvars.copy_context()
    ctx.run(_REQUEST.set, (query.decode("latin-1"), lower, head))
    budget = deadline_ms_header(_header_value(lower, b"seldon-deadline-ms:"))
    if budget is not None:
        ctx.run(DEADLINE_VAR.set, Deadline.after(budget))
    tp = _header_value(lower, b"traceparent:")
    parent = parse_traceparent(tp.decode("latin-1")) if tp is not None else None
    if parent is not None:
        ctx.run(TRACE_VAR.set, parent)
    # the tenant id as sent (ids are case-sensitive); the tier is
    # case-folded by parse_tier
    tenant = _header_value(lower, b"seldon-tenant:", head)
    tier = _header_value(lower, b"seldon-tier:")
    if tenant is not None or tier is not None:
        ctx.run(bind_qos, None if tenant is None else tenant.decode("latin-1"),
                None if tier is None else tier.decode("latin-1"))
    return ctx


class _HttpProtocol(asyncio.Protocol):
    def __init__(self, routes: _EngineRoutes, protocols: set):
        self.routes = routes
        self.protocols = protocols
        self.buf = bytearray()
        self.transport: Optional[asyncio.Transport] = None
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.writer_task: Optional[asyncio.Task] = None
        self.closing = False
        self.paused_read = False

    def connection_made(self, transport):
        self.transport = transport
        self.protocols.add(self)
        self.writer_task = asyncio.get_running_loop().create_task(self._writer())

    def connection_lost(self, exc):
        self.closing = True
        self.protocols.discard(self)
        if self.writer_task is not None:
            self.writer_task.cancel()

    async def _writer(self):
        """Send handler results in request order (pipelining-safe)."""
        while True:
            task, close = await self.queue.get()
            try:
                result = await task
            except asyncio.CancelledError:
                raise
            except (SeldonMessageError, GraphSpecError) as e:
                result = e.http_code, _failure(e, e.http_code), _JSON
            except Exception as e:  # unexpected: 500, keep serving
                result = 500, _failure(e, 500), _JSON
            if isinstance(result, StreamResult):
                await self._write_stream(result)
                if close and self.transport is not None:
                    self.transport.close()
                continue
            status, body, ctype = result
            if self.transport is None or self.transport.is_closing():
                continue
            parts = body if isinstance(body, list) else [body]
            head = (_STATUS_LINE.get(status) or f"HTTP/1.1 {status} X\r\n".encode()) + (
                b"Content-Length: %d\r\nContent-Type: %s\r\n%s\r\n"
                % (sum(len(p) for p in parts), ctype.encode(),
                   b"Connection: close\r\n" if close else b"")
            )
            # a frame's parts go out one by one, its payload straight from
            # the readback buffer
            self.transport.write(head)
            for p in parts:
                if p:
                    self.transport.write(p)
            if self.paused_read and self.queue.qsize() <= _MAX_INFLIGHT // 2:
                self.paused_read = False
                self.transport.resume_reading()
            if close:
                self.transport.close()

    async def _write_stream(self, result: StreamResult):
        """Chunked transfer encoding, one SSE ``data:`` frame per event.  A
        failure mid-stream cannot change the status already sent: the
        stream ends with an error frame and the connection closes."""
        try:
            if self.transport is None or self.transport.is_closing():
                return
            self.transport.write(
                b"HTTP/1.1 %d OK\r\nContent-Type: %s\r\nCache-Control: no-cache\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n" % (result.status, result.ctype.encode()))
            try:
                async for event in result.agen:
                    if self.transport is None or self.transport.is_closing():
                        return  # the client went away; finally closes the generator
                    frame = event if result.raw else b"data: " + event.encode() + b"\n\n"
                    if not frame:
                        continue
                    self.transport.write(b"%x\r\n" % len(frame) + frame + b"\r\n")
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reported in-band
                if self.transport is not None and not self.transport.is_closing():
                    err = b"data: %s\n\n" % json.dumps({"done": True, "error": str(e)}).encode()
                    self.transport.write(b"%x\r\n" % len(err) + err + b"\r\n0\r\n\r\n")
                    self.transport.close()  # the stream's integrity is unknown
                return
            if self.transport is not None and not self.transport.is_closing():
                self.transport.write(b"0\r\n\r\n")
        finally:
            # a client gone mid-stream must not leave the generator (and its
            # KV caches) suspended until garbage collection
            await result.agen.aclose()

    def data_received(self, data):
        self.buf += data
        consumed = 0
        while not self.closing:
            end = self.buf.find(b"\r\n\r\n", consumed)
            if end < 0:
                if len(self.buf) - consumed > _MAX_HEAD:
                    self._reject(413, b"headers too large", close=True)
                break
            head = bytes(self.buf[consumed:end])
            lower = head.lower()
            # Transfer-Encoding wins over Content-Length (RFC 7230); framing
            # such a request by Content-Length would allow smuggling
            if _header_value(lower, b"transfer-encoding:") is not None:
                self._reject(501, b"chunked bodies not supported", close=True)
                break
            clen = 0
            clv = _header_value(lower, b"content-length:")
            if clv is not None:
                if not clv.isdigit():
                    self._reject(400, b"bad content-length", close=True)
                    break
                clen = int(clv)
            if clen > _MAX_BODY:
                self._reject(413, b"body too large", close=True)
                break
            start = end + 4
            if len(self.buf) < start + clen:
                break  # body incomplete: wait for more bytes
            body = bytes(self.buf[start: start + clen])
            consumed = start + clen
            self._dispatch(head, lower, body)
        if consumed:
            del self.buf[:consumed]
        if (not self.paused_read and self.queue.qsize() > _MAX_INFLIGHT
                and self.transport is not None):
            self.paused_read = True
            self.transport.pause_reading()

    def _reject(self, status: int, text: bytes, close: bool = False):
        self.closing = self.closing or close
        fut = asyncio.get_running_loop().create_future()
        fut.set_result((status, text, "text/plain"))
        self.queue.put_nowait((fut, close))

    def _dispatch(self, head: bytes, lower: bytes, body: bytes):
        line_end = head.find(b"\r\n")
        request_line = head[: line_end if line_end > 0 else len(head)]
        try:
            method, target, _ = request_line.split(b" ", 2)
        except ValueError:
            self._reject(400, b"malformed request line", close=True)
            return
        path, _, query = target.partition(b"?")
        conn = _header_value(lower, b"connection:")
        close = conn is not None and b"close" in (p.strip() for p in conn.split(b","))
        handler, status = route_handler(self.routes, method, path)
        if handler is None:
            self._reject(status, b"method not allowed" if status == 405 else b"not found",
                         close=close)
            return
        ctv = _header_value(lower, b"content-type:")
        coro = handler(body, ctv.decode("latin-1") if ctv is not None else "")
        ctx = request_context(query, lower, head)
        task = asyncio.get_running_loop().create_task(coro, context=ctx)
        self.queue.put_nowait((task, close))


class FastHttpServer:
    """Owns the listening sockets: ``await start(host, port)``, and with
    ``await start_uds(path)`` the same routes on a unix socket (the lane a
    ``unix:`` node binding dials, ``httpfast.py:804`` there); ``await
    stop()`` closes both and removes the socket file.  ``port`` is the
    bound port (0 picks a free one).  Serves an engine's routes, or a
    given route table (``_UnitRoutes``)."""

    def __init__(self, engine=None, routes=None):
        self.routes = routes if routes is not None else _EngineRoutes(engine)
        self._server: Optional[asyncio.AbstractServer] = None
        self._uds_server: Optional[asyncio.AbstractServer] = None
        self.uds_path: Optional[str] = None
        self._protocols: set = set()
        self.port: Optional[int] = None

    async def start(self, host: str, port: int) -> None:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _HttpProtocol(self.routes, self._protocols), host, port, backlog=1024
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def start_uds(self, path: str) -> None:
        """Serve the routes on the unix socket ``path`` (a stale socket
        file from a crashed predecessor is removed first)."""
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        loop = asyncio.get_running_loop()
        self._uds_server = await loop.create_unix_server(
            lambda: _HttpProtocol(self.routes, self._protocols), path=path)
        self.uds_path = path

    async def stop(self) -> None:
        servers = [s for s in (self._server, self._uds_server) if s is not None]
        for s in servers:
            s.close()
        # idle keepalive connections never finish on their own: close their
        # transports first or wait_closed hangs
        for proto in list(self._protocols):
            if proto.transport is not None:
                proto.transport.close()
        for s in servers:
            try:
                await asyncio.wait_for(s.wait_closed(), timeout=5.0)
            except asyncio.TimeoutError:
                pass  # the listener is closed either way
        self._server = self._uds_server = None
        if self.uds_path is not None:
            try:
                os.unlink(self.uds_path)
            except FileNotFoundError:
                pass
            self.uds_path = None


async def serve_fast(engine, host: str, port: int,
                     uds_path: Optional[str] = None) -> FastHttpServer:
    """The engine's routes on ``host:port`` and, with ``uds_path``, on that
    unix socket too."""
    server = FastHttpServer(engine)
    await server.start(host, port)
    if uds_path:
        await server.start_uds(uds_path)
    return server


async def serve_unit(runtime, host: str, port: int) -> FastHttpServer:
    """Serve one node runtime over the unit microservice API."""
    server = FastHttpServer(routes=_UnitRoutes(runtime))
    await server.start(host, port)
    return server
