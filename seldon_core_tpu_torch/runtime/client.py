"""Remote-node client — the engine's outbound dispatch; the port's
counterpart of ``seldon_core_tpu/runtime/client.py:55-660``.

``RestNodeRuntime`` speaks the internal microservice API (``/predict``,
``/route``, ``/aggregate``, ``/transform-input``, ``/transform-output``,
``/send-feedback``; docs/reference/internal-api.md) on stdlib asyncio
alone (the port leans on no ``aiohttp``):

* HTTP/1.1 over keep-alive connections pooled per node, to ``host:port``
  or, for a ``unix:/path`` host, to that unix socket (an engine's
  ``ENGINE_HTTP_UDS_PATH`` listener): a call takes an idle connection (one
  the peer has closed is dropped first, read with a non-blocking peek) or
  dials a new one, and hands it back after a whole ``Content-Length``
  response; the sockets are non-blocking and driven by the running loop's
  ``sock_*`` calls, so a pool outlives the loop that filled it and closes
  without one;
* a predict whose payload is numeric goes as a binary tensor frame
  (``runtime/wire.py``, ``Content-Type: application/x-seldon-tensor``)
  unless ``SELDON_TPU_WIRE=0``: the reference's negotiation, in which a
  JSON answer to a frame, or a 400/404/405/415/501 that is not a frame,
  turns the node's wire off for good and the same attempt goes again as
  JSON; every other call is JSON;
* each request body is encoded on the engine's dispatch executor (the
  loop's default one when none is given), never on the loop: a payload
  that is still a device tensor is read back there;
* each request carries the model-identity headers (``Seldon-model-name``,
  ``-image``, ``-version``, InternalPredictionService.java:73-75) and, with
  a deadline in force, ``Seldon-Deadline-Ms``; each attempt's timeout is
  clamped to the request's remaining budget, so retries share one budget;
* the JAX package's retry and breaker rules: transient statuses (429, 502,
  503, 504) and transport failures retry with jittered backoff, only for
  idempotent methods (``route`` and ``send_feedback`` get one attempt) and
  only while the deadline and the predictor's shared ``RetryBudget``
  allow; a transport failure or a 5xx counts against the node's
  ``CircuitBreaker``, a 4xx does not; an open breaker refuses at once.

``GrpcNodeRuntime`` calls a gRPC microservice's node services
(Model/Predict, Transformer/TransformInput, OutputTransformer/
TransformOutput, Router/Route, Combiner/Aggregate, and SendFeedback on
Router, or Generic for an untyped node) over one pooled connection of the
port's own HTTP/2 client (``runtime/grpcfast.py`` ``FastGrpcChannel``, so
no ``grpcio``), with the same policy: a call's status
name (UNAVAILABLE, RESOURCE_EXHAUSTED) decides a retry, a refused or lost
connection is UNAVAILABLE (and the next attempt dials again), a timed-out
attempt DEADLINE_EXCEEDED; every failed call counts against the breaker.
A FAILURE SeldonMessage is an answer, returned as it is and never retried.

Each call runs in a ``client`` span of the node's name (``transport``
``rest``, ``wire`` or ``grpc``) and sends the W3C ``traceparent`` of that
span (a header, gRPC metadata, and the frame's sidecar), so the remote
server span is its child, and the bound tenant and tier (``Seldon-Tenant``
/ ``Seldon-Tier``, ``runtime/qos.py``) the same three ways; a retry and an
open breaker's refusal are span events, and each retry or exhausted retry
counts in ``seldon_tpu_retry_attempts_total``.

A failure after the policy gives up is a ``RemoteCallError`` (502); the
client never swaps a remote node for a local unit.

``HttpClient`` is the gateway's one upstream client (the JAX gateway's
pooled aiohttp session, ``gateway/apife.py:1251`` there), used by the
gateway's dispatch lanes, the replica scrape and the fleet plane: asyncio
streams, HTTP/1.1 keep-alive connections pooled per authority, at most
``SELDON_TPU_GW_POOL`` (default 100) in use at once and idle ones dropped
after ``SELDON_TPU_GW_KEEPALIVE_S`` (default 15 s).  ``request`` sends a
POST or GET of any body under a whole-call timeout and reads a
``Content-Length``, chunked or to-the-end response; ``stream`` sends a POST
whose response is read chunk by chunk as it arrives (an SSE relay) under a
connect timeout only.  A connection that could not be opened raises
``UpstreamConnectError`` (nothing reached the peer, so a caller may retry);
a pooled connection the peer closed before answering is retried once on a
fresh one; every other transport failure is an ``OSError``, and a timeout
``TimeoutError``.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import os
import socket
import threading
import time
from concurrent.futures import Executor
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from seldon_core_tpu_torch import protoconv
from seldon_core_tpu_torch.graph.interpreter import NodeRuntime
from seldon_core_tpu_torch.graph.spec import ComponentBinding, PredictiveUnit
from seldon_core_tpu_torch.messages import (
    Feedback,
    SeldonMessage,
    SeldonMessageError,
    SeldonMessageList,
)
from seldon_core_tpu_torch.runtime import wire
from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel, GrpcCallError
from seldon_core_tpu_torch.runtime.qos import (
    TENANT_HEADER,
    TIER_HEADER,
    current_tenant,
    current_tier,
)
from seldon_core_tpu_torch.runtime.resilience import (
    DEADLINE_HEADER,
    CircuitBreaker,
    RetryBudget,
    RetryPolicy,
    _BreakerGuard,
    clamp_timeout,
    deadline_header_value,
    is_idempotent,
    remaining_s,
)
from seldon_core_tpu_torch.runtime.resilience import BreakerOpenError
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import (
    TRACEPARENT_HEADER,
    TRACER,
    current_trace_puid,
    traceparent_header_value,
)

__all__ = ["RestNodeRuntime", "GrpcNodeRuntime", "RemoteCallError", "make_node_runtime",
           "HttpClient", "HttpResponse", "UpstreamConnectError"]

DEFAULT_TIMEOUT_S = 5.0  # the reference's TIMEOUT, InternalPredictionService.java:77
MAX_IDLE = 8  # idle keep-alive connections kept per node
_MAX_HEAD = 64 * 1024
_JSON = "application/json"
# a peer that answers a frame with one of these, not as a frame, does not
# speak the wire (a unit app, an older build, a kill-switched engine)
_WIRE_NEGOTIATE_DOWN = (400, 404, 405, 415, 501)


class RemoteCallError(SeldonMessageError):
    """A remote node call failed after the retry policy gave up: 502 at the
    serving edge (an upstream failure, not the client's fault)."""

    http_code = 502

    def __init__(self, node: str, path: str, detail: str):
        super().__init__(f"remote node {node!r} {path}: {detail}")
        self.node = node


class _BadResponse(ConnectionError):
    """A peer's bytes that are not an HTTP/1.1 response this client reads:
    a transport failure, as a reset connection is."""


def _branch_from_msg(node_name: str, resp: SeldonMessage, where: str) -> int:
    """The branch index in a router's answer tensor, reference-style
    (engine PredictiveUnitBean.java:227-237)."""
    try:
        return int(np.asarray(resp.array()).ravel()[0])
    except (SeldonMessageError, IndexError, ValueError) as e:
        raise RemoteCallError(node_name, where, f"bad branch: {e}") from e


def _qos_headers() -> Dict[str, str]:
    """The bound tenant and tier as request headers (gRPC metadata
    lower-cased), forwarded to a remote node as the gateway forwards them;
    the default tier, with no tenant, sends nothing."""
    out: Dict[str, str] = {}
    tenant = current_tenant()
    if tenant is not None:
        out[TENANT_HEADER] = tenant
    tier = current_tier()
    if tenant is not None or tier != "interactive":
        out[TIER_HEADER] = tier
    return out


def _client_span(node: str, puid: str, method: str, transport: str):
    """A remote call's ``client`` span, with the request's remaining
    deadline when one is in force."""
    rem = remaining_s()
    return TRACER.span(puid or current_trace_puid(), node, kind="client", method=method,
                       transport=transport,
                       **({} if rem is None else {"deadline_remaining_ms": round(rem * 1e3, 1)}))


def _gate_traced(guard, node: str) -> None:
    """Per-attempt breaker admission, a refusal recorded as a span event
    (an open breaker's short circuit makes no network call to see)."""
    try:
        guard.gate(node)
    except BreakerOpenError:
        TRACER.event("breaker_open", node=node)
        raise


class _ResilientCallMixin:
    """The retry / breaker / deadline rules (the transport's own loop calls
    them); subclasses set ``node``, ``retry_policy``, ``breaker`` and
    ``retry_budget``."""

    node: PredictiveUnit
    retry_policy: RetryPolicy
    breaker: Optional[CircuitBreaker]
    retry_budget: Optional[RetryBudget]

    def _retry_allowed(self, attempt: int, method: str) -> bool:
        """The attempt-count and idempotency gate of the next attempt."""
        if attempt + 1 >= self.retry_policy.max_attempts:
            RECORDER.record_retry(method, "exhausted")
            return False
        return is_idempotent(method)

    async def _retry_after_backoff(self, attempt: int, method: str) -> bool:
        """The last retry gate, feasibility first: would the jittered
        backoff outlive the remaining deadline?  Does the shared budget
        grant a token?  Then sleep.  A deadline-doomed call never drains
        the budget other callers still need."""
        delay = self.retry_policy.backoff_s(attempt)
        rem = remaining_s()
        if rem is not None and delay >= rem:
            RECORDER.record_retry(method, "exhausted")
            return False
        if self.retry_budget is not None and not self.retry_budget.withdraw():
            RECORDER.record_retry(method, "exhausted")
            return False
        RECORDER.record_retry(method, "retry")
        # the retry and its backoff are an event on the client span: the
        # phase decomposition takes retry time out of "network" with it
        TRACER.event("retry", method=method, attempt=attempt + 1,
                     backoff_ms=round(delay * 1e3, 3),
                     deadline_remaining_ms=None if rem is None else round(rem * 1e3, 1))
        if delay > 0:
            await asyncio.sleep(delay)
        return True


def _alive(sock: socket.socket) -> bool:
    """An idle pooled connection the peer has not closed: a non-blocking
    peek finds nothing to read (EOF or stray bytes mean drop it)."""
    try:
        sock.recv(1, socket.MSG_PEEK)
    except BlockingIOError:
        return True
    except OSError:
        pass
    return False


class RestNodeRuntime(_ResilientCallMixin, NodeRuntime):
    """REST microservice client of one graph node; ``executor`` encodes the
    request bodies (the loop's default executor when None)."""

    def __init__(self, node: PredictiveUnit, binding: ComponentBinding,
                 timeout_s: float = DEFAULT_TIMEOUT_S, retries: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 executor: Optional[Executor] = None):
        host = binding.host or "localhost"
        self.node = node
        self.binding = binding
        self.host = host
        self.port = int(binding.port)
        # a "unix:/path" host dials that socket: the same HTTP surface
        self._uds_path: Optional[str] = host[len("unix:"):] if host.startswith("unix:") else None
        self.timeout_s = float(timeout_s)
        self.retry_policy = retry_policy or RetryPolicy(max_attempts=retries)
        self.breaker = breaker
        self.retry_budget = retry_budget
        self.executor = executor
        image, _, version = (binding.image or "").partition(":")
        authority = "localhost" if self._uds_path is not None else f"{host}:{self.port}"
        self._head_fixed = (
            f"Host: {authority}\r\n"
            f"Seldon-model-name: {node.name}\r\nSeldon-model-image: {image}\r\n"
            f"Seldon-model-version: {version}\r\n").encode("latin-1")
        self._idle: List[Tuple[socket.socket, bytearray]] = []
        self._pool_lock = threading.Lock()
        self._closed = False
        # binary wire negotiation: predicts try the frame first; a peer that
        # does not speak it is remembered as JSON-only
        self._wire_ok = True

    # -- the connection pool ---------------------------------------------------

    def _checkout(self) -> Optional[Tuple[socket.socket, bytearray]]:
        with self._pool_lock:
            while self._idle:
                sock, buf = self._idle.pop()
                if not buf and _alive(sock):
                    return sock, buf
                sock.close()
        return None

    def _checkin(self, conn: Tuple[socket.socket, bytearray]) -> None:
        with self._pool_lock:
            if not self._closed and len(self._idle) < MAX_IDLE:
                self._idle.append(conn)
                return
        conn[0].close()

    async def _dial(self) -> Tuple[socket.socket, bytearray]:
        loop = asyncio.get_running_loop()
        if self._uds_path is not None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                await loop.sock_connect(sock, self._uds_path)
            except BaseException:
                sock.close()
                raise
            return sock, bytearray()
        infos = await loop.getaddrinfo(self.host, self.port, type=socket.SOCK_STREAM)
        err: Optional[OSError] = None
        for family, type_, proto, _, addr in infos:
            sock = socket.socket(family, type_, proto)
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                await loop.sock_connect(sock, addr)
                return sock, bytearray()
            except OSError as e:
                sock.close()
                err = e
            except BaseException:
                sock.close()
                raise
        raise err or ConnectionError(f"no address for {self.host}:{self.port}")

    def close(self) -> None:
        """Close the pooled connections; one still in use closes when its
        call ends."""
        with self._pool_lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock, _ in idle:
            sock.close()

    # -- one HTTP exchange --------------------------------------------------

    async def _exchange(self, conn, path: str, body: bytes, headers: Dict[str, str]
                        ) -> Tuple[int, bytes, bool, str]:
        """POST ``body`` on ``conn``: (status, response body, keep-alive,
        response content type)."""
        loop = asyncio.get_running_loop()
        sock, buf = conn
        extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items()).encode("latin-1")
        await loop.sock_sendall(sock, b"POST %s HTTP/1.1\r\n%s%sContent-Length: %d\r\n\r\n%s" % (
            path.encode("latin-1"), self._head_fixed, extra, len(body), body))
        while (end := buf.find(b"\r\n\r\n")) < 0:
            if len(buf) > _MAX_HEAD:
                raise _BadResponse("response head too large")
            await self._fill(loop, sock, buf)
        head = bytes(buf[:end]).decode("latin-1").split("\r\n")
        del buf[:end + 4]
        try:
            version, status = head[0].split(" ", 2)[:2]
            status = int(status)
        except ValueError:
            raise _BadResponse(f"bad status line {head[0][:80]!r}") from None
        fields = {}
        for line in head[1:]:
            name, _, value = line.partition(":")
            fields[name.strip().lower()] = value.strip()
        keep = version == "HTTP/1.1" and fields.get("connection", "").lower() != "close"
        ctype = fields.get("content-type", "").split(";", 1)[0].strip().lower()
        if "transfer-encoding" in fields:
            raise _BadResponse(f"Transfer-Encoding {fields['transfer-encoding']!r} responses "
                               f"are not read; the unit servers send Content-Length")
        if "content-length" in fields:
            try:
                n = int(fields["content-length"])
            except ValueError:
                raise _BadResponse("bad Content-Length") from None
            while len(buf) < n:
                await self._fill(loop, sock, buf)
            payload = bytes(buf[:n])
            del buf[:n]
            return status, payload, keep and not buf, ctype
        while await self._fill(loop, sock, buf, eof_ok=True):
            pass  # no length: the body runs to the connection's end
        payload = bytes(buf)
        buf.clear()
        return status, payload, False, ctype

    @staticmethod
    async def _fill(loop, sock, buf: bytearray, eof_ok: bool = False) -> bool:
        chunk = await loop.sock_recv(sock, 262144)
        if not chunk:
            if eof_ok:
                return False
            raise ConnectionResetError("the peer closed the connection mid-response")
        buf += chunk
        return True

    async def _attempt(self, path: str, body: bytes, headers: Dict[str, str],
                       timeout_s: float) -> Tuple[int, bytes, str]:
        """One attempt under its timeout, on a pooled or a new connection:
        (status, response body, response content type)."""
        conn, keep = None, False
        try:
            async with asyncio.timeout(timeout_s):
                conn = self._checkout() or await self._dial()
                status, payload, keep, ctype = await self._exchange(conn, path, body, headers)
            return status, payload, ctype
        finally:
            if conn is not None:
                if keep:
                    self._checkin(conn)
                else:
                    conn[0].close()

    # -- the resilient call ----------------------------------------------------

    async def _encoded(self, encode: Callable[[], Any]) -> bytes:
        """``encode()`` on the executor, in the caller's context (a frame's
        sidecar reads the deadline); a str comes back as UTF-8 bytes."""
        ctx = contextvars.copy_context()
        out = await asyncio.get_running_loop().run_in_executor(self.executor, ctx.run, encode)
        return out.encode() if isinstance(out, str) else out

    async def _post(self, path: str, encode: Callable[[], str], method: str,
                    wire_msg: Optional[SeldonMessage] = None, puid: str = "") -> SeldonMessage:
        """One call in its client span (``client.py:219-230`` there)."""
        with _client_span(self.node.name, puid, path.strip("/"),
                          "wire" if wire_msg is not None else "rest"):
            return await self._post_traced(path, encode, method, wire_msg)

    async def _post_traced(self, path: str, encode: Callable[[], str], method: str,
                           wire_msg: Optional[SeldonMessage] = None) -> SeldonMessage:
        """The attempt loop: per-attempt breaker admission, a timeout
        clamped to the remaining budget (an exhausted one raises
        ``DeadlineExceededError``, 504, before any I/O), retries as the
        policy allows.  ``wire_msg`` sends each attempt as a binary frame
        while the node speaks the wire; the JSON body (``encode()``) is
        made only if the node negotiates down."""
        policy = self.retry_policy
        guard = _BreakerGuard(self.breaker)
        attempt = 0
        body = wire_body = None

        def accept(raw: bytes, ctype: str) -> SeldonMessage:
            # the one 200 acceptance rule of both transports: a malformed
            # 200 is deterministic misbehaviour, a breaker failure, never
            # retried; a first-attempt success deposits into the budget
            try:
                if ctype == wire.WIRE_CONTENT_TYPE:
                    out = wire.message_from_frame(wire.decode_frame(raw))
                else:
                    out = SeldonMessage.from_json(raw)
            except SeldonMessageError as e:
                guard.record(False)
                raise RemoteCallError(self.node.name, path, f"bad response: {e}") from e
            guard.record(True)
            if self.retry_budget is not None and attempt == 0:
                self.retry_budget.deposit()
            return out

        try:
            while True:
                _gate_traced(guard, self.node.name)
                timeout_s = clamp_timeout(self.timeout_s, where=f"rest:{self.node.name}")
                headers = {}
                hdr = deadline_header_value()
                if hdr is not None:
                    headers[DEADLINE_HEADER] = hdr
                # the client span (active here) is the remote server span's
                # parent
                tp = traceparent_header_value()
                if tp is not None:
                    headers[TRACEPARENT_HEADER] = tp
                headers.update(_qos_headers())
                use_wire = wire_msg is not None and self._wire_ok
                try:
                    if use_wire:
                        if wire_body is None:
                            wire_body = await self._encoded(lambda: wire.join_parts(
                                wire.frame_from_message(wire_msg, sidecar=True)))
                        headers["Content-Type"] = wire.WIRE_CONTENT_TYPE
                        RECORDER.record_wire_request("node", "binary")
                        status, raw, ctype = await self._attempt(path, wire_body, headers,
                                                                 timeout_s)
                        if status == 200:
                            if ctype != wire.WIRE_CONTENT_TYPE:
                                # a JSON answer to a frame: the peer ignored the
                                # content type; take it and speak JSON from now on
                                self._wire_ok = False
                            return accept(raw, ctype)
                        if status in _WIRE_NEGOTIATE_DOWN and ctype != wire.WIRE_CONTENT_TYPE:
                            # the peer does not speak the wire: negotiate down
                            # and send this attempt again as JSON; the answer
                            # shows the node alive, a breaker success
                            self._wire_ok = False
                            guard.record(True)
                            continue
                    else:
                        if body is None:
                            body = await self._encoded(encode)
                        headers["Content-Type"] = _JSON
                        RECORDER.record_wire_request("node", "json")
                        status, raw, ctype = await self._attempt(path, body, headers, timeout_s)
                        if status == 200:
                            return accept(raw, ctype)
                    # 5xx and 429 count against the breaker and may retry;
                    # a 4xx is the caller's fault: neither
                    retryable = policy.retryable_http(status)
                    guard.record(not (retryable or status >= 500))
                    last_err = f"HTTP {status}: {raw[:200].decode('utf-8', 'replace')}"
                except OSError as e:
                    # a transport failure (refused, reset, a stale socket, an
                    # attempt's TimeoutError): a breaker failure, retryable
                    # for idempotent methods
                    guard.record(False)
                    retryable = True
                    last_err = f"{type(e).__name__}: {e}"
                if not (retryable and self._retry_allowed(attempt, method)
                        and await self._retry_after_backoff(attempt, method)):
                    raise RemoteCallError(self.node.name, path, last_err)
                attempt += 1
        finally:
            guard.close()

    # -- NodeRuntime API ----------------------------------------------------

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if self._wire_ok and wire.wire_enabled() and wire.frame_eligible(msg):
            return await self._post("/predict", msg.to_json, "predict", wire_msg=msg,
                                    puid=msg.meta.puid)
        return await self._post("/predict", msg.to_json, "predict", puid=msg.meta.puid)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._post("/transform-input", msg.to_json, "transform_input",
                                puid=msg.meta.puid)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._post("/transform-output", msg.to_json, "transform_output",
                                puid=msg.meta.puid)

    async def route(self, msg: SeldonMessage) -> int:
        # not idempotent (a bandit moves its exploration state): one attempt
        resp = await self._post("/route", msg.to_json, "route", puid=msg.meta.puid)
        return _branch_from_msg(self.node.name, resp, "/route")

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        return await self._post("/aggregate", SeldonMessageList(messages=msgs).to_json,
                                "aggregate", puid=msgs[0].meta.puid if msgs else "")

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        # never retried: a duplicated delivery trains the unit twice
        await self._post("/send-feedback", feedback.to_json, "send_feedback",
                         puid=feedback.puid())


class GrpcNodeRuntime(_ResilientCallMixin, NodeRuntime):
    """gRPC microservice client of one graph node, on one pooled
    ``FastGrpcChannel`` (dialled on first use, again after a lost
    connection, and again on another event loop); ``executor`` encodes
    and decodes the messages (the loop's default executor when None).
    Method routing follows the reference's type dispatch (engine
    InternalPredictionService.java:111-161)."""

    def __init__(self, node: PredictiveUnit, binding: ComponentBinding,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 executor: Optional[Executor] = None):
        self.node = node
        self.binding = binding
        self.host = binding.host or "localhost"
        self.port = int(binding.port)
        self.timeout_s = float(timeout_s)
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker
        self.retry_budget = retry_budget
        self.executor = executor
        # feedback goes to Router/SendFeedback for a typed node and to
        # Generic/SendFeedback for an untyped one (the Model service has no
        # SendFeedback rpc)
        fb_service = "Generic" if node.type is None else "Router"
        self._paths = {
            "predict": b"/seldon.protos.Model/Predict",
            "transform_input": b"/seldon.protos.Transformer/TransformInput",
            "transform_output": b"/seldon.protos.OutputTransformer/TransformOutput",
            "route": b"/seldon.protos.Router/Route",
            "aggregate": b"/seldon.protos.Combiner/Aggregate",
            "send_feedback": f"/seldon.protos.{fb_service}/SendFeedback".encode(),
        }
        self._channel: Optional[FastGrpcChannel] = None
        self._dialing: Optional[asyncio.Future] = None

    async def _connection(self) -> FastGrpcChannel:
        """The pooled channel on the running loop, dialled when there is
        none open there (concurrent first calls share one dial)."""
        loop = asyncio.get_running_loop()
        ch = self._channel
        if ch is not None and ch.loop is loop and ch.is_open:
            return ch
        if self._dialing is None or self._dialing.get_loop() is not loop:
            self._drop()
            dial = loop.create_task(FastGrpcChannel().connect(self.host, self.port))

            def adopt(task):
                # a dial outlives a caller's timeout (shielded): its channel
                # is kept, and the dial's error is read here
                if self._dialing is task:
                    self._dialing = None
                if not task.cancelled() and task.exception() is None:
                    self._channel = task.result()

            dial.add_done_callback(adopt)
            self._dialing = dial
        return await asyncio.shield(self._dialing)

    def _drop(self) -> None:
        ch, self._channel = self._channel, None
        if ch is not None:
            ch.close_nowait()

    def close(self) -> None:
        """Close the pooled connection."""
        self._drop()

    async def _call(self, method: str, encode: Callable[[], bytes],
                    puid: str = "") -> SeldonMessage:
        """One call in its client span (``client.py:500-515`` there)."""
        with _client_span(self.node.name, puid, method, "grpc"):
            return await self._call_traced(method, encode)

    async def _call_traced(self, method: str, encode: Callable[[], bytes]) -> SeldonMessage:
        """One resilient call: the breaker gate, a timeout clamped to the
        remaining budget, retries on a retryable status name as the policy
        allows."""
        loop = asyncio.get_running_loop()
        path = self._paths[method]
        request = await loop.run_in_executor(self.executor, encode)
        policy = self.retry_policy
        guard = _BreakerGuard(self.breaker)
        attempt = 0
        try:
            while True:
                _gate_traced(guard, self.node.name)
                timeout_s = clamp_timeout(self.timeout_s, where=f"grpc:{self.node.name}")
                tp = traceparent_header_value()
                metadata = ((b"traceparent", tp.encode("latin-1")),) if tp is not None else ()
                metadata += tuple((k.lower().encode(), v.encode("latin-1"))
                                  for k, v in _qos_headers().items())
                try:
                    async with asyncio.timeout(timeout_s):
                        channel = await self._connection()
                        raw = await channel.call(path, request, metadata)
                except GrpcCallError as e:
                    code_name, detail = e.code_name, e.grpc_message
                    if e.status == 14:
                        self._drop()  # the connection is gone: dial again
                except TimeoutError:
                    code_name, detail = "DEADLINE_EXCEEDED", f"attempt exceeded {timeout_s:.3f}s"
                except OSError as e:
                    self._drop()
                    code_name, detail = "UNAVAILABLE", f"{type(e).__name__}: {e}"
                else:
                    try:
                        out = await loop.run_in_executor(self.executor, protoconv.msg_from_proto,
                                                         raw)
                    except SeldonMessageError as e:
                        guard.record(False)
                        raise RemoteCallError(self.node.name, path.decode(),
                                              f"bad response: {e}") from e
                    guard.record(True)
                    if self.retry_budget is not None and attempt == 0:
                        self.retry_budget.deposit()
                    return out
                guard.record(False)
                if not (policy.retryable_grpc(code_name) and self._retry_allowed(attempt, method)
                        and await self._retry_after_backoff(attempt, method)):
                    raise RemoteCallError(self.node.name, path.decode(), f"{code_name}: {detail}")
                attempt += 1
        finally:
            guard.close()

    # -- NodeRuntime API ----------------------------------------------------

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("predict", lambda: protoconv.msg_to_proto(msg), msg.meta.puid)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("transform_input", lambda: protoconv.msg_to_proto(msg),
                                msg.meta.puid)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("transform_output", lambda: protoconv.msg_to_proto(msg),
                                msg.meta.puid)

    async def route(self, msg: SeldonMessage) -> int:
        # not idempotent (a bandit moves its exploration state): one attempt
        resp = await self._call("route", lambda: protoconv.msg_to_proto(msg), msg.meta.puid)
        return _branch_from_msg(self.node.name, resp, "Route")

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        return await self._call("aggregate", lambda: protoconv.msg_list_to_proto(
            SeldonMessageList(messages=msgs)), msgs[0].meta.puid if msgs else "")

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        # never retried: a duplicated delivery trains the unit twice
        await self._call("send_feedback", lambda: protoconv.feedback_to_proto(feedback),
                         feedback.puid())


def make_node_runtime(node: PredictiveUnit, binding: ComponentBinding,
                      retry_policy: Optional[RetryPolicy] = None,
                      breaker: Optional[CircuitBreaker] = None,
                      retry_budget: Optional[RetryBudget] = None,
                      executor: Optional[Executor] = None) -> NodeRuntime:
    """The remote runtime of a binding (``rest`` or ``grpc``), wired into the
    predictor's shared resilience state (the engine passes one
    ``RetryBudget`` for the graph, one ``CircuitBreaker`` per node and its
    dispatch executor)."""
    cls = GrpcNodeRuntime if binding.runtime == "grpc" else RestNodeRuntime
    return cls(node, binding, retry_policy=retry_policy,
               breaker=breaker or CircuitBreaker(node.name),
               retry_budget=retry_budget, executor=executor)


# ---------------------------------------------------------------------------
# The gateway's upstream HTTP client
# ---------------------------------------------------------------------------


class UpstreamConnectError(ConnectionError):
    """The connection could not be opened: no byte reached the peer."""


class HttpResponse:
    """One upstream answer: ``status``, ``ctype`` (the media type, lower
    case, parameters cut), ``headers`` (lower-cased names) and ``body``."""

    __slots__ = ("status", "ctype", "headers", "body")

    def __init__(self, status: int, headers: Dict[str, str], body: bytes = b""):
        self.status = status
        self.headers = headers
        self.ctype = headers.get("content-type", "").split(";", 1)[0].strip().lower()
        self.body = body

    def text(self) -> str:
        return self.body.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.body)


def _env_number(name: str, default, cast):
    try:
        return cast(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _Upstream:
    """A streamed response: ``status`` and ``headers`` are read; iterate
    ``chunks()`` for the body as it arrives, then ``close()``."""

    def __init__(self, response: HttpResponse, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, release: Callable[[], None]):
        self.response = response
        self.status = response.status
        self._reader = reader
        self._writer = writer
        self._release = release

    async def chunks(self) -> AsyncIterator[bytes]:
        async for part in _body_parts(self._reader, self.response.headers):
            yield part

    async def read(self) -> bytes:
        return b"".join([p async for p in self.chunks()])

    def close(self) -> None:
        self._writer.close()
        self._release()


async def _body_parts(reader: asyncio.StreamReader, headers: Dict[str, str]
                      ) -> AsyncIterator[bytes]:
    """A response body as it arrives: chunked, by Content-Length, or to the
    connection's end; a body cut short raises ``ConnectionResetError``."""
    try:
        async for part in _body_parts_raw(reader, headers):
            yield part
    except asyncio.IncompleteReadError as e:
        raise ConnectionResetError("the peer closed the connection mid-response") from e
    except asyncio.LimitOverrunError as e:
        raise _BadResponse("response chunk header too large") from e


async def _body_parts_raw(reader: asyncio.StreamReader, headers: Dict[str, str]
                          ) -> AsyncIterator[bytes]:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            line = await reader.readuntil(b"\r\n")
            try:
                n = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadResponse(f"bad chunk size {line[:40]!r}") from None
            if n == 0:
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass  # trailers
                return
            data = await reader.readexactly(n + 2)
            yield data[:-2]
    elif "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise _BadResponse("bad Content-Length") from None
        while n > 0:
            data = await reader.read(min(n, 262144))
            if not data:
                raise ConnectionResetError("the peer closed the connection mid-response")
            n -= len(data)
            yield data
    else:
        while data := await reader.read(262144):
            yield data


class HttpClient:
    """Pooled HTTP/1.1 keep-alive client (see the module docstring).  One
    per gateway; bound to the event loop of its first call (a call on
    another loop starts a fresh pool)."""

    def __init__(self, pool: Optional[int] = None, keepalive_s: Optional[float] = None):
        self.pool = pool if pool is not None else _env_number("SELDON_TPU_GW_POOL", 100, int)
        self.keepalive_s = (keepalive_s if keepalive_s is not None
                            else _env_number("SELDON_TPU_GW_KEEPALIVE_S", 15.0, float))
        self._idle: Dict[Tuple[str, int], List[Tuple[Any, Any, float]]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._slots: Optional[asyncio.Semaphore] = None
        self.closed = False

    # -- connections -------------------------------------------------------

    def _bind_loop(self) -> asyncio.Semaphore:
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            for conns in self._idle.values():
                for _r, w, _t in conns:
                    w.close()
            self._idle = {}
            self._loop = loop
            self._slots = asyncio.Semaphore(max(1, int(self.pool)))
        return self._slots

    def _checkout(self, key):
        conns = self._idle.get(key)
        now = time.monotonic()
        while conns:
            reader, writer, since = conns.pop()
            if writer.is_closing() or reader.at_eof() or now - since > self.keepalive_s:
                writer.close()
                continue
            return reader, writer
        return None

    def _checkin(self, key, reader, writer) -> None:
        conns = self._idle.setdefault(key, [])
        if self.closed or len(conns) >= self.pool or writer.is_closing():
            writer.close()
            return
        conns.append((reader, writer, time.monotonic()))

    @staticmethod
    async def _dial(host: str, port: int):
        try:
            reader, writer = await asyncio.open_connection(host, port, limit=1 << 20)
        except OSError as e:
            raise UpstreamConnectError(f"cannot connect to {host}:{port}: {e}") from e
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        return reader, writer

    @staticmethod
    def _split(url: str) -> Tuple[str, int, str]:
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"not an http:// URL: {url!r}")
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        return parts.hostname, parts.port or 80, target

    @staticmethod
    async def _send_and_read_head(reader, writer, method: str, host: str, port: int,
                                  target: str, body: bytes,
                                  headers: Optional[Dict[str, str]]) -> HttpResponse:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"{method} {target} HTTP/1.1\r\nHost: {host}:{port}\r\n{extra}"
            f"Content-Length: {len(body)}\r\n\r\n".encode("latin-1") + body)
        await writer.drain()
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            raise ConnectionResetError("the peer closed the connection before answering") from e
        except asyncio.LimitOverrunError as e:
            raise _BadResponse("response head too large") from e
        lines = head[:-4].decode("latin-1").split("\r\n")
        try:
            status = int(lines[0].split(" ", 2)[1])
        except (IndexError, ValueError):
            raise _BadResponse(f"bad status line {lines[0][:80]!r}") from None
        fields = {}
        for line in lines[1:]:
            name, _, value = line.partition(":")
            fields[name.strip().lower()] = value.strip()
        if not lines[0].startswith("HTTP/1.1"):
            fields.setdefault("connection", "close")
        return HttpResponse(status, fields)

    async def _open(self, method: str, url: str, body: bytes,
                    headers: Optional[Dict[str, str]]):
        """Send one request on a pooled or a new connection and read its
        head: (response, reader, writer, key).  A pooled connection the
        peer closed before any answer is replaced by a fresh one, once."""
        if self.closed:
            raise ConnectionError("http client closed")
        host, port, target = self._split(url)
        key = (host, port)
        pooled = self._checkout(key)
        for attempt in (0, 1):
            reader, writer = pooled if pooled is not None else await self._dial(host, port)
            try:
                resp = await self._send_and_read_head(reader, writer, method, host, port, target,
                                                      body, headers)
                return resp, reader, writer, key
            except (ConnectionResetError, BrokenPipeError):
                writer.close()
                if pooled is None or attempt:
                    raise
                pooled = None  # a stale keep-alive: dial once more
            except BaseException:
                writer.close()
                raise
        raise AssertionError("unreachable")

    # -- calls -------------------------------------------------------------

    async def request(self, method: str, url: str, body: bytes = b"",
                      headers: Optional[Dict[str, str]] = None,
                      timeout: Optional[float] = 20.0) -> HttpResponse:
        """One whole call under ``timeout`` seconds (None: no limit)."""
        slots = self._bind_loop()
        async with asyncio.timeout(timeout):
            async with slots:
                resp, reader, writer, key = await self._open(method, url, body, headers)
                try:
                    resp.body = b"".join([p async for p in _body_parts(reader, resp.headers)])
                except BaseException:
                    writer.close()
                    raise
                framed = ("content-length" in resp.headers
                          or "chunked" in resp.headers.get("transfer-encoding", ""))
                if framed and resp.headers.get("connection", "").lower() != "close":
                    self._checkin(key, reader, writer)
                else:
                    writer.close()
                return resp

    async def post(self, url: str, body: bytes, headers: Optional[Dict[str, str]] = None,
                   timeout: Optional[float] = 20.0) -> HttpResponse:
        return await self.request("POST", url, body, headers, timeout)

    async def get(self, url: str, timeout: Optional[float] = 20.0) -> HttpResponse:
        return await self.request("GET", url, b"", None, timeout)

    async def get_json(self, url: str, timeout: Optional[float] = 20.0):
        """GET a JSON document: (status, the parsed body)."""
        resp = await self.get(url, timeout)
        return resp.status, json.loads(resp.body)

    async def stream(self, url: str, body: bytes, headers: Optional[Dict[str, str]] = None,
                     connect_timeout: float = 20.0) -> _Upstream:
        """POST ``body`` and return once the response head is read (within
        ``connect_timeout``); the body is then read as it arrives, with no
        time limit.  The connection is the stream's own, never pooled."""
        slots = self._bind_loop()
        async with asyncio.timeout(connect_timeout):
            await slots.acquire()
            try:
                resp, reader, writer, _key = await self._open("POST", url, body, headers)
            except BaseException:
                slots.release()
                raise
        released = []

        def release():
            if not released:
                released.append(True)
                slots.release()

        return _Upstream(resp, reader, writer, release)

    async def close(self) -> None:
        self.closed = True
        for conns in self._idle.values():
            for _r, w, _t in conns:
                w.close()
        self._idle = {}
