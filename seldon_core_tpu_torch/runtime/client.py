"""Remote-node client — the engine's outbound dispatch; the port's
counterpart of ``seldon_core_tpu/runtime/client.py:55-447, 639-660``.

``RestNodeRuntime`` speaks the internal microservice API (``/predict``,
``/route``, ``/aggregate``, ``/transform-input``, ``/transform-output``,
``/send-feedback``; docs/reference/internal-api.md) in JSON, on stdlib
asyncio alone (the machines the port serves on have no ``aiohttp``):

* HTTP/1.1 over keep-alive connections pooled per node: a call takes an
  idle connection (one the peer has closed is dropped first, read with a
  non-blocking peek) or dials a new one, and hands it back after a whole
  ``Content-Length`` response; the sockets are non-blocking and driven by
  the running loop's ``sock_*`` calls, so a pool outlives the loop that
  filled it and closes without one;
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

A failure after the policy gives up is a ``RemoteCallError`` (502).  The
binary tensor wire, ``GrpcNodeRuntime`` and ``unix:`` hosts raise
``GraphSpecError`` until ROADMAP Queue 1 item [3] (gRPC and the binary
wire); the client never swaps a remote node for a local unit.
"""

from __future__ import annotations

import asyncio
import socket
import threading
from concurrent.futures import Executor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.graph.interpreter import NodeRuntime
from seldon_core_tpu_torch.graph.spec import ComponentBinding, GraphSpecError, PredictiveUnit
from seldon_core_tpu_torch.messages import (
    Feedback,
    SeldonMessage,
    SeldonMessageError,
    SeldonMessageList,
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

__all__ = ["RestNodeRuntime", "RemoteCallError", "make_node_runtime"]

DEFAULT_TIMEOUT_S = 5.0  # the reference's TIMEOUT, InternalPredictionService.java:77
MAX_IDLE = 8  # idle keep-alive connections kept per node
_MAX_HEAD = 64 * 1024


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
            return False
        if self.retry_budget is not None and not self.retry_budget.withdraw():
            return False
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
        if host.startswith("unix:"):
            raise GraphSpecError(f"node {node.name!r}: unix-socket hosts are not ported yet "
                                 f"(ROADMAP Queue 1 item [3]: gRPC and the binary wire)")
        self.node = node
        self.binding = binding
        self.host = host
        self.port = int(binding.port)
        self.timeout_s = float(timeout_s)
        self.retry_policy = retry_policy or RetryPolicy(max_attempts=retries)
        self.breaker = breaker
        self.retry_budget = retry_budget
        self.executor = executor
        image, _, version = (binding.image or "").partition(":")
        self._head_fixed = (
            f"Host: {host}:{self.port}\r\nContent-Type: application/json\r\n"
            f"Seldon-model-name: {node.name}\r\nSeldon-model-image: {image}\r\n"
            f"Seldon-model-version: {version}\r\n").encode("latin-1")
        self._idle: List[Tuple[socket.socket, bytearray]] = []
        self._pool_lock = threading.Lock()
        self._closed = False

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
                        ) -> Tuple[int, bytes, bool]:
        """POST ``body`` on ``conn``: (status, response body, keep-alive)."""
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
            return status, payload, keep and not buf
        while await self._fill(loop, sock, buf, eof_ok=True):
            pass  # no length: the body runs to the connection's end
        payload = bytes(buf)
        buf.clear()
        return status, payload, False

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
                       timeout_s: float) -> Tuple[int, bytes]:
        """One attempt under its timeout, on a pooled or a new connection."""
        conn, keep = None, False
        try:
            async with asyncio.timeout(timeout_s):
                conn = self._checkout() or await self._dial()
                status, payload, keep = await self._exchange(conn, path, body, headers)
            return status, payload
        finally:
            if conn is not None:
                if keep:
                    self._checkin(conn)
                else:
                    conn[0].close()

    # -- the resilient call ----------------------------------------------------

    async def _post(self, path: str, encode: Callable[[], str], method: str) -> SeldonMessage:
        """``encode()`` on the executor, then the attempt loop: per-attempt
        breaker admission, a timeout clamped to the remaining budget (an
        exhausted one raises ``DeadlineExceededError``, 504, before any
        I/O), retries as the policy allows."""
        body = (await asyncio.get_running_loop().run_in_executor(self.executor, encode)).encode()
        policy = self.retry_policy
        guard = _BreakerGuard(self.breaker)
        attempt = 0
        try:
            while True:
                guard.gate(self.node.name)
                timeout_s = clamp_timeout(self.timeout_s, where=f"rest:{self.node.name}")
                headers = {}
                hdr = deadline_header_value()
                if hdr is not None:
                    headers[DEADLINE_HEADER] = hdr
                try:
                    status, raw = await self._attempt(path, body, headers, timeout_s)
                    if status == 200:
                        try:
                            out = SeldonMessage.from_json(raw)
                        except SeldonMessageError as e:
                            # a malformed 200 is deterministic misbehaviour:
                            # a breaker failure, never retried
                            guard.record(False)
                            raise RemoteCallError(self.node.name, path,
                                                  f"bad response: {e}") from e
                        guard.record(True)
                        if self.retry_budget is not None and attempt == 0:
                            self.retry_budget.deposit()
                        return out
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
        return await self._post("/predict", msg.to_json, "predict")

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._post("/transform-input", msg.to_json, "transform_input")

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._post("/transform-output", msg.to_json, "transform_output")

    async def route(self, msg: SeldonMessage) -> int:
        # not idempotent (a bandit moves its exploration state): one attempt
        resp = await self._post("/route", msg.to_json, "route")
        return _branch_from_msg(self.node.name, resp, "/route")

    async def aggregate(self, msgs: List[SeldonMessage]) -> SeldonMessage:
        return await self._post("/aggregate", SeldonMessageList(messages=msgs).to_json,
                                "aggregate")

    async def send_feedback(self, feedback: Feedback, branch: int) -> None:
        # never retried: a duplicated delivery trains the unit twice
        await self._post("/send-feedback", feedback.to_json, "send_feedback")


def make_node_runtime(node: PredictiveUnit, binding: ComponentBinding,
                      retry_policy: Optional[RetryPolicy] = None,
                      breaker: Optional[CircuitBreaker] = None,
                      retry_budget: Optional[RetryBudget] = None,
                      executor: Optional[Executor] = None) -> NodeRuntime:
    """The remote runtime of a binding, wired into the predictor's shared
    resilience state (the engine passes one ``RetryBudget`` for the graph,
    one ``CircuitBreaker`` per node and its dispatch executor).  gRPC
    raises ``GraphSpecError``."""
    if binding.runtime == "grpc":
        raise GraphSpecError(f"node {node.name!r} is a gRPC binding: gRPC nodes are not ported "
                             f"yet (ROADMAP Queue 1 item [3]: gRPC and the binary wire)")
    return RestNodeRuntime(node, binding, retry_policy=retry_policy,
                           breaker=breaker or CircuitBreaker(node.name),
                           retry_budget=retry_budget, executor=executor)
