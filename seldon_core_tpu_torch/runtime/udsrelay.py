"""UDS relay lane — co-located gateway <-> engine dispatch; the port's
copy of ``seldon_core_tpu/runtime/udsrelay.py``.

The cheapest framing that still multiplexes methods, over a
``SOCK_STREAM`` unix domain socket::

    request  frame:  !IB   payload_len(u32) | op(u8)      | payload
    response frame:  !IH   payload_len(u32) | status(u16) | payload

The server slices the receive buffer with memoryviews and hands the body
on; responses go out as a (header, body parts) sequence of writes.

Ops:

    OP_PREDICT   payload = SeldonMessage JSON  -> response JSON + status
    OP_FEEDBACK  payload = Feedback JSON       -> ack JSON + status
    OP_PING      empty                         -> b"pong", 200
    OP_KVSTREAM  payload = binary KV hand-off frame (``runtime/kvstream.py``)
                 -> the engine's ``kv_frame`` answer (503 where it has none)
    OP_TRACE     payload = JSON query {"trace_id"|"puid"|"limit"} -> the
                 engine's local trace document (``engine.trace_json``)
    OP_WIRE      payload = binary tensor frame (``runtime/wire.py``; single
                 or MULTI) -> binary response frame parts

Metadata sidecar: the op byte's high bit (``op | 0x80``) marks the payload
as ``uvarint(meta_len) | meta_block | body``; the block (version first)
carries the request deadline, traceparent, tenant and tier.  The server
binds the deadline, the trace context, the tenant and the tier around the
handler, as the HTTP lane binds the ``Seldon-Deadline-Ms``,
``traceparent``, ``Seldon-Tenant`` and ``Seldon-Tier`` headers; a
malformed block degrades to no metadata.  The client packs the calling
context's deadline, traceparent, tenant and tier, and with the cost ledger
on bills each frame's bytes to the bound tenant (lane ``relay``,
``udsrelay.py:608-619`` there).

Scope: unary predict, feedback, the binary wire and the KV hand-off.  The
client pipelines nothing: each pooled connection carries one request at a
time.  The same protocol runs on a TCP port (``TcpRelayServer``,
``TcpRelayClient``, ``serve_relay_tcp``; ``tcp:host:port`` relay specs):
the cross-host lane of the prefill-to-decode hand-off.
"""

from __future__ import annotations

import asyncio
import os
import struct
from typing import Optional

from seldon_core_tpu_torch.messages import (
    Feedback,
    SeldonMessage,
    SeldonMessageError,
)
from seldon_core_tpu_torch.runtime import wire as wirelib
from seldon_core_tpu_torch.runtime.qos import current_tenant, current_tier, qos_scope
from seldon_core_tpu_torch.runtime.resilience import maybe_deadline_scope, remaining_s
from seldon_core_tpu_torch.utils.costledger import LEDGER, costledger_enabled
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import (
    parse_traceparent,
    trace_scope,
    traceparent_header_value,
)

__all__ = [
    "OP_PREDICT",
    "OP_FEEDBACK",
    "OP_PING",
    "OP_KVSTREAM",
    "OP_TRACE",
    "OP_WIRE",
    "META_FLAG",
    "RELAY_META_VERSION",
    "UdsEngineServer",
    "UdsRelayClient",
    "TcpRelayServer",
    "TcpRelayClient",
    "serve_relay_tcp",
    "make_relay_client",
    "pack_relay_meta",
    "unpack_relay_meta",
    "current_relay_meta",
    "serve_uds",
]

OP_PREDICT = 1
OP_FEEDBACK = 2
OP_PING = 3
OP_KVSTREAM = 4
OP_TRACE = 5
OP_WIRE = 6

#: high bit of the op byte: payload begins with a varint-prefixed
#: metadata block (deadline/traceparent/tenant/tier sidecar)
META_FLAG = 0x80
RELAY_META_VERSION = 1

_REQ_HEAD = struct.Struct("!IB")   # payload length, op
_RESP_HEAD = struct.Struct("!IH")  # payload length, status
_META_HEAD = struct.Struct("!Bd")  # version, deadline_ms (<=0 = absent)
_MAX_FRAME = 256 * 1024 * 1024     # matches the HTTP lanes' body cap
_JSON_500 = 500
# per-connection backpressure: the shipped client never pipelines, but
# the server must not trust that — a runaway local writer would otherwise
# turn every buffered frame into a concurrent engine task.  Reading
# pauses once this many responses are pending and resumes at the low
# mark; excess frames wait in the kernel socket buffer until the
# client's writes block.
_PAUSE_PENDING = 64
_RESUME_PENDING = 16


# framing helpers shared with the binary tensor wire codec: one uvarint for
# both framed lanes (runtime/wire.py owns it)
_pack_str = wirelib.pack_str
_read_uvarint = wirelib.read_uvarint
_uvarint = wirelib.uvarint


def pack_relay_meta(deadline_ms=None, traceparent=None, tenant=None,
                    tier=None) -> bytes:
    """The request-frame metadata sidecar: deadline budget, W3C trace
    context, tenant and tier, packed version-first so a future field can
    ride behind a version bump without breaking old parsers."""
    return (
        _META_HEAD.pack(RELAY_META_VERSION,
                        float(deadline_ms) if deadline_ms else -1.0)
        + _pack_str(traceparent) + _pack_str(tenant) + _pack_str(tier)
    )


def unpack_relay_meta(view) -> dict:
    """Lenient sidecar parse: a malformed or future-versioned block
    degrades to 'no metadata' — bad metadata must never fail a request
    that would otherwise serve (the deadline-header rule)."""
    out = {"deadline_ms": None, "traceparent": None, "tenant": None,
           "tier": None}
    try:
        version, deadline_ms = _META_HEAD.unpack_from(view, 0)
        if version != RELAY_META_VERSION:
            return out
        if deadline_ms > 0:
            out["deadline_ms"] = deadline_ms
        off = _META_HEAD.size
        for key in ("traceparent", "tenant", "tier"):
            n, off = _read_uvarint(view, off)
            raw = bytes(view[off:off + n])
            off += n
            if raw:
                out[key] = raw.decode("utf-8", "replace")
    except (struct.error, ValueError):
        return {"deadline_ms": None, "traceparent": None, "tenant": None,
                "tier": None}
    return out


def current_relay_meta() -> "bytes | None":
    """The calling context's deadline, traceparent, tenant and tier as a
    sidecar block, or None when nothing is bound (the frame then goes out
    without one)."""
    rem = remaining_s()
    tp = traceparent_header_value()
    tenant = current_tenant()
    tier = current_tier()
    if rem is None and tp is None and tenant is None and tier == "interactive":
        return None
    return pack_relay_meta(deadline_ms=None if rem is None else max(rem * 1e3, 1.0),
                           traceparent=tp, tenant=tenant, tier=tier)


class _UdsServerProtocol(asyncio.Protocol):
    """One accepted relay connection.  Requests on a connection are
    handled strictly in order (the client sends one at a time); a handler
    task per frame keeps a slow dispatch from blocking other
    CONNECTIONS, while the per-connection FIFO queue keeps responses in
    request order if a client ever does pipeline."""

    def __init__(self, engine, protocols: Optional[set] = None):
        self.engine = engine
        self.protocols = protocols
        self.buf = bytearray()
        self.transport: Optional[asyncio.Transport] = None
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.writer_task: Optional[asyncio.Task] = None
        self.closing = False
        self.paused = False
        self.close_after_drain = False

    def connection_made(self, transport):
        self.transport = transport
        if self.protocols is not None:
            self.protocols.add(self)
        self.writer_task = asyncio.get_running_loop().create_task(
            self._writer()
        )

    def connection_lost(self, exc):
        self.closing = True
        if self.protocols is not None:
            self.protocols.discard(self)
        if self.writer_task is not None:
            self.writer_task.cancel()
        # cancel handler tasks still queued behind the writer — their
        # client is gone; without this they run to completion unconsumed
        # (wasted engine work + "Task exception was never retrieved")
        while True:
            try:
                task = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            task.cancel()

    async def _writer(self):
        while True:
            task = await self.queue.get()
            if (
                self.paused
                and self.queue.qsize() < _RESUME_PENDING
                and self.transport is not None
                and not self.transport.is_closing()
            ):
                self.paused = False
                self.transport.resume_reading()
            try:
                status, body = await task
            except asyncio.CancelledError:
                raise
            except SeldonMessageError as e:
                status = e.http_code
                body = SeldonMessage.failure(
                    str(e), code=status
                ).to_json().encode()
            except Exception as e:  # unexpected: 500, keep serving
                status = _JSON_500
                body = SeldonMessage.failure(
                    str(e), code=_JSON_500
                ).to_json().encode()
            if self.transport is None or self.transport.is_closing():
                continue
            # one head write + one write per body part — the transport
            # coalesces into a single writev; no intermediate
            # concatenation copy.  A LIST body is the binary wire lane's
            # (header, device-readback payload) parts
            if isinstance(body, (list, tuple)):
                blen = sum(len(p) for p in body)
                self.transport.write(_RESP_HEAD.pack(blen, status))
                for p in body:
                    if p:
                        self.transport.write(p)
            else:
                self.transport.write(_RESP_HEAD.pack(len(body), status))
                if body:
                    self.transport.write(body)
            if self.close_after_drain and self.queue.empty():
                # the terminal 413 (and everything queued before it) is
                # out; now the connection can die
                self.transport.close()
                return

    def data_received(self, data):
        self.buf += data
        consumed = 0
        view = memoryview(self.buf)
        try:
            while not self.closing:
                remaining = len(self.buf) - consumed
                if remaining < _REQ_HEAD.size:
                    break
                length, op = _REQ_HEAD.unpack_from(view, consumed)
                if length > _MAX_FRAME:
                    # stop parsing, but the 413 rides the FIFO writer
                    # BEHIND any already-queued responses — writing it
                    # directly would let a pipelining client read it as
                    # the answer to an earlier, still-running request.
                    # The writer closes the transport once drained.
                    self.closing = True
                    self.close_after_drain = True
                    body = SeldonMessage.failure(
                        "frame too large", code=413
                    ).to_json().encode()

                    async def _reject(b=body):
                        return 413, b

                    task = asyncio.get_running_loop().create_task(
                        _reject()
                    )
                    task.add_done_callback(
                        lambda t: None if t.cancelled() else t.exception()
                    )
                    self.queue.put_nowait(task)
                    break
                if remaining < _REQ_HEAD.size + length:
                    break
                start = consumed + _REQ_HEAD.size
                # the payload is sliced as a view of the receive buffer
                # and decoded exactly once — the engine's predict_json
                # contract is str, and that decode is the lane's only
                # copy (binary ops take ONE bytes copy instead — no
                # base64, no JSON).  release() before the buffer trim
                # below: a live export would make the bytearray
                # unresizable.
                meta = None
                has_meta = bool(op & META_FLAG)
                op &= ~META_FLAG
                with view[start: start + length] as payload:
                    lo = 0
                    if has_meta:
                        try:
                            meta_len, off = _read_uvarint(payload, 0)
                            with payload[off:off + meta_len] as mv:
                                meta = unpack_relay_meta(mv)
                            lo = off + meta_len
                        except ValueError:
                            meta = None
                    with payload[lo:] as body:
                        if op in (OP_KVSTREAM, OP_WIRE):
                            data: "str | bytes" = bytes(body)
                        else:
                            data = str(body, "utf-8", "replace")
                self._dispatch(op, data, meta)
                consumed = start + length
        finally:
            view.release()
        if consumed:
            del self.buf[:consumed]

    def _dispatch(self, op: int, data, meta=None):
        task = asyncio.get_running_loop().create_task(
            self._handle(op, data, meta)
        )
        # the writer normally consumes the result; if it is cancelled
        # mid-await (client hung up) the in-flight handler finishes
        # detached — retrieve its exception so asyncio doesn't log
        # "Task exception was never retrieved" on every disconnect
        task.add_done_callback(
            lambda t: None if t.cancelled() else t.exception()
        )
        self.queue.put_nowait(task)
        if not self.paused and self.queue.qsize() >= _PAUSE_PENDING:
            self.paused = True
            self.transport.pause_reading()

    async def _handle(self, op: int, data, meta=None):
        if meta is not None:
            # the sidecar's deadline binds as the HTTP lane binds the
            # header (it can only tighten an inherited one), its trace
            # context, tenant and tier as those headers do
            dl = meta.get("deadline_ms")
            with maybe_deadline_scope(dl / 1e3 if dl else None), \
                    trace_scope(parse_traceparent(meta.get("traceparent"))), \
                    qos_scope(meta.get("tenant"), meta.get("tier")):
                return await self._handle(op, data, None)
        if op in (OP_PREDICT, OP_WIRE):
            RECORDER.record_lane_request("relay")
        if op == OP_PREDICT:
            text_out, status = await self.engine.predict_json(data)
            return status or 200, text_out.encode()
        if op == OP_FEEDBACK:
            fb = Feedback.from_json(data)
            ack = await self.engine.send_feedback(fb)
            ok = ack.status is None or ack.status.status == "SUCCESS"
            status = 200 if ok else (ack.status.code or 200)
            return status or 200, ack.to_json().encode()
        if op == OP_KVSTREAM:
            handler = getattr(self.engine, "kv_frame", None)
            if handler is None:
                return 503, b"engine does not accept KV handoffs"
            status, body = await handler(data)
            return status or 200, body
        if op == OP_WIRE:
            # binary tensor predict: bytes in, frame parts out.  Frame
            # errors surface typed through the writer's SeldonMessageError
            # catch (WireError 400, WireFrameTooLarge 413)
            handler = getattr(self.engine, "predict_wire", None)
            if handler is None or not wirelib.wire_enabled():
                return 415, b"binary wire lane unavailable"
            RECORDER.record_wire_request("relay", "binary")
            wirelib.account_copy(len(data))
            status, parts = await handler(data)
            return status or 200, parts
        if op == OP_TRACE:
            # the trace document of a replica that serves no HTTP lane
            handler = getattr(self.engine, "trace_json", None)
            if handler is None:
                return 404, b"engine serves no trace surface"
            return 200, handler(data).encode()
        if op == OP_PING:
            return 200, b"pong"
        return 400, SeldonMessage.failure(
            f"unknown relay op {op}", code=400
        ).to_json().encode()


class UdsEngineServer:
    """Owns the listening unix socket; ``await start()`` / ``await
    stop()``.  A stale socket file from a crashed predecessor is unlinked
    before binding (the conventional UDS idiom)."""

    def __init__(self, engine, path: str):
        self.engine = engine
        self.path = path
        self._server: Optional[asyncio.AbstractServer] = None
        self._protocols: set = set()

    async def start(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        loop = asyncio.get_running_loop()
        self._server = await loop.create_unix_server(
            lambda: _UdsServerProtocol(self.engine, self._protocols),
            path=self.path,
        )

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for proto in list(self._protocols):
            if proto.transport is not None:
                proto.transport.close()
        try:
            await asyncio.wait_for(self._server.wait_closed(), timeout=5.0)
        except asyncio.TimeoutError:
            pass
        self._server = None
        if self.path is None:  # a TCP server
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


async def serve_uds(engine, path: str) -> UdsEngineServer:
    server = UdsEngineServer(engine, path)
    await server.start()
    return server


class TcpRelayServer(UdsEngineServer):
    """The same framed relay protocol on a TCP port: the cross-host lane
    of the KV hand-off (a decode replica on another host shares no unix
    socket).  Everything above the transport is the unix server's."""

    def __init__(self, engine, host: str, port: int):
        super().__init__(engine, None)
        self.host = host
        self.port = port

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _UdsServerProtocol(self.engine, self._protocols), self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]


async def serve_relay_tcp(engine, host: str, port: int) -> TcpRelayServer:
    server = TcpRelayServer(engine, host, port)
    await server.start()
    return server


class UdsRelayClient:
    """Pooled relay client: up to ``pool`` persistent connections to one
    engine socket, each carrying one request at a time (acquire ->
    write frame -> read response -> release).  A connection that errors
    mid-call is dropped and the call fails typed; the next call dials a
    fresh one — connection establishment over UDS is microseconds, so no
    retry choreography is worth its complexity here (the gateway's
    breaker/retry machinery sits above this lane)."""

    def __init__(self, path: str, pool: int = 8):
        self.path = path
        self.pool = max(1, int(pool))
        self._idle: "asyncio.Queue" = asyncio.Queue()
        self._open = 0
        self._lock = asyncio.Lock()
        self.closed = False
        #: deployment identity on the ledger's relay-byte rows
        self.cost_deployment = ""

    async def _connect(self):
        return await asyncio.open_unix_connection(self.path)

    async def _acquire(self):
        while True:
            try:
                conn = self._idle.get_nowait()
            except asyncio.QueueEmpty:
                conn = None
            # None is the freed-capacity token a broken release leaves so
            # a waiter can dial fresh instead of sleeping forever
            if conn is not None:
                reader, writer = conn
                if writer.is_closing():
                    self._open -= 1
                    continue
                return conn
            async with self._lock:
                if self._open < self.pool:
                    self._open += 1
                    try:
                        return await self._connect()
                    except (OSError, asyncio.CancelledError):
                        # CancelledError: a deadline timeout landed mid-
                        # dial — the slot must go back or N timeouts
                        # exhaust the pool forever
                        self._open -= 1
                        self._idle.put_nowait(None)
                        raise
            # pool exhausted: wait for a release (a live connection, or a
            # None capacity token from a broken one)
            conn = await self._idle.get()
            if conn is None:
                continue
            reader, writer = conn
            if writer.is_closing():
                self._open -= 1
                self._idle.put_nowait(None)
                continue
            return conn

    def _release(self, conn, broken: bool = False) -> None:
        if broken or self.closed:
            self._open -= 1
            conn[1].close()
            # wake one pool waiter: capacity is free even though no
            # connection came back (without this, a caller blocked in
            # _acquire hangs forever once every held connection breaks)
            self._idle.put_nowait(None)
            return
        self._idle.put_nowait(conn)

    async def call(self, op: int, payload: bytes,
                   meta: "bytes | None" = None) -> "tuple[bytes, int]":
        """One framed round trip; returns ``(body, status)``.  ``meta``
        (pack_relay_meta) rides the sidecar: the op byte's high bit is
        set and the payload is prefixed with the varint-length metadata
        block.  None keeps the PR-8 wire bytes exactly."""
        if self.closed:
            raise ConnectionError("relay client closed")
        conn = await self._acquire()
        reader, writer = conn
        if meta:
            op |= META_FLAG
            prefix = _uvarint(len(meta)) + meta
            payload = prefix + payload
        if costledger_enabled():
            # tenant-attributed relay bytes; a call with no tenant bound
            # books under the anonymous one, so lane totals stay complete
            LEDGER.note_bytes(current_tenant() or "", self.cost_deployment, "relay",
                              len(payload))
        try:
            writer.write(_REQ_HEAD.pack(len(payload), op))
            if payload:
                writer.write(payload)
            await writer.drain()
            head = await reader.readexactly(_RESP_HEAD.size)
            length, status = _RESP_HEAD.unpack(head)
            body = await reader.readexactly(length) if length else b""
        except (OSError, asyncio.IncompleteReadError) as e:
            self._release(conn, broken=True)
            raise ConnectionError(f"uds relay {self.path}: {e}") from e
        except asyncio.CancelledError:
            # a deadline/timeout cancelled us mid-frame: the connection
            # has an orphaned request in flight — drop it, free the slot
            self._release(conn, broken=True)
            raise
        self._release(conn)
        return body, status

    async def predict(self, payload: str) -> "tuple[str, int]":
        body, status = await self.call(OP_PREDICT, payload.encode())
        return body.decode("utf-8", "replace"), status

    async def feedback(self, payload: str) -> "tuple[str, int]":
        body, status = await self.call(OP_FEEDBACK, payload.encode())
        return body.decode("utf-8", "replace"), status

    async def ping(self) -> bool:
        body, status = await self.call(OP_PING, b"")
        return status == 200 and body == b"pong"

    async def close(self) -> None:
        self.closed = True
        while True:
            try:
                conn = self._idle.get_nowait()
            except asyncio.QueueEmpty:
                break
            if conn is None:  # capacity token from a broken release
                continue
            self._open -= 1
            conn[1].close()


class TcpRelayClient(UdsRelayClient):
    """The pooled relay client over TCP: dial semantics aside, identical
    to the unix-socket client."""

    def __init__(self, host: str, port: int, pool: int = 8):
        super().__init__(f"tcp:{host}:{port}", pool=pool)
        self.host = host
        self.port = int(port)

    async def _connect(self):
        return await asyncio.open_connection(self.host, self.port)


def make_relay_client(spec: str, pool: int = 8) -> UdsRelayClient:
    """Relay client for a peer spec: ``uds:/path`` (or a bare path) dials
    the unix socket, ``tcp:host:port`` the TCP lane."""
    spec = spec.strip()
    if spec.startswith("tcp:"):
        host, _, port = spec[len("tcp:"):].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp relay spec {spec!r}")
        return TcpRelayClient(host, int(port), pool=pool)
    if spec.startswith("uds:"):
        spec = spec[len("uds:"):]
    if not spec:
        raise ValueError("empty relay peer spec")
    return UdsRelayClient(spec, pool=pool)
