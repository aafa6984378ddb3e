"""gRPC data plane — HTTP/2 + HPACK terminated in-framework; the port's
copy of ``seldon_core_tpu/runtime/grpcfast.py``, the reference's stdlib
lane (the engine's default ``ENGINE_GRPC_IMPL`` when no native plane is
up), so serving and calling gRPC needs no ``grpcio``.

  * server: ``FastGrpcServer`` speaks HTTP/2 (RFC 7540) + HPACK (RFC 7541,
    ``native/hpackcodec.py``) on an asyncio.Protocol and dispatches unary
    gRPC calls by ``:path``.  ``for_engine`` serves the Seldon service
    (Predict rides the engine's wire-bytes lane, ``predict_proto_wire``)
    and the Model/Router/Generic aliases through which an engine is a gRPC
    leaf; ``for_unit`` serves one unit's node services (the map of the
    reference's ``make_unit_grpc_server``).  Typed errors answer a FAILURE
    SeldonMessage (``protoconv``); an unknown path UNIMPLEMENTED.
  * client: ``FastGrpcChannel``, multiplexed unary calls over one
    connection (``GrpcCallError`` carries the status of a failed call).

A request's ``traceparent`` metadata becomes its handler's trace context
(the unit services each open a ``server`` span of the node's name in it),
its ``seldon-tenant`` / ``seldon-tier`` metadata its QoS identity
(``runtime/qos.py``), as the REST lane binds those headers; and
``FastGrpcChannel.call`` sends ``metadata`` pairs as request headers.

Scope (the reference's): unary calls, identity encoding, trailers-only
error responses; no streaming RPCs, no TLS.
"""

from __future__ import annotations

import asyncio
import contextvars
import struct
from typing import Awaitable, Callable, Dict, List, Optional, Sequence, Tuple

from seldon_core_tpu_torch.native.hpackcodec import (
    HpackDecoder,
    HpackError,
    encode_headers,
)
from seldon_core_tpu_torch.runtime.qos import bind_qos
from seldon_core_tpu_torch.utils.telemetry import RECORDER
from seldon_core_tpu_torch.utils.tracing import (
    TRACE_VAR,
    TRACER,
    current_trace_puid,
    parse_traceparent,
)

__all__ = ["FastGrpcServer", "FastGrpcChannel", "GrpcCallError", "GrpcAbort", "Unauthenticated",
           "serve_grpc_fast", "GRPC_STATUS_NAMES", "CALL_TOKEN"]

_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
_DATA = 0x0
_HEADERS = 0x1
_PRIORITY = 0x2
_RST_STREAM = 0x3
_SETTINGS = 0x4
_PUSH_PROMISE = 0x5
_PING = 0x6
_GOAWAY = 0x7
_WINDOW_UPDATE = 0x8
_CONTINUATION = 0x9

# flags
_F_END_STREAM = 0x1
_F_ACK = 0x1
_F_END_HEADERS = 0x4
_F_PADDED = 0x8
_F_PRIORITY = 0x20

_DEFAULT_WINDOW = 65535
_BIG_WINDOW = (1 << 31) - 1
_WINDOW_REPLENISH = 1 << 20  # send a connection WINDOW_UPDATE per MiB read
_MAX_MESSAGE = 256 * 1024 * 1024  # the reference's GRPC_MAX_MESSAGE

_SETTINGS_HEADER_TABLE_SIZE = 0x1
_SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
_SETTINGS_INITIAL_WINDOW_SIZE = 0x4
_SETTINGS_MAX_FRAME_SIZE = 0x5

# gRPC status codes used here
GRPC_OK = 0
GRPC_UNAUTHENTICATED = 16
GRPC_INTERNAL = 13
GRPC_UNIMPLEMENTED = 12
GRPC_RESOURCE_EXHAUSTED = 8

#: gRPC status code -> name, as ``grpc.StatusCode`` names them (the retry
#: policy's ``retryable_grpc`` reads names)
GRPC_STATUS_NAMES = {
    0: "OK", 1: "CANCELLED", 2: "UNKNOWN", 3: "INVALID_ARGUMENT", 4: "DEADLINE_EXCEEDED",
    5: "NOT_FOUND", 6: "ALREADY_EXISTS", 7: "PERMISSION_DENIED", 8: "RESOURCE_EXHAUSTED",
    9: "FAILED_PRECONDITION", 10: "ABORTED", 11: "OUT_OF_RANGE", 12: "UNIMPLEMENTED",
    13: "INTERNAL", 14: "UNAVAILABLE", 15: "DATA_LOSS", 16: "UNAUTHENTICATED",
}

Handler = Callable[[bytes], Awaitable[bytes]]


def _frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return struct.pack(
        ">I", len(payload)
    )[1:] + bytes((ftype, flags)) + struct.pack(">I", stream_id) + payload


def _settings_payload(pairs: List[Tuple[int, int]]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in pairs)


def _grpc_frame(message: bytes) -> bytes:
    """5-byte gRPC length-prefixed framing (uncompressed)."""
    return b"\x00" + struct.pack(">I", len(message)) + message


class _H2Endpoint(asyncio.Protocol):
    """Shared HTTP/2 connection machinery (frame parse, HPACK state, flow
    control).  Subclasses handle HEADERS/DATA events."""

    is_server = True

    def __init__(self):
        self.buf = bytearray()
        self.transport: Optional[asyncio.Transport] = None
        self.decoder = HpackDecoder()
        self.preface_seen = not self.is_server
        self.recv_since_update = 0
        self.conn_send_window = _DEFAULT_WINDOW
        self.peer_initial_window = _DEFAULT_WINDOW
        self.peer_max_frame = 16384
        self.stream_send_windows: Dict[int, int] = {}
        # in-flight outbound stream payloads (flow-control partial sends):
        # sid -> {buf, off, trailer, end}
        self._tx: Dict[int, dict] = {}
        self._header_accum: Optional[Tuple[int, int, bytearray]] = None
        self.closed = asyncio.get_running_loop().create_future()

    # -- lifecycle -----------------------------------------------------------

    def connection_made(self, transport):
        self.transport = transport
        transport.set_write_buffer_limits(high=1 << 22)
        hello = b"" if self.is_server else _PREFACE
        hello += _frame(
            _SETTINGS, 0, 0,
            _settings_payload([
                (_SETTINGS_INITIAL_WINDOW_SIZE, _BIG_WINDOW),
                (_SETTINGS_MAX_CONCURRENT_STREAMS, 1 << 20),
            ]),
        )
        # open the connection-level receive window wide: unlike stream
        # windows it starts at 65535 regardless of SETTINGS
        hello += _frame(
            _WINDOW_UPDATE, 0, 0,
            struct.pack(">I", _BIG_WINDOW - _DEFAULT_WINDOW),
        )
        transport.write(hello)

    def connection_lost(self, exc):
        if not self.closed.done():
            self.closed.set_result(None)
        self._on_close(exc)

    def _on_close(self, exc):
        pass

    def _fatal(self, msg: str):
        if self.transport is not None and not self.transport.is_closing():
            self.transport.write(
                _frame(_GOAWAY, 0, 0, struct.pack(">II", 0, 2) + msg.encode())
            )
            self.transport.close()

    # -- frame parsing -------------------------------------------------------

    def data_received(self, data):
        self.buf += data
        consumed = 0
        if not self.preface_seen:
            if len(self.buf) < len(_PREFACE):
                return
            if bytes(self.buf[: len(_PREFACE)]) != _PREFACE:
                self._fatal("bad connection preface")
                return
            consumed = len(_PREFACE)
            self.preface_seen = True
        try:
            while len(self.buf) - consumed >= 9:
                ln = int.from_bytes(self.buf[consumed: consumed + 3], "big")
                if len(self.buf) - consumed < 9 + ln:
                    break
                ftype = self.buf[consumed + 3]
                flags = self.buf[consumed + 4]
                sid = (
                    int.from_bytes(
                        self.buf[consumed + 5: consumed + 9], "big"
                    ) & 0x7FFFFFFF
                )
                payload = bytes(self.buf[consumed + 9: consumed + 9 + ln])
                consumed += 9 + ln
                self._on_frame(ftype, flags, sid, payload)
        except HpackError as e:
            self._fatal(f"hpack: {e}")
        finally:
            if consumed:
                del self.buf[:consumed]

    def _on_frame(self, ftype, flags, sid, payload):
        if ftype == _SETTINGS:
            if not flags & _F_ACK:
                for off in range(0, len(payload) - 5, 6):
                    k, v = struct.unpack_from(">HI", payload, off)
                    if k == _SETTINGS_INITIAL_WINDOW_SIZE:
                        delta = v - self.peer_initial_window
                        self.peer_initial_window = v
                        for s in self.stream_send_windows:
                            self.stream_send_windows[s] += delta
                    elif k == _SETTINGS_MAX_FRAME_SIZE:
                        self.peer_max_frame = v
                    # HEADER_TABLE_SIZE announces the PEER's decode-table
                    # limit (RFC 7540 §6.5.2) — it constrains encoders, and
                    # ours never references dynamic entries, so ignore it;
                    # our decoder's table is sized by OUR advertised default
                self.transport.write(_frame(_SETTINGS, _F_ACK, 0, b""))
                # RFC 7540 §6.9.2: a SETTINGS raising INITIAL_WINDOW_SIZE
                # can make stalled streams sendable — resume them
                self._drain_pending()
        elif ftype == _WINDOW_UPDATE:
            (inc,) = struct.unpack(">I", payload)
            inc &= 0x7FFFFFFF
            if sid == 0:
                self.conn_send_window += inc
            elif sid in self.stream_send_windows or sid in self._tx:
                # only track windows for live streams (a per-finished-stream
                # entry would leak one dict slot per call)
                self.stream_send_windows[sid] = (
                    self.stream_send_windows.get(
                        sid, self.peer_initial_window
                    ) + inc
                )
            self._drain_pending()
        elif ftype == _PING:
            if not flags & _F_ACK:
                self.transport.write(_frame(_PING, _F_ACK, 0, payload))
        elif ftype == _HEADERS:
            block = payload
            pad = 0
            if flags & _F_PADDED:
                pad = block[0]
                block = block[1:]
            if flags & _F_PRIORITY:
                block = block[5:]
            if pad:
                block = block[:-pad]
            if flags & _F_END_HEADERS:
                self._on_headers(
                    sid, self.decoder.decode(block),
                    bool(flags & _F_END_STREAM),
                )
            else:
                self._header_accum = (
                    sid, flags & _F_END_STREAM, bytearray(block)
                )
        elif ftype == _CONTINUATION:
            if self._header_accum is None or self._header_accum[0] != sid:
                self._fatal("unexpected CONTINUATION")
                return
            self._header_accum[2].extend(payload)
            if flags & _F_END_HEADERS:
                sid0, es, blk = self._header_accum
                self._header_accum = None
                self._on_headers(
                    sid0, self.decoder.decode(bytes(blk)), bool(es)
                )
        elif ftype == _DATA:
            body = payload
            if flags & _F_PADDED:
                pad = body[0]
                body = body[1: len(body) - pad]
            self._on_data(sid, body, bool(flags & _F_END_STREAM))
            self.recv_since_update += len(payload)
            if self.recv_since_update >= _WINDOW_REPLENISH:
                self.transport.write(
                    _frame(
                        _WINDOW_UPDATE, 0, 0,
                        struct.pack(">I", self.recv_since_update),
                    )
                )
                self.recv_since_update = 0
        elif ftype == _RST_STREAM:
            self._on_rst(sid)
        elif ftype == _GOAWAY:
            self.transport.close()
        # PRIORITY / PUSH_PROMISE / unknown: ignored

    # -- flow-controlled sending --------------------------------------------

    def _send_stream(self, sid: int, framed: bytes, trailer: bytes = b"",
                     end_on_data: bool = False):
        """Queue a stream's outbound payload and send as much as the flow
        windows allow; the rest resumes on WINDOW_UPDATE.  ``trailer`` is a
        pre-built frame (server trailers HEADERS) written after the last
        DATA byte; ``end_on_data`` puts END_STREAM on the final DATA frame
        (client requests)."""
        self._tx[sid] = {
            "buf": framed, "off": 0, "trailer": trailer, "end": end_on_data,
        }
        self._pump(sid)

    def _pump(self, sid: int):
        tx = self._tx.get(sid)
        if tx is None or self.transport is None or self.transport.is_closing():
            return
        buf = tx["buf"]
        out = bytearray()
        while tx["off"] < len(buf):
            window = min(
                self.conn_send_window,
                self.stream_send_windows.get(sid, self.peer_initial_window),
            )
            n = min(len(buf) - tx["off"], window, self.peer_max_frame)
            if n <= 0:
                if out:
                    self.transport.write(bytes(out))
                return  # stalled on flow control; WINDOW_UPDATE resumes
            chunk = buf[tx["off"]: tx["off"] + n]
            tx["off"] += n
            last = tx["off"] >= len(buf)
            flags = _F_END_STREAM if (last and tx["end"]) else 0
            out += _frame(_DATA, flags, sid, chunk)
            self.conn_send_window -= n
            self.stream_send_windows[sid] = (
                self.stream_send_windows.get(sid, self.peer_initial_window)
                - n
            )
        if tx["end"] and not buf:  # empty payload still needs END_STREAM
            out += _frame(_DATA, _F_END_STREAM, sid, b"")
        out += tx["trailer"]
        if out:
            self.transport.write(bytes(out))
        del self._tx[sid]
        self.stream_send_windows.pop(sid, None)  # stream done: no leak

    def _drain_pending(self):
        for sid in list(self._tx):
            self._pump(sid)

    def _abort_stream_tx(self, sid: int):
        self._tx.pop(sid, None)
        self.stream_send_windows.pop(sid, None)

    # -- subclass events -----------------------------------------------------

    def _on_headers(self, sid, headers, end_stream):
        raise NotImplementedError

    def _on_data(self, sid, body, end_stream):
        raise NotImplementedError

    def _on_rst(self, sid):
        pass


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _ServerConnection(_H2Endpoint):
    is_server = True

    def __init__(self, handlers: Dict[bytes, Handler], protocols: set):
        super().__init__()
        self.handlers = handlers
        self.protocols = protocols
        self.streams: Dict[int, Tuple[bytes, bytearray]] = {}  # sid -> (path, body)
        self._tasks: set = set()  # strong refs: create_task alone can be GC'd
        # response HEADERS + OK trailers are constant: build once per conn
        self._resp_headers = encode_headers(
            [(b":status", b"200"), (b"content-type", b"application/grpc")]
        )
        self._ok_trailers = encode_headers(
            [(b"grpc-status", b"0"), (b"grpc-message", b"")]
        )

    def connection_made(self, transport):
        super().connection_made(transport)
        self.protocols.add(self)

    def _on_close(self, exc):
        self.protocols.discard(self)

    def _on_headers(self, sid, headers, end_stream):
        # the call's tenant, tier and bearer token
        path, traceparent, meta = b"", None, [None, None, None]
        for name, value in headers:
            if name == b":path":
                path = value
            elif name == b"traceparent":
                traceparent = value.decode("latin-1")
            elif name == b"seldon-tenant":
                meta[0] = value.decode("latin-1").strip()
            elif name == b"seldon-tier":
                meta[1] = value.decode("latin-1").strip()
            elif name == b"oauth_token":
                meta[2] = value.decode("latin-1").strip()
            elif name == b"authorization" and meta[2] is None:
                auth = value.decode("latin-1").strip()
                if auth.startswith("Bearer "):
                    meta[2] = auth[len("Bearer "):]
        self.streams[sid] = (path, bytearray(), traceparent, meta)
        if end_stream:  # unary call with no body: invalid -> trailers-only
            self._trailers_only(sid, GRPC_INTERNAL, b"missing request body")
            self.streams.pop(sid, None)

    def _on_data(self, sid, body, end_stream):
        entry = self.streams.get(sid)
        if entry is None:
            return
        entry[1].extend(body)
        if len(entry[1]) > _MAX_MESSAGE + 5:
            self._trailers_only(
                sid, GRPC_RESOURCE_EXHAUSTED, b"message too large"
            )
            self.streams.pop(sid, None)
            return
        if end_stream:
            path, buf, traceparent, meta = self.streams.pop(sid)
            handler = self.handlers.get(path)
            if handler is None:
                self._trailers_only(
                    sid, GRPC_UNIMPLEMENTED,
                    b"unknown method " + path,
                )
                return
            if len(buf) < 5 or buf[0] != 0:
                self._trailers_only(
                    sid, GRPC_INTERNAL, b"compressed or malformed grpc frame"
                )
                return
            (mlen,) = struct.unpack_from(">I", buf, 1)
            if mlen != len(buf) - 5:
                self._trailers_only(
                    sid, GRPC_INTERNAL, b"grpc frame length mismatch"
                )
                return
            task = asyncio.get_running_loop().create_task(
                self._run(sid, handler, bytes(buf[5:])),
                context=call_context(traceparent, *meta))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    def _on_rst(self, sid):
        self.streams.pop(sid, None)
        self._abort_stream_tx(sid)

    async def _run(self, sid: int, handler: Handler, message: bytes):
        try:
            response = await handler(message)
        except GrpcAbort as e:
            self._trailers_only(sid, e.status, e.grpc_message.encode())
            return
        except NotImplementedError as e:
            self._trailers_only(sid, GRPC_UNIMPLEMENTED, str(e).encode())
            return
        except Exception as e:  # handler bug: surface as INTERNAL
            self._trailers_only(sid, GRPC_INTERNAL, str(e).encode())
            return
        if self.transport is None or self.transport.is_closing():
            return
        head = _frame(_HEADERS, _F_END_HEADERS, sid, self._resp_headers)
        trailer = _frame(
            _HEADERS, _F_END_HEADERS | _F_END_STREAM, sid, self._ok_trailers
        )
        self.transport.write(head)
        self._send_stream(sid, _grpc_frame(response), trailer=trailer)

    def _trailers_only(self, sid: int, status: int, message: bytes):
        if self.transport is None or self.transport.is_closing():
            return
        block = encode_headers([
            (b":status", b"200"),
            (b"content-type", b"application/grpc"),
            (b"grpc-status", str(status).encode()),
            (b"grpc-message", message[:1024]),
        ])
        self.transport.write(
            _frame(_HEADERS, _F_END_HEADERS | _F_END_STREAM, sid, block)
        )


#: a call's bearer token: its ``oauth_token`` metadata (the reference
#: gateway's), else the token of an ``authorization: Bearer`` entry
CALL_TOKEN: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "seldon_torch_grpc_token", default=None)


def call_context(traceparent: Optional[str], tenant: Optional[str],
                 tier: Optional[str], token: Optional[str] = None) -> contextvars.Context:
    """The context a call's handler runs in: the caller's trace context
    (the metadata's ``traceparent``: the handler's spans join the caller's
    tree), the ``seldon-tenant`` / ``seldon-tier`` QoS identity and the
    call's bearer token (``CALL_TOKEN``)."""
    ctx = contextvars.copy_context()
    if token is not None:
        ctx.run(CALL_TOKEN.set, token)
    parent = parse_traceparent(traceparent)
    if parent is not None:
        ctx.run(TRACE_VAR.set, parent)
    if tenant is not None or tier is not None:
        ctx.run(bind_qos, tenant, tier)
    return ctx


class FastGrpcServer:
    """Engine-facing server: routes the Seldon service's unary methods.

    ``handlers`` maps gRPC paths to ``async (request bytes) -> response
    bytes``; ``for_engine`` wires the standard Seldon surface."""

    def __init__(self, handlers: Dict[bytes, Handler]):
        self.handlers = handlers
        self._server: Optional[asyncio.AbstractServer] = None
        self._protocols: set = set()
        self.port: Optional[int] = None

    @classmethod
    def for_engine(cls, engine) -> "FastGrpcServer":
        """The Seldon service of an engine: Predict and SendFeedback, plus
        the Model/Router/Generic aliases through which the engine is a
        leaf of a larger cross-process graph."""
        from seldon_core_tpu_torch import protoconv

        async def predict(wire: bytes) -> bytes:
            RECORDER.record_lane_request("grpc")
            return await _failure_on_error(engine.predict_proto_wire(wire))

        async def send_feedback(wire: bytes) -> bytes:
            async def run():
                ack = await engine.send_feedback(protoconv.feedback_from_proto(wire))
                return protoconv.msg_to_proto(ack)

            return await _failure_on_error(run())

        return cls({
            b"/seldon.protos.Seldon/Predict": predict,
            b"/seldon.protos.Seldon/SendFeedback": send_feedback,
            b"/seldon.protos.Model/Predict": predict,
            b"/seldon.protos.Router/SendFeedback": send_feedback,
            b"/seldon.protos.Generic/SendFeedback": send_feedback,
        })

    @classmethod
    def for_gateway(cls, gateway) -> "FastGrpcServer":
        """The gateway's Seldon service (``make_gateway_grpc_server`` of the
        JAX package's ``runtime/grpc_server.py``): Predict and SendFeedback
        through ``gateway.predict`` / ``gateway.send_feedback`` with the
        call's bearer token; a refused token (``Unauthenticated``, which
        the gateway's ``AuthError`` is) ends the call UNAUTHENTICATED, a
        typed error answers a FAILURE message."""
        from seldon_core_tpu_torch import protoconv

        def unary(call, decode):
            async def handle(wire: bytes) -> bytes:
                async def run():
                    return protoconv.msg_to_proto(await call(decode(wire), CALL_TOKEN.get()))

                return await _failure_on_error(run())

            return handle

        return cls({
            b"/seldon.protos.Seldon/Predict": unary(gateway.predict, protoconv.msg_from_proto),
            b"/seldon.protos.Seldon/SendFeedback": unary(gateway.send_feedback,
                                                         protoconv.feedback_from_proto),
        })

    @classmethod
    def for_unit(cls, runtime) -> "FastGrpcServer":
        """One unit's node services (the reference's
        ``make_unit_grpc_server``): Generic (TransformInput,
        TransformOutput, Route, Aggregate, SendFeedback), Model (Predict),
        Router (Route, SendFeedback), Transformer, OutputTransformer and
        Combiner (their one method each).  Route answers the branch as a
        1x1 tensor.  A runtime with a thread pool decodes and encodes the
        messages there (a device payload is read back there), never on the
        loop."""
        import numpy as np

        from seldon_core_tpu_torch import protoconv
        from seldon_core_tpu_torch.messages import SeldonMessage

        loop_pool = getattr(runtime, "executor", None)

        async def off_loop(fn, *args):
            return await asyncio.get_running_loop().run_in_executor(loop_pool, fn, *args)

        name = runtime.node.name

        def server_span(puid: str, method: str):
            # the call's server span, in the caller's trace (grpc_server.py
            # _wrap there)
            return TRACER.span(puid or current_trace_puid(), name, kind="server",
                               method=method)

        def message(method):
            async def handle(wire: bytes) -> bytes:
                async def run():
                    msg = await off_loop(protoconv.msg_from_proto, wire)
                    with server_span(msg.meta.puid, method):
                        out = await getattr(runtime, method)(msg)
                    return await off_loop(protoconv.msg_to_proto, out)

                return await _failure_on_error(run())

            return handle

        async def route(wire: bytes) -> bytes:
            async def run():
                msg = await off_loop(protoconv.msg_from_proto, wire)
                with server_span(msg.meta.puid, "route") as sp:
                    branch = await runtime.route(msg)
                    if isinstance(sp, dict):
                        sp["branch"] = branch
                return protoconv.msg_to_proto(
                    msg.with_array(np.array([[branch]], dtype=np.float64)))

            return await _failure_on_error(run())

        async def aggregate(wire: bytes) -> bytes:
            async def run():
                msgs = await off_loop(protoconv.msg_list_from_proto, wire)
                puid = msgs.messages[0].meta.puid if msgs.messages else ""
                with server_span(puid, "aggregate"):
                    out = await runtime.aggregate(msgs.messages)
                return await off_loop(protoconv.msg_to_proto, out)

            return await _failure_on_error(run())

        async def send_feedback(wire: bytes) -> bytes:
            async def run():
                fb = await off_loop(protoconv.feedback_from_proto, wire)
                routing = fb.response.meta.routing if fb.response is not None else {}
                with server_span(fb.puid(), "send_feedback"):
                    await runtime.send_feedback(fb, int(routing.get(runtime.node.name, -1)))
                return protoconv.msg_to_proto(SeldonMessage())

            return await _failure_on_error(run())

        services = {
            "Generic": {"TransformInput": message("transform_input"),
                        "TransformOutput": message("transform_output"),
                        "Route": route, "Aggregate": aggregate, "SendFeedback": send_feedback},
            "Model": {"Predict": message("predict")},
            "Router": {"Route": route, "SendFeedback": send_feedback},
            "Transformer": {"TransformInput": message("transform_input")},
            "OutputTransformer": {"TransformOutput": message("transform_output")},
            "Combiner": {"Aggregate": aggregate},
        }
        return cls({f"/seldon.protos.{svc}/{name}".encode(): fn
                    for svc, methods in services.items() for name, fn in methods.items()})

    async def start(self, host: str, port: int) -> None:
        """Listen on ``host:port``; ``port`` 0 picks a free one, and
        ``self.port`` is the bound port."""
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _ServerConnection(self.handlers, self._protocols),
            host, port, backlog=4096,
        )
        self.port = self._server.sockets[0].getsockname()[1]

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


async def serve_grpc_fast(engine, host: str, port: int) -> FastGrpcServer:
    server = FastGrpcServer.for_engine(engine)
    await server.start(host, port)
    return server


async def _failure_on_error(call: Awaitable[bytes]) -> bytes:
    """Await a handler's bytes; a typed framework error (an undecodable
    body among them) answers a FAILURE SeldonMessage with its code, as the
    reference's stock lane wraps its handlers (``grpc_server._wrap``)."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.graph.spec import GraphSpecError
    from seldon_core_tpu_torch.messages import SeldonMessage, SeldonMessageError

    try:
        return await call
    except (SeldonMessageError, GraphSpecError) as e:
        return protoconv.msg_to_proto(
            SeldonMessage.failure(str(e), code=getattr(e, "http_code", 400)))


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class GrpcAbort(Exception):
    """Raised by a handler to end its call with ``status`` and
    ``grpc_message`` (a trailers-only response)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.grpc_message = message


class Unauthenticated(GrpcAbort):
    """A refused credential: ends a call UNAUTHENTICATED."""

    def __init__(self, message: str):
        super().__init__(GRPC_UNAUTHENTICATED, message)


class GrpcCallError(Exception):
    """A call that ended with a non-OK ``grpc-status`` (or lost its
    connection: 14, UNAVAILABLE)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"grpc-status {status}: {message}")
        self.status = status
        self.grpc_message = message

    @property
    def code_name(self) -> str:
        return GRPC_STATUS_NAMES.get(self.status, "UNKNOWN")


class _ClientConnection(_H2Endpoint):
    is_server = False

    def __init__(self, authority: bytes):
        super().__init__()
        self.authority = authority
        self.next_stream = 1
        self.calls: Dict[int, dict] = {}

    def _on_close(self, exc):
        err = GrpcCallError(14, "connection lost")  # UNAVAILABLE
        for call in self.calls.values():
            if not call["future"].done():
                call["future"].set_exception(err)
        self.calls.clear()

    def start_call(self, path: bytes, message: bytes,
                   metadata: Sequence[Tuple[bytes, bytes]] = ()) -> asyncio.Future:
        if self.transport is None or self.transport.is_closing():
            # fail fast: a write on a closed transport is a silent no-op and
            # the future would never resolve
            raise GrpcCallError(14, "connection closed")
        sid = self.next_stream
        self.next_stream += 2
        fut = asyncio.get_running_loop().create_future()
        self.calls[sid] = {"future": fut, "body": bytearray(), "status": None}
        block = encode_headers([
            (b":method", b"POST"),
            (b":scheme", b"http"),
            (b":path", path),
            (b":authority", self.authority),
            (b"content-type", b"application/grpc"),
            (b"te", b"trailers"),
            *metadata,
        ])
        framed = _grpc_frame(message)
        self.transport.write(_frame(_HEADERS, _F_END_HEADERS, sid, block))
        self._send_stream(sid, framed, end_on_data=True)
        return fut

    def _on_headers(self, sid, headers, end_stream):
        call = self.calls.get(sid)
        if call is None:
            return
        for name, value in headers:
            if name == b"grpc-status":
                call["status"] = int(value)
            elif name == b"grpc-message":
                call["message"] = value.decode("utf-8", "replace")
        if end_stream:
            self._finish(sid)

    def _on_data(self, sid, body, end_stream):
        call = self.calls.get(sid)
        if call is None:
            return
        call["body"].extend(body)
        if end_stream:  # servers normally end on trailers, but be lenient
            self._finish(sid)

    def _on_rst(self, sid):
        self._abort_stream_tx(sid)
        call = self.calls.pop(sid, None)
        if call is not None and not call["future"].done():
            call["future"].set_exception(GrpcCallError(13, "stream reset"))

    def _finish(self, sid):
        self._abort_stream_tx(sid)
        call = self.calls.pop(sid, None)
        if call is None or call["future"].done():
            return
        status = call["status"]
        if status not in (None, 0):
            call["future"].set_exception(
                GrpcCallError(status, call.get("message", ""))
            )
            return
        buf = call["body"]
        if len(buf) < 5:
            call["future"].set_exception(
                GrpcCallError(13, "short grpc frame")
            )
            return
        call["future"].set_result(bytes(buf[5:]))


class FastGrpcChannel:
    """Minimal multiplexing unary client: ``await channel.call(path,
    message_bytes) -> response_bytes``.  The channel owns its socket, so
    ``close_nowait`` can close it from any thread, or after its loop has
    stopped."""

    def __init__(self):
        self._conn: Optional[_ClientConnection] = None
        self._sock = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    async def connect(self, host: str, port: int) -> "FastGrpcChannel":
        import socket

        loop = asyncio.get_running_loop()
        infos = await loop.getaddrinfo(host, port, type=socket.SOCK_STREAM)
        err: Optional[OSError] = None
        for family, type_, proto, _, addr in infos:
            sock = socket.socket(family, type_, proto)
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                await loop.sock_connect(sock, addr)
            except OSError as e:
                sock.close()
                err = e
                continue
            except BaseException:
                sock.close()
                raise
            _, self._conn = await loop.create_connection(
                lambda: _ClientConnection(f"{host}:{port}".encode()), sock=sock)
            self._sock, self.loop = sock, loop
            return self
        raise err or ConnectionError(f"no address for {host}:{port}")

    @property
    def is_open(self) -> bool:
        return (self._conn is not None and self._conn.transport is not None
                and not self._conn.transport.is_closing())

    async def call(self, path: bytes, message: bytes,
                   metadata: Sequence[Tuple[bytes, bytes]] = ()) -> bytes:
        """One unary call; ``metadata`` (lower-case name, value) pairs ride
        the request headers (a ``traceparent``)."""
        if self._conn is None:
            raise GrpcCallError(14, "channel not connected")
        return await self._conn.start_call(path, message, metadata)

    async def close(self) -> None:
        if self._conn is not None and self._conn.transport is not None:
            self._conn.transport.close()
            await self._conn.closed

    def close_nowait(self) -> None:
        """Close the connection without awaiting: on its loop's thread, or
        from another thread while that loop runs, the transport closes
        there; once the loop has stopped, the socket is closed here."""
        conn, loop = self._conn, self.loop
        if conn is None or conn.transport is None or loop is None:
            return
        if loop.is_running():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is loop:
                conn.transport.close()
            else:
                loop.call_soon_threadsafe(conn.transport.close)
            return
        try:
            conn.transport.close()  # drops the socket from the loop's selector
        except RuntimeError:
            pass  # the loop is closed: nothing to unregister
        self._sock.close()
