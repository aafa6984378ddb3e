"""HPACK (RFC 7541) header compression codec — the port's copy of
``seldon_core_tpu/native/hpackcodec.py``, pure Python, no deps.

Backs the port's gRPC lane (``runtime/grpcfast.py``), which terminates
HTTP/2 + HPACK itself as the reference's stdlib lane does, so serving gRPC
needs no ``grpcio``.

Decode implements the full spec surface a real gRPC peer exercises:
indexed fields, all literal forms, dynamic-table inserts/evictions/size
updates, and Huffman-coded strings (nibble-FSM decoder built at import
from the spec table).  Encode stays deliberately simple — exact static
matches as indexed fields, everything else literal-without-indexing,
never Huffman — which any conformant peer must accept and which keeps the
encoder stateless (no dynamic entries referenced, so peers never need our
table state).

HUFFMAN_CODES / HUFFMAN_LENGTHS / STATIC_TABLE are the constants from RFC
7541 Appendix B and Appendix A verbatim (spec data, not creative code).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["HpackDecoder", "encode_headers", "HpackError"]


class HpackError(Exception):
    """Malformed header block (connection-fatal per RFC 7541)."""


HUFFMAN_CODES = [8184, 8388568, 268435426, 268435427, 268435428, 268435429, 268435430, 268435431, 268435432, 16777194, 1073741820, 268435433, 268435434, 1073741821, 268435435, 268435436, 268435437, 268435438, 268435439, 268435440, 268435441, 268435442, 1073741822, 268435443, 268435444, 268435445, 268435446, 268435447, 268435448, 268435449, 268435450, 268435451, 20, 1016, 1017, 4090, 8185, 21, 248, 2042, 1018, 1019, 249, 2043, 250, 22, 23, 24, 0, 1, 2, 25, 26, 27, 28, 29, 30, 31, 92, 251, 32764, 32, 4091, 1020, 8186, 33, 93, 94, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113, 114, 252, 115, 253, 8187, 524272, 8188, 16380, 34, 32765, 3, 35, 4, 36, 5, 37, 38, 39, 6, 116, 117, 40, 41, 42, 7, 43, 118, 44, 8, 9, 45, 119, 120, 121, 122, 123, 32766, 2044, 16381, 8189, 268435452, 1048550, 4194258, 1048551, 1048552, 4194259, 4194260, 4194261, 8388569, 4194262, 8388570, 8388571, 8388572, 8388573, 8388574, 16777195, 8388575, 16777196, 16777197, 4194263, 8388576, 16777198, 8388577, 8388578, 8388579, 8388580, 2097116, 4194264, 8388581, 4194265, 8388582, 8388583, 16777199, 4194266, 2097117, 1048553, 4194267, 4194268, 8388584, 8388585, 2097118, 8388586, 4194269, 4194270, 16777200, 2097119, 4194271, 8388587, 8388588, 2097120, 2097121, 4194272, 2097122, 8388589, 4194273, 8388590, 8388591, 1048554, 4194274, 4194275, 4194276, 8388592, 4194277, 4194278, 8388593, 67108832, 67108833, 1048555, 524273, 4194279, 8388594, 4194280, 33554412, 67108834, 67108835, 67108836, 134217694, 134217695, 67108837, 16777201, 33554413, 524274, 2097123, 67108838, 134217696, 134217697, 67108839, 134217698, 16777202, 2097124, 2097125, 67108840, 67108841, 268435453, 134217699, 134217700, 134217701, 1048556, 16777203, 1048557, 2097126, 4194281, 2097127, 2097128, 8388595, 4194282, 4194283, 33554414, 33554415, 16777204, 16777205, 67108842, 8388596, 67108843, 134217702, 67108844, 67108845, 134217703, 134217704, 134217705, 134217706, 134217707, 268435454, 134217708, 134217709, 134217710, 134217711, 134217712, 67108846, 1073741823]
HUFFMAN_LENGTHS = [13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28, 6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10, 13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6, 15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5, 6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28, 20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23, 24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24, 22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23, 21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23, 26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25, 19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27, 20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23, 26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26, 30]
STATIC_TABLE = [(b':authority', b''), (b':method', b'GET'), (b':method', b'POST'), (b':path', b'/'), (b':path', b'/index.html'), (b':scheme', b'http'), (b':scheme', b'https'), (b':status', b'200'), (b':status', b'204'), (b':status', b'206'), (b':status', b'304'), (b':status', b'400'), (b':status', b'404'), (b':status', b'500'), (b'accept-charset', b''), (b'accept-encoding', b'gzip, deflate'), (b'accept-language', b''), (b'accept-ranges', b''), (b'accept', b''), (b'access-control-allow-origin', b''), (b'age', b''), (b'allow', b''), (b'authorization', b''), (b'cache-control', b''), (b'content-disposition', b''), (b'content-encoding', b''), (b'content-language', b''), (b'content-length', b''), (b'content-location', b''), (b'content-range', b''), (b'content-type', b''), (b'cookie', b''), (b'date', b''), (b'etag', b''), (b'expect', b''), (b'expires', b''), (b'from', b''), (b'host', b''), (b'if-match', b''), (b'if-modified-since', b''), (b'if-none-match', b''), (b'if-range', b''), (b'if-unmodified-since', b''), (b'last-modified', b''), (b'link', b''), (b'location', b''), (b'max-forwards', b''), (b'proxy-authenticate', b''), (b'proxy-authorization', b''), (b'range', b''), (b'referer', b''), (b'refresh', b''), (b'retry-after', b''), (b'server', b''), (b'set-cookie', b''), (b'strict-transport-security', b''), (b'transfer-encoding', b''), (b'user-agent', b''), (b'vary', b''), (b'via', b''), (b'www-authenticate', b'')]


_STATIC_MAP = {pair: i + 1 for i, pair in enumerate(STATIC_TABLE)}
_EOS = 256


def _build_fsm():
    """Nibble-stepped Huffman decode FSM.

    Trie nodes: [zero_child, one_child, symbol].  FSM state = trie node id;
    transitions[state * 16 + nibble] = (next_state, emitted, ok) where a
    symbol hit mid-walk emits and resets to the root.  A state is a valid
    END state iff its path from the root is all 1-bits (EOS prefix = legal
    padding).
    """
    nodes = [[None, None, None]]  # root

    def insert(code, length, sym):
        n = 0
        for i in range(length - 1, -1, -1):
            bit = (code >> i) & 1
            if nodes[n][bit] is None:
                nodes.append([None, None, None])
                nodes[n][bit] = len(nodes) - 1
            n = nodes[n][bit]
        nodes[n][2] = sym

    for sym, (code, length) in enumerate(zip(HUFFMAN_CODES, HUFFMAN_LENGTHS)):
        insert(code, length, sym)

    # all-ones path marking (valid padding end states)
    accept = [False] * len(nodes)
    n = 0
    accept[0] = True
    while True:
        n = nodes[n][1]
        if n is None or nodes[n][2] is not None:
            break
        accept[n] = True

    transitions = []
    for state in range(len(nodes)):
        for nibble in range(16):
            n, out, ok = state, [], True
            for i in (3, 2, 1, 0):
                bit = (nibble >> i) & 1
                nxt = nodes[n][bit]
                if nxt is None:
                    ok = False
                    break
                sym = nodes[nxt][2]
                if sym is not None:
                    if sym == _EOS:
                        ok = False
                        break
                    out.append(sym)
                    n = 0
                else:
                    n = nxt
            transitions.append((n, bytes(out), ok))
    return transitions, accept


_FSM, _FSM_ACCEPT = _build_fsm()


def huffman_decode(data: bytes) -> bytes:
    state = 0
    out = []
    fsm = _FSM
    for b in data:
        nxt, emitted, ok = fsm[state * 16 + (b >> 4)]
        if not ok:
            raise HpackError("bad huffman sequence")
        if emitted:
            out.append(emitted)
        nxt, emitted, ok = fsm[nxt * 16 + (b & 0x0F)]
        if not ok:
            raise HpackError("bad huffman sequence")
        if emitted:
            out.append(emitted)
        state = nxt
    if not _FSM_ACCEPT[state]:
        raise HpackError("bad huffman padding")
    return b"".join(out)


def _decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    mask = (1 << prefix_bits) - 1
    value = data[pos] & mask
    pos += 1
    if value < mask:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer overflow")
        if not b & 0x80:
            return value, pos


def _decode_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = _decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("truncated string")
    raw = data[pos: pos + length]
    return (huffman_decode(raw) if huff else raw), pos + length


class HpackDecoder:
    """Stateful decoder: one per HTTP/2 connection (owns the peer-populated
    dynamic table)."""

    def __init__(self, max_table_size: int = 4096):
        self.dynamic: List[Tuple[bytes, bytes]] = []
        self.size = 0
        self.max_size = max_table_size
        self.protocol_max = max_table_size

    def _entry(self, index: int) -> Tuple[bytes, bytes]:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if d >= len(self.dynamic):
            raise HpackError(f"index {index} out of table")
        return self.dynamic[d]

    def _insert(self, name: bytes, value: bytes) -> None:
        self.dynamic.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        while self.size > self.max_size and self.dynamic:
            n, v = self.dynamic.pop()
            self.size -= len(n) + len(v) + 32

    def decode(self, block: bytes) -> List[Tuple[bytes, bytes]]:
        headers: List[Tuple[bytes, bytes]] = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:  # indexed
                index, pos = _decode_int(block, pos, 7)
                headers.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = _decode_int(block, pos, 6)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(block, pos)
                value, pos = _decode_string(block, pos)
                self._insert(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                new_size, pos = _decode_int(block, pos, 5)
                if new_size > self.protocol_max:
                    raise HpackError("table size above protocol maximum")
                self.max_size = new_size
                while self.size > self.max_size and self.dynamic:
                    n, v = self.dynamic.pop()
                    self.size -= len(n) + len(v) + 32
            else:  # literal without indexing (0x00) / never indexed (0x10)
                index, pos = _decode_int(block, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(block, pos)
                value, pos = _decode_string(block, pos)
                headers.append((name, value))
        return headers


def _encode_int(value: int, prefix_bits: int, pattern: int) -> bytes:
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([pattern | value])
    out = bytearray([pattern | mask])
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def encode_headers(headers: List[Tuple[bytes, bytes]]) -> bytes:
    """Stateless encode: exact static matches indexed, the rest literal
    without indexing, never Huffman."""
    out = bytearray()
    for name, value in headers:
        idx = _STATIC_MAP.get((name, value))
        if idx is not None:
            out += _encode_int(idx, 7, 0x80)
            continue
        out.append(0x00)  # literal w/o indexing, new name
        out += _encode_int(len(name), 7, 0x00)
        out += name
        out += _encode_int(len(value), 7, 0x00)
        out += value
    return bytes(out)
