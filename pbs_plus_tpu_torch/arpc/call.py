"""RPC envelopes + session call API.

Reference: internal/arpc/call.go:11-37 — CBOR ``Request{method, payload,
headers}`` / ``Response{status, message, data}``; status 213 = raw-stream
upgrade with 0xFF/0xAA ready/ack handshake (router.go:36-86).  Envelope
codec here is msgpack (utils/codec.py).

A copy of the JAX package's ``arpc/call.py``, its code byte for byte
apart from its imports, which name the port's own modules; the port
keeps no trace context, so calls carry the caller's headers only."""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

from ..utils import codec, trace
from .mux import MuxConnection, MuxError, MuxStream

STATUS_OK = 200
STATUS_RAW_STREAM = 213      # same upgrade code as the reference
STATUS_BAD_REQUEST = 400
STATUS_NOT_FOUND = 404
STATUS_ERROR = 500

_READY = b"\xff"             # server→client: raw stream ready
_ACK = b"\xaa"               # client→server: proceed

_LEN = struct.Struct("<I")
MAX_ENVELOPE = 32 << 20


@dataclass
class Request:
    method: str
    payload: Any = None
    headers: dict[str, str] = field(default_factory=dict)

    def encode(self) -> bytes:
        body = codec.encode({"m": self.method, "p": self.payload,
                             "h": self.headers})
        return _LEN.pack(len(body)) + body

    @classmethod
    def from_wire(cls, d: dict) -> "Request":
        return cls(method=d.get("m", ""), payload=d.get("p"),
                   headers=dict(d.get("h", {})))


@dataclass
class Response:
    status: int = STATUS_OK
    message: str = ""
    data: Any = None

    def encode(self) -> bytes:
        body = codec.encode({"s": self.status, "e": self.message,
                             "d": self.data})
        return _LEN.pack(len(body)) + body

    @classmethod
    def from_wire(cls, d: dict) -> "Response":
        return cls(status=d.get("s", STATUS_ERROR), message=d.get("e", ""),
                   data=d.get("d"))

    @property
    def ok(self) -> bool:
        return self.status in (STATUS_OK, STATUS_RAW_STREAM)


async def read_envelope(stream: MuxStream) -> dict:
    hdr = await stream.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_ENVELOPE:
        raise MuxError(f"envelope too large: {n}")
    return codec.decode_map(await stream.readexactly(n))


class CallError(RuntimeError):
    def __init__(self, resp: Response):
        super().__init__(f"rpc failed ({resp.status}): {resp.message}")
        self.response = resp


class Session:
    """Client-side call surface over a MuxConnection (reference:
    Call/CallData/CallMessage/CallBinaryWithMeta, internal/arpc/call.go:171-199)."""

    def __init__(self, conn: MuxConnection):
        self.conn = conn

    async def call(self, method: str, payload: Any = None, *,
                   headers: dict[str, str] | None = None,
                   timeout: float | None = 30.0) -> Response:
        """One stream per RPC; raises CallError on non-2xx."""
        # trace context rides the call metadata (headers) so handler-side
        # work parents under the caller's span across the mux
        # (docs/observability.md "Propagation")
        hdrs = trace.headers_out(headers)

        async def _do() -> Response:
            st = await self.conn.open_stream()
            try:
                await st.write(Request(method, payload, hdrs).encode())
                resp = Response.from_wire(await read_envelope(st))
                if not resp.ok:
                    raise CallError(resp)
                return resp
            finally:
                await st.close()
        return await asyncio.wait_for(_do(), timeout)

    async def call_binary_into(self, method: str, payload: Any,
                               writer: Callable[[bytes], Any] | bytearray,
                               *, timeout: float | None = 300.0,
                               headers: dict[str, str] | None = None,
                               ) -> tuple[Response, int]:
        """Raw-stream download: server responds 213, we ack, then a framed
        binary transfer lands via ``writer`` (callable or bytearray).
        Returns (response, bytes_received).  (Reference: CallBinaryWithMeta
        reading into caller buffers, internal/arpc/call.go:176-199.)"""
        from .binary_stream import receive_data_into
        hdrs = trace.headers_out(headers)

        async def _do() -> tuple[Response, int]:
            st = await self.conn.open_stream()
            try:
                await st.write(Request(method, payload, hdrs).encode())
                resp = Response.from_wire(await read_envelope(st))
                if resp.status != STATUS_RAW_STREAM:
                    if not resp.ok:
                        raise CallError(resp)
                    return resp, 0
                ready = await st.readexactly(1)
                if ready != _READY:
                    raise MuxError("bad raw-stream ready byte")
                await st.write(_ACK)
                n = await receive_data_into(st, writer)
                return resp, n
            finally:
                await st.close()
        return await asyncio.wait_for(_do(), timeout)

    async def open_raw(self, method: str, payload: Any = None, *,
                       headers: dict[str, str] | None = None,
                       timeout: float | None = 30.0,
                       ) -> tuple[Response, MuxStream]:
        """Raw-stream upgrade keeping the stream open for caller-driven IO
        (used by the remote-restore protocol's content streams)."""
        hdrs = trace.headers_out(headers)
        st = await self.conn.open_stream()
        try:
            async def _handshake() -> Response:
                await st.write(Request(method, payload, hdrs).encode())
                resp = Response.from_wire(await read_envelope(st))
                if resp.status != STATUS_RAW_STREAM:
                    raise CallError(resp)
                ready = await st.readexactly(1)
                if ready != _READY:
                    raise MuxError("bad raw-stream ready byte")
                await st.write(_ACK)
                return resp
            resp = await asyncio.wait_for(_handshake(), timeout)
            return resp, st
        except BaseException:
            await st.close()
            raise


class RawStreamHandler:
    """Marker return for router handlers that upgrade to a raw stream:
    the router sends 213 + ready byte, waits for ack, then invokes ``fn``
    with the stream."""

    def __init__(self, fn: Callable[[MuxStream], Awaitable[None]],
                 data: Any = None):
        self.fn = fn
        self.data = data
