"""Length-prefixed raw binary transfer over a mux stream.

Reference: internal/arpc/binary_stream.go:12-124 — 14-byte header
``magic(4) + version(2) + length(8)``, 1 GiB frame cap, drain-on-short-
buffer so a short consumer never desyncs the stream.

A copy of the JAX package's ``arpc/binary_stream.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import struct
from typing import Callable

from ..utils import conf, failpoints
from .mux import MuxError, MuxStream

MAGIC = b"TPBS"
VERSION = 1
_HDR = struct.Struct("<4sHQ")
MAX_FRAME = conf.MAX_FRAME_SIZE            # 1 GiB
_IO_CHUNK = 1 << 20


class StreamLengthError(MuxError):
    """Declared-vs-actual length violation on a framed binary transfer:
    the header promised ``declared`` bytes but the stream delivered (or
    the reader produced) only ``actual`` before EOF.  Receive-side
    violations are counted in the per-connection
    ``stats["stream_length_violations"]`` — a peer lying about stream
    lengths is an abuse signal, not a generic transport hiccup."""

    def __init__(self, msg: str, *, declared: int, actual: int):
        super().__init__(msg)
        self.declared = declared
        self.actual = actual


async def send_data_from_reader(stream: MuxStream, reader,
                                total_len: int) -> int:
    """Send exactly ``total_len`` bytes read from ``reader`` (object with
    .read(n) → bytes, or bytes-like)."""
    if total_len < 0 or total_len > MAX_FRAME:
        raise MuxError(f"frame length {total_len} exceeds cap")
    await failpoints.ahit("arpc.binary.send")
    await stream.write(_HDR.pack(MAGIC, VERSION, total_len))
    if isinstance(reader, (bytes, bytearray, memoryview)):
        data = memoryview(reader)[:total_len]
        if len(data) < total_len:
            raise StreamLengthError(
                f"reader holds {len(data)} bytes of declared {total_len}",
                declared=total_len, actual=len(data))
        sent = 0
        while sent < total_len:
            n = min(_IO_CHUNK, total_len - sent)
            await stream.write(bytes(data[sent:sent + n]))
            sent += n
        return sent
    sent = 0
    while sent < total_len:
        block = reader.read(min(_IO_CHUNK, total_len - sent))
        if not block:
            raise StreamLengthError(
                f"reader EOF at {sent}/{total_len}",
                declared=total_len, actual=sent)
        await stream.write(block)
        sent += len(block)
    return sent


async def receive_data_into(stream: MuxStream,
                            sink: Callable[[bytes], object] | bytearray,
                            *, max_len: int | None = None) -> int:
    """Receive one framed transfer.  ``sink`` is a bytearray (appended) or
    a callable per block.  If the frame exceeds ``max_len``, the excess is
    drained and discarded (reference's drain-on-short-buffer) and the
    consumed length is still returned."""
    await failpoints.ahit("arpc.binary.receive")
    hdr = await stream.readexactly(_HDR.size)
    magic, ver, length = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise MuxError(f"bad binary frame magic {magic!r}")
    if ver != VERSION:
        raise MuxError(f"unsupported binary frame version {ver}")
    if length > MAX_FRAME:
        raise MuxError(f"frame length {length} exceeds cap")
    keep = length if max_len is None else min(length, max_len)
    got = 0
    while got < length:
        block = await stream.read(min(_IO_CHUNK, length - got))
        if not block:
            # declared-vs-actual accounting: the sender promised
            # ``length`` bytes and FINed early — a lying peer, counted
            # per connection so fleet soaks can assert the abuse was
            # SEEN, not just survived
            stream.conn.stats["stream_length_violations"] += 1
            raise StreamLengthError(
                f"stream EOF at {got}/{length}",
                declared=length, actual=got)
        take = max(0, min(len(block), keep - got))
        if take:
            if isinstance(sink, bytearray):
                sink += block[:take]
            else:
                sink(block[:take])
        got += len(block)
    return min(got, keep)
