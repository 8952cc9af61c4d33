"""Microsoft Tape Format (MTF 1.00a) subset reader.

Reference capability: the external go-mtf library consumed by
internal/tapeio/converter.go.  MTF media is a sequence of descriptor
blocks (DBLKs), 4-char typed, each carrying a common header and optional
data streams.  This subset covers what BKF-style backup media need:

    TAPE  media header
    SSET  start of a backup set
    VOLB  volume (drive root)
    DIRB  directory
    FILE  file (with a STAN standard-data stream holding the content)
    ESET  end of set

DBLK common header (fixed part, little-endian):
    offset 0   4s   block type
    offset 4   u32  block attributes
    offset 8   u16  offset to first stream
    ...        (we honor type / first-stream offset / format-logical-address)

Stream header:
    4s id | u16 sys attrs | u16 media attrs | u64 length | ...
    data follows, padded to 4-byte alignment.

Strings in DIRB/FILE are stored as (offset, length) into the block; this
subset stores them UTF-8 at the tail (matching the spec's "TSTRING type 1"
single-byte form).

``write_synthetic_mtf`` produces valid-for-this-reader media — the test
fixture generator (the reference tests MTF via go-mtf's own fixtures;
golden real-tape images are out of scope for a container).

A copy of the JAX package's ``tapeio/mtf.py``, its code byte for byte.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, Optional

BLOCK_ALIGN = 1024                  # MTF formats media in 512/1024 blocks
_DBLK_HDR = struct.Struct("<4sIHH")   # type, attrs, off_first_stream, str_off
_STREAM_HDR = struct.Struct("<4sHHQ")  # id, sys_attr, media_attr, length

TAPE, SSET, VOLB, DIRB, FILE, ESET = b"TAPE", b"SSET", b"VOLB", b"DIRB", b"FILE", b"ESET"
STAN = b"STAN"                      # standard data stream
SPAD = b"SPAD"                      # padding stream


class MTFError(ValueError):
    pass


@dataclass
class MTFEntry:
    kind: str                      # "dir" | "file"
    path: str                      # media-relative, '/'-separated
    size: int = 0
    content_offset: int = 0        # absolute offset of STAN data
    attributes: int = 0


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _align(n: int, a: int = BLOCK_ALIGN) -> int:
    return (n + a - 1) & ~(a - 1)


# ---------------------------------------------------------------------------
# writer (fixture generator / bkf creation)
# ---------------------------------------------------------------------------

def _dblk(btype: bytes, name: str = "", streams: list[tuple[bytes, bytes]]
          | None = None) -> bytes:
    """Build one DBLK: header + name string + streams, block-aligned."""
    name_b = name.encode("utf-8")
    body_off = _DBLK_HDR.size
    str_off = body_off
    first_stream = _pad4(str_off + len(name_b))
    hdr = _DBLK_HDR.pack(btype, 0, first_stream, str_off)
    out = bytearray(hdr)
    out += name_b
    out += b"\0" * (first_stream - len(out))
    for sid, data in (streams or []):
        out += _STREAM_HDR.pack(sid, 0, 0, len(data))
        out += data
        out += b"\0" * (_pad4(len(data)) - len(data))
    # terminating SPAD stream fills to block alignment
    total = _align(len(out) + _STREAM_HDR.size)
    pad_len = total - len(out) - _STREAM_HDR.size
    out += _STREAM_HDR.pack(SPAD, 0, 0, pad_len)
    out += b"\0" * pad_len
    return bytes(out)


def write_synthetic_mtf(fp: BinaryIO, tree: dict[str, bytes | None],
                        *, media_name: str = "pbs-plus-test") -> None:
    """Write MTF media containing ``tree`` (path → content; None = dir).
    Paths use '/' separators; parents are emitted automatically."""
    fp.write(_dblk(TAPE, media_name))
    fp.write(_dblk(SSET, "set-1"))
    fp.write(_dblk(VOLB, "C:"))
    emitted: set[str] = set()

    def emit_dirs(path: str) -> None:
        parts = path.split("/")[:-1]
        for i in range(1, len(parts) + 1):
            d = "/".join(parts[:i])
            if d and d not in emitted:
                emitted.add(d)
                fp.write(_dblk(DIRB, d + "/"))

    for path in sorted(tree, key=lambda p: tuple(p.split("/"))):
        content = tree[path]
        if content is None:
            if path not in emitted:
                emitted.add(path)
                fp.write(_dblk(DIRB, path + "/"))
            continue
        emit_dirs(path)
        fp.write(_dblk(FILE, path, streams=[(STAN, content)]))
    fp.write(_dblk(ESET, "set-1"))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class MTFReader:
    """Walk MTF media sequentially (the tape access pattern): yields
    MTFEntry records; file content is read via ``read_content`` (ranged,
    for the spool) or streamed inline during iteration."""

    def __init__(self, fp: BinaryIO, *, strict: bool = True):
        self.fp = fp
        self.media_name = ""
        self.set_name = ""
        self.strict = strict     # media must end with ESET (truncation guard)

    def _read_at(self, off: int, n: int) -> bytes:
        self.fp.seek(off)
        return self.fp.read(n)

    def entries(self) -> Iterator[MTFEntry]:
        off = 0
        self.fp.seek(0, io.SEEK_END)
        end = self.fp.tell()
        seen_tape = False
        while off < end:
            hdr = self._read_at(off, _DBLK_HDR.size)
            if len(hdr) < _DBLK_HDR.size:
                break
            btype, attrs, first_stream, str_off = _DBLK_HDR.unpack(hdr)
            if not seen_tape:
                if btype != TAPE:
                    raise MTFError(f"media does not start with TAPE: {btype!r}")
                seen_tape = True
            if btype not in (TAPE, SSET, VOLB, DIRB, FILE, ESET):
                raise MTFError(f"unknown DBLK {btype!r} at {off}")
            name = b""
            if first_stream > str_off >= _DBLK_HDR.size:
                name = self._read_at(off + str_off, first_stream - str_off)
                name = name.rstrip(b"\0")
            # walk streams to find STAN + the end of this block
            soff = off + first_stream
            content_off, content_len = 0, 0
            while True:
                shdr = self._read_at(soff, _STREAM_HDR.size)
                if len(shdr) < _STREAM_HDR.size:
                    soff = end
                    break
                sid, _sa, _ma, slen = _STREAM_HDR.unpack(shdr)
                data_off = soff + _STREAM_HDR.size
                if sid == STAN:
                    content_off, content_len = data_off, slen
                soff = data_off + (_pad4(slen) if sid != SPAD else slen)
                if sid == SPAD:
                    break
            if btype == TAPE:
                self.media_name = name.decode("utf-8", "replace")
            elif btype == SSET:
                self.set_name = name.decode("utf-8", "replace")
            elif btype == DIRB:
                p = name.decode("utf-8", "replace").strip("/").replace("\\", "/")
                if p:
                    yield MTFEntry("dir", p, attributes=attrs)
            elif btype == FILE:
                p = name.decode("utf-8", "replace").replace("\\", "/")
                yield MTFEntry("file", p, size=content_len,
                               content_offset=content_off, attributes=attrs)
            elif btype == ESET:
                return
            off = _align(soff)
        if self.strict:
            raise MTFError("media ended without ESET (truncated tape?)")

    def read_content(self, entry: MTFEntry, off: int, n: int) -> bytes:
        if entry.kind != "file":
            raise MTFError("not a file entry")
        n = max(0, min(n, entry.size - off))
        return self._read_at(entry.content_offset + off, n)
