"""Delta chunk blobs: the on-disk format of the similarity-dedup tier.

A chunk whose content resembles an already-stored base chunk
(docs/data-plane.md "Similarity tier") is stored as a DELTA against that
base instead of a full compressed blob:

    magic "TPXDELT1" (8) | codec u8 | depth u8 | reserved u16 |
    raw_size u32 | base_digest (32) | payload

- ``codec`` 1 — **zstd-dict**: the payload is a zstd frame compressed
  with the base chunk as the raw-content dictionary
  (``utils/zstdshim.compress_with_dict``); matches against the base
  cost ~nothing, so only the novel bytes remain.
- ``codec`` 2 — **copy/insert patch**: pure-Python fallback when
  libzstd's dictionary API is unavailable.  16-byte-aligned blocks of
  the chunk are matched against a base block table and extended
  byte-wise; the op stream (COPY base_off len / LITERAL bytes) is
  plain-zstd-compressed.  Alignment-based matching wins on in-place
  mutations (the dominant near-dup shape: VM images, DB pages) and
  simply produces an unprofitable patch on byte-shifting edits — the
  writer then falls back to a full blob, never a bad delta.

``depth`` is the delta-chain depth of THIS chunk (base's depth + 1);
the write path bounds it (``PBS_PLUS_DELTA_MAX_CHAIN``) and the read
path re-checks it as a corruption guard.  The decoded bytes always
re-verify against the chunk digest in ``ChunkStore.get``, so a wrong
base or corrupt payload can never serve wrong bytes.

The magic cannot collide with the two existing on-disk kinds: raw zstd
frames start ``28 B5 2F FD`` and PBS DataBlobs have their own 8-byte
magic — readers sniff all three.

A copy of the JAX package's ``pxar/deltablob.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import struct

from ..utils import zstdshim

DELTA_MAGIC = b"TPXDELT1"
CODEC_ZSTD_DICT = 1
CODEC_PYPATCH = 2
_HDR = struct.Struct("<8sBBHI32s")
HEADER_SIZE = _HDR.size

_PATCH_BLOCK = 16
_OP_COPY = 0
_OP_LIT = 1
_MAX_CHUNK = 1 << 30


class DeltaError(ValueError):
    """Malformed delta blob (bad magic/header/payload)."""


def is_delta(raw: bytes) -> bool:
    return raw[:8] == DELTA_MAGIC


def parse_header(raw: bytes) -> tuple[int, int, int, bytes]:
    """→ (codec, depth, raw_size, base_digest); raises DeltaError."""
    if len(raw) < HEADER_SIZE:
        raise DeltaError("truncated delta header")
    magic, codec, depth, _rsv, raw_size, base = _HDR.unpack_from(raw)
    if magic != DELTA_MAGIC:
        raise DeltaError(f"bad delta magic {magic!r}")
    if codec not in (CODEC_ZSTD_DICT, CODEC_PYPATCH):
        raise DeltaError(f"unknown delta codec {codec}")
    return codec, depth, raw_size, base


def encode(data: bytes, base: bytes, base_digest: bytes, *,
           depth: int, level: int = 3) -> bytes | None:
    """Delta-encode ``data`` against ``base`` → the full on-disk blob,
    or None when no codec produced a payload smaller than ~90% of the
    data itself (a delta that large loses to a plain blob once zstd has
    had its own pass — the caller falls back to the full write)."""
    if len(data) >= _MAX_CHUNK:
        return None
    payload = None
    codec = CODEC_ZSTD_DICT
    if zstdshim.dict_available():
        try:
            payload = zstdshim.compress_with_dict(data, base, level)
        except zstdshim.ZstdError:
            payload = None
    if payload is None:
        codec = CODEC_PYPATCH
        patch = _patch_encode(data, base)
        if patch is not None:
            payload = zstdshim.ZstdCompressor(level=level).compress(patch)
    if payload is None or HEADER_SIZE + len(payload) >= 0.9 * len(data):
        return None
    return _HDR.pack(DELTA_MAGIC, codec, depth, 0, len(data),
                     base_digest) + payload


def decode(raw: bytes, base: bytes) -> bytes:
    """Reassemble the chunk bytes from a delta blob + its base bytes.
    The caller verifies the result against the chunk digest."""
    codec, _depth, raw_size, _base_digest = parse_header(raw)
    payload = raw[HEADER_SIZE:]
    if codec == CODEC_ZSTD_DICT:
        try:
            out = zstdshim.decompress_with_dict(
                payload, base, max_output_size=_MAX_CHUNK)
        except zstdshim.ZstdError as e:
            raise DeltaError(f"delta payload undecodable: {e}") from e
    else:
        try:
            patch = zstdshim.ZstdDecompressor().decompress(
                payload, max_output_size=_MAX_CHUNK)
        except zstdshim.ZstdError as e:
            raise DeltaError(f"delta patch undecodable: {e}") from e
        out = _patch_apply(patch, base)
    if len(out) != raw_size:
        raise DeltaError(f"delta decoded {len(out)} bytes, "
                         f"header declares {raw_size}")
    return out


# -- pure-Python copy/insert codec ------------------------------------------

def _patch_encode(data: bytes, base: bytes) -> bytes | None:
    """Greedy aligned-block copy/insert patch; None when the match rate
    is too low to bother serializing (module docstring)."""
    if len(base) < _PATCH_BLOCK or len(data) < _PATCH_BLOCK:
        return None
    table: dict[bytes, int] = {}
    for off in range(0, len(base) - _PATCH_BLOCK + 1, _PATCH_BLOCK):
        table.setdefault(base[off:off + _PATCH_BLOCK], off)
    ops: list[bytes] = []
    lit_start = 0
    i = 0
    matched = 0
    n = len(data)
    while i + _PATCH_BLOCK <= n:
        m = table.get(data[i:i + _PATCH_BLOCK])
        if m is None:
            # re-sync to the aligned grid: the table only holds aligned
            # base blocks, so probing unaligned offsets can never match
            i = (i // _PATCH_BLOCK + 1) * _PATCH_BLOCK
            continue
        # extend the match forward byte-wise
        j = i + _PATCH_BLOCK
        k = m + _PATCH_BLOCK
        while j < n and k < len(base) and data[j] == base[k]:
            j += 1
            k += 1
        if lit_start < i:
            lit = data[lit_start:i]
            ops.append(struct.pack("<BI", _OP_LIT, len(lit)) + lit)
        ops.append(struct.pack("<BII", _OP_COPY, m, j - i))
        matched += j - i
        lit_start = j
        i = j if j % _PATCH_BLOCK == 0 \
            else j + _PATCH_BLOCK - (j % _PATCH_BLOCK)
    if lit_start < n:
        lit = data[lit_start:]
        ops.append(struct.pack("<BI", _OP_LIT, len(lit)) + lit)
    if matched * 2 < n:
        return None                  # mostly literals: not a useful delta
    return b"".join(ops)


def _patch_apply(patch: bytes, base: bytes) -> bytes:
    out = bytearray()
    pos = 0
    n = len(patch)
    while pos < n:
        op = patch[pos]
        if op == _OP_COPY:
            if pos + 9 > n:
                raise DeltaError("truncated copy op")
            _, off, length = struct.unpack_from("<BII", patch, pos)
            pos += 9
            if off + length > len(base):
                raise DeltaError("copy op outside base")
            out += base[off:off + length]
        elif op == _OP_LIT:
            if pos + 5 > n:
                raise DeltaError("truncated literal op")
            _, length = struct.unpack_from("<BI", patch, pos)
            pos += 5
            if pos + length > n:
                raise DeltaError("literal op past patch end")
            out += patch[pos:pos + length]
            pos += length
        else:
            raise DeltaError(f"unknown patch op {op}")
    return bytes(out)
