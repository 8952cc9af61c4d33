"""Proxmox Backup Server on-disk format layer: DIDX / FIDX indexes,
DataBlob chunk/blob envelopes, and the ``index.json`` manifest schema.

Parity target: the reference's commit engine writes archives a stock PBS
can serve (internal/pxarmount/commit_orchestrate.go:127-163
via pxar/datastore.ParseDynamicIndex; SURVEY §2.2 DIDX surface; §7 hard
parts "DIDX/split-archive layout … drop-in sidecar on a PBS host").
This build reaches the same layout behind ``Datastore(pbs_format=True)``
(`datastore.py`) — chunks become DataBlobs under the PBS ``.chunks/XXXX``
fan-out, indexes are written in the PBS dynamic-index binary layout, and
snapshots gain an ``index.json.blob`` manifest.

Binary layouts (PBS format, all integers little-endian):

    DynamicIndexHeader  — 4096 bytes
      magic[8]  uuid[16]  ctime:i64  index_csum[32]  reserved[4032]
      entries follow:  (end:u64, digest[32]) × N      — 40 bytes each
      index_csum = sha256 over the entry area
    FixedIndexHeader    — 4096 bytes
      magic[8]  uuid[16]  ctime:i64  index_csum[32]
      size:u64  chunk_size:u64  reserved[4016]
      entries follow: digest[32] × ceil(size/chunk_size)
      index_csum = sha256 over the digest area
    DataBlob
      magic[8]  crc32:u32  payload…
      crc32 (IEEE, as zlib.crc32) over the payload bytes; compressed
      blobs carry a zstd frame as payload.

Constants provenance: the magic arrays below are the published Proxmox
Backup file-format constants (pbs-datastore ``file_formats.rs``),
reproduced from the public format.  This build runs in an offline image
with no PBS installation to cross-check against, so they are pinned in
this ONE place with golden tests (`tests/test_pbsformat.py`); if a live
PBS ever rejects an index, this block is the single update point.

A copy of the JAX package's ``pxar/pbsformat.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from dataclasses import dataclass

try:
    import zstandard
except ImportError:                 # image lacks the wheel; ctypes shim
    from ..utils import zstdshim as zstandard

# -- published PBS magics (see module docstring for provenance) -----------
DYNAMIC_INDEX_MAGIC = bytes([28, 145, 78, 165, 25, 186, 179, 205])
FIXED_INDEX_MAGIC = bytes([47, 127, 65, 237, 145, 253, 15, 205])
UNCOMPRESSED_BLOB_MAGIC = bytes([66, 171, 56, 7, 190, 131, 112, 161])
COMPRESSED_BLOB_MAGIC = bytes([49, 185, 88, 66, 111, 182, 163, 127])
ENCRYPTED_BLOB_MAGIC = bytes([123, 103, 133, 190, 34, 45, 23, 37])
ENCR_COMPR_BLOB_MAGIC = bytes([230, 89, 27, 191, 11, 191, 216, 11])

HEADER_SIZE = 4096
ENTRY_SIZE = 40                       # u64 end + 32-byte digest
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"

_DIDX_HDR = struct.Struct("<8s16sq32s")            # + 4032 reserved
_FIDX_HDR = struct.Struct("<8s16sq32sQQ")          # + 4016 reserved
_BLOB_HDR = struct.Struct("<8sI")


# -- dynamic index ---------------------------------------------------------

def write_dynamic_index_bytes(records: list[tuple[int, bytes]],
                              uuid16: bytes, ctime_s: int) -> bytes:
    """records = [(end_offset, digest)] with strictly increasing ends."""
    if len(uuid16) != 16:
        raise ValueError("uuid must be 16 bytes")
    body = io.BytesIO()
    prev = 0
    for end, digest in records:
        if end <= prev:
            raise ValueError("non-monotonic index records")
        if len(digest) != 32:
            raise ValueError("digest must be 32 bytes")
        body.write(struct.pack("<Q", end))
        body.write(digest)
        prev = end
    entries = body.getvalue()
    csum = hashlib.sha256(entries).digest()
    hdr = _DIDX_HDR.pack(DYNAMIC_INDEX_MAGIC, uuid16, ctime_s, csum)
    return hdr + b"\0" * (HEADER_SIZE - len(hdr)) + entries


@dataclass(frozen=True)
class ParsedDynamicIndex:
    records: list          # [(end, digest)]
    uuid: bytes
    ctime_s: int
    csum: bytes            # the validated index csum


def parse_dynamic_index_bytes(data: bytes) -> ParsedDynamicIndex:
    if len(data) < HEADER_SIZE:
        raise ValueError("truncated dynamic index header")
    magic, uuid16, ctime_s, csum = _DIDX_HDR.unpack_from(data, 0)
    if magic != DYNAMIC_INDEX_MAGIC:
        raise ValueError(f"bad dynamic index magic {magic.hex()}")
    entries = data[HEADER_SIZE:]
    if len(entries) % ENTRY_SIZE:
        raise ValueError("dynamic index entry area not a multiple of 40")
    if hashlib.sha256(entries).digest() != csum:
        raise ValueError("dynamic index csum mismatch")
    records: list[tuple[int, bytes]] = []
    prev = 0
    for off in range(0, len(entries), ENTRY_SIZE):
        (end,) = struct.unpack_from("<Q", entries, off)
        if end <= prev:
            raise ValueError("non-monotonic dynamic index")
        records.append((end, entries[off + 8:off + 40]))
        prev = end
    return ParsedDynamicIndex(records, uuid16, ctime_s, csum)


# -- fixed index -----------------------------------------------------------

def write_fixed_index_bytes(digests: list[bytes], size: int,
                            chunk_size: int, uuid16: bytes,
                            ctime_s: int) -> bytes:
    if len(uuid16) != 16:
        raise ValueError("uuid must be 16 bytes")
    want = (size + chunk_size - 1) // chunk_size if size else 0
    if len(digests) != want:
        raise ValueError(f"fixed index needs {want} digests, got {len(digests)}")
    area = b"".join(digests)
    csum = hashlib.sha256(area).digest()
    hdr = _FIDX_HDR.pack(FIXED_INDEX_MAGIC, uuid16, ctime_s, csum,
                         size, chunk_size)
    return hdr + b"\0" * (HEADER_SIZE - len(hdr)) + area


@dataclass(frozen=True)
class ParsedFixedIndex:
    digests: list
    size: int
    chunk_size: int
    uuid: bytes
    ctime_s: int


def parse_fixed_index_bytes(data: bytes) -> ParsedFixedIndex:
    if len(data) < HEADER_SIZE:
        raise ValueError("truncated fixed index header")
    magic, uuid16, ctime_s, csum, size, chunk_size = \
        _FIDX_HDR.unpack_from(data, 0)
    if magic != FIXED_INDEX_MAGIC:
        raise ValueError(f"bad fixed index magic {magic.hex()}")
    area = data[HEADER_SIZE:]
    if hashlib.sha256(area).digest() != csum:
        raise ValueError("fixed index csum mismatch")
    if len(area) % 32:
        raise ValueError("fixed index digest area not a multiple of 32")
    digests = [area[i:i + 32] for i in range(0, len(area), 32)]
    return ParsedFixedIndex(digests, size, chunk_size, uuid16, ctime_s)


# -- DataBlob --------------------------------------------------------------

def blob_encode(data: bytes, *, compress: bool = True, level: int = 3,
                cctx: "zstandard.ZstdCompressor | None" = None) -> bytes:
    """Wrap payload bytes as a PBS DataBlob.  Mirrors PBS behavior of
    keeping the uncompressed form when zstd does not help.  Pass a cached
    ``cctx`` on hot paths (per-call compressor construction is real cost
    at chunk granularity)."""
    if compress:
        comp = (cctx or zstandard.ZstdCompressor(level=level)).compress(data)
        if len(comp) < len(data):
            return _BLOB_HDR.pack(COMPRESSED_BLOB_MAGIC,
                                  zlib.crc32(comp)) + comp
    return _BLOB_HDR.pack(UNCOMPRESSED_BLOB_MAGIC, zlib.crc32(data)) + data


def blob_wrap_compressed(frame: bytes) -> bytes:
    """Wrap an ALREADY-compressed zstd frame as a compressed DataBlob
    without touching the payload — the sync wire's format adapter when a
    native raw-zstd chunk lands in a pbs-format mirror: only the 12-byte
    envelope is added, never a decompress/recompress round-trip
    (docs/sync.md)."""
    if frame[:4] != _ZSTD_FRAME_MAGIC:
        raise ValueError("not a zstd frame")
    return _BLOB_HDR.pack(COMPRESSED_BLOB_MAGIC, zlib.crc32(frame)) + frame


def blob_decode(raw: bytes, *, max_size: int = 1 << 30,
                dctx: "zstandard.ZstdDecompressor | None" = None) -> bytes:
    if len(raw) < _BLOB_HDR.size:
        raise ValueError("truncated DataBlob")
    magic, crc = _BLOB_HDR.unpack_from(raw, 0)
    payload = raw[_BLOB_HDR.size:]
    if magic in (ENCRYPTED_BLOB_MAGIC, ENCR_COMPR_BLOB_MAGIC):
        raise ValueError("encrypted DataBlob: no key material configured")
    if magic not in (COMPRESSED_BLOB_MAGIC, UNCOMPRESSED_BLOB_MAGIC):
        raise ValueError(f"bad DataBlob magic {magic.hex()}")
    if zlib.crc32(payload) != crc:
        raise ValueError("DataBlob crc mismatch")
    if magic == COMPRESSED_BLOB_MAGIC:
        return (dctx or zstandard.ZstdDecompressor()).decompress(
            payload, max_output_size=max_size)
    return payload


def is_datablob(raw: bytes) -> bool:
    """Sniff: PBS DataBlob vs this build's native raw-zstd chunk files
    (zstd frame magic) — lets one chunk dir hold both during migration."""
    return raw[:8] in (COMPRESSED_BLOB_MAGIC, UNCOMPRESSED_BLOB_MAGIC,
                       ENCRYPTED_BLOB_MAGIC, ENCR_COMPR_BLOB_MAGIC) \
        and raw[:4] != _ZSTD_FRAME_MAGIC


# -- index.json manifest ---------------------------------------------------

def manifest_json(backup_type: str, backup_id: str, backup_time: int,
                  files: list[dict], unprotected: dict | None = None) -> bytes:
    """PBS BackupManifest schema (index.json payload).  ``files`` entries:
    {"filename", "size", "csum" (hex), "crypt-mode": "none"}."""
    doc = {
        "backup-type": backup_type,
        "backup-id": backup_id,
        "backup-time": backup_time,
        "files": files,
        "unprotected": unprotected or {},
    }
    return json.dumps(doc, sort_keys=True).encode()


def index_file_csum(data: bytes) -> bytes:
    """The csum a manifest ``files`` entry records for an index file:
    sha256 over the entry area (bytes after the fixed 4096-byte header).
    Identical to the value stored in the index header — kept here so the
    header-size/csum layout knowledge lives in this module only."""
    return hashlib.sha256(data[HEADER_SIZE:]).digest()


def chunk_rel_path(digest: bytes) -> str:
    """PBS chunk fan-out: .chunks/<first-4-hex>/<full-hex> (matches this
    build's native layout — shared on purpose)."""
    h = digest.hex()
    return f"{h[:4]}/{h}"
