"""Fused batched ingest: many sessions' stream windows packed into one
ragged buffer, scanned by kernel K1 in one launch and digested by K2.

Counterpart of the JAX package's ``ops/ingest.py``.  Packing layout
(``pack_rows``, copied)::

    [ pad | tail_0 | row_0 | pad | tail_1 | row_1 | ... ]
            '------ 63 B ------'

Every row owns a fixed 63-byte halo slot holding its stream's real scan
tail right-aligned (zero-filled when the stream has less history).  The
buzhash is position-local over a 64-byte window, so one flat scan of the
packed buffer computes every row's candidates in its own stream context;
positions whose window crosses a row seam or exceeds the row's real
history are dropped afterwards (``_split_ends``), so halo and padding
bytes never leak a candidate into a row's results.

K1 sees the buffer as one row (B = 1) without history; it takes any row
length, so the buffer is not padded (the JAX twin padded to a power of
two only to bound its jit cache).  ``stats`` counts batched-stage
dispatches; packing accounting lives on ``RaggedBatch``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..chunker.spec import WINDOW, ChunkerParams
from ..utils.device import host_tensor, resolve
from .rolling_hash import candidate_mask, device_tables
from .sha256 import sha256_chunks

HALO = WINDOW - 1

# batched-stage dispatch accounting (cumulative): one per entry into a
# batched stage
stats = {
    "scan_dispatches": 0,          # guarded-by: _stats_lock
    "sha_dispatches": 0,           # guarded-by: _stats_lock
}
_stats_lock = threading.Lock()

# torch.nonzero takes at most this many elements per call here (some
# versions refuse 2**31)
_NONZERO_ELEMS = 1 << 30


def _bump(counter: str) -> None:
    with _stats_lock:
        stats[counter] += 1


class RaggedBatch:
    """One packed ragged batch of stream windows (module docstring).

    ``buf``       uint8[total] -- the packed scan buffer
    ``starts``    int64[N] -- packed offset of each row's first byte
    ``lens``      int64[N] -- row payload lengths (all > 0)
    ``hist_lens`` int64[N] -- real history bytes available to each row,
                  clamped to ``HALO`` (positions needing more are invalid)
    ``bases``     int64[N] -- absolute stream offset of each row's first
                  byte (candidate ends are returned in this coordinate)
    ``padding_bytes`` -- non-payload bytes in ``buf`` (halo slots)
    """

    __slots__ = ("buf", "starts", "lens", "hist_lens", "bases",
                 "padding_bytes")

    def __init__(self, buf, starts, lens, hist_lens, bases,
                 padding_bytes: int):
        self.buf = buf
        self.starts = starts
        self.lens = lens
        self.hist_lens = hist_lens
        self.bases = bases
        self.padding_bytes = padding_bytes


def pack_rows(rows: "list[list]", tails: "list[bytes]",
              hist_lens: "list[int]", bases: "list[int]") -> RaggedBatch:
    """Pack N stream windows into one ragged scan buffer.

    ``rows[i]`` is a list of bytes-like blocks (a stream's unscanned
    window); ``tails[i]`` holds up to ``HALO`` bytes of real preceding
    stream context; ``hist_lens[i]`` is the run history length (clamped to
    ``HALO`` here); ``bases[i]`` the absolute stream offset of the row's
    first byte.  Zero-length rows are the caller's job to filter."""
    n = len(rows)
    lens = np.empty(n, dtype=np.int64)
    for i, blocks in enumerate(rows):
        lens[i] = sum(len(b) for b in blocks)
        if lens[i] <= 0:
            raise ValueError("pack_rows: empty row (caller filters)")
    starts = np.empty(n, dtype=np.int64)
    cursor = 0
    for i in range(n):
        cursor += HALO
        starts[i] = cursor
        cursor += int(lens[i])
    total = cursor
    buf = np.zeros(total, dtype=np.uint8)
    for i, blocks in enumerate(rows):
        tail = tails[i][-HALO:] if tails[i] else b""
        if tail:
            s = int(starts[i])
            buf[s - len(tail):s] = np.frombuffer(tail, dtype=np.uint8)
        off = int(starts[i])
        for b in blocks:
            nb = len(b)
            buf[off:off + nb] = np.frombuffer(b, dtype=np.uint8)
            off += nb
    payload = int(lens.sum())
    return RaggedBatch(
        buf, starts, lens,
        np.minimum(np.asarray(hist_lens, dtype=np.int64), HALO),
        np.asarray(bases, dtype=np.int64),
        total - payload)


def _split_ends(batch: RaggedBatch, packed_ends: np.ndarray) -> "list[np.ndarray]":
    """Map candidate ends in packed coordinates back to per-row absolute
    stream ends, dropping every halo/seam/short-history position."""
    out = [np.empty(0, dtype=np.int64) for _ in range(len(batch.starts))]
    if not len(packed_ends):
        return out
    pos = np.asarray(packed_ends, dtype=np.int64) - 1
    idx = np.searchsorted(batch.starts, pos, side="right") - 1
    idx = np.clip(idx, 0, len(batch.starts) - 1)
    rel = pos - batch.starts[idx]
    valid = (rel >= 0) & (rel < batch.lens[idx]) \
        & (rel + batch.hist_lens[idx] >= HALO)
    idx, rel = idx[valid], rel[valid]
    for i in range(len(batch.starts)):
        sel = idx == i
        if sel.any():
            out[i] = (batch.bases[i] + rel[sel] + 1).astype(np.int64)
    return out


def scan_rows(batch: RaggedBatch, params: ChunkerParams, *,
              device="cuda") -> "list[np.ndarray]":
    """Candidate ends of every row of ``batch`` (absolute stream offsets):
    one K1 launch over the whole packed buffer on ``device``, hits
    extracted there, then ``_split_ends`` on the host."""
    dev = resolve(device)
    _bump("scan_dispatches")
    if not len(batch.buf):
        return _split_ends(batch, np.empty(0, np.int64))
    buf = host_tensor(batch.buf).to(dev)
    hit = candidate_mask(buf, device_tables(params, dev), params.mask,
                         params.magic)
    parts = [torch.nonzero(hit[lo:lo + _NONZERO_ELEMS]).flatten() + lo
             for lo in range(0, hit.numel(), _NONZERO_ELEMS)]
    return _split_ends(batch, torch.cat(parts).cpu().numpy() + 1)


def digest_chunks(chunks: "list", *, device="cuda") -> "list[bytes]":
    """SHA-256 over a whole chunk batch: K2 on ``device``, one launch per
    ``sha256_chunks`` batch."""
    _bump("sha_dispatches")
    return sha256_chunks([bytes(c) for c in chunks], device=device)
