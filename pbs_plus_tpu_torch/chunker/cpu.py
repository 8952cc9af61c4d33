"""CPU buzhash CDC backends: numpy-vectorized batch + streaming chunker.

Implements chunker/spec.py exactly.  The numpy path computes per-position
hashes with the same log2(W) doubling passes the TPU kernel uses; the
optional C++ native path (chunker/native.py) uses the classic rolling
recurrence — with W=64 on 32-bit rotations it degenerates to
``h = rotl1(h) ^ T[out] ^ T[in]``.  All paths must produce identical
candidate sets; tests/test_chunker.py enforces it.

A copy of the JAX package's ``chunker/cpu.py``, its code byte for byte;
its imports name the port's own modules (``chunker/native.py``, the
port's copy of the ctypes binding, and ``chunker/observe.py``).  Host
code: no device work, and no K1 launch.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from . import observe
from .spec import WINDOW, ChunkerParams, select_cuts


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    r &= 31
    if r == 0:
        return x.copy()
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def position_hashes(data: bytes | np.ndarray, params: ChunkerParams,
                    prefix: bytes | np.ndarray = b"") -> np.ndarray:
    """Buzhash h(i) for every position of ``data`` (uint32 array, same
    length).  Positions whose 64-byte window extends before the start of
    ``prefix+data`` hold partial-window values; ``candidates`` masks them
    out via its validity check."""
    buf = np.frombuffer(bytes(prefix), dtype=np.uint8) if not isinstance(prefix, np.ndarray) else prefix
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    full = np.concatenate([buf, arr]) if len(buf) else arr
    t = params.table[full]
    h = t.astype(np.uint32, copy=True)
    m = 1
    while m < WINDOW:
        # H_{2m}(i) = H_m(i) ^ rotl_{m mod 32}(H_m(i-m))
        h[m:] ^= _rotl32(h[:-m], m)
        m *= 2
    return h[len(buf):]


def candidates(data: bytes | np.ndarray, params: ChunkerParams, *,
               prefix: bytes | np.ndarray = b"",
               global_offset: int = 0, force_numpy: bool = False,
               threads: int | None = None) -> np.ndarray:
    """Sorted absolute candidate END offsets inside ``data``.

    ``prefix`` supplies up to W-1 bytes of preceding stream context;
    ``global_offset`` is the stream offset of ``data[0]``.  Positions whose
    window is not fully inside the stream (fewer than W bytes of history)
    are excluded.

    Dispatches to the C++ native scanner when available (same spec,
    bit-identical — tests/test_chunker.py::test_native_matches_numpy);
    the numpy path is the always-available reference implementation.
    ``threads``: forwarded to the native scan (None → auto segment-
    parallel on big buffers, 1 → sequential single-core).
    """
    if len(prefix) > global_offset:
        # context cannot exceed real stream history; keep the bytes
        # immediately preceding data[0]
        prefix = prefix[-global_offset:] if global_offset else prefix[:0]
    if not force_numpy and len(data) >= 1 << 16:
        from . import native
        if native.available():
            return native.candidates(
                data, params,  # ndarray passes through zero-copy
                prefix=bytes(prefix[-(WINDOW - 1):]),
                global_offset=global_offset, threads=threads)
    plen = len(prefix)
    if plen >= WINDOW:
        prefix = prefix[-(WINDOW - 1):]
        plen = WINDOW - 1
    observe.add_scan_bytes("numpy", len(data))
    h = position_hashes(data, params, prefix)
    hit = (h & np.uint32(params.mask)) == np.uint32(params.magic)
    # window of position i (local, within data) spans [i - 63 .. i] in the
    # combined buffer: needs plen + i >= WINDOW - 1 and the stream itself
    # must have WINDOW bytes of history: global_offset + i >= WINDOW - 1.
    n = len(h)
    local_i = np.arange(n, dtype=np.int64)
    valid = (plen + local_i >= WINDOW - 1) & (global_offset + local_i >= WINDOW - 1)
    ends = np.nonzero(hit & valid)[0] + 1 + global_offset
    return ends.astype(np.int64)


def chunk_bounds(data: bytes, params: ChunkerParams) -> list[tuple[int, int]]:
    """One-shot chunking: list of (start, end) covering ``data``."""
    if len(data) == 0:
        return []
    ends = candidates(data, params)
    cuts = select_cuts(ends, len(data), params)
    out = []
    s = 0
    for e in cuts:
        out.append((s, e))
        s = e
    return out


# Coalescing floor for streaming feeds: sub-block feeds accumulate in a
# pending buffer and scan as ONE batch once this many bytes are buffered
# (clamped to params.max_size so small-parameter configs still cut with
# their old cadence).  Without it, every tiny feed() paid a full scan
# dispatch PLUS a W-1-byte prefix re-hash it then discarded — a 1-byte
# feed pattern cost ~64x the one-shot scan (the satellite fix;
# tests/test_bench_harness.py::test_bench_streaming_feed_matches_oneshot
# pins both the scan-call count and the wall-clock ratio).
_FEED_COALESCE = 1 << 18


class CpuChunker:
    """Streaming chunker: ``feed()`` returns finalized absolute cut offsets,
    ``finalize()`` flushes the tail chunk.  Mirrors the reference's streaming
    buzhash consumption inside RemoteDedupWriter (SURVEY §3.4).

    Also the streaming shell shared by the CPU scan backends: subclasses
    (chunker/vector.py ``VectorChunker``) override ``_scan`` only, so the
    W-1 tail carry, the feed coalescing, and the shared greedy pass
    (``spec.select_cuts``) are structural — cut-point parity between
    them reduces to candidate-set parity.  (The tpu/sidecar chunkers
    carry their own streaming state and do not coalesce.)"""

    backend_name = "cpu"

    def __init__(self, params: ChunkerParams):
        self.params = params
        self._tail = b""            # last W-1 bytes of the scanned stream
        self._pending = bytearray()  # fed but not yet scanned
        self._scanned = 0           # stream offset of the scan frontier
        self._chunk_start = 0
        self._cand: deque[int] = deque()
        self._finalized = False
        self._scan_block = min(_FEED_COALESCE, params.max_size)

    def _scan(self, data, prefix, global_offset: int) -> np.ndarray:
        """Candidate ends for one frontier extension (backend hook)."""
        return candidates(data, self.params, prefix=prefix,
                          global_offset=global_offset)

    def _ingest(self, data) -> None:
        """Scan ``data`` as the next frontier extension and carry the
        W-1 tail forward."""
        ends = self._scan(data, self._tail, self._scanned)
        self._cand.extend(ends.tolist())
        self._scanned += len(data)
        joined = self._tail + (bytes(data) if len(data) < WINDOW
                               else bytes(data[-(WINDOW - 1):]))
        self._tail = joined[-(WINDOW - 1):]

    def _flush_pending(self) -> None:
        if self._pending:
            data = bytes(self._pending)
            self._pending.clear()
            self._ingest(data)

    def feed(self, data: bytes) -> list[int]:
        if self._finalized:
            raise RuntimeError("chunker already finalized")
        if not data:
            return []
        if len(data) >= self._scan_block:
            # big feeds (the data plane's 4-8 MiB blocks) scan directly —
            # zero-copy: any small pending remainder scans first as its
            # own frontier extension (split points never move cuts)
            self._flush_pending()
            self._ingest(data)
            return self._drain(final=False)
        self._pending += data
        if len(self._pending) < self._scan_block:
            return []
        self._flush_pending()
        return self._drain(final=False)

    def finalize(self) -> list[int]:
        if self._finalized:
            return []
        self._finalized = True
        self._flush_pending()
        return self._drain(final=True)

    def _drain(self, final: bool) -> list[int]:
        # delegate to the single shared greedy pass (spec.select_cuts) so the
        # streaming and batch paths cannot fork the chunk format
        cuts = select_cuts(
            np.fromiter(self._cand, dtype=np.int64, count=len(self._cand)),
            self._scanned, self.params, start=self._chunk_start, final=final,
        )
        if cuts:
            self._chunk_start = cuts[-1]
            while self._cand and self._cand[0] <= self._chunk_start:
                self._cand.popleft()
        return cuts
