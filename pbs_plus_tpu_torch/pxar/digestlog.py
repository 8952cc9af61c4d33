"""Spillable exact-confirm tier: on-disk sorted digest segments behind
the cuckoo-filter front.

A copy of the JAX package's ``pxar/digestlog.py``.  Its segments and
manifests are byte-identical to the reference's for the same operations,
so either package boots from the other's files.  It imports nothing of
the JAX package: the atomic publish, fs witness, failpoint registry,
trace histograms and logger are the port's own copies.

The all-RAM confirm set costs ~120-160 B/digest of resident RAM, so
10^9 chunks would need ~150 GB.  ``DigestLog`` is the spill: an
LSM-shaped exact-membership store that bounds the resident confirm-tier
cost by ``budget_bytes`` (the server's ``PBS_PLUS_DEDUP_RESIDENT_MB``)
while keeping the probe discipline intact:

- **Memtable**: recent inserts live in a plain dict (digest -> flags).
  When its estimated resident cost crosses the budget it spills to a
  new immutable segment and empties.
- **Segments** (``<store>/.chunkindex/segments/*.seg``): fixed-width
  33-byte records (32-byte digest + 1 flags byte: tombstone / DataBlob
  knowledge), sorted ascending, immutable once renamed into place.
  Each segment carries a sha256 over its records in the header and a
  sha256 trailer over header+fence section, so a torn file is rejected
  structurally.
- **Fence pointers**: the first digest of every 124-record (~4 KiB)
  block, stored in the segment footer and held in RAM -- a confirm
  probe is one fence bisect + ONE ``pread`` of a ~4 KiB block + an
  in-block binary search.  Batched probes sort their digests once and
  sweep each segment ascending, newest segment first (a sweep that
  needs most of a segment's blocks reads the region in one go).
- **Tombstones**: ``discard`` writes a tombstone record (newest wins at
  lookup), so the GC sweep's discard-before-unlink ordering keeps its
  safe-false-negative failure direction.  Compaction drops a tombstone
  only when the merge includes the OLDEST segment.
- **Compaction**: a background thread merges adjacent segments into
  exponentially-larger runs (newest-first size-tiered policy), writing
  the merged output tmp+rename before the old pair leaves the live
  list -- a compaction killed at the ``pbsstore.digestlog.compact``
  failpoint leaves the old segments authoritative.
- **Negatives stay disk-free**: the DigestLog is only consulted for a
  filter POSITIVE (``chunkindex.DedupIndex`` gates every call), so an
  all-novel backup performs zero confirm reads.

Durability contract: the ``.chunkindex/snapshot`` file is a thin
MANIFEST over the live segments (names + counts + per-segment trailer
hashes), consumed (unlinked) as the store boots.  A crash between a
sweep's unlinks and the next manifest save leaves no manifest -- the
next boot falls back to the chunk-store shard scan and resets the
segment directory, so a stale segment never resurrects a swept digest.
"""

from __future__ import annotations

import logging
import bisect
import hashlib
import heapq
import os
import struct
import threading
import time
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..utils import atomicio, failpoints, fswitness, trace

L = logging.getLogger(__name__)

SEG_MAGIC = b"TPXG"
SEG_VERSION = 1
_SEG_HDR = struct.Struct("<4sHHQI32s")       # magic ver flags count
                                             # block_records records_sha
_FENCE_HDR = struct.Struct("<Q")             # n_blocks

MAN_MAGIC = b"TPXM"
MAN_VERSION = 1
_MAN_HDR = struct.Struct("<4sHHQQ")          # magic ver res n_segs live
_MAN_ENT = struct.Struct("<HQ")              # name_len, count (then name,
                                             # then 32-byte trailer sha)

REC_SIZE = 33                                # 32-byte digest + 1 flags byte
BLOCK_RECORDS = 124                          # ~4 KiB per probe block
BLOCK_BYTES = BLOCK_RECORDS * REC_SIZE

FLAG_TOMBSTONE = 0x01
FLAG_DATABLOB = 0x02

# resident-cost estimate per memtable entry: dict slot + 32-byte bytes
# key + small-int value (CPython ≈ 89 B for the key object, ~23 B
# amortized dict slot) — the budget check and the resident gauge both
# use it
_MEM_ENTRY_BYTES = 112
# per-fence resident estimate: 32-byte bytes object in the bisect list
# (+ object header) + one u64 mirror word
_FENCE_ENTRY_BYTES = 104


class LogMetrics:
    """Process-global digestlog observability of the port (the JAX
    server's metrics read only the JAX package's counters)."""

    _COUNTERS = ("spills", "compactions", "confirm_reads",
                 "compaction_failures")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)   # guarded-by: self._lock
        self._logs: "list[DigestLog]" = []           # guarded-by: self._lock

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def register(self, log: "DigestLog") -> None:
        import weakref
        with self._lock:
            self._logs = [x for x in self._logs if x() is not None]
            self._logs.append(weakref.ref(log))

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            live = [x() for x in self._logs]
        live = [x for x in live if x is not None]
        out["segments"] = sum(x.segment_count for x in live)
        out["resident_bytes"] = sum(x.resident_bytes for x in live)
        out["logs"] = len(live)
        return out


METRICS = LogMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def _words_of(digs: np.ndarray) -> np.ndarray:
    """uint8[N,32] → uint64[N,4] comparison words, NATIVE byte order
    (the ascending-bytes order of 32-byte digests IS the lexicographic
    order of these big-endian-read words; the astype materializes them
    native because numpy's searchsorted pays a per-element byteswap on
    non-native views — ~20x slower on the sweep hot path)."""
    return np.ascontiguousarray(digs).view(">u8").astype(
        np.uint64).reshape(-1, 4)


def _match_sorted(seg_w: np.ndarray, probe_w: np.ndarray
                  ) -> "tuple[np.ndarray, np.ndarray]":
    """Exact membership of sorted probes in sorted records, vectorized:
    both sides are uint64[·,4] big-endian word views.  Primary match by
    the first word via searchsorted; first-word collisions (two digests
    sharing their leading 8 bytes) resolve by advancing through the
    equal-word run — bounded by the run length, ~1 for real digests.
    Returns (found bool[K], row index int64[K])."""
    n = len(seg_w)
    pos = np.searchsorted(seg_w[:, 0], probe_w[:, 0], side="left")
    found = np.zeros(len(probe_w), dtype=bool)
    rows = np.zeros(len(probe_w), dtype=np.int64)
    active = pos < n
    cur = pos.copy()
    first = True
    while np.any(active):
        if first and bool(active.all()):
            idx = None                      # full first pass: no gathers
            c = cur
            cand = seg_w[np.minimum(c, n - 1)]
            pv = probe_w
        else:
            idx = np.flatnonzero(active)
            c = np.minimum(cur[idx], n - 1)
            cand = seg_w[c]                 # one (K,4) row gather
            pv = probe_w[idx]
        first = False
        same_w0 = cand[:, 0] == pv[:, 0]
        eq = (cand == pv).all(axis=1)
        hit = eq if idx is None else idx[eq]
        found[hit] = True
        rows[hit] = c[eq]
        # keep walking only probes whose first word still matches but
        # whose tail words did not (a leading-8-byte collision run)
        cont = same_w0 & ~eq
        walk = np.flatnonzero(cont) if idx is None else idx[cont]
        cur[walk] += 1
        active[:] = False
        active[walk] = cur[walk] < n
    return found, rows


class _Segment:
    """One immutable sorted run: open fd + in-RAM fence pointers.
    Readers ``pread`` through the fd, so a compaction may unlink the
    file while stragglers still read it — the fd stays valid."""

    __slots__ = ("path", "name", "count", "fd", "fences", "fence_w0",
                 "last", "trailer", "n_blocks", "records_sha")

    def __init__(self, path: str, name: str, count: int, fd: int,
                 fences: "list[bytes]", fence_w0: np.ndarray,
                 last: bytes, trailer: bytes, records_sha: bytes):
        self.path = path
        self.name = name
        self.count = count
        self.fd = fd
        self.fences = fences
        self.fence_w0 = fence_w0
        self.last = last
        self.trailer = trailer
        self.n_blocks = len(fences)
        self.records_sha = records_sha

    def close(self) -> None:
        fd, self.fd = self.fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception as e:                  # interpreter teardown
            L.debug("segment close at finalize: %s", e)

    # -- reads -------------------------------------------------------------
    def read_block(self, blk: int) -> bytes:
        off = _SEG_HDR.size + blk * BLOCK_BYTES
        ln = min(BLOCK_BYTES, self.count * REC_SIZE - blk * BLOCK_BYTES)
        t0 = time.perf_counter()
        raw = os.pread(self.fd, ln, off)
        METRICS.add("confirm_reads")
        trace.record("digestlog.confirm", time.perf_counter() - t0)
        return raw

    def read_records(self) -> np.ndarray:
        """The whole sorted record region as uint8[count, 33] (bulk
        sweeps and compaction; ONE sequential read)."""
        t0 = time.perf_counter()
        raw = os.pread(self.fd, self.count * REC_SIZE, _SEG_HDR.size)
        METRICS.add("confirm_reads")
        trace.record("digestlog.confirm", time.perf_counter() - t0)
        if len(raw) != self.count * REC_SIZE:
            raise IOError(f"segment {self.name}: short records read")
        return np.frombuffer(raw, dtype=np.uint8).reshape(-1, REC_SIZE)

    def iter_records(self, chunk_blocks: int = 256
                     ) -> Iterator[tuple[bytes, int]]:
        """(digest, flags) ascending, read in ~1 MiB slices."""
        per = chunk_blocks * BLOCK_BYTES
        total = self.count * REC_SIZE
        off = 0
        while off < total:
            raw = os.pread(self.fd, min(per, total - off),
                           _SEG_HDR.size + off)
            if not raw:
                raise IOError(f"segment {self.name}: short read at {off}")
            for i in range(0, len(raw) - len(raw) % REC_SIZE, REC_SIZE):
                yield raw[i:i + 32], raw[i + 32]
            off += len(raw) - len(raw) % REC_SIZE


def _write_segment_file(path: str, recs: np.ndarray) -> bytes:
    """Write sorted records uint8[N,33] as an immutable segment
    (tmp+rename); returns the trailer sha binding header+fences."""
    count = len(recs)
    records = recs.tobytes()
    records_sha = hashlib.sha256(records).digest()
    hdr = _SEG_HDR.pack(SEG_MAGIC, SEG_VERSION, 0, count,
                        BLOCK_RECORDS, records_sha)
    fences = np.ascontiguousarray(recs[::BLOCK_RECORDS, :32])
    fence_section = (_FENCE_HDR.pack(len(fences)) + fences.tobytes()
                     + recs[-1, :32].tobytes())
    trailer = hashlib.sha256(hdr + fence_section).digest()
    with atomicio.atomic_write(path) as f:
        f.write(hdr)
        f.write(records)
        f.write(fence_section)
        f.write(trailer)
    return trailer


def parse_segment_bytes(raw: bytes,
                        expected_trailer: "bytes | None" = None
                        ) -> np.ndarray:
    """Structurally verify a whole segment held in memory and return its
    records as uint8[count, 33].  On the distributed-index handoff path
    segments ship VERBATIM between index shards, and the
    receiver must prove the bytes it got are the bytes the source's
    manifest named before any record becomes live — header, size,
    records sha, fence count, and the sha256 trailer over header+fence
    section all check out, plus the out-of-band ``expected_trailer``
    when the caller carries one.  Raises ValueError on any defect (a
    rejected transfer is retried or dropped — a safe false negative,
    never a torn adoption)."""
    if len(raw) < _SEG_HDR.size + 32:
        raise ValueError("segment bytes truncated (header)")
    hdr = raw[:_SEG_HDR.size]
    magic, ver, _flags, count, block_records, records_sha = \
        _SEG_HDR.unpack(hdr)
    if magic != SEG_MAGIC or ver != SEG_VERSION \
            or block_records != BLOCK_RECORDS or count == 0:
        raise ValueError("bad segment header")
    n_blocks = (count + BLOCK_RECORDS - 1) // BLOCK_RECORDS
    fence_off = _SEG_HDR.size + count * REC_SIZE
    fence_len = _FENCE_HDR.size + n_blocks * 32 + 32
    if len(raw) != fence_off + fence_len + 32:
        raise ValueError("segment size mismatch")
    records = raw[_SEG_HDR.size:fence_off]
    if hashlib.sha256(records).digest() != records_sha:
        raise ValueError("records sha mismatch")
    fence_section = raw[fence_off:fence_off + fence_len]
    trailer = raw[fence_off + fence_len:]
    if hashlib.sha256(hdr + fence_section).digest() != trailer:
        raise ValueError("trailer mismatch")
    if expected_trailer is not None and trailer != expected_trailer:
        raise ValueError("expected/actual trailer mismatch")
    (got_blocks,) = _FENCE_HDR.unpack_from(fence_section)
    if got_blocks != n_blocks:
        raise ValueError("fence count mismatch")
    return np.frombuffer(records, dtype=np.uint8).reshape(-1, REC_SIZE)


def _open_segment(path: str, expected_trailer: "bytes | None" = None
                  ) -> "_Segment | None":
    """Open + structurally verify a segment: header, file size, and the
    sha256 trailer over header+fence section must all check out (the
    records sha in the header is verified lazily, when a compaction
    reads the full region).  None on any defect — the caller treats the
    segment as lost, which is always a safe false negative."""
    name = os.path.basename(path)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        hdr = os.pread(fd, _SEG_HDR.size, 0)
        if len(hdr) != _SEG_HDR.size:
            raise ValueError("short header")
        magic, ver, _flags, count, block_records, records_sha = \
            _SEG_HDR.unpack(hdr)
        if magic != SEG_MAGIC or ver != SEG_VERSION \
                or block_records != BLOCK_RECORDS or count == 0:
            raise ValueError("bad header")
        n_blocks = (count + BLOCK_RECORDS - 1) // BLOCK_RECORDS
        fence_off = _SEG_HDR.size + count * REC_SIZE
        fence_len = _FENCE_HDR.size + n_blocks * 32 + 32
        want_size = fence_off + fence_len + 32
        if os.fstat(fd).st_size != want_size:
            raise ValueError("size mismatch")
        tail = os.pread(fd, fence_len + 32, fence_off)
        fence_section, trailer = tail[:fence_len], tail[fence_len:]
        if hashlib.sha256(hdr + fence_section).digest() != trailer:
            raise ValueError("trailer mismatch")
        if expected_trailer is not None and trailer != expected_trailer:
            raise ValueError("manifest/segment trailer mismatch")
        (got_blocks,) = _FENCE_HDR.unpack_from(fence_section)
        if got_blocks != n_blocks:
            raise ValueError("fence count mismatch")
        farr = np.frombuffer(fence_section, dtype=np.uint8,
                             count=n_blocks * 32,
                             offset=_FENCE_HDR.size).reshape(-1, 32)
        fences = [farr[i].tobytes() for i in range(n_blocks)]
        fence_w0 = _words_of(farr)[:, 0].copy()
        last = fence_section[-32:]
        return _Segment(path, name, count, fd, fences, fence_w0,
                        last, trailer, records_sha)
    except (ValueError, OSError) as e:
        L.warning("digestlog segment %s rejected: %s", name, e)
        try:
            os.close(fd)
        except OSError:
            pass
        return None


class DigestLog:
    """The spillable exact-membership store.  All mutation is driven by
    ``chunkindex.DedupIndex`` under ITS lock (single-writer discipline);
    the internal lock exists to serialize against the background
    compactor.  Lock order: DedupIndex._lock → DigestLog._lock (the
    compactor takes only the latter)."""

    def __init__(self, root: str, *, budget_bytes: int = 256 << 20):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._mem: dict[bytes, int] = {}        # guarded-by: self._lock
        self._segs: "list[_Segment]" = []       # guarded-by: self._lock
                                                # (oldest → newest)
        self._live = 0                          # guarded-by: self._lock
        self._seq = 0
        self._budget = max(1 << 20, int(budget_bytes))
        self._compactor: "threading.Thread | None" = None
        METRICS.register(self)

    # -- introspection -----------------------------------------------------
    @property
    def live_count(self) -> int:
        with self._lock:
            return self._live

    @property
    def segment_count(self) -> int:
        with self._lock:
            return len(self._segs)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            fences = sum(s.n_blocks for s in self._segs)
            return (len(self._mem) * _MEM_ENTRY_BYTES
                    + fences * _FENCE_ENTRY_BYTES
                    + len(self._segs) * 256)

    @property
    def budget_bytes(self) -> int:
        return self._budget

    # -- membership --------------------------------------------------------
    def flags_of(self, digest: bytes) -> "int | None":
        """Newest-wins flags for one digest: memtable, then segments
        newest→oldest.  None = never recorded; a tombstone answers its
        own flags (callers check FLAG_TOMBSTONE)."""
        with self._lock:
            f = self._mem.get(digest)
            if f is not None:
                return f
            segs = list(self._segs)
        for seg in reversed(segs):
            f = self._seg_flags(seg, digest)
            if f is not None:
                return f
        return None

    def contains(self, digest: bytes) -> bool:
        f = self.flags_of(digest)
        return f is not None and not f & FLAG_TOMBSTONE

    def _seg_flags(self, seg: _Segment, digest: bytes) -> "int | None":
        if not seg.fences or digest < seg.fences[0] or digest > seg.last:
            return None
        blk = bisect.bisect_right(seg.fences, digest) - 1
        raw = seg.read_block(blk)
        lo, hi = 0, len(raw) // REC_SIZE
        while lo < hi:
            mid = (lo + hi) // 2
            d = raw[mid * REC_SIZE:mid * REC_SIZE + 32]
            if d == digest:
                return raw[mid * REC_SIZE + 32]
            if d < digest:
                lo = mid + 1
            else:
                hi = mid
        return None

    def flags_arr(self, digests: Sequence[bytes], arr: np.ndarray,
                  idx: np.ndarray) -> np.ndarray:
        """Batched ``flags_of`` over ``arr[idx]`` (uint8[N,32] rows of
        the already-materialized probe batch): one sweep per segment,
        newest first, each resolving its share in block-grouped preads
        — or a single sequential region read when the sweep would
        touch most blocks anyway.  Returns int16[len(idx)]: -1 = never
        recorded, else the newest-wins flags byte (callers test
        FLAG_TOMBSTONE)."""
        m = len(idx)
        res = np.full(m, -1, dtype=np.int16)
        with self._lock:
            mem = self._mem
            if mem:
                for k, i in enumerate(idx.tolist()):
                    f = mem.get(digests[i])
                    if f is not None:
                        res[k] = f
            segs = list(self._segs)
        if not segs:
            return res
        open_k = np.flatnonzero(res < 0)
        if not len(open_k):
            return res
        # one contiguous copy of the unresolved probes, sorted by their
        # leading word.  Correctness never needs the sort (every
        # placement is an independent searchsorted), but sorted queries
        # walk the records' binary-search tree with cache locality —
        # measured ~13x faster than the identical searchsorted with
        # random query order — which is what makes the "one ascending
        # sweep per segment" claim real
        sub = np.ascontiguousarray(arr[idx[open_k]])
        sw = _words_of(sub)
        order = np.argsort(sw[:, 0])
        sw = np.ascontiguousarray(sw[order])
        unresolved = np.arange(len(open_k))
        for seg in reversed(segs):
            if not len(unresolved):
                break
            flags, mask = self._seg_sweep(seg, sub, order, sw,
                                          unresolved)
            hit = unresolved[mask]
            res[open_k[order[hit]]] = flags.astype(np.int16)
            unresolved = unresolved[~mask]
        return res

    def flags_many(self, digests: Sequence[bytes]) -> "list[int | None]":
        if not digests:
            return []
        arr = np.frombuffer(b"".join(digests),
                            dtype=np.uint8).reshape(-1, 32)
        res = self.flags_arr(digests, arr, np.arange(len(digests)))
        return [None if v < 0 else int(v) for v in res.tolist()]

    def _seg_sweep(self, seg: _Segment, sub: np.ndarray,
                   order: np.ndarray, sw: np.ndarray,
                   idxs: np.ndarray
                   ) -> "tuple[np.ndarray, np.ndarray]":
        """Resolve the probe subset ``idxs`` against one segment;
        returns (flags for found, found-mask over idxs).  ``sw`` is
        sorted by leading word; ``sub``/``order`` recover the raw
        digest bytes for the rare fence-collision fallback."""
        pw = sw if len(idxs) == len(sw) else sw[idxs]
        # dense sweep: when the probes would touch a third of the
        # blocks anyway, skip the fence work entirely — one sequential
        # region read + one sorted match beats per-block preads AND the
        # per-probe block assignment
        if len(idxs) * BLOCK_RECORDS * 3 >= seg.count:
            recs = seg.read_records()
            rw = _words_of(recs[:, :32])
            found = np.zeros(len(idxs), dtype=bool)
            flags = np.zeros(len(idxs), dtype=np.uint8)
            got, rows = _match_sorted(rw, pw)
            found[got] = True
            flags[got] = recs[rows[got], 32]
            return flags[found], found
        # block assignment by leading word; a probe whose leading word
        # equals any fence's leading word resolves exactly via the
        # bytes-level bisect (leading-8-byte fence collisions)
        blk = np.searchsorted(seg.fence_w0, pw[:, 0], side="right") - 1
        f_pos = np.searchsorted(seg.fence_w0, pw[:, 0], side="left")
        amb = (f_pos < seg.n_blocks) & \
            (seg.fence_w0[np.minimum(f_pos, seg.n_blocks - 1)] == pw[:, 0])
        if np.any(amb):
            for j in np.flatnonzero(amb).tolist():
                d = sub[order[idxs[j]]].tobytes()
                blk[j] = bisect.bisect_right(seg.fences, d) - 1
        valid = blk >= 0
        found = np.zeros(len(idxs), dtype=bool)
        flags = np.zeros(len(idxs), dtype=np.uint8)
        if not np.any(valid):
            return flags[found], found
        need = np.unique(blk[valid])
        for b in need.tolist():
            sel = np.flatnonzero(valid & (blk == b))
            raw = seg.read_block(b)
            recs = np.frombuffer(raw, dtype=np.uint8).reshape(-1, REC_SIZE)
            rw = _words_of(recs[:, :32])
            got, rows = _match_sorted(rw, pw[sel])
            found[sel[got]] = True
            flags[sel[got]] = recs[rows[got], 32]
        return flags[found], found

    def contains_many(self, digests: Sequence[bytes]) -> "list[bool]":
        return [f is not None and not f & FLAG_TOMBSTONE
                for f in self.flags_many(digests)]

    # -- mutation (caller = DedupIndex, which owns membership truth) -------
    def add(self, digest: bytes, flags: int = 0) -> None:
        """Record a digest the caller confirmed ABSENT (the count
        contract: adds are pre-probed, so live membership is counted
        here, not re-derived from disk)."""
        with self._lock:
            self._mem[digest] = flags & ~FLAG_TOMBSTONE
            self._live += 1
            self._maybe_spill()

    def add_many(self, digests: Iterable[bytes], flags: int = 0) -> int:
        """Bulk ``add`` — same pre-probed-absent contract, one budget
        check per batch (callers feed bounded batches)."""
        flags &= ~FLAG_TOMBSTONE
        with self._lock:
            n = 0
            for d in digests:
                self._mem[d] = flags
                n += 1
            self._live += n
            self._maybe_spill()
        return n

    def set_flags(self, digest: bytes, flags: int) -> None:
        """OR extra flags onto a PRESENT digest (DataBlob knowledge).
        A spilled digest gets a shadow memtable record — newest wins at
        lookup, compaction folds it down."""
        with self._lock:
            cur = self._mem.get(digest)
            if cur is not None and not cur & FLAG_TOMBSTONE:
                self._mem[digest] = cur | (flags & ~FLAG_TOMBSTONE)
            else:
                self._mem[digest] = flags & ~FLAG_TOMBSTONE
                self._maybe_spill()

    def discard(self, digest: bytes) -> None:
        """Tombstone a digest the caller confirmed PRESENT.  With no
        segments the memtable entry just disappears; otherwise the
        tombstone persists (and spills) until compaction proves no
        older run still carries the digest."""
        with self._lock:
            self._live -= 1
            if not self._segs:
                self._mem.pop(digest, None)
            else:
                self._mem[digest] = FLAG_TOMBSTONE
                self._maybe_spill()
        # tombstone recorded BEFORE the caller drops the filter
        # fingerprint — the witness pairs these two events
        fswitness.note("digestlog.tombstone", digest.hex())

    # -- spill / flush -----------------------------------------------------
    def _maybe_spill(self) -> None:
        if len(self._mem) * _MEM_ENTRY_BYTES >= self._budget:
            self._flush_locked()
            self.compact()

    def flush(self) -> bool:
        """Spill the memtable to a new segment (durable).  True when a
        segment was written."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> bool:
        if not self._mem:
            return False
        items = sorted(self._mem.items())
        if not self._segs:
            # nothing older to mask: tombstones are pure noise
            items = [(d, f) for d, f in items if not f & FLAG_TOMBSTONE]
        if not items:
            self._mem = {}
            return False
        recs = np.empty((len(items), REC_SIZE), dtype=np.uint8)
        recs[:, :32] = np.frombuffer(
            b"".join(d for d, _ in items), dtype=np.uint8).reshape(-1, 32)
        recs[:, 32] = np.fromiter((f for _, f in items), dtype=np.uint8,
                                  count=len(items))
        seg = self._write_new_segment(recs)
        self._segs.append(seg)
        self._mem = {}
        METRICS.add("spills")
        return True

    def _write_new_segment(self, recs: np.ndarray) -> _Segment:
        name = f"{self._seq:016d}.seg"
        self._seq += 1
        path = os.path.join(self.root, name)
        trailer = _write_segment_file(path, recs)
        seg = _open_segment(path, trailer)
        if seg is None:                  # just wrote it: disk is broken
            raise IOError(f"freshly written segment {name} unreadable")
        return seg

    # -- compaction --------------------------------------------------------
    def compact(self, wait: bool = False) -> None:
        """Schedule (or, with ``wait``, run to completion) the
        size-tiered merge pass on the background compactor thread."""
        with self._lock:
            t = self._compactor
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._compact_pass,
                                     name="digestlog-compact",
                                     daemon=True)
                self._compactor = t
                t.start()
        if wait:
            t.join()

    def drain(self) -> None:
        """Block until no compaction is running (tests, shutdown)."""
        with self._lock:
            t = self._compactor
        if t is not None:
            t.join()

    def _pick_merge(self) -> "tuple[_Segment, _Segment] | None":
        # newest-first size-tiered: merge the newest adjacent pair whose
        # older member is not already exponentially larger — segments
        # settle into geometrically-growing runs, oldest largest
        for i in range(len(self._segs) - 2, -1, -1):
            if self._segs[i].count <= 2 * self._segs[i + 1].count:
                return self._segs[i], self._segs[i + 1]
        return None

    def _compact_pass(self) -> None:
        while True:
            with self._lock:
                pair = self._pick_merge()
            if pair is None:
                return
            try:
                self._merge_pair(*pair)
            except failpoints.FailpointError as e:
                METRICS.add("compaction_failures")
                L.warning("digestlog compaction failpoint: %s — old "
                          "segments stay authoritative", e)
                return
            except (OSError, IOError, ValueError) as e:
                METRICS.add("compaction_failures")
                L.warning("digestlog compaction failed: %s — old "
                          "segments stay authoritative", e)
                return

    def _merge_pair(self, older: _Segment, newer: _Segment) -> None:
        """Merge two adjacent runs, newest-wins per digest.  Tombstones
        drop only when ``older`` is the oldest live segment (no earlier
        run can still carry the masked digest).  The merged output is
        fully durable (tmp+rename) BEFORE the inputs leave the live
        list; a crash or injected fault anywhere leaves the old pair
        authoritative."""
        failpoints.hit("pbsstore.digestlog.compact")
        a = older.read_records()
        b = newer.read_records()
        if hashlib.sha256(a.tobytes()).digest() != older.records_sha or \
                hashlib.sha256(b.tobytes()).digest() != newer.records_sha:
            raise IOError("segment records corrupt (sha mismatch); "
                          "compaction refused")
        recs = np.vstack([a, b])
        w = _words_of(recs[:, :32])
        # rank: newer first among equal digests (stable lexsort keeps
        # the LOWER rank first) — b's records must win
        rank = np.r_[np.ones(len(a), np.uint8), np.zeros(len(b), np.uint8)]
        order = np.lexsort((rank, w[:, 3], w[:, 2], w[:, 1], w[:, 0]))
        sw = w[order]
        first = np.r_[True, np.any(sw[1:] != sw[:-1], axis=1)]
        winners = recs[order[first]]
        with self._lock:
            drop_tombstones = self._segs and self._segs[0] is older
        if drop_tombstones:
            winners = winners[(winners[:, 32] & FLAG_TOMBSTONE) == 0]
        # materialize the merged run OUTSIDE the lock: at scale this is
        # a multi-GB sha256+write, and probes/inserts must not stall
        # behind it — the lock is taken only to allocate the name and,
        # below, for the O(1) list splice
        merged = None
        if len(winners):
            with self._lock:
                name = f"{self._seq:016d}.seg"
                self._seq += 1
            path = os.path.join(self.root, name)
            trailer = _write_segment_file(path, winners)
            merged = _open_segment(path, trailer)
            if merged is None:       # just wrote it: disk is broken
                raise IOError(f"merged segment {name} unreadable")
        with self._lock:
            try:
                ia = self._segs.index(older)
            except ValueError:
                # a concurrent reset took the pair; drop the orphan
                if merged is not None:
                    merged.close()
                    try:
                        os.unlink(merged.path)
                    except OSError as e:
                        L.debug("orphan merged segment: %s", e)
                return
            self._segs[ia:ia + 2] = [merged] if merged is not None else []
            METRICS.add("compactions")
        for seg in (older, newer):
            try:
                os.unlink(seg.path)
            except OSError as e:
                L.debug("compacted segment unlink %s: %s", seg.name, e)

    # -- iteration (merged, tombstones applied) ----------------------------
    def iter_live(self) -> Iterator[tuple[bytes, int]]:
        """(digest, flags) over the LIVE set, ascending, newest-wins.
        Sources snapshot under the lock; segment readers pread through
        held fds, so concurrent compaction cannot corrupt the walk."""
        with self._lock:
            mem_items = sorted(self._mem.items())
            segs = list(self._segs)

        def src(rank: int, it):
            for d, f in it:
                yield d, rank, f

        sources = [src(0, iter(mem_items))]
        for r, seg in enumerate(reversed(segs), start=1):
            sources.append(src(r, seg.iter_records()))
        last = None
        for d, _r, f in heapq.merge(*sources):
            if d == last:
                continue
            last = d
            if f & FLAG_TOMBSTONE:
                continue
            yield d, f

    def iter_live_digests(self) -> Iterator[bytes]:
        for d, _f in self.iter_live():
            yield d

    # -- whole-segment handoff (the distributed index's rebalance) ---------
    def export_segments(self) -> "list[tuple[str, str, int]]":
        """Freeze the live set into segments and describe them for a
        shard handoff: flush the memtable first (so every record —
        tombstones included — lives in an immutable checksummed file),
        then return ``(name, trailer_hex, count)`` oldest → newest.
        The order matters: the receiver adopts in this order so its
        newest-wins lookup preserves the source's tombstone shadowing."""
        self.flush()
        with self._lock:
            return [(s.name, s.trailer.hex(), s.count)
                    for s in self._segs]

    def export_segment_bytes(self, name: str) -> bytes:
        """One live segment's file bytes, VERBATIM (the handoff ships
        the immutable artifact the way sync ships chunks — the trailer
        from ``export_segments`` lets every hop re-verify).  Raises
        KeyError for names not in the live set: stray or compacted-away
        files never cross the wire."""
        with self._lock:
            seg = next((s for s in self._segs if s.name == name), None)
            if seg is None:
                raise KeyError(f"segment {name!r} is not live")
            path, count = seg.path, seg.count
        n_blocks = (count + BLOCK_RECORDS - 1) // BLOCK_RECORDS
        size = (_SEG_HDR.size + count * REC_SIZE
                + _FENCE_HDR.size + n_blocks * 32 + 32 + 32)
        with open(path, "rb") as f:
            return f.read(size)

    def adopt_segment(self, raw: bytes, expected_trailer: bytes,
                      keep) -> np.ndarray:
        """Adopt the subset of a shipped segment this log should own.
        The raw bytes are fully re-verified against ``expected_trailer``
        (``parse_segment_bytes``), then ``keep(arr)`` — a vectorized
        uint8[N,32] → bool[N] ownership predicate — filters the records,
        and the kept rows (flags intact, tombstones included so newer
        kills keep shadowing older adoptions) are written as a NEW
        immutable segment under this log's own name sequence.  Returns
        the kept LIVE digests as uint8[K,32] so the caller can teach its
        filter front.  Raises ValueError on any verification defect."""
        recs = parse_segment_bytes(raw, expected_trailer)
        mask = np.asarray(keep(recs[:, :32]), dtype=bool)
        if mask.shape != (len(recs),):
            raise ValueError("keep predicate arity mismatch")
        kept = np.ascontiguousarray(recs[mask])
        live_rows = kept[(kept[:, 32] & FLAG_TOMBSTONE) == 0]
        with self._lock:
            if len(kept):
                seg = self._write_new_segment(kept)
                self._segs.append(seg)
            # moved ranges are disjoint from prior holdings (the source
            # owned them), so kept-live counts straight onto _live
            self._live += len(live_rows)
        return np.ascontiguousarray(live_rows[:, :32])

    # -- manifest ----------------------------------------------------------
    def manifest_bytes(self) -> bytes:
        """The thin consume-once manifest over the live segments (the
        caller flushes first and writes this tmp+rename at the
        `.chunkindex/snapshot` path)."""
        with self._lock:
            segs = list(self._segs)
            live = self._live
        body = bytearray(_MAN_HDR.pack(MAN_MAGIC, MAN_VERSION, 0,
                                       len(segs), live))
        for s in segs:
            nb = s.name.encode()
            body += _MAN_ENT.pack(len(nb), s.count)
            body += nb
            body += s.trailer
        return bytes(body) + hashlib.sha256(bytes(body)).digest()

    def load_manifest_bytes(self, raw: bytes) -> "tuple[bool, int]":
        """Adopt the segment set a manifest describes: every listed
        segment must open and its trailer must match the manifest's
        record.  Returns (ok, bytes consumed); any defect loads NOTHING
        (the caller falls back to the shard-scan rebuild).  Stray files
        in the segment dir (crashed compactions, unlisted runs) are
        reaped — only the manifest's view is authoritative."""
        if len(raw) < _MAN_HDR.size + 32 or raw[:4] != MAN_MAGIC:
            return False, 0
        magic, ver, _res, n_segs, live = _MAN_HDR.unpack_from(raw)
        if ver != MAN_VERSION:
            return False, 0
        off = _MAN_HDR.size
        entries: "list[tuple[str, int, bytes]]" = []
        try:
            for _ in range(n_segs):
                nlen, count = _MAN_ENT.unpack_from(raw, off)
                off += _MAN_ENT.size
                name = raw[off:off + nlen].decode()
                off += nlen
                trailer = raw[off:off + 32]
                off += 32
                if len(trailer) != 32 or os.sep in name or not name:
                    return False, 0
                entries.append((name, count, trailer))
        except (struct.error, UnicodeDecodeError):
            return False, 0
        if len(raw) < off + 32 or \
                hashlib.sha256(raw[:off]).digest() != raw[off:off + 32]:
            return False, 0
        segs: "list[_Segment]" = []
        for name, count, trailer in entries:
            seg = _open_segment(os.path.join(self.root, name), trailer)
            if seg is None or seg.count != count:
                for s in segs:
                    s.close()
                return False, 0
            segs.append(seg)
        with self._lock:
            for s in self._segs:
                s.close()
            self._segs = segs
            self._mem = {}
            self._live = live
            seqs = [int(s.name.split(".")[0]) for s in segs
                    if s.name.split(".")[0].isdigit()]
            self._seq = max(seqs, default=-1) + 1
            keep = {s.name for s in segs}
        self._reap_strays(keep)
        return True, off + 32

    def _reap_strays(self, keep: "set[str]") -> None:
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if name in keep:
                continue
            try:
                os.unlink(os.path.join(self.root, name))
            except OSError as e:
                L.debug("digestlog stray %s not reaped: %s", name, e)

    def reset(self) -> None:
        """Drop everything — memtable, segments, stray files.  The
        shard-scan rebuild path starts here, so a scan can never merge
        with stale segment state."""
        self.drain()
        with self._lock:
            for s in self._segs:
                s.close()
            self._segs = []
            self._mem = {}
            self._live = 0
        self._reap_strays(set())
