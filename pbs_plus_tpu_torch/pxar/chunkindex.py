"""Dedup index: the authoritative membership front for chunk-store probes.

Counterpart of the JAX package's ``pxar/chunkindex.py``, with the same
surface, so a JAX ``ChunkStore(index=DedupIndex(device=...))`` runs on it.
``DedupIndex`` turns the port's ``ops/cuckoo.py`` index into a
process-resident, growable membership oracle in front of the chunk store:

- **Batched probe** (``probe_batch``): one vectorized filter pass per
  batch.  The index's ``device`` decides how: on ``"cuda"`` the pass is
  K3 (``CuckooIndex.probe``) on the card against the device copy of the
  table, which ``device_table`` keeps current by copying only the buckets
  that inserts, discards and evictions wrote; on ``"cpu"`` it is the numpy
  twin over the host mirror (``CuckooIndex.probe_host``), as the reference
  does on a CPU backend.  Nothing falls back from one to the other.
  Filter positives are confirmed against the exact tier before a chunk
  upload is skipped, so a fingerprint collision can never cause a false
  dedup skip -- it is only counted in ``false_positives``.
- **Negative probes never touch disk**; a positive pays at most one
  confirm (a set lookup, or a memtable hit or one fence-guided ``pread``
  of the spill tier).
- **Single-writer insert** (one lock per index).
- **Coherence with GC**: the sweep discards a digest from the index
  BEFORE unlinking its file, so the failure direction is always a safe
  false negative (re-store an existing chunk).
- **Boot**: the index rebuilds from a shard scan, or loads a snapshot
  (``save_snapshot``/``load_snapshot``).  The snapshot bytes are the
  reference's (``TPXI`` header, the digests, the DataBlob subset, a
  sha256 trailer, and the optional ``TPXS`` sketch section; or the
  ``TPXM`` manifest of the spill tier), so either package boots from the
  other's file.

Spillable exact tier: with a ``spill_dir`` the confirm set no longer
lives in RAM -- a bounded memtable (``resident_mb``) spills to immutable
sorted segments under ``<spill_dir>/segments/`` (``pxar/digestlog.py``),
so the resident cost is the filter table + memtable + fence pointers
regardless of chunk count.

The counters (``METRICS``) and the fs witness notes are the port's own:
the JAX server's metrics and witness read only the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import weakref
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..ops.cuckoo import SLOTS, CuckooIndex, buckets_for_bytes
from ..utils import atomicio, fswitness
from ..utils.device import resolve
from .digestlog import DigestLog
from .digestlog import FLAG_DATABLOB as _DATABLOB
from .digestlog import FLAG_TOMBSTONE as _TOMB
from .digestlog import MAN_MAGIC as _MAN_MAGIC

SNAP_MAGIC = b"TPXI"
SNAP_VERSION = 1
_SNAP_HDR = struct.Struct("<4sHHQQ")

# optional trailing sketch section: the similarity tier's resemblance entries persist alongside the exact
# index so a restarted server keeps offering pre-restart delta bases.
# Independently checksummed and strictly optional — a corrupt, truncated
# or absent section degrades to the organic sketch rebuild while the
# main digest payload still loads.
SKETCH_MAGIC = b"TPXS"
SKETCH_VERSION = 1
_SKETCH_HDR = struct.Struct("<4sHHQ")
_SKETCH_REC = struct.Struct("<32sQB")      # digest, sketch u64, depth u8

# per-entry resident estimate beyond the filter table: a 32-byte bytes
# object + set-slot overhead in the exact host set (CPython ≈ 89 B for
# the object, ~32 B amortized slot) — the gauge is an estimate
_SET_ENTRY_BYTES = 121


class IndexMetrics:
    """Process-global dedup-index observability of the port: cumulative
    counters plus resident bytes/entries summed over live indexes (the
    JAX server renders only the JAX package's counters)."""

    _COUNTERS = ("probes", "hits", "false_positives", "inserts",
                 "discards", "rebuilds", "snapshot_loads",
                 "snapshot_saves")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)     # guarded-by: self._lock
        self._indexes: "weakref.WeakSet[DedupIndex]" = \
            weakref.WeakSet()                          # guarded-by: self._lock

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def register(self, index: "DedupIndex") -> None:
        with self._lock:
            self._indexes.add(index)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            live = list(self._indexes)
        out["entries"] = sum(len(i) for i in live)
        out["resident_bytes"] = sum(i.resident_bytes for i in live)
        out["indexes"] = len(live)
        return out


METRICS = IndexMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


class DedupIndex:
    """Thread-safe membership oracle over a growable cuckoo filter.

    All mutation goes through one lock (single-writer discipline); the
    batched probe holds it only for the vectorized pass + exact
    confirm, so K3 launches from several threads (a shard node's HTTP
    handlers) are serialized here.  Answers are EXACT -- the filter's
    job is making the batched no-answer cheap and device-dispatchable."""

    def __init__(self, *, budget_mb: int = 64, seed: int = 0,
                 spill_dir: "str | None" = None,
                 resident_mb: int = 256, device="cuda"):
        """``spill_dir`` (the store's ``.chunkindex`` dir) activates the
        SPILLABLE exact-confirm tier (pxar/digestlog.py): the confirm set
        lives in a bounded memtable (``resident_mb``, the server's
        PBS_PLUS_DEDUP_RESIDENT_MB) backed by immutable sorted on-disk
        segments.  Without it the exact set stays fully in RAM.
        ``device``: ``"cuda"`` probes with K3 on the card (raises
        without one), ``"cpu"`` with the numpy twin."""
        self.device = resolve(device)
        self._lock = threading.RLock()
        # the filter + exact set are ONE coherent unit under _lock: a
        # probe against a half-swapped rebuild would answer wrongly
        self._cuckoo = CuckooIndex(                 # guarded-by: self._lock
            n_buckets=buckets_for_bytes(max(1, int(budget_mb)) << 20),
            seed=seed, device=self.device)
        self._datablob: set[bytes] = set()          # guarded-by: self._lock
        # bound once at construction, never reassigned — the log's own
        # contents are mutated only under self._lock (plus its internal
        # lock against the background compactor)
        self._log = None
        if spill_dir is not None:
            self._log = DigestLog(
                os.path.join(spill_dir, "segments"),
                budget_bytes=max(1, int(resident_mb)) << 20)
            # growth rebuilds stream the live digests back from the log
            # (mutation order contract: the log learns a digest BEFORE
            # its fingerprint lands, so a rebuild can never lose one)
            self._cuckoo.attach_digest_source(self._log.iter_live_digests)
        # boot state lives ON the index (not the owning store) so
        # stores SHARING one index — the server's per-job
        # chunker-override store — share one boot: whoever probes
        # first loads, the other sees `booted` and skips the scan
        self._booted = False
        self._boot_lock = threading.Lock()
        # sketch entries recovered by the last load_snapshot (consumed
        # by ChunkStore._boot_index into the similarity tier); None =
        # snapshot had no valid sketch section
        self.loaded_sketches: "list[tuple[bytes, int, int]] | None" = None
        METRICS.register(self)

    # -- boot gate (driven by ChunkStore's lazy `index` property) ----------
    @property
    def booted(self) -> bool:
        return self._booted

    def mark_booted(self) -> None:
        """Declare the current contents authoritative (caller
        pre-populated the index; no loader should ever run)."""
        self._booted = True

    def ensure_booted(self, loader) -> None:
        """Run ``loader()`` exactly once across every sharer before the
        first membership answer; concurrent callers serialize here."""
        if self._booted:
            return
        with self._boot_lock:
            if not self._booted:
                loader()
                self._booted = True

    # -- introspection (the guarded-by sweep found all four of these
    #    reading _cuckoo/_datablob lock-free while rebuild/load_snapshot
    #    swap them out; _lock is an RLock, so re-entry from locked
    #    callers stays cheap) ----------------------------------------------
    @property
    def spillable(self) -> bool:
        """True when the exact-confirm tier spills to disk segments."""
        return self._log is not None

    @property
    def digestlog(self):
        """The attached DigestLog (None in all-RAM mode) — tests and
        chip_smoke.py read its counters; nothing else may reach past it
        to the segment files."""
        return self._log

    def __len__(self) -> int:
        with self._lock:
            if self._log is not None:
                return self._log.live_count
            return len(self._cuckoo)

    @property
    def n_buckets(self) -> int:
        with self._lock:
            return self._cuckoo.n_buckets

    @property
    def table_bytes(self) -> int:
        with self._lock:
            return self._cuckoo._table.nbytes

    @property
    def resident_bytes(self) -> int:
        """ACTUAL resident cost: the filter table plus what the confirm
        tier really holds in RAM — memtable + fence pointers when
        spillable (the segments themselves are disk, not RAM), the
        whole exact set only in all-RAM mode."""
        with self._lock:
            if self._log is not None:
                return self._cuckoo._table.nbytes + self._log.resident_bytes
            return self._cuckoo._table.nbytes + _SET_ENTRY_BYTES * (
                len(self._cuckoo) + len(self._datablob))

    def digests(self) -> Iterator[bytes]:
        """Snapshot of the known digests (tests, persistence).  In
        spill mode this streams the merged memtable+segment view —
        ascending, tombstones applied."""
        with self._lock:
            if self._log is not None:
                return self._log.iter_live_digests()
            return iter(list(self._cuckoo._known))

    # -- membership --------------------------------------------------------
    def contains(self, digest: bytes) -> bool:
        """Exact single-digest membership.  All-RAM: a set lookup.
        Spillable: the scalar filter gates — a filter NEGATIVE answers
        without touching the log (disk-free), a positive pays one
        confirm (memtable hit or one fence-guided ``pread``)."""
        with self._lock:
            if self._log is not None:
                if not self._cuckoo.maybe_contains(digest):
                    hit = False
                else:
                    hit = self._log.contains(digest)
                    if not hit:
                        METRICS.add("false_positives")
            else:
                hit = self._cuckoo.contains_exact(digest)
        METRICS.add("probes")
        if hit:
            METRICS.add("hits")
        return hit

    def probe_batch(self, digests: Sequence[bytes]) -> "list[bool]":
        """One vectorized filter pass over the whole batch, exact-
        confirmed: digests (32-byte each) → [present?].  Filter
        positives that fail the exact confirm are counted as false
        positives and answered False — never a false dedup skip.  In
        spill mode only the filter POSITIVES reach the log (negatives
        stay structurally disk-free), sorted once so every segment is
        probed in one ascending sweep."""
        if not digests:
            return []
        arr = np.frombuffer(b"".join(digests),
                            dtype=np.uint8).reshape(-1, 32)
        with self._lock:
            if self._log is not None:
                maybe = self._probe_arr(arr)
                pos = np.flatnonzero(maybe)
                if len(pos):
                    flags = self._log.flags_arr(digests, arr, pos)
                    present = (flags >= 0) & \
                        ((flags & _TOMB) == 0)
                    out_arr = np.zeros(len(digests), dtype=bool)
                    out_arr[pos] = present
                    hits = int(present.sum())
                    fps = len(pos) - hits
                else:
                    out_arr = np.zeros(len(digests), dtype=bool)
                    hits = fps = 0
                out = out_arr.tolist()
            else:
                # .tolist() up front: iterating a numpy bool array
                # yields np.bool_ objects and is ~10x slower than plain
                # bools on this hot loop
                maybe = self._probe_arr(arr).tolist()
                known = self._cuckoo._known
                out = [m and d in known for m, d in zip(maybe, digests)]
                hits = out.count(True)
                fps = maybe.count(True) - hits
        METRICS.add("probes", len(digests))
        if hits:
            METRICS.add("hits", hits)
        if fps:
            METRICS.add("false_positives", fps)
        return out

    def _probe_arr(self, arr: np.ndarray) -> np.ndarray:
        """Maybe-present bool[N] for uint8[N,32]: K3 on the card when the
        index's device is CUDA (the device table is brought current by
        row copies first), the numpy host mirror when it is the CPU."""
        if self.device.type == "cuda":
            return self._cuckoo.probe(arr).cpu().numpy()
        return self._cuckoo.probe_host(arr)

    # -- mutation ----------------------------------------------------------
    def insert(self, digest: bytes) -> bool:
        with self._lock:
            if self._log is not None:
                if self._cuckoo.maybe_contains(digest):
                    if self._log.contains(digest):
                        return False
                    METRICS.add("false_positives")
                # the log learns the digest FIRST: a filter-growth
                # rebuild streams from it
                self._log.add(digest)
                self._cuckoo.insert_fp(digest)
                new = True
            else:
                new = self._cuckoo.insert(digest)
        if new:
            METRICS.add("inserts")
        return new

    def insert_many(self, digests: Iterable[bytes]) -> int:
        digests = list(digests)
        with self._lock:
            if self._log is not None:
                n = 0
                # bounded batches: the memtable budget check (and spill)
                # runs between batches, not after a 10^7 dict build
                for i in range(0, len(digests), 1 << 16):
                    n += self._insert_batch_spill(digests[i:i + (1 << 16)])
            else:
                n = self._cuckoo.insert_many(digests)
        if n:
            METRICS.add("inserts", n)
        return n

    def _insert_batch_spill(self, batch: "list[bytes]") -> int:
        for d in batch:
            if len(d) != 32:
                raise ValueError(f"digest must be 32 bytes, got {len(d)}")
        seen: set[bytes] = set()
        uniq = [d for d in batch if not (d in seen or seen.add(d))]
        arr = np.frombuffer(b"".join(uniq), dtype=np.uint8).reshape(-1, 32)
        maybe = self._probe_arr(arr)
        pos = np.flatnonzero(maybe)
        fresh_mask = np.ones(len(uniq), dtype=bool)
        if len(pos):
            flags = self._log.flags_arr(uniq, arr, pos)
            present = (flags >= 0) & ((flags & _TOMB) == 0)
            fresh_mask[pos[present]] = False
            fps = len(pos) - int(present.sum())
            if fps:
                METRICS.add("false_positives", fps)
        fresh = [uniq[i] for i in np.flatnonzero(fresh_mask).tolist()]
        if not fresh:
            return 0
        self._log.add_many(fresh)
        self._cuckoo.insert_fp_many(fresh)
        return len(fresh)

    def discard(self, digest: bytes) -> bool:
        with self._lock:
            if self._log is not None:
                if not self._cuckoo.maybe_contains(digest):
                    return False
                if not self._log.contains(digest):
                    METRICS.add("false_positives")
                    return False
                # tombstone BEFORE the fingerprint leaves: the failure
                # direction stays a safe false negative either way
                self._log.discard(digest)
                self._cuckoo.discard_fp(digest)
                fswitness.note("filter.remove", digest.hex())
                gone = True
            else:
                gone = self._cuckoo.discard(digest)
                self._datablob.discard(digest)
        if gone:
            METRICS.add("discards")
        return gone

    def discard_many(self, digests: Iterable[bytes]) -> int:
        return sum(1 for d in digests if self.discard(d))

    def discard_many_acked(self, digests: Sequence[bytes]
                           ) -> "list[bool]":
        """Per-digest discard ACKS for the sweep's discard-before-unlink
        protocol: True means the owning index has durably
        PROCESSED the discard — including "was never present" — so the
        caller may unlink the chunk file.  A local index can always ack;
        the distributed client answers False for digests whose owning
        shard did not confirm, and the sweep then leaves those files on
        disk (a safe false negative, never a resurrectable entry)."""
        for d in digests:
            self.discard(d)
            # the ack IS the discard-before-unlink fence: the witness
            # pairs this event against the sweep's chunk unlink
            fswitness.note("index.discard", d.hex())
        return [True] * len(digests)

    # -- whole-segment handoff (the distributed index's rebalance) ---------
    def export_segments(self) -> "list[tuple[str, str, int]]":
        """Freeze and describe the exact-confirm segments for a shard
        handoff: ``(name, trailer_hex, count)`` oldest → newest (the
        memtable flushes first, so the description covers everything).
        Spill mode only — an all-RAM index has no immutable checksummed
        artifact to ship."""
        with self._lock:
            if self._log is None:
                raise RuntimeError("segment handoff requires a spillable "
                                   "index (a spill_dir)")
            return self._log.export_segments()

    def export_segment_bytes(self, name: str) -> bytes:
        """One live segment's bytes, verbatim (see DigestLog)."""
        with self._lock:
            if self._log is None:
                raise RuntimeError("segment handoff requires a spillable "
                                   "index")
            return self._log.export_segment_bytes(name)

    def adopt_segment(self, raw: bytes, expected_trailer: bytes,
                      keep) -> int:
        """Adopt the owned subset of a shipped segment: the log
        verifies the bytes against ``expected_trailer``, filters by the
        vectorized ownership predicate ``keep``, and registers the kept
        rows as its newest run; the filter front then learns the kept
        LIVE digests via ``insert_fp_many`` (growth rebuilds keep
        streaming from the log through the already-attached
        ``attach_digest_source``).  Returns the number of live digests
        adopted; raises ValueError on any verification defect."""
        with self._lock:
            if self._log is None:
                raise RuntimeError("segment handoff requires a spillable "
                                   "index")
            live = self._log.adopt_segment(raw, expected_trailer, keep)
            if len(live):
                self._cuckoo.insert_fp_many(
                    [live[i].tobytes() for i in range(len(live))])
        if len(live):
            METRICS.add("inserts", len(live))
        return len(live)

    def rebuild(self, digests: Iterable[bytes]) -> int:
        """Reset to exactly ``digests`` (the boot-time shard scan).  In
        spill mode the stream lands straight in the log (spilling at
        budget — the scan's sorted order makes tidy runs) while the
        filter ingests fingerprints batch-wise."""
        with self._lock:
            if self._log is not None:
                self._log.reset()
                fresh = CuckooIndex(n_buckets=self._cuckoo.n_buckets,
                                    device=self.device)
                fresh.attach_digest_source(self._log.iter_live_digests)
                self._cuckoo = fresh
                n = 0
                batch: list[bytes] = []
                for d in digests:
                    batch.append(d)
                    if len(batch) == (1 << 16):
                        self._log.add_many(batch)
                        fresh.insert_fp_many(batch)
                        n += len(batch)
                        batch = []
                if batch:
                    self._log.add_many(batch)
                    fresh.insert_fp_many(batch)
                    n += len(batch)
            else:
                fresh = CuckooIndex(n_buckets=self._cuckoo.n_buckets,
                                    device=self.device)
                fresh.insert_many(list(digests))
                self._cuckoo = fresh
                n = len(fresh)
            self._datablob.clear()
        METRICS.add("rebuilds")
        return n

    # -- pbs DataBlob knowledge (the old capped _datablob_seen) ------------
    def is_datablob(self, digest: bytes) -> bool:
        with self._lock:
            if self._log is not None:
                if not self._cuckoo.maybe_contains(digest):
                    return False
                f = self._log.flags_of(digest)
                return f is not None and not f & _TOMB \
                    and bool(f & _DATABLOB)
            return digest in self._datablob

    def mark_datablob(self, digest: bytes) -> None:
        with self._lock:
            if self._log is not None:
                self._log.set_flags(digest, _DATABLOB)
            else:
                self._datablob.add(digest)

    # -- persistence -------------------------------------------------------
    @staticmethod
    def _sketch_section(sketches) -> bytes:
        shdr = _SKETCH_HDR.pack(SKETCH_MAGIC, SKETCH_VERSION, 0,
                                len(sketches))
        recs = b"".join(
            _SKETCH_REC.pack(d, s & ((1 << 64) - 1), min(255, dp))
            for d, s, dp in sketches)
        return shdr + recs + hashlib.sha256(shdr + recs).digest()

    def save_snapshot(self, path: str,
                      sketches: "list[tuple[bytes, int, int]] | None"
                      = None) -> None:
        """Atomic journaled snapshot.  All-RAM: header + known digests
        + DataBlob subset + sha256 trailer.  Spillable: the memtable
        spills to a durable segment and the snapshot becomes a THIN
        MANIFEST over the live segments (names + counts + per-segment
        trailer hashes) — boot re-opens the segment fences instead of
        re-reading every digest off the chunk store.  ``sketches`` —
        the similarity tier's (digest, sketch, depth) entries — append
        as an independently-checksummed optional section either way
        (corrupt/absent section → organic rebuild, main payload
        unaffected)."""
        with self._lock:
            if self._log is not None:
                # quiesce the compactor first: a merge finishing between
                # manifest_bytes() and the rename would unlink segments
                # the manifest just listed (the boot would then fall
                # back to the shard scan — safe, but a wasted save)
                self._log.drain()
                self._log.flush()
                body = self._log.manifest_bytes()
            else:
                known = sorted(self._cuckoo._known)
                blob = sorted(self._datablob)
                payload = b"".join(known) + b"".join(blob)
                hdr = _SNAP_HDR.pack(SNAP_MAGIC, SNAP_VERSION, 0,
                                     len(known), len(blob))
                body = hdr + payload + \
                    hashlib.sha256(hdr + payload).digest()
        if sketches is not None:
            body += self._sketch_section(sketches)
        atomicio.replace_bytes(path, body)
        METRICS.add("snapshot_saves")

    def load_snapshot(self, path: str) -> bool:
        """Replace contents from a snapshot; False (and unchanged) on a
        missing/corrupt/truncated file — the caller then rebuilds from
        a shard scan.  A spillable index loads either format: a TPXM
        manifest adopts the on-disk segments (fences only — no digest
        re-read), and a LEGACY TPXI snapshot loads once and migrates
        into segments (the digests stream through the memtable and
        spill).  A valid trailing sketch section lands in
        ``self.loaded_sketches`` for the similarity tier; any defect
        there leaves the main load intact and the sketches None."""
        self.loaded_sketches = None
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return False
        if raw[:4] == _MAN_MAGIC:
            return self._load_manifest(raw)
        if len(raw) < _SNAP_HDR.size + 32:
            return False
        magic, ver, _, n_known, n_blob = _SNAP_HDR.unpack_from(raw)
        if magic != SNAP_MAGIC or ver != SNAP_VERSION:
            return False
        body_end = _SNAP_HDR.size + 32 * (n_known + n_blob)
        if len(raw) < body_end + 32 or \
                hashlib.sha256(raw[:body_end]).digest() != \
                raw[body_end:body_end + 32]:
            return False
        off = _SNAP_HDR.size
        known = [raw[off + 32 * i:off + 32 * (i + 1)]
                 for i in range(n_known)]
        off += 32 * n_known
        blob = [raw[off + 32 * i:off + 32 * (i + 1)] for i in range(n_blob)]
        with self._lock:
            if self._log is not None:
                # legacy snapshot into a spillable index: load once,
                # migrate to segments (the next manifest save makes the
                # migration durable)
                self._log.reset()
                fresh = CuckooIndex(n_buckets=self._cuckoo.n_buckets,
                                    device=self.device)
                fresh.attach_digest_source(self._log.iter_live_digests)
                self._cuckoo = fresh
                blob_set = set(blob)
                for i in range(0, len(known), 1 << 16):
                    batch = known[i:i + (1 << 16)]
                    plain = [d for d in batch if d not in blob_set]
                    marked = [d for d in batch if d in blob_set]
                    if plain:
                        self._log.add_many(plain)
                    if marked:
                        self._log.add_many(marked, flags=_DATABLOB)
                    fresh.insert_fp_many(batch)
            else:
                fresh = CuckooIndex(n_buckets=self._cuckoo.n_buckets,
                                    device=self.device)
                fresh.insert_many(known)
                self._cuckoo = fresh
                self._datablob = set(blob)
        self.loaded_sketches = self._parse_sketch_section(
            raw, body_end + 32)
        METRICS.add("snapshot_loads")
        return True

    def _load_manifest(self, raw: bytes) -> bool:
        """Adopt a TPXM segment manifest (spillable mode only — an
        all-RAM index treats it as unloadable and the caller rebuilds
        from the shard scan).  The filter rebuilds from one sequential
        stream over the adopted segments; fences were already loaded by
        the manifest adoption, so boot never re-scans the chunk
        store."""
        if self._log is None:
            return False
        with self._lock:
            ok, consumed = self._log.load_manifest_bytes(raw)
            if not ok:
                return False
            nb = self._cuckoo.n_buckets
            count = self._log.live_count
            while count > nb * SLOTS * 0.85:
                nb *= 2
            fresh = CuckooIndex(n_buckets=nb, device=self.device)
            fresh.attach_digest_source(self._log.iter_live_digests)
            self._cuckoo = fresh
            batch: list[bytes] = []
            for d in self._log.iter_live_digests():
                batch.append(d)
                if len(batch) == (1 << 18):
                    fresh.insert_fp_many(batch)
                    batch = []
            if batch:
                fresh.insert_fp_many(batch)
        self.loaded_sketches = self._parse_sketch_section(raw, consumed)
        METRICS.add("snapshot_loads")
        return True

    @staticmethod
    def _parse_sketch_section(raw: bytes, start: int
                              ) -> "list[tuple[bytes, int, int]] | None":
        """The optional sketch section at ``start``; None on anything
        short of a fully-valid section (its own sha256 trailer must
        check out — a torn tail degrades to organic rebuild, never to
        half-loaded sketch state)."""
        if start >= len(raw):
            return None                       # v1 snapshot: no section
        sect = raw[start:]
        if len(sect) < _SKETCH_HDR.size + 32:
            return None
        magic, ver, _, count = _SKETCH_HDR.unpack_from(sect)
        if magic != SKETCH_MAGIC or ver != SKETCH_VERSION:
            return None
        body_end = _SKETCH_HDR.size + _SKETCH_REC.size * count
        if len(sect) != body_end + 32 or \
                hashlib.sha256(sect[:body_end]).digest() != \
                sect[body_end:]:
            return None
        out: list[tuple[bytes, int, int]] = []
        off = _SKETCH_HDR.size
        for _ in range(count):
            d, s, dp = _SKETCH_REC.unpack_from(sect, off)
            off += _SKETCH_REC.size
            out.append((d, s, dp))
        return out

