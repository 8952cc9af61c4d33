"""Resemblance index: the similarity-dedup tier's candidate oracle.

Counterpart of the JAX package's ``pxar/similarityindex.py``, with the
same surface and the same answers.  Identical-chunk dedup
(``pxar/chunkindex.py``) catches exact repeats; this index offers a
near-duplicate stored chunk as a delta base for a novel one:

- **Batched sketch computation per hash batch**: the write path hands a
  whole hash batch's novel chunks to ``presketch`` in ONE call.  The
  index's ``device`` decides the sketch program: on ``"cuda"`` it is
  ``ops.similarity.content_sketch_device`` on the card, on ``"cpu"`` the
  numpy twin ``content_sketch_host``; the two are bit-identical, and a
  failure on the card raises (the reference sniffs its JAX backend into a
  process global and drops to numpy on any exception).
- **Hamming-banded candidate lookup**: each 64-bit sketch splits into 4
  bands of 16 bits; a stored chunk is a candidate for a novel one when
  they share at least one full band.  The band union is augmented with a
  **recency window**: a linear exact scan of the last 128 inserted
  entries, where near-dup bases live in practice (the previous generation
  of the same stream).  Candidates rank by exact Hamming distance and the
  best one at ``<= threshold`` wins.
- **Chain-depth bookkeeping**: every entry carries its delta-chain depth
  (0 = full blob); candidates whose depth would push the new chunk past
  ``max_chain`` are rejected (counted in ``chain_rejects``).
- **GC coherence**: ``discard`` removes a digest's sketch + band
  entries; the chunk-store sweep calls it BEFORE unlinking the file.

Bounded memory: ``max_entries`` (default 1M) evicts oldest-inserted
entries.
"""

from __future__ import annotations

import logging
import threading
import weakref
from collections import OrderedDict, deque
from typing import Iterable, Sequence

import numpy as np

from ..ops.similarity import content_sketch_device, content_sketch_host
from ..utils.device import resolve

L = logging.getLogger(__name__)

_BANDS = 4
_BAND_BITS = 16
_BAND_MASK = (1 << _BAND_BITS) - 1
_BUCKET_CAP = 8          # entries per band bucket; oldest evicted past it
_RECENT_WINDOW = 128     # last-inserted entries scanned exactly per probe

DEFAULT_THRESHOLD = 14   # max Hamming distance (of 64) to delta-encode
DEFAULT_MAX_CHAIN = 3    # max delta-chain depth (base hops to raw bytes)


class SimilarityMetrics:
    """Process-global similarity-tier observability of the port (the JAX
    server renders only the JAX package's counters)."""

    _COUNTERS = ("probes", "candidates", "hits", "bytes_saved",
                 "chain_rejects", "encode_fallbacks", "delta_reads",
                 "base_resolves", "read_errors", "refolds")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)     # guarded-by: self._lock
        self._indexes: "weakref.WeakSet[SimilarityIndex]" = \
            weakref.WeakSet()                          # guarded-by: self._lock

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def register(self, index: "SimilarityIndex") -> None:
        with self._lock:
            self._indexes.add(index)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            live = list(self._indexes)
        out["entries"] = sum(len(i) for i in live)
        out["indexes"] = len(live)
        return out


METRICS = SimilarityMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


class SimilarityIndex:
    """Thread-safe banded sketch index over stored chunks."""

    def __init__(self, *, threshold: int = DEFAULT_THRESHOLD,
                 max_chain: int = DEFAULT_MAX_CHAIN,
                 max_entries: int = 1 << 20, device="cuda"):
        """``device``: ``"cuda"`` sketches on the card (raises without
        one), ``"cpu"`` with the numpy twin."""
        self.device = resolve(device)
        self.threshold = max(0, int(threshold))
        self.max_chain = max(1, int(max_chain))
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.RLock()
        # digest -> (sketch:int, depth:int); ordered for FIFO eviction
        self._entries: "OrderedDict[bytes, tuple[int, int]]" = \
            OrderedDict()                              # guarded-by: self._lock
        # (band, band_value) -> list of digests (capped); must stay
        # consistent with _entries — a band row pointing at a popped
        # entry is a wasted candidate, the reverse is a lost base
        self._bands: dict[tuple[int, int], list[bytes]] = \
            {}                                         # guarded-by: self._lock
        # most recent insertions, scanned exactly on every probe
        # (module docstring: boundary-drift recall)
        self._recent: "deque[bytes]" = \
            deque(maxlen=_RECENT_WINDOW)               # guarded-by: self._lock
        # digest -> sketch precomputed by the batched presketch pass,
        # consumed by the per-chunk insert that follows
        self._pending: dict[bytes, int] = {}           # guarded-by: self._lock
        # digest -> (pool digests, distances, pool set) precomputed by
        # the batched candidate preselect (one locked pass + one
        # vectorized popcount per hash batch — the delta-ENCODE half of
        # the fused ingest batch); consumed by take_candidate
        self._pending_cand: dict = {}                  # guarded-by: self._lock
        METRICS.register(self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- batched sketching -------------------------------------------------
    def sketch_batch(self, chunks: Sequence[bytes]) -> np.ndarray:
        """uint64[N] content sketches in one batched call on the index's
        device (an instance method: the reference's is static)."""
        if self.device.type == "cuda":
            return content_sketch_device(list(chunks), device=self.device)
        return content_sketch_host(list(chunks))

    def presketch(self, digests: Sequence[bytes], chunks: Sequence[bytes],
                  known: "Sequence[bool] | None") -> int:
        """Sketch every not-known chunk of a hash batch in ONE kernel
        call and stash the results for the per-chunk inserts that
        follow (the write path's batched entry point — transfer.py
        ``_flush_hashes`` / the pipelined batch committer).  Returns the
        number of sketches computed."""
        todo = [(d, c) for i, (d, c) in enumerate(zip(digests, chunks))
                if known is None or not known[i]]
        if not todo:
            return 0
        sketches = self.sketch_batch([c for _, c in todo])
        with self._lock:
            for (d, _c), s in zip(todo, sketches):
                self._pending[d] = int(s)
            # batched delta-candidate preselect rides the same locked
            # pass: one vectorized Hamming computation for the whole
            # batch instead of a per-chunk pool walk at insert time
            self._precandidate_locked([d for d, _ in todo],
                                      [int(s) for s in sketches])
            # writers abandon pending sketches when an insert races a
            # dedup hit; cap the stashes so they can never grow unbounded
            while len(self._pending) > 4096:
                self._pending.pop(next(iter(self._pending)))
            while len(self._pending_cand) > 4096:
                self._pending_cand.pop(next(iter(self._pending_cand)))
        return len(todo)

    def _precandidate_locked(self, digests: "list[bytes]",
                             sketches: "list[int]") -> None:
        """Stash each novel chunk's candidate pool + exact Hamming
        distances (caller holds the lock).  The pool is gathered in
        ``candidate()``'s iteration order (band buckets, then the
        recency window) and distances for ALL pool members of ALL batch
        chunks are computed in one ``np.bitwise_count`` pass; entries
        are immutable after ``add``, so stashed distances stay valid
        for the entries that remain live at consume time."""
        pools: "list[list[tuple[bytes, int]]]" = []
        for d, sk in zip(digests, sketches):
            seen: set = set()
            pool: "list[tuple[bytes, int]]" = []
            for key in self._band_keys(sk):
                for cd in self._bands.get(key, ()):
                    if cd == d or cd in seen:
                        continue
                    seen.add(cd)
                    ent = self._entries.get(cd)
                    if ent is not None:
                        pool.append((cd, ent[0]))
            for cd in self._recent:
                if cd == d or cd in seen:
                    continue
                seen.add(cd)
                ent = self._entries.get(cd)
                if ent is not None:
                    pool.append((cd, ent[0]))
            pools.append(pool)
        flat = sum(len(p) for p in pools)
        if flat:
            a = np.fromiter(
                (sk for sk, pool in zip(sketches, pools)
                 for _ in pool), dtype=np.uint64, count=flat)
            b = np.fromiter(
                (s for pool in pools for _, s in pool),
                dtype=np.uint64, count=flat)
            dists = np.bitwise_count(a ^ b).astype(np.int64)
        else:
            dists = np.empty(0, dtype=np.int64)
        k = 0
        for d, pool in zip(digests, pools):
            n = len(pool)
            self._pending_cand[d] = (
                [cd for cd, _ in pool], dists[k:k + n],
                {cd for cd, _ in pool})
            k += n

    def take_candidate(self, digest: bytes, sketch: int, *,
                       exclude: bytes = b"") -> "tuple[bytes, int] | None":
        """``candidate()`` with the batched preselect consumed: stashed
        pool distances are reused (the vectorized popcount paid once per
        batch), then the LIVE band buckets and recency window are
        re-walked for anything the stash predates — so the pool examined
        is always a superset of what a live ``candidate()`` walk would
        see, including bases inserted earlier in the same hash batch
        (even ones already rotated out of the recency window: their band
        rows are live).  Depth/liveness are re-read live.  Falls back to
        a full ``candidate()`` walk when no stash exists (inline/
        per-chunk writers)."""
        with self._lock:
            stash = self._pending_cand.pop(digest, None)
        if stash is None:
            return self.candidate(sketch, exclude=exclude)
        pool, dists, pool_set = stash
        METRICS.add("probes")
        best: "tuple[int, bytes, int] | None" = None
        rejected_depth = False
        examined = 0
        with self._lock:
            for cd, dist in zip(pool, dists):
                if cd == exclude:
                    continue
                ent = self._entries.get(cd)
                if ent is None:
                    continue
                examined += 1
                dist = int(dist)
                if dist > self.threshold:
                    continue
                if ent[1] + 1 > self.max_chain:
                    rejected_depth = True
                    continue
                if best is None or dist < best[0]:
                    best = (dist, cd, ent[1])
            # post-stash adds: everything candidate() would see live —
            # this chunk's band buckets plus the recency window —
            # distance-checked inline for members the stash predates
            # (typically zero, a handful during an active batch).
            # Walked in candidate()'s own deterministic order (bands,
            # then recent); on exact distance ties the stashed pool
            # still wins over a post-stash add — the one residual
            # tie-break divergence vs a fully-live walk.
            fresh_seen: set = set()
            fresh: "list[bytes]" = []
            for key in self._band_keys(sketch):
                for cd in self._bands.get(key, ()):
                    if cd not in fresh_seen:
                        fresh_seen.add(cd)
                        fresh.append(cd)
            for cd in self._recent:
                if cd not in fresh_seen:
                    fresh_seen.add(cd)
                    fresh.append(cd)
            for cd in fresh:
                if cd == digest or cd == exclude or cd in pool_set:
                    continue
                ent = self._entries.get(cd)
                if ent is None:
                    continue
                examined += 1
                dist = int(bin(ent[0] ^ sketch).count("1"))
                if dist > self.threshold:
                    continue
                if ent[1] + 1 > self.max_chain:
                    rejected_depth = True
                    continue
                if best is None or dist < best[0]:
                    best = (dist, cd, ent[1])
        if examined:
            METRICS.add("candidates", examined)
        if rejected_depth and best is None:
            METRICS.add("chain_rejects")
        if best is None:
            return None
        return best[1], best[2]

    def take_sketch(self, digest: bytes, chunk: bytes) -> int:
        """The sketch for one chunk: precomputed by ``presketch`` when
        the batch path ran, computed inline otherwise."""
        with self._lock:
            s = self._pending.pop(digest, None)
        if s is not None:
            return s
        return int(self.sketch_batch([chunk])[0])

    # -- candidate lookup --------------------------------------------------
    @staticmethod
    def _band_keys(sketch: int):
        for b in range(_BANDS):
            yield (b, (sketch >> (b * _BAND_BITS)) & _BAND_MASK)

    def candidate(self, sketch: int, *,
                  exclude: bytes = b"") -> "tuple[bytes, int] | None":
        """Best delta base for ``sketch``: the banded bucket union,
        ranked by exact Hamming distance, accepted at ``<= threshold``
        with chain depth ``< max_chain``.  → (base_digest, base_depth)
        or None."""
        METRICS.add("probes")
        best: "tuple[int, bytes, int] | None" = None
        rejected_depth = False
        with self._lock:
            seen: set[bytes] = set()
            pool = [d for key in self._band_keys(sketch)
                    for d in self._bands.get(key, ())]
            pool.extend(self._recent)
            for d in pool:
                if d in seen or d == exclude:
                    continue
                seen.add(d)
                ent = self._entries.get(d)
                if ent is None:
                    continue
                s, depth = ent
                dist = int(bin(s ^ sketch).count("1"))
                if dist > self.threshold:
                    continue
                if depth + 1 > self.max_chain:
                    rejected_depth = True
                    continue
                if best is None or dist < best[0]:
                    best = (dist, d, depth)
        if seen:
            METRICS.add("candidates", len(seen))
        if rejected_depth and best is None:
            METRICS.add("chain_rejects")
        if best is None:
            return None
        return best[1], best[2]

    # -- mutation ----------------------------------------------------------
    def add(self, digest: bytes, sketch: int, depth: int) -> None:
        with self._lock:
            if digest in self._entries:
                return
            self._entries[digest] = (int(sketch), int(depth))
            self._recent.append(digest)
            for key in self._band_keys(sketch):
                bucket = self._bands.setdefault(key, [])
                bucket.append(digest)
                if len(bucket) > _BUCKET_CAP:
                    bucket.pop(0)
            while len(self._entries) > self.max_entries:
                old, (old_sketch, _d) = self._entries.popitem(last=False)
                self._unband(old, old_sketch)

    def discard(self, digest: bytes) -> bool:
        """Forget a digest (GC sweep calls this BEFORE unlink — the
        sketch-discard-before-unlink ordering the chaos battery pins)."""
        with self._lock:
            ent = self._entries.pop(digest, None)
            if ent is None:
                self._pending.pop(digest, None)
                self._pending_cand.pop(digest, None)
                return False
            self._unband(digest, ent[0])
            self._pending.pop(digest, None)
            self._pending_cand.pop(digest, None)
            try:
                self._recent.remove(digest)
            except ValueError:
                # already rotated out of the window: expected — O(128)
                # scan only runs for entries still inside it
                L.debug("similarity: discard of %s past the recency "
                        "window", digest.hex()[:12])
            return True

    def _unband(self, digest: bytes, sketch: int) -> None:
        for key in self._band_keys(sketch):
            bucket = self._bands.get(key)
            if bucket is None:
                continue
            try:
                bucket.remove(digest)
            except ValueError:
                pass             # already band-evicted by the bucket cap
            if not bucket:
                del self._bands[key]

    def discard_many(self, digests: Iterable[bytes]) -> int:
        return sum(1 for d in digests if self.discard(d))

    # -- persistence (rides the dedup-index snapshot's sketch section,
    #    pxar/chunkindex.py) ------------------------------------------------
    def export_entries(self) -> "list[tuple[bytes, int, int]]":
        """(digest, sketch, depth) in insertion order — written into the
        ``.chunkindex`` snapshot after every sweep so a restarted server
        keeps offering pre-restart delta bases."""
        with self._lock:
            return [(d, s, dp) for d, (s, dp) in self._entries.items()]

    def load_entries(self,
                     entries: "Iterable[tuple[bytes, int, int]]") -> int:
        """Re-seed from persisted entries (insertion order preserved, so
        band buckets and the recency window rebuild exactly like the
        original insert sequence).  A stale entry — its chunk swept
        after the snapshot was saved — is only ever a wasted candidate:
        the writer's base fetch fails and drops it (module docstring)."""
        n = 0
        for d, s, dp in entries:
            self.add(d, s, dp)
            n += 1
        return n

    # -- introspection -----------------------------------------------------
    def has(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._entries

    def depth_of(self, digest: bytes) -> "int | None":
        with self._lock:
            ent = self._entries.get(digest)
            return None if ent is None else ent[1]
