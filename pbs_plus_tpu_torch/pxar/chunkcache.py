"""Shared read-path chunk cache: lock-sharded, scan-resistant segments
of decompressed, verified chunks, with single-flight fetch and adaptive
sequential readahead.

Every read consumer — restore, verification, FUSE mounts, zip download,
ranged ``pxar.read_at`` over aRPC — used to go through ``ChunkStore.get``
one chunk at a time, paying open+read+decompress+SHA-256 per call with
zero caching; a file served in small RPC windows re-decompressed the
same 2-4 MiB chunk dozens of times.  This module puts one process-wide
cache in front of every chunk source (docs/data-plane.md "Read path"):

- **Lock-sharded segments**: the budget splits across N digest-sharded
  segments, each with its own lock — hundreds of concurrent mount
  readers hash across segments instead of convoying on one mutex.  The
  shard count adapts to the budget (small test caches collapse to one
  segment and keep exact LRU accounting); single-flight stays
  cache-global, so concurrent readers of one digest coalesce across
  shards.
- **Scan resistance (segmented LRU)**: each segment splits into a
  probationary and a protected region.  First-touch admissions enter
  probation; a re-reference promotes to protected.  Evictions drain
  probation first, so one sequential restore scan (every chunk touched
  exactly once) churns through probation without evicting the hot
  Zipf working set that mount serving promoted.
- **Verify-once**: a chunk is SHA-256-checked when it is loaded (every
  chunk source's ``get`` verifies against the digest) and never
  re-hashed on a hit.  Safe because chunks are content-addressed and
  immutable — sweep/re-insert cannot change a digest's bytes, so a
  verified resident copy stays correct for the digest's lifetime.  A
  load failure (corrupt on disk, transport fault) propagates to the
  caller and the chunk is NEVER admitted.
- **Single-flight**: concurrent readers of one digest trigger exactly
  one underlying load (``utils.singleflight.ThreadSingleFlight``); the
  rest block and share the decompressed bytes.
- **Adaptive readahead**: ``ReadaheadState`` (one per reader stream)
  detects forward scans over a ``DynamicIndex`` and prefetches ahead on
  a small shared thread pool, never past the index.  The window starts
  at ``PBS_PLUS_CHUNK_READAHEAD`` and doubles on confirmed sequential
  reads up to ``PBS_PLUS_CHUNK_READAHEAD_MAX``, halving back on a
  misprediction (a seek that stranded prefetched chunks) — precision
  stays observable as ``prefetch_used / prefetch_issued``.
- **Delta-base warming**: prefetching a delta chunk also warms its
  on-disk base (one fixed-size header sniff via
  ``ChunkStore.delta_base_of`` — no ``delta_closure`` walk), counted
  separately (``base_warms``) so readahead precision stays measurable;
  and ``get_many`` batches a read wave's delta-chain resolution through
  a wave-local memo so each shared base decompresses exactly once even
  with caching disabled.

Keyed by digest alone: content addressing makes the mapping
digest→bytes store-independent, so one cache serves every open reader
(local ChunkStore and PBS reader sessions alike).  Budget comes from
``PBS_PLUS_CHUNK_CACHE_MB`` (``conf.Env.chunk_cache_mb``), overridable
per server via ``ServerConfig.chunk_cache_mb``; 0 disables caching
(every get is a verified pass-through load).

A copy of the JAX package's ``pxar/chunkcache.py``, its code byte for
byte apart from its imports, which name the port's own modules; it logs
through ``logging``. Its ``shared_cache()`` is the port's own: a process
holding both packages keeps two shared caches, as it keeps two metrics
and failpoint registries."""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

from ..utils import trace
from ..utils.singleflight import ThreadSingleFlight

L = logging.getLogger(__name__)

_PREFETCH_QUEUE_CAP = 64        # advisory work only: shed, never queue deep

# sharding geometry: segments never shrink below 8 MiB (a smaller
# budget collapses to fewer shards — down to ONE for the byte-exact
# test caches), and never exceed 8 segments (past that the lock is no
# longer the bottleneck on any realistic reader fleet)
_SEGMENT_MIN_BYTES = 8 << 20
_MAX_SEGMENTS = 8
# protected-region share of each segment's budget (segmented LRU): the
# rest is the probationary region sequential scans churn through
_PROTECTED_FRAC = 0.8

# ONE prefetch pool per process, shared by every cache instance (a pool
# per cache would leak threads per open reader in a long-lived server);
# sized by PBS_PLUS_CHUNK_PREFETCH_THREADS on first use
_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None        # guarded-by: _pool_lock


def _prefetch_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            from ..utils import conf
            workers = max(1, int(conf.env().chunk_prefetch_threads))
            _pool = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="chunk-prefetch")
        return _pool


class _Segment:
    """One lock-sharded, scan-resistant cache segment: a segmented LRU
    of a probationary region (first-touch admissions) and a protected
    region (re-referenced chunks).  Eviction drains probation first, so
    a one-pass scan can never displace the promoted working set."""

    __slots__ = ("_lock", "_prob", "_prot", "_prob_size", "_prot_size",
                 "budget", "counters")

    def __init__(self, budget: int):
        self._lock = threading.Lock()
        # digest -> [data, prefetched_flag]; flag clears on first hit so
        # prefetch_used counts chunks a prefetch actually saved a load for
        self._prob: "OrderedDict[bytes, list]" = OrderedDict()  # guarded-by: self._lock
        self._prot: "OrderedDict[bytes, list]" = OrderedDict()  # guarded-by: self._lock
        self._prob_size = 0                            # guarded-by: self._lock
        self._prot_size = 0                            # guarded-by: self._lock
        self.budget = max(0, int(budget))
        self.counters = {
            "hits": 0, "misses": 0, "evictions": 0,
            "prefetch_used": 0,
            "probation_admits": 0, "probation_promotions": 0,
        }                                              # guarded-by: self._lock

    # -- internals (call with self._lock held via the public methods) ------
    def _prot_cap(self) -> int:
        return int(self.budget * _PROTECTED_FRAC)

    def _evict_down(self) -> None:
        while self._prob_size + self._prot_size > self.budget and \
                (self._prob or self._prot):
            if self._prob:
                _, (old, _fl) = self._prob.popitem(last=False)
                self._prob_size -= len(old)
            else:
                _, (old, _fl) = self._prot.popitem(last=False)
                self._prot_size -= len(old)
            self.counters["evictions"] += 1

    def _promote(self, digest: bytes, ent: list) -> None:
        """Probation hit → protected MRU; an overfull protected region
        demotes its own LRU back to probation (never straight out)."""
        n = len(ent[0])
        del self._prob[digest]
        self._prob_size -= n
        self._prot[digest] = ent
        self._prot_size += n
        self.counters["probation_promotions"] += 1
        cap = self._prot_cap()
        while self._prot_size > cap and len(self._prot) > 1:
            d_lru, e_lru = self._prot.popitem(last=False)
            self._prot_size -= len(e_lru[0])
            self._prob[d_lru] = e_lru
            self._prob_size += len(e_lru[0])

    # -- public ------------------------------------------------------------
    def lookup(self, digest: bytes, *, count: bool = True):
        """Resident bytes or None.  A probation hit promotes; a
        protected hit refreshes recency.  ``count=False`` is the
        lost-race re-check in ``_load`` (the original lookup already
        counted the miss)."""
        with self._lock:
            ent = self._prot.get(digest)
            if ent is not None:
                self._prot.move_to_end(digest)
            else:
                ent = self._prob.get(digest)
                if ent is not None:
                    self._promote(digest, ent)
            if ent is None:
                if count:
                    self.counters["misses"] += 1
                return None
            if count:
                self.counters["hits"] += 1
                if ent[1]:
                    ent[1] = False
                    self.counters["prefetch_used"] += 1
            return ent[0]

    def admit(self, digest: bytes, data: bytes, *,
              prefetched: bool = False) -> None:
        n = len(data)
        if self.budget <= 0 or n > self.budget:
            return                       # disabled, or would evict everything
        with self._lock:
            if digest in self._prob or digest in self._prot:
                return
            self._prob[digest] = [data, prefetched]
            self._prob_size += n
            self.counters["probation_admits"] += 1
            self._evict_down()

    def contains(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._prob or digest in self._prot

    def set_budget(self, budget: int) -> None:
        with self._lock:
            self.budget = max(0, int(budget))
            self._evict_down()

    def clear(self) -> None:
        with self._lock:
            self._prob.clear()
            self._prot.clear()
            self._prob_size = 0
            self._prot_size = 0

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["resident_bytes"] = self._prob_size + self._prot_size
            out["resident_chunks"] = len(self._prob) + len(self._prot)
            out["protected_bytes"] = self._prot_size
            return out


class ChunkCache:
    """Byte-budgeted, lock-sharded, scan-resistant cache of decompressed,
    verified chunks (digest-sharded segmented-LRU segments)."""

    def __init__(self, max_bytes: int, *, readahead_chunks: int = 4,
                 readahead_max: int | None = None,
                 shards: int | None = None):
        self._max_bytes = max(0, int(max_bytes))
        self.readahead_chunks = max(0, int(readahead_chunks))
        # adaptive-readahead ceiling (PBS_PLUS_CHUNK_READAHEAD_MAX): the
        # window doubles from readahead_chunks up to this many chunks
        if readahead_max is None:
            readahead_max = max(32, self.readahead_chunks)
        self.readahead_max = max(self.readahead_chunks, int(readahead_max))
        if shards is None:
            shards = max(1, min(_MAX_SEGMENTS,
                                self.max_bytes // _SEGMENT_MIN_BYTES))
        self._nseg = max(1, int(shards))
        self._segs = [_Segment(self.max_bytes // self._nseg)
                      for _ in range(self._nseg)]
        self._lock = threading.Lock()
        self._flight = ThreadSingleFlight()
        self._inflight_prefetch = 0                    # guarded-by: self._lock
        # cache-global counters; per-segment hit/miss/eviction counters
        # live in the segments and are summed into snapshot()
        self.counters = {
            "prefetch_issued": 0, "load_errors": 0,
            "base_warms": 0, "readahead_window": 0,
        }                                              # guarded-by: self._lock

    @property
    def shards(self) -> int:
        return self._nseg

    @property
    def max_bytes(self) -> int:
        return self._max_bytes

    @max_bytes.setter
    def max_bytes(self, value: int) -> None:
        # assignment must actually re-split the per-segment budgets —
        # callers that clamp the budget for a bounded pass (the commit
        # verify caps the serving cache to VERIFY_BATCH_BYTES) would
        # otherwise mutate a dead attribute while the segments keep
        # retaining to the old budget
        self.resize(value)

    def _seg(self, digest: bytes) -> _Segment:
        return self._segs[digest[0] % self._nseg]

    # -- core get ----------------------------------------------------------
    def get(self, store, digest: bytes, stats: dict | None = None) -> bytes:
        """Decompressed, verified bytes for ``digest``.  Cache hit: no
        disk IO, no re-hash.  Miss: exactly one ``store.get`` across all
        concurrent callers (which verifies SHA-256 on load), admitted on
        success only.  ``stats`` is an optional per-caller dict whose
        ``hits``/``misses`` keys are incremented alongside the global
        counters (per-reader cache stats for ``pxar.stats``)."""
        data = self._seg(digest).lookup(digest)
        if data is not None:
            if stats is not None:
                stats["hits"] = stats.get("hits", 0) + 1
            return data
        if stats is not None:
            stats["misses"] = stats.get("misses", 0) + 1
        return self._flight.do(digest, lambda: self._load(store, digest))

    def get_many(self, store, digests, stats: dict | None = None) -> dict:
        """Batched get for one read wave: returns {digest: bytes} for
        the distinct digests, resolving each exactly once.  Delta-chain
        bases shared across the wave decompress exactly once — a
        wave-local memo backs the base resolver, so the guarantee holds
        even with caching disabled or a base too big to admit.

        The returned dict pins every chunk of the wave resident at
        once — callers slicing a large range should prefer
        ``get_stream`` (O(chunk) resident, not O(range))."""
        memo: dict[bytes, bytes] = {}
        out: dict[bytes, bytes] = {}
        for digest in digests:
            if digest in out:
                continue
            data = self._seg(digest).lookup(digest)
            if data is not None:
                if stats is not None:
                    stats["hits"] = stats.get("hits", 0) + 1
            else:
                if stats is not None:
                    stats["misses"] = stats.get("misses", 0) + 1
                data = self._flight.do(
                    digest,
                    lambda d=digest: self._load(store, d, _memo=memo))
            out[digest] = data
            memo.setdefault(digest, data)
        return out

    def get_stream(self, store, digests, stats: dict | None = None):
        """Streaming twin of ``get_many``: yields ``bytes`` per digest
        in input order WITHOUT pinning the whole wave — the consumer
        slices each chunk and drops it, so a multi-MiB range read stays
        O(chunk + shared bases) resident instead of O(range).  Only
        delta BASES ride the wave memo (a base shared by several deltas
        in the wave still decompresses once); the top-level chunks
        themselves are covered by the cache as usual."""
        memo: dict[bytes, bytes] = {}
        for digest in digests:
            data = self._seg(digest).lookup(digest)
            if data is not None:
                if stats is not None:
                    stats["hits"] = stats.get("hits", 0) + 1
            else:
                if stats is not None:
                    stats["misses"] = stats.get("misses", 0) + 1
                data = self._flight.do(
                    digest,
                    lambda d=digest: self._load(store, d, _memo=memo))
            yield data

    def _load(self, store, digest: bytes, *, prefetched: bool = False,
              _chain: tuple = (), _memo: dict | None = None) -> bytes:
        """Single-flight body: verified load + admission.  Runs on the
        calling thread (foreground miss) or the prefetch pool.

        Delta-capable stores (``ChunkStore.get_resolved``) are handed a
        resolver that pulls delta BASES back through this cache
        (``_base_resolver``) — a hot base decompresses once and serves
        every delta above it plus its own direct readers (pbslint rule
        ``delta-discipline``)."""
        # a caller that lost the lookup race to a just-landed flight
        # must not issue a second disk read for resident bytes
        data = self._seg(digest).lookup(digest, count=False)
        if data is not None:
            return data
        try:
            # the cache-miss span: disk read + decompress + verify (a
            # hit never gets here, so the histogram is pure miss cost)
            with trace.span("chunkcache.fetch",
                            digest=digest.hex()[:16],
                            prefetch=prefetched):
                getter = getattr(store, "get_resolved", None)
                if getter is None:
                    data = store.get(digest)   # verifies sha256 == digest
                else:
                    data = getter(
                        digest,
                        self._base_resolver(store, _chain + (digest,),
                                            _memo))
        except BaseException:
            with self._lock:
                self.counters["load_errors"] += 1
            raise
        self._seg(digest).admit(digest, data, prefetched=prefetched)
        return data

    def _base_resolver(self, store, chain: tuple, memo: dict | None = None):
        """Resolver closure for delta bases: wave memo hit, cache hit,
        or a direct load admitted on success.  Deliberately NOT
        single-flighted — a corrupt cross-referencing chain in two
        threads could deadlock two flights against each other; the worst
        case without the flight is one duplicated base read under a
        race.  ``chain`` carries the digests above this resolution, so a
        corrupt cyclic chain raises instead of recursing.  ``memo`` is
        the ``get_many`` wave-local dict: a base shared by many deltas
        in one read wave decompresses once regardless of cache state."""
        def resolve(base_digest: bytes) -> bytes:
            if base_digest in chain or len(chain) > 64:
                raise IOError(
                    f"delta base cycle at {base_digest.hex()[:16]}")
            if memo is not None:
                got = memo.get(base_digest)
                if got is not None:
                    return got
            seg = self._seg(base_digest)
            data = seg.lookup(base_digest)
            if data is None:
                data = self._load(store, base_digest, _chain=chain,
                                  _memo=memo)
            if memo is not None:
                memo[base_digest] = data
            return data
        return resolve

    def contains(self, digest: bytes) -> bool:
        return self._seg(digest).contains(digest)

    # -- prefetch ----------------------------------------------------------
    def prefetch(self, store, digests: Iterable[bytes]) -> int:
        """Schedule background loads for ``digests`` (advisory: errors
        are logged and surface on the foreground read instead; work is
        shed when the queue is saturated).  Returns the number of loads
        actually issued."""
        if self.max_bytes <= 0:
            return 0
        issued = 0
        for digest in digests:
            if self._flight.in_flight(digest):
                continue                 # someone is already loading it
            if self._seg(digest).contains(digest):
                continue
            with self._lock:
                if self._inflight_prefetch >= _PREFETCH_QUEUE_CAP:
                    break
                self._inflight_prefetch += 1
                self.counters["prefetch_issued"] += 1
            issued += 1
            _prefetch_pool().submit(self._prefetch_one, store, digest)
        return issued

    def _prefetch_one(self, store, digest: bytes) -> None:
        try:
            self._warm_delta_base(store, digest)
            if not self.contains(digest):
                self._flight.do(
                    digest, lambda: self._load(store, digest,
                                               prefetched=True))
        except Exception as e:
            # advisory work: the foreground read of this digest will
            # surface the real error with full context
            L.debug("chunk prefetch failed for %s: %s",
                    digest.hex()[:16], e)
        finally:
            with self._lock:
                self._inflight_prefetch -= 1

    def _warm_delta_base(self, store, digest: bytes) -> None:
        """If the prefetched chunk is a delta blob on disk, warm its
        base too: one fixed-size header sniff (``delta_base_of`` — no
        ``delta_closure`` walk), then a cache-admitted load.  Counted as
        ``base_warms``, NOT ``prefetch_issued``, so readahead precision
        (prefetch_used / prefetch_issued) is not diluted by base loads
        the readahead window never predicted."""
        sniff = getattr(store, "delta_base_of", None)
        if sniff is None:
            return
        try:
            base = sniff(digest)
        except OSError:
            return
        if base is None or self.contains(base) or \
                self._flight.in_flight(base):
            return
        with self._lock:
            self.counters["base_warms"] += 1
        try:
            self._flight.do(base, lambda: self._load(store, base))
        except Exception as e:
            L.debug("delta base warm failed for %s: %s",
                    base.hex()[:16], e)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until no prefetch is in flight (tests/bench: settles
        load counters; the pool stays usable)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight_prefetch == 0:
                    return
            time.sleep(0.002)

    # -- management --------------------------------------------------------
    def resize(self, max_bytes: int) -> None:
        """Re-split the new budget across the existing segments and
        evict each down in place (the shard count is fixed at
        construction — re-sharding would rehash every resident chunk)."""
        self._max_bytes = max(0, int(max_bytes))
        per_seg = self._max_bytes // self._nseg
        for seg in self._segs:
            seg.set_budget(per_seg)

    def note_readahead_window(self, window: int) -> None:
        """Record the adaptive readahead window a reader stream just
        used (exported as the ``pbs_plus_chunk_cache_readahead_window``
        gauge — last observed value across streams)."""
        with self._lock:
            self.counters["readahead_window"] = int(window)

    def clear(self) -> None:
        for seg in self._segs:
            seg.clear()

    @property
    def resident_bytes(self) -> int:
        return sum(seg.stats()["resident_bytes"] for seg in self._segs)

    def snapshot(self) -> dict:
        out = {"hits": 0, "misses": 0, "evictions": 0,
               "prefetch_used": 0, "probation_admits": 0,
               "probation_promotions": 0, "resident_bytes": 0,
               "resident_chunks": 0, "protected_bytes": 0}
        for seg in self._segs:
            for k, v in seg.stats().items():
                out[k] += v
        with self._lock:
            out.update(self.counters)
        out["budget_bytes"] = self.max_bytes
        out["shards"] = self._nseg
        sf = self._flight.stats
        out["singleflight_shared"] = sf["shared"]
        return out


class ReadaheadState:
    """Forward-scan detector for one indexed stream (one instance per
    (reader, index) pair — SplitReader keeps one for meta and one for
    payload).  A read whose first chunk continues the previous read's
    window (same chunk or the next one) is a forward scan: prefetch the
    chunks after the window, clamped to the index — the prefetcher
    never reads past the last chunk.

    The window is ADAPTIVE: it starts at ``cache.readahead_chunks`` and
    doubles on each confirmed sequential read up to
    ``cache.readahead_max`` (``PBS_PLUS_CHUNK_READAHEAD_MAX``), so a
    long restore scan keeps the prefetch pool ahead of the consumer; a
    misprediction (a seek that stranded prefetched chunks beyond the
    consumed position) halves it back toward the base, so a
    random-access mount reader stops paying for wasted loads.
    Precision stays observable as prefetch_used / prefetch_issued."""

    __slots__ = ("_last_ci", "_horizon", "_window")

    def __init__(self) -> None:
        self._last_ci = -1
        self._horizon = -1     # furthest chunk already handed to prefetch
        self._window = 0       # current adaptive window (0 = cold)

    def on_read(self, cache: ChunkCache, store, index,
                first_ci: int, last_ci: int) -> int:
        """Notify a read that covered chunks [first_ci, last_ci]."""
        base = cache.readahead_chunks
        sequential = 0 <= self._last_ci and \
            self._last_ci <= first_ci <= self._last_ci + 1
        if not sequential:
            # a seek with prefetched chunks beyond the consumed
            # position is a misprediction — those loads were wasted, so
            # the NEXT confirmed scan restarts from a halved window
            if self._horizon > self._last_ci and self._window > base:
                self._window = max(base, self._window // 2)
            self._last_ci = last_ci
            self._horizon = last_ci
            return 0
        self._last_ci = last_ci
        if base <= 0:
            return 0
        # use the current window for THIS wave, then double for the
        # next confirmed one — growth is earned by consumed prefetch,
        # and a post-shrink window is observable before it regrows
        if self._window < base:
            self._window = base
        window = self._window
        cache.note_readahead_window(window)
        self._window = min(cache.readahead_max, window * 2)
        start = max(last_ci + 1, self._horizon + 1)
        stop = min(last_ci + 1 + window, len(index))
        if start >= stop:
            return 0
        self._horizon = stop - 1
        return cache.prefetch(
            store, (index.digest(ci) for ci in range(start, stop)))


# -- process-shared cache ---------------------------------------------------

_shared_lock = threading.Lock()
_shared: ChunkCache | None = None              # guarded-by: _shared_lock


def shared_cache() -> ChunkCache:
    """The process-wide cache every reader shares by default, sized from
    ``PBS_PLUS_CHUNK_CACHE_MB`` on first use."""
    global _shared
    with _shared_lock:
        if _shared is None:
            from ..utils import conf
            e = conf.env()
            _shared = ChunkCache(
                int(e.chunk_cache_mb) << 20,
                readahead_chunks=int(e.chunk_readahead),
                readahead_max=int(e.chunk_readahead_max))
        return _shared


def configure_shared(*, max_bytes: int | None = None,
                     readahead_chunks: int | None = None) -> ChunkCache:
    """Server-config override of the shared cache (ServerConfig.
    chunk_cache_mb); resizing evicts down to the new budget in place so
    already-open readers see the new limit."""
    cache = shared_cache()
    if max_bytes is not None:
        cache.resize(max_bytes)
    if readahead_chunks is not None:
        cache.readahead_chunks = max(0, int(readahead_chunks))
        cache.readahead_max = max(cache.readahead_chunks,
                                  cache.readahead_max)
    return cache


def metrics_snapshot() -> dict:
    """Shared-cache counters for server/metrics.py (zeros before first
    use — rendering must not force readers into existence elsewhere)."""
    with _shared_lock:
        cache = _shared
    if cache is None:
        return {"hits": 0, "misses": 0, "evictions": 0,
                "prefetch_issued": 0, "prefetch_used": 0, "load_errors": 0,
                "probation_admits": 0, "probation_promotions": 0,
                "base_warms": 0, "readahead_window": 0,
                "resident_bytes": 0, "resident_chunks": 0,
                "protected_bytes": 0, "budget_bytes": 0, "shards": 0,
                "singleflight_shared": 0}
    return cache.snapshot()
