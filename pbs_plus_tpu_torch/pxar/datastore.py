"""Content-addressed chunk store + dynamic indexes + snapshot layout.

Reference capability: pxar ``datastore`` sub-package — ``NewChunkStore``,
``ParseDynamicIndex`` (DIDX), ``ParseBackupType`` (consumed at
internal/pxar/format.go:101-106 and
internal/pxarmount/commit_orchestrate.go:122,218-222).

Layout (PBS-compatible in spirit, clean-room):

    <store>/.chunks/<hex[:4]>/<hex>       zstd-compressed chunks
    <store>/<type>/<id>/<rfc3339-time>/   snapshot dir:
        root.midx                         metadata-stream dynamic index
        root.pidx                         payload-stream dynamic index
        manifest.json                     snapshot manifest + stats

DIDX binary format (``TPXD``): magic(4) ver(u16) reserved(2) uuid(16)
ctime_ns(u64) count(u64), then count records of end_offset(u64)+sha256(32).

A copy of the JAX package's ``pxar/datastore.py``, its code byte for
byte apart from its imports, which name the port's own modules (the
index is the port's ``chunkindex.DedupIndex``, the delta tier's the
port's ``similarityindex.SimilarityIndex``, and
``PBS_PLUS_DIST_INDEX_SHARDS`` builds the port's
``parallel.dist_index.DistIndexClient``), its logger (``logging``), and
two changes: ``device=`` (default ``"cuda"``) threads through
``Datastore`` and ``ChunkStore`` into the index and the similarity index
the store builds; and ``list_snapshots`` skips a session's staging dir
(``<time>.tmp.<pid>.<id>``), which holds its manifest for a moment
before the rename that publishes it: a sync listing the store in that
moment took it for a snapshot and failed on its rename (a race of the
reference that a fleet of hundreds of sessions beside sync jobs meets)."""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
try:
    import zstandard
except ImportError:                 # image lacks the wheel; ctypes shim
    from ..utils import zstdshim as zstandard

from ..utils import atomicio, failpoints, fswitness, validate
from ..utils.counters import Counters
from ..utils.device import resolve

L = logging.getLogger(__name__)

DIDX_MAGIC = b"TPXD"
DIDX_VERSION = 1
_HDR = struct.Struct("<4sHH16sQQ")
_REC_DTYPE = np.dtype([("end", "<u8"), ("digest", "V32")])

BACKUP_TYPES = ("host", "vm", "ct")

# cross-process write accounting (docs/data-plane.md "Shared
# datastore"): chunks_written counts chunk-file writes this process
# CLAIMED (full blobs and, in shared mode, raw sync-mirror landings);
# cross_process_hits counts claims lost to another process that
# already held the chunk (the link-CAS EEXIST) — summed across a
# fleet's /metrics, written-once means Σ chunks_written == distinct
# chunks on disk.  Rendered by server/metrics.py.
METRICS = Counters("chunks_written", "cross_process_hits")
_count = METRICS.add


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def parse_backup_type(s: str) -> str:
    if s not in BACKUP_TYPES:
        raise ValueError(f"invalid backup type {s!r} (want one of {BACKUP_TYPES})")
    return s


def parse_snapshot_ref(s: str) -> "SnapshotRef":
    """Parse + validate a ``type/id/time`` snapshot reference from
    untrusted input (API token holders).  Each component must be a single
    safe path segment — '', '.', '..', '/' and shell-metacharacter-bearing
    strings are rejected before anything reaches os.path.join or a mount
    subprocess argv, and the type must be one of
    BACKUP_TYPES.  The same validator guards mint time (start_session,
    target create) so no unreachable snapshot can exist."""
    parts = s.strip("/").split("/")
    ns_parts: list[str] = []
    while len(parts) > 3 and parts[0] == "ns":
        if len(ns_parts) >= MAX_NAMESPACE_DEPTH:
            raise ValueError(f"namespace too deep in {s!r}")
        validate.snapshot_component(parts[1])
        ns_parts.append(parts[1])
        parts = parts[2:]
    if len(parts) != 3:
        raise ValueError(f"bad snapshot ref {s!r} "
                         f"(want [ns/<n>/...]type/id/time)")
    for p in parts:
        validate.snapshot_component(p)
    parse_backup_type(parts[0])
    return SnapshotRef(*parts, namespace="/".join(ns_parts))


def parse_backup_time(ts: str) -> int:
    """Inverse of format_backup_time: 'YYYY-mm-ddTHH:MM:SSZ' → epoch s."""
    return int(_dt.datetime.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")
               .replace(tzinfo=_dt.timezone.utc).timestamp())


def format_backup_time(t: float | _dt.datetime) -> str:
    if isinstance(t, (int, float)):
        t = _dt.datetime.fromtimestamp(t, _dt.timezone.utc)
    return t.astimezone(_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class ChunkStore:
    """sha256-addressed chunk files, zstd-compressed, atomic insert.

    Reference: datastore.NewChunkStore(path).  GC is mark-and-sweep via
    atime touch (PBS model): ``touch`` on reuse, ``sweep(before)`` removes
    chunks untouched since a mark time.

    Sharded + index-fronted: the namespace is split into
    ``n_shards`` logical shards by digest prefix (the on-disk
    ``.chunks/<hex[:4]>/`` layout is unchanged — shard = first digest
    byte mod N), each with its own lock and zstd compressor, so
    concurrent sessions stop contending on one lock and GC mark/sweep
    runs shard-parallel.  When a ``chunkindex.DedupIndex`` is attached
    (default: sized by PBS_PLUS_DEDUP_INDEX_MB, 0 disables) it is the
    ONLY membership oracle: negative probes never touch disk, positive
    probes are confirmed by at most one store access (the GC-mark
    utime), and the sweep keeps it coherent by discarding a digest
    BEFORE unlinking its file.
    """

    # per-shard locks serialize every mutating path, and reads use
    # thread-local decompressors — callers (pipeline.locked_store) may
    # skip the process-wide _LockedStore wrap
    thread_safe = True

    def __init__(self, base: str, *, compression_level: int = 3,
                 blob_format: str = "zstd",
                 n_shards: "int | None" = None,
                 index_budget_mb: "int | None" = None,
                 index=None,
                 index_resident_mb: "int | None" = None,
                 delta_tier: "bool | None" = None,
                 delta_threshold: "int | None" = None,
                 delta_max_chain: "int | None" = None,
                 shared_instance: "str | None" = None,
                 device="cuda"):
        """blob_format="zstd" (native raw zstd frame) | "pbs" (stock-PBS
        DataBlob envelope: magic + crc32 + zstd payload).  Reads sniff
        the on-disk magic, so a datastore may hold both formats.

        ``shared_instance`` (None → PBS_PLUS_SHARED_DATASTORE; "" = off)
        names THIS process when several server processes open one
        datastore (docs/data-plane.md "Shared datastore"):
        novel-chunk writes claim their final path with an ``os.link``
        CAS instead of a rename — a lost claim is a cross-process dedup
        hit, so every chunk is WRITTEN exactly once fleet-wide even
        though each process runs its own membership index — and the
        index's spill segments + boot snapshot move to per-instance
        paths (``.chunkindex/proc-<id>/`` / ``snapshot-<id>``): the
        digestlog's tmp+rename segment discipline is single-writer per
        directory, so coexistence means one directory per writer.  The
        similarity delta tier is forced OFF in shared mode — its
        base-pin protocol is in-process and a cross-process sweep
        cannot see another process's pins.

        ``n_shards``: logical shard count (None → PBS_PLUS_STORE_SHARDS).
        ``index``: an explicit DedupIndex (tests); else one is built
        from ``index_budget_mb`` (None → PBS_PLUS_DEDUP_INDEX_MB,
        0 → index disabled, legacy utime-probe path).
        ``index_resident_mb`` bounds the exact-confirm tier's resident
        cost (None → PBS_PLUS_DEDUP_RESIDENT_MB): the confirm set
        spills to sorted segments under ``.chunkindex/segments/``
        (pxar/digestlog.py) once the memtable crosses the budget;
        0 keeps the whole confirm set in RAM (the earlier all-in-RAM shape).

        ``delta_tier`` enables the similarity-dedup tier
        (docs/data-plane.md "Similarity tier"): novel chunks resembling a
        stored base (``delta_threshold`` max sketch Hamming distance,
        chain depth bounded by ``delta_max_chain``) are stored as delta
        blobs against it (pxar/deltablob.py).  None → the
        PBS_PLUS_DELTA_TIER / _DELTA_THRESHOLD / _DELTA_MAX_CHAIN
        environment knobs.  Forced off for pbs-format stores — a stock
        PBS cannot decode delta blobs.

        ``device`` (default ``"cuda"``; raises without a card,
        ``"cpu"`` runs the plain versions) is where the index this
        store builds probes (K3 on the card) and where its similarity
        tier sketches."""
        from ..utils import conf as _conf
        self.device = resolve(device)
        self.base = os.path.join(base, ".chunks")
        os.makedirs(self.base, exist_ok=True)
        self.blob_format = blob_format
        if shared_instance is None:
            shared_instance = _conf.env().shared_datastore
        self.shared_instance = shared_instance or ""
        self._level = compression_level
        if n_shards is None:
            n_shards = _conf.env().store_shards
        self.n_shards = max(1, int(n_shards))
        self._shard_locks = [threading.Lock()
                             for _ in range(self.n_shards)]
        # one compressor per shard: a zstd context is not thread-safe,
        # and per-shard ownership (used only under the shard lock) is
        # what lets two sessions compress concurrently at all
        self._shard_cctx = [zstandard.ZstdCompressor(level=compression_level)
                            for _ in range(self.n_shards)
                            ]                  # guarded-by: self._shard_locks
        # reads happen concurrently (chunk-cache prefetch pool, parallel
        # verification workers) and a zstd decompressor is NOT
        # thread-safe — one per reading thread
        self._dctx_local = threading.local()
        # prefix dirs this process already created — skips the makedirs
        # stat storm on the novel-insert hot path.  Shared across ALL
        # shards (prefix dirs don't align with shard boundaries), so it
        # needs its own lock: two inserts on different shards were
        # mutating this set under different shard locks (the guarded-by
        # sweep's catch — GIL-atomic in CPython today, but nothing in
        # the store's thread_safe contract says so)
        self._made_dirs_lock = threading.Lock()
        self._made_dirs: set[str] = set()   # guarded-by: self._made_dirs_lock
        # legacy DataBlob memory for INDEX-LESS stores only: bounded,
        # evicts an arbitrary half at the cap (the old clear-everything
        # reset forgot every hot digest at once and re-ran the full
        # read+decompress upgrade probe for all of them).  With an index
        # attached this knowledge lives there, unbounded and exact.
        self._datablob_seen: set[bytes] = \
            set()                           # guarded-by: self._datablob_lock
        self._datablob_seen_cap = 1 << 20
        # its own lock: inserts on DIFFERENT shards share this one set,
        # and the cap eviction iterates it — a per-shard lock alone
        # would let another shard's add() race the iteration
        self._datablob_lock = threading.Lock()
        # (annotated below: _datablob_seen is only touched under it)
        # per-instance index state in shared mode: the spill segments
        # and the boot snapshot are single-writer artifacts, so every
        # co-resident process gets its own directory/file (the segment
        # NAME sequence would collide in one shared dir)
        _inst = self.shared_instance
        _spill_root = os.path.join(base, ".chunkindex",
                                   f"proc-{_inst}") if _inst \
            else os.path.join(base, ".chunkindex")
        index_explicit = index is not None
        if index is None and _conf.env().dist_index_shards:
            # distributed index (docs/dist-index.md): the
            # membership surface moves to a DistIndexClient over the
            # configured shard nodes; the local DedupIndex is not built
            # at all.  The client is boot-free (`booted` is always
            # True) — shard nodes own their spill/snapshot state.
            from ..parallel.dist_index import (DistIndexClient,
                                               parse_endpoints)
            _env = _conf.env()
            index = DistIndexClient(
                endpoints=parse_endpoints(_env.dist_index_shards),
                token=_env.dist_index_token,
                timeout_s=_env.dist_index_timeout_s,
                map_path=_env.dist_index_map)
        if index is None:
            mb = (_conf.env().dedup_index_mb
                  if index_budget_mb is None else index_budget_mb)
            if mb and mb > 0:
                from .chunkindex import DedupIndex
                rmb = (_conf.env().dedup_resident_mb
                       if index_resident_mb is None else index_resident_mb)
                if rmb and rmb > 0:
                    index = DedupIndex(
                        budget_mb=mb,
                        spill_dir=_spill_root,
                        resident_mb=rmb,
                        device=self.device)
                else:
                    # resident budget 0: the all-RAM confirm set
                    index = DedupIndex(budget_mb=mb, device=self.device)
        self._index = index
        if index is not None and index_explicit:
            # a caller-supplied index is taken as-is (tests pre-seed it)
            index.mark_booted()
        self._index_snap = os.path.join(
            base, ".chunkindex",
            f"snapshot-{_inst}" if _inst else "snapshot")
        self._instance_lock_fd: "int | None" = None
        if _inst and self._index is not None and not index_explicit:
            # duplicate-id guard: two processes booting with the SAME
            # instance id would share a spill directory (single-writer
            # by design), a GC-lease holder name, and a queue owner —
            # every cross-process guarantee voided at once.  An
            # advisory flock on the instance's lock file fails the
            # second boot loudly instead; held (deliberately, no
            # close) for the store's whole lifetime.
            import fcntl
            os.makedirs(_spill_root, exist_ok=True)
            fd = os.open(os.path.join(_spill_root, ".instance-lock"),
                         os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                raise RuntimeError(
                    f"shared-datastore instance id "
                    f"{self.shared_instance!r} is already in use by a "
                    "live process — PBS_PLUS_SHARED_DATASTORE ids must "
                    "be unique per server process")
            self._instance_lock_fd = fd
        # similarity-dedup tier (docs/data-plane.md "Similarity tier")
        env = _conf.env()
        if delta_tier is None:
            delta_tier = env.delta_tier
        self._sim = None
        # set once the ".delta-tier" marker is known written: GC's mark
        # must run the base closure on any store that EVER wrote deltas,
        # even with the tier since turned off
        self._delta_marked = False
        # base-pin protocol (docs/data-plane.md "Similarity tier"): a
        # delta commit pins its base here (exists-confirm + pin under
        # ONE mutex) and the sweep's unlink skips pinned digests under
        # the same mutex — without it, a sweep could unlink a base in
        # the window between the writer's base fetch and its delta
        # commit, publishing a chunk that can never reassemble.  The
        # mutex is only ever taken while holding a shard lock (writer:
        # its chunk's; sweep: the victim's), a consistent order, and
        # never held across encode/IO-heavy work
        self._pin_lock = threading.Lock()
        self._pinned_bases: dict[bytes, int] = {}   # guarded-by: self._pin_lock
        if delta_tier and self.shared_instance:
            # the base-pin commit protocol (exists-confirm + pin under
            # _pin_lock) is in-process state: a leader's sweep cannot
            # see a follower's pins, so a cross-process delta commit
            # could anchor on a base mid-unlink.  Forced off, loudly.
            L.warning("similarity delta tier disabled: shared-datastore "
                      "instance %r (the base-pin protocol is "
                      "in-process)", self.shared_instance)
            delta_tier = False
        if delta_tier and blob_format != "pbs":
            from .similarityindex import SimilarityIndex
            self._sim = SimilarityIndex(
                threshold=(env.delta_threshold if delta_threshold is None
                           else delta_threshold),
                max_chain=(env.delta_max_chain if delta_max_chain is None
                           else delta_max_chain),
                device=self.device)

    # -- index lifecycle ---------------------------------------------------
    @property
    def index(self):
        """The attached DedupIndex (None = disabled), boot-scanned
        LAZILY on first access — consume-once snapshot if present, else
        a full shard scan — so read-only opens (restore, verify, CLI
        listings) never pay it.  Boot state rides the DedupIndex
        object: stores sharing one index share one boot."""
        idx = self._index
        if idx is not None:
            idx.ensure_booted(self._boot_index)
        return idx

    @index.setter
    def index(self, idx) -> None:
        """Attach another store's index (the server's per-job
        chunker-override store shares the primary's RAW ``_index``) —
        boot state travels with the object, so whichever sharer probes
        first loads it, on its own (writer) thread."""
        self._index = idx

    def _boot_index(self) -> None:
        """Populate the index at first use: consume-once snapshot if
        present (unlinked even on a failed load, so a crash later can
        never resurrect it stale), else a full shard scan.  A valid
        sketch section re-seeds the similarity tier (tier on), so the
        server keeps offering pre-restart delta bases; a corrupt or
        absent section just leaves the tier to rebuild organically."""
        loaded = False
        try:
            loaded = self._index.load_snapshot(self._index_snap)
        finally:
            try:
                # consume-once snapshot, not a chunk: no index entry
                # pairs with this unlink — going stale is the hazard,
                # not ordering
                # pbslint: disable=ordering-discipline
                os.unlink(self._index_snap)
            except OSError:
                pass
        if not loaded:
            self._index.rebuild(self.iter_digests())
            return
        sketches = self._index.loaded_sketches
        self._index.loaded_sketches = None      # consume-once, like the file
        if sketches and self._sim is not None:
            self._sim.load_entries(sketches)

    def save_index_snapshot(self) -> bool:
        """Persist the index so the next open skips the shard scan
        (called after every sweep; safe to call any time — anything
        inserted after the save is re-learned as a false negative).
        With the similarity tier on, the resemblance entries ride along
        in the snapshot's optional sketch section."""
        if self.index is None:
            return False
        os.makedirs(os.path.dirname(self._index_snap), exist_ok=True)
        self.index.save_snapshot(
            self._index_snap,
            sketches=(self._sim.export_entries()
                      if self._sim is not None else None))
        return True

    @property
    def _dctx(self):
        d = getattr(self._dctx_local, "d", None)
        if d is None:
            d = self._dctx_local.d = zstandard.ZstdDecompressor()
        return d

    def _path(self, digest: bytes) -> str:
        h = digest.hex()
        return os.path.join(self.base, h[:4], h)

    def shard_of(self, digest: bytes) -> int:
        return digest[0] % self.n_shards

    def has(self, digest: bytes) -> bool:
        if self.index is not None:
            return self.index.contains(digest)
        return os.path.exists(self._path(digest))

    def on_disk(self, digest: bytes) -> bool:
        """Disk-TRUE existence, deliberately bypassing the index.  For
        integrity paths that suspect index/disk divergence (checkpoint
        validation rejecting a resume that would splice a hole) — never
        for dedup probes, where the index is the oracle."""
        return os.path.exists(self._path(digest))

    def probe_batch(self, digests: "list[bytes]") -> "list[bool] | None":
        """Batched membership for a whole digest batch in one call (the
        DedupWriter/PipelinedStream entry point).  None when no index
        is attached — callers fall back to per-digest ``insert``."""
        if self.index is None:
            return None
        return self.index.probe_batch(digests)

    def ingest_capabilities(self):
        """Declared batched-ingest surface (pxar/ingestbackend.py): the
        answer tracks the LIVE index/similarity attachments, so a store
        that gains a shared similarity index after construction starts
        presketching on the next flush."""
        from .ingestbackend import IngestCapabilities
        return IngestCapabilities(probe=self.index is not None,
                                  presketch=self._sim is not None)

    def on_disk_many(self, digests: "list[bytes]") -> "list[bool]":
        """Batched disk-TRUE existence (``on_disk`` over a whole batch
        in ONE call).  The sync engine's sanctioned membership fallback
        for index-less destinations (pbslint rule ``sync-discipline``:
        sync code negotiates membership via ``probe_batch``/
        ``on_disk_many``, never per-digest loops of its own).  Stats
        run in ascending digest order — adjacent digests share prefix
        dirs, so the sweep rides the dentry cache like the digestlog's
        sorted segment sweeps — while the answer keeps input order."""
        present = {d: os.path.exists(self._path(d))
                   for d in sorted(set(digests))}
        return [present[d] for d in digests]

    # -- raw (compressed-as-stored) transfer surface — docs/sync.md --------
    def get_raw(self, digest: bytes) -> bytes:
        """The on-disk payload exactly as stored (raw zstd frame, PBS
        DataBlob, or delta blob — callers sniff).  The sync wire reads
        this so replicas exchange compressed bytes with no decompress/
        recompress round-trip; integrity is re-checked by the receiving
        ``insert_raw``.  Raises FileNotFoundError when absent."""
        with open(self._path(digest), "rb") as f:
            return f.read()

    def insert_raw(self, digest: bytes, payload: bytes, *,
                   verify: bool = True) -> bool:
        """Store an already-encoded on-disk payload verbatim (the sync
        wire's compressed-as-stored write).  Verification before the
        payload becomes reachable:

        - full blobs decode in memory and must hash back to ``digest``
          (one decompress, never a recompress);
        - delta blobs are header-checked before the write and then
          verified by a read-back reassembly through their (already
          mirrored — the engine transfers closure bases first) base
          chain; a failed read-back unlinks the file again, so a
          corrupt transfer can never leave a torn chunk behind.

        A delta payload also forces the durable ``.delta-tier`` marker
        BEFORE the write — a mirror holding delta blobs must run GC's
        base closure exactly like the store that encoded them
        (``delta_closure``) — except into a pbs-format store, where the
        reassembled bytes land as a full DataBlob instead (the
        invariant: a stock PBS cannot decode delta blobs, so they are
        never written where one must read them).  Raises ValueError/
        DeltaError/IOError on a payload that does not verify; nothing
        reaches the final path until it has — a failed transfer can
        never clobber a chunk the store already held."""
        from .deltablob import is_delta, parse_header
        from .pbsformat import blob_decode, blob_wrap_compressed, \
            is_datablob
        p = self._path(digest)
        shard = self.shard_of(digest)
        delta = is_delta(payload)
        datablob = False
        if delta:
            base_digest = parse_header(payload)[3]   # structural gate
            if verify or self.blob_format == "pbs":
                # bases transfer first (the sync engine's ordering), so
                # the chain resolves from THIS store: reassemble in
                # memory and re-hash BEFORE anything lands on disk —
                # symmetric with the full-blob path below
                from .deltablob import decode as _delta_decode
                base = self.get_resolved(base_digest, None)
                data = _delta_decode(payload, base)
                if hashlib.sha256(data).digest() != digest:
                    raise ValueError(
                        f"delta chunk {digest.hex()} reassembles to "
                        "wrong bytes")
            if self.blob_format == "pbs":
                # store the reassembled bytes as a full DataBlob (the
                # one cross-format case that pays a recompress — stock-
                # PBS readability beats the as-stored purity here)
                from .pbsformat import blob_encode
                with self._shard_locks[shard]:
                    self._land_payload(
                        p, blob_encode(data, cctx=self._shard_cctx[shard]))
                    if self.index is not None:
                        self.index.insert(digest)
                        self.index.mark_datablob(digest)
                    else:
                        self._remember_datablob(digest)
                return True
            if not self._ensure_delta_marker():
                raise IOError(
                    f"delta-tier marker unwritable; cannot mirror delta "
                    f"blob {digest.hex()[:16]} as-stored")
        else:
            datablob = is_datablob(payload)
            if self.blob_format == "pbs" and not datablob:
                # pbs-format mirror receiving a native raw-zstd frame:
                # wrap the envelope so a stock PBS can decode it — the
                # compressed payload itself is untouched
                payload = blob_wrap_compressed(payload)
                datablob = True
            if verify:
                if datablob:
                    data = blob_decode(payload, dctx=self._dctx)
                else:
                    data = self._dctx.decompress(payload,
                                                 max_output_size=1 << 30)
                if hashlib.sha256(data).digest() != digest:
                    raise ValueError(
                        f"raw chunk {digest.hex()} does not verify "
                        "against its digest")
        with self._shard_locks[shard]:
            self._land_payload(p, payload)
            if self.index is not None:
                self.index.insert(digest)
                if datablob:
                    self.index.mark_datablob(digest)
            elif datablob and self.blob_format == "pbs":
                self._remember_datablob(digest)
        return True

    # -- similarity tier ---------------------------------------------------
    @property
    def similarity(self):
        """The attached SimilarityIndex (None = tier disabled)."""
        return self._sim

    @similarity.setter
    def similarity(self, sim) -> None:
        """Attach another store's similarity index (the server's
        per-job chunker-override store shares the primary's — two
        views of one directory must never hold split sketch state,
        the ``index`` sharing discipline)."""
        self._sim = sim

    def presketch_batch(self, digests: "list[bytes]", chunks: "list",
                        known: "list[bool] | None") -> int:
        """Batched sketch computation for a whole hash batch's novel
        chunks (ONE kernel call — the write path calls this right after
        its exact-index ``probe_batch``, so the per-chunk inserts that
        follow find their sketches precomputed).  No-op when the tier
        is off."""
        if self._sim is None:
            return 0
        return self._sim.presketch(digests, chunks, known)

    def insert(self, digest: bytes, data: bytes, *, verify: bool = True) -> bool:
        """Store a chunk; returns True if it was new.  ``verify`` re-hashes
        for corrupt-write containment — writers that just computed the
        digest from the same buffer pass verify=False to avoid double
        hashing on the hot path."""
        # fires BEFORE the tmp write so an injected fault models ENOSPC/
        # EIO at the store boundary; the tmp+rename discipline below is
        # what "no orphaned partial chunks" rests on either way
        failpoints.hit("pbsstore.chunk.insert")
        p = self._path(digest)
        shard = self.shard_of(digest)
        with self._shard_locks[shard]:
            if self.index is not None:
                if self.index.contains(digest):
                    # dedup hit: the GC-mark touch is the one sanctioned
                    # store access, doubling as the stale-index guard —
                    # a vanished file (external delete) falls through to
                    # the write path below
                    if self._touch_hit(digest, p, shard):
                        return False
                # filter-negative: ZERO pre-write existence probes — the
                # write lands via tmp+rename, which is idempotent even
                # if the index missed a chunk that is already on disk
            else:
                # legacy probe: dedup-hit check + GC-mark touch in ONE
                # syscall (the old os.path.exists + touch pair
                # double-statted every hit)
                exists = True
                try:
                    os.utime(p)
                except FileNotFoundError:
                    exists = False
                except OSError:
                    # utime denied (read-only store surface) but the
                    # chunk may exist — explicit stat before rewriting
                    exists = os.path.exists(p)
                if exists:
                    self._note_datablob_hit(digest, p, shard)
                    return False
            if verify and hashlib.sha256(data).digest() != digest:
                raise ValueError("chunk digest mismatch on insert")
            claimed = True
            if self._sim is None or not self._try_delta_write(
                    digest, data, p, shard):
                claimed = self._write_chunk(p, data, shard)
            # the local index learns the digest either way: a lost
            # cross-process claim is a dedup hit this index simply had
            # not heard about yet (the other process wrote it)
            if self.index is not None:
                self.index.insert(digest)
                if self.blob_format == "pbs":
                    self.index.mark_datablob(digest)
            elif self.blob_format == "pbs":
                self._remember_datablob(digest)
            return claimed

    def note_dedup_hit(self, digest: bytes) -> bool:
        """Record a dedup hit discovered via ``probe_batch``: GC-mark
        touch + the pbs-format upgrade probe, without re-probing
        membership.  False when the file is GONE (index stale against
        an external delete) — the caller must fall back to ``insert``
        with the chunk bytes in hand."""
        p = self._path(digest)
        shard = self.shard_of(digest)
        with self._shard_locks[shard]:
            return self._touch_hit(digest, p, shard)

    def _touch_hit(self, digest: bytes, p: str, shard: int) -> bool:
        """Shared dedup-hit tail (caller holds the shard lock)."""
        try:
            os.utime(p)
        except FileNotFoundError:
            return False
        except OSError:
            # utime denied (read-only surface) — but some mounts raise
            # EACCES/EROFS for MISSING paths too, and declaring a hit
            # on a memory view alone is the false-skip the design
            # forbids: confirm on disk before trusting the index
            if not os.path.exists(p):
                return False
        self._note_datablob_hit(digest, p, shard)
        return True

    def _try_delta_write(self, digest: bytes, data, p: str,
                         shard: int,
                         exclude_bases: "frozenset[bytes]"
                         = frozenset()) -> bool:
        """Similarity-tier insert attempt for a novel chunk (caller
        holds the shard lock): sketch → banded candidate → delta encode
        against the base, written only when it actually beats a plain
        blob.  Returns True when a delta blob landed; False = caller
        writes the full blob.  EVERY failure direction falls back to the
        full write — an unprofitable delta, a vanished/corrupt base, an
        injected ``pbsstore.delta.encode`` fault — so the tier can only
        ever save bytes, never lose chunks."""
        sim = self._sim
        data_b = data if isinstance(data, bytes) else bytes(data)
        sketch = sim.take_sketch(digest, data_b)
        # candidate selection consumes the batched preselect computed by
        # presketch (one vectorized Hamming pass per hash batch) and
        # falls back to a live pool walk for inline writers
        cand = sim.take_candidate(digest, sketch, exclude=digest)
        if cand is not None and cand[0] in exclude_bases:
            # the refold path must not re-anchor a chunk onto a base GC
            # is about to reclaim — plain is the only safe fallback
            cand = None
        if cand is None:
            sim.add(digest, sketch, 0)
            return False
        base_digest, base_depth = cand
        from .similarityindex import METRICS as _SM
        try:
            failpoints.hit("pbsstore.delta.encode")
            # base bytes through the shared read cache: a hot base
            # decompresses once across many encodes (and later
            # reassemblies) — reads take no shard lock, so holding this
            # chunk's shard lock here cannot deadlock
            from . import chunkcache as _cc
            base = _cc.shared_cache().get(self, base_digest)
            from . import deltablob as _delta
            blob = _delta.encode(data_b, base, base_digest,
                                 depth=base_depth + 1, level=self._level)
        except FileNotFoundError:
            # index stale against an external delete: stop offering it
            sim.discard(base_digest)
            _SM.add("encode_fallbacks")
            sim.add(digest, sketch, 0)
            return False
        except Exception as e:
            L.warning("delta encode failed for %s (base %s): %s — "
                      "falling back to full blob", digest.hex()[:16],
                      base_digest.hex()[:16], e)
            _SM.add("encode_fallbacks")
            sim.add(digest, sketch, 0)
            return False
        # the honest profitability gate compares against what the plain
        # write would actually cost on disk (zstd already shrinks
        # compressible chunks without any base) — computed once here and
        # reused for the fallback write, so losing the gate never pays a
        # second compression
        plain = self._shard_cctx[shard].compress(data_b)
        if blob is None or len(blob) >= 0.9 * len(plain):
            _SM.add("encode_fallbacks")
            sim.add(digest, sketch, 0)
            self._write_payload(p, plain)
            return True
        if not self._ensure_delta_marker():
            # cannot durably record that this store holds deltas — a
            # later tier-off GC would then skip the base closure and
            # could sweep this delta's base; store full instead
            _SM.add("encode_fallbacks")
            sim.add(digest, sketch, 0)
            self._write_payload(p, plain)
            return True
        # pin the base for the commit window: exists-confirm and pin
        # are atomic against the sweep's pinned-check+unlink (both
        # under _pin_lock), so either the sweep already took the base
        # (confirm fails → full blob) or the base survives until the
        # delta is durably on disk.  The bytes fetched above may have
        # been a cache hit for an already-unlinked file — only THIS
        # confirm makes the reference safe.
        bp = self._path(base_digest)
        with self._pin_lock:
            if not os.path.exists(bp):
                gone = True
            else:
                gone = False
                self._pinned_bases[base_digest] = \
                    self._pinned_bases.get(base_digest, 0) + 1
        if gone:
            sim.discard(base_digest)
            _SM.add("encode_fallbacks")
            sim.add(digest, sketch, 0)
            self._write_payload(p, plain)
            return True
        try:
            # GC-mark the base: the NEXT sweep sees it fresh, like any
            # chunk an in-flight session just referenced
            try:
                os.utime(bp)
            except OSError:
                L.debug("delta base utime failed for %s",
                        base_digest.hex()[:16])
            self._write_payload(p, blob)
        finally:
            with self._pin_lock:
                n = self._pinned_bases.pop(base_digest, 1) - 1
                if n > 0:
                    self._pinned_bases[base_digest] = n
        sim.add(digest, sketch, base_depth + 1)
        _SM.add("hits")
        _SM.add("bytes_saved", len(plain) - len(blob))
        return True

    def _write_chunk(self, p: str, data: bytes, shard: int) -> bool:
        """Encode + land a full blob.  True when THIS process's bytes
        became the chunk file.  In shared-datastore mode the landing is
        an ``os.link`` CAS — False means another process already held
        the chunk: a cross-process dedup hit (counted, GC-touched),
        never a second write.  The trade vs the rename path: a shared
        store gives up silent overwrite-repair of a corrupt chunk file
        (operators unlink first), buying written-exactly-once."""
        if self.blob_format == "pbs":
            from .pbsformat import blob_encode
            payload = blob_encode(data, cctx=self._shard_cctx[shard])
        else:
            payload = self._shard_cctx[shard].compress(data)
        return self._land_payload(p, payload)

    def _ensure_dir(self, d: str) -> None:
        with self._made_dirs_lock:
            fresh = d not in self._made_dirs
        if fresh:
            # makedirs outside the lock (it can touch disk); exist_ok
            # makes the lost race idempotent, and remembering after the
            # fact only ever re-pays one makedirs
            os.makedirs(d, exist_ok=True)
            with self._made_dirs_lock:
                self._made_dirs.add(d)

    def _land_payload(self, p: str, payload: bytes) -> bool:
        """Land a verified, already-encoded payload with the mode-
        appropriate discipline: rename in single-process mode, the
        ``os.link`` claim in shared mode (the sync-mirror write path,
        ``insert_raw``, must keep the written-exactly-once identity
        too — two shared servers pulling the same source would
        otherwise re-land each other's chunks via rename, invisibly
        to the claim accounting).  True = our bytes became the file."""
        if not self.shared_instance:
            self._write_payload(p, payload)
            _count("chunks_written")
            return True
        if self._claim_payload(p, payload):
            _count("chunks_written")
            return True
        _count("cross_process_hits")
        try:
            os.utime(p)           # the dedup-hit GC mark
        except OSError:
            pass
        return False

    def _write_payload(self, p: str, payload: bytes) -> None:
        """tmp+rename an already-encoded on-disk payload into place."""
        self._ensure_dir(os.path.dirname(p))
        atomicio.replace_bytes(p, payload, per_thread=True)

    def _claim_payload(self, p: str, payload: bytes) -> bool:
        """tmp + ``os.link`` CAS via atomicio: the final path is
        CREATED, never replaced, so exactly one process's write wins
        (EEXIST = lost claim).  The staging name carries pid+tid, so
        co-resident writers and sibling processes never collide."""
        self._ensure_dir(os.path.dirname(p))
        return atomicio.claim_bytes(p, payload)

    def _note_datablob_hit(self, digest: bytes, p: str, shard: int) -> None:
        """pbs-format dedup hit: a hit against a NATIVE raw-zstd chunk
        would leave this pbs-format snapshot referencing a file a stock
        PBS cannot decode — upgrade it to a DataBlob in place (this
        build reads both, so nothing else notices).  Confirmed once per
        digest: chunks are immutable, so the probe never needs
        repeating — the knowledge rides the dedup index (exact,
        unbounded) or, index-less, the bounded legacy set."""
        if self.blob_format != "pbs":
            return
        if self.index is not None:
            if self.index.is_datablob(digest):
                return
            self._upgrade_to_datablob(p, shard)
            self.index.mark_datablob(digest)
            return
        with self._datablob_lock:
            seen = digest in self._datablob_seen
        if not seen:
            self._upgrade_to_datablob(p, shard)
            self._remember_datablob(digest)

    def _remember_datablob(self, digest: bytes) -> None:
        with self._datablob_lock:
            if len(self._datablob_seen) >= self._datablob_seen_cap:
                # evict an arbitrary half, never everything: the hot
                # half re-learns in O(cap/2) probes instead of O(store)
                drop = len(self._datablob_seen) // 2
                it = iter(self._datablob_seen)
                victims = [next(it) for _ in range(drop)]
                self._datablob_seen.difference_update(victims)
            self._datablob_seen.add(digest)

    def _upgrade_to_datablob(self, p: str, shard: int = 0) -> None:
        from .pbsformat import blob_encode, is_datablob
        try:
            with open(p, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return          # vanished under us (external delete): the
                            # membership answer already handled it
        if is_datablob(raw):
            return
        data = self._dctx.decompress(raw, max_output_size=1 << 30)
        atomicio.replace_bytes(
            p, blob_encode(data, cctx=self._shard_cctx[shard]),
            per_thread=True)

    # absolute ceiling on a delta chain while REASSEMBLING — far above
    # any configurable max_chain; purely a corruption guard so a
    # damaged header can never recurse unboundedly
    MAX_DELTA_DEPTH = 64

    def get(self, digest: bytes) -> bytes:
        """Decompressed, verified chunk bytes.  Delta blobs resolve
        their base recursively through direct store reads — the
        READ-PATH consumers must instead go through the chunk cache
        (``get_resolved`` with the cache's resolver, wired by
        ``ChunkCache._load``), so a hot base decompresses once (pbslint
        rule ``delta-discipline``)."""
        return self.get_resolved(digest, None)

    def get_resolved(self, digest: bytes, resolver,
                     _chain: tuple = ()) -> bytes:
        """``get`` with pluggable base resolution: ``resolver(base_digest)
        -> bytes`` supplies delta bases (the chunk cache passes itself,
        making base reuse a cache hit); None falls back to recursive
        direct reads.  Every result — including reassembled deltas —
        re-verifies against ``digest`` before it is returned, so a wrong
        or corrupt base can never serve wrong bytes."""
        with open(self._path(digest), "rb") as f:
            raw = f.read()
        # read-side fault injection (docs/fault-injection.md): `raise`/
        # `delay` model EIO/slow disks; `corrupt` flips a bit in the raw
        # frame so the digest check below must catch it — proving a bad
        # chunk is never admitted to the read cache
        raw = failpoints.hit("pbsstore.chunk.read", raw)
        from .deltablob import DeltaError, is_delta, parse_header
        if is_delta(raw):
            from .similarityindex import METRICS as _SM
            # counted before the failpoint: an injected read fault IS a
            # delta read attempt, and chaos tests audit the pairing
            _SM.add("delta_reads")
            # delta-specific fault injection: fires only for delta
            # blobs, between the raw read and the reassembly
            try:
                raw = failpoints.hit("pbsstore.delta.read", raw)
            except BaseException:
                _SM.add("read_errors")
                raise
            try:
                _codec, depth, _rsz, base_digest = parse_header(raw)
                if depth > self.MAX_DELTA_DEPTH or \
                        len(_chain) >= self.MAX_DELTA_DEPTH or \
                        base_digest == digest or base_digest in _chain:
                    raise DeltaError(
                        f"delta chain corrupt at {digest.hex()[:16]} "
                        f"(depth {depth}, chain {len(_chain)})")
            except DeltaError:
                _SM.add("read_errors")
                raise
            # base-resolution failures propagate UNCOUNTED: a failed
            # inner read of a chained delta already counted itself at
            # its own frame — re-counting here would report one broken
            # reassembly as depth-many read errors
            _SM.add("base_resolves")
            if resolver is not None:
                base = resolver(base_digest)
            else:
                base = self.get_resolved(base_digest, None,
                                         _chain + (digest,))
            from .deltablob import decode as _delta_decode
            try:
                data = _delta_decode(raw, base)
            except (DeltaError, OSError):
                _SM.add("read_errors")
                raise
            if hashlib.sha256(data).digest() != digest:
                _SM.add("read_errors")
                raise IOError(f"delta chunk {digest.hex()} reassembled "
                              "to wrong bytes")
            return data
        from .pbsformat import blob_decode, is_datablob
        if is_datablob(raw):
            data = blob_decode(raw, dctx=self._dctx)
        else:
            data = self._dctx.decompress(raw, max_output_size=1 << 30)
        if hashlib.sha256(data).digest() != digest:
            raise IOError(f"chunk {digest.hex()} corrupt on disk")
        return data

    def touch(self, digest: bytes) -> None:
        try:
            os.utime(self._path(digest))
        except OSError:
            pass

    def touch_many(self, digests) -> None:
        """GC phase-1 mark over many digests, shard-parallel: digests
        group by shard and each shard's utime loop runs on its own
        worker (utime releases the GIL, so even a 1-core host overlaps
        the syscall waits)."""
        by_shard: dict[int, list[bytes]] = {}
        for d in digests:
            by_shard.setdefault(self.shard_of(d), []).append(d)
        if not by_shard:
            return
        if len(by_shard) == 1:
            for d in next(iter(by_shard.values())):
                self.touch(d)
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(8, len(by_shard)),
                thread_name_prefix="gc-mark") as ex:
            for group in by_shard.values():
                ex.submit(self._touch_all, group)

    def _touch_all(self, digests: "list[bytes]") -> None:
        for d in digests:
            self.touch(d)

    def chunk_size(self, digest: bytes) -> int:
        return os.path.getsize(self._path(digest))

    def delta_base_of(self, digest: bytes) -> "bytes | None":
        """The base digest this chunk's on-disk blob deltas against
        (None = full blob or missing).  Reads only the fixed-size
        header — the GC mark's closure walk stays cheap."""
        from .deltablob import HEADER_SIZE, DeltaError, is_delta, \
            parse_header
        try:
            with open(self._path(digest), "rb") as f:
                head = f.read(HEADER_SIZE)
        except OSError:
            return None
        if not is_delta(head):
            return None
        try:
            return parse_header(head)[3]
        except DeltaError:
            return None

    def delta_closure(self, digests: "set[bytes]") -> "set[bytes]":
        """Close a live digest set over delta base references: every
        chunk a live delta (transitively) reassembles from is itself
        live.  GC's mark MUST touch the closure, not the raw set — a
        base referenced only by deltas has no snapshot index entry, and
        sweeping it would orphan every delta above it.  Derived from
        the on-disk headers, never from index memory, so it survives
        restarts and index loss.

        The ``.delta-tier`` marker (written durably BEFORE the first
        delta blob) is the sole gate: no marker proves no delta exists
        on disk — tier on or off — so a store that never delta'd pays
        zero per-chunk header reads per GC (the disk-free-probe
        discipline)."""
        if not (self._delta_marked or self._store_may_hold_deltas()):
            return digests
        out = set(digests)
        frontier = list(digests)
        hops = 0
        while frontier and hops <= self.MAX_DELTA_DEPTH:
            nxt: list[bytes] = []
            for d in frontier:
                base = self.delta_base_of(d)
                if base is not None and base not in out:
                    out.add(base)
                    nxt.append(base)
            frontier = nxt
            hops += 1
        return out

    def refold_deltas(self, live: "set[bytes]",
                      doomed_bases: "set[bytes]") -> int:
        """Re-delta on GC (ROADMAP item 3): a base
        chunk kept alive ONLY by the delta closure — every snapshot
        that referenced it directly is pruned — would otherwise pin
        disk forever.  For every LIVE delta whose on-disk base is in
        ``doomed_bases``, reassemble the chunk and re-encode it WITHOUT
        that base: against a surviving similarity candidate when the
        tier is on (never against another doomed base), else as a plain
        full blob.  Content is immutable — the rewrite lands tmp+rename
        under the chunk's shard lock, same digest, so concurrent
        readers and in-flight sessions never notice.  Returns how many
        chunks were refolded; a chunk that fails to refold keeps its
        delta (the caller re-closes the live set, so its base stays
        marked — a refold failure degrades to the old keep-the-base
        behavior, never to a dangling delta)."""
        refolded = 0
        exclude = frozenset(doomed_bases)
        for d in live:
            base = self.delta_base_of(d)
            if base is None or base not in doomed_bases:
                continue
            try:
                # `raise` here models a mid-refold crash/EIO: the delta
                # must stay intact and GC must keep its base
                failpoints.hit("pbsstore.delta.refold")
                data = self.get(d)        # reassembles through the chain
            except (OSError, ValueError, failpoints.FailpointError) as e:
                L.warning("delta refold of %s failed: %s — keeping its "
                          "base marked", d.hex()[:16], e)
                continue
            p = self._path(d)
            shard = self.shard_of(d)
            # the WRITE leg degrades per-chunk too: an ENOSPC/EIO here
            # (GC often runs exactly when the disk is full) must keep
            # this delta and let the mark+sweep proceed — aborting the
            # whole prune would make GC unable to free a full disk
            try:
                with self._shard_locks[shard]:
                    if self._sim is not None:
                        self._sim.discard(d)   # re-sketched by the rewrite
                    if self._sim is None or not self._try_delta_write(
                            d, data, p, shard, exclude_bases=exclude):
                        self._write_chunk(p, data, shard)
            except OSError as e:
                L.warning("delta refold write of %s failed: %s — "
                          "keeping its base marked", d.hex()[:16], e)
                continue
            refolded += 1
        if refolded:
            from .similarityindex import METRICS as _SM
            _SM.add("refolds", refolded)
        return refolded

    def _store_may_hold_deltas(self) -> bool:
        """Tier currently off: a previous run may still have written
        delta blobs, so the closure must still run unless the store has
        never seen the tier.  Cheap sentinel: the tier drops a marker
        file before its first delta write."""
        return os.path.exists(self._delta_marker_path())

    def _delta_marker_path(self) -> str:
        return os.path.join(os.path.dirname(self.base), ".delta-tier")

    def _ensure_delta_marker(self) -> bool:
        """Durably mark the store as delta-bearing BEFORE the first
        delta blob lands (``_store_may_hold_deltas``); False = marker
        unwritable, caller must not write the delta."""
        if self._delta_marked:
            return True
        try:
            atomicio.replace_bytes(
                self._delta_marker_path(),
                b"delta blobs present; GC mark must close over "
                b"bases (docs/data-plane.md Similarity tier)\n")
        except OSError as e:
            L.warning("delta-tier marker unwritable (%s); storing full "
                      "blobs", e)
            return False
        self._delta_marked = True
        return True

    def iter_digests(self) -> Iterator[bytes]:
        for sub in sorted(os.listdir(self.base)):
            d = os.path.join(self.base, sub)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if len(name) == 64:
                    yield bytes.fromhex(name)

    def sweep(self, before: float) -> tuple[int, int]:
        """Remove chunks with atime/mtime older than ``before``; returns
        (count_removed, bytes_removed).  Caller is responsible for having
        touched all live chunks after the mark (GC phase 1).

        Runs shard-parallel: prefix dirs group by shard (first digest
        byte) and each shard sweeps on its own worker.  Index coherence:
        a digest leaves the filter BEFORE its file is unlinked, so the
        only reachable inconsistency is a safe false negative (a chunk
        on disk the index forgot re-stores idempotently) — a swept
        digest can never yield a false dedup skip.  The index snapshot
        is re-saved after the sweep so the next boot loads a
        post-sweep-coherent view."""
        # fires BEFORE any unlink: an injected fault proves the mark→sweep
        # ordering (a sweep that dies here has removed nothing — and has
        # discarded nothing from the index — so marked chunks, including
        # checkpoint-referenced ones, are untouched)
        failpoints.hit("pbsstore.chunk.sweep")
        # force the lazy index boot NOW, before any worker unlinks: a
        # boot scan racing the unlinks could re-learn a digest whose
        # discard already happened — exactly the false-skip the
        # discard-before-unlink ordering forbids
        _ = self.index
        by_shard: dict[int, list[str]] = {}
        for sub in os.listdir(self.base):
            if not os.path.isdir(os.path.join(self.base, sub)):
                continue
            try:
                shard = int(sub[:2], 16) % self.n_shards
            except ValueError:
                shard = 0
            by_shard.setdefault(shard, []).append(sub)
        if not by_shard:
            return 0, 0
        if len(by_shard) == 1:
            results = [self._sweep_subdirs(next(iter(by_shard.values())),
                                           before)]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(8, len(by_shard)),
                    thread_name_prefix="gc-sweep") as ex:
                results = list(ex.map(
                    lambda subs: self._sweep_subdirs(subs, before),
                    by_shard.values()))
        removed = sum(r for r, _ in results)
        freed = sum(f for _, f in results)
        if self.index is not None:
            # unconditional: boot consumed any previous snapshot, so a
            # zero-removal sweep must still leave one behind or every
            # restart in steady state re-pays the full shard scan
            try:
                self.save_index_snapshot()
            except OSError:
                pass        # snapshot is an optimization; the next boot
                            # falls back to the shard scan
        return removed, freed

    def _sweep_subdirs(self, subs: "list[str]",
                       before: float) -> tuple[int, int]:
        removed = 0
        freed = 0
        idx = self.index
        for sub in subs:
            d = os.path.join(self.base, sub)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            try:
                shard = int(sub[:2], 16) % self.n_shards
            except ValueError:
                shard = 0
            # the whole stat → discard → unlink pass for a subdir runs
            # under its shard lock (every digest in a prefix dir shares
            # its first byte) so a concurrent dedup hit cannot slip its
            # utime in after our stat: the server serializes GC against
            # jobs, but the store's own thread_safe contract must not
            # depend on that (a hit landing mid-pass would publish a
            # reference to a chunk this unlink deletes)
            with self._shard_locks[shard]:
                victims: "list[tuple[bytes, str, int]]" = []
                for name in names:
                    p = os.path.join(d, name)
                    if len(name) != 64:
                        # not a chunk (e.g. a crashed writer's .tmp
                        # debris): still reap when stale, but never
                        # count it in the chunk accounting
                        try:
                            st = os.stat(p)
                            if max(st.st_atime, st.st_mtime) < before:
                                # non-chunk debris (crashed writer's
                                # .tmp): no digest, nothing to discard
                                # pbslint: disable=ordering-discipline
                                os.unlink(p)
                        except OSError:
                            pass
                        continue
                    try:
                        digest = bytes.fromhex(name)
                    except ValueError:
                        continue     # 64-char non-hex stranger: leave it
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    if max(st.st_atime, st.st_mtime) < before:
                        victims.append((digest, p, st.st_size))
                if not victims:
                    continue
                # discard BEFORE unlink, BATCHED: one per-digest-acked
                # round to the index for the whole subdir — against a
                # distributed index that is ≤1 wire request per owning
                # shard instead of one HTTP probe per victim
                # (docs/dist-index.md "Cross-process discard").  A
                # digest the index did not ack keeps its file: the
                # failure direction stays the safe false negative (a
                # chunk on disk the index forgot re-stores
                # idempotently), never a discarded entry whose unlink
                # was skipped... which is why the unlink below only
                # ever runs under an ack.
                if idx is not None:
                    acks = idx.discard_many_acked([v[0] for v in victims])
                else:
                    acks = [True] * len(victims)
                for (digest, p, size), acked in zip(victims, acks):
                    if not acked:
                        continue
                    with self._pin_lock:
                        if digest in self._pinned_bases:
                            # a delta commit is mid-flight against this
                            # base: the file must survive.  The index
                            # already forgot it — a safe false negative
                            # (the base re-stores on next sight); the
                            # pinned reassembly reads from disk, not
                            # the index
                            continue
                        if self._sim is not None:
                            # same ordering for the sketch entry: a
                            # failed unlink leaves a chunk the tier
                            # merely stops offering as a base — never
                            # an offered base with no file
                            self._sim.discard(digest)
                        try:
                            os.unlink(p)
                        except OSError:
                            continue
                    # counted only after a successful unlink — an EPERM
                    # failure must not inflate bytes_freed
                    freed += size
                    removed += 1
        return removed, freed


class DynamicIndex:
    """Dynamic index: sorted (end_offset, digest) records over a stream.

    Reference: datastore.ParseDynamicIndex (DIDX).
    """

    def __init__(self, ends: np.ndarray, digests: np.ndarray,
                 uuid: bytes = b"\0" * 16, ctime_ns: int = 0):
        assert ends.dtype == np.uint64 and len(ends) == len(digests)
        self.ends = ends                  # cumulative end offsets, ascending
        self.digests = digests            # (n, 32) uint8
        self.uuid = uuid
        self.ctime_ns = ctime_ns

    # -- construction -----------------------------------------------------
    @classmethod
    def from_records(cls, records: list[tuple[int, bytes]],
                     uuid: bytes = b"", ctime_ns: int = 0) -> "DynamicIndex":
        ends = np.array([r[0] for r in records], dtype=np.uint64)
        digs = np.frombuffer(b"".join(r[1] for r in records),
                             dtype=np.uint8).reshape(-1, 32) if records else \
            np.empty((0, 32), dtype=np.uint8)
        if len(ends) and not np.all(np.diff(ends.astype(np.int64)) > 0):
            raise ValueError("index end offsets must be strictly increasing")
        return cls(ends, digs, uuid or os.urandom(16), ctime_ns)

    # -- properties -------------------------------------------------------
    @property
    def total_size(self) -> int:
        return int(self.ends[-1]) if len(self.ends) else 0

    def __len__(self) -> int:
        return len(self.ends)

    def chunk_bounds(self, i: int) -> tuple[int, int]:
        start = int(self.ends[i - 1]) if i > 0 else 0
        return start, int(self.ends[i])

    def digest(self, i: int) -> bytes:
        return self.digests[i].tobytes()

    def chunk_for_offset(self, offset: int) -> int:
        """Index of the chunk containing stream offset (0 <= off < total)."""
        if offset < 0 or offset >= self.total_size:
            raise IndexError(f"offset {offset} outside stream")
        return int(np.searchsorted(self.ends, offset, side="right"))

    def chunks_overlapping(self, start: int, end: int) -> Iterator[int]:
        if start >= end:
            return
        i = self.chunk_for_offset(start)
        while i < len(self.ends) and (int(self.ends[i - 1]) if i else 0) < end:
            yield i
            i += 1

    def records(self) -> Iterator[tuple[int, int, bytes]]:
        """Yields (start, end, digest) per chunk."""
        prev = 0
        for i in range(len(self.ends)):
            e = int(self.ends[i])
            yield prev, e, self.digests[i].tobytes()
            prev = e

    # -- io ---------------------------------------------------------------
    def write(self, path: str, *, fmt: str = "tpxd") -> None:
        """fmt="tpxd" (native) | "pbs" (stock-PBS dynamic index bytes —
        pbsformat.write_dynamic_index_bytes; ctime truncates ns→s)."""
        if fmt == "pbs":
            from .pbsformat import write_dynamic_index_bytes
            data = write_dynamic_index_bytes(
                [(int(e), self.digests[i].tobytes())
                 for i, e in enumerate(self.ends)],
                self.uuid, self.ctime_ns // 1_000_000_000)
            atomicio.replace_bytes(path, data)
            return
        arr = np.empty(len(self.ends), dtype=_REC_DTYPE)
        arr["end"] = self.ends
        arr["digest"] = np.ascontiguousarray(self.digests).view(
            np.dtype("V32")).reshape(-1)
        hdr = _HDR.pack(DIDX_MAGIC, DIDX_VERSION, 0, self.uuid,
                        self.ctime_ns, len(self.ends))
        with atomicio.atomic_write(path) as f:
            f.write(hdr)
            f.write(arr.tobytes())

    @classmethod
    def parse(cls, path: str) -> "DynamicIndex":
        """Sniffs the magic: reads native TPXD and stock-PBS dynamic
        indexes interchangeably (one reader for mixed-format datastores)."""
        with open(path, "rb") as f:
            head = f.read(8)
            f.seek(0)
            from .pbsformat import DYNAMIC_INDEX_MAGIC
            if head == DYNAMIC_INDEX_MAGIC:
                from .pbsformat import parse_dynamic_index_bytes
                parsed = parse_dynamic_index_bytes(f.read())
                ends = np.array([e for e, _ in parsed.records],
                                dtype=np.uint64)
                digs = np.frombuffer(
                    b"".join(d for _, d in parsed.records),
                    dtype=np.uint8).reshape(-1, 32) if parsed.records \
                    else np.empty((0, 32), dtype=np.uint8)
                return cls(ends, digs, parsed.uuid,
                           parsed.ctime_s * 1_000_000_000)
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                raise ValueError(f"{path}: truncated index header")
            magic, ver, _, uuid, ctime_ns, count = _HDR.unpack(hdr)
            if magic != DIDX_MAGIC:
                raise ValueError(f"{path}: bad index magic {magic!r}")
            if ver != DIDX_VERSION:
                raise ValueError(f"{path}: unsupported index version {ver}")
            raw = f.read(count * _REC_DTYPE.itemsize)
        if len(raw) < count * _REC_DTYPE.itemsize:
            raise ValueError(f"{path}: truncated index records")
        arr = np.frombuffer(raw, dtype=_REC_DTYPE)
        ends = arr["end"].astype(np.uint64)
        digs = np.frombuffer(arr["digest"].tobytes(), dtype=np.uint8).reshape(-1, 32)
        if len(ends) and not np.all(np.diff(ends.astype(np.int64)) > 0):
            raise ValueError(f"{path}: non-monotonic index")
        return cls(ends, digs, uuid, ctime_ns)


@dataclass(frozen=True)
class SnapshotRef:
    backup_type: str
    backup_id: str
    backup_time: str           # rfc3339 UTC
    namespace: str = ""        # "a/b" → dirs ns/a/ns/b/ (PBS layout,
                               # reference: ensureNamespaceDir,
                               # commit_orchestrate.go:307-326)

    @property
    def ns_rel(self) -> str:
        if not self.namespace:
            return ""
        return "/".join(f"ns/{p}"
                        for p in self.namespace.split("/")) + "/"

    @property
    def rel_dir(self) -> str:
        return (f"{self.ns_rel}{self.backup_type}/"
                f"{self.backup_id}/{self.backup_time}")

    def __str__(self) -> str:
        return self.rel_dir


MAX_NAMESPACE_DEPTH = validate.MAX_NAMESPACE_DEPTH   # one constant rules
                                                     # mint + parse limits


class Datastore:
    """Snapshot directory layout + listing over a ChunkStore.

    Reference: the PBS datastore dir structure the pxar lib reads/writes
    (snapshot dirs with didx files + manifest).
    """

    META_IDX = "root.midx"
    PAYLOAD_IDX = "root.pidx"
    # stock-PBS split-archive names (reference serves .mpxar.didx /
    # .ppxar.didx — SURVEY §2.2)
    META_IDX_PBS = "root.mpxar.didx"
    PAYLOAD_IDX_PBS = "root.ppxar.didx"
    MANIFEST = "manifest.json"
    MANIFEST_PBS = "index.json.blob"

    def __init__(self, base: str, *, pbs_format: bool = False,
                 store_shards: "int | None" = None,
                 dedup_index_mb: "int | None" = None,
                 dedup_resident_mb: "int | None" = None,
                 delta_tier: "bool | None" = None,
                 delta_threshold: "int | None" = None,
                 delta_max_chain: "int | None" = None,
                 shared_instance: "str | None" = None,
                 device="cuda"):
        """pbs_format=True publishes snapshots in the stock-PBS on-disk
        layout (DataBlob chunks, PBS dynamic indexes under .didx names,
        index.json.blob manifest) so a PBS can serve what this build
        writes.  Reads sniff per-file, so both layouts coexist.
        ``store_shards``/``dedup_index_mb`` size the chunk store's shard
        count and dedup-index budget (None → the PBS_PLUS_STORE_SHARDS /
        PBS_PLUS_DEDUP_INDEX_MB environment knobs); the ``delta_*``
        knobs configure the similarity-dedup tier (None → the
        PBS_PLUS_DELTA_* environment knobs; see ChunkStore).
        ``device`` is the chunk store's (see ChunkStore)."""
        self.base = base
        self.pbs_format = pbs_format
        os.makedirs(base, exist_ok=True)
        self.chunks = ChunkStore(base,
                                 blob_format="pbs" if pbs_format else "zstd",
                                 n_shards=store_shards,
                                 index_budget_mb=dedup_index_mb,
                                 index_resident_mb=dedup_resident_mb,
                                 delta_tier=delta_tier,
                                 delta_threshold=delta_threshold,
                                 delta_max_chain=delta_max_chain,
                                 shared_instance=shared_instance,
                                 device=device)

    @property
    def meta_idx_name(self) -> str:
        return self.META_IDX_PBS if self.pbs_format else self.META_IDX

    @property
    def payload_idx_name(self) -> str:
        return self.PAYLOAD_IDX_PBS if self.pbs_format else self.PAYLOAD_IDX

    def _find_idx(self, d: str, names: tuple[str, ...]) -> str:
        for n in names:
            p = os.path.join(d, n)
            if os.path.exists(p):
                return p
        return os.path.join(d, names[0])

    def snapshot_dir(self, ref: SnapshotRef) -> str:
        return os.path.join(self.base, ref.rel_dir)

    def namespaces(self) -> list[str]:
        """All namespaces with a directory, root ("") first, depth-first
        sorted, bounded at MAX_NAMESPACE_DEPTH."""
        out = [""]

        def walk(dir_: str, prefix: str, depth: int) -> None:
            if depth >= MAX_NAMESPACE_DEPTH:
                return
            nsdir = os.path.join(dir_, "ns")
            if not os.path.isdir(nsdir):
                return
            for name in sorted(os.listdir(nsdir)):
                sub = os.path.join(nsdir, name)
                if os.path.isdir(sub):
                    full = f"{prefix}/{name}" if prefix else name
                    out.append(full)
                    walk(sub, full, depth + 1)

        walk(self.base, "", 0)
        return out

    def _ns_base(self, namespace: str) -> str:
        if not namespace:
            return self.base
        return os.path.join(self.base, *(
            p for part in namespace.split("/") for p in ("ns", part)))

    def list_snapshots(self, backup_type: str | None = None,
                       backup_id: str | None = None, *,
                       namespace: str = "",
                       all_namespaces: bool = False) -> list[SnapshotRef]:
        spaces = self.namespaces() if all_namespaces else [namespace]
        out: list[SnapshotRef] = []
        for ns in spaces:
            base = self._ns_base(ns)
            types = [backup_type] if backup_type else [
                t for t in BACKUP_TYPES
                if os.path.isdir(os.path.join(base, t))]
            for t in types:
                tdir = os.path.join(base, t)
                if not os.path.isdir(tdir):
                    continue
                ids = [backup_id] if backup_id else sorted(os.listdir(tdir))
                for bid in ids:
                    iddir = os.path.join(tdir, bid)
                    if not os.path.isdir(iddir):
                        continue
                    for ts in sorted(os.listdir(iddir)):
                        if ".tmp." in ts:
                            continue        # a session's staging dir
                        snap = os.path.join(iddir, ts)
                        if os.path.exists(os.path.join(snap, self.MANIFEST)):
                            out.append(SnapshotRef(t, bid, ts, ns))
        return out

    def last_snapshot(self, backup_type: str, backup_id: str,
                      namespace: str = "") -> SnapshotRef | None:
        snaps = self.list_snapshots(backup_type, backup_id,
                                    namespace=namespace)
        return snaps[-1] if snaps else None

    def ensure_group_dir(self, ref: SnapshotRef) -> None:
        """Create the namespace chain + group dir for ``ref``.  In PBS
        layout each ns component is chowned to uid/gid 34 (the `backup`
        user) best-effort, so a stock PBS on the same host can manage
        what this build writes (reference: ensureNamespaceDir,
        commit_orchestrate.go:307-326)."""
        cur = self.base
        for part in (ref.namespace.split("/") if ref.namespace else []):
            cur = os.path.join(cur, "ns", part)
            fresh = not os.path.isdir(cur)
            os.makedirs(cur, exist_ok=True)
            if self.pbs_format and fresh:
                try:
                    os.chown(cur, 34, 34)
                    os.chown(os.path.dirname(cur), 34, 34)
                except OSError:
                    pass               # not root / no backup user: fine
        os.makedirs(os.path.join(
            cur, ref.backup_type, ref.backup_id), exist_ok=True)

    def load_manifest(self, ref: SnapshotRef) -> dict:
        with open(os.path.join(self.snapshot_dir(ref), self.MANIFEST)) as f:
            return json.load(f)

    def load_indexes(self, ref: SnapshotRef) -> tuple[DynamicIndex, DynamicIndex]:
        d = self.snapshot_dir(ref)
        return (DynamicIndex.parse(self._find_idx(
                    d, (self.META_IDX, self.META_IDX_PBS))),
                DynamicIndex.parse(self._find_idx(
                    d, (self.PAYLOAD_IDX, self.PAYLOAD_IDX_PBS))))

    def remove_snapshot(self, ref: SnapshotRef) -> None:
        import shutil
        shutil.rmtree(self.snapshot_dir(ref), ignore_errors=True)
