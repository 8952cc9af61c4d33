"""Chunk-index probe: cuckoo lookups on a torch device table (K3).

Counterpart of the JAX package's ``ops/cuckoo.py``.  The device table holds
64-bit fingerprints (digest words 0..1) in ``uint32[n_buckets, SLOTS, 2]``,
probed as one int64 per slot; bucket 1 is digest word 2 masked, bucket 2 is
bucket 1 ^ mix(fingerprint).  A probe is a gather of the two buckets and a
compare, in PyTorch ops on the index's device (the TPU side left it to XLA
the same way; no hand kernel).  Inserts run on the host numpy mirror, which
stays authoritative: after the same inserts and seed its bytes equal the JAX
package's.

``device_table`` keeps the device copy current.  The reference re-uploads
the whole mirror after any insert; at the default 64 MiB table that is a
64 MiB host-to-device copy per probe batch in the store's probe-then-insert
loop.  Here every write to the mirror records its bucket, and the next
``device_table`` copies only those rows (one gather on the host, one
``index_copy_`` on the device); a rebuild or growth, which reallocates the
mirror, uploads it whole.  ``stats`` counts both kinds of upload and their
bytes.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..utils.device import host_tensor, resolve

SLOTS = 4
_MIX = np.uint32(0x9E3779B1)
_MAX_KICKS = 500
BUCKET_BYTES = SLOTS * 2 * 4        # uint32[SLOTS, 2] per bucket


def buckets_for_bytes(budget_bytes: int, *, minimum: int = 1 << 10) -> int:
    """Largest power-of-two bucket count whose table fits the budget
    (the PBS_PLUS_DEDUP_INDEX_MB sizing rule in pxar/chunkindex.py)."""
    nb = minimum
    while nb * 2 * BUCKET_BYTES <= budget_bytes:
        nb *= 2
    return nb


def _digest_words(digests: np.ndarray):
    """digests uint8[N,32] → (fp0, fp1, idx) uint32[N] each."""
    w = digests.reshape(-1, 8, 4).astype(np.uint32)
    word = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    return word[:, 0], word[:, 1], word[:, 2]


def lookup_host(table: np.ndarray, digests: np.ndarray) -> np.ndarray:
    """numpy twin of ``_lookup`` over the host mirror: table
    uint32[NB, SLOTS, 2]; digests uint8[N, 32] → bool[N].

    Hot-path formulation: digest words come from a big-endian u32 view
    (one vectorized byteswap of 3 words/digest instead of 4 shifts + 3
    ors over all 8), and the (fp0, fp1) pair compares as ONE u64 per
    slot via a view of the table — half the gathers and compares of the
    naive twin."""
    nb = table.shape[0]
    if not digests.flags.c_contiguous:
        digests = np.ascontiguousarray(digests)
    w = digests.view(">u4")             # [N, 8] big-endian words
    fp0 = w[:, 0].astype(np.uint32)
    fp1 = w[:, 1].astype(np.uint32)
    bidx = w[:, 2].astype(np.uint32)
    fp0 = np.where((fp0 == 0) & (fp1 == 0), np.uint32(0x5A5A5A5A), fp0)
    mask = np.uint32(nb - 1)
    b1 = bidx & mask
    b2 = b1 ^ ((fp0 * _MIX) & mask)
    # little-endian slot memory [fp0, fp1] == u64 fp0 | fp1<<32
    t64 = table.view(np.uint64).reshape(nb, SLOTS)
    fpc = fp0.astype(np.uint64) | (fp1.astype(np.uint64) << np.uint64(32))
    hit = (t64[b1] == fpc[:, None]).any(axis=1)
    hit |= (t64[b2] == fpc[:, None]).any(axis=1)
    return hit


# device probes made by ``_lookup`` (the K3 gather/compare), on any device,
# and the device table's uploads: whole-table copies, row copies, bytes
stats = {"device_probes": 0, "table_uploads": 0, "row_uploads": 0,
         "upload_bytes": 0}


def _fingerprint_buckets(digests: torch.Tensor, n_buckets: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """digests uint8[N, 32] -> int64[N] each: the fingerprint as the
    table's int64 slot value, and its two buckets in a table of
    ``n_buckets``."""
    q = digests[:, :12].reshape(-1, 3, 4).to(torch.int64)
    w = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]
    fp0, fp1, bidx = w[:, 0], w[:, 1], w[:, 2]
    fp0 = torch.where((fp0 == 0) & (fp1 == 0), 0x5A5A5A5A, fp0)
    mask = n_buckets - 1
    b1 = bidx & mask
    # low bits of a product depend only on the operands' low bits, so the
    # mix stays exact in int64
    b2 = b1 ^ (((fp0 & mask) * (int(_MIX) & mask)) & mask)
    # little-endian slot memory [fp0, fp1] == int64 fp0 + fp1 * 2**32, with
    # fp1 taken as signed so the sum never leaves the int64 range
    fpc = fp0 + (fp1 - ((fp1 >> 31) << 32)) * (1 << 32)
    return fpc, b1, b2


def _lookup(table64: torch.Tensor, digests: torch.Tensor) -> torch.Tensor:
    """table64 int64[NB, SLOTS] (the mirror's slots as one int64 each);
    digests uint8[N, 32] on the same device → bool[N]."""
    stats["device_probes"] += 1
    fpc, b1, b2 = _fingerprint_buckets(digests, table64.shape[0])
    hit = (table64[b1] == fpc[:, None]).any(dim=1)
    return hit | (table64[b2] == fpc[:, None]).any(dim=1)


def _locked(method):
    """Run ``method`` under the index's lock (see ``CuckooIndex``)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return run


class CuckooIndex:
    """Chunk-presence index: device-probe, host-authoritative.

    Every public method runs under one re-entrant lock, so callers that
    share an index across threads (the sidecar's gRPC handlers) cannot
    interleave a mirror write with the row bookkeeping of
    ``device_table``: a bucket written between the gather of the touched
    rows and their reset would otherwise stay stale on the device."""

    def __init__(self, n_buckets: int = 1 << 16, seed: int = 0, *,
                 device="cuda"):
        if n_buckets & (n_buckets - 1):
            raise ValueError("n_buckets must be a power of two")
        self.device = resolve(device)
        self._lock = threading.RLock()
        self.n_buckets = n_buckets
        self._table = np.zeros((n_buckets, SLOTS, 2), dtype=np.uint32)
        self._device_table: torch.Tensor | None = None
        # _dirty: the device copy must be uploaded whole; _touched: the
        # buckets written since the last upload (ints from scalar writes,
        # arrays from bulk placements), _n_touched their count
        self._dirty = True
        self._touched: list = []
        self._n_touched = 0
        self._known: set[bytes] = set()       # authoritative
        self._rng = np.random.default_rng(seed)
        # filter-only mode (the spillable exact tier, pxar/digestlog.py):
        # membership truth lives OUTSIDE this object, `_known` stays
        # empty, `_n_fp` counts resident fingerprints for the growth
        # trigger, and growth rebuilds stream every live digest back
        # from the attached source instead of an in-RAM set
        self._n_fp = 0
        self._digest_source = None

    # -- host authoritative ----------------------------------------------
    def __len__(self) -> int:
        return len(self._known)

    def contains_exact(self, digest: bytes) -> bool:
        return digest in self._known

    def _fp_bucket(self, digest: bytes) -> tuple[int, int, int, int]:
        d = np.frombuffer(digest, dtype=np.uint8)[None]
        fp0, fp1, bidx = _digest_words(d)
        fp0, fp1, bidx = int(fp0[0]), int(fp1[0]), int(bidx[0])
        if fp0 == 0 and fp1 == 0:
            fp0 = 0x5A5A5A5A
        mask = self.n_buckets - 1
        b1 = bidx & mask
        b2 = b1 ^ ((fp0 * int(_MIX)) & 0xFFFFFFFF & mask)
        return fp0, fp1, b1, b2

    @_locked
    def insert(self, digest: bytes) -> bool:
        """Insert; returns False if already present."""
        if digest in self._known:
            return False
        self._known.add(digest)
        fp0, fp1, b1, b2 = self._fp_bucket(digest)
        self._insert_fp(fp0, fp1, b1, b2)
        return True

    @_locked
    def discard(self, digest: bytes) -> bool:
        """Remove a digest (GC sweep coherence: a swept chunk must leave
        the filter).  Returns False if it was never present.  The table
        slot is zeroed when the fingerprint is found in either bucket; a
        fingerprint shared with ANOTHER digest (same fp+bucket pair,
        ~2⁻⁶⁴) keeps its own slot, and at worst a removal turns into a
        false NEGATIVE for that twin — which is safe: a false negative
        re-stores a chunk that exists, never skips one that doesn't."""
        if digest not in self._known:
            return False
        self._known.discard(digest)
        fp0, fp1, b1, b2 = self._fp_bucket(digest)
        for b in (b1, b2):
            row = self._table[b]
            for s in range(SLOTS):
                if row[s, 0] == fp0 and row[s, 1] == fp1:
                    row[s] = (0, 0)
                    self._touch(b)
                    return True
        # fingerprint not in the mirror (dropped during an eviction
        # overflow before a growth rebuild): the authoritative set is
        # already updated, so membership answers stay correct
        return True

    @_locked
    def discard_many(self, digests) -> int:
        n = 0
        for d in digests:
            if self.discard(d):
                n += 1
        return n

    @_locked
    def probe_host(self, digests: np.ndarray) -> np.ndarray:
        """Batched maybe-present over the host mirror (numpy, no device):
        digests uint8[N,32] → bool[N].  The CPU-only probe path of
        ``probe``; confirm hits via ``contains_exact`` before skipping
        an upload."""
        return lookup_host(self._table, digests)

    def _touch(self, rows) -> None:
        """Record buckets written to the mirror (an int or an int array)
        for the next ``device_table``.  Nothing is recorded while the
        device copy is absent or due whole, and past a quarter of the
        table the next upload is a whole one."""
        if self._device_table is None or self._dirty:
            return
        self._touched.append(rows)
        self._n_touched += np.size(rows)
        if 4 * self._n_touched >= self.n_buckets:
            self._dirty = True
            self._touched, self._n_touched = [], 0

    def _insert_fp(self, fp0: int, fp1: int, b1: int, b2: int,
                   *, grow: bool = True) -> bool:
        for b in (b1, b2):
            row = self._table[b]
            for s in range(SLOTS):
                if row[s, 0] == 0 and row[s, 1] == 0:
                    row[s] = (fp0, fp1)
                    self._touch(b)
                    return True
        # eviction chain
        b = b1
        cur = np.array([fp0, fp1], dtype=np.uint32)
        for _ in range(_MAX_KICKS):
            s = int(self._rng.integers(0, SLOTS))
            victim = self._table[b, s].copy()
            self._table[b, s] = cur
            self._touch(b)
            cur = victim
            vfp0 = int(cur[0])
            mask = self.n_buckets - 1
            b = b ^ ((vfp0 * int(_MIX)) & 0xFFFFFFFF & mask)
            row = self._table[b]
            for s2 in range(SLOTS):
                if row[s2, 0] == 0 and row[s2, 1] == 0:
                    row[s2] = cur
                    self._touch(b)
                    return True
        if not grow:
            # mid-rebuild overflow: the rebuild loop doubles and retries
            # from a fresh source pass (the displaced fingerprint is
            # re-placed there — its digest is in the source)
            return False
        self._grow()
        # nothing left to re-place: _grow()'s rebuild covered every
        # digest (the in-RAM set, or the attached source — callers add
        # the digest to the source BEFORE inserting its fingerprint)
        return True

    def _grow(self) -> None:
        self.n_buckets *= 2
        self._rebuild_bulk()

    # -- filter-only surface (spillable exact tier) ------------------------
    @_locked
    def attach_digest_source(self, source) -> None:
        """Enter filter-only mode: ``source()`` must yield every LIVE
        digest (pxar/digestlog.py's merged view) — growth rebuilds
        stream it instead of an in-RAM ``_known`` set."""
        self._digest_source = source

    @_locked
    def maybe_contains(self, digest: bytes) -> bool:
        """Scalar filter lookup (maybe-present; the caller confirms a
        positive against the exact tier before any dedup skip)."""
        fp0, fp1, b1, b2 = self._fp_bucket(digest)
        for b in (b1, b2):
            row = self._table[b]
            for s in range(SLOTS):
                if row[s, 0] == fp0 and row[s, 1] == fp1:
                    return True
        return False

    @_locked
    def insert_fp(self, digest: bytes) -> None:
        """Insert ONE fingerprint (filter-only mode; caller already
        recorded the digest in the exact tier, so a growth rebuild
        finds it in the source)."""
        self._n_fp += 1
        if self._n_fp > self.n_buckets * SLOTS * 0.85:
            self._grow()
        else:
            fp0, fp1, b1, b2 = self._fp_bucket(digest)
            self._insert_fp(fp0, fp1, b1, b2)

    @_locked
    def insert_fp_many(self, digests: "list[bytes]") -> None:
        """Bulk fingerprint insert (filter-only mode): group-wise free
        slot placement, eviction chains only for the overflow tail —
        the ``insert_many`` machinery without the membership set."""
        if not digests:
            return
        self._n_fp += len(digests)
        grew = False
        while self._n_fp > self.n_buckets * SLOTS * 0.85:
            self.n_buckets *= 2
            grew = True
        if grew or self._table.shape[0] != self.n_buckets:
            self._rebuild_bulk()       # source already holds the batch
        else:
            arr = np.frombuffer(b"".join(digests),
                                dtype=np.uint8).reshape(-1, 32)
            nb = self.n_buckets
            for i in self._place_bulk(arr):
                fp0, fp1, b1, b2 = self._fp_bucket(digests[int(i)])
                self._insert_fp(fp0, fp1, b1, b2)
                if self.n_buckets != nb:
                    break              # the growth rebuild placed the rest

    @_locked
    def discard_fp(self, digest: bytes) -> None:
        """Zero the fingerprint slot (filter-only mode).  A twin digest
        sharing the fp+bucket pair degrades to a safe false negative,
        exactly like ``discard``."""
        self._n_fp = max(0, self._n_fp - 1)
        fp0, fp1, b1, b2 = self._fp_bucket(digest)
        for b in (b1, b2):
            row = self._table[b]
            for s in range(SLOTS):
                if row[s, 0] == fp0 and row[s, 1] == fp1:
                    row[s] = (0, 0)
                    self._touch(b)
                    return

    @_locked
    def insert_many(self, digests: list[bytes]) -> int:
        """Bulk insert, vectorized: one numpy pass computes every
        fingerprint/bucket pair, free slots are allocated group-wise on
        the host mirror, and only the overflow tail (buckets whose free
        slots ran out) falls back to per-digest eviction chains.  A 1M
        preload (PBSStore ``previous`` known-digest warm-up) builds in
        one pass instead of a million Python round-trips."""
        digests = list(digests)          # accept any iterable, like insert
        for d in digests:
            if len(d) != 32:
                raise ValueError(f"digest must be 32 bytes, got {len(d)}")
        fresh = [d for d in digests if d not in self._known]
        if not fresh:
            return 0
        # in-batch dedupe, preserving first occurrence
        seen: set[bytes] = set()
        uniq = [d for d in fresh if not (d in seen or seen.add(d))]
        self._known.update(uniq)
        # grow proactively so the bulk placement isn't done at a load
        # factor where eviction chains dominate
        while len(self._known) > self.n_buckets * SLOTS * 0.85:
            self.n_buckets *= 2
        arr = np.frombuffer(b"".join(uniq), dtype=np.uint8).reshape(-1, 32)
        if self._table.shape[0] != self.n_buckets:
            self._rebuild_bulk()            # re-places every known digest
        else:
            nb = self.n_buckets
            for i in self._place_bulk(arr):
                fp0, fp1, b1, b2 = self._fp_bucket(uniq[int(i)])
                self._insert_fp(fp0, fp1, b1, b2)
                if self.n_buckets != nb:
                    # _insert_fp grew the table, and the rebuild placed
                    # every known digest — the rest of the tail included
                    break
        return len(uniq)

    def _fp_buckets_vec(self, arr: np.ndarray):
        """uint8[N,32] → (fp0, fp1, b1, b2) uint32[N] each (the
        vectorized twin of ``_fp_bucket``)."""
        fp0, fp1, bidx = _digest_words(arr)
        fp0 = np.where((fp0 == 0) & (fp1 == 0),
                       np.uint32(0x5A5A5A5A), fp0).astype(np.uint32)
        mask = np.uint32(self.n_buckets - 1)
        b1 = bidx & mask
        b2 = b1 ^ ((fp0 * _MIX) & mask)
        return fp0, fp1, b1, b2

    def _place_bulk(self, arr: np.ndarray) -> np.ndarray:
        """Place digests uint8[N,32] into free slots of the host mirror
        without eviction; returns the indices (into ``arr``) that did not
        fit and need the eviction-chain fallback."""
        fp0, fp1, b1, b2 = self._fp_buckets_vec(arr)
        remaining = np.ones(arr.shape[0], dtype=bool)
        for bk in (b1, b2):
            idx = np.flatnonzero(remaining)
            if not idx.size:
                break
            order = np.argsort(bk[idx], kind="stable")
            sel_i = idx[order]              # arr-indices sorted by bucket
            bs = bk[sel_i]
            # rank of each entry within its equal-bucket run
            new_grp = np.r_[True, bs[1:] != bs[:-1]]
            starts = np.flatnonzero(new_grp)
            rank = np.arange(bs.size) - np.repeat(
                starts, np.diff(np.r_[starts, bs.size]))
            free = (self._table[bs, :, 0] == 0) & \
                   (self._table[bs, :, 1] == 0)          # [n, SLOTS]
            cfree = np.cumsum(free, axis=1)
            fits = cfree[:, -1] > rank
            # the (rank+1)-th free slot of the bucket, for entries that fit
            slot = np.argmax((cfree == (rank + 1)[:, None]) & free, axis=1)
            put = sel_i[fits]
            self._table[bs[fits], slot[fits], 0] = fp0[put]
            self._table[bs[fits], slot[fits], 1] = fp1[put]
            self._touch(bs[fits])
            remaining[put] = False
        return np.flatnonzero(remaining)

    def _rebuild_bulk(self) -> None:
        """Zero the mirror at the current ``n_buckets`` and re-place
        every known digest with the vectorized path (bulk twin of
        ``_grow``).  In filter-only mode the digests stream from the
        attached source in bounded batches — 10⁹ fingerprints rebuild
        without ever materializing the digest set in RAM.  A placement
        overflow mid-rebuild doubles the table and retries from a fresh
        source pass (no nested-grow recursion)."""
        while True:
            self._table = np.zeros((self.n_buckets, SLOTS, 2),
                                   dtype=np.uint32)
            self._dirty = True
            if self._place_all():
                return
            self.n_buckets *= 2

    def _place_all(self) -> bool:
        if self._known or self._digest_source is None:
            src = iter(self._known)
        else:
            src = self._digest_source()
            self._n_fp = 0             # recounted as the stream places
        batch: list[bytes] = []
        for d in src:
            batch.append(d)
            if len(batch) == (1 << 19):
                if not self._place_batch(batch):
                    return False
                batch.clear()
        return self._place_batch(batch) if batch else True

    def _place_batch(self, known: "list[bytes]") -> bool:
        if self._digest_source is not None and not self._known:
            self._n_fp += len(known)
        arr = np.frombuffer(b"".join(known), dtype=np.uint8).reshape(-1, 32)
        for i in self._place_bulk(arr):
            fp0, fp1, b1, b2 = self._fp_bucket(known[int(i)])
            if not self._insert_fp(fp0, fp1, b1, b2, grow=False):
                return False
        return True

    # -- device probe -----------------------------------------------------
    @_locked
    def device_table(self) -> torch.Tensor:
        """int64[NB, SLOTS]: the host mirror on the index's device, one
        int64 per slot.  Uploaded whole the first time and after a
        rebuild; otherwise only the buckets written since the last call
        are copied (module docstring)."""
        t64 = self._table.view(np.int64).reshape(self.n_buckets, SLOTS)
        dt = self._device_table
        rows = None
        if not (self._dirty or dt is None or dt.shape[0] != self.n_buckets):
            if not self._touched:
                return dt
            rows = np.unique(np.concatenate(
                [np.atleast_1d(r).astype(np.int64) for r in self._touched]))
        self._touched, self._n_touched = [], 0
        self._dirty = False
        if rows is None:
            # pageable host memory: the copy is done when .to() returns,
            # so later inserts may write the mirror at once
            self._device_table = torch.from_numpy(t64.copy()).to(self.device)
            stats["table_uploads"] += 1
            stats["upload_bytes"] += t64.nbytes
        else:
            vals = torch.from_numpy(t64[rows])           # a gathered copy
            idx = torch.from_numpy(rows.astype(np.int64))
            dt.index_copy_(0, idx.to(self.device), vals.to(self.device))
            stats["row_uploads"] += 1
            stats["upload_bytes"] += vals.numel() * 8 + idx.numel() * 8
        return self._device_table

    @_locked
    def probe(self, digests: np.ndarray | torch.Tensor) -> torch.Tensor:
        """digests uint8[N,32] → bool[N] on the index's device
        (maybe-present; exact-confirm via contains_exact on hits if false
        positives matter)."""
        if isinstance(digests, np.ndarray):
            digests = host_tensor(np.ascontiguousarray(digests, dtype=np.uint8))
        d = digests.to(self.device)
        return _lookup(self.device_table(), d)

    @_locked
    def probe_confirmed(self, digests: list[bytes]) -> list[bool]:
        arr = np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 32)
        maybe = self.probe(arr).cpu().numpy()
        return [bool(m) and (d in self._known) for m, d in zip(maybe, digests)]
