"""Cross-session fused ingest: ragged batching across concurrent writers.

Counterpart of the JAX package's ``pxar/ingestbatch.py``.  The ingest hot
path is four separately batched stages -- CDC candidate scan, SHA-256,
dedup-index probe, similarity presketch -- each dispatched per session,
so a fleet of N concurrent agents pays N x stages dispatches per flush.
This module packs every concurrent session's pending work into one
ragged batch and runs the whole ladder as one fused pass per flush:

    pack rows -> CDC scan (K1) -> cut selection -> SHA-256 (K2)
              -> index probe (K3, in the store's index) -> presketch
              -> inserts

The mechanism (packing layout, one K1 launch per flush, the batched K2)
lives in ``ops/ingest.py``; this module is the policy: who deposits,
when a batch flushes, and how results fan back out.

Deposit protocol
----------------

Writers deposit **parcels** and block until their parcel's flush
completes (``IngestCollector.submit``):

- ``FusedIngestStream`` deposits *scan parcels* -- raw unscanned stream
  windows with their 63-byte tail context; the flush scans them, selects
  cuts (the shared ``spec.select_cuts`` greedy pass, so cut parity with
  the staged writer is structural), slices chunks, and carries them into
  the same flush's hash/probe/presketch stages.
- ``transfer._ChunkedStream._flush_hashes`` and the JAX package's
  pipelined batch committer deposit *chunk parcels* -- already-cut chunks
  awaiting sha/probe/presketch.  The collector reads a depositing
  stream's ``records``, ``params`` and ``_insert_probed`` and nothing
  else, so either package's streams deposit here.

Flush policy (the bounded-wait guarantee):

- **all-deposited** -- every registered stream has a parcel pending:
  nobody else can contribute, flush immediately.
- **size** -- pending payload bytes >= ``batch_bytes`` or pending chunks
  >= ``batch_chunks``.
- **quiescence linger** -- no deposit has arrived anywhere for
  ``max_wait/8`` (min 2 ms): co-depositors that were going to contribute
  already have, so stop accumulating latency.
- **deadline** -- a parcel older than ``max_wait`` flushes whatever is
  pending (each blocked depositor re-checks on its own timeout; no timer
  thread to leak).

The flusher is whichever depositor observes a trigger; it runs the fused
pass outside the collector lock (new deposits queue for the next batch;
one flush runs at a time), completes every parcel -- filling each
stream's record slots and running its per-chunk inserts -- then wakes
all waiters.  A stage-level failure poisons every parcel in the batch; a
per-stream insert failure poisons only that stream's parcel.

The port's differences: the collector runs its kernels on one device,
resolved once at construction (``device="cuda"``, the calling thread's
current card; it raises without one), whichever writer's thread flushes;
``collector_for`` memoizes on its own store attribute, apart from the
JAX package's, and the counters (``METRICS``) are the port's own.

Store thread-safety: completions run on flusher threads, so a caller
wraps a store that is not thread-safe with ``pipeline.locked_store``
before building fused streams over it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np

from ..chunker.spec import select_cuts
from ..ops import ingest as ingest_ops
from ..ops.ingest import HALO     # the packing layout's one halo width
from ..utils import trace
from ..utils.device import resolve_indexed
from .ingestbackend import resolve_ingest_backend
from .transfer import _ChunkedStream

L = logging.getLogger(__name__)

# a fused stream deposits once this many bytes are unscanned (the JAX
# package's chunker/cpu.py feed coalescing, copied)
_FEED_COALESCE = 1 << 18


class IngestBatchMetrics:
    """Process-global fused-ingest counters (the JAX server renders its
    own as ``pbs_plus_ingest_batch_*``; these are the port's)."""

    _COUNTERS = ("flushes", "failed_flushes", "sessions_packed", "rows",
                 "chunks", "bytes_packed", "padding_bytes",
                 "probe_dispatches", "presketch_dispatches",
                 "linger_flushes", "deadline_flushes")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)   # guarded-by: self._lock

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
        packed = out["bytes_packed"]
        total = packed + out["padding_bytes"]
        # payload fraction of the packed scan buffers: 1.0 = zero
        # halo overhead
        out["occupancy"] = round(packed / total, 4) if total else 0.0
        return out


METRICS = IngestBatchMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


class _Parcel:
    """One stream's deposit awaiting the next fused flush."""

    __slots__ = ("stream", "kind", "blocks", "chunks", "final",
                 "nbytes", "nchunks", "t", "done", "error")

    def __init__(self, stream, kind: str, *, blocks=None, chunks=None,
                 final: bool = False):
        self.stream = stream
        self.kind = kind            # "scan" | "chunks"
        self.blocks = blocks        # scan: list of bytes-like blocks
        self.chunks = chunks        # chunks: list[(record_idx, chunk)]
        self.final = final
        self.nbytes = (sum(len(b) for b in blocks) if blocks is not None
                       else sum(len(c) for _, c in chunks))
        self.nchunks = len(chunks) if chunks is not None else 0
        self.t = time.monotonic()
        self.done = False
        self.error: "BaseException | None" = None


class IngestCollector:
    """Cross-session fused-ingest batching domain for one store, with
    its kernels on ``device`` (module docstring: deposit protocol and
    flush policy)."""

    def __init__(self, store, *, device="cuda", batch_bytes: int = 16 << 20,
                 batch_chunks: int = 4096, max_wait: float = 0.025):
        self.device = resolve_indexed(device)
        self.store = store
        self.batch_bytes = max(1, int(batch_bytes))
        self.batch_chunks = max(1, int(batch_chunks))
        self.max_wait = max(0.001, float(max_wait))
        # quiescence linger: once deposits stop arriving for this long,
        # nobody else is about to contribute -- flush early instead of
        # sitting out the full deadline (an idle registered stream
        # defeats the all-deposited trigger)
        self.linger = min(self.max_wait, max(0.002, self.max_wait / 8.0))
        self._backend = resolve_ingest_backend(store)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._parcels: "list[_Parcel]" = []      # guarded-by: self._lock
        self._pending_bytes = 0                  # guarded-by: self._lock
        self._pending_chunks = 0                 # guarded-by: self._lock
        self._last_deposit = 0.0                 # guarded-by: self._lock
        self._streams: set = set()               # guarded-by: self._lock
        self._flushing = False                   # guarded-by: self._lock

    # -- registration ------------------------------------------------------
    def register(self, stream) -> None:
        """Count ``stream`` toward the all-deposited flush trigger (a
        registered stream that idles costs co-depositors at most
        ``max_wait`` per batch)."""
        with self._lock:
            self._streams.add(stream)

    def deregister(self, stream) -> None:
        with self._lock:
            self._streams.discard(stream)
            # remaining depositors may now be "all deposited"
            self._cv.notify_all()

    # -- deposit surface ---------------------------------------------------
    def ingest_chunks(self, stream, batch: "list") -> None:
        """Deposit a pre-cut chunk batch (``[(record_idx, chunk), ...]``)
        for fused sha -> probe -> presketch -> insert; blocks until this
        stream's records are filled and its inserts committed."""
        self.submit(_Parcel(stream, "chunks", chunks=batch))

    def submit(self, parcel: _Parcel) -> None:
        """Deposit and block until the parcel's flush completes (bounded
        by the flush policy; re-raises the parcel's failure)."""
        with self._lock:
            self._parcels.append(parcel)
            self._pending_bytes += parcel.nbytes
            self._pending_chunks += parcel.nchunks
            self._last_deposit = time.monotonic()
            self._cv.notify_all()
        deadline = parcel.t + self.max_wait
        while True:
            batch = None
            with self._lock:
                if parcel.done:
                    break
                now = time.monotonic()
                # quiescent = no deposit anywhere for one linger window
                wake = min(deadline, self._last_deposit + self.linger)
                if not self._flushing and now >= wake:
                    # a true deadline expiry is a latency signal; a
                    # quiescence flush is batching working -- count them
                    # apart
                    METRICS.add("deadline_flushes" if now >= deadline
                                else "linger_flushes")
                    batch, self._parcels = self._parcels, []
                    self._pending_bytes = 0
                    self._pending_chunks = 0
                    self._flushing = True
                elif not self._flushing and self._should_flush():
                    batch, self._parcels = self._parcels, []
                    self._pending_bytes = 0
                    self._pending_chunks = 0
                    self._flushing = True
                else:
                    remaining = wake - now
                    self._cv.wait(timeout=remaining if remaining > 0
                                  else self.linger)
                    continue
            # the fused pass runs outside the lock: new deposits queue
            # for the next batch while this one is in flight
            try:
                self._run_flush(batch)
            finally:
                with self._lock:
                    self._flushing = False
                    for p in batch:
                        p.done = True
                    self._cv.notify_all()
        if parcel.error is not None:
            raise parcel.error

    # -- flush policy ------------------------------------------------------
    def _should_flush(self) -> bool:
        """Caller holds self._lock."""
        if not self._parcels:
            return False
        if self._pending_bytes >= self.batch_bytes:
            return True
        if self._pending_chunks >= self.batch_chunks:
            return True
        waiting = {id(p.stream) for p in self._parcels}
        return all(id(s) in waiting for s in self._streams)

    # -- the fused pass ----------------------------------------------------
    def _run_flush(self, parcels: "list[_Parcel]") -> None:
        sessions = len({id(p.stream) for p in parcels})
        # counted up-front so a failed flush still counts; failed_flushes
        # marks the poisoned ones apart
        METRICS.add("flushes")
        METRICS.add("sessions_packed", sessions)
        work: "list[tuple]" = []    # (stream, record_idx, chunk, parcel)
        try:
            with trace.span("ingest.fused", parcels=len(parcels),
                            sessions=sessions):
                scans = [p for p in parcels if p.kind == "scan"]
                per_parcel_ends = self._scan_stage(scans)
                for p in scans:
                    for idx, chunk in p.stream._apply_scan(
                            p, per_parcel_ends.get(id(p), None)):
                        work.append((p.stream, idx, chunk, p))
                for p in parcels:
                    if p.kind == "chunks":
                        for idx, chunk in p.chunks:
                            work.append((p.stream, idx, chunk, p))
                known = None
                digests: "list[bytes]" = []
                if work:
                    chunks = [c for _, _, c, _ in work]
                    with trace.span("ingest.sha", chunks=len(chunks)):
                        digests = ingest_ops.digest_chunks(
                            chunks, device=self.device)
                    backend = self._backend
                    if backend.capabilities.probe:
                        # one probe for every session's chunks
                        METRICS.add("probe_dispatches")
                        with trace.span("ingest.probe",
                                        chunks=len(digests)):
                            known = backend.probe_batch(digests)
                    if backend.capabilities.presketch:
                        METRICS.add("presketch_dispatches")
                        with trace.span("ingest.presketch",
                                        chunks=len(digests)):
                            backend.presketch_batch(digests, chunks,
                                                    known)
        except BaseException as e:
            # stage-level failure: the whole batch is poisoned -- every
            # depositor re-raises (their streams hold unfilled record
            # slots, so letting any of them continue would publish a
            # corrupt index)
            for p in parcels:
                if p.error is None:
                    p.error = e
            METRICS.add("failed_flushes")
            L.warning("fused ingest flush failed (%d parcels): %s",
                      len(parcels), e)
            return
        # per-chunk completion: fill record slots and insert, in deposit
        # order; an insert failure poisons only its own parcel
        for i, (stream, idx, chunk, parcel) in enumerate(work):
            if parcel.error is not None:
                continue
            try:
                end, _ = stream.records[idx]
                stream.records[idx] = (end, digests[i])
                stream._insert_probed(
                    digests[i], chunk,
                    known[i] if known is not None else None)
            except BaseException as e:
                parcel.error = e
        METRICS.add("chunks", len(work))

    def _scan_stage(self, scans: "list[_Parcel]") -> dict:
        """One fused CDC scan (one K1 launch) per distinct ChunkerParams
        across every scan parcel with a non-empty window;
        -> {id(parcel): ends}."""
        out: dict = {}
        groups: dict = {}
        for p in scans:
            if p.nbytes:
                groups.setdefault(p.stream.params, []).append(p)
        for params, group in groups.items():
            st = [p.stream for p in group]
            batch = ingest_ops.pack_rows(
                [p.blocks for p in group],
                [s._scan_tail for s in st],
                [s._hist for s in st],
                [s._scanned for s in st])
            METRICS.add("rows", len(group))
            METRICS.add("bytes_packed", int(batch.lens.sum()))
            METRICS.add("padding_bytes", batch.padding_bytes)
            with trace.span("ingest.cdc", bytes=int(batch.lens.sum()),
                            rows=len(group)):
                ends = ingest_ops.scan_rows(batch, params,
                                            device=self.device)
            for p, e in zip(group, ends):
                out[id(p)] = e
        return out


class FusedIngestStream(_ChunkedStream):
    """The sequential writer's fused twin: ``write`` only buffers; the
    CDC scan, cut selection, hashing, probing and sketching all happen
    inside the collector's fused flush.  Caller surface, records and
    stats are ``_ChunkedStream``'s; cuts and digests are bit-identical to
    the staged writer for any deposit cadence (prefix-stable greedy
    selection over the identical candidate stream)."""

    def __init__(self, store, params, collector: IngestCollector):
        # the collector owns scanning: no per-stream chunker is built
        super().__init__(store, params, _no_chunker_factory,
                         collector=collector)
        self.bound_backend = "fused"
        self._scan_tail = b""         # last W-1 bytes of the current run
        self._hist = 0                # run history, clamped to HALO
        self._scanned = 0             # stream offset of the scan frontier
        self._cand: "deque[int]" = deque()   # absolute candidate ends
        self._pending_scan: "list" = []      # unscanned blocks (by ref)
        self._scan_block = min(_FEED_COALESCE, params.max_size)

    # -- caller-thread surface --------------------------------------------
    def write(self, data) -> None:
        if not data:
            return
        self._buf.append(data)
        self._pending_scan.append(data)
        self.offset += len(data)
        self.stats.bytes_streamed += len(data)
        if self.offset - self._scanned >= self._scan_block:
            self._deposit(final=False)

    def _deposit(self, final: bool) -> None:
        blocks, self._pending_scan = self._pending_scan, []
        self._collector.submit(
            _Parcel(self, "scan", blocks=blocks, final=final))

    def flush_chunker(self) -> None:
        """Force a cut at the current offset (and resolve everything up
        to it -- the fused flush hashes and inserts in the same pass),
        then restart the scan run so cuts never span a splice seam."""
        if self._buf or self._pending_scan:
            self._deposit(final=True)
        assert self._buf_base == self.offset and not self._buf
        self._scan_tail = b""
        self._hist = 0
        self._cand.clear()

    def append_ref(self, digest: bytes, size: int) -> None:
        if self._buf or self._pending_scan:
            self.flush_chunker()
        self.offset += size
        self._buf_base = self.offset
        self._scanned = self.offset
        self._scan_tail = b""
        self._hist = 0
        self.records.append((self.offset, digest))
        self.stats.ref_chunks += 1
        self.stats.bytes_reffed += size
        self.store.touch(digest)

    def sync(self) -> None:
        if self._buf or self._pending_scan:
            self.flush_chunker()
        self._emit_stage_spans()

    def finish(self) -> "list[tuple[int, bytes]]":
        if self._buf or self._pending_scan:
            self.flush_chunker()
        self._emit_stage_spans()
        self._collector.deregister(self)
        return self.records

    # close() inherited: deregisters from the collector (abort paths)

    # -- flusher-side completion ------------------------------------------
    def _apply_scan(self, parcel: _Parcel,
                    ends: "np.ndarray | None") -> "list[tuple[int, object]]":
        """Fold one scanned window into this stream's state and slice
        the newly cut chunks.  Runs on the flusher thread while the
        owner is blocked in ``submit`` -- the only cross-thread access,
        ordered by the parcel's done handshake."""
        if parcel.nbytes:
            if ends is not None and len(ends):
                self._cand.extend(ends.tolist())
            self._scanned += parcel.nbytes
            self._hist = min(HALO, self._hist + parcel.nbytes)
            self._scan_tail = _tail_of(self._scan_tail, parcel.blocks)
        cuts = select_cuts(
            np.fromiter(self._cand, dtype=np.int64, count=len(self._cand)),
            self._scanned, self.params, start=self._buf_base,
            final=parcel.final)
        out = []
        for e in cuts:
            chunk = self._buf.take(e - self._buf_base)
            self._buf_base = e
            self.records.append((e, b""))
            out.append((len(self.records) - 1, chunk))
        while self._cand and self._cand[0] <= self._buf_base:
            self._cand.popleft()
        return out


def _no_chunker_factory(params):
    """FusedIngestStream's factory stand-in: scanning happens in the
    collector's fused flush, so the stream never owns a chunker."""
    return None


def _tail_of(prev_tail: bytes, blocks: "list") -> bytes:
    """Last W-1 bytes of ``prev_tail + join(blocks)`` without joining
    the whole window."""
    parts: "list[bytes]" = []
    need = HALO
    for b in reversed(blocks):
        if need <= 0:
            break
        bb = bytes(b[-need:]) if len(b) > need else bytes(b)
        parts.append(bb)
        need -= len(bb)
    if need > 0 and prev_tail:
        parts.append(prev_tail[-need:])
    parts.reverse()
    return b"".join(parts)


def _env_int(name: str, default: int) -> int:
    """An integer environment knob; an unset or unparsable value gives
    ``default`` (the JAX package's ``utils/conf.py`` reading)."""
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


_wrap_lock = threading.Lock()


def collector_for(store, *, device="cuda", batch_bytes: "int | None" = None,
                  batch_chunks: "int | None" = None,
                  max_wait: "float | None" = None) -> IngestCollector:
    """One collector -- one cross-session batching domain -- per store
    object, memoized on the store as ``_torch_ingest_collector`` (apart
    from the JAX package's ``_ingest_collector``).  Defaults come from
    the environment (``PBS_PLUS_INGEST_BATCH_BYTES``, 16 MiB, and
    ``PBS_PLUS_INGEST_MAX_WAIT_MS``, 25 ms).  A second call for the same
    store on another device raises ``ValueError``."""
    dev = resolve_indexed(device)
    with _wrap_lock:
        existing = getattr(store, "_torch_ingest_collector", None)
        if existing is not None:
            if existing.device != dev:
                raise ValueError(
                    f"the store's collector runs on {existing.device}, "
                    f"not {dev}")
            return existing
        coll = IngestCollector(
            store, device=dev,
            batch_bytes=(_env_int("PBS_PLUS_INGEST_BATCH_BYTES", 16 << 20)
                         if batch_bytes is None else batch_bytes),
            batch_chunks=batch_chunks or 4096,
            max_wait=(_env_int("PBS_PLUS_INGEST_MAX_WAIT_MS", 25) / 1000.0
                      if max_wait is None else max_wait))
        try:
            store._torch_ingest_collector = coll
        except AttributeError:
            L.warning(
                "collector_for: %s rejects attribute memoization; "
                "concurrent sessions will NOT share one batching domain",
                type(store).__name__)
        return coll
