"""Pipelined multi-worker chunk+fingerprint engine (the CPU data plane).

BENCH_r05 put the end-to-end chunk+fingerprint path at ~193 MiB/s on one
core while the raw buzhash scan alone reaches ~610 MiB/s multithreaded:
the sequential writer chunks, hashes, and inserts one chunk at a time,
so SHA-256 and store IO serialize behind the scan.  ``PipelinedStream``
splits the path into three overlapped stages (the stage-pipelining lever
of arXiv:2508.05797 / arXiv:2409.06066):

    scan    (caller thread)   CDC chunker feed + zero-copy chunk slicing
    hash    (N pool threads)  SHA-256 per chunk — hashlib releases the
                              GIL on large buffers, so N threads scale on
                              multi-core hosts; the ``batch_hasher`` hook
                              stays the TPU escape hatch (batched device
                              dispatch from the pool instead)
    insert  (committer)       ``store.insert`` + record/stat commit,
                              strictly in chunk-emission order

Hashes may complete out of order; each chunk's record slot is allocated
at emission time and the committer fills slots in order, so ``records``
(and the WriterStats new/known accounting, which a sequential dedup hit
pattern determines) are bit-identical to ``transfer._ChunkedStream`` for
ANY worker count — the parity gate ``tests/test_pipeline.py`` pins.

Store thread-safety: neither built-in store is safe for concurrent
calls (ChunkStore shares one zstd compressor context; PBSChunkSink
shares one HTTP connection), and a pipelined session has two calling
threads — this stream's committer, plus the writer thread inserting
meta chunks through its sequential sibling stream.  Every store call
therefore goes through a ``_LockedStore`` proxy; ``SessionWriter``
wraps the store ONCE so meta and payload streams share the same lock.
Contention is negligible: meta chunks are rare, and the lock is only
ever held for one insert/touch.

Backpressure: at most ``max_inflight`` chunks (default 2*workers+2) are
in flight, bounding peak extra memory by max_inflight * params.max_size.

Chunker backends: the scan stage inherits ``_ChunkedStream``'s
``bind_stream`` seam untouched, so a pipelined session picks up the
vectorized scan (chunker/vector.py) — or the sidecar, or the scalar
fallback — exactly like the sequential writer, pinned once at stream
open; ``bound_backend`` rides along for job stats.

A copy of the JAX package's ``pxar/pipeline.py``, its code byte for byte
apart from its imports, which name the port's own modules, its logger
(``logging``), and one change: ``PipelinedStream`` takes its
``chunker_factory`` from the caller, as the port's ``_ChunkedStream``
does, since the port has no CPU chunker to default to.
``SessionWriter(pipeline_workers>=1)`` builds it with the port's
``"cuda"`` factory and hasher; the proxy memo ``_locked_proxy`` is the
reference's, so writers of both packages over one store share one lock."""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

from ..chunker import ChunkerParams
from ..utils import failpoints, trace
from .transfer import (
    _HASH_BATCH_BYTES, _HASH_BATCH_COUNT, BatchHasher, ChunkerFactory,
    _ChunkedStream,
)

L = logging.getLogger(__name__)

_DONE = object()


class _LockedStore:
    """Serializes ``insert``/``touch`` across threads for stores that
    are not thread-safe (module docstring).  Everything else proxies
    through untouched."""

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()

    def insert(self, digest, data, *, verify: bool = True) -> bool:
        with self._lock:
            return self._store.insert(digest, data, verify=verify)

    def touch(self, digest) -> None:
        with self._lock:
            self._store.touch(digest)

    def __getattr__(self, name):
        return getattr(self._store, name)


_wrap_lock = threading.Lock()


def locked_store(store) -> _LockedStore:
    """Idempotent AND memoized: one proxy — therefore ONE lock — per
    underlying store object.  Memoization matters because the server
    runs concurrent jobs over the SAME shared ChunkStore (jobs.py
    max_concurrent > 1, backupproxy hands every session
    ``datastore.chunks``): per-writer locks would each "protect" the
    same non-thread-safe zstd context from a different lock."""
    if isinstance(store, _LockedStore):
        return store
    if getattr(store, "thread_safe", False):
        # sharded ChunkStore (pxar/datastore.py): per-shard locks +
        # per-shard compressors make every mutating path safe already —
        # wrapping would re-serialize all shards behind ONE lock and
        # undo exactly the contention win the sharding bought
        return store
    with _wrap_lock:
        proxy = getattr(store, "_locked_proxy", None)
        if proxy is None:
            proxy = _LockedStore(store)
            try:
                store._locked_proxy = proxy
            except AttributeError:
                # __slots__ store: per-call proxies means per-caller
                # LOCKS — cross-writer serialization is lost, so say so
                L.warning(
                    "locked_store: %s rejects attribute memoization; "
                    "concurrent writers will NOT share one lock",
                    type(store).__name__)
    return proxy


class PipelineMetrics:
    """Process-global pipeline observability (rendered by
    server/metrics.py): cumulative per-stage bytes/seconds/chunks plus
    live queue depths summed over active streams at snapshot time."""

    _STAGES = ("scan", "hash", "insert")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes = dict.fromkeys(self._STAGES, 0)
        self._seconds = dict.fromkeys(self._STAGES, 0.0)
        self._chunks = dict.fromkeys(self._STAGES, 0)
        self._streams: "weakref.WeakSet[PipelinedStream]" = weakref.WeakSet()

    def add(self, stage: str, nbytes: int, seconds: float,
            chunks: int = 0) -> None:
        with self._lock:
            self._bytes[stage] += nbytes
            self._seconds[stage] += seconds
            self._chunks[stage] += chunks

    def register(self, stream: "PipelinedStream") -> None:
        with self._lock:
            self._streams.add(stream)

    def snapshot(self) -> dict:
        with self._lock:
            live = [s for s in self._streams if not s._closed]
            stages = {}
            for s in self._STAGES:
                secs = self._seconds[s]
                stages[s] = {
                    "bytes": self._bytes[s],
                    "seconds": round(secs, 6),
                    "chunks": self._chunks[s],
                    "mib_s": round(self._bytes[s] / (1 << 20) / secs, 3)
                    if secs > 1e-9 else 0.0,
                }
            return {
                "stages": stages,
                "active_streams": len(live),
                "workers": sum(s.workers for s in live),
                "queues": {
                    "hash_inflight": sum(s._hash_inflight for s in live),
                    "commit_depth": sum(s._commit_q.qsize() for s in live),
                },
            }


METRICS = PipelineMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


class PipelinedStream(_ChunkedStream):
    """``_ChunkedStream`` with the hash and insert stages pipelined
    behind the CDC scan (module docstring).

    Subclasses the sequential writer so the entire caller surface —
    ``write``/``_emit``/``flush_chunker``/``append_ref`` buffer and
    offset bookkeeping — is SHARED, not copied; only chunk emission
    (hand-off to the pool instead of inline hash+insert) and ``finish``
    (drain + join) are overridden.  Extra surface: ``close()`` for
    abort paths (reaps the pool + committer; idempotent, also safe
    after ``finish``)."""

    def __init__(self, store, params: ChunkerParams,
                 chunker_factory: ChunkerFactory,
                 batch_hasher: BatchHasher | None = None,
                 workers: int = 2, max_inflight: int | None = None,
                 collector=None):
        super().__init__(locked_store(store), params, chunker_factory,
                         batch_hasher=batch_hasher, collector=collector)
        try:
            self._init_pipeline(workers, max_inflight)
        except BaseException:
            # the base __init__ registered us with the process-lifetime
            # collector; a half-built stream must not stay counted in
            # its all-deposited trigger (or strong-referenced) forever
            if collector is not None:
                collector.deregister(self)
            raise

    def _init_pipeline(self, workers: int,
                       max_inflight: "int | None") -> None:
        self.workers = max(1, int(workers))
        # chunk-count backpressure (per-chunk hash mode); batch mode
        # bounds whole batches instead — a >max_inflight batch of small
        # chunks must never deadlock against its own permits
        self._slots = threading.BoundedSemaphore(
            max_inflight or (2 * self.workers + 2))
        self._batch_slots = threading.BoundedSemaphore(2)
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="pipe-hash")
        self._commit_q: "queue.Queue" = queue.Queue()
        self._exc: BaseException | None = None
        self._hash_inflight = 0     # gauge only; racy int updates are fine
        self._closed = False
        self._finished = False
        self._finish_ok = False     # set only by a successful finish()
        # the stream opens under the job's trace context (start_session
        # runs trace-wrapped); pool workers and the committer attach it
        # so their stage spans parent under the job — the thread-pool
        # propagation seam (docs/observability.md).  Captured BEFORE the
        # committer starts: it reads this immediately.
        self._tctx = trace.capture()
        self._committer = threading.Thread(
            target=self._commit_loop, name="pipeline-commit", daemon=True)
        self._committer.start()
        METRICS.register(self)

    # -- caller-thread surface: inherited semantics + failure checks -------
    def _check_failed(self) -> None:
        if self._exc is not None:
            self.close()
            raise self._exc

    def write(self, data) -> None:
        self._check_failed()
        t0 = time.perf_counter()
        super().write(data)
        # scan = caller-thread time INCLUDING backpressure stalls: when
        # this gauge's MiB/s collapses while insert stays busy, the
        # store stage is the bottleneck
        METRICS.add("scan", len(data) if data else 0,
                    time.perf_counter() - t0)

    def flush_chunker(self) -> None:
        self._check_failed()
        super().flush_chunker()

    def append_ref(self, digest: bytes, size: int) -> None:
        self._check_failed()
        super().append_ref(digest, size)    # touch goes via _LockedStore

    def _emit_chunk(self, end: int) -> None:
        """Hand the finalized chunk to the pipeline instead of hashing
        and inserting inline."""
        n = end - self._buf_base
        chunk = self._buf.take(n)
        self._buf_base = end
        self.records.append((end, b""))      # slot filled by the committer
        idx = len(self.records) - 1
        if self._hasher is not None or self._collector is not None:
            # batch mode reuses the sequential writer's pending-batch
            # fields; whole batches dispatch to the pool at the same
            # thresholds, so the device feeder sees identical batches
            self._pending.append((idx, chunk))
            self._pending_bytes += n
            if (self._pending_bytes >= _HASH_BATCH_BYTES
                    or len(self._pending) >= _HASH_BATCH_COUNT):
                self._flush_batch()
            return
        self._slots.acquire()
        self._hash_inflight += 1
        fut = self._pool.submit(self._hash_one, chunk)
        self._commit_q.put(("chunk", idx, chunk, fut))

    def _hash_one(self, chunk) -> bytes:
        t0 = time.perf_counter()
        # worker-thread fault: surfaces through fut.result() in the
        # committer, which must drain queues and wake the caller
        failpoints.hit("pipeline.hash")
        d = hashlib.sha256(chunk).digest()
        dt = time.perf_counter() - t0
        METRICS.add("hash", len(chunk), dt, 1)
        if trace.enabled():
            # inherited stage accumulator (flushed as ONE aggregate span
            # at sync/finish); concurrent += from N workers may lose an
            # update — observability aggregate, like _hash_inflight
            self._sha_ns += int(dt * 1e9)
            self._sha_chunks += 1
        self._hash_inflight -= 1
        return d

    def _hash_batch(self, chunks: list, nbytes: int) -> list:
        t0 = time.perf_counter()
        # pool-thread span, attached to the stream's captured context:
        # batch hashing shows up per dispatch under the job trace
        with trace.attached(self._tctx), \
                trace.span("ingest.sha", chunks=len(chunks)):
            out = self._hasher(chunks)
        METRICS.add("hash", nbytes, time.perf_counter() - t0, len(chunks))
        self._hash_inflight -= len(chunks)
        return out

    def _flush_batch(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        nbytes, self._pending_bytes = self._pending_bytes, 0
        self._batch_slots.acquire()
        self._hash_inflight += len(batch)
        if self._collector is not None:
            # fused-ingest mode: the committer deposits the raw batch
            # with the cross-session collector (which runs sha + probe +
            # presketch fused over every concurrent session) — the pool
            # stays out of the hash path, but the caller thread still
            # overlaps its scan with the committer's blocking deposit
            self._commit_q.put(("cparcel", batch))
            return
        fut = self._pool.submit(self._hash_batch,
                                [c for _, c in batch], nbytes)
        self._commit_q.put(("batch", batch, fut))

    def _flush_hashes(self) -> None:
        # the sequential batch path (records filled inline) never runs
        # here — the committer owns record slots; finish() drains instead
        raise AssertionError("unused on the pipelined stream")

    def sync(self) -> None:
        """Checkpoint support (same contract as the sequential stream's
        ``sync``): cut at the current offset, dispatch pending batches,
        and BLOCK until the committer has inserted every in-flight chunk
        — ``records`` is then final and fully committed, and the stream
        stays writable.  The barrier rides the commit queue, so ordering
        with earlier chunks is structural, not timed."""
        self._check_failed()
        if self._closed:
            return               # committer gone; records already final
        if self._buf:
            self.flush_chunker()
        if self._hasher is not None or self._collector is not None:
            self._flush_batch()
        done = threading.Event()
        self._commit_q.put(("drain", done))
        done.wait()
        self._check_failed()
        self._emit_stage_spans()

    def finish(self) -> list[tuple[int, bytes]]:
        if self._finished:
            # finish() after close()/failure must never hand back
            # records with un-committed b"" digest slots — a caller
            # would silently build a corrupt index from them
            if self._exc is not None:
                raise self._exc
            if not self._finish_ok:
                raise RuntimeError(
                    "finish() after close(): stream was aborted")
            return self.records
        if self._buf:
            self.flush_chunker()
        if self._exc is None and (self._hasher is not None
                                  or self._collector is not None):
            self._flush_batch()
        self._shutdown()
        if self._exc is not None:
            raise self._exc
        self._finish_ok = True
        self._emit_stage_spans()
        return self.records

    def close(self) -> None:
        """Reap the pool + committer (abort paths); idempotent."""
        self._shutdown()

    def _shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finished = True
        self._commit_q.put(_DONE)
        self._committer.join()
        self._pool.shutdown(wait=True)
        if self._collector is not None:
            self._collector.deregister(self)

    # -- committer thread --------------------------------------------------
    def _commit_loop(self) -> None:
        # committer-side batched probe/presketch spans parent under the
        # stream's job trace (the second thread seam of this stream)
        with trace.attached(self._tctx):
            self._commit_loop_body()

    def _commit_loop_body(self) -> None:
        try:
            while True:
                slot = self._commit_q.get()
                if slot is _DONE:
                    return
                if slot[0] == "drain":
                    slot[1].set()        # sync() barrier: all prior
                    continue             # queue items are committed
                if slot[0] == "chunk":
                    _, idx, chunk, fut = slot
                    try:
                        self._commit(idx, fut.result(), chunk)
                    finally:
                        self._slots.release()
                elif slot[0] == "cparcel":
                    _, batch = slot
                    try:
                        # blocking cross-session deposit: the collector
                        # fills this stream's record slots and runs the
                        # inserts before returning (deadline-bounded)
                        self._collector.ingest_chunks(self, batch)
                        self._hash_inflight -= len(batch)
                    finally:
                        self._batch_slots.release()
                else:
                    _, batch, fut = slot
                    try:
                        digests = fut.result()
                        # one dedup-index probe per hash batch — the
                        # same batched entry point the sequential
                        # writer's _flush_hashes uses, so new/known
                        # accounting stays bit-identical
                        known = self._probe_known(digests)
                        # one batched sketch pass per hash batch too
                        # (similarity tier): identical batches to the
                        # sequential writer's _flush_hashes
                        self._presketch(digests,
                                        [c for _, c in batch], known)
                        for i, ((idx, chunk), digest) in enumerate(
                                zip(batch, digests)):
                            self._commit(idx, digest, chunk,
                                         known[i] if known is not None
                                         else None)
                    finally:
                        self._batch_slots.release()
        except BaseException as e:
            self._exc = e
            # drain until the finish()/close() sentinel so a caller
            # blocked on backpressure permits OR a sync() barrier always
            # wakes up (sync re-raises via _check_failed after waking)
            while True:
                slot = self._commit_q.get()
                if slot is _DONE:
                    return
                if slot[0] == "drain":
                    slot[1].set()
                elif slot[0] == "chunk":
                    self._slots.release()
                else:            # "batch" and "cparcel" share the permit
                    self._batch_slots.release()

    def _commit(self, idx: int, digest: bytes, chunk,
                known: "bool | None" = None) -> None:
        end, _ = self.records[idx]
        self.records[idx] = (end, digest)
        t0 = time.perf_counter()
        # inherited new/known counting; `known` is the batched-probe
        # hint (None on the per-chunk path — insert probes the index
        # itself, still disk-free for negatives)
        self._insert_probed(digest, chunk, known)
        METRICS.add("insert", len(chunk), time.perf_counter() - t0, 1)
