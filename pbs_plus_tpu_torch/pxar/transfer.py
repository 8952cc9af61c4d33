"""The chunked stream writer: CDC cuts, digests and store inserts.

A copy of the stream half of the JAX package's ``pxar/transfer.py``:
``WriterStats``, ``_ChunkBuffer``, ``_ChunkedStream`` and the hash-batch
ceilings.  Its ``SessionWriter``, ``DedupWriter`` and ``SplitReader`` are
not copied; they need the pxar formats and the datastore, which a JAX
writer brings.  Two differences:

- ``chunker_factory`` has no default: the reference's default is its CPU
  chunker, which the port has no copy of.  A caller passes the port's
  ``models.backends.make_chunker_factory("cuda", device=...)``, with the
  ``"cuda"`` batch hasher beside it, which makes this the staged writer
  the fused stream (``ingestbatch.py``) is held against.
- The store is anything with the ``ChunkStore`` surface (``insert``,
  ``touch``, ``note_dedup_hit`` and, where it declares them, the batched
  stages of ``ingestbackend.py``); a JAX ``ChunkStore`` serves.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..chunker.spec import ChunkerParams
from ..utils import trace
from .ingestbackend import resolve_ingest_backend

ChunkerFactory = Callable[[ChunkerParams], object]
BatchHasher = Callable[[list[bytes]], list[bytes]]

# pending-hash ceiling: chunk copies held for the next batched sha256
# dispatch.  16 MiB saturates the device hash kernel while keeping the
# writer's peak memory ~2x this bound regardless of stream size
_HASH_BATCH_BYTES = 16 << 20
_HASH_BATCH_COUNT = 512


@dataclass
class WriterStats:
    new_chunks: int = 0
    known_chunks: int = 0          # CDC-produced but already in store
    ref_chunks: int = 0            # reused by reference without IO
    bytes_streamed: int = 0        # bytes that went through the chunker
    bytes_reffed: int = 0          # bytes covered by reused chunks
    bytes_reencoded: int = 0       # ref boundary bytes that were re-read
    size_mismatch_files: int = 0   # streams shorter/longer than stat size

    def merge(self, other: "WriterStats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))


class _ChunkBuffer:
    """Rotating segment buffer for the chunk-emission hot path.

    ``append`` retains incoming blocks whole (no copy); ``take(n)``
    yields the next ``n`` bytes -- a zero-copy memoryview when the chunk
    lies inside one block, a single joined bytes object only when it
    spans a block seam.  Appended blocks are retained by reference:
    callers must not mutate them afterwards."""

    __slots__ = ("_segs", "_head", "size")

    def __init__(self) -> None:
        self._segs: "deque" = deque()   # retained bytes blocks
        self._head = 0                  # consumed bytes of _segs[0]
        self.size = 0

    def __bool__(self) -> bool:
        return self.size > 0

    def __len__(self) -> int:
        return self.size

    def append(self, data) -> None:
        if len(data):
            self._segs.append(data)
            self.size += len(data)

    def take(self, n: int):
        """First n bytes, consumed.  memoryview (zero-copy) or bytes."""
        if n <= 0:
            return b""
        if n > self.size:
            raise ValueError(f"take({n}) exceeds buffered {self.size}")
        first = self._segs[0]
        avail = len(first) - self._head
        if n < avail:
            out = memoryview(first)[self._head:self._head + n]
            self._head += n
            self.size -= n
            return out
        if n == avail:
            out = memoryview(first)[self._head:] if self._head else first
            self._segs.popleft()
            self._head = 0
            self.size -= n
            return out
        parts = []
        remaining = n
        while remaining:
            first = self._segs[0]
            avail = len(first) - self._head
            step = min(avail, remaining)
            parts.append(memoryview(first)[self._head:self._head + step])
            if step == avail:
                self._segs.popleft()
                self._head = 0
            else:
                self._head += step
            remaining -= step
        self.size -= n
        return b"".join(parts)


class _ChunkedStream:
    """CDC-chunked stream writer over a chunk store: ``write`` feeds the
    chunker, ``append_ref`` splices an existing chunk, ``finish`` returns
    the index records ``(end_offset, digest)``.

    ``batch_hasher`` defers digests so many chunks hash in one device
    dispatch; None = per-chunk hashlib.  ``collector``
    (``ingestbatch.IngestCollector``) takes whole hash batches for its
    cross-session fused pass instead."""

    def __init__(self, store, params: ChunkerParams,
                 chunker_factory: ChunkerFactory,
                 batch_hasher: BatchHasher | None = None,
                 collector=None):
        self.store = store
        self.params = params
        # the store's declared batched-ingest surface, resolved once at
        # stream open (ingestbackend.py)
        self._ingest = resolve_ingest_backend(store)
        self._collector = collector
        # a factory exposing bind_stream() pins its backend decision once
        # per stream, never at the flush_chunker/append_ref restarts
        bind = getattr(chunker_factory, "bind_stream", None)
        if bind is not None:
            chunker_factory = bind(params)
        self._factory = chunker_factory
        self._chunker = chunker_factory(params)
        # the backend pinned for this stream's life (observability)
        self.bound_backend = getattr(self._chunker, "backend_name",
                                     type(self._chunker).__name__.lower())
        self._buf = _ChunkBuffer()
        self._buf_base = 0          # stream offset of _buf[0]
        self._run_base = 0          # stream offset where current chunker run began
        self.offset = 0             # total stream bytes accepted
        self.records: list[tuple[int, bytes]] = []   # (end_offset, digest)
        self.stats = WriterStats()
        self._hasher = batch_hasher
        self._pending: list[tuple[int, bytes]] = []  # (record idx, chunk)
        self._pending_bytes = 0
        # per-stream ingest-stage accumulators (ns): the per-chunk hot
        # path pays two perf_counter_ns calls, and sync()/finish() emit
        # one aggregate span per stage
        self._cdc_ns = 0
        self._cdc_bytes = 0
        self._sha_ns = 0
        self._sha_chunks = 0
        # register last: a fallible factory bind above must not leak a
        # half-built stream into the collector's all-deposited trigger
        # (deregistered at finish/close)
        if collector is not None:
            collector.register(self)

    def write(self, data: bytes) -> None:
        if not data:
            return
        self._buf.append(data)
        self.offset += len(data)
        self.stats.bytes_streamed += len(data)
        if trace.enabled():
            t0 = time.perf_counter_ns()
            cuts = self._chunker.feed(data)
            self._cdc_ns += time.perf_counter_ns() - t0
            self._cdc_bytes += len(data)
        else:
            cuts = self._chunker.feed(data)
        self._emit(cuts)

    def _emit(self, run_relative_cuts: list[int]) -> None:
        for rc in run_relative_cuts:
            end = self._run_base + rc
            self._emit_chunk(end)

    def _emit_chunk(self, end: int) -> None:
        start = self._buf_base
        n = end - start
        chunk = self._buf.take(n)      # memoryview when seam-free
        self._buf_base = end
        if self._hasher is None and self._collector is None:
            if trace.enabled():
                t0 = time.perf_counter_ns()
                digest = hashlib.sha256(chunk).digest()
                self._sha_ns += time.perf_counter_ns() - t0
                self._sha_chunks += 1
            else:
                digest = hashlib.sha256(chunk).digest()
            self._insert(digest, chunk)
            self.records.append((end, digest))
        else:
            self.records.append((end, b""))
            self._pending.append((len(self.records) - 1, chunk))
            self._pending_bytes += len(chunk)
            if (self._pending_bytes >= _HASH_BATCH_BYTES
                    or len(self._pending) >= _HASH_BATCH_COUNT):
                self._flush_hashes()

    def _insert(self, digest: bytes, chunk: bytes) -> None:
        if self.store.insert(digest, chunk, verify=False):
            self.stats.new_chunks += 1
        else:
            self.stats.known_chunks += 1

    def _probe_known(self, digests: "list[bytes]") -> "list[bool] | None":
        """One batched dedup-index probe for a whole digest batch; None
        when the store declares no probe capability -- callers then
        insert per digest (the index-less fallback)."""
        backend = self._ingest
        if not backend.capabilities.probe:
            return None
        with trace.span("ingest.probe", chunks=len(digests)):
            return backend.probe_batch(digests)

    def _insert_probed(self, digest: bytes, chunk: bytes,
                       known: "bool | None") -> None:
        """Insert with a batched-probe hint: a probed-present digest
        takes the dedup-hit tail (GC-mark touch) without re-probing
        membership; ``note_dedup_hit`` returning False (file vanished
        under a stale index) falls back to the authoritative insert with
        the bytes still in hand."""
        if known and self.store.note_dedup_hit(digest):
            self.stats.known_chunks += 1
        else:
            self._insert(digest, chunk)

    def _presketch(self, digests: "list[bytes]", chunks: "list",
                   known: "list[bool] | None") -> None:
        """Similarity-tier batch hook: one batched sketch computation
        for the hash batch's novel chunks, right after the exact-index
        probe."""
        backend = self._ingest
        if backend.capabilities.presketch:
            with trace.span("ingest.presketch", chunks=len(digests)):
                backend.presketch_batch(digests, chunks, known)

    def _flush_hashes(self) -> None:
        if not self._pending:
            return
        if self._collector is not None:
            # cross-session fused path: the whole pending batch deposits
            # with the collector, which runs sha -> probe -> presketch
            # over every concurrent session's chunks in one pass and
            # completes this stream's records/inserts before returning
            batch, self._pending = self._pending, []
            self._pending_bytes = 0
            self._collector.ingest_chunks(self, batch)
            return
        assert self._hasher is not None
        with trace.span("ingest.sha", chunks=len(self._pending)):
            digests = self._hasher([c for _, c in self._pending])
        known = self._probe_known(digests)
        self._presketch(digests, [c for _, c in self._pending], known)
        for i, ((idx, chunk), digest) in enumerate(zip(self._pending,
                                                       digests)):
            end, _ = self.records[idx]
            self.records[idx] = (end, digest)
            self._insert_probed(digest, chunk,
                                known[i] if known is not None else None)
        self._pending.clear()
        self._pending_bytes = 0

    def flush_chunker(self) -> None:
        """Force a cut at the current offset and restart the chunker."""
        cuts = self._chunker.finalize()
        self._emit(cuts)
        assert self._buf_base == self.offset and not self._buf
        self._chunker = self._factory(self.params)
        self._run_base = self.offset

    def append_ref(self, digest: bytes, size: int) -> None:
        """Splice an existing store chunk at the current offset (no IO)."""
        if self._buf:
            self.flush_chunker()
        self.offset += size
        self._buf_base = self.offset
        # restart the chunker after the spliced region: its window never
        # spans a splice seam, keeping cuts deterministic per segment run
        self._chunker = self._factory(self.params)
        self._run_base = self.offset
        self.records.append((self.offset, digest))
        self.stats.ref_chunks += 1
        self.stats.bytes_reffed += size
        self.store.touch(digest)

    def _emit_stage_spans(self) -> None:
        """Flush the per-chunk stage accumulators as one aggregate span
        each, covering only what was measured since the last emit."""
        if self._cdc_ns:
            trace.emit("ingest.cdc", self._cdc_ns / 1e9,
                       bytes=self._cdc_bytes, aggregated=True)
            self._cdc_ns = 0
            self._cdc_bytes = 0
        if self._sha_ns:
            trace.emit("ingest.sha", self._sha_ns / 1e9,
                       chunks=self._sha_chunks, aggregated=True)
            self._sha_ns = 0
            self._sha_chunks = 0

    def finish(self) -> list[tuple[int, bytes]]:
        if self._buf:
            self.flush_chunker()
        self._flush_hashes()
        self._emit_stage_spans()
        if self._collector is not None:
            self._collector.deregister(self)
        return self.records

    def sync(self) -> None:
        """Checkpoint support: force a cut at the current offset and
        resolve every pending digest, so ``records`` is final and every
        chunk it names is committed to the store -- without finishing;
        the stream stays writable."""
        if self._buf:
            self.flush_chunker()
        self._flush_hashes()
        self._emit_stage_spans()

    def close(self) -> None:
        """Abort-path release: stop counting this stream toward the
        collector's all-deposited trigger (idempotent; no-op without a
        collector, safe after ``finish``)."""
        if self._collector is not None:
            self._collector.deregister(self)
