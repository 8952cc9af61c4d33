"""Split-archive writers and readers with dedup.

A copy of the JAX package's ``pxar/transfer.py``: the chunked stream
writer (``WriterStats``, ``_ChunkBuffer``, ``_ChunkedStream``, the
hash-batch ceilings), the archive writers (``SessionWriter``,
``DedupWriter``), the reader (``SplitReader``, ``_RangeIO``,
``_StreamIO``) and ``write_manifest``.  The writers' code is byte for
byte the reference's apart from the imports, which name the port's own
modules (its datastore, formats, chunk cache, pipelined and fused
streams), the logger (``logging``), and these differences:

- ``chunker_factory`` has no default: the reference's default is its CPU
  chunker, which the port has no copy of.  A caller passes the port's
  ``models.backends.make_chunker_factory("cuda", device=...)``, with the
  ``"cuda"`` batch hasher beside it (``backupproxy.LocalStore`` does);
  ``_ChunkedStream`` so built is the staged writer the fused stream
  (``ingestbatch.py``) is held against.  A fused sequential writer
  therefore always logs that the collector's scan overrides the
  session's factory.
- The store is anything with the ``ChunkStore`` surface (``insert``,
  ``touch``, ``note_dedup_hit`` and, where it declares them, the batched
  stages of ``ingestbackend.py``); a JAX ``ChunkStore`` serves, and a
  ``SplitReader`` reads either package's ``Datastore``.
"""

from __future__ import annotations

import hashlib
import io
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator

from ..chunker import spec as _spec
from ..chunker.spec import ChunkerParams
from ..utils import atomicio, trace
from .datastore import ChunkStore, Datastore, DynamicIndex, SnapshotRef
from .format import Entry, KIND_DIR, KIND_FILE, decode_entries
from .ingestbackend import resolve_ingest_backend
from .pxarv2 import (
    PAYLOAD_HDR_SIZE, Pxar2Encoder, decode_pxar2, payload_header,
    payload_start_marker, sniff_is_pxar2,
)

L = logging.getLogger(__name__)

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


class SessionWriter:
    """Builds a tpxar split archive: entries in sorted-path order, file
    contents streamed into the payload stream.  The test/golden-archive
    writer (reference: transfer.NewSessionWriter,
    internal/pxarmount/commit_walk_test.go:21-120)."""

    def __init__(self, store: ChunkStore, *,
                 payload_params: ChunkerParams,
                 meta_params: ChunkerParams | None = None,
                 chunker_factory: ChunkerFactory,
                 batch_hasher: BatchHasher | None = None,
                 entry_codec: str = "tpxar",
                 pipeline_workers: int = 0,
                 ingest_collector=None):
        """``entry_codec='pxar2'`` writes stock pxar v2 binary items in
        the meta stream (with per-file payload headers + start marker in
        the payload stream) so stock PBS tools can decode the archive;
        'tpxar' (default) keeps the native msgpack entries (`pxarv2.py`
        module docstring; entry encoding was the last stock-PBS format
        gap).

        ``pipeline_workers >= 1`` runs the payload stream through
        ``pipeline.PipelinedStream`` (scan ∥ hash ∥ insert with N hash
        workers); 0 (default) keeps the sequential writer.  Cut/digest
        output is bit-identical either way (tests/test_pipeline.py).

        ``ingest_collector`` (pxar/ingestbatch.py) routes the payload
        stream's batched stages through the cross-session fused ingest
        op: the sequential writer becomes a ``FusedIngestStream`` (CDC
        scan included in the fused batch), a pipelined writer's batch
        committer deposits its hash batches there.  Cuts/digests stay
        bit-identical (tests/test_ingest_fused.py)."""
        if entry_codec not in ("tpxar", "pxar2"):
            raise ValueError(f"unknown entry codec {entry_codec!r}")
        if (pipeline_workers and pipeline_workers > 0) \
                or ingest_collector is not None:
            # the payload committer / collector-flusher thread and this
            # (writer) thread both call store.insert once the meta
            # stream cuts a chunk, and neither built-in store is
            # thread-safe — share ONE locked proxy across both streams
            # (pipeline.py module docstring)
            from .pipeline import locked_store
            store = locked_store(store)
        self.store = store
        self.payload_params = payload_params
        self.meta_params = meta_params or ChunkerParams(
            avg_size=max(1024, min(payload_params.avg_size, 128 << 10)))
        # meta stays sequential: entries are tiny and arrive interleaved
        # with payload writes on the same caller thread
        self.meta = _ChunkedStream(store, self.meta_params, chunker_factory)
        if pipeline_workers and pipeline_workers > 0:
            from .pipeline import PipelinedStream
            self.payload = PipelinedStream(
                store, payload_params, chunker_factory,
                batch_hasher=batch_hasher, workers=pipeline_workers,
                collector=ingest_collector)
        elif ingest_collector is not None:
            from .ingestbatch import FusedIngestStream
            # the collector's packed scan is the one scan backend for
            # fused sequential streams; the session's factory (always
            # given: the port has no default to compare with) is
            # overridden (cuts stay bit-identical, but say so)
            L.info("fused ingest: session chunker factory %s "
                   "overridden by the collector's packed scan",
                   getattr(chunker_factory, "__name__",
                           type(chunker_factory).__name__))
            self.payload = FusedIngestStream(
                store, payload_params, ingest_collector)
        else:
            self.payload = _ChunkedStream(
                store, payload_params, chunker_factory,
                batch_hasher=batch_hasher)
        self.entry_codec = entry_codec
        self._codec: Pxar2Encoder | None = None
        if entry_codec == "pxar2":
            self._codec = Pxar2Encoder(self.meta.write)
        # pxar2 payload streams open with a 16-byte start marker; it is
        # written lazily so a whole-stream splice from a previous pxar2
        # archive can carry the previous marker and stay chunk-aligned
        self._payload_started = entry_codec != "pxar2"
        self._last_path: str | None = None
        self._entries = 0
        self._finished = False
        # per-file divergence reports (size mismatches etc.) for the
        # caller's session stats / task log
        self.file_errors: list[str] = []
        # called (with this writer) after every completed entry — the
        # durable-checkpoint hook (server/checkpoint.py Checkpointer);
        # runs on the writer thread, may call sync_streams()
        self.checkpoint_hook: Callable[["SessionWriter"], None] | None = None

    # -- entry emission ---------------------------------------------------
    @staticmethod
    def _path_key(path: str) -> tuple[str, ...]:
        # DFS order: compare path *components*, so a directory's subtree is
        # contiguous ("foo/bar" sorts before sibling file "foo.txt")
        return tuple(path.split("/")) if path else ()

    def _check_order(self, entry: Entry) -> None:
        if self._last_path is not None and \
                self._path_key(entry.path) <= self._path_key(self._last_path):
            raise ValueError(
                f"entries must be in strict DFS path order: "
                f"{entry.path!r} after {self._last_path!r}")
        self._last_path = entry.path

    def _emit_meta(self, entry: Entry,
                   payload_ref: tuple[int, int] | None = None) -> None:
        """Append one entry to the meta stream in the session's codec.
        ``payload_ref=(payload_item_header_offset, content_size)`` for
        non-empty files in pxar2 mode."""
        if self._codec is not None:
            self._codec.entry(entry, payload_ref)
        else:
            self.meta.write(entry.encode())

    def _notify_entry(self) -> None:
        """One entry is fully written — give the checkpoint hook a shot.
        Called from the public entry points only (never from inside
        ``_flush_refs``'s own emission loop, whose pending state must
        not be re-entered)."""
        hook = self.checkpoint_hook
        if hook is not None:
            hook(self)

    def sync_streams(self) -> None:
        """Force both streams to a fully-committed cut (chunker flushed,
        pending digests resolved, pipelined commits drained) without
        finishing — the checkpoint primitive.  Only valid between
        entries."""
        self.meta.sync()
        self.payload.sync()

    def write_entry(self, entry: Entry) -> None:
        """Metadata-only entry (dir, symlink, empty file, special)."""
        self._check_order(entry)
        if entry.kind == KIND_FILE and entry.size:
            raise ValueError("file with content must use write_entry_reader")
        if self._codec is not None and entry.kind == KIND_FILE:
            # pxar2: even an empty file owns a real zero-length PAYLOAD
            # item so its ref validates under a stock accessor
            self._write_file_pxar2(entry, io.BytesIO(b""), 1 << 16)
            self._notify_entry()
            return
        self._emit_meta(entry)
        self._entries += 1
        self._notify_entry()

    def write_entry_reader(self, entry: Entry, reader: io.RawIOBase | io.BufferedIOBase,
                           *, bufsize: int = 4 << 20) -> bytes:
        """File entry with content streamed from ``reader``.  Returns the
        whole-file sha256 (also stored in the entry for verification).

        pxar2: the payload item header carries the content length and
        must precede the bytes, so the declared ``entry.size`` is
        authoritative (short streams are zero-padded, long ones
        truncated — the stat-size discipline of the stock client); a
        stream of unknown size (entry.size == 0 but bytes arrive, e.g.
        the S3/tape ingest pumps) is spooled once to learn it."""
        self._check_order(entry)
        if self._codec is not None:
            digest = self._write_file_pxar2(entry, reader, bufsize)
            self._notify_entry()
            return digest
        entry.payload_offset = self.payload.offset
        h = hashlib.sha256()
        total = 0
        while True:
            block = reader.read(bufsize)
            if not block:
                break
            h.update(block)
            self.payload.write(block)
            total += len(block)
        entry.size = total
        entry.digest = h.digest()
        self._emit_meta(entry)
        self._entries += 1
        self._notify_entry()
        return entry.digest

    def _ensure_payload_started(self) -> None:
        if not self._payload_started:
            self._payload_started = True
            self.payload.write(payload_start_marker())

    def _write_file_pxar2(self, entry: Entry, reader, bufsize: int) -> bytes:
        self._ensure_payload_started()
        declared = entry.size
        if declared <= 0:
            first = reader.read(bufsize)
            if first:
                import tempfile
                spool = tempfile.SpooledTemporaryFile(max_size=64 << 20)
                spool.write(first)
                while True:
                    block = reader.read(bufsize)
                    if not block:
                        break
                    spool.write(block)
                declared = spool.tell()
                spool.seek(0)
                reader = spool
            else:
                declared = 0
        hdr_off = self.payload.offset
        h = hashlib.sha256()
        # A zero-length file still gets a real PAYLOAD item so the ref
        # points at a validatable header, matching the stock encoder
        # (REF(0,0) aimed at the start marker instead).
        self.payload.write(payload_header(declared))
        short = False
        remaining = declared
        while remaining > 0:
            block = reader.read(min(bufsize, remaining))
            if not block:
                short = True
                block = b"\0" * min(bufsize, remaining)
            block = block[:remaining]
            h.update(block)
            self.payload.write(block)
            remaining -= len(block)
        long_tail = False
        if not short:
            # long-stream probe: one extra byte tells a grown file from a
            # stat-sized one.  A reader that has already delivered every
            # declared byte may legitimately raise here (e.g. a
            # _QueuePumpReader whose producer errored after the payload
            # sentinel) — the file content is complete, so treat probe
            # failures as a divergence report, not a write failure
            #.
            try:
                long_tail = bool(reader.read(1))
            except Exception as e:
                self.payload.stats.size_mismatch_files += 1
                self.file_errors.append(
                    f"{entry.path}: stream probe past declared size "
                    f"{declared} failed: {e}")
                L.warning("pxar2 probe divergence: %s", self.file_errors[-1])
        if short or long_tail:
            # file changed size mid-backup: the declared stat size stays
            # authoritative for the archive, but the divergence must be
            # visible — warn and count it as the stock client does
            self.payload.stats.size_mismatch_files += 1
            self.file_errors.append(
                f"{entry.path}: stream {'shorter' if short else 'longer'} "
                f"than declared size {declared} (content "
                f"{'zero-padded' if short else 'truncated'})")
            L.warning("pxar2 size mismatch: %s", self.file_errors[-1])
        entry.size = declared
        entry.payload_offset = hdr_off + PAYLOAD_HDR_SIZE
        entry.digest = h.digest()
        self._emit_meta(entry, (hdr_off, declared))
        self._entries += 1
        return entry.digest

    def write_entry_bytes(self, entry: Entry, data: bytes) -> bytes:
        return self.write_entry_reader(entry, io.BytesIO(data))

    # dir markers for reference-API parity; flat sorted entries carry full
    # paths so these only validate nesting
    def begin_directory(self, entry: Entry) -> None:
        if entry.kind != KIND_DIR:
            raise ValueError("begin_directory needs a dir entry")
        self.write_entry(entry)

    def end_directory(self) -> None:
        pass

    # -- finish -----------------------------------------------------------
    def finish(self) -> tuple[DynamicIndex, DynamicIndex, WriterStats]:
        if self._finished:
            raise RuntimeError("writer already finished")
        self._finished = True
        try:
            if self._codec is not None:
                self._codec.finish()        # close open dirs, goodbye tables
                self._ensure_payload_started()  # valid (if empty) v2 stream
            now_ns = time.time_ns()
            midx = DynamicIndex.from_records(self.meta.finish(),
                                             ctime_ns=now_ns)
            pidx = DynamicIndex.from_records(self.payload.finish(),
                                             ctime_ns=now_ns)
        except BaseException:
            # a meta-stream failure must still reap the payload
            # pipeline's pool + committer (no-op for sequential streams)
            self.close()
            raise
        stats = WriterStats()
        stats.merge(self.meta.stats)
        stats.merge(self.payload.stats)
        return midx, pidx, stats

    def close(self) -> None:
        """Release stream resources without finishing (abort paths).
        No-op for sequential streams; a PipelinedStream parks a worker
        pool + committer thread that must not outlive a failed job."""
        for s in (self.meta, self.payload):
            closer = getattr(s, "close", None)
            if closer is not None:
                closer()

    @property
    def entry_count(self) -> int:
        return self._entries


class DedupWriter(SessionWriter):
    """SessionWriter + incremental reuse against a previous snapshot
    (reference: transfer.NewRemoteDedupWriter with PreviousBackupRef,
    internal/pxarmount/commit_orchestrate.go:177-200)."""

    def __init__(self, store: ChunkStore, *, previous: "SplitReader | None",
                 payload_params: ChunkerParams,
                 meta_params: ChunkerParams | None = None,
                 chunker_factory: ChunkerFactory,
                 batch_hasher: BatchHasher | None = None,
                 entry_codec: str = "tpxar",
                 pipeline_workers: int = 0,
                 ingest_collector=None):
        super().__init__(store, payload_params=payload_params,
                         meta_params=meta_params,
                         chunker_factory=chunker_factory,
                         batch_hasher=batch_hasher,
                         entry_codec=entry_codec,
                         pipeline_workers=pipeline_workers,
                         ingest_collector=ingest_collector)
        self.previous = previous
        # pending coalesced old-payload range [A, B) and the new-stream
        # offset N0 where it will land
        self._pend_a = self._pend_b = -1
        self._pend_entries: list[tuple[Entry, int]] = []  # (entry, old offset)

    def write_entry_ref(self, entry: Entry, old_payload_offset: int,
                        size: int) -> None:
        """Reference an unchanged file's content range in the previous
        archive's payload stream (``old_payload_offset`` = content
        start, the decoded Entry convention).  In-order contiguous refs
        coalesce; any other pattern flushes and re-encodes only boundary
        bytes.

        pxar2 target: when the previous archive is also pxar2, the
        stored 16-byte payload item header rides along in the spliced
        range (consecutive files stay contiguous, so runs still
        coalesce).  When the previous archive is tpxar (no headers in
        its stream), the header is synthesized and the ref flushes
        alone — a one-time coalescing loss on a codec switch."""
        if self.previous is None:
            raise RuntimeError("write_entry_ref without previous snapshot")
        self._check_order(entry)
        v2_prev = self.previous.codec == "pxar2"
        if size and self._codec is not None and not v2_prev:
            # codec switch: synthesize the payload header, splice alone
            self._flush_refs()
            self._ensure_payload_started()
            self.payload.write(payload_header(size))
            a, b = old_payload_offset, old_payload_offset + size
            if b > self.previous.payload_index.total_size or a < 0:
                raise ValueError("ref range outside previous payload stream")
            self._pend_a, self._pend_b = a, b
            entry.size = size
            self._pend_entries.append((entry, a))
            self._entries += 1
            self._flush_refs()
            self._notify_entry()
            return
        if size and self._codec is not None and v2_prev:
            a = old_payload_offset - PAYLOAD_HDR_SIZE   # include stored hdr
            if not self._payload_started and a == PAYLOAD_HDR_SIZE \
                    and self._pend_a < 0:
                # stream-opening splice: carry the previous archive's
                # start marker so the run begins chunk-aligned at 0
                a = 0
                self._payload_started = True
            else:
                self._ensure_payload_started()
        else:
            a = old_payload_offset
        b = old_payload_offset + size
        if b > self.previous.payload_index.total_size or a < 0:
            raise ValueError("ref range outside previous payload stream")
        if self._pend_b == a and self._pend_a >= 0:
            self._pend_b = b                      # coalesce contiguous run
        else:
            self._flush_refs()
            self._pend_a, self._pend_b = a, b
        entry.size = size
        self._pend_entries.append((entry, old_payload_offset))
        self._entries += 1
        self._notify_entry()

    def sync_streams(self) -> None:
        # pending coalesced refs must land before the streams are cut —
        # a checkpoint taken mid-run would otherwise miss them
        self._flush_refs()
        super().sync_streams()

    def write_entry(self, entry: Entry) -> None:
        self._flush_refs()
        super().write_entry(entry)

    def write_entry_reader(self, entry: Entry, reader, *, bufsize: int = 4 << 20) -> bytes:
        self._flush_refs()
        return super().write_entry_reader(entry, reader, bufsize=bufsize)

    def _flush_refs(self) -> None:
        if self._pend_a < 0:
            return
        a, b = self._pend_a, self._pend_b
        prev = self.previous
        assert prev is not None
        pidx = prev.payload_index
        # force a chunk boundary before splicing
        if self.payload._buf:
            self.payload.flush_chunker()
        n0 = self.payload.offset
        pos = a
        for ci in pidx.chunks_overlapping(a, b):
            cs, ce = pidx.chunk_bounds(ci)
            if cs >= a and ce <= b:
                # whole chunk inside the range → splice without IO
                if pos < cs:
                    raise AssertionError("gap in ref coverage")
                self.payload.append_ref(pidx.digest(ci), ce - cs)
                pos = ce
            else:
                # boundary chunk → re-encode just the overlapping bytes
                lo, hi = max(cs, a), min(ce, b)
                data = prev.read_payload(lo, hi - lo)
                self.payload.write(data)
                self.payload.stats.bytes_reencoded += hi - lo
                pos = hi
        if pos != b:
            raise AssertionError("ref flush did not cover range")
        # emit the pending entries with their new payload offsets
        for entry, old_a in self._pend_entries:
            entry.payload_offset = n0 + (old_a - a)
            if self._codec is not None:
                if entry.size:
                    self._emit_meta(entry, (entry.payload_offset -
                                            PAYLOAD_HDR_SIZE, entry.size))
                else:
                    # empty refed file: write a real zero-length PAYLOAD
                    # item so its ref validates under a stock accessor —
                    # a bare REF(0,0) aimed at the start marker does not
                    # (the encoder now refuses payload_ref=None
                    # files outright).  _write_file_pxar2 recounts the
                    # entry, which write_entry_ref already did.
                    self._entries -= 1
                    self._write_file_pxar2(entry, io.BytesIO(b""), 1 << 16)
            else:
                self._emit_meta(entry)
        self._pend_entries.clear()
        self._pend_a = self._pend_b = -1

    def finish(self):
        self._flush_refs()
        return super().finish()


class SplitReader:
    """Random-access reader over a (meta_didx, payload_didx, chunk store)
    triple (reference: transfer.NewSplitReader,
    internal/pxar/format.go:108-126).

    Chunk reads go through a ``chunkcache.ChunkCache`` (decompressed+
    verified LRU with single-flight fetch and sequential readahead —
    docs/data-plane.md "Read path").  Default: a private per-reader
    cache (``max_cache_bytes``, 256 MiB), preserving the old per-reader
    isolation — a fresh reader always re-reads (and re-verifies) the
    disk.  Server read consumers pass ``cache=chunkcache.shared_cache()``
    explicitly to share verified chunks process-wide."""

    def __init__(self, meta_index: DynamicIndex, payload_index: DynamicIndex,
                 store: ChunkStore, *, max_cache_bytes: int | None = None,
                 cache: "chunkcache.ChunkCache | None" = None):
        from . import chunkcache
        self.meta_index = meta_index
        self.payload_index = payload_index
        self.store = store
        if cache is not None:
            self._cache = cache
        else:
            self._cache = chunkcache.ChunkCache(
                 256 << 20 if max_cache_bytes is None else max_cache_bytes)
        # per-reader hit/miss counts (the shared cache aggregates across
        # every reader; pxar.stats wants THIS reader's locality)
        self._stats = {"hits": 0, "misses": 0}
        self._ra = {id(self.meta_index): chunkcache.ReadaheadState(),
                    id(self.payload_index): chunkcache.ReadaheadState()}
        self._tree: dict[str, Entry] | None = None
        self._children: dict[str, list[str]] | None = None
        self._codec: str | None = None

    @property
    def cache(self) -> "chunkcache.ChunkCache":
        return self._cache

    @property
    def codec(self) -> str:
        """'pxar2' or 'tpxar', sniffed from the meta stream's first
        bytes (`pxarv2.sniff_is_pxar2`) — both encodings coexist in one
        datastore, so readers decide per snapshot."""
        if self._codec is None:
            self._codec = ("pxar2"
                           if sniff_is_pxar2(self.read_meta(0, 8))
                           else "tpxar")
        return self._codec

    # -- low-level stream reads ------------------------------------------
    def fetch_chunk(self, digest: bytes) -> bytes:
        """Decompressed, verified bytes of one chunk, through the cache
        (the ONLY sanctioned path to the chunk source on the read side —
        pbslint rule ``cache-discipline``)."""
        return self._cache.get(self.store, digest, self._stats)

    def _read_stream(self, index: DynamicIndex, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        end = min(offset + size, index.total_size)
        if offset >= end:
            return b""
        # collect the wave's chunk list first, then fetch as one
        # streamed batch: get_stream resolves delta chains through a
        # wave-local memo, so a base shared by several chunks in this
        # read decompresses once — while each chunk's bytes are sliced
        # and dropped immediately (O(chunk) resident, not O(range))
        wave: list[tuple[int, int, int, bytes]] = []
        first_ci = last_ci = -1
        for ci in index.chunks_overlapping(offset, end):
            cs, ce = index.chunk_bounds(ci)
            wave.append((ci, cs, ce, index.digest(ci)))
            if first_ci < 0:
                first_ci = ci
            last_ci = ci
        parts: list[bytes] = []
        fetched = self._cache.get_stream(
            self.store, (w[3] for w in wave), self._stats)
        for (_ci, cs, ce, digest), data in zip(wave, fetched):
            lo, hi = max(cs, offset), min(ce, end)
            parts.append(data[lo - cs:hi - cs])
        if first_ci >= 0:
            ra = self._ra.get(id(index))
            if ra is not None:
                ra.on_read(self._cache, self.store, index, first_ci, last_ci)
        return b"".join(parts)

    def read_payload(self, offset: int, size: int) -> bytes:
        return self._read_stream(self.payload_index, offset, size)

    def read_meta(self, offset: int, size: int) -> bytes:
        return self._read_stream(self.meta_index, offset, size)

    # -- entries ----------------------------------------------------------
    def entries(self) -> Iterator[Entry]:
        """Stream all entries in archive (sorted-path) order."""
        stream = _StreamIO(self, self.meta_index)
        if self.codec == "pxar2":
            yield from decode_pxar2(stream)
        else:
            yield from decode_entries(stream)

    def _load_tree(self) -> None:
        if self._tree is not None:
            return
        tree: dict[str, Entry] = {}
        children: dict[str, list[str]] = {}
        for e in self.entries():
            tree[e.path] = e
            if e.path:
                parent = e.path.rsplit("/", 1)[0] if "/" in e.path else ""
                children.setdefault(parent, []).append(e.path)
            children.setdefault(e.path, []) if e.is_dir else None
        self._tree = tree
        self._children = children

    def lookup(self, path: str) -> Entry | None:
        self._load_tree()
        assert self._tree is not None
        return self._tree.get(path.strip("/"))

    def read_dir(self, path: str) -> list[Entry]:
        self._load_tree()
        assert self._tree is not None and self._children is not None
        key = path.strip("/")
        if key and key not in self._tree:
            raise FileNotFoundError(path)
        return [self._tree[p] for p in sorted(self._children.get(key, []))]

    def _file_range(self, entry: Entry, offset: int, size: int) -> tuple[int, int]:
        """Clamped (payload_offset, size) for a ranged file read."""
        if not entry.is_file:
            raise IsADirectoryError(entry.path)
        if entry.size == 0 or entry.payload_offset < 0:
            return 0, 0
        if size < 0:
            size = entry.size - offset
        return entry.payload_offset + offset, \
            max(0, min(size, entry.size - offset))

    def read_file(self, entry: Entry, offset: int = 0, size: int = -1) -> bytes:
        off, n = self._file_range(entry, offset, size)
        return self.read_payload(off, n) if n else b""

    def file_reader(self, entry: Entry, offset: int = 0,
                    size: int = -1) -> "tuple[_RangeIO, int]":
        """(sequential file-like over the clamped range, range size) —
        the chunk-aligned pump: consumers read in their own window size
        while each underlying chunk is decompressed at most once (cache
        hits serve every later window), and the whole range is never
        materialized at once (remote.read_at, zip streaming)."""
        off, n = self._file_range(entry, offset, size)
        return _RangeIO(self, self.payload_index, off, n), n

    @property
    def cache_stats(self) -> tuple[int, int]:
        """(hits, misses) of THIS reader against the (shared) cache."""
        return self._stats["hits"], self._stats["misses"]

    # -- construction helpers --------------------------------------------
    @classmethod
    def open_snapshot(cls, ds: Datastore, ref: SnapshotRef,
                      *, max_cache_bytes: int | None = None,
                      cache=None) -> "SplitReader":
        midx, pidx = ds.load_indexes(ref)
        return cls(midx, pidx, ds.chunks, max_cache_bytes=max_cache_bytes,
                   cache=cache)


class _RangeIO(io.RawIOBase):
    """Sequential file-like over one [offset, offset+size) stream range.
    Each ``read(n)`` goes through ``SplitReader._read_stream`` — i.e.
    the chunk cache — so window-sized consumers pay one decompress per
    chunk, not one per window."""

    def __init__(self, reader: "SplitReader", index: DynamicIndex,
                 offset: int, size: int):
        self._r = reader
        self._idx = index
        self._pos = offset
        self._end = offset + size

    def read(self, n: int = -1) -> bytes:
        remaining = self._end - self._pos
        if remaining <= 0:
            return b""
        if n < 0 or n > remaining:
            n = remaining
        out = self._r._read_stream(self._idx, self._pos, n)
        self._pos += len(out)
        return out


class _StreamIO(io.RawIOBase):
    """Sequential file-like view of an indexed stream (for decode_entries)."""

    def __init__(self, reader: SplitReader, index: DynamicIndex,
                 bufsize: int = 4 << 20):
        self._r = reader
        self._idx = index
        self._pos = 0
        self._buf = b""
        self._buf_off = 0
        self._bufsize = bufsize

    def read(self, n: int = -1) -> bytes:
        total = self._idx.total_size
        if n < 0:
            n = total - self._pos
        out = bytearray()
        while n > 0 and self._pos < total:
            rel = self._pos - self._buf_off
            if 0 <= rel < len(self._buf):
                take = min(n, len(self._buf) - rel)
                out += self._buf[rel:rel + take]
                self._pos += take
                n -= take
                continue
            self._buf_off = self._pos
            self._buf = self._r._read_stream(
                self._idx, self._pos, max(self._bufsize, n))
        return bytes(out)


def write_manifest(path: str, *, ref: SnapshotRef, midx: DynamicIndex,
                   pidx: DynamicIndex, stats: WriterStats,
                   payload_params: ChunkerParams, entry_count: int,
                   previous: str | None = None, extra: dict | None = None) -> dict:
    manifest = {
        "format": "tpxar-v1",
        "backup_type": ref.backup_type,
        "backup_id": ref.backup_id,
        "backup_time": ref.backup_time,
        "previous": previous,
        "entries": entry_count,
        "meta_size": midx.total_size,
        "payload_size": pidx.total_size,
        "meta_chunks": len(midx),
        "payload_chunks": len(pidx),
        "chunker": {
            "format": _spec.CHUNK_FORMAT,
            "avg": payload_params.avg_size,
            "min": payload_params.min_size,
            "max": payload_params.max_size,
            "seed": payload_params.seed,
        },
        "stats": {
            "new_chunks": stats.new_chunks,
            "known_chunks": stats.known_chunks,
            "ref_chunks": stats.ref_chunks,
            "bytes_streamed": stats.bytes_streamed,
            "bytes_reffed": stats.bytes_reffed,
            "bytes_reencoded": stats.bytes_reencoded,
        },
        "created_unix": int(time.time()),
    }
    if extra:
        manifest.update(extra)
    atomicio.replace_json(path, manifest)
    return manifest
