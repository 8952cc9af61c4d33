"""The backup job — the reference's most important path (SURVEY §3.2),
TPU-first redesign.

Reference flow: scheduler → preExecute (queued task log, pre-script,
target_status probe, FUSE mount of agentfs) → execute (exec
proxmox-backup-client against the mount; pbc reads cross kernel-FUSE +
aRPC per read) → post-process logs → cleanup (unmount, kill agent child).

This build owns the archive writer (SURVEY §2.9: no pbc exec), so the hot
loop loses two kernel crossings: the server walks agentfs directly over
aRPC and streams file content straight into the DedupWriter (whose chunker
backend is the store's: on the card, ``CudaChunker`` (K1) per read, the
feeder's K2 flushes and the index's K3 probe).  Dataflow:

    agent pread ← aRPC raw stream ← [async prefetcher] → bounded queue →
    [writer thread: CDC chunker → chunk store] → DIDX + manifest

The async side prefetches up to ``queue_depth`` file blocks ahead (the
reference's readahead/buffer-pool role); the writer thread runs the
synchronous dedup writer without blocking the event loop.

A copy of the JAX package's ``server/backup_job.py``, its code byte for
byte apart from its imports, which name the port's own modules, its
logger (``logging``; a job's scoped logger is a ``LoggerAdapter``
carrying the same ``job_id``/``backup_id`` fields) and the chunker
kinds.  The job runs no device work of its own: it gets its device from
the ``LocalStore(device=...)`` it is handed.
``make_chunker_factory(kind, *, cpu_backend=None, device="cuda")``,
``make_batch_hasher`` and ``validate_chunker_kind`` serve the port's
``"cuda"`` (``models/backends.py``: K1 per stream, K2 through the
feeder on the device given, the store's, whose writer probes each batch
with K3) and the reference's kinds: ``""``, ``cpu``, ``scalar`` and
``vector`` through the port's ``chunker/{cpu,native,vector}.py``,
``sidecar:<host:port>`` through its ``ResilientSidecarFactory``; these
hash inline with hashlib and insert chunk by chunk through the index's
host mirror, as the reference's writer does.  The JAX package's ``tpu``
kind raises ``ValueError`` naming that package.
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
import os
import queue
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable

from ..agent.agentfs import AgentFSClient
from ..arpc import Session
from ..arpc.agents_manager import AgentsManager
from ..chunker import CpuChunker
from ..pxar.backupproxy import BackupSession, LocalStore
from ..pxar.format import (
    Entry, KIND_BLOCKDEV, KIND_DEVICE, KIND_DIR, KIND_FIFO, KIND_FILE,
    KIND_HARDLINK, KIND_SOCKET, KIND_SYMLINK,
)
from ..utils import failpoints, trace
from ..utils.resilience import CircuitBreaker, with_retry
from . import checkpoint, database

L = logging.getLogger(__name__)

READ_BLOCK = 8 << 20          # agentfs read granularity
QUEUE_DEPTH = 8               # prefetched blocks in flight

_SENTINEL = object()
_ABORTED = object()


def _get_abortable(q: "queue.Queue", abort: "threading.Event | None"):
    """Blocking queue get that returns _ABORTED instead of waiting
    forever once ``abort`` is set (producers cancelled mid-flight never
    send their sentinels).  The single polling idiom for every
    writer-side wait in this module."""
    while True:
        try:
            return q.get(timeout=0.25)
        except queue.Empty:
            if abort is not None and abort.is_set():
                return _ABORTED


def match_exclusion(rel: str, patterns: list[str]) -> bool:
    """THE exclusion semantic, shared by every target kind (agent pump,
    local walk, s3 pull): plain fnmatch, anchored '/'-patterns matched
    against '/'+rel, and directory-prefix patterns ('cache/')."""
    for pat in patterns:
        p = pat.strip()
        if not p:
            continue
        anchored = p
        if p.startswith("/"):
            p = p[1:]
        if fnmatch.fnmatch(rel, p) or fnmatch.fnmatch("/" + rel, anchored):
            return True
        if p.endswith("/") and (rel + "/").startswith(p):
            return True
    return False


def _tpu_refused() -> ValueError:
    return ValueError("chunker backend 'tpu' is the JAX package's "
                      "(pbs_plus_tpu, TpuChunker); the port's device kind "
                      "is cuda")


def validate_chunker_kind(kind: str) -> None:
    """Cheap syntactic validation (no clients constructed — web CRUD path)."""
    if kind in ("", "cpu", "scalar", "vector", "cuda") \
            or kind.startswith("sidecar:"):
        return
    if kind == "tpu":
        raise _tpu_refused()
    raise ValueError(f"unknown chunker backend {kind!r} "
                     "(want cpu | scalar | vector | cuda | "
                     "sidecar:<host:port>)")


def validate_pipeline_workers(n) -> int:
    """Validate the per-job pipelined-writer worker count (web CRUD
    path).  0 = the sequential writer; 1..64 = pxar/pipeline.py with
    that many hash workers (insert always runs on one ordered committer
    stage, so cut/digest output is identical for every value)."""
    n = int(n)
    if not 0 <= n <= 64:
        raise ValueError(f"pipeline_workers {n} out of range 0..64")
    return n


def make_batch_hasher(kind: str, *, device="cuda"):
    """Batched digest backend matching the chunker backend: the cuda path
    hashes emitted chunks in device batches (K2 through the feeder of
    ``device``, the store's); cpu/sidecar use the writer's inline
    hashlib path."""
    if kind == "cuda":
        from ..models.backends import make_batch_hasher as cuda_hasher
        return cuda_hasher("cuda", device=device)
    if kind == "tpu":
        raise _tpu_refused()
    return None


def resolve_cpu_scan_backend(cpu_backend: str | None = None) -> str:
    """CPU scan implementation for cpu-kind chunkers: explicit
    ``cpu_backend`` (ServerConfig.chunker_backend) wins, empty falls
    back to ``PBS_PLUS_CHUNKER_BACKEND`` (conf.Env.chunker_backend),
    default scalar.  Unknown values degrade to scalar with a warning —
    a typo'd env var must not take the fleet down."""
    from ..utils import conf
    backend = cpu_backend or conf.env().chunker_backend or "scalar"
    if backend in ("scalar", "cpu"):
        return "scalar"
    if backend == "vector":
        return "vector"
    L.warning("unknown chunker backend %r (want scalar | vector); "
              "using the scalar scan", backend)
    return "scalar"


def make_chunker_factory(kind: str, *, cpu_backend: str | None = None,
                         device="cuda"):
    """The one-line config change (BASELINE.json):
    chunker = cuda | cpu | scalar | vector | sidecar:<host:port>.

    ``cuda``: one ``CudaChunker`` (K1) per stream on ``device``, the
    store's.  ``cpu_backend`` selects the scan implementation for the
    cpu kinds (''/'cpu'): 'vector' routes through chunker/vector.py's
    ``ResilientVectorFactory`` (self-test-gated, pinned per stream at
    bind_stream time, degrades to scalar like sidecar degrades to CPU);
    anything else keeps the scalar ``CpuChunker``.  Explicit kinds
    'scalar'/'vector' pin the implementation regardless of conf.
    Invoked inside ``start_session``, which job code runs off the event
    loop."""
    if kind == "cuda":
        from ..models.backends import make_chunker_factory as cuda_factory
        return cuda_factory("cuda", device=device)
    if kind == "tpu":
        raise _tpu_refused()
    if kind.startswith("sidecar:"):
        # breaker-gated factory: degrades to the CPU chunker when the
        # sidecar is unreachable, decided per stream at OPEN time only
        # (sidecar/client.py ResilientSidecarFactory docstring)
        from ..sidecar.client import ResilientSidecarFactory
        return ResilientSidecarFactory(kind.split(":", 1)[1])
    if kind == "scalar":
        return lambda p: CpuChunker(p)
    if kind == "vector" or (kind in ("", "cpu")
                            and resolve_cpu_scan_backend(cpu_backend)
                            == "vector"):
        from ..chunker.vector import ResilientVectorFactory
        return ResilientVectorFactory()
    if kind not in ("", "cpu"):
        raise ValueError(f"unknown chunker backend {kind!r} "
                         "(want cpu | scalar | vector | cuda | "
                         "sidecar:<host:port>)")
    return lambda p: CpuChunker(p)


@dataclass
class BackupResult:
    snapshot: str = ""
    entries: int = 0
    bytes_total: int = 0
    files: int = 0
    errors: list[str] = field(default_factory=list)
    manifest: dict = field(default_factory=dict)


class _QueuePumpReader:
    """File-like .read(n) fed by a thread-safe queue of blocks (async
    producer / sync writer-thread consumer)."""

    def __init__(self, q: "queue.Queue", abort: "threading.Event | None" = None):
        self._q = q
        self._abort = abort
        self._buf = b""
        self._eof = False
        # set by the writer thread when it dies: the async producer checks
        # it before each fq.put so a >64 MB file can't wedge the job on a
        # dead consumer (advisor finding r1)
        self.dead = False

    def read(self, n: int = -1) -> bytes:
        while not self._buf and not self._eof:
            item = _get_abortable(self._q, self._abort)
            if item is _ABORTED:
                # producer was cancelled mid-file; no sentinel will
                # ever come — fail the writer instead of hanging
                self._eof = True
                raise RuntimeError("backup aborted mid-file")
            if item is _SENTINEL:
                self._eof = True
                break
            if isinstance(item, Exception):
                self._eof = True
                raise item
            self._buf = item
        if not self._buf:
            return b""
        if n < 0 or n >= len(self._buf):
            out = self._buf
            self._buf = b""
        else:
            out = self._buf[:n]
            self._buf = self._buf[n:]
        return out


class RemoteTreeBackup:
    """Walks an agentfs tree in archive (DFS) order and streams it into a
    BackupSession writer."""

    def __init__(self, client: AgentFSClient, session: BackupSession, *,
                 exclusions: list[str] | None = None,
                 job_log=None):
        self.fs = client
        self.session = session
        self.exclusions = exclusions or []
        self.log = job_log or L
        self.result = BackupResult()
        # checkpoint resume (server/checkpoint.py): files the crashed
        # run fully committed splice via write_entry_ref with ZERO agent
        # reads — only the tail of the tree re-streams
        self.resume = getattr(session, "resume_plan", None)
        self._wq: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._writer_exc: BaseException | None = None
        self._seen_inodes: dict[tuple[int, int], str] = {}
        # set when run() is cancelled (job kill): the writer thread must
        # exit without waiting for sentinels a dead producer never sends
        self._abort = threading.Event()

    def _excluded(self, rel: str) -> bool:
        return match_exclusion(rel, self.exclusions)

    @staticmethod
    def _to_entry(rel: str, m: dict) -> Entry:
        kind = m["kind"]
        return Entry(
            path=rel, kind=kind, mode=m["mode"], uid=m["uid"], gid=m["gid"],
            mtime_ns=m["mtime_ns"],
            size=m["size"] if kind == KIND_FILE else 0,
            link_target=m.get("target", ""),
            rdev=m.get("rdev", 0),
            xattrs={k: bytes(v) for k, v in m.get("xattrs", {}).items()},
        )

    async def run(self) -> BackupResult:
        # hand the job's trace context to the writer thread: ingest
        # stage spans emitted there parent under the job span
        self._tctx = trace.capture()
        writer_thread = threading.Thread(
            target=self._writer_loop, name="backup-writer", daemon=True)
        writer_thread.start()
        try:
            root_attr = await self.fs.attr("")
            await self._put(("entry", self._to_entry("", root_attr), None))
            await self._walk("")
        except BaseException as e:
            await self._put(e if isinstance(e, Exception) else RuntimeError(str(e)))
            raise
        finally:
            # the sync abort flag ALWAYS lands, even if the awaits below
            # are interrupted by task cancellation — the writer thread
            # then self-drains and exits instead of blocking forever
            self._abort.set()
            closer = asyncio.ensure_future(self._close_writer(writer_thread))
            try:
                await asyncio.shield(closer)
            except asyncio.CancelledError:
                # finish the join before propagating so no caller ever
                # observes run() "done" with the writer still streaming
                if not closer.done():
                    try:
                        await closer
                    except (asyncio.CancelledError, Exception) as e:
                        self.log.debug(
                            "writer close raced job cancel: %s", e)
                raise
        if self._writer_exc is not None:
            raise self._writer_exc
        return self.result

    async def _close_writer(self, writer_thread: threading.Thread) -> None:
        await self._put(_SENTINEL)
        await asyncio.get_running_loop().run_in_executor(
            None, writer_thread.join)

    async def _put(self, item) -> None:
        await asyncio.get_running_loop().run_in_executor(
            None, self._wq.put, item)

    async def _walk(self, rel: str) -> None:
        seen_inodes = self._seen_inodes
        try:
            entries = await self.fs.read_dir(rel)
        except ConnectionError:
            # transport death fails the JOB (the job-level retry may
            # re-run it); swallowing it as a per-dir error would grind
            # through every remaining path against a dead session
            raise
        except Exception as e:
            self.result.errors.append(f"{rel}: {e}")
            return
        for m in entries:
            child = f"{rel}/{m['name']}" if rel else m["name"]
            if self._excluded(child):
                continue
            kind = m["kind"]
            e = self._to_entry(child, m)
            if kind == KIND_DIR:
                await self._put(("entry", e, None))
                await self._walk(child)
            elif kind == KIND_FILE:
                key = (m.get("dev", 0), m.get("ino", 0))
                if m.get("nlink", 1) > 1 and key in seen_inodes:
                    e.kind = KIND_HARDLINK
                    e.link_target = seen_inodes[key]
                    e.size = 0
                    await self._put(("entry", e, None))
                else:
                    if m.get("nlink", 1) > 1:
                        seen_inodes[key] = child
                    src_e = (self.resume.skip_ref(child, e.size, e.mtime_ns)
                             if self.resume is not None else None)
                    if src_e is not None:
                        # digest rides along from the checkpoint entry so
                        # verification sees the whole-file sha256 (the
                        # mount commit engine's ref discipline)
                        e.digest = src_e.digest
                        await self._put(
                            ("ref", e, (src_e.payload_offset, src_e.size)))
                        # spliced files count as completed files, same
                        # as the local walker's skip branch
                        self.result.files += 1
                    else:
                        await self._stream_file(child, e)
            elif kind == KIND_SYMLINK:
                # multiply-linked symlinks are hardlink entries here too
                # (same rsync -H parity as pxar/walker.py's local walk)
                key = (m.get("dev", 0), m.get("ino", 0))
                if m.get("nlink", 1) > 1 and key in seen_inodes:
                    e.kind = KIND_HARDLINK
                    e.link_target = seen_inodes[key]
                elif m.get("nlink", 1) > 1:
                    seen_inodes[key] = child
                await self._put(("entry", e, None))
            elif kind in (KIND_FIFO, KIND_SOCKET, KIND_DEVICE,
                          KIND_BLOCKDEV):
                await self._put(("entry", e, None))
            self.result.entries += 1

    async def _stream_file(self, rel: str, entry: Entry) -> None:
        """Prefetch file blocks over aRPC into the writer queue."""
        try:
            handle = await self.fs.open(rel)
        except ConnectionError:
            raise                       # dead transport: fail the job
        except Exception as e:
            self.result.errors.append(f"{rel}: open: {e}")
            return
        fq: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        reader = _QueuePumpReader(fq, self._abort)
        await self._put(("file", entry, reader))
        off = 0
        try:
            while True:
                if reader.dead:      # writer died; its drain empties fq
                    break
                await failpoints.ahit("backup.file.stream")
                block = await self.fs.read_at(handle, off, READ_BLOCK)
                if not block:
                    break
                await asyncio.get_running_loop().run_in_executor(
                    None, fq.put, block)
                off += len(block)
                self.result.bytes_total += len(block)
                if self.resume is not None:
                    self.resume.note_reread(len(block))
        except ConnectionError as e:
            # dead transport: fail the writer's file AND the job (the
            # job-level retry re-runs incrementally — committed chunks
            # are already in the store)
            await asyncio.get_running_loop().run_in_executor(
                None, fq.put, RuntimeError(f"read {rel}: {e}"))
            self.result.errors.append(f"{rel}: read: {e}")
            raise
        except Exception as e:
            await asyncio.get_running_loop().run_in_executor(
                None, fq.put, RuntimeError(f"read {rel}: {e}"))
            self.result.errors.append(f"{rel}: read: {e}")
            return
        finally:
            await asyncio.get_running_loop().run_in_executor(
                None, fq.put, _SENTINEL)
            try:
                await self.fs.close(handle)
            except Exception as e:
                self.log.debug("agentfs close failed for %s: %s", rel, e)
        self.result.files += 1
        if self.resume is not None:
            self.resume.note_reread(0, files=1)

    def _drain_reader(self, reader) -> None:
        """Unblock the async producer of a dropped/aborted file: mark the
        reader dead (producer stops reading ahead) and consume its block
        queue until the producer's closing sentinel so any in-flight
        fq.put is released (advisor finding r1: the S3 writer drained its
        file queue on error; this path previously did not).  Under abort
        (producer cancelled) the sentinel may never come — bounded
        timeout-gets instead of waiting forever."""
        if reader is None or reader._eof:
            # _eof ⇒ the producer's closing sentinel was already consumed
            # (nothing more will arrive; a blocking get would never return)
            return
        reader.dead = True
        while True:
            item = _get_abortable(reader._q, self._abort)
            if item is _ABORTED or item is _SENTINEL or \
                    isinstance(item, BaseException):
                return

    def _nowait_drain_all(self, current) -> None:
        """Abort path: free every blocked executor-thread put without
        waiting for producers that were cancelled mid-flight."""
        def drain_q(q: "queue.Queue") -> None:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    return
        if current is not None:
            current.dead = True
            drain_q(current._q)
        while True:
            try:
                item = self._wq.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, tuple) and item[0] == "file":
                item[2].dead = True
                drain_q(item[2]._q)

    def _writer_loop(self) -> None:
        # fresh thread: attach the job's trace context so the writer's
        # ingest-stage spans/emits parent under the job span
        with trace.attached(getattr(self, "_tctx", None)):
            self._writer_loop_body()

    def _writer_loop_body(self) -> None:
        w = self.session.writer
        current = None
        try:
            while True:
                item = _get_abortable(self._wq, self._abort)
                if item is _ABORTED:
                    self._nowait_drain_all(current)
                    return
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    return
                tag, entry, reader = item
                if tag == "entry":
                    w.write_entry(entry)
                elif tag == "ref":
                    # checkpoint fast-skip: splice the previous payload
                    # range (reader is the (old_offset, size) pair)
                    w.write_entry_ref(entry, reader[0], reader[1])
                else:
                    current = reader
                    w.write_entry_reader(entry, reader)
                    current = None
        except BaseException as e:
            self._writer_exc = e
            # drain so no producer ever blocks on a dead consumer: the
            # in-flight file first, then every dropped item in _wq
            self._drain_reader(current)
            while True:
                item = _get_abortable(self._wq, self._abort)
                if item is _ABORTED:
                    self._nowait_drain_all(None)
                    return
                if item is _SENTINEL or isinstance(item, BaseException):
                    return
                if isinstance(item, tuple) and item[0] == "file":
                    self._drain_reader(item[2])


def crashed_backup_job_ids(db: database.Database,
                           tasks: list[dict]) -> list[str]:
    """Which of the tasks found 'running' at startup (they died with the
    previous process) should be re-enqueued as resumable backups: backup
    tasks whose job row still exists and is enabled, deduped in task
    order.  The policy half of Server._cleanup_orphaned_tasks, split out
    so the startup self-heal is testable without the server's TLS
    stack."""
    out: list[str] = []
    for t in tasks:
        if t.get("kind") != "backup":
            continue
        row = db.get_backup_job(t["job_id"])
        if row is not None and row.enabled:
            out.append(row.id)
    return list(dict.fromkeys(out))


async def run_target_backup(row: database.BackupJobRow, *,
                            db: database.Database,
                            agents: AgentsManager,
                            store: LocalStore,
                            on_pump=None,
                            breaker_factory: Callable[
                                [], CircuitBreaker] | None = None,
                            attempts: int = 1,
                            checkpoint_interval: str = "") -> BackupResult:
    """Dispatch by target kind (reference: Target(agent|local|s3),
    internal/server/database/types.go) — agent targets stream over aRPC,
    local targets walk the server's own filesystem, s3 targets pull a
    bucket tree through the SigV4 client.

    Agent targets get the resilience wrap — applied HERE, at the single
    kind-dispatch point, so callers need not duplicate the kind
    defaulting: ``breaker_factory`` lazily yields the per-target circuit
    (JobsManager.breaker — one dead agent must not burn the scheduler's
    whole retry budget) and ``attempts > 1`` enables the job-level
    retry, which the dedup store makes cheap — chunks committed by a
    failed attempt are already present, so the re-run is incremental by
    construction.  ``CircuitOpenError``/cancellation are never retried
    (utils/resilience.py).

    ``checkpoint_interval`` (conf: ``PBS_PLUS_CHECKPOINT_INTERVAL``)
    arms durable checkpoints on agent and local targets backed by a
    local datastore — a crashed or retried attempt then resumes from the
    last checkpoint instead of byte zero (server/checkpoint.py); s3
    pulls and PBS push sessions are not checkpointed."""
    target = db.get_target(row.target)
    kind = (target or {}).get("kind", "agent")
    if kind == "local":
        return await run_local_backup(row, db=db, store=store,
                                      target=target,
                                      checkpoint_interval=checkpoint_interval)
    if kind == "s3":
        return await run_s3_backup(row, db=db, store=store, target=target)
    if kind != "agent":
        # a typo'd kind must fail HERE, not as a misleading
        # "agent not connected" from the fall-through
        raise RuntimeError(f"unknown target kind {kind!r} "
                           "(want agent | local | s3)")

    async def once() -> BackupResult:
        return await run_backup_job(row, db=db, agents=agents, store=store,
                                    on_pump=on_pump,
                                    checkpoint_interval=checkpoint_interval)

    breaker = breaker_factory() if breaker_factory is not None else None
    guarded = once if breaker is None else (lambda: breaker.call(once))
    if attempts <= 1 and breaker is None:
        return await once()
    return await with_retry(guarded, attempts=max(1, attempts),
                            base_delay_s=0.5, max_delay_s=5.0,
                            name=f"backup:{row.id}")


async def run_local_backup(row: database.BackupJobRow, *, db, store,
                           target: dict | None,
                           checkpoint_interval: str = "") -> BackupResult:
    """Local-path target: snapshot (btrfs/lvm/freeze fall-through) and
    walk the server's own filesystem — no agent involved (reference:
    local targets back up paths on the PBS host itself)."""
    from ..agent.snapshots import SnapshotManager
    from ..pxar.walker import backup_tree

    src = row.source_path or (target or {}).get("root_path", "")
    if not src or not os.path.isdir(src):
        raise RuntimeError(f"local source {src!r} is not a directory")
    result = BackupResult()
    exclusions = row.exclusions + db.list_exclusions(row.id)
    backup_id = row.backup_id or row.target

    def excluded(rel: str) -> bool:
        return match_exclusion(rel, exclusions)

    def run_sync() -> None:
        snaps = SnapshotManager()
        snap = snaps.create(src)
        try:
            with trace.span("backup.session_open"):
                resume_ctx = checkpoint.open_resume(
                    store, backup_type="host", backup_id=backup_id,
                    namespace=row.namespace or "")
                kw = {"previous_reader": resume_ctx[0]} if resume_ctx \
                    else {}
                session = store.start_session(
                    backup_type="host", backup_id=backup_id,
                    namespace=row.namespace or None,
                    pipeline_workers=row.pipeline_workers, **kw)
            try:
                if resume_ctx is not None:
                    session.resume_plan = resume_ctx[1]
                checkpoint.attach(session, checkpoint_interval)
                counters = {"files": 0, "bytes": 0}
                n = backup_tree(
                    session, snap.snapshot_path, exclude=excluded,
                    on_error=lambda p, e: result.errors.append(
                        f"{p}: {e}"),
                    counters=counters)
                result.entries = n
                result.files = counters["files"]
                result.bytes_total = counters["bytes"]
                extra = {"job": row.id, "errors": result.errors[:100]}
                if resume_ctx is not None:
                    extra["resume"] = resume_ctx[1].summary()
                with trace.span("backup.publish"):
                    result.manifest = session.finish(extra)
                result.snapshot = str(session.ref)
                # the published snapshot supersedes the group's
                # checkpoints — reap them now instead of waiting for
                # prune's sweep (store may be a PBSStore when the job
                # row says store='pbs': no local datastore, nothing to
                # clear)
                if getattr(store, "datastore", None) is not None:
                    checkpoint.clear(store.datastore, "host", backup_id,
                                     row.namespace or "")
            except BaseException:
                session.abort()
                raise
        finally:
            snaps.cleanup(snap)

    await asyncio.get_running_loop().run_in_executor(
        None, trace.wrap(run_sync))
    return result


async def run_s3_backup(row: database.BackupJobRow, *, db, store,
                        target: dict | None) -> BackupResult:
    """S3 target: pull the bucket/prefix tree through the SigV4 client
    (reference: vfs/s3fs backup source)."""
    import aiohttp

    from .s3 import S3Client, S3Config, backup_s3_tree

    cfg = (target or {}).get("config") or {}
    for k in ("endpoint", "bucket", "access_key", "secret_key"):
        if not cfg.get(k):
            raise RuntimeError(f"s3 target missing config key {k!r}")
    result = BackupResult()
    session = await asyncio.get_running_loop().run_in_executor(
        None, lambda: store.start_session(
            backup_type="host", backup_id=row.backup_id or row.target,
            namespace=row.namespace or None,
            pipeline_workers=row.pipeline_workers))
    try:
        async with aiohttp.ClientSession() as http:
            client = S3Client(http, S3Config(
                endpoint=cfg["endpoint"], bucket=cfg["bucket"],
                access_key=cfg["access_key"],
                secret_key=cfg["secret_key"],
                prefix=cfg.get("prefix", ""),
                region=cfg.get("region", "us-east-1")))
            counters = {"files": 0, "bytes": 0}
            n = await backup_s3_tree(
                client, session,
                exclusions=row.exclusions + db.list_exclusions(row.id),
                counters=counters)
        result.entries = n
        result.files = counters["files"]
        result.bytes_total = counters["bytes"]
        result.manifest = await asyncio.get_running_loop().run_in_executor(
            None, session.finish, {"job": row.id})
        result.snapshot = str(session.ref)
        return result
    except BaseException:
        session.abort()
        raise


async def run_backup_job(row: database.BackupJobRow, *,
                         db: database.Database,
                         agents: AgentsManager,
                         store: LocalStore,
                         job_suffix: str | None = None,
                         on_pump=None,
                         checkpoint_interval: str = "") -> BackupResult:
    """End-to-end agent backup: ask the agent to open a job session, walk
    its agentfs, stream into a datastore session, publish the snapshot."""
    job_id = job_suffix or f"{row.id}-{uuid.uuid4().hex[:8]}"
    target = db.get_target(row.target)
    if target is None:
        raise RuntimeError(f"unknown target {row.target!r}")
    hostname = target["hostname"] or row.target
    log = logging.LoggerAdapter(L, {"job_id": row.id, "backup_id": job_id})

    control = agents.get(hostname)
    if control is None:
        raise RuntimeError(f"agent {hostname!r} not connected")
    control_sess = Session(control.conn)

    # target_status probe over the control plane (reference: job.go:489-543)
    st = await control_sess.call(
        "target_status", {"path": row.source_path})
    if not st.data.get("ok"):
        raise RuntimeError(f"target path unavailable: {st.data}")
    db.touch_target_online(row.target)

    # announce + request the job data session (reference: Expect + "backup")
    client_id = f"{hostname}|{job_id}"
    agents.expect(client_id)
    try:
        resp = await control_sess.call(
            "backup", {"job_id": job_id, "source": row.source_path},
            timeout=120)
        log.info("agent accepted backup (snapshot=%s)",
                 resp.data.get("snapshot_method"))
        loop = asyncio.get_running_loop()
        with trace.span("backup.session_open"):
            job_sess_info = await agents.wait_session(client_id, timeout=60)
            fs = AgentFSClient(Session(job_sess_info.conn))

            # checkpoint resume (datastore-backed stores only): a valid
            # checkpoint from a crashed or retried run becomes the
            # writer's `previous`, and its plan fast-skips committed
            # unchanged files.  Executor offloads are trace.wrap-ped so
            # spans opened on the worker thread (ingest stage emits,
            # store work) stay parented under this job's trace.
            resume_ctx = await loop.run_in_executor(
                None, trace.wrap(lambda: checkpoint.open_resume(
                    store, backup_type="host",
                    backup_id=row.backup_id or row.target,
                    namespace=row.namespace or "")))
            session_kw = ({"previous_reader": resume_ctx[0]}
                          if resume_ctx else {})
            # start_session can do network I/O (PBSStore: TLS connect,
            # session establish, previous-index downloads) — keep it off
            # the event loop
            session = await loop.run_in_executor(
                None, trace.wrap(lambda: store.start_session(
                    backup_type="host",
                    backup_id=row.backup_id or row.target,
                    namespace=row.namespace or None,
                    pipeline_workers=row.pipeline_workers,
                    **session_kw)))
        try:
            if resume_ctx is not None:
                session.resume_plan = resume_ctx[1]
                log.info("resuming from checkpoint %s: %d skippable "
                         "files", resume_ctx[1].summary()["checkpoint"],
                         len(resume_ctx[1]))
            # attach scans the group's .ckpt dir — datastore I/O stays
            # off the event loop like the session/resume calls around it
            await loop.run_in_executor(
                None, lambda: checkpoint.attach(session,
                                                checkpoint_interval))
            pump = RemoteTreeBackup(
                fs, session,
                exclusions=row.exclusions + db.list_exclusions(row.id),
                job_log=log)
            if on_pump is not None:
                on_pump(pump.result)     # live-progress metrics hook
            # crashed-job detection: race the pump against the job
            # session's disconnect (reference: arpcfs crashed-agent
            # pattern — control plane up, job session severed)
            disc = agents.watch_disconnect(job_sess_info)
            pump_task = asyncio.ensure_future(pump.run())
            try:
                await asyncio.wait({pump_task, disc},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not pump_task.done():
                    pump_task.cancel()
                    await asyncio.gather(pump_task, return_exceptions=True)
                    raise RuntimeError(
                        "agent job session lost mid-backup "
                        f"({job_sess_info.client_id})")
                result = await pump_task
            finally:
                agents.unwatch_disconnect(job_sess_info, disc)
                if not disc.done():
                    disc.cancel()
                # outer cancellation (job kill, server stop) must not
                # orphan the pump: its writer would keep streaming into
                # a session about to be aborted
                if not pump_task.done():
                    pump_task.cancel()
                    await asyncio.gather(pump_task, return_exceptions=True)
            extra = {"job": row.id, "errors": pump.result.errors[:100]}
            if resume_ctx is not None:
                extra["resume"] = resume_ctx[1].summary()

            def _publish():
                with trace.span("backup.publish"):
                    return session.finish(extra)
            manifest = await loop.run_in_executor(
                None, trace.wrap(_publish))
            if getattr(store, "datastore", None) is not None:
                # published snapshot supersedes the group's checkpoints
                await loop.run_in_executor(
                    None, lambda: checkpoint.clear(
                        store.datastore, "host",
                        row.backup_id or row.target, row.namespace or ""))
            result.snapshot = str(session.ref)
            result.manifest = manifest
            log.info("backup complete: %d entries, %d bytes, snapshot %s",
                     result.entries, result.bytes_total, result.snapshot)
            return result
        except BaseException:
            session.abort()
            raise
    finally:
        agents.unexpect(client_id)
        # the server owns the client end of the job data session — close
        # it so a fork-isolated agent child sees EOF and can wind down
        # even when the daemon (and its "cleanup" RPC) is gone
        try:
            sess_info = agents.get(client_id)
            if sess_info is not None:
                await sess_info.conn.close()
        except Exception as e:
            log.debug("job data session close failed: %s", e)
        # tear down the agent-side job session (reference: "cleanup" RPC)
        try:
            await control_sess.call("cleanup", {"job_id": job_id}, timeout=15)
        except Exception as e:
            log.warning("agent cleanup RPC failed (agent may leak a "
                        "snapshot): %s", e)
