"""Durable backup checkpoints: crash anywhere, resume from progress.

A retried or restarted backup used to start from byte zero: dedup
against the *previous snapshot* makes re-runs cheap only when a previous
snapshot exists, so a first full backup dying at 90% re-read, re-chunked
and re-hashed the whole source over the agent link (chunking+hashing
dominate ingest cost — arXiv:2409.06066).  This module persists the
writer's committed progress periodically and lets the next attempt
splice it back:

    checkpoint = the committed meta/payload DynamicIndex prefix of the
    in-flight session plus the walker high-water mark (the last
    fully-committed entry path — well-defined because SessionWriter
    enforces strict DFS order and both stream writers commit in order).

    resume     = open the newest valid checkpoint's indexes as a
    SplitReader fed to DedupWriter as ``previous``; entries at-or-below
    the high-water mark with unchanged stat are emitted via
    ``write_entry_ref`` with NO file reads from the agent — only the
    tail of the tree is re-streamed.

Layout (one hidden dir per backup group, invisible to snapshot listing
because it carries no manifest):

    <datastore>/[ns/...]<type>/<id>/.ckpt/ck-<seq>/
        state.json      high-water mark, entry count, chunker params
        meta.midx       committed meta-stream DynamicIndex (TPXD)
        payload.pidx    committed payload-stream DynamicIndex (TPXD)

Checkpoints publish atomically (tmp dir + rename; the
``backup.checkpoint.flush`` failpoint fires before the tmp write, so an
injected crash always leaves the previous checkpoint intact).  GC
safety: ``live_checkpoint_digests`` feeds prune's mark phase so a live
checkpoint's chunks are never swept, and ``sweep_stale`` reaps
checkpoints superseded by a published snapshot or older than
``CKPT_MAX_AGE_S``.  Sessions run on any store exposing a local
``Datastore`` (LocalStore); PBS push sessions have no readable staging
side and are not checkpointed.

A copy of the JAX package's ``server/checkpoint.py``, its code byte for
byte apart from its imports, which name the port's own modules, and its
logger (``logging``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time

from ..pxar.datastore import BACKUP_TYPES, Datastore, DynamicIndex, SnapshotRef
from ..pxar.format import KIND_FILE
from ..pxar.transfer import SplitReader
from ..chunker import spec as _spec
from ..utils import atomicio, failpoints

L = logging.getLogger(__name__)

CKPT_DIR = ".ckpt"
CKPT_FORMAT = "tpxar-ckpt-v1"
CKPT_MAX_AGE_S = 7 * 24 * 3600.0     # unresumed checkpoints age out
_TMP_TTL_S = 3600.0                  # .tmp dirs younger than this may be
                                     # a live flush — never reaped
STATE_JSON = "state.json"
META_IDX = "meta.midx"
PAYLOAD_IDX = "payload.pidx"


def parse_interval(spec: str) -> tuple[int, float]:
    """``PBS_PLUS_CHECKPOINT_INTERVAL`` → (chunks, seconds); (0, 0.0)
    disables checkpointing.  Grammar: ``<N>c`` (every N committed payload
    chunks), ``<M>s`` (every M seconds), or both joined with ``/`` —
    ``"256c/60s"``.  A bare number means chunks."""
    spec = (spec or "").strip()
    if not spec or spec == "0":
        return 0, 0.0
    chunks, seconds = 0, 0.0
    try:
        for part in spec.split("/"):
            part = part.strip().lower()
            if not part:
                continue
            if part.endswith("s"):
                seconds = float(part[:-1])
            elif part.endswith("c"):
                chunks = int(part[:-1])
            else:
                chunks = int(part)
    except ValueError:
        raise ValueError(
            f"bad checkpoint interval {spec!r} (want '<N>c', '<M>s' or "
            f"'<N>c/<M>s', e.g. '256c/60s')") from None
    if chunks < 0 or seconds < 0:
        raise ValueError(f"bad checkpoint interval {spec!r}: negative")
    return chunks, seconds


class CheckpointMetrics:
    """Process-global checkpoint observability (rendered by
    server/metrics.py): cumulative counters over every session."""

    _KEYS = ("written", "write_failures", "resumes", "files_skipped",
             "bytes_skipped", "files_reread", "bytes_reread", "swept")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._KEYS, 0)

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


METRICS = CheckpointMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def group_ckpt_dir(ds: Datastore, ref: SnapshotRef) -> str:
    """The group's hidden checkpoint dir (independent of backup_time)."""
    return os.path.join(os.path.dirname(ds.snapshot_dir(ref)), CKPT_DIR)


def _seq_of(name: str) -> int:
    try:
        return int(name.split("-", 1)[1])
    except (IndexError, ValueError):
        return -1


class Checkpointer:
    """The ``SessionWriter.checkpoint_hook``: fires after every completed
    entry on the backup writer thread, persists a checkpoint when the
    conf-plumbed interval (committed payload chunks and/or seconds) is
    due.  A checkpoint-write failure is logged and counted, never fatal
    to the backup — the checkpoint is an optimization, the session's own
    error paths stay authoritative."""

    def __init__(self, session, *, every_chunks: int = 0,
                 every_s: float = 0.0):
        self.session = session
        self.every_chunks = int(every_chunks)
        self.every_s = float(every_s)
        self.written = 0
        self._last_t = time.time()
        self._last_chunks = 0
        self._busy = False       # re-entrancy: flushing refs emits entries
        # seq of the checkpoint this session is RESUMING from, if any:
        # it must survive until publish — a new checkpoint only covers
        # the prefix committed so far, while the resume plan still holds
        # un-spliced files whose chunks are GC-protected ONLY by the old
        # checkpoint's indexes
        plan = getattr(session, "resume_plan", None)
        self.protect_seq = (_seq_of(os.path.basename(plan.checkpoint.path))
                            if plan is not None else -1)
        ds = session.store.datastore
        self._dir = group_ckpt_dir(ds, session.ref)
        existing = []
        if os.path.isdir(self._dir):
            existing = [_seq_of(n) for n in os.listdir(self._dir)
                        if n.startswith("ck-")]
        self._seq = max(existing, default=0) + 1

    def install(self) -> "Checkpointer":
        self.session.writer.checkpoint_hook = self
        return self

    def _due(self, writer) -> bool:
        n = len(writer.payload.records)
        if self.every_chunks and n - self._last_chunks >= self.every_chunks:
            return True
        return bool(self.every_s
                    and time.time() - self._last_t >= self.every_s)

    def __call__(self, writer) -> None:
        if self._busy or not self._due(writer):
            return
        self._busy = True
        try:
            # the stream sync commits REAL backup data (chunker flush +
            # store inserts) — its failures are the BACKUP's failures
            # and must propagate; only the persist step below is
            # best-effort
            writer.sync_streams()
            try:
                self._persist(writer)
            except Exception as e:
                METRICS.inc("write_failures")
                L.warning("checkpoint write failed for %s (backup "
                          "continues, previous checkpoint still valid): "
                          "%s", self.session.ref, e)
        finally:
            # (re)base the interval even on failure so a persistently
            # failing flush (read-only dir, ENOSPC) does not retry on
            # every single entry
            self._last_t = time.time()
            self._last_chunks = len(writer.payload.records)
            self._busy = False

    def flush(self, writer) -> dict:
        """Persist the committed state NOW (the test/bench hook).
        Only valid between entries, which is when the hook runs."""
        writer.sync_streams()
        return self._persist(writer)

    def _persist(self, writer) -> dict:
        """Atomically write the (already stream-synced) committed state."""
        failpoints.hit("backup.checkpoint.flush")
        ds = self.session.store.datastore
        params = self.session.store.params
        state = {
            "format": CKPT_FORMAT,
            "backup_type": self.session.ref.backup_type,
            "backup_id": self.session.ref.backup_id,
            "namespace": self.session.ref.namespace,
            "backup_time": self.session.ref.backup_time,
            "hwm": writer._last_path,
            "entry_count": writer.entry_count,
            "entry_codec": writer.entry_codec,
            "meta_size": writer.meta.offset,
            "payload_size": writer.payload.offset,
            "chunker": {"format": _spec.CHUNK_FORMAT,
                        "avg": params.avg_size, "min": params.min_size,
                        "max": params.max_size, "seed": params.seed},
            "created_unix": time.time(),
            "seq": self._seq,
            # seq of the checkpoint this session resumed from (-1 =
            # fresh run): sweep_stale keeps it alive alongside the
            # newest, because the resume plan still holds un-spliced
            # files whose chunks only IT protects from GC
            "resumed_from": self.protect_seq,
        }
        seq, self._seq = self._seq, self._seq + 1
        os.makedirs(self._dir, exist_ok=True)
        with atomicio.staged_dir(
                os.path.join(self._dir, f"ck-{seq:08d}"),
                tmp=os.path.join(self._dir,
                                 f".tmp-{seq:08d}.{os.getpid()}")) as tmp:
            now_ns = time.time_ns()
            DynamicIndex.from_records(list(writer.meta.records),
                                      ctime_ns=now_ns).write(
                os.path.join(tmp, META_IDX))
            DynamicIndex.from_records(list(writer.payload.records),
                                      ctime_ns=now_ns).write(
                os.path.join(tmp, PAYLOAD_IDX))
            atomicio.write_bytes(
                os.path.join(tmp, STATE_JSON),
                json.dumps(state, indent=1, sort_keys=True)
                .encode("utf-8"))
        # the new checkpoint supersedes every older one in the group —
        # EXCEPT the one this session is resuming from: its indexes are
        # the only GC protection for files the plan has not spliced yet,
        # so it lives until publish (clear()) or prune's sweep_stale
        for name in os.listdir(self._dir):
            if name.startswith("ck-") and _seq_of(name) < seq \
                    and _seq_of(name) != self.protect_seq:
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
        self.written += 1
        METRICS.inc("written")
        L.info("checkpoint %d written for %s (hwm=%r, %d entries, "
               "%d payload chunks)", seq, self.session.ref, state["hwm"],
               state["entry_count"], len(writer.payload.records))
        return state


def attach(session, interval: str) -> Checkpointer | None:
    """Arm periodic checkpointing on a datastore-backed session; returns
    None when the interval disables it or the session's store has no
    local datastore (PBS push sessions).  A malformed interval is loud
    (warning + counted) but NEVER fatal — checkpointing is an
    optimization; the backup runs un-checkpointed."""
    try:
        chunks, seconds = parse_interval(interval)
    except ValueError as e:
        METRICS.inc("write_failures")
        L.warning("checkpointing disabled for %s: %s", session.ref, e)
        return None
    if not chunks and not seconds:
        return None
    if getattr(session.store, "datastore", None) is None:
        return None
    return Checkpointer(session, every_chunks=chunks,
                        every_s=seconds).install()


class Checkpoint:
    """One loaded-and-validated checkpoint."""

    def __init__(self, path: str, state: dict, midx: DynamicIndex,
                 pidx: DynamicIndex):
        self.path = path
        self.state = state
        self.midx = midx
        self.pidx = pidx


def load_latest(ds: Datastore, backup_type: str, backup_id: str,
                namespace: str = "", *, params=None,
                max_age_s: float = CKPT_MAX_AGE_S) -> Checkpoint | None:
    """Newest valid checkpoint of the group, or None.  Validation: state
    parses, the checkpoint is younger than ``max_age_s`` (the SAME
    cutoff sweep_stale reaps at — a resume must never trust a
    checkpoint whose GC protection may already be gone), chunker params
    match (cuts would not line up otherwise), the indexes parse, and
    every referenced chunk still exists in the store (a GC race or torn
    write invalidates the checkpoint, never the resumed backup)."""
    ref = SnapshotRef(backup_type, backup_id, "x", namespace)
    ckdir = group_ckpt_dir(ds, ref)
    if not os.path.isdir(ckdir):
        return None
    names = sorted((n for n in os.listdir(ckdir) if n.startswith("ck-")),
                   key=_seq_of, reverse=True)
    for name in names:
        path = os.path.join(ckdir, name)
        try:
            with open(os.path.join(path, STATE_JSON)) as f:
                state = json.load(f)
            if state.get("format") != CKPT_FORMAT:
                raise ValueError(f"unknown checkpoint format "
                                 f"{state.get('format')!r}")
            age = time.time() - float(state.get("created_unix", 0))
            if age > max_age_s:
                raise ValueError(f"aged out ({age:.0f}s > "
                                 f"{max_age_s:.0f}s); sweep may have "
                                 "released its chunks")
            ch = state.get("chunker", {})
            if params is not None and (
                    ch.get("format") != _spec.CHUNK_FORMAT
                    or ch.get("avg") != params.avg_size
                    or ch.get("min") != params.min_size
                    or ch.get("max") != params.max_size
                    or ch.get("seed") != params.seed):
                raise ValueError("chunker format/params changed since the "
                                 "checkpoint was written")
            midx = DynamicIndex.parse(os.path.join(path, META_IDX))
            pidx = DynamicIndex.parse(os.path.join(path, PAYLOAD_IDX))
            digests = {midx.digest(i) for i in range(len(midx))}
            digests.update(pidx.digest(i) for i in range(len(pidx)))
            # disk-TRUE check, bypassing the dedup index on purpose: a
            # resume spliced over a vanished chunk (GC race, disk loss)
            # would publish a hole, so this integrity gate must not
            # trust any memory-resident view
            missing = sum(1 for d in digests if not ds.chunks.on_disk(d))
            if missing:
                raise ValueError(f"{missing} referenced chunk(s) missing "
                                 "from the store")
            # the scan just proved every referenced chunk present; warm
            # the read cache with the META stream (ResumePlan decodes it
            # in full next) so the resume's entry scan starts on hits
            from ..pxar import chunkcache
            chunkcache.shared_cache().prefetch(
                ds.chunks, (midx.digest(i) for i in range(len(midx))))
            return Checkpoint(path, state, midx, pidx)
        except (OSError, ValueError, KeyError) as e:
            L.warning("ignoring invalid checkpoint %s: %s", path, e)
    return None


class ResumePlan:
    """Fast-skip decisions for a resumed walk: file entries the
    checkpoint fully committed, keyed by path, matched on (size,
    mtime_ns) — unchanged files splice their previous payload range via
    ``write_entry_ref`` with no agent reads; everything else re-streams
    (and dedups chunk-level against the store anyway)."""

    def __init__(self, checkpoint: Checkpoint, reader: SplitReader):
        self.checkpoint = checkpoint
        self.hwm = checkpoint.state.get("hwm") or ""
        self._files: dict[str, object] = {}
        try:
            for e in reader.entries():
                if e.kind == KIND_FILE and e.size and e.payload_offset >= 0:
                    self._files[e.path] = e
        except Exception as e:
            # a pxar2 checkpoint prefix has no closing goodbye tables —
            # every entry decoded before the truncation point is whole
            # and usable; the tail simply re-streams
            L.debug("checkpoint meta decode stopped early "
                    "(prefix entries kept): %s", e)
        # per-run counters (reported into the resumed run's manifest)
        self.files_skipped = 0
        self.bytes_skipped = 0
        self.files_reread = 0
        self.bytes_reread = 0

    def __len__(self) -> int:
        return len(self._files)

    def skip_ref(self, path: str, size: int, mtime_ns: int):
        """The checkpoint's Entry for ``path`` when it can be spliced
        without re-reading its data (callers carry its ``digest`` and
        ``payload_offset`` into ``write_entry_ref``, exactly like the
        mount commit engine's previous-archive refs); None = re-stream."""
        e = self._files.get(path)
        if e is None or not size:
            return None
        if e.size != size or e.mtime_ns != mtime_ns:
            return None
        self.files_skipped += 1
        self.bytes_skipped += size
        METRICS.inc("files_skipped")
        METRICS.inc("bytes_skipped", size)
        return e

    def note_reread(self, nbytes: int, *, files: int = 0) -> None:
        """Bytes the resumed run did pull from the agent (the tail)."""
        self.bytes_reread += nbytes
        self.files_reread += files
        METRICS.inc("bytes_reread", nbytes)
        if files:
            METRICS.inc("files_reread", files)

    def summary(self) -> dict:
        return {"checkpoint": os.path.basename(self.checkpoint.path),
                "hwm": self.hwm,
                "files_skipped": self.files_skipped,
                "bytes_skipped": self.bytes_skipped,
                "files_reread": self.files_reread,
                "bytes_reread": self.bytes_reread}


def open_resume(store, *, backup_type: str, backup_id: str,
                namespace: str = "") -> tuple[SplitReader, ResumePlan] | None:
    """Resume context for ``store.start_session(previous_reader=...)``:
    (SplitReader over the newest valid checkpoint, ResumePlan), or None
    when there is nothing to resume.  A checkpoint superseded by a
    published snapshot is ignored — dedup against that snapshot is
    strictly better."""
    ds = getattr(store, "datastore", None)
    if ds is None:
        return None
    ck = load_latest(ds, backup_type, backup_id, namespace,
                     params=store.params)
    if ck is None:
        return None
    last = ds.last_snapshot(backup_type, backup_id, namespace)
    if last is not None:
        try:
            man = ds.load_manifest(last)
        except (OSError, ValueError) as e:
            L.debug("manifest unreadable while resolving resume "
                    "supersession for %s: %s", last, e)
            man = {}
        # manifest created_unix is second-truncated — compare at second
        # granularity so a publish in the same second still supersedes
        if man.get("created_unix", 0) >= int(ck.state.get("created_unix",
                                                          0)):
            return None
    from ..pxar import chunkcache
    reader = SplitReader(ck.midx, ck.pidx, ds.chunks,
                         cache=chunkcache.shared_cache())
    plan = ResumePlan(ck, reader)
    METRICS.inc("resumes")
    L.info("resuming %s/%s from checkpoint %s: %d skippable files "
           "(hwm=%r)", backup_type, backup_id,
           os.path.basename(ck.path), len(plan), plan.hwm)
    return reader, plan


def clear(ds: Datastore, backup_type: str, backup_id: str,
          namespace: str = "") -> bool:
    """Remove the group's checkpoints (a published snapshot supersedes
    them).  Returns True when something was removed."""
    ref = SnapshotRef(backup_type, backup_id, "x", namespace)
    ckdir = group_ckpt_dir(ds, ref)
    if not os.path.isdir(ckdir):
        return False
    shutil.rmtree(ckdir, ignore_errors=True)
    return True


# -- GC integration (server/prune.py) ---------------------------------------

def iter_group_ckpt_dirs(ds: Datastore):
    """Yield (namespace, backup_type, backup_id, ckpt_dir_path) for every
    group with a checkpoint dir, across all namespaces."""
    for ns in ds.namespaces():
        base = ds._ns_base(ns)
        for t in BACKUP_TYPES:
            tdir = os.path.join(base, t)
            if not os.path.isdir(tdir):
                continue
            for bid in sorted(os.listdir(tdir)):
                ckdir = os.path.join(tdir, bid, CKPT_DIR)
                if os.path.isdir(ckdir):
                    yield ns, t, bid, ckdir


def live_checkpoint_digests(ds: Datastore) -> set[bytes]:
    """Every chunk digest referenced by any live checkpoint — prune's
    mark phase must touch these, or GC would sweep the very chunks a
    crashed job's resume is about to splice."""
    out: set[bytes] = set()
    for _ns, _t, _b, ckdir in iter_group_ckpt_dirs(ds):
        for name in os.listdir(ckdir):
            if not name.startswith("ck-"):
                continue
            for idx_name in (META_IDX, PAYLOAD_IDX):
                p = os.path.join(ckdir, name, idx_name)
                try:
                    idx = DynamicIndex.parse(p)
                except (OSError, ValueError) as e:
                    L.warning("GC mark: unreadable checkpoint index %s: %s",
                              p, e)
                    continue
                for i in range(len(idx)):
                    out.add(idx.digest(i))
    return out


def sweep_stale(ds: Datastore, *, max_age_s: float = CKPT_MAX_AGE_S,
                now: float | None = None) -> int:
    """Reap checkpoints that can never be resumed: superseded by a newer
    published snapshot of their group, unreadable, older than
    ``max_age_s``, or a non-newest seq / torn tmp dir.  Returns the
    number of checkpoint dirs removed (run by prune BEFORE the mark
    phase, so swept checkpoints no longer protect chunks)."""
    now = time.time() if now is None else now
    removed = 0
    for ns, t, bid, ckdir in iter_group_ckpt_dirs(ds):
        newest_snap = 0.0
        last = ds.last_snapshot(t, bid, ns)
        if last is not None:
            try:
                newest_snap = float(
                    ds.load_manifest(last).get("created_unix", 0))
            except (OSError, ValueError) as e:
                L.debug("sweep_stale: manifest unreadable for %s: %s",
                        last, e)
        names = sorted((n for n in os.listdir(ckdir)
                        if n.startswith("ck-")), key=_seq_of)
        keep_seqs = {_seq_of(names[-1])} if names else set()
        if names:
            # the newest checkpoint may belong to an in-flight RESUMED
            # session — its resume-source checkpoint must survive too
            # (it alone GC-protects the plan's not-yet-spliced files)
            try:
                with open(os.path.join(ckdir, names[-1],
                                       STATE_JSON)) as f:
                    keep_seqs.add(int(json.load(f).get("resumed_from",
                                                       -1)))
            except (OSError, ValueError) as e:
                L.debug("sweep_stale: newest checkpoint state "
                        "unreadable in %s: %s", ckdir, e)
        for name in os.listdir(ckdir):
            p = os.path.join(ckdir, name)
            reason = ""
            if name.startswith(".tmp-"):
                # age-gated: a fresh .tmp dir may be a LIVE flush racing
                # this sweep (cross-process prune) — only a torn write
                # sits untouched for an hour
                try:
                    if now - os.stat(p).st_mtime < _TMP_TTL_S:
                        continue
                except OSError:
                    continue       # vanished mid-scan (flush renamed it)
                reason = "torn checkpoint write"
            elif not name.startswith("ck-"):
                continue
            else:
                try:
                    with open(os.path.join(p, STATE_JSON)) as f:
                        created = float(json.load(f).get("created_unix", 0))
                except (OSError, ValueError):
                    created = 0.0
                    reason = "unreadable state"
                if not reason and _seq_of(name) not in keep_seqs:
                    reason = "superseded by a newer checkpoint"
                # manifest created_unix is second-truncated: compare at
                # second granularity (same-second publish supersedes)
                if not reason and newest_snap and \
                        int(created) <= newest_snap:
                    reason = "superseded by a published snapshot"
                if not reason and now - created > max_age_s:
                    reason = f"older than {max_age_s:.0f}s"
            if reason:
                shutil.rmtree(p, ignore_errors=True)
                removed += 1
                L.info("swept stale checkpoint %s (%s)", p, reason)
        try:
            if not os.listdir(ckdir):
                os.rmdir(ckdir)
        except OSError as e:
            L.debug("could not remove empty checkpoint dir %s: %s",
                    ckdir, e)
    if removed:
        METRICS.inc("swept", removed)
    return removed
