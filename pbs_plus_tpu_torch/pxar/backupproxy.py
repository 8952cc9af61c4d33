"""Backup session backends: LocalStore (PBS-less) and the session protocol.

Reference capability: pxar ``backupproxy`` — ``NewPBSStore(...)`` /
``NewLocalStore(dir, buzhashCfg, bool)`` → ``StartSession(BackupConfig)`` →
``BackupSession.Finish``; ``PreviousBackupRef`` links incremental dedup
(consumed at internal/pxarmount/commit_orchestrate.go:127-163
and the key test fake at
internal/pxarmount/commit_walk_test.go:25-37).

LocalStore is the test/dev backend: a datastore directory on local disk.
Snapshots publish atomically — writers build into a ``.tmp`` dir that is
renamed into place at ``finish()``, so a crashed upload never leaves a
half-snapshot visible (crash-safety rule from SURVEY §5.3).

A copy of the JAX package's ``pxar/backupproxy.py``, its code byte for
byte apart from its imports, which name the port's own modules, its
logger (``logging``), and one change: ``LocalStore`` takes ``device=``
(default ``"cuda"``) for its datastore, and with no ``chunker_factory``
given builds the port's ``"cuda"`` chunker and batch hasher on that
device (the reference's defaults are its CPU chunker and inline
hashlib; the port's CPU kinds are ``server/backup_job.py``'s, passed
as a factory with no batch hasher); ``ingest_collector()``
returns the port's ``collector_for`` on the same device."""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
import os
import shutil
import time
from dataclasses import dataclass

from ..chunker import ChunkerParams
from ..models.backends import make_batch_hasher, make_chunker_factory
from ..utils import atomicio, validate
from ..utils.device import resolve
from .datastore import (
    Datastore, SnapshotRef, format_backup_time, parse_backup_type,
)
from .transfer import (
    ChunkerFactory, DedupWriter, SplitReader, write_manifest,
)

L = logging.getLogger(__name__)


@dataclass(frozen=True)
class PreviousBackupRef:
    ref: SnapshotRef


class BackupSession:
    """One backup run: exposes a DedupWriter, publishes on finish.

    ``previous_reader`` overrides the snapshot-backed previous with a
    caller-supplied SplitReader — the checkpoint-resume path
    (server/checkpoint.py) feeds the crashed run's committed prefix here
    so unchanged entries splice via ``write_entry_ref``.  ``resume_plan``
    is the matching fast-skip plan, consumed by the walkers
    (pxar/walker.py, server/backup_job.py)."""

    resume_plan = None          # set by the checkpoint-resume wiring

    def __init__(self, store: "LocalStore", ref: SnapshotRef,
                 previous: SnapshotRef | None,
                 chunker_factory: ChunkerFactory,
                 pipeline_workers: int | None = None,
                 previous_reader: SplitReader | None = None,
                 previous_cache=None):
        self.store = store
        self.ref = ref
        self.previous_ref = previous
        self._prev_reader: SplitReader | None = previous_reader
        if previous is not None and previous_reader is None:
            # previous_cache lets long-lived callers (the FUSE commit
            # plane) share the process chunk cache instead of paying a
            # private 256 MiB one per session; None keeps the isolated
            # default
            self._prev_reader = SplitReader.open_snapshot(
                store.datastore, previous, cache=previous_cache)
        self.writer = DedupWriter(
            store.datastore.chunks,
            previous=self._prev_reader,
            payload_params=store.params,
            chunker_factory=chunker_factory,
            batch_hasher=store.batch_hasher,
            pipeline_workers=(getattr(store, "pipeline_workers", 0)
                              if pipeline_workers is None
                              else pipeline_workers),
            # cross-session fused ingest: one collector per chunk store
            # = one batching domain shared by every concurrent session
            # (pxar/ingestbatch.py; PBS_PLUS_FUSED_INGEST)
            ingest_collector=store.ingest_collector(),
            # PBS layout ⇒ stock pxar v2 entries so PBS tools can decode
            # the archive content too, not just serve its chunks/indexes
            entry_codec="pxar2" if store.datastore.pbs_format else "tpxar",
        )
        try:
            store.datastore.ensure_group_dir(ref)   # ns chain (PBS chown 34)
            self._final_dir = store.datastore.snapshot_dir(ref)
            # unique staging dir: concurrent same-second sessions must
            # never share (or rmtree) each other's in-progress state
            self._tmp_dir = f"{self._final_dir}.tmp.{os.getpid()}." \
                            f"{id(self):x}"
            os.makedirs(self._tmp_dir)
        except BaseException:
            # the writer may hold pipeline threads and a fused-ingest
            # collector registration (process-lifetime) — a failed
            # session open must release both, not leak them
            try:
                self.writer.close()
            except Exception as e:
                L.debug("writer close during failed session open: %s", e)
            raise
        self._done = False

    @property
    def previous_reader(self) -> SplitReader | None:
        return self._prev_reader

    def finish(self, extra_manifest: dict | None = None, *,
               verify_hook=None) -> dict:
        """Flush writers, write indexes + manifest, publish atomically.
        ``verify_hook(reader)`` runs against the staged (pre-publish)
        snapshot — raising there aborts the staging dir, so a corrupt
        snapshot is never published.  On failure the staging dir is removed
        and the session is dead — the datastore never sees a half-snapshot."""
        if self._done:
            raise RuntimeError("session already finished")
        try:
            midx, pidx, stats = self.writer.finish()
            ds = self.store.datastore
            fmt = "pbs" if ds.pbs_format else "tpxd"
            midx.write(os.path.join(self._tmp_dir, ds.meta_idx_name),
                       fmt=fmt)
            pidx.write(os.path.join(self._tmp_dir, ds.payload_idx_name),
                       fmt=fmt)
            if verify_hook is not None:
                verify_hook(SplitReader(midx, pidx, ds.chunks))
            # same-second concurrent sessions: re-check the final dir at
            # publish time and bump +1 s until free
            while os.path.exists(self._final_dir):
                t = _dt.datetime.strptime(
                    self.ref.backup_time, "%Y-%m-%dT%H:%M:%SZ"
                ).replace(tzinfo=_dt.timezone.utc).timestamp() + 1.0
                self.ref = dataclasses.replace(
                    self.ref, backup_time=format_backup_time(t))
                self._final_dir = ds.snapshot_dir(self.ref)
            # per-session bound-backend label (pinned at stream open by
            # _ChunkedStream; the payload stream is the one every file
            # byte flows through)
            extra = dict(extra_manifest or {})
            extra.setdefault("chunker_backend",
                             getattr(self.writer.payload, "bound_backend",
                                     ""))
            manifest = write_manifest(
                os.path.join(self._tmp_dir, ds.MANIFEST),
                ref=self.ref, midx=midx, pidx=pidx, stats=stats,
                payload_params=self.store.params,
                entry_count=self.writer.entry_count,
                previous=str(self.previous_ref) if self.previous_ref else None,
                extra=extra,
            )
            if ds.pbs_format:
                self._write_pbs_manifest(ds, midx, pidx)
            os.makedirs(os.path.dirname(self._final_dir), exist_ok=True)
            atomicio.publish_staged(self._tmp_dir, self._final_dir)
        except BaseException:
            self._done = True
            try:
                self.writer.close()    # reap pipeline threads; _done=True
            except Exception as e:     # makes a later abort() a no-op
                L.debug("writer close during failed publish: %s", e)
            shutil.rmtree(self._tmp_dir, ignore_errors=True)
            raise
        self._done = True
        return manifest

    def _write_pbs_manifest(self, ds, midx, pidx) -> None:
        """index.json.blob in the PBS manifest schema, alongside the
        internal manifest (a stock PBS lists snapshots off this file)."""
        from .pbsformat import blob_encode, index_file_csum, manifest_json
        files = []
        for name, idx in ((ds.meta_idx_name, midx),
                          (ds.payload_idx_name, pidx)):
            with open(os.path.join(self._tmp_dir, name), "rb") as f:
                data = f.read()
            files.append({"filename": name, "size": idx.total_size,
                          "csum": index_file_csum(data).hex(),
                          "crypt-mode": "none"})
        t = _dt.datetime.strptime(
            self.ref.backup_time, "%Y-%m-%dT%H:%M:%SZ"
        ).replace(tzinfo=_dt.timezone.utc).timestamp()
        doc = manifest_json(self.ref.backup_type, self.ref.backup_id,
                            int(t), files)
        atomicio.write_bytes(os.path.join(self._tmp_dir, ds.MANIFEST_PBS),
                             blob_encode(doc))

    def abort(self) -> None:
        if not self._done:
            self._done = True
            try:
                self.writer.close()    # park pipeline pool + committer
            except Exception as e:
                L.debug("writer close during abort: %s", e)
            shutil.rmtree(self._tmp_dir, ignore_errors=True)


class LocalStore:
    """PBS-less datastore-backed session source (reference:
    backupproxy.NewLocalStore).

    ``device`` (default ``"cuda"``; raises without a card, ``"cpu"``
    runs the plain versions) carries the whole write path: the chunk
    store's index probes there (K3), and unless the caller passes its
    own chunker factory, sessions cut with the port's ``"cuda"`` chunker
    (K1) and digest with its ``"cuda"`` batch hasher (K2) on it; a
    caller's factory without a batch hasher (the CPU and sidecar kinds)
    digests inline with hashlib, as the reference's stores do."""

    def __init__(self, base_dir: str, params: ChunkerParams, *,
                 chunker_factory: "ChunkerFactory | None" = None,
                 batch_hasher=None, pbs_format: bool = False,
                 pipeline_workers: int = 0,
                 store_shards: "int | None" = None,
                 dedup_index_mb: "int | None" = None,
                 dedup_resident_mb: "int | None" = None,
                 delta_tier: "bool | None" = None,
                 delta_threshold: "int | None" = None,
                 delta_max_chain: "int | None" = None,
                 fused_ingest: "bool | None" = None,
                 shared_instance: "str | None" = None,
                 device="cuda"):
        self.device = resolve(device)
        self.datastore = Datastore(base_dir, pbs_format=pbs_format,
                                   store_shards=store_shards,
                                   dedup_index_mb=dedup_index_mb,
                                   dedup_resident_mb=dedup_resident_mb,
                                   delta_tier=delta_tier,
                                   delta_threshold=delta_threshold,
                                   delta_max_chain=delta_max_chain,
                                   shared_instance=shared_instance,
                                   device=self.device)
        self.params = params
        if chunker_factory is None:
            chunker_factory = make_chunker_factory("cuda",
                                                   device=self.device)
            if batch_hasher is None:
                batch_hasher = make_batch_hasher("cuda", device=self.device)
        self._chunker_factory = chunker_factory
        self.batch_hasher = batch_hasher
        # >=1 pipelines each session's payload stream (pxar/pipeline.py);
        # 0 keeps the sequential writer (cut/digest output is identical)
        self.pipeline_workers = pipeline_workers
        if fused_ingest is None:
            from ..utils import conf as _conf
            fused_ingest = _conf.env().fused_ingest
        self.fused_ingest = bool(fused_ingest)

    def ingest_collector(self):
        """The store-wide cross-session fused-ingest collector, or None
        when the fused path is disabled (pxar/ingestbatch.py)."""
        if not self.fused_ingest:
            return None
        from .ingestbatch import collector_for
        return collector_for(self.datastore.chunks, device=self.device)

    def start_session(self, *, backup_type: str, backup_id: str,
                      backup_time: float | None = None,
                      previous: SnapshotRef | PreviousBackupRef | None = None,
                      auto_previous: bool = True,
                      namespace: str | None = None,
                      pipeline_workers: int | None = None,
                      previous_reader=None,
                      previous_cache=None) -> BackupSession:
        """Open a session.  ``previous`` enables ref-dedup against that
        snapshot; by default the latest snapshot of the same group (same
        ``namespace``) is used.  ``previous_reader`` (a SplitReader)
        overrides both — the checkpoint-resume path, which embeds any
        prior snapshot's reuse in its own indexes.  Same-second
        collisions bump the timestamp +1 s (reference behavior,
        internal/pxarmount/commit_orchestrate.go: same-second
        commits bump timestamp)."""
        parse_backup_type(backup_type)
        # mint-time guard: the id becomes a datastore path component and a
        # later parse_snapshot_ref must accept it — reject traversal and
        # argv-unsafe ids HERE so no unreachable snapshot can be created
        validate.snapshot_component(backup_id)
        namespace = namespace or ""     # callers may pass None for root
        validate.namespace_path(namespace)
        if isinstance(previous, PreviousBackupRef):
            previous = previous.ref
        if previous_reader is not None:
            previous, auto_previous = None, False
        if previous is None and auto_previous:
            previous = self.datastore.last_snapshot(backup_type, backup_id,
                                                    namespace)
        if previous is not None:
            # refuse ref-dedup across chunk-format/param changes — cuts
            # would not line up and the link would silently destroy dedup
            try:
                man = self.datastore.load_manifest(previous)
                ch = man.get("chunker", {})
                from ..chunker import spec as _spec
                if (ch.get("format", _spec.CHUNK_FORMAT) != _spec.CHUNK_FORMAT
                        or ch.get("avg") != self.params.avg_size
                        or ch.get("seed") != self.params.seed):
                    L.warning("previous snapshot %s uses a different chunk "
                              "format/params; starting a full backup", previous)
                    previous = None
            except OSError:
                previous = None
        t = backup_time if backup_time is not None else time.time()
        ref = SnapshotRef(backup_type, backup_id, format_backup_time(t),
                          namespace)
        while os.path.exists(self.datastore.snapshot_dir(ref)):
            t += 1.0
            ref = dataclasses.replace(ref,
                                      backup_time=format_backup_time(t))
        return BackupSession(self, ref, previous, self._chunker_factory,
                             pipeline_workers=pipeline_workers,
                             previous_reader=previous_reader,
                             previous_cache=previous_cache)

    def open_snapshot(self, ref: SnapshotRef, **kw) -> SplitReader:
        return SplitReader.open_snapshot(self.datastore, ref, **kw)
