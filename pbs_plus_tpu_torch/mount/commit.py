"""The commit engine — dedup re-snapshot of a mutated mount.

Reference: internal/pxarmount/commit_orchestrate.go:28-562 +
commit_walk.go + commit_reuse.go (SURVEY §3.4) — six phases:

  1 freeze    mutation barrier + journal sync
  2 prepare   open a session against the store with PreviousBackupRef
  3 walk      two-pointer merge of journal edges × archive dirents in DFS
              order; unchanged files → WriteEntryRef (payload-offset
              ordered runs coalesce into whole-chunk reuse; out-of-order
              refs re-encode boundaries); changed files stream from the
              passthrough dir
  4 upload    writer.finish / session publish (only new chunks land)
  5 verify    re-hash passthrough-backed files vs what was written
              (reference: xxh3 pool ≤16 workers; here one batched device
              sha256 dispatch via VerifyPipeline)
  6 swap      open the new snapshot, clear the journal, HotSwap the
              archive view, wipe the passthrough dir

Crash safety: the store session publishes atomically at phase 4; a crash
anywhere leaves the old archive serving and the journal intact.

A copy of the JAX package's ``mount/commit.py``, its code byte for byte
apart from its imports, which name the port's own modules (the lazy ones
too: the chunk cache both the mounted view and the session's previous
reader share is the port's ``chunkcache.shared_cache()``), its logger
(``logging``), and one change: ``CommitEngine`` takes ``device=``
(default ``"cuda"``; raises without a card, ``"cpu"`` runs the plain
versions), and its verify re-hashes the changed files with the port's
``VerifyPipeline`` on that device, K2 on the card.  The store it commits
to carries its own device: a port ``LocalStore(device=)`` cuts the
changed files and the meta stream with K1, digests the new chunks with
K2 and probes its index with K3.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..models.verify import VerifyPipeline
from ..pxar.backupproxy import LocalStore
from ..pxar.datastore import SnapshotRef
from ..pxar.format import Entry, KIND_DIR, KIND_FILE
from ..pxar.transfer import SplitReader
from ..utils.device import resolve
from .journal import Node, ROOT_ID
from .mutablefs import MutableFS

L = logging.getLogger(__name__)

ProgressFn = Callable[[str, dict], None]


@dataclass
class CommitProgress:
    phase: str = "idle"
    entries: int = 0
    ref_files: int = 0
    changed_files: int = 0
    verified: int = 0
    snapshot: str = ""
    listeners: list[ProgressFn] = field(default_factory=list)

    def emit(self, phase: str, **kw) -> None:
        self.phase = phase
        for fn in list(self.listeners):
            try:
                fn(phase, {**kw, "entries": self.entries})
            except Exception as e:
                L.warning("progress listener raised in phase %s: %s",
                          phase, e)


class CommitEngine:
    def __init__(self, fs: MutableFS, store: LocalStore, *,
                 backup_type: str = "host", backup_id: str = "mount",
                 previous: SnapshotRef | None = None, device="cuda"):
        # the verify's device: K2 re-hashes the changed files there
        self.device = resolve(device)
        self.fs = fs
        self.store = store
        self.backup_type = backup_type
        self.backup_id = backup_id
        self.previous = previous
        self.progress = CommitProgress()

    # -- phase 3: the merged walk -----------------------------------------
    def _walk(self, writer, prev_entries: dict[str, Entry],
              node: Node, arch: Optional[str], rel: str) -> None:
        j = self.fs.journal
        edge_map = dict(j.edges(node.id))
        white = j.whiteouts(node.id)
        arch_children: dict[str, Entry] = {}
        if arch is not None:
            try:
                for e in self.fs.view.read_dir(arch):
                    arch_children[e.name] = e
            except FileNotFoundError:
                pass
        # two-pointer merge over the sorted union of names
        for name in sorted(set(edge_map) | (set(arch_children) - white)):
            child_rel = f"{rel}/{name}" if rel else name
            if name in edge_map:
                child = j.get_node(edge_map[name])
                assert child is not None
                self._emit_journal_child(writer, prev_entries, child,
                                         child_rel)
            else:
                self._emit_archive_subtree(writer, prev_entries,
                                           arch_children[name], child_rel)

    def _entry_from_node(self, n: Node, rel: str) -> Entry:
        return Entry(path=rel, kind=n.kind, mode=n.mode, uid=n.uid,
                     gid=n.gid, mtime_ns=n.mtime_ns, size=n.size,
                     link_target=n.link_target,
                     xattrs=self.fs.journal.xattrs(n.id))

    def _emit_journal_child(self, writer, prev_entries, n: Node,
                            rel: str) -> None:
        self.progress.entries += 1
        if n.kind == KIND_DIR:
            writer.write_entry(self._entry_from_node(n, rel))
            self._walk(writer, prev_entries, n, n.base_path, rel)
        elif n.kind == KIND_FILE:
            e = self._entry_from_node(n, rel)
            if n.content_path:
                # changed/new content: stream from the passthrough dir
                p = os.path.join(self.fs.passthrough, n.content_path)
                with open(p, "rb") as f:
                    d = writer.write_entry_reader(e, f)
                self.progress.changed_files += 1
                self._changed_paths.append(rel)
                self._changed_digests[rel] = d
            elif n.base_path is not None:
                self._ref_or_reencode(writer, prev_entries, e, n.base_path)
            else:
                e.size = 0
                writer.write_entry(e)
        else:
            writer.write_entry(self._entry_from_node(n, rel))

    def _emit_archive_subtree(self, writer, prev_entries, e: Entry,
                              rel: str) -> None:
        """Entire subtree unchanged — dirs recurse, files become refs."""
        self.progress.entries += 1
        out = Entry(**{**e.__dict__})
        out.path = rel
        if e.is_dir:
            writer.write_entry(out)
            for child in self.fs.view.read_dir(e.path):
                self._emit_archive_subtree(writer, prev_entries, child,
                                           f"{rel}/{child.name}" if rel
                                           else child.name)
        elif e.is_file:
            self._ref_or_reencode(writer, prev_entries, out, e.path)
        else:
            writer.write_entry(out)

    def _ref_or_reencode(self, writer, prev_entries, e: Entry,
                         arch_path: str) -> None:
        src = prev_entries.get(arch_path)
        if src is not None and src.is_file and src.payload_offset >= 0:
            e.digest = src.digest
            writer.write_entry_ref(e, src.payload_offset, src.size)
            self.progress.ref_files += 1
        else:
            # no payload in the previous archive (empty file or anomaly)
            if src is not None and src.size == 0:
                e.size = 0
                writer.write_entry(e)
            else:
                data = self.fs.view.read_file(
                    self.fs.view.lookup(arch_path))  # type: ignore[arg-type]
                import io
                d = writer.write_entry_reader(e, io.BytesIO(data))
                self.progress.changed_files += 1
                self._changed_paths.append(e.path)
                self._changed_digests[e.path] = d

    # -- the commit --------------------------------------------------------
    def commit(self) -> SnapshotRef:
        t0 = time.time()
        fs = self.fs
        prog = self.progress
        prog.emit("freeze")
        fs.freeze()
        try:
            fs.journal.sync()
            problems = fs.journal.verify_integrity()
            if problems:
                raise RuntimeError(f"journal integrity: {problems[:5]}")

            prog.emit("prepare")
            # the previous-snapshot reader re-reads chunks the mounted
            # view already served — share the process cache instead of
            # letting the session open a private 256 MiB one (the FUSE
            # plane's reads all go through chunkcache.shared_cache())
            from ..pxar import chunkcache
            session = self.store.start_session(
                backup_type=self.backup_type, backup_id=self.backup_id,
                previous=self.previous,
                previous_cache=chunkcache.shared_cache(),
                namespace=(self.previous.namespace or None)
                if self.previous else None)
            prev_entries: dict[str, Entry] = {}
            if session.previous_reader is not None:
                prev_entries = {e.path: e
                                for e in session.previous_reader.entries()}
            try:
                prog.emit("walk")
                self._changed_paths = []
                # write-time digests: pxar2 archives carry none in the
                # meta stream, so post-publish verify needs them here
                self._changed_digests = {}
                root = fs.journal.get_node(ROOT_ID)
                assert root is not None
                session.writer.write_entry(self._entry_from_node(root, ""))
                prog.entries += 1
                self._walk(session.writer, prev_entries, root,
                           root.base_path, "")

                # verify runs via the pre-publish hook: a failure aborts the
                # staging dir and the datastore never sees the bad snapshot
                prog.emit("upload")

                def _pre_publish_verify(reader):
                    prog.emit("verify")
                    self._verify(reader)

                # stores without readable pre-publish staging (PBS wire:
                # chunk uploads are digest-verified server-side) verify
                # post-publish through the reader instead
                pre_verify = getattr(session, "supports_verify_hook", True)
                manifest = session.finish(
                    {"commit": True,
                     "journal": fs.journal.stats()},
                    verify_hook=_pre_publish_verify if pre_verify else None)
            except BaseException:
                session.abort()
                raise

            new_ref = session.ref
            # the hot-swapped view serves FUSE reads — share the process
            # cache so the post-commit re-read of just-written chunks hits
            from ..pxar import chunkcache
            reader = self.store.open_snapshot(
                new_ref, cache=chunkcache.shared_cache())
            if not pre_verify:
                prog.emit("verify")
                try:
                    self._verify(reader)   # post-publish, same discipline
                except BaseException:
                    # the bad snapshot is already published — delete it so
                    # it can never become the next backup's splice base
                    L.error("post-publish verify FAILED for %s — deleting "
                            "the published snapshot", new_ref)
                    close = getattr(reader.store, "close", None)
                    if close is not None:
                        close()
                    delete = getattr(self.store, "delete_snapshot", None)
                    if delete is not None:
                        try:
                            delete(new_ref)
                        except Exception as de:
                            L.error("could not delete bad snapshot %s: %s",
                                    new_ref, de)
                    raise

            prog.emit("swap")
            # readers are also excluded by the freeze barrier (read paths
            # participate in op accounting), so the journal-clear/hot-swap
            # pair is not observable half-done
            fs.view.hot_swap(reader)
            fs.journal.clear()
            for name in os.listdir(fs.passthrough):
                p = os.path.join(fs.passthrough, name)
                try:
                    if os.path.isdir(p) and not os.path.islink(p):
                        shutil.rmtree(p)
                    else:
                        os.unlink(p)
                except OSError:
                    pass
            prog.snapshot = str(new_ref)
            prog.emit("done", snapshot=str(new_ref),
                      seconds=round(time.time() - t0, 3))
            L.info("commit done: %s (%d entries, %d refs, %d changed, %.2fs)",
                   new_ref, prog.entries, prog.ref_files,
                   prog.changed_files, time.time() - t0)
            self.previous = new_ref
            return new_ref
        finally:
            fs.unfreeze()

    # verify dispatch ceiling: files are re-hashed in device batches of at
    # most this many bytes, so commit memory stays bounded no matter how
    # large the changed set is (reference: commit_memory_test's B-series
    # pins the same property on the Go engine)
    VERIFY_BATCH_BYTES = 32 << 20

    def _verify(self, reader: SplitReader) -> None:
        """Re-hash the files this commit wrote (changed/new content) against
        their recorded digests (reference: verifyBackedFileHashes — only
        passthrough-backed files, so commit cost stays O(changed bytes),
        with peak memory bounded by VERIFY_BATCH_BYTES per dispatch)."""
        changed = set(getattr(self, "_changed_paths", []))
        digests = getattr(self, "_changed_digests", {})
        vp = VerifyPipeline(device=self.device)
        entries = []
        for e in reader.entries():
            if not (e.is_file and e.size and e.path in changed):
                continue
            # the archive entry's digest when present (tpxar), else the
            # digest recorded at write time (pxar2 has no digest field)
            e.digest = e.digest or digests.get(e.path, b"")
            if e.digest:
                entries.append(e)
        # verify reads every changed chunk exactly once — the reader's
        # big serving cache would just retain them all; cap it for the
        # duration so commit peak stays ~2x the batch ceiling
        cache = getattr(reader, "_cache", None)
        saved_cap = getattr(cache, "max_bytes", None)
        if cache is not None and saved_cap is not None:
            cache.max_bytes = min(saved_cap, self.VERIFY_BATCH_BYTES)
        try:
            self._verify_entries(vp, reader, entries)
        finally:
            if cache is not None and saved_cap is not None:
                cache.max_bytes = saved_cap

    def _verify_entries(self, vp, reader, entries) -> None:
        checked = 0
        corrupt: list[str] = []
        batch: list = []
        batch_bytes = 0

        def flush():
            nonlocal checked, batch, batch_bytes
            if not batch:
                return
            chunks = [reader.read_file(e) for e in batch]
            res = vp.verify_chunks(chunks, [e.digest for e in batch])
            checked += res.checked
            corrupt.extend(batch[i].path for i in res.corrupt)
            batch, batch_bytes = [], 0

        for e in entries:
            if e.size > self.VERIFY_BATCH_BYTES:
                # a single over-ceiling file is stream-hashed on the
                # host in bounded blocks instead of materializing whole
                h = hashlib.sha256()
                off = 0
                blk = min(8 << 20, self.VERIFY_BATCH_BYTES)
                while off < e.size:
                    block = reader.read_file(e, off, blk)
                    if not block:
                        break
                    h.update(block)
                    off += len(block)
                checked += 1
                if h.digest() != e.digest:
                    corrupt.append(e.path)
                continue
            batch.append(e)
            batch_bytes += e.size
            if batch_bytes >= self.VERIFY_BATCH_BYTES:
                flush()
        flush()
        self.progress.verified = checked
        if corrupt:
            raise RuntimeError(
                f"commit verification failed for {len(corrupt)} files")
