"""Agent-side restore engine: pull archive content from the server's
remote-archive service and materialize files locally.

Reference: internal/pxar/restore.go:22-107 (worker-pooled file writes,
metadata application, sha256 verify), restore_unix.go (chmod/chown/utimes/
xattrs), hardlink.go.  The pull loop is DFS over pxar.read_dir with ranged
raw-stream reads (SURVEY §3.3 hot loop).

A copy of the JAX package's ``agent/restore.py``, its code byte for
byte apart from its logger (``logging``); on ``os.name == "nt"`` the
metadata applier is the port's own ``agent/win/restore.py``.  Every
restored file is checked with ``hashlib`` against its entry's SHA-256
(``Entry.digest``, written by the backup's K2 on the card).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import shutil
import stat as statmod
from dataclasses import dataclass, field

from ..pxar.format import (
    Entry, KIND_BLOCKDEV, KIND_DEVICE, KIND_DIR, KIND_FIFO, KIND_FILE,
    KIND_HARDLINK, KIND_SOCKET, KIND_SYMLINK,
)
from ..pxar.remote import RemoteArchiveClient
L = logging.getLogger(__name__)

READ_BLOCK = 8 << 20


@dataclass
class RestoreResult:
    entries: int = 0
    files: int = 0
    bytes: int = 0
    verified: int = 0
    errors: list[str] = field(default_factory=list)


class RestoreEngine:
    def __init__(self, client: RemoteArchiveClient, dest: str, *,
                 verify: bool = True, apply_ownership: bool | None = None,
                 win_meta=None, workers: int = 8):
        self.c = client
        self.dest = os.path.abspath(dest)
        self.verify = verify
        # chown needs root; default to trying only when euid == 0
        # (no euid on Windows — ownership rides the SDDL there)
        if apply_ownership is None:
            apply_ownership = getattr(os, "geteuid", lambda: -1)() == 0
        self.apply_ownership = apply_ownership
        # Windows metadata applier (restore_windows.go analog): active on
        # win32, injectable everywhere for the seam tests
        if win_meta is None and os.name == "nt":  # pragma: no cover
            from .win.restore import WinMetaApplier
            win_meta = WinMetaApplier()
        self.win_meta = win_meta
        self.result = RestoreResult()
        self._hardlinks: list[tuple[str, str]] = []
        self._dir_meta: list[tuple[str, Entry]] = []
        # worker-pooled file pulls (reference: restore.go:22-107 — the
        # pull loop is RPC-latency-bound on trees of small files; ranged
        # reads for different files ride concurrent mux streams)
        self._sem = asyncio.Semaphore(max(1, workers))
        self._file_tasks: list[asyncio.Task] = []
        self._peak_inflight = 0        # test/telemetry probe
        self._inflight = 0

    @staticmethod
    def _clear_conflict(path: str) -> None:
        """Remove whatever occupies ``path`` so the archive's node kind
        wins — including a conflicting directory tree (restore is
        authoritative for the destination, like rsync with a changed
        entry type)."""
        if not os.path.lexists(path):
            return
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)

    def _target(self, rel: str) -> str:
        p = os.path.normpath(os.path.join(self.dest, rel)) if rel else self.dest
        if p != self.dest and not p.startswith(self.dest + os.sep):
            raise ValueError(f"entry escapes destination: {rel!r}")
        return p

    async def run(self) -> RestoreResult:
        try:
            return await self._run()
        except BaseException:
            # cancellation/crash mid-walk: the pool's detached tasks must
            # not keep writing into dest after the caller stopped us
            for t in self._file_tasks:
                t.cancel()
            await asyncio.gather(*self._file_tasks, return_exceptions=True)
            self._file_tasks.clear()
            raise

    async def _run(self) -> RestoreResult:
        root = await self.c.root()
        os.makedirs(self.dest, exist_ok=True)
        self._dir_meta.append((self.dest, root))
        await self._restore_dir("")
        # drain the file-worker pool before link/metadata phases
        for t in self._file_tasks:
            try:
                await t
            except Exception as ex:
                self.result.errors.append(f"{t.get_name()}: {ex}")
        self._file_tasks.clear()
        # hardlinks after all targets exist (follow_symlinks=False so a
        # hardlink TO a symlink links the symlink itself, not its target)
        for link_rel, target_rel in self._hardlinks:
            try:
                lp, tp = self._target(link_rel), self._target(target_rel)
                self._clear_conflict(lp)
                try:
                    os.link(tp, lp, follow_symlinks=False)
                except NotImplementedError:
                    # platform without the flag: plain link (follows a
                    # symlink target — best effort); real OSErrors must
                    # surface below, not silently change semantics
                    os.link(tp, lp)
            except OSError as e:
                self.result.errors.append(f"hardlink {link_rel}: {e}")
        # directory metadata deepest-first (mtimes would be clobbered by
        # child writes otherwise)
        for path, entry in sorted(self._dir_meta,
                                  key=lambda x: -x[0].count(os.sep)):
            self._apply_meta(path, entry)
        await self.c.done()
        return self.result

    async def _restore_dir(self, rel: str) -> None:
        try:
            entries = await self.c.read_dir(rel)
        except Exception as e:
            self.result.errors.append(f"{rel}: read_dir: {e}")
            return
        for e in entries:
            child = e.path
            try:
                await self._restore_entry(child, e)
            except Exception as ex:
                self.result.errors.append(f"{child}: {ex}")
            self.result.entries += 1

    async def _restore_entry(self, rel: str, e: Entry) -> None:
        path = self._target(rel)
        if e.kind == KIND_DIR:
            # conflicting non-dir (incl. a symlink TO a dir — keeping it
            # would alias writes outside this subtree) is replaced
            if os.path.lexists(path) and (
                    os.path.islink(path) or not os.path.isdir(path)):
                os.unlink(path)
            os.makedirs(path, exist_ok=True)
            self._dir_meta.append((path, e))
            await self._restore_dir(rel)
        elif e.kind == KIND_FILE:
            # schedule on the pool; the semaphore bounds real concurrency
            # and back-pressures the walk so tasks never pile unbounded
            await self._sem.acquire()
            try:
                task = asyncio.create_task(self._pull_file(rel, e, path),
                                           name=rel)
            except BaseException:
                # permit must not leak if task construction fails or the
                # coroutine is cancelled between acquire and create_task
                self._sem.release()
                raise
            self._file_tasks.append(task)
        elif e.kind == KIND_SYMLINK:
            self._clear_conflict(path)
            os.symlink(e.link_target, path)
            self._apply_meta(path, e, symlink=True)
        elif e.kind == KIND_HARDLINK:
            self._hardlinks.append((rel, e.link_target))
        elif e.kind == KIND_FIFO:
            self._clear_conflict(path)
            os.mkfifo(path, e.mode)
            self._apply_meta(path, e)
        elif e.kind in (KIND_SOCKET, KIND_DEVICE, KIND_BLOCKDEV):
            # recreate the node itself (rsync --specials/--devices parity);
            # device nodes need CAP_MKNOD — record the failure, don't abort
            ifmt = {KIND_SOCKET: statmod.S_IFSOCK,
                    KIND_DEVICE: statmod.S_IFCHR,
                    KIND_BLOCKDEV: statmod.S_IFBLK}[e.kind]
            try:
                self._clear_conflict(path)
                os.mknod(path, ifmt | e.mode, e.rdev)
                self._apply_meta(path, e)
            except OSError as ex:
                self.result.errors.append(f"{rel}: mknod: {ex}")

    async def _pull_file(self, rel: str, e: Entry, path: str) -> None:
        self._inflight += 1
        self._peak_inflight = max(self._peak_inflight, self._inflight)
        try:
            await self._restore_file(rel, e, path)
        finally:
            self._inflight -= 1
            self._sem.release()

    async def _restore_file(self, rel: str, e: Entry, path: str) -> None:
        h = hashlib.sha256() if (self.verify and e.digest) else None
        tmp = f"{path}.pbsplus-restore.tmp"
        try:
            with open(tmp, "wb") as f:
                off = 0
                while off < e.size:
                    block = await self.c.read_at(
                        rel, off, min(READ_BLOCK, e.size - off))
                    if not block:
                        raise IOError(f"short read at {off}/{e.size}")
                    f.write(block)
                    if h is not None:
                        h.update(block)
                    off += len(block)
        except BaseException:
            # incl. pool cancellation: a half-written tmp must not
            # survive as junk in the destination
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if h is not None:
            if h.digest() != e.digest:
                os.unlink(tmp)
                raise IOError("content digest mismatch after restore")
            self.result.verified += 1
        if os.path.isdir(path) and not os.path.islink(path):
            self._clear_conflict(path)    # os.replace cannot evict a dir
        os.replace(tmp, path)
        self._apply_meta(path, e)
        self.result.files += 1
        self.result.bytes += e.size

    def _apply_meta(self, path: str, e: Entry, *, symlink: bool = False) -> None:
        # chown BEFORE chmod: on Linux chown() clears setuid/setgid even for
        # root, so the reverse order strips the bits off restored binaries
        # (restore_unix.go applies ownership first for the same reason)
        if self.apply_ownership:
            try:
                os.chown(path, e.uid, e.gid, follow_symlinks=not symlink)
            except OSError:
                pass
        if not symlink:       # symlink modes are ignored on Linux (no lchmod)
            try:
                os.chmod(path, e.mode, follow_symlinks=True)
            except OSError:
                pass
        for name, value in e.xattrs.items():
            if name.startswith("win."):
                continue        # Windows metadata is applied below
            try:
                os.setxattr(path, name, value, follow_symlinks=not symlink)
            except OSError:
                pass
        try:
            os.utime(path, ns=(e.mtime_ns, e.mtime_ns),
                     follow_symlinks=not symlink)
        except OSError:
            pass
        if self.win_meta is not None and any(
                k.startswith("win.") for k in e.xattrs):
            # ACLs, attribute bits, ADS, then times (restore_windows.go
            # applyMeta ordering)
            n0 = len(self.win_meta.errors)
            self.win_meta.apply(path, e.mtime_ns, e.xattrs)
            self.result.errors.extend(self.win_meta.errors[n0:])


async def run_restore_job(session, dest: str, *, verify: bool = True,
                          ) -> RestoreResult:
    """Entry point used by the agent lifecycle's restore handler."""
    client = RemoteArchiveClient(session)
    engine = RestoreEngine(client, dest, verify=verify)
    res = await engine.run()
    L.info("restore done: %d files, %d bytes, %d errors",
           res.files, res.bytes, len(res.errors))
    return res
