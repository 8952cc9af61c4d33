"""agentfs — the read-only remote-FS protocol the agent serves during a
backup job.

Reference: internal/agent/agentfs/server.go:16-99 (handlers OpenFile/Attr/
Xattr/ReadDir/ReadAt/Lseek/Close/StatFS, handle table, panic-safe wrapper)
and the wire DTOs at internal/agent/agentfs/types/types.go:7-155.

Methods (msgpack payloads over aRPC; file reads use the raw-stream path so
bytes land directly in caller buffers — the reference's CallBinaryWithMeta
hot loop, SURVEY §3.2):

    agentfs.stat_fs   {}                          → {total, free, files}
    agentfs.attr      {path}                      → entry map
    agentfs.read_dir  {path, start?, max?}        → {entries: [entry map],
                                                     next?: name token}
    agentfs.read_link {path}                      → {target}
    agentfs.xattrs    {path}                      → {xattrs: {name: bytes}}
    agentfs.open      {path}                      → {handle}
    agentfs.read_at   {handle, off, n}            → 213 raw stream
    agentfs.lseek     {handle, off, whence}       → {pos}
    agentfs.close     {handle}                    → {}

A copy of the JAX package's ``agent/agentfs.py``, its code byte for byte
apart from its imports, which name the port's own modules.
"""

from __future__ import annotations

import bisect
import os
import stat as statmod
from typing import Any

from ..arpc.call import RawStreamHandler
from ..arpc.router import HandlerError, Router
from ..arpc.binary_stream import send_data_from_reader
from ..pxar.format import read_xattrs

MAX_READ = 32 << 20
MAX_HANDLES = 512          # open-fd ceiling per snapshot session: a leaky
                           # or compromised server must not exhaust the
                           # agent's fd table
READDIR_PAGE = 4096        # entries per read_dir response; larger dirs
                           # page via the `start` continuation token


def _entry_map(name: str, st: os.stat_result, link_target: str = "") -> dict:
    m = st.st_mode
    if statmod.S_ISDIR(m):
        kind = "d"
    elif statmod.S_ISLNK(m):
        kind = "l"
    elif statmod.S_ISREG(m):
        kind = "f"
    elif statmod.S_ISFIFO(m):
        kind = "p"
    elif statmod.S_ISSOCK(m):
        kind = "s"
    elif statmod.S_ISBLK(m):
        kind = "b"
    else:
        kind = "c"
    return {
        "name": name, "kind": kind, "mode": statmod.S_IMODE(m),
        "uid": st.st_uid, "gid": st.st_gid, "size": st.st_size,
        "mtime_ns": st.st_mtime_ns, "nlink": st.st_nlink,
        "ino": st.st_ino, "dev": st.st_dev, "rdev": st.st_rdev,
        "target": link_target,
    }


class AgentFSServer:
    """Serves one snapshot root read-only.  Register on a job-session
    router; the server side walks it to build the archive."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._realroot = os.path.realpath(self.root)
        self._handles: dict[int, Any] = {}
        self._next_handle = 1
        self.stats = {"reads": 0, "bytes": 0, "opens": 0}

    def _resolve(self, rel: str) -> str:
        rel = rel.strip("/")
        p = os.path.normpath(os.path.join(self.root, rel)) if rel else self.root
        if p != self.root and not p.startswith(self.root + os.sep):
            raise HandlerError(f"path escapes root: {rel!r}", status=400)
        return p

    def _within_realroot(self, rp: str) -> bool:
        """THE containment predicate — every gate (metadata pre-checks
        and _open's post-open fd check) must use this one definition or
        they drift apart."""
        return rp == self._realroot or \
            rp.startswith(self._realroot + os.sep)

    def _check_contained(self, p: str, rel: str, *,
                         follow_final: bool) -> None:
        """Refuse paths whose symlink resolution leaves the snapshot root.

        follow_final=True when the operation itself follows the final
        component (listdir); False when it operates on the node itself
        (lstat/readlink/lgetxattr) — there only the PARENT traversal can
        escape.  Best-effort for metadata; content reads get the stronger
        post-open fd gate in _open."""
        target = p if (follow_final or p == self.root) \
            else (os.path.dirname(p) or p)
        if not self._within_realroot(os.path.realpath(target)):
            raise HandlerError(f"symlink escapes root: {rel!r}", status=400)

    def register(self, router: Router) -> None:
        router.handle("agentfs.stat_fs", self._stat_fs)
        router.handle("agentfs.attr", self._attr)
        router.handle("agentfs.read_dir", self._read_dir)
        router.handle("agentfs.read_link", self._read_link)
        router.handle("agentfs.xattrs", self._xattrs)
        router.handle("agentfs.open", self._open)
        router.handle("agentfs.read_at", self._read_at)
        router.handle("agentfs.lseek", self._lseek)
        router.handle("agentfs.close", self._close)

    # -- handlers ----------------------------------------------------------
    async def _stat_fs(self, req, ctx):
        sv = os.statvfs(self.root)
        return {"total": sv.f_blocks * sv.f_frsize,
                "free": sv.f_bavail * sv.f_frsize,
                "files": sv.f_files}

    async def _attr(self, req, ctx):
        p = self._resolve(req.payload["path"])
        self._check_contained(p, req.payload["path"], follow_final=False)
        try:
            st = os.lstat(p)
        except OSError as e:
            raise HandlerError(f"lstat: {e}", status=404)
        target = ""
        if statmod.S_ISLNK(st.st_mode):
            try:
                target = os.readlink(p)
            except OSError:
                pass
        return _entry_map(os.path.basename(p), st, target)

    async def _read_dir(self, req, ctx):
        p = self._resolve(req.payload["path"])
        self._check_contained(p, req.payload["path"], follow_final=True)
        try:
            names = sorted(os.listdir(p))
        except NotADirectoryError:
            raise HandlerError("not a directory", status=400)
        except OSError as e:
            raise HandlerError(f"listdir: {e}", status=404)
        # paging: resume strictly after the `start` name so one response
        # never has to carry a 100k-entry directory (the continuation is
        # a name, not an index — stable under concurrent unlinks)
        start = req.payload.get("start", "")
        if not isinstance(start, str):
            raise HandlerError("start must be a name string", status=400)
        if start:
            names = names[bisect.bisect_right(names, start):]
        try:
            page = int(req.payload.get("max", READDIR_PAGE))
        except (TypeError, ValueError):
            raise HandlerError("max must be an integer", status=400)
        # clamp BOTH ends: max<=0 must not read as "empty directory" on
        # the client (no next token would end its loop early)
        page = max(1, min(page, READDIR_PAGE))
        names, more = names[:page], len(names) > page
        entries = []
        for name in names:
            try:
                st = os.lstat(os.path.join(p, name))
            except OSError:
                continue          # raced unlink — skip
            target = ""
            if statmod.S_ISLNK(st.st_mode):
                try:
                    target = os.readlink(os.path.join(p, name))
                except OSError:
                    pass
            e = _entry_map(name, st, target)
            # piggyback xattrs (POSIX ACLs travel as system.* xattrs) so
            # the server needs no per-file RPC to preserve them
            if not statmod.S_ISLNK(st.st_mode):
                x = read_xattrs(os.path.join(p, name))
                if x:
                    e["xattrs"] = x
            entries.append(e)
        out = {"entries": entries}
        if more and names:
            out["next"] = names[-1]
        return out

    async def _read_link(self, req, ctx):
        p = self._resolve(req.payload["path"])
        self._check_contained(p, req.payload["path"], follow_final=False)
        try:
            return {"target": os.readlink(p)}
        except OSError as e:
            raise HandlerError(f"readlink: {e}", status=404)

    async def _xattrs(self, req, ctx):
        p = self._resolve(req.payload["path"])
        self._check_contained(p, req.payload["path"], follow_final=False)
        return {"xattrs": read_xattrs(p)}

    async def _open(self, req, ctx):
        p = self._resolve(req.payload["path"])
        if len(self._handles) >= MAX_HANDLES:
            raise HandlerError(
                f"too many open handles ({MAX_HANDLES})", status=429)
        # O_NONBLOCK: an open() on a fifo blocks until a writer appears —
        # a raced or hostile path must not hang the agent's event loop
        try:
            fd = os.open(p, os.O_RDONLY | getattr(os, "O_NONBLOCK", 0))
        except OSError as e:
            raise HandlerError(f"open: {e}", status=404)
        try:
            st = os.fstat(fd)
            if not statmod.S_ISREG(st.st_mode):
                raise HandlerError("not a regular file", status=400)
            # containment is checked on the OPENED fd (not a pre-open
            # realpath, which a concurrent rename could invalidate): an
            # in-tree symlink pointing outside the snapshot root must not
            # hand the peer arbitrary agent files.  /proc/self/fd gives
            # the fully-resolved path of what was actually opened.
            proc = f"/proc/self/fd/{fd}"
            rp = os.path.realpath(proc) if os.path.exists(proc) \
                else os.path.realpath(p)
            if not self._within_realroot(rp):
                raise HandlerError(f"symlink escapes root: "
                                   f"{req.payload['path']!r}", status=400)
            f = os.fdopen(fd, "rb", buffering=0)
        except HandlerError:
            os.close(fd)
            raise
        except OSError as e:
            os.close(fd)
            raise HandlerError(f"open: {e}", status=400)
        h = self._next_handle
        self._next_handle += 1
        self._handles[h] = f
        self.stats["opens"] += 1
        return {"handle": h}

    def _file(self, handle: int):
        f = self._handles.get(handle)
        if f is None:
            raise HandlerError(f"bad handle {handle}", status=400)
        return f

    async def _read_at(self, req, ctx):
        f = self._file(req.payload["handle"])
        off = int(req.payload["off"])
        n = int(req.payload["n"])
        if n < 0 or n > MAX_READ:
            raise HandlerError(f"read size {n} out of range", status=400)
        try:
            data = os.pread(f.fileno(), n, off)
        except OSError as e:
            raise HandlerError(f"pread: {e}", status=500)
        self.stats["reads"] += 1
        self.stats["bytes"] += len(data)

        async def pump(stream):
            await send_data_from_reader(stream, data, len(data))
        return RawStreamHandler(pump, data={"n": len(data)})

    async def _lseek(self, req, ctx):
        f = self._file(req.payload["handle"])
        try:
            pos = f.seek(int(req.payload["off"]), int(req.payload.get("whence", 0)))
        except OSError as e:
            raise HandlerError(f"lseek: {e}", status=400)
        return {"pos": pos}

    async def _close(self, req, ctx):
        f = self._handles.pop(int(req.payload["handle"]), None)
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        return {}

    def close_all(self) -> None:
        for f in self._handles.values():
            try:
                f.close()
            except OSError:
                pass
        self._handles.clear()


class AgentFSClient:
    """Server-side client of agentfs (reference: the arpcfs FUSE backend's
    RPC surface, internal/server/vfs/arpcfs — here consumed directly by the
    archive writer instead of through kernel FUSE: one fewer kernel
    crossing than the reference's hot loop)."""

    def __init__(self, session):
        self.s = session            # arpc.Session

    async def stat_fs(self) -> dict:
        return (await self.s.call("agentfs.stat_fs")).data

    async def attr(self, path: str) -> dict:
        return (await self.s.call("agentfs.attr", {"path": path})).data

    async def read_dir(self, path: str) -> list[dict]:
        entries: list[dict] = []
        start = ""
        while True:
            payload = {"path": path}
            if start:
                payload["start"] = start
            d = (await self.s.call("agentfs.read_dir", payload)).data
            entries.extend(d["entries"])
            start = d.get("next", "")
            if not start:
                return entries

    async def read_link(self, path: str) -> str:
        return (await self.s.call("agentfs.read_link", {"path": path})).data["target"]

    async def xattrs(self, path: str) -> dict:
        return (await self.s.call("agentfs.xattrs", {"path": path})).data["xattrs"]

    async def open(self, path: str) -> int:
        return (await self.s.call("agentfs.open", {"path": path})).data["handle"]

    async def read_at(self, handle: int, off: int, n: int) -> bytes:
        buf = bytearray()
        await self.s.call_binary_into(
            "agentfs.read_at", {"handle": handle, "off": off, "n": n}, buf)
        return bytes(buf)

    async def close(self, handle: int) -> None:
        await self.s.call("agentfs.close", {"handle": handle})
