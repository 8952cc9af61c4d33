"""MutableFS — the journal-over-archive merged filesystem.

Reference: internal/pxarmount/mutablefs.go:39-1841 — go-fuse RawFileSystem
merging journal edges over pxar entries: journal edge wins, whiteouts hide
archive entries, writes copy-up to a passthrough dir, deletes add
whiteouts, renames re-point nodes, a freeze barrier stops mutations during
commits (waitIfFrozen).

Here the same semantics as a path-based VFS object (the FUSE adapter is a
thin frontend over these methods).  Overlay model:

- every journal *dir* node may carry ``base_path`` — the archive directory
  whose unmodified children show through it (overlayfs-style fall-through)
- journal *file* nodes either hold copied-up content (``content_path`` in
  the passthrough dir) or reference unmodified archive content via
  ``base_path`` (renames don't copy data; commit turns them into refs)
- deleting an archive-backed name adds a whiteout on the (materialized)
  parent node

A copy of the JAX package's ``mount/mutablefs.py``, its code byte for
byte; its imports are relative, so they name the port's own modules.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..pxar.format import Entry, KIND_DIR, KIND_FILE, KIND_SYMLINK
from .journal import Journal, Node, ROOT_ID
from .pxarfs import ArchiveView


def _mutating(fn):
    """Wrap a mutator in freeze-barrier op accounting (re-entrant)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        self._begin_op()
        try:
            return fn(self, *a, **kw)
        finally:
            self._end_op()
    return wrapper


@dataclass
class Resolved:
    """Result of path resolution: exactly one of node/entry set (or both
    for dirs merged over archive dirs — node wins for metadata)."""
    node: Optional[Node]           # journal side
    arch_path: Optional[str]       # archive path visible at this name

    @property
    def exists(self) -> bool:
        return self.node is not None or self.arch_path is not None


class MutableFS:
    def __init__(self, view: ArchiveView, journal: Journal,
                 passthrough_dir: str):
        self.view = view
        self.journal = journal
        self.passthrough = os.path.abspath(passthrough_dir)
        os.makedirs(self.passthrough, exist_ok=True)
        self._frozen = False
        self._freeze_cv = threading.Condition()
        self._op_depth: dict[int, int] = {}
        root = journal.get_node(ROOT_ID)
        assert root is not None
        if root.base_path is None:
            root.base_path = ""          # archive root shows through
            journal.put_node(root)
        self.stats = {"copy_ups": 0, "writes": 0, "reads": 0}

    # -- freeze barrier ----------------------------------------------------
    # freeze() must not only stop NEW mutations — it waits for in-flight
    # ones to drain (reference: waitIfFrozen + op accounting), so the
    # commit walk never observes a half-applied mutation.  Ops are
    # re-entrant per thread (write() → _copy_up()).
    def freeze(self) -> None:
        with self._freeze_cv:
            self._frozen = True
            while sum(self._op_depth.values()) > 0:
                self._freeze_cv.wait()

    def unfreeze(self) -> None:
        with self._freeze_cv:
            self._frozen = False
            self._freeze_cv.notify_all()

    def _begin_op(self) -> None:
        tid = threading.get_ident()
        with self._freeze_cv:
            if self._op_depth.get(tid, 0) > 0:
                self._op_depth[tid] += 1
                return
            while self._frozen:
                self._freeze_cv.wait()
            self._op_depth[tid] = 1

    def _end_op(self) -> None:
        tid = threading.get_ident()
        with self._freeze_cv:
            d = self._op_depth.get(tid, 0) - 1
            if d <= 0:
                self._op_depth.pop(tid, None)
            else:
                self._op_depth[tid] = d
            self._freeze_cv.notify_all()


    # -- resolution --------------------------------------------------------
    @staticmethod
    def _parts(path: str) -> list[str]:
        path = path.strip("/")
        return path.split("/") if path else []

    def _arch_lookup(self, arch_path: str) -> Optional[Entry]:
        return self.view.lookup(arch_path)

    def resolve(self, path: str) -> Resolved:
        node: Optional[Node] = self.journal.get_node(ROOT_ID)
        arch: Optional[str] = node.base_path if node else None
        for name in self._parts(path):
            if node is not None:
                child_id = self.journal.get_edge(node.id, name)
                if child_id is not None:
                    node = self.journal.get_node(child_id)
                    arch = node.base_path if node else None
                    continue
                if self.journal.is_whiteout(node.id, name):
                    return Resolved(None, None)
                node_arch = arch
                node = None
                if node_arch is None:
                    return Resolved(None, None)
                arch = f"{node_arch}/{name}" if node_arch else name
                if self._arch_lookup(arch) is None:
                    return Resolved(None, None)
            else:
                assert arch is not None
                arch = f"{arch}/{name}" if arch else name
                if self._arch_lookup(arch) is None:
                    return Resolved(None, None)
        return Resolved(node, arch)

    # -- attrs -------------------------------------------------------------
    @_mutating
    def getattr(self, path: str) -> Entry:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        rel = path.strip("/")
        if r.node is not None:
            n = r.node
            size = n.size
            if n.kind == KIND_FILE and n.content_path:
                try:
                    size = os.path.getsize(
                        os.path.join(self.passthrough, n.content_path))
                except OSError:
                    pass
            elif n.kind == KIND_FILE and n.base_path is not None:
                e = self._arch_lookup(n.base_path)
                size = e.size if e else 0
            return Entry(path=rel, kind=n.kind, mode=n.mode, uid=n.uid,
                         gid=n.gid, mtime_ns=n.mtime_ns, size=size,
                         link_target=n.link_target,
                         xattrs=self.journal.xattrs(n.id))
        e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
        assert e is not None
        out = Entry(**{**e.__dict__})
        out.path = rel
        return out

    @_mutating
    def readdir(self, path: str) -> list[Entry]:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        names: dict[str, Entry] = {}
        if r.node is not None:
            if r.node.kind != KIND_DIR:
                raise NotADirectoryError(path)
            arch = r.node.base_path
            if arch is not None:
                try:
                    for e in self.view.read_dir(arch):
                        names[e.name] = e
                except FileNotFoundError:
                    pass
            for w in self.journal.whiteouts(r.node.id):
                names.pop(w, None)
            for name, _ in self.journal.edges(r.node.id):
                child = path.rstrip("/") + "/" + name if path.strip("/") else name
                names[name] = self.getattr(child)
        else:
            for e in self.view.read_dir(r.arch_path):  # type: ignore[arg-type]
                names[e.name] = e
        rel = path.strip("/")
        out = []
        for name in sorted(names):
            e = names[name]
            ee = Entry(**{**e.__dict__})
            ee.path = f"{rel}/{name}" if rel else name
            out.append(ee)
        return out

    # -- data --------------------------------------------------------------
    @_mutating
    def read(self, path: str, off: int = 0, size: int = -1) -> bytes:
        self.stats["reads"] += 1
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        if r.node is not None:
            n = r.node
            if n.kind != KIND_FILE:
                raise IsADirectoryError(path)
            if n.content_path:
                p = os.path.join(self.passthrough, n.content_path)
                with open(p, "rb") as f:
                    f.seek(off)
                    return f.read(size if size >= 0 else -1)
            if n.base_path is not None:
                e = self._arch_lookup(n.base_path)
                if e is None:
                    raise FileNotFoundError(path)
                return self.view.read_file(e, off, size)
            return b""
        e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
        assert e is not None
        if not e.is_file:
            raise IsADirectoryError(path)
        return self.view.read_file(e, off, size)

    def _new_content_path(self) -> str:
        name = f"f{int(time.time()*1e6):x}-{os.urandom(4).hex()}"
        return name

    def _materialize_dir(self, path: str) -> Node:
        """Ensure every directory level of ``path`` has a journal node
        (copy-up of directories)."""
        node = self.journal.get_node(ROOT_ID)
        assert node is not None
        arch = node.base_path
        for name in self._parts(path):
            child_id = self.journal.get_edge(node.id, name)
            if child_id is not None:
                node = self.journal.get_node(child_id)
                assert node is not None
                arch = node.base_path
                if node.kind != KIND_DIR:
                    raise NotADirectoryError(path)
                continue
            if self.journal.is_whiteout(node.id, name):
                raise FileNotFoundError(path)
            if arch is None:
                raise FileNotFoundError(path)
            child_arch = f"{arch}/{name}" if arch else name
            e = self._arch_lookup(child_arch)
            if e is None:
                raise FileNotFoundError(path)
            if not e.is_dir:
                raise NotADirectoryError(path)
            child = Node(0, KIND_DIR, mode=e.mode, uid=e.uid, gid=e.gid,
                         mtime_ns=e.mtime_ns, base_path=child_arch)
            self.journal.put_node(child)
            self.journal.set_edge(node.id, name, child.id)
            node, arch = child, child_arch
        return node

    @_mutating
    def _copy_up(self, path: str, r: Resolved) -> Node:
        """Copy an archive (or ref) file's content into the passthrough dir
        (reference: copyUp/copyUpRegularFile)."""
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        if r.node is not None and r.node.content_path:
            return r.node
        if r.node is not None:
            src_entry = self._arch_lookup(r.node.base_path or "")
            node = r.node
        else:
            src_entry = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
            node = None
        if src_entry is None or not src_entry.is_file:
            raise FileNotFoundError(path)
        cp = self._new_content_path()
        dst = os.path.join(self.passthrough, cp)
        with open(dst, "wb") as f:
            off = 0
            while off < src_entry.size:
                block = self.view.read_file(src_entry, off, 8 << 20)
                if not block:
                    break
                f.write(block)
                off += len(block)
        if node is None:
            node = Node(0, KIND_FILE, mode=src_entry.mode, uid=src_entry.uid,
                        gid=src_entry.gid, mtime_ns=src_entry.mtime_ns,
                        base_path=r.arch_path)
        node.content_path = cp
        node.size = src_entry.size
        self.journal.put_node(node)
        self.journal.set_edge(pnode.id, name, node.id)
        self.stats["copy_ups"] += 1
        return node

    @_mutating
    def write(self, path: str, data: bytes, off: int = 0) -> int:
        self.stats["writes"] += 1
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        node = r.node
        if node is None or not node.content_path:
            node = self._copy_up(path, r)
        p = os.path.join(self.passthrough, node.content_path)
        with open(p, "r+b") as f:
            f.seek(off)
            f.write(data)
        node.size = os.path.getsize(p)
        node.mtime_ns = time.time_ns()
        self.journal.put_node(node)
        return len(data)

    @_mutating
    def truncate(self, path: str, size: int) -> None:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        node = r.node
        if node is None or not node.content_path:
            node = self._copy_up(path, r)
        p = os.path.join(self.passthrough, node.content_path)
        os.truncate(p, size)
        node.size = size
        node.mtime_ns = time.time_ns()
        self.journal.put_node(node)

    @_mutating
    def create(self, path: str, mode: int = 0o644, *,
               exist_ok: bool = False) -> None:
        if self.resolve(path).exists:
            if exist_ok:
                return
            raise FileExistsError(path)
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        cp = self._new_content_path()
        with open(os.path.join(self.passthrough, cp), "wb"):
            pass        # create the empty content file
        node = Node(0, KIND_FILE, mode=mode, mtime_ns=time.time_ns(),
                    content_path=cp)
        self.journal.put_node(node)
        self.journal.set_edge(pnode.id, name, node.id)

    @_mutating
    def mkdir(self, path: str, mode: int = 0o755) -> None:
        if self.resolve(path).exists:
            raise FileExistsError(path)
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        node = Node(0, KIND_DIR, mode=mode, mtime_ns=time.time_ns())
        self.journal.put_node(node)
        self.journal.set_edge(pnode.id, name, node.id)

    @_mutating
    def symlink(self, path: str, target: str) -> None:
        if self.resolve(path).exists:
            raise FileExistsError(path)
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        node = Node(0, KIND_SYMLINK, link_target=target,
                    mode=0o777, mtime_ns=time.time_ns())
        self.journal.put_node(node)
        self.journal.set_edge(pnode.id, name, node.id)

    @_mutating
    def readlink(self, path: str) -> str:
        e = self.getattr(path)
        if e.kind != KIND_SYMLINK:
            raise OSError(f"{path} is not a symlink")
        return e.link_target

    def _archive_has(self, pnode: Node, name: str) -> bool:
        if pnode.base_path is None:
            return False
        arch = f"{pnode.base_path}/{name}" if pnode.base_path else name
        return self._arch_lookup(arch) is not None

    @_mutating
    def unlink(self, path: str) -> None:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        e = self.getattr(path)
        if e.is_dir:
            raise IsADirectoryError(path)
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        if r.node is not None:
            if r.node.content_path:
                try:
                    os.unlink(os.path.join(self.passthrough,
                                           r.node.content_path))
                except OSError:
                    pass
            self.journal.del_edge(pnode.id, name)
        if self._archive_has(pnode, name):
            self.journal.add_whiteout(pnode.id, name)

    @_mutating
    def rmdir(self, path: str) -> None:
        if self.readdir(path):
            raise OSError(f"directory not empty: {path}")
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent)
        self.journal.del_edge(pnode.id, name)
        if self._archive_has(pnode, name):
            self.journal.add_whiteout(pnode.id, name)

    @_mutating
    def rename(self, src: str, dst: str) -> None:
        """Rename without copying content: archive-backed sources become
        journal nodes referencing their old archive path (the commit engine
        turns them into payload refs — rename chains stay dedup'd)."""
        r = self.resolve(src)
        if not r.exists:
            raise FileNotFoundError(src)
        if self.resolve(dst).exists:
            # posix rename-over semantics: file->dir is EISDIR, dir->file is
            # ENOTDIR, dir->nonempty-dir is ENOTEMPTY (rmdir raises)
            se = self.getattr(src)
            de = self.getattr(dst)
            if de.is_dir and not se.is_dir:
                raise IsADirectoryError(dst)
            if se.is_dir and not de.is_dir:
                raise NotADirectoryError(dst)
            if de.is_dir:
                self.rmdir(dst)
            else:
                self.unlink(dst)
        src_parent, src_name = os.path.split(src.strip("/"))
        dst_parent, dst_name = os.path.split(dst.strip("/"))
        sp = self._materialize_dir(src_parent)
        dp = self._materialize_dir(dst_parent)
        if r.node is not None:
            node = r.node
        else:
            e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
            assert e is not None
            node = Node(0, e.kind, mode=e.mode, uid=e.uid, gid=e.gid,
                        mtime_ns=e.mtime_ns, size=e.size,
                        link_target=e.link_target, base_path=r.arch_path)
            self.journal.put_node(node)
        self.journal.del_edge(sp.id, src_name)
        if self._archive_has(sp, src_name):
            self.journal.add_whiteout(sp.id, src_name)
        self.journal.set_edge(dp.id, dst_name, node.id)

    # -- metadata ----------------------------------------------------------
    def _node_for_meta(self, path: str) -> Node:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        if r.node is not None:
            return r.node
        # metadata change on an archive entry → materialize a shadow node
        e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
        assert e is not None
        parent, name = os.path.split(path.strip("/"))
        pnode = self._materialize_dir(parent) if path.strip("/") else None
        node = Node(0, e.kind, mode=e.mode, uid=e.uid, gid=e.gid,
                    mtime_ns=e.mtime_ns, size=e.size,
                    link_target=e.link_target, base_path=r.arch_path)
        self.journal.put_node(node)
        if pnode is not None:
            self.journal.set_edge(pnode.id, name, node.id)
        for k, v in e.xattrs.items():
            self.journal.set_xattr(node.id, k, v)
        return node

    @_mutating
    def chmod(self, path: str, mode: int) -> None:
        n = self._node_for_meta(path)
        n.mode = mode
        self.journal.put_node(n)

    @_mutating
    def chown(self, path: str, uid: int, gid: int) -> None:
        n = self._node_for_meta(path)
        n.uid, n.gid = uid, gid
        self.journal.put_node(n)

    @_mutating
    def utimens(self, path: str, mtime_ns: int) -> None:
        n = self._node_for_meta(path)
        n.mtime_ns = mtime_ns
        self.journal.put_node(n)

    @_mutating
    def set_xattr(self, path: str, name: str, value: bytes) -> None:
        n = self._node_for_meta(path)
        self.journal.set_xattr(n.id, name, value)

    @_mutating
    def get_xattrs(self, path: str) -> dict[str, bytes]:
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        if r.node is not None:
            return self.journal.xattrs(r.node.id)
        e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
        return dict(e.xattrs) if e else {}

    @_mutating
    def get_xattr(self, path: str, name: str) -> bytes | None:
        """Single-name lookup for the kernel getxattr hot path."""
        r = self.resolve(path)
        if not r.exists:
            raise FileNotFoundError(path)
        if r.node is not None:
            return self.journal.xattr(r.node.id, name)
        e = self._arch_lookup(r.arch_path)  # type: ignore[arg-type]
        return e.xattrs.get(name) if e else None

    @_mutating
    def remove_xattr(self, path: str, name: str) -> None:
        n = self._node_for_meta(path)
        self.journal.del_xattr(n.id, name)
