"""Kernel FUSE frontend for MutableFS (ctypes over libfuse 2.9).

Reference: the go-fuse v2 RawFileSystem frontends (internal/pxarmount/
mutablefs.go for the archive mount, internal/server/vfs/arpcfs for the
backup mount).  No Python FUSE binding ships in this image, so this module
binds libfuse.so.2's high-level API (FUSE_USE_VERSION 26) directly:
a ``fuse_operations`` struct of C callbacks forwarding to a MutableFS.

Runs single-threaded foreground (``-s -f``) in a dedicated thread; the
freeze barrier therefore excludes kernel-originated operations during
commits exactly like embedded use.

A copy of the JAX package's ``mount/fusefs.py``, its code byte for byte
apart from its imports, which name the port's own modules; it logs
through ``logging``.  libfuse is loaded at the first mount, and a missing
library raises there.
"""

from __future__ import annotations

import ctypes as C
import errno
import logging
import os
import stat as statmod
import threading
from typing import Optional

from ..pxar.format import KIND_DIR, KIND_FILE, KIND_SYMLINK
from .mutablefs import MutableFS

L = logging.getLogger(__name__)

_libfuse = None


def _load_libfuse():
    global _libfuse
    if _libfuse is None:
        _libfuse = C.CDLL("libfuse.so.2", use_errno=True)
    return _libfuse


class _Timespec(C.Structure):
    _fields_ = [("tv_sec", C.c_long), ("tv_nsec", C.c_long)]


class _Stat(C.Structure):           # x86_64 struct stat
    _fields_ = [
        ("st_dev", C.c_ulong), ("st_ino", C.c_ulong),
        ("st_nlink", C.c_ulong), ("st_mode", C.c_uint),
        ("st_uid", C.c_uint), ("st_gid", C.c_uint), ("__pad0", C.c_uint),
        ("st_rdev", C.c_ulong), ("st_size", C.c_long),
        ("st_blksize", C.c_long), ("st_blocks", C.c_long),
        ("st_atim", _Timespec), ("st_mtim", _Timespec),
        ("st_ctim", _Timespec), ("__reserved", C.c_long * 3),
    ]


_GETATTR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.POINTER(_Stat))
_READLINK = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p, C.c_size_t)
_MKDIR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_uint)
_UNLINK = C.CFUNCTYPE(C.c_int, C.c_char_p)
_RMDIR = C.CFUNCTYPE(C.c_int, C.c_char_p)
_SYMLINK = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p)
_RENAME = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p)
_CHMOD = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_uint)
_CHOWN = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_uint, C.c_uint)
_TRUNCATE = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_long)
_OPEN = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_void_p)
_READ = C.CFUNCTYPE(C.c_int, C.c_char_p, C.POINTER(C.c_char), C.c_size_t,
                    C.c_long, C.c_void_p)
_WRITE = C.CFUNCTYPE(C.c_int, C.c_char_p, C.POINTER(C.c_char), C.c_size_t,
                     C.c_long, C.c_void_p)
_FILLER = C.CFUNCTYPE(C.c_int, C.c_void_p, C.c_char_p, C.POINTER(_Stat),
                      C.c_long)
_READDIR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_void_p, _FILLER, C.c_long,
                       C.c_void_p)
_CREATE = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_uint, C.c_void_p)
_UTIMENS = C.CFUNCTYPE(C.c_int, C.c_char_p, C.POINTER(_Timespec))
_SETXATTR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p,
                        C.POINTER(C.c_char), C.c_size_t, C.c_int)
_GETXATTR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p,
                        C.POINTER(C.c_char), C.c_size_t)
_LISTXATTR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.POINTER(C.c_char),
                         C.c_size_t)
_REMOVEXATTR = C.CFUNCTYPE(C.c_int, C.c_char_p, C.c_char_p)
_VOIDP = C.c_void_p


class _FuseOps(C.Structure):        # libfuse 2.9 fuse_operations (API 26)
    _fields_ = [
        ("getattr", _GETATTR), ("readlink", _READLINK), ("getdir", _VOIDP),
        ("mknod", _VOIDP), ("mkdir", _MKDIR), ("unlink", _UNLINK),
        ("rmdir", _RMDIR), ("symlink", _SYMLINK), ("rename", _RENAME),
        ("link", _VOIDP), ("chmod", _CHMOD), ("chown", _CHOWN),
        ("truncate", _TRUNCATE), ("utime", _VOIDP), ("open", _OPEN),
        ("read", _READ), ("write", _WRITE), ("statfs", _VOIDP),
        ("flush", _VOIDP), ("release", _VOIDP), ("fsync", _VOIDP),
        ("setxattr", _SETXATTR), ("getxattr", _GETXATTR),
        ("listxattr", _LISTXATTR),
        ("removexattr", _REMOVEXATTR), ("opendir", _VOIDP),
        ("readdir", _READDIR),
        ("releasedir", _VOIDP), ("fsyncdir", _VOIDP), ("init", _VOIDP),
        ("destroy", _VOIDP), ("access", _VOIDP), ("create", _CREATE),
        ("ftruncate", _VOIDP), ("fgetattr", _VOIDP), ("lock", _VOIDP),
        ("utimens", _UTIMENS), ("bmap", _VOIDP),
        ("flags", C.c_uint),
        ("ioctl", _VOIDP), ("poll", _VOIDP), ("write_buf", _VOIDP),
        ("read_buf", _VOIDP), ("flock", _VOIDP), ("fallocate", _VOIDP),
    ]


def _errno_of(e: BaseException) -> int:
    if isinstance(e, FileNotFoundError):
        return -errno.ENOENT
    if isinstance(e, FileExistsError):
        return -errno.EEXIST
    if isinstance(e, IsADirectoryError):
        return -errno.EISDIR
    if isinstance(e, NotADirectoryError):
        return -errno.ENOTDIR
    if isinstance(e, PermissionError):
        return -errno.EACCES
    if isinstance(e, OSError) and e.errno:
        return -e.errno
    return -errno.EIO


def _guard(fn):
    def wrapper(*args):
        try:
            return fn(*args)
        except BaseException as e:       # noqa: BLE001 — C boundary
            if not isinstance(e, (OSError, ValueError)):
                L.exception("fuse op %s crashed", fn.__name__)
            return _errno_of(e)
    return wrapper


class FuseMount:
    """Mount a MutableFS at ``mountpoint`` via kernel FUSE."""

    def __init__(self, fs: MutableFS, mountpoint: str):
        self.fs = fs
        self.mountpoint = os.path.abspath(mountpoint)
        self._thread: Optional[threading.Thread] = None
        self._ops = self._make_ops()     # keep callbacks referenced!

    # -- op implementations -------------------------------------------------
    def _fill_stat(self, st: _Stat, e) -> None:
        C.memset(C.byref(st), 0, C.sizeof(_Stat))
        kind_bits = {KIND_DIR: statmod.S_IFDIR, KIND_FILE: statmod.S_IFREG,
                     KIND_SYMLINK: statmod.S_IFLNK}.get(e.kind,
                                                        statmod.S_IFREG)
        st.st_mode = kind_bits | (e.mode & 0o7777)
        st.st_nlink = 2 if e.kind == KIND_DIR else 1
        st.st_uid, st.st_gid = e.uid, e.gid
        st.st_size = len(e.link_target) if e.kind == KIND_SYMLINK else e.size
        st.st_blksize = 4096
        st.st_blocks = (e.size + 511) // 512
        sec, nsec = divmod(e.mtime_ns, 1_000_000_000)
        for field in (st.st_atim, st.st_mtim, st.st_ctim):
            field.tv_sec, field.tv_nsec = sec, nsec

    def _make_ops(self) -> _FuseOps:
        fs = self.fs

        @_guard
        def op_getattr(path: bytes, stbuf):
            e = fs.getattr(path.decode())
            self._fill_stat(stbuf.contents, e)
            return 0

        @_guard
        def op_readdir(path: bytes, buf, filler, offset, fi):
            filler(buf, b".", None, 0)
            filler(buf, b"..", None, 0)
            for e in fs.readdir(path.decode()):
                filler(buf, e.name.encode(), None, 0)
            return 0

        @_guard
        def op_read(path: bytes, buf, size, offset, fi):
            data = fs.read(path.decode(), offset, size)
            C.memmove(buf, data, len(data))
            return len(data)

        @_guard
        def op_write(path: bytes, buf, size, offset, fi):
            data = C.string_at(buf, size)
            return fs.write(path.decode(), data, offset)

        @_guard
        def op_open(path: bytes, fi):
            fs.getattr(path.decode())
            return 0

        @_guard
        def op_create(path: bytes, mode, fi):
            fs.create(path.decode(), mode & 0o7777)
            return 0

        @_guard
        def op_mkdir(path: bytes, mode):
            fs.mkdir(path.decode(), mode & 0o7777)
            return 0

        @_guard
        def op_unlink(path: bytes):
            fs.unlink(path.decode())
            return 0

        @_guard
        def op_rmdir(path: bytes):
            fs.rmdir(path.decode())
            return 0

        @_guard
        def op_rename(src: bytes, dst: bytes):
            fs.rename(src.decode(), dst.decode())
            return 0

        # xattr protocol (libfuse 2.9): size==0 queries the needed
        # length; too-small buffers answer -ERANGE; absent → -ENODATA
        @_guard
        def op_setxattr(path: bytes, name: bytes, value, size, flags):
            data = C.string_at(value, size) if size else b""
            p, n = path.decode(), name.decode()
            create = bool(flags & os.XATTR_CREATE)
            replace = bool(flags & os.XATTR_REPLACE)
            if create and replace:
                return -errno.EINVAL       # real filesystems reject this
            if create or replace:
                exists = n in fs.get_xattrs(p)
                if create and exists:
                    return -errno.EEXIST
                if replace and not exists:
                    return -errno.ENODATA
            fs.set_xattr(p, n, data)
            return 0

        @_guard
        def op_getxattr(path: bytes, name: bytes, value, size):
            data = fs.get_xattr(path.decode(), name.decode())
            if data is None:
                return -errno.ENODATA
            if size == 0:
                return len(data)
            if size < len(data):
                return -errno.ERANGE
            C.memmove(value, data, len(data))
            return len(data)

        @_guard
        def op_listxattr(path: bytes, buf, size):
            names = sorted(fs.get_xattrs(path.decode()))
            blob = b"".join(n.encode() + b"\0" for n in names)
            if size == 0:
                return len(blob)
            if size < len(blob):
                return -errno.ERANGE
            if blob:
                C.memmove(buf, blob, len(blob))
            return len(blob)

        @_guard
        def op_removexattr(path: bytes, name: bytes):
            p, n = path.decode(), name.decode()
            if n not in fs.get_xattrs(p):
                return -errno.ENODATA
            fs.remove_xattr(p, n)
            return 0

        @_guard
        def op_symlink(target: bytes, path: bytes):
            fs.symlink(path.decode(), target.decode())
            return 0

        @_guard
        def op_readlink(path: bytes, buf, size):
            t = fs.readlink(path.decode()).encode()[:size - 1]
            C.memmove(buf, t + b"\0", len(t) + 1)
            return 0

        @_guard
        def op_truncate(path: bytes, length):
            fs.truncate(path.decode(), length)
            return 0

        @_guard
        def op_chmod(path: bytes, mode):
            fs.chmod(path.decode(), mode & 0o7777)
            return 0

        @_guard
        def op_chown(path: bytes, uid, gid):
            fs.chown(path.decode(), uid, gid)
            return 0

        @_guard
        def op_utimens(path: bytes, times):
            if times:
                mt = times[1]
                fs.utimens(path.decode(),
                           mt.tv_sec * 1_000_000_000 + mt.tv_nsec)
            return 0

        ops = _FuseOps()
        ops.getattr = _GETATTR(op_getattr)
        ops.readdir = _READDIR(op_readdir)
        ops.read = _READ(op_read)
        ops.write = _WRITE(op_write)
        ops.open = _OPEN(op_open)
        ops.create = _CREATE(op_create)
        ops.mkdir = _MKDIR(op_mkdir)
        ops.unlink = _UNLINK(op_unlink)
        ops.rmdir = _RMDIR(op_rmdir)
        ops.rename = _RENAME(op_rename)
        ops.symlink = _SYMLINK(op_symlink)
        ops.readlink = _READLINK(op_readlink)
        ops.truncate = _TRUNCATE(op_truncate)
        ops.chmod = _CHMOD(op_chmod)
        ops.chown = _CHOWN(op_chown)
        ops.utimens = _UTIMENS(op_utimens)
        ops.setxattr = _SETXATTR(op_setxattr)
        ops.getxattr = _GETXATTR(op_getxattr)
        ops.listxattr = _LISTXATTR(op_listxattr)
        ops.removexattr = _REMOVEXATTR(op_removexattr)
        return ops

    # -- lifecycle ----------------------------------------------------------
    def mount(self, *, allow_other: bool = False) -> None:
        lib = _load_libfuse()
        os.makedirs(self.mountpoint, exist_ok=True)
        args = [b"pbs-plus-tpu", b"-f", b"-s", self.mountpoint.encode()]
        if allow_other:
            args += [b"-o", b"allow_other"]
        argv = (C.c_char_p * len(args))(*args)

        def run():
            rc = lib.fuse_main_real(len(args), argv, C.byref(self._ops),
                                    C.sizeof(self._ops), None)
            if rc != 0:
                L.error("fuse_main exited with %d", rc)

        self._thread = threading.Thread(target=run, name="fuse-main",
                                        daemon=True)
        self._thread.start()
        # wait for the kernel mount to appear
        import time
        for _ in range(100):
            if os.path.ismount(self.mountpoint):
                return
            if not self._thread.is_alive():
                raise RuntimeError("fuse_main exited during mount")
            time.sleep(0.05)
        raise TimeoutError("FUSE mount did not appear")

    def unmount(self, *, timeout: float = 10.0) -> None:
        lazy_unmount(self.mountpoint, timeout=timeout)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


def is_mounted(mountpoint: str) -> bool:
    """True while ``mountpoint`` appears in /proc/self/mounts.

    ``os.path.ismount`` lstat()s the path, which raises ENOTCONN on a
    FUSE mount whose daemon died — and ismount swallows that into False,
    making a *disconnected* mount look unmounted.  The kernel mount
    table is the ground truth (the reference treats stale mounts as a
    first-class failure mode: internal/server/bootstrap.go:173-196)."""
    try:
        real = os.path.realpath(mountpoint)
        with open("/proc/self/mounts", "rb") as f:
            table = f.read().decode("utf-8", "surrogateescape")
    except OSError:
        return os.path.ismount(mountpoint)
    # fields: dev mountpoint fstype opts ... ; octal-escaped spaces
    for line in table.splitlines():
        parts = line.split(" ")
        if len(parts) < 2:
            continue
        mp = parts[1].replace("\\040", " ").replace("\\011", "\t")
        if mp == real or mp == mountpoint:
            return True
    return False


def lazy_unmount(mountpoint: str, *, timeout: float = 10.0) -> bool:
    """Best-effort lazy unmount via fusermount/fusermount3/umount -l.
    Returns True when the mountpoint is no longer in the mount table
    (checked via /proc/self/mounts — robust against the disconnected-
    FUSE state where os.path.ismount lies, see is_mounted)."""
    import shutil as _sh
    import subprocess as _sp
    if not is_mounted(mountpoint):
        return True
    for tool, args in (("fusermount", ["-u", "-z"]),
                       ("fusermount3", ["-u", "-z"]),
                       ("umount", ["-l"])):
        if _sh.which(tool) is None:
            continue
        _sp.run([tool, *args, mountpoint], capture_output=True,
                timeout=timeout)
        if not is_mounted(mountpoint):
            return True
    return not is_mounted(mountpoint)
