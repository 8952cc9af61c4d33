"""tpxar entry model + wire encoding.

Reference capability: the pxar root package's ``Entry{Path,Kind,Metadata,
FileSize,LinkTarget,FileOffset,ContentOffset,PayloadOffset}`` and
``Metadata{Stat,XAttrs,FCaps,ACL,QuotaProjectID}`` (consumed at
internal/pxarmount/commit_orchestrate.go:186-199,267-305),
plus ``format.Stat/XAttr/Mode*/StatxTimestamp``.

Entries are msgpack maps with short keys, length-prefixed (u32) in the
metadata stream, emitted in sorted-path depth-first order.  Each entry is
self-contained (full archive-relative path) so the commit engine can run
two-pointer merges against journal edges (SURVEY §3.4) without carrying
directory state.

A copy of the JAX package's ``pxar/format.py``, its code byte for byte
apart from its imports, which name the port's own modules; entries
encode through the port's ``utils/codec.py``, which imports msgpack when
an entry is first encoded or decoded."""

from __future__ import annotations

import os
import stat as statmod
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Iterator

from ..utils import codec

KIND_FILE = "f"
KIND_DIR = "d"
KIND_SYMLINK = "l"
KIND_HARDLINK = "h"
KIND_FIFO = "p"
KIND_SOCKET = "s"
KIND_DEVICE = "c"          # character device
KIND_BLOCKDEV = "b"        # block device (same Entry shape; rdev carries
                           # the device number for both).  Format history:
                           # before "b" existed, block devices were encoded
                           # as "c" and never recreated on restore; the
                           # tpxar format has no released archives, so no
                           # version guard is needed for that era

_LEN = struct.Struct("<I")
MAX_ENTRY_SIZE = 16 << 20  # sanity cap for one metadata record


@dataclass
class Entry:
    path: str                      # archive-relative ("" = root dir)
    kind: str
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    mtime_ns: int = 0
    size: int = 0                  # payload bytes (files only)
    link_target: str = ""          # symlink target or hardlink source path
    rdev: int = 0
    xattrs: dict[str, bytes] = field(default_factory=dict)
    acl: list[tuple[str, int, int]] = field(default_factory=list)
    fcaps: bytes = b""
    quota_project_id: int = 0
    payload_offset: int = -1       # offset into the payload stream
    digest: bytes = b""            # sha256 of content (verification)

    # -- wire -------------------------------------------------------------
    def to_wire(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "p": self.path, "k": self.kind, "m": self.mode,
            "u": self.uid, "g": self.gid, "t": self.mtime_ns,
        }
        if self.size:
            d["s"] = self.size
        if self.link_target:
            d["l"] = self.link_target
        if self.rdev:
            d["r"] = self.rdev
        if self.xattrs:
            d["x"] = self.xattrs
        if self.acl:
            d["a"] = [list(e) for e in self.acl]
        if self.fcaps:
            d["c"] = self.fcaps
        if self.quota_project_id:
            d["q"] = self.quota_project_id
        if self.payload_offset >= 0:
            d["o"] = self.payload_offset
        if self.digest:
            d["h"] = self.digest
        return d

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "Entry":
        return cls(
            path=d["p"], kind=d["k"], mode=d.get("m", 0o644),
            uid=d.get("u", 0), gid=d.get("g", 0), mtime_ns=d.get("t", 0),
            size=d.get("s", 0), link_target=d.get("l", ""),
            rdev=d.get("r", 0),
            xattrs=dict(d.get("x", {})),
            acl=[tuple(e) for e in d.get("a", [])],
            fcaps=d.get("c", b""),
            quota_project_id=d.get("q", 0),
            payload_offset=d.get("o", -1), digest=d.get("h", b""),
        )

    def encode(self) -> bytes:
        body = codec.encode(self.to_wire())
        return _LEN.pack(len(body)) + body

    @property
    def is_file(self) -> bool:
        return self.kind == KIND_FILE

    @property
    def is_dir(self) -> bool:
        return self.kind == KIND_DIR

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]


def decode_entries(stream: BinaryIO) -> Iterator[Entry]:
    """Iterate length-prefixed entries from a metadata stream."""
    while True:
        hdr = stream.read(4)
        if not hdr:
            return
        if len(hdr) < 4:
            raise ValueError("truncated entry header")
        (n,) = _LEN.unpack(hdr)
        if n > MAX_ENTRY_SIZE:
            raise ValueError(f"entry record too large: {n}")
        body = stream.read(n)
        if len(body) < n:
            raise ValueError("truncated entry body")
        yield Entry.from_wire(codec.decode_map(body))


def read_xattrs(p: str) -> dict[str, bytes]:
    """All xattrs of ``p`` (no symlink follow); POSIX ACLs travel as
    system.posix_acl_* entries.  Unreadable names are skipped — a
    denied xattr must never fail a walk."""
    out: dict[str, bytes] = {}
    try:
        for name in os.listxattr(p, follow_symlinks=False):
            try:
                out[name] = os.getxattr(p, name, follow_symlinks=False)
            except OSError:
                continue
    except OSError:
        pass
    return out


def entry_from_stat(path: str, st: os.stat_result, *,
                    link_target: str = "") -> Entry:
    """Build an Entry from an os.stat result (lstat for symlinks)."""
    m = st.st_mode
    if statmod.S_ISDIR(m):
        kind = KIND_DIR
    elif statmod.S_ISLNK(m):
        kind = KIND_SYMLINK
    elif statmod.S_ISFIFO(m):
        kind = KIND_FIFO
    elif statmod.S_ISSOCK(m):
        kind = KIND_SOCKET
    elif statmod.S_ISCHR(m):
        kind = KIND_DEVICE
    elif statmod.S_ISBLK(m):
        kind = KIND_BLOCKDEV
    else:
        kind = KIND_FILE
    return Entry(
        path=path, kind=kind, mode=statmod.S_IMODE(m),
        uid=st.st_uid, gid=st.st_gid, mtime_ns=st.st_mtime_ns,
        size=st.st_size if kind == KIND_FILE else 0,
        link_target=link_target,
        rdev=st.st_rdev if kind in (KIND_DEVICE, KIND_BLOCKDEV) else 0,
    )
