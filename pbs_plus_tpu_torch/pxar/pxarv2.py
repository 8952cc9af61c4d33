"""pxar v2 binary entry encoding (stock-pxar archive content).

Parity target: the reference consumes the pxar library's format surface —
its commit engine writes FormatVersion2 split archives a stock
proxmox-backup-client can decode
(internal/pxarmount/commit_orchestrate.go:177-200 via
pxar ``transfer.NewSplitReader``/``NewRemoteDedupWriter``; msgpack
"tpxar" entries were the last PBS-compat format gap).
This module implements the pxar v2 *entry* encoding so that with
``datastore_format='pbs'`` the meta/payload streams inside
``root.mpxar.didx``/``root.ppxar.didx`` are pxar binary items, not
msgpack.  The tpxar codec (`format.py`) remains the native-datastore
default.

Wire shape (all integers little-endian; every item is
``header(htype:u64, size:u64)`` where size INCLUDES the 16-byte header):

    meta stream   = FORMAT_VERSION(u64=2)
                    ENTRY(root stat)
                    { FILENAME(name\\0) item-set }*  GOODBYE(root)
    item-set(dir) = ENTRY … children … GOODBYE
    item-set(file)= ENTRY [XATTR…] [ACL…] [FCAPS] [QUOTA_PROJID]
                    PAYLOAD_REF(offset:u64, size:u64)
    item-set(sym) = ENTRY SYMLINK(target\\0)
    item-set(dev) = ENTRY DEVICE(major:u64, minor:u64)
    item-set(hl)  = HARDLINK(offset:u64, target\\0)     (no ENTRY)
    ENTRY payload = mode:u64 flags:u64 uid:u32 gid:u32
                    mtime_secs:i64 mtime_nanos:u32 pad:u32   (40 bytes)
    GOODBYE       = {hash:u64 offset:u64 size:u64}×N in complete-BST
                    order + tail {TAIL_MARKER, dist-to-dir-ENTRY,
                    goodbye-item-size}
    payload stream= PAYLOAD_START_MARKER then per file
                    PAYLOAD(hdr + raw bytes) at PAYLOAD_REF.offset

POSIX ACLs: the walker carries them as raw ``system.posix_acl_*``
xattrs (`format.py` read_xattrs); stock pxar excludes those names from
XATTR items and decomposes them into ACL_* items.  The encoder performs
that decomposition (and FCAPS extraction of ``security.capability``);
the decoder reassembles the xattr form so restore applies them
unchanged.

Constants provenance: the item-type constants and the goodbye SipHash
key below are the published pxar crate format constants
(``pxar/src/format/mod.rs``), reproduced from the public format.  This
build runs in an offline image with neither the pxar crate source nor a
live PBS to cross-check, so — like the index magics in ``pbsformat.py``
— they are pinned in this ONE block with golden tests
(`tests/test_pxarv2.py`); `tools/pbs_interop_check.py` closes the loop
the first time a real PBS is reachable, and this block is the single
update point if it rejects an archive.  A sequential stock decoder
(``proxmox-backup-client restore``) does not consult the goodbye hash
values, so a transcription error there degrades only random access.

A copy of the JAX package's ``pxar/pxarv2.py``, its code byte for byte
apart from its imports, which name the port's own modules."""

from __future__ import annotations

import io
import os
import stat as statmod
import struct
from typing import BinaryIO, Callable, Iterator

from .format import (
    Entry, KIND_BLOCKDEV, KIND_DEVICE, KIND_DIR, KIND_FIFO, KIND_FILE,
    KIND_HARDLINK, KIND_SOCKET, KIND_SYMLINK,
)

# -- pinned pxar v2 constants (see module docstring for provenance) -------
PXAR_FORMAT_VERSION = 0x730F6C75DF16A40D
PXAR_ENTRY = 0xD5956474E588ACEF            # v2 stat entry
PXAR_ENTRY_V1 = 0x11DA850A1C1CCEB0
PXAR_FILENAME = 0x16701121063917B3
PXAR_SYMLINK = 0x27F971E7DBF5DC5F
PXAR_DEVICE = 0x9FC9E906586D5CE9
PXAR_XATTR = 0x0DAB0229B57DCD03
PXAR_ACL_USER = 0x2CE8540A457D55B8
PXAR_ACL_GROUP = 0x136E3ECEB04C03AB
PXAR_ACL_GROUP_OBJ = 0x10868031E9582876
PXAR_ACL_DEFAULT = 0xBBBB13415A6896F5
PXAR_ACL_DEFAULT_USER = 0xC89357B40532CD1F
PXAR_ACL_DEFAULT_GROUP = 0xF90A8A5816038FFE
PXAR_FCAPS = 0x2DA9DD9DB5F7FB67
PXAR_QUOTA_PROJID = 0xE07540E82F7D1CBB
PXAR_HARDLINK = 0x51269C8422BD7275
PXAR_PAYLOAD = 0x28147A1B0195AD71
PXAR_PAYLOAD_REF = 0x419D3D6BC4E977BB
PXAR_PAYLOAD_START_MARKER = 0x834C68C2194A4ED2
PXAR_GOODBYE = 0x2FEC4FA642D5731D
PXAR_GOODBYE_TAIL_MARKER = 0xEF5EED5B753E1555
# goodbye-table filename hash: SipHash-2-4 with this fixed key
GOODBYE_HASH_KEY = (0x8574442B0F1D84B3, 0x2736ED30D1C22EC1)

FORMAT_VERSION_2 = 2
HDR = struct.Struct("<QQ")                 # htype, size (incl. header)
_ENTRY_PAYLOAD = struct.Struct("<QQIIqI4x")  # mode flags uid gid secs nanos
_GOODBYE_ITEM = struct.Struct("<QQQ")
MAX_ITEM_SIZE = 64 << 20                   # decode sanity cap

# security.capability rides in FCAPS; posix ACL xattrs become ACL items
_XATTR_FCAPS = "security.capability"
_XATTR_ACL_ACCESS = "system.posix_acl_access"
_XATTR_ACL_DEFAULT = "system.posix_acl_default"

_KIND_TO_IFMT = {
    KIND_FILE: statmod.S_IFREG, KIND_DIR: statmod.S_IFDIR,
    KIND_SYMLINK: statmod.S_IFLNK, KIND_FIFO: statmod.S_IFIFO,
    KIND_SOCKET: statmod.S_IFSOCK, KIND_DEVICE: statmod.S_IFCHR,
    KIND_BLOCKDEV: statmod.S_IFBLK,
}
_IFMT_TO_KIND = {v: k for k, v in _KIND_TO_IFMT.items()}


def siphash24(data: bytes, k0: int, k1: int) -> int:
    """SipHash-2-4 (64-bit), the goodbye-table filename hash."""
    M = 0xFFFFFFFFFFFFFFFF
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rotl(x: int, b: int) -> int:
        return ((x << b) | (x >> (64 - b))) & M

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & M
            v1 = rotl(v1, 13) ^ v0
            v0 = rotl(v0, 32)
            v2 = (v2 + v3) & M
            v3 = rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & M
            v3 = rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & M
            v1 = rotl(v1, 17) ^ v2
            v2 = rotl(v2, 32)

    b = len(data) & 0xFF
    tail = data[len(data) - (len(data) % 8):]
    for i in range(0, len(data) - len(tail), 8):
        m = int.from_bytes(data[i:i + 8], "little")
        v3 ^= m
        rounds(2)
        v0 ^= m
    m = int.from_bytes(tail, "little") | (b << 56)
    v3 ^= m
    rounds(2)
    v0 ^= m
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1) ^ (v2 ^ v3)


def hash_filename(name: bytes) -> int:
    return siphash24(name, *GOODBYE_HASH_KEY)


def item(htype: int, payload: bytes = b"") -> bytes:
    return HDR.pack(htype, HDR.size + len(payload)) + payload


# -- POSIX ACL xattr <-> pxar ACL items -----------------------------------
# system.posix_acl_* layout: version:u32=2 then (tag:u16, perm:u16,
# id:u32)×N; tags per <linux/posix_acl_xattr.h>
_ACL_VERSION = 2
_ACL_ENT = struct.Struct("<HHI")
_TAG_USER_OBJ, _TAG_USER, _TAG_GROUP_OBJ = 0x01, 0x02, 0x04
_TAG_GROUP, _TAG_MASK, _TAG_OTHER = 0x08, 0x10, 0x20
_ID_UNSET = 0xFFFFFFFF          # u32 ACL_UNDEFINED_ID in the xattr blob
# The stock pxar crate marks an absent permission slot in the u64 fields
# of PXAR_ACL_DEFAULT with u64::MAX ("NO_MASK"), not u32::MAX.
_PERM_UNSET = 0xFFFFFFFFFFFFFFFF
# Snapshots written before the sentinel fix carried u32::MAX in those
# slots; perms are u16-range, so the value is unambiguous — accepted as
# "unset" on DECODE ONLY (the encoder always writes u64::MAX).
_PERM_UNSET_LEGACY = 0xFFFFFFFF


def _perm_is_unset(v: int) -> bool:
    return v == _PERM_UNSET or v == _PERM_UNSET_LEGACY


def _checked_perm(perm: int) -> int:
    """Validate a decoded ACL permission fits the u16 xattr field so a
    malformed stock archive raises ValueError instead of struct.error."""
    if not 0 <= perm <= 0xFFFF:
        raise ValueError(f"ACL permission out of u16 range: {perm:#x}")
    return perm


def _checked_id(eid: int) -> int:
    """Validate a decoded uid/gid fits the u32 xattr id field."""
    if not 0 <= eid <= 0xFFFFFFFF:
        raise ValueError(f"ACL uid/gid out of u32 range: {eid:#x}")
    return eid


def _parse_posix_acl(raw: bytes) -> list[tuple[int, int, int]] | None:
    """[(tag, perm, id)] or None if the blob is not a v2 ACL xattr."""
    if len(raw) < 4 or (len(raw) - 4) % _ACL_ENT.size:
        return None
    if int.from_bytes(raw[:4], "little") != _ACL_VERSION:
        return None
    return [_ACL_ENT.unpack_from(raw, 4 + i * _ACL_ENT.size)
            for i in range((len(raw) - 4) // _ACL_ENT.size)]


def _build_posix_acl(ents: list[tuple[int, int, int]]) -> bytes:
    out = io.BytesIO()
    out.write(_ACL_VERSION.to_bytes(4, "little"))
    order = {_TAG_USER_OBJ: 0, _TAG_USER: 1, _TAG_GROUP_OBJ: 2,
             _TAG_GROUP: 3, _TAG_MASK: 4, _TAG_OTHER: 5}
    for tag, perm, eid in sorted(ents, key=lambda e: (order.get(e[0], 9),
                                                      e[2])):
        out.write(_ACL_ENT.pack(tag, perm, eid))
    return out.getvalue()


def _acl_items_from_xattr(raw: bytes, default: bool) -> list[bytes]:
    """Decompose one posix-acl xattr blob into pxar ACL items.  The
    USER_OBJ/OTHER (and for access ACLs the mask-less GROUP_OBJ) slots
    live in the entry mode, so only the named/default parts get items."""
    ents = _parse_posix_acl(raw)
    if ents is None:
        return []
    items: list[bytes] = []
    by_tag: dict[int, list[tuple[int, int, int]]] = {}
    for e in ents:
        by_tag.setdefault(e[0], []).append(e)
    if not default:
        for _, perm, eid in by_tag.get(_TAG_USER, []):
            items.append(item(PXAR_ACL_USER, struct.pack("<QQ", eid, perm)))
        for _, perm, eid in by_tag.get(_TAG_GROUP, []):
            items.append(item(PXAR_ACL_GROUP, struct.pack("<QQ", eid, perm)))
        if _TAG_MASK in by_tag and _TAG_GROUP_OBJ in by_tag:
            # with a mask, the mode group bits carry the mask — the real
            # group-obj permissions need their own item
            items.append(item(PXAR_ACL_GROUP_OBJ, struct.pack(
                "<Q", by_tag[_TAG_GROUP_OBJ][0][1])))
    else:
        def _perm(tag: int) -> int:
            return by_tag[tag][0][1] if tag in by_tag else _PERM_UNSET
        items.append(item(PXAR_ACL_DEFAULT, struct.pack(
            "<QQQQ", _perm(_TAG_USER_OBJ), _perm(_TAG_GROUP_OBJ),
            _perm(_TAG_OTHER), _perm(_TAG_MASK))))
        for _, perm, eid in by_tag.get(_TAG_USER, []):
            items.append(item(PXAR_ACL_DEFAULT_USER,
                              struct.pack("<QQ", eid, perm)))
        for _, perm, eid in by_tag.get(_TAG_GROUP, []):
            items.append(item(PXAR_ACL_DEFAULT_GROUP,
                              struct.pack("<QQ", eid, perm)))
    return items


class _AclAssembler:
    """Decoder side: collect ACL items back into the xattr blobs."""

    def __init__(self) -> None:
        self.access: list[tuple[int, int, int]] = []
        self.default: list[tuple[int, int, int]] = []
        self.group_obj: int | None = None
        self.default_head: tuple[int, int, int, int] | None = None

    def feed(self, htype: int, payload: bytes) -> bool:
        if htype == PXAR_ACL_USER:
            eid, perm = struct.unpack("<QQ", payload)
            self.access.append((_TAG_USER, _checked_perm(perm), _checked_id(eid)))
        elif htype == PXAR_ACL_GROUP:
            eid, perm = struct.unpack("<QQ", payload)
            self.access.append((_TAG_GROUP, _checked_perm(perm), _checked_id(eid)))
        elif htype == PXAR_ACL_GROUP_OBJ:
            (self.group_obj,) = struct.unpack("<Q", payload)
            self.group_obj = _checked_perm(self.group_obj)
        elif htype == PXAR_ACL_DEFAULT:
            self.default_head = struct.unpack("<QQQQ", payload)
        elif htype == PXAR_ACL_DEFAULT_USER:
            eid, perm = struct.unpack("<QQ", payload)
            self.default.append((_TAG_USER, _checked_perm(perm), _checked_id(eid)))
        elif htype == PXAR_ACL_DEFAULT_GROUP:
            eid, perm = struct.unpack("<QQ", payload)
            self.default.append((_TAG_GROUP, _checked_perm(perm), _checked_id(eid)))
        else:
            return False
        return True

    def into_xattrs(self, xattrs: dict[str, bytes], mode: int) -> None:
        if self.access or self.group_obj is not None:
            ents = [(_TAG_USER_OBJ, (mode >> 6) & 7, _ID_UNSET)]
            ents += self.access
            if self.group_obj is not None:
                ents.append((_TAG_GROUP_OBJ, self.group_obj, _ID_UNSET))
                ents.append((_TAG_MASK, (mode >> 3) & 7, _ID_UNSET))
            else:
                ents.append((_TAG_GROUP_OBJ, (mode >> 3) & 7, _ID_UNSET))
            ents.append((_TAG_OTHER, mode & 7, _ID_UNSET))
            xattrs[_XATTR_ACL_ACCESS] = _build_posix_acl(ents)
        if self.default_head is not None or self.default:
            ents = []
            if self.default_head is not None:
                uo, go, ot, mask = self.default_head
                if not _perm_is_unset(uo):
                    ents.append((_TAG_USER_OBJ, _checked_perm(uo), _ID_UNSET))
                if not _perm_is_unset(go):
                    ents.append((_TAG_GROUP_OBJ, _checked_perm(go), _ID_UNSET))
                if not _perm_is_unset(ot):
                    ents.append((_TAG_OTHER, _checked_perm(ot), _ID_UNSET))
                if not _perm_is_unset(mask):
                    ents.append((_TAG_MASK, _checked_perm(mask), _ID_UNSET))
            ents += self.default
            xattrs[_XATTR_ACL_DEFAULT] = _build_posix_acl(ents)


# -- goodbye-table BST layout ---------------------------------------------

def _bst_order(items: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
    """Arrange hash-sorted goodbye items into complete-BST (heap) order."""
    items = sorted(items, key=lambda t: t[0])
    n = len(items)
    out: list[tuple[int, int, int] | None] = [None] * n

    def left_count(n: int) -> int:
        if n <= 1:
            return 0
        h = n.bit_length() - 1
        bottom_cap = 1 << h
        internal = bottom_cap - 1
        bottom = n - internal
        return (internal - 1) // 2 + min(bottom, bottom_cap // 2)

    def place(lo: int, n: int, pos: int) -> None:
        if n == 0:
            return
        left = left_count(n)
        out[pos] = items[lo + left]
        place(lo, left, 2 * pos + 1)
        place(lo + left + 1, n - left - 1, 2 * pos + 2)

    place(0, n, 0)
    return out  # type: ignore[return-value]


# -- encoder ---------------------------------------------------------------

class _DirFrame:
    __slots__ = ("path", "entry_start", "children")

    def __init__(self, path: str, entry_start: int):
        self.path = path
        self.entry_start = entry_start
        # (filename-hash, FILENAME item start, end of item-set)
        self.children: list[tuple[int, int, int]] = []


class Pxar2Encoder:
    """Streaming meta-stream encoder fed flat DFS-ordered Entries (the
    SessionWriter contract); directory opens/closes are inferred from the
    paths, goodbye tables emitted at each close."""

    def __init__(self, write: Callable[[bytes], None]):
        self._write = write
        self.offset = 0
        self._stack: list[_DirFrame] = []
        self._entry_offsets: dict[str, int] = {}   # path -> ENTRY item start
        self._started = False

    # -- low level --------------------------------------------------------
    def _emit(self, data: bytes) -> None:
        self._write(data)
        self.offset += len(data)

    def _start(self) -> None:
        self._emit(item(PXAR_FORMAT_VERSION,
                        struct.pack("<Q", FORMAT_VERSION_2)))
        self._started = True

    @staticmethod
    def _stat_payload(e: Entry) -> bytes:
        mode = _KIND_TO_IFMT.get(e.kind, statmod.S_IFREG) | (e.mode & 0o7777)
        secs, nanos = divmod(e.mtime_ns, 1_000_000_000)
        return _ENTRY_PAYLOAD.pack(mode, 0, e.uid, e.gid, secs, nanos)

    def _meta_items(self, e: Entry) -> list[bytes]:
        items: list[bytes] = []
        fcaps = e.fcaps
        for name in sorted(e.xattrs):
            if name == _XATTR_ACL_ACCESS or name == _XATTR_ACL_DEFAULT:
                continue
            if name == _XATTR_FCAPS:
                fcaps = fcaps or e.xattrs[name]
                continue
            items.append(item(PXAR_XATTR,
                              name.encode() + b"\0" + e.xattrs[name]))
        if _XATTR_ACL_ACCESS in e.xattrs:
            items += _acl_items_from_xattr(e.xattrs[_XATTR_ACL_ACCESS],
                                           default=False)
        if _XATTR_ACL_DEFAULT in e.xattrs:
            items += _acl_items_from_xattr(e.xattrs[_XATTR_ACL_DEFAULT],
                                           default=True)
        if fcaps:
            items.append(item(PXAR_FCAPS, fcaps))
        if e.quota_project_id:
            items.append(item(PXAR_QUOTA_PROJID,
                              struct.pack("<Q", e.quota_project_id)))
        return items

    # -- directory tracking ----------------------------------------------
    def _close_dir(self) -> None:
        frame = self._stack.pop()
        gb_start = self.offset
        gitems = [(h, gb_start - child_start, end - child_start)
                  for h, child_start, end in frame.children]
        body = b"".join(_GOODBYE_ITEM.pack(*it)
                        for it in _bst_order(gitems))
        gb_size = HDR.size + len(body) + _GOODBYE_ITEM.size
        tail = _GOODBYE_ITEM.pack(PXAR_GOODBYE_TAIL_MARKER,
                                  gb_start - frame.entry_start, gb_size)
        self._emit(HDR.pack(PXAR_GOODBYE, gb_size) + body + tail)
        if self._stack:
            # the finished dir's item-set end becomes known only now
            h, fstart, _ = self._stack[-1].children[-1]
            self._stack[-1].children[-1] = (h, fstart, self.offset)

    def _sync_to_parent(self, path: str) -> None:
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        while self._stack and self._stack[-1].path != parent:
            self._close_dir()
        if not self._stack and path:
            raise ValueError(f"entry {path!r} outside any open directory")

    # -- public -----------------------------------------------------------
    def entry(self, e: Entry, payload_ref: tuple[int, int] | None) -> None:
        """Emit one entry.  ``payload_ref=(payload_item_offset, size)``
        for non-empty files (offset of the PXAR_PAYLOAD header in the
        payload stream)."""
        if not self._started:
            self._start()
        if e.path == "":
            if e.kind != KIND_DIR:
                raise ValueError("root must be a directory")
            self._entry_offsets[""] = self.offset
            self._emit(item(PXAR_ENTRY, self._stat_payload(e)))
            for m in self._meta_items(e):
                self._emit(m)
            self._stack.append(_DirFrame("", self._entry_offsets[""]))
            return
        self._sync_to_parent(e.path)
        name = e.name.encode()
        fstart = self.offset
        self._emit(item(PXAR_FILENAME, name + b"\0"))
        if e.kind == KIND_HARDLINK:
            target = e.link_target.strip("/")
            if target not in self._entry_offsets:
                # a wrong back-offset would send a stock decoder to a
                # garbage position — refuse rather than encode it
                raise ValueError(
                    f"hardlink {e.path!r} targets {target!r}, which is "
                    f"not an already-encoded entry")
            back = self.offset - self._entry_offsets[target]
            self._emit(item(PXAR_HARDLINK,
                            struct.pack("<Q", back) +
                            target.encode() + b"\0"))
        else:
            self._entry_offsets[e.path] = self.offset
            self._emit(item(PXAR_ENTRY, self._stat_payload(e)))
            for m in self._meta_items(e):
                self._emit(m)
            if e.kind == KIND_FILE:
                if payload_ref is not None:
                    off, size = payload_ref
                    self._emit(item(PXAR_PAYLOAD_REF,
                                    struct.pack("<QQ", off, size)))
                else:
                    # Every file — even an empty one — must carry a ref
                    # at a real PAYLOAD item header; a REF(0,0) aimed at
                    # the start marker does not validate under a stock
                    # accessor.  SessionWriter routes empty files through
                    # _write_file_pxar2, which writes the zero-length
                    # item, so hitting this branch is a writer bug
                    # (the old silent REF(0,0) fallback).
                    raise ValueError(
                        f"file {e.path!r} needs a payload_ref "
                        f"(zero-length PAYLOAD item for empty files)")
            elif e.kind == KIND_SYMLINK:
                self._emit(item(PXAR_SYMLINK,
                                e.link_target.encode() + b"\0"))
            elif e.kind in (KIND_DEVICE, KIND_BLOCKDEV):
                self._emit(item(PXAR_DEVICE,
                                struct.pack("<QQ", os.major(e.rdev),
                                            os.minor(e.rdev))))
            # FIFO/SOCKET: the ENTRY mode alone describes them
        self._stack[-1].children.append(
            (hash_filename(name), fstart, self.offset))
        if e.kind == KIND_DIR:
            self._stack.append(_DirFrame(e.path, self._entry_offsets[e.path]))

    def finish(self) -> None:
        if not self._started:
            self._start()
        if not self._stack:
            # empty archive: synthesize a bare root
            self.entry(Entry(path="", kind=KIND_DIR, mode=0o755), None)
        while self._stack:
            self._close_dir()


def payload_start_marker() -> bytes:
    return HDR.pack(PXAR_PAYLOAD_START_MARKER, HDR.size)


def payload_header(size: int) -> bytes:
    """Header preceding each file's raw bytes in the payload stream."""
    return HDR.pack(PXAR_PAYLOAD, HDR.size + size)


PAYLOAD_HDR_SIZE = HDR.size


# -- decoder ---------------------------------------------------------------

def _read_item(stream: BinaryIO) -> tuple[int, bytes] | None:
    hdr = stream.read(HDR.size)
    if not hdr:
        return None
    if len(hdr) < HDR.size:
        raise ValueError("truncated pxar item header")
    htype, size = HDR.unpack(hdr)
    if size < HDR.size or size - HDR.size > MAX_ITEM_SIZE:
        raise ValueError(f"implausible pxar item size {size}")
    payload = stream.read(size - HDR.size)
    if len(payload) < size - HDR.size:
        raise ValueError("truncated pxar item payload")
    return htype, payload


def _entry_from_stat_payload(payload: bytes, path: str) -> Entry:
    mode, _flags, uid, gid, secs, nanos = _ENTRY_PAYLOAD.unpack(payload)
    kind = _IFMT_TO_KIND.get(statmod.S_IFMT(mode), KIND_FILE)
    return Entry(path=path, kind=kind, mode=mode & 0o7777, uid=uid,
                 gid=gid, mtime_ns=secs * 1_000_000_000 + nanos)


def decode_pxar2(stream: BinaryIO) -> Iterator[Entry]:
    """Sequential decode of a pxar v2 meta stream into flat Entries with
    archive-relative paths (the tpxar Entry model, so every consumer —
    SplitReader tree, restore, verify, zipdl — works unchanged).
    Goodbye tables are validated for frame shape and skipped; payload
    refs become content offsets (ref offset + payload header size)."""
    first = _read_item(stream)
    if first is None:
        return
    htype, payload = first
    if htype != PXAR_FORMAT_VERSION:
        raise ValueError("not a pxar v2 stream (missing format version)")
    version = struct.unpack("<Q", payload[:8])[0] if len(payload) >= 8 else 0
    if version != FORMAT_VERSION_2:
        raise ValueError(f"unsupported pxar format version {version}")

    dir_stack: list[str] = []
    pending_name: str | None = None
    cur: Entry | None = None
    acl: _AclAssembler | None = None

    def flush_cur() -> Entry | None:
        nonlocal cur, acl
        if cur is None:
            return None
        if acl is not None:
            acl.into_xattrs(cur.xattrs, cur.mode)
        out, cur, acl = cur, None, None
        return out

    while True:
        it = _read_item(stream)
        if it is None:
            break
        htype, payload = it
        if htype == PXAR_ENTRY or htype == PXAR_ENTRY_V1:
            if htype == PXAR_ENTRY_V1:
                raise ValueError("pxar v1 entries unsupported")
            done = flush_cur()
            if done is not None:
                yield done
                if done.is_dir:
                    dir_stack.append(done.path)
            if pending_name is None:
                # only the root entry arrives without a FILENAME
                if dir_stack or done is not None:
                    raise ValueError("ENTRY without preceding FILENAME")
                path = ""
            else:
                parent = dir_stack[-1] if dir_stack else ""
                path = f"{parent}/{pending_name}" if parent else pending_name
            pending_name = None
            cur = _entry_from_stat_payload(payload, path)
            acl = _AclAssembler()
        elif htype == PXAR_FILENAME:
            done = flush_cur()
            if done is not None:
                yield done
                if done.is_dir:
                    dir_stack.append(done.path)
            pending_name = payload.rstrip(b"\0").decode()
        elif htype == PXAR_GOODBYE:
            done = flush_cur()
            if done is not None:
                yield done
                if done.is_dir:
                    dir_stack.append(done.path)
            if (len(payload) % _GOODBYE_ITEM.size) != 0 or not payload:
                raise ValueError("malformed goodbye table")
            tail = _GOODBYE_ITEM.unpack_from(
                payload, len(payload) - _GOODBYE_ITEM.size)
            if tail[0] != PXAR_GOODBYE_TAIL_MARKER:
                raise ValueError("goodbye table missing tail marker")
            if not dir_stack:
                raise ValueError("goodbye without open directory")
            dir_stack.pop()
            if not dir_stack:
                break                           # root closed: archive end
        elif htype == PXAR_PAYLOAD_REF:
            if cur is None or cur.kind != KIND_FILE:
                raise ValueError("payload ref outside a file entry")
            off, size = struct.unpack("<QQ", payload)
            cur.size = size
            cur.payload_offset = (off + PAYLOAD_HDR_SIZE) if size else -1
        elif htype == PXAR_SYMLINK:
            if cur is None:
                raise ValueError("symlink item outside an entry")
            cur.link_target = payload.rstrip(b"\0").decode()
        elif htype == PXAR_DEVICE:
            if cur is None:
                raise ValueError("device item outside an entry")
            major, minor = struct.unpack("<QQ", payload)
            cur.rdev = os.makedev(major, minor)
        elif htype == PXAR_HARDLINK:
            if pending_name is None:
                raise ValueError("hardlink without preceding FILENAME")
            target = payload[8:].rstrip(b"\0").decode()
            parent = dir_stack[-1] if dir_stack else ""
            path = f"{parent}/{pending_name}" if parent else pending_name
            pending_name = None
            yield Entry(path=path, kind=KIND_HARDLINK, link_target=target)
        elif htype == PXAR_XATTR:
            if cur is None:
                raise ValueError("xattr item outside an entry")
            name, _, value = payload.partition(b"\0")
            cur.xattrs[name.decode()] = value
        elif htype == PXAR_FCAPS:
            if cur is None:
                raise ValueError("fcaps item outside an entry")
            cur.fcaps = payload
        elif htype == PXAR_QUOTA_PROJID:
            if cur is None:
                raise ValueError("quota item outside an entry")
            (cur.quota_project_id,) = struct.unpack("<Q", payload)
        elif acl is not None and acl.feed(htype, payload):
            pass
        else:
            raise ValueError(f"unknown pxar item type {htype:#x}")
    last = flush_cur()
    if last is not None:
        yield last


def sniff_is_pxar2(first8: bytes) -> bool:
    """True when a meta stream starts with the v2 FORMAT_VERSION item
    (tpxar streams start with a u32 record length < 16 MiB, which can
    never alias this 8-byte constant)."""
    return len(first8) >= 8 and \
        struct.unpack("<Q", first8[:8])[0] == PXAR_FORMAT_VERSION
