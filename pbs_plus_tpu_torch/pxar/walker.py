"""Filesystem → archive walker: DFS in archive order with content readers.

Reference capability: the scan/walk phase of the commit pipeline and the
proxmox-backup-client's own tree walker (our build owns the archive writer —
SURVEY §2.9: no exec of the PBS client).  Used by the local backup path and
by tests to build golden archives from real trees.

A copy of the JAX package's ``pxar/walker.py``, its code byte for byte;
its imports are relative, so they name the port's own ``pxar.format``.
"""

from __future__ import annotations

import os
import stat as statmod
from typing import Callable, Iterator

from .format import Entry, KIND_HARDLINK, entry_from_stat, read_xattrs

ExcludeFn = Callable[[str], bool]


def iter_tree(root: str, *, exclude: ExcludeFn | None = None,
              one_file_system: bool = False,
              on_error: Callable[[str, OSError], None] | None = None,
              ) -> Iterator[tuple[Entry, str | None]]:
    """Yield (entry, abs_source_path|None) in strict DFS archive order.

    - entries carry archive-relative paths ("" for the root dir)
    - hardlinks (same dev/inode seen twice) become KIND_HARDLINK entries
      pointing at the first-seen path (reference: internal/pxar/hardlink.go)
    - ``exclude`` receives the archive-relative path; True skips (dirs are
      pruned whole)
    - unreadable entries are reported via ``on_error`` and skipped
    """
    root = os.path.abspath(root)
    st_root = os.stat(root)
    root_dev = st_root.st_dev
    seen_inodes: dict[tuple[int, int], str] = {}

    root_entry = entry_from_stat("", st_root)
    root_entry.xattrs = read_xattrs(root)
    yield root_entry, None

    def walk(dir_abs: str, dir_rel: str) -> Iterator[tuple[Entry, str | None]]:
        try:
            names = sorted(os.listdir(dir_abs))
        except OSError as e:
            if on_error:
                on_error(dir_rel, e)
            return
        for name in names:
            abs_p = os.path.join(dir_abs, name)
            rel_p = f"{dir_rel}/{name}" if dir_rel else name
            if exclude and exclude(rel_p):
                continue
            try:
                st = os.lstat(abs_p)
            except OSError as e:
                if on_error:
                    on_error(rel_p, e)
                continue
            if one_file_system and st.st_dev != root_dev:
                continue
            if statmod.S_ISLNK(st.st_mode):
                # multiply-linked symlinks are hardlink entries too (rsync
                # -H parity): the restore side links the symlink node
                # itself via link(follow_symlinks=False)
                key = (st.st_dev, st.st_ino)
                if st.st_nlink > 1 and key in seen_inodes:
                    e = entry_from_stat(rel_p, st)
                    e.kind = KIND_HARDLINK
                    e.link_target = seen_inodes[key]
                    yield e, None
                    continue
                if st.st_nlink > 1:
                    seen_inodes[key] = rel_p
                try:
                    target = os.readlink(abs_p)
                except OSError as e:
                    if on_error:
                        on_error(rel_p, e)
                    continue
                yield entry_from_stat(rel_p, st, link_target=target), None
            elif statmod.S_ISDIR(st.st_mode):
                e = entry_from_stat(rel_p, st)
                e.xattrs = read_xattrs(abs_p)
                yield e, None
                yield from walk(abs_p, rel_p)
            elif statmod.S_ISREG(st.st_mode):
                key = (st.st_dev, st.st_ino)
                if st.st_nlink > 1 and key in seen_inodes:
                    e = entry_from_stat(rel_p, st)
                    e.kind = KIND_HARDLINK
                    e.link_target = seen_inodes[key]
                    e.size = 0
                    yield e, None
                else:
                    if st.st_nlink > 1:
                        seen_inodes[key] = rel_p
                    e = entry_from_stat(rel_p, st)
                    e.xattrs = read_xattrs(abs_p)
                    yield e, abs_p
            else:
                # fifo / socket / char+block device — metadata only
                e = entry_from_stat(rel_p, st)
                e.xattrs = read_xattrs(abs_p)
                yield e, None

    yield from walk(root, "")


def backup_tree(session, root: str, *, exclude: ExcludeFn | None = None,
                on_error=None, counters: dict | None = None) -> int:
    """Stream a directory tree into a BackupSession's writer.  Returns the
    number of entries written; ``counters`` (optional dict) accumulates
    ``files``/``bytes`` for job stats.  (The minimal end-to-end slice's
    local-target path; the agent path streams the same entries over aRPC.)

    When the session carries a ``resume_plan`` (checkpoint resume,
    server/checkpoint.py), files the crashed run fully committed with
    unchanged stat are spliced via ``write_entry_ref`` — no re-read, no
    re-chunk, no re-hash; only the tail streams."""
    w = session.writer
    plan = getattr(session, "resume_plan", None)
    n = 0
    for entry, src in iter_tree(root, exclude=exclude, on_error=on_error):
        if src is not None:
            if plan is not None:
                src_e = plan.skip_ref(entry.path, entry.size,
                                      entry.mtime_ns)
                if src_e is not None:
                    entry.digest = src_e.digest
                    w.write_entry_ref(entry, src_e.payload_offset,
                                      src_e.size)
                    if counters is not None:
                        counters["files"] = counters.get("files", 0) + 1
                    n += 1
                    continue
            try:
                with open(src, "rb") as f:
                    w.write_entry_reader(entry, f)
            except OSError as e:
                if on_error:
                    on_error(entry.path, e)
                continue
            if plan is not None:
                plan.note_reread(entry.size, files=1)
            if counters is not None:
                counters["files"] = counters.get("files", 0) + 1
                counters["bytes"] = counters.get("bytes", 0) + entry.size
        else:
            w.write_entry(entry)
        n += 1
    return n
