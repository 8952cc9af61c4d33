"""Zip download of archive subtrees.

Reference: internal/pxar/zip.go — the UI's "download as zip" for a
directory inside a snapshot.  Streams entries from a SplitReader into a
zip (stored or deflated), preserving mtimes and modes.

A copy of the JAX package's ``pxar/zipdl.py``, its code byte for
byte; the ``SplitReader`` it reads is the port's (``pxar/transfer.py``).
"""

from __future__ import annotations

import io
import os
import shutil
import zipfile
from typing import BinaryIO

from .format import Entry, KIND_DIR, KIND_FILE, KIND_HARDLINK, KIND_SYMLINK
from .transfer import SplitReader

_COPY_WINDOW = 1 << 20


def _write_file(zf: zipfile.ZipFile, info: zipfile.ZipInfo,
                reader: SplitReader, entry: Entry) -> None:
    """Stream one file into the zip through the chunk cache: window-sized
    copies from a sequential range reader (readahead-friendly) instead of
    materializing the whole file — a multi-GiB member costs one chunk of
    resident memory, and shared chunks across members decompress once."""
    src, size = reader.file_reader(entry)
    info.file_size = size
    with zf.open(info, "w", force_zip64=size >= (1 << 31)) as dst:
        shutil.copyfileobj(src, dst, _COPY_WINDOW)


def zip_subtree(reader: SplitReader, subpath: str = "", *,
                out: BinaryIO | None = None,
                compression: int = zipfile.ZIP_DEFLATED) -> BinaryIO:
    """Write ``subpath`` (and everything below) into a zip stream."""
    out = out or io.BytesIO()
    sub = subpath.strip("/")
    root = reader.lookup(sub)
    if root is None:
        raise FileNotFoundError(subpath or "/")
    with zipfile.ZipFile(out, "w", compression=compression) as zf:
        def emit(e: Entry) -> None:
            rel = e.path[len(sub):].lstrip("/") if sub else e.path
            if not rel and e.is_dir:
                # the subtree root itself is implicit — emit its children
                for child in reader.read_dir(e.path):
                    emit(child)
                return
            if not rel:
                rel = os.path.basename(e.path)   # zipping a single file
            mtime = max(0, e.mtime_ns) // 1_000_000_000
            import time as _t
            date = _t.localtime(mtime)[:6]
            if date[0] < 1980:
                date = (1980, 1, 1, 0, 0, 0)
            if e.is_dir:
                info = zipfile.ZipInfo(rel + "/", date_time=date)
                info.external_attr = ((0o40000 | (e.mode & 0o7777)) << 16)
                zf.writestr(info, b"")
                for child in reader.read_dir(e.path):
                    emit(child)
            elif e.kind == KIND_FILE:
                info = zipfile.ZipInfo(rel, date_time=date)
                info.external_attr = ((0o100000 | (e.mode & 0o7777)) << 16)
                _write_file(zf, info, reader, e)
            elif e.kind == KIND_SYMLINK:
                info = zipfile.ZipInfo(rel, date_time=date)
                info.external_attr = ((0o120000 | 0o777) << 16)
                zf.writestr(info, e.link_target)
            elif e.kind == KIND_HARDLINK:
                # zip has no hardlinks: duplicate the target's content
                target = reader.lookup(e.link_target)
                info = zipfile.ZipInfo(rel, date_time=date)
                info.external_attr = ((0o100000 | (e.mode & 0o7777)) << 16)
                if target is not None and target.is_file:
                    _write_file(zf, info, reader, target)
                else:
                    zf.writestr(info, b"")
        emit(root)
    out.seek(0)
    return out
