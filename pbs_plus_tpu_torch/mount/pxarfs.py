"""ArchiveView — the immutable archive side of a mount, with HotSwap.

Reference: internal/pxarmount/pxarfs.go:24-727 — slim dirent cache with
inode registry, stale eviction, and ``HotSwap(reader)`` replacing the
archive under a live mount after a commit.

A copy of the JAX package's ``mount/pxarfs.py``, its code byte for byte
apart from its imports, which name the port's own modules (the view
serves the port's ``SplitReader``); it logs through ``logging``.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..pxar.format import Entry
from ..pxar.transfer import SplitReader

L = logging.getLogger(__name__)


class ArchiveView:
    def __init__(self, reader: SplitReader | None):
        self._reader = reader
        self._lock = threading.RLock()
        self.generation = 0
        self.stats = {"lookups": 0, "reads": 0, "bytes": 0, "swaps": 0}

    @property
    def reader(self) -> Optional[SplitReader]:
        with self._lock:
            return self._reader

    def hot_swap(self, reader: SplitReader) -> None:
        """Replace the archive under the live mount (reference: HotSwap —
        performed only after a successful commit publish).  The displaced
        reader's chunk source is closed if it holds a connection (PBS
        reader sessions) — one leaked socket per commit otherwise."""
        with self._lock:
            old = self._reader
            self._reader = reader
            self.generation += 1
            self.stats["swaps"] += 1
        if old is not None and old is not reader:
            close = getattr(old.store, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as e:
                    L.debug("old reader store close after swap: %s", e)

    # -- lookups (None-safe for init-mode empty mounts) --------------------
    def lookup(self, path: str) -> Optional[Entry]:
        self.stats["lookups"] += 1
        r = self.reader
        if r is None:
            return Entry(path="", kind="d", mode=0o755) if path.strip("/") == "" else None
        return r.lookup(path)

    def read_dir(self, path: str) -> list[Entry]:
        r = self.reader
        if r is None:
            if path.strip("/") == "":
                return []
            raise FileNotFoundError(path)
        return r.read_dir(path)

    def read_file(self, entry: Entry, off: int = 0, size: int = -1) -> bytes:
        r = self.reader
        if r is None:
            raise FileNotFoundError(entry.path)
        # goes through the reader's chunk cache (pxar/chunkcache.py):
        # FUSE issues window-sized reads, the cache's readahead turns a
        # sequential file read into prefetched whole-chunk loads and the
        # window re-reads into decompress-free hits
        data = r.read_file(entry, off, size)
        self.stats["reads"] += 1
        self.stats["bytes"] += len(data)
        hits, misses = r.cache_stats
        self.stats["cache_hits"] = hits
        self.stats["cache_misses"] = misses
        return data
