"""Bounded-memory spool between the tape reader and the dedup writer.

Reference: internal/tapeio/feeder.go (623 LoC) + converter.go:36-57
(SpoolCapBytes) — tape drives stream fastest sequentially; the spool lets
the reader run ahead of the writer while capping memory, falling back to
disk when the cap is exceeded (the reference's disk-backed spool).

A copy of the JAX package's ``tapeio/feeder.py``, its code byte for
byte.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

DEFAULT_CAP = 256 << 20


@dataclass
class _Item:
    data: bytes | None = None        # in-memory block
    disk_path: str | None = None     # spilled block
    eof: bool = False
    error: BaseException | None = None


class Spool:
    """Single-producer single-consumer byte spool with a memory cap and
    disk spill; ``write``/``close`` on the producer side, ``read`` on the
    consumer side (blocking)."""

    def __init__(self, *, mem_cap: int = DEFAULT_CAP,
                 spill_dir: str | None = None, block: int = 4 << 20):
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._mem = 0
        self._mem_cap = mem_cap
        self._block = block
        self._cv = threading.Condition()
        self._spill_dir = spill_dir
        self._disk_paths: set[str] = set()
        self._closed = False
        self.stats = {"bytes": 0, "spilled": 0}

    # -- producer ----------------------------------------------------------
    def write(self, data: bytes) -> None:
        if self._closed:
            raise ValueError("spool closed")
        view = memoryview(data)
        while view:
            chunk = bytes(view[:self._block])
            view = view[self._block:]
            with self._cv:
                if self._mem + len(chunk) > self._mem_cap:
                    self._spill(chunk)
                    continue
                self._mem += len(chunk)
            self._q.put(_Item(data=chunk))
            self.stats["bytes"] += len(chunk)

    def _spill(self, chunk: bytes) -> None:
        d = self._spill_dir or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        fd, p = tempfile.mkstemp(prefix="pbs-spool-", suffix=".blk", dir=d)
        with os.fdopen(fd, "wb") as f:
            f.write(chunk)
        self._disk_paths.add(p)
        self._q.put(_Item(disk_path=p))
        self.stats["bytes"] += len(chunk)
        self.stats["spilled"] += len(chunk)

    def fail(self, exc: BaseException) -> None:
        self._q.put(_Item(error=exc))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(_Item(eof=True))

    def cleanup(self) -> None:
        """Remove spill files the consumer never read (abandoned stream)."""
        for p in list(self._disk_paths):
            self._disk_paths.discard(p)
            try:
                os.unlink(p)
            except OSError:
                pass

    # -- consumer ----------------------------------------------------------
    def blocks(self) -> Iterator[bytes]:
        while True:
            item = self._q.get()
            if item.eof:
                return
            if item.error is not None:
                raise item.error
            if item.disk_path is not None:
                try:
                    with open(item.disk_path, "rb") as f:
                        yield f.read()
                finally:
                    self._disk_paths.discard(item.disk_path)
                    try:
                        os.unlink(item.disk_path)
                    except OSError:
                        pass
            else:
                assert item.data is not None
                with self._cv:
                    self._mem -= len(item.data)
                    self._cv.notify_all()
                yield item.data


class SpoolReader:
    """File-like .read(n) over a Spool's block iterator (feeds
    write_entry_reader)."""

    def __init__(self, spool: Spool):
        self._it = spool.blocks()
        self._buf = b""
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        while not self._buf and not self._eof:
            try:
                self._buf = next(self._it)
            except StopIteration:
                self._eof = True
        if not self._buf:
            return b""
        if n < 0 or n >= len(self._buf):
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return out
