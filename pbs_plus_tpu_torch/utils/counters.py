"""Tiny thread-safe counter bundle — the module-level METRICS pattern
(`METRICS` dict + lock + `_count` + `metrics_snapshot`) that subsystem
modules kept hand-rolling.  New subsystems hold one
``Counters`` and export thin module-level wrappers; the older copies
(pxar/chunkindex.py, pxar/chunkcache.py) predate this helper.

A copy of the JAX package's ``utils/counters.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import threading


class Counters:
    __slots__ = ("_lock", "_values")

    def __init__(self, *names: str) -> None:
        self._lock = threading.Lock()
        self._values = {n: 0 for n in names}    # guarded-by: self._lock

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._values[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)
