"""Chunker-backend observability, copied from the JAX package's
``chunker/observe.py``: which scan implementation touched how many payload
bytes, plus named event counters.  Backend labels: ``numpy`` (the scalar
scan, chunker/cpu.py), ``native`` (its C++ rolling scan, chunker/native.py),
``vector`` (the vectorized native scan, chunker/vector.py),
``vector-numpy`` (its blocked-numpy fallback), ``sidecar`` (bytes shipped
to a dedup sidecar's chunker) and ``cuda`` (the port's device scan, K1,
ops/rolling_hash.py).  Events: ``vector_fallbacks`` (a stream bound to the
scalar chunker after the vector self-test failed).  Prefix/halo bytes are
not counted, so the figures compare across backends.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_scan_bytes: dict[str, int] = {}
_events: dict[str, int] = {}


def add_scan_bytes(backend: str, n: int) -> None:
    """Record ``n`` payload bytes scanned by ``backend``."""
    if n <= 0:
        return
    with _lock:
        _scan_bytes[backend] = _scan_bytes.get(backend, 0) + int(n)


def add_event(name: str, n: int = 1) -> None:
    """Bump a named counter (e.g. ``vector_fallbacks``)."""
    with _lock:
        _events[name] = _events.get(name, 0) + int(n)


def snapshot() -> dict:
    """{"scan_bytes": {backend: bytes}, "events": {name: count}}."""
    with _lock:
        return {"scan_bytes": dict(_scan_bytes), "events": dict(_events)}


def reset() -> None:
    """Test support: zero every counter."""
    with _lock:
        _scan_bytes.clear()
        _events.clear()
