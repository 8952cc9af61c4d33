"""Thread-safe typed map (reference: internal/safemap/safemap.go:7-14, a thin
generic wrapper over xsync.Map).  Python dicts are GIL-atomic for single ops,
but the reference API includes compound ops (GetOrSet, compute) that need a
lock, so we provide the same surface explicitly.

A copy of the JAX package's ``utils/safemap.py``, its code byte for
byte."""

from __future__ import annotations

import threading
from typing import Callable, Generic, Iterator, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class SafeMap(Generic[K, V]):
    def __init__(self) -> None:
        self._d: dict[K, V] = {}
        self._lock = threading.RLock()

    def get(self, key: K, default: V | None = None) -> V | None:
        with self._lock:
            return self._d.get(key, default)

    def set(self, key: K, value: V) -> None:
        with self._lock:
            self._d[key] = value

    def get_or_set(self, key: K, factory: Callable[[], V]) -> tuple[V, bool]:
        """Returns (value, loaded) — loaded=True if the key already existed."""
        with self._lock:
            if key in self._d:
                return self._d[key], True
            v = factory()
            self._d[key] = v
            return v, False

    def delete(self, key: K) -> V | None:
        with self._lock:
            return self._d.pop(key, None)

    def compute(self, key: K, fn: Callable[[V | None], V | None]) -> V | None:
        """Atomically transform the value at key; returning None deletes."""
        with self._lock:
            new = fn(self._d.get(key))
            if new is None:
                self._d.pop(key, None)
            else:
                self._d[key] = new
            return new

    def items(self) -> list[tuple[K, V]]:
        with self._lock:
            return list(self._d.items())

    def keys(self) -> list[K]:
        with self._lock:
            return list(self._d.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._d

    def __iter__(self) -> Iterator[K]:
        return iter(self.keys())
