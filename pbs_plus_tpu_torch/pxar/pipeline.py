"""The store lock shared by a store's writer threads.

A copy of ``_LockedStore`` and ``locked_store`` from the JAX package's
``pxar/pipeline.py`` (its ``PipelinedStream`` is not copied: it imports
no JAX and deposits into the port's collector as it is).  A fused stream
(``ingestbatch.py``) has its inserts run on whichever writer's thread
flushes the batch, so a caller that builds one over a store that is not
thread-safe wraps the store with ``locked_store`` first.  The proxy is
memoized on the store as ``_locked_proxy``, the attribute the JAX package
uses, so a JAX writer and a port writer over one store share one lock.
"""

from __future__ import annotations

import logging
import threading

L = logging.getLogger(__name__)


class _LockedStore:
    """Serializes ``insert``/``touch`` across threads for stores that
    are not thread-safe.  Everything else proxies through untouched."""

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()

    def insert(self, digest, data, *, verify: bool = True) -> bool:
        with self._lock:
            return self._store.insert(digest, data, verify=verify)

    def touch(self, digest) -> None:
        with self._lock:
            self._store.touch(digest)

    def __getattr__(self, name):
        return getattr(self._store, name)


_wrap_lock = threading.Lock()


def locked_store(store):
    """Idempotent and memoized: one proxy -- therefore one lock -- per
    underlying store object, since concurrent jobs share one store and
    per-writer locks would each "protect" the same store from a
    different lock.  A store that says it is ``thread_safe`` (the sharded
    ``ChunkStore``) passes through unwrapped: wrapping it would serialize
    all its shards behind one lock."""
    if isinstance(store, _LockedStore):
        return store
    if getattr(store, "thread_safe", False):
        return store
    with _wrap_lock:
        proxy = getattr(store, "_locked_proxy", None)
        if proxy is None:
            proxy = _LockedStore(store)
            try:
                store._locked_proxy = proxy
            except AttributeError:
                # __slots__ store: per-call proxies means per-caller
                # locks -- cross-writer serialization is lost, so say so
                L.warning(
                    "locked_store: %s rejects attribute memoization; "
                    "concurrent writers will NOT share one lock",
                    type(store).__name__)
    return proxy
