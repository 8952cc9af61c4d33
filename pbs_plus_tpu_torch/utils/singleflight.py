"""Async singleflight: coalesce concurrent calls for the same key.

Reference capability: the duplicate-suppression on hot API work
(internal/server/web/api/plus.go:44,107-111 — concurrent
agent-binary downloads share ONE download+verify via
singleflight.Group.Do; contract proven by plus_singleflight_test.go).

asyncio-native redesign: the first caller for a key runs the factory as
a task; every concurrent caller for the same key awaits that same task's
result (or exception).  The key is released once the flight lands, so
later callers re-execute — this is stampede suppression, not a cache
(layer a cache on top where staleness policy belongs, e.g. web.py's
release cache).

A copy of the JAX package's ``utils/singleflight.py``, its code byte for
byte apart from its imports, which name the port's own modules."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Awaitable, Callable


class SingleFlight:
    def __init__(self) -> None:
        self._flights: dict[Any, asyncio.Task] = {}
        self.stats = {"calls": 0, "executions": 0, "shared": 0}

    async def do(self, key: Any,
                 factory: Callable[[], Awaitable[Any]]) -> Any:
        """Return factory()'s result, running it at most once across all
        concurrent callers with this key.  Exceptions propagate to every
        waiter.  The flight runs as a DETACHED task: cancelling any
        caller — including the one that started it — cancels only that
        caller's wait, never the shared flight (the Go reference's
        Group.Do likewise outlives its first caller)."""
        self.stats["calls"] += 1
        task = self._flights.get(key)
        if task is None:
            self.stats["executions"] += 1
            task = asyncio.get_running_loop().create_task(
                self._run(key, factory))
            # if every waiter is cancelled the exception would otherwise
            # log "never retrieved" at GC time
            task.add_done_callback(
                lambda t: t.cancelled() or t.exception())
            self._flights[key] = task
        else:
            self.stats["shared"] += 1
        return await asyncio.shield(task)

    async def _run(self, key: Any,
                   factory: Callable[[], Awaitable[Any]]) -> Any:
        try:
            return await factory()
        finally:
            self._flights.pop(key, None)

    def in_flight(self, key: Any) -> bool:
        return key in self._flights


class _ThreadFlight:
    __slots__ = ("event", "result", "exc")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result: Any = None
        self.exc: BaseException | None = None


class ThreadSingleFlight:
    """Thread-side twin of :class:`SingleFlight`: coalesce concurrent
    *thread* callers for one key (the chunk-cache read path lives on
    executor/FUSE/verify-pool threads, not the event loop).  The first
    caller for a key runs the factory inline; every concurrent caller
    blocks on the flight and shares its result (or exception).  The key
    is released once the flight lands — stampede suppression, not a
    cache."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: dict[Any, _ThreadFlight] = {}
        self.stats = {"calls": 0, "executions": 0, "shared": 0}

    def do(self, key: Any, factory: Callable[[], Any]) -> Any:
        with self._lock:
            self.stats["calls"] += 1
            fl = self._flights.get(key)
            if fl is None:
                fl = _ThreadFlight()
                self._flights[key] = fl
                self.stats["executions"] += 1
                leader = True
            else:
                self.stats["shared"] += 1
                leader = False
        if not leader:
            fl.event.wait()
            if fl.exc is not None:
                raise fl.exc
            return fl.result
        try:
            fl.result = factory()
            return fl.result
        except BaseException as e:
            fl.exc = e
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            fl.event.set()

    def in_flight(self, key: Any) -> bool:
        with self._lock:
            return key in self._flights
