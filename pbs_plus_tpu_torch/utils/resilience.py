"""Resilience helpers: circuit breaker + retry with backoff.

Reference: internal/server/resilience.go:17-109 (CircuitBreaker, WithRetry)
and the agent's exponential backoff discipline (SURVEY §5.3).

Both helpers come in async and sync flavors sharing one state machine:
the data plane mixes event-loop code (jobs, aRPC) with writer/committer
threads (pxar pipeline, sidecar gRPC), and a breaker guarding a sidecar
must see failures from BOTH sides.  ``CircuitBreaker`` is therefore
internally locked with a ``threading.Lock`` (held only for state flips,
never across a guarded call).

Half-open discipline: after ``reset_timeout_s`` the breaker admits
exactly ONE probe call; concurrent callers are rejected with
``CircuitOpenError`` until the probe resolves.  Without this, every
caller blocked on an open circuit probes at once when the timer
expires — re-hammering the exact backend the breaker was protecting.

A copy of the JAX package's ``utils/resilience.py``, its code byte for
byte apart from its imports, which name the port's own modules, and its
logger (``logging``).
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time
from typing import Awaitable, Callable, TypeVar

L = logging.getLogger(__name__)


T = TypeVar("T")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitOpenError(RuntimeError):
    pass


class CircuitBreaker:
    """Trips after ``failure_threshold`` consecutive failures; half-opens
    after ``reset_timeout_s`` and admits a single probe call."""

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, name: str = ""):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.name = name
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False          # half-open probe in flight
        self._lock = threading.Lock()
        # monotonic timestamp of the last admission/verdict — registry
        # owners (server/jobs.py) evict closed breakers idle past a TTL
        self.last_used = time.monotonic()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        # the open→half-open transition is PERSISTED here (not recomputed
        # per read): admission control needs one authoritative state to
        # hang the single-probe rule off
        if self._state == OPEN and \
                time.monotonic() - self._opened_at >= self.reset_timeout_s:
            self._state = HALF_OPEN
        return self._state

    def _admit(self) -> None:
        """Gate one call; raises ``CircuitOpenError`` when not admitted."""
        with self._lock:
            self.last_used = time.monotonic()
            st = self._state_locked()
            if st == OPEN:
                raise CircuitOpenError(
                    f"circuit {self.name or '?'} open "
                    f"({self._failures} consecutive failures)")
            if st == HALF_OPEN:
                if self._probing:
                    raise CircuitOpenError(
                        f"circuit {self.name or '?'} half-open: "
                        "probe already in flight")
                self._probing = True

    def _record_success(self) -> None:
        with self._lock:
            self.last_used = time.monotonic()
            self._failures = 0
            self._state = CLOSED
            self._probing = False

    def _record_failure(self) -> None:
        with self._lock:
            self.last_used = time.monotonic()
            self._failures += 1
            failed_probe = self._probing
            self._probing = False
            if self._failures >= self.failure_threshold or \
                    self._state == HALF_OPEN or failed_probe:
                self._state = OPEN
                self._opened_at = time.monotonic()
                L.warning("circuit %s opened after %d failures",
                          self.name or "?", self._failures)

    def _abort_probe(self) -> None:
        """A probe died without a verdict (cancellation): release the
        half-open slot so the breaker cannot deadlock probing."""
        with self._lock:
            self._probing = False

    async def call(self, fn: Callable[[], Awaitable[T]]) -> T:
        self._admit()
        try:
            out = await fn()
        except Exception:
            self._record_failure()
            raise
        except BaseException:          # CancelledError: no verdict
            self._abort_probe()
            raise
        self._record_success()
        return out

    def call_sync(self, fn: Callable[[], T]) -> T:
        """Same state machine for synchronous callers (writer threads,
        the sidecar gRPC client)."""
        self._admit()
        try:
            out = fn()
        except Exception:
            self._record_failure()
            raise
        except BaseException:
            self._abort_probe()
            raise
        self._record_success()
        return out


# retrying these can never help: the circuit short-circuits on purpose,
# and a cancellation must propagate immediately — even when callers pass
# a broad ``retry_on``
_NEVER_RETRY = (CircuitOpenError,)


def _backoff(delay: float, max_delay_s: float, jitter: float) -> float:
    return max(0.0, min(delay, max_delay_s)
               * (1 + random.uniform(-jitter, jitter)))


async def with_retry(fn: Callable[[], Awaitable[T]], *, attempts: int = 3,
                     base_delay_s: float = 0.5, max_delay_s: float = 30.0,
                     jitter: float = 0.2,
                     retry_on: tuple[type[BaseException], ...] = (Exception,),
                     name: str = "",
                     ) -> T:
    """Exponential backoff with jitter (reference: WithRetry; the agent's
    500ms→30s ×2 ±20% discipline).  Every retry is logged at warning with
    the site ``name``, attempt number, delay, and the exception."""
    delay = base_delay_s
    last: BaseException | None = None
    for attempt in range(attempts):
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except _NEVER_RETRY:
            raise
        except retry_on as e:
            last = e
            if attempt == attempts - 1:
                break
            sleep = _backoff(delay, max_delay_s, jitter)
            L.warning("retry %s: attempt %d/%d failed (%s: %s); "
                      "next try in %.2fs", name or "?", attempt + 1,
                      attempts, type(e).__name__, e, sleep)
            await asyncio.sleep(sleep)
            delay *= 2
    assert last is not None
    raise last


def retry_sync(fn: Callable[[], T], *, attempts: int = 3,
               base_delay_s: float = 0.5, max_delay_s: float = 30.0,
               jitter: float = 0.2,
               retry_on: tuple[type[BaseException], ...] = (Exception,),
               name: str = "",
               ) -> T:
    """``with_retry`` for synchronous callers (blocks the calling thread
    between attempts — never use on the event loop)."""
    delay = base_delay_s
    last: BaseException | None = None
    for attempt in range(attempts):
        try:
            return fn()
        except asyncio.CancelledError:
            raise
        except _NEVER_RETRY:
            raise
        except retry_on as e:
            last = e
            if attempt == attempts - 1:
                break
            sleep = _backoff(delay, max_delay_s, jitter)
            L.warning("retry %s: attempt %d/%d failed (%s: %s); "
                      "next try in %.2fs", name or "?", attempt + 1,
                      attempts, type(e).__name__, e, sleep)
            time.sleep(sleep)
            delay *= 2
    assert last is not None
    raise last
