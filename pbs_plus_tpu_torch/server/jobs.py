"""The job record and the queue-full error of the server's jobs manager.

A copy of ``QueueFullError`` and ``Job`` of the JAX package's
``server/jobs.py``, the parts the verification job builds and catches.
The manager itself is not copied: the job enqueues through the server's
``jobs``/``job_queue``, which a caller brings, duck-typed.  One addition,
``is_queue_full``: the manager a caller brings may raise its own
package's ``QueueFullError``, a class this module cannot name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

AsyncFn = Callable[[], Awaitable[None]]


class QueueFullError(RuntimeError):
    """Typed fast-fail: the jobs queue is at its configured bound."""


def is_queue_full(exc: BaseException) -> bool:
    """True for this module's ``QueueFullError`` and for any exception
    whose class, or a base of it, is named ``QueueFullError`` (the JAX
    package's manager raises its own)."""
    return any(c.__name__ == "QueueFullError" for c in type(exc).__mro__)


@dataclass
class Job:
    id: str
    kind: str = "backup"
    tenant: str = ""                          # fairness lane (target CN);
                                              # "" = shared default lane
    priority: int = 0                         # strict class: lower first
    weight: int = 1                           # fair-share weight within a
                                              # class (≥1; a JobsManager
                                              # tenant_weights entry wins)
    pre_exec: Optional[AsyncFn] = None        # runs before the exec slot
    execute: Optional[AsyncFn] = None
    on_success: Optional[AsyncFn] = None
    on_error: Optional[Callable[[BaseException], Awaitable[None]]] = None
    cleanup: Optional[AsyncFn] = None
    # set by enqueue(): the enqueue-to-grant / enqueue-to-publish
    # latency origin (docs/observability.md)
    enqueued_at: float = 0.0
