"""Jobs manager: dedup by id, bounded queue, per-tenant fair dequeue.

Reference: internal/server/jobs/manager.go:12-203 — Job = {ID, PreExec,
Execute, OnSuccess, OnError, Cleanup}; dedup by ID; dynamic-capacity queue
+ executionSem concurrency gate (RAM-derived, conf.max_concurrent_clients);
PreExec runs BEFORE acquiring the execution slot (mount while queued);
StartupMu serializes client startups.

Fleet-scale additions (docs/fleet.md "Fairness"): execution slots are
granted WEIGHTED round-robin ACROSS tenants (strict ``Job.priority``
classes first, deficit-weighted RR within a class), so one noisy tenant
enqueuing hundreds of jobs cannot starve another tenant's single job —
with a plain FIFO semaphore the victim waits behind the entire noisy
backlog; under RR it waits at most one slot-grant cycle.  Per-tenant
weights (``PBS_PLUS_TENANT_WEIGHTS`` or ``Job.weight``, DB-plumbed like
priority) shape the shares: each tenant's credit replenishes by its
weight once per grant cycle and every grant costs one credit, so a
weight-3 tenant lands ~3x the grants of a weight-1 tenant within one
cycle while a zero-credit tenant is merely skipped, never starved.
The queue itself is bounded
(``max_queued``, conf ``PBS_PLUS_MAX_QUEUED_JOBS``): enqueues past the
bound fast-fail with the typed ``QueueFullError`` instead of accepting
unbounded work the server cannot start.

A copy of the JAX package's ``server/jobs.py``, its code byte for byte
apart from its imports, which name the port's own modules, and its
logger (``logging``; a job's scoped logger is a ``LoggerAdapter``
carrying the same ``job_id``/``kind`` fields).  One addition,
``is_queue_full``: a verification job may be handed the JAX package's
manager, which raises its own package's ``QueueFullError``, a class
this module cannot name.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from ..utils import conf, failpoints, trace
from ..utils.resilience import CircuitBreaker

L = logging.getLogger(__name__)

AsyncFn = Callable[[], Awaitable[None]]

# breaker-registry hygiene: prune cadence, default cap, and how long a
# CLOSED breaker may sit unused before it is evictable (an open/half-open
# breaker is live protective state and is never evicted)
_BREAKER_PRUNE_INTERVAL_S = 60.0
DEFAULT_MAX_BREAKERS = 1024
DEFAULT_BREAKER_IDLE_EVICT_S = 3600.0


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


class JobsManager:
    def __init__(self, *, max_concurrent: int | None = None,
                 max_queued: int | None = None,
                 max_breakers: int = DEFAULT_MAX_BREAKERS,
                 breaker_idle_evict_s: float = DEFAULT_BREAKER_IDLE_EVICT_S,
                 tenant_weights: "dict[str, int] | None" = None):
        self.max_concurrent = max_concurrent or conf.max_concurrent_clients()
        self.max_queued = (conf.env().max_queued_jobs if max_queued is None
                           else max_queued)
        self._slots_free = self.max_concurrent
        # fair gate state: per-tenant FIFO of (future, job) waiters plus
        # the tenant round-robin ring (invariant: a tenant is in _rr iff
        # it has an entry in _waiting)
        self._waiting: dict[str, deque] = {}
        self._rr: deque[str] = deque()
        # deficit-weighted fair shares: tenant → remaining grant credit
        # this cycle (replenished by weight when the winning class runs
        # dry; dropped with the backlog so idle tenants never bank a
        # burst), and the per-tenant CONTENDED grant counter the ±10%
        # proportionality gate reads (fast-path grants are uncontended
        # and carry no fairness signal)
        self._tenant_weights = (dict(tenant_weights)
                                if tenant_weights is not None
                                else conf.parse_tenant_weights(
                                    conf.env().tenant_weights))
        self._credit: dict[str, float] = {}
        self.tenant_grants: dict[str, int] = {}
        self._queued = 0                      # enqueued, no exec slot yet
        self._tenant_running: dict[str, int] = {}
        self._active: dict[str, asyncio.Task] = {}
        # reference: StartupMu.  Named into the lock-order vocabulary:
        # callers acquire it through the `startup_mu` property, which
        # the static resolver cannot see through — so every acquisition
        # site carries the same `# pbslint: lock-order jobs.startup-mu`
        # annotation (see server/store.py), and this declaration-site
        # name keeps any direct `self._startup_mu` acquisition on the
        # same graph node
        self._startup_mu = asyncio.Lock()   # pbslint: lock-order jobs.startup-mu
        # per-key circuit breakers (keyed "agent:<target>" by the backup
        # path): a dead agent fails fast instead of burning the
        # scheduler's retry budget on every tick
        self._breakers: dict[str, CircuitBreaker] = {}
        self.max_breakers = max_breakers
        self.breaker_idle_evict_s = breaker_idle_evict_s
        self._last_breaker_prune = time.monotonic()
        self.stats = {"enqueued": 0, "completed": 0, "failed": 0,
                      "deduped": 0, "resumed": 0, "rejected_full": 0}

    def note_resumed(self) -> None:
        """A backup completed from a durable checkpoint instead of byte
        zero (server/checkpoint.py) — surfaced via pbs_plus_jobs_total."""
        self.stats["resumed"] += 1

    def enqueue(self, job: Job) -> bool:
        """Returns False if a job with the same id is already active
        (reference dedup-by-ID, manager.go:61); raises the typed
        ``QueueFullError`` when ``max_queued`` jobs are already waiting
        for an execution slot — admission control over accepting work
        the server cannot start."""
        if job.id in self._active:
            self.stats["deduped"] += 1
            return False
        if self.max_queued > 0 and self._queued >= self.max_queued:
            self.stats["rejected_full"] += 1
            raise QueueFullError(
                f"jobs queue full ({self._queued}/{self.max_queued} "
                f"queued); rejecting {job.id!r}")
        job.enqueued_at = time.perf_counter()
        task = asyncio.create_task(self._run(job), name=f"job:{job.id}")
        self._active[job.id] = task
        self._queued += 1
        self.stats["enqueued"] += 1
        return True

    # -- circuit breakers --------------------------------------------------
    def breaker(self, key: str, *, failure_threshold: int = 5,
                reset_timeout_s: float = 30.0) -> CircuitBreaker:
        """Per-key CircuitBreaker, created on first use.  Thresholds only
        apply at creation; a later caller requesting DIFFERENT thresholds
        for an existing key gets the existing circuit and a warning (the
        silent-ignore was easy to misread as reconfiguration)."""
        cb = self._breakers.get(key)
        if cb is not None:
            if (cb.failure_threshold != failure_threshold
                    or cb.reset_timeout_s != reset_timeout_s):
                L.warning(
                    "breaker %r already exists with thresholds "
                    "(%d, %.1fs); requested (%d, %.1fs) ignored",
                    key, cb.failure_threshold, cb.reset_timeout_s,
                    failure_threshold, reset_timeout_s)
            return cb
        self._maybe_prune_breakers(time.monotonic())
        cb = self._breakers[key] = CircuitBreaker(
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s, name=key)
        return cb

    @property
    def breaker_count(self) -> int:
        return len(self._breakers)

    def _maybe_prune_breakers(self, now: float) -> None:
        """Evict closed, long-idle breakers so the registry cannot grow
        one entry per target EVER seen.  Open/half-open breakers are
        live protective state — never evicted, whatever their age."""
        if (len(self._breakers) < self.max_breakers
                and now - self._last_breaker_prune
                < _BREAKER_PRUNE_INTERVAL_S):
            return
        self._last_breaker_prune = now
        dead = [k for k, cb in self._breakers.items()
                if cb.state == "closed"
                and now - cb.last_used >= self.breaker_idle_evict_s]
        for k in dead:
            del self._breakers[k]
        if len(self._breakers) >= self.max_breakers:
            # still over cap: evict the coldest CLOSED breakers
            closed = sorted((cb.last_used, k)
                            for k, cb in self._breakers.items()
                            if cb.state == "closed")
            excess = len(self._breakers) - self.max_breakers + 1
            for _, k in closed[:excess]:
                del self._breakers[k]

    # -- introspection -----------------------------------------------------
    def is_active(self, job_id: str) -> bool:
        return job_id in self._active

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def queued_count(self) -> int:
        """Jobs admitted but not yet holding an execution slot."""
        return self._queued

    @property
    def running_count(self) -> int:
        return self.max_concurrent - self._slots_free

    def tenant_active(self) -> dict[str, int]:
        """tenant → jobs currently holding an execution slot."""
        return {t: n for t, n in self._tenant_running.items() if n > 0}

    async def wait(self, job_id: str, timeout: float | None = None) -> None:
        t = self._active.get(job_id)
        if t is not None:
            await asyncio.wait_for(asyncio.shield(t), timeout)

    async def cancel(self, job_id: str) -> bool:
        t = self._active.get(job_id)
        if t is None:
            return False
        t.cancel()
        try:
            await t
        except asyncio.CancelledError:
            pass        # the cancellation we just requested
        except Exception as e:
            logging.LoggerAdapter(L, {"job_id": job_id}).warning(
                "job raised while being cancelled: %s", e)
        return True

    # -- fair slot gate ----------------------------------------------------
    def _pump(self) -> None:
        while self._slots_free > 0 and self._grant_next():
            self._slots_free -= 1

    def _weight_of(self, tenant: str, head: Job) -> int:
        """Effective fair-share weight: an operator-pinned tenant weight
        (PBS_PLUS_TENANT_WEIGHTS) wins over the job-carried weight (the
        DB-plumbed row value), floor 1 so no tenant can be weighted out
        of existence."""
        w = self._tenant_weights.get(tenant, head.weight)
        return max(1, int(w))

    def _grant_next(self) -> bool:
        """Grant one slot: strict priority across the waiting tenants'
        HEAD jobs, deficit-weighted round-robin within the winning class.
        Each grant costs one credit; when every tenant of the winning
        class is out of credit the cycle ends and every one of them
        replenishes by its weight — so within one cycle a weight-3
        tenant lands 3 grants for a weight-1 tenant's 1, and a tenant
        out of credit is merely skipped until the boundary, never
        starved.  Returns False when no live waiter exists."""
        best: int | None = None
        for t in list(self._rr):
            dq = self._waiting.get(t)
            while dq and dq[0][0].done():       # cancelled leftovers
                dq.popleft()
            if not dq:
                del self._waiting[t]
                self._rr.remove(t)
                self._credit.pop(t, None)       # backlog gone: no banking
                continue
            p = dq[0][1].priority
            if best is None or p < best:
                best = p
        if best is None:
            return False
        # candidates in ring order, winning priority class only
        ring = [t for t in self._rr
                if self._waiting[t][0][1].priority == best]
        t = next((c for c in ring if self._credit.get(c, 0.0) >= 1.0), None)
        if t is None:
            # cycle boundary: all candidates exhausted — replenish each
            # by its weight (credits here are always 0: a tenant with
            # credit ≥1 would have been picked above)
            for c in ring:
                self._credit[c] = float(
                    self._weight_of(c, self._waiting[c][0][1]))
            t = ring[0]
        self._credit[t] -= 1.0
        dq = self._waiting[t]
        fut, _job = dq.popleft()
        self._rr.remove(t)
        if dq:
            self._rr.append(t)                  # rotate: back of the ring
        else:
            del self._waiting[t]
            self._credit.pop(t, None)           # leave the cycle clean
        self.tenant_grants[t] = self.tenant_grants.get(t, 0) + 1
        fut.set_result(None)
        return True

    async def _acquire_slot(self, job: Job) -> None:
        if self._slots_free > 0 and not self._waiting:
            self._slots_free -= 1
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if job.tenant not in self._waiting:
            self._waiting[job.tenant] = deque()
            self._rr.append(job.tenant)
        self._waiting[job.tenant].append((fut, job))
        self._pump()
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # granted concurrently with the cancel: return the slot
                self._release_slot(job, counted=False)
            raise

    def _release_slot(self, job: Job, *, counted: bool = True) -> None:
        if counted:
            n = self._tenant_running.get(job.tenant, 0) - 1
            if n > 0:
                self._tenant_running[job.tenant] = n
            else:
                self._tenant_running.pop(job.tenant, None)
        self._slots_free += 1
        self._pump()

    # -- lifecycle ---------------------------------------------------------
    async def _run(self, job: Job) -> None:
        log = logging.LoggerAdapter(L, {"job_id": job.id,
                                        "kind": job.kind})
        failed: BaseException | None = None
        dequeued = got_slot = False

        def _dequeue() -> None:
            nonlocal dequeued
            if not dequeued:
                dequeued = True
                self._queued -= 1

        # the trace root: everything the job does — slot wait, execute,
        # agent-side RPC work (via call metadata), hooks — nests under
        # this span (docs/observability.md "Span vocabulary")
        with trace.span("job", job_id=job.id, kind=job.kind,
                        tenant=job.tenant):
            try:
                if job.pre_exec is not None:
                    # before the execution slot: target mounts while queued
                    await job.pre_exec()
                with trace.span("job.queue_wait", kind=job.kind):
                    await self._acquire_slot(job)
                got_slot = True
                _dequeue()
                if job.enqueued_at:
                    # the histogram's contract is enqueue→grant: measured
                    # from the enqueue timestamp, so task-scheduling
                    # delay and pre_exec (a 30s mount waits BEFORE the
                    # slot) are included — the queue_wait span above
                    # times only the slot acquisition itself
                    trace.record("job.enqueue_to_grant",
                                 time.perf_counter() - job.enqueued_at,
                                 kind=job.kind)
                self._tenant_running[job.tenant] = \
                    self._tenant_running.get(job.tenant, 0) + 1
                await failpoints.ahit("server.job.execute")
                if job.execute is not None:
                    with trace.span("job.execute", kind=job.kind):
                        await job.execute()
            except asyncio.CancelledError as e:
                failed = e
                log.warning("job cancelled")
            except BaseException as e:
                failed = e
                log.exception("job failed")
            finally:
                if got_slot:
                    self._release_slot(job)
                _dequeue()
                try:
                    if failed is None:
                        self.stats["completed"] += 1
                        if job.enqueued_at:
                            # whole-path latency — the fleet report's
                            # enqueue-to-publish percentiles derive from
                            # this histogram's bucket counts
                            trace.record(
                                "job.enqueue_to_publish",
                                time.perf_counter() - job.enqueued_at,
                                kind=job.kind)
                        if job.on_success is not None:
                            await job.on_success()
                    else:
                        self.stats["failed"] += 1
                        if job.on_error is not None:
                            await job.on_error(failed)
                except Exception:
                    log.exception("job completion hook failed")
                try:
                    if job.cleanup is not None:
                        await job.cleanup()
                except Exception:
                    log.exception("job cleanup failed")
                self._active.pop(job.id, None)

    @property
    def startup_mu(self) -> asyncio.Lock:
        """Serializes backup-session startups (reference: StartupMu)."""
        return self._startup_mu

    async def drain(self, timeout: float = 60.0) -> None:
        """Wait until the jobs plane is quiescent.  Re-snapshots until
        no job is active: a draining job may chain NEW jobs from its
        execute (backup waves, read-back lanes) — a single snapshot
        would return with those still running, and a caller tearing
        down its event loop would cancel them mid-flight."""
        deadline = time.perf_counter() + timeout
        while True:
            tasks = list(self._active.values())
            if not tasks:
                return
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise asyncio.TimeoutError(
                    f"jobs plane not quiescent after {timeout}s "
                    f"({len(tasks)} active)")
            await asyncio.wait_for(
                asyncio.gather(*tasks, return_exceptions=True),
                remaining)
