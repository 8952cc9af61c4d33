"""PruneService: retention + GC behind one narrow surface.

Owns everything the old ``Server._prune_lock`` region owned — the lock
that serializes prune/GC/snapshot-delete in THIS process, the
``gc_active`` flag backups gate on, the last-prune stats, the schedule
loop — plus the piece that makes a second server process safe: the
**GC leader lease** (``gc_lease`` table, migration 009).

Lease discipline: before any non-dry sweep the service must win the
single-row TTL'd lease (``Database.acquire_gc_lease`` — a conditional
upsert that only lands when the caller already holds it or the
incumbent's TTL expired, atomic under SQLite's write lock).  While the
sweep runs on an executor thread, a heartbeat task renews the lease
every ttl/3, so a live sweeper can hold GC indefinitely but a KILLED
one is stolen from within one TTL — exactly-once GC per cycle across
the fleet, with crash failover.  A loser raises the typed
``GCLeaseHeldError`` (the web route's 409), never a silent no-op sweep.

Cross-process note on snapshot deletes: a delete in process B racing
process A's mark phase is safe in the keep direction — the doomed
snapshot's chunks were live at A's mark time, so they survive A's sweep
and fall in the NEXT leader's cycle.

A copy of the JAX package's ``server/services/prune_service.py``, its
code byte for byte apart from its imports, which name the port's own
modules, and its logger (``logging``; the scoped logger is a
``LoggerAdapter``). The sweep runs on an executor thread and its lease
heartbeat on a thread of its own: neither launches work on the card,
since the sweep's discards only write the host mirror of the store's
device cuckoo table, which the next probe uploads."""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Callable, Optional

from ...utils import trace
from ...utils.counters import Counters

L = logging.getLogger(__name__)

DEFAULT_LEASE_TTL_S = 30.0

# lease observability (rendered by server/metrics.py as the
# pbs_plus_gc_lease_* gauges; docs/metrics.md)
METRICS = Counters("acquisitions", "renewals", "steals", "held_skips")
_count = METRICS.add


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


class GCLeaseHeldError(RuntimeError):
    """Another live process holds the GC lease — this cycle is theirs."""


class PruneDeferredError(RuntimeError):
    """GC yielded to active/running backup jobs; retry after they drain.
    A RuntimeError subclass so the scheduler/web/fleetproc retry
    catchers keep working — but typed, so callers stop string-matching
    (pbslint ``typed-error-discipline``)."""


class _LeaseHeartbeat(threading.Thread):
    """ttl/3 lease renewer on its OWN thread: an asyncio-loop stall
    (long GIL-held kernel, blocking DB call) cannot starve the
    heartbeat into a spurious mid-sweep steal — only process death
    (the designed failover) or a genuinely lost lease stops it."""

    def __init__(self, db, holder: str, ttl_s: float, on_lost) -> None:
        super().__init__(name="gc-lease-heartbeat", daemon=True)
        self._db = db
        self._holder = holder
        self._ttl = ttl_s
        self._on_lost = on_lost
        self._stopped = threading.Event()

    def run(self) -> None:
        while not self._stopped.wait(self._ttl / 3.0):
            if self._db.renew_gc_lease(self._holder, self._ttl):
                _count("renewals")
            else:
                self._on_lost()
                return

    def stop(self) -> None:
        self._stopped.set()


class PruneService:
    """One instance per server process; see the module docstring."""

    def __init__(self, *, datastore, policy_factory: Callable[[], object],
                 jobs_active: Callable[[], int], db=None,
                 holder: str = "", lease_ttl_s: float = DEFAULT_LEASE_TTL_S):
        # ``datastore`` is the LocalStore whose .datastore GC operates
        # on; ``policy_factory`` builds the configured default policy;
        # ``jobs_active`` is the jobs plane's active count (a narrow
        # callable — never the JobQueueService object itself)
        self._datastore = datastore
        self._policy_factory = policy_factory
        self._jobs_active = jobs_active
        self._db = db
        self.holder = holder or f"prune-{id(self):x}"
        self.lease_ttl_s = lease_ttl_s
        self._lock = asyncio.Lock()     # serializes prune/GC/delete here
        self.gc_active = False          # backups wait while GC runs
        self.last_prune: dict = {}      # metrics: last prune/GC stats
        self._lease_lost = False
        self.log = logging.LoggerAdapter(L, {"component": "prune-service"})

    @property
    def lock(self) -> asyncio.Lock:
        """The per-process prune/GC/delete mutex (composition-root and
        test surface; other services never touch it)."""
        return self._lock

    def policy(self):
        return self._policy_factory()

    def fleet_gc_active(self) -> bool:
        """GC-in-progress across EVERY process sharing the datastore:
        locally via the flag, remotely via a live (unexpired) lease row
        — the jobs plane's start gate must see a sibling's sweep, or a
        backup could splice-reference a chunk the leader is unlinking."""
        if self.gc_active:
            return True
        if self._db is None:
            return False
        lease = self._db.get_gc_lease()
        return bool(lease and lease["sweeping"]
                    and lease["expires_at"] > time.time())

    # -- lease ------------------------------------------------------------
    def _lease_acquire(self) -> None:
        """Win or renew the lease, or raise the typed loser error."""
        res = self._db.acquire_gc_lease(self.holder, self.lease_ttl_s)
        if not res["acquired"]:
            _count("held_skips")
            raise GCLeaseHeldError(
                f"GC lease held by {res['holder']!r} until "
                f"{res['expires_at']:.0f} — exactly one sweeper per "
                "cycle")
        _count({"acquired": "acquisitions", "stolen": "steals",
                "renewed": "renewals"}[res["outcome"]])
        if res["outcome"] == "stolen":
            self.log.warning("stole expired GC lease from a dead "
                             "holder (now %s)", self.holder)
        self._lease_lost = False

    def _on_lease_lost(self) -> None:
        """A failed renew means the lease was stolen mid-sweep (we
        were presumed dead) — flagged, logged, and surfaced on the
        report.  The in-flight executor sweep cannot be aborted; the
        heartbeat THREAD below exists precisely so this can only
        happen to a genuinely wedged process, never to one whose
        asyncio loop merely stalled past the TTL."""
        self._lease_lost = True
        self.log.warning(
            "GC lease lost mid-sweep (holder %s presumed dead and "
            "stolen) — this sweep's exactly-once guarantee is void",
            self.holder)

    # -- the prune/GC entry point -----------------------------------------
    async def run_prune(self, policy=None, *, dry_run: bool = False,
                        gc_grace_s: float | None = None):
        """Prune+GC off the event loop.  Serialized with every other
        datastore-mutating admin path in this process via the service
        lock, and with every OTHER PROCESS via the leader lease — a
        delete racing the mark phase would abort GC mid-flight, and two
        concurrent sweepers would double-unlink."""
        from ..prune import GC_GRACE_S, run_prune
        policy = policy or self.policy()
        kw = {"gc_grace_s": GC_GRACE_S if gc_grace_s is None
              else gc_grace_s}
        t0 = time.perf_counter()
        async with self._lock:
            trace.record("service.lock_wait", time.perf_counter() - t0,
                         service="prune")
            heartbeat: Optional[_LeaseHeartbeat] = None
            if not dry_run:
                # GC must never run concurrently with backups: a mid-
                # flight incremental may still REFERENCE chunks of the
                # very snapshot this prune removes (splice touch happens
                # at walk time, so neither the mark nor the grace window
                # protects them).  Mutual exclusion: refuse while jobs
                # run; new jobs wait out the GC (the flag is checked
                # before each job's session starts).
                active = self._jobs_active()
                if active:
                    raise PruneDeferredError(
                        f"prune deferred: {active} job(s) active")
                if self._db is not None:
                    # lease FIRST (advertises GC fleet-wide through the
                    # row), THEN the fleet-wide running check — jobs
                    # granted after the lease landed gate on
                    # fleet_gc_active, jobs granted before it show up
                    # in the shared queue's running count here.  Both
                    # on the executor: the shared DB is write-contended
                    # across processes, and a lock wait must not stall
                    # this loop's mux writes.
                    loop = asyncio.get_running_loop()
                    await loop.run_in_executor(None, self._lease_acquire)
                    running = (await loop.run_in_executor(
                        None, self._db.queue_counts)).get("running", 0)
                    if running:
                        await loop.run_in_executor(
                            None, self._db.release_gc_lease, self.holder)
                        raise PruneDeferredError(
                            f"prune deferred: {running} job(s) running "
                            "fleet-wide")
                    heartbeat = _LeaseHeartbeat(
                        self._db, self.holder, self.lease_ttl_s,
                        self._on_lease_lost)
                    heartbeat.start()
                self.gc_active = True
            swept_ok = False
            try:
                report = await asyncio.get_running_loop().run_in_executor(
                    None, trace.wrap(
                        lambda: run_prune(self._datastore.datastore,
                                          policy, dry_run=dry_run, **kw)))
                swept_ok = True
                if not dry_run:
                    self.last_prune = {
                        "at": time.time(),
                        "removed": len(report.removed),
                        "chunks_removed": report.chunks_removed,
                        "bytes_freed": report.bytes_freed,
                        "lease_lost": self._lease_lost}
                return report
            finally:
                self.gc_active = False
                if heartbeat is not None:
                    heartbeat.stop()
                    await asyncio.get_running_loop().run_in_executor(
                        None, lambda: heartbeat.join(timeout=2.0))
                if not dry_run and self._db is not None \
                        and not self._lease_lost:
                    _loop = asyncio.get_running_loop()
                    if swept_ok:
                        # a successful sweep KEEPS the lease for its
                        # TTL — the unexpired row is what makes a
                        # same-cycle loser observe `held` (exactly-once
                        # per cycle) even when this sweep finished in
                        # milliseconds — but demoted to a cycle marker
                        # so the jobs gate reopens immediately.  On the
                        # executor, like the acquire: a sibling's write
                        # lock must not stall this loop.
                        await _loop.run_in_executor(
                            None, self._db.mark_gc_lease_idle,
                            self.holder)
                    else:
                        # a FAILED sweep hands the cycle back at once.
                        # A lost lease belongs to its thief either way
                        # — never delete theirs.
                        await _loop.run_in_executor(
                            None, self._db.release_gc_lease, self.holder)

    async def delete_snapshot(self, ref) -> None:
        """Admin snapshot delete, serialized against a GC mark phase in
        this process (the old ``server._prune_lock`` route)."""
        t0 = time.perf_counter()
        async with self._lock:
            trace.record("service.lock_wait", time.perf_counter() - t0,
                         service="prune")
            await asyncio.get_running_loop().run_in_executor(
                None, self._datastore.datastore.remove_snapshot, ref)

    # -- the schedule loop -------------------------------------------------
    async def run_loop(self, schedule: str) -> None:
        import datetime as dt

        from ...utils import calendar
        while True:
            try:
                nxt = calendar.compute_next_event(schedule,
                                                  dt.datetime.now())
                if nxt is None:
                    return
                await asyncio.sleep(
                    max(1.0, (nxt - dt.datetime.now()).total_seconds()))
                report = await self.run_prune()
                self.log.info(
                    "scheduled prune: -%d snapshots, -%d chunks",
                    len(report.removed), report.chunks_removed)
            except asyncio.CancelledError:
                raise
            except GCLeaseHeldError as e:
                # another process swept this cycle — by design, not an
                # error worth a stack trace every schedule tick
                self.log.info("scheduled prune skipped: %s", e)
            except Exception:
                self.log.exception("scheduled prune failed")
                await asyncio.sleep(60)
