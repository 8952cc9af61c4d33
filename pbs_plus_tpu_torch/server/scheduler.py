"""Scheduler: calendar-expression ticks, retry policy, pending
verifications.

Reference: internal/server/scheduler/scheduler.go:20-377 — 30 s tick;
ComputeNextEvent with lastEnqueued dedup; Retry/RetryInterval with typed
JobStatus.ShouldRetry; verification scheduling incl. run-on-backup-complete
pending mode + TriggerPendingVerifications.

A copy of the JAX package's ``server/scheduler.py``, its code byte for
byte apart from its imports, which name the port's own modules
(``calendar``, ``database``, the jobs manager), and its logger
(``logging``).  A due sync row fires through the server's
``_enqueue_sync`` (``server/sync_job.py``), as in the reference.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import logging
import time
from typing import Awaitable, Callable

from ..utils import calendar
from . import database
from .jobs import JobsManager

L = logging.getLogger(__name__)

TICK_S = 30.0

EnqueueFn = Callable[[database.BackupJobRow], Awaitable[None]]
VerifyFn = Callable[[dict], Awaitable[None]]
SyncFn = Callable[[dict], Awaitable[None]]


class Scheduler:
    def __init__(self, db: database.Database, jobs: JobsManager, *,
                 enqueue_backup: EnqueueFn,
                 enqueue_verification: VerifyFn | None = None,
                 enqueue_sync: SyncFn | None = None,
                 tick_s: float = TICK_S):
        self.db = db
        self.jobs = jobs
        self.enqueue_backup = enqueue_backup
        self.enqueue_verification = enqueue_verification
        self.enqueue_sync = enqueue_sync
        self.tick_s = tick_s
        self._last_enqueued: dict[str, dt.datetime] = {}
        self._retry_at: dict[str, float] = {}
        self._pending_verifications: set[str] = set()
        self._trigger_tasks: set[asyncio.Task] = set()
        self._stop = asyncio.Event()

    async def run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                L.exception("scheduler tick crashed")   # panic containment
            try:
                await asyncio.wait_for(self._stop.wait(), self.tick_s)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()

    async def tick(self, now: dt.datetime | None = None) -> None:
        now = now or dt.datetime.now()
        for row in self.db.list_backup_jobs(enabled_only=True):
            # the manager keys backups "backup:<id>" — the bare id never
            # matches, so this guard silently never fired: each tick over
            # a still-running job minted a stale queued task row before
            # the manager's own dedup rejected the duplicate
            if self.jobs.is_active(f"backup:{row.id}"):
                continue
            if await self._due_retry(row, now):
                continue
            if not row.schedule:
                continue
            try:
                prev = self._reference_time(row, now)
                nxt = calendar.compute_next_event(row.schedule, prev)
            except calendar.CalendarError:
                L.warning("job %s has invalid schedule %r", row.id, row.schedule)
                continue
            if nxt is not None and nxt <= now:
                last = self._last_enqueued.get(row.id)
                if last is not None and last >= nxt:
                    continue                      # lastEnqueued dedup
                self._last_enqueued[row.id] = now
                await self.enqueue_backup(row)
        await self._tick_verifications(now)
        await self._tick_syncs(now)

    def _reference_time(self, row: database.BackupJobRow,
                        now: dt.datetime) -> dt.datetime:
        if row.last_run_at:
            return dt.datetime.fromtimestamp(row.last_run_at)
        last = self._last_enqueued.get(row.id)
        if last is not None:
            return last
        return now - dt.timedelta(seconds=2 * self.tick_s)

    async def _due_retry(self, row: database.BackupJobRow,
                         now: dt.datetime) -> bool:
        """Typed retry policy (reference: scheduler.go:159-180)."""
        if not row.retry or row.last_status is None:
            return False
        if not database.should_retry(row.last_status):
            self._retry_at.pop(row.id, None)
            return False
        key = row.id
        at = self._retry_at.get(key)
        if at is None:
            base = row.last_run_at or time.time()
            self._retry_at[key] = base + row.retry_interval_s
            return False
        if time.time() >= at:
            self._retry_at[key] = time.time() + row.retry_interval_s
            L.info("retrying failed job %s", row.id)
            await self.enqueue_backup(row)
            return True
        return False

    # -- verifications -----------------------------------------------------
    def on_backup_complete(self, store: str) -> None:
        """Mark run-on-backup verifications pending AND trigger them
        immediately (reference: OnBackupComplete →
        TriggerPendingVerifications fires right away, scheduler.go:320 —
        not at the next 30 s tick)."""
        marked = False
        for v in self.db.list_verification_jobs():
            if v["run_on_backup"] and (not v["store"] or v["store"] == store):
                self._pending_verifications.add(v["id"])
                marked = True
        if marked:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return                  # no loop: the next tick picks it up
            t = loop.create_task(self._fire_pending())
            self._trigger_tasks.add(t)          # strong ref (loop keeps
            t.add_done_callback(self._trigger_tasks.discard)  # weak only)

    async def _fire_pending(self) -> None:
        """Enqueue ONLY the pending set, immediately — never calendar
        evaluation, so the concurrent periodic tick cannot double-enqueue
        a schedule-due job.  Failures keep the id pending (the next tick
        retries) and are logged, never lost to task GC."""
        if self.enqueue_verification is None:
            return
        for v in self.db.list_verification_jobs():
            if v["id"] not in self._pending_verifications:
                continue
            self._pending_verifications.discard(v["id"])
            try:
                await self.enqueue_verification(v)
            except Exception:
                self._pending_verifications.add(v["id"])
                L.exception("pending verification enqueue failed")

    async def _tick_verifications(self, now: dt.datetime) -> None:
        if self.enqueue_verification is None:
            return
        for v in self.db.list_verification_jobs():
            due = False
            if v["id"] in self._pending_verifications:
                due = True
            elif v["schedule"]:
                try:
                    ref = (dt.datetime.fromtimestamp(v["last_run_at"])
                           if v["last_run_at"]
                           else now - dt.timedelta(seconds=2 * self.tick_s))
                    nxt = calendar.compute_next_event(v["schedule"], ref)
                    due = nxt is not None and nxt <= now
                except calendar.CalendarError:
                    continue
            if due:
                self._pending_verifications.discard(v["id"])
                await self.enqueue_verification(v)

    async def _tick_syncs(self, now: dt.datetime) -> None:
        """Calendar-due sync jobs (datastore replication, docs/sync.md)
        — plumbed exactly like verification schedules; the sync job
        layer dedups an already-running id itself."""
        if self.enqueue_sync is None:
            return
        for s in self.db.list_sync_jobs(enabled_only=True):
            if not s["schedule"]:
                continue
            try:
                ref = (dt.datetime.fromtimestamp(s["last_run_at"])
                       if s["last_run_at"]
                       else now - dt.timedelta(seconds=2 * self.tick_s))
                nxt = calendar.compute_next_event(s["schedule"], ref)
            except calendar.CalendarError:
                L.warning("sync job %s has invalid schedule %r",
                          s["id"], s["schedule"])
                continue
            if nxt is not None and nxt <= now:
                await self.enqueue_sync(s)
