"""JobQueueService: the jobs plane behind one narrow surface.

Owns the ``JobsManager`` (the bounded queue + strict-priority +
per-tenant round-robin fairness), the live-progress / last-run-stats
observability state the metrics layer renders, the backup enqueue path
(moved out of the ``Server`` god-object), and — the scale-out piece —
the **DB-backed shared queue**: with a database attached, every
admission lands a ``job_queue`` row first, and the queue BOUND is
checked against the DB-wide ``queued`` count (``Database.queue_admit``,
BEGIN IMMEDIATE), so two server processes sharing one datastore share
ONE bounded queue.  Fairness stays per-process inside each process's
``JobsManager`` — the shared state is the bound and the queue's
cross-process observability, not the grant order.

Admission counters ride the same database: ``flush_admission`` folds
this process's ``AgentsManager`` verdict deltas into the shared
``admission_counters`` table, so /metrics summed across the fleet adds
up instead of double- or under-counting.

A copy of the JAX package's ``server/services/jobqueue.py``, its code
byte for byte apart from its imports, which name the port's own modules
(``run_target_backup``, ``LocalStore``, ``PBSStore``, the jobs manager),
its logger (``logging``; the scoped logger is a ``LoggerAdapter``) and
one change: the service takes ``device=`` (default ``"cuda"``; raises
without a card), the server's, and hands it to the per-job
``LocalStore`` and ``PBSStore`` and their chunker factory and batch
hasher (``make_chunker_factory(kind, cpu_backend=, device=)``).  A
row whose chunker kind the port does not serve (the JAX package's
``tpu``, or an unknown kind) is recorded as that run's error, as a
missing PBS target is, instead of raising out of the scheduler tick;
the three rejections share ``_reject``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Callable

from ...utils import conf, trace
from ...utils.device import resolve
from .. import database
from ..jobs import Job, JobsManager, QueueFullError

L = logging.getLogger(__name__)


def default_owner() -> str:
    """Queue-row owner identity: stable enough to reap a restarted
    process's rows, unique enough that two live processes never
    collide."""
    return f"{conf.env().hostname}:{os.getpid()}"


class JobQueueService:
    def __init__(self, *, db=None, config=None, agents=None,
                 datastore=None,
                 gc_active: Callable[[], bool] = lambda: False,
                 checkpoint_interval: Callable[[], str] = lambda: "",
                 max_concurrent: "int | None" = None,
                 max_queued: "int | None" = None,
                 tenant_weights: "dict[str, int] | None" = None,
                 owner: str = "", reap_all_on_boot: bool = False,
                 device="cuda"):
        self.device = resolve(device)
        self.db = db
        self.config = config
        self.agents = agents
        self.datastore = datastore          # the primary LocalStore
        self._gc_active = gc_active         # narrow PruneService gate
        self._checkpoint_interval = checkpoint_interval
        self.owner = owner or default_owner()
        self.jobs = JobsManager(max_concurrent=max_concurrent,
                                max_queued=max_queued,
                                tenant_weights=tenant_weights)
        # completion hook the composition root wires to the scheduler
        # (late-bound: the scheduler is constructed after this service)
        self.on_backup_complete: "Callable[[str], None] | None" = None
        # notification batch tracker — a sink is attached by the caller
        # through the Server.notifications property
        self.notifications = None
        # observability state (metrics.py): live per-job progress
        # objects and the last finished run's stats, both in-memory
        self.live_progress: dict[str, tuple[float, object]] = {}
        self.last_run_stats: dict[str, dict] = {}
        self._admission_flushed: dict[str, int] = {}
        self.log = logging.LoggerAdapter(L, {"component": "job-queue"})
        if self.db is not None:
            # a restarted process's leftover rows must stop counting
            # against the SHARED bound.  reap_all_on_boot is the
            # single-process case: the owner id is pid-derived (changes
            # every restart) and no sibling can exist, so every live
            # row is stale by construction
            reaped = self.db.queue_reap_owner(
                None if reap_all_on_boot else self.owner)
            if reaped:
                self.log.warning("reaped %d stale shared-queue rows "
                                 "from a previous run", reaped)

    # -- introspection (Server property surface) ---------------------------
    @property
    def active_count(self) -> int:
        return self.jobs.active_count

    # -- the DB-mirrored enqueue -------------------------------------------
    def submit(self, job: Job) -> bool:
        """Enqueue through the shared bound: a ``job_queue`` row lands
        first (rejected → typed ``QueueFullError``, same as the local
        bound; a NON-TERMINAL row in any process → fleet-wide
        dedup-by-id), then the local fair queue.  Lifecycle
        transitions (running / done / error) ride the job's own hooks
        so the row always reflects what the local plane did."""
        if self.db is None:
            return self.jobs.enqueue(job)
        self._wrap_lifecycle(job)
        # queue_admit blocks on SQLite's write lock when a sibling is
        # admitting (BEGIN IMMEDIATE) — accepted on the caller's thread
        # because every in-tree transaction is micro (single-row CAS /
        # count+insert); submit() stays sync so the scheduler/web/RPC
        # callers keep their interface.  The slow row writes that CAN
        # queue behind real work (running/finish) are on the executor
        # via _wrap_lifecycle.
        verdict = self.db.queue_admit(job.id, job.kind, job.tenant,
                                      self.owner,
                                      max_queued=self.jobs.max_queued,
                                      weight=job.weight)
        if verdict == "active":
            if not self.jobs.is_active(job.id):
                # live row, not ours: the run is active in a SIBLING
                # process (or a local run completed inside the race
                # window — its row goes terminal before it leaves the
                # active set, so a legitimate retry is merely deferred
                # to the next tick).  Fleet-wide dedup-by-id: running
                # it here would double-run the job and blind GC's
                # fleet-wide running check.
                self.jobs.stats["deduped"] += 1
                return False
            # active HERE: JobsManager dedups.  If completion races
            # between the row check and this enqueue, the job really
            # enqueues (wrapped) — re-admit its row post-hoc,
            # boundless: one raced slip past the bound beats losing
            # the row's accounting.
            ok = self.jobs.enqueue(job)
            if ok:
                self.db.queue_admit(job.id, job.kind, job.tenant,
                                    self.owner, max_queued=0,
                                    weight=job.weight)
            return ok
        if verdict == "full":
            self.jobs.stats["rejected_full"] += 1
            raise QueueFullError(
                f"shared jobs queue full "
                f"({self.db.queue_depth()}/{self.jobs.max_queued} "
                f"queued across processes); rejecting {job.id!r}")
        try:
            ok = self.jobs.enqueue(job)
        except QueueFullError as e:
            # local bound tripped after the shared row landed (shared
            # passed at ≤ local count, so this is a cross-process race):
            # the row must not keep counting against the bound
            self.db.queue_finish(job.id, "rejected", str(e))
            raise
        if not ok:
            # deduped against an already-active id discovered inside
            # enqueue (completion raced the row check the OTHER way):
            # release the fresh row
            self.db.queue_finish(job.id, "done", "deduped")
        return ok

    def _wrap_lifecycle(self, job: Job) -> None:
        # row transitions run on the executor: the shared DB is write-
        # contended across PROCESSES (BEGIN IMMEDIATE admits, a
        # sibling's migration), and a blocking sqlite call on the
        # event loop during a lock wait would stall mux writes into
        # spurious write-deadline sheds
        db, jid = self.db, job.id
        orig_execute = job.execute
        orig_success = job.on_success
        orig_error = job.on_error

        async def execute():
            await asyncio.get_running_loop().run_in_executor(
                None, db.queue_mark_running, jid)
            if orig_execute is not None:
                await orig_execute()

        async def on_success():
            await asyncio.get_running_loop().run_in_executor(
                None, db.queue_finish, jid, "done")
            if orig_success is not None:
                await orig_success()

        async def on_error(exc: BaseException):
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: db.queue_finish(jid, "error", str(exc)))
            if orig_error is not None:
                await orig_error(exc)

        job.execute = execute
        job.on_success = on_success
        job.on_error = on_error

    # -- shared admission counters -----------------------------------------
    def flush_admission(self) -> None:
        """Fold this process's admission verdict deltas into the shared
        counters (called at shutdown and by fleet workers before a
        metrics dump — one DB write per flush, never per session)."""
        if self.db is None or self.agents is None:
            return
        stats = self.agents.admission_stats()
        deltas = {k: v - self._admission_flushed.get(k, 0)
                  for k, v in stats.items()}
        self.db.bump_admission_counters(deltas)
        self._admission_flushed = dict(stats)

    # -- backup enqueue (moved from Server) --------------------------------
    def enqueue_backup(self, job_id: str) -> bool:
        from ...proxmox.upid import make_upid
        from ..backup_job import (make_batch_hasher, make_chunker_factory,
                                  run_target_backup, validate_chunker_kind)
        config = self.config
        row = self.db.get_backup_job(job_id)
        if row is None:
            raise KeyError(f"unknown backup job {job_id!r}")
        if self.jobs.is_active(f"backup:{row.id}"):
            # dedup BEFORE creating the task row (the sync/verify rule:
            # a deduped enqueue must not leave an orphan 'running' task)
            return False
        upid = make_upid("backup", row.id)
        self.db.create_task(upid, row.id, "backup", detail=row.source_path)
        result_box: dict = {}

        store = self.datastore
        try:
            # the kind this run's store would chunk with: the row's, else
            # the server's (checked at boot)
            validate_chunker_kind(row.chunker or config.chunker)
        except ValueError as e:
            # Record as a job error rather than raising: a raise here
            # would abort the scheduler tick mid-loop and starve every
            # due job sorted after the misconfigured one.
            return self._reject(row, upid, f"job {row.id!r}: {e}")
        if row.store == "pbs":
            if not config.pbs_url:
                return self._reject(
                    row, upid, f"job {row.id!r} wants store='pbs' but no PBS "
                    f"push target is configured (ServerConfig.pbs_url)")
            from ...chunker import ChunkerParams
            from ...pxar.pbsstore import PBSConfig, PBSStore
            kind = row.chunker or config.chunker
            store = PBSStore(
                PBSConfig(base_url=config.pbs_url,
                          datastore=config.pbs_datastore,
                          auth_token=config.pbs_token,
                          namespace=config.pbs_namespace,
                          fingerprint=config.pbs_fingerprint),
                ChunkerParams(avg_size=config.chunk_avg),
                chunker_factory=make_chunker_factory(
                    kind, cpu_backend=config.chunker_backend,
                    device=self.device),
                batch_hasher=make_batch_hasher(kind, device=self.device),
                pipeline_workers=config.pipeline_workers,
                device=self.device)
        elif row.chunker and row.chunker != config.chunker:
            from ...chunker import ChunkerParams
            from ...pxar.backupproxy import LocalStore
            store = LocalStore(
                config.datastore_dir,
                ChunkerParams(avg_size=config.chunk_avg),
                chunker_factory=make_chunker_factory(
                    row.chunker, cpu_backend=config.chunker_backend,
                    device=self.device),
                batch_hasher=make_batch_hasher(row.chunker,
                                               device=self.device),
                pbs_format=config.datastore_format == "pbs",
                pipeline_workers=config.pipeline_workers,
                store_shards=(None if config.store_shards < 0
                              else config.store_shards),
                dedup_index_mb=0, device=self.device)
            # the per-job store shares the server datastore's directory —
            # share the ONE dedup index too (built above with index
            # disabled), so the two views can never disagree about
            # membership within this process.  RAW `_index`, not the
            # property: the getter would run the lazy boot scan HERE,
            # on the event loop — boot state rides the index object and
            # the scan happens on whichever writer thread probes first
            store.datastore.chunks.index = \
                self.datastore.datastore.chunks._index
            # same sharing rule for the similarity tier's sketch state
            store.datastore.chunks.similarity = \
                self.datastore.datastore.chunks.similarity

        async def execute():
            from .. import hooks
            while self._gc_active():       # never start mid-GC
                await asyncio.sleep(0.5)
            # serialize session startups; property-reached lock, so the
            # acquisition joins the static graph by its vocabulary name.
            # Timed: the per-service lock-wait histogram is where an
            # enqueue convoy would now show up (docs/observability.md)
            t_mu = time.perf_counter()
            async with self.jobs.startup_mu:   # pbslint: lock-order jobs.startup-mu
                trace.record("service.lock_wait",
                             time.perf_counter() - t_mu,
                             service="jobqueue")
            t0 = time.time()
            self.live_progress[row.id] = (t0, None)

            # pre-script: PBS_PLUS__* env, KEY=VALUE stdout feedback
            # (reference: runPreScript + override protocol, job.go:459-482)
            run_row = row
            pre = hooks.resolve_script(self.db, row.pre_script)
            if pre:
                fb = await hooks.run_hook(pre, hooks.job_env(row))
                if fb:
                    self.db.append_task_log(upid, f"pre-script: {fb}")
                import dataclasses
                run_row = dataclasses.replace(
                    row,
                    source_path=fb.get("SOURCE", row.source_path),
                    exclusions=row.exclusions +
                    ([fb["EXCLUDE"]] if fb.get("EXCLUDE") else []))
            result_box["row"] = run_row

            def on_pump(result):
                self.live_progress[row.id] = (t0, result)
            res = await run_target_backup(
                run_row, db=self.db, agents=self.agents, store=store,
                on_pump=on_pump,
                # applied by run_target_backup on the agent branch only
                # (the one place the target kind is resolved)
                breaker_factory=lambda: self.jobs.breaker(
                    f"agent:{run_row.target}",
                    failure_threshold=config.target_breaker_threshold,
                    reset_timeout_s=config.target_breaker_reset_s),
                attempts=config.backup_retry_attempts,
                checkpoint_interval=self._checkpoint_interval())
            result_box["res"] = res
            if res.manifest.get("resume"):
                self.jobs.note_resumed()
            result_box["t0"] = t0
            self.db.append_task_log(
                upid, f"backup complete: {res.entries} entries, "
                      f"{res.bytes_total} bytes -> {res.snapshot}")
            for err in res.errors[:50]:
                self.db.append_task_log(upid, f"warning: {err}")

        async def on_success():
            res = result_box.get("res")
            status = (database.STATUS_WARNING
                      if res and res.errors else database.STATUS_SUCCESS)
            self.live_progress.pop(row.id, None)
            if res is not None:
                self.last_run_stats[row.id] = {
                    "duration": time.time() - result_box.get("t0",
                                                             time.time()),
                    "bytes": res.bytes_total, "files": res.files,
                    "entries": res.entries, "errors": len(res.errors),
                    # backend pinned at stream open (manifest label):
                    # which chunker actually scanned this run's bytes
                    "chunker_backend":
                        res.manifest.get("chunker_backend", "")}
            self.db.finish_task(upid, status)
            self.db.record_backup_result(
                row.id, status, snapshot=res.snapshot if res else "")
            if self.on_backup_complete is not None:
                self.on_backup_complete(row.store)
            if self.notifications is not None:
                self.notifications.record(row.id, status)
            await self._post_hook(result_box.get("row", row), status,
                                  snapshot=res.snapshot if res else "")

        async def on_error(exc: BaseException):
            self.live_progress.pop(row.id, None)
            self.db.append_task_log(upid, f"error: {exc}")
            self.db.finish_task(upid, database.STATUS_ERROR)
            self.db.record_backup_result(row.id, database.STATUS_ERROR,
                                         error=str(exc))
            if self.notifications is not None:
                self.notifications.record(row.id, database.STATUS_ERROR,
                                          detail=str(exc))
            await self._post_hook(result_box.get("row", row),
                                  database.STATUS_ERROR, error=str(exc))

        try:
            # tenant = target CN: the fair dequeue's lane, so one noisy
            # tenant's backlog cannot starve another's single job
            ok = self.submit(Job(
                id=f"backup:{row.id}", kind="backup", tenant=row.target,
                execute=execute, on_success=on_success, on_error=on_error))
            if not ok:
                # deduped after the task row landed — locally (a
                # completion race) or in a SIBLING process (two
                # schedulers over one DB see the same due job every
                # tick): the row must not sit 'running' forever, or
                # the next boot converts it to an error AND re-enqueues
                # it as a crashed backup
                self.db.append_task_log(
                    upid, "skipped: already active in the fleet")
                self.db.finish_task(upid, database.STATUS_CANCELLED)
            return ok
        except QueueFullError as e:
            # typed fast-fail admission: record it as this run's failure
            # instead of letting the exception abort the scheduler tick
            return self._reject(row, upid, str(e), level=logging.WARNING)

    def _reject(self, row, upid: str, msg: str, *,
                level: int = logging.ERROR) -> bool:
        """Record a backup refused at enqueue as this run's failure, with
        full on_error parity (task log, job row, notification and
        post-script), so a refused backup is as loud as a failed one."""
        self.log.log(level, "backup %s rejected: %s", row.id, msg)
        self.db.append_task_log(upid, f"error: {msg}")
        self.db.finish_task(upid, database.STATUS_ERROR)
        self.db.record_backup_result(row.id, database.STATUS_ERROR,
                                     error=msg)
        if self.notifications is not None:
            self.notifications.record(row.id, database.STATUS_ERROR,
                                      detail=msg)
        try:
            # enqueue_backup is sync; fire the async post-script the
            # way on_error would have (callers all hold a loop)
            asyncio.get_running_loop().create_task(
                self._post_hook(row, database.STATUS_ERROR, error=msg))
        except RuntimeError:
            self.log.warning(
                "no running loop; post-hook skipped for rejected "
                "backup %s", row.id)
        return False

    async def _post_hook(self, row, status: str, *, snapshot: str = "",
                         error: str = "") -> None:
        """Best-effort post-script (reference: runPostScript — a failing
        post hook never changes the job result)."""
        from .. import hooks
        try:
            post = hooks.resolve_script(self.db, row.post_script)
            if post:
                await hooks.run_hook(post, hooks.job_env(
                    row, {"STATUS": status, "SNAPSHOT": snapshot,
                          "ERROR": error}))
        except Exception as e:
            self.log.warning("post-script for %s failed: %s", row.id, e)

    async def drain(self, timeout: float = 60.0) -> None:
        await self.jobs.drain(timeout=timeout)
