"""CheckpointService: startup self-heal + checkpoint policy.

Owns what the ``Server`` god-object used to inline: converting tasks
found 'running' at boot (they died with the previous process) into
error tasks, re-enqueueing the backup jobs among them as resumable —
with durable checkpoints (server/checkpoint.py) the re-run picks up
from the last checkpoint instead of byte zero — and resolving the
effective checkpoint interval the enqueue path attaches to sessions.

A copy of the JAX package's ``server/services/checkpoint_service.py``,
its code byte for byte apart from its imports, which name the port's own
modules, and its logger (``logging``; the scoped logger is a
``LoggerAdapter``)."""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from ...utils import conf
from .. import database

L = logging.getLogger(__name__)


class CheckpointService:
    def __init__(self, *, db, config,
                 enqueue_backup: Callable[[str], bool]):
        self.db = db
        self.config = config
        self._enqueue_backup = enqueue_backup
        self._tasks: list[asyncio.Task] = []
        self.log = logging.LoggerAdapter(
            L, {"component": "checkpoint-service"})

    def interval(self) -> str:
        """The effective checkpoint cadence: server config, falling back
        to PBS_PLUS_CHECKPOINT_INTERVAL (conf.env)."""
        return self.config.checkpoint_interval \
            or conf.env().checkpoint_interval

    def cleanup_orphaned_tasks(self) -> None:
        """Tasks still 'running' at startup died with the previous
        process — convert them to error tasks (reference:
        cleanupQueuedBackups, internal/server/bootstrap.go:136-171),
        then re-enqueue the backup jobs among them as resumable."""
        from ..backup_job import crashed_backup_job_ids
        orphans = self.db.list_running_tasks()
        requeue = crashed_backup_job_ids(self.db, orphans)
        for t in orphans:
            self.db.append_task_log(
                t["upid"], "error: interrupted by server restart")
            self.db.finish_task(t["upid"], database.STATUS_ERROR)
        if orphans:
            self.log.warning("converted %d orphaned tasks to errors",
                             len(orphans))
        if not requeue or self.config.resume_requeue_delay_s < 0:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self.log.warning("no running event loop: %d crashed "
                             "backup(s) not re-enqueued", len(requeue))
            return
        self._tasks.append(loop.create_task(
            self._requeue_crashed(requeue)))
        # logged only once the requeue is actually scheduled, so the
        # task log never promises a resume that was disabled/failed
        for t in orphans:
            if t["kind"] == "backup" and t["job_id"] in requeue:
                self.db.append_task_log(
                    t["upid"], "re-enqueued for resume after restart")

    async def _requeue_crashed(self, job_ids: list[str]) -> None:
        """Startup self-heal: give agents a moment to reconnect, then
        re-enqueue the backups that died with the previous process."""
        if self.config.resume_requeue_delay_s:
            await asyncio.sleep(self.config.resume_requeue_delay_s)
        for jid in job_ids:
            try:
                self._enqueue_backup(jid)
                self.log.info("re-enqueued crashed backup %s for resume",
                              jid)
            except Exception as e:
                self.log.warning("re-enqueue of crashed backup %s "
                                 "failed: %s", jid, e)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass        # we cancelled it above
            except Exception as e:
                self.log.debug("requeue task died at shutdown: %s", e)
        self._tasks.clear()
