"""Sync job: replicate snapshot groups between datastores.

The job layer over ``pxar/syncwire.py``: resolves a ``sync_jobs`` DB row
into a (source, dest) endpoint pair — local↔local via a peer datastore
directory, or over the loopback HTTP wire via ``remote_url`` — and runs
the blocking engine in an executor through the bounded jobs queue.

Fairness: every sync job shares ONE fairness lane (``tenant="sync"``,
the verification-job crowding rule from docs/fleet.md) — a backlog of
scheduled syncs competes for a single tenant's round-robin share and
can never starve backup tenants out of slot grants.

Scheduling: calendar specs on the row are evaluated by the scheduler's
tick exactly like backup/verification schedules; the web CRUD
(``/api2/json/d2d/sync``) persists the rows.

A copy of the JAX package's ``server/sync_job.py``, its code byte for
byte apart from its imports, which name the port's own modules (the
UPID from ``proxmox/upid.py``, the only part of ``proxmox/`` in the
port), its logger (``logging``) and one change: a peer datastore
(``peer_path``) opens on the server's device (``Datastore(...,
device=server.device)``), as the server's own store does.  So each
membership batch of a sync into either store is a K3 probe on the
server's card.
"""

from __future__ import annotations

import asyncio
import logging

from ..utils import trace
from . import database

L = logging.getLogger(__name__)


def build_endpoints(server, row: dict):
    """(source, dest, state_root) for a sync job row.  The durable
    resume state always rides the server's own datastore (the side the
    operator owns either way)."""
    from ..pxar.datastore import Datastore
    from ..pxar.syncwire import (HttpSyncDest, HttpSyncSource,
                                 LocalSyncDest, LocalSyncSource)
    local_ds = server.datastore.datastore
    direction = row.get("direction", "pull")
    if row.get("remote_url"):
        if direction == "pull":
            source = HttpSyncSource(row["remote_url"],
                                    row.get("remote_token", ""))
            dest = LocalSyncDest(local_ds)
        else:
            source = LocalSyncSource(local_ds)
            dest = HttpSyncDest(row["remote_url"],
                                row.get("remote_token", ""))
    else:
        peer = Datastore(row["peer_path"], device=server.device)
        if direction == "pull":
            source, dest = LocalSyncSource(peer), LocalSyncDest(local_ds)
        else:
            source, dest = LocalSyncSource(local_ds), LocalSyncDest(peer)
    return source, dest, local_ds.base


def run_sync_job(server, row: dict) -> dict:
    """Blocking sync run (callers dispatch to an executor)."""
    from ..pxar.syncwire import run_sync
    source, dest, state_root = build_endpoints(server, row)
    try:
        return run_sync(
            source, dest, job_id=row["id"], state_root=state_root,
            backup_type=row.get("backup_type", ""),
            backup_id=row.get("backup_id", ""),
            namespace=row.get("namespace") or None)
    finally:
        for ep in (source, dest):
            close = getattr(ep, "close", None)
            if close is not None:
                close()


def enqueue_sync(server, row: dict) -> bool:
    """Enqueue one sync run through the bounded jobs queue; returns
    False when the job is already active or the queue is full."""
    from ..proxmox.upid import new_upid
    from .jobs import Job, QueueFullError
    sid = row["id"]
    if server.jobs.is_active(f"sync:{sid}"):
        # dedup BEFORE creating the task row (the verification rule: a
        # deduped enqueue must not leave an orphan 'running' task)
        return False
    # minted directly (not via store.make_upid): the composition root
    # drags in the TLS stack, which the sync layer never needs
    upid = str(new_upid("sync", sid))
    server.db.create_task(upid, sid, "sync",
                          detail=row.get("remote_url")
                          or row.get("peer_path", ""))

    async def execute():
        while getattr(server, "_gc_active", False):   # never write mid-GC
            await asyncio.sleep(0.5)
        # trace.wrap: the sync engine's negotiate/transfer spans on the
        # executor thread parent under this job's span
        report = await asyncio.get_running_loop().run_in_executor(
            None, trace.wrap(lambda: run_sync_job(server, row)))
        # the SyncStateService owns last-sync reports; bare
        # test stubs without the service keep the legacy dict write
        sync_state = getattr(server, "sync_state", None)
        if sync_state is not None:
            sync_state.record(sid, report)
        else:
            server.last_sync_stats[sid] = report
        server.db.record_sync_result(sid, database.STATUS_SUCCESS, report)
        server.db.append_task_log(
            upid, f"sync complete: {report['snapshots_synced']} synced, "
                  f"{report['snapshots_skipped']} up-to-date, "
                  f"{report['chunks_transferred']} chunks / "
                  f"{report['bytes_wire']} wire bytes"
                  f"{' (resumed)' if report['resumed'] else ''}")
        server.db.finish_task(upid, database.STATUS_SUCCESS)

    async def on_error(exc: BaseException):
        server.db.append_task_log(upid, f"error: {exc}")
        server.db.finish_task(upid, database.STATUS_ERROR)
        server.db.record_sync_result(sid, database.STATUS_ERROR,
                                     {"error": str(exc)})
        L.warning("sync job %s failed: %s", sid, exc)

    try:
        # ONE shared fairness lane for every sync job (docs/fleet.md
        # "Fairness": same crowding rule as verification — per-config
        # lanes would let scheduled syncs outvote backup tenants).
        # Submitted through the JobQueueService when the server has one
        # (the DB-mirrored shared bound); bare test stubs
        # fall back to the local JobsManager.
        job_queue = getattr(server, "job_queue", None)
        submit = job_queue.submit if job_queue is not None \
            else server.jobs.enqueue
        return submit(
            Job(id=f"sync:{sid}", kind="sync", tenant="sync",
                execute=execute, on_error=on_error))
    except QueueFullError as e:
        server.db.append_task_log(upid, f"error: {e}")
        server.db.finish_task(upid, database.STATUS_ERROR)
        server.db.record_sync_result(sid, database.STATUS_ERROR,
                                     {"error": str(e)})
        return False
