"""Restore job: serve a snapshot to an agent that writes it out locally.

Reference: internal/server/restore/job.go:54-663 (SURVEY §3.3) —
target_status probe → "restore" RPC forks the agent child → child dials
the data pipe with X-PBS-Plus-RestoreID → server opens the snapshot and
registers the remote-archive handlers on that pipe → agent pulls and
writes.

A copy of the JAX package's ``server/restore_job.py``, its code byte for
byte apart from its logger (``logging``; the scoped logger is a
``LoggerAdapter`` carrying the same ``restore_id`` field).  The snapshot
is read on the host through the port's ``SplitReader`` and shared chunk
cache; the agent checks each restored file against its entry's SHA-256.
"""

from __future__ import annotations

import asyncio
import logging
import uuid

from ..arpc import Router, Session
from ..pxar import chunkcache
from ..pxar.datastore import parse_snapshot_ref
from ..pxar.remote import RemoteArchiveServer
from ..pxar.transfer import SplitReader
from . import database

L = logging.getLogger(__name__)


async def run_restore_job(server, rid: str, *, target: str, snapshot: str,
                          destination: str, subpath: str = "") -> dict:
    """``server`` is the composition root (server/store.py Server)."""
    db: database.Database = server.db
    agents = server.agents
    log = logging.LoggerAdapter(L, {"restore_id": rid})

    trow = db.get_target(target)
    if trow is None:
        raise RuntimeError(f"unknown target {target!r}")
    hostname = trow["hostname"] or target
    control = agents.get(hostname)
    if control is None:
        raise RuntimeError(f"agent {hostname!r} not connected")
    control_sess = Session(control.conn)

    ref = parse_snapshot_ref(snapshot)
    # the process-shared chunk cache (single-flight + readahead): an
    # agent pulling files front-to-back turns into a sequence of forward
    # scans, and concurrent restores of sibling snapshots share every
    # deduped chunk they touch (pxar/chunkcache.py)
    reader = SplitReader.open_snapshot(server.datastore.datastore, ref,
                                       cache=chunkcache.shared_cache())
    remote = RemoteArchiveServer(reader, subpath=subpath)
    job_router = Router()
    remote.register(job_router)

    client_id = f"{hostname}|{rid}|restore"
    agents.expect(client_id)
    server._job_routers[client_id] = job_router
    db.update_restore(rid, database.STATUS_RUNNING)
    try:
        await control_sess.call(
            "restore", {"job_id": rid, "destination": destination},
            timeout=60)
        sess = await agents.wait_session(client_id, timeout=60)
        # the agent drives; we wait for its "done" or its session death.
        # A severed session without "done" is a crashed restore — never
        # record success for it (crashed-job detection, reference:
        # internal/server/vfs/arpcfs/fs.go:119-148)
        disc = agents.watch_disconnect(sess)
        try:
            while not sess.conn.closed and not remote.done:
                done_set, _ = await asyncio.wait(
                    {disc}, timeout=0.2,
                    return_when=asyncio.FIRST_COMPLETED)
                if done_set:
                    break
        finally:
            agents.unwatch_disconnect(sess, disc)
            if not disc.done():
                disc.cancel()
        if not remote.done:
            # grace for the in-flight "done" handler racing the close
            for _ in range(10):
                await asyncio.sleep(0.05)
                if remote.done:
                    break
        if not remote.done:
            raise RuntimeError(
                f"agent restore session lost before completion ({client_id})")
        db.update_restore(rid, database.STATUS_SUCCESS)
        hits, misses = reader.cache_stats
        log.info("restore served: done=%s chunk cache hits=%d misses=%d",
                 remote.done, hits, misses)
        return {"done": remote.done}
    except BaseException as e:
        db.update_restore(rid, database.STATUS_ERROR, error=str(e))
        raise
    finally:
        agents.unexpect(client_id)
        server._job_routers.pop(client_id, None)
        try:
            await control_sess.call("cleanup_restore", {"job_id": rid},
                                    timeout=15)
        except Exception as e:
            log.warning("agent cleanup_restore RPC failed: %s", e)


def enqueue_restore(server, *, target: str, snapshot: str,
                    destination: str, subpath: str = "") -> str:
    from .jobs import Job
    from .store import make_upid
    parse_snapshot_ref(snapshot)     # reject bad refs before any row/task
    rid = f"restore-{uuid.uuid4().hex[:8]}"
    server.db.create_restore(rid, target, snapshot, destination, subpath)
    upid = make_upid("restore", rid)
    server.db.create_task(upid, rid, "restore", detail=f"{snapshot} -> {destination}")

    async def execute():
        while getattr(server, "_gc_active", False):   # never read mid-GC
            await asyncio.sleep(0.5)
        await run_restore_job(server, rid, target=target, snapshot=snapshot,
                              destination=destination, subpath=subpath)
        server.db.append_task_log(upid, "restore served to agent")

    async def on_success():
        server.db.finish_task(upid, database.STATUS_SUCCESS)

    async def on_error(exc):
        server.db.append_task_log(upid, f"error: {exc}")
        server.db.finish_task(upid, database.STATUS_ERROR)

    from .jobs import QueueFullError
    try:
        # through the JobQueueService when the server has one: a
        # restore must land a shared job_queue row, or a SIBLING
        # process's GC-lease winner cannot see it running fleet-wide
        # and could prune the very snapshot this restore is reading
        job_queue = getattr(server, "job_queue", None)
        submit = job_queue.submit if job_queue is not None \
            else server.jobs.enqueue
        submit(Job(id=rid, kind="restore", tenant=target,
                   execute=execute, on_success=on_success,
                   on_error=on_error))
    except QueueFullError as e:
        server.db.append_task_log(upid, f"error: {e}")
        server.db.finish_task(upid, database.STATUS_ERROR)
        raise
    return rid
