"""Verification job: spot-check stored snapshots by re-hashing content.

Reference: internal/server/verification/job.go:41-130,765-1273 — weighted-
random backup selection by staleness, systematic file sampling, server-side
sha256 vs stored digests.  Here the re-hash is the batched VerifyPipeline
(one device dispatch instead of a worker pool).

A copy of the JAX package's ``server/verification_job.py``, its code
byte for byte apart from its imports, which name the port's own modules
(``VerifyPipeline`` on K2, ``SplitReader``, the chunk cache, the aRPC
``Session``, ``Job`` and the task ``STATUS_*``), its logger
(``logging``), and two changes. ``run_verification`` and
``enqueue_verification`` take ``device=`` (default ``"cuda"``; raises
without a card) for the pipeline that re-hashes. And the job treats a
queue at its bound by the exception's class name
(``jobs.is_queue_full``), so a JAX ``JobsManager``'s ``QueueFullError``
ends the task as the reference's does. The server is duck-typed:
``config.verify_workers``, ``datastore.datastore`` (either package's
``Datastore``), ``db``, ``jobs``/``job_queue`` and ``agents``."""

from __future__ import annotations

import asyncio
import logging
import os
import time

import numpy as np

from ..models.verify import VerifyPipeline
from ..pxar import chunkcache
from ..pxar.transfer import SplitReader
from ..utils.device import resolve
from . import database

L = logging.getLogger(__name__)


def verify_worker_count(server) -> int:
    """ServerConfig.verify_workers; 0 = auto (min(8, cores), the
    reference's min(NumCPU,16) verify pool scaled for the chunk-level
    loop), 1 = sequential."""
    n = int(getattr(server.config, "verify_workers", 0) or 0)
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return max(1, n)


def pick_snapshots(server, *, store_filter: str = "",
                   max_count: int = 3) -> list:
    """Weighted-random selection by staleness: older unverified snapshots
    first (reference: weighted-random by staleness)."""
    ds = server.datastore.datastore
    snaps = ds.list_snapshots(all_namespaces=True)
    if not snaps:
        return []
    weights = []
    now = time.time()
    for ref in snaps:
        try:
            man = ds.load_manifest(ref)
        except Exception:
            continue
        verified_at = man.get("verified_at", 0)
        age = max(1.0, now - max(verified_at, man.get("created_unix", 0)))
        weights.append((ref, age))
    weights.sort(key=lambda x: -x[1])
    return [ref for ref, _ in weights[:max_count]]


async def check_source_drift(server, ref, reader, *, rng,
                             max_files: int = 8) -> dict | None:
    """Agent-side cross-check (reference: verify_start RPC →
    VerifyChunkFileHandler, internal/agent/verification/handler.go:70-93):
    sample files from the snapshot and ask the LIVE agent to hash its
    current copy.  A mismatch is *drift* (the source changed since the
    backup), reported separately from corruption.  None when the group
    has no connected agent."""
    import os

    from ..arpc import Session

    row = next((j for j in server.db.list_backup_jobs()
                if (j.backup_id or j.target) == ref.backup_id), None)
    if row is None:
        return None
    target = server.db.get_target(row.target) or {}
    hostname = target.get("hostname") or row.target
    ctl = server.agents.get(hostname)
    if ctl is None:
        return None
    files = [e for e in reader.entries()
             if e.is_file and e.size > 0 and e.digest]
    if not files:
        return {"sampled": 0, "drifted": []}
    idx = rng.choice(len(files), size=min(max_files, len(files)),
                     replace=False)
    from ..arpc.call import CallError

    sess = Session(ctl.conn)
    drifted = []
    for i in sorted(int(x) for x in idx):
        e = files[i]
        path = os.path.join(row.source_path, e.path)
        try:
            resp = await sess.call("verify_start", {"path": path},
                                   timeout=120)
            if bytes.fromhex(resp.data["sha256"]) != e.digest:
                drifted.append(e.path)
        except CallError:
            # the agent answered: the file is gone/unreadable — drift
            drifted.append(f"{e.path} (unreadable on agent)")
        except (asyncio.TimeoutError, ConnectionError, OSError) as exc:
            # transport trouble is NOT drift: report the abort instead
            # of smearing the remaining samples as changed files
            return {"sampled": int(len(idx)), "drifted": drifted,
                    "aborted": f"agent unreachable mid-check: {exc}"}
    return {"sampled": int(len(idx)), "drifted": drifted}


async def run_verification(server, v: dict, *, device="cuda") -> dict:
    vp = VerifyPipeline(device=device)
    rng = np.random.default_rng()
    workers = verify_worker_count(server)
    report = {"checked": 0, "corrupt": [], "snapshots": [], "drift": []}
    for ref in pick_snapshots(server, store_filter=v.get("store", "")):
        # a PRIVATE cold cache per job, not the shared one: a
        # verification job exists to catch on-disk bitrot, so every
        # sampled chunk must be read (and digest-checked) from disk THIS
        # run — a shared-cache hit would vouch for bytes loaded before
        # the rot.  The private cache still buys single-flight +
        # readahead inside the job, and the full-snapshot scan cannot
        # evict the shared cache's hot restore/mount working set.
        shared = chunkcache.shared_cache()
        reader = SplitReader.open_snapshot(
            server.datastore.datastore, ref,
            cache=chunkcache.ChunkCache(
                shared.max_bytes,
                readahead_chunks=shared.readahead_chunks))
        res = await asyncio.get_running_loop().run_in_executor(
            None, lambda r=reader: vp.verify_snapshot(
                r, sample_rate=float(v.get("sample_rate", 0.1)), rng=rng,
                workers=workers))
        report["checked"] += res.checked
        report["snapshots"].append(str(ref))
        if not res.ok:
            report["corrupt"].append(
                {"snapshot": str(ref), "files": res.corrupt_paths})
        if v.get("check_source"):
            drift = await check_source_drift(server, ref, reader, rng=rng)
            if drift is not None and drift["drifted"]:
                report["drift"].append(
                    {"snapshot": str(ref), **drift})
    return report


def enqueue_verification(server, v: dict, *, device="cuda") -> bool:
    from ..proxmox.upid import make_upid
    from .jobs import Job
    device = resolve(device)
    vid = v["id"]
    if server.jobs.is_active(f"verify:{vid}"):
        # dedup BEFORE creating the task row: a deduped enqueue must not
        # leave an orphan task_log entry stuck "running" forever
        return False
    upid = make_upid("verify", vid)
    server.db.create_task(upid, vid, "verify")

    async def execute():
        while getattr(server, "_gc_active", False):   # never read mid-GC
            await asyncio.sleep(0.5)
        report = await run_verification(server, v, device=device)
        status = (database.STATUS_SUCCESS if not report["corrupt"]
                  else database.STATUS_ERROR)
        server.db.record_verification_result(vid, status, report)
        server.db.append_task_log(
            upid, f"verified {report['checked']} files across "
                  f"{len(report['snapshots'])} snapshots; "
                  f"{len(report['corrupt'])} corruption reports")
        server.db.finish_task(upid, status)
        if report["corrupt"]:
            L.error("verification found corruption: %s", report["corrupt"])

    async def on_error(exc):
        server.db.finish_task(upid, database.STATUS_ERROR)

    from .jobs import is_queue_full
    try:
        # one SHARED fairness lane for all verification jobs: a verify
        # config has no single target CN, and giving each config its own
        # lane would let 50 scheduled verifications crowd a backup
        # tenant out of 50/51 slot grants (docs/fleet.md "Fairness").
        # Through the JobQueueService's DB-mirrored shared bound when
        # the server has one; stubs keep the local queue.
        job_queue = getattr(server, "job_queue", None)
        submit = job_queue.submit if job_queue is not None \
            else server.jobs.enqueue
        return submit(
            Job(id=f"verify:{vid}", kind="verify", tenant="verify",
                execute=execute, on_error=on_error))
    except Exception as e:
        if not is_queue_full(e):
            raise
        server.db.append_task_log(upid, f"error: {e}")
        server.db.finish_task(upid, database.STATUS_ERROR)
        return False
