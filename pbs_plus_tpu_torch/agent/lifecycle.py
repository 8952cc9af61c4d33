"""Agent control-plane lifecycle: connect, serve handlers, reconnect.

Reference: internal/agent/lifecycle/manager.go:153-365 — ConnectARPC with
exponential backoff + jitter (500 ms → 30 s, ×2, ±20%), handler table
{ping, backup, restore, filetree, target_status, cleanup, cleanup_restore,
verify_start, update}, cert-error → clear certs + re-bootstrap.

Job execution model: the reference forks a child per job
(internal/agent/cli/entry.go:14-88) so a crashing job can't take down the
control session, and the child opens its own data connection carrying the
X-PBS-Plus-BackupID header.  This build runs jobs as asyncio tasks (each
with its own data connection — same wire behavior).

A copy of the part of the JAX package's ``agent/lifecycle.py`` that a
backup job reaches: ``AgentConfig``, and ``AgentLifecycle`` with the
handlers ``ping``, ``target_status``, ``backup``, ``cleanup``,
``filetree`` and ``drives``, the reconnect loop and the drive-inventory
push.  Its code is byte for byte apart from its imports, which name the
port's own modules, and its logger (``logging``; the scoped logger is a
``LoggerAdapter`` carrying the same ``agent`` field).  Not ported yet,
each raising ``ValueError`` at construction where a config asks for it:
subprocess job isolation (``agent/jobproc.py`` and an ``agent-job``
command) and self-update (``agent/updater.py``); the ``restore``,
``cleanup_restore``, ``verify_start``, ``profile`` and ``update_now``
handlers are not registered (``agent/restore.py``, ``utils/profiling.py``
and ``agent/updater.py`` are not ported), so a server calling them gets
the router's "unknown method" answer.  One addition: with ``tls=None``
(the transport's plain loopback mode) the agent's handshakes claim its
hostname in ``X-PBS-Plus-Loopback-CN``, so a plain loopback server admits
it under that name.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from dataclasses import dataclass

from ..arpc import Router, Session, TlsClientConfig, connect_to_server
from ..arpc.agents_manager import HDR_BACKUP_ID
from ..arpc.mux import MuxConnection
from ..arpc.transport import HDR_LOOPBACK_CN
from .agentfs import AgentFSServer
from .snapshots import Snapshot, SnapshotManager

L = logging.getLogger(__name__)

BACKOFF_MIN_S = 0.5
BACKOFF_MAX_S = 30.0


@dataclass
class ActiveJob:
    job_id: str
    kind: str                    # backup
    conn: MuxConnection | None
    snapshot: Snapshot | None
    task: asyncio.Task | None = None


@dataclass
class AgentConfig:
    hostname: str
    server_host: str
    server_port: int
    tls: TlsClientConfig | None      # None: plain loopback (tests, bench)
    # "subprocess" = fork-per-job (reference: cli.Entry re-exec,
    # internal/agent/cli/entry.go:14-88); "task" = in-process asyncio
    job_isolation: str = "task"
    # periodic volume-inventory push over the control session
    # (reference: cmd/agent/main_unix.go:118-148); 0 disables
    drive_update_interval_s: float = 300.0
    # self-update (reference: internal/agent/{updater,binswap}) — all four
    # must be set to enable; the signer key is PINNED (fetched once at
    # install, never over the update channel)
    update_base_url: str = ""          # server web base URL
    update_binary_path: str = ""       # the live artifact (.pyz) to swap
    update_state_dir: str = ""         # staging + rollback markers
    update_signer_pub: bytes = b""     # Ed25519 release key (PEM)
    update_interval_s: float = 3600.0  # poll cadence; 0 = RPC-only
    update_ca_path: str = ""           # CA for the update HTTPS endpoint


class AgentLifecycle:
    """Owns the control session and job sessions."""

    def __init__(self, config: AgentConfig, *,
                 snapshot_manager: SnapshotManager | None = None):
        if config.job_isolation != "task":
            raise ValueError(
                f"job_isolation={config.job_isolation!r} needs "
                "agent/jobproc.py and the 'python -m pbs_plus_tpu_torch "
                "agent-job' command, not yet ported; use 'task'")
        if all((config.update_base_url, config.update_binary_path,
                config.update_state_dir, config.update_signer_pub)):
            raise ValueError("self-update needs agent/updater.py, not yet "
                             "ported; leave the update_* fields empty")
        self.config = config
        self.snapshots = snapshot_manager or SnapshotManager()
        self.router = Router()
        self.jobs: dict[str, ActiveJob] = {}
        self.conn: MuxConnection | None = None
        self._stop = asyncio.Event()
        self._register_handlers()
        self.log = logging.LoggerAdapter(L, {"agent": config.hostname})

    def _headers(self, headers: dict | None = None) -> dict:
        """Handshake headers; with ``tls=None`` (the transport's plain
        loopback mode) they claim the agent's hostname as its identity,
        which a certificate carries otherwise."""
        out = dict(headers or {})
        if self.config.tls is None:
            out[HDR_LOOPBACK_CN] = self.config.hostname
        return out

    # -- handlers ----------------------------------------------------------
    def _register_handlers(self) -> None:
        r = self.router
        r.handle("ping", self._ping)
        r.handle("target_status", self._target_status)
        r.handle("backup", self._backup_start)
        r.handle("cleanup", self._cleanup)
        r.handle("filetree", self._filetree)
        r.handle("drives", self._drives)

    async def _drives(self, req, ctx):
        from .drives import enumerate_drives
        ds = await asyncio.get_running_loop().run_in_executor(
            None, enumerate_drives)
        return {"drives": ds}

    async def _ping(self, req, ctx):
        return {"pong": True, "hostname": self.config.hostname}

    async def _target_status(self, req, ctx):
        import os
        path = req.payload.get("path", "/")
        return {"ok": os.path.exists(path), "path": path}

    async def _filetree(self, req, ctx):
        """Shallow directory listing for the UI's file-tree browser."""
        import os
        path = req.payload.get("path", "/")
        out = []
        try:
            with os.scandir(path) as it:
                for e in sorted(it, key=lambda x: x.name)[:1000]:
                    out.append({"name": e.name,
                                "dir": e.is_dir(follow_symlinks=False)})
        except OSError as e:
            from ..arpc.router import HandlerError
            raise HandlerError(str(e), status=404)
        return {"entries": out}

    async def _backup_start(self, req, ctx):
        """Server-initiated backup: snapshot the source, open a job data
        session, serve agentfs on it (reference: sync.BackupStartHandler →
        cli.ExecBackup, SURVEY §3.2)."""
        job_id = req.payload["job_id"]
        source = req.payload["source"]
        if job_id in self.jobs:
            return {"ok": True, "already": True}
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.snapshots.create, source)
        try:
            conn = await connect_to_server(
                self.config.server_host, self.config.server_port,
                self.config.tls,
                headers=self._headers({HDR_BACKUP_ID: job_id}))
        except BaseException:
            self.snapshots.cleanup(snap)
            raise
        fs = AgentFSServer(snap.snapshot_path)
        job_router = Router()
        fs.register(job_router)
        job = ActiveJob(job_id, "backup", conn, snap)
        job.task = asyncio.create_task(
            self._serve_job(job, job_router, fs))
        self.jobs[job_id] = job
        self.log.info("backup job session opened")
        return {"ok": True, "snapshot_method": snap.method}

    async def _serve_job(self, job: ActiveJob, router: Router,
                         fs: AgentFSServer) -> None:
        try:
            await router.serve_connection(job.conn)
        finally:
            fs.close_all()
            if job.snapshot is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.snapshots.cleanup, job.snapshot)
            self.jobs.pop(job.job_id, None)
            self.log.info("backup job session closed")

    async def _cleanup(self, req, ctx):
        """Kill a job session (reference: sync/backup.go:69-100); the
        job's own teardown releases its snapshot."""
        job_id = req.payload["job_id"]
        job = self.jobs.pop(job_id, None)
        if job is not None:
            if job.conn is not None:
                await job.conn.close()
            if job.task:
                job.task.cancel()
                try:
                    # gather absorbs the task's own CancelledError so the
                    # handler still returns its RPC response; our OWN
                    # cancellation (wait_for raising) still propagates
                    await asyncio.wait_for(
                        asyncio.gather(job.task, return_exceptions=True),
                        10)
                except asyncio.TimeoutError:
                    pass
        return {"ok": True, "found": job is not None}

    # -- connection loop ---------------------------------------------------
    async def run(self) -> None:
        """Reconnect loop with exponential backoff + jitter."""
        await self._run_loop(BACKOFF_MIN_S)

    async def _run_loop(self, backoff: float) -> None:
        while not self._stop.is_set():
            try:
                self.conn = await connect_to_server(
                    self.config.server_host, self.config.server_port,
                    self.config.tls, headers=self._headers())
                self.log.info("control session connected")
                backoff = BACKOFF_MIN_S
                pusher = None
                if self.config.drive_update_interval_s > 0:
                    pusher = asyncio.create_task(
                        self._drive_pusher(self.conn))
                try:
                    await self.router.serve_connection(self.conn)
                finally:
                    if pusher is not None:
                        pusher.cancel()
                        try:
                            await pusher
                        except asyncio.CancelledError:
                            # only swallow the pusher's own cancellation;
                            # OUR task being cancelled must propagate
                            if asyncio.current_task().cancelling():
                                raise
                        except Exception as e:
                            self.log.warning(
                                "drive pusher died with session: %s", e)
                self.log.warning("control session lost: %s",
                                 self.conn.close_reason)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.log.warning("connect failed: %s", e)
            if self._stop.is_set():
                return
            sleep = backoff * (1 + random.uniform(-0.2, 0.2))
            backoff = min(backoff * 2, BACKOFF_MAX_S)
            try:
                await asyncio.wait_for(self._stop.wait(), sleep)
            except asyncio.TimeoutError:
                pass

    async def _drive_pusher(self, conn: MuxConnection) -> None:
        """Push the volume inventory right after connect, then on the
        configured interval, while this control session lives."""
        from .drives import enumerate_drives
        sess = Session(conn)
        while not conn.closed:
            try:
                ds = await asyncio.get_running_loop().run_in_executor(
                    None, enumerate_drives)
                await sess.call("drive_update", {"drives": ds}, timeout=30)
            except Exception as e:
                self.log.warning("drive update failed: %s", e)
            await asyncio.sleep(self.config.drive_update_interval_s)

    async def connect_once(self) -> None:
        """Single connect + serve (tests / foreground)."""
        self.conn = await connect_to_server(
            self.config.server_host, self.config.server_port, self.config.tls,
            headers=self._headers())
        await self.router.serve_connection(self.conn)

    async def stop(self) -> None:
        """Stop the daemon: close every job session (each job's task then
        releases its snapshot) and the control session."""
        self._stop.set()
        for job in list(self.jobs.values()):
            if job.conn is not None:
                await job.conn.close()
        if self.conn is not None:
            await self.conn.close()
