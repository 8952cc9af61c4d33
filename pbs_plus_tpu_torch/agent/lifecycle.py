"""Agent control-plane lifecycle: connect, serve handlers, reconnect.

Reference: internal/agent/lifecycle/manager.go:153-365 — ConnectARPC with
exponential backoff + jitter (500 ms → 30 s, ×2, ±20%), handler table
{ping, backup, restore, filetree, target_status, cleanup, cleanup_restore,
verify_start, update}, cert-error → clear certs + re-bootstrap.

Job execution model: the reference forks a child per job
(internal/agent/cli/entry.go:14-88) so a crashing job can't take down the
control session, and the child opens its own data connection carrying the
X-PBS-Plus-BackupID header.  This build runs jobs as asyncio tasks by
default (each with its own data connection — same wire behavior) and
supports subprocess isolation via ``python -m pbs_plus_tpu_torch
agent-job`` (``agent/jobproc.py``).

A copy of the JAX package's ``agent/lifecycle.py``: ``AgentConfig``, and
``AgentLifecycle`` with every handler of the reference (``ping``,
``target_status``, ``backup``, ``cleanup``, ``restore``,
``cleanup_restore``, ``filetree``, ``verify_start``, ``drives``,
``profile`` and ``update_now``), in-process or subprocess job isolation,
the reconnect loop, the drive-inventory push and self-update (the boot
``Watchdog``, the poller and the server-pushed ``update_now`` over
``agent/updater.py``).  Its code is byte for byte apart from its
imports, which name the port's own modules, and its logger
(``logging``; the scoped logger is a ``LoggerAdapter`` carrying the same
``agent`` field).  One addition: with ``tls=None`` (the transport's
plain loopback mode) the agent's handshakes claim its hostname in
``X-PBS-Plus-Loopback-CN``, so a plain loopback server admits it under
that name; its jobs then run as tasks (``subprocess`` isolation, whose
children dial mTLS sessions of their own, raises ``ValueError``).  And
a backup's job child takes the daemon's snapshot preference
(``SnapshotManager(prefer_direct=...)``), so an agent told to read trees
directly never has its children freeze or snapshot a filesystem either.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from dataclasses import dataclass

from ..arpc import Router, Session, TlsClientConfig, connect_to_server
from ..arpc.agents_manager import HDR_BACKUP_ID, HDR_RESTORE_ID
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
    kind: str                    # backup | restore
    conn: MuxConnection | None
    snapshot: Snapshot | None
    task: asyncio.Task | None = None
    proc: "asyncio.subprocess.Process | None" = None   # subprocess isolation


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
        if config.job_isolation == "subprocess" and config.tls is None:
            raise ValueError("job_isolation='subprocess' needs the agent's "
                             "certificate (tls): a job child dials its own "
                             "mTLS session; use 'task' on plain loopback")
        self.config = config
        self.snapshots = snapshot_manager or SnapshotManager()
        self.router = Router()
        self.jobs: dict[str, ActiveJob] = {}
        self.conn: MuxConnection | None = None
        self._stop = asyncio.Event()
        self._update_lock: asyncio.Lock | None = None   # made on first use
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
        r.handle("restore", self._restore_start)
        r.handle("cleanup_restore", self._cleanup)
        r.handle("filetree", self._filetree)
        r.handle("verify_start", self._verify_start)
        r.handle("drives", self._drives)
        # CPU-profile capture on demand (the agent-side pprof analog,
        # reference internal/agent/cli/entry.go:59-79)
        from ..utils.profiling import profile_rpc
        r.handle("profile", profile_rpc)
        r.handle("update_now", self._update_now)

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
        if self.config.job_isolation == "subprocess":
            from .jobproc import spawn_job_child
            proc = await spawn_job_child(
                "backup", job_id, self.config, source=source,
                prefer_direct=self.snapshots.prefer_direct)
            job = ActiveJob(job_id, "backup", None, None, proc=proc)
            job.task = asyncio.create_task(self._reap_child(job))
            self.jobs[job_id] = job
            self.log.info("backup job child spawned (pid %d)", proc.pid)
            return {"ok": True, "snapshot_method": "child",
                    "pid": proc.pid}
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

    async def _restore_start(self, req, ctx):
        """Server-initiated restore: open a job session on which the agent
        *drives* the restore (pulls archive content from the server's
        remote-pxar handlers and writes files locally)."""
        from .restore import run_restore_job
        job_id = req.payload["job_id"]
        dest = req.payload["destination"]
        if job_id in self.jobs:
            return {"ok": True, "already": True}
        if self.config.job_isolation == "subprocess":
            from .jobproc import spawn_job_child
            proc = await spawn_job_child("restore", job_id, self.config,
                                         destination=dest)
            job = ActiveJob(job_id, "restore", None, None, proc=proc)
            job.task = asyncio.create_task(self._reap_child(job))
            self.jobs[job_id] = job
            return {"ok": True, "pid": proc.pid}
        conn = await connect_to_server(
            self.config.server_host, self.config.server_port,
            self.config.tls,
            headers=self._headers({HDR_RESTORE_ID: job_id}))
        job = ActiveJob(job_id, "restore", conn, None)
        job.task = asyncio.create_task(
            self._run_restore(job, dest))
        self.jobs[job_id] = job
        return {"ok": True}

    async def _run_restore(self, job: ActiveJob, dest: str) -> None:
        from .restore import run_restore_job
        try:
            await run_restore_job(Session(job.conn), dest)
        except Exception:
            self.log.exception("restore job failed")
        finally:
            await job.conn.close()
            self.jobs.pop(job.job_id, None)

    @staticmethod
    def _remove_handoff(proc) -> None:
        """A child killed before consuming its one-time handoff leaves it
        behind — remove it so no job parameters linger on disk.  Called
        from every teardown path (reaper AND cleanup RPC)."""
        path = getattr(proc, "handoff_path", "")
        if path and os.path.exists(path):
            try:
                os.unlink(path)
            except OSError:
                pass

    async def _reap_child(self, job: ActiveJob) -> None:
        """Wait for a job child to exit; keep the job table accurate."""
        assert job.proc is not None
        rc = await job.proc.wait()
        self.jobs.pop(job.job_id, None)
        self._remove_handoff(job.proc)
        self.log.info("job child %s exited rc=%s", job.job_id, rc)

    async def _cleanup(self, req, ctx):
        """Kill a job session (reference: sync/backup.go:69-100 — the
        parent terminates the forked child; the child's own teardown
        releases its snapshot)."""
        job_id = req.payload["job_id"]
        job = self.jobs.pop(job_id, None)
        if job is not None:
            if job.proc is not None and job.proc.returncode is None:
                job.proc.terminate()
                try:
                    await asyncio.wait_for(job.proc.wait(), 10)
                except asyncio.TimeoutError:
                    job.proc.kill()
            if job.proc is not None:
                self._remove_handoff(job.proc)
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

    async def _verify_start(self, req, ctx):
        """Agent-side hash of a local file for spot-check verification
        (reference: internal/agent/verification/handler.go:70-93)."""
        import hashlib
        path = req.payload["path"]
        h = hashlib.sha256()
        def _hash():
            with open(path, "rb") as f:
                while True:
                    b = f.read(4 << 20)
                    if not b:
                        break
                    h.update(b)
            return h.hexdigest()
        try:
            digest = await asyncio.get_running_loop().run_in_executor(None, _hash)
        except OSError as e:
            from ..arpc.router import HandlerError
            raise HandlerError(str(e), status=404)
        return {"sha256": digest}

    # -- self-update (reference: internal/agent/updater + binswap) ---------
    @property
    def _update_configured(self) -> bool:
        c = self.config
        return bool(c.update_base_url and c.update_binary_path
                    and c.update_state_dir and c.update_signer_pub)

    async def _update_once(self) -> dict:
        """One poll→verify→stage→swap cycle.  The swapped artifact takes
        effect on the next service start; the boot-time Watchdog rolls
        back if the new version never reaches a healthy connect.
        Serialized: concurrent pushes/poller ticks must never run two
        swap cycles over one state dir (the second would clobber the
        rollback copy with the new binary)."""
        if not self._update_configured:
            return {"updated": False, "message": "updates not configured"}
        if self._update_lock is None:
            self._update_lock = asyncio.Lock()
        async with self._update_lock:
            return await self._update_once_locked()

    async def _update_once_locked(self) -> dict:
        import hashlib
        import ssl

        import aiohttp

        from .updater import BinSwap, SwapState, Updater
        c = self.config
        cur = "unknown"
        try:
            with open(c.update_binary_path, "rb") as f:
                cur = hashlib.sha256(f.read()).hexdigest()[:16]
        except OSError:
            pass
        swap = BinSwap(SwapState(c.update_binary_path, c.update_state_dir))
        if swap._marker().get("state") == "swapped":
            # a swapped-but-never-booted update is the rollback baseline:
            # swapping again would os.replace the unproven binary over
            # previous.bin and lose the last KNOWN-GOOD version
            return {"updated": False, "version": cur,
                    "message": "update pending restart; not re-swapping"}
        up = Updater(swap, current_version=cur,
                     signing_pubkey_pem=c.update_signer_pub)
        connector = None
        if c.update_ca_path:
            connector = aiohttp.TCPConnector(
                ssl=ssl.create_default_context(cafile=c.update_ca_path))
        try:
            async with aiohttp.ClientSession(connector=connector) as http:
                version = await up.check_and_stage(http, c.update_base_url)
            if version is None:
                return {"updated": False, "version": cur,
                        "message": "up to date"}
            swap.swap()
            return {"updated": True, "version": version,
                    "message": "staged + swapped; effective on restart"}
        except Exception as e:
            return {"updated": False, "version": cur,
                    "message": f"update failed: {type(e).__name__}: {e}"}

    async def _update_now(self, req, ctx):
        """Server-pushed immediate update (reference: push_update.go →
        the agent's update RPC)."""
        res = await self._update_once()
        self.log.info("push update: %s", res["message"])
        return res

    async def _update_poller(self) -> None:
        while not self._stop.is_set():
            await asyncio.sleep(self.config.update_interval_s)
            res = await self._update_once()
            msg = res.get("message", "")
            if res.get("updated"):
                self.log.info("auto-update: %s", msg)
            elif ("up to date" not in msg
                    and "pending restart" not in msg):
                # recurring silent failures would leave the fleet
                # quietly unpatched — surface every failed cycle (but a
                # healthy swap awaiting restart is not a failure)
                self.log.warning("auto-update: %s", msg)

    def _update_watchdog_on_boot(self) -> "object | None":
        """Run the rollback watchdog before the first connect; returns
        the Watchdog so a healthy connect can commit the update."""
        if not self._update_configured:
            return None
        from .updater import BinSwap, SwapState, Watchdog
        wd = Watchdog(BinSwap(SwapState(self.config.update_binary_path,
                                        self.config.update_state_dir)))
        state = wd.on_boot()
        if state != "no-pending":
            self.log.info("update watchdog: %s", state)
        return wd

    # -- connection loop ---------------------------------------------------
    async def run(self) -> None:
        """Reconnect loop with exponential backoff + jitter."""
        backoff = BACKOFF_MIN_S
        watchdog = self._update_watchdog_on_boot()
        updater_task = None
        if self._update_configured and self.config.update_interval_s > 0:
            updater_task = asyncio.create_task(self._update_poller())
        try:
            await self._run_loop(backoff, watchdog)
        finally:
            if updater_task is not None:
                updater_task.cancel()
                try:
                    await updater_task
                except asyncio.CancelledError:
                    pass        # its own cancellation: expected teardown
                except Exception as e:
                    self.log.warning("update poller died during "
                                     "shutdown: %s", e)

    async def _run_loop(self, backoff: float, watchdog) -> None:
        while not self._stop.is_set():
            try:
                self.conn = await connect_to_server(
                    self.config.server_host, self.config.server_port,
                    self.config.tls, headers=self._headers())
                self.log.info("control session connected")
                if watchdog is not None:
                    # healthy connect on the new binary: commit the swap
                    watchdog.mark_healthy()
                    watchdog = None
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
        """Stop the daemon.  Subprocess jobs are NOT killed — they own
        their snapshots and data sessions, finish serving, and clean up
        themselves (reference: child survives the service, snapshot
        lifetime tied to the job)."""
        self._stop.set()
        for job in list(self.jobs.values()):
            if job.conn is not None:
                await job.conn.close()
            if job.task is not None and job.proc is not None:
                job.task.cancel()       # stop reaping; child lives on
        if self.conn is not None:
            await self.conn.close()
