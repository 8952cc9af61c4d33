"""Fork-per-job agent isolation: each backup/restore runs in a spawned
``python -m pbs_plus_tpu_torch agent-job`` subprocess.

Reference: internal/agent/cli/entry.go:14-88 — the agent re-execs itself
per job with a one-time config/token file handed from parent to child;
the child creates the snapshot, opens its OWN data connection carrying
the job-identity header, and serves until the server disconnects.  The
payoffs:

- a crashing/leaking job handler cannot take the agent daemon down;
- snapshot lifetime is tied to the CHILD, not the daemon — killing the
  daemon mid-backup orphans nothing: the child finishes serving, then
  cleans up its snapshot/mounts itself;
- the child is independent of the control plane: one data session per
  child, ending when the server closes it (this build's server fails a
  job on the first data-session drop and retries with a fresh child —
  vs the reference child's reconnect-with-kept-snapshot,
  internal/agent/cli/backup.go:130-225; see child_backup_main).

The one-time handoff file (0600) holds the job config + a nonce; the
child deletes it before doing anything else, so the parameters cannot be
read twice or by a latecomer.

A copy of the JAX package's ``agent/jobproc.py``, its code byte for byte
apart from its logger (``logging``; the scoped logger is a
``LoggerAdapter`` carrying the same ``agent`` and ``backup_id`` fields),
the child's command line, which runs this package (``python -m
pbs_plus_tpu_torch agent-job``), and one addition: a backup child reads
its tree directly where the daemon's handoff says ``prefer_direct`` (the
daemon's own ``SnapshotManager`` does)."""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sys
import tempfile

from ..arpc import Router, Session, TlsClientConfig, connect_to_server
from ..arpc.agents_manager import HDR_BACKUP_ID, HDR_RESTORE_ID

L = logging.getLogger(__name__)


def write_handoff(config: dict) -> str:
    """Parent side: write the one-time job config file (0600 + nonce)."""
    config = dict(config)
    config["nonce"] = os.urandom(16).hex()
    fd, path = tempfile.mkstemp(prefix="pbs-plus-job.", suffix=".json")
    try:
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(config, f)
    except BaseException:
        os.unlink(path)
        raise
    return path


def read_handoff(path: str) -> dict:
    """Child side: read AND DELETE the handoff file (one-time)."""
    with open(path) as f:
        cfg = json.load(f)
    os.unlink(path)
    if not cfg.get("nonce"):
        raise ValueError("handoff file has no nonce")
    return cfg


def _tls(cfg: dict) -> TlsClientConfig:
    return TlsClientConfig(cfg["cert"], cfg["key"], cfg["ca"])


async def child_backup_main(cfg: dict) -> int:
    """Backup child: snapshot → job data session → serve agentfs until
    the server closes the session → clean up the snapshot → exit.

    One session per child, deliberately: the server races the pump
    against the session's disconnect and fails the job on the FIRST
    drop (crashed-job detection, docs/data-plane.md), so a dropped
    session is never resumable — the retry path spawns a fresh child
    with a fresh snapshot.  (The reference instead reconnects and keeps
    its snapshot, because its server tolerates data-session re-dials —
    a different recovery trade-off, chosen here for fast failure.)"""
    from .agentfs import AgentFSServer
    from .snapshots import SnapshotManager

    log = logging.LoggerAdapter(L, {"agent": cfg.get("hostname", "?"),
                                    "backup_id": cfg["job_id"]})
    snaps = SnapshotManager(prefer_direct=bool(cfg.get("prefer_direct")))
    snap = await asyncio.get_running_loop().run_in_executor(
        None, snaps.create, cfg["source"])
    log.info("job child: snapshot via %s", snap.method)
    try:
        conn = await connect_to_server(
            cfg["server_host"], int(cfg["server_port"]), _tls(cfg),
            headers={HDR_BACKUP_ID: cfg["job_id"]})
        fs = AgentFSServer(snap.snapshot_path)
        router = Router()
        fs.register(router)

        # the job child is where backup CPU burns — profile it through
        # its own data session (pprof-on-every-process)
        from ..utils.profiling import profile_rpc
        router.handle("profile", profile_rpc)
        try:
            await router.serve_connection(conn)
        finally:
            fs.close_all()
        log.info("job session ended (%s); child exiting",
                 conn.close_reason)
        return 0
    finally:
        await asyncio.get_running_loop().run_in_executor(
            None, snaps.cleanup, snap)
        log.info("job child: snapshot cleaned up")


async def child_restore_main(cfg: dict) -> int:
    """Restore child: dial the job session and drive the restore."""
    from .restore import run_restore_job

    conn = await connect_to_server(
        cfg["server_host"], int(cfg["server_port"]), _tls(cfg),
        headers={HDR_RESTORE_ID: cfg["job_id"]})
    try:
        await run_restore_job(Session(conn), cfg["destination"])
        return 0
    finally:
        await conn.close()


async def _with_signals(main, cfg: dict) -> int:
    """SIGTERM/SIGINT become task cancellation so the job's ``finally``
    (snapshot cleanup, session close) always runs — a plain signal death
    would orphan the snapshot."""
    import signal
    loop = asyncio.get_running_loop()
    task = asyncio.current_task()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, task.cancel)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        return await main(cfg)
    except asyncio.CancelledError:
        return 0


def run_child(config_path: str) -> int:
    """``python -m pbs_plus_tpu_torch agent-job --config <handoff>``
    entry."""
    cfg = read_handoff(config_path)
    mode = cfg.get("mode")
    if mode == "backup":
        return asyncio.run(_with_signals(child_backup_main, cfg))
    if mode == "restore":
        return asyncio.run(_with_signals(child_restore_main, cfg))
    raise SystemExit(f"unknown job mode {mode!r}")


async def spawn_job_child(mode: str, job_id: str, agent_cfg,
                          **params) -> asyncio.subprocess.Process:
    """Parent side: hand off the job to a fresh subprocess."""
    config = {
        "mode": mode, "job_id": job_id,
        "hostname": agent_cfg.hostname,
        "server_host": agent_cfg.server_host,
        "server_port": agent_cfg.server_port,
        "cert": agent_cfg.tls.cert_path, "key": agent_cfg.tls.key_path,
        "ca": agent_cfg.tls.ca_path,
        **params,
    }
    path = write_handoff(config)
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "pbs_plus_tpu_torch", "agent-job",
            "--config", path, env=env,
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL,
            start_new_session=True)   # survive daemon death (job owns it)
        proc.handoff_path = path      # reaper removes it if the child
        return proc                   # died before consuming it
    except BaseException:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
