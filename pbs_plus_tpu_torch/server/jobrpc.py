"""One-shot job mutation over a unix socket.

Reference: internal/server/rpc/job_service.go:58-196 — the
``pbs_agent_job_mutate.sock`` JobRPCService (BackupQueue / RestoreQueue)
used by the one-shot CLI (``pbs_plus --backup-job <id>``) and cron.

Line protocol: one JSON object per line in, one JSON object per line
out.  Ops:

    {"op": "backup_queue",  "job_id": "<id>"}
    {"op": "restore_queue", "target": ..., "snapshot": ...,
     "destination": ..., "subpath": ""}
    {"op": "status", "job_id": "<id>"}          (backup job row)
    {"op": "list"}                              (job ids + states)

Local-root-only by unix permissions (socket mode 0600), matching the
reference's trust model for this socket.

A copy of the JAX package's ``server/jobrpc.py``, its code byte for
byte apart from its logger (``logging``).  The wire is the reference's,
so either package's ``call_job_rpc`` talks to either package's server."""

from __future__ import annotations

import asyncio
import json
import logging
import os

L = logging.getLogger(__name__)


class JobRPCServer:
    def __init__(self, server, socket_path: str):
        self.server = server
        self.path = socket_path
        self._srv: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # bind already-restricted: a permissive umask must never open a
        # window where another local user can connect before the chmod
        old_umask = os.umask(0o177)
        try:
            self._srv = await asyncio.start_unix_server(self._handle,
                                                        self.path)
        finally:
            os.umask(old_umask)
        os.chmod(self.path, 0o600)
        L.info("job-mutate socket at %s", self.path)

    async def stop(self) -> None:
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    resp = await self._dispatch(req)
                except Exception as e:
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        s = self.server
        if op == "backup_queue":
            started = s.enqueue_backup(req["job_id"])
            return {"ok": True, "started": started}
        if op == "restore_queue":
            from .jobs import QueueFullError
            from .restore_job import enqueue_restore
            try:
                rid = enqueue_restore(
                    s, target=req["target"], snapshot=req["snapshot"],
                    destination=req["destination"],
                    subpath=req.get("subpath", ""))
            except QueueFullError as e:
                return {"ok": False, "error": str(e)}
            return {"ok": True, "restore_id": rid}
        if op == "status":
            row = s.db.get_backup_job(req["job_id"])
            if row is None:
                return {"ok": False, "error": "unknown job"}
            return {"ok": True, "job": {
                "id": row.id, "last_status": row.last_status,
                "last_snapshot": row.last_snapshot,
                "last_error": row.last_error,
                "running": s.jobs.is_active(f"backup:{row.id}")}}
        if op == "list":
            return {"ok": True, "jobs": [
                {"id": j.id,
                 "running": s.jobs.is_active(f"backup:{j.id}"),
                 "last_status": j.last_status}
                for j in s.db.list_backup_jobs()]}
        return {"ok": False, "error": f"unknown op {op!r}"}


async def call_job_rpc(socket_path: str, req: dict,
                       timeout: float = 30.0) -> dict:
    """One-shot client used by the CLI."""
    reader, writer = await asyncio.open_unix_connection(socket_path)
    try:
        writer.write(json.dumps(req).encode() + b"\n")
        await writer.drain()
        line = await asyncio.wait_for(reader.readline(), timeout)
        if not line:
            raise ConnectionError("job socket closed without a response")
        return json.loads(line)
    finally:
        writer.close()
