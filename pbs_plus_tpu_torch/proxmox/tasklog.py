"""PBS-compatible task-log files.

Reference: internal/proxmox/tasklog/{active,archive,worker,queued,state}.go
— the stock PBS UI lists tasks from ``/var/log/proxmox-backup/tasks``:

    active                    one line per running task: "<upid> <stime hex>"
    archive                   finished tasks: "<upid> <endtime hex> <status>"
    <hash-dir>/<upid>         the task's log lines

Status strings: "OK", "WARNINGS: n", or the error message.

A copy of the JAX package's ``proxmox/tasklog.py``, its code byte for
byte.
"""

from __future__ import annotations

import fcntl
import os
import time
from typing import Optional

from .upid import UPID, new_upid


class TaskLogDir:
    def __init__(self, base: str):
        self.base = base
        os.makedirs(base, exist_ok=True)

    @property
    def active_path(self) -> str:
        return os.path.join(self.base, "active")

    @property
    def archive_path(self) -> str:
        return os.path.join(self.base, "archive")

    def task_file(self, upid: UPID) -> str:
        # PBS shards task files by starttime; a 2-hex shard keeps dirs small
        shard = f"{upid.starttime & 0xFF:02X}"
        d = os.path.join(self.base, shard)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, str(upid))

    def _append(self, path: str, line: str) -> None:
        with open(path, "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.write(line.rstrip("\n") + "\n")
            fcntl.flock(f, fcntl.LOCK_UN)

    def _remove_line(self, path: str, prefix: str) -> None:
        try:
            with open(path, "r+") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                lines = [ln for ln in f.readlines()
                         if not ln.startswith(prefix)]
                f.seek(0)
                f.truncate()
                f.writelines(lines)
                fcntl.flock(f, fcntl.LOCK_UN)
        except FileNotFoundError:
            pass

    # -- lifecycle ---------------------------------------------------------
    def start(self, upid: UPID) -> None:
        self._append(self.active_path, f"{upid} {upid.starttime:08X}")

    def finish(self, upid: UPID, status: str) -> None:
        self._remove_line(self.active_path, str(upid))
        self._append(self.archive_path,
                     f"{upid} {int(time.time()):08X} {status}")

    def list_active(self) -> list[str]:
        try:
            with open(self.active_path) as f:
                return [ln.split()[0] for ln in f if ln.strip()]
        except FileNotFoundError:
            return []

    def read_status(self, upid: UPID) -> Optional[str]:
        try:
            with open(self.archive_path) as f:
                for ln in f:
                    parts = ln.strip().split(" ", 2)
                    if parts and parts[0] == str(upid):
                        return parts[2] if len(parts) > 2 else "OK"
        except FileNotFoundError:
            pass
        return None


class WorkerTask:
    """A running task writing PBS-style log lines with a final status line
    (reference: tasklog/worker.go:24)."""

    def __init__(self, logs: TaskLogDir, worker_type: str, worker_id: str,
                 **upid_kw):
        self.logs = logs
        self.upid = new_upid(worker_type, worker_id, **upid_kw)
        self._path = logs.task_file(self.upid)
        self._warnings = 0
        logs.start(self.upid)

    def log(self, message: str) -> None:
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S%z")
        self.logs._append(self._path, f"{stamp}: {message}")

    def warn(self, message: str) -> None:
        self._warnings += 1
        self.log(f"WARN: {message}")

    def finish(self, error: str = "") -> str:
        if error:
            status = f"ERROR: {error}"
        elif self._warnings:
            status = f"WARNINGS: {self._warnings}"
        else:
            status = "OK"
        self.log(f"TASK {status}")
        self.logs.finish(self.upid, status)
        return status

    def read_log(self) -> str:
        try:
            with open(self._path) as f:
                return f.read()
        except FileNotFoundError:
            return ""
