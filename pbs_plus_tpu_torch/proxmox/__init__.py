"""PBS integration: UPID task identifiers + PBS-compatible task-log files.

Reference: internal/proxmox (~1.9k LoC, SURVEY §2.6) — UPID parse/generate/
rewrite (upid.go:23-141), task-log files the stock PBS UI reads (active
file, archive index, worker task writer with status line, queued-task
placeholders), pxar path building, and proxmox-backup-manager CLI wrappers
for token/datastore management.

The CLI wrappers are thin subprocess shims gated on binary availability
(no PBS install in this image); UPID + task files are fully implemented so
a PBS host shows our tasks natively.

A copy of the JAX package's ``proxmox/__init__.py``, its code byte for
byte.
"""

from .upid import UPID, make_upid, new_upid, parse_upid
from .tasklog import TaskLogDir, WorkerTask

__all__ = ["UPID", "parse_upid", "new_upid", "make_upid", "TaskLogDir",
           "WorkerTask"]
