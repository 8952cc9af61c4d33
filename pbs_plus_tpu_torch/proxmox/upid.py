"""PBS UPID (unique process identifier) format.

Reference: internal/proxmox/upid.go:23-141.  PBS wire format:

    UPID:<node>:<pid hex8>:<pstart hex8>:<task_id hex8>:<starttime hex8>:\
<worker_type>:<worker_id>:<auth_id>:

(worker_id is percent-encoded; trailing colon required.)

A copy of the JAX package's ``proxmox/upid.py``, its code byte for byte
apart from its imports, which name the port's own modules."""

from __future__ import annotations

import os
import re
import time
import urllib.parse
from dataclasses import dataclass

_RE = re.compile(
    r"^UPID:(?P<node>[a-zA-Z0-9._\-]+):(?P<pid>[0-9A-Fa-f]{8}):"
    r"(?P<pstart>[0-9A-Fa-f]{8,9}):(?P<task_id>[0-9A-Fa-f]{8,16}):"
    r"(?P<starttime>[0-9A-Fa-f]{8}):(?P<wtype>[^:\s]+):"
    r"(?P<wid>[^:\s]*):(?P<auth>[^:\s]+):$"
)

_counter = iter(range(1 << 30))


@dataclass(frozen=True)
class UPID:
    node: str
    pid: int
    pstart: int
    task_id: int
    starttime: int
    worker_type: str
    worker_id: str
    auth_id: str

    def __str__(self) -> str:
        wid = urllib.parse.quote(self.worker_id, safe="")
        return (f"UPID:{self.node}:{self.pid:08X}:{self.pstart:08X}:"
                f"{self.task_id:08X}:{self.starttime:08X}:"
                f"{self.worker_type}:{wid}:{self.auth_id}:")


def new_upid(worker_type: str, worker_id: str, *,
             node: str = "", auth_id: str = "root@pam") -> UPID:
    node = node or os.uname().nodename.split(".")[0]
    try:
        with open("/proc/self/stat") as f:
            pstart = int(f.read().split()[21]) & 0xFFFFFFFF
    except (OSError, IndexError, ValueError):
        pstart = 0
    return UPID(node=node, pid=os.getpid() & 0xFFFFFFFF, pstart=pstart,
                task_id=next(_counter), starttime=int(time.time()),
                worker_type=worker_type, worker_id=worker_id,
                auth_id=auth_id)


def make_upid(kind: str, job_id: str) -> str:
    """PBS-compatible unique process id STRING for task logs — the one
    shared wrapper (reference: internal/proxmox/upid.go:23-141); the
    composition root and the jobs service both mint through here so
    the format can never diverge between the two paths."""
    return str(new_upid(kind, job_id))


def parse_upid(s: str) -> UPID:
    m = _RE.match(s.strip())
    if m is None:
        raise ValueError(f"invalid UPID {s!r}")
    return UPID(
        node=m["node"], pid=int(m["pid"], 16), pstart=int(m["pstart"], 16),
        task_id=int(m["task_id"], 16), starttime=int(m["starttime"], 16),
        worker_type=m["wtype"],
        worker_id=urllib.parse.unquote(m["wid"]), auth_id=m["auth"])
