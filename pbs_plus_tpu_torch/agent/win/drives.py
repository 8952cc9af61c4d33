"""Windows drive enumeration (reference:
internal/agent/drives_windows.go — the periodic drive update payload).

Protocol (runner-seam testable): CIM logical disks as JSON:

    powershell ... Get-CimInstance Win32_LogicalDisk |
        Select DeviceID,FileSystem,Size,FreeSpace,DriveType |
        ConvertTo-Json

DriveType 3 = local disk, 4 = network, 2 = removable; only 3 (and
optionally 2) are backup targets, matching the reference's filter.

A copy of the JAX package's ``agent/win/drives.py``, its code byte for
byte."""

from __future__ import annotations

import json
import subprocess
from typing import Callable

Runner = Callable[..., "subprocess.CompletedProcess"]

_PS = ("Get-CimInstance Win32_LogicalDisk | "
       "Select-Object DeviceID,FileSystem,Size,FreeSpace,DriveType | "
       "ConvertTo-Json -Compress")


def enumerate_drives_windows(*, run: Runner = subprocess.run,
                             include_removable: bool = False) -> list[dict]:
    """Same shape as agent.drives.enumerate_drives: [{name, mountpoint,
    fstype, size_bytes, free_bytes}]."""
    r = run(["powershell", "-NoProfile", "-NonInteractive", "-Command",
             _PS], check=True, capture_output=True, text=True, timeout=60)
    data = json.loads(r.stdout or "[]")
    if isinstance(data, dict):          # single drive → bare object
        data = [data]
    kinds = (3, 2) if include_removable else (3,)
    out = []
    for d in data:
        if d.get("DriveType") not in kinds:
            continue
        dev = str(d.get("DeviceID", ""))
        out.append({
            "name": dev.rstrip(":"),
            "mountpoint": dev + "\\",
            "fstype": str(d.get("FileSystem") or "").lower(),
            "size_bytes": int(d.get("Size") or 0),
            "free_bytes": int(d.get("FreeSpace") or 0),
        })
    return out
