"""Drive/volume enumeration for target registration.

Reference: internal/agent drive updates (cmd/agent/main_unix.go:118-148 —
periodic POST of the drive list to the server) and drives_windows.go.
Linux: parse lsblk JSON (gated) with a /proc/mounts fallback.

A copy of the JAX package's ``agent/drives.py``, its code byte for byte;
on Windows it enumerates through the port's ``agent/win/drives.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess


def enumerate_drives() -> list[dict]:
    """[{name, mountpoint, fstype, size_bytes, free_bytes}] for real
    filesystems (tmpfs/proc/etc. filtered).  Platform-dispatched: on
    Windows the CIM enumeration (agent/win/drives.py) serves the same
    shape."""
    if os.name == "nt":
        from .win.drives import enumerate_drives_windows
        return enumerate_drives_windows()
    out: list[dict] = []
    if shutil.which("lsblk"):
        try:
            r = subprocess.run(
                ["lsblk", "-J", "-b", "-o",
                 "NAME,MOUNTPOINT,FSTYPE,SIZE,TYPE"],
                capture_output=True, text=True, timeout=15, check=True)
            data = json.loads(r.stdout)

            def walk(devs):
                for d in devs:
                    if d.get("mountpoint") and d.get("type") in (
                            "part", "lvm", "crypt", "disk"):
                        out.append(_volume(d["mountpoint"],
                                           name=d.get("name", ""),
                                           fstype=d.get("fstype", "")))
                    walk(d.get("children", []) or [])
            walk(data.get("blockdevices", []))
        except (subprocess.SubprocessError, json.JSONDecodeError, OSError):
            pass
    if not out:
        out = _from_proc_mounts()
    return out


_SKIP_FS = {"proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup",
            "cgroup2", "overlay", "squashfs", "mqueue", "hugetlbfs",
            "debugfs", "tracefs", "securityfs", "pstore", "bpf",
            "binfmt_misc", "autofs", "fusectl", "configfs", "ramfs",
            "rpc_pipefs", "nsfs"}


def _from_proc_mounts() -> list[dict]:
    out = []
    seen = set()
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                dev, mnt, fstype = parts[0], parts[1], parts[2]
                if fstype in _SKIP_FS or mnt in seen:
                    continue
                seen.add(mnt)
                out.append(_volume(mnt, name=dev, fstype=fstype))
    except OSError:
        pass
    return out


def _volume(mountpoint: str, *, name: str = "", fstype: str = "") -> dict:
    total = free = 0
    try:
        sv = os.statvfs(mountpoint)
        total = sv.f_blocks * sv.f_frsize
        free = sv.f_bavail * sv.f_frsize
    except OSError:
        pass
    return {"name": name, "mountpoint": mountpoint, "fstype": fstype,
            "size_bytes": total, "free_bytes": free}
