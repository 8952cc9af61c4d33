"""VSS snapshot handler (reference:
internal/agent/snapshots/ntfs_windows.go via mxk/go-vss).

Protocol (runner-seam testable on Linux): create a shadow copy of the
volume owning the source path via WMI through PowerShell, expose its
device path, and delete it on cleanup.

    powershell -NoProfile -Command (Get-CimInstance ... Win32_ShadowCopy
        ).Create('<vol>\\', 'ClientAccessible')  → {ShadowID}
    vssadmin list shadows /shadow={id}           → Device path
    vssadmin delete shadows /shadow={id} /quiet

A copy of the JAX package's ``agent/win/vss.py``, its code byte for
byte.
"""

from __future__ import annotations

import json
import re
import subprocess
from typing import Callable

from ..snapshots import Snapshot

Runner = Callable[..., "subprocess.CompletedProcess"]

_CREATE_PS = (
    "$r = (Get-CimInstance -ClassName Win32_ShadowCopy -List)."
    "Create('{vol}\\', 'ClientAccessible'); "
    "ConvertTo-Json @{{ReturnValue=$r.ReturnValue; ShadowID=$r.ShadowID}}"
)


class VssHandler:
    """SnapshotHandler-shaped; registered by SnapshotManager only when
    running on Windows (win.is_windows())."""

    name = "vss"

    def __init__(self, *, run: Runner = subprocess.run):
        self._run = run

    def available(self, fstype: str) -> bool:
        from . import is_windows
        return is_windows() and fstype.lower() in ("ntfs", "refs", "")

    @staticmethod
    def _volume_of(path: str) -> str:
        m = re.match(r"^([A-Za-z]:)", path)
        if not m:
            raise RuntimeError(f"cannot derive volume from {path!r}")
        return m.group(1)

    def create(self, path: str) -> Snapshot:
        vol = self._volume_of(path)
        r = self._run(
            ["powershell", "-NoProfile", "-Command",
             _CREATE_PS.format(vol=vol)],
            check=True, capture_output=True, text=True, timeout=300)
        out = json.loads(r.stdout)
        if out.get("ReturnValue") != 0:
            raise RuntimeError(f"VSS create failed rc={out.get('ReturnValue')}")
        shadow_id = out["ShadowID"]
        r = self._run(
            ["vssadmin", "list", "shadows", f"/shadow={shadow_id}"],
            check=True, capture_output=True, text=True, timeout=60)
        m = re.search(r"Shadow Copy Volume:\s*(\S+)", r.stdout)
        if not m:
            self.cleanup(Snapshot(path, path, self.name, handle=shadow_id))
            raise RuntimeError("VSS device path not found")
        device = m.group(1)
        rel = path[len(vol):].lstrip("\\/")
        snap_path = f"{device}\\{rel}" if rel else device
        return Snapshot(path, snap_path, self.name, handle=shadow_id)

    def cleanup(self, snap: Snapshot) -> None:
        if snap.handle:
            self._run(["vssadmin", "delete", "shadows",
                       f"/shadow={snap.handle}", "/quiet"],
                      capture_output=True, timeout=120)
