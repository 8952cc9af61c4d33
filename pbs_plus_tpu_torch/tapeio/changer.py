"""SCSI media-changer abstraction.

Reference: internal/changer/{changer,sgio,smc}.go — SCSI Medium Changer
(SMC) commands over sg ioctls: READ ELEMENT STATUS (inventory), MOVE
MEDIUM (load/unload).  No tape hardware exists in this image, so the
transport is injectable: the real backend shells to ``mtx`` (the standard
SMC userland tool) when present; tests inject a fake transport.

A copy of the JAX package's ``tapeio/changer.py``, its code byte for
byte.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Optional

Transport = Callable[[list[str]], str]


class ChangerError(RuntimeError):
    pass


@dataclass
class Slot:
    index: int
    kind: str               # "drive" | "storage" | "import_export"
    full: bool
    volume_tag: str = ""


@dataclass
class Inventory:
    drives: list[Slot] = field(default_factory=list)
    slots: list[Slot] = field(default_factory=list)

    def find_tag(self, volume_tag: str) -> Optional[Slot]:
        for s in [*self.drives, *self.slots]:
            if s.volume_tag == volume_tag:
                return s
        return None


def _mtx_transport(device: str) -> Transport:
    if shutil.which("mtx") is None:
        raise ChangerError("mtx not available (no SMC userland)")

    def run(args: list[str]) -> str:
        r = subprocess.run(["mtx", "-f", device, *args],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise ChangerError(f"mtx {' '.join(args)}: {r.stderr.strip()}")
        return r.stdout
    return run


_DRIVE_RE = re.compile(
    r"Data Transfer Element (\d+):(Full|Empty)"
    r"(?:.*VolumeTag\s*=\s*(\S+))?")
_SLOT_RE = re.compile(
    r"Storage Element (\d+)(?: IMPORT/EXPORT)?:(Full|Empty)"
    r"(?:\s*:?\s*VolumeTag\s*=\s*(\S+))?")


class MediaChanger:
    def __init__(self, device: str = "", *,
                 transport: Transport | None = None):
        self._run = transport or _mtx_transport(device)

    def inventory(self) -> Inventory:
        """READ ELEMENT STATUS (reference: smc.go inventory)."""
        out = self._run(["status"])
        inv = Inventory()
        for line in out.splitlines():
            line = line.strip()
            m = _DRIVE_RE.search(line)
            if m:
                inv.drives.append(Slot(int(m.group(1)), "drive",
                                       m.group(2) == "Full",
                                       m.group(3) or ""))
                continue
            m = _SLOT_RE.search(line)
            if m:
                kind = "import_export" if "IMPORT/EXPORT" in line else "storage"
                inv.slots.append(Slot(int(m.group(1)), kind,
                                      m.group(2) == "Full",
                                      m.group(3) or ""))
        return inv

    def load(self, slot: int, drive: int = 0) -> None:
        self._run(["load", str(slot), str(drive)])

    def unload(self, slot: int, drive: int = 0) -> None:
        self._run(["unload", str(slot), str(drive)])

    def load_by_tag(self, volume_tag: str, drive: int = 0) -> None:
        inv = self.inventory()
        s = inv.find_tag(volume_tag)
        if s is None:
            raise ChangerError(f"no medium with tag {volume_tag!r}")
        if s.kind == "drive":
            if s.index == drive:
                return                   # already loaded where requested
            raise ChangerError(
                f"medium {volume_tag!r} is loaded in drive {s.index}, "
                f"not drive {drive}; unload it first")
        self.load(s.index, drive)
