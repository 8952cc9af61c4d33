"""LTO drive control.

Reference: internal/tapeio/{lto,tape}.go — drive control through
go-tapedrive (rewind, seek to file mark, eject, status, density) plus
the PBS drive lock.  No tape hardware exists in this image, so the
command transport is injectable (same seam discipline as
``changer.py``): the real backend shells to ``mt`` (st driver userland)
and ``sg_read_attr``; tests inject fakes.

A copy of the JAX package's ``tapeio/lto.py``, its code byte for byte."""

from __future__ import annotations

import fcntl
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional

Transport = Callable[[list[str]], str]


class DriveError(RuntimeError):
    pass


@dataclass
class DriveStatus:
    online: bool
    file_number: int
    block_number: int
    write_protected: bool
    density: str = ""
    raw: str = ""


def _mt_transport(device: str) -> Transport:
    if shutil.which("mt") is None:
        raise DriveError("mt(1) not available")

    def run(args: list[str]) -> str:
        r = subprocess.run(["mt", "-f", device, *args],
                          capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise DriveError(f"mt {' '.join(args)}: {r.stderr.strip()}")
        return r.stdout
    return run


class TapeDrive:
    """One LTO drive (st device)."""

    def __init__(self, device: str = "/dev/nst0", *,
                 transport: Transport | None = None):
        self.device = device
        self._run = transport or _mt_transport(device)

    # -- positioning -------------------------------------------------------
    def rewind(self) -> None:
        self._run(["rewind"])

    def seek_file(self, n: int) -> None:
        """Position at the start of file mark ``n`` (absolute)."""
        self.rewind()
        if n > 0:
            self._run(["fsf", str(n)])

    def eject(self) -> None:
        self._run(["eject"])

    def erase_quick(self) -> None:
        """Quick erase: a filemark at BOT makes the media read as empty.
        Must rewind first — a weof at the current position would leave
        every earlier file intact and readable."""
        self.rewind()
        self._run(["weof", "1"])

    # -- status ------------------------------------------------------------
    def status(self) -> DriveStatus:
        out = self._run(["status"])

        def num(pat: str) -> int:
            m = re.search(pat, out)
            return int(m.group(1)) if m else -1

        return DriveStatus(
            online="ONLINE" in out or "DR_OPEN" not in out,
            file_number=num(r"[Ff]ile number\s*=\s*(-?\d+)"),
            block_number=num(r"[Bb]lock number\s*=\s*(-?\d+)"),
            write_protected="WR_PROT" in out,
            density=(re.search(r"Density code (0x[0-9a-f]+)", out) or
                     [None, ""])[1] if "Density" in out else "",
            raw=out)


class DriveLock:
    """Exclusive advisory drive lock (reference: tapelock.go — PBS's
    per-drive lock file protocol under /run)."""

    def __init__(self, drive_name: str,
                 lock_dir: str = "/run/pbs-plus-tpu/tape-locks"):
        os.makedirs(lock_dir, exist_ok=True)
        self.path = os.path.join(lock_dir, f"{drive_name}.lock")
        self._fd: Optional[int] = None

    def acquire(self, *, blocking: bool = False) -> bool:
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX |
                        (0 if blocking else fcntl.LOCK_NB))
        except OSError:
            os.close(fd)
            return False
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd
        return True

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "DriveLock":
        if not self.acquire(blocking=True):
            raise DriveError(f"could not lock {self.path}")
        return self

    def __exit__(self, *exc) -> None:
        self.release()
