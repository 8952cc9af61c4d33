"""Filesystem snapshot manager.

Reference: internal/agent/snapshots — SnapshotHandler interface + per-FS
handlers (btrfs/zfs/lvm/ext4-xfs-freeze/VSS), /proc/mounts detection, and
the Direct fallback (snapshot.go:8-26, manager.go:11-38, detect.go:14-65).

Windows VSS has no analog in this Linux build; the handler table mirrors
the reference's unix set with availability gates (tool presence checked at
runtime) and Direct as the universal fallback.

A copy of the JAX package's ``agent/snapshots.py``, its code byte for
byte apart from its logger (``logging``); on Windows a manager built
without ``handlers=`` takes the port's ``agent/win/vss.py`` handler.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
import time
import uuid
from dataclasses import dataclass

L = logging.getLogger(__name__)



@dataclass
class Snapshot:
    source_path: str          # what the job asked to back up
    snapshot_path: str        # where to actually read (may == source)
    method: str               # direct | btrfs | lvm | zfs | freeze
    handle: str = ""          # handler-specific cleanup token


def detect_fs(path: str,
              mounts_path: str = "/proc/mounts") -> tuple[str, str, str]:
    """(fstype, mountpoint, device) owning ``path`` — longest-prefix
    match over /proc/mounts (reference: detect.go:14-65)."""
    best = ("", "/", "")
    try:
        with open(mounts_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                dev, mnt, fstype = parts[0], parts[1], parts[2]
                mnt = mnt.replace("\\040", " ")
                if path.startswith(mnt.rstrip("/") + "/") or path == mnt:
                    if len(mnt) >= len(best[1]):
                        best = (fstype, mnt, dev)
    except OSError:
        pass
    return best


class DirectHandler:
    """No snapshot: read the live tree (reference: Direct fallback)."""

    name = "direct"

    def available(self, fstype: str) -> bool:
        return True

    def create(self, path: str) -> Snapshot:
        return Snapshot(path, path, self.name)

    def cleanup(self, snap: Snapshot) -> None:
        pass


class BtrfsHandler:
    """Read-only btrfs subvolume snapshot."""

    name = "btrfs"

    def available(self, fstype: str) -> bool:
        return fstype == "btrfs" and shutil.which("btrfs") is not None

    def create(self, path: str) -> Snapshot:
        snap_dir = os.path.join(path, f".pbs-plus-snap-{uuid.uuid4().hex[:8]}")
        subprocess.run(["btrfs", "subvolume", "snapshot", "-r", path, snap_dir],
                       check=True, capture_output=True, timeout=60)
        return Snapshot(path, snap_dir, self.name, handle=snap_dir)

    def cleanup(self, snap: Snapshot) -> None:
        if snap.handle:
            subprocess.run(["btrfs", "subvolume", "delete", snap.handle],
                           capture_output=True, timeout=60)


class ZfsHandler:
    name = "zfs"

    def available(self, fstype: str) -> bool:
        return fstype == "zfs" and shutil.which("zfs") is not None

    def create(self, path: str) -> Snapshot:
        fstype, mnt, _dev = detect_fs(path)
        dataset = subprocess.run(
            ["zfs", "list", "-H", "-o", "name", mnt],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.strip()
        tag = f"pbs-plus-{int(time.time())}"
        subprocess.run(["zfs", "snapshot", f"{dataset}@{tag}"],
                       check=True, capture_output=True, timeout=60)
        rel = os.path.relpath(path, mnt)
        snap_path = os.path.join(mnt, ".zfs", "snapshot", tag, rel)
        return Snapshot(path, snap_path, self.name, handle=f"{dataset}@{tag}")

    def cleanup(self, snap: Snapshot) -> None:
        if snap.handle:
            subprocess.run(["zfs", "destroy", snap.handle],
                           capture_output=True, timeout=60)


class LvmHandler:
    """Copy-on-write LVM snapshot: ``lvcreate -s`` against the logical
    volume backing the source, mounted read-only at a temp dir
    (reference: internal/agent/snapshots/lvm.go).  The subprocess seam
    (``run``/``which``) is injectable so the command protocol is
    testable without a volume group."""

    name = "lvm"
    SNAP_EXTENT = "10%ORIGIN"       # CoW reserve for the snapshot LV

    def __init__(self, *, run=subprocess.run, which=shutil.which,
                 mounts_path: str = "/proc/mounts"):
        self._run = run
        self._which = which
        self._mounts = mounts_path

    def available(self, fstype: str) -> bool:
        return fstype in ("ext2", "ext3", "ext4", "xfs") and \
            self._which("lvcreate") is not None and \
            self._which("lvs") is not None

    def _lv_of(self, dev: str) -> tuple[str, str]:
        """(vg, lv) backing ``dev``; raises if it is not an LV."""
        r = self._run(["lvs", "--noheadings", "-o", "vg_name,lv_name", dev],
                      check=True, capture_output=True, text=True, timeout=30)
        parts = r.stdout.split()
        if len(parts) != 2:
            raise RuntimeError(f"{dev} is not a logical volume")
        return parts[0], parts[1]

    def create(self, path: str) -> Snapshot:
        fstype, mnt, dev = detect_fs(path, self._mounts)
        vg, lv = self._lv_of(dev)
        tag = f"pbs-plus-snap-{uuid.uuid4().hex[:8]}"
        self._run(["lvcreate", "-s", "-n", tag, "-l", self.SNAP_EXTENT,
                   f"{vg}/{lv}"],
                  check=True, capture_output=True, timeout=60)
        mount_dir = tempfile.mkdtemp(prefix="pbs-plus-lvm-")
        opts = "ro,nouuid" if fstype == "xfs" else "ro"
        try:
            self._run(["mount", "-o", opts, f"/dev/{vg}/{tag}", mount_dir],
                      check=True, capture_output=True, timeout=60)
        except BaseException:
            # rollback must never mask the mount failure
            try:
                self._run(["lvremove", "-f", f"{vg}/{tag}"],
                          capture_output=True, timeout=60)
            except Exception:
                L.warning("rollback lvremove of %s/%s failed; snapshot LV "
                          "may linger", vg, tag)
            try:
                os.rmdir(mount_dir)
            except OSError:
                pass
            raise
        rel = os.path.relpath(path, mnt)
        snap_path = mount_dir if rel == "." else os.path.join(mount_dir, rel)
        return Snapshot(path, snap_path, self.name,
                        handle=f"{vg}/{tag}|{mount_dir}")

    def cleanup(self, snap: Snapshot) -> None:
        """Teardown with diagnostics: a swallowed umount/lvremove failure
        would silently leak a CoW LV per backup until the VG runs out of
        extents — surface every failed step (leak discipline)."""
        if not snap.handle:
            return
        lv_ref, mount_dir = snap.handle.split("|", 1)
        r = self._run(["umount", mount_dir], capture_output=True, timeout=60)
        if getattr(r, "returncode", 1) != 0:
            self._run(["umount", "-l", mount_dir],
                      capture_output=True, timeout=60)
            L.warning("lvm snapshot umount of %s failed (rc=%s); lazy "
                      "unmount attempted", mount_dir,
                      getattr(r, "returncode", "?"))
        r = self._run(["lvremove", "-f", lv_ref],
                      capture_output=True, timeout=60)
        if getattr(r, "returncode", 1) != 0:
            L.warning("lvremove %s failed (rc=%s); snapshot LV leaked — "
                      "remove manually", lv_ref,
                      getattr(r, "returncode", "?"))
        try:
            os.rmdir(mount_dir)
        except OSError:
            pass


class FreezeHandler:
    """ext4/xfs quiesce via fsfreeze: freeze forces a consistent on-disk
    state (journal flushed), then thaw immediately and read the live
    tree (reference: the fsfreeze-style ext4/xfs handler,
    internal/agent/snapshots/detect.go:14-65).  Weaker than a CoW
    snapshot — concurrent writes after the thaw are visible — but it
    guarantees the backup starts from a clean journal without needing
    free VG extents."""

    name = "freeze"

    def __init__(self, *, run=subprocess.run, which=shutil.which,
                 mounts_path: str = "/proc/mounts"):
        self._run = run
        self._which = which
        self._mounts = mounts_path

    def available(self, fstype: str) -> bool:
        return fstype in ("ext3", "ext4", "xfs") and \
            self._which("fsfreeze") is not None

    def create(self, path: str) -> Snapshot:
        _fstype, mnt, _dev = detect_fs(path, self._mounts)
        if mnt == "/":
            raise RuntimeError("refusing to freeze the root filesystem")
        try:
            self._run(["fsfreeze", "--freeze", mnt],
                      check=True, capture_output=True, timeout=30)
        except BaseException:
            # the freeze may have latched before the error (e.g. a
            # timeout after the kernel froze) — best-effort thaw, but the
            # original failure propagates
            try:
                self._run(["fsfreeze", "--unfreeze", mnt],
                          capture_output=True, timeout=30)
            except Exception as e:
                L.error("best-effort unfreeze of %s after failed freeze "
                        "also failed (fs may be wedged frozen): %s", mnt, e)
            raise
        # frozen: journal + caches quiesced on disk — thaw immediately.
        # A fs left frozen wedges every writer, so a failed thaw is a
        # hard error, never a silent success
        for attempt in (0, 1):
            try:
                self._run(["fsfreeze", "--unfreeze", mnt],
                          check=True, capture_output=True, timeout=30)
                break
            except Exception:
                if attempt:
                    raise RuntimeError(
                        f"could not thaw {mnt}; FILESYSTEM MAY BE FROZEN "
                        f"— run 'fsfreeze --unfreeze {mnt}' manually")
        return Snapshot(path, path, self.name)

    def cleanup(self, snap: Snapshot) -> None:
        pass


class SnapshotManager:
    """Pick the best available handler for a path (reference:
    snapshots.Manager.CreateSnapshot, manager.go:26-38).  Handler order:
    CoW snapshots (btrfs, zfs, lvm) > journal quiesce (freeze) > direct;
    a failing handler falls through to the next."""

    def __init__(self, *, prefer_direct: bool = False,
                 handlers: list | None = None,
                 mounts_path: str = "/proc/mounts"):
        if handlers is not None:
            self.handlers = handlers
        elif os.name == "nt":
            from .win.vss import VssHandler
            self.handlers = [VssHandler()]
        else:
            self.handlers = [
                BtrfsHandler(), ZfsHandler(),
                LvmHandler(mounts_path=mounts_path),
                FreezeHandler(mounts_path=mounts_path)]
        self.direct = DirectHandler()
        self.prefer_direct = prefer_direct
        self._mounts = mounts_path

    def create(self, path: str) -> Snapshot:
        path = os.path.abspath(path)
        if not self.prefer_direct:
            fstype, _, _ = detect_fs(path, self._mounts)
            for h in self.handlers:
                if h.available(fstype):
                    try:
                        snap = h.create(path)
                        L.info("snapshot created via %s", h.name)
                        return snap
                    except Exception as e:
                        L.warning("snapshot via %s failed (%s); falling back",
                                  h.name, e)
        return self.direct.create(path)

    def cleanup(self, snap: Snapshot) -> None:
        for h in [*self.handlers, self.direct]:
            if h.name == snap.method:
                try:
                    h.cleanup(snap)
                except Exception:
                    L.exception("snapshot cleanup failed")
                return
