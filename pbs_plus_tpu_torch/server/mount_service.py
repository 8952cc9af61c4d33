"""Snapshot mount service: expose stored snapshots as live mounts.

Reference: internal/server/web/api/mount_handlers.go:97-424 +
internal/server/systemd_mount.go:15-105 — the UI's "mount snapshot"
button starts a transient systemd unit running pxar-mount; unmount stops
it.  Here each mount is a supervised ``python -m pbs_plus_tpu_torch mount``
subprocess; ``cleanup_stale_mounts`` reaps leftovers from a crashed
server at startup (the reference's cleanupStaleMounts, bootstrap.go:68).

A copy of the JAX package's ``server/mount_service.py``, its code byte
for byte apart from its imports, which name the port's own modules, its
logger (``logging``), and its child: ``python -m pbs_plus_tpu_torch
mount``, which commits on the card by default.  The flags the service
passes are the JAX service's.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import sys
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ..mount.fusefs import is_mounted, lazy_unmount

L = logging.getLogger(__name__)


@dataclass
class ActiveMount:
    mount_id: str
    snapshot: str
    mountpoint: str
    socket: str
    proc: asyncio.subprocess.Process | None = None


class MountService:
    def __init__(self, server, *, base_dir: str | None = None):
        self.server = server
        self.base = base_dir or os.path.join(server.config.state_dir, "mounts")
        os.makedirs(self.base, exist_ok=True)
        self.mounts: dict[str, ActiveMount] = {}

    async def mount(self, snapshot: str, *, fuse: bool = True) -> ActiveMount:
        mid = uuid.uuid4().hex[:8]
        mdir = os.path.join(self.base, mid)
        mountpoint = os.path.join(mdir, "mnt")
        socket = os.path.join(mdir, "ctl.sock")
        os.makedirs(mountpoint, exist_ok=True)
        argv = [sys.executable, "-m", "pbs_plus_tpu_torch", "mount",
                "--store", self.server.config.datastore_dir,
                "--snapshot", snapshot,
                "--mount-state", os.path.join(mdir, "state"),
                "--socket", socket,
                "--chunk-avg", str(self.server.config.chunk_avg)]
        if fuse:
            argv += ["--mountpoint", mountpoint]
        env = dict(os.environ)
        # the package may be run from a checkout (no site install): make the
        # subprocess resolve it regardless of cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        proc = await asyncio.create_subprocess_exec(
            *argv, env=env,
            stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.DEVNULL)
        m = ActiveMount(mid, snapshot, mountpoint, socket, proc)
        # register BEFORE the readiness wait so unmount_all/stop can always
        # reach an in-flight mount
        self.mounts[mid] = m
        # ready = control socket present AND (if requested) the kernel
        # mount visible
        def ready() -> bool:
            if not os.path.exists(socket):
                return False
            return (not fuse) or os.path.ismount(mountpoint)
        try:
            for _ in range(150):
                if ready():
                    break
                if proc.returncode is not None:
                    raise RuntimeError(
                        f"mount process exited early ({proc.returncode})")
                await asyncio.sleep(0.1)
            else:
                raise TimeoutError("mount did not become ready")
        except BaseException:
            await self.unmount(mid)
            raise
        L.info("snapshot %s mounted as %s", snapshot, mid)
        return m

    async def unmount(self, mount_id: str) -> bool:
        """Guaranteed teardown: detach the kernel mount FIRST (while the
        FUSE daemon is still alive a fusermount -uz detaches cleanly and
        ends its fuse_main loop), then stop the subprocess, then verify
        against /proc/self/mounts — os.path.ismount cannot be trusted on
        a disconnected FUSE mount (ENOTCONN → False).  Finally the mount
        state dir is removed so the server's state tree stays removable
        (the reference's stale-mount discipline, bootstrap.go:173-196)."""
        m = self.mounts.pop(mount_id, None)
        if m is None:
            return False
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lazy_unmount, m.mountpoint)
        if m.proc is not None and m.proc.returncode is None:
            m.proc.terminate()
            try:
                await asyncio.wait_for(m.proc.wait(), 10)
            except asyncio.TimeoutError:
                m.proc.kill()
                try:
                    await asyncio.wait_for(m.proc.wait(), 5)
                except asyncio.TimeoutError:
                    pass
        # the daemon is gone now; if the mount survived (e.g. the child
        # was SIGKILLed before its own cleanup ran) detach it lazily
        ok = await loop.run_in_executor(None, lazy_unmount, m.mountpoint)
        if not ok:
            L.warning("mount %s still attached at %s after unmount "
                      "attempts", m.mount_id, m.mountpoint)
        if ok:
            shutil.rmtree(os.path.dirname(m.mountpoint), ignore_errors=True)
        return True

    async def unmount_all(self) -> None:
        for mid in list(self.mounts):
            await self.unmount(mid)

    def cleanup_stale_mounts(self) -> int:
        """Reap mounts left by a crashed server (reference:
        cleanupStaleMounts — umount -lf basepath/*)."""
        n = 0
        try:
            entries = os.listdir(self.base)
        except OSError:
            return 0
        for mid in entries:
            if mid in self.mounts:
                # a live mount owned by THIS service (cleanup may run
                # after startup, e.g. an operator re-sweep) — reaping it
                # would yank a healthy FUSE daemon's state dir
                continue
            mdir = os.path.join(self.base, mid)
            mp = os.path.join(mdir, "mnt")
            if is_mounted(mp):
                if not lazy_unmount(mp):
                    L.warning("stale mount %s could not be detached; "
                              "leaving its state dir in place", mp)
                    continue
                n += 1
            shutil.rmtree(mdir, ignore_errors=True)
        if n:
            L.warning("cleaned %d stale snapshot mounts", n)
        return n

    def list(self) -> list[dict]:
        return [{"mount_id": m.mount_id, "snapshot": m.snapshot,
                 "mountpoint": m.mountpoint,
                 "alive": m.proc is not None and m.proc.returncode is None}
                for m in self.mounts.values()]
