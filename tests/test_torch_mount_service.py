"""The port's mount service, its ``mount``/``commit`` commands and its
kernel FUSE frontend, against the JAX package's.

- ``MountService`` spawns ``python -m pbs_plus_tpu_torch mount`` with the
  JAX service's flags, and reaps stale mounts as the JAX service does in
  the four cleanup cases of tests/test_mount_service.py (both services
  run each case).
- A ``python -m pbs_plus_tpu_torch mount --device cpu`` child serves a
  snapshot of a port ``LocalStore``; ``commit --socket`` commits it, and
  the new snapshot reads back through the JAX package's ``SplitReader``.
- The port's ``FuseMount`` over libfuse: reads, writes, a rename and a
  commit through the kernel, skipped where /dev/fuse is unavailable (as
  tests/test_fuse.py is).

Tolerance is exact.
"""

import asyncio
import os
import subprocess
import sys
import time
import types
import uuid

import numpy as np
import pytest

from pbs_plus_tpu.pxar import transfer as ref_tr
from pbs_plus_tpu.server import mount_service as ref_ms
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.mount import (ArchiveView, CommitEngine, Journal,
                                      MutableFS)
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.pxar.walker import backup_tree
from pbs_plus_tpu_torch.server import mount_service as port_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = ChunkerParams(avg_size=4096, min_size=1024, max_size=4096)
SERVICES = [ref_ms, port_ms]
SERVICE_IDS = ["ref", "port"]


def _svc(ms, tmp_path):
    server = types.SimpleNamespace(config=types.SimpleNamespace(
        state_dir=str(tmp_path / "state"),
        datastore_dir=str(tmp_path / "ds"),
        chunk_avg=4096))
    return ms.MountService(server, base_dir=str(tmp_path / "mounts"))


def _leftover(svc, mid: str) -> str:
    mdir = os.path.join(svc.base, mid)
    os.makedirs(os.path.join(mdir, "mnt"))
    with open(os.path.join(mdir, "ctl.sock"), "w"):
        pass
    return mdir


def _argv_of(ms, tmp_path, monkeypatch):
    """The child's argv and environment when ``ms``'s service mounts a
    snapshot, with the child faked to exit at once."""
    seen = {}

    class _Proc:
        returncode = 3

        def terminate(self):
            pass

        async def wait(self):
            return 3

    async def spawn(*argv, env=None, **kw):
        seen["argv"], seen["env"] = list(argv), env
        return _Proc()

    monkeypatch.setattr(ms.asyncio, "create_subprocess_exec", spawn)
    monkeypatch.setattr(ms, "uuid", types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=0xABCDEF)))
    svc = _svc(ms, tmp_path)
    with pytest.raises(RuntimeError, match="exited early"):
        asyncio.run(svc.mount("host/m/2026-01-01T00:00:00Z"))
    assert svc.mounts == {}
    return seen


def test_child_argv_names_the_port(tmp_path, monkeypatch):
    ref = _argv_of(ref_ms, tmp_path / "ref", monkeypatch)["argv"]
    port_seen = _argv_of(port_ms, tmp_path / "port", monkeypatch)
    port = port_seen["argv"]
    assert port[1:4] == ["-m", "pbs_plus_tpu_torch", "mount"]
    assert ref[1:4] == ["-m", "pbs_plus_tpu", "mount"]
    # every other flag is the JAX service's (paths under each tmp dir)
    norm = lambda a, d: [x.replace(str(tmp_path / d), "T") for x in a]
    assert norm(port[4:], "port") == norm(ref[4:], "ref")
    assert "--device" not in port and "--datastore-format" not in port
    assert port_seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO


@pytest.mark.parametrize("ms", SERVICES, ids=SERVICE_IDS)
def test_cleanup_reaps_unmounted_leftover_dir(tmp_path, ms):
    svc = _svc(ms, tmp_path)
    mdir = _leftover(svc, "deadbee1")
    assert svc.cleanup_stale_mounts() == 0
    assert not os.path.exists(mdir)


@pytest.mark.parametrize("ms", SERVICES, ids=SERVICE_IDS)
def test_cleanup_detaches_stale_kernel_mount(tmp_path, monkeypatch, ms):
    svc = _svc(ms, tmp_path)
    mdir = _leftover(svc, "deadbee2")
    mp = os.path.join(mdir, "mnt")
    detached = []
    monkeypatch.setattr(ms, "is_mounted", lambda p: p == mp)
    monkeypatch.setattr(ms, "lazy_unmount",
                        lambda p: detached.append(p) or True)
    assert svc.cleanup_stale_mounts() == 1
    assert detached == [mp]
    assert not os.path.exists(mdir)


@pytest.mark.parametrize("ms", SERVICES, ids=SERVICE_IDS)
def test_cleanup_leaves_undetachable_mount_state(tmp_path, monkeypatch, ms):
    svc = _svc(ms, tmp_path)
    mdir = _leftover(svc, "deadbee3")
    monkeypatch.setattr(ms, "is_mounted", lambda p: True)
    monkeypatch.setattr(ms, "lazy_unmount", lambda p: False)
    assert svc.cleanup_stale_mounts() == 0
    assert os.path.exists(mdir)


@pytest.mark.parametrize("ms", SERVICES, ids=SERVICE_IDS)
def test_cleanup_skips_live_mounts_of_this_service(tmp_path, monkeypatch, ms):
    svc = _svc(ms, tmp_path)
    live_dir = _leftover(svc, "a11ce001")
    stale_dir = _leftover(svc, "deadbee4")
    mp = os.path.join(live_dir, "mnt")
    svc.mounts["a11ce001"] = ms.ActiveMount(
        "a11ce001", "vm/100/2026-01-01T00:00:00Z", mp,
        os.path.join(live_dir, "ctl.sock"))
    probed = []
    monkeypatch.setattr(ms, "is_mounted",
                        lambda p: probed.append(p) or False)
    assert svc.cleanup_stale_mounts() == 0
    assert os.path.exists(live_dir)
    assert not os.path.exists(stale_dir)
    assert mp not in probed


def _blob(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def _snapshot(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("alpha content")
    (src / "sub" / "b.bin").write_bytes(_blob(20_000, 1))
    store = LocalStore(str(tmp_path / "ds"), P, dedup_index_mb=1,
                       device="cpu")
    s = store.start_session(backup_type="host", backup_id="fm")
    backup_tree(s, str(src))
    s.finish()
    return store, s.ref, src


def _wait_for(path, proc, seconds=60):
    deadline = time.time() + seconds
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"mount exited rc={proc.returncode}:\n"
                                 f"{proc.stdout.read()}")
        if time.time() > deadline:
            raise AssertionError("mount never became ready")
        time.sleep(0.1)


def test_mount_child_committed_through_the_socket(tmp_path):
    """``python -m pbs_plus_tpu_torch mount --device cpu`` serves the
    snapshot; ``commit --socket`` publishes the next one, which holds the
    same files (by reference) and reads in the JAX package."""
    store, ref, src = _snapshot(tmp_path)
    sock = str(tmp_path / "ctl.sock")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pbs_plus_tpu_torch", "mount",
         "--store", str(tmp_path / "ds"), "--snapshot", str(ref),
         "--mount-state", str(tmp_path / "state"), "--socket", sock,
         "--chunk-avg", "4096", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_for(sock, proc)
        r = subprocess.run(
            [sys.executable, "-m", "pbs_plus_tpu_torch", "commit",
             "--socket", sock], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        new = r.stdout.strip().splitlines()[-1]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0
    snaps = store.datastore.list_snapshots("host", "fm")
    assert [str(x) for x in snaps][-1] == new and len(snaps) == 2
    man = store.datastore.load_manifest(snaps[-1])
    assert man["commit"] is True and man["previous"] == str(ref)
    assert man["stats"]["ref_chunks"] > 0
    reader = ref_tr.SplitReader.open_snapshot(store.datastore, snaps[-1])
    by = {e.path: e for e in reader.entries()}
    assert reader.read_file(by["sub/b.bin"]) == _blob(20_000, 1)
    assert reader.read_file(by["a.txt"]) == b"alpha content"


def _fuse_available() -> bool:
    try:
        return os.path.exists("/dev/fuse") and os.access("/dev/fuse", os.R_OK | os.W_OK)
    except OSError:
        return False


@pytest.mark.skipif(not _fuse_available(), reason="/dev/fuse unavailable")
def test_fuse_mount_round_trip_and_commit(tmp_path):
    """The port's ``FuseMount`` serves the port's ``MutableFS`` through
    the kernel; the mutations made there commit through the port's
    engine and the mount keeps serving after the hot swap."""
    from pbs_plus_tpu_torch.mount.fusefs import FuseMount, is_mounted

    store, ref, src = _snapshot(tmp_path)
    fs = MutableFS(ArchiveView(store.open_snapshot(ref)),
                   Journal(str(tmp_path / "j" / "j.db")),
                   str(tmp_path / "pass"))
    engine = CommitEngine(fs, store, backup_id="fm", previous=ref,
                          device="cpu")
    mp = str(tmp_path / "mnt")
    m = FuseMount(fs, mp)
    m.mount()
    try:
        assert is_mounted(mp)
        assert sorted(os.listdir(mp)) == ["a.txt", "sub"]
        assert open(f"{mp}/sub/b.bin", "rb").read() == _blob(20_000, 1)
        with open(f"{mp}/new.txt", "w") as f:
            f.write("kernel write")
        os.mkdir(f"{mp}/d")
        os.rename(f"{mp}/a.txt", f"{mp}/d/a.txt")
        assert sorted(os.listdir(mp)) == ["d", "new.txt", "sub"]
        assert fs.read("d/a.txt") == b"alpha content"
        assert os.stat(f"{mp}/sub/b.bin").st_size == 20_000
        new = engine.commit()
        assert open(f"{mp}/new.txt").read() == "kernel write"
        assert fs.view.generation == 1
    finally:
        m.unmount()
    assert not is_mounted(mp)
    r = store.open_snapshot(new)
    by = {e.path: e for e in r.entries()}
    assert r.read_file(by["new.txt"]) == b"kernel write"
    assert r.read_file(by["d/a.txt"]) == b"alpha content"
    assert "a.txt" not in by and engine.progress.ref_files >= 1


def test_pbs_format_server_child_commits_native_layout_as_reference(tmp_path):
    """The service passes no ``--datastore-format``, so on a server whose
    datastore is in the stock-PBS layout its child opens the store in the
    native layout: it mounts the PBS-layout snapshot, and its commit
    lands in the native layout (``root.midx``/``root.pidx`` and
    ``manifest.json``, no ``index.json.blob``).  The JAX package's child
    does the same; a fault of the reference, kept by the port."""
    import io

    from pbs_plus_tpu import mount as ref_mount
    from pbs_plus_tpu.chunker import ChunkerParams as RefParams
    from pbs_plus_tpu.pxar import backupproxy as ref_bp
    from pbs_plus_tpu_torch import mount as port_mount
    from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry

    got = {}
    for name, bp, mnt, params, kw in (
            ("ref", ref_bp, ref_mount, RefParams(4096, 1024, 4096), {}),
            ("port", port_bp, port_mount, P, {"device": "cpu"})):
        base = str(tmp_path / name / "ds")
        server = bp.LocalStore(base, params, pbs_format=True,
                               dedup_index_mb=1, **kw)
        s = server.start_session(backup_type="host", backup_id="m",
                                 backup_time=1_700_000_000)
        s.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
        s.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE, size=5),
                                    io.BytesIO(b"hello"))
        s.finish()
        child = bp.LocalStore(base, params, dedup_index_mb=1, **kw)
        fs = mnt.MutableFS(mnt.ArchiveView(child.open_snapshot(s.ref)),
                           mnt.Journal(str(tmp_path / name / "j.db")),
                           str(tmp_path / name / "pass"))
        fs.write("f", b"HELLO", 0)
        ref = mnt.CommitEngine(fs, child, backup_id="m", previous=s.ref,
                               **kw).commit()
        rd = server.open_snapshot(ref)
        got[name] = (sorted(os.listdir(server.datastore.snapshot_dir(s.ref))),
                     sorted(os.listdir(server.datastore.snapshot_dir(ref))),
                     rd.read_file(rd.lookup("f")))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["index.json.blob", "manifest.json",
                              "root.mpxar.didx", "root.ppxar.didx"]
    assert got["port"][1] == ["manifest.json", "root.midx", "root.pidx"]
    assert got["port"][2] == b"HELLO"
