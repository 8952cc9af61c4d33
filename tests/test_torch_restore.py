"""The port's restore against the JAX package's.

The backup -> restore -> verification -> backup #2 round trip of
``tests/test_e2e.py`` runs in both packages: each package's ``Server``
(the JAX one with its ``"tpu"`` chunker kind, on the CPU here, the port's
with ``device="cpu"``; both at a 64 KiB average chunk) and an agent of
the same package, bootstrapped by CSR and connected over loopback mTLS.
The restored trees are identical to each other and to the source: file
contents, kinds, modes, mtimes, symlink targets and hard-link groups
(``skip.tmp`` excluded by the job).  Also in both packages: a subpath
restore, a restore queued over the job socket's ``restore_queue`` and
run by the jobs plane, and a restore whose agent session is severed
before the agent's ``done``, which ends in error, not success.  The
verification reports and backup #2's manifest statistics are equal, and
backup #2 writes no new chunk.

The tree is kept small (about 14 KB of file data): the plain SHA-256 the
port runs on the CPU steps once per 64-byte block of a batch's longest
chunk.
"""

import asyncio
import hashlib
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.agent import lifecycle as ref_lc
from pbs_plus_tpu.agent import restore as ref_restore
from pbs_plus_tpu.agent import snapshots as ref_snaps
from pbs_plus_tpu import arpc as ref_arpc
from pbs_plus_tpu.server import database as ref_db
from pbs_plus_tpu.server import jobrpc as ref_jobrpc
from pbs_plus_tpu.server import restore_job as ref_rj
from pbs_plus_tpu.server import store as ref_store
from pbs_plus_tpu.server import verification_job as ref_vj
from pbs_plus_tpu.utils import mtls as ref_mtls
from pbs_plus_tpu_torch.agent import lifecycle as port_lc
from pbs_plus_tpu_torch.agent import restore as port_restore
from pbs_plus_tpu_torch.agent import snapshots as port_snaps
from pbs_plus_tpu_torch import arpc as port_arpc
from pbs_plus_tpu_torch.server import database as port_db
from pbs_plus_tpu_torch.server import jobrpc as port_jobrpc
from pbs_plus_tpu_torch.server import restore_job as port_rj
from pbs_plus_tpu_torch.server import store as port_store
from pbs_plus_tpu_torch.server import verification_job as port_vj
from pbs_plus_tpu_torch.utils import mtls as port_mtls

REF = SimpleNamespace(name="ref", lc=ref_lc, restore=ref_restore,
                      snaps=ref_snaps, arpc=ref_arpc, db=ref_db,
                      jobrpc=ref_jobrpc, rj=ref_rj, store=ref_store,
                      vj=ref_vj, mtls=ref_mtls, config_kw={"chunker": "tpu"},
                      server_kw={}, verify_kw={})
PORT = SimpleNamespace(name="port", lc=port_lc, restore=port_restore,
                       snaps=port_snaps, arpc=port_arpc, db=port_db,
                       jobrpc=port_jobrpc, rj=port_rj, store=port_store,
                       vj=port_vj, mtls=port_mtls, config_kw={},
                       server_kw={"device": "cpu"},
                       verify_kw={"device": "cpu"})
T0_NS = 1_700_000_000 * 10**9 + 123_456_789


def _build_tree(root):
    """``tests/test_e2e.py``'s tree at a smaller size."""
    os.makedirs(root / "docs", exist_ok=True)
    os.makedirs(root / "data" / "deep", exist_ok=True)
    rng = np.random.default_rng(1)
    (root / "docs" / "readme.txt").write_text("backup me\n" * 300)
    (root / "docs" / "empty").write_bytes(b"")
    (root / "data" / "big.bin").write_bytes(
        rng.integers(0, 256, 8000, dtype=np.uint8).tobytes())
    (root / "data" / "deep" / "inner.bin").write_bytes(
        rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
    os.chmod(root / "data" / "big.bin", 0o640)
    (root / "skip.tmp").write_text("excluded")
    os.symlink("docs/readme.txt", root / "link")
    os.link(root / "docs" / "readme.txt", root / "hard")
    os.link(root / "link", root / "link-twin", follow_symlinks=False)
    for dp, dn, fn in os.walk(root, topdown=False):
        for i, n in enumerate(sorted(fn + dn)):
            os.utime(os.path.join(dp, n), ns=(T0_NS + i, T0_NS + i),
                     follow_symlinks=False)
    os.utime(root, ns=(T0_NS, T0_NS))
    return str(root)


def _tree(root, *, exclude=()):
    """Every entry under ``root`` as lstat would show it to rsync -aH:
    kind, mode, size, mtime (directories' and symlinks' too), content
    digest, link target, and hard-link groups."""
    out, inodes = {}, {}
    for dp, dn, fn in os.walk(root):
        dn.sort()
        for n in sorted(dn + fn):
            path = os.path.join(dp, n)
            rel = os.path.relpath(path, root)
            if rel in exclude:
                continue
            st = os.lstat(path)
            if stat.S_ISLNK(st.st_mode):
                body = ("link", os.readlink(path))
            elif stat.S_ISDIR(st.st_mode):
                body = ("dir",)
            else:
                with open(path, "rb") as f:
                    body = ("file", hashlib.sha256(f.read()).hexdigest())
            out[rel] = body + (stat.S_IMODE(st.st_mode), st.st_mtime_ns,
                               st.st_size if not stat.S_ISDIR(st.st_mode)
                               else 0)
            if not stat.S_ISDIR(st.st_mode):
                inodes.setdefault(st.st_ino, []).append(rel)
    groups = sorted(sorted(g) for g in inodes.values() if len(g) > 1)
    return out, groups


# generous bounds: the plain SHA-256 is slow on a loaded CPU, and each
# wait returns as soon as its condition holds
WAIT_S = 300.0


async def _wait(pred, timeout=WAIT_S):
    for _ in range(int(timeout / 0.05)):
        if pred():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError


async def _env(pkg, base):
    server = pkg.store.Server(pkg.store.ServerConfig(
        state_dir=os.path.join(base, "state"),
        cert_dir=os.path.join(base, "certs"),
        datastore_dir=os.path.join(base, "ds"), chunk_avg=64 << 10,
        dedup_index_mb=1, max_concurrent=4, **pkg.config_kw),
        **pkg.server_kw)
    await server.start()
    server.scheduler.tick_s = 3600.0
    tid, secret = server.issue_bootstrap_token()
    key = pkg.mtls.generate_private_key()
    cert = server.bootstrap_agent("agent-e2e",
                                  pkg.mtls.make_csr(key, "agent-e2e"),
                                  tid, secret)
    paths = [os.path.join(base, "agent.pem"), os.path.join(base, "agent.key")]
    for p, data in zip(paths, (cert, pkg.mtls.key_pem(key))):
        with open(p, "wb") as f:
            f.write(data)
    agent = pkg.lc.AgentLifecycle(
        pkg.lc.AgentConfig(
            hostname="agent-e2e", server_host="127.0.0.1",
            server_port=server.config.arpc_port,
            tls=pkg.arpc.TlsClientConfig(*paths, server.certs.ca_cert_path),
            drive_update_interval_s=0),
        snapshot_manager=pkg.snaps.SnapshotManager(prefer_direct=True))
    task = asyncio.ensure_future(agent.run())
    await server.agents.wait_session("agent-e2e", timeout=WAIT_S)
    return server, agent, task


async def _restore(pkg, server, agent, rid, snap, dest, subpath=""):
    server.db.create_restore(rid, "agent-e2e", snap, dest, subpath)
    await pkg.rj.run_restore_job(server, rid, target="agent-e2e",
                                 snapshot=snap, destination=dest,
                                 subpath=subpath)
    await _wait(lambda: not agent.jobs)      # the agent's task wrote it all
    return server.db.get_restore(rid)["status"]


async def _severed(pkg, server, snap, dest):
    """A restore whose agent session is cut before the agent's ``done``:
    the agent's engine waits, so only the cut can end it.  The cut lands
    once the server watches the session for its end (past its
    ``wait_session``), so it cannot race the session's pickup."""
    hold = asyncio.Event()
    orig = pkg.restore.RestoreEngine.run

    async def held(self):
        await hold.wait()
        return await orig(self)

    async def killer():
        while True:
            for s in server.agents.sessions():
                if s.client_id.endswith("|restore") and \
                        id(s) in server.agents._disc_watchers:
                    s.conn.writer.transport.abort()
                    return
            await asyncio.sleep(0.01)

    server.db.create_restore("rx", "agent-e2e", snap, dest)
    pkg.restore.RestoreEngine.run = held
    kt = asyncio.ensure_future(killer())
    try:
        with pytest.raises(RuntimeError, match="lost before completion"):
            await pkg.rj.run_restore_job(server, "rx", target="agent-e2e",
                                         snapshot=snap, destination=dest)
    finally:
        pkg.restore.RestoreEngine.run = orig
        hold.set()
    await kt
    row = server.db.get_restore("rx")
    return row["status"], row["error"].split("(")[0]


def _round_trip(pkg, base, src):
    async def main():
        server, agent, task = await _env(pkg, base)
        out = {}
        try:
            server.db.upsert_backup_job(pkg.db.BackupJobRow(
                id="job1", target="agent-e2e", source_path=src,
                backup_id="e2e", exclusions=["*.tmp"], chunker=""))
            assert server.enqueue_backup("job1")
            await server.jobs.wait("backup:job1", timeout=WAIT_S)
            row = server.db.get_backup_job("job1")
            assert row.last_status == pkg.db.STATUS_SUCCESS, row.last_error
            snap = row.last_snapshot
            out["task"] = [(t["kind"], t["status"]) for t in
                           server.db.list_tasks(job_id="job1")]
            out["full"] = await _restore(pkg, server, agent, "r-full", snap,
                                         os.path.join(base, "full"))
            out["sub"] = await _restore(pkg, server, agent, "r-sub", snap,
                                        os.path.join(base, "sub"), "data")
            # over the job socket: queued, run by the jobs plane
            sock = os.path.join(server.config.state_dir, "job.sock")
            resp = await pkg.jobrpc.call_job_rpc(sock, {
                "op": "restore_queue", "target": "agent-e2e",
                "snapshot": snap, "destination": os.path.join(base, "sock"),
                "subpath": ""})
            assert resp["ok"], resp
            rid = resp["restore_id"]
            await server.jobs.wait(rid, timeout=WAIT_S)
            await _wait(lambda: not agent.jobs)
            out["sock"] = server.db.get_restore(rid)["status"]
            out["sock_task"] = [(t["kind"], t["status"], t["log"]) for t in
                                server.db.list_tasks(job_id=rid)]
            rep = await pkg.vj.run_verification(
                server, {"id": "v1", "sample_rate": 1.0}, **pkg.verify_kw)
            out["verify"] = {k: rep[k] for k in ("checked", "corrupt",
                                                 "drift")}
            out["verify_snaps"] = len(rep["snapshots"])
            # backup #2: chunk-level dedup against snapshot 1
            assert server.enqueue_backup("job1")
            await server.jobs.wait("backup:job1", timeout=WAIT_S)
            row2 = server.db.get_backup_job("job1")
            assert row2.last_status == pkg.db.STATUS_SUCCESS
            ds = server.datastore.datastore
            man2 = ds.load_manifest(
                next(r for r in ds.list_snapshots()
                     if str(r) == row2.last_snapshot))
            out["previous_is_first"] = man2["previous"] == snap
            out["stats2"] = man2["stats"]
            out["severed"] = await _severed(pkg, server, snap,
                                            os.path.join(base, "cut"))
        finally:
            await agent.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await server.stop()
        return out
    return asyncio.run(main())


@pytest.fixture(scope="module")
def trips(tmp_path_factory):
    root = tmp_path_factory.mktemp("restore")
    src = _build_tree(root / "src")
    out = {"src": src}
    for pkg in (REF, PORT):
        base = str(root / pkg.name)
        os.makedirs(base)
        out[pkg.name] = SimpleNamespace(base=base,
                                        **_round_trip(pkg, base, src))
    return out


def test_restored_trees_equal_each_other_and_the_source(trips):
    want = _tree(trips["src"], exclude=("skip.tmp",))
    r, p = trips["ref"], trips["port"]
    assert p.full == r.full == "success"
    got_r = _tree(os.path.join(r.base, "full"))
    got_p = _tree(os.path.join(p.base, "full"))
    assert got_p == got_r
    # the source's own mtime moves with nothing; the restored root's is
    # the snapshot root's
    assert got_p == want
    assert ["hard", "docs/readme.txt"] not in got_p[1]
    assert ["docs/readme.txt", "hard"] in got_p[1]
    assert ["link", "link-twin"] in got_p[1]


def test_subpath_restore_matches_reference(trips):
    r, p = trips["ref"], trips["port"]
    assert p.sub == r.sub == "success"
    got_p = _tree(os.path.join(p.base, "sub"))
    assert got_p == _tree(os.path.join(r.base, "sub"))
    want = _tree(os.path.join(trips["src"], "data"))
    assert got_p[0] == want[0] and sorted(got_p[0]) == [
        "big.bin", "deep", "deep/inner.bin"]


def test_restore_over_the_job_socket_matches_reference(trips):
    r, p = trips["ref"], trips["port"]
    assert p.sock == r.sock == "success"
    assert p.sock_task == r.sock_task == [
        ("restore", "success", "restore served to agent\n")]
    got = _tree(os.path.join(p.base, "sock"))
    assert got == _tree(os.path.join(r.base, "sock"))
    assert got == _tree(trips["src"], exclude=("skip.tmp",))


def test_verification_and_backup_two_match_reference(trips):
    r, p = trips["ref"], trips["port"]
    assert p.task == r.task == [("backup", "success")]
    assert p.verify == r.verify
    assert p.verify["checked"] > 0 and p.verify["corrupt"] == []
    assert p.verify_snaps == r.verify_snaps == 1
    assert p.previous_is_first and r.previous_is_first
    assert p.stats2 == r.stats2
    assert p.stats2["new_chunks"] == 0


def test_severed_restore_session_ends_in_error(trips):
    r, p = trips["ref"], trips["port"]
    assert p.severed == r.severed == (
        "error", "agent restore session lost before completion ")
    assert not os.path.exists(os.path.join(p.base, "cut", "docs"))
