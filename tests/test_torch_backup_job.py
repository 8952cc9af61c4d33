"""The port's agent backup job against the JAX package's.

The same directory tree, made from a numpy seed, is backed up by two
whole jobs over mTLS loopback (certificates from the JAX package's
``utils/mtls.py``): the JAX job (``run_target_backup`` with the JAX
``AgentLifecycle``, ``AgentsManager``, ``serve``, ``Database`` and
``LocalStore``) and the port's (the same classes from the port, with
``LocalStore(device="cpu")``: the plain K1 behind ``CudaChunker``, the
plain SHA-256 behind the ``"cuda"`` batch hasher, the port's
``DedupIndex`` on the CPU).  Chunk and index files must match byte for
byte in both layouts at 0 and 2 pipeline workers, manifests apart from
their creation second and the chunker backend's label, and the
``BackupResult``s field for field.  The two mixed wirings (the port's job
against a JAX agent, the JAX job against a port agent), exclusions and
the errors of unreadable entries, a job severed by
``backup.file.stream=drop@nth`` and resumed from its checkpoint (also
across packages), a local target, an S3 target, an offline agent and the
startup re-enqueue policy are held the same way.  Tolerance is exact.

The snapshot name's ``time.time()``, the index header's ``os.urandom(16)``
uuid and ``time.time_ns`` are pinned for both packages.  Trees chunk at
``ChunkerParams(1024, 64, 1024)`` and files stay at a few KiB: the plain
SHA-256 steps once per 64-byte block of a batch's longest chunk.

Where a job checkpoints, the JAX store runs its ``"tpu"`` chunker kind
(``TpuChunker`` through its feeder, on the CPU here), the one the port's
``CudaChunker`` replaces: a checkpoint falls due by the count of
committed payload records, so it depends on when a chunker emits its
cuts, not only where, and the JAX CPU chunker holds small feeds back
until a scan block fills, where ``TpuChunker`` and ``CudaChunker`` scan
each feed at once.  Without checkpoints the cuts, and so every file, are
the same on either JAX chunker.
"""

import asyncio
import functools
import os
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu import arpc as ref_arpc
from pbs_plus_tpu.agent import lifecycle as ref_lc
from pbs_plus_tpu.agent import snapshots as ref_snaps
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.server import backup_job as ref_bj
from pbs_plus_tpu.server import checkpoint as ref_ck
from pbs_plus_tpu.server import database as ref_db
from pbs_plus_tpu.utils import failpoints as ref_fp
from pbs_plus_tpu.utils import mtls as ref_mtls
from pbs_plus_tpu_torch import arpc as port_arpc
from pbs_plus_tpu_torch.agent import lifecycle as port_lc
from pbs_plus_tpu_torch.agent import snapshots as port_snaps
from pbs_plus_tpu_torch.chunker import ChunkerParams
from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
from pbs_plus_tpu_torch.server import backup_job as port_bj
from pbs_plus_tpu_torch.server import checkpoint as port_ck
from pbs_plus_tpu_torch.server import database as port_db
from pbs_plus_tpu_torch.utils import failpoints as port_fp

REF = SimpleNamespace(name="ref", arpc=ref_arpc, lc=ref_lc, snaps=ref_snaps,
                      bp=ref_bp, bj=ref_bj, ck=ref_ck, db=ref_db, fp=ref_fp,
                      Params=RefParams, store_kw={}, backend="cpu",
                      tpu_kw=lambda: {"chunker_factory":
                                      ref_bj.make_chunker_factory("tpu")},
                      tpu_backend="tpu")
PORT = SimpleNamespace(name="port", arpc=port_arpc, lc=port_lc,
                       snaps=port_snaps, bp=port_bp, bj=port_bj, ck=port_ck,
                       db=port_db, fp=port_fp, Params=ChunkerParams,
                       store_kw={"device": "cpu"}, backend="cuda",
                       tpu_kw=dict, tpu_backend="cuda")
PARAMS = dict(avg_size=1024, min_size=64, max_size=1024)
T0 = 1_700_000_000
HOSTS = ("h0", "h1")


@pytest.fixture(autouse=True)
def _disarmed():
    for pkg in (REF, PORT):
        pkg.fp.disarm_all()
    yield
    for pkg in (REF, PORT):
        pkg.fp.disarm_all()


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, the server's identity and one agent certificate a host, from
    the JAX package's ``CertManager``."""
    d = tmp_path_factory.mktemp("pki")
    cm = ref_mtls.CertManager(str(d))
    cm.load_or_create_ca()
    cm.ensure_server_identity("pbs-server")
    agents = {}
    for h in HOSTS:
        cert, key = cm.issue(h)
        (d / f"{h}.pem").write_bytes(cert)
        (d / f"{h}.key").write_bytes(key)
        agents[h] = (str(d / f"{h}.pem"), str(d / f"{h}.key"))
    return SimpleNamespace(server=(cm.server_cert_path, cm.server_key_path),
                           ca=cm.ca_cert_path, agents=agents)


class _Clock:
    """``time`` for the stores' modules: ``time()`` pinned (snapshots of
    one second bump by +1 s, as the reference does), the rest real."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(T0)


@contextmanager
def pinned():
    """Index headers' uuid and time and snapshot times pinned for both
    packages."""
    with pytest.MonkeyPatch.context() as mp:
        real = os.urandom
        mp.setattr(os, "urandom",
                   lambda n: b"\x5a" * n if n == 16 else real(n))
        mp.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)
        for bp in (ref_bp, port_bp):
            mp.setattr(bp, "time", _Clock())
        yield mp


def make_tree(root, seed: int, *, files: int = 8, extras: bool = False):
    """A source tree: files of a few KiB in two directories, a symlink, a
    hard link and files the exclusions drop; with ``extras`` also an
    xattr, a fifo and a file the agent cannot open."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "etc"))
    os.makedirs(os.path.join(root, "var", "log"))
    os.makedirs(os.path.join(root, "cache"))
    for i in range(files):
        d = "etc" if i % 2 else os.path.join("var", "log")
        n = int(rng.integers(300, 6000))
        with open(os.path.join(root, d, f"f{i:02d}"), "wb") as f:
            f.write(rng.integers(0, 256, n, np.uint8).tobytes())
    with open(os.path.join(root, "skip.tmp"), "wb") as f:
        f.write(b"excluded by the row")
    with open(os.path.join(root, "cache", "blob"), "wb") as f:
        f.write(b"excluded by the database")
    with open(os.path.join(root, "etc", "old.bak"), "wb") as f:
        f.write(b"excluded globally")
    os.symlink("etc/f01", os.path.join(root, "link"))
    os.link(os.path.join(root, "etc", "f01"), os.path.join(root, "hard"))
    if extras:
        os.setxattr(os.path.join(root, "etc", "f03"), "user.tag", b"blue")
        os.mkfifo(os.path.join(root, "pipe"))
        with open(os.path.join(root, "var", "secret"), "wb") as f:
            f.write(b"no access")
        os.chmod(os.path.join(root, "var", "secret"), 0)
    for dp, dn, fn in os.walk(root, topdown=False):
        for n in fn + dn:
            os.utime(os.path.join(dp, n), ns=(T0 * 10**9, T0 * 10**9),
                     follow_symlinks=False)
    os.utime(root, ns=(T0 * 10**9, T0 * 10**9))
    return str(root)


def deny_secret(mp):
    """The agent's open of any file named ``secret`` fails with EACCES,
    as it does for an agent that is not root on a mode-0 file."""
    real = os.open

    def fake(path, *a, **kw):
        if os.path.basename(str(path)) == "secret":
            raise PermissionError(13, "Permission denied", str(path))
        return real(path, *a, **kw)
    mp.setattr(os, "open", fake)


class Side:
    """One package's server side: its database, agents manager, aRPC
    listener and store."""

    def __init__(self, pkg, base, pki, *, tls=True, pbs=False, workers=0,
                 tpu=False):
        self.pkg, self.pki, self.tls = pkg, pki, tls
        os.makedirs(base, exist_ok=True)
        self.db = pkg.db.Database(os.path.join(base, "server.db"))
        self.agents = pkg.arpc.AgentsManager()
        self.store = pkg.bp.LocalStore(
            os.path.join(base, "ds"), pkg.Params(**PARAMS), pbs_format=pbs,
            dedup_index_mb=1, **pkg.store_kw, **(pkg.tpu_kw() if tpu else {}))
        self.workers = workers
        self.lifecycles = []

    async def start(self):
        agents, arpc = self.agents, self.pkg.arpc

        async def on_connection(conn, peer, headers):
            sess = await agents.register(peer, headers, conn)
            try:
                await arpc.Router().serve_connection(conn, context=sess)
            finally:
                await agents.unregister(sess)

        tls = arpc.TlsServerConfig(*self.pki.server, self.pki.ca) \
            if self.tls else None
        self.listener = await arpc.serve("127.0.0.1", 0, tls,
                                         on_connection=on_connection,
                                         admit=agents.admit)
        self.port = self.listener.sockets[0].getsockname()[1]
        return self

    async def add_agent(self, pkg, host):
        """A ``pkg`` agent for ``host``, connected and registered."""
        tls = pkg.arpc.TlsClientConfig(*self.pki.agents[host], self.pki.ca) \
            if self.tls else None
        lc = pkg.lc.AgentLifecycle(
            pkg.lc.AgentConfig(hostname=host, server_host="127.0.0.1",
                               server_port=self.port, tls=tls,
                               drive_update_interval_s=0),
            snapshot_manager=pkg.snaps.SnapshotManager(prefer_direct=True))
        task = asyncio.ensure_future(lc.run())
        self.lifecycles.append((lc, task))
        await self.agents.wait_session(host, timeout=10)
        return lc

    def job(self, host, src, job_id="j1", **row_kw):
        """A job row for ``host``'s ``src`` with the row-level, per-job
        and global exclusions."""
        db = self.pkg.db
        self.db.upsert_target(host, "agent", hostname=host)
        self.db.upsert_backup_job(db.BackupJobRow(
            id=job_id, target=host, source_path=src, backup_id=host,
            exclusions=["*.tmp"], pipeline_workers=self.workers, **row_kw))
        if not self.db.list_exclusions(job_id):
            self.db.add_exclusion("cache/", job_id=job_id)
            self.db.add_exclusion("*.bak")
        return self.db.get_backup_job(job_id)

    async def close(self):
        for lc, task in self.lifecycles:
            await lc.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        self.listener.close()
        await self.listener.wait_closed()
        self.db.close()


def run_job(server_pkg, agent_pkg, base, src, pki, *, host="h0", tls=True,
            pbs=False, workers=0, tpu=False, **kw):
    """One whole job: ``server_pkg``'s server side and job against a
    ``agent_pkg`` agent.  Returns the side and the result (or the
    exception the job raised)."""
    async def main():
        side = await Side(server_pkg, base, pki, tls=tls, pbs=pbs,
                          workers=workers, tpu=tpu).start()
        try:
            await side.add_agent(agent_pkg, host)
            row = side.job(host, src)
            try:
                out = await server_pkg.bj.run_target_backup(
                    row, db=side.db, agents=side.agents, store=side.store,
                    **kw)
            except Exception as e:
                out = e
        finally:
            await side.close()
        return side, out
    return asyncio.run(main())


def files_of(root):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def chunk_files(ds_base):
    return {k: v for k, v in files_of(ds_base).items()
            if k.startswith(".chunks")}


INDEX_NAMES = ("root.midx", "root.pidx", "root.mpxar.didx", "root.ppxar.didx",
               "index.json.blob")


def index_files(ds_base):
    return {k: v for k, v in files_of(ds_base).items()
            if os.path.basename(k) in INDEX_NAMES}


def plain_result(res, pkg, tpu=False):
    """A ``BackupResult`` as a dict, the manifest without its creation
    second and with the backend label checked and dropped."""
    d = dict(vars(res))
    man = dict(d.pop("manifest"))
    assert man.pop("chunker_backend") == (pkg.tpu_backend if tpu
                                          else pkg.backend)
    man.pop("created_unix")
    d["manifest"] = man
    return d


CASES = [(pbs, w) for pbs in (False, True) for w in (0, 2)]
IDS = [f"{'pbs' if pbs else 'tpxd'}-workers{w}" for pbs, w in CASES]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, pki):
    """Both packages' whole jobs over the same tree, per (layout,
    workers); built on first use."""
    built = {}

    def get(pbs, workers):
        if (pbs, workers) not in built:
            root = tmp_path_factory.mktemp(f"jobs-{pbs}-{workers}")
            src = make_tree(root / "src", 5)
            out = {"src": src}
            with pinned():
                for pkg in (REF, PORT):
                    base = str(root / pkg.name)
                    side, res = run_job(pkg, pkg, base, src, pki, pbs=pbs,
                                        workers=workers)
                    assert not isinstance(res, Exception), res
                    out[pkg.name] = SimpleNamespace(
                        base=os.path.join(base, "ds"), result=res,
                        store=side.store)
            built[(pbs, workers)] = out
        return built[(pbs, workers)]
    return get


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_job_chunk_and_index_files_match_reference(jobs, pbs, workers):
    b = jobs(pbs, workers)
    ref, port = chunk_files(b["ref"].base), chunk_files(b["port"].base)
    assert ref and ref == port
    ref, port = index_files(b["ref"].base), index_files(b["port"].base)
    assert len(ref) == (3 if pbs else 2) and ref == port


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_job_results_and_manifests_match_reference(jobs, pbs, workers):
    b = jobs(pbs, workers)
    r, p = plain_result(b["ref"].result, REF), plain_result(b["port"].result,
                                                           PORT)
    assert r == p
    assert p["snapshot"] == f"host/h0/{port_bp.format_backup_time(T0)}"
    assert p["errors"] == [] and p["files"] == 8
    assert p["manifest"]["job"] == "j1"


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_job_snapshot_reads_back_as_the_tree(jobs, pbs):
    """Exclusions from the row, the job's database rows and the global
    ones are absent; the hard link is stored once; every file reads back
    equal to its source."""
    b = jobs(pbs, 0)
    ds = b["port"].store.datastore
    ref = ds.list_snapshots()[0]
    rd = b["port"].store.open_snapshot(ref)
    by = {e.path: e for e in rd.entries()}
    assert not {"skip.tmp", "cache", "cache/blob", "etc/old.bak"} & set(by)
    assert by["link"].link_target == "etc/f01"
    assert {by["hard"].kind, by["etc/f01"].kind} == {"h", "f"}
    for path, e in by.items():
        if e.is_file:
            with open(os.path.join(b["src"], path), "rb") as f:
                assert rd.read_file(e) == f.read()


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
@pytest.mark.parametrize("server,agent", [(PORT, REF), (REF, PORT)],
                         ids=["port-job-ref-agent", "ref-job-port-agent"])
def test_mixed_wiring_gives_the_same_snapshot(jobs, tmp_path, pki, pbs,
                                              server, agent):
    b = jobs(pbs, 0)
    with pinned():
        side, res = run_job(server, agent, str(tmp_path), b["src"], pki,
                            pbs=pbs)
    assert not isinstance(res, Exception), res
    base = os.path.join(str(tmp_path), "ds")
    assert chunk_files(base) == chunk_files(b["ref"].base)
    assert index_files(base) == index_files(b["ref"].base)
    assert plain_result(res, server) == plain_result(b["ref"].result, REF)


def test_errors_of_unreadable_entries_match_reference(tmp_path, pki):
    """An xattr, a fifo, a file the agent cannot open and the three kinds
    of exclusion: equal ``errors`` lists, byte-identical snapshots."""
    src = make_tree(tmp_path / "src", 9, extras=True)
    out = {}
    with pinned() as mp:
        deny_secret(mp)
        for pkg in (REF, PORT):
            side, res = run_job(pkg, pkg, str(tmp_path / pkg.name), src, pki)
            assert not isinstance(res, Exception), res
            out[pkg.name] = (res, os.path.join(str(tmp_path / pkg.name), "ds"),
                             side.store)
    (r, rbase, _), (p, pbase, store) = out["ref"], out["port"]
    assert r.errors == p.errors and len(p.errors) == 1
    assert p.errors[0].startswith("var/secret: open: ")
    assert "Permission denied" in p.errors[0]
    assert plain_result(r, REF) == plain_result(p, PORT)
    assert index_files(rbase) == index_files(pbase)
    assert chunk_files(rbase) == chunk_files(pbase)
    rd = store.open_snapshot(store.datastore.list_snapshots()[0])
    by = {e.path: e for e in rd.entries()}
    assert by["pipe"].kind == "p" and "var/secret" not in by
    assert by["etc/f03"].xattrs == {"user.tag": b"blue"}


def _severed(pkg, base, src, pki, nth, *, attempts=2):
    """``pkg``'s job with a checkpoint every 2 chunks and
    ``backup.file.stream`` dropping at its ``nth`` hit; returns the
    result (or exception) and the errors of each failed attempt."""
    failed = []
    real = pkg.bj.run_backup_job

    async def spy(*a, **kw):
        try:
            return await real(*a, **kw)
        except Exception as e:
            failed.append(f"{type(e).__name__}: {e}")
            raise

    with pinned() as mp, pkg.fp.armed("backup.file.stream", "drop", nth=nth):
        mp.setattr(pkg.bj, "run_backup_job", spy)
        side, res = run_job(pkg, pkg, base, src, pki, attempts=attempts,
                            checkpoint_interval="2c", tpu=True)
    return res, failed, side


NTH = 13          # the 7th file's first read: 2 hits a file of one block


@pytest.fixture(scope="module")
def severed(tmp_path_factory, pki):
    """Each package's severed-and-resumed job and an uncrashed one over
    the same 12-file tree."""
    root = tmp_path_factory.mktemp("severed")
    src = make_tree(root / "src", 21, files=12)
    out = {"src": src}
    for pkg in (REF, PORT):
        res, failed, side = _severed(pkg, str(root / pkg.name), src, pki, NTH)
        with pinned():
            _, clean = run_job(pkg, pkg, str(root / f"{pkg.name}-clean"), src,
                               pki, tpu=True)
        out[pkg.name] = SimpleNamespace(
            result=res, failed=failed, store=side.store,
            base=str(root / pkg.name / "ds"),
            clean_base=str(root / f"{pkg.name}-clean" / "ds"), clean=clean)
    return out


def test_severed_job_fails_then_resumes_like_reference(severed):
    r, p = severed["ref"], severed["port"]
    assert not isinstance(p.result, Exception), p.result
    assert r.failed == p.failed and len(p.failed) == 1
    assert "injected connection drop" in p.failed[0]
    assert plain_result(r.result, REF, True) == \
        plain_result(p.result, PORT, True)
    res = p.result.manifest["resume"]
    total = sum(len(v) for k, v in files_of(severed["src"]).items()
                if not k.endswith((".tmp", ".bak", "blob")) and k != "hard")
    assert res["files_skipped"] > 0 and res["files_reread"] > 0
    assert 0 < res["bytes_reread"] < total
    assert index_files(r.base) == index_files(p.base)
    assert chunk_files(r.base) == chunk_files(p.base)
    assert not os.path.exists(os.path.join(
        p.base, "host", "h0", port_ck.CKPT_DIR))


def test_resumed_snapshot_equals_an_uncrashed_one(severed):
    """File for file, the resumed snapshot holds what an uncrashed backup
    of the same tree holds (the resume splices the checkpoint's payload
    ranges, so its chunks may be cut elsewhere)."""
    p = severed["port"]
    ds = p.store.datastore
    rd = p.store.open_snapshot(ds.list_snapshots()[0])
    clean = PORT.bp.LocalStore(p.clean_base, ChunkerParams(**PARAMS),
                               dedup_index_mb=1, device="cpu")
    rc = clean.open_snapshot(clean.datastore.list_snapshots()[0])
    got = {e.path: (e.kind, e.size, e.digest,
                    rd.read_file(e) if e.is_file else None)
           for e in rd.entries()}
    want = {e.path: (e.kind, e.size, e.digest,
                     rc.read_file(e) if e.is_file else None)
            for e in rc.entries()}
    assert got == want


@pytest.mark.parametrize("writer,resumer", [(REF, PORT), (PORT, REF)],
                         ids=["ref-checkpoint", "port-checkpoint"])
def test_checkpoint_written_by_one_package_resumes_in_the_other(
        severed, tmp_path, pki, writer, resumer):
    res, failed, side = _severed(writer, str(tmp_path / "w"), severed["src"],
                                 pki, NTH, attempts=1)
    assert isinstance(res, ConnectionResetError) and len(failed) == 1
    ds = os.path.join(str(tmp_path / "w"), "ds")
    assert os.listdir(os.path.join(ds, "host", "h0", resumer.ck.CKPT_DIR))
    with pinned():
        _, out = run_job(resumer, resumer, str(tmp_path / "w"),
                         severed["src"], pki, tpu=True,
                         checkpoint_interval="2c")
    assert not isinstance(out, Exception), out
    own = severed[resumer.name]
    assert out.manifest["resume"] == own.result.manifest["resume"]
    assert index_files(ds) == index_files(own.base)


def test_local_target_matches_reference_and_the_agent_job(jobs, tmp_path,
                                                          pki):
    """A local target (``run_local_backup``) over the same tree: equal in
    both packages, and its files equal the agent job's."""
    b = jobs(False, 0)
    out = {}
    with pinned() as mp:
        for pkg in (REF, PORT):
            mp.setattr(pkg.snaps, "SnapshotManager", functools.partial(
                pkg.snaps.SnapshotManager, prefer_direct=True))
            base = str(tmp_path / pkg.name)
            side = Side(pkg, base, pki)
            side.db.upsert_target("loc", "local", root_path=b["src"])
            side.db.upsert_backup_job(pkg.db.BackupJobRow(
                id="l1", target="loc", source_path="", backup_id="h0",
                exclusions=["*.tmp"]))
            side.db.add_exclusion("cache/", job_id="l1")
            side.db.add_exclusion("*.bak")
            res = asyncio.run(pkg.bj.run_target_backup(
                side.db.get_backup_job("l1"), db=side.db, agents=None,
                store=side.store))
            side.db.close()
            out[pkg.name] = (res, os.path.join(base, "ds"), side.store)
    (r, rbase, _), (p, pbase, store) = out["ref"], out["port"]
    assert plain_result(r, REF) == plain_result(p, PORT)
    assert index_files(rbase) == index_files(pbase)
    assert chunk_files(rbase) == chunk_files(pbase)
    rl = store.open_snapshot(store.datastore.list_snapshots()[0])
    agent_store = b["port"].store
    ra = agent_store.open_snapshot(agent_store.datastore.list_snapshots()[0])
    files = lambda rd: {e.path: rd.read_file(e) for e in rd.entries()
                        if e.is_file}
    assert files(rl) == files(ra)


def test_offline_agent_unknown_kind_and_crashed_jobs_match_reference(
        tmp_path, pki):
    msgs = {}
    for pkg in (REF, PORT):
        side = Side(pkg, str(tmp_path / pkg.name), pki)
        row = side.job("h1", str(tmp_path))
        side.db.upsert_target("odd", "tape")
        side.db.upsert_backup_job(pkg.db.BackupJobRow(
            id="j2", target="odd", source_path="/"))
        side.db.upsert_backup_job(pkg.db.BackupJobRow(
            id="j3", target="h1", source_path="/", enabled=False))
        got = []
        for r in (row, side.db.get_backup_job("j2")):
            try:
                asyncio.run(pkg.bj.run_target_backup(
                    r, db=side.db, agents=side.agents, store=side.store))
            except RuntimeError as e:
                got.append(str(e))
        tasks = [{"kind": "backup", "job_id": "j1"},
                 {"kind": "restore", "job_id": "j1"},
                 {"kind": "backup", "job_id": "j3"},
                 {"kind": "backup", "job_id": "gone"},
                 {"kind": "backup", "job_id": "j2"},
                 {"kind": "backup", "job_id": "j1"}]
        got.append(pkg.bj.crashed_backup_job_ids(side.db, tasks))
        side.db.close()
        msgs[pkg.name] = got
    assert msgs["ref"] == msgs["port"]
    assert msgs["port"] == ["agent 'h1' not connected",
                            "unknown target kind 'tape' (want agent | "
                            "local | s3)", ["j1", "j2"]]


def test_s3_target_matches_reference(tmp_path, pki):
    from aiohttp import web
    from test_s3 import make_fake_s3

    rng = np.random.default_rng(4)
    objects = {"data/a.bin": rng.integers(0, 256, 5000, np.uint8).tobytes(),
               "data/deep/b.txt": b"deep text " * 300,
               "readme.md": b"# hello s3",
               "skip.tmp": b"excluded"}

    async def main(pkg, base):
        runner = web.AppRunner(make_fake_s3("backups", objects))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            side = Side(pkg, base, pki)
            side.db.upsert_target("s3t", "s3", config={
                "endpoint": f"http://127.0.0.1:{port}", "bucket": "backups",
                "access_key": "AK", "secret_key": "SK"})
            side.db.upsert_backup_job(pkg.db.BackupJobRow(
                id="s1", target="s3t", source_path="", backup_id="s3t",
                exclusions=["*.tmp"]))
            res = await pkg.bj.run_target_backup(
                side.db.get_backup_job("s1"), db=side.db, agents=None,
                store=side.store)
            side.db.close()
            return res, side.store
        finally:
            await runner.cleanup()

    out = {}
    with pinned():
        for pkg in (REF, PORT):
            out[pkg.name] = asyncio.run(main(pkg, str(tmp_path / pkg.name)))
    (r, _), (p, store) = out["ref"], out["port"]
    assert plain_result(r, REF) == plain_result(p, PORT)
    assert p.files == 3 and p.bytes_total == sum(
        len(v) for k, v in objects.items() if k != "skip.tmp")
    assert index_files(str(tmp_path / "ref" / "ds")) == \
        index_files(str(tmp_path / "port" / "ds"))
    rd = store.open_snapshot(store.datastore.list_snapshots()[0])
    assert {e.path: rd.read_file(e) for e in rd.entries() if e.is_file} == \
        {k: v for k, v in objects.items() if k != "skip.tmp"}


def test_chunker_kinds_name_cuda(tmp_path, monkeypatch):
    """The port's job serves the reference's kinds as the reference does
    (the cpu kinds through the port's ``chunker/`` copies with no batch
    hasher, ``sidecar:<host:port>`` through its
    ``ResilientSidecarFactory``, unknown kinds refused alike) and
    ``"cuda"`` (on the device given, the store's); the JAX package's
    ``"tpu"`` raises a ``ValueError`` naming that package."""
    p, rp = ChunkerParams(**PARAMS), RefParams(**PARAMS)
    for kind in ("", "cpu", "scalar", "vector", "sidecar:127.0.0.1:1"):
        port_bj.validate_chunker_kind(kind)
        ref_bj.validate_chunker_kind(kind)
        pf = port_bj.make_chunker_factory(kind)
        rf = ref_bj.make_chunker_factory(kind)
        assert type(pf).__name__ == type(rf).__name__
        if not kind.startswith("sidecar:"):
            assert type(pf(p)).__name__ == type(rf(rp)).__name__
        else:
            pf.client.close()
            rf.client.close()
        assert port_bj.make_batch_hasher(kind) is None
        assert ref_bj.make_batch_hasher(kind) is None
    for backend in ("vector", "scalar", "cpu", "bogus", ""):
        assert port_bj.resolve_cpu_scan_backend(backend) == \
            ref_bj.resolve_cpu_scan_backend(backend)
        assert type(port_bj.make_chunker_factory(
            "cpu", cpu_backend=backend)(p)).__name__ == type(
            ref_bj.make_chunker_factory("cpu", cpu_backend=backend)(rp)
        ).__name__
    # an empty choice falls back to PBS_PLUS_CHUNKER_BACKEND
    from pbs_plus_tpu.utils import conf as ref_conf
    from pbs_plus_tpu_torch.utils import conf as port_conf
    monkeypatch.setenv("PBS_PLUS_CHUNKER_BACKEND", "vector")
    try:
        for conf in (ref_conf, port_conf):
            conf.env.cache_clear()
        assert port_bj.resolve_cpu_scan_backend() == \
            ref_bj.resolve_cpu_scan_backend() == "vector"
    finally:
        monkeypatch.delenv("PBS_PLUS_CHUNKER_BACKEND")
        for conf in (ref_conf, port_conf):
            conf.env.cache_clear()
    port_bj.validate_chunker_kind("cuda")
    assert port_bj.validate_pipeline_workers(2) == \
        ref_bj.validate_pipeline_workers(2) == 2
    for call in (port_bj.validate_chunker_kind,
                 port_bj.make_chunker_factory, port_bj.make_batch_hasher):
        with pytest.raises(ValueError, match="'tpu' is the JAX package's"):
            call("tpu")
    for call, ref_call in ((port_bj.validate_chunker_kind,
                            ref_bj.validate_chunker_kind),
                           (port_bj.make_chunker_factory,
                            ref_bj.make_chunker_factory)):
        with pytest.raises(ValueError, match="unknown chunker backend 'x'"):
            call("x")
        with pytest.raises(ValueError, match="unknown chunker backend 'x'"):
            ref_call("x")
    with pytest.raises(ValueError):
        port_bj.validate_pipeline_workers(65)
    factory = port_bj.make_chunker_factory("cuda", device="cpu")
    assert type(factory(ChunkerParams(**PARAMS))).__name__ == "CudaChunker"
    digs = port_bj.make_batch_hasher("cuda", device="cpu")([b"abc"])
    import hashlib
    assert bytes(digs[0]) == hashlib.sha256(b"abc").digest()
    for pat, rel in (("*.tmp", "a/b.tmp"), ("/etc", "etc"), ("cache/", "cache/x"),
                     ("cache/", "cachex"), ("", "a"), ("b/*", "b/c")):
        assert port_bj.match_exclusion(rel, [pat]) == \
            ref_bj.match_exclusion(rel, [pat])
