"""The port's fleet against the JAX package's.

``pbs_plus_tpu_torch/server/fleetsim.py`` (the in-process fleet of
loopback agents over the real admission, jobs, mux and datastore code)
and ``server/fleetproc.py`` (one server process of the two-process
shared datastore) are held against the JAX package's on the CPU:

- (a) one mixed run (12 agents, 4 tenants, 4 slots, 2 backup waves,
  restore, verify, sync and readserve lanes) through ``run_fleet`` of
  each package: the report's deterministic fields equal, and the
  datastores and the sync mirrors equal byte for byte (chunk files, the
  snapshots' index files, the snapshot list); the reference's
  ``Datastore.list_snapshots`` is patched there to skip a session's
  staging dir, as the port's does, which a sync lane listing the store
  mid-publish otherwise trips on;
- (a') the same without the sync lane, at 4 agents and 3 files of 8 KiB
  at a 4 KiB average chunk, against the reference as it is: report,
  datastore, snapshot views and restored trees equal;
- (b) chaos: a seeded agent killed mid-backup once a checkpoint
  exists (``checkpoint_interval="1c"``), its job re-enqueued and
  resumed: the port's survivors' snapshots equal its clean run's record
  for record, every snapshot's restored tree equals the JAX chaos run's
  (in both chaos runs a doomed agent's read waits up to 5 s for its
  group's checkpoint before the crash gate is asked);
- (c) the structural hostile profiles: ``flood`` gives a flow
  violation, ``length_liar`` a typed error in its own lane and nothing
  published;
- (d) ``run_multiproc_fleet`` with two ``fleetproc`` workers over one
  datastore and one SQLite database: published, the GC outcomes and
  the queue counts equal the JAX run's, and the port's workers are
  ``pbs_plus_tpu_torch.server.fleetproc`` processes in which jax and
  the JAX package cannot be imported.

Each run is a fresh interpreter (the metrics histograms, the trace ring,
the failpoints and the chunk cache are process-wide), the two packages'
runs side by side.  The port's runs block jax and the JAX package
through a ``sitecustomize`` on ``PYTHONPATH``, which every interpreter
they start loads too.  The index headers' urandom(16) uuid, ``time_ns``
and the stores' ``time.time()`` are pinned, as in
``tests/test_torch_backup_job.py``.  Trees are small (3 files of 1 KiB
at a 1 KiB average chunk but in (a')): the port's sessions digest on the
plain SHA-256, one torch step per 64-byte block of a flush's longest
chunk.  No test asserts a latency, a rate or a deadline shed.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "pbs_plus_tpu", "pbs_plus_tpu_torch"

# the port's interpreters (and their children) load this first: any
# import of jax or of the JAX package fails and is written down, and each
# interpreter writes its command line
_BLOCK = r"""
import json, os, sys

_BLOCKED = ("jax", "jaxlib", "pbs_plus_tpu")
_DIR = os.environ["GATE_REPORTS"]

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            with open(os.path.join(_DIR, f"blocked-{os.getpid()}-{name}"),
                      "w") as f:
                f.write(name)
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
with open("/proc/self/cmdline", "rb") as f:
    _argv = [a.decode() for a in f.read().split(b"\0") if a]
with open(os.path.join(_DIR, f"start-{os.getpid()}.json"), "w") as f:
    json.dump(_argv, f)
"""

_FLEET = r"""
import hashlib, importlib, json, os, sys, time
pkg, cfg_kw, root, out = (sys.argv[1], json.loads(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
fs = importlib.import_module(pkg + ".server.fleetsim")
bp = importlib.import_module(pkg + ".pxar.backupproxy")
dsm = importlib.import_module(pkg + ".pxar.datastore")
tr = importlib.import_module(pkg + ".pxar.transfer")
T0 = 1_700_000_000

class _Clock:
    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(T0)

real = os.urandom
os.urandom = lambda n: b"\x5a" * n if n == 16 else real(n)
time.time_ns = lambda: T0 * 10**9 + 123
bp.time = _Clock()
flags = set(sys.argv[5:])
if "skip-staging" in flags:
    # the reference lists a session's staging dir (<time>.tmp.<pid>.<id>)
    # in the moment between its manifest and its rename, and a sync job
    # listing the store then fails on the rename; the port skips staging
    # dirs (pbs_plus_tpu_torch/pxar/datastore.py), and so does the
    # reference here
    _list = dsm.Datastore.list_snapshots

    def _published(self, *a, **kw):
        return [r for r in _list(self, *a, **kw)
                if ".tmp." not in r.backup_time]
    dsm.Datastore.list_snapshots = _published
if "wait-checkpoint" in flags:
    # a doomed agent's read waits (up to 5 s) for its group's checkpoint
    # before the crash gate is asked: the port's checkpoint on the CPU
    # waits on the plain SHA-256 of its flush, and the agent's reads
    # would all be answered before it lands
    import asyncio
    crash = fs.SimAgent._maybe_crash

    async def _maybe_crash(self, fsobj):
        if self.die_after_reads and fsobj.reads >= self.die_after_reads \
                and not self.dead and self.crash_gate is not None:
            for _ in range(250):
                if self.crash_gate():
                    break
                await asyncio.sleep(0.02)
        await crash(self, fsobj)
    fs.SimAgent._maybe_crash = _maybe_crash
kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
rep = fs.run_fleet(os.path.join(root, "ds"), fs.FleetConfig(**cfg_kw), **kw)
ds = dsm.Datastore(os.path.join(root, "ds"), dedup_index_mb=0, **kw)
views, restored = {}, {}
for ref in ds.list_snapshots():
    rd = tr.SplitReader.open_snapshot(ds, ref)
    key = f"{ref.backup_id}/{ref.backup_time}"
    ents = list(rd.entries())
    views[key] = {
        "tree": [[e.path, e.kind, e.size, e.digest.hex() if e.digest else ""]
                 for e in ents],
        "payload": [[int(rd.payload_index.ends[i]),
                     bytes(rd.payload_index.digests[i]).hex()]
                    for i in range(len(rd.payload_index))],
        "meta": [[int(rd.meta_index.ends[i]),
                  bytes(rd.meta_index.digests[i]).hex()]
                 for i in range(len(rd.meta_index))]}
    restored[key] = {e.path: hashlib.sha256(rd.read_file(e)).hexdigest()
                     for e in ents if e.is_file}
with open(out, "w") as f:
    json.dump({"report": rep.to_dict(), "failures": rep.failures,
               "lane_failures": [rep.restore_failures, rep.verify_failures,
                                 rep.sync_failures, rep.readserve_failures],
               "killed": sorted(rep.killed), "requeued": rep.requeued,
               "resumed": rep.resumed,
               "breakers_round1": rep.breaker_states_round1,
               "breakers": rep.breaker_states,
               "liar_errors": rep.hostile_liar_errors,
               "views": views, "restored": restored}, f)
"""

_MULTIPROC = r"""
import importlib, json, sys
pkg, cfg_kw, root, out = (sys.argv[1], json.loads(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
fs = importlib.import_module(pkg + ".server.fleetsim")
kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
rep = fs.run_multiproc_fleet(root, fs.MultiProcConfig(**cfg_kw), **kw)
with open(out, "w") as f:
    json.dump({"report": rep.to_dict(), "failures": rep.failures}, f)
"""


def _start(script, pkg, cfg, root, *extra):
    """One package's run in a fresh interpreter, started (not waited)."""
    os.makedirs(root)
    # one intra-op thread: the runs side by side would otherwise each
    # spin a pool as wide as the host for tensors of a few KiB
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PBS_PLUS_FUSED_INGEST", None)
    reports = os.path.join(root, "reports")
    if pkg == PORT:
        site = os.path.join(root, "site")
        os.makedirs(site)
        os.makedirs(reports)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_BLOCK)
        env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}",
                   GATE_REPORTS=reports)
    out = os.path.join(root, "out.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, pkg, json.dumps(cfg), root, out,
         *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out, reports


def _runs(script, runs):
    """``runs``: [(pkg, cfg, root, *extra argv)], run side by side; their
    outputs."""
    started = [_start(script, *r) for r in runs]
    results = []
    for (proc, out, reports), (pkg, *_rest) in zip(started, runs):
        _so, se = proc.communicate(timeout=300)
        assert proc.returncode == 0, se[-6000:]
        with open(out) as f:
            res = json.load(f)
        if pkg == PORT:
            names = os.listdir(reports)
            assert [n for n in names if n.startswith("blocked-")] == []
            res["argvs"] = [json.load(open(os.path.join(reports, n)))
                            for n in sorted(names)]
        results.append(res)
    return results


def _files(root, pred=lambda rel: True):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            rel = os.path.relpath(p, root)
            if pred(rel):
                with open(p, "rb") as fh:
                    out[rel] = hashlib.sha256(fh.read()).hexdigest()
    return out


INDEX_NAMES = ("root.midx", "root.pidx", "root.mpxar.didx", "root.ppxar.didx",
               "index.json.blob")


def _store_files(base):
    """Chunk files and the snapshots' index files of a datastore."""
    return _files(base, lambda rel: rel.startswith(".chunks")
                  or os.path.basename(rel) in INDEX_NAMES)


MIXED = dict(n_agents=12, tenants=4, max_concurrent=4, files_per_agent=3,
             file_size=1 << 10, chunk_avg=1 << 10, jobs_per_agent=2,
             restore_jobs=2, verify_jobs=2, sync_jobs=1,
             readserve_readers=2, readserve_reads=4)
# no sync lane, so nothing lists the store while a session publishes and
# the reference runs as it is; 3 files of 8 KiB at a 4 KiB average chunk,
# 4 agents (the port's plain SHA-256 steps a 64-byte block at a time)
UNPATCHED = dict(MIXED, n_agents=4, file_size=8 << 10, chunk_avg=4 << 10,
                 sync_jobs=0)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The MIXED runs (the reference's staging-dir listing patched) and
    the UNPATCHED ones, all four side by side."""
    root = tmp_path_factory.mktemp("mixed")
    ref, port, uref, uport = _runs(_FLEET, [
        (REF, MIXED, str(root / "ref"), "skip-staging"),
        (PORT, MIXED, str(root / "port")),
        (REF, UNPATCHED, str(root / "uref")),
        (PORT, UNPATCHED, str(root / "uport"))])
    return root, ref, port, uref, uport


_DETERMINISTIC = ("n_agents", "tenants", "published", "failed", "resumed",
                  "requeued", "restore_completed", "restore_failed",
                  "restore_entries", "verify_completed", "verify_failed",
                  "verify_checked", "sync_completed", "sync_failed",
                  "sync_chunks", "readserve_completed", "readserve_failed",
                  "readserve_reads", "readserve_bytes", "churned",
                  "hostile_run", "queue_bound", "bound_violated")


def _same_report(ref, port, cfg, contended=True):
    """``contended``: every tenant queues behind the slots, so the same
    tenants have contended grants (with fewer agents than slots a grant
    from the queue depends on when the second wave lands)."""
    r, p = ref["report"], port["report"]
    assert p["published"] == cfg["n_agents"] * cfg["jobs_per_agent"]
    assert port["failures"] == {} and port["lane_failures"] == [{}] * 4
    assert {k: p[k] for k in _DETERMINISTIC} == \
        {k: r[k] for k in _DETERMINISTIC}
    assert p["admission"]["admitted"] == r["admission"]["admitted"]
    assert p["admission_rejected"] == r["admission_rejected"] == 0
    if contended:
        assert {t for t, n in p["tenant_grants"].items() if n} == \
            {t for t, n in r["tenant_grants"].items() if n}
    assert p["running_max"] <= cfg["max_concurrent"]


def test_mixed_fleet_report_matches_reference(mixed):
    _root, ref, port, _uref, _uport = mixed
    _same_report(ref, port, MIXED)


def test_mixed_fleet_datastore_and_mirror_match_reference(mixed):
    root, ref, port, _uref, _uport = mixed
    for sub in ("ds", "ds-mirror"):
        want = _store_files(str(root / "ref" / sub))
        assert want and _store_files(str(root / "port" / sub)) == want, sub
    assert port["views"] == ref["views"]
    assert port["restored"] == ref["restored"]


def test_unpatched_fleet_matches_reference(mixed):
    root, _ref, _port, uref, uport = mixed
    _same_report(uref, uport, UNPATCHED, contended=False)
    assert uport["report"]["sync_completed"] == 0
    want = _store_files(str(root / "uref" / "ds"))
    assert want and _store_files(str(root / "uport" / "ds")) == want
    assert not os.path.exists(root / "uport" / "ds-mirror")
    assert uport["views"] == uref["views"]
    assert uport["restored"] == uref["restored"]
    # a file of 8 KiB at a 4 KiB average: more than one chunk a file
    # somewhere, so the cuts themselves are compared
    assert any(len(v["payload"]) > UNPATCHED["files_per_agent"]
               for v in uport["views"].values())


def test_port_fleet_runs_without_jax_or_reference(mixed):
    _root, _ref, port, _uref, uport = mixed
    for res in (port, uport):
        assert len(res["argvs"]) == 1 and "-c" in res["argvs"][0]


# the kill lands on a read of the third file, with two files (4 KiB, at
# least one chunk) in the writer
CHAOS = dict(n_agents=10, tenants=4, max_concurrent=4, files_per_agent=3,
             file_size=2 << 10, chunk_avg=1 << 10,
             checkpoint_interval="1c", breaker_threshold=1,
             kill_after_reads=5)


def test_chaos_resumes_and_matches_clean_run_and_reference(tmp_path):
    chaos = dict(CHAOS, kill_fraction=0.1)
    ref, port, clean = _runs(_FLEET, [
        (REF, chaos, str(tmp_path / "ref"), "wait-checkpoint"),
        (PORT, chaos, str(tmp_path / "port"), "wait-checkpoint"),
        (PORT, dict(CHAOS, kill_fraction=0.0), str(tmp_path / "clean"))])
    killed = port["killed"]
    assert len(killed) == 1 and killed == ref["killed"]
    assert port["report"]["published"] == CHAOS["n_agents"]
    assert port["failures"] == {} and clean["failures"] == {}
    assert port["requeued"] == port["resumed"] == 1
    assert {k for k, s in port["breakers_round1"].items()
            if s != "closed"} == {f"agent:{killed[0]}"}
    assert set(port["breakers"].values()) == {"closed"}
    for key, view in port["views"].items():
        if key.split("/")[0] in killed:
            assert view["tree"] == clean["views"][key]["tree"], key
        else:
            assert view == clean["views"][key], key
    assert port["restored"] == ref["restored"] == clean["restored"]


def test_structural_hostiles(tmp_path):
    cfg = dict(n_agents=4, tenants=2, max_concurrent=2, files_per_agent=2,
               file_size=1 << 10, chunk_avg=1 << 10, hostile_agents=2,
               hostile_profiles="flood,length_liar")
    (port,) = _runs(_FLEET, [(PORT, cfg, str(tmp_path / "port"))])
    d = port["report"]
    assert d["published"] == 4 and port["failures"] == {}
    assert d["hostile_run"] == 2
    assert d["server_flow_violations"] >= 1
    assert d["hostile_liar_published"] == 0
    assert d["hostile_liar_errors"] >= 1
    assert "StreamLengthError" in " ".join(port["liar_errors"])
    assert d["server_stream_length_violations"] >= 1
    assert [k for k in port["views"] if k.startswith("hostile")] == []


MULTIPROC = dict(n_agents=4, files_per_agent=2, file_size=1 << 10,
                 chunk_avg=1 << 10, gc_ttl_s=1.0, kill_slow_sweep_s=2.0,
                 kill_leader=True)


def test_multiproc_matches_reference(tmp_path):
    ref, port = _runs(_MULTIPROC, [
        (REF, MULTIPROC, str(tmp_path / "ref")),
        (PORT, MULTIPROC, str(tmp_path / "port"))])
    r, p = ref["report"], port["report"]
    assert p["published"] == 2 * MULTIPROC["n_agents"]
    assert port["failures"] == {}
    for k in ("published", "failed", "gc_cycles", "gc_swept", "gc_held",
              "queue_counts", "failover_outcome", "written_once",
              "doomed_on_disk", "doomed_resurrected", "live_missing"):
        assert p[k] == r[k], k
    # which worker wins a cycle's lease race is the scheduler's choice, in
    # either package: the outcomes are compared as a multiset
    assert sorted(o["outcome"] for o in p["gc_outcomes"]) == \
        sorted(o["outcome"] for o in r["gc_outcomes"])
    assert {o["proc"] for o in p["gc_outcomes"]} == {"p0", "p1"}
    assert p["written_once"] and p["cross_process_hits"] > 0
    assert set(p["launches"]) == {"p0", "p1"}
    workers = [a for a in port["argvs"] if "-m" in a]
    assert len(workers) == 2
    for argv in workers:
        assert argv[argv.index("-m") + 1] == \
            "pbs_plus_tpu_torch.server.fleetproc"
        assert argv[argv.index("--device") + 1] == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_fleet_entry_points_want_a_card_by_default(tmp_path):
    from pbs_plus_tpu_torch.server import fleetsim
    from pbs_plus_tpu_torch.utils.device import CudaUnavailableError

    cfg = fleetsim.FleetConfig(n_agents=2, files_per_agent=1,
                               file_size=1 << 10, chunk_avg=1 << 10)
    with pytest.raises(CudaUnavailableError):
        fleetsim.FleetServer(str(tmp_path / "a"), cfg)
    with pytest.raises(CudaUnavailableError):
        fleetsim.run_fleet(str(tmp_path / "b"), cfg)
    with pytest.raises(CudaUnavailableError):
        fleetsim.run_multiproc_fleet(str(tmp_path / "c"),
                                     fleetsim.MultiProcConfig(n_agents=2))
    assert not (tmp_path / "c").exists()
    r = subprocess.run(
        [sys.executable, "-m", "pbs_plus_tpu_torch.server.fleetproc",
         "--state-dir", str(tmp_path / "st"), "--datastore",
         str(tmp_path / "ds"), "--proc-id", "p0"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        stdin=subprocess.DEVNULL)
    assert r.returncode != 0 and "cuda" in r.stderr, r.stderr
    assert '"ready"' not in r.stdout


def _open_db(path, t0, q):
    from pbs_plus_tpu_torch.server import database  # imported by the test
    while time.time() < t0:
        pass
    try:
        database.Database(path)
        q.put("ok")
    except Exception as e:  # noqa: BLE001 - the child reports any failure
        q.put(repr(e))


def test_two_processes_open_one_fresh_database(tmp_path):
    """Processes opening one fresh database at once, as the two
    ``fleetproc`` workers do: the reference's switch to WAL fails in one
    of two with "database is locked" about a third of the time; the
    port's retries it."""
    import multiprocessing
    from pbs_plus_tpu_torch.server import database  # noqa: F401 - forked

    ctx = multiprocessing.get_context("fork")
    for i in range(10):
        path = str(tmp_path / f"{i}" / "state.db")
        q = ctx.Queue()
        t0 = time.time() + 0.1
        procs = [ctx.Process(target=_open_db, args=(path, t0, q))
                 for _ in range(3)]
        for p in procs:
            p.start()
        got = [q.get(timeout=30) for _ in procs]
        for p in procs:
            p.join(timeout=30)
        assert got == ["ok"] * 3, (i, got)
