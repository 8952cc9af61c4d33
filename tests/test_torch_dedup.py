"""The port's streaming dedup path on the CPU against the JAX package's:
the ``CudaChunker`` through the ``DeviceFeeder``, the ``"cuda"`` writer
backend, the jax-free import gate, and the refusal to run on an absent
card.  Tolerance is exact.  ``test_torch_pipeline.py`` holds the
whole-stream ``DedupPipeline``."""

import argparse
import ast
import asyncio
import io
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.chunker import CpuChunker
from pbs_plus_tpu.models.dedup import TpuChunker
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.models import (CudaChunker, DedupConfig,
                                       DedupPipeline, DeviceFeeder,
                                       make_batch_hasher,
                                       make_chunker_factory)
from pbs_plus_tpu_torch.models import SimilarityModel, VerifyPipeline
from pbs_plus_tpu_torch.mount import CommitEngine
from pbs_plus_tpu_torch.ops import (fingerprint, ingest, rolling_hash, sha256,
                                    similarity)
from pbs_plus_tpu_torch import parallel
from pbs_plus_tpu_torch.parallel import dist_index
from pbs_plus_tpu_torch.pxar import (DedupIndex, IngestCollector, SimilarityIndex,
                                     collector_for)
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.pxar.datastore import ChunkStore, Datastore
from pbs_plus_tpu_torch.pxar.pbsstore import PBSConfig, PBSStore
from pbs_plus_tpu_torch.server import backup_job as port_backup_job
from pbs_plus_tpu_torch.server.store import Server, ServerConfig
from pbs_plus_tpu_torch.server.verification_job import (enqueue_verification,
                                                        run_verification)
from pbs_plus_tpu_torch.sidecar import DedupService, serve_sidecar
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError
from pbs_plus_tpu_torch.__main__ import main as port_main

REF_P = RefParams(avg_size=4 << 10)
P = params_from_reference(REF_P.avg_size, REF_P.min_size, REF_P.max_size,
                          REF_P.seed)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def test_cuda_chunker_fed_in_pieces_matches_tpu_chunker():
    data = _data(300_000, seed=4)
    for feed in (1 << 14, 99_991):
        ref, port = TpuChunker(REF_P), CudaChunker(P, device="cpu")
        got_r, got_p = [], []
        for off in range(0, len(data), feed):
            got_r += ref.feed(data[off:off + feed])
            got_p += port.feed(data[off:off + feed])
        got_r += ref.finalize()
        got_p += port.finalize()
        assert got_p == got_r
    assert CudaChunker.backend_name == "cuda"


def test_feeder_batches_four_streams_like_solo_runs():
    feeder = DeviceFeeder(linger_s=0.2, device="cpu")
    bufs = [np.frombuffer(_data(40_000 + i, seed=10 + i), dtype=np.uint8)
            for i in range(4)]
    hists = [np.frombuffer(_data(63, seed=20 + i), dtype=np.uint8)
             for i in range(4)]
    chunks = [[_data(500 + i, seed=30 + i), _data(70, seed=40 + i)]
              for i in range(4)]
    hits, digests, errs = {}, {}, []
    barrier = threading.Barrier(4)

    def work(i):
        try:
            barrier.wait()
            hits[i] = feeder.candidate_hits(bufs[i], hists[i], P)
            digests[i] = feeder.sha256_batch(chunks[i])
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and not any(t.is_alive() for t in threads)
    tables = rolling_hash.device_tables(P, "cpu")
    for i in range(4):
        solo = rolling_hash.batched_candidate_hits([bufs[i]], [hists[i]],
                                                   tables, P)[0]
        assert np.array_equal(hits[i], solo)
        assert digests[i] == sha256.sha256_chunks(chunks[i], device="cpu")
    assert feeder.stats["max_mask_batch"] > 1
    assert feeder.stats["mask_rows"] == 4


def test_feeder_failure_reaches_only_its_owner():
    feeder = DeviceFeeder(linger_s=0.2, device="cpu")
    good = np.frombuffer(_data(20_000, seed=1), dtype=np.uint8)
    bad_history = np.zeros(5, dtype=np.uint8)       # not 63 bytes
    out, errs = {}, {}
    barrier = threading.Barrier(2)

    def work(name, hist):
        barrier.wait()
        try:
            out[name] = feeder.candidate_hits(good, hist, P)
        except BaseException as e:
            errs[name] = e

    threads = [threading.Thread(target=work, args=("good", np.zeros(63, np.uint8))),
               threading.Thread(target=work, args=("bad", bad_history))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert set(out) == {"good"} and set(errs) == {"bad"}
    solo = rolling_hash.batched_candidate_hits(
        [good], [np.zeros(63, np.uint8)], rolling_hash.device_tables(P, "cpu"), P)
    assert np.array_equal(out["good"], solo[0])


def test_cuda_backend_in_session_writer(tmp_path):
    """chunker='cuda' from the port drops into the JAX package's writer."""
    from pbs_plus_tpu.pxar import Entry, KIND_DIR, KIND_FILE, LocalStore

    def build(base, factory, hasher):
        store = LocalStore(str(base), REF_P, chunker_factory=factory,
                           batch_hasher=hasher)
        s = store.start_session(backup_type="host", backup_id="x")
        s.writer.write_entry(Entry(path="", kind=KIND_DIR))
        s.writer.write_entry_reader(Entry(path="f1", kind=KIND_FILE),
                                    io.BytesIO(_data(100_000, seed=5)))
        return s.finish()

    m_cpu = build(tmp_path / "cpu", lambda p: CpuChunker(p), None)
    m_cuda = build(tmp_path / "cuda", make_chunker_factory("cuda", device="cpu"),
                   make_batch_hasher("cuda", device="cpu"))
    assert m_cpu["payload_chunks"] == m_cuda["payload_chunks"]
    assert m_cpu["payload_size"] == m_cuda["payload_size"]
    assert make_batch_hasher("cpu") is None
    with pytest.raises(ValueError):
        make_chunker_factory("tpu")


_GATE = r"""
import hashlib, importlib, pkgutil, sys

_BLOCKED = ("jax", "jaxlib", "grpc", "msgpack", "pbs_plus_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import pbs_plus_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(pbs_plus_tpu_torch.__path__,
                                              "pbs_plus_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke

# the sidecar's service runs without grpc and msgpack
from pbs_plus_tpu_torch.chunker.spec import TEST_PARAMS
from pbs_plus_tpu_torch.sidecar import DedupService
svc = DedupService(params=TEST_PARAMS, index_buckets=1 << 10, device="cpu")
data = bytes(range(256)) * 40
r = svc.chunk({"stream_id": "s", "data": data, "eof": True})
assert r["cuts"][-1] == len(data) and sum(r["sizes"]) == len(data)
assert r["digests"][0] == hashlib.sha256(data[:r["cuts"][0]]).digest()
assert svc.insert_index({"digests": r["digests"]})["inserted"] >= 1
assert all(svc.probe_index({"digests": r["digests"]})["present"])
assert len(svc.snapshot_signature({"digests": r["digests"]})["signature"]) == 128
assert svc.get_stats({})["use_tpu"] is False

# the index tier: DedupIndex (spill mode), SimilarityIndex and a shard node
import tempfile
from pbs_plus_tpu_torch.parallel import (DistIndexClient, IndexShardServer,
                                         ShardMap)
from pbs_plus_tpu_torch.pxar import (DedupIndex, IngestCollector, SimilarityIndex,
                                     collector_for)
with tempfile.TemporaryDirectory() as tmp:
    idx = DedupIndex(budget_mb=1, spill_dir=tmp, resident_mb=1, device="cpu")
    digs = [hashlib.sha256(b"%d" % i).digest() for i in range(3000)]
    assert idx.insert_many(digs[:2000]) == 2000
    assert idx.probe_batch(digs[1990:2010]) == [True] * 10 + [False] * 10
    idx.save_snapshot(tmp + "/snap")
    sim = SimilarityIndex(device="cpu")
    sim.presketch(digs[:2], [data, data[:-9]], None)
    sim.add(digs[0], sim.take_sketch(digs[0], data), 0)
    assert sim.take_candidate(digs[1], sim.take_sketch(digs[1], data[:-9]))
    node_idx = DedupIndex(budget_mb=1, device="cpu")
    node_idx.mark_booted()
    node = IndexShardServer("s0", node_idx)
    node.start()
    try:
        cli = DistIndexClient(ShardMap([("s0", node.endpoint)]))
        assert cli.insert_many(digs) == 3000
        assert cli.probe_batch(digs[:5]) == [True] * 5
        cli.close()
    finally:
        node.stop()

# the multi-device layer: the sharded step and sequence-parallel cuts over
# a repeated-cpu mesh, held against one device
from pbs_plus_tpu_torch.parallel import dryrun_multichip
assert dryrun_multichip(2, device="cpu")["hits"] == 1

# the fused-ingest collector and its sequential writer
from pbs_plus_tpu_torch.pxar import FusedIngestStream, collector_for

class _Store:
    def __init__(self):
        self.chunks = {}

    def insert(self, digest, chunk, verify=True):
        new = digest not in self.chunks
        self.chunks[digest] = bytes(chunk)
        return new

store = _Store()
fused = FusedIngestStream(store, TEST_PARAMS, collector_for(store, device="cpu"))
fused.write(data)
recs = fused.finish()
assert recs[-1][0] == len(data) and recs[0][1] == hashlib.sha256(
    data[:recs[0][0]]).digest()
assert set(store.chunks) == {d for _, d in recs}

# the snapshot store and the verification job: one small backup through
# LocalStore in the stock-PBS layout (pxar v2 entries and DataBlob chunks
# need no msgpack), read back, then verified at a sample rate of 1.0
import asyncio, io
from types import SimpleNamespace
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu_torch.server.verification_job import run_verification
with tempfile.TemporaryDirectory() as tmp:
    ls = LocalStore(tmp, TEST_PARAMS, pbs_format=True, dedup_index_mb=1,
                    device="cpu")
    sess = ls.start_session(backup_type="host", backup_id="gate")
    sess.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
    sess.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE,
                                         size=len(data)), io.BytesIO(data))
    sess.finish()
    snap = ls.datastore.list_snapshots()[0]
    rd = ls.open_snapshot(snap)
    assert rd.read_file(rd.lookup("f")) == data
    srv = SimpleNamespace(config=SimpleNamespace(verify_workers=0),
                          datastore=SimpleNamespace(datastore=ls.datastore))
    rep = asyncio.run(run_verification(srv, {"id": "v", "sample_rate": 1.0},
                                       device="cpu"))
    assert rep["corrupt"] == [] and rep["snapshots"] == [str(snap)]
    assert rep["checked"] == len({ix.digest(i) for ix in (rd.meta_index,
                                                         rd.payload_index)
                                  for i in range(len(ix))})

# the host chunker kinds (the native scan built by g++ from the package's
# own source), the agent's registry and its update swap
from pbs_plus_tpu_torch.chunker import CpuChunker, candidates, native, vector
cand = candidates(data, TEST_PARAMS, force_numpy=True)
assert native.available()
assert list(native.candidates(data, TEST_PARAMS)) == list(cand)
assert list(vector.candidates(data, TEST_PARAMS)) == list(cand)
assert vector.available()
from pbs_plus_tpu_torch.agent.registry import open_registry
from pbs_plus_tpu_torch.agent.updater import BinSwap, SwapState, Watchdog
with tempfile.TemporaryDirectory() as tmp:
    reg = open_registry(tmp + "/agent.json")
    reg.set_secret("token", b"t")
    assert reg.get_secret("token") == b"t"
    open(tmp + "/live", "wb").write(b"old")
    swap = BinSwap(SwapState(tmp + "/live", tmp + "/st"))
    swap.stage(b"new", "v2")
    swap.swap()
    assert Watchdog(swap).on_boot() == "grace"
    assert swap.rollback() and open(tmp + "/live", "rb").read() == b"old"

# the last slice's modules are among those imported above; a medium
# converts into a pbs_format store (no msgpack) and probes as mtfprobe
new = {"pbs_plus_tpu_torch." + m for m in (
    "utils.safemap", "utils.memlimit", "utils.lockwatch", "proxmox.tasklog",
    "proxmox.manager", "tapeio", "tapeio.mtf", "tapeio.feeder",
    "tapeio.converter", "tapeio.inventory", "tapeio.lto", "tapeio.changer",
    "agent.win", "agent.win.secdesc", "agent.win.acls", "agent.win.registry",
    "agent.win.drives", "agent.win.vss", "agent.win.service",
    "agent.win.restore", "operator", "operator.kube", "operator.leader",
    "operator.operator", "operator.__main__")}
assert new <= set(mods), sorted(new - set(mods))
fleet = {"pbs_plus_tpu_torch." + m for m in (
    "server.fleetsim", "server.fleetproc", "utils.log")}
assert fleet <= set(mods), sorted(fleet - set(mods))
import contextlib, io
from pbs_plus_tpu_torch.__main__ import main as port_main
from pbs_plus_tpu_torch.tapeio import (convert_mtf_to_snapshot,
                                       write_synthetic_mtf)
tree = {"d": None, "d/f": data[:5000], "g": data[5000:9000]}
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/m.bkf", "wb") as f:
        write_synthetic_mtf(f, tree)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(["mtfprobe", tmp + "/m.bkf"]) == 0
    assert out.getvalue().endswith(": 1 dirs, 2 files, 9000 content bytes\n")
    ls = LocalStore(tmp + "/ds", TEST_PARAMS, pbs_format=True,
                    dedup_index_mb=1, device="cpu")
    sess = ls.start_session(backup_type="host", backup_id="tape")
    with open(tmp + "/m.bkf", "rb") as f:
        res = convert_mtf_to_snapshot(f, sess)
    sess.finish()
    rd = ls.open_snapshot(ls.datastore.list_snapshots()[0])
    assert res.files == 2 and not res.errors
    assert rd.read_file(rd.lookup("d/f")) == tree["d/f"]

bad = [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
assert not bad, bad
print(len(mods))
"""


def test_port_imports_without_jax_or_reference():
    r = subprocess.run([sys.executable, "-c", _GATE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 154


_STORE_GATE = r"""
import asyncio, hashlib, io, sys, tempfile
from types import SimpleNamespace

_BLOCKED = ("jax", "jaxlib", "pbs_plus_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from pbs_plus_tpu_torch.chunker.spec import TEST_PARAMS
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu_torch.server.verification_job import run_verification

data = bytes(range(256)) * 12
with tempfile.TemporaryDirectory() as tmp:
    ls = LocalStore(tmp, TEST_PARAMS, dedup_index_mb=1, pipeline_workers=2,
                    device="cpu")
    for t in (1, 2):
        sess = ls.start_session(backup_type="host", backup_id="gate",
                                backup_time=1_700_000_000 + t)
        sess.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
        sess.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE,
                                             size=len(data)), io.BytesIO(data))
        man = sess.finish()
    assert man["previous"] and man["stats"]["new_chunks"] == 0
    rd = ls.open_snapshot(ls.datastore.list_snapshots()[-1])
    assert rd.lookup("f").digest == hashlib.sha256(data).digest()
    srv = SimpleNamespace(config=SimpleNamespace(verify_workers=0),
                          datastore=SimpleNamespace(datastore=ls.datastore))
    rep = asyncio.run(run_verification(srv, {"id": "v", "sample_rate": 1.0},
                                       device="cpu"))
    assert rep["corrupt"] == [] and rep["checked"] == 2

    # the mount: the newest snapshot mounted, one change committed
    from pbs_plus_tpu_torch.mount import (ArchiveView, CommitEngine, Journal,
                                          MutableFS)
    ref = ls.datastore.list_snapshots()[-1]
    fs = MutableFS(ArchiveView(ls.open_snapshot(ref)),
                   Journal(tmp + "/j/j.db"), tmp + "/pass")
    fs.write("f", b"gate", 0)
    new = CommitEngine(fs, ls, backup_id="gate", previous=ref,
                       device="cpu").commit()
    rd = ls.open_snapshot(new)
    assert rd.read_file(rd.lookup("f")) == b"gate" + data[4:]
    assert fs.view.generation == 1 and fs.journal.stats()["edges"] == 0

    # sync: the three snapshots mirrored local to local into a store on
    # the CPU (its index probes each batch); a second run moves nothing
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.pxar.syncwire import (LocalSyncDest,
                                                  LocalSyncSource, run_sync)
    mirror = Datastore(tmp + "/mirror", device="cpu")
    st = run_sync(LocalSyncSource(ls.datastore), LocalSyncDest(mirror),
                  job_id="g", state_root=tmp + "/mirror")
    assert st["snapshots_synced"] == 3 and st["chunks_transferred"] > 0
    st = run_sync(LocalSyncSource(ls.datastore), LocalSyncDest(mirror),
                  job_id="g", state_root=tmp + "/mirror")
    assert st["chunks_transferred"] == 0 and st["snapshots_skipped"] == 3

    # the host chunker kinds cut the file as the first backup's K1 did,
    # hashing inline
    from pbs_plus_tpu_torch.server.backup_job import (make_batch_hasher,
                                                      make_chunker_factory)
    first = ls.open_snapshot(ls.datastore.list_snapshots()[0])
    for kind in ("scalar", "vector", "cpu"):
        cs = LocalStore(tmp + "/" + kind, TEST_PARAMS, dedup_index_mb=1,
                        chunker_factory=make_chunker_factory(kind),
                        batch_hasher=make_batch_hasher(kind), device="cpu")
        assert cs.batch_hasher is None
        sess = cs.start_session(backup_type="host", backup_id="gate")
        sess.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
        sess.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE,
                                             size=len(data)), io.BytesIO(data))
        sess.finish()
        rd = cs.open_snapshot(cs.datastore.list_snapshots()[0])
        assert list(rd.payload_index.records()) == \
            list(first.payload_index.records())
bad = [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
assert not bad, bad
print("ok")
"""


def test_tpxd_store_and_verification_run_without_jax_or_reference():
    """The native layout's tpxar entries need msgpack, which the import
    gate blocks for the sidecar's sake: the pipelined tpxd write path,
    the file-level verification, a sync of the store and sessions cut by
    the host chunker kinds run here with only jax and the reference
    blocked."""
    r = subprocess.run([sys.executable, "-c", _STORE_GATE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


_JOB_GATE = r"""
import asyncio, hashlib, os, sys, tempfile

_BLOCKED = ("jax", "jaxlib", "pbs_plus_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
from pbs_plus_tpu_torch.arpc import AgentsManager, Router, serve
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.server import database
from pbs_plus_tpu_torch.server.backup_job import run_target_backup
from pbs_plus_tpu_torch.utils import failpoints

tmp = tempfile.mkdtemp()
src = os.path.join(tmp, "src")
os.makedirs(os.path.join(src, "d"))
files = {f"d/f{i}": os.urandom(2000 + 700 * i) for i in range(6)}
for p, data in files.items():
    with open(os.path.join(src, p), "wb") as f:
        f.write(data)
os.symlink("d/f0", os.path.join(src, "ln"))

async def main():
    db = database.Database(os.path.join(tmp, "server.db"))
    db.upsert_target("h", "agent", hostname="h")
    db.upsert_backup_job(database.BackupJobRow(
        id="j", target="h", source_path=src, backup_id="h"))
    agents = AgentsManager()

    async def on_connection(conn, peer, headers):
        sess = await agents.register(peer, headers, conn)
        try:
            await Router().serve_connection(conn, context=sess)
        finally:
            await agents.unregister(sess)

    lis = await serve("127.0.0.1", 0, None, on_connection=on_connection,
                      admit=agents.admit)
    agent = AgentLifecycle(AgentConfig(
        "h", "127.0.0.1", lis.sockets[0].getsockname()[1], None,
        drive_update_interval_s=0),
        snapshot_manager=SnapshotManager(prefer_direct=True))
    task = asyncio.ensure_future(agent.run())
    await agents.wait_session("h", timeout=10)
    store = LocalStore(os.path.join(tmp, "ds"), ChunkerParams(1024, 64, 1024),
                       dedup_index_mb=1, device="cpu")
    # the fifth file's stream dropped: the retry resumes from a checkpoint
    with failpoints.armed("backup.file.stream", "drop", nth=9) as fp:
        res = await run_target_backup(
            db.get_backup_job("j"), db=db, agents=agents, store=store,
            attempts=2, checkpoint_interval="1c")
    assert fp.fires == 1 and res.errors == [] and res.files == 6, res
    assert res.manifest["resume"]["files_skipped"] >= 1
    rd = store.open_snapshot(store.datastore.list_snapshots()[0])
    assert {e.path: rd.read_file(e) for e in rd.entries() if e.is_file} \
        == files
    assert rd.lookup("ln").link_target == "d/f0"
    # the agent's source cross-check and self-update handlers over aRPC
    from pbs_plus_tpu_torch.arpc import Session
    sess = Session(agents.get("h").conn)
    got = await sess.call("verify_start",
                          {"path": os.path.join(src, "d/f1")}, timeout=60)
    assert got.data["sha256"] == hashlib.sha256(files["d/f1"]).hexdigest()
    got = await sess.call("update_now", {}, timeout=60)
    assert got.data == {"updated": False,
                        "message": "updates not configured"}
    await agent.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    lis.close()
    db.close()

asyncio.run(main())
bad = [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
assert not bad, bad
print("ok")
"""


def test_backup_job_runs_without_jax_or_reference():
    """The port's agent backup job end to end (port agent, the aRPC
    envelopes over plain loopback, a dropped stream resumed from its
    checkpoint, a tpxd LocalStore on the CPU, then the agent's
    ``verify_start`` and ``update_now`` over the same session) with only
    jax and the reference blocked: the envelopes need msgpack, which the
    main gate blocks."""
    r = subprocess.run([sys.executable, "-c", _JOB_GATE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


_SERVER_GATE = r"""
import asyncio, datetime as dt, os, sys, tempfile

_BLOCKED = ("jax", "jaxlib", "pbs_plus_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
from pbs_plus_tpu_torch.arpc import TlsClientConfig
from pbs_plus_tpu_torch.server import database
from pbs_plus_tpu_torch.server.jobrpc import call_job_rpc
from pbs_plus_tpu_torch.server.metrics import MetricsRegistry
from pbs_plus_tpu_torch.server.store import Server, ServerConfig
from pbs_plus_tpu_torch.utils import mtls

tmp = tempfile.mkdtemp()
src = os.path.join(tmp, "src")
os.makedirs(src)
for i in range(3):
    with open(os.path.join(src, f"f{i}"), "wb") as f:
        f.write(os.urandom(1500 + 900 * i))

async def main():
    server = Server(ServerConfig(
        state_dir=os.path.join(tmp, "state"),
        cert_dir=os.path.join(tmp, "certs"),
        datastore_dir=os.path.join(tmp, "ds"), chunk_avg=1024,
        dedup_index_mb=1, prune_keep_last=1), device="cpu")
    await server.start()
    tid, secret = server.issue_bootstrap_token()
    key = mtls.generate_private_key()
    cert = server.bootstrap_agent("h", mtls.make_csr(key, "h"), tid, secret)
    paths = [os.path.join(tmp, "h.pem"), os.path.join(tmp, "h.key")]
    for p, data in zip(paths, (cert, mtls.key_pem(key))):
        with open(p, "wb") as f:
            f.write(data)
    agent = AgentLifecycle(AgentConfig(
        "h", "127.0.0.1", server.config.arpc_port,
        TlsClientConfig(*paths, server.certs.ca_cert_path),
        drive_update_interval_s=0),
        snapshot_manager=SnapshotManager(prefer_direct=True))
    task = asyncio.ensure_future(agent.run())
    await server.agents.wait_session("h", timeout=10)
    server.db.upsert_backup_job(database.BackupJobRow(
        id="j", target="h", source_path=src, backup_id="h",
        schedule="02:00", chunker="cuda"))
    await server.scheduler.tick(dt.datetime(2026, 7, 29, 2, 0, 10))
    await server.job_queue.drain(timeout=60)
    # a sync row pushing the server's store into a peer, fired by a tick
    server.db.upsert_sync_job("s", direction="push",
                              peer_path=os.path.join(tmp, "peer"),
                              schedule="03:00")
    await server.scheduler.tick(dt.datetime(2026, 7, 29, 3, 0, 10))
    await server.job_queue.drain(timeout=60)
    row = server.db.get_sync_job("s")
    assert row["last_status"] == "success", row
    assert '"snapshots_synced": 1' in row["last_report"], row
    with open(os.path.join(src, "f0"), "r+b") as f:
        f.write(b"changed")
    sock = os.path.join(tmp, "state", "job.sock")
    assert (await call_job_rpc(sock, {"op": "backup_queue",
                                      "job_id": "j"}))["started"]
    await server.job_queue.drain(timeout=60)
    st = await call_job_rpc(sock, {"op": "status", "job_id": "j"})
    assert st["job"]["last_status"] == "success", st
    rep = await server.run_prune(gc_grace_s=0.0)
    assert len(rep.removed) == 1 and rep.chunks_removed >= 1, rep
    text = MetricsRegistry(server).render()
    assert 'pbs_plus_job_grant_to_publish_seconds_count{kind="backup"} 2' \
        in text
    assert "pbs_plus_dedup_index_discards_total" in text
    await agent.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    await server.stop()
    rd = server.datastore.open_snapshot(
        server.datastore.datastore.list_snapshots()[0])
    with open(os.path.join(src, "f0"), "rb") as f:
        assert rd.read_file(rd.lookup("f0")) == f.read()

asyncio.run(main())
bad = [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
assert not bad, bad
print("ok")
"""


def test_server_shell_runs_without_jax_or_reference():
    """A port ``Server`` on the CPU with only jax and the reference
    blocked: one agent bootstrapped and connected over mTLS, a backup
    fired by a scheduler tick and another over the job socket, a sync row
    fired by a tick, prune and GC, the metrics render, and stop."""
    r = subprocess.run([sys.executable, "-c", _SERVER_GATE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


# Installed as ``sitecustomize`` on PYTHONPATH, so every interpreter the
# gate starts (the agent's ``agent-job`` children too) blocks the same
# packages from its first line on: each writes its argv at start and any
# attempt to import a blocked package, so a child that caught the
# ImportError still shows.  msgpack stays importable: it is the aRPC
# wire's codec (utils/codec.py), as in the reference, and the gate runs
# an agent
_WEB_BLOCK = r"""
import json, os, sys

_BLOCKED = ("jax", "jaxlib", "grpc", "pbs_plus_tpu")
_DIR = os.environ["GATE_REPORTS"]

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            with open(os.path.join(_DIR, f"blocked-{os.getpid()}-{name}"),
                      "w") as f:
                f.write(" ".join(sys.argv))
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
with open(os.path.join(_DIR, f"start-{os.getpid()}.json"), "w") as f:
    json.dump(sys.argv, f)
"""

_WEB_GATE = r"""
import asyncio, hashlib, os, sys, tempfile, time
import aiohttp
from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
from pbs_plus_tpu_torch.arpc import TlsClientConfig
from pbs_plus_tpu_torch.server.store import Server, ServerConfig
from pbs_plus_tpu_torch.server.web import start_web
from pbs_plus_tpu_torch.utils import mtls

tmp = tempfile.mkdtemp()
src = os.path.join(tmp, "src")
os.makedirs(os.path.join(src, "d"))
for i in range(3):
    with open(os.path.join(src, "d", f"f{i}"), "wb") as f:
        f.write(os.urandom(1500 + 900 * i))
os.symlink("d/f0", os.path.join(src, "link"))

def tree(root):
    out = {}
    for dp, dn, fn in os.walk(root):
        for n in fn:
            p = os.path.join(dp, n)
            out[os.path.relpath(p, root)] = os.readlink(p) if os.path.islink(
                p) else hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out

async def main():
    server = Server(ServerConfig(
        state_dir=os.path.join(tmp, "state"),
        cert_dir=os.path.join(tmp, "certs"),
        datastore_dir=os.path.join(tmp, "ds"), chunk_avg=1024,
        dedup_index_mb=1), device="cpu")
    await server.start()
    runner, port = await start_web(server, host="127.0.0.1", port=0)
    aid, asec = server.issue_api_token()
    url = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession(
            headers={"Authorization": f"Bearer {aid}:{asec.hex()}"}) as http:
        async def req(method, path, body=None):
            async with http.request(method, url + path, json=body) as r:
                assert r.status == 200, (path, r.status, await r.text())
                return await r.json()
        tok = await req("POST", "/api2/json/d2d/token")
        key = mtls.generate_private_key()
        boot = await req("POST", "/plus/agent/bootstrap", {
            "hostname": "h", "csr": mtls.make_csr(key, "h").decode(),
            "token_id": tok["token_id"], "token_secret": tok["token_secret"]})
        paths = [os.path.join(tmp, n) for n in ("h.pem", "h.key", "ca.pem")]
        for p, data in zip(paths, (boot["cert"].encode(), mtls.key_pem(key),
                                   boot["ca"].encode())):
            with open(p, "wb") as f:
                f.write(data)
        agent = AgentLifecycle(AgentConfig(
            "h", "127.0.0.1", server.config.arpc_port,
            TlsClientConfig(*paths), job_isolation="subprocess",
            drive_update_interval_s=0),
            snapshot_manager=SnapshotManager(prefer_direct=True))
        task = asyncio.ensure_future(agent.run())
        await server.agents.wait_session("h", timeout=300)
        await req("POST", "/api2/json/d2d/target", {"name": "h"})
        await req("POST", "/api2/json/d2d/backup", {
            "id": "j", "target": "h", "source_path": src})
        assert (await req("POST", "/api2/json/d2d/backup/j/run"))["started"]
        for _ in range(3000):
            t = (await req("GET", "/api2/json/d2d/tasks?job=j"))["data"]
            if t and t[0]["status"] != "running":
                break
            await asyncio.sleep(0.1)
        assert t[0]["status"] == "success", t
        snap = (await req("GET", "/api2/json/d2d/snapshots"))["data"][0]
        dest = os.path.join(tmp, "restored")
        rid = (await req("POST", "/api2/json/d2d/restore", {
            "target": "h", "snapshot": snap["snapshot"],
            "destination": dest}))["restore_id"]
        for _ in range(3000):
            r = (await req("GET", f"/api2/json/d2d/restore/{rid}"))["data"]
            if r["status"] in ("success", "error"):
                break
            await asyncio.sleep(0.1)
        assert r["status"] == "success", r
        for _ in range(3000):               # the children are reaped
            if not agent.jobs:
                break
            await asyncio.sleep(0.1)
        assert not agent.jobs
        assert tree(dest) == tree(src)
        # a sync row pushing the server's own store into a peer dir
        await req("POST", "/api2/json/d2d/sync", {
            "id": "s", "direction": "push",
            "peer_path": os.path.join(tmp, "peer")})
        assert (await req("POST", "/api2/json/d2d/sync/s/run"))["started"]
        for _ in range(3000):
            res = (await req("GET", "/api2/json/d2d/sync/s/results"))["data"]
            if res["last_status"]:
                break
            await asyncio.sleep(0.1)
        assert res["last_status"] == "success", res
        assert res["report"]["snapshots_synced"] == 1, res
    await agent.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)
    await runner.cleanup()
    await server.stop()

asyncio.run(main())
print("ok")
"""


def test_web_backup_and_restore_run_without_jax_or_reference(tmp_path):
    """The port's web API over a ``Server(device="cpu")``: an agent
    enrolled over HTTP with ``job_isolation="subprocess"``, one backup
    and one restore through the API, each run in an ``agent-job`` child,
    and a sync row stored, run and read back over the API;
    jax, jaxlib, grpc and the reference are blocked in this interpreter
    and, through ``sitecustomize``, in every child, and none of them
    tries to import one."""
    site = tmp_path / "site"
    reports = tmp_path / "reports"
    site.mkdir()
    reports.mkdir()
    (site / "sitecustomize.py").write_text(_WEB_BLOCK)
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               GATE_REPORTS=str(reports))
    r = subprocess.run([sys.executable, "-c", _WEB_GATE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"
    names = sorted(p.name for p in reports.iterdir())
    assert [n for n in names if n.startswith("blocked-")] == []
    argvs = [json.loads((reports / n).read_text()) for n in names]
    assert len(argvs) == 3, argvs          # this interpreter, two children
    assert sum("agent-job" in a for a in argvs) == 2, argvs


def _imports_of(path):
    """Every module an ``import``/``from`` statement of ``path`` names,
    at any depth (inside functions too); relative imports stay
    relative."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_import_of_jax_or_reference_anywhere_in_the_port():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dp, _dn, fn in os.walk(os.path.join(REPO, "pbs_plus_tpu_torch")):
        files += [os.path.join(dp, f) for f in fn if f.endswith(".py")]
    assert len(files) >= 156
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imports_of(f)
           if m.split(".")[0] in ("jax", "jaxlib", "pbs_plus_tpu")]
    assert bad == []


def test_cuda_request_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        DedupPipeline(DedupConfig(params=P))
    with pytest.raises(CudaUnavailableError):
        CudaChunker(P)
    with pytest.raises(CudaUnavailableError):
        make_chunker_factory("cuda")(P)
    with pytest.raises(CudaUnavailableError):
        sha256.sha256_chunks([b"abc"])
    digs = np.zeros((2, 32), dtype=np.uint8)
    for call in (
            lambda: DedupService(params=P),
            lambda: serve_sidecar(params=P),
            lambda: VerifyPipeline(),
            lambda: SimilarityModel(),
            lambda: similarity.simhash_sketch(digs),
            lambda: similarity.minhash_signature(digs),
            lambda: similarity.pairwise_hamming(np.zeros((2, 2), np.uint32),
                                                np.zeros((2, 2), np.uint32)),
            lambda: similarity.content_sketch_device([b"abcd"]),
            lambda: fingerprint.fold_fingerprint(b"abcd", [0], [4], 1),
            lambda: ingest.scan_rows(ingest.pack_rows([[b"x" * 100]], [b""],
                                                      [0], [0]), P),
            lambda: ingest.digest_chunks([b"abc"]),
            lambda: DedupIndex(),
            lambda: DedupIndex(spill_dir=str(tmp_path / "spill")),
            lambda: SimilarityIndex(),
            lambda: dist_index.serve_shard(argparse.Namespace(
                shard_id="s0", host="127.0.0.1", port=0, token="",
                spill_dir="", budget_mb=1, resident_mb=1, snapshot="",
                device="cuda")),
            lambda: parallel.make_mesh(),
            lambda: parallel.make_seq_mesh(2),
            lambda: parallel.dryrun_multichip(2),
            lambda: IngestCollector(object()),
            lambda: collector_for(object()),
            lambda: LocalStore(str(tmp_path / "ls"), P),
            lambda: Datastore(str(tmp_path / "ds")),
            lambda: ChunkStore(str(tmp_path / "cs")),
            lambda: asyncio.run(run_verification(SimpleNamespace(),
                                                 {"id": "v"})),
            lambda: enqueue_verification(SimpleNamespace(), {"id": "v"}),
            lambda: CommitEngine(SimpleNamespace(), SimpleNamespace()),
            lambda: PBSStore(PBSConfig(base_url="http://127.0.0.1:9",
                                       datastore="d", auth_token="t"), P),
            lambda: port_main(["mount", "--store", str(tmp_path / "ms"),
                               "--mount-state", str(tmp_path / "mst"),
                               "--socket", str(tmp_path / "m.sock")]),
            lambda: port_backup_job.make_chunker_factory("cuda")(P),
            lambda: port_backup_job.make_batch_hasher("cuda")([b"abc"]),
            lambda: Server(ServerConfig(str(tmp_path / "st"),
                                        str(tmp_path / "certs"),
                                        str(tmp_path / "srv")))):
        with pytest.raises(CudaUnavailableError):
            call()
