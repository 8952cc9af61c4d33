"""The port's DedupIndex against the JAX package's, on the CPU.

The same seeded sequence of inserts, probes, discards, DataBlob marks,
rebuilds and one filter growth goes through the JAX ``DedupIndex`` (CPU
jax) and the port's ``DedupIndex(device="cpu")``, in the all-RAM mode and
in the spill mode.  Verdicts, ``len``, ``n_buckets``, the host mirror and
the snapshot bytes must be equal, and a snapshot saved by either package
must load in the other, sketch section included.  A JAX ``ChunkStore``
backed by the port's index must hold the same chunk files through
backup, restore and GC as one backed by the JAX index.  Tolerance is
exact.
"""

import io
import os

import numpy as np
import pytest

from pbs_plus_tpu.pxar import chunkindex as ref_ci
from pbs_plus_tpu_torch.ops import cuckoo
from pbs_plus_tpu_torch.pxar import chunkindex as port_ci
from pbs_plus_tpu_torch.pxar.similarityindex import SimilarityIndex
from pbs_plus_tpu_torch.utils import fswitness


def _digests(n, seed):
    arr = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [arr[i].tobytes() for i in range(n)]


def _pair(tmp_path, mode):
    """(reference, port) indexes at the smallest budget (1 MiB: 2**15
    buckets); spill mode with the smallest memtable (1 MiB)."""
    kw = {"budget_mb": 1, "seed": 3}
    if mode == "spill":
        return (ref_ci.DedupIndex(spill_dir=str(tmp_path / "ref"),
                                  resident_mb=1, **kw),
                port_ci.DedupIndex(spill_dir=str(tmp_path / "port"),
                                   resident_mb=1, device="cpu", **kw))
    return ref_ci.DedupIndex(**kw), port_ci.DedupIndex(device="cpu", **kw)


def _both(ref, port, fn):
    """``fn`` on both, drained of background compaction (segment names
    then follow the call order alone); returns the reference's answer
    after checking the port's equals it."""
    want, got = fn(ref), fn(port)
    for idx in (ref, port):
        if idx.digestlog is not None:
            idx.digestlog.drain()
    assert got == want
    return want


def _same_state(ref, port, probe):
    assert len(port) == len(ref)
    assert port.n_buckets == ref.n_buckets
    assert port._cuckoo._table.tobytes() == ref._cuckoo._table.tobytes()
    assert port.probe_batch(probe) == ref.probe_batch(probe)
    assert [port.contains(d) for d in probe[::7]] == \
        [ref.contains(d) for d in probe[::7]]


@pytest.mark.parametrize("mode", ["ram", "spill"])
def test_sequence_verdicts_state_and_snapshots(tmp_path, mode):
    ref, port = _pair(tmp_path, mode)
    digs = _digests(30_000, seed=1)
    fresh = _digests(2_000, seed=2)
    # inserts in batches under the memtable budget, duplicates included
    for i in range(0, 24_000, 6_000):
        _both(ref, port, lambda x: x.insert_many(digs[i:i + 6_000]
                                                 + digs[i:i + 50]))
    _both(ref, port, lambda x: [x.insert(d) for d in digs[24_000:24_100]])
    probe = digs[::13] + fresh
    _same_state(ref, port, probe)
    # probe-then-insert of the absent half, as the store does
    _both(ref, port, lambda x: x.probe_batch(digs[24_000:26_000]))
    _both(ref, port, lambda x: x.insert_many(digs[24_100:26_000]))
    gone = digs[:3_000:3]
    with fswitness.watching() as w:
        _both(ref, port, lambda x: x.discard_many_acked(gone))
        _both(ref, port, lambda x: x.discard_many(fresh[:10] + gone[:10]))
    w.assert_clean()
    assert w.saw("index.discard")
    assert w.saw("filter.remove") == (mode == "spill")
    for d in digs[5_000:5_040]:
        _both(ref, port, lambda x, d=d: x.mark_datablob(d))
    _both(ref, port, lambda x: [x.is_datablob(d) for d in digs[4_990:5_050]])
    _same_state(ref, port, probe + gone)
    assert not any(port.probe_batch(gone))

    # snapshots: byte-identical, and each loads in the other package
    sketches = [(d, int(i) * 0x9E3779B97F4A7C15 % (1 << 64), i % 4)
                for i, d in enumerate(digs[:64])]
    for x, name in ((ref, "ref.snap"), (port, "port.snap")):
        x.save_snapshot(str(tmp_path / name), sketches=sketches)
    raw = (tmp_path / "port.snap").read_bytes()
    assert raw == (tmp_path / "ref.snap").read_bytes()
    assert raw[:4] == (b"TPXM" if mode == "spill" else b"TPXI")
    if mode == "spill":
        assert sorted(os.listdir(tmp_path / "port" / "segments")) == \
            sorted(os.listdir(tmp_path / "ref" / "segments"))
    for src, dst_mod, dst_dir in ((ref, port_ci, "ref"), (port, ref_ci, "port")):
        kw = {"spill_dir": str(tmp_path / dst_dir), "resident_mb": 1} \
            if mode == "spill" else {}
        if dst_mod is port_ci:
            kw["device"] = "cpu"
        other = dst_mod.DedupIndex(budget_mb=1, **kw)
        assert other.load_snapshot(str(tmp_path / f"{dst_dir}.snap"))
        assert other.loaded_sketches == sketches
        assert len(other) == len(src)
        assert other.probe_batch(probe + gone) == src.probe_batch(probe + gone)

    # rebuild to an exact set, then one growth past the load factor
    _both(ref, port, lambda x: x.rebuild(iter(digs[:9_000])))
    _same_state(ref, port, probe)
    nb = port.n_buckets
    more = _digests(112_000, seed=5)
    for i in range(0, len(more), 8_000):
        _both(ref, port, lambda x: x.insert_many(more[i:i + 8_000]))
    assert port.n_buckets == 2 * nb
    _same_state(ref, port, probe + more[::97])


def test_cpu_index_probes_on_the_host_mirror():
    """device="cpu" answers from the numpy twin: K3 never runs, and no
    device table is kept."""
    idx = port_ci.DedupIndex(budget_mb=1, device="cpu")
    digs = _digests(5_000, seed=6)
    n0 = cuckoo.stats["device_probes"]
    idx.insert_many(digs[:2_500])
    assert idx.probe_batch(digs) == [True] * 2_500 + [False] * 2_500
    assert cuckoo.stats["device_probes"] == n0
    assert idx._cuckoo._device_table is None


def test_device_table_row_copies_track_the_mirror():
    """The device copy is brought current by row copies after inserts,
    discards and evictions, and whole after growth: K3 on it (the plain
    version on a CPU tensor) equals the host mirror's lookup throughout."""
    idx = cuckoo.CuckooIndex(n_buckets=1 << 10, seed=7, device="cpu")
    digs = _digests(3_700, seed=8)
    probe = np.frombuffer(b"".join(digs + _digests(500, seed=9)),
                          np.uint8).reshape(-1, 32)
    idx.insert_many(digs[:1_000])
    s0 = dict(cuckoo.stats)
    for step in range(12):
        t = idx.device_table()
        assert np.array_equal(t.numpy(), idx._table.view(np.int64)
                              .reshape(idx.n_buckets, cuckoo.SLOTS))
        assert np.array_equal(idx.probe(probe).numpy(), idx.probe_host(probe))
        lo = 1_000 + 225 * step
        idx.insert_many(digs[lo:lo + 200])
        for d in digs[lo + 200:lo + 225]:
            idx.insert(d)                       # eviction chains when full
        idx.discard_many(digs[lo - 1_000:lo - 990])
    assert idx.n_buckets == 2 << 10             # grew once, on the way
    assert cuckoo.stats["row_uploads"] > s0["row_uploads"]
    assert cuckoo.stats["table_uploads"] >= s0["table_uploads"] + 2


def test_chunkstore_backup_restore_gc_on_port_index(tmp_path):
    """A JAX ChunkStore whose index (and similarity tier) is the port's
    holds the same chunk files as one on the JAX index, reads every
    snapshot back, and keeps index and disk coherent through prune + GC;
    the sweep's discard-before-unlink order holds in the port's witness."""
    from pbs_plus_tpu.chunker import ChunkerParams
    from pbs_plus_tpu.pxar.backupproxy import LocalStore
    from pbs_plus_tpu.pxar.format import KIND_DIR, KIND_FILE, Entry
    from pbs_plus_tpu.server.prune import PrunePolicy, run_prune
    from pbs_plus_tpu.utils import fswitness as ref_fswitness

    rng = np.random.default_rng(18)
    base = rng.integers(0, 256, 96 << 10, dtype=np.uint8)
    files = []
    for gen in range(3):
        b = base.copy()
        b[gen * 7_000:gen * 7_000 + 500] ^= 0x5A       # a near-duplicate edit
        files.append(np.concatenate(
            [b, rng.integers(0, 256, 32 << 10, dtype=np.uint8)]).tobytes())

    from pbs_plus_tpu.pxar import similarityindex as ref_si
    from pbs_plus_tpu_torch.pxar import similarityindex as port_si

    def run(root, port):
        m0 = ref_si.metrics_snapshot()
        p0 = port_si.metrics_snapshot()["probes"]
        store = LocalStore(str(root), ChunkerParams(avg_size=4 << 10),
                           store_shards=4, dedup_index_mb=1,
                           dedup_resident_mb=1, delta_tier=True)
        cs = store.datastore.chunks
        if port:
            cs.index = port_ci.DedupIndex(
                budget_mb=1, resident_mb=1, device="cpu",
                spill_dir=os.path.join(str(root), ".chunkindex"))
            cs._sim = SimilarityIndex(threshold=cs._sim.threshold,
                                      max_chain=cs._sim.max_chain,
                                      device="cpu")
        mans = []
        for gen, data in enumerate(files):
            sess = store.start_session(backup_type="host", backup_id="g",
                                       backup_time=1_600_000_000.0 + gen,
                                       auto_previous=False)
            sess.writer.write_entry(Entry(path="", kind=KIND_DIR))
            sess.writer.write_entry_reader(Entry(path="f.bin", kind=KIND_FILE),
                                           io.BytesIO(data))
            mans.append(sess.finish()["stats"])
        m1 = ref_si.metrics_snapshot()
        # the store counts delta hits in the JAX module; the candidate
        # probes are the port index's when it is attached
        delta = {k: m1[k] - m0[k] for k in ("hits", "bytes_saved")}
        assert (port_si.metrics_snapshot()["probes"] > p0) == port
        ds = store.datastore
        snaps = ds.list_snapshots("host", "g")      # oldest first
        assert len(snaps) == len(files)
        for ref_, data in zip(snaps, files):
            reader = store.open_snapshot(ref_)
            assert reader.read_file(reader.lookup("f.bin")) == data
        with ref_fswitness.watching() as wr, fswitness.watching() as wp:
            report = run_prune(ds, PrunePolicy(keep_last=1), gc=True,
                               gc_grace_s=0)
        wr.assert_clean()
        wp.assert_clean()
        if port:
            assert wp.saw("index.discard") and not wr.saw("index.discard")
        disk = set(cs.iter_digests())
        assert disk == set(cs.index.digests())
        reader = store.open_snapshot(ds.list_snapshots("host", "g")[0])
        assert reader.read_file(reader.lookup("f.bin")) == files[-1]
        chunk_files = {}
        for d in sorted(disk):
            with open(cs._path(d), "rb") as fh:
                chunk_files[d] = fh.read()
        return mans, report.chunks_removed, chunk_files, cs, delta

    ref_run = run(tmp_path / "ref", port=False)
    port_run = run(tmp_path / "port", port=True)
    assert port_run[0] == ref_run[0]            # new/known/delta counts
    assert port_run[1] == ref_run[1] > 0
    assert port_run[2] == ref_run[2]            # the same chunk files
    assert isinstance(port_run[3].index, port_ci.DedupIndex)
    assert port_run[4] == ref_run[4] and ref_run[4]["hits"] > 0


def test_chunkstore_on_port_dist_index_client(tmp_path):
    """A JAX ChunkStore whose index is the port's DistIndexClient over two
    port shard nodes (the route a host without jax has to the distributed
    index) holds the same chunk files and verdicts, through two backups by
    a JAX pipelined SessionWriter into the port's collector, as the same
    store on the JAX client, nodes and collector; both read back."""
    from pbs_plus_tpu.chunker import ChunkerParams
    from pbs_plus_tpu.parallel import dist_index as ref_di
    from pbs_plus_tpu.pxar import ingestbatch as ref_ib
    from pbs_plus_tpu.pxar.datastore import ChunkStore
    from pbs_plus_tpu.pxar.format import KIND_FILE, Entry
    from pbs_plus_tpu.pxar.transfer import SessionWriter
    from pbs_plus_tpu_torch.parallel import dist_index as port_di
    from pbs_plus_tpu_torch.pxar import ingestbatch as port_ib

    params = ChunkerParams(avg_size=1024)
    rng = np.random.default_rng(19)
    first = rng.integers(0, 256, 60_000, dtype=np.uint8)
    second = first.copy()
    second[20_000:20_400] ^= 0x3C                     # one edit
    files = [first.tobytes(), second.tobytes()]
    absent = _digests(64, seed=20)

    def run(pkg):
        di = ref_di if pkg == "ref" else port_di
        nodes = []
        for sid in ("s0", "s1"):
            idx = (ref_ci.DedupIndex(budget_mb=1) if pkg == "ref"
                   else port_ci.DedupIndex(budget_mb=1, device="cpu"))
            idx.mark_booted()
            nodes.append(di.IndexShardServer(sid, idx, token="t"))
            nodes[-1].start()
        cli = None
        try:
            m = di.ShardMap([(n.shard_id, n.endpoint) for n in nodes], epoch=1)
            for n in nodes:
                n.install_map(m)
            cli = di.DistIndexClient(m, token="t")
            store = ChunkStore(str(tmp_path / pkg), index=cli)
            coll = (ref_ib.IngestCollector(store, max_wait=0.01) if pkg == "ref"
                    else port_ib.IngestCollector(store, device="cpu",
                                                 max_wait=0.01))
            flushes = port_ib.metrics_snapshot()["flushes"]
            out = []
            for data in files:
                w = SessionWriter(store, payload_params=params,
                                  pipeline_workers=2, ingest_collector=coll)
                w.write_entry_reader(Entry(path="f", kind=KIND_FILE,
                                           size=len(data)), io.BytesIO(data))
                _, pidx, stats = w.finish()
                digs = [pidx.digest(i) for i in range(len(pidx))]
                assert b"".join(store.get(d) for d in digs) == data
                out.append((digs, stats.new_chunks, stats.known_chunks))
            assert (port_ib.metrics_snapshot()["flushes"] > flushes) \
                == (pkg == "port")
            probe = [d for digs, _, _ in out for d in digs] + absent
            chunk_files = {}
            for d in store.iter_digests():
                with open(store._path(d), "rb") as fh:
                    chunk_files[d] = fh.read()
            return out, cli.probe_batch(probe), chunk_files, type(cli)
        finally:
            if cli is not None:
                cli.close()
            for n in nodes:
                n.stop()

    ref, port = run("ref"), run("port")
    assert port[0] == ref[0] and ref[0][1][2] > 0      # backup #2 dedups
    assert port[1] == ref[1] and not any(ref[1][-64:])
    assert port[2] == ref[2] and len(ref[2]) > 60
    assert port[3] is port_di.DistIndexClient
