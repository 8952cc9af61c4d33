"""The port's snapshot store against the JAX package's.

The same directory trees, made from a numpy seed, are backed up through
the JAX ``LocalStore`` (its CPU chunker, hashlib) and through the port's
``LocalStore(device="cpu")`` (the plain K1 behind ``CudaChunker``, the
plain SHA-256 behind the ``"cuda"`` batch hasher, the port's
``DedupIndex`` on the CPU), in both codecs (the native ``tpxd`` layout
with tpxar entries, and the stock-PBS layout with pxar v2 entries), with
the sequential writer and with two pipeline workers.  Backup #1 writes
every file; backup #2 rewrites one file, adds one, and references the
rest in the previous snapshot (``DedupWriter.write_entry_ref``).

Chunk files must match byte for byte (same names, same bytes), index
files too (the index header's random uuid and creation time are pinned
for both packages), and manifests must be equal apart from their creation
second and the chunker backend's label (``cpu`` against ``cuda``).  A
snapshot written by either package must read back identically through
the other's ``SplitReader``.  Tolerance is exact.

The plain SHA-256 on the CPU takes one step per 64-byte block of a
batch's longest chunk, so the trees chunk at a 1 KiB average with 1 KiB
at most.
"""

import io
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar import format as ref_fmt
from pbs_plus_tpu.pxar import transfer as ref_tr
from pbs_plus_tpu_torch.chunker import spec as port_spec
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.models.dedup import CudaChunker
from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
from pbs_plus_tpu_torch.pxar import datastore as port_ds
from pbs_plus_tpu_torch.pxar import format as port_fmt
from pbs_plus_tpu_torch.pxar import transfer as port_tr
from pbs_plus_tpu_torch.pxar.chunkindex import DedupIndex

REF = SimpleNamespace(LocalStore=ref_bp.LocalStore, Params=RefParams,
                      fmt=ref_fmt, SplitReader=ref_tr.SplitReader, kw={})
PORT = SimpleNamespace(LocalStore=port_bp.LocalStore, Params=ChunkerParams,
                       fmt=port_fmt, SplitReader=port_tr.SplitReader,
                       kw={"device": "cpu"})
PARAMS = dict(avg_size=1024, min_size=64, max_size=1024)
T0 = 1_700_000_000


def _dfs(tree):
    return dict(sorted(tree.items(), key=lambda kv: tuple(kv[0].split("/"))
                       if kv[0] else ()))


def _tree(seed):
    """{path: bytes or None (a directory)} in DFS path order."""
    rng = np.random.default_rng(seed)
    tree = {"": None, "etc": None, "var": None, "var/log": None}
    for i in range(4):
        n = int(rng.integers(300, 5000))
        tree[f"etc/conf{i}"] = rng.integers(0, 256, n, np.uint8).tobytes()
    for i in range(3):
        n = int(rng.integers(1000, 9000))
        tree[f"var/log/l{i}.log"] = rng.integers(0, 256, n, np.uint8).tobytes()
    tree["var/empty"] = b""
    return _dfs(tree)


def _second(tree):
    """Backup #2's tree: one file rewritten, one added."""
    t = dict(tree)
    t["etc/conf1"] = t["etc/conf1"][:100] + b"changed" + t["etc/conf1"][107:]
    t["var/log/l3.log"] = bytes(range(256)) * 9
    return _dfs(t)


def _write(pkg, base, tree, *, pbs, workers, previous_tree=None):
    store = pkg.LocalStore(base, pkg.Params(**PARAMS), pbs_format=pbs,
                           pipeline_workers=workers, dedup_index_mb=1,
                           **pkg.kw)
    t = T0 if previous_tree is None else T0 + 3600
    sess = store.start_session(backup_type="host", backup_id="a",
                               backup_time=t)
    w = sess.writer
    prev = sess.previous_reader
    for path, data in tree.items():
        if data is None:
            w.write_entry(pkg.fmt.Entry(path=path, kind=pkg.fmt.KIND_DIR,
                                        mode=0o40755))
            continue
        e = pkg.fmt.Entry(path=path, kind=pkg.fmt.KIND_FILE, mode=0o100644,
                          size=len(data), mtime_ns=T0 * 10**9)
        old = prev.lookup(path) if prev is not None else None
        if old is not None and previous_tree.get(path) == data and data:
            w.write_entry_ref(e, old.payload_offset, old.size)
        elif data:
            w.write_entry_reader(e, io.BytesIO(data))
        else:
            w.write_entry(e)
    return store, sess.finish()


def _files(root):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages' stores, backups #1 and #2, per (codec, workers);
    built on first use.  The index header's uuid and time are pinned."""
    _BUILT = {}

    def get(pbs, workers):
        key = (pbs, workers)
        if key not in _BUILT:
            out = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(os, "urandom", lambda n: b"\x5a" * n)
                mp.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)
                t1, t2 = _tree(7), _second(_tree(7))
                for name, pkg in (("ref", REF), ("port", PORT)):
                    base = str(tmp_path_factory.mktemp(f"{name}-{pbs}-{workers}"))
                    _, m1 = _write(pkg, base, t1, pbs=pbs, workers=workers)
                    store, m2 = _write(pkg, base, t2, pbs=pbs, workers=workers,
                                       previous_tree=t1)
                    out[name] = SimpleNamespace(base=base, store=store,
                                                manifests=(m1, m2))
            out["trees"] = (t1, t2)
            _BUILT[key] = out
        return _BUILT[key]
    return get


CASES = [(pbs, w) for pbs in (False, True) for w in (0, 2)]
IDS = [f"{'pbs' if pbs else 'tpxd'}-workers{w}" for pbs, w in CASES]


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_chunk_files_match_reference(built, pbs, workers):
    b = built(pbs, workers)
    ref = {k: v for k, v in _files(b["ref"].base).items()
           if k.startswith(".chunks")}
    port = {k: v for k, v in _files(b["port"].base).items()
            if k.startswith(".chunks")}
    assert ref and sorted(ref) == sorted(port)
    assert all(ref[k] == port[k] for k in ref)


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_index_files_match_reference(built, pbs, workers):
    b = built(pbs, workers)
    names = ("root.mpxar.didx", "root.ppxar.didx", "index.json.blob") if pbs \
        else ("root.midx", "root.pidx")
    ref, port = _files(b["ref"].base), _files(b["port"].base)
    idx = [k for k in ref if os.path.basename(k) in names]
    assert len(idx) == 2 * len(names)
    for k in idx:
        assert ref[k] == port[k], k


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_manifests_match_reference_apart_from_times(built, pbs, workers):
    b = built(pbs, workers)
    for mr, mp in zip(b["ref"].manifests, b["port"].manifests):
        assert mr.pop("chunker_backend") == "cpu"
        assert mp.pop("chunker_backend") == "cuda"
        mr.pop("created_unix"), mp.pop("created_unix")
        assert mr == mp
        mr["chunker_backend"], mp["chunker_backend"] = "cpu", "cuda"
    m2 = b["port"].manifests[1]
    assert m2["previous"] == "host/a/2023-11-14T22:13:20Z"
    assert m2["chunker"]["format"] == port_spec.CHUNK_FORMAT \
        == "buzhash32-nibble16-w64-v1"


@pytest.mark.parametrize("pbs,workers", CASES, ids=IDS)
def test_dedup_writer_reuse_matches_reference(built, pbs, workers):
    b = built(pbs, workers)
    sr, sp = b["ref"].manifests[1]["stats"], b["port"].manifests[1]["stats"]
    assert sr == sp
    assert sp["ref_chunks"] > 0 and sp["bytes_reffed"] > 0
    assert sp["known_chunks"] + sp["ref_chunks"] > sp["new_chunks"]


def _read_all(reader):
    out = {}
    for e in reader.entries():
        out[e.path] = (e.kind, e.size, e.digest,
                       reader.read_file(e) if e.is_file else None)
    return out


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-written", "port-written"])
def test_snapshots_read_back_across_packages(built, pbs, writer, reader):
    b = built(pbs, 0)
    src = b["ref"] if writer is REF else b["port"]
    ds = src.store.datastore
    for ref, tree in zip(ds.list_snapshots(), b["trees"]):
        own = writer.SplitReader.open_snapshot(ds, ref)
        other = reader.SplitReader.open_snapshot(ds, ref)
        got = _read_all(other)
        assert got == _read_all(own)
        assert {p: v[3] for p, v in got.items() if v[3] is not None} == \
            {p: d for p, d in tree.items() if d is not None}
        for path in ("etc/conf2", "var/log", "var/empty"):
            a, c = own.lookup(path), other.lookup(path)
            assert (a.path, a.kind, a.size, a.payload_offset) == \
                (c.path, c.kind, c.size, c.payload_offset)
        assert other.lookup("nope") is None
        assert [e.path for e in other.read_dir("var")] == \
            [e.path for e in own.read_dir("var")]


def test_port_takes_reference_snapshot_as_previous(tmp_path):
    """A JAX-written snapshot serves as the port's previous one (same
    chunk format): the port's backup #2 over it reuses what the JAX
    package's backup #2 over a copy of the same store reuses."""
    tree = _tree(11)
    _write(REF, str(tmp_path / "a"), tree, pbs=False, workers=0)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    store = PORT.LocalStore(str(tmp_path / "a"), ChunkerParams(**PARAMS),
                            dedup_index_mb=1, device="cpu")
    sess = store.start_session(backup_type="host", backup_id="a",
                               backup_time=T0 + 60)
    assert str(sess.previous_ref) == "host/a/2023-11-14T22:13:20Z"
    sess.abort()
    _, mp = _write(PORT, str(tmp_path / "a"), tree, pbs=False, workers=0,
                   previous_tree=tree)
    _, mr = _write(REF, str(tmp_path / "b"), tree, pbs=False, workers=0,
                   previous_tree=tree)
    assert mp["stats"] == mr["stats"] and mp["stats"]["ref_chunks"] > 0
    chunks = lambda d: {k: v for k, v in _files(str(d)).items()
                        if k.startswith(".chunks")}
    assert chunks(tmp_path / "a") == chunks(tmp_path / "b")


def test_local_store_builds_the_cuda_write_path_on_its_device(tmp_path):
    store = port_bp.LocalStore(str(tmp_path), ChunkerParams(**PARAMS),
                               dedup_index_mb=1, device="cpu")
    assert str(store.device) == "cpu"
    assert isinstance(store._chunker_factory(store.params), CudaChunker)
    assert store.batch_hasher is not None
    chunks = store.datastore.chunks
    assert isinstance(chunks, port_ds.ChunkStore)
    assert isinstance(chunks.index, DedupIndex)
    assert str(chunks.index.device) == "cpu"
    assert store.batch_hasher([b"abc"]) == \
        [bytes.fromhex("ba7816bf8f01cfea414140de5dae2223"
                       "b00361a396177a9cb410ff61f20015ad")]


def test_datastore_of_either_package_opens_the_other(built):
    b = built(False, 0)
    theirs = port_ds.Datastore(b["ref"].base, dedup_index_mb=1, device="cpu")
    refs = theirs.list_snapshots()
    assert [str(r) for r in refs] == \
        [str(r) for r in b["ref"].store.datastore.list_snapshots()]
    assert theirs.load_manifest(refs[0]) == \
        b["ref"].store.datastore.load_manifest(refs[0])
