"""The port's host chunker kinds against the JAX package's and the plain K1.

``chunker/{cpu,native,vector}.py`` of ``pbs_plus_tpu_torch`` (the scalar
numpy scan, the g++-built C++ rolling scan, the vectorized scan and its
batched form) must give the same candidate ends and cuts as the JAX
package's same functions and as the port's plain K1
(``ops/rolling_hash.py`` on the CPU, behind ``CudaChunker``) over one
seeded 1 MiB stream fed in ragged pieces.  ``ResilientVectorFactory``'s
self-test latch and its per-stream pinning, and ``ResilientSidecarFactory``
against a port ``DedupService(device="cpu")`` on loopback gRPC (and a dead
address, where both packages degrade to ``CpuChunker``), are held against
the JAX classes.  A local-target backup job with a ``"cpu"`` row, the JAX
default, writes the same snapshot in both packages.  Tolerance is exact.
"""

import asyncio
import functools
import os

import numpy as np
import pytest

from pbs_plus_tpu.chunker import cpu as ref_cpu
from pbs_plus_tpu.chunker import native as ref_native
from pbs_plus_tpu.chunker import observe as ref_observe
from pbs_plus_tpu.chunker import vector as ref_vector
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.sidecar import client as ref_client
from pbs_plus_tpu_torch.chunker import ChunkerParams
from pbs_plus_tpu_torch.chunker import cpu as port_cpu
from pbs_plus_tpu_torch.chunker import native as port_native
from pbs_plus_tpu_torch.chunker import observe as port_observe
from pbs_plus_tpu_torch.chunker import select_cuts
from pbs_plus_tpu_torch.chunker import vector as port_vector
from pbs_plus_tpu_torch.models.dedup import CudaChunker
from pbs_plus_tpu_torch.ops.rolling_hash import candidate_ends_host
from pbs_plus_tpu_torch.server import backup_job as port_bj
from pbs_plus_tpu_torch.sidecar import client as port_client
from pbs_plus_tpu_torch.sidecar import serve_sidecar

from test_torch_backup_job import (PARAMS, PORT, REF, chunk_files,
                                   index_files, make_tree, pinned)

AVG = 4096
P, RP = ChunkerParams(avg_size=AVG), RefParams(avg_size=AVG)
STREAM = np.random.default_rng(12).integers(0, 256, 1 << 20,
                                            dtype=np.uint8).tobytes()


def _pieces(data, seed=3):
    """``data`` cut at seeded ragged offsets: pieces of 1 B to 96 KiB, some
    under the 63-byte history, some over the scan block."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < len(data):
        n = int(rng.choice([1, 17, 63, 64, 1000, 4096, 70_001, 98_304]))
        out.append(data[pos:pos + n])
        pos += n
    return out


def _stream_cuts(chunker, pieces):
    cuts = []
    for p in pieces:
        cuts += chunker.feed(p)
    return cuts + chunker.finalize()


@pytest.fixture(scope="module")
def k1():
    """The plain K1's candidate ends and cuts of the stream."""
    ends = candidate_ends_host(STREAM, P, device="cpu")
    return ends, select_cuts(ends, len(STREAM), P)


def test_native_library_builds_from_the_port_source():
    assert port_native.available() and port_native.vec_available()
    assert port_native._SRC.endswith(os.path.join(
        "pbs_plus_tpu_torch", "chunker", "csrc", "buzhash_native.cpp"))
    assert os.path.isfile(port_native._SO)
    assert os.path.join("build", "torch_native") in port_native._SO
    assert port_native.vec_impl() == ref_native.vec_impl()
    assert port_vector.scan_impl_name() == ref_vector.scan_impl_name()


@pytest.mark.parametrize("scan", ["numpy", "native", "native-st", "vector",
                                  "vector-numpy"])
def test_candidates_equal_reference_and_plain_k1(k1, scan):
    ends, _ = k1
    arr = np.frombuffer(STREAM, dtype=np.uint8)
    pick = {
        "numpy": lambda m, p: m[0].candidates(arr, p, force_numpy=True),
        "native": lambda m, p: m[1].candidates(arr, p),
        "native-st": lambda m, p: m[1].candidates(arr, p, threads=1),
        "vector": lambda m, p: m[2].candidates(arr, p),
        "vector-numpy": lambda m, p: m[2].candidates(arr, p,
                                                    force_numpy=True),
    }[scan]
    got = pick((port_cpu, port_native, port_vector), P)
    want = pick((ref_cpu, ref_native, ref_vector), RP)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ends)
    # with stream context: the tail after a split, fed its 63-byte prefix
    split = 300_001
    for m, p in ((port_cpu, P), (port_vector, P)):
        part = m.candidates(arr[split:], p, prefix=arr[:split][-63:],
                            global_offset=split)
        np.testing.assert_array_equal(part, ends[ends > split])


@pytest.mark.parametrize("force_numpy", [False, True])
def test_candidates_batch_equal_reference_and_plain_k1(k1, force_numpy):
    ends, _ = k1
    arr = np.frombuffer(STREAM, dtype=np.uint8)
    edges = [0, 5, 70_000, 70_100, 400_000, len(arr)]
    bufs = [arr[a:b] for a, b in zip(edges, edges[1:])]
    prefixes = [arr[max(0, a - 63):a] for a in edges[:-1]]
    kw = dict(prefixes=prefixes, global_offsets=edges[:-1],
              force_numpy=force_numpy)
    got = port_vector.candidates_batch(bufs, P, **kw)
    want = ref_vector.candidates_batch(bufs, RP, **kw)
    for g, w, a, b in zip(got, want, edges, edges[1:]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ends[(ends > a) & (ends <= b)])


@pytest.mark.parametrize("kind", ["scalar", "vector", "cpu", ""])
def test_streaming_cuts_equal_reference_and_plain_k1(k1, kind):
    """One stream fed in ragged pieces through the job's factory of each
    cpu kind: the cuts of the JAX kind, of ``CudaChunker`` on the plain
    K1 and of the one-shot K1 pass are equal."""
    _, cuts = k1
    pieces = _pieces(STREAM)
    got = _stream_cuts(port_bj.make_chunker_factory(kind)(P), pieces)
    from pbs_plus_tpu.server import backup_job as ref_bj
    want = _stream_cuts(ref_bj.make_chunker_factory(kind)(RP), pieces)
    assert got == want == cuts
    assert _stream_cuts(CudaChunker(P, device="cpu"), pieces) == cuts
    assert [e for _, e in port_cpu.chunk_bounds(STREAM, P)] == cuts


def test_scan_bytes_are_counted_by_backend():
    port_observe.reset()
    ref_observe.reset()
    arr = np.frombuffer(STREAM, dtype=np.uint8)[:200_000]
    for (cpu, vec), p, obs in (((port_cpu, port_vector), P, port_observe),
                               ((ref_cpu, ref_vector), RP, ref_observe)):
        cpu.candidates(arr, p, force_numpy=True)
        cpu.candidates(arr, p)
        vec.candidates(arr, p)
        vec.candidates(arr, p, force_numpy=True)
    assert port_observe.snapshot() == ref_observe.snapshot() == {
        "scan_bytes": {"numpy": 200_000, "native": 200_000,
                       "vector": 200_000, "vector-numpy": 200_000},
        "events": {}}


@pytest.mark.parametrize("verdict", ["pass", "mismatch", "raises"])
def test_vector_factory_self_test_and_pinning(monkeypatch, verdict):
    """The self-test latches once a process; a failed or raising one binds
    every stream to ``CpuChunker`` and counts a ``vector_fallbacks``
    event, in both packages.  The class a stream binds is kept for its
    whole life."""
    out = {}
    for name, vec, obs, p in (("ref", ref_vector, ref_observe, RP),
                              ("port", port_vector, port_observe, P)):
        monkeypatch.setattr(vec, "_probe_ok", None)
        if verdict == "mismatch":
            monkeypatch.setattr(vec, "_self_test", lambda: False)
        elif verdict == "raises":
            def boom():
                raise RuntimeError("miscompiled")
            monkeypatch.setattr(vec, "_self_test", boom)
        obs.reset()
        f = vec.ResilientVectorFactory()
        bound = f.bind_stream(p)
        again = f.bind_stream(p)
        one = f(p)
        out[name] = (bound.__name__, again.__name__, type(one).__name__,
                     type(one).backend_name, vec._probe_ok,
                     obs.snapshot()["events"])
    assert out["port"] == out["ref"]
    if verdict == "pass":
        assert out["port"][:5] == ("VectorChunker", "VectorChunker",
                                   "VectorChunker", "vector", True)
        assert out["port"][5] == {}
    else:
        assert out["port"] == ("CpuChunker", "CpuChunker", "CpuChunker",
                               "cpu", False, {"vector_fallbacks": 3})


def test_vector_self_test_passes_on_this_host():
    assert port_vector._self_test() is True
    assert port_vector._self_test() == ref_vector._self_test()


# the sidecar's params: 1 KiB chunks (at most 4 KiB), since the service
# digests each page on the plain SHA-256 here
SP, RSP = ChunkerParams(avg_size=1024), RefParams(avg_size=1024)


@pytest.fixture(scope="module")
def sidecar():
    server, port, svc = serve_sidecar(params=SP, device="cpu")
    yield f"127.0.0.1:{port}", svc
    server.stop(grace=None)


def test_sidecar_factory_cuts_equal_plain_k1(sidecar):
    """``"sidecar:<addr>"`` rows: the port's factory and the JAX one, each
    against the port's ``DedupService`` on the plain K1, cut a ragged
    stream as the plain K1 does; the client's scan bytes land under
    ``sidecar``; a writer whose params differ from the sidecar's is
    refused."""
    data = STREAM[:96 << 10]
    cuts = select_cuts(candidate_ends_host(data, SP, device="cpu"),
                       len(data), SP)
    addr, svc = sidecar
    pieces = _pieces(data, seed=5)
    port_observe.reset()
    f = port_bj.make_chunker_factory(f"sidecar:{addr}")
    assert isinstance(f, port_client.ResilientSidecarFactory)
    bound = f.bind_stream(SP)
    chunker = bound(SP)
    assert type(chunker).__name__ == "SidecarChunker"
    assert _stream_cuts(chunker, pieces) == cuts
    assert port_observe.snapshot()["scan_bytes"]["sidecar"] == len(data)
    ref_f = ref_client.ResilientSidecarFactory(addr)
    assert _stream_cuts(ref_f.bind_stream(RSP)(RSP), pieces) == cuts
    assert port_bj.make_batch_hasher(f"sidecar:{addr}") is None
    assert not svc._streams
    for fac, params in ((bound, ChunkerParams(avg_size=1024, seed=7)),
                        (ref_f.bind_stream(RSP),
                         RefParams(avg_size=1024, seed=7))):
        with pytest.raises(ValueError, match="differ from the writer's"):
            fac(params)
    f.client.close()
    ref_f.client.close()


def test_sidecar_factory_degrades_on_a_dead_address_as_reference():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    out = {}
    for name, mod, p in (("ref", ref_client, RP), ("port", port_client, P)):
        client = mod.SidecarClient(addr, timeout_s=5)
        f = mod.ResilientSidecarFactory(addr, client=client)
        bound = f.bind_stream(p)
        out[name] = (bound.__name__, client.breaker.state,
                     _stream_cuts(bound(p), _pieces(STREAM[:300_000])))
        client.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == "CpuChunker" and out["port"][1] == "open"


def test_cpu_row_local_backup_matches_reference(tmp_path):
    """A local-target job whose row names ``"cpu"`` (``BackupJobRow``'s
    default): the port's store built with that kind's factory and no
    batch hasher writes the chunk and index files of the JAX cpu-kind
    job, and reads back as the tree."""
    src = make_tree(tmp_path / "src", 17)
    out = {}
    with pinned() as mp:
        for pkg in (REF, PORT):
            mp.setattr(pkg.snaps, "SnapshotManager", functools.partial(
                pkg.snaps.SnapshotManager, prefer_direct=True))
            base = str(tmp_path / pkg.name)
            os.makedirs(base)
            db = pkg.db.Database(os.path.join(base, "server.db"))
            store = pkg.bp.LocalStore(
                os.path.join(base, "ds"), pkg.Params(**PARAMS),
                chunker_factory=pkg.bj.make_chunker_factory("cpu"),
                batch_hasher=pkg.bj.make_batch_hasher("cpu"),
                dedup_index_mb=1, **pkg.store_kw)
            db.upsert_target("loc", "local", root_path=src)
            db.upsert_backup_job(pkg.db.BackupJobRow(
                id="l1", target="loc", source_path="", backup_id="h0"))
            row = db.get_backup_job("l1")
            assert row.chunker == "cpu"
            res = asyncio.run(pkg.bj.run_target_backup(
                row, db=db, agents=None, store=store))
            db.close()
            out[pkg.name] = (res, os.path.join(base, "ds"), store)
    (r, rbase, _), (p, pbase, store) = out["ref"], out["port"]
    dr, dp = dict(vars(r)), dict(vars(p))
    mr, mp_ = dict(dr.pop("manifest")), dict(dp.pop("manifest"))
    assert mr.pop("chunker_backend") == mp_.pop("chunker_backend") == "cpu"
    mr.pop("created_unix"), mp_.pop("created_unix")     # the run's second
    assert dr == dp and mr == mp_ and not dp["errors"]
    assert chunk_files(rbase) and chunk_files(rbase) == chunk_files(pbase)
    assert index_files(rbase) == index_files(pbase)
    rd = store.open_snapshot(store.datastore.list_snapshots()[0])
    got = {e.path: rd.read_file(e) for e in rd.entries() if e.is_file}
    assert len(got) >= 8
    for k, v in got.items():
        with open(os.path.join(src, k), "rb") as f:
            assert f.read() == v
