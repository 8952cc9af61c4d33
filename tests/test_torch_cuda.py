"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
the card, run ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port does not
need).  The kernels build into ``build/torch_kernels/`` at first use.
Tolerance is exact: every value is an integer.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from pbs_plus_tpu_torch.chunker.spec import DEFAULT_PARAMS, TEST_PARAMS
from pbs_plus_tpu_torch.ops import cuckoo, rolling_hash, sha256

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("params", [TEST_PARAMS, DEFAULT_PARAMS],
                         ids=["4KiB", "4MiB"])
@pytest.mark.parametrize("with_history", [False, True])
def test_candidate_mask_kernel_matches_plain(cuda, params, with_history):
    # lengths below the window, off and on every span edge, across spans,
    # and 16-byte aligned rows (staged by cp.async) beside ragged ones
    span = rolling_hash.SPAN
    for S in (1, 40, 63, 64, 8447, 8448, 8449, 300_001, span - 1, span,
              span + 1, 3 * span + 17, 16 * span, 17 * span + 5):
        data = torch.from_numpy(np.stack([_bytes(S, S), _bytes(S, S + 1)]))
        hist = torch.from_numpy(np.stack([_bytes(63, 7), _bytes(63, 8)])) \
            if with_history else None
        tables = rolling_hash.device_tables(params, "cpu")
        want = rolling_hash.candidate_mask_plain(data, tables, params.mask,
                                                 params.magic, hist)
        got = rolling_hash.candidate_mask(
            data.to(cuda), tables.to(cuda), params.mask, params.magic,
            history=hist.to(cuda) if hist is not None else None)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), S


def test_candidate_mask_kernel_counts_launches(cuda):
    before = rolling_hash.KERNEL.launches
    rolling_hash.candidate_ends_host(_bytes(100_000, 3), TEST_PARAMS)
    assert rolling_hash.KERNEL.launches == before + 1


def test_sha256_kernel_matches_hashlib_and_plain(cuda):
    sizes = [0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 4096,
             65_537]
    stream = _bytes(sum(sizes) + 3, 11)
    bounds, off = [], 3                 # unaligned starts
    for n in sizes:
        bounds.append((off, off + n))
        off += n
    before = sha256.KERNEL.launches
    got = sha256.sha256_stream_chunks(stream, bounds, device=cuda)
    assert sha256.KERNEL.launches == before + 1
    assert got == [hashlib.sha256(stream[s:e].tobytes()).digest()
                   for s, e in bounds]
    small = [(s, e) for s, e in bounds if e - s <= 4096]
    assert sha256.sha256_stream_chunks(stream, small, device="cpu") == \
        sha256.sha256_stream_chunks(stream, small, device=cuda)


def test_cuckoo_probe_on_card_matches_host(cuda):
    rng = np.random.default_rng(5)
    known = rng.integers(0, 256, (5000, 32), dtype=np.uint8)
    idx = cuckoo.CuckooIndex(n_buckets=1 << 10, seed=1, device=cuda)
    idx.insert_many([bytes(r) for r in known])
    probes = np.concatenate([known[:1000],
                             rng.integers(0, 256, (1000, 32), dtype=np.uint8)])
    got = idx.probe(probes).cpu().numpy()
    assert np.array_equal(got, cuckoo.lookup_host(idx._table, probes))
    assert got[:1000].all()


SHA_EDGE_LENS = [0, 1, 55, 56, 63, 64, 65, 119, 120, 121, 128, 4096, 65_537,
                 (1 << 20) + 3, 16 << 20]


def _sha_check(stream, bounds, cuda):
    got = sha256.sha256_stream_chunks(stream, bounds, device=cuda)
    assert got == [hashlib.sha256(stream[s:e].tobytes()).digest()
                   for s, e in bounds]
    short = [(s, e) for s, e in bounds if e - s <= 4096]
    if short:
        assert sha256.sha256_stream_chunks(stream, short, device="cpu") == \
            sha256.sha256_stream_chunks(stream, short, device=cuda)


def test_sha256_kernel_edge_lengths_every_start_mod_16(cuda):
    stream = _bytes(max(SHA_EDGE_LENS) + 16, 12)
    _sha_check(stream, [(r, r + n) for n in SHA_EDGE_LENS for r in range(16)],
               cuda)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 5000])
def test_sha256_kernel_ragged_batches(cuda, n):
    rng = np.random.default_rng(n)
    stream = _bytes((1 << 20) + 3000, 13)
    bounds = [(int(s), int(s + k)) for s, k in
              zip(rng.integers(0, 1 << 20, n), rng.integers(0, 3000, n))]
    _sha_check(stream, bounds, cuda)


def test_sha256_kernel_long_chunk_among_short(cuda):
    rng = np.random.default_rng(14)
    stream = _bytes((16 << 20) + (1 << 20), 15)
    bounds = [(int(s), int(s + k)) for s, k in
              zip(rng.integers(0, 1 << 20, 1000), rng.integers(0, 5000, 1000))]
    bounds.insert(517, (7, 7 + (16 << 20)))
    _sha_check(stream, bounds, cuda)


def test_ingest_scan_and_digest_on_card_match_plain(cuda):
    """One K1 launch over a packed ragged buffer (rows not 16-byte
    aligned, short rows, zero history) == the plain scan; K2 == hashlib."""
    from pbs_plus_tpu_torch.ops import ingest
    rng = np.random.default_rng(21)
    sizes = (10, 63, 64, 200, 5000, 100_003, 333_333)
    rows = [[_bytes(n, 30 + i).tobytes()] for i, n in enumerate(sizes)]
    tails = [_bytes(63, 40 + i).tobytes() if i % 2 else b""
             for i in range(len(sizes))]
    batch = ingest.pack_rows(rows, tails, [63 if t else 0 for t in tails],
                             [int(x) for x in rng.integers(0, 1 << 30, len(sizes))])
    before = rolling_hash.KERNEL.launches
    got = ingest.scan_rows(batch, TEST_PARAMS, device=cuda)
    assert rolling_hash.KERNEL.launches == before + 1
    want = ingest.scan_rows(batch, TEST_PARAMS, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    chunks = [r[0][:n] for r, n in zip(rows, (10, 63, 64, 200, 999, 4097, 0))]
    assert ingest.digest_chunks(chunks, device=cuda) == \
        [hashlib.sha256(c).digest() for c in chunks]


class _DictStore:
    """A thread-safe in-memory store with a declared batched probe."""

    thread_safe = True

    def __init__(self):
        self.lock = threading.Lock()
        self.chunks = {}

    def ingest_capabilities(self):
        from pbs_plus_tpu_torch.pxar.ingestbackend import IngestCapabilities
        return IngestCapabilities(probe=True, presketch=False)

    def probe_batch(self, digests):
        with self.lock:
            return [d in self.chunks for d in digests]

    def insert(self, digest, chunk, *, verify=True):
        with self.lock:
            new = digest not in self.chunks
            self.chunks[digest] = len(chunk)
            return new

    def note_dedup_hit(self, digest):
        return True

    def touch(self, digest):
        pass


def test_fused_ingest_collector_on_card_matches_cpu(cuda):
    """Two sessions in threads through the port's collector on the card
    == the same on the CPU; one K1 launch per scanning flush, K2 per
    flush that cuts; flusher threads leave the current device at 0."""
    from pbs_plus_tpu_torch.ops import ingest
    from pbs_plus_tpu_torch.pxar.ingestbatch import (FusedIngestStream,
                                                     IngestCollector)
    payloads = [_bytes(n, 50 + n).tobytes() for n in (200_000, 150_001)]
    shared = payloads[0][:40_000]

    def run(device):
        store = _DictStore()
        coll = IngestCollector(store, device=device, max_wait=0.05)
        out, devs = [None, None], []

        def one(k):
            s = FusedIngestStream(store, TEST_PARAMS, coll)
            data = shared + payloads[k]
            for off in range(0, len(data), 64 << 10):
                s.write(data[off:off + (64 << 10)])
            out[k] = (s.finish(), s.stats.new_chunks + s.stats.known_chunks)
            devs.append(torch.cuda.current_device())

        threads = [threading.Thread(target=one, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads) and None not in out
        return out, set(store.chunks), devs

    k1, k2 = rolling_hash.KERNEL.launches, sha256.KERNEL.launches
    scans = ingest.stats["scan_dispatches"]
    got, got_store, devs = run(cuda)
    assert rolling_hash.KERNEL.launches - k1 == \
        ingest.stats["scan_dispatches"] - scans > 0
    assert sha256.KERNEL.launches > k2
    assert devs == [0, 0]
    want, want_store, _ = run("cpu")
    assert got == want and got_store == want_store
    for k, (records, _) in enumerate(got):
        data, s = shared + payloads[k], 0
        for end, digest in records:
            assert digest == hashlib.sha256(data[s:end]).digest()
            s = end
        assert s == len(data)


def test_similarity_ops_on_card_match_host_twins(cuda):
    from pbs_plus_tpu_torch.ops import similarity as S
    digs = _bytes(32 * 3000, 22).reshape(-1, 32)
    sk = S.simhash_sketch(digs, k=64, device=cuda)
    assert sk.is_cuda
    host = S.simhash_sketch_host(digs, k=64)
    assert np.array_equal(sk.cpu().numpy().astype(np.uint32), host)
    assert np.array_equal(S.pairwise_hamming(sk, sk[:500]).cpu().numpy(),
                          S.pairwise_hamming_host(host, host[:500]))
    for k in (64, 128, 256):
        assert np.array_equal(S.minhash_signature(digs, k=k, device=cuda),
                              S.minhash_signature_host(digs, k=k))
    chunks = [_bytes(n, 50 + n).tobytes() for n in (0, 3, 4, 5, 100, 70_000)]
    chunks.append(bytes(5000))
    assert np.array_equal(S.content_sketch_device(chunks, device=cuda),
                          S.content_sketch_host(chunks))


def test_fold_fingerprint_on_card_matches_host(cuda):
    from pbs_plus_tpu_torch.ops import fingerprint as F
    lens = [0, 1, 63, 64, 65, 4097, 1 << 20]
    stream = _bytes(sum(lens) + 9, 23)
    starts = np.cumsum([9] + lens[:-1])
    got = F.fold_fingerprint(stream, starts, lens, (max(lens) + 63) // 64,
                             device=cuda).cpu().numpy().astype(np.uint32)
    assert [w.astype(">u4").tobytes() for w in got] == \
        [F.fold_fingerprint_host(stream[s:s + n].tobytes())
         for s, n in zip(starts, lens)]


def test_verify_snapshot_cross_checks_fetched_chunks_on_card(cuda):
    """On the card a fetched chunk is re-hashed by K2, so a reader that
    hands back wrong bytes without raising is caught; verdicts are the
    same for 0 and 4 workers."""
    from types import SimpleNamespace
    from pbs_plus_tpu_torch.models import VerifyPipeline
    chunks = [_bytes(n, 60 + i).tobytes()
              for i, n in enumerate((100, 5000, 70_000, 3, 4096) * 4)]
    digs = [hashlib.sha256(c).digest() for c in chunks]
    store = dict(zip(digs, chunks))
    store[digs[6]] = b"wrong bytes"

    def fetch(d):
        if d == digs[13]:
            raise IOError("unreadable")
        return store[d]

    index = SimpleNamespace(ends=list(range(len(digs))),
                            digest=lambda i: digs[i])
    empty = SimpleNamespace(ends=[], digest=None)
    reader = SimpleNamespace(entries=lambda: [], meta_index=empty,
                             payload_index=index, fetch_chunk=fetch)
    vp = VerifyPipeline(device=cuda)
    results = [vp.verify_snapshot(reader, workers=w) for w in (0, 4)]
    for r in results:
        assert r.corrupt == [6, 13] or r.corrupt == [13, 6]
    assert results[0].corrupt == results[1].corrupt
    assert results[0].corrupt_paths == results[1].corrupt_paths


def test_sidecar_service_on_card_matches_cpu(cuda):
    from pbs_plus_tpu_torch.sidecar import DedupService
    data = _bytes(300_000, 24).tobytes()
    out = []
    for device in (cuda, "cpu"):
        svc = DedupService(params=TEST_PARAMS, index_buckets=1 << 10,
                           device=device)
        r = [svc.chunk({"stream_id": "s", "data": data[o:o + 65_536],
                        "eof": o + 65_536 >= len(data)})
             for o in range(0, len(data), 65_536)]
        digs = [d for x in r for d in x["digests"]]
        svc.insert_index({"digests": digs[::2]})
        out.append((r, svc.probe_index({"digests": digs}),
                    svc.snapshot_signature({"digests": digs})))
    assert out[0] == out[1]


@pytest.mark.parametrize("spill", [False, True], ids=["ram", "spill"])
def test_dedup_index_probes_with_k3_on_card(cuda, tmp_path, spill):
    """DedupIndex(device="cuda") answers with K3 on the card, equal to a
    Python set, after interleaved inserts, discards and one growth; the
    device table equals the host mirror after its row copies."""
    from pbs_plus_tpu_torch.pxar import DedupIndex
    rng = np.random.default_rng(6)
    kw = {"spill_dir": str(tmp_path), "resident_mb": 1} if spill else {}
    idx = DedupIndex(budget_mb=1, seed=2, device=cuda, **kw)
    nb = idx.n_buckets
    truth: set[bytes] = set()
    before = cuckoo.stats["device_probes"]
    for step in range(16):
        batch = [bytes(r) for r in rng.integers(0, 256, (8_000, 32), np.uint8)]
        probe = batch[:500] + list(truth)[:500]
        assert idx.probe_batch(probe) == [d in truth for d in probe]
        idx.insert_many(batch[250:])
        truth.update(batch[250:])
        gone = list(truth)[:40]
        idx.discard_many_acked(gone)
        truth.difference_update(gone)
        t = idx._cuckoo.device_table()
        torch.cuda.synchronize()
        assert np.array_equal(t.cpu().numpy(), idx._cuckoo._table.view(
            np.int64).reshape(idx.n_buckets, cuckoo.SLOTS))
    assert idx.n_buckets == 2 * nb
    assert cuckoo.stats["device_probes"] >= before + 16
    sample = list(truth)[::50] + [bytes(32)] * 3
    assert idx.probe_batch(sample) == [d in truth for d in sample]


def test_similarity_index_sketches_on_card(cuda):
    from pbs_plus_tpu_torch.ops import similarity
    from pbs_plus_tpu_torch.pxar import SimilarityIndex
    chunks = [_bytes(n, n).tobytes() for n in (3, 4, 100, 4096, 70_001)]
    before = similarity.stats["content_sketch"]
    got = SimilarityIndex(device=cuda).sketch_batch(chunks)
    assert similarity.stats["content_sketch"] == before + 1
    assert np.array_equal(got, similarity.content_sketch_host(chunks))


def test_sharded_step_on_repeated_card_equals_one_device(cuda):
    from pbs_plus_tpu_torch.parallel import (build_step_inputs, make_mesh,
                                             multichip_dedup_step)
    from pbs_plus_tpu_torch.parallel.dist_index import shard_table
    index = cuckoo.CuckooIndex(n_buckets=1 << 12, device=cuda)
    outs = []
    for devs in (["cuda:0"] * 8, ["cuda:0"]):
        mesh = make_mesh(devices=devs)
        s, t, _, p, host = build_step_inputs(mesh, batch=8, seg_len=1 << 16,
                                             params=TEST_PARAMS, index=index)
        index.insert(hashlib.sha256(host[3, :4096].tobytes()).digest())
        k1 = rolling_hash.KERNEL.launches
        out = multichip_dedup_step(mesh, chunk_len=4096, n_buckets=1 << 12)(
            s, t, shard_table(mesh, index._table), p, TEST_PARAMS.mask,
            TEST_PARAMS.magic)
        torch.cuda.synchronize()
        assert rolling_hash.KERNEL.launches == k1 + mesh.shape["data"]
        outs.append([x.cpu() for x in out])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][1].tolist() == [False] * 3 + [True] + [False] * 4


def test_sp_chunker_on_repeated_card_equals_one_device(cuda):
    from pbs_plus_tpu_torch.parallel import make_seq_mesh, sp_chunk_stream
    data = _bytes((8 << 20) + 5, 17)
    before = rolling_hash.KERNEL.launches
    cuts = sp_chunk_stream(make_seq_mesh(devices=["cuda:0"] * 8), data,
                           TEST_PARAMS)
    assert rolling_hash.KERNEL.launches == before + 8
    assert cuts == rolling_hash.chunk_stream_device(data, TEST_PARAMS,
                                                    device="cpu")


def test_fan_in_on_repeated_card_equals_local(cuda):
    from pbs_plus_tpu_torch.parallel import make_seq_mesh, mesh
    bufs = [_bytes(n, n) for n in (70_000, 1 << 20, 5, 300_001, 0)]
    hists = [_bytes(63, i) if i % 2 else None for i in range(len(bufs))]
    tables = rolling_hash.device_tables(TEST_PARAMS, cuda)
    stream = _bytes(1 << 20, 3)
    bounds = [(i * 1000, i * 1000 + 700 + i) for i in range(900)]
    local = (rolling_hash.batched_candidate_hits(bufs, hists, tables,
                                                 TEST_PARAMS),
             sha256.sha256_stream_chunks(stream, bounds, device=cuda))
    before = mesh.set_data_mesh(make_seq_mesh(devices=["cuda:0"] * 4,
                                              axis_name="data"))
    try:
        k1, k2 = rolling_hash.KERNEL.launches, sha256.KERNEL.launches
        hits = rolling_hash.batched_candidate_hits(bufs, hists, tables,
                                                   TEST_PARAMS)
        digs = sha256.sha256_stream_chunks(stream, bounds, device=cuda)
        assert rolling_hash.KERNEL.launches == k1 + 4
        assert sha256.KERNEL.launches == k2 + 4
    finally:
        mesh.set_data_mesh(before)
    assert all(np.array_equal(a, b) for a, b in zip(hits, local[0]))
    assert digs == local[1] == [hashlib.sha256(stream[s:e].tobytes()).digest()
                                for s, e in bounds]


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    n = min(8, 1 << (torch.cuda.device_count().bit_length() - 1))
    return [f"cuda:{i}" for i in range(n)]


def test_multi_device_layer_on_distinct_cards_equals_one_card(cards):
    from pbs_plus_tpu_torch.parallel import (build_step_inputs, make_mesh,
                                             make_seq_mesh, mesh,
                                             multichip_dedup_step,
                                             sp_chunk_stream)
    from pbs_plus_tpu_torch.parallel.dist_index import shard_table
    index = cuckoo.CuckooIndex(n_buckets=1 << 12, device="cuda:0")
    outs = []
    for devs in (cards, ["cuda:0"]):
        m = make_mesh(devices=devs)
        s, t, _, p, host = build_step_inputs(m, batch=8, seg_len=1 << 16,
                                             params=TEST_PARAMS, index=index)
        index.insert(hashlib.sha256(host[5, :4096].tobytes()).digest())
        out = multichip_dedup_step(m, chunk_len=4096, n_buckets=1 << 12)(
            s, t, shard_table(m, index._table), p, TEST_PARAMS.mask,
            TEST_PARAMS.magic)
        outs.append([x.cpu() for x in out])
        assert torch.cuda.current_device() == 0
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    data = _bytes((16 << 20) + 3, 5)
    assert sp_chunk_stream(make_seq_mesh(devices=cards), data, TEST_PARAMS) \
        == rolling_hash.chunk_stream_device(data, TEST_PARAMS)
    # the batched dispatches fan out over every card by default
    assert mesh.data_mesh() is not None
    tables = rolling_hash.device_tables(TEST_PARAMS, "cuda:0")
    bufs = [_bytes(300_000, i) for i in range(6)]
    fan = rolling_hash.batched_candidate_hits(bufs, [None] * 6, tables,
                                              TEST_PARAMS)
    stream = _bytes(1 << 20, 4)
    bounds = [(i * 999, i * 999 + 500 + i) for i in range(1000)]
    digs = sha256.sha256_stream_chunks(stream, bounds, device="cuda:0")
    assert torch.cuda.current_device() == 0
    prev = mesh.set_data_mesh(None)
    try:
        local = rolling_hash.batched_candidate_hits(bufs, [None] * 6, tables,
                                                    TEST_PARAMS)
    finally:
        mesh.set_data_mesh(prev)
    assert all(np.array_equal(a, b) for a, b in zip(fan, local))
    assert digs == [hashlib.sha256(stream[s:e].tobytes()).digest()
                    for s, e in bounds]


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_store_and_verification_on_card(cuda, tmp_path, pbs):
    """A small LocalStore on the card (K1 cuts, K2 digests, K3 probes)
    equals one on the CPU chunk for chunk; the verification job on the
    card reports as the CPU's does, also with one flipped chunk (reported
    in the PBS layout, raised in the tpxd one)."""
    import asyncio
    import io
    import os
    from types import SimpleNamespace

    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
    from pbs_plus_tpu_torch.server.verification_job import run_verification

    files = {f"f{i}": _bytes(1000 + 37_000 * i, 20 + i).tobytes()
             for i in range(5)}
    stores = {}
    for dev in ("cpu", "cuda"):
        ls = LocalStore(str(tmp_path / dev), TEST_PARAMS, pbs_format=pbs,
                        dedup_index_mb=1, device=dev)
        before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                  cuckoo.stats["device_probes"])
        sess = ls.start_session(backup_type="host", backup_id="a",
                                backup_time=1_700_000_000)
        sess.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
        for name, data in files.items():
            sess.writer.write_entry_reader(
                Entry(path=name, kind=KIND_FILE, size=len(data)),
                io.BytesIO(data))
        sess.finish()
        after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                 cuckoo.stats["device_probes"])
        if dev == "cuda":
            assert all(a > b for a, b in zip(after, before))
        stores[dev] = ls.datastore
    raw = {dev: {d: ds.chunks.get_raw(d) for d in ds.chunks.iter_digests()}
           for dev, ds in stores.items()}
    assert raw["cpu"] == raw["cuda"]

    def verify(dev):
        srv = SimpleNamespace(config=SimpleNamespace(verify_workers=0),
                              datastore=SimpleNamespace(datastore=stores["cuda"]))
        return asyncio.run(run_verification(
            srv, {"id": "v", "sample_rate": 1.0}, device=dev))

    before = sha256.KERNEL.launches
    assert verify("cuda") == verify("cpu")
    ds = stores["cuda"]
    ref = ds.list_snapshots()[0]
    d = ds.load_indexes(ref)[1].digest(0)
    with open(ds.chunks._path(d), "r+b") as f:
        raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0x40
        f.seek(0)
        f.write(raw)
    if pbs:
        rep = verify("cuda")
        assert rep == verify("cpu")
        assert rep["corrupt"] == [{"snapshot": str(ref),
                                   "files": [f"chunk:{d.hex()}"]}]
    else:
        for dev in ("cuda", "cpu"):
            with pytest.raises(OSError, match="corrupt on disk"):
                verify(dev)
    assert sha256.KERNEL.launches > before


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_mount_commit_on_card(cuda, tmp_path, monkeypatch, pbs):
    """A small mount committed on the card (K1 cuts, K2 digests and
    verifies, K3 probes) equals the same commit on the CPU chunk for
    chunk (the journal's mtimes pinned); a commit whose expected digest
    has one bit flipped fails on K2's verdict and publishes nothing."""
    import io
    import time

    from pbs_plus_tpu_torch.mount import (ArchiveView, CommitEngine, Journal,
                                          MutableFS)
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry

    class Flipping(CommitEngine):
        def _verify_entries(self, vp, reader, entries):
            e = entries[0]
            e.digest = bytes([e.digest[0] ^ 1]) + e.digest[1:]
            return super()._verify_entries(vp, reader, entries)

    files = {f"d/f{i}": _bytes(1000 + 9_000 * i, 40 + i).tobytes()
             for i in range(5)}
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000 * 10**9)
    got = {}
    for dev in ("cpu", "cuda"):
        ls = LocalStore(str(tmp_path / dev / "ds"), TEST_PARAMS,
                        pbs_format=pbs, dedup_index_mb=1, device=dev)
        sess = ls.start_session(backup_type="host", backup_id="m",
                                backup_time=1_700_000_000)
        w = sess.writer
        w.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
        w.write_entry(Entry(path="d", kind=KIND_DIR, mode=0o40755))
        for name, data in files.items():
            w.write_entry_reader(Entry(path=name, kind=KIND_FILE,
                                       size=len(data)), io.BytesIO(data))
        sess.finish()
        fs = MutableFS(ArchiveView(ls.open_snapshot(sess.ref)),
                       Journal(str(tmp_path / dev / "j" / "j.db")),
                       str(tmp_path / dev / "pass"))
        fs.write("d/f3", b"x" * 4096, 5000)
        fs.create("new.bin")
        fs.write("new.bin", _bytes(20_000, 50).tobytes())
        fs.rename("d/f1", "d/g1")
        before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                  cuckoo.stats["device_probes"])
        ref = CommitEngine(fs, ls, backup_id="m", previous=sess.ref,
                           device=dev).commit()
        after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                 cuckoo.stats["device_probes"])
        if dev == "cuda":
            assert all(a > b for a, b in zip(after, before))
        rd = ls.open_snapshot(ref)
        read = {e.path: rd.read_file(e) for e in rd.entries() if e.is_file}
        fs.write("new.bin", b"late", 0)
        snaps = ls.datastore.list_snapshots()
        with pytest.raises(RuntimeError, match="verification failed"):
            Flipping(fs, ls, backup_id="m", previous=ref, device=dev).commit()
        assert ls.datastore.list_snapshots() == snaps
        assert fs.view.generation == 1 and fs.read("new.bin")[:4] == b"late"
        ds = ls.datastore
        got[dev] = (read, {d: ds.chunks.get_raw(d)
                           for d in ds.chunks.iter_digests()})
    assert got["cuda"] == got["cpu"]
    want = dict(files)
    want["d/g1"] = want.pop("d/f1")
    want["d/f3"] = want["d/f3"][:5000] + b"x" * 4096 + want["d/f3"][9096:]
    want["new.bin"] = _bytes(20_000, 50).tobytes()
    assert got["cuda"][0] == want


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_backup_job_on_card(cuda, tmp_path, pbs):
    """A whole agent backup job (port agent, aRPC over plain loopback,
    ``run_target_backup``) into a LocalStore on the card equals the same
    job into one on the CPU chunk for chunk and index for index (the
    index headers' uuid and time and the snapshot time pinned), and K1,
    K2 and K3 launch from the job's writer thread."""
    import asyncio
    import os
    import time

    from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
    from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
    from pbs_plus_tpu_torch.arpc import AgentsManager, Router, serve
    from pbs_plus_tpu_torch.pxar import backupproxy
    from pbs_plus_tpu_torch.server import database
    from pbs_plus_tpu_torch.server.backup_job import run_target_backup

    src = tmp_path / "src"
    os.makedirs(src / "d")
    for i in range(6):
        (src / "d" / f"f{i}").write_bytes(_bytes(1000 + 41_000 * i,
                                                 60 + i).tobytes())
    os.symlink("d/f1", src / "ln")
    os.link(src / "d" / "f2", src / "hard")
    (src / "skip.tmp").write_bytes(b"excluded")

    async def job(dev):
        db = database.Database(str(tmp_path / dev / "server.db"))
        db.upsert_target("h", "agent", hostname="h")
        db.upsert_backup_job(database.BackupJobRow(
            id="j", target="h", source_path=str(src), backup_id="h",
            exclusions=["*.tmp"], pipeline_workers=2 if pbs else 0))
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
        try:
            await agents.wait_session("h", timeout=10)
            store = backupproxy.LocalStore(
                str(tmp_path / dev / "ds"), TEST_PARAMS, pbs_format=pbs,
                dedup_index_mb=1, device=dev)
            res = await run_target_backup(db.get_backup_job("j"), db=db,
                                          agents=agents, store=store)
        finally:
            await agent.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            lis.close()
            db.close()
        return res, store

    class Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def time():
            return 1_700_000_000.0

    got = {}
    mp = pytest.MonkeyPatch()
    real = os.urandom
    mp.setattr(os, "urandom", lambda n: b"\x5a" * n if n == 16 else real(n))
    mp.setattr(time, "time_ns", lambda: 1_700_000_000 * 10**9)
    mp.setattr(backupproxy, "time", Clock())
    try:
        for dev in ("cpu", "cuda"):
            before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                      cuckoo.stats["device_probes"])
            res, store = asyncio.run(job(dev))
            after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                     cuckoo.stats["device_probes"])
            if dev == "cuda":
                assert all(a > b for a, b in zip(after, before))
            ds = store.datastore
            ref = ds.list_snapshots()[0]
            rd = store.open_snapshot(ref)
            files = {e.path: rd.read_file(e) for e in rd.entries()
                     if e.is_file}
            idx = [bytes(open(os.path.join(ds.snapshot_dir(ref), n),
                              "rb").read())
                   for n in sorted(os.listdir(ds.snapshot_dir(ref)))
                   if n.endswith(("idx", "didx"))]
            man = dict(res.manifest)
            man.pop("chunker_backend"), man.pop("created_unix")
            got[dev] = (res.errors, res.files, res.bytes_total, man, files,
                        idx, {d: ds.chunks.get_raw(d)
                              for d in ds.chunks.iter_digests()})
    finally:
        mp.undo()
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0] == [] and got["cuda"][1] == 6
    assert got["cuda"][4] == {f"d/f{i}": (src / "d" / f"f{i}").read_bytes()
                              for i in range(6)}


def test_server_on_card(cuda, tmp_path):
    """A port ``Server`` on the card against one on the CPU: an agent
    bootstrapped and connected over mTLS, a backup fired by a scheduler
    tick, a second over the job socket after a change, then prune and
    GC.  The chunk and snapshot files and the index verdicts on every
    digest after the sweep are equal (the index headers' uuid and time
    and the snapshot time pinned), and K1, K2 and K3 launch under the
    server on the card."""
    import asyncio
    import datetime as dt
    import os
    import time

    from pbs_plus_tpu_torch.agent.lifecycle import AgentConfig, AgentLifecycle
    from pbs_plus_tpu_torch.agent.snapshots import SnapshotManager
    from pbs_plus_tpu_torch.arpc import TlsClientConfig
    from pbs_plus_tpu_torch.pxar import backupproxy
    from pbs_plus_tpu_torch.server import database
    from pbs_plus_tpu_torch.server.jobrpc import call_job_rpc
    from pbs_plus_tpu_torch.server.metrics import MetricsRegistry
    from pbs_plus_tpu_torch.server.store import Server, ServerConfig
    from pbs_plus_tpu_torch.utils import mtls

    src = tmp_path / "src"
    os.makedirs(src / "d")

    def put(name, data, t):
        """Write a file, its mtime and its directory's pinned, so both
        servers' metadata archives match."""
        (src / "d" / name).write_bytes(data.tobytes())
        for p in (src / "d" / name, src / "d"):
            os.utime(p, ns=(t * 10**9, t * 10**9))
    for i in range(5):
        put(f"f{i}", _bytes(2000 + 30_000 * i, 80 + i), 1_600_000_000)

    async def run(dev):
        base = tmp_path / dev
        server = Server(ServerConfig(
            state_dir=str(base / "state"), cert_dir=str(base / "certs"),
            datastore_dir=str(base / "ds"), chunk_avg=4096,
            dedup_index_mb=1, prune_keep_last=1), device=dev)
        await server.start()
        tid, secret = server.issue_bootstrap_token()
        key = mtls.generate_private_key()
        cert = server.bootstrap_agent("h", mtls.make_csr(key, "h"), tid,
                                      secret)
        (base / "h.pem").write_bytes(cert)
        (base / "h.key").write_bytes(mtls.key_pem(key))
        agent = AgentLifecycle(AgentConfig(
            "h", "127.0.0.1", server.config.arpc_port,
            TlsClientConfig(str(base / "h.pem"), str(base / "h.key"),
                            server.certs.ca_cert_path),
            drive_update_interval_s=0),
            snapshot_manager=SnapshotManager(prefer_direct=True))
        task = asyncio.ensure_future(agent.run())
        try:
            await server.agents.wait_session("h", timeout=10)
            server.db.upsert_backup_job(database.BackupJobRow(
                id="j", target="h", source_path=str(src), backup_id="h",
                schedule="02:00", chunker="cuda"))
            await server.scheduler.tick(dt.datetime(2026, 7, 29, 2, 0, 10))
            await server.job_queue.drain(timeout=120)
            put("f4", _bytes(70_000, 99), 1_600_000_100)
            sock = str(base / "state" / "job.sock")
            await call_job_rpc(sock, {"op": "backup_queue", "job_id": "j"})
            await server.job_queue.drain(timeout=120)
            status = await call_job_rpc(sock, {"op": "status",
                                               "job_id": "j"})
            before = sorted(server.datastore.datastore.chunks.iter_digests())
            rep = await server.run_prune(gc_grace_s=0.0)
            verdicts = server.datastore.datastore.chunks.index.probe_batch(
                before)
            text = MetricsRegistry(server).render()
        finally:
            await agent.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await server.stop()
        files = {}
        for dp, _dn, fn in os.walk(base / "ds"):
            for f in fn:
                if f.endswith(("idx", "didx")) or len(f) == 64:
                    files[os.path.relpath(os.path.join(dp, f), base)] = \
                        open(os.path.join(dp, f), "rb").read()
        return status, (rep.removed, rep.chunks_removed), verdicts, files, \
            text

    class Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def time():
            return 1_700_000_000.0

    got = {}
    mp = pytest.MonkeyPatch()
    real = os.urandom
    mp.setattr(os, "urandom", lambda n: b"\x5a" * n if n == 16 else real(n))
    mp.setattr(time, "time_ns", lambda: 1_700_000_000 * 10**9)
    mp.setattr(backupproxy, "time", Clock())
    try:
        for dev in ("cpu", "cuda"):
            put("f4", _bytes(2000 + 30_000 * 4, 84), 1_600_000_000)
            before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                      cuckoo.stats["device_probes"])
            got[dev] = asyncio.run(run(dev))
            after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                     cuckoo.stats["device_probes"])
            if dev == "cuda":
                assert all(a > b for a, b in zip(after, before))
    finally:
        mp.undo()
    for dev in ("cpu", "cuda"):
        status, (removed, swept), verdicts, _files, text = got[dev]
        assert status["job"]["last_status"] == "success"
        assert len(removed) == 1 and swept >= 1
        assert not all(verdicts) and any(verdicts)
        assert 'pbs_plus_job_grant_to_publish_seconds_count{kind="backup"}' \
            in text
    assert got["cuda"][:4] == got["cpu"][:4]


def test_web_on_card(cuda, tmp_path):
    """The ``server`` command on the card and an ``agent`` process (its
    jobs in ``agent-job`` children): one small backup and one restore
    over the HTTP API; the restored tree equals the source, and the
    server's ``/plus/metrics`` counts K1, K2 and K3 launches."""
    import asyncio
    import os
    import re
    import subprocess
    import sys

    import aiohttp

    from test_torch_web import REPO, _lines_until, _tree, _wait

    src = tmp_path / "src"
    os.makedirs(src / "d")
    for i in range(4):
        (src / "d" / f"f{i}").write_bytes(
            _bytes(5000 + 700_000 * i, 90 + i).tobytes())
    os.symlink("d/f0", src / "link")
    env = dict(os.environ, PYTHONPATH=REPO)
    # stderr to files: an unread pipe would stall a process that logs
    logs = {n: tmp_path / f"{n}.stderr" for n in ("server", "agent")}
    with open(logs["server"], "w") as err:
        server = subprocess.Popen(
            [sys.executable, "-m", "pbs_plus_tpu_torch", "server",
             "--datastore", str(tmp_path / "ds"), "--state-dir",
             str(tmp_path / "st"), "--cert-dir", str(tmp_path / "ct"),
             "--host", "127.0.0.1", "--arpc-port", "0", "--web-port", "0",
             "--chunk-avg", str(64 << 10), "--print-token", "--device",
             "cuda"], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
            text=True)
    agent = None
    try:
        lines = _lines_until(server, lambda s: s.startswith("api token"), 300)
        arpc, web = re.search(r"aRPC :(\d+), web :(\d+)", lines[0]).groups()
        with open(logs["agent"], "w") as err:
            agent = subprocess.Popen(
                [sys.executable, "-m", "pbs_plus_tpu_torch", "agent",
                 "--hostname", "h0", "--server", f"127.0.0.1:{arpc}",
                 "--state-dir", str(tmp_path / "agent"), "--bootstrap-url",
                 f"http://127.0.0.1:{web}", "--bootstrap-token",
                 lines[1].split()[-1], "--snapshots", "direct"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        _lines_until(agent, lambda s: s.startswith("bootstrapped"), 120)
        base = f"http://127.0.0.1:{web}"
        auth = {"Authorization": f"Bearer {lines[2].split()[-1]}"}
        dest = str(tmp_path / "restored")

        async def main():
            async with aiohttp.ClientSession(headers=auth) as http:
                async def call(method, path, body=None):
                    async with http.request(method, base + path,
                                            json=body) as r:
                        assert r.status == 200, await r.text()
                        if r.content_type == "application/json":
                            return await r.json()
                        return await r.text()
                api = "/api2/json/d2d"
                await call("POST", f"{api}/target", {"name": "h0"})

                async def connected():
                    return (await call("GET", f"{api}/target"))[
                        "data"][0]["connected"]
                await _wait(connected, "control session", 60)
                await call("POST", f"{api}/backup", {
                    "id": "j", "target": "h0", "source_path": str(src)})
                await call("POST", f"{api}/backup/j/run")

                async def backed_up():
                    t = (await call("GET", f"{api}/tasks?job=j"))["data"]
                    return t and t[0]["status"] != "running" and t[0]
                task = await _wait(backed_up, "backup", 300)
                assert task["status"] == "success", task
                snap = (await call("GET", f"{api}/snapshots"))[
                    "data"][0]["snapshot"]
                rid = (await call("POST", f"{api}/restore", {
                    "target": "h0", "snapshot": snap,
                    "destination": dest}))["restore_id"]

                async def restored():
                    r = (await call("GET", f"{api}/restore/{rid}"))["data"]
                    return r["status"] in ("success", "error") and r
                assert (await _wait(restored, "restore", 300))[
                    "status"] == "success"
                return await call("GET", "/plus/metrics")
        metrics = asyncio.run(main())
    finally:
        for proc in (agent, server):
            if proc is not None:
                proc.terminate()
        for proc in (agent, server):
            if proc is not None:
                proc.wait(timeout=60)
    assert _tree(dest) == _tree(str(src))
    launches = dict(re.findall(
        r'pbs_plus_device_kernel_launches_total\{kernel="(\w+)"\} (\S+)',
        metrics))
    assert set(launches) == {"candidate_mask", "sha256_chunks",
                             "cuckoo_probe"}
    assert all(float(v) > 0 for v in launches.values()), launches


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_sync_on_card_equals_cpu(cuda, tmp_path, pbs):
    """A store synced into a destination on the card and one on the CPU:
    the same files, the same stats bar the seconds, and K3 launched at the
    card's destination for every membership batch."""
    import io
    import os
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
    from pbs_plus_tpu_torch.pxar.syncwire import (LocalSyncDest,
                                                  LocalSyncSource, run_sync)
    src = LocalStore(str(tmp_path / "src"), TEST_PARAMS, pbs_format=pbs,
                     dedup_index_mb=1, device=cuda)
    for t, seed in ((1, 1), (2, 2)):
        sess = src.start_session(backup_type="host", backup_id="a",
                                 backup_time=1_700_000_000 + t)
        sess.writer.write_entry(Entry(path="", kind=KIND_DIR))
        sess.writer.write_entry_reader(
            Entry(path="f", kind=KIND_FILE),
            io.BytesIO(_bytes(300_000, seed).tobytes()))
        sess.finish()

    def files(base):
        out = {}
        for dp, _dn, fn in os.walk(base):
            for f in fn:
                p = os.path.join(dp, f)
                if not os.path.relpath(p, base).startswith(
                        (".chunkindex", ".sync")):
                    out[os.path.relpath(p, base)] = open(p, "rb").read()
        return out
    got = {}
    for dev in ("cpu", cuda):
        dst = Datastore(str(tmp_path / str(dev)), pbs_format=pbs, device=dev)
        cuckoo.stats["device_probes"] = 0
        stats = run_sync(LocalSyncSource(src.datastore), LocalSyncDest(dst))
        stats.pop("wall_s")
        got[str(dev)] = (stats, files(dst.base), cuckoo.stats["device_probes"])
    (s_cpu, f_cpu, _), (s_card, f_card, k3) = got["cpu"], got[str(cuda)]
    assert s_card == s_cpu and f_card == f_cpu
    assert s_card["snapshots_synced"] == 2 and k3 >= s_card["probe_batches"]


def test_cpu_and_sidecar_kinds_on_card(cuda, tmp_path):
    """A store on the card fed by the ``"cpu"`` kind launches no kernel:
    the chunker is the host's, hashlib digests inline and each chunk is
    inserted through the index's host mirror, as the reference's inline
    path does; the ``sidecar:`` kind against a port sidecar on the card
    cuts with its K1 and K2; both give the cuts of the ``"cuda"`` kind,
    which launches K1, K2 and K3."""
    import io
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry
    from pbs_plus_tpu_torch.server.backup_job import (make_batch_hasher,
                                                      make_chunker_factory)
    from pbs_plus_tpu_torch.sidecar import serve_sidecar
    server, port, _svc = serve_sidecar("127.0.0.1:0", params=TEST_PARAMS,
                                       device=cuda)
    data = _bytes(1 << 20, 9).tobytes()
    out = {}
    try:
        for kind in ("cpu", f"sidecar:127.0.0.1:{port}", "cuda"):
            store = LocalStore(str(tmp_path / kind.split(":")[0]), TEST_PARAMS,
                               chunker_factory=make_chunker_factory(
                                   kind, device=cuda),
                               batch_hasher=make_batch_hasher(kind,
                                                              device=cuda),
                               dedup_index_mb=1, device=cuda)
            before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                      cuckoo.stats["device_probes"])
            sess = store.start_session(backup_type="host", backup_id="k")
            sess.writer.write_entry(Entry(path="", kind=KIND_DIR))
            sess.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE),
                                           io.BytesIO(data))
            sess.finish()
            after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                     cuckoo.stats["device_probes"])
            rd = store.open_snapshot(store.datastore.list_snapshots()[0])
            assert rd.read_file(rd.lookup("f")) == data
            out[kind.split(":")[0]] = (list(rd.payload_index.records()),
                                       [a - b for a, b in zip(after, before)])
    finally:
        server.stop(grace=None)
    assert out["cpu"][0] == out["sidecar"][0] == out["cuda"][0]
    assert out["cpu"][1] == [0, 0, 0]
    assert out["sidecar"][1][0] > 0 and out["sidecar"][1][1] > 0
    assert all(out["cuda"][1])


@pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])
def test_tape_conversion_on_card_equals_cpu(cuda, tmp_path, monkeypatch, pbs):
    """An MTF medium converted into a LocalStore on the card (K1 cuts, K2
    digests, K3 probes) and into one on the CPU: chunk and index files
    byte for byte equal (the index header's uuid and time pinned), equal
    results, and the three kernels launched on the card."""
    import io
    import os
    import time

    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.tapeio import (convert_mtf_to_snapshot,
                                           write_synthetic_mtf)
    monkeypatch.setattr(os, "urandom", lambda n: b"\x5a" * n)
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000 * 10**9)
    tree = {"vol/empty": None}
    for i in range(6):
        tree[f"vol/d{i % 2}/f{i}"] = _bytes(1000 + 170_000 * i, 40 + i).tobytes()
    buf = io.BytesIO()
    write_synthetic_mtf(buf, tree)
    got = {}
    for dev in ("cpu", "cuda"):
        ls = LocalStore(str(tmp_path / dev), TEST_PARAMS, pbs_format=pbs,
                        dedup_index_mb=1, device=dev)
        before = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                  cuckoo.stats["device_probes"])
        sess = ls.start_session(backup_type="host", backup_id="tape",
                                backup_time=1_700_000_000)
        buf.seek(0)
        res = convert_mtf_to_snapshot(buf, sess, spool_cap=256 << 10)
        man = sess.finish()
        after = (rolling_hash.KERNEL.launches, sha256.KERNEL.launches,
                 cuckoo.stats["device_probes"])
        if dev == "cuda":
            assert all(a > b for a, b in zip(after, before))
        files = {}
        for dp, _dn, fn in os.walk(ls.datastore.base):
            for f in fn:
                p = os.path.join(dp, f)
                rel = os.path.relpath(p, ls.datastore.base)
                if rel.startswith(".chunks") or rel.endswith(
                        ("idx", ".didx")):
                    files[rel] = open(p, "rb").read()
        man.pop("created_unix")
        r = vars(res)
        r.pop("seconds")
        got[dev] = (files, man["stats"], r)
    assert got["cpu"] == got["cuda"]
    assert got["cuda"][2]["files"] == 6 and not got["cuda"][2]["errors"]
