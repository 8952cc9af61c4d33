"""The port's multi-device layer on the CPU against the JAX package's on
8 virtual CPU devices (tests/conftest.py): meshes, the halo and sum
collectives, sequence-parallel chunking, the index-sharded cuckoo probe,
the full sharded step, the data-axis fan-in of the batched K1/K2
dispatches, and the dry run.  The port's meshes repeat ``cpu`` and run
the plain versions.

Tolerance is exact (cuts, masks, verdicts, counts, mirrors, digests),
with one stated exception: the JAX step decides simhash signs in
float32, the port in float64, so a sign may differ where the float64
score lies within 1e-4 of 0 (the rule of test_torch_similarity.py)."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from pbs_plus_tpu import parallel as R
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.chunker import chunk_bounds
from pbs_plus_tpu.ops import rolling_hash as ref_rh
from pbs_plus_tpu.ops import sha256 as ref_sha
from pbs_plus_tpu.ops.cuckoo import CuckooIndex as RefIndex
from pbs_plus_tpu_torch import parallel as T
from pbs_plus_tpu_torch.chunker.spec import WINDOW, ChunkerParams
from pbs_plus_tpu_torch.convert import (params_from_reference,
                                        sharded_index_from_reference)
from pbs_plus_tpu_torch.models import DedupConfig, DedupPipeline
from pbs_plus_tpu_torch.ops import rolling_hash, sha256, similarity
from pbs_plus_tpu_torch.ops.cuckoo import CuckooIndex
from pbs_plus_tpu_torch.parallel import collectives, dist_index, sharded_step
from pbs_plus_tpu_torch.parallel import mesh as mesh_mod
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError

REF_P = RefParams(avg_size=4 << 10)
P = params_from_reference(REF_P.avg_size, REF_P.min_size, REF_P.max_size,
                          REF_P.seed)
CPU8 = ["cpu"] * 8
FLIP_SCORE_LIMIT = 1e-4


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.fixture(scope="module")
def ref_mesh():
    return R.make_mesh(8)                # 4 data x 2 index


@pytest.fixture(scope="module")
def port_mesh():
    return T.make_mesh(devices=CPU8)


# -- meshes and collectives ---------------------------------------------------

@pytest.mark.parametrize("n, index_parallel, shape", [
    (8, None, {"data": 4, "index": 2}), (6, None, {"data": 3, "index": 2}),
    (5, None, {"data": 5, "index": 1}), (8, 4, {"data": 2, "index": 4}),
    (1, None, {"data": 1, "index": 1})])
def test_make_mesh_shape_rules_match_reference(n, index_parallel, shape):
    got = T.make_mesh(n, devices=CPU8, index_parallel=index_parallel)
    want = R.make_mesh(n, index_parallel=index_parallel)
    assert got.shape == dict(want.shape) == shape
    assert got.size == want.size == n
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_refuses_what_is_not_there():
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        T.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        T.make_seq_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="index_parallel"):
        T.make_mesh(8, devices=CPU8, index_parallel=3)
    seq = T.make_seq_mesh(devices=["cpu"] * 3, axis_name="s")
    assert seq.shape == {"s": 3} and seq.axis_devices("s") == [
        torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        for call in (T.make_mesh, T.make_seq_mesh, lambda: T.make_mesh(2),
                     lambda: T.make_mesh(devices=["cuda:0"])):
            with pytest.raises(CudaUnavailableError):
                call()
        assert mesh_mod.data_mesh() is None


def test_set_data_mesh_installs_and_restores():
    before = mesh_mod.data_mesh()
    m = T.make_seq_mesh(devices=["cpu"] * 4, axis_name="data")
    assert mesh_mod.set_data_mesh(m) is before
    try:
        assert mesh_mod.data_mesh() is m
        assert mesh_mod.dispatch_mesh(2, torch.device("cpu")) is m
        assert mesh_mod.dispatch_mesh(1, torch.device("cpu")) is None
    finally:
        assert mesh_mod.set_data_mesh(before) is m
    assert mesh_mod.data_mesh() is before


def test_halo_and_psum_collectives():
    shards = [torch.arange(i * 100, i * 100 + 100) for i in range(4)]
    halos = collectives.halo_from_left(shards, WINDOW - 1)
    assert torch.equal(halos[0], torch.zeros(WINDOW - 1, dtype=torch.int64))
    for i in range(1, 4):
        assert torch.equal(halos[i], shards[i - 1][-(WINDOW - 1):])
    halos[0] += 1                   # a fresh tensor: no shard is written
    assert shards[0][0] == 0
    with pytest.raises(ValueError, match="shorter"):
        collectives.halo_from_left([torch.zeros(62), torch.zeros(62)],
                                   WINDOW - 1)
    parts = [torch.tensor([1, 0, 2]), torch.tensor([0, 0, 3])]
    got = collectives.psum(parts, torch.device("cpu"))
    assert got.tolist() == [1, 0, 5]
    got += 1
    assert parts[0].tolist() == [1, 0, 2]
    with pytest.raises(ValueError, match="split"):
        collectives.scatter_rows(torch.zeros(5, 2), [torch.device("cpu")] * 2)


# -- sequence-parallel chunking ----------------------------------------------

@pytest.mark.parametrize("n", [300_000, 300_001])     # 300,001 is padded
def test_sp_chunker_matches_reference_and_one_device(n):
    data = _bytes(n, 1).tobytes()
    ref_mesh, port_mesh = R.make_seq_mesh(8), T.make_seq_mesh(devices=CPU8)
    cuts = T.sp_chunk_stream(port_mesh, data, P)
    assert cuts == R.sp_chunk_stream(ref_mesh, data, REF_P)
    assert cuts == [e for _, e in chunk_bounds(data, REF_P)]
    assert cuts == rolling_hash.chunk_stream_device(data, P, device="cpu")
    # the masks, bit for bit, on the padded stream
    padded = np.zeros(n + (-n) % 8, np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    ref_mask = np.asarray(R.sp_candidate_mask(
        ref_mesh, jax.device_put(jnp.asarray(padded),
                                 NamedSharding(ref_mesh, PartitionSpec("seq"))),
        REF_P))
    parts = T.sp_candidate_mask(port_mesh, torch.from_numpy(padded), P)
    assert len(parts) == 8
    assert np.array_equal(torch.cat(parts).numpy(), ref_mask)


def test_sp_chunker_refuses_short_shards_and_ragged_splits():
    mesh = T.make_seq_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="shorter"):
        T.sp_chunk_stream(mesh, _bytes(8 * 62, 2).tobytes(), P)
    with pytest.raises(ValueError, match="pad"):
        T.sp_candidate_mask(mesh, torch.zeros(8 * 100 + 1, dtype=torch.uint8), P)
    # a shard of exactly the halo's length is enough
    data = _bytes(8 * 63, 3).tobytes()
    assert T.sp_chunk_stream(mesh, data, P) == \
        rolling_hash.chunk_stream_device(data, P, device="cpu")


# -- the index-sharded probe --------------------------------------------------

def _digests(tag, n=128):
    return [hashlib.sha256(bytes([i, tag])).digest() for i in range(n)]


@pytest.fixture(scope="module")
def sharded_pair(ref_mesh, port_mesh):
    present = _digests(1)
    ref = R.ShardedCuckooIndex(ref_mesh, n_buckets=1 << 12)
    port = T.ShardedCuckooIndex(port_mesh, n_buckets=1 << 12)
    assert ref.insert_many(present) == port.insert_many(present) == 128
    return ref, port, present


def test_sharded_index_mirror_and_verdicts_match_reference(sharded_pair):
    ref, port, present = sharded_pair
    absent = _digests(2)
    assert port.inner._table.tobytes() == ref.inner._table.tobytes()
    assert len(port) == len(ref) == 128
    arr = np.frombuffer(b"".join(present + absent), np.uint8).reshape(-1, 32)
    got = port.probe(arr).numpy()
    assert np.array_equal(got, np.asarray(ref.probe(arr)))
    assert got[:128].all() and got[128:].sum() <= 1
    # a digest whose two buckets lie on different index shards
    w = arr[:128].view(">u4").astype(np.uint64)
    fp0 = np.where((w[:, 0] == 0) & (w[:, 1] == 0), 0x5A5A5A5A, w[:, 0])
    b1 = w[:, 2] & 4095
    b2 = b1 ^ ((fp0 * 0x9E3779B1) & 4095)
    assert ((b1 < 2048) != (b2 < 2048)).any()
    # one device table per mesh position, one row range per index shard
    tab = port.device_table()
    assert tab.shape == (4, 2) and tuple(tab[0, 1].shape) == (2048, 4)
    assert tab[3, 1] is tab[0, 1]       # a repeated device holds one copy


@pytest.mark.parametrize("n, data_axis", [(255, "data"), (3, "data"),
                                          (256, None)])
def test_sharded_probe_pads_and_replicates_like_reference(sharded_pair, n,
                                                          data_axis):
    ref, port, present = sharded_pair
    digs = (present + _digests(3))[128 - n // 2:128 - n // 2 + n]
    arr = np.frombuffer(b"".join(digs), np.uint8).reshape(-1, 32)
    got = port.probe(arr, data_axis=data_axis).numpy()
    assert got.shape == (n,)
    assert np.array_equal(got, np.asarray(ref.probe(arr, data_axis=data_axis)))
    assert port.probe(arr[:0]).shape == (0,)


def test_sharded_index_carries_across_and_follows_inserts(sharded_pair,
                                                          port_mesh):
    ref, port, present = sharded_pair
    absent = _digests(4)
    copy = sharded_index_from_reference(ref.inner._table, ref.inner._known,
                                        port_mesh, n_buckets=1 << 12)
    assert copy.inner._table.tobytes() == ref.inner._table.tobytes()
    assert copy.probe_confirmed(present[:3] + absent[:3]) == \
        ref.probe_confirmed(present[:3] + absent[:3]) == [True] * 3 + [False] * 3
    before = copy.device_table()
    assert copy.insert(absent[0]) and not copy.insert(absent[0])
    assert copy.device_table() is not before     # re-placed after a change
    assert copy.probe_confirmed(absent[:2]) == [True, False]
    assert copy.contains_exact(absent[0]) and len(copy) == 129
    with pytest.raises(ValueError, match="index-axis"):
        T.ShardedCuckooIndex(T.make_mesh(6, devices=CPU8, index_parallel=3),
                             n_buckets=1 << 12)


# -- the full sharded step ----------------------------------------------------

def _flip_scores(heads, ref, got):
    """|float64 simhash score| at every bit where ``ref`` and ``got``
    differ (k = 64)."""
    diff = np.unpackbits((ref ^ got).astype(">u4").view(np.uint8), axis=-1)
    diff = diff.reshape(len(heads), -1).astype(bool)
    bits = np.unpackbits(heads, axis=-1).astype(np.float64) * 2 - 1
    scores = bits @ similarity.simhash_projection(64).astype(np.float64)
    return np.abs(scores[diff])


@pytest.fixture(scope="module")
def steps(ref_mesh, port_mesh):
    ref_index = RefIndex(n_buckets=1 << 12)
    port_index = CuckooIndex(n_buckets=1 << 12, device="cpu")
    ref_step = R.multichip_dedup_step(ref_mesh, chunk_len=4096,
                                      n_buckets=1 << 12)
    port_step = T.multichip_dedup_step(port_mesh, chunk_len=4096,
                                       n_buckets=1 << 12)

    def run(insert_head0: bool):
        if insert_head0:
            ref_index.insert(d0)
            port_index.insert(d0)
        rs, rt, ri, rp, rhost = R.build_step_inputs(
            ref_mesh, batch=8, seg_len=1 << 14, params=REF_P, index=ref_index)
        ps, pt, pi, pp, phost = T.build_step_inputs(
            port_mesh, batch=8, seg_len=1 << 14, params=P, index=port_index)
        assert np.array_equal(rhost, phost)
        assert port_index._table.tobytes() == ref_index._table.tobytes()
        ref_out = ref_step(rs, rt, ri, rp, jnp.uint32(REF_P.mask),
                           jnp.uint32(REF_P.magic))
        port_out = port_step(ps, pt, pi, pp, P.mask, P.magic)
        return [np.asarray(x) for x in ref_out], \
            [x.numpy() for x in port_out], phost

    host = np.random.default_rng(0).integers(0, 256, (8, 1 << 14),
                                             dtype=np.uint8)
    d0 = hashlib.sha256(host[0, :4096].tobytes()).digest()
    return {"before": run(False), "after": run(True)}


@pytest.mark.parametrize("when", ["before", "after"])
def test_step_matches_reference(steps, when):
    (r_cand, r_hits, r_sk, r_total), (cand, hits, sk, total), host = steps[when]
    assert np.array_equal(cand, r_cand)
    assert np.array_equal(hits, r_hits)
    assert int(total) == int(r_total) == int(cand.sum())
    assert hits[0] == (when == "after") and not hits[1:].any()
    heads = np.frombuffer(b"".join(hashlib.sha256(r[:4096].tobytes()).digest()
                                   for r in host), np.uint8).reshape(-1, 32)
    assert np.array_equal(sk, similarity.simhash_sketch_host(heads))
    assert (_flip_scores(heads, r_sk.astype(np.uint32),
                         sk.astype(np.uint32)) < FLIP_SCORE_LIMIT).all()


def test_step_counts_match_one_device(steps):
    cand = steps["before"][1][0]
    host = steps["before"][2]
    tables = rolling_hash.device_tables(P, "cpu")
    want = rolling_hash.candidate_mask(torch.from_numpy(host), tables,
                                       P.mask, P.magic).sum(dim=1)
    assert np.array_equal(cand, want.numpy())


def test_step_over_one_device_equals_sharded(steps):
    one = T.make_mesh(devices=["cpu"])
    index = CuckooIndex(n_buckets=1 << 12, device="cpu")
    s, t, i, p, _ = T.build_step_inputs(one, batch=8, seg_len=1 << 14,
                                        params=P, index=index)
    out = T.multichip_dedup_step(one, chunk_len=4096, n_buckets=1 << 12)(
        s, t, i, p, P.mask, P.magic)
    for a, b in zip(out, steps["before"][1]):
        assert np.array_equal(a.numpy(), b)


def test_step_layers_alone_give_the_step_outputs(steps, port_mesh):
    """The layer functions the step calls, run one by one as the chip
    smoke times them, give the step's counts and hits and hashlib's
    head digests."""
    _, (cand, hits, _, _), host = steps["after"]
    index = CuckooIndex(n_buckets=1 << 12, device="cpu")
    index.insert(hashlib.sha256(host[0, :4096].tobytes()).digest())
    shards, tables, idx_tab, _, _ = T.build_step_inputs(
        port_mesh, batch=8, seg_len=1 << 14, params=P, index=index)
    counts = [sharded_step.mask_counts(s, tables, P.mask, P.magic)
              for s in shards]
    digs = [sharded_step.head_digests(s, 4096) for s in shards]
    got = [dist_index.probe_row(port_mesh, idx_tab, d, 1 << 12,
                                row={"data": i}) for i, d in enumerate(digs)]
    assert np.array_equal(torch.cat(counts).numpy(), cand)
    assert np.array_equal(torch.cat(got).numpy(), hits) and hits[0]
    assert b"".join(d.numpy().tobytes() for d in digs) == b"".join(
        hashlib.sha256(r[:4096].tobytes()).digest() for r in host)
    with pytest.raises(ValueError, match="chunk_len"):
        sharded_step.head_digests(shards[0], (1 << 14) + 1)


# -- the data-axis fan-in of the batched dispatches ---------------------------

@pytest.fixture
def fan_in():
    m = T.make_seq_mesh(devices=["cpu"] * 4, axis_name="data")
    before = mesh_mod.set_data_mesh(m)
    try:
        yield m
    finally:
        mesh_mod.set_data_mesh(before)


def _rows(n_rows):
    rng = np.random.default_rng(n_rows)
    bufs = [rng.integers(0, 256, int(L), dtype=np.uint8)
            for L in rng.integers(0, 40_000, n_rows)]
    hists = [rng.integers(0, 256, WINDOW - 1, dtype=np.uint8) if i % 2 else None
             for i in range(n_rows)]
    return bufs, hists


@pytest.mark.parametrize("n_rows", [1, 2, 5, 9])
def test_candidate_fan_in_matches_local_and_reference(fan_in, n_rows):
    bufs, hists = _rows(n_rows)
    tables = rolling_hash.device_tables(P, "cpu")
    before = dict(rolling_hash.stats)
    got = rolling_hash.batched_candidate_hits(bufs, hists, tables, P)
    sharded = n_rows >= 2
    assert rolling_hash.stats["mesh_dispatches"] == \
        before["mesh_dispatches"] + sharded
    if sharded:
        assert rolling_hash.stats["mesh_devices"] == 4
    mesh_mod.set_data_mesh(None)
    local = rolling_hash.batched_candidate_hits(bufs, hists, tables, P)
    want = ref_rh.batched_candidate_hits(bufs, hists,
                                         ref_rh.device_tables(REF_P), REF_P)
    assert len(got) == n_rows
    for g, lo, w in zip(got, local, want):
        assert np.array_equal(g, lo) and np.array_equal(g, w)


@pytest.mark.parametrize("n_chunks", [1, 3, 37])
def test_sha_fan_in_matches_local_hashlib_and_reference(fan_in, n_chunks):
    stream = _bytes(200_000, 9)
    rng = np.random.default_rng(n_chunks)
    starts = rng.integers(0, 190_000, n_chunks)
    # lengths of 5 to 15 blocks: two of the reference's block buckets
    bounds = [(int(s), int(s + L)) for s, L in
              zip(starts, rng.integers(300, 950, n_chunks))]
    before = sha256.stats["mesh_dispatches"]
    got = sha256.sha256_stream_chunks(stream, bounds, device="cpu",
                                      max_batch=16)
    batches = [min(16, n_chunks - lo) for lo in range(0, n_chunks, 16)]
    assert sha256.stats["mesh_dispatches"] == \
        before + sum(b >= 2 for b in batches)
    assert got == [hashlib.sha256(stream[s:e].tobytes()).digest()
                   for s, e in bounds]
    assert got == ref_sha.sha256_stream_chunks(stream, bounds)
    mesh_mod.set_data_mesh(None)
    assert got == sha256.sha256_stream_chunks(stream, bounds, device="cpu")


def test_pipeline_fans_out_with_no_change_of_its_own(fan_in):
    streams = {f"s{i}": _bytes(40_000 + 7 * i, 20 + i).tobytes()
               for i in range(3)}
    # 1 KiB average chunks: the plain SHA-256 steps once per block of the
    # longest chunk
    cfg = DedupConfig(params=ChunkerParams(avg_size=1 << 10),
                      segment_bytes=1 << 14, index_buckets=1 << 10)
    k1, k2 = rolling_hash.stats["mesh_dispatches"], \
        sha256.stats["mesh_dispatches"]
    got = DedupPipeline(cfg, device="cpu").fingerprint_streams(streams)
    assert rolling_hash.stats["mesh_dispatches"] > k1
    assert sha256.stats["mesh_dispatches"] > k2
    mesh_mod.set_data_mesh(None)
    assert got == DedupPipeline(cfg, device="cpu").fingerprint_streams(streams)


# -- the dry run --------------------------------------------------------------

def test_dryrun_multichip_on_cpu():
    out = T.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"data": 4, "index": 2}
    assert out["batch"] == 8 and out["hits"] == 1 and out["sp_cuts"] > 40
