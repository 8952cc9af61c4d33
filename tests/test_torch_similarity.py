"""The port's similarity ops and SimilarityModel on the CPU against the JAX
package's: simhash, minhash, Hamming matrices and content sketches.

Tolerance is exact against the numpy twins and the JAX package, with one
stated exception: the JAX device simhash decides signs in float32, the
port (like the numpy twin) in float64, so a sign may differ where a score
lies within float32 rounding of 0; every such flip must sit at a score
whose absolute value is below 1e-4."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbs_plus_tpu.models.similarity import SimilarityModel as RefModel
from pbs_plus_tpu.ops import similarity as R
from pbs_plus_tpu_torch.models import SimilarityModel
from pbs_plus_tpu_torch.ops import similarity as S

FLIP_SCORE_LIMIT = 1e-4


def _digests(n, tag):
    return np.frombuffer(b"".join(
        hashlib.sha256(bytes([i & 0xFF, i >> 8, tag])).digest()
        for i in range(n)), np.uint8).reshape(-1, 32)


def _words(t):
    return t.cpu().numpy().astype(np.uint32)


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_projection_file_is_the_reference_projection(k):
    want = np.asarray(R.simhash_projection(k))
    got = S.simhash_projection(k)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_unshipped_projection_asks_for_proj():
    with pytest.raises(ValueError, match="proj="):
        S.simhash_projection(96)
    with pytest.raises(ValueError, match="proj="):
        S.simhash_projection(64, seed=7)
    proj = np.asarray(R.simhash_projection(96))
    digs = _digests(40, 3)
    assert np.array_equal(
        _words(S.simhash_sketch(digs, k=96, proj=proj, device="cpu")),
        S.simhash_sketch_host(digs, k=96, proj=proj))


def _flip_scores(digs, k, ref, got):
    """|float64 score| at every bit where ``ref`` and ``got`` differ."""
    diff = np.unpackbits((ref ^ got).astype(">u4").view(np.uint8), axis=-1)
    diff = diff.reshape(len(digs), -1).astype(bool)
    bits = np.unpackbits(digs, axis=-1).astype(np.float64) * 2 - 1
    scores = bits @ S.simhash_projection(k).astype(np.float64)
    return np.abs(scores[diff])


@pytest.mark.parametrize("k", [32, 64, 128, 256])
def test_simhash_matches_host_and_reference(k):
    rng = np.random.default_rng(k)
    for digs in (_digests(300, 11),
                 rng.integers(0, 256, (4000, 32), dtype=np.uint8)):
        got = _words(S.simhash_sketch(digs, k=k, device="cpu"))
        assert got.shape == (len(digs), k // 32)
        assert np.array_equal(got, S.simhash_sketch_host(digs, k=k))
        assert np.array_equal(got, R.simhash_sketch_host(digs, k=k))
        ref = np.asarray(R.simhash_sketch(digs, k=k))
        assert (_flip_scores(digs, k, ref, got) < FLIP_SCORE_LIMIT).all()
    # the fixed corpus of the JAX package's own parity test has no flip
    digs = _digests(300, 11)
    assert np.array_equal(_words(S.simhash_sketch(digs, k=k, device="cpu")),
                          np.asarray(R.simhash_sketch(digs, k=k)))


def test_pairwise_hamming_matches_reference(monkeypatch):
    digs = _digests(300, 11)
    sk = S.simhash_sketch_host(digs, k=128)
    want = np.asarray(R.pairwise_hamming(jnp.asarray(sk), jnp.asarray(sk[:70])))
    assert np.array_equal(want, S.pairwise_hamming_host(sk, sk[:70]))
    for block in (S.BLOCK_ELEMS, 1000):     # one block, then row blocks
        monkeypatch.setattr(S, "BLOCK_ELEMS", block)
        got = S.pairwise_hamming(sk, sk[:70], device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    # int32 bit patterns give the same matrix
    as_i32 = torch.from_numpy(sk.view(np.int32))
    assert np.array_equal(S.pairwise_hamming(as_i32, as_i32[:70]).numpy(), want)


@pytest.mark.parametrize("k", [64, 128, 256])
def test_minhash_matches_reference(k, monkeypatch):
    digs = _digests(500, 12)
    want = R.minhash_signature(digs, k=k)
    assert np.array_equal(S.minhash_signature_host(digs, k=k), want)
    got = S.minhash_signature(digs, k=k, device="cpu")
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    monkeypatch.setattr(S, "BLOCK_ELEMS", 37 * k)   # row blocks of 37
    assert np.array_equal(S.minhash_signature(digs, k=k, device="cpu"), want)


def test_minhash_similarity_estimates_jaccard():
    base = _digests(2000, 9)
    half = _digests(1000, 10)
    sig_a = S.minhash_signature(base, k=256, device="cpu")
    sig_b = S.minhash_signature(np.concatenate([base[:1000], half]), k=256,
                                device="cpu")
    assert S.minhash_similarity(sig_a, sig_b) == \
        R.minhash_similarity(sig_a, sig_b)
    assert abs(S.minhash_similarity(sig_a, sig_b) - 1 / 3) < 0.12


def test_content_sketch_matches_reference(monkeypatch):
    rng = np.random.default_rng(13)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (1, 3, 4, 7, 64, 1000, 16 << 10, 64 << 10)]
    # no sampled window, a run of one repeated window, and empty
    chunks += [bytes(5000), b"\xff" * 300, b""]
    want = R.content_sketch_device(chunks)
    assert np.array_equal(want, R.content_sketch_host(chunks))
    assert np.array_equal(S.content_sketch_host(chunks), want)
    for cap in (S.GROUP_ELEMS, 70_000):      # one group, then several
        monkeypatch.setattr(S, "GROUP_ELEMS", cap)
        got = S.content_sketch_device(chunks, device="cpu")
        assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert S.content_sketch_device([], device="cpu").shape == (0,)
    assert S.sketch_hamming(want[0], want[1]) == R.sketch_hamming(want[0], want[1])


def test_similarity_model_matches_reference():
    ref, port = RefModel(minhash_k=256), SimilarityModel(minhash_k=256,
                                                          device="cpu")
    a = [hashlib.sha256(bytes([i & 0xFF, i >> 8, 1])).digest() for i in range(1500)]
    b = a[:750] + [hashlib.sha256(bytes([i & 0xFF, i >> 8, 2])).digest()
                   for i in range(750)]
    c = [hashlib.sha256(bytes([i & 0xFF, i >> 8, 3])).digest() for i in range(1500)]
    sigs = [port.snapshot_signature(x) for x in (a, b, c)]
    for s, x in zip(sigs, (a, b, c)):
        assert np.array_equal(s, ref.snapshot_signature(x))
    got = port.best_previous(sigs[0], {"b": sigs[1], "c": sigs[2]})
    assert got == ref.best_previous(sigs[0], {"b": sigs[1], "c": sigs[2]})
    assert got[0] == "b" and got[1] > 0.2
    sk = port.chunk_sketches(a[:64])
    assert sk.dtype == np.uint32 and np.array_equal(sk, ref.chunk_sketches(a[:64]))
    for dist in (0, 20):
        pairs = port.near_duplicates(sk, sk, max_distance=dist)
        assert pairs == ref.near_duplicates(sk, sk, max_distance=dist)
    assert {(i, i) for i in range(64)} <= {(i, j) for i, j, _ in pairs}
