"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
the card, run ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port does not
need).  The kernels build into ``build/torch_kernels/`` at first use.
Tolerance is exact: every value is an integer.
"""

import hashlib

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
