"""The port's SHA-256 (K2, plain PyTorch version on the CPU) against the JAX
package's ``sha256_chunks`` and hashlib.  Sizes stay at or below 4096 bytes
so the plain version's per-block loop stays short; tolerance is exact."""

import hashlib

import numpy as np
import pytest
import torch

from pbs_plus_tpu.ops import sha256 as ref
from pbs_plus_tpu_torch.ops import sha256 as port

SIZES = [0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 4096]


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def test_sha256_chunks_match_reference_and_hashlib():
    chunks = [_bytes(n, n + 1) for n in SIZES]
    got = port.sha256_chunks(chunks, device="cpu")
    assert got == [hashlib.sha256(c).digest() for c in chunks]
    assert got == ref.sha256_chunks(chunks)


def test_sha256_stream_bounds_unaligned():
    data = _bytes(12_000, 5)
    bounds, off = [], 3
    for n in (4096, 1, 0, 777, 4000, 55):
        bounds.append((off, off + n))
        off += n
    got = port.sha256_stream_chunks(data, bounds, device="cpu")
    assert got == [hashlib.sha256(data[s:e]).digest() for s, e in bounds]
    # a tensor stream is used where it lies, and max_batch splits launches
    assert port.sha256_stream_chunks(torch.frombuffer(bytearray(data),
                                                      dtype=torch.uint8),
                                     bounds, max_batch=2) == got


def test_sha256_streams_chunks_concatenates():
    streams = [_bytes(5000, 1), b"", _bytes(3000, 2)]
    bounds = [[(0, 2500), (2500, 5000)], [], [(10, 3000)]]
    got = port.sha256_streams_chunks(streams, bounds, device="cpu")
    assert got == [[hashlib.sha256(s[a:b]).digest() for a, b in bs]
                   for s, bs in zip(streams, bounds)]


@pytest.mark.parametrize("bounds", [[(0, 1 << 30)], [(0, -1)]])
def test_sha256_rejects_oversized(bounds):
    with pytest.raises(ValueError, match="chunk length"):
        port.sha256_stream_chunks(b"x", bounds, device="cpu")
    with pytest.raises(ValueError):
        ref.sha256_stream_chunks(b"x", bounds)


def test_sha256_rejects_bounds_outside_stream():
    with pytest.raises(ValueError, match="outside the stream"):
        port.sha256_stream_chunks(b"abc", [(1, 5)], device="cpu")


def _plan_case(seed, n=200, max_len=300):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n)
    starts = rng.integers(0, 64, n) + np.concatenate(
        [[0], np.cumsum(lens)[:-1]])            # unaligned, may overlap
    data = rng.integers(0, 256, int((starts + lens).max()) + 1,
                        dtype=np.uint8).tobytes()
    return data, starts, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_launch_plan_order_inverse_and_blocks(seed):
    _, _, lens = _plan_case(seed)
    lens[::7] = lens[3]                          # ties keep input order
    t = torch.from_numpy(lens)
    order, inv, blocks = port.launch_plan(t)
    o = order.numpy()
    assert sorted(o) == list(range(len(lens)))
    assert np.all(np.diff(lens[o]) <= 0)         # longest first
    ties = lens[o][1:] == lens[o][:-1]
    assert np.all(o[1:][ties] > o[:-1][ties])    # stable
    assert np.array_equal(t[order][inv].numpy(), lens)
    # the block count _sha256_scan_impl computes inline
    # (pbs_plus_tpu/ops/sha256.py, nblocks = (L + 8) // 64 + 1): the data,
    # the 0x80 byte and the 8-byte bit length fit, with under 64 bytes spare
    assert np.array_equal(blocks.numpy(), (lens + 8) // 64 + 1)
    spare = 64 * blocks.numpy() - lens - 9
    assert spare.min() >= 0 and spare.max() < 64


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_through_launch_plan_matches_hashlib_and_reference(seed):
    data, starts, lens = _plan_case(seed, n=60)
    stream = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    s, n = torch.from_numpy(starts), torch.from_numpy(lens)
    order, inv, _ = port.launch_plan(n)
    words = port.sha256_words_plain(stream, s[order], n[order])[inv]
    got = [w.astype(">u4").tobytes()
           for w in words.numpy().astype(np.uint32)]
    bounds = [(int(a), int(a + b)) for a, b in zip(starts, lens)]
    assert got == [hashlib.sha256(data[a:b]).digest() for a, b in bounds]
    assert got == ref.sha256_stream_chunks(data, bounds)
