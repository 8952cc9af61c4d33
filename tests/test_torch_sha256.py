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
