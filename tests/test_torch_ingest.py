"""The port's fused ragged ingest on the CPU against the JAX package's
``ops/ingest.py``: packing, the one-launch scan (plain K1 here) against
``scan_rows_host`` and ``scan_rows_device``, and the digest stage against
hashlib.  Tolerance is exact."""

import hashlib

import numpy as np
import pytest

from pbs_plus_tpu.chunker.spec import TEST_PARAMS as REF_TEST_PARAMS
from pbs_plus_tpu.ops import ingest as R
from pbs_plus_tpu_torch.chunker.spec import TEST_PARAMS
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.ops import ingest as I
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError


def _rows(seed, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [int(rng.integers(100, 20_000)) for _ in range(6)]
    rows, tails, hists, bases = [], [], [], []
    for n in sizes:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        histn = int(rng.integers(0, 200))
        hist = rng.integers(0, 256, histn, dtype=np.uint8).tobytes()
        cut = int(rng.integers(0, n + 1))          # blocks split the row
        rows.append([data[:cut], data[cut:]])
        tails.append(hist[-63:])
        hists.append(min(histn, 63))
        bases.append(histn)
    return rows, tails, hists, bases


def test_pack_rows_matches_reference():
    args = _rows(11)
    got, want = I.pack_rows(*args), R.pack_rows(*args)
    assert I.HALO == R.HALO == 63
    for name in ("buf", "starts", "lens", "hist_lens", "bases"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.padding_bytes == want.padding_bytes
    with pytest.raises(ValueError):
        I.pack_rows([[b""]], [b""], [0], [0])


def test_scan_rows_matches_host_and_device_twins():
    assert TEST_PARAMS == params_from_reference(
        REF_TEST_PARAMS.avg_size, REF_TEST_PARAMS.min_size,
        REF_TEST_PARAMS.max_size, REF_TEST_PARAMS.seed)
    batch = I.pack_rows(*_rows(12))
    ref_batch = R.pack_rows(*_rows(12))
    before = dict(I.stats)
    got = I.scan_rows(batch, TEST_PARAMS, device="cpu")
    assert I.stats["scan_dispatches"] == before["scan_dispatches"] + 1
    host = R.scan_rows_host(ref_batch, REF_TEST_PARAMS)
    dev = R.scan_rows_device(ref_batch, REF_TEST_PARAMS)
    assert len(got) == len(host) == len(dev) == 6
    assert sum(len(g) for g in got) > 0
    for g, h, d in zip(got, host, dev):
        assert g.dtype == np.int64
        assert np.array_equal(g, h) and np.array_equal(g, d)


def test_padding_rows_never_leak():
    """Rows shorter than a window and rows with zero history: candidates
    in halo slots and short-history prefixes never surface."""
    sizes = (10, 63, 64, 200, 5000)
    rng = np.random.default_rng(14)
    rows = [[rng.integers(0, 256, n, dtype=np.uint8).tobytes()] for n in sizes]
    args = (rows, [b""] * 5, [0] * 5, [0] * 5)
    got = I.scan_rows(I.pack_rows(*args), TEST_PARAMS, device="cpu")
    want = R.scan_rows_host(R.pack_rows(*args), REF_TEST_PARAMS)
    for n, g, w in zip(sizes, got, want):
        assert np.array_equal(g, w)
        assert all(63 < e <= n for e in g.tolist())


def test_digest_chunks_match_hashlib():
    rng = np.random.default_rng(13)
    chunks = [rng.integers(0, 256, int(rng.integers(1, 3000)),
                           dtype=np.uint8).tobytes() for _ in range(12)]
    chunks.append(b"")
    before = I.stats["sha_dispatches"]
    got = I.digest_chunks([bytearray(c) for c in chunks], device="cpu")
    assert I.stats["sha_dispatches"] == before + 1
    assert got == [hashlib.sha256(c).digest() for c in chunks] == \
        R.digest_chunks_host(chunks)


def test_ingest_entry_points_raise_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        I.scan_rows(I.pack_rows(*_rows(1, [100])), TEST_PARAMS)
    with pytest.raises(CudaUnavailableError):
        I.digest_chunks([b"abc"])
