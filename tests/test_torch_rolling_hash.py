"""The port's candidate mask (K1, plain PyTorch version on the CPU) against
the JAX package's jnp and Pallas (interpret mode) masks and the CPU
chunker.  Inputs come from a numpy seed; tolerance is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbs_plus_tpu.chunker import candidates
from pbs_plus_tpu.chunker.spec import ChunkerParams as RefParams
from pbs_plus_tpu.ops import rolling_hash as ref
from pbs_plus_tpu.ops.pallas_rolling_hash import candidate_mask_pallas
from pbs_plus_tpu_torch.chunker import observe
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.ops import rolling_hash as port
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError

REF_P = RefParams(avg_size=4 << 10)
P = params_from_reference(REF_P.avg_size, REF_P.min_size, REF_P.max_size,
                          REF_P.seed)


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_tables_match_reference_nibbles():
    a, b = (np.asarray(t) for t in ref.device_tables(REF_P))
    x = np.arange(256)
    want = (a[x >> 4] ^ b[x & 15]).astype(np.uint32)
    got = port.device_tables(P, "cpu").numpy().view(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("with_history", [False, True])
def test_candidate_mask_matches_jnp(with_history):
    data = np.stack([_bytes(70_001, 1), _bytes(70_001, 2)])
    hist = np.stack([_bytes(63, 3), _bytes(63, 4)]) if with_history else None
    want = np.asarray(ref.candidate_mask(
        jnp.asarray(data), ref.device_tables(REF_P), P.mask, P.magic,
        history=jnp.asarray(hist) if with_history else None))
    got = port.candidate_mask(
        torch.from_numpy(data), port.device_tables(P, "cpu"), P.mask,
        P.magic, history=torch.from_numpy(hist) if with_history else None)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert want.any()


def test_candidate_mask_matches_pallas_interpret():
    data = _bytes(50_000, 21)
    want = np.asarray(candidate_mask_pallas(jnp.asarray(data), REF_P,
                                            interpret=True))
    got = port.candidate_mask_params(torch.from_numpy(data), P)
    assert np.array_equal(got.numpy(), want)
    batch = np.stack([data[:40_000], _bytes(40_000, 22)])
    want_b = np.asarray(candidate_mask_pallas(jnp.asarray(batch), REF_P,
                                              interpret=True))
    got_b = port.candidate_mask_params(torch.from_numpy(batch), P)
    assert np.array_equal(got_b.numpy(), want_b)


def test_batched_candidate_hits_matches_reference():
    bufs = [_bytes(30_000, 5), _bytes(70_000, 6), _bytes(10, 7)]
    hists = [None, _bytes(63, 8), _bytes(63, 9)]
    want = ref.batched_candidate_hits(bufs, hists, ref.device_tables(REF_P),
                                      REF_P)
    observe.reset()
    got = port.batched_candidate_hits(bufs, hists,
                                      port.device_tables(P, "cpu"), P)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert observe.snapshot()["scan_bytes"] == {"torch-cpu": 100_010}


def test_candidate_ends_and_cuts_match_cpu_chunker():
    data = _bytes(300_000, 3).tobytes()
    want = candidates(data, REF_P, force_numpy=True)
    got = port.candidate_ends_host(data, P, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref.candidate_ends_host(data, REF_P))
    assert port.chunk_stream_device(data, P, device="cpu") == \
        ref.chunk_stream_device(data, REF_P)


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        port.candidate_ends_host(b"x" * 100, P)


SPAN = port.SPAN
RAGGED = [1, 62, 63, 64, SPAN - 1, SPAN, SPAN + 1, 3 * SPAN + 17]


def _blocks(S):
    """Position ranges [lo, hi) of the blocks along one row, as the kernel
    derives them from span_partition."""
    grid_x, spans = port.span_partition(S)
    n_spans = -(-S // SPAN)
    out = []
    for bx in range(grid_x):
        k0, k1 = bx * spans, min(bx * spans + spans, n_spans)
        out.append((k0 * SPAN, min(k1 * SPAN, S)))
    return out


@pytest.mark.parametrize("S", RAGGED + [16 * SPAN, 17 * SPAN + 5, 64 << 20])
@pytest.mark.parametrize("B", [1, 3, port.MAX_ROWS])
def test_span_partition_covers_every_position_once(S, B):
    blocks = _blocks(S)
    assert all(lo < hi for lo, hi in blocks)                # no empty block
    assert blocks[0][0] == 0 and blocks[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    if S <= 4 * SPAN:
        seen = np.zeros(S, np.int64)
        for lo, hi in blocks:
            seen[lo:hi] += 1
        assert (seen == 1).all()
    # the grid is (grid_x, B): every row gets the same blocks
    grid_x, spans = port.span_partition(S)
    assert grid_x * B <= (1 << 31) - 1 and B <= port.MAX_ROWS
    assert sum(hi - lo for lo, hi in blocks) * B == S * B
    assert spans <= 2 * port.SPANS_PER_BLOCK


def test_launch_rejects_too_many_rows():
    data = torch.zeros((port.MAX_ROWS + 1, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rows per launch"):
        port._launch(data, port.device_tables(P, "cpu"), P.mask, P.magic,
                     None)


@pytest.mark.parametrize("S", [SPAN - 1, SPAN + 1, 3 * SPAN + 17])
def test_candidate_mask_matches_pallas_at_span_edges(S):
    # the smallest average the reference takes, so that hits are many
    params = RefParams(avg_size=1024)
    p = params_from_reference(params.avg_size, params.min_size,
                              params.max_size, params.seed)
    data = np.stack([_bytes(S, S), _bytes(S, S + 1)])
    want = np.asarray(candidate_mask_pallas(jnp.asarray(data), params,
                                            interpret=True))
    got = port.candidate_mask_params(torch.from_numpy(data), p)
    assert np.array_equal(got.numpy(), want)
    assert want.any()
