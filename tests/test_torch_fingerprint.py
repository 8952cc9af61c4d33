"""The port's fold fingerprint on the CPU against the JAX package's
``fold_fingerprint`` and ``fold_fingerprint_host``.  Tolerance is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbs_plus_tpu.ops import fingerprint as R
from pbs_plus_tpu_torch.ops import fingerprint as F

LENS = [0, 1, 3, 63, 64, 65, 127, 128, 1000, 4097]

# the reference under one jit: its eager ops would compile one by one
_REF = jax.jit(R.fold_fingerprint, static_argnums=3)


def _case():
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 256, sum(LENS) + 100, dtype=np.uint8)
    starts = np.cumsum([7] + LENS[:-1]).astype(np.int64)   # unaligned
    return stream, starts, np.array(LENS, dtype=np.int64)


def _ref(stream, starts, lens, t_max):
    return np.asarray(_REF(
        jnp.asarray(stream), jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), t_max))


def _port(stream, starts, lens, t_max):
    return F.fold_fingerprint(stream, starts, lens, t_max,
                              device="cpu").numpy().astype(np.uint32)


@pytest.mark.parametrize("extra_blocks", [0, 5])
def test_fold_fingerprint_matches_reference(extra_blocks, monkeypatch):
    """t_max exactly the longest chunk's blocks, and larger than needed;
    one dispatch group, then several."""
    stream, starts, lens = _case()
    t_max = (int(lens.max()) + 63) // 64 + extra_blocks
    want = _ref(stream, starts, lens, t_max)
    assert np.array_equal(_port(stream, starts, lens, t_max), want)
    assert [F.fold_fingerprint_host(stream[s:s + n].tobytes())
            for s, n in zip(starts, lens)] == \
        [w.astype(">u4").tobytes() for w in want]
    assert [F.fold_fingerprint_host(stream[s:s + n].tobytes())
            for s, n in zip(starts, lens)] == \
        [R.fold_fingerprint_host(stream[s:s + n].tobytes())
         for s, n in zip(starts, lens)]
    monkeypatch.setattr(F, "GROUP_ELEMS", 10_000)
    assert np.array_equal(_port(stream, starts, lens, t_max), want)


def test_fold_fingerprint_reads_at_most_t_max_blocks_like_reference():
    """Past the caller contract (chunks longer than t_max * 64 bytes) the
    port reads the same first t_max blocks and binds the same length."""
    stream, starts, lens = _case()
    assert np.array_equal(_port(stream, starts, lens, 10),
                          _ref(stream, starts, lens, 10))


def test_fold_fingerprint_rejects_slices_outside_the_stream():
    stream = np.zeros(100, dtype=np.uint8)
    with pytest.raises(ValueError):
        F.fold_fingerprint(stream, [90], [20], 1, device="cpu")
    assert F.fold_fingerprint(stream, [], [], 1, device="cpu").shape == (0, 8)


def test_fold_fingerprint_counts_one_dispatch_per_call():
    stream, starts, lens = _case()
    before = F.stats["fold_fingerprint"]
    _port(stream, starts, lens, 400)
    assert F.stats["fold_fingerprint"] == before + 1
