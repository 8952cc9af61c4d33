"""The buzhash CDC specification, copied from the JAX package's
``chunker/spec.py`` with the same values: the port holds its own copy so it
never imports the reference package.

- 32-bit buzhash over a sliding window of W=64 bytes of the raw stream, in
  the position-local closed form::

      h(i) = XOR_{k=0}^{W-1} rotl32(T[b[i-k]], k mod 32)

  so the hash at position ``i`` depends only on bytes ``[i-W+1 .. i]`` and
  never resets at cut points.  Every position's hash can be computed
  independently, and cut selection is a greedy pass over a sparse
  candidate list.

- Candidate at position ``i`` (0-based, ``i >= W-1``) iff
  ``(h(i) & mask) == magic`` with ``mask = avg_size - 1`` (``avg_size`` a
  power of two) and ``magic = 0x5BC0FFEE & mask``.

- Greedy selection with min/max clamps: from chunk start ``s``, cut at the
  first candidate ``i`` with ``min <= i+1-s <= max``; if none exists before
  ``s+max``, force a cut at ``s+max``; the stream tail is the final chunk.
  Defaults: ``min = avg/4``, ``max = avg*4``.

``select_cuts`` below is the shared greedy pass, so backend parity reduces
to producing identical candidate sets.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

WINDOW = 64
MAGIC_BASE = 0x5BC0FFEE
TABLE_SEED = 0x7069_7861_7274_7075  # "pixartpu" — fixed, part of the format
# on-disk chunk-format identifier: bump whenever the table derivation, the
# window, or the cut condition changes — snapshots record it in their
# manifest and ref-dedup refuses to link across differing formats
CHUNK_FORMAT = "buzhash32-nibble16-w64-v1"

_M64 = (1 << 64) - 1


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, (z ^ (z >> 31)) & _M64


@lru_cache(maxsize=4)
def _buzhash_subtables_cached(seed: int) -> tuple[np.ndarray, np.ndarray]:
    hi = np.empty(16, dtype=np.uint64)
    lo = np.empty(16, dtype=np.uint64)
    s = seed
    for i in range(16):
        s, v = _splitmix64(s)
        hi[i] = v & 0xFFFFFFFF
    for i in range(16):
        s, v = _splitmix64(s)
        lo[i] = v & 0xFFFFFFFF
    a, b = hi.astype(np.uint32), lo.astype(np.uint32)
    a.flags.writeable = False
    b.flags.writeable = False
    return a, b


def buzhash_subtables(seed: int = TABLE_SEED) -> tuple[np.ndarray, np.ndarray]:
    """The two 16-entry subtables (A, B) the byte table derives from."""
    return _buzhash_subtables_cached(seed)


@lru_cache(maxsize=4)
def _buzhash_table_cached(seed: int) -> np.ndarray:
    a, b = _buzhash_subtables_cached(seed)
    t = (a[np.arange(256) >> 4] ^ b[np.arange(256) & 0xF]).astype(np.uint32)
    t.flags.writeable = False  # shared across all chunkers — never mutate
    return t


def buzhash_table(seed: int = TABLE_SEED) -> np.ndarray:
    """256 deterministic uint32 entries (read-only, cached; part of the
    on-disk dedup format).

    Derivation: ``T[x] = A[x >> 4] ^ B[x & 15]`` with A/B two 16-entry
    splitmix64 subtables.  The CUDA kernel reads this materialized table;
    it is bit-identical to the nibble form by construction."""
    return _buzhash_table_cached(seed)


@dataclass(frozen=True)
class ChunkerParams:
    avg_size: int = 4 << 20
    min_size: int = 0      # 0 → avg/4
    max_size: int = 0      # 0 → avg*4
    seed: int = TABLE_SEED

    def __post_init__(self) -> None:
        if self.avg_size & (self.avg_size - 1) or self.avg_size < 1024:
            raise ValueError("avg_size must be a power of two >= 1024")
        if not self.min_size:
            object.__setattr__(self, "min_size", self.avg_size // 4)
        if not self.max_size:
            object.__setattr__(self, "max_size", self.avg_size * 4)
        if not (WINDOW <= self.min_size <= self.avg_size <= self.max_size):
            raise ValueError("need WINDOW <= min <= avg <= max")

    @property
    def mask(self) -> int:
        return self.avg_size - 1

    @property
    def magic(self) -> int:
        return MAGIC_BASE & self.mask

    @property
    def table(self) -> np.ndarray:
        return buzhash_table(self.seed)


DEFAULT_PARAMS = ChunkerParams(avg_size=4 << 20)   # 4 MiB production target
TEST_PARAMS = ChunkerParams(avg_size=4 << 10)      # 4 KiB test scale


def select_cuts(candidate_ends: np.ndarray, total_len: int,
                params: ChunkerParams, *,
                start: int = 0, final: bool = True) -> list[int]:
    """Greedy min/max cut selection — shared by CPU and TPU backends.

    ``candidate_ends``: sorted array of candidate *end offsets* (cut after
    byte i → end offset i+1), absolute within the stream.
    Returns the list of chunk end offsets in ``(start, total_len]``.
    If ``final`` is False, trailing data shorter than ``max_size`` stays
    un-cut (streaming mode: more data may arrive).
    """
    cuts: list[int] = []
    cand = np.asarray(candidate_ends, dtype=np.int64)
    idx = int(np.searchsorted(cand, start + params.min_size, side="left"))
    s = start
    while True:
        limit = s + params.max_size
        # first candidate with end >= s+min
        while idx < len(cand) and cand[idx] < s + params.min_size:
            idx += 1
        if idx < len(cand) and cand[idx] <= limit and cand[idx] <= total_len:
            s = int(cand[idx])
            cuts.append(s)
            idx += 1
            continue
        if limit <= total_len:          # forced max-size cut
            s = limit
            cuts.append(s)
            continue
        break
    if final and s < total_len:
        cuts.append(total_len)
    return cuts
