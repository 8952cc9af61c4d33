"""State carried across from the JAX package.

The port's index and chunker parameters are built from plain values that a
JAX ``CuckooIndex``, ``ShardedCuckooIndex`` or ``ChunkerParams`` holds, so
both packages compute on the same state.  Nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .chunker.spec import ChunkerParams
from .ops.cuckoo import SLOTS, CuckooIndex


def index_from_reference(table: np.ndarray, known: Iterable[bytes], *,
                         n_buckets: int, seed: int = 0,
                         device="cuda") -> CuckooIndex:
    """A port ``CuckooIndex`` holding a reference index's host mirror
    (``_table``, uint32[n_buckets, 4, 2]) and exact digest set
    (``_known``).  Later evictions draw from a fresh generator seeded with
    ``seed``."""
    table = np.asarray(table)
    if table.shape != (n_buckets, SLOTS, 2) or table.dtype != np.uint32:
        raise ValueError(f"table must be uint32[{n_buckets}, {SLOTS}, 2], "
                         f"got {table.dtype}{list(table.shape)}")
    idx = CuckooIndex(n_buckets=n_buckets, seed=seed, device=device)
    idx._table = table.copy()
    idx._known = set(known)
    for d in idx._known:
        if len(d) != 32:
            raise ValueError(f"digest must be 32 bytes, got {len(d)}")
    return idx


def sharded_index_from_reference(table: np.ndarray, known: Iterable[bytes],
                                 mesh, *, n_buckets: int, seed: int = 0
                                 ) -> "ShardedCuckooIndex":
    """A port ``ShardedCuckooIndex`` over ``mesh`` holding a reference
    ``ShardedCuckooIndex``'s host mirror (``inner._table``) and exact set
    (``inner._known``), as ``index_from_reference`` does for a
    ``CuckooIndex``."""
    from .parallel.dist_index import ShardedCuckooIndex
    idx = ShardedCuckooIndex(mesh, n_buckets=n_buckets, seed=seed)
    idx.inner = index_from_reference(table, known, n_buckets=n_buckets,
                                     seed=seed, device=idx.device)
    return idx


def params_from_reference(avg_size: int, min_size: int, max_size: int,
                          seed: int) -> ChunkerParams:
    """The port's ``ChunkerParams`` for a reference configuration."""
    return ChunkerParams(avg_size=avg_size, min_size=min_size,
                         max_size=max_size, seed=seed)
