"""The full multi-device dedup step over a (data x index) mesh.

Counterpart of the JAX package's ``parallel/sharded_step.py``: agent
streams split over ``data``, the cuckoo table over ``index``.  Per data
shard, on the row's first device: the K1 candidate mask and its row
counts (``mask_counts``), then K2 over each row's fixed-length head
segment (``head_digests``); the index-sharded probe of the row
(``dist_index.probe_row``: ``_probe_local`` per index shard, the partial
hits summed back); then the simhash sketch; last, the candidate total
summed over the data axis.  The layers are module functions so that a
timing of one layer times the code the step runs.  Every launch is
asynchronous on its device's current stream; the caller's read of the
results is the one host sync.  Variable-length cut selection stays on
the host: the full variable-length path is ``models.DedupPipeline``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..chunker.spec import ChunkerParams
from ..ops.cuckoo import CuckooIndex
from ..ops.rolling_hash import candidate_mask, device_tables
from ..ops.sha256 import sha256_words
from ..ops.similarity import _simhash, simhash_projection
from ..utils.device import host_tensor
from .collectives import psum, scatter_rows, to_device
from .dist_index import probe_row, shard_table
from .mesh import Mesh


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int64[N, 8] big-endian digest words (uint32 values) -> uint8[N, 32]."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    b = (words[:, :, None] >> shifts) & 0xFF
    return b.reshape(words.shape[0], 32).to(torch.uint8)


def mask_counts(shard: torch.Tensor, tables: torch.Tensor, mask: int,
                magic: int) -> torch.Tensor:
    """The step's first layer: K1's candidate mask of a data shard's
    uint8[b, S] rows -> int64[b] candidates per row."""
    return candidate_mask(shard, tables, mask, magic).sum(dim=1)


def head_digests(shard: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """The step's second layer: K2 over the first ``chunk_len`` bytes of
    each of a data shard's uint8[b, S] rows -> uint8[b, 32] digests."""
    b_local, S = shard.shape
    if chunk_len > S:
        raise ValueError(f"chunk_len {chunk_len} > segment {S}")
    starts = torch.arange(b_local, device=shard.device) * S
    lens = torch.full((b_local,), chunk_len, dtype=torch.int64,
                      device=shard.device)
    return _words_to_bytes(sha256_words(shard.reshape(-1), starts, lens))


def multichip_dedup_step(mesh: Mesh, *, chunk_len: int, n_buckets: int,
                         data_axis: str = "data", index_axis: str = "index"):
    """Build the sharded step.  Returns
    ``step(streams, table, index_table, proj, mask, magic) ->
    (cand_count[B], hits[B], sketches[B, k/32], total_candidates)``, all
    on the mesh's first device.

    ``streams`` is one uint8[B/nd, S] shard per data row (as
    ``build_step_inputs`` gives), ``table`` the K1 table, ``index_table``
    a ``shard_table`` of the index over ``index_axis``, ``proj`` the
    float [256, k] simhash projection."""
    nd = mesh.shape[data_axis]
    if n_buckets % mesh.shape[index_axis]:
        raise ValueError("n_buckets must divide by index-axis size")
    heads = [mesh.devices[mesh.position(**{data_axis: i})]
             for i in range(nd)]
    out_dev = mesh.devices.flat[0]

    def step(shards, table, index_table, proj, mask, magic):
        if len(shards) != nd:
            raise ValueError(f"{len(shards)} stream shards for {nd} data rows")
        k = proj.shape[1]
        placed: dict = {}               # replicated inputs, once per device

        def on(dev):
            if dev not in placed:
                p = proj if isinstance(proj, torch.Tensor) \
                    else host_tensor(np.asarray(proj))
                placed[dev] = (to_device(table, dev),
                               to_device(p, dev).to(torch.float64))
            return placed[dev]

        counts, hits, sketches = [], [], []
        for i, s in enumerate(shards):
            dev = heads[i]
            s = to_device(s, dev)
            tables_d, proj_d = on(dev)
            # 1) candidate mask (dense pass 1)
            counts.append(mask_counts(s, tables_d, mask, magic))
            # 2) SHA-256 of each row's head segment (dense pass 2)
            digests = head_digests(s, chunk_len)
            # 3) index-sharded probe: partial hits summed over the index axis
            hits.append(probe_row(mesh, index_table, digests, n_buckets,
                                  row={data_axis: i}, index_axis=index_axis))
            # 4) simhash sketches
            sketches.append(_simhash(digests, proj_d, k))
        cand_count = torch.cat([to_device(c, out_dev) for c in counts])
        # 5) the global stat rides the data axis
        total = psum([c.sum() for c in counts], out_dev)
        return (cand_count,
                torch.cat([to_device(h, out_dev) for h in hits]),
                torch.cat([to_device(x, out_dev) for x in sketches]),
                total)

    return step


def build_step_inputs(mesh: Mesh, *, batch: int, seg_len: int,
                      params: ChunkerParams, index: CuckooIndex,
                      simhash_bits: int = 64, seed: int = 0,
                      data_axis: str = "data", index_axis: str = "index"):
    """Inputs for ``multichip_dedup_step``, placed over ``mesh``: the same
    numpy draws as the JAX package's, so both build the same streams from
    one seed.  Returns ``(stream shards, K1 table, index table shards,
    projection, host streams)``."""
    nd = mesh.shape[data_axis]
    if batch % nd:
        raise ValueError("batch must divide by data-axis size")
    rng = np.random.default_rng(seed)
    streams = rng.integers(0, 256, (batch, seg_len), dtype=np.uint8)
    heads = [mesh.devices[mesh.position(**{data_axis: i})]
             for i in range(nd)]
    shards = scatter_rows(torch.from_numpy(streams), heads)
    table = device_tables(params, mesh.devices.flat[0])
    idx_tab = shard_table(mesh, index._table, index_axis)
    proj = simhash_projection(simhash_bits)
    return shards, table, idx_tab, proj, streams
