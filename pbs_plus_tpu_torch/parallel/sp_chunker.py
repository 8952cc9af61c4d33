"""Sequence-parallel CDC: one long stream sharded along its byte axis.

Counterpart of the JAX package's ``parallel/sp_chunker.py``.  Buzhash's
sliding window makes each position's hash depend on 64 bytes only, so a
stream split over a mesh needs just a 63-byte halo from the left
neighbour (``collectives.halo_from_left``, the ``ppermute``), after which
every shard runs K1 on its own bytes with the halo as its history.
Bit-identical to the single-device mask and cuts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..chunker.spec import WINDOW, ChunkerParams, select_cuts
from ..ops.rolling_hash import _nonzero_rows, candidate_mask, device_tables
from ..utils.device import as_u8, host_tensor
from .collectives import halo_from_left, to_device
from .mesh import Mesh


def _sp_mask_local(local: torch.Tensor, halo: torch.Tensor, first: bool,
                   tables: torch.Tensor, params: ChunkerParams
                   ) -> torch.Tensor:
    """Per-shard body: the candidate mask of shard ``local`` uint8[S]
    with its left neighbour's 63 bytes ``halo`` as history.  Shard 0's
    halo is zeros: its first W-1 stream positions have no full window and
    are invalid."""
    hit = candidate_mask(local[None], tables, params.mask, params.magic,
                         history=halo[None])[0]
    if first:
        hit[:WINDOW - 1] = False         # a fresh tensor: no alias written
    return hit


def _shards(mesh: Mesh, t: torch.Tensor, axis_name: str
            ) -> list[torch.Tensor]:
    devices = mesh.axis_devices(axis_name)
    if t.dim() != 1 or t.dtype != torch.uint8:
        raise ValueError("data must be uint8[S]")
    if t.shape[0] % len(devices):
        raise ValueError(f"{t.shape[0]} bytes do not split over "
                         f"{len(devices)} shards (pad the stream)")
    return [to_device(part, d)
            for part, d in zip(t.chunk(len(devices)), devices)]


def sp_candidate_mask(mesh: Mesh, data: torch.Tensor, params: ChunkerParams,
                      *, axis_name: str = "seq") -> list[torch.Tensor]:
    """Candidate mask of one stream, a uint8[S] tensor sharded over
    ``axis_name`` (each shard a view where it already lies on its
    device); S must divide evenly by the axis size.  Returns one bool
    mask per shard, on the shard's device; their concatenation is the
    stream's mask."""
    shards = _shards(mesh, data, axis_name)
    halos = halo_from_left(shards, WINDOW - 1)
    tables = {}
    out = []
    for i, (local, halo) in enumerate(zip(shards, halos)):
        dev = local.device
        if dev not in tables:
            tables[dev] = device_tables(params, dev)
        out.append(_sp_mask_local(local, halo, i == 0, tables[dev], params))
    return out


def sp_chunk_stream(mesh: Mesh, data, params: ChunkerParams, *,
                    axis_name: str = "seq") -> list[int]:
    """Sequence-parallel chunking of one long stream -> absolute cut
    offsets: the stream is zero-padded to a multiple of the axis size,
    the shards' candidates past its end are dropped, and the shared host
    greedy pass picks the cuts."""
    t = data if isinstance(data, torch.Tensor) else host_tensor(as_u8(data))
    n = t.shape[0]
    n_dev = mesh.shape[axis_name]
    pad = (-n) % n_dev
    if pad:
        padded = torch.zeros(n + pad, dtype=torch.uint8, device=t.device)
        padded[:n].copy_(t)
        t = padded
    masks = sp_candidate_mask(mesh, t, params, axis_name=axis_name)
    ends, off = [np.empty(0, np.int64)], 0
    for m in masks:
        ends.append(_nonzero_rows(m[None], 1)[:, 1] + off + 1)
        off += m.shape[0]
    ends = np.concatenate(ends)
    return select_cuts(ends[ends <= n], n, params)
