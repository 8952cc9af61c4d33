"""One real run of the multi-device step and of sequence-parallel chunking
at tiny shapes, held against the port's single-device path.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(its single-chip ``entry()`` is the same step over a 1 x 1 mesh).

    python -m pbs_plus_tpu_torch dryrun-multichip --devices 8 --device cuda

runs over ``cuda:0..7`` where eight cards are visible, and over
``cuda:0`` repeated eight times where fewer are; ``--device cpu`` runs
the plain versions over ``cpu`` repeated.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..chunker.spec import ChunkerParams
from ..ops.cuckoo import CuckooIndex, lookup_host
from ..ops.rolling_hash import candidate_mask, chunk_stream_device, device_tables
from ..ops.similarity import simhash_sketch
from ..utils.device import resolve
from .dist_index import shard_table
from .mesh import make_mesh, make_seq_mesh
from .sharded_step import build_step_inputs, multichip_dedup_step
from .sp_chunker import sp_chunk_stream


def _mesh_devices(n_devices: int, device="cuda") -> list[torch.device]:
    """``n_devices`` devices for a mesh: distinct cards where that many
    are visible, else ``device`` repeated (``cpu`` always repeats)."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.device_count() >= n_devices:
            return [torch.device("cuda", i) for i in range(n_devices)]
        dev = torch.device("cuda", 0)
    return [dev] * n_devices


def _check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """The full sharded step over ``make_mesh`` (data x index) and the
    sequence-parallel cuts over ``make_seq_mesh``, one run each; raises
    ``AssertionError`` where either differs from the single-device path.
    Returns a summary."""
    devs = _mesh_devices(n_devices, device)
    params = ChunkerParams(avg_size=4 << 10)

    # --- full batched step over (data x index) ---------------------------
    mesh = make_mesh(devices=devs)
    nd = mesh.shape["data"]
    batch, seg_len, chunk_len = max(2 * nd, 8), 1 << 14, 4096
    index = CuckooIndex(n_buckets=1 << 12, device=devs[0])
    for i in range(64):
        index.insert(hashlib.sha256(bytes([i])).digest())
    streams, table, idx_tab, proj, host = build_step_inputs(
        mesh, batch=batch, seg_len=seg_len, params=params, index=index)
    # stream 0's head is present: one hit is expected
    index.insert(hashlib.sha256(host[0, :chunk_len].tobytes()).digest())
    idx_tab = shard_table(mesh, index._table)
    step = multichip_dedup_step(mesh, chunk_len=chunk_len,
                                n_buckets=index.n_buckets)
    cand, hits, sketches, total = step(streams, table, idx_tab, proj,
                                       params.mask, params.magic)
    cand, hits = cand.cpu().numpy(), hits.cpu().numpy()

    one = torch.from_numpy(host).to(devs[0])
    want_cand = candidate_mask(one, device_tables(params, devs[0]),
                               params.mask, params.magic).sum(dim=1)
    _check(np.array_equal(cand, want_cand.cpu().numpy()), "cand_count")
    _check(int(total) == int(cand.sum()), "total_candidates")
    heads = np.frombuffer(b"".join(hashlib.sha256(r[:chunk_len].tobytes())
                                   .digest() for r in host),
                          np.uint8).reshape(-1, 32)
    _check(np.array_equal(hits, lookup_host(index._table, heads)), "hits")
    _check(hits[0] and not hits[1:].any(), "only stream 0's head is present")
    want_sk = simhash_sketch(torch.from_numpy(heads.copy()).to(devs[0]),
                             proj=proj)
    _check(torch.equal(sketches.cpu(), want_sk.cpu()), "sketches")

    # --- sequence-parallel chunker over 'seq' ----------------------------
    seq_mesh = make_seq_mesh(devices=devs)
    stream = np.random.default_rng(7).integers(0, 256, 256 * 1024,
                                               dtype=np.uint8).tobytes()
    cuts = sp_chunk_stream(seq_mesh, stream, params)
    want = chunk_stream_device(stream, params, device=devs[0])
    _check(cuts == want, "sequence-parallel cuts differ from one device")
    return {"mesh": dict(mesh.shape), "devices": [str(d) for d in devs],
            "batch": batch, "hits": int(hits.sum()), "sp_cuts": len(cuts)}
