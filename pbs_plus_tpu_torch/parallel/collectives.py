"""The mesh's data movement as tensor copies: the port's counterparts of
``jax.device_put`` with a row sharding, ``jax.lax.ppermute`` and
``jax.lax.psum``.

Every copy is ``.to(device)``, asynchronous where it lands on a card:
between two cards a peer copy, ordered after the source's work by
PyTorch.  On a repeated device ``.to`` returns the tensor itself, so a
result that is written later is a fresh tensor here (``torch.zeros``,
``torch.stack``), never an alias of its input.
"""

from __future__ import annotations

import torch


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: asynchronous onto a card, synchronous onto the
    host (whose reader would not wait for the copy), ``t`` itself where
    it already lies there."""
    return t.to(device, non_blocking=device.type == "cuda")


def scatter_rows(x: torch.Tensor, devices: list[torch.device]
                 ) -> list[torch.Tensor]:
    """``x`` split along dim 0 into ``len(devices)`` equal shards, shard
    ``i`` on ``devices[i]`` (a view where it already lies there)."""
    if x.shape[0] % len(devices):
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{len(devices)} devices")
    return [to_device(part, d)
            for part, d in zip(x.chunk(len(devices)), devices)]


def halo_from_left(shards: list[torch.Tensor], width: int
                   ) -> list[torch.Tensor]:
    """The halo exchange of sequence-parallel chunking: shard ``i``
    receives the last ``width`` elements of shard ``i - 1`` on its own
    device, and shard 0 receives zeros.  A shard shorter than ``width``
    cannot supply a full halo and raises ``ValueError`` (the JAX version
    cannot run such a mesh either: its halo has a static shape)."""
    for s in shards:
        if s.shape[0] < width:
            raise ValueError(f"shard of {s.shape[0]} elements is shorter "
                             f"than the {width}-element halo")
    out = [torch.zeros(width, dtype=shards[0].dtype, device=shards[0].device)]
    for left, right in zip(shards[:-1], shards[1:]):
        out.append(to_device(left[-width:], right.device))
    return out


def psum(parts: list[torch.Tensor], out_device: torch.device) -> torch.Tensor:
    """The sum of ``parts`` (one partial result per device), gathered onto
    ``out_device``."""
    return torch.stack([to_device(p, out_device) for p in parts]).sum(dim=0)
