"""Scan-free 256-bit fold fingerprint in PyTorch ops.

Counterpart of the JAX package's ``ops/fingerprint.py`` (jnp lowered by
XLA, not a Pallas kernel).  Per 64-byte block, the 16 big-endian words are
multiplied by odd constants pairwise into 8 lanes and rotated by a
block-dependent amount, then XOR-folded across blocks and avalanched with
the chunk length.  A cheap non-cryptographic content fingerprint; content
addresses stay SHA-256 (``ops/sha256.py``).

torch has no XOR reduction, so the fold is a log2 tree of pairwise XORs.
uint32 arithmetic runs in int64 tensors (``_u32``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils.device import as_u8, host_tensor, resolve
from ._u32 import M32, be_words, length_groups, mul32, rotl32

_MULT = np.array([
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
], dtype=np.uint32)

# padded bytes of one dispatch group (see ``fold_fingerprint``)
GROUP_ELEMS = 1 << 27

stats = {"fold_fingerprint": 0}
_stats_lock = threading.Lock()


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 of ``x[N, T, ...]`` as a log2 tree of pairwise XORs."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] ^ x[:, 1::2]
    return x[:, 0]


def _fold_group(stream: torch.Tensor, starts: torch.Tensor,
                lengths: torch.Tensor, t: int) -> torch.Tensor:
    """int64[n, 8] fold fingerprints of ``stream`` slices whose data is at
    most ``t`` blocks; ``lengths`` are the lengths bound into the result,
    ``starts`` int64[n]."""
    dev = stream.device
    j = torch.arange(t * 64, device=dev)
    data_len = torch.clamp(lengths, max=t * 64)
    idx = (starts[:, None] + j[None, :]).clamp_(max=stream.numel() - 1)
    b = torch.where(j[None, :] < data_len[:, None], stream[idx], 0)
    del idx
    words = be_words(b.to(torch.int64).view(-1, t, 16, 4))       # [n, t, 16]
    mult = torch.from_numpy(_MULT.astype(np.int64)).to(dev)
    lane = mul32(words[:, :, :8], mult) ^ mul32(words[:, :, 8:], mult.flip(0))
    rot = (torch.arange(t, device=dev) * 7) % 31 + 1
    lane = rotl32(lane, rot[None, :, None])
    x = _xor_fold(lane) ^ mul32((lengths & M32)[:, None], mult[None, :])
    x = mul32(x, 0x85EBCA77)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE3D)
    return x ^ (x >> 16)


def fold_fingerprint(stream, starts, lengths, t_max: int, *,
                     device="cuda") -> torch.Tensor:
    """stream uint8[S]; starts/lengths int[N] -> int64[N, 8] fold
    fingerprints (uint32 values) on the stream's device.  A stream tensor
    is used where it lies; bytes or an array are copied to ``device``.

    As in the JAX package, a chunk's data is read up to ``t_max * 64``
    bytes (longer chunks are outside the caller contract), and its full
    length is bound into the result.  Slices must lie inside the stream.

    Chunks go in length-sorted groups of at most ``GROUP_ELEMS`` padded
    bytes, each padded only to its own longest chunk.  This is exact:
    blocks past a chunk's data are zero words, which multiply, rotate and
    XOR in as 0, so a group's block count does not change a result."""
    if isinstance(stream, torch.Tensor):
        s = stream.reshape(-1)
    else:
        s = host_tensor(as_u8(stream)).to(resolve(device))
    if s.numel() == 0:
        s = torch.zeros(1, dtype=torch.uint8, device=s.device)
    st = np.asarray(starts, dtype=np.int64).reshape(-1)
    ln = np.asarray(lengths, dtype=np.int64).reshape(-1)
    if st.shape != ln.shape:
        raise ValueError("starts and lengths differ in shape")
    out = torch.empty((len(st), 8), dtype=torch.int64, device=s.device)
    if not len(st):
        return out
    if t_max < 1:
        raise ValueError("t_max must be at least 1")
    data_len = np.minimum(ln, t_max * 64)
    if ln.min() < 0 or st.min() < 0 or int((st + data_len).max()) > s.numel():
        raise ValueError("chunk bounds outside the stream")
    with _stats_lock:
        stats["fold_fingerprint"] += 1
    blocks = np.maximum(1, (data_len + 63) // 64)
    for g in length_groups(blocks * 64, GROUP_ELEMS):
        out[torch.from_numpy(g).to(s.device)] = _fold_group(
            s, torch.from_numpy(st[g]).to(s.device),
            torch.from_numpy(ln[g]).to(s.device), int(blocks[g].max()))
    return out


def fold_fingerprint_host(chunk: bytes) -> bytes:
    """Reference host implementation (numpy), copied from the JAX package:
    the parity oracle of ``fold_fingerprint``."""
    L = len(chunk)
    t_max = max(1, (L + 63) // 64)
    buf = np.zeros(t_max * 64, dtype=np.uint8)
    buf[:L] = np.frombuffer(chunk, dtype=np.uint8)
    words = buf.reshape(t_max, 16, 4).astype(np.uint32)
    words = (words[..., 0] << 24) | (words[..., 1] << 16) | \
        (words[..., 2] << 8) | words[..., 3]
    w8 = words.reshape(t_max, 2, 8)
    lane = (w8[:, 0, :] * _MULT) ^ (w8[:, 1, :] * _MULT[::-1])
    rot = (np.arange(t_max, dtype=np.uint32) * 7) % 31 + 1
    lane = ((lane << rot[:, None]) | (lane >> (32 - rot[:, None]))).astype(np.uint32)
    folded = np.bitwise_xor.reduce(lane, axis=0)
    x = folded ^ (np.uint32(L) * _MULT)
    x = (x * np.uint32(0x85EBCA77)) & 0xFFFFFFFF
    x = x ^ (x >> 13)
    x = (x * np.uint32(0xC2B2AE3D)) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return x.astype(">u4").tobytes()
