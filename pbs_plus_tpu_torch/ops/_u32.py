"""uint32 arithmetic in int64 tensors, and the length grouping of the
port's padded torch-op programs.

torch has no uint32 multiply, add or shift on the CPU, so the port holds
32-bit words in int64 tensors, in [0, 2**32).  A product of two such
words can reach 2**64 and leave the int64 range, so ``mul32`` splits one
operand into 16-bit halves: every partial product stays below 2**48 and
nothing relies on signed wraparound.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` and ``c`` (a tensor or an
    int) in [0, 2**32)."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def rotl32(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate the 32-bit words ``x`` left by ``r`` (an int or a tensor
    broadcast against ``x``) in [1, 31]."""
    return ((x << r) | (x >> (32 - r))) & M32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of ``x`` (int64 in [0, 2**32)), by the
    SWAR sum of the JAX package's ``_popcount32``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def be_words(q: torch.Tensor) -> torch.Tensor:
    """Big-endian 32-bit words of int64 bytes ``q[..., 4]``."""
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]


def length_groups(lens: np.ndarray, cap: int) -> list[np.ndarray]:
    """Indices of ``lens`` in ascending-length groups whose count times
    longest stays within ``cap`` elements (a longer one goes alone): the
    dispatch groups of a program that pads each row to its group's
    longest."""
    groups, cur = [], []
    for i in np.argsort(lens, kind="stable"):
        if cur and (len(cur) + 1) * int(lens[i]) > cap:
            groups.append(np.array(cur))
            cur = []
        cur.append(int(i))
    groups.append(np.array(cur))
    return groups
