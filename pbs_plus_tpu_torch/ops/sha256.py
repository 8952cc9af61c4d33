"""Batched whole-chunk SHA-256: the CUDA kernel K2 (``csrc/sha256.cu``) and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/sha256.py``.  Chunks are
``(start, end)`` slices of one stream buffer; the digests come back as
32-byte strings in input order, equal to ``hashlib.sha256``'s.  A stream on
a CUDA device goes to the kernel, one launch for up to ``max_batch``
chunks; a stream on the CPU goes to the plain version.  Offsets are int64,
so many streams concatenated past 2 GiB still hash in one buffer.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import as_u8, host_tensor, resolve
from ._build import Kernel

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

MAX_CHUNK_BYTES = (1 << 29) - 64   # the JAX package's bound, kept as is

_M32 = 0xFFFFFFFF

# multi-device dispatch evidence: bumped when a batch shards over the
# data mesh (``sha256_stream_chunks``)
stats = {"mesh_dispatches": 0, "mesh_devices": 0}

KERNEL = Kernel("sha256", "sha256_chunks_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])


def _dup(x: torch.Tensor) -> torch.Tensor:
    # x * (2**32 + 1) == x | x << 32 (mod 2**64) for x < 2**32: a right
    # shift of it by r < 32 holds rotr(x, r) in its low 32 bits
    return x * 0x100000001


def _compress_plain(state: list, w: torch.Tensor) -> list:
    """One SHA-256 compression in int64: ``state`` eight int64[N] in
    [0, 2**32), ``w`` int64[N, 16] big-endian message words.  Only the low
    32 bits of a sum depend on the low 32 bits of its terms, so the
    rotations' high garbage bits are masked once, where a word is stored."""
    W = [w[:, i] for i in range(16)]
    for i in range(16, 64):
        x, y = W[i - 15], W[i - 2]
        xx, yy = _dup(x), _dup(y)
        s0 = (xx >> 7) ^ (xx >> 18) ^ (x >> 3)
        s1 = (yy >> 17) ^ (yy >> 19) ^ (y >> 10)
        W.append((W[i - 16] + s0 + W[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        ee, aa = _dup(e), _dup(a)
        S1 = (ee >> 6) ^ (ee >> 11) ^ (ee >> 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + S1 + ch + (W[i] + _K[i])
        S0 = (aa >> 2) ^ (aa >> 13) ^ (aa >> 22)
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, \
            (t1 + S0 + maj) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words_plain(stream: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2: every chunk's blocks advance in
    lockstep, with the SHA padding applied by masks (finished chunks
    freeze).  ``stream`` uint8[S], ``starts``/``lens`` int64[N]; returns
    int64[N, 8] digest words."""
    dev = stream.device
    N = starts.numel()
    if stream.numel() == 0:
        stream = torch.zeros(1, dtype=torch.uint8, device=dev)
    last_byte = stream.numel() - 1
    nblocks = (lens + 8) // 64 + 1
    bitlen = lens * 8
    j = torch.arange(64, device=dev)
    state = [torch.full((N,), v, dtype=torch.int64, device=dev) for v in _H0]
    for t in range(int(nblocks.max()) if N else 0):
        local = t * 64 + j
        idx = (starts[:, None] + local[None, :]).clamp_(max=last_byte)
        raw = stream[idx].to(torch.int64)
        byte = torch.where(local[None, :] < lens[:, None], raw, 0)
        byte = torch.where(local[None, :] == lens[:, None], 0x80, byte)
        q = byte.view(N, 16, 4)
        words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) \
            | q[..., 3]
        is_last = nblocks - 1 == t
        words[:, 14] = torch.where(is_last, (bitlen >> 32) & _M32, words[:, 14])
        words[:, 15] = torch.where(is_last, bitlen & _M32, words[:, 15])
        new = _compress_plain(state, words)
        active = nblocks > t
        state = [torch.where(active, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=1)


def launch_plan(lens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's launch plan for int64[N] chunk lengths: ``order`` (indices
    longest first, ties in input order), its inverse ``inv``
    (``x[order][inv] == x``) and the blocks of each chunk,
    ``(L + 8) // 64 + 1``: its data blocks, the 0x80 byte and the 64-bit
    bit length.  The kernel hashes ``order``'s chunks 32 to a warp, so the
    longest chunk starts first and a warp's lanes have similar block
    counts; ``inv`` puts the digests back in input order."""
    order = torch.sort(lens, descending=True, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return order, inv, (lens + 8) // 64 + 1


def _launch(stream: torch.Tensor, starts: torch.Tensor,
            lens: torch.Tensor) -> torch.Tensor:
    n = starts.numel()
    order, inv, _ = launch_plan(lens)
    s_starts, s_lens = starts[order], lens[order]
    out = torch.empty((n, 8), dtype=torch.int32, device=stream.device)
    KERNEL(stream.device.index, stream.data_ptr(), s_starts.data_ptr(),
           s_lens.data_ptr(), n, out.data_ptr(),
           torch.cuda.current_stream(stream.device).cuda_stream)
    return out[inv].to(torch.int64) & _M32


def sha256_words(stream: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor) -> torch.Tensor:
    """int64[N, 8] digest words of ``stream[starts[i] : starts[i]+lens[i]]``
    (uint8[S] stream, int64[N] starts and lengths, all on one device; the
    caller has checked that every slice lies inside the stream).  CUDA
    tensors run kernel K2, CPU tensors the plain version."""
    if stream.dtype != torch.uint8 or stream.dim() != 1:
        raise ValueError("stream must be uint8[S]")
    if starts.device != stream.device or lens.device != stream.device:
        raise ValueError("starts and lens must be on the stream's device")
    starts = starts.to(torch.int64).contiguous()
    lens = lens.to(torch.int64).contiguous()
    if stream.is_cuda:
        return _launch(stream.contiguous(), starts, lens)
    if stream.device.type == "cpu":
        return sha256_words_plain(stream, starts, lens)
    raise ValueError(f"unsupported device {stream.device}")


def _stream_tensor(stream, device) -> torch.Tensor:
    if isinstance(stream, torch.Tensor):
        return stream.reshape(-1)
    return host_tensor(as_u8(stream)).to(resolve(device))


def sha256_stream_chunks(stream, bounds: list[tuple[int, int]], *,
                         max_batch: int = 4096, device="cuda") -> list[bytes]:
    """SHA-256 of ``stream[s:e]`` for each ``(s, e)`` in bounds, in input
    order.  ``stream`` is bytes, a numpy uint8 array (copied to
    ``device``) or a uint8 tensor (used where it lies).  One kernel launch
    per ``max_batch`` chunks.

    Multi-device: where the stream's device is in the process's data mesh
    (``parallel/mesh.py::data_mesh``), the stream is copied once to each
    mesh device, each batch of two chunks or more splits its rows evenly
    over the devices, one launch each, and the digests come back in input
    order."""
    from ..parallel.mesh import dispatch_mesh
    if not bounds:
        return []
    starts = np.array([s for s, _ in bounds], dtype=np.int64)
    lens = np.array([e - s for s, e in bounds], dtype=np.int64)
    if lens.min() < 0 or lens.max() > MAX_CHUNK_BYTES:
        raise ValueError("chunk length out of supported range")
    t = _stream_tensor(stream, device)
    if starts.min() < 0 or int((starts + lens).max()) > t.numel():
        raise ValueError("chunk bounds outside the stream")
    dstarts = torch.from_numpy(starts).to(t.device)
    dlens = torch.from_numpy(lens).to(t.device)
    copies = {t.device: t}      # the stream on each device
    parts = []                  # every launch, then any sync
    for lo in range(0, len(bounds), max_batch):
        hi = min(lo + max_batch, len(bounds))
        mesh = dispatch_mesh(hi - lo, t.device)
        devices = [t.device] if mesh is None else list(mesh.devices.flat)
        if mesh is not None:
            stats["mesh_dispatches"] += 1
            stats["mesh_devices"] = mesh.size
        per = -(-(hi - lo) // len(devices))
        for k, d in enumerate(devices):
            a, b = lo + k * per, min(lo + (k + 1) * per, hi)
            if a < b:
                if d not in copies:
                    copies[d] = t.to(d)
                parts.append(sha256_words(copies[d], dstarts[a:b].to(d),
                                          dlens[a:b].to(d)))
    words = torch.cat([p.cpu() for p in parts]).numpy().astype(">u4")
    return [row.tobytes() for row in words]


def sha256_streams_chunks(streams: list, bounds_per_stream: list, *,
                          device="cuda") -> list[list[bytes]]:
    """Digest many streams' chunks in one buffer: the streams are
    concatenated on ``device`` and all their chunks go through
    ``sha256_stream_chunks`` together.  Returns per-stream digest lists in
    input order."""
    arrs = [as_u8(s) for s in streams]
    all_bounds: list[tuple[int, int]] = []
    counts: list[int] = []
    off = 0
    for a, bounds in zip(arrs, bounds_per_stream):
        all_bounds.extend((off + s, off + e) for s, e in bounds)
        counts.append(len(bounds))
        off += len(a)
    if not all_bounds:
        return [[] for _ in arrs]
    dstream = torch.empty(off, dtype=torch.uint8, device=resolve(device))
    pos = 0
    for a in arrs:
        if len(a):
            dstream[pos:pos + len(a)].copy_(host_tensor(a))
        pos += len(a)
    flat = sha256_stream_chunks(dstream, all_bounds)
    out: list[list[bytes]] = []
    k = 0
    for c in counts:
        out.append(flat[k:k + c])
        k += c
    return out


def sha256_chunks(chunks: list[bytes], *, device="cuda") -> list[bytes]:
    """Digest a list of standalone chunk buffers (joined into one stream
    buffer on ``device``)."""
    if not chunks:
        return []
    bounds = []
    off = 0
    for c in chunks:
        bounds.append((off, off + len(c)))
        off += len(c)
    return sha256_stream_chunks(b"".join(chunks), bounds, device=device)
