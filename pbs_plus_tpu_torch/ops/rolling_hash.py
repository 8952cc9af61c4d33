"""Buzhash candidate mask: the CUDA kernel K1 (``csrc/rolling_hash.cu``) and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/rolling_hash.py`` and
``ops/pallas_rolling_hash.py``: per byte ``i``,

    h(i) = XOR_{k=0}^{63} rotl32(T[b[i-k]], k mod 32)

and a candidate ends at ``i`` where ``(h & mask) == magic``.  A tensor on a
CUDA device goes to the kernel; a tensor on the CPU goes to the plain
version.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..chunker import observe
from ..chunker.spec import WINDOW, ChunkerParams, buzhash_table, select_cuts
from ..utils.device import as_u8, host_tensor, resolve
from ._build import Kernel

_M32 = 0xFFFFFFFF

KERNEL = Kernel("rolling_hash", "rolling_hash_candidate_mask",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])

# K1's geometry (csrc/rolling_hash.cu): a span is 256 threads x 132
# positions; a block walks about SPANS_PER_BLOCK consecutive spans of a row
SPAN = 256 * 132
SPANS_PER_BLOCK = 16
MAX_ROWS = 65535

# multi-device dispatch evidence: bumped when a batch shards over the
# data mesh (``batched_candidate_hits``)
stats = {"mesh_dispatches": 0, "mesh_devices": 0}


def device_tables(params: ChunkerParams, device="cuda") -> torch.Tensor:
    """int32[256]: ``buzhash_table(params.seed)`` as uint32 bit patterns,
    on ``device``."""
    t = np.ascontiguousarray(buzhash_table(params.seed)).view(np.int32)
    return torch.from_numpy(t.copy()).to(resolve(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    r &= 31
    if r == 0:
        return x
    return ((x << r) | (x >> (32 - r))) & _M32


def candidate_mask_plain(data: torch.Tensor, tables: torch.Tensor, mask: int,
                         magic: int, history: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """The plain PyTorch version of K1, in int64 masked to 32 bits: the
    table lookup, then log2(W)=6 shift-rotate-XOR doubling passes,
    ``H_2m(i) = H_m(i) ^ rotl_m(H_m(i-m))``.  ``data`` uint8[B, S],
    ``history`` uint8[B, 63] or None; returns bool[B, S]."""
    B, S = data.shape
    hlen = 0
    if history is not None:
        hlen = history.shape[-1]
        data = torch.cat([history, data], dim=-1)
    h = (tables.to(torch.int64) & _M32)[data.to(torch.int64)]
    m = 1
    while m < WINDOW:
        shifted = torch.zeros_like(h)
        shifted[:, m:] = h[:, :-m]
        h = h ^ _rotl(shifted, m)
        m *= 2
    hit = (h & mask) == magic
    pos = torch.arange(hlen + S, device=data.device)
    hit &= (pos >= WINDOW - 1)[None, :]
    return hit[:, hlen:]


def span_partition(S: int) -> tuple[int, int]:
    """K1's grid along a row of ``S`` positions: ``(grid_x, spans)``.
    Block ``x`` of a row hashes spans ``x * spans`` up to the row's last
    span, ``(x + 1) * spans`` excluded, where span ``k`` holds positions
    ``[k * SPAN, min((k + 1) * SPAN, S))``.  The row's spans are split as
    evenly as blocks of about SPANS_PER_BLOCK allow, and no block is
    empty."""
    if S <= 0:
        return 0, 0
    n_spans = -(-S // SPAN)
    groups = -(-n_spans // SPANS_PER_BLOCK)
    spans = -(-n_spans // groups)
    return -(-n_spans // spans), spans


def _launch(data: torch.Tensor, tables: torch.Tensor, mask: int, magic: int,
            history: torch.Tensor | None) -> torch.Tensor:
    B, S = data.shape
    if B > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {B}")
    if tables.dtype != torch.int32 or tables.numel() != 256:
        raise ValueError("tables must be int32[256]")
    tables = tables.contiguous()
    out = torch.empty((B, S), dtype=torch.uint8, device=data.device)
    grid_x, spans = span_partition(S)
    KERNEL(data.device.index, data.data_ptr(),
           history.data_ptr() if history is not None else None,
           tables.data_ptr(), out.data_ptr(), B, S, SPAN, spans, grid_x,
           mask & _M32, magic & _M32,
           torch.cuda.current_stream(data.device).cuda_stream)
    return out.view(torch.bool)


def candidate_mask(data: torch.Tensor, tables: torch.Tensor, mask: int,
                   magic: int, *, history: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Candidate mask of batched stream segments.

    data:    uint8[B, S] or uint8[S]
    tables:  int32[256] (``device_tables(params)``), on data's device
    history: optional uint8[B, 63], the bytes preceding each segment.
             Without it, the first 63 positions of each row are invalid.

    Returns bool[B, S] (bool[S] for 1-D data): True where a chunk cut
    candidate ends at that byte.  CUDA tensors run kernel K1, CPU tensors
    the plain version."""
    squeeze = data.dim() == 1
    if squeeze:
        data = data[None]
    if data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8, got {data.dtype}")
    if history is not None:
        if history.shape != (data.shape[0], WINDOW - 1) \
                or history.dtype != torch.uint8:
            raise ValueError(f"history must be uint8[B, {WINDOW - 1}]")
        if history.device != data.device:
            raise ValueError("history must be on the data's device")
    if tables.device != data.device:
        raise ValueError("tables must be on the data's device")
    if data.is_cuda:
        hit = _launch(data.contiguous(), tables, mask, magic,
                      history.contiguous() if history is not None else None)
    elif data.device.type == "cpu":
        hit = candidate_mask_plain(data, tables, mask, magic, history)
    else:
        raise ValueError(f"unsupported device {data.device}")
    return hit[0] if squeeze else hit


def candidate_mask_params(data: torch.Tensor, params: ChunkerParams
                          ) -> torch.Tensor:
    """bool[B, S] candidate mask for ``params`` with no history: the first
    63 positions of each row are invalid.  Counterpart of the JAX package's
    ``candidate_mask_pallas``, as one call of the same kernel."""
    return candidate_mask(data, device_tables(params, data.device),
                          params.mask, params.magic)


def _as_tensor(b) -> torch.Tensor:
    return b if isinstance(b, torch.Tensor) else host_tensor(as_u8(b))


def _pow2_len(n: int) -> int:
    return max(1 << 14, 1 << int(n - 1).bit_length()) if n else 1 << 14


def _nonzero_rows(m: torch.Tensor, n_rows: int) -> np.ndarray:
    """int64[K, 2] (row, column) of the True entries in ``m``'s first
    ``n_rows`` rows, row-major, on the host."""
    # nonzero over at most 2**30 elements per call: a [32, 64 MiB] batch
    # is 2**31, past what torch.nonzero takes in one call on some versions
    step = max(1, (1 << 30) // max(1, m.shape[1]))
    nz = [np.empty((0, 2), np.int64)]
    for r in range(0, n_rows, step):
        part = torch.nonzero(m[r:min(r + step, n_rows)]).cpu().numpy()
        part[:, 0] += r
        nz.append(part)
    return np.concatenate(nz)


def batched_candidate_hits(bufs: list, hists: list, tables: torch.Tensor,
                           params: ChunkerParams) -> list[np.ndarray]:
    """Pack, dispatch and unpack one cross-stream candidate batch: stack
    variable-length segments (each with an optional 63-byte history; rows
    without one get zeros) into a pow2-padded ``[B_pad, S_pad]`` mask on the
    tables' device, and return each row's raw hit positions (0-based,
    unfiltered: callers apply their own window-validity and offsets).

    Segments and histories are host arrays, or uint8 tensors, which
    copy device to device when they already lie on the tables' device.
    Shared by the DeviceFeeder and the whole-stream DedupPipeline.  On the
    card the hits are extracted with ``torch.nonzero`` there, and only the
    positions come back to the host.

    Multi-device: a batch of two rows or more whose tables' device is in
    the process's data mesh (``parallel/mesh.py::data_mesh``) shards over
    it: ``B_pad`` is padded up to a multiple of the mesh size, each
    device takes an equal run of rows and its own K1 launch, and the
    positions come back in row order.  Single-row dispatches stay
    local."""
    from ..parallel.mesh import dispatch_mesh
    B = len(bufs)
    dev = tables.device
    observe.add_scan_bytes("cuda" if dev.type == "cuda" else "torch-cpu",
                           sum(len(b) for b in bufs))
    S_pad = _pow2_len(max(len(b) for b in bufs))
    B_pad = 1 << int(B - 1).bit_length() if B > 1 else 1
    mesh = dispatch_mesh(B, dev)
    devices = [dev] if mesh is None else list(mesh.devices.flat)
    if mesh is not None:
        n = mesh.size
        B_pad = -(-max(B_pad, n) // n) * n
        stats["mesh_dispatches"] += 1
        stats["mesh_devices"] = n
    per = B_pad // len(devices)                 # rows on each device
    masks = []
    for k, d in enumerate(devices):             # every launch, then any sync
        dbuf = torch.zeros((per, S_pad), dtype=torch.uint8, device=d)
        dhist = torch.zeros((per, WINDOW - 1), dtype=torch.uint8, device=d)
        for i in range(k * per, min((k + 1) * per, B)):
            if len(bufs[i]):
                dbuf[i - k * per, :len(bufs[i])].copy_(_as_tensor(bufs[i]))
            if hists[i] is not None:
                dhist[i - k * per].copy_(_as_tensor(hists[i]))
        masks.append(candidate_mask(dbuf, tables.to(d), params.mask,
                                    params.magic, history=dhist))
    nz = []
    for k, m in enumerate(masks):
        part = _nonzero_rows(m, max(0, min(per, B - k * per)))
        part[:, 0] += k * per
        nz.append(part)
    nz = np.concatenate(nz)
    rows, cols = nz[:, 0], nz[:, 1]
    edges = np.searchsorted(rows, np.arange(B + 1))
    out = []
    for i, b in enumerate(bufs):
        c = cols[edges[i]:edges[i + 1]]
        out.append(c[c < len(b)])
    return out


def candidate_ends_host(data: bytes | np.ndarray, params: ChunkerParams,
                        *, device="cuda") -> np.ndarray:
    """Sorted absolute candidate end offsets of one stream (the contract of
    the CPU chunker's ``candidates`` with no prefix), computed on
    ``device``."""
    arr = as_u8(data)
    dev = resolve(device)
    n = len(arr)
    buf = torch.zeros(_pow2_len(n), dtype=torch.uint8, device=dev)
    if n:
        buf[:n].copy_(host_tensor(arr))
    hit = candidate_mask(buf, device_tables(params, dev), params.mask,
                         params.magic)
    return (torch.nonzero(hit[:n]).flatten().cpu().numpy() + 1).astype(np.int64)


def chunk_stream_device(data: bytes | np.ndarray, params: ChunkerParams,
                        *, device="cuda") -> list[int]:
    """Device candidates plus the shared host greedy pass: cut offsets."""
    return select_cuts(candidate_ends_host(data, params, device=device),
                       len(data), params)
