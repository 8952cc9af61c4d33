"""Vectorized (SIMD-style) CDC backend — the batched buzhash scan as a
first-class chunker backend.

The scalar backend's hot loop is the classic rolling recurrence
``h = rotl1(h) ^ T[out] ^ T[in]`` — a 3-instruction dependency chain per
byte that no compiler can widen.  This backend instead ports the
shift/rotate/XOR doubling formulation the TPU kernel proves on-device
(ops/rolling_hash.py):

    H_1(i)    = T[b[i]]
    H_{2m}(i) = H_m(i) ^ rotl_{m mod 32}(H_m(i-m))

to the CPU as wide data-parallel passes (the reformulation of
"Accelerating Data Chunking in Deduplication Systems using Vector
Instructions", arXiv:2508.05797, and "Vectorized Sequence-Based
Chunking", arXiv:2505.21194).  Two implementations, bit-identical by
test (tests/test_vector_chunker.py, bench.py in-run gate):

- ``native/buzhash_native.cpp pbs_buzhash_candidates_vec`` — the fast
  path: a register-fused AVX-512 pipeline whose table lookup is the SAME
  nibble decomposition the device kernel uses (T[x] = A[x>>4] ^ B[x&15],
  chunker/spec.py): two 16-entry ``vpermd`` permutes are the CPU-register
  analog of the TPU's 32 unrolled selects.  ~2.7x the scalar native scan
  on one core (bench ``detail.cpu.scan_vec_mib_s`` vs ``scan_st_mib_s``).
- ``_numpy_candidates`` below — the always-available reference: the same
  doubling passes over L1-sized blocks with a 63-byte halo and reused
  scratch (the old whole-buffer numpy scan allocated ~40 bytes of
  temporaries per input byte and collapsed on large buffers).

``candidates_batch`` is the vmap-across-sessions shape from BASELINE:
many concurrent streams stacked into one ``[B, 63+S]`` scan, mirroring
``ops/rolling_hash.batched_candidate_hits``.

``VectorChunker`` wraps the scan in the shared streaming shell
(chunker/cpu.py ``CpuChunker``): same W-1 tail carry, same feed
coalescing, same ``spec.select_cuts`` greedy pass — cut parity with the
scalar chunker is structural.  ``ResilientVectorFactory`` is the
``bind_stream`` seam implementation (pxar/transfer.py:162): the
vector-vs-scalar decision is pinned ONCE per stream at open, and a
failed self-test degrades vector -> scalar exactly like the sidecar
factory degrades sidecar -> CPU (the fallback discipline).

A copy of the JAX package's ``chunker/vector.py``, its code byte for
byte apart from its imports, which name the port's own modules, and its
logger (``logging``).  Host code: the "device kernel" above is the JAX
package's; in the port the device scan is K1 (``ops/rolling_hash.py``,
``ops/csrc/rolling_hash.cu``), and this module launches nothing.
"""

from __future__ import annotations

import logging

import numpy as np

from . import native, observe
from .cpu import CpuChunker
from .spec import WINDOW, ChunkerParams

# numpy block: 64 KiB keeps the uint32 hash block + scratch L2-resident
_NP_BLOCK = 1 << 16
# below this, the ctypes call overhead beats the native kernel's gain
_NATIVE_THRESHOLD = 1 << 12


def _clamp_prefix(prefix, global_offset: int):
    """Shared context clamping: at most W-1 bytes, never more than the
    real stream history (identical to chunker.cpu.candidates)."""
    if len(prefix) > global_offset:
        prefix = prefix[-global_offset:] if global_offset else prefix[:0]
    if len(prefix) >= WINDOW:
        prefix = prefix[-(WINDOW - 1):]
    return prefix


def _doubling_passes(hv: np.ndarray, s1: np.ndarray, s2: np.ndarray) -> None:
    """In-place log2(W) doubling along the LAST axis (scratch-reusing
    form of ops/rolling_hash._candidate_mask_impl's pass loop) — the one
    bit-parity-critical recurrence, shared by the one-shot block kernel
    (1-D) and the batched ``[B, cols]`` kernel (2-D)."""
    m_ = hv.shape[-1]
    m = 1
    while m < WINDOW:
        r = m & 31
        n = m_ - m
        if n <= 0:
            break
        sv = s1[..., :n]
        if r:
            np.left_shift(hv[..., :n], np.uint32(r), out=sv)
            np.right_shift(hv[..., :n], np.uint32(32 - r), out=s2[..., :n])
            np.bitwise_or(sv, s2[..., :n], out=sv)
        else:
            np.copyto(sv, hv[..., :n])   # rotl by 32 ≡ identity
        hv[..., m:] ^= sv
        m *= 2


def _numpy_candidates(arr: np.ndarray, params: ChunkerParams,
                      prefix: np.ndarray, global_offset: int) -> np.ndarray:
    """Blocked-numpy reference kernel (see module docstring)."""
    table = params.table
    mask = np.uint32(params.mask)
    magic = np.uint32(params.magic)
    plen = len(prefix)
    n = len(arr)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    # first data index whose 64-byte window is fully inside real history
    iv = max(WINDOW - 1 - plen, WINDOW - 1 - global_offset, 0)
    out: list[np.ndarray] = []
    h = np.empty(_NP_BLOCK + WINDOW - 1, dtype=np.uint32)
    s1 = np.empty(_NP_BLOCK + WINDOW - 1, dtype=np.uint32)
    s2 = np.empty(_NP_BLOCK + WINDOW - 1, dtype=np.uint32)
    for s in range(0, n, _NP_BLOCK):
        e = min(s + _NP_BLOCK, n)
        if s:                        # _NP_BLOCK > W-1 ⇒ halo from data
            halo = WINDOW - 1
            seg = arr[s - halo:e]
        else:
            halo = min(WINDOW - 1, plen)
            seg = np.concatenate([prefix[plen - halo:], arr[:e]]) \
                if halo else arr[:e]
        m_ = len(seg)
        hv = h[:m_]
        np.take(table, seg, out=hv)
        _doubling_passes(hv, s1, s2)
        # local j maps to data index i = s + j - halo; valid positions
        # need j >= W-1 (full window inside the block) and i >= iv
        first_j = max(WINDOW - 1, halo + iv - s)
        if first_j >= m_:
            continue
        np.bitwise_and(hv, mask, out=hv)
        hits = np.flatnonzero(hv[first_j:] == magic)
        if len(hits):
            out.append(hits + (first_j + global_offset + s - halo + 1))
    if not out:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


def candidates(data: bytes | np.ndarray, params: ChunkerParams, *,
               prefix: bytes | np.ndarray = b"",
               global_offset: int = 0,
               force_numpy: bool = False) -> np.ndarray:
    """Sorted absolute candidate END offsets inside ``data`` — the
    vectorized twin of ``chunker.cpu.candidates`` (same contract, same
    clamping, bit-identical output)."""
    arr = np.frombuffer(data, dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data
    prefix = _clamp_prefix(prefix, global_offset)
    if not force_numpy and len(arr) >= _NATIVE_THRESHOLD \
            and native.vec_available():
        return native.candidates_vec(
            arr, params, prefix=bytes(prefix[-(WINDOW - 1):]),
            global_offset=global_offset)
    pfx = np.frombuffer(bytes(prefix), dtype=np.uint8) \
        if not isinstance(prefix, np.ndarray) else prefix
    observe.add_scan_bytes("vector-numpy", len(arr))
    return _numpy_candidates(arr, params, pfx, global_offset)


def candidates_batch(bufs: list, params: ChunkerParams, *,
                     prefixes: list | None = None,
                     global_offsets: list[int] | None = None,
                     force_numpy: bool = False) -> list[np.ndarray]:
    """Batched scan across many concurrent streams — the
    vmap-across-sessions shape (ops/rolling_hash.batched_candidate_hits
    on host vectors).  Row i gets up to W-1 bytes of ``prefixes[i]``
    context and stream offset ``global_offsets[i]``; returns each row's
    sorted absolute candidate ends (identical to per-row ``candidates``).

    With the native kernel present each row runs through the fused SIMD
    scan (the batch axis buys dispatch amortization); the numpy fallback
    genuinely stacks rows into one ``[B, 63+S]`` blocked doubling pass.
    """
    B = len(bufs)
    if B == 0:
        return []
    prefixes = prefixes if prefixes is not None else [b""] * B
    offs = global_offsets if global_offsets is not None else [0] * B
    arrs = [np.frombuffer(b, dtype=np.uint8)
            if not isinstance(b, np.ndarray) else b for b in bufs]
    pfxs = [_clamp_prefix(p, o) for p, o in zip(prefixes, offs)]
    if not force_numpy and native.vec_available():
        return [candidates(a, params, prefix=p, global_offset=o)
                for a, p, o in zip(arrs, pfxs, offs)]
    halo = WINDOW - 1
    S = max(len(a) for a in arrs)
    if S == 0:
        return [np.empty(0, dtype=np.int64) for _ in arrs]
    lens = np.array([len(a) for a in arrs], dtype=np.int64)
    ivs = np.array([max(WINDOW - 1 - len(p), WINDOW - 1 - o, 0)
                    for p, o in zip(pfxs, offs)], dtype=np.int64)
    mat = np.zeros((B, halo + S), dtype=np.uint8)
    for i, (a, p) in enumerate(zip(arrs, pfxs)):
        if len(p):
            mat[i, halo - len(p):halo] = np.frombuffer(bytes(p), np.uint8)
        mat[i, halo:halo + len(a)] = a
    observe.add_scan_bytes("vector-numpy", int(lens.sum()))
    table = params.table
    mask = np.uint32(params.mask)
    magic = np.uint32(params.magic)
    cols = halo + S
    cb = max(_NP_BLOCK // max(B, 1), 4 * WINDOW)
    per_row: list[list[np.ndarray]] = [[] for _ in range(B)]
    h = np.empty((B, cb + halo), dtype=np.uint32)
    s1 = np.empty((B, cb + halo), dtype=np.uint32)
    s2 = np.empty((B, cb + halo), dtype=np.uint32)
    for cs in range(halo, cols, cb):
        ce = min(cs + cb, cols)
        lo = cs - halo
        m_ = ce - lo
        hv = h[:, :m_]
        np.take(table, mat[:, lo:ce], out=hv)
        _doubling_passes(hv, s1, s2)
        np.bitwise_and(hv, mask, out=hv)
        # local column j of this block maps to combined column lo + j;
        # columns below W-1 in the block were emitted by the previous
        # block (or are pad/halo — invalid either way)
        rows, js = np.nonzero(hv[:, WINDOW - 1:] == magic)
        if not len(rows):
            continue
        i_idx = js + (WINDOW - 1) + lo - halo      # per-row data index
        keep = (i_idx >= ivs[rows]) & (i_idx < lens[rows])
        rows, i_idx = rows[keep], i_idx[keep]
        for r_ in range(B):
            sel = i_idx[rows == r_]
            if len(sel):
                per_row[r_].append(sel + offs[r_] + 1)
    return [np.concatenate(p).astype(np.int64) if p
            else np.empty(0, dtype=np.int64) for p in per_row]


def scan_impl_name() -> str:
    """Which implementation one-shot ``candidates`` uses for large
    buffers right now: 'native-avx512' | 'native-generic' | 'numpy'."""
    impl = native.vec_impl()
    return {2: "native-avx512", 1: "native-generic"}.get(impl, "numpy")


class VectorChunker(CpuChunker):
    """Streaming vectorized chunker: the shared streaming shell
    (tail carry, feed coalescing, ``spec.select_cuts``) over the
    vectorized scan.  Drop-in for ``CpuChunker`` in transfer writers."""

    backend_name = "vector"

    def _scan(self, data, prefix, global_offset: int) -> np.ndarray:
        return candidates(data, self.params, prefix=prefix,
                          global_offset=global_offset)


# -- resilient backend selection (the bind_stream seam) ---------------------

_probe_ok: bool | None = None


def _self_test() -> bool:
    """One-shot parity probe: the vectorized scan (whatever path it
    dispatches to on this host) must agree with the scalar numpy
    reference on a deterministic mixed corpus, with and without stream
    context.  A miscompiled native library fails here — and every
    stream then degrades to the scalar chunker at bind time."""
    from .cpu import candidates as cpu_candidates
    params = ChunkerParams(avg_size=4 << 10)
    n = 192 << 10
    x = np.arange(n, dtype=np.uint64)
    data = ((x * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)) \
        .astype(np.uint8)
    want = cpu_candidates(data, params, force_numpy=True)
    if not np.array_equal(candidates(data, params), want):
        return False
    split = 70_003
    got = candidates(data[split:], params, prefix=data[:split][-63:],
                     global_offset=split)
    if not np.array_equal(got, want[want > split]):
        return False
    return np.array_equal(
        candidates(data, params, force_numpy=True), want)


def available() -> bool:
    """Latched self-test: computed once per process, False on any
    mismatch or exception (fail closed, scan stays scalar)."""
    global _probe_ok
    if _probe_ok is None:
        L = logging.getLogger(__name__)
        try:
            _probe_ok = bool(_self_test())
        except Exception as e:
            L.warning("vector chunker self-test raised (%s: %s); "
                      "degrading to the scalar backend",
                      type(e).__name__, e)
            _probe_ok = False
        if not _probe_ok:
            L.warning("vector chunker self-test failed parity; scans "
                      "will use the scalar backend")
    return _probe_ok


class ResilientVectorFactory:
    """Chunker factory with self-test-gated scalar degradation.

    ``_ChunkedStream`` calls ``bind_stream(params)`` once per stream;
    the vector-vs-scalar decision is pinned there for the stream's whole
    life, mirroring ``sidecar.ResilientSidecarFactory`` — a mid-stream
    swap would move every later cut point and silently destroy dedup.
    Degradation is latched process-wide (the self-test is deterministic,
    so retrying per stream would only re-fail).  The stream's
    ``bound_backend`` label comes from the chunker INSTANCE the pinned
    factory builds, so a degraded stream correctly reports "cpu"."""

    def bind_stream(self, params: ChunkerParams):
        if available():
            return VectorChunker
        observe.add_event("vector_fallbacks")
        return CpuChunker

    def __call__(self, params: ChunkerParams):
        """Plain-factory compatibility (callers that never bind)."""
        return self.bind_stream(params)(params)
