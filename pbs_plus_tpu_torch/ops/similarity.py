"""Cross-snapshot near-duplicate detection in PyTorch ops: simhash and
minhash over chunk digests, and 64-bit content sketches over chunk bytes.

Counterpart of the JAX package's ``ops/similarity.py``.  Its device
programs were jnp lowered by XLA, not Pallas kernels; here they are
PyTorch ops on the caller's device, each beside the numpy twin it is held
against (``*_host``, copied from the JAX package).

- simhash: each digest's 256 bits become a +-1 vector, a fixed random
  projection maps it to ``k`` scores, and their signs pack into ``k``-bit
  sketches.  The projection is the JAX package's
  ``jax.random.normal(PRNGKey(1234), (256, k))``, which torch cannot
  regenerate: it ships exported in ``simhash_projection.npz`` for k = 32,
  64, 128 and 256.  Scores are summed in float64 on every device, as the
  numpy twin sums them, so no sign rides a float32 summation-order
  boundary.
- minhash: ``k`` affine uint32 hashes of one word per digest, the minimum
  over the set; equal components estimate Jaccard similarity.
- content sketches: per chunk, every 4-byte window hashes through two
  integer mixes; windows whose first mix falls in a 1/64 sample class
  give a 64-bit feature, and the per-bit majority over the set of unique
  features packs into a 64-bit sketch.

uint32 arithmetic runs in int64 tensors (``_u32``).  ``stats`` counts the
device programs dispatched, one per call of a device entry point.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils.device import host_tensor, resolve
from ._u32 import M32, be_words, length_groups, mul32, popcount32

PROJECTION_FILE = Path(__file__).with_name("simhash_projection.npz")
PROJECTION_SEED = 1234

# elements of one [rows, width] int64 working set: pairwise Hamming rows
# and content-sketch groups are dispatched in pieces of at most this size
BLOCK_ELEMS = 1 << 25
GROUP_ELEMS = 1 << 27

stats = {"simhash": 0, "minhash": 0, "pairwise_hamming": 0,
         "content_sketch": 0}
_stats_lock = threading.Lock()


def _bump(counter: str) -> None:
    with _stats_lock:
        stats[counter] += 1


def _digest_tensor(digests, device) -> torch.Tensor:
    """uint8[N, 32] digests as a tensor: a tensor is used where it lies,
    anything else is copied to ``device``."""
    if isinstance(digests, torch.Tensor):
        return digests.to(torch.uint8).reshape(-1, 32)
    arr = np.ascontiguousarray(np.asarray(digests, dtype=np.uint8))
    return host_tensor(arr).to(resolve(device)).reshape(-1, 32)


def _word_tensor(x, device) -> torch.Tensor:
    """32-bit words (numpy uint32, or a tensor of int64 or int32 bit
    patterns) as int64 in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    arr = np.asarray(x, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(resolve(device))


# -- simhash ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _projections() -> dict[int, np.ndarray]:
    with np.load(PROJECTION_FILE) as z:
        out = {int(name[1:]): z[name] for name in z.files}
    for a in out.values():
        a.setflags(write=False)
    return out


def simhash_projection(k: int = 64, seed: int = PROJECTION_SEED) -> np.ndarray:
    """float32[256, k]: the JAX package's ``simhash_projection(k, seed)``,
    read from the exported file (read-only).  Only seed 1234 and
    k in {32, 64, 128, 256} ship; any other raises ``ValueError``, and the
    caller passes its own ``proj=``."""
    projs = _projections()
    if seed != PROJECTION_SEED or k not in projs:
        raise ValueError(
            f"no exported simhash projection for k={k}, seed={seed} "
            f"(shipped: seed {PROJECTION_SEED}, k in {sorted(projs)}); "
            "pass proj= explicitly")
    return projs[k]


def _digests_to_bits(d: torch.Tensor) -> torch.Tensor:
    """uint8[N, 32] -> float64 +-1 [N, 256] (byte-major, MSB first)."""
    shifts = torch.arange(7, -1, -1, device=d.device)
    bits = (d.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(d.shape[0], 256).to(torch.float64) * 2.0 - 1.0


def _simhash(d: torch.Tensor, proj: torch.Tensor, k: int) -> torch.Tensor:
    _bump("simhash")
    scores = _digests_to_bits(d) @ proj                  # float64 [N, k]
    signs = (scores >= 0).to(torch.int64).reshape(-1, k // 32, 32)
    shifts = torch.arange(31, -1, -1, device=d.device)
    return (signs << shifts).sum(dim=-1)


def simhash_sketch(digests, *, k: int = 64, proj=None,
                   device="cuda") -> torch.Tensor:
    """uint8[N, 32] digests -> int64[N, k/32] sketch words (uint32 values)
    on the digests' device: a tensor is used where it lies, anything else
    is copied to ``device``."""
    if k % 32:
        raise ValueError("k must be a multiple of 32")
    if proj is None:
        proj = simhash_projection(k)
    d = _digest_tensor(digests, device)
    p = proj if isinstance(proj, torch.Tensor) else torch.from_numpy(
        np.asarray(proj, dtype=np.float64))
    if p.shape != (256, k):
        raise ValueError(f"proj must be [256, {k}], got {list(p.shape)}")
    return _simhash(d, p.to(device=d.device, dtype=torch.float64), k)


# -- Hamming distances ---------------------------------------------------------

def pairwise_hamming(a, b, *, device="cuda") -> torch.Tensor:
    """a uint32[N, W], b uint32[M, W] -> int32[N, M] Hamming distances, on
    the inputs' device (tensors are used where they lie, arrays copied to
    ``device``).  The [rows, M, W] XOR goes in row blocks of at most
    ``BLOCK_ELEMS`` elements, so a 10k x 10k matrix needs no more than the
    result and one block."""
    x = _word_tensor(a, device)
    y = _word_tensor(b, device).to(x.device)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError("a and b must be [N, W] and [M, W]")
    _bump("pairwise_hamming")
    n, m, w = x.shape[0], y.shape[0], x.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=x.device)
    rows = max(1, BLOCK_ELEMS // max(1, m * w))
    for r in range(0, n, rows):
        xor = x[r:r + rows, None, :] ^ y[None, :, :]
        out[r:r + rows] = popcount32(xor).sum(dim=-1).to(torch.int32)
    return out


# -- minhash -----------------------------------------------------------------

def _minhash_params(k: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, size=k, dtype=np.uint64) | 1  # odd multipliers
    b = rng.integers(0, 1 << 32, size=k, dtype=np.uint64)
    return a.astype(np.uint32), b.astype(np.uint32)


def _minhash(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8[N, 32] digests, int64[k] multipliers and offsets -> int64[k]:
    one uint32 word per digest (bytes 0-3 XOR bytes 4-7, big-endian), then
    ``min over the set of (w * a + b) mod 2**32``, in row blocks."""
    _bump("minhash")
    q = d[:, :8].to(torch.int64).reshape(-1, 2, 4)
    w = be_words(q[:, 0]) ^ be_words(q[:, 1])
    k = a.numel()
    rows = max(1, BLOCK_ELEMS // k)
    out = None
    for r in range(0, w.numel(), rows):
        h = (mul32(w[r:r + rows, None], a[None, :]) + b[None, :]) & M32
        part = h.min(dim=0).values
        out = part if out is None else torch.minimum(out, part)
    if out is None:
        raise ValueError("minhash of an empty digest set")
    return out


def minhash_signature(digests, *, k: int = 128, seed: int = 99,
                      device="cuda") -> np.ndarray:
    """uint8[N, 32] digest set -> uint32[k] minhash signature, computed
    on the digests' device (see ``simhash_sketch``)."""
    d = _digest_tensor(digests, device)
    a, b = _minhash_params(k, seed)
    sig = _minhash(d, torch.from_numpy(a.astype(np.int64)).to(d.device),
                   torch.from_numpy(b.astype(np.int64)).to(d.device))
    return sig.cpu().numpy().astype(np.uint32)


def minhash_similarity(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    """Estimated Jaccard similarity of two digest sets."""
    if sig_a.shape != sig_b.shape:
        raise ValueError("signature length mismatch")
    return float(np.mean(sig_a == sig_b))


# -- numpy twins (copied from the JAX package) --------------------------------

def simhash_sketch_host(digests: np.ndarray, *, k: int = 64,
                        proj: np.ndarray | None = None) -> np.ndarray:
    """numpy twin of ``simhash_sketch``: uint8[N,32] -> uint32[N, k/32].
    Same +-1 bit expansion, same projection, scores accumulated in
    float64."""
    if k % 32:
        raise ValueError("k must be a multiple of 32")
    if proj is None:
        proj = simhash_projection(k)
    d = np.asarray(digests, dtype=np.uint8).reshape(-1, 32)
    shifts = np.arange(7, -1, -1, dtype=np.uint8)
    bits = ((d[:, :, None] >> shifts[None, None, :]) & np.uint8(1))
    bits = bits.reshape(d.shape[0], 256).astype(np.float64) * 2.0 - 1.0
    scores = bits @ np.asarray(proj, dtype=np.float64)
    b = (scores >= 0).astype(np.uint32).reshape(-1, k // 32, 32)
    sh = np.arange(31, -1, -1, dtype=np.uint32)
    return np.sum(b << sh[None, None, :], axis=-1, dtype=np.uint32)


def minhash_signature_host(digests: np.ndarray, *, k: int = 128,
                           seed: int = 99) -> np.ndarray:
    """numpy twin of ``minhash_signature`` (uint32 wraparound arithmetic
    -- exact parity)."""
    d = np.asarray(digests, dtype=np.uint8).reshape(-1, 32).astype(np.uint32)
    a, b = _minhash_params(k, seed)
    w = (d[:, 0] << np.uint32(24)) | (d[:, 1] << np.uint32(16)) \
        | (d[:, 2] << np.uint32(8)) | d[:, 3]
    w = w ^ ((d[:, 4] << np.uint32(24)) | (d[:, 5] << np.uint32(16))
             | (d[:, 6] << np.uint32(8)) | d[:, 7])
    with np.errstate(over="ignore"):
        h = w[:, None].astype(np.uint32) * a[None, :] + b[None, :]
    return np.min(h, axis=0).astype(np.uint32)


def pairwise_hamming_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy twin of ``pairwise_hamming``: uint32[N,W] x uint32[M,W] ->
    int32[N,M] (exact -- popcount over xor)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.sum(np.unpackbits(
        x.astype(">u4").view(np.uint8), axis=-1), axis=-1).astype(np.int32)


# -- content sketches -----------------------------------------------------------

_WMULT = np.uint32(0x9E3779B1)     # Knuth/golden-ratio multiplicative hash
_MIX2 = np.uint32(0x85EBCA6B)      # murmur3 finalizer odd constant
_SAMPLE_MASK = np.uint32(63)       # 1/64 of windows become features
_SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _window_words_host(b: np.ndarray) -> np.ndarray:
    """uint8[n] -> uint32[n-3] big-endian 4-byte windows."""
    w = b.astype(np.uint32)
    return ((w[:-3] << np.uint32(24)) | (w[1:-2] << np.uint32(16))
            | (w[2:-1] << np.uint32(8)) | w[3:])


def _mix_host(w: np.ndarray, mult: np.uint32) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (w * mult).astype(np.uint32)
        h ^= h >> np.uint32(15)
        h = (h * np.uint32(0x2C1B3C6D)).astype(np.uint32)
        h ^= h >> np.uint32(12)
    return h


def content_sketch_host(chunks: "list[bytes]") -> np.ndarray:
    """Batched 64-bit content simhash per chunk: list of byte strings ->
    uint64[N] sketches (module docstring).  Pure numpy; the parity oracle
    of ``content_sketch_device``."""
    out = np.empty(len(chunks), dtype=np.uint64)
    for i, chunk in enumerate(chunks):
        out[i] = _content_sketch_one_host(chunk)
    return out


def _content_sketch_one_host(chunk: bytes) -> np.uint64:
    b = np.frombuffer(chunk, dtype=np.uint8)
    if b.size < 4:
        # degenerate chunk: sketch the padded bytes directly so equal
        # tiny chunks still sketch equal (they dedup exactly anyway)
        b = np.concatenate([b, np.zeros(4 - b.size, dtype=np.uint8)])
    w = _window_words_host(b)
    h_lo = _mix_host(w, _WMULT)
    sel = (h_lo & _SAMPLE_MASK) == 0
    if not sel.any():
        sel = np.zeros(w.size, dtype=bool)
        sel[0] = True               # at least one feature per chunk
    lo = h_lo[sel]
    hi = _mix_host(w[sel], _MIX2)
    # set semantics: the majority votes once per unique feature; the
    # all-ones value is the device path's sentinel and is excluded here
    # too (a 2^-64 feature loss)
    f = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    f = f[f != _SENTINEL64]
    if f.size == 0:
        f = np.zeros(1, dtype=np.uint64)
    uniq = np.unique(f)
    m = uniq.size
    lo_u = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi_u = (uniq >> np.uint64(32)).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    ones_lo = ((lo_u[:, None] >> shifts[None, :]) & np.uint32(1)) \
        .sum(axis=0, dtype=np.int64)
    ones_hi = ((hi_u[:, None] >> shifts[None, :]) & np.uint32(1)) \
        .sum(axis=0, dtype=np.int64)
    # majority vote with a deterministic >=half tie-break
    bits_lo = (2 * ones_lo >= m).astype(np.uint64)
    bits_hi = (2 * ones_hi >= m).astype(np.uint64)
    sh64 = np.arange(32, dtype=np.uint64)
    word_lo = np.bitwise_or.reduce(bits_lo << sh64)
    word_hi = np.bitwise_or.reduce(bits_hi << sh64)
    return np.uint64((int(word_hi) << 32) | int(word_lo))


def _mix(x: torch.Tensor, mult: int) -> torch.Tensor:
    h = mul32(x, mult)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _content_sketch_words(data: torch.Tensor, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """uint8[n, L] padded chunks + int64[n] lengths (each >= 4) ->
    int64[n, 2] (lo, hi) sketch words.

    The sampled windows are compacted first (about 1 in 64), each to one
    int64 feature ``hi * 2**32 + lo`` with ``hi`` taken as signed, so the
    all-ones sentinel pair is -1 and is dropped explicitly.  Two stable
    sorts, by feature and then by row, group every row's features in
    order; a first-occurrence mask keeps each unique feature once (any
    total order serves a count of unique values), and per-row sums of
    their bits, read off a running sum, give the majority vote."""
    n = data.shape[0]
    dev = data.device
    w8 = data.to(torch.int64)
    w = (w8[:, :-3] << 24) | (w8[:, 1:-2] << 16) | (w8[:, 2:-1] << 8) \
        | w8[:, 3:]
    del w8
    h_lo = _mix(w, int(_WMULT))
    pos = torch.arange(w.shape[1], device=dev)
    sel = (pos[None, :] < (lengths[:, None] - 3)) \
        & ((h_lo & int(_SAMPLE_MASK)) == 0)
    # degenerate rows take window 0 as their lone feature (host parity)
    sel[:, 0] |= ~sel.any(dim=1)
    row, col = sel.nonzero(as_tuple=True)
    lo = h_lo[row, col]
    hi = _mix(w[row, col], int(_MIX2))
    del w, h_lo, sel
    f = lo + (hi - ((hi >> 31) << 32)) * (1 << 32)
    keep = f != -1
    row, f = row[keep], f[keep]
    f, o = torch.sort(f, stable=True)
    row = row[o]
    row, o = torch.sort(row, stable=True)
    f = f[o]
    first = torch.ones_like(row, dtype=torch.bool)
    first[1:] = (row[1:] != row[:-1]) | (f[1:] != f[:-1])
    row, f = row[first], f[first]
    m = torch.bincount(row, minlength=n)
    shifts = torch.arange(32, device=dev)
    # bit b of feature u at b * U + u: one flat running sum (a scan over
    # the outer dim of a [U, 64] tensor runs 64 serial chains on CUDA)
    u = f.numel()
    bits = torch.cat([((f & M32)[None, :] >> shifts[:, None]) & 1,
                      (((f >> 32) & M32)[None, :] >> shifts[:, None]) & 1])
    run = torch.zeros(64 * u + 1, dtype=torch.int64, device=dev)
    torch.cumsum(bits.view(-1), dim=0, out=run[1:])
    end = torch.cumsum(m, dim=0)[:, None] + u * torch.arange(64, device=dev)
    ones = run[end] - run[end - m[:, None]]
    # majority with the >= half tie-break; a row whose every feature was
    # the sentinel sketches 0, as the host's lone zero feature does
    word_bits = (2 * ones >= m[:, None]).to(torch.int64)
    words = torch.stack([(word_bits[:, :32] << shifts).sum(dim=1),
                         (word_bits[:, 32:] << shifts).sum(dim=1)], dim=1)
    words[m == 0] = 0
    return words


def content_sketch_device(chunks: "list[bytes]", *, device="cuda"
                          ) -> np.ndarray:
    """Torch twin of ``content_sketch_host``, on ``device``: uint64[N],
    bit-identical to the host path (the uint64 is put together in numpy).

    Chunks go in length-sorted groups of at most ``GROUP_ELEMS`` padded
    bytes (a chunk longer than that goes alone), each zero-padded to its
    group's longest.  This is exact: a row's sketch reads only its windows
    below ``length - 3``, so the pad never reaches a feature."""
    if not chunks:
        return np.empty(0, dtype=np.uint64)
    dev = resolve(device)
    _bump("content_sketch")
    lens = np.array([max(4, len(c)) for c in chunks], dtype=np.int64)
    lo = np.empty(len(chunks), dtype=np.uint64)
    hi = np.empty(len(chunks), dtype=np.uint64)
    for group in length_groups(lens, GROUP_ELEMS):
        L = int(lens[group].max())
        padded = np.zeros((len(group), L), dtype=np.uint8)
        for r, i in enumerate(group):
            padded[r, :len(chunks[i])] = np.frombuffer(chunks[i], np.uint8)
        words = _content_sketch_words(
            torch.from_numpy(padded).to(dev),
            torch.from_numpy(lens[group]).to(dev)).cpu().numpy()
        lo[group] = words[:, 0].astype(np.uint64)
        hi[group] = words[:, 1].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def sketch_hamming(a: int, b: int) -> int:
    """Hamming distance between two 64-bit content sketches."""
    return int(bin(int(a) ^ int(b)).count("1"))
