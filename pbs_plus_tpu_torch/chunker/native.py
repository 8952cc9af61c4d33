"""ctypes binding for the C++ native chunker (chunker/csrc/buzhash_native.cpp).

Built on demand with g++ into ``<repo>/build/torch_native/libbuzhash_native.so``.
Falls back cleanly when the toolchain is unavailable (``available()`` →
False); the numpy backend is always present.

A copy of the JAX package's ``chunker/native.py``, its code byte for
byte apart from its two paths: the source is the port's own copy inside
this package (``chunker/csrc/buzhash_native.cpp``, so the agent bundle,
which packs only ``pbs_plus_tpu_torch/``, carries it), and the library
lands in ``build/torch_native/``, beside the CUDA kernels'
``build/torch_kernels/``.  Host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import observe
from .spec import ChunkerParams

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "buzhash_native.cpp")
_SO = os.path.join(_REPO_ROOT, "build", "torch_native",
                   "libbuzhash_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)  # atomic: interrupted builds never corrupt _SO
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not os.path.exists(_SRC) and not os.path.exists(_SO):
                _load_failed = True
                return None
            if os.path.exists(_SRC) and not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _load_failed = True
            return None
        fn = lib.pbs_buzhash_candidates
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # data, n
            ctypes.c_void_p, ctypes.c_int64,   # prefix, prefix_len
            ctypes.c_void_p,                   # table
            ctypes.c_uint32, ctypes.c_uint32,  # mask, magic
            ctypes.c_int64,                    # global_offset
            ctypes.c_void_p, ctypes.c_int64,   # out_ends, out_cap
        ]
        try:
            mt = lib.pbs_buzhash_candidates_mt
        except AttributeError:                 # stale pre-mt .so
            mt = None
        if mt is not None:
            mt.restype = ctypes.c_int64
            mt.argtypes = fn.argtypes + [ctypes.c_int]
        try:                                   # stale pre-vec .so
            vec = lib.pbs_buzhash_candidates_vec
            impl = lib.pbs_buzhash_vec_impl
        except AttributeError:
            vec = impl = None
        if vec is not None:
            vec.restype = ctypes.c_int64
            vec.argtypes = fn.argtypes
            impl.restype = ctypes.c_int
            impl.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def vec_available() -> bool:
    """True when the SIMD-style vectorized scan entry is present (the
    library was built from a source that ships it)."""
    lib = _load()
    return lib is not None and \
        getattr(lib, "pbs_buzhash_candidates_vec", None) is not None


def vec_impl() -> int:
    """0 = unavailable, 1 = generic auto-vectorized blocks, 2 = AVX-512
    (vpermd nibble lookup + vprold fused passes)."""
    if not vec_available():
        return 0
    lib = _load()
    assert lib is not None
    return int(lib.pbs_buzhash_vec_impl())


# buffers below this size aren't worth thread spawn overhead
_MT_THRESHOLD = 4 << 20


def candidates(data: bytes | np.ndarray, params: ChunkerParams, *,
               prefix: bytes = b"", global_offset: int = 0,
               threads: int | None = None) -> np.ndarray:
    """Native equivalent of chunker.cpu.candidates (bit-identical).

    ``threads``: None → auto (multi-threaded segment scan for buffers
    ≥ 4 MiB — deterministic: the hash is position-local, segments seed
    from a 63-byte halo); 1 → force the sequential scan (bench's
    declared single-core baseline uses this)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native chunker unavailable")
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    pfx = np.frombuffer(prefix, dtype=np.uint8)
    table = np.ascontiguousarray(params.table, dtype=np.uint32)
    mt = getattr(lib, "pbs_buzhash_candidates_mt", None)
    if threads is None:
        threads = 0 if (mt is not None and len(arr) >= _MT_THRESHOLD) else 1
    observe.add_scan_bytes("native", len(arr))
    if threads != 1 and mt is not None:
        def call(*args):
            return mt(*args, ctypes.c_int(threads))
    else:
        call = lib.pbs_buzhash_candidates
    return _scan_retry(call, arr, pfx, table, params, global_offset)


def _scan_retry(call, arr: np.ndarray, pfx: np.ndarray, table: np.ndarray,
                params: ChunkerParams, global_offset: int) -> np.ndarray:
    """Shared marshalling + grow-retry loop for every native scan entry
    (they all use the pbs_buzhash_candidates signature and the same
    -1-on-overflow contract)."""
    # expected candidate density ~ n/avg; size output with 8x headroom + slack
    cap = max(1024, 8 * (len(arr) // params.avg_size + 1) + 64)
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = call(arr.ctypes.data, len(arr),
                 pfx.ctypes.data if len(pfx) else None, len(pfx),
                 table.ctypes.data,
                 ctypes.c_uint32(params.mask), ctypes.c_uint32(params.magic),
                 global_offset,
                 out.ctypes.data, cap)
        if n >= 0:
            return out[:n].copy()
        cap *= 4


def candidates_vec(data: bytes | np.ndarray, params: ChunkerParams, *,
                   prefix: bytes = b"",
                   global_offset: int = 0) -> np.ndarray:
    """SIMD-style vectorized scan (the ops/rolling_hash.py doubling
    formulation on CPU vectors) — bit-identical to ``candidates``.
    Raises RuntimeError when the vec entry is unavailable (stale .so or
    no toolchain); chunker/vector.py falls back to its numpy kernel."""
    lib = _load()
    if lib is None or getattr(lib, "pbs_buzhash_candidates_vec", None) is None:
        raise RuntimeError("native vectorized chunker unavailable")
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    pfx = np.frombuffer(prefix, dtype=np.uint8)
    table = np.ascontiguousarray(params.table, dtype=np.uint32)
    observe.add_scan_bytes("vector", len(arr))
    return _scan_retry(lib.pbs_buzhash_candidates_vec, arr, pfx, table,
                       params, global_offset)
