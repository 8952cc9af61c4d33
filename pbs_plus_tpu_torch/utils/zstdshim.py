"""Minimal ``zstandard``-compatible shim over the system libzstd (ctypes).

Some deployment images (including this one) lack the ``zstandard`` wheel
but ship ``libzstd.so.1``.  This shim exposes exactly the API surface the
repo uses — ``ZstdCompressor(level=).compress``, ``ZstdDecompressor()
.decompress(data, max_output_size=)``, ``ZstdError`` — producing and
consuming REAL zstd frames via the one-shot libzstd API, so the on-disk
chunk/blob format stays byte-compatible with a zstandard-equipped
install (the simple API embeds the frame content size, exactly like the
python binding's default).

Import-gated consumers do::

    try:
        import zstandard
    except ImportError:
        from ..utils import zstdshim as zstandard

Beyond the wheel-compatible surface, the shim also exposes the
dictionary one-shot API (``compress_with_dict`` /
``decompress_with_dict`` over ``ZSTD_compress_usingDict``) used by the
similarity-dedup delta tier (pxar/deltablob.py): a near-duplicate chunk
compresses against its base chunk as the dictionary, so only the novel
bytes cost storage.  ``dict_available()`` probes for the symbols; the
delta codec degrades to a pure-Python copy/insert patch when they are
missing.

A copy of the JAX package's ``utils/zstdshim.py``, its code byte for
byte apart from its imports, which name the port's own modules; it
imports nothing. A store whose chunks it cannot compress fails: nothing
writes a chunk uncompressed."""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2
_lib: "ctypes.CDLL | None" = None


class ZstdError(Exception):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:                      # no wheel AND no system lib
        raise ImportError(f"libzstd unavailable: {e}") from e
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_int]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                             ctypes.c_size_t]
    # dictionary one-shot API (present in every libzstd >= 1.0); probed
    # defensively because exotic builds may strip symbols
    try:
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_compress_usingDict.restype = ctypes.c_size_t
        lib.ZSTD_compress_usingDict.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_decompress_usingDict.restype = ctypes.c_size_t
        lib.ZSTD_decompress_usingDict.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
        lib._dict_ok = True
    except AttributeError:
        lib._dict_ok = False
    _lib = lib
    return lib


def _err(lib: ctypes.CDLL, code: int) -> str:
    return lib.ZSTD_getErrorName(code).decode(errors="replace")


class ZstdCompressor:
    def __init__(self, level: int = 3, **_kw):
        self._level = level

    def compress(self, data) -> bytes:
        if not isinstance(data, bytes):
            data = bytes(data)
        lib = _load()
        bound = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(max(bound, 1))
        n = lib.ZSTD_compress(dst, bound, data, len(data), self._level)
        if lib.ZSTD_isError(n):
            raise ZstdError(f"compress failed: {_err(lib, n)}")
        return dst.raw[:n]


class ZstdDecompressor:
    def decompress(self, data, max_output_size: int = 0) -> bytes:
        if not isinstance(data, bytes):
            data = bytes(data)
        lib = _load()
        sz = lib.ZSTD_getFrameContentSize(data, len(data))
        if sz == _CONTENTSIZE_ERROR:
            raise ZstdError("input is not a zstd frame")
        if sz == _CONTENTSIZE_UNKNOWN:
            if max_output_size <= 0:
                raise ZstdError("frame content size unknown and no "
                                "max_output_size given")
            # grow-and-retry: frames without an embedded size are rare
            # here (both writers embed it); start small, never allocate
            # the full (possibly GiB-scale) cap up front
            cap = min(max_output_size, max(64 << 10, 4 * len(data)))
            while True:
                out = self._one_shot(lib, data, cap)
                if out is not None:
                    return out
                if cap >= max_output_size:
                    raise ZstdError("decompressed size exceeds "
                                    "max_output_size")
                cap = min(max_output_size, cap * 2)
        if max_output_size and sz > max_output_size:
            raise ZstdError("decompressed size exceeds max_output_size")
        out = self._one_shot(lib, data, int(sz))
        if out is None:
            raise ZstdError("frame declares a smaller size than it holds")
        return out

    @staticmethod
    def _one_shot_dict(lib: ctypes.CDLL, data: bytes, cap: int,
                       dict_bytes: bytes) -> bytes | None:
        """Dict twin of ``_one_shot``; None = destination too small."""
        dctx = _thread_dctx(lib)
        dst = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress_usingDict(dctx, dst, cap, data, len(data),
                                          dict_bytes, len(dict_bytes))
        if lib.ZSTD_isError(n):
            msg = _err(lib, n)
            if "too small" in msg:
                return None
            raise ZstdError(f"dict decompress failed: {msg}")
        return dst.raw[:n]

    @staticmethod
    def _one_shot(lib: ctypes.CDLL, data: bytes, cap: int) -> bytes | None:
        """Returns None when the destination was too small (retryable)."""
        dst = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(dst, cap, data, len(data))
        if lib.ZSTD_isError(n):
            msg = _err(lib, n)
            if "too small" in msg:
                return None
            raise ZstdError(f"decompress failed: {msg}")
        return dst.raw[:n]


# -- dictionary one-shot API (delta tier, pxar/deltablob.py) ----------------

# ZSTD_compress_usingDict/ZSTD_decompress_usingDict need an explicit
# context object; contexts are not thread-safe, so each thread keeps one
# of each (write path and prefetch pool call concurrently)
_dict_local = threading.local()


class _CtxHolder:
    """Owns one thread's native (cctx, dctx) pair and frees them when
    the thread-local slot is collected — raw pointers in a
    threading.local would leak the native contexts (window + dict
    state, potentially MBs each) for every worker thread that ever
    delta-coded."""

    __slots__ = ("_lib", "cctx", "dctx")

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self.cctx = 0
        self.dctx = 0

    def __del__(self):
        try:
            if self.cctx:
                self._lib.ZSTD_freeCCtx(self.cctx)
            if self.dctx:
                self._lib.ZSTD_freeDCtx(self.dctx)
        except Exception:  # pbslint: disable=no-silent-swallow
            pass    # interpreter teardown: the lib handle may already
                    # be gone; leaking at exit is the safe direction


def _ctx_holder(lib: ctypes.CDLL) -> _CtxHolder:
    h = getattr(_dict_local, "holder", None)
    if h is None:
        h = _dict_local.holder = _CtxHolder(lib)
    return h


def _thread_cctx(lib: ctypes.CDLL) -> int:
    h = _ctx_holder(lib)
    if not h.cctx:
        h.cctx = lib.ZSTD_createCCtx()
        if not h.cctx:
            raise ZstdError("ZSTD_createCCtx failed")
    return h.cctx


def _thread_dctx(lib: ctypes.CDLL) -> int:
    h = _ctx_holder(lib)
    if not h.dctx:
        h.dctx = lib.ZSTD_createDCtx()
        if not h.dctx:
            raise ZstdError("ZSTD_createDCtx failed")
    return h.dctx


def dict_available() -> bool:
    """True when libzstd loads and exposes the dictionary one-shots."""
    try:
        return bool(_load()._dict_ok)
    except ImportError:
        return False


def compress_with_dict(data, dict_bytes: bytes, level: int = 3) -> bytes:
    """One-shot ``ZSTD_compress_usingDict``: compress ``data`` with
    ``dict_bytes`` as the raw-content dictionary (the delta tier passes
    the base chunk).  The frame only decodes with the same dictionary."""
    if not isinstance(data, bytes):
        data = bytes(data)
    lib = _load()
    if not lib._dict_ok:
        raise ZstdError("libzstd lacks the dictionary API")
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(max(bound, 1))
    n = lib.ZSTD_compress_usingDict(_thread_cctx(lib), dst, bound,
                                    data, len(data),
                                    dict_bytes, len(dict_bytes), level)
    if lib.ZSTD_isError(n):
        raise ZstdError(f"dict compress failed: {_err(lib, n)}")
    return dst.raw[:n]


def decompress_with_dict(data, dict_bytes: bytes,
                         max_output_size: int = 0) -> bytes:
    """One-shot ``ZSTD_decompress_usingDict`` inverse of
    ``compress_with_dict`` (same embedded-content-size semantics as the
    plain decompressor)."""
    if not isinstance(data, bytes):
        data = bytes(data)
    lib = _load()
    if not lib._dict_ok:
        raise ZstdError("libzstd lacks the dictionary API")
    sz = lib.ZSTD_getFrameContentSize(data, len(data))
    if sz == _CONTENTSIZE_ERROR:
        raise ZstdError("input is not a zstd frame")
    if sz == _CONTENTSIZE_UNKNOWN:
        if max_output_size <= 0:
            raise ZstdError("frame content size unknown and no "
                            "max_output_size given")
        cap = min(max_output_size, max(64 << 10, 4 * len(data)))
        while True:
            out = ZstdDecompressor._one_shot_dict(lib, data, cap, dict_bytes)
            if out is not None:
                return out
            if cap >= max_output_size:
                raise ZstdError("decompressed size exceeds max_output_size")
            cap = min(max_output_size, cap * 2)
    if max_output_size and sz > max_output_size:
        raise ZstdError("decompressed size exceeds max_output_size")
    out = ZstdDecompressor._one_shot_dict(lib, data, int(sz), dict_bytes)
    if out is None:
        raise ZstdError("frame declares a smaller size than it holds")
    return out
