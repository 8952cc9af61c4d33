"""Build and bind the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``.  The library's file name carries a hash of its source and the
flags, so an edit rebuilds.  ``ptxas``'s report (registers, shared
memory and spills of each kernel) is kept beside the library.  Several
sources build in parallel, one ``nvcc`` process each.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("rolling_hash", "sha256")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_load_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Build every named source that is not built yet, all ``nvcc``
    processes started together; returns the seconds it took.  Raises
    ``KernelBuildError`` with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            out.with_name(out.name + ".log").write_bytes(log)
            os.replace(tmp, out)        # atomic: concurrent builds agree
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          + log.decode(errors="replace"))
    if failed:
        raise KernelBuildError("\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list[str]:
    """The ``ptxas info`` lines of ``csrc/<name>.cu``'s build: per kernel,
    registers, barriers, shared memory, stack and spills."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    if not log.exists():
        return []
    keep = ("Compiling entry", "Used", "spill", "stack frame")
    return [" ".join(line.split()) for line in log.read_text().splitlines()
            if any(k in line for k in keep)]


def _library(name: str) -> ctypes.CDLL:
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


class Kernel:
    """One C entry point of a kernel library.

    The C function takes the CUDA device index first and returns the
    ``cudaError_t`` of its launch; a non-zero code raises.  The caller's
    current device is the same after the call as before it.  ``launches``
    counts the launches made through this object, and nothing else adds to
    it."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = [ctypes.c_int, *argtypes]
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def _resolve(self):
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def __call__(self, device_index: int, *args) -> None:
        # the C function sets the device; the guard puts the caller's
        # current device back, so that a launch on another card of a mesh
        # does not move later allocations of "cuda" there
        with torch.cuda.device(device_index):
            code = self._resolve()(device_index, *args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code}: "
                               f"{self._err(code).decode()}")
        with self._count_lock:
            self.launches += 1
