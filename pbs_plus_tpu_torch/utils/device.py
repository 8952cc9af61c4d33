"""Device resolution for the port's entry points.

Counterpart of the JAX package's ``utils/jaxdev.py``, without its relay
probing and without pinning to the CPU: every entry point takes
``device=`` (default ``"cuda"``), and a CUDA request on a host where
``torch.cuda.is_available()`` is False raises.  Nothing falls back to the
CPU; a caller that wants the CPU (the tests do) asks for it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


class CudaUnavailableError(RuntimeError):
    """A CUDA device was requested and none is usable."""


def resolve(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is usable, or names a type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda or cpu)")
    return dev


def resolve_indexed(device: str | torch.device | None = "cuda") -> torch.device:
    """``resolve(device)`` with a CUDA device's index named (``"cuda"``
    becomes the calling thread's current card), so work launched later
    from another thread lands on the same card; raises for an index that
    is not visible."""
    dev = resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is not a visible device "
                             f"({torch.cuda.device_count()} visible)")
    return dev


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory, without a copy.  Read-only arrays
    (views of ``bytes``) are accepted: the port never writes through the
    tensor this returns."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def as_u8(b) -> np.ndarray:
    """``bytes``-like or array input as a 1-D uint8 array, without a copy."""
    if isinstance(b, (bytes, bytearray, memoryview)):
        return np.frombuffer(b, dtype=np.uint8)
    return np.asarray(b, dtype=np.uint8)
