"""Device meshes: named axes over an array of ``torch.device``.

Counterpart of the JAX package's ``parallel/mesh.py``.  The JAX mesh is
single-controller: one process holds a ``jax.sharding.Mesh`` and maps a
function over its devices.  The port keeps that design: one process
drives an array of ``torch.device``s, and the collectives are explicit
tensor copies and sums (``collectives.py``); between distinct cards the
copies are peer copies.  Nothing here uses ``torch.distributed``.

A mesh may name one device more than once.  That is the counterpart of
the JAX tests' virtual CPU devices: ``make_mesh(devices=["cpu"] * 8)`` on
a host without a card, and ``make_mesh(devices=["cuda:0"] * 8)`` on one
card, carry real shard boundaries, halos and partial sums, with every
shard's work on that one device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve, resolve_indexed


class Mesh:
    """An ``np.ndarray`` of ``torch.device`` with one name per axis.

    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh``
    does), ``size`` is the device count and ``devices`` the array."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = devices.size

    def position(self, **coords) -> tuple:
        """The index into ``devices`` at the given axis coordinates
        (``mesh.position(data=i, index=k)``), every other axis at 0."""
        pos = [0] * self.devices.ndim
        for name, c in coords.items():
            pos[self.axis_names.index(name)] = c
        return tuple(pos)

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name``, every other axis at 0: where
        a mapping over that axis alone places its shards."""
        return list(self.devices[self.position(**{axis_name: slice(None)})])


def _devices(n_devices: int | None, devices) -> list[torch.device]:
    """``devices`` (default: every visible card) cut to ``n_devices``;
    raises when more are asked for than the list holds."""
    if devices is None:
        resolve("cuda")             # raises without a card
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_indexed(d) for d in devices]
    n = n_devices or len(devs)
    if not 0 < n <= len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(n_devices: int | None = None, *, devices=None,
              axis_names: tuple[str, str] = ("data", "index"),
              index_parallel: int | None = None) -> Mesh:
    """2D mesh (data x index).  ``index_parallel`` defaults to 2 when the
    device count is even (so collectives are exercised on both axes), else
    1.  ``devices`` (may repeat a device) defaults to ``cuda:0..n-1``."""
    devs = _devices(n_devices, devices)
    n = len(devs)
    if index_parallel is None:
        index_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    if n % index_parallel:
        raise ValueError("index_parallel must divide device count")
    shape = (n // index_parallel, index_parallel)
    return Mesh(np.array(devs, dtype=object).reshape(shape), axis_names)


def make_seq_mesh(n_devices: int | None = None, *, devices=None,
                  axis_name: str = "seq") -> Mesh:
    """1D mesh for sequence-parallel chunking of one long stream."""
    return Mesh(np.array(_devices(n_devices, devices), dtype=object),
                (axis_name,))


_data_mesh: "Mesh | None | bool" = False          # False = undecided


def data_mesh() -> Mesh | None:
    """Process-wide 1D ``data`` mesh over all visible cards, or None with
    one card or none (or when ``PBS_PLUS_FEEDER_MESH=0``).  The batched
    candidate and SHA dispatches (``ops/rolling_hash.py``,
    ``ops/sha256.py``) shard their rows over it, so the DeviceFeeder's
    and the pipeline's dispatches use every card.

    Decided once per process: callers sit on the hot dispatch path."""
    global _data_mesh
    if _data_mesh is False:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if os.environ.get("PBS_PLUS_FEEDER_MESH", "1") == "0" or n < 2:
            _data_mesh = None
        else:
            _data_mesh = make_seq_mesh(n, axis_name="data")
    return _data_mesh


def set_data_mesh(mesh: Mesh | None) -> Mesh | None:
    """Install ``mesh`` (or no mesh) as the process's data mesh; returns
    the one it replaces.  The counterpart of forcing virtual devices: a
    test or a one-card run puts a repeated-device mesh under the
    dispatches."""
    prev = data_mesh()
    global _data_mesh
    _data_mesh = mesh
    return prev


def dispatch_mesh(n_rows: int, device: torch.device) -> Mesh | None:
    """The data mesh a batched dispatch of ``n_rows`` rows on ``device``
    shards its rows over: the process's ``data_mesh()`` when the batch
    has two rows or more and ``device`` is one of the mesh's, else None
    (the dispatch stays on ``device``)."""
    mesh = data_mesh() if n_rows >= 2 else None
    if mesh is None or device not in list(mesh.devices.flat):
        return None
    return mesh
