"""Small-file IO helpers that own their handles.

Two pbslint rules funnel here: ``resource-ctx`` (an ``open(p).read()``
chain leaks the handle to the GC) and ``no-blocking-in-async`` (the
server event loop serves every agent at once, so even small config
reads go through a worker thread).  ``read_*``/``write_*`` are the
``with``-scoped sync forms; ``aread_*``/``awrite_*`` are the same ops
hopped onto ``asyncio.to_thread`` for use inside server handlers.

``write_private_*`` creates the file 0o600 from the first byte —
the key-material pattern (an atomic-rename dance is overkill for
certs/keys written once at bootstrap, but mode-at-create matters).

A copy of the JAX package's ``utils/fsio.py``, its code byte for
byte.
"""

from __future__ import annotations

import asyncio
import os


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_text(path: str, encoding: str = "utf-8") -> str:
    with open(path, "r", encoding=encoding) as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    with open(path, "w", encoding=encoding) as f:
        f.write(text)


def write_private_bytes(path: str, data: bytes) -> None:
    """Write key material: the file never exists with open modes.
    The mode argument to os.open only applies at CREATION — an
    existing world-readable file would keep its mode through O_TRUNC —
    so the mode is re-asserted on the open fd every time."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        if hasattr(os, "fchmod"):   # absent on Windows (agent bootstrap)
            os.fchmod(fd, 0o600)
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
    finally:
        os.close(fd)


async def aread_bytes(path: str) -> bytes:
    return await asyncio.to_thread(read_bytes, path)


async def aread_text(path: str, encoding: str = "utf-8") -> str:
    return await asyncio.to_thread(read_text, path, encoding)


async def awrite_bytes(path: str, data: bytes) -> None:
    await asyncio.to_thread(write_bytes, path, data)


async def awrite_text(path: str, text: str, encoding: str = "utf-8") -> None:
    await asyncio.to_thread(write_text, path, text, encoding)
