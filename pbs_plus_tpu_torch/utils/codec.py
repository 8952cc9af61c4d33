"""Wire codec of the sidecar's msgpack envelopes.

A copy of the JAX package's ``utils/codec.py``, byte for byte on the wire:
maps of str to scalars and bytes, packed with ``use_bin_type``.  ``msgpack``
is imported inside the functions, so the package imports on a host
without it.
"""

from __future__ import annotations

from typing import Any


def encode(obj: Any) -> bytes:
    import msgpack
    return msgpack.packb(obj, use_bin_type=True)


def decode(data: bytes) -> Any:
    import msgpack
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class DecodeError(ValueError):
    pass


def decode_map(data: bytes) -> dict:
    obj = decode(data)
    if not isinstance(obj, dict):
        raise DecodeError(f"expected map, got {type(obj).__name__}")
    return obj
