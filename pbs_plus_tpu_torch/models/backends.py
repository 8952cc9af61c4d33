"""The ``"cuda"`` chunker backend: counterparts of ``make_chunker_factory``
and ``make_batch_hasher`` in the JAX package's ``server/backup_job.py``.

A writer (``SessionWriter(chunker_factory=, batch_hasher=)``) reaches the
port's streaming path through these: the factory makes one ``CudaChunker``
per stream, and the hasher digests emitted chunks through the device's
``DeviceFeeder``, coalesced with other writers' batches.
"""

from __future__ import annotations

from .dedup import CudaChunker
from .feeder import get_feeder


def make_chunker_factory(kind: str, *, device="cuda"):
    """Chunker factory for ``kind``; the port serves only ``"cuda"``."""
    if kind != "cuda":
        raise ValueError(f"unknown chunker backend {kind!r} (want cuda)")

    def factory(params):
        return CudaChunker(params, device=device)
    return factory


def make_batch_hasher(kind: str, *, device="cuda"):
    """Batched digest backend matching the chunker backend: ``"cuda"``
    hashes emitted chunks in device batches through the feeder; any other
    kind returns None (the writer hashes inline)."""
    if kind != "cuda":
        return None

    def hasher(chunks):
        return get_feeder(device).sha256_batch(chunks)
    return hasher
