"""Typed ingest-backend protocol: declared capabilities, not duck-typing.

A copy of the JAX package's ``pxar/ingestbackend.py`` (it imports no
JAX).  The write path's batched stages (dedup-index probe, similarity
presketch) reach the store through an explicit seam:

- Stores that implement the batched ingest surface **declare** it via
  ``ingest_capabilities()``, answering with an object that has ``probe``
  and ``presketch`` (a JAX ``ChunkStore`` answers with the JAX package's
  ``IngestCapabilities``; the adapter reads only the two fields, so both
  packages' answers serve).
- ``resolve_ingest_backend(store)`` resolves the declaration once, at
  stream or collector open, into a small typed adapter; writers then
  branch on ``backend.capabilities``.
- A store without the declaration resolves to ``InlineIngestBackend``:
  the declared fallback whose capabilities are statically empty, so
  per-chunk ``insert`` remains the membership oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, runtime_checkable


class IngestCapabilities(NamedTuple):
    """What the store can batch for the write path.

    ``probe``     -- ``probe_batch`` answers membership authoritatively
                    for a whole digest batch (a dedup index is attached).
    ``presketch`` -- ``presketch_batch`` precomputes similarity sketches
                    (and delta-base candidate shortlists) for a batch's
                    novel chunks (the delta tier is attached).
    """

    probe: bool
    presketch: bool


NO_CAPABILITIES = IngestCapabilities(probe=False, presketch=False)


@runtime_checkable
class IngestBackend(Protocol):
    """The batched-stage surface writers consume (``transfer.py``'s
    ``_flush_hashes``, the ``ingestbatch.py`` collector)."""

    @property
    def capabilities(self) -> IngestCapabilities: ...

    def probe_batch(self, digests: "list[bytes]") -> "list[bool] | None": ...

    def presketch_batch(self, digests: "list[bytes]", chunks: "list",
                        known: "list[bool] | None") -> int: ...


class StoreIngestBackend:
    """Adapter over a store that declares ``ingest_capabilities()``.

    ``capabilities`` re-asks the store on every read: index and
    similarity attachments can change after store construction, and the
    answer is two attribute checks."""

    __slots__ = ("_store",)

    def __init__(self, store):
        self._store = store

    @property
    def capabilities(self) -> IngestCapabilities:
        return self._store.ingest_capabilities()

    def probe_batch(self, digests: "list[bytes]") -> "list[bool] | None":
        return self._store.probe_batch(digests)

    def presketch_batch(self, digests: "list[bytes]", chunks: "list",
                        known: "list[bool] | None") -> int:
        return self._store.presketch_batch(digests, chunks, known)


class InlineIngestBackend:
    """The declared index-less fallback: no batched stage exists, so
    every capability is statically False and the batched entry points
    refuse loudly (writers must branch on ``capabilities`` first --
    reaching a method anyway is a caller bug, not a silent no-op)."""

    __slots__ = ("_store",)

    capabilities = NO_CAPABILITIES

    def __init__(self, store):
        self._store = store

    def probe_batch(self, digests):
        raise TypeError(
            f"{type(self._store).__name__} declares no batched probe "
            "capability -- branch on backend.capabilities.probe")

    def presketch_batch(self, digests, chunks, known):
        raise TypeError(
            f"{type(self._store).__name__} declares no presketch "
            "capability -- branch on backend.capabilities.presketch")


def resolve_ingest_backend(store) -> IngestBackend:
    """Resolve a store's declared ingest capabilities into a typed
    backend (one declaration lookup, at stream/collector open)."""
    decl = getattr(store, "ingest_capabilities", None)
    if callable(decl):
        return StoreIngestBackend(store)
    return InlineIngestBackend(store)
