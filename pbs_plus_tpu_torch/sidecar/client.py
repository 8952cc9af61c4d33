"""Sidecar client + the chunker-interface adapters that route a writer's
CDC through the sidecar (``chunker = "sidecar:host:port"``).

Resilience wiring (docs/fault-injection.md, docs/data-plane.md):

- one cached stub per method (the old code rebuilt the ``unary_unary``
  callable on every RPC), per-call deadline from ``conf`` (override via
  ``PBS_PLUS_SIDECAR_TIMEOUT``, default 300 s);
- a per-client ``CircuitBreaker`` records every call's outcome;
  *idempotent* methods (stats/probe/insert-index/similarity) get a
  short bounded retry, the stateful ``Chunk`` method never retries (a
  replayed feed would double-append to the sidecar's stream carry);
- ``ResilientSidecarFactory`` degrades to the CPU chunker when the
  sidecar is unreachable — decided at stream-OPEN time only, never
  mid-stream: CPU and sidecar cuts are parity-tested identical, but a
  mid-stream swap after a partial carry would move every later cut
  point and silently destroy dedup ("A Thorough Investigation of
  Content-Defined Chunking Algorithms" — cut-point stability is the
  whole game).  ``chunker.vector.ResilientVectorFactory`` applies the
  same bind-time-only discipline to vector -> scalar degradation.

A copy of the JAX package's ``sidecar/client.py``, its code byte for byte
apart from its imports, which name the port's own modules (the breaker
and retries of ``utils/resilience.py``), its logger (``logging``) and
one change: ``grpc`` is imported when a client is made, not with the
module (the import gate runs the port with grpc blocked), so the tuple
of retryable errors is the client's ``_retryable``.  A port sidecar
(``DedupService``, served by ``serve_sidecar``) on the card answers a
``SidecarChunker`` with K1's cuts.
"""

from __future__ import annotations

import logging

from ..chunker import observe
from ..chunker.spec import ChunkerParams
from ..utils import codec, conf, failpoints, trace
from ..utils.resilience import CircuitBreaker, retry_sync

L = logging.getLogger(__name__)


class SidecarClient:
    def __init__(self, address: str, *, timeout_s: float | None = None,
                 breaker: CircuitBreaker | None = None):
        import grpc

        # transient transport classes worth a second attempt on
        # idempotent RPCs
        self._retryable = (grpc.RpcError, ConnectionError, OSError)
        self.address = address
        self.channel = grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", 128 << 20),
                     ("grpc.max_send_message_length", 128 << 20)])
        self._stubs: dict[str, object] = {}
        self.timeout_s = (conf.env().sidecar_timeout_s
                          if timeout_s is None else float(timeout_s))
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=15.0,
            name=f"sidecar:{address}")

    def _stub(self, method: str):
        fn = self._stubs.get(method)
        if fn is None:
            fn = self._stubs[method] = self.channel.unary_unary(
                method,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
        return fn

    def _call(self, method: str, req: dict, *,
              idempotent: bool = True) -> dict:
        fn = self._stub(method)

        def once() -> dict:
            failpoints.hit("sidecar.call")
            with trace.span("sidecar.call", method=method):
                return codec.decode_map(fn(codec.encode(req),
                                           timeout=self.timeout_s))

        def guarded() -> dict:
            return self.breaker.call_sync(once)

        if not idempotent:
            return guarded()
        return retry_sync(guarded, attempts=3, base_delay_s=0.2,
                          max_delay_s=2.0, name=f"sidecar{method}",
                          retry_on=self._retryable)

    def chunk(self, stream_id: str, data: bytes, *, eof: bool = False) -> dict:
        # stateful per stream_id: NEVER retried (see module docstring)
        return self._call("/pbsplus.Dedup/Chunk",
                          {"stream_id": stream_id, "data": data, "eof": eof},
                          idempotent=False)

    def probe_index(self, digests: list[bytes]) -> list[bool]:
        return self._call("/pbsplus.Dedup/ProbeIndex",
                          {"digests": digests})["present"]

    def insert_index(self, digests: list[bytes]) -> int:
        return self._call("/pbsplus.Dedup/InsertIndex",
                          {"digests": digests})["inserted"]

    def stats(self) -> dict:
        return self._call("/pbsplus.Dedup/Stats", {})

    def snapshot_signature(self, digests: list[bytes]) -> list[int]:
        return self._call("/pbsplus.Dedup/Similarity",
                          {"digests": digests})["signature"]

    def close(self) -> None:
        self.channel.close()


class SidecarChunker:
    """feed/finalize chunker backed by the sidecar's Chunk method —
    plugs into transfer writers like Cpu/TpuChunker.  Stream ids are
    uuids: many processes share one sidecar without collisions."""

    backend_name = "sidecar"

    def __init__(self, params: ChunkerParams, client: SidecarClient):
        import uuid
        self.client = client
        self.stream_id = uuid.uuid4().hex
        self._finalized = False
        # the sidecar chunks with ITS params — a silent mismatch would move
        # every cut point, so verify once per (client, params) combination
        # (cached on the client object itself)
        key = (params.avg_size, params.min_size, params.max_size, params.seed)
        checked = getattr(client, "_checked_params", None)
        if checked is None:
            checked = client._checked_params = set()
        if key not in checked:
            remote = client.stats().get("chunker", {})
            if remote and (remote.get("avg") != params.avg_size
                           or remote.get("seed") != params.seed
                           or remote.get("min") != params.min_size
                           or remote.get("max") != params.max_size):
                raise ValueError(
                    f"sidecar chunker params {remote} differ from the "
                    f"writer's (avg={params.avg_size}, seed={params.seed})")
            checked.add(key)

    def feed(self, data: bytes) -> list[int]:
        if self._finalized:
            raise RuntimeError("chunker already finalized")
        observe.add_scan_bytes("sidecar", len(data))
        return list(self.client.chunk(self.stream_id, bytes(data))["cuts"])

    def finalize(self) -> list[int]:
        if self._finalized:
            return []
        self._finalized = True
        return list(self.client.chunk(self.stream_id, b"", eof=True)["cuts"])


class ResilientSidecarFactory:
    """Chunker factory with breaker-gated CPU degradation.

    ``_ChunkedStream`` calls ``bind_stream(params)`` once per stream; the
    sidecar-vs-CPU decision is pinned there for the stream's whole life
    (``flush_chunker``/``append_ref`` restarts reuse the pinned factory).
    A sidecar that dies MID-stream therefore fails the stream — the
    job-level retry reopens it, finds the breaker open, and degrades to
    CPU for the rerun (incremental by construction: committed chunks are
    already in the store).
    """

    def __init__(self, address: str, *,
                 client: SidecarClient | None = None):
        self.client = client or SidecarClient(address)

    def bind_stream(self, params: ChunkerParams):
        from ..chunker import CpuChunker
        try:
            # explicit liveness probe through the breaker + bounded retry
            # (NOT just the params check — that is cached per client, and
            # a stream opened after a mid-stream sidecar death must still
            # observe the outage here, where degrading is safe)
            self.client.stats()
            probe = SidecarChunker(params, self.client)
        except Exception as e:
            L.warning("sidecar %s unavailable at stream open (%s: %s); "
                      "degrading this stream to the CPU chunker",
                      self.client.address, type(e).__name__, e)
            return CpuChunker
        first = [probe]

        def factory(p: ChunkerParams):
            # reuse the probe only for the params it was built with —
            # a chunker for different params must be a fresh one
            if first and p == params:
                return first.pop()
            return SidecarChunker(p, self.client)
        return factory

    def __call__(self, params: ChunkerParams):
        """Plain-factory compatibility (callers that never bind): one
        chunker, no degradation."""
        return SidecarChunker(params, self.client)
