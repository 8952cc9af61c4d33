"""The dedup sidecar's gRPC service on the card: Chunk(stream pages) ->
cut points + digests.

Counterpart of the JAX package's ``sidecar/service.py``, with the same
wire: msgpack request and response maps over grpc, 128 MiB message limits.

    /pbsplus.Dedup/Chunk        {stream_id, data, eof} ->
                                {cuts: [abs offsets], digests: [32B], sizes}
    /pbsplus.Dedup/ProbeIndex   {digests: [32B]} -> {present: [bool]}
    /pbsplus.Dedup/InsertIndex  {digests: [32B]} -> {inserted: int}
    /pbsplus.Dedup/Stats        {} -> service stats
    /pbsplus.Dedup/Similarity   {digests: [...]} -> {signature: [u32]}

Chunk is stateful per stream_id (streaming CDC with carry), so many agents
multiplex one sidecar.  Each stream's candidates come from kernel K1
through ``CudaChunker`` and the device's ``DeviceFeeder``, which also
coalesces concurrent streams' SHA-256 batches into K2 launches; the index
probe is K3.  ``grpc`` is imported only by ``serve_sidecar``, so
``DedupService`` runs on a host without it.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures

from ..chunker.spec import ChunkerParams
from ..models.dedup import CudaChunker
from ..models.feeder import get_feeder
from ..models.similarity import SimilarityModel
from ..ops.cuckoo import CuckooIndex
from ..utils import codec
from ..utils.device import resolve

L = logging.getLogger(__name__)

_STREAM_IDLE_EVICT_S = 3600.0      # abandoned-stream GC


class _StreamState:
    def __init__(self, params: ChunkerParams, device):
        self.chunker = CudaChunker(params, device=device)
        self.pending = bytearray()     # bytes not yet emitted as chunks
        self.base = 0                  # stream offset of pending[0]
        self.lock = threading.Lock()   # serialize calls per stream
        self.last_used = time.monotonic()


class DedupService:
    """The five handlers of the sidecar on ``device`` (default the card).
    ``get_stats`` reports ``use_tpu``, the wire's name for "an accelerator
    serves this": true on ``cuda``."""

    def __init__(self, *, params: ChunkerParams | None = None,
                 index_buckets: int = 1 << 20, device="cuda"):
        self.params = params or ChunkerParams(avg_size=4 << 20)
        self.device = resolve(device)
        self.index = CuckooIndex(n_buckets=index_buckets, device=self.device)
        self.similarity = SimilarityModel(device=self.device)
        self._streams: dict[str, _StreamState] = {}
        self._lock = threading.Lock()
        self.stats = {"bytes": 0, "chunks": 0, "streams": 0}

    def handlers(self) -> dict:
        """Method name -> handler, as the wire names them."""
        return {"Chunk": self.chunk, "ProbeIndex": self.probe_index,
                "InsertIndex": self.insert_index, "Stats": self.get_stats,
                "Similarity": self.snapshot_signature}

    def chunk(self, req: dict) -> dict:
        sid = req["stream_id"]
        data = req.get("data", b"")
        eof = bool(req.get("eof", False))
        with self._lock:
            now = time.monotonic()
            # GC streams abandoned by crashed clients (never sent eof)
            for k in [k for k, v in self._streams.items()
                      if now - v.last_used > _STREAM_IDLE_EVICT_S]:
                del self._streams[k]
            st = self._streams.get(sid)
            if st is None:
                st = _StreamState(self.params, self.device)
                self._streams[sid] = st
                self.stats["streams"] += 1
            st.last_used = now
        with st.lock:                       # serialize per-stream feeds
            st.pending += data
            cuts = st.chunker.feed(data) if data else []
            if eof:
                cuts += st.chunker.finalize()
            chunks: list[bytes] = []
            out_cuts: list[int] = []
            for c in cuts:
                n = c - st.base
                chunks.append(bytes(st.pending[:n]))
                del st.pending[:n]
                st.base = c
                out_cuts.append(c)
        # feeder-coalesced: concurrent streams' hash batches land in one
        # K2 launch
        digests = get_feeder(self.device).sha256_batch(chunks) if chunks else []
        with self._lock:
            self.stats["bytes"] += len(data)
            self.stats["chunks"] += len(chunks)
            if eof:
                self._streams.pop(sid, None)
        return {"cuts": out_cuts, "digests": digests,
                "sizes": [len(c) for c in chunks]}

    def probe_index(self, req: dict) -> dict:
        digests = list(req["digests"])
        return {"present": self.index.probe_confirmed(digests)}

    def insert_index(self, req: dict) -> dict:
        return {"inserted": self.index.insert_many(list(req["digests"]))}

    def get_stats(self, req: dict) -> dict:
        return {**self.stats, "index_size": len(self.index),
                "use_tpu": self.device.type == "cuda",
                "chunker": {"avg": self.params.avg_size,
                            "min": self.params.min_size,
                            "max": self.params.max_size,
                            "seed": self.params.seed}}

    def snapshot_signature(self, req: dict) -> dict:
        sig = self.similarity.snapshot_signature(list(req["digests"]))
        return {"signature": [int(x) for x in sig]}


def serve_sidecar(address: str = "127.0.0.1:0", *,
                  params: ChunkerParams | None = None, device="cuda",
                  max_workers: int = 8):
    """Start the sidecar on ``device``; returns (server, bound_port,
    service)."""
    import grpc

    svc = DedupService(params=params, device=device)

    def handler(fn):
        return grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: codec.encode(fn(codec.decode_map(req))),
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b)

    methods = {f"/pbsplus.Dedup/{name}": handler(fn)
               for name, fn in svc.handlers().items()}

    class _Dispatcher(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            return methods.get(handler_call_details.method)

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", 128 << 20),
                 ("grpc.max_send_message_length", 128 << 20)])
    server.add_generic_rpc_handlers((_Dispatcher(),))
    port = server.add_insecure_port(address)
    server.start()
    L.info("dedup sidecar listening on port %d (device=%s)", port, svc.device)
    return server, port, svc
