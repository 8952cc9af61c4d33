"""The wire half of the sidecar client: one gRPC channel to a sidecar, the
five methods, msgpack maps in and out.

Counterpart of the JAX package's ``SidecarClient`` without its circuit
breaker and retries, which belong to the server side that routes a
writer's chunking through a sidecar (the JAX package's ``SidecarChunker``
and ``ResilientSidecarFactory`` work against this package's server
unchanged).  ``grpc`` is imported when a client is made.
"""

from __future__ import annotations

from ..utils import codec


class SidecarClient:
    def __init__(self, address: str, *, timeout_s: float = 300.0):
        import grpc

        self.address = address
        self.timeout_s = float(timeout_s)
        self.channel = grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", 128 << 20),
                     ("grpc.max_send_message_length", 128 << 20)])
        self._stubs: dict[str, object] = {}

    def _call(self, method: str, req: dict) -> dict:
        fn = self._stubs.get(method)
        if fn is None:
            fn = self._stubs[method] = self.channel.unary_unary(
                method, request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
        return codec.decode_map(fn(codec.encode(req), timeout=self.timeout_s))

    def chunk(self, stream_id: str, data: bytes, *, eof: bool = False) -> dict:
        return self._call("/pbsplus.Dedup/Chunk",
                          {"stream_id": stream_id, "data": data, "eof": eof})

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
