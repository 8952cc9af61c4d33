"""Pipelines of the port: the dedup data plane on the card.

- DedupPipeline: whole-stream batched chunk + fingerprint + index probe.
- CudaChunker + DeviceFeeder: the streaming path, coalescing concurrent
  writers into one dispatch; ``backends`` selects it for a writer.
- VerifyPipeline: batched re-hash verification of chunks and snapshots.
- SimilarityModel: minhash and simhash over snapshots' chunk digests.
"""

from .dedup import (ChunkRecord, CudaChunker, DedupConfig, DedupPipeline,
                    StreamResult)
from .feeder import DeviceFeeder, get_feeder
from .backends import make_batch_hasher, make_chunker_factory
from .verify import VerifyPipeline, VerifyResult
from .similarity import SimilarityModel

__all__ = [
    "DedupPipeline", "DedupConfig", "StreamResult", "ChunkRecord",
    "CudaChunker", "DeviceFeeder", "get_feeder",
    "make_chunker_factory", "make_batch_hasher",
    "VerifyPipeline", "VerifyResult", "SimilarityModel",
]
