"""PyTorch and CUDA port of the pbs-plus-tpu dedup data plane.

The JAX package ``pbs_plus_tpu`` is the reference; this package imports
torch, numpy and the standard library, never JAX and never the reference.
Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
asked for and absent; the tests pass ``device="cpu"``, which runs each
kernel's plain PyTorch version.

- ops: K1 candidate mask and K2 SHA-256 (CUDA C++ for sm_90a, built at
  first use), K3 cuckoo probe in PyTorch ops.
- models: DedupPipeline (whole streams), CudaChunker + DeviceFeeder
  (streaming writers), the ``"cuda"`` backend factories.
- convert: index and chunker state carried across from the JAX package.
"""

from .chunker.spec import (DEFAULT_PARAMS, TEST_PARAMS, WINDOW,
                           ChunkerParams, select_cuts)
from .ops import (CuckooIndex, buckets_for_bytes, candidate_ends_host,
                  candidate_mask, lookup_host, sha256_chunks,
                  sha256_stream_chunks)
from .models import (ChunkRecord, CudaChunker, DedupConfig, DedupPipeline,
                     DeviceFeeder, StreamResult, get_feeder,
                     make_batch_hasher, make_chunker_factory)
from .convert import index_from_reference, params_from_reference

__all__ = [
    "DEFAULT_PARAMS", "TEST_PARAMS", "WINDOW", "ChunkerParams", "select_cuts",
    "candidate_mask", "candidate_ends_host",
    "sha256_chunks", "sha256_stream_chunks",
    "CuckooIndex", "buckets_for_bytes", "lookup_host",
    "DedupPipeline", "DedupConfig", "StreamResult", "ChunkRecord",
    "CudaChunker", "DeviceFeeder", "get_feeder",
    "make_chunker_factory", "make_batch_hasher",
    "index_from_reference", "params_from_reference",
]
