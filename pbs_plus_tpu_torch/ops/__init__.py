"""Device kernels of the port.

- rolling_hash: buzhash candidate masks, CUDA kernel K1
  (``csrc/rolling_hash.cu``) and its plain PyTorch version.
- sha256: whole-chunk SHA-256 over slices of one stream buffer, CUDA kernel
  K2 (``csrc/sha256.cu``) and its plain PyTorch version.
- cuckoo: the chunk-index probe (K3) in PyTorch ops on the device table,
  with the host-authoritative insert mirror.
"""

from .rolling_hash import candidate_ends_host, candidate_mask
from .sha256 import sha256_chunks, sha256_stream_chunks
from .cuckoo import CuckooIndex, buckets_for_bytes, lookup_host

__all__ = [
    "candidate_mask", "candidate_ends_host",
    "sha256_chunks", "sha256_stream_chunks",
    "CuckooIndex", "buckets_for_bytes", "lookup_host",
]
