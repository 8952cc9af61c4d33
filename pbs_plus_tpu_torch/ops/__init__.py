"""Device kernels and programs of the port.

- rolling_hash: buzhash candidate masks, CUDA kernel K1
  (``csrc/rolling_hash.cu``) and its plain PyTorch version.
- sha256: whole-chunk SHA-256 over slices of one stream buffer, CUDA kernel
  K2 (``csrc/sha256.cu``) and its plain PyTorch version.
- cuckoo: the chunk-index probe (K3) in PyTorch ops on the device table,
  with the host-authoritative insert mirror.
- ingest: ragged cross-session packing, scanned by K1 in one launch and
  digested by K2.
- similarity, fingerprint: simhash, minhash, Hamming matrices, content
  sketches and the fold fingerprint in PyTorch ops, beside their numpy
  twins.
"""

from .rolling_hash import candidate_ends_host, candidate_mask
from .sha256 import sha256_chunks, sha256_stream_chunks
from .cuckoo import CuckooIndex, buckets_for_bytes, lookup_host
from .ingest import HALO, RaggedBatch, digest_chunks, pack_rows, scan_rows
from .similarity import (content_sketch_device, content_sketch_host,
                         minhash_signature, minhash_signature_host,
                         minhash_similarity, pairwise_hamming,
                         pairwise_hamming_host, simhash_projection,
                         simhash_sketch, simhash_sketch_host, sketch_hamming)
from .fingerprint import fold_fingerprint, fold_fingerprint_host

__all__ = [
    "candidate_mask", "candidate_ends_host",
    "sha256_chunks", "sha256_stream_chunks",
    "CuckooIndex", "buckets_for_bytes", "lookup_host",
    "HALO", "RaggedBatch", "pack_rows", "scan_rows", "digest_chunks",
    "simhash_projection", "simhash_sketch", "simhash_sketch_host",
    "pairwise_hamming", "pairwise_hamming_host",
    "minhash_signature", "minhash_signature_host", "minhash_similarity",
    "content_sketch_device", "content_sketch_host", "sketch_hamming",
    "fold_fingerprint", "fold_fingerprint_host",
]
