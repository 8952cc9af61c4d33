"""The store's dedup-index tier and the fused-ingest write path of the port.

- chunkindex: ``DedupIndex``, the membership front a JAX ``ChunkStore``
  takes as ``index=``; K3 on the card, or the numpy twin on the CPU.
- digestlog: ``DigestLog``, the spillable exact-confirm tier (a copy;
  byte-identical segments and manifests).
- similarityindex: ``SimilarityIndex``, the delta tier's candidate
  oracle; content sketches on the index's device.
- ingestbatch: ``IngestCollector``, the cross-session fused-ingest
  batching domain (one K1 launch and one K2 batch per flush across every
  concurrent writer), ``FusedIngestStream``, the sequential writer that
  deposits there, and ``collector_for``, one collector per store.
- transfer, ingestbackend, pipeline: copies of the JAX package's
  jax-free stream writer (``_ChunkedStream``, the staged writer),
  declared-capability seam and store lock that the collector needs.
"""

from .chunkindex import DedupIndex
from .digestlog import DigestLog
from .ingestbatch import FusedIngestStream, IngestCollector, collector_for
from .similarityindex import SimilarityIndex

__all__ = ["DedupIndex", "DigestLog", "SimilarityIndex", "IngestCollector",
           "FusedIngestStream", "collector_for"]
