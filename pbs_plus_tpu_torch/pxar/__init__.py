"""The store's dedup-index tier of the port.

- chunkindex: ``DedupIndex``, the membership front a JAX ``ChunkStore``
  takes as ``index=``; K3 on the card, or the numpy twin on the CPU.
- digestlog: ``DigestLog``, the spillable exact-confirm tier (a copy;
  byte-identical segments and manifests).
- similarityindex: ``SimilarityIndex``, the delta tier's candidate
  oracle; content sketches on the index's device.
"""

from .chunkindex import DedupIndex
from .digestlog import DigestLog
from .similarityindex import SimilarityIndex

__all__ = ["DedupIndex", "DigestLog", "SimilarityIndex"]
