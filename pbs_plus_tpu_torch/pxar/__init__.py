"""The snapshot store of the port: its dedup-index tier, its fused-ingest
write path, and the store itself.

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
- backupproxy, transfer, datastore: the snapshot store (copies of the
  JAX package's): ``LocalStore(device=)`` and its sessions, whose
  writers (``SessionWriter``, ``DedupWriter``) cut with K1, digest with
  K2 and probe the store's ``DedupIndex`` (K3) on the store's device;
  ``SplitReader``; ``ChunkStore``/``Datastore`` in the native and the
  stock-PBS layouts.  Snapshots are byte-identical to the JAX package's.
- chunkcache, format, pxarv2, pbsformat, deltablob, pipeline,
  ingestbackend: copies of the read cache, the entry codecs, the PBS
  formats, delta blobs, the pipelined writer and the declared-capability
  seam the store needs.
- pbsstore: ``PBSStore(device=)``, the same session surface over a PBS
  server's backup and reader protocols (HTTP/1.1, or HTTP/2 after the
  101 upgrade through ``utils.h2lib``); sessions cut with K1 and digest
  with K2 on its device.  walker: ``backup_tree``, a directory tree into
  a session (copies).
"""

from .backupproxy import LocalStore
from .chunkindex import DedupIndex
from .datastore import ChunkStore, Datastore
from .digestlog import DigestLog
from .ingestbatch import FusedIngestStream, IngestCollector, collector_for
from .similarityindex import SimilarityIndex
from .transfer import SplitReader

__all__ = ["DedupIndex", "DigestLog", "SimilarityIndex", "IngestCollector",
           "FusedIngestStream", "collector_for", "LocalStore", "ChunkStore",
           "Datastore", "SplitReader"]
