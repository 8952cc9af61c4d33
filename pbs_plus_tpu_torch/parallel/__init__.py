"""Multi-process and multi-device parts of the port.

- dist_index: the distributed dedup index's service half (``ShardMap``,
  ``IndexShardServer``, ``DistIndexClient`` with ``rebalance``) on the
  JAX package's HTTP wire; shard nodes hold the port's ``DedupIndex``.

Nothing here imports ``torch.distributed``.
"""

from .dist_index import (DistIndexClient, DistIndexError, IndexShardServer,
                         ShardMap, parse_endpoints)

__all__ = ["DistIndexClient", "DistIndexError", "IndexShardServer",
           "ShardMap", "parse_endpoints"]
