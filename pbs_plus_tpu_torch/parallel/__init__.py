"""Multi-device and multi-process parts of the port.

Axes, as in the JAX package:

- ``data``  -- agent fan-in: independent streams split over devices
  (``sharded_step``, and the batched K1/K2 dispatches of
  ``ops/rolling_hash.py`` and ``ops/sha256.py`` over ``data_mesh()``).
- ``index`` -- the cuckoo table split over devices; probes sum the
  partial hits of every shard (``dist_index.ShardedCuckooIndex``).
- ``seq``   -- one long stream split along its bytes with a 63-byte halo
  from the left neighbour (``sp_chunker``).

One process drives an array of ``torch.device``s (``mesh.Mesh``, which
may repeat a device); the collectives are tensor copies and sums
(``collectives``).  ``dryrun`` runs the step and the sequence-parallel
cuts once against the single-device path.  ``dist_index`` also holds the
distributed index's service half (``ShardMap``, ``IndexShardServer``,
``DistIndexClient``) on the JAX package's HTTP wire.

Nothing here imports ``torch.distributed``.
"""

from .mesh import data_mesh, make_mesh, make_seq_mesh, set_data_mesh
from .sp_chunker import sp_candidate_mask, sp_chunk_stream
from .dist_index import (DistIndexClient, DistIndexError, IndexShardServer,
                         ShardMap, ShardedCuckooIndex, parse_endpoints)
from .sharded_step import build_step_inputs, multichip_dedup_step
from .dryrun import dryrun_multichip

__all__ = [
    "make_mesh", "make_seq_mesh", "data_mesh", "set_data_mesh",
    "sp_candidate_mask", "sp_chunk_stream",
    "ShardedCuckooIndex",
    "DistIndexClient", "DistIndexError", "IndexShardServer",
    "ShardMap", "parse_endpoints",
    "multichip_dedup_step", "build_step_inputs", "dryrun_multichip",
]
