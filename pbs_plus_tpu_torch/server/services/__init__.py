"""Narrow server services — the ``Store`` god-object split.

The reference's ``store.Store`` holds DB, app services, agents, jobs,
notifications and the cert manager behind one object, and our
``server/store.py`` inherited the shape: every subsystem built
threaded through one ``Server`` and one ``_prune_lock``.  This package
is the seam cut: five protocol-narrow services, each owning its own
lock and its own state, composed by ``Server`` (the composition root):

========================  ==============================================
service                   owns
========================  ==============================================
``CheckpointService``     crashed-task cleanup + resumable requeue,
                          checkpoint-interval resolution
``ChunkCacheService``     the shared read-path chunk cache's
                          configuration + stats surface
``JobQueueService``       the jobs plane: JobsManager (fair shares),
                          live progress / last-run stats, the DB-backed
                          shared queue rows + admission counters
``SyncStateService``      last-sync reports (the replication plane's
                          in-memory observability state)
``PruneService``          retention + GC: its own lock, the gc_active
                          gate, last-prune stats, the schedule loop,
                          and the cross-process GC leader lease
``DistIndexService``      the distributed dedup-index client:
                          construction from the shard spec, attachment
                          to the chunk store, rebalance, stats
========================  ==============================================

Construction discipline (pbslint rule ``service-discipline``): only the
composition roots — ``server/store.py`` (the production ``Server``) and
``server/fleetproc.py`` (the multi-process fleet worker) — may
construct these classes.  Cross-service needs are wired there as narrow
callables (``gc_active=lambda: prune.gc_active``), never by one service
reaching into another's private state — reach-through would silently
re-grow the god-object this package exists to shatter.

A copy of the JAX package's ``server/services/__init__.py``: the same
six services, each a copy of the reference's over the port's modules.
"""

from .checkpoint_service import CheckpointService
from .chunkcache_service import ChunkCacheService
from .distindex_service import DistIndexService
from .jobqueue import JobQueueService
from .prune_service import GCLeaseHeldError, PruneService
from .syncstate import SyncStateService

__all__ = [
    "CheckpointService",
    "ChunkCacheService",
    "DistIndexService",
    "GCLeaseHeldError",
    "JobQueueService",
    "PruneService",
    "SyncStateService",
]
