"""DistIndexService: owner of the distributed dedup-index client
(docs/dist-index.md).

The client itself (parallel/dist_index.py) is the batched
scatter/gather membership surface over the consistent-hash-sharded
index fleet; this service is the ONE place server composition reaches
it — construction from the shard spec, attachment to a ChunkStore's
membership slot, the rebalance entry point, and the stats surface.
Constructed only by the composition roots (pbslint
``service-discipline``); everything else talks to the attached client
through the store's ``probe_batch``/``insert_many``/``discard_many``
surface and never sees an endpoint.

A copy of the JAX package's ``server/services/distindex_service.py``,
its code byte for byte apart from its imports, which name the port's own
modules (the port's ``parallel.dist_index``, also where the service
looks the module up in ``sys.modules``)."""

from __future__ import annotations


class DistIndexService:
    def __init__(self, *, shards: str, token: str = "",
                 timeout_s: float = 30.0, map_path: str = "") -> None:
        """``shards`` is the PBS_PLUS_DIST_INDEX_SHARDS spec
        (``"s0=host:port,s1=host:port"``); empty leaves the service
        disabled and the local in-process index in charge."""
        self.client = None
        self.spec = shards or ""
        if self.spec:
            # deferred: a server without the knob must never pay the
            # module's import
            from ...parallel.dist_index import (DistIndexClient,
                                                parse_endpoints)
            self.client = DistIndexClient(
                endpoints=parse_endpoints(self.spec), token=token,
                timeout_s=timeout_s, map_path=map_path)

    @property
    def enabled(self) -> bool:
        return self.client is not None

    def adopt(self, chunks) -> None:
        """Take ownership of a client the ChunkStore already built from
        the PBS_PLUS_DIST_INDEX_SHARDS environment knob — the service
        must not construct a SECOND client (second connection pool,
        second map) next to it."""
        if self.client is not None:
            return
        import sys
        mod = sys.modules.get("pbs_plus_tpu_torch.parallel.dist_index")
        if mod is None:
            return
        idx = getattr(chunks, "_index", None)
        if isinstance(idx, mod.DistIndexClient):
            self.client = idx
            from ...utils import conf
            self.spec = conf.env().dist_index_shards

    def attach(self, chunks) -> None:
        """Point a ChunkStore's membership surface at the distributed
        client (the index-setter seam stores already expose for the
        per-job chunker-override share)."""
        if self.client is not None:
            chunks.index = self.client

    def rebalance(self, new_map) -> dict:
        """Coordinate a membership change (whole-segment handoff; see
        DistIndexClient.rebalance for the fence→ship→retire ordering).
        Callers must not run this concurrently with a GC sweep — the
        two are mutually exclusive by operational contract
        (docs/dist-index.md failure matrix)."""
        if self.client is None:
            from ...parallel.dist_index import DistIndexError
            raise DistIndexError("distributed index is not enabled")
        return self.client.rebalance(new_map)

    def stats(self) -> dict:
        import sys
        mod = sys.modules.get("pbs_plus_tpu_torch.parallel.dist_index")
        return mod.metrics_snapshot() if mod is not None else {}

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
            self.client = None
