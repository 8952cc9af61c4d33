"""ChunkCacheService: owner of the shared read-path chunk cache's
configuration.  The cache itself (pxar/chunkcache.py) is a
process-wide singleton with its own internal lock; this service is the
ONE place server config reaches it — the old inline
``chunkcache.configure_shared`` call buried in ``Server.__init__``.

A copy of the JAX package's ``server/services/chunkcache_service.py``,
its code byte for byte."""

from __future__ import annotations


class ChunkCacheService:
    def __init__(self, *, chunk_cache_mb: int) -> None:
        # < 0 = keep the PBS_PLUS_CHUNK_CACHE_MB environment default
        # (conf.env), matching the old ServerConfig semantics
        self.configured_mb = chunk_cache_mb
        if chunk_cache_mb >= 0:
            from ...pxar import chunkcache
            chunkcache.configure_shared(max_bytes=chunk_cache_mb << 20)

    def stats(self) -> dict:
        from ...pxar import chunkcache
        return chunkcache.metrics_snapshot()
