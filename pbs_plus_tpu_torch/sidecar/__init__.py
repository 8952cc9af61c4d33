"""The dedup sidecar on the card: the gRPC service that lets an unmodified
backup server (job rows with ``chunker = "sidecar:<host:port>"``) reach
kernels K1, K2 and K3, and its client: ``SidecarClient`` with its
circuit breaker and retries, ``SidecarChunker`` and the
``ResilientSidecarFactory`` behind a ``"sidecar:<host:port>"`` row.  Run
the service with ``python -m pbs_plus_tpu_torch sidecar``."""

from .service import DedupService, serve_sidecar
from .client import ResilientSidecarFactory, SidecarClient, SidecarChunker

__all__ = ["DedupService", "serve_sidecar", "SidecarClient",
           "SidecarChunker", "ResilientSidecarFactory"]
