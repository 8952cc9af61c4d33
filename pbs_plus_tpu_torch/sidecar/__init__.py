"""The dedup sidecar on the card: the gRPC service that lets an unmodified
backup server (job rows with ``chunker = "sidecar:<host:port>"``) reach
kernels K1, K2 and K3, and the wire half of its client.  Run it with
``python -m pbs_plus_tpu_torch sidecar``."""

from .service import DedupService, serve_sidecar
from .client import SidecarClient

__all__ = ["DedupService", "serve_sidecar", "SidecarClient"]
