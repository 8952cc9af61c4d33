"""The sync counters of the port's datastore replication.

A copy of the part of the JAX package's ``pxar/syncwire.py`` that the
metrics render reads: ``SyncMetrics``, ``METRICS`` and
``metrics_snapshot``, its code byte for byte, so a port server exports
the same ``pbs_plus_sync_*`` series as the reference's.  The sync
engine itself (negotiation, transfer, the HTTP wire) is not in the port
yet; until it is, every counter stays 0.
"""

from __future__ import annotations

import threading


class SyncMetrics:
    """Process-global sync observability (rendered by server/metrics.py
    as ``pbs_plus_sync_*``)."""

    _COUNTERS = ("jobs", "snapshots", "chunks_probed", "probe_batches",
                 "chunks_transferred", "chunks_skipped", "bytes_wire",
                 "bytes_logical", "resumes", "errors")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


METRICS = SyncMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()
