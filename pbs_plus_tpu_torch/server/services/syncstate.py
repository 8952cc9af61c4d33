"""SyncStateService: the replication plane's in-memory observability
state — last-sync reports keyed by sync-job id, previously a
bare dict on the ``Server`` god-object that ``sync_job.py`` wrote and
the web/metrics layers read with no owner and no lock.

A copy of the JAX package's ``server/services/syncstate.py``, its code
byte for byte."""

from __future__ import annotations

import threading


class SyncStateService:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: dict[str, dict] = {}    # guarded-by: self._lock

    def record(self, sid: str, report: dict) -> None:
        with self._lock:
            self._last[sid] = report

    def get(self, sid: str) -> "dict | None":
        with self._lock:
            return self._last.get(sid)

    def view(self) -> dict:
        """Snapshot copy for read paths (web results route, tests) —
        mutation goes through ``record`` only."""
        with self._lock:
            return dict(self._last)
