"""Task status values of the server's database.

A copy of the ``STATUS_*`` constants of the JAX package's
``server/database.py``, the values the verification job writes into a
task row.  The database itself is not copied: the job writes through the
server's ``db``, which a caller brings.
"""

from __future__ import annotations

# -- job status (reference: database/types.go:36-47 typed JobStatus) -------
STATUS_QUEUED = "queued"
STATUS_RUNNING = "running"
STATUS_SUCCESS = "success"
STATUS_WARNING = "warnings"
STATUS_ERROR = "error"
STATUS_CANCELLED = "cancelled"
