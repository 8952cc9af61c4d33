"""The server side of the port: the verification job (``verification_job``)
and copies of the server parts it imports (``jobs.Job``,
``jobs.QueueFullError``, ``database.STATUS_*``)."""
