"""The server side of the port: the verification job (``verification_job``)
and copies of the server parts it imports (``jobs.Job``,
``jobs.QueueFullError``, ``database.STATUS_*``), and the snapshot mount
service (``mount_service``), whose children are ``python -m
pbs_plus_tpu_torch mount``."""
