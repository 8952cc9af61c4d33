"""The server side of the port: the agent backup job (``backup_job``:
agent, local and s3 targets into a ``LocalStore`` on the card) with
copies of the server parts it runs on (``database``, the whole
``Database`` and ``BackupJobRow``; ``checkpoint``, durable checkpoints
and resume; ``s3``, the SigV4 client), the verification job
(``verification_job``) with ``jobs.Job``/``jobs.QueueFullError``, and the
snapshot mount service (``mount_service``), whose children are ``python
-m pbs_plus_tpu_torch mount``."""
