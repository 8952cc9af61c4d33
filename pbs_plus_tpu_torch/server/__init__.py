"""The server side of the port: the server shell (``store``: ``Server``
and ``ServerConfig``, composing the database, the certificate manager,
the agents manager, the ``LocalStore`` on the card and the services of
``services/``: the jobs queue, prune and GC, checkpoints, the chunk
cache, the distributed index client and the sync state), the scheduler
(``scheduler``), the jobs manager (``jobs``), the job socket
(``jobrpc``), hook scripts (``hooks``), retention (``prune``) and the
Prometheus render (``metrics``); the agent backup job (``backup_job``:
agent, local and s3 targets) with the server parts it runs on
(``database``, ``checkpoint``, ``s3``); the verification job
(``verification_job``); and the snapshot mount service
(``mount_service``), whose children are ``python -m pbs_plus_tpu_torch
mount``."""
