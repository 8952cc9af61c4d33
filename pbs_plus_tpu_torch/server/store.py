"""Server composition root + bootstrap wiring.

Reference: internal/server/store/store.go:24-118 (the Store god-object:
DB, app services, AgentsManager, jobs Manager, notification tracker,
CertManager) and internal/server/bootstrap.go:29-196 (startup sequence:
cleanup queued backups → secret key → CA validate → stale-mount cleanup →
RPC servers in self-restarting loops → jobs manager → scheduler).

The service split shattered the inherited god-object shape: the jobs plane,
prune/GC, checkpoints self-heal, the chunk-cache config and the sync
observability state each live in a narrow service
(``server/services/``), every one owning its own lock and state —
``Server`` is reduced to THE composition root that constructs them and
wires their cross-service needs as narrow callables.  The legacy
attribute surface (``server.jobs``, ``server.last_prune``,
``server._gc_active``, ...) is preserved as delegating properties so
the web/metrics/test layers keep working unchanged.  See
docs/architecture.md "Service map".

A copy of the JAX package's ``server/store.py``, its code byte for byte
apart from its imports, which name the port's own modules, its logger
(``logging``; the scoped logger is a ``LoggerAdapter``) and two
changes.  ``Server(config, *, device="cuda")`` resolves its device
first (``utils/device.py``, with a CUDA device's index named, since the
jobs' writer threads and the GC's executor thread launch on it), so it
raises ``CudaUnavailableError`` without a card before it touches the
state directory; it hands that device to its ``LocalStore`` (whose
sessions cut with K1, digest with K2 and probe with K3), to the
``JobQueueService``'s per-job stores and to the verification job.
``ServerConfig.chunker`` defaults to ``"cuda"``, the port's chunker
kind, where the reference's defaults to ``"cpu"``; the CPU kinds and
``sidecar:<host:port>`` are served too (``server/backup_job.py``), so a
row a JAX server wrote at its default runs here.  The web API
(``server/web.py``), the notification tracker
(``server/notifications.py``) and the ``server`` command (``python -m
pbs_plus_tpu_torch server``) wrap it as the reference's do;
``notifications`` is the sink the caller attaches.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from ..arpc import AgentsManager, Router, TlsServerConfig, serve
from ..chunker import ChunkerParams
from ..pxar.backupproxy import LocalStore
from ..utils import conf, crypto
from ..utils.device import resolve_indexed
from ..utils.mtls import CertManager
from . import database
from .backup_job import make_batch_hasher, make_chunker_factory
from .scheduler import Scheduler
from .services import (CheckpointService, ChunkCacheService,
                       DistIndexService, JobQueueService, PruneService,
                       SyncStateService)

L = logging.getLogger(__name__)


def make_upid(kind: str, job_id: str) -> str:
    """PBS-compatible unique process id for task logs — re-exported for
    the web/verification importers; the shared implementation lives in
    proxmox/upid.py so the TLS-free jobs service mints identically."""
    from ..proxmox.upid import make_upid as _make_upid
    return _make_upid(kind, job_id)


@dataclass
class ServerConfig:
    state_dir: str
    cert_dir: str
    datastore_dir: str
    arpc_host: str = "127.0.0.1"
    arpc_port: int = 0                      # 0 = ephemeral (tests)
    chunk_avg: int = 4 << 20
    chunker: str = "cuda"                   # default backend; per-job override
    # CPU scan implementation for cpu-kind chunkers: "" (fall back to
    # PBS_PLUS_CHUNKER_BACKEND from the environment, default scalar) |
    # "scalar" | "vector" (chunker/vector.py — SIMD-style doubling scan,
    # self-test-gated, degrades to scalar per stream at bind time)
    chunker_backend: str = ""
    # default pipelined-writer hash workers (0 = sequential); per-job
    # override via BackupJobRow.pipeline_workers
    pipeline_workers: int = 0
    datastore_format: str = "tpxd"          # "tpxd" | "pbs" (stock-PBS layout)
    max_concurrent: int | None = None
    hostname: str = "pbs-plus-tpu-server"
    # optional PBS push target: backup jobs with store="pbs" upload into a
    # live Proxmox Backup Server instead of the local datastore
    # (reference: backupproxy.NewPBSStore,
    # internal/pxarmount/commit_orchestrate.go:137-149)
    pbs_url: str = ""
    pbs_datastore: str = ""
    pbs_token: str = ""
    pbs_namespace: str = ""
    pbs_fingerprint: str = ""
    # PBS-host drop-in: path to PBS's ticket-signing key
    # (/etc/proxmox-backup/authkey.key); when set, the web API accepts
    # the PBS UI's auth cookie alongside bearer tokens (reference:
    # internal/server/web/auth.go:55-297).  Cookie-authed writes
    # additionally need a CSRFPreventionToken validated with the PBS
    # CSRF secret; only allowed_users (default root@pam, "*" = any)
    # get sidecar access.
    pbs_auth_key_path: str = ""
    pbs_csrf_key_path: str = ""
    pbs_auth_allowed_users: str = ""
    # retention: scheduled prune+GC over the local datastore (0 = keep
    # all; empty schedule = manual only via POST /api2/json/d2d/prune)
    prune_keep_last: int = 0
    prune_keep_daily: int = 0
    prune_keep_weekly: int = 0
    prune_schedule: str = ""
    # resilience (docs/data-plane.md "Resilience wiring"): job-level
    # retry count for agent backups (1 = no retry — a mid-backup
    # disconnect stays a hard, promptly-reported error; >1 retries with
    # backoff, cheap because committed chunks dedup on the re-run) and
    # the per-target circuit breaker that keeps one dead agent from
    # burning the scheduler's retry budget every tick
    backup_retry_attempts: int = 1
    target_breaker_threshold: int = 5
    target_breaker_reset_s: float = 30.0
    # durable checkpoints (server/checkpoint.py): "<N>c/<M>s" persists
    # the in-flight session every N committed payload chunks and/or M
    # seconds so a crashed/retried backup resumes from progress instead
    # of byte zero.  "" falls back to PBS_PLUS_CHECKPOINT_INTERVAL from
    # the environment (conf.env), which defaults to disabled.
    checkpoint_interval: str = ""
    # startup self-heal: jobs found 'running' at boot (they died with
    # the previous process) are re-enqueued as resumable after this
    # settle delay (lets agents reconnect first); < 0 disables requeue
    resume_requeue_delay_s: float = 5.0
    # read path (pxar/chunkcache.py): budget of the process-shared
    # decompressed-chunk LRU in MiB (0 disables; < 0 falls back to
    # PBS_PLUS_CHUNK_CACHE_MB from the environment) and the worker
    # count of the verification job's parallel chunk-check pool
    # (0 = auto: min(8, cores); 1 = sequential)
    chunk_cache_mb: int = -1
    verify_workers: int = 0
    # dedup index + store sharding (pxar/chunkindex.py, docs/
    # data-plane.md "Dedup index"): memory budget of the cuckoo-filter
    # membership front in MiB (0 disables it), resident budget of the
    # spillable exact-confirm memtable in MiB (pxar/digestlog.py; 0
    # keeps the whole confirm set in RAM), and the chunk store's
    # logical shard count.  Negative values fall back to the
    # PBS_PLUS_DEDUP_INDEX_MB / PBS_PLUS_DEDUP_RESIDENT_MB /
    # PBS_PLUS_STORE_SHARDS environment knobs
    dedup_index_mb: int = -1
    dedup_resident_mb: int = -1
    store_shards: int = -1
    # similarity-dedup delta tier (pxar/similarityindex.py +
    # pxar/deltablob.py, docs/data-plane.md "Similarity tier"):
    # delta_tier 1 stores near-duplicate chunks as deltas against a
    # resembling base, 0 disables; delta_threshold = max sketch Hamming
    # distance (of 64) to accept a base; delta_max_chain bounds
    # reassembly depth.  Negative values fall back to the
    # PBS_PLUS_DELTA_TIER / _DELTA_THRESHOLD / _DELTA_MAX_CHAIN
    # environment knobs (utils/conf.py)
    delta_tier: int = -1
    delta_threshold: int = -1
    delta_max_chain: int = -1
    # fleet admission + queueing (docs/fleet.md): per-client session-open
    # token bucket, global opens/s bucket, concurrent-session ceiling
    # (AgentsManager), and the jobs waiting-queue bound (JobsManager,
    # QueueFullError past it).  Negative values fall back to the
    # corresponding PBS_PLUS_AGENT_RATE / PBS_PLUS_AGENT_BURST /
    # PBS_PLUS_AGENT_OPEN_RATE / PBS_PLUS_AGENT_MAX_SESSIONS /
    # PBS_PLUS_MAX_QUEUED_JOBS environment knobs (utils/conf.py)
    agent_rate: float = -1.0
    agent_burst: int = -1
    agent_open_rate: float = -1.0
    agent_max_sessions: int = -1
    max_queued_jobs: int = -1
    # shared-datastore scale-out (docs/architecture.md
    # "Service map"): shared_instance names THIS process when several
    # server processes open one datastore ("" falls back to
    # PBS_PLUS_SHARED_DATASTORE; empty everywhere = single-process
    # mode).  When set, the chunk store claims novel chunks with an
    # os.link CAS (written exactly once across processes) and keeps its
    # index spill/snapshot state per-instance.  gc_lease_ttl_s is the
    # GC leader lease TTL: a killed sweeper is stolen from within one
    # TTL (server/services/prune_service.py)
    shared_instance: str = ""
    gc_lease_ttl_s: float = 30.0
    # distributed dedup index (docs/dist-index.md): shard
    # spec "s0=host:port,s1=host:port" routes the membership surface
    # through a DistIndexClient over those index nodes; "" falls back
    # to PBS_PLUS_DIST_INDEX_SHARDS (which the ChunkStore reads
    # itself), empty everywhere = local in-process index
    dist_index_shards: str = ""
    dist_index_token: str = ""


class Server:
    """Owns every server-side component; start()/stop() lifecycle."""

    def __init__(self, config: ServerConfig, *, device="cuda"):
        self.device = resolve_indexed(device)
        self.config = config
        os.makedirs(config.state_dir, exist_ok=True)
        self.seal_key = crypto.load_or_create_key(
            os.path.join(config.state_dir, "secret.key"))
        self.db = database.Database(
            os.path.join(config.state_dir, conf.DEFAULT_DB_NAME),
            seal_key=self.seal_key)
        self.certs = CertManager(config.cert_dir)
        self.certs.load_or_create_ca()
        self.certs.validate()
        self.certs.ensure_server_identity(config.hostname)
        self.agents = AgentsManager(
            is_expected=self._is_expected_host,
            rate=None if config.agent_rate < 0 else config.agent_rate,
            burst=None if config.agent_burst < 0 else config.agent_burst,
            open_rate=(None if config.agent_open_rate < 0
                       else config.agent_open_rate),
            max_sessions=(None if config.agent_max_sessions < 0
                          else config.agent_max_sessions))
        # -- the service split: each service owns its own
        # lock and state; cross-service needs are wired as NARROW
        # callables (never the peer service object) -----------------------
        self.chunk_cache = ChunkCacheService(
            chunk_cache_mb=config.chunk_cache_mb)
        params = ChunkerParams(avg_size=config.chunk_avg)
        shared = config.shared_instance or conf.env().shared_datastore
        self.datastore = LocalStore(
            config.datastore_dir, params,
            chunker_factory=make_chunker_factory(
                config.chunker, cpu_backend=config.chunker_backend,
                device=self.device),
            batch_hasher=make_batch_hasher(config.chunker,
                                           device=self.device),
            pbs_format=config.datastore_format == "pbs",
            pipeline_workers=config.pipeline_workers,
            store_shards=(None if config.store_shards < 0
                          else config.store_shards),
            dedup_index_mb=(None if config.dedup_index_mb < 0
                            else config.dedup_index_mb),
            dedup_resident_mb=(None if config.dedup_resident_mb < 0
                               else config.dedup_resident_mb),
            delta_tier=(None if config.delta_tier < 0
                        else bool(config.delta_tier)),
            delta_threshold=(None if config.delta_threshold < 0
                             else config.delta_threshold),
            delta_max_chain=(None if config.delta_max_chain < 0
                             else config.delta_max_chain),
            shared_instance=shared, device=self.device)
        # distributed index: an explicit config spec builds
        # + attaches the client here; with only the environment knob
        # set, the ChunkStore built it already and the service ADOPTS
        # that one (never a second client beside it)
        self.dist_index = DistIndexService(
            shards=config.dist_index_shards,
            token=config.dist_index_token or conf.env().dist_index_token,
            timeout_s=conf.env().dist_index_timeout_s,
            map_path=conf.env().dist_index_map)
        _chunks = self.datastore.datastore.chunks
        if self.dist_index.enabled:
            self.dist_index.attach(_chunks)
        else:
            self.dist_index.adopt(_chunks)
        holder = f"{config.hostname}:{shared or os.getpid()}"
        self.prune = PruneService(
            datastore=self.datastore,
            policy_factory=self.prune_policy,
            # narrow gate into the jobs plane, late-bound on purpose:
            # the job queue is constructed just below
            jobs_active=lambda: self.job_queue.active_count,
            db=self.db, holder=holder,
            lease_ttl_s=config.gc_lease_ttl_s)
        self.job_queue = JobQueueService(
            db=self.db, config=config, agents=self.agents,
            datastore=self.datastore,
            gc_active=lambda: self.prune.fleet_gc_active(),
            checkpoint_interval=lambda: self.checkpoints.interval(),
            max_concurrent=config.max_concurrent,
            max_queued=(None if config.max_queued_jobs < 0
                        else config.max_queued_jobs),
            owner=holder, reap_all_on_boot=not shared,
            device=self.device)
        self.checkpoints = CheckpointService(
            db=self.db, config=config,
            enqueue_backup=self.enqueue_backup)
        self.sync_state = SyncStateService()
        self.scheduler = Scheduler(
            self.db, self.jobs,
            enqueue_backup=self._enqueue_backup_row,
            enqueue_verification=self._enqueue_verification,
            enqueue_sync=self._enqueue_sync)
        self.job_queue.on_backup_complete = \
            self.scheduler.on_backup_complete
        self.router = Router()          # control-plane server handlers
        self._register_handlers()
        # routers pre-attached to expected job sessions (restore jobs serve
        # the remote-archive protocol on their data session)
        self._job_routers: dict[str, Router] = {}
        self._arpc_server: Optional[asyncio.AbstractServer] = None
        self.mount_service = None       # lazily created by the web layer
        self.job_rpc = None             # unix-socket job mutation service
        self._tasks: list[asyncio.Task] = []
        self.log = logging.LoggerAdapter(L, {"component": "server"})
        self.started_at = time.time()

    # -- legacy attribute surface (delegating into the services) ----------
    @property
    def jobs(self):
        """The JobsManager (owned by JobQueueService)."""
        return self.job_queue.jobs

    @property
    def notifications(self):
        """Notification batch tracker (reference: BatchTracker.
        RecordJobResult in the backup OnSuccess path) — a sink attached
        by the caller, consumed by the jobs plane."""
        return self.job_queue.notifications

    @notifications.setter
    def notifications(self, sink) -> None:
        self.job_queue.notifications = sink

    @property
    def live_progress(self) -> dict:
        return self.job_queue.live_progress

    @property
    def last_run_stats(self) -> dict:
        return self.job_queue.last_run_stats

    @property
    def last_sync_stats(self) -> dict:
        """Snapshot view; writers go through ``sync_state.record``."""
        return self.sync_state.view()

    @property
    def last_prune(self) -> dict:
        return self.prune.last_prune

    @property
    def _gc_active(self) -> bool:
        # fleet-wide: a sibling process's sweep (live lease row) gates
        # this process's restore/sync/verify starts exactly like a
        # local one
        return self.prune.fleet_gc_active()

    @property
    def _prune_lock(self) -> asyncio.Lock:
        return self.prune.lock

    # -- admission ---------------------------------------------------------
    async def _is_expected_host(self, cn: str, cert_der: bytes) -> bool:
        """Expected-list gate: cert must be in agent_hosts (reference:
        SetExtraExpectFunc cert-in-DB check, web/server.go:193-227)."""
        row = self.db.get_agent_host(cn)
        if row is None:
            return False
        # pin: the presented cert must be byte-identical to the one issued
        # at bootstrap/renewal (DER compare)
        from cryptography import x509
        from cryptography.hazmat.primitives.serialization import Encoding
        try:
            stored = x509.load_pem_x509_certificate(row["cert_pem"])
        except Exception:
            return False
        return stored.public_bytes(Encoding.DER) == cert_der

    def _register_handlers(self) -> None:
        async def ping(req, ctx):
            return {"pong": True}
        self.router.handle("ping", ping)

        async def drive_update(req, ctx):
            """Agent-pushed volume inventory (reference: periodic drive
            updates, cmd/agent/main_unix.go:118-148) — feeds the
            per-target volume-usage metrics."""
            cn = getattr(ctx, "cn", "")
            if not cn:
                return {"ok": False}
            drives = req.payload.get("drives", [])
            if not isinstance(drives, list):
                return {"ok": False}
            # sanitize per item: a malformed entry must never be able to
            # poison the DB row and 500 every later /metrics scrape
            clean = []
            for d in drives[:64]:
                if not isinstance(d, dict):
                    continue
                clean.append({
                    "name": str(d.get("name", ""))[:128],
                    "mountpoint": str(d.get("mountpoint", ""))[:256],
                    "fstype": str(d.get("fstype", ""))[:64],
                    "size_bytes": int(d.get("size_bytes") or 0),
                    "free_bytes": int(d.get("free_bytes") or 0),
                })
            self.db.update_agent_drives(cn, clean)
            return {"ok": True}
        self.router.handle("drive_update", drive_update)

    # -- aRPC listener -----------------------------------------------------
    async def start_arpc(self) -> int:
        tls = TlsServerConfig(self.certs.server_cert_path,
                              self.certs.server_key_path,
                              self.certs.ca_cert_path)

        async def on_connection(conn, peer, headers):
            sess = await self.agents.register(peer, headers, conn)
            try:
                if sess.client_id == sess.cn:
                    # primary control session: serve our handlers on it too
                    await self.router.serve_connection(conn, context=sess)
                else:
                    # job data session: serve the job's pre-attached router
                    # (restore: remote-archive handlers; backup: empty — the
                    # server side acts as the client on that session)
                    router = self._job_routers.pop(sess.client_id, None) \
                        or Router()
                    await router.serve_connection(conn, context=sess)
            finally:
                await self.agents.unregister(sess)

        self._arpc_server = await serve(
            self.config.arpc_host, self.config.arpc_port, tls,
            on_connection=on_connection, admit=self.agents.admit)
        port = self._arpc_server.sockets[0].getsockname()[1]
        self.log.info("aRPC listening on %s:%d", self.config.arpc_host, port)
        return port

    async def start(self) -> None:
        self.checkpoints.cleanup_orphaned_tasks()
        from .mount_service import MountService
        self.mount_service = MountService(self)
        # stale-mount reaping shells out (fusermount) — keep it off the loop
        await asyncio.get_running_loop().run_in_executor(
            None, self.mount_service.cleanup_stale_mounts)
        port = await self.start_arpc()
        self.config.arpc_port = port
        # one-shot job mutation socket (reference: JobRPCService on
        # pbs_agent_job_mutate.sock, rpc/job_service.go:58-196)
        from .jobrpc import JobRPCServer
        self.job_rpc = JobRPCServer(
            self, os.path.join(self.config.state_dir, "job.sock"))
        await self.job_rpc.start()
        self._tasks.append(asyncio.create_task(self.scheduler.run()))
        if self.config.prune_schedule:
            self._tasks.append(asyncio.create_task(
                self.prune.run_loop(self.config.prune_schedule)))

    async def stop(self) -> None:
        if getattr(self, "job_rpc", None) is not None:
            await self.job_rpc.stop()
        if self.mount_service is not None:
            await self.mount_service.unmount_all()
        self.scheduler.stop()
        await self.checkpoints.stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass        # we cancelled it above
            except Exception as e:
                L.debug("server task died at shutdown: %s", e)
        for sess in self.agents.sessions():
            await sess.conn.close()
        if self._arpc_server is not None:
            self._arpc_server.close()
            try:
                await asyncio.wait_for(self._arpc_server.wait_closed(), 5)
            except asyncio.TimeoutError:
                pass
        await self.job_queue.drain(timeout=10)
        # the shared admission counters get this process's final deltas
        # before the DB handle goes away (cross-process /metrics sums)
        self.job_queue.flush_admission()
        self.db.close()

    # -- bootstrap endpoint logic (used by the web API) --------------------
    def bootstrap_agent(self, hostname: str, csr_pem: bytes,
                        token_id: str, token_secret: bytes,
                        drives: list | None = None) -> bytes:
        """CSR signing flow (reference: AgentBootstrapHandler →
        CertManager.SignCSR + host cert stored in DB as expected list)."""
        if not self.db.check_token(token_id, token_secret, kind="bootstrap"):
            raise PermissionError("invalid bootstrap token")
        from ..utils import validate
        from ..utils.mtls import common_name
        # same mint-time gate as the manual target route: the hostname
        # becomes a target name (a datastore path component) and is
        # rendered in the dashboard — a token holder must not be able to
        # store an arbitrary string here.  Gate BEFORE sign_csr so the CA
        # never issues a cert for a rejected name.
        validate.hostname(hostname)
        cert_pem = self.certs.sign_csr(csr_pem)
        cn = common_name(cert_pem)
        if cn != hostname:
            raise PermissionError(f"CSR CN {cn!r} != hostname {hostname!r}")
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes
        fp = x509.load_pem_x509_certificate(cert_pem).fingerprint(
            hashes.SHA256()).hex()
        self.db.upsert_agent_host(hostname, cert_pem, fp, drives)
        self.db.upsert_target(hostname, "agent", hostname=hostname)
        return cert_pem

    def issue_bootstrap_token(self, *, ttl_s: float = 3600.0) -> tuple[str, bytes]:
        token_id = uuid.uuid4().hex[:12]
        secret = os.urandom(24)
        self.db.put_token(token_id, secret, expires_at=time.time() + ttl_s)
        return token_id, secret

    def issue_api_token(self, *, ttl_s: float | None = None) -> tuple[str, bytes]:
        token_id = uuid.uuid4().hex[:12]
        secret = os.urandom(24)
        self.db.put_token(token_id, secret, kind="api",
                          expires_at=time.time() + ttl_s if ttl_s else None)
        return token_id, secret

    # -- job enqueue -------------------------------------------------------
    async def _enqueue_backup_row(self, row: database.BackupJobRow) -> None:
        self.enqueue_backup(row.id)

    def prune_policy(self):
        from .prune import PrunePolicy
        return PrunePolicy(keep_last=self.config.prune_keep_last,
                           keep_daily=self.config.prune_keep_daily,
                           keep_weekly=self.config.prune_keep_weekly)

    async def run_prune(self, policy=None, *, dry_run: bool = False,
                        gc_grace_s: float | None = None):
        """Prune+GC via the PruneService: serialized with every other
        datastore-mutating admin path in this process through the
        service's own lock, and with other server processes through the
        GC leader lease (services/prune_service.py)."""
        return await self.prune.run_prune(policy, dry_run=dry_run,
                                          gc_grace_s=gc_grace_s)

    def enqueue_backup(self, job_id: str) -> bool:
        """Backup enqueue via the JobQueueService (the shared-bounded,
        DB-mirrored jobs plane)."""
        return self.job_queue.enqueue_backup(job_id)

    async def _enqueue_verification(self, v: dict) -> None:
        from .verification_job import enqueue_verification
        enqueue_verification(self, v, device=self.device)

    async def _enqueue_sync(self, s: dict) -> None:
        from .sync_job import enqueue_sync
        enqueue_sync(self, s)
