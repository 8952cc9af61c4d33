"""SQLite database: schema migrations + typed CRUD.

Reference: internal/server/database (~8.1k LoC) — modernc sqlite +
golang-migrate (36 migrations) + sqlc-generated queries; domain types at
types.go:10-238 (Backup/Restore/Target/VerificationJob/Exclusion/Token/
AgentHost/JobStatus with typed ShouldRetry).

Python sqlite3 (serialized mode) with an explicit migration list; secrets
sealed via utils.crypto before they land in rows (reference:
store.go:21 crypto.Seal).

A copy of the JAX package's ``server/database.py``, its code byte for
byte apart from its imports, which name the port's own modules: the same
schema and migrations, so either package opens a file the other wrote.
One change: ``Database`` retries the switch to WAL while it fails with
"database is locked", within the connection's 10 s timeout.  Two
processes opening one fresh database at once (two ``fleetproc``
workers, two servers cold-starting on one shared datastore) make the
switch fail at once in one of them about a third of the time: SQLite
calls no busy handler there, and the reference raises.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils import crypto

# -- job status (reference: database/types.go:36-47 typed JobStatus) -------
STATUS_QUEUED = "queued"
STATUS_RUNNING = "running"
STATUS_SUCCESS = "success"
STATUS_WARNING = "warnings"
STATUS_ERROR = "error"
STATUS_CANCELLED = "cancelled"

RETRYABLE = {STATUS_ERROR}


def should_retry(status: str) -> bool:
    return status in RETRYABLE


_MIGRATIONS: list[str] = [
    # 001 — core tables
    """
    CREATE TABLE backup_jobs (
        id TEXT PRIMARY KEY,
        target TEXT NOT NULL,
        source_path TEXT NOT NULL,
        store TEXT NOT NULL DEFAULT '',
        backup_id TEXT NOT NULL DEFAULT '',
        schedule TEXT NOT NULL DEFAULT '',
        retry INTEGER NOT NULL DEFAULT 0,
        retry_interval_s INTEGER NOT NULL DEFAULT 60,
        exclusions TEXT NOT NULL DEFAULT '[]',
        chunker TEXT NOT NULL DEFAULT 'cpu',
        pre_script TEXT NOT NULL DEFAULT '',
        post_script TEXT NOT NULL DEFAULT '',
        enabled INTEGER NOT NULL DEFAULT 1,
        last_run_at REAL,
        last_status TEXT,
        last_error TEXT,
        last_snapshot TEXT,
        created_at REAL NOT NULL
    );
    """,
    """
    CREATE TABLE targets (
        name TEXT PRIMARY KEY,
        kind TEXT NOT NULL DEFAULT 'agent',     -- agent | local | s3
        hostname TEXT NOT NULL DEFAULT '',
        root_path TEXT NOT NULL DEFAULT '',
        config TEXT NOT NULL DEFAULT '{}',
        online_at REAL,
        created_at REAL NOT NULL
    );
    """,
    """
    CREATE TABLE agent_hosts (
        hostname TEXT PRIMARY KEY,
        cert_pem BLOB NOT NULL,
        cert_fingerprint TEXT NOT NULL,
        drives TEXT NOT NULL DEFAULT '[]',
        bootstrapped_at REAL NOT NULL,
        renewed_at REAL
    );
    """,
    """
    CREATE TABLE tokens (
        id TEXT PRIMARY KEY,
        kind TEXT NOT NULL DEFAULT 'bootstrap',
        sealed_secret BLOB NOT NULL,
        created_at REAL NOT NULL,
        expires_at REAL,
        revoked INTEGER NOT NULL DEFAULT 0
    );
    """,
    # 002 — restores + verification
    """
    CREATE TABLE restore_jobs (
        id TEXT PRIMARY KEY,
        target TEXT NOT NULL,
        snapshot TEXT NOT NULL,
        destination TEXT NOT NULL,
        subpath TEXT NOT NULL DEFAULT '',
        status TEXT,
        error TEXT,
        started_at REAL,
        finished_at REAL,
        created_at REAL NOT NULL
    );
    """,
    """
    CREATE TABLE verification_jobs (
        id TEXT PRIMARY KEY,
        store TEXT NOT NULL DEFAULT '',
        schedule TEXT NOT NULL DEFAULT '',
        sample_rate REAL NOT NULL DEFAULT 0.1,
        run_on_backup INTEGER NOT NULL DEFAULT 0,
        last_run_at REAL,
        last_status TEXT,
        last_report TEXT,
        created_at REAL NOT NULL
    );
    """,
    # 003 — task log + notifications
    """
    CREATE TABLE task_log (
        upid TEXT PRIMARY KEY,
        job_id TEXT NOT NULL,
        kind TEXT NOT NULL,
        status TEXT NOT NULL,
        detail TEXT NOT NULL DEFAULT '',
        log TEXT NOT NULL DEFAULT '',
        started_at REAL NOT NULL,
        finished_at REAL
    );
    """,
    """
    CREATE TABLE alert_settings (
        key TEXT PRIMARY KEY,
        value TEXT NOT NULL
    );
    """,
    # 004 — exclusions as their own table (global + per-job)
    """
    CREATE TABLE exclusions (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        job_id TEXT NOT NULL DEFAULT '',      -- '' == global
        pattern TEXT NOT NULL,
        comment TEXT NOT NULL DEFAULT ''
    );
    """,
    # 005 — reusable hook scripts
    """
    CREATE TABLE scripts (
        name TEXT PRIMARY KEY,
        content TEXT NOT NULL,
        description TEXT NOT NULL DEFAULT '',
        created_at REAL NOT NULL,
        updated_at REAL NOT NULL
    );
    """,
    # 006 — PBS-style namespaces on backup jobs
    """
    ALTER TABLE backup_jobs ADD COLUMN namespace TEXT NOT NULL DEFAULT '';
    """,
    # 007 — pipelined data plane: per-job hash-worker count (0 = the
    # sequential writer; >=1 opts the job into pxar/pipeline.py)
    """
    ALTER TABLE backup_jobs ADD COLUMN pipeline_workers
        INTEGER NOT NULL DEFAULT 0;
    """,
    # 008 — datastore replication: sync jobs (pxar/syncwire.py,
    # docs/sync.md).  A pull job replicates FROM the peer into the
    # server datastore; push replicates INTO the peer.  The peer is
    # either a remote sync wire (remote_url + remote_token) or a
    # second local datastore directory (peer_path).
    """
    CREATE TABLE sync_jobs (
        id TEXT PRIMARY KEY,
        direction TEXT NOT NULL DEFAULT 'pull',
        remote_url TEXT NOT NULL DEFAULT '',
        remote_token TEXT NOT NULL DEFAULT '',
        peer_path TEXT NOT NULL DEFAULT '',
        backup_type TEXT NOT NULL DEFAULT '',
        backup_id TEXT NOT NULL DEFAULT '',
        namespace TEXT NOT NULL DEFAULT '',
        schedule TEXT NOT NULL DEFAULT '',
        enabled INTEGER NOT NULL DEFAULT 1,
        last_run_at REAL,
        last_status TEXT,
        last_report TEXT,
        created_at REAL NOT NULL
    );
    """,
    # 009 — shared-datastore scale-out (docs/architecture.md
    # "Service map"): job/queue state, admission counters, and the GC
    # leader lease move behind the DB so a SECOND server process can
    # open the same datastore.  job_queue mirrors every jobs-plane
    # admission (the shared bounded queue: the bound is checked against
    # the DB-wide 'queued' count, not one process's); admission_counters
    # accumulates AgentsManager verdicts across processes;
    # gc_lease is the single-row TTL'd leader lease — exactly one
    # sweeper per cycle, stolen on expiry (server/services/prune.py).
    """
    CREATE TABLE job_queue (
        id TEXT PRIMARY KEY,
        kind TEXT NOT NULL DEFAULT 'backup',
        tenant TEXT NOT NULL DEFAULT '',
        owner TEXT NOT NULL DEFAULT '',
        status TEXT NOT NULL DEFAULT 'queued',
        enqueued_at REAL NOT NULL,
        started_at REAL,
        finished_at REAL,
        error TEXT NOT NULL DEFAULT ''
    );
    """,
    """
    CREATE INDEX job_queue_status ON job_queue (status);
    """,
    """
    CREATE TABLE admission_counters (
        key TEXT PRIMARY KEY,
        value INTEGER NOT NULL DEFAULT 0
    );
    """,
    """
    CREATE TABLE gc_lease (
        id INTEGER PRIMARY KEY CHECK (id = 1),
        holder TEXT NOT NULL,
        generation INTEGER NOT NULL DEFAULT 1,
        acquired_at REAL NOT NULL,
        renewed_at REAL NOT NULL,
        expires_at REAL NOT NULL,
        sweeping INTEGER NOT NULL DEFAULT 1
    );
    """,
    # 010 — weighted-fair tenant shares (docs/fleet.md "Fairness"):
    # Job.weight rides the shared queue row like kind/tenant, so every
    # process sharing this database sees the same fair-share input the
    # enqueuing process used (the DB-plumbed half of the weight pair;
    # PBS_PLUS_TENANT_WEIGHTS is the operator override).
    """
    ALTER TABLE job_queue ADD COLUMN weight INTEGER NOT NULL DEFAULT 1;
    """,
]


@dataclass
class BackupJobRow:
    id: str
    target: str
    source_path: str
    store: str = ""
    backup_id: str = ""
    namespace: str = ""        # PBS-style ns/a/ns/b grouping
    schedule: str = ""
    retry: int = 0
    retry_interval_s: int = 60
    exclusions: list[str] = field(default_factory=list)
    chunker: str = "cpu"
    pipeline_workers: int = 0      # 0 = sequential; >=1 = pipelined writer
    pre_script: str = ""
    post_script: str = ""
    enabled: bool = True
    last_run_at: float | None = None
    last_status: str | None = None
    last_error: str | None = None
    last_snapshot: str | None = None


class Database:
    def __init__(self, path: str, *, seal_key: bytes | None = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # timeout: cross-process writers (a second server sharing this
        # datastore, migration 009) serialize on SQLite's write lock —
        # wait it out instead of surfacing SQLITE_BUSY to the jobs plane
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=10.0)
        self._conn.row_factory = sqlite3.Row
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
                break
            except sqlite3.OperationalError as e:
                if "locked" not in str(e) or time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._lock = threading.RLock()
        self._seal_key = seal_key
        self._migrate()

    def _migrate(self) -> None:
        """Apply pending migrations under BEGIN IMMEDIATE: two server
        processes cold-starting against one fresh database (migration
        009's whole point) serialize on SQLite's write lock — the loser
        re-reads the version after the winner commits and no-ops,
        instead of both racing the same CREATE TABLE.  Each migration
        entry is a single statement, executed via ``execute`` (never
        ``executescript``, which would commit the guard transaction)."""
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_version (v INTEGER)")
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT v FROM schema_version").fetchone()
                current = row["v"] if row else 0
                if row is None:
                    self._conn.execute(
                        "INSERT INTO schema_version VALUES (0)")
                for i, sql in enumerate(_MIGRATIONS[current:],
                                        start=current + 1):
                    self._conn.execute(sql)
                    self._conn.execute(
                        "UPDATE schema_version SET v = ?", (i,))
                self._conn.execute("COMMIT")
            except BaseException:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.OperationalError:
                    pass
                raise

    def close(self) -> None:
        self._conn.close()

    # -- backup jobs -------------------------------------------------------
    def upsert_backup_job(self, j: BackupJobRow) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO backup_jobs (id,target,source_path,store,
                   backup_id,namespace,schedule,retry,retry_interval_s,
                   exclusions,chunker,pipeline_workers,pre_script,
                   post_script,enabled,created_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)
                   ON CONFLICT(id) DO UPDATE SET target=excluded.target,
                     source_path=excluded.source_path, store=excluded.store,
                     backup_id=excluded.backup_id,
                     namespace=excluded.namespace,
                     schedule=excluded.schedule,
                     retry=excluded.retry,
                     retry_interval_s=excluded.retry_interval_s,
                     exclusions=excluded.exclusions, chunker=excluded.chunker,
                     pipeline_workers=excluded.pipeline_workers,
                     pre_script=excluded.pre_script,
                     post_script=excluded.post_script,
                     enabled=excluded.enabled""",
                (j.id, j.target, j.source_path, j.store, j.backup_id,
                 j.namespace, j.schedule, j.retry, j.retry_interval_s,
                 json.dumps(j.exclusions), j.chunker, j.pipeline_workers,
                 j.pre_script, j.post_script, int(j.enabled), time.time()))

    def _row_to_job(self, r: sqlite3.Row) -> BackupJobRow:
        return BackupJobRow(
            id=r["id"], target=r["target"], source_path=r["source_path"],
            store=r["store"], backup_id=r["backup_id"],
            namespace=r["namespace"], schedule=r["schedule"],
            retry=r["retry"], retry_interval_s=r["retry_interval_s"],
            exclusions=json.loads(r["exclusions"]), chunker=r["chunker"],
            pipeline_workers=r["pipeline_workers"],
            pre_script=r["pre_script"], post_script=r["post_script"],
            enabled=bool(r["enabled"]), last_run_at=r["last_run_at"],
            last_status=r["last_status"], last_error=r["last_error"],
            last_snapshot=r["last_snapshot"])

    def get_backup_job(self, job_id: str) -> Optional[BackupJobRow]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM backup_jobs WHERE id=?", (job_id,)).fetchone()
        return self._row_to_job(r) if r else None

    def list_backup_jobs(self, *, enabled_only: bool = False) -> list[BackupJobRow]:
        q = "SELECT * FROM backup_jobs"
        if enabled_only:
            q += " WHERE enabled=1"
        with self._lock:
            return [self._row_to_job(r) for r in self._conn.execute(q)]

    def delete_backup_job(self, job_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM backup_jobs WHERE id=?", (job_id,))

    def record_backup_result(self, job_id: str, status: str,
                             error: str = "", snapshot: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """UPDATE backup_jobs SET last_run_at=?, last_status=?,
                   last_error=?, last_snapshot=COALESCE(NULLIF(?,''),
                   last_snapshot) WHERE id=?""",
                (time.time(), status, error, snapshot, job_id))

    # -- targets -----------------------------------------------------------
    def upsert_target(self, name: str, kind: str, hostname: str = "",
                      root_path: str = "", config: dict | None = None) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO targets (name,kind,hostname,root_path,config,
                   created_at) VALUES (?,?,?,?,?,?)
                   ON CONFLICT(name) DO UPDATE SET kind=excluded.kind,
                     hostname=excluded.hostname, root_path=excluded.root_path,
                     config=excluded.config""",
                (name, kind, hostname, root_path,
                 json.dumps(config or {}), time.time()))

    def get_target(self, name: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM targets WHERE name=?", (name,)).fetchone()
        if r is None:
            return None
        d = dict(r)
        d["config"] = json.loads(d["config"])
        return d

    def list_targets(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute("SELECT * FROM targets").fetchall()
        out = []
        for r in rows:
            d = dict(r)
            d["config"] = json.loads(d["config"])
            out.append(d)
        return out

    def delete_target(self, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM targets WHERE name=?", (name,))

    def touch_target_online(self, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE targets SET online_at=? WHERE name=?",
                (time.time(), name))

    # -- agent hosts (the aRPC expected list) --------------------------------
    def upsert_agent_host(self, hostname: str, cert_pem: bytes,
                          fingerprint: str, drives: list | None = None) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO agent_hosts (hostname,cert_pem,
                   cert_fingerprint,drives,bootstrapped_at)
                   VALUES (?,?,?,?,?)
                   ON CONFLICT(hostname) DO UPDATE SET
                     cert_pem=excluded.cert_pem,
                     cert_fingerprint=excluded.cert_fingerprint,
                     drives=excluded.drives, renewed_at=excluded.bootstrapped_at""",
                (hostname, cert_pem, fingerprint,
                 json.dumps(drives or []), time.time()))

    def get_agent_host(self, hostname: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM agent_hosts WHERE hostname=?",
                (hostname,)).fetchone()
        return dict(r) if r else None

    def list_agent_hosts(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in
                    self._conn.execute("SELECT * FROM agent_hosts")]

    def update_agent_drives(self, hostname: str, drives: list) -> None:
        """Refresh the volume inventory pushed periodically by the agent
        (reference: cmd/agent/main_unix.go:118-148 drive updates)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE agent_hosts SET drives=? WHERE hostname=?",
                (json.dumps(drives), hostname))

    def file_size(self) -> int:
        """On-disk size of the database file (metrics)."""
        with self._lock:
            try:
                row = self._conn.execute("PRAGMA database_list").fetchone()
                return os.path.getsize(row["file"]) if row and row["file"] \
                    else 0
            except (sqlite3.Error, OSError):
                return 0

    def status_counts(self, table: str) -> dict[str, int]:
        """{status: count} for a job table (metrics)."""
        if table not in ("restore_jobs", "task_log", "backup_jobs"):
            raise ValueError(f"no status counts for {table!r}")
        col = "last_status" if table == "backup_jobs" else "status"
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {col} AS k, COUNT(*) AS n FROM {table} "
                f"GROUP BY {col}").fetchall()
        return {str(r["k"]): int(r["n"]) for r in rows if r["k"]}

    def delete_agent_host(self, hostname: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM agent_hosts WHERE hostname=?",
                               (hostname,))

    # -- tokens (sealed) -----------------------------------------------------
    def put_token(self, token_id: str, secret: bytes, kind: str = "bootstrap",
                  expires_at: float | None = None) -> None:
        if self._seal_key is None:
            raise RuntimeError("database has no seal key")
        sealed = crypto.seal(self._seal_key, secret, aad=token_id.encode())
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO tokens VALUES (?,?,?,?,?,0)",
                (token_id, kind, sealed, time.time(), expires_at))

    def check_token(self, token_id: str, secret: bytes,
                    kind: str | None = None) -> bool:
        """``kind`` restricts which token class is acceptable — bootstrap
        tokens must never authorize API calls and vice versa."""
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM tokens WHERE id=? AND revoked=0",
                (token_id,)).fetchone()
        if r is None or self._seal_key is None:
            return False
        if kind is not None and r["kind"] != kind:
            return False
        if r["expires_at"] is not None and r["expires_at"] < time.time():
            return False
        try:
            want = crypto.unseal(self._seal_key, r["sealed_secret"],
                                 aad=token_id.encode())
        except Exception:
            return False
        return crypto.constant_time_equal(want, secret)

    def revoke_token(self, token_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("UPDATE tokens SET revoked=1 WHERE id=?",
                               (token_id,))

    def list_tokens(self) -> list[dict]:
        """Token metadata only — sealed secrets never leave the DB."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, kind, created_at, expires_at, revoked "
                "FROM tokens").fetchall()
        return [dict(r) for r in rows]

    # -- restores ------------------------------------------------------------
    def create_restore(self, rid: str, target: str, snapshot: str,
                       destination: str, subpath: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO restore_jobs (id,target,snapshot,destination,
                   subpath,created_at) VALUES (?,?,?,?,?,?)""",
                (rid, target, snapshot, destination, subpath, time.time()))

    def update_restore(self, rid: str, status: str, error: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """UPDATE restore_jobs SET status=?, error=?,
                   started_at=COALESCE(started_at, ?),
                   finished_at=CASE WHEN ? IN ('success','error')
                     THEN ? ELSE finished_at END
                   WHERE id=?""",
                (status, error, time.time(), status, time.time(), rid))

    def get_restore(self, rid: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM restore_jobs WHERE id=?", (rid,)).fetchone()
        return dict(r) if r else None

    # -- verification --------------------------------------------------------
    def upsert_verification_job(self, vid: str, store: str = "",
                                schedule: str = "", sample_rate: float = 0.1,
                                run_on_backup: bool = False) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO verification_jobs (id,store,schedule,
                   sample_rate,run_on_backup,created_at) VALUES (?,?,?,?,?,?)
                   ON CONFLICT(id) DO UPDATE SET store=excluded.store,
                     schedule=excluded.schedule,
                     sample_rate=excluded.sample_rate,
                     run_on_backup=excluded.run_on_backup""",
                (vid, store, schedule, sample_rate, int(run_on_backup),
                 time.time()))

    def list_verification_jobs(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in
                    self._conn.execute("SELECT * FROM verification_jobs")]

    def record_verification_result(self, vid: str, status: str,
                                   report: dict) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """UPDATE verification_jobs SET last_run_at=?, last_status=?,
                   last_report=? WHERE id=?""",
                (time.time(), status, json.dumps(report), vid))

    # -- sync jobs (datastore replication, docs/sync.md) ---------------------
    def upsert_sync_job(self, sid: str, *, direction: str = "pull",
                        remote_url: str = "", remote_token: str = "",
                        peer_path: str = "", backup_type: str = "",
                        backup_id: str = "", namespace: str = "",
                        schedule: str = "", enabled: bool = True) -> None:
        from ..utils import validate
        validate.job_id(sid)
        if direction not in ("pull", "push"):
            raise ValueError(f"sync direction must be pull|push, "
                             f"got {direction!r}")
        if bool(remote_url) == bool(peer_path):
            raise ValueError("exactly one of remote_url / peer_path "
                             "must be set")
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO sync_jobs (id,direction,remote_url,
                   remote_token,peer_path,backup_type,backup_id,namespace,
                   schedule,enabled,created_at) VALUES (?,?,?,?,?,?,?,?,?,?,?)
                   ON CONFLICT(id) DO UPDATE SET
                     direction=excluded.direction,
                     remote_url=excluded.remote_url,
                     remote_token=excluded.remote_token,
                     peer_path=excluded.peer_path,
                     backup_type=excluded.backup_type,
                     backup_id=excluded.backup_id,
                     namespace=excluded.namespace,
                     schedule=excluded.schedule,
                     enabled=excluded.enabled""",
                (sid, direction, remote_url, remote_token, peer_path,
                 backup_type, backup_id, namespace, schedule, int(enabled),
                 time.time()))

    def get_sync_job(self, sid: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM sync_jobs WHERE id=?", (sid,)).fetchone()
        return dict(r) if r else None

    def list_sync_jobs(self, *, enabled_only: bool = False) -> list[dict]:
        q = "SELECT * FROM sync_jobs"
        if enabled_only:
            q += " WHERE enabled=1"
        with self._lock:
            return [dict(r) for r in self._conn.execute(q)]

    def delete_sync_job(self, sid: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM sync_jobs WHERE id=?", (sid,))

    def record_sync_result(self, sid: str, status: str,
                           report: dict) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """UPDATE sync_jobs SET last_run_at=?, last_status=?,
                   last_report=? WHERE id=?""",
                (time.time(), status, json.dumps(report), sid))

    # -- hook scripts (reference: Script entity + PBS_PLUS__* env
    #    protocol, internal/server/jobs/{env,shell}.go) ----------------------
    def upsert_script(self, name: str, content: str,
                      description: str = "") -> None:
        from ..utils import validate
        validate.job_id(name)
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO scripts (name,content,description,created_at,
                   updated_at) VALUES (?,?,?,?,?)
                   ON CONFLICT(name) DO UPDATE SET content=excluded.content,
                     description=excluded.description,
                     updated_at=excluded.updated_at""",
                (name, content, description, time.time(), time.time()))

    def get_script(self, name: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM scripts WHERE name=?", (name,)).fetchone()
        return dict(r) if r else None

    def list_scripts(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in
                    self._conn.execute("SELECT * FROM scripts")]

    def delete_script(self, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM scripts WHERE name=?", (name,))

    # -- alert settings ------------------------------------------------------
    def get_alert_setting(self, key: str, default: str = "") -> str:
        with self._lock:
            r = self._conn.execute(
                "SELECT value FROM alert_settings WHERE key=?",
                (key,)).fetchone()
        return r["value"] if r else default

    def put_alert_setting(self, key: str, value: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO alert_settings (key,value) VALUES (?,?)
                   ON CONFLICT(key) DO UPDATE SET value=excluded.value""",
                (key, value))

    def list_alert_settings(self) -> dict[str, str]:
        with self._lock:
            return {r["key"]: r["value"] for r in self._conn.execute(
                "SELECT * FROM alert_settings")}

    def list_restores(self, limit: int = 200) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM restore_jobs ORDER BY created_at DESC "
                "LIMIT ?", (limit,))]

    def get_verification_job(self, vid: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM verification_jobs WHERE id=?",
                (vid,)).fetchone()
        return dict(r) if r else None

    # -- task log (PBS-visible tasks, §2.6) ----------------------------------
    def create_task(self, upid: str, job_id: str, kind: str,
                    detail: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT OR REPLACE INTO task_log (upid,job_id,kind,status,
                   detail,started_at) VALUES (?,?,?,?,?,?)""",
                (upid, job_id, kind, STATUS_RUNNING, detail, time.time()))

    def append_task_log(self, upid: str, line: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE task_log SET log = log || ? WHERE upid=?",
                (line.rstrip("\n") + "\n", upid))

    def finish_task(self, upid: str, status: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE task_log SET status=?, finished_at=? WHERE upid=?",
                (status, time.time(), upid))

    def get_task(self, upid: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM task_log WHERE upid=?", (upid,)).fetchone()
        return dict(r) if r else None

    def list_running_tasks(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM task_log WHERE status=?", (STATUS_RUNNING,))]

    def list_tasks(self, *, job_id: str | None = None,
                   limit: int = 100) -> list[dict]:
        q = "SELECT * FROM task_log"
        args: tuple = ()
        if job_id:
            q += " WHERE job_id=?"
            args = (job_id,)
        q += " ORDER BY started_at DESC LIMIT ?"
        with self._lock:
            return [dict(r) for r in self._conn.execute(q, args + (limit,))]

    # -- exclusions ----------------------------------------------------------
    def add_exclusion(self, pattern: str, job_id: str = "",
                      comment: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO exclusions (job_id,pattern,comment) VALUES (?,?,?)",
                (job_id, pattern, comment))

    def delete_exclusion(self, eid: int) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM exclusions WHERE id=?", (eid,))

    def list_exclusions(self, job_id: str = "") -> list[str]:
        """Global exclusions + per-job ones."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT pattern FROM exclusions WHERE job_id='' OR job_id=?",
                (job_id,)).fetchall()
        return [r["pattern"] for r in rows]

    # -- shared job queue (migration 009; server/services/jobqueue.py) -------
    # The DB-wide mirror of the jobs plane: every admission lands a row
    # here so the queue BOUND is shared across every server process that
    # opens this database.  Fairness (strict priority + per-tenant RR)
    # stays per-process inside JobsManager — the shared state is the
    # bound and the queue's observability, not the grant order.

    def queue_admit(self, job_id: str, kind: str, tenant: str,
                    owner: str, *, max_queued: int = 0,
                    weight: int = 1) -> str:
        """Admit ``job_id`` into the shared queue.  Returns
        ``"admitted"``, ``"full"`` (DB-wide 'queued' count at
        ``max_queued`` — the caller raises the typed QueueFullError),
        or ``"active"`` (a NON-TERMINAL row already exists — in any
        process: resetting a live sibling's 'running' row would both
        double-run the job and blind GC's fleet-wide running check, so
        dedup-by-id is fleet-wide here).  Only terminal rows (a retry
        round) are reset.  The check+insert runs under BEGIN IMMEDIATE
        so two processes admitting concurrently serialize on the
        database write lock — the bound cannot be overshot and the
        active-row check cannot race."""
        with self._lock:
            if not self._conn.in_transaction:
                # a real lock-wait failure ("database is locked") must
                # raise, not silently drop the serialization guarantee
                self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT status FROM job_queue WHERE id=?",
                    (job_id,)).fetchone()
                if row is not None and row["status"] in ("queued",
                                                         "running"):
                    self._conn.execute("ROLLBACK")
                    return "active"
                if max_queued and max_queued > 0:
                    n = self._conn.execute(
                        "SELECT COUNT(*) AS n FROM job_queue WHERE "
                        "status='queued'").fetchone()["n"]
                    if n >= max_queued:
                        self._conn.execute("ROLLBACK")
                        return "full"
                self._conn.execute(
                    """INSERT INTO job_queue (id,kind,tenant,owner,status,
                       enqueued_at,weight) VALUES (?,?,?,?, 'queued', ?,?)
                       ON CONFLICT(id) DO UPDATE SET kind=excluded.kind,
                         tenant=excluded.tenant, owner=excluded.owner,
                         status='queued', enqueued_at=excluded.enqueued_at,
                         started_at=NULL, finished_at=NULL, error='',
                         weight=excluded.weight""",
                    (job_id, kind, tenant, owner, time.time(),
                     max(1, int(weight))))
                self._conn.execute("COMMIT")
            except BaseException:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.OperationalError:
                    pass
                raise
        return "admitted"

    def queue_mark_running(self, job_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE job_queue SET status='running', started_at=? "
                "WHERE id=?", (time.time(), job_id))

    def queue_finish(self, job_id: str, status: str,
                     error: str = "") -> None:
        """Terminal transition (``done`` / ``error`` / ``rejected``)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE job_queue SET status=?, finished_at=?, error=? "
                "WHERE id=?", (status, time.time(), error, job_id))

    def queue_depth(self) -> int:
        """DB-wide queued count — the shared bound's denominator."""
        with self._lock:
            r = self._conn.execute(
                "SELECT COUNT(*) AS n FROM job_queue WHERE "
                "status='queued'").fetchone()
        return int(r["n"])

    def queue_counts(self) -> dict[str, int]:
        """{status: count} across every process sharing this DB."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT status AS k, COUNT(*) AS n FROM job_queue "
                "GROUP BY status").fetchall()
        return {str(r["k"]): int(r["n"]) for r in rows}

    def queue_reap_owner(self, owner: "str | None") -> int:
        """Rows a dead/restarted process left queued or running become
        error rows (the bootstrap orphan-cleanup discipline applied to
        the shared queue) — they must stop counting against the bound.
        ``owner=None`` reaps EVERY live row: the single-process boot
        path, where a pid-derived owner id changes across restarts and
        no sibling process can exist by definition."""
        q = ("UPDATE job_queue SET status='error', finished_at=?, "
             "error='owner restarted' WHERE status IN "
             "('queued','running')")
        args: tuple = (time.time(),)
        if owner is not None:
            q += " AND owner=?"
            args += (owner,)
        with self._lock, self._conn:
            cur = self._conn.execute(q, args)
        return cur.rowcount

    # -- shared admission counters (migration 009) ---------------------------
    def bump_admission_counters(self, deltas: "dict[str, int]") -> None:
        """Accumulate AgentsManager admission verdict deltas into the
        cross-process counters (flushed, not per-event — one write per
        flush, not per session open)."""
        items = [(k, int(v)) for k, v in deltas.items() if v]
        if not items:
            return
        with self._lock, self._conn:
            self._conn.executemany(
                """INSERT INTO admission_counters (key, value)
                   VALUES (?, ?) ON CONFLICT(key) DO UPDATE SET
                   value = value + excluded.value""", items)

    def admission_counters(self) -> dict[str, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM admission_counters").fetchall()
        return {str(r["key"]): int(r["value"]) for r in rows}

    # -- GC leader lease (migration 009; server/services/prune.py) ----------
    # Single-row CAS discipline: the conditional upsert only lands when
    # the caller already holds the lease OR the incumbent's TTL has
    # expired — one statement, atomic under SQLite's write lock, so two
    # processes racing for an expired lease cannot both win.

    def acquire_gc_lease(self, holder: str, ttl_s: float) -> dict:
        """Try to take (or renew) the GC leader lease.  Returns
        ``{"acquired": bool, "outcome": "acquired"|"renewed"|"stolen"|
        "held", "holder": ..., "expires_at": ...}`` — ``held`` means a
        live incumbent owns it and the caller must not sweep."""
        now = time.time()
        with self._lock, self._conn:
            prior = self._conn.execute(
                "SELECT * FROM gc_lease WHERE id=1").fetchone()
            prior = dict(prior) if prior else None
            cur = self._conn.execute(
                """INSERT INTO gc_lease (id,holder,generation,acquired_at,
                   renewed_at,expires_at,sweeping) VALUES (1,?,1,?,?,?,1)
                   ON CONFLICT(id) DO UPDATE SET
                     holder=excluded.holder,
                     generation=gc_lease.generation +
                       (gc_lease.holder != excluded.holder),
                     acquired_at=CASE WHEN gc_lease.holder=excluded.holder
                       THEN gc_lease.acquired_at
                       ELSE excluded.acquired_at END,
                     renewed_at=excluded.renewed_at,
                     expires_at=excluded.expires_at,
                     sweeping=1
                   WHERE gc_lease.holder=excluded.holder
                      OR gc_lease.expires_at < excluded.renewed_at""",
                (holder, now, now, now + ttl_s))
            acquired = cur.rowcount > 0
        if not acquired:
            return {"acquired": False, "outcome": "held",
                    "holder": prior["holder"] if prior else "",
                    "expires_at": prior["expires_at"] if prior else 0.0}
        if prior is None:
            outcome = "acquired"
        elif prior["holder"] == holder:
            outcome = "renewed"
        elif prior["expires_at"] < now:
            outcome = "stolen"
        else:
            # prior expired between our read and the upsert's check —
            # still a steal from the caller's point of view
            outcome = "stolen"
        return {"acquired": True, "outcome": outcome, "holder": holder,
                "expires_at": now + ttl_s}

    def renew_gc_lease(self, holder: str, ttl_s: float) -> bool:
        """Heartbeat: extend the TTL iff we still hold the lease.  False
        means the lease was stolen (TTL lapsed mid-sweep) — the caller's
        sweep result is suspect and must be logged as such."""
        now = time.time()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE gc_lease SET renewed_at=?, expires_at=? "
                "WHERE id=1 AND holder=?", (now, now + ttl_s, holder))
        return cur.rowcount > 0

    def mark_gc_lease_idle(self, holder: str) -> bool:
        """A successful sweep KEEPS the lease for its TTL (the unexpired
        row is how a same-cycle loser observes `held` — exactly-once per
        cycle) but demotes it to a cycle marker: ``sweeping=0`` lets the
        jobs plane's ``fleet_gc_active`` gate reopen immediately instead
        of stalling backups for a whole TTL after every GC."""
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE gc_lease SET sweeping=0 WHERE id=1 AND holder=?",
                (holder,))
        return cur.rowcount > 0

    def release_gc_lease(self, holder: str) -> bool:
        """Drop the lease iff still held — fast handover beats waiting
        out the TTL when the sweeper exits cleanly."""
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM gc_lease WHERE id=1 AND holder=?", (holder,))
        return cur.rowcount > 0

    def get_gc_lease(self) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM gc_lease WHERE id=1").fetchone()
        return dict(r) if r else None
