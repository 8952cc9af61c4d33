"""Configuration singleton + compile-time constants.

Reference: internal/conf/config.go:5-38 (env singleton),
internal/conf/constants.go:5-55 (ports, paths, limits),
internal/conf/buffer.go:9-43 (RAM-derived sizing).

The reference loads an env singleton once and derives buffer/concurrency
sizes from system RAM.  We keep the same shape: a frozen ``Env`` read from
the process environment on first access, plus derived sizing helpers.

A copy of the JAX package's ``utils/conf.py``, its code byte for byte
apart from its imports, which name the port's own modules."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache

# --- network constants (reference: internal/conf/constants.go:7-12) ------
# Five-port topology: proxied PBS UI, REST API, agent HTTP, aRPC data/control.
PBS_UI_PORT = 8007
API_PORT = 8017
AGENT_HTTP_PORT = 8018
ARPC_PORT = 8008          # TCP mTLS + mux data plane (and control plane here;
                          # the reference splits control onto QUIC/UDP 8008)

# --- framing / buffers (reference: internal/arpc/binary_stream.go:12-16,
#     internal/conf/buffer.go:9) -------------------------------------------
MAX_FRAME_SIZE = 1 << 30          # 1 GiB raw-frame cap
STREAM_BUFFER_SIZE = 4 << 20      # 4 MiB per-stream buffer

# chunker size constants live with the format spec:
# pbs_plus_tpu/chunker/spec.py DEFAULT_PARAMS (4 MiB) / TEST_PARAMS (4 KiB)
# (reference: buzhash.NewConfig(4<<20), internal/pxarmount/commit_orchestrate.go:144)

# --- identity / state dirs (reference: internal/conf/constants.go:17-45) --
DEFAULT_STATE_DIR = "/var/lib/pbs-plus-tpu"
DEFAULT_CERT_DIR = "/etc/pbs-plus-tpu/certs"
DEFAULT_DB_NAME = "pbs-plus-tpu.db"
CERT_RENEW_BEFORE_DAYS = 30
CA_ROTATION_GRACE_DAYS = 7

# --- rate limiting (reference: internal/arpc/agents_manager.go:225-268) ---
CLIENT_RATE_LIMIT_PER_SEC = 10.0
CLIENT_RATE_LIMIT_BURST = 20

# --- env-var registry ------------------------------------------------------
# The declaration of record for every PBS_PLUS_* environment knob the
# product tree reads.  pbslint's whole-program `registry-consistency`
# rule enforces closure in both directions: an env string referenced
# anywhere under pbs_plus_tpu/ must be declared here AND documented in
# docs/configuration.md, and every entry here must actually be read
# somewhere.  Test/bench-only knobs (PBS_PLUS_FLEET, PBS_PLUS_SOAK,
# PBS_PLUS_BENCH*) live outside the product tree and are documented in
# the same table without being registered.
ENV_VARS = {
    "PBS_PLUS_DEBUG": "verbose debug logging (1/true/yes)",
    "PBS_PLUS_HOSTNAME": "server identity override (default: uname)",
    "PBS_PLUS_SERVER_URL": "server base URL handed to agents/operator",
    "PBS_PLUS_STATE_DIR": "state directory (db, checkpoints, sync state)",
    "PBS_PLUS_CERT_DIR": "certificate directory for the mTLS plane",
    "PBS_PLUS_CHUNKER": "chunker kind: cpu | tpu",
    "PBS_PLUS_CHUNKER_BACKEND": "CPU scan impl: scalar | vector",
    "PBS_PLUS_SIDECAR_TIMEOUT": "dedup sidecar per-RPC deadline (s)",
    "PBS_PLUS_CHECKPOINT_INTERVAL": "durable checkpoint cadence <N>c/<M>s",
    "PBS_PLUS_CHUNK_CACHE_MB": "shared read-path chunk cache budget (MiB)",
    "PBS_PLUS_CHUNK_READAHEAD": "base chunks prefetched ahead of a scan",
    "PBS_PLUS_CHUNK_READAHEAD_MAX": "adaptive readahead window ceiling",
    "PBS_PLUS_CHUNK_PREFETCH_THREADS": "shared chunk prefetch pool size",
    "PBS_PLUS_DEDUP_INDEX_MB": "dedup-index cuckoo filter budget (MiB)",
    "PBS_PLUS_DEDUP_RESIDENT_MB": "exact-confirm memtable budget (MiB)",
    "PBS_PLUS_STORE_SHARDS": "chunk store logical shard count",
    "PBS_PLUS_SHARED_DATASTORE": "shared-datastore instance id ('' = off)",
    "PBS_PLUS_DELTA_TIER": "enable the similarity-dedup delta tier",
    "PBS_PLUS_DELTA_THRESHOLD": "max sketch Hamming distance for a base",
    "PBS_PLUS_DELTA_MAX_CHAIN": "max delta-chain depth (base hops)",
    "PBS_PLUS_FUSED_INGEST": "cross-session fused ingest batching",
    "PBS_PLUS_INGEST_BATCH_BYTES": "fused-ingest flush size threshold",
    "PBS_PLUS_INGEST_MAX_WAIT_MS": "fused-ingest flush deadline (ms)",
    "PBS_PLUS_AGENT_RATE": "per-client token bucket rate (req/s)",
    "PBS_PLUS_AGENT_BURST": "per-client token bucket burst",
    "PBS_PLUS_AGENT_OPEN_RATE": "global session-open rate (0 = off)",
    "PBS_PLUS_AGENT_MAX_SESSIONS": "hard ceiling on registered sessions",
    "PBS_PLUS_ADMISSION_DEADLINE_MS": "admission wait deadline (0 = fast-fail)",
    "PBS_PLUS_MUX_WRITE_DEADLINE": "mux slow-reader shed deadline (s)",
    "PBS_PLUS_MAX_QUEUED_JOBS": "jobs-queue bound (QueueFullError past it)",
    "PBS_PLUS_TENANT_WEIGHTS": "fair-share weights 'tenant=w,...' ('' = 1x)",
    "PBS_PLUS_SYNC_BATCH": "digests per sync membership-negotiation batch",
    "PBS_PLUS_FAILPOINTS": "arm failpoints at import (site=action@trig;…)",
    "PBS_PLUS_TRACE_RING": "trace ring capacity (closed spans retained)",
    "PBS_PLUS_LOCKWATCH": "runtime lock-order witness (utils/lockwatch.py)",
    "PBS_PLUS_FSWITNESS": "runtime fs-protocol witness (utils/fswitness.py)",
    "PBS_PLUS_BOOTSTRAP_URL": "operator: agent bootstrap endpoint",
    "PBS_PLUS_BOOTSTRAP_TOKEN": "operator: bootstrap bearer token",
    "PBS_PLUS_AGENT_IMAGE": "operator: agent container image",
    "PBS_PLUS_LEADER_ELECT": "operator: lease-based leader election (0=off)",
    "PBS_PLUS_FEEDER_MESH": "models: multi-host feeder mesh (0=off)",
    "PBS_PLUS_FEEDER_LINGER_S": "models: feeder linger before teardown (s)",
    "PBS_PLUS_DIST_INDEX_SHARDS": "distributed index shard spec ('' = off)",
    "PBS_PLUS_DIST_INDEX_TOKEN": "distributed index bearer token",
    "PBS_PLUS_DIST_INDEX_TIMEOUT_S": "distributed index per-request deadline",
    "PBS_PLUS_DIST_INDEX_MAP": "shard-map snapshot path ('' = wire-only)",
}


@dataclass(frozen=True)
class Env:
    """Process environment, loaded once (reference: conf.Env)."""

    debug: bool = False
    hostname: str = ""
    server_url: str = ""
    state_dir: str = DEFAULT_STATE_DIR
    cert_dir: str = DEFAULT_CERT_DIR
    chunker: str = "cpu"            # "cpu" | "tpu"  — the one-line config
                                    # change from BASELINE.json's north star
    # CPU scan implementation for cpu-kind chunkers: "" (scalar) |
    # "scalar" | "vector" (chunker/vector.py — the SIMD-style doubling
    # scan, self-test-gated with scalar fallback).  ServerConfig's
    # chunker_backend overrides this fleet-wide default per server.
    chunker_backend: str = ""
    log_dedup_window_s: float = 5.0
    # per-RPC deadline for the dedup sidecar's gRPC calls (the old
    # hard-coded 300 in sidecar/client.py, now an operator knob)
    sidecar_timeout_s: float = 300.0
    # durable backup checkpoints (server/checkpoint.py): "<N>c/<M>s"
    # persists in-flight session state every N committed payload chunks
    # and/or M seconds; "" (default) disables checkpointing
    checkpoint_interval: str = ""
    # read-path chunk cache (pxar/chunkcache.py): byte budget of the
    # process-shared LRU of decompressed, verified chunks (MiB; 0
    # disables caching) and how many chunks ahead a detected forward
    # scan prefetches (0 disables readahead)
    chunk_cache_mb: int = 256
    chunk_readahead: int = 4
    # adaptive readahead: the window doubles from chunk_readahead up to
    # this ceiling on confirmed sequential scans, and halves back on a
    # misprediction; the prefetch pool is process-global and shared by
    # every open reader
    chunk_readahead_max: int = 32
    chunk_prefetch_threads: int = 2
    # dedup index (pxar/chunkindex.py, docs/data-plane.md "Dedup
    # index"): initial byte budget of the memory-resident cuckoo-filter
    # membership front (MiB; the filter still grows under load-factor
    # pressure; 0 disables the index — negative dedup probes then fall
    # back to a per-digest disk stat) and the chunk store's logical
    # shard count (per-shard locks + compressors; GC mark/sweep runs
    # shard-parallel)
    dedup_index_mb: int = 64
    # spillable exact-confirm tier (pxar/digestlog.py, docs/data-plane.md
    # "Spillable exact-confirm tier"): resident budget of the confirm
    # memtable in MiB — past it, recent digests spill to immutable
    # sorted segments under <store>/.chunkindex/segments/ and a confirm
    # probe costs one fence-guided pread.  0 keeps the whole exact set
    # in RAM (the pre-spill behavior; resident cost then scales with
    # the chunk count, ~120-160 B/digest)
    dedup_resident_mb: int = 256
    store_shards: int = 16
    # shared-datastore scale-out (docs/architecture.md
    # "Service map"): names THIS server process when several processes
    # open one datastore — switches novel-chunk writes to the os.link
    # claim (written exactly once fleet-wide) and moves index spill/
    # snapshot state to per-instance paths.  "" = single-process mode.
    shared_datastore: str = ""
    # similarity-dedup tier (pxar/similarityindex.py + pxar/deltablob.py,
    # docs/data-plane.md "Similarity tier"): store near-duplicate chunks
    # as deltas against a resembling base chunk.  delta_tier 0 disables
    # (default — opt-in, restores stay bit-identical either way);
    # delta_threshold is the max sketch Hamming distance (of 64) to
    # accept a base; delta_max_chain bounds the base-hop depth a
    # reassembly may pay
    delta_tier: bool = False
    delta_threshold: int = 14
    delta_max_chain: int = 3
    # cross-session fused ingest (pxar/ingestbatch.py, docs/data-plane.md
    # "Fused ingest"): pack every concurrent session's pending buffers
    # into one ragged batch and run CDC scan -> sha -> probe -> presketch
    # as ONE fused pass per flush.  fused_ingest 0 keeps the per-session
    # staged path; ingest_batch_bytes is the flush size threshold and
    # ingest_max_wait_ms bounds how long a lone depositor can wait.
    fused_ingest: bool = False
    ingest_batch_bytes: int = 16 << 20
    ingest_max_wait_ms: int = 25
    # fleet admission control (arpc/agents_manager.py, docs/fleet.md):
    # per-client token bucket (the old hardcoded 10/s burst 20), a
    # global session-open rate bucket, and a hard ceiling on concurrent
    # registered sessions.  0 disables the respective gate.
    agent_rate: float = CLIENT_RATE_LIMIT_PER_SEC
    agent_burst: int = CLIENT_RATE_LIMIT_BURST
    agent_open_rate: float = 0.0
    agent_max_sessions: int = 4096
    # deadline admission (arpc/agents_manager.py, docs/fleet.md
    # "Admission"): >0 turns the session-ceiling fast-fail into a
    # bounded wait — an arriving handshake queues up to this many
    # milliseconds for capacity before the typed AdmissionDeadlineError;
    # 0 (default) keeps the pure fast-fail 503
    admission_deadline_ms: float = 0.0
    # mux slow-reader shed (arpc/mux.py): a frame write blocked on a
    # full transport for longer than this sheds the CONNECTION instead
    # of buffering without bound; 0 disables the deadline
    mux_write_deadline_s: float = 60.0
    # jobs queue bound (server/jobs.py): enqueues past this many
    # waiting jobs fast-fail with QueueFullError; 0 = unbounded
    max_queued_jobs: int = 1024
    # weighted-fair tenant shares (server/jobs.py, docs/fleet.md
    # "Fairness"): "tenant=weight,tenant2=weight" — a listed tenant's
    # slot-grant share within its priority class is proportional to its
    # weight; unlisted tenants default to the job-carried weight (1)
    tenant_weights: str = ""
    # datastore replication (pxar/syncwire.py, docs/sync.md): digests
    # per membership-negotiation batch — one vectorized destination
    # probe_batch (and at most one chunk transfer round) per batch
    sync_batch: int = 1024
    # distributed dedup index (parallel/dist_index.py, docs/dist-index.md):
    # a non-empty shard spec ("s0=host:port,s1=host:port,...") replaces
    # the in-process DedupIndex with a DistIndexClient over those shard
    # nodes; the token authenticates the /distidx/v1 wire, timeout_s
    # bounds each fan-out request, and dist_index_map names the local
    # shard-map snapshot (a corrupt/missing snapshot degrades to a wire
    # re-read of shard epochs).  "" = local single-process index.
    dist_index_shards: str = ""
    dist_index_token: str = ""
    dist_index_timeout_s: float = 30.0
    dist_index_map: str = ""
    extra: dict = field(default_factory=dict)


def _float_env(e, name: str, default: str) -> float:
    try:
        return float(e.get(name, default))
    except ValueError:
        return float(default)


def _int_env(e, name: str, default: str) -> int:
    try:
        return int(e.get(name, default))
    except ValueError:
        return int(default)


@lru_cache(maxsize=1)
def env() -> Env:
    e = os.environ
    return Env(
        debug=e.get("PBS_PLUS_DEBUG", "").lower() in ("1", "true", "yes"),
        hostname=e.get("PBS_PLUS_HOSTNAME", os.uname().nodename),
        server_url=e.get("PBS_PLUS_SERVER_URL", ""),
        state_dir=e.get("PBS_PLUS_STATE_DIR", DEFAULT_STATE_DIR),
        cert_dir=e.get("PBS_PLUS_CERT_DIR", DEFAULT_CERT_DIR),
        chunker=e.get("PBS_PLUS_CHUNKER", "cpu"),
        chunker_backend=e.get("PBS_PLUS_CHUNKER_BACKEND", ""),
        log_dedup_window_s=_float_env(e, "LOG_DEDUP_WINDOW", "5"),
        sidecar_timeout_s=_float_env(e, "PBS_PLUS_SIDECAR_TIMEOUT", "300"),
        checkpoint_interval=e.get("PBS_PLUS_CHECKPOINT_INTERVAL", ""),
        chunk_cache_mb=_int_env(e, "PBS_PLUS_CHUNK_CACHE_MB", "256"),
        chunk_readahead=_int_env(e, "PBS_PLUS_CHUNK_READAHEAD", "4"),
        chunk_readahead_max=_int_env(e, "PBS_PLUS_CHUNK_READAHEAD_MAX",
                                     "32"),
        chunk_prefetch_threads=_int_env(e, "PBS_PLUS_CHUNK_PREFETCH_THREADS",
                                        "2"),
        dedup_index_mb=_int_env(e, "PBS_PLUS_DEDUP_INDEX_MB", "64"),
        dedup_resident_mb=_int_env(e, "PBS_PLUS_DEDUP_RESIDENT_MB",
                                   "256"),
        store_shards=_int_env(e, "PBS_PLUS_STORE_SHARDS", "16"),
        shared_datastore=e.get("PBS_PLUS_SHARED_DATASTORE", ""),
        delta_tier=e.get("PBS_PLUS_DELTA_TIER", "").lower()
        in ("1", "true", "yes"),
        delta_threshold=_int_env(e, "PBS_PLUS_DELTA_THRESHOLD", "14"),
        delta_max_chain=_int_env(e, "PBS_PLUS_DELTA_MAX_CHAIN", "3"),
        fused_ingest=e.get("PBS_PLUS_FUSED_INGEST", "").lower()
        in ("1", "true", "yes"),
        ingest_batch_bytes=_int_env(e, "PBS_PLUS_INGEST_BATCH_BYTES",
                                    str(16 << 20)),
        ingest_max_wait_ms=_int_env(e, "PBS_PLUS_INGEST_MAX_WAIT_MS",
                                    "25"),
        agent_rate=_float_env(e, "PBS_PLUS_AGENT_RATE",
                              str(CLIENT_RATE_LIMIT_PER_SEC)),
        agent_burst=_int_env(e, "PBS_PLUS_AGENT_BURST",
                             str(CLIENT_RATE_LIMIT_BURST)),
        agent_open_rate=_float_env(e, "PBS_PLUS_AGENT_OPEN_RATE", "0"),
        agent_max_sessions=_int_env(e, "PBS_PLUS_AGENT_MAX_SESSIONS",
                                    "4096"),
        admission_deadline_ms=_float_env(
            e, "PBS_PLUS_ADMISSION_DEADLINE_MS", "0"),
        mux_write_deadline_s=_float_env(e, "PBS_PLUS_MUX_WRITE_DEADLINE",
                                        "60"),
        max_queued_jobs=_int_env(e, "PBS_PLUS_MAX_QUEUED_JOBS", "1024"),
        tenant_weights=e.get("PBS_PLUS_TENANT_WEIGHTS", ""),
        sync_batch=_int_env(e, "PBS_PLUS_SYNC_BATCH", "1024"),
        dist_index_shards=e.get("PBS_PLUS_DIST_INDEX_SHARDS", ""),
        dist_index_token=e.get("PBS_PLUS_DIST_INDEX_TOKEN", ""),
        dist_index_timeout_s=_float_env(e, "PBS_PLUS_DIST_INDEX_TIMEOUT_S",
                                        "30"),
        dist_index_map=e.get("PBS_PLUS_DIST_INDEX_MAP", ""),
    )


def parse_tenant_weights(spec: str) -> dict[str, int]:
    """Parse the PBS_PLUS_TENANT_WEIGHTS spec ("tenant=weight,...") into
    a tenant → weight map.  Malformed entries are dropped, weights are
    floored at 1 — a bad spec degrades to equal shares, never to a
    starved tenant."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _, raw = part.partition("=")
        tenant = tenant.strip()
        try:
            w = int(raw.strip())
        except ValueError:
            continue
        if tenant:
            out[tenant] = max(1, w)
    return out


def _system_ram_gib() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return max(1, int(line.split()[1]) // (1 << 20))
    except OSError:
        pass
    return 4


def max_concurrent_clients() -> int:
    """RAM-GiB clamped to [16, 512] (reference: internal/conf/buffer.go:33-38)."""
    return min(512, max(16, _system_ram_gib()))
