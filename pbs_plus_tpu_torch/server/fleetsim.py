"""Loopback agent-fleet simulator: hundreds of lightweight simulated
agents speaking REAL aRPC (mux frames, admission, expect/wait-session,
agentfs raw streams) against the real jobs/datastore plane, in one
process (docs/fleet.md, written for the JAX package).

The reference system is a fleet fabric — AgentsManager, scheduler, job
queues serving many agents at once — and its overload behavior only
shows up at scale.  This module makes N=500 a deterministic test: every
simulated agent is an asyncio peer dialing the server over plain-TCP
loopback (``transport.serve(tls=None)``; identity via the
``X-PBS-Plus-Loopback-CN`` header — TLS handshakes are
tests/test_arpc.py's job and would dominate a 1-core soak), serving a
deterministic in-memory tree over the REAL agentfs protocol, so every
layer from mux flow control up through ``RemoteTreeBackup`` and the
datastore runs exactly its production code.

The soak runner measures enqueue-to-publish latency percentiles,
session-open admission latency, mux frame throughput, and the maximum
observed depth of every bounded queue — and supports deterministic
chaos: a seeded subset of agents hard-kills its transports after N
agentfs reads (mid-backup), composing the failpoint/chaos discipline
with checkpointed resume at fleet scale.

A copy of the JAX package's ``server/fleetsim.py``, its code byte for
byte apart from its imports, which name the port's own modules, its
logger (``logging``) and these changes:

- ``FleetServer(..., device="cuda")``, ``run_fleet(..., device=)`` and
  ``run_multiproc_fleet(..., device=)`` (default ``"cuda"``; raises
  ``CudaUnavailableError`` without a card, ``"cpu"`` runs the plain
  versions): the server's ``LocalStore`` is built on that device, so
  every session cuts with K1, digests with K2 and probes with K3 there
  (the port's ``"cuda"`` chunker kind and batch hasher), and the verify
  lane's ``VerifyPipeline``, the sync mirror's ``Datastore`` and the
  multiproc runner's datastore view are on it too;
- ``_WorkerProc.spawn`` starts ``python -m
  pbs_plus_tpu_torch.server.fleetproc`` with ``--device`` (and sets no
  ``JAX_PLATFORMS``);
- ``MultiProcReport.launches``: each worker's K1/K2/K3 launches
  (``candidate_mask``, ``sha256_chunks``, ``cuckoo_probe``) from its
  ``metrics`` event, taken before the leader is killed and again from
  the survivor at the end;
- ``FleetServer.stop`` closes the listener, every session's and every
  other accepted connection, and only then waits for the listener: on
  Python 3.12 ``Server.wait_closed`` waits for every accepted
  connection, and the reference, which waits first, hangs for good
  where a connection outlives the run (a ``reconnect_storm`` redial that
  won the newest-wins race, a churned control transport).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import struct
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..agent.agentfs import AgentFSClient
from ..arpc import Router, Session, connect_to_server, serve
from ..arpc.agents_manager import AgentsManager
from ..arpc.binary_stream import (_HDR as _BIN_HDR, MAGIC as _BIN_MAGIC,
                                  VERSION as _BIN_VERSION,
                                  send_data_from_reader)
from ..arpc.call import RawStreamHandler
from ..arpc.mux import MuxConnection
from ..arpc.router import HandlerError
from ..arpc.transport import (_LEN as _HS_LEN, HANDSHAKE_MAGIC,
                              HDR_LOOPBACK_CN, HandshakeError)
from ..chunker import ChunkerParams
from ..pxar.backupproxy import LocalStore
from ..utils import codec, conf, failpoints, trace
from ..utils.device import resolve
from . import checkpoint, metrics
from .backup_job import RemoteTreeBackup
from .jobs import Job, JobsManager

L = logging.getLogger(__name__)

HDR_BACKUP_ID = "X-PBS-Plus-BackupID"

# fixed timestamp for every synthetic entry: snapshots become
# bit-reproducible across runs AND stat-identical across an agent
# restart (checkpoint resume's fast-skip predicate)
_FIXED_MTIME_NS = 1_700_000_000 * 1_000_000_000


@dataclass
class FleetConfig:
    n_agents: int = 100
    tenants: int = 4                     # agents round-robin into tenants
    files_per_agent: int = 3
    file_size: int = 8 << 10
    chunk_avg: int = 4 << 10
    # server knobs under test
    max_concurrent: int = 8              # execution slots
    max_queued: int = 2048               # jobs queue bound (asserted)
    max_sessions: int = 0                # 0 → 2*n_agents + slack
    open_rate: float = 0.0               # global session opens/s (0 = off)
    client_rate: float = 200.0           # per-CN bucket (high: the sim's
    client_burst: int = 400              # storm is the load, not the test)
    mux_write_deadline_s: float = 60.0
    checkpoint_interval: str = ""        # e.g. "1c" arms resumable chaos
    breaker_threshold: int = 5
    breaker_reset_s: float = 0.05
    # chaos: seeded fraction of agents that hard-kill their transports
    # after kill_after_reads agentfs reads (0.0 = no chaos)
    kill_fraction: float = 0.0
    kill_after_reads: int = 3
    seed: int = 2026
    connect_concurrency: int = 32        # simultaneous dials in the storm
    connect_attempts: int = 25           # per-agent retries on 429/503
    job_timeout_s: float = 300.0
    # replication traffic (the fleet tie-in): drive this many sync
    # jobs through the SAME jobs plane concurrently with the backup
    # round — all in one "sync" fairness lane (the verification
    # crowding rule), mirroring the fleet datastore into
    # sync_mirror_dir (default "<datastore>-mirror"); a final catch-up
    # sync after the backup rounds makes the mirror complete
    sync_jobs: int = 0
    sync_mirror_dir: str = ""
    # hostile agent profiles (docs/fleet.md
    # "Hostile clients"): EXTRA agents beyond n_agents that abuse the
    # mux — each performs the RX-credit violation (floods DATA past its
    # advertised credit on a kept-open call stream → server resets the
    # stream, flow_violations counted) and then the slow-reader attack
    # (pauses its transport reads and keeps requesting echo responses →
    # the server's write blocks past mux_write_deadline_s and sheds the
    # CONNECTION, write_deadline_sheds counted).  Both paths were built
    # with the mux and never before exercised by a soak.
    # sized past loopback TCP autotuning (~10 MiB of kernel buffering
    # can absorb a smaller flood without ever blocking the server's
    # writes): ~25 MiB of refused responses guarantees the drain stalls
    hostile_agents: int = 0
    hostile_echo_calls: int = 400
    hostile_echo_bytes: int = 64 << 10
    # hostile profile spec (docs/fleet.md "Hostile clients"):
    # "" keeps the classic flood+slow_reader pair per hostile agent;
    # otherwise a comma list from {flood, slow_reader, reconnect_storm,
    # length_liar, slowloris} assigned round-robin across hostile_agents
    hostile_profiles: str = ""
    hostile_reconnects: int = 6          # redials per reconnect_storm
    hostile_slowloris_rounds: int = 3    # stranded reservations per loris
    hostile_lie_bytes: int = 512         # declared-vs-actual shortfall
    # weighted-fair shares + deadline admission: a
    # "tenant=weight,..." spec plumbed into JobsManager exactly like
    # PBS_PLUS_TENANT_WEIGHTS; admission_deadline_ms > 0 turns the
    # session-ceiling fast-fail into a bounded deadline wait
    # (PBS_PLUS_ADMISSION_DEADLINE_MS semantics); reservation_ttl_s > 0
    # shrinks the admit-reservation TTL so a slowloris strand is reaped
    # within the soak instead of 20s later
    tenant_weights: str = ""
    admission_deadline_ms: float = 0.0
    reservation_ttl_s: float = 0.0
    # fleet-survival mixed traffic: each agent runs
    # jobs_per_agent sequential backups (chained on publish — two live
    # sessions into one snapshot group would race the publish); a seeded
    # churn_fraction of agents drops + redials its control transport
    # between waves (keepalive churn racing newest-wins eviction); the
    # first restore_jobs/verify_jobs agents get a read-back restore /
    # spot-check verify lane through the SAME execution slots
    jobs_per_agent: int = 1
    churn_fraction: float = 0.0
    restore_jobs: int = 0
    verify_jobs: int = 0
    # mount-serve read plane (docs/fleet.md "Read serving"):
    # readserve_readers reader jobs fan out across the agents' publish
    # events (an agent's publish spawns its share, so reads always hit
    # live snapshots and contend with the ingest still in flight).
    # Each reader performs readserve_reads clamped-range random-access
    # reads through ``file_reader``'s pump — snapshot picked by a
    # Zipf(readserve_zipf) rank over the published set, range verified
    # bit-for-bit against the synthetic tree — all in ONE
    # tenant="readserve" fairness lane over ONE sharded scan-resistant
    # chunk cache shared by every reader in the soak.  delta_tier=True
    # runs the whole soak over a similarity-delta datastore so the read
    # plane exercises delta-chain resolution, not just blob reads.
    readserve_readers: int = 0
    readserve_reads: int = 8
    readserve_zipf: float = 1.2
    delta_tier: bool = False


def zipf_rank(rng, n: int, s: float) -> int:
    """Sample a rank in [0, n) with P(k) ∝ 1/(k+1)^s — the readserve
    lane's access mix (rank 0 is the hot snapshot).  Inverse-CDF over
    the finite support; O(n) per draw is fine at fleet sizes."""
    if n <= 1:
        return 0
    weights = [(k + 1) ** -s for k in range(n)]
    x = rng.random() * sum(weights)
    for k, w in enumerate(weights):
        x -= w
        if x <= 0:
            return k
    return n - 1


def has_checkpoint(store: LocalStore, cn: str) -> bool:
    """True once a durable checkpoint exists for the agent's group —
    the chaos runner's crash gate (a kill before any checkpoint would
    test plain retry, not resume)."""
    from ..pxar.datastore import SnapshotRef
    d = checkpoint.group_ckpt_dir(store.datastore,
                                  SnapshotRef("host", cn, "x", ""))
    try:
        return any(n.startswith("ck-") for n in os.listdir(d))
    except OSError:
        return False


def synthetic_tree(seed: int, agent_idx: int, files: int,
                   size: int) -> dict[str, bytes]:
    """Deterministic per-agent tree: same (seed, idx) → same bytes, so
    chaos-run snapshots can be compared bit-for-bit to a clean run."""
    import numpy as np
    rng = np.random.default_rng((seed, agent_idx))
    return {f"data/f{i:02d}.bin":
            rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for i in range(files)}


class SyntheticFS:
    """In-memory agentfs server over a {relpath: bytes} tree — the same
    wire protocol as agent/agentfs.AgentFSServer (attr/read_dir/open/
    read_at raw-stream/close), no disk."""

    def __init__(self, tree: dict[str, bytes], *, on_read=None,
                 lie_bytes: int = 0):
        self.tree = dict(tree)
        # length-liar hostile profile: > 0 makes every read_at stream
        # DECLARE the full length and FIN lie_bytes short — the server's
        # receive path must refuse the transfer with a typed
        # StreamLengthError and count the violation per connection
        self.lie_bytes = lie_bytes
        self._dirs: dict[str, list[str]] = {"": []}
        for rel in self.tree:
            parts = rel.split("/")
            for i in range(len(parts)):
                parent = "/".join(parts[:i])
                name = parts[i]
                self._dirs.setdefault(parent, [])
                if i < len(parts) - 1:
                    self._dirs.setdefault("/".join(parts[:i + 1]), [])
                if name not in self._dirs[parent]:
                    self._dirs[parent].append(name)
        self._ino = {p: i + 2 for i, p in
                     enumerate(sorted(set(self.tree) | set(self._dirs)))}
        self._handles: dict[int, str] = {}
        self._next_handle = 1
        self._on_read = on_read
        self.reads = 0

    def _entry(self, rel: str) -> dict:
        name = rel.rsplit("/", 1)[-1] if rel else ""
        if rel in self.tree:
            kind, mode, size = "f", 0o644, len(self.tree[rel])
        elif rel in self._dirs:
            kind, mode, size = "d", 0o755, 0
        else:
            raise HandlerError(f"no such path {rel!r}", status=404)
        return {"name": name, "kind": kind, "mode": mode, "uid": 0,
                "gid": 0, "size": size, "mtime_ns": _FIXED_MTIME_NS,
                "nlink": 1, "ino": self._ino[rel], "dev": 1, "rdev": 0,
                "target": ""}

    def register(self, router: Router) -> None:
        router.handle("agentfs.stat_fs", self._stat_fs)
        router.handle("agentfs.attr", self._attr)
        router.handle("agentfs.read_dir", self._read_dir)
        router.handle("agentfs.read_link", self._read_link)
        router.handle("agentfs.xattrs", self._xattrs)
        router.handle("agentfs.open", self._open)
        router.handle("agentfs.read_at", self._read_at)
        router.handle("agentfs.close", self._close)

    async def _stat_fs(self, req, ctx):
        total = sum(len(b) for b in self.tree.values())
        return {"total": total, "free": 0, "files": len(self.tree)}

    async def _attr(self, req, ctx):
        return self._entry(req.payload.get("path", "").strip("/"))

    async def _read_dir(self, req, ctx):
        rel = req.payload.get("path", "").strip("/")
        names = self._dirs.get(rel)
        if names is None:
            raise HandlerError(f"not a directory: {rel!r}", status=404)
        return {"entries": [
            self._entry(f"{rel}/{n}" if rel else n) for n in sorted(names)]}

    async def _read_link(self, req, ctx):
        raise HandlerError("no symlinks in synthetic trees", status=404)

    async def _xattrs(self, req, ctx):
        return {"xattrs": {}}

    async def _open(self, req, ctx):
        rel = req.payload.get("path", "").strip("/")
        if rel not in self.tree:
            raise HandlerError(f"no such file {rel!r}", status=404)
        h, self._next_handle = self._next_handle, self._next_handle + 1
        self._handles[h] = rel
        return {"handle": h}

    async def _read_at(self, req, ctx):
        rel = self._handles.get(int(req.payload["handle"]))
        if rel is None:
            raise HandlerError("bad handle", status=400)
        self.reads += 1
        if self._on_read is not None:
            # chaos hook: a doomed agent hard-kills its transports here
            # (raises ConnectionResetError after aborting the sockets)
            await self._on_read(self)
        off, n = int(req.payload["off"]), int(req.payload["n"])
        data = self.tree[rel][off:off + n]
        lie = min(self.lie_bytes, len(data)) if self.lie_bytes > 0 else 0

        async def pump(stream):
            if lie:
                # the lying pump: header promises len(data), the stream
                # FINs short — a clean half-close, so the receiver sees
                # EOF (declared > actual), not a transport error
                await stream.write(_BIN_HDR.pack(_BIN_MAGIC, _BIN_VERSION,
                                                 len(data)))
                short = data[:len(data) - lie]
                if short:
                    await stream.write(short)
            else:
                await send_data_from_reader(stream, data, len(data))
        return RawStreamHandler(pump, data={"n": len(data)})

    async def _close(self, req, ctx):
        self._handles.pop(int(req.payload.get("handle", 0)), None)
        return {}


class SimAgent:
    """One simulated agent: a control session + on-demand backup job
    sessions, all over plain-TCP loopback aRPC."""

    def __init__(self, cn: str, host: str, port: int,
                 tree: dict[str, bytes], *, die_after_reads: int = 0,
                 crash_gate: Callable[[], bool] | None = None,
                 connect_attempts: int = 25,
                 write_deadline_s: float | None = None,
                 lie_bytes: int = 0):
        self.cn = cn
        self.host, self.port = host, port
        self.tree = tree
        self.lie_bytes = lie_bytes               # length-liar FS profile
        self.die_after_reads = die_after_reads   # 0 = never
        # structural chaos sync: a doomed agent crashes on the first read
        # ≥ die_after_reads for which this predicate holds (the runner
        # gates on "a durable checkpoint exists for my group", so the
        # kill is mid-backup AND resumable — no sleeps-as-sync)
        self.crash_gate = crash_gate
        self.connect_attempts = connect_attempts
        self.write_deadline_s = write_deadline_s
        self.conn: Optional[MuxConnection] = None
        self.dead = False
        self.connect_latency_s = 0.0     # FIRST successful dial only —
        #                                  the control session opened
        #                                  during the contended connect
        #                                  storm, not later job dials
        self.connect_rejects = 0         # 429/503 retries on the way in
        self._jobs: dict[str, tuple[MuxConnection, asyncio.Task]] = {}
        self._serve_task: Optional[asyncio.Task] = None
        self._conns: list[MuxConnection] = []

    async def _dial(self, headers: dict[str, str]) -> MuxConnection:
        """Dial with deterministic backoff on admission rejects (429 rate
        / 503 capacity) — the agent-side reconnect discipline."""
        delay = 0.02
        for attempt in range(self.connect_attempts):
            try:
                t0 = time.perf_counter()
                conn = await connect_to_server(
                    self.host, self.port, None, headers=headers,
                    keepalive_s=0,
                    write_deadline_s=self.write_deadline_s)
                if not self.connect_latency_s:
                    self.connect_latency_s = time.perf_counter() - t0
                    # the contended control dial feeds the shared
                    # session-open histogram (phase=connect); the
                    # report's percentiles derive from its buckets
                    trace.record("session.open", self.connect_latency_s)
                self._conns.append(conn)
                return conn
            except HandshakeError as e:
                if e.code not in (429, 503) or \
                        attempt == self.connect_attempts - 1:
                    raise
                self.connect_rejects += 1
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.5)
        raise RuntimeError("unreachable")

    async def start(self) -> None:
        headers = {HDR_LOOPBACK_CN: self.cn}
        self.conn = await self._dial(headers)
        router = Router()

        async def ping(req, ctx):
            return {"pong": True, "hostname": self.cn}

        async def target_status(req, ctx):
            return {"ok": True, "path": req.payload.get("path", "/")}

        async def backup(req, ctx):
            job_id = req.payload["job_id"]
            if job_id in self._jobs:
                return {"ok": True, "already": True}
            jconn = await self._dial({HDR_LOOPBACK_CN: self.cn,
                                      HDR_BACKUP_ID: job_id})
            fs = SyntheticFS(self.tree, on_read=self._maybe_crash,
                             lie_bytes=self.lie_bytes)
            job_router = Router()
            fs.register(job_router)
            task = asyncio.create_task(job_router.serve_connection(jconn),
                                       name=f"simjob:{self.cn}:{job_id}")
            self._jobs[job_id] = (jconn, task)
            return {"ok": True, "snapshot_method": "sim"}

        async def cleanup(req, ctx):
            job = self._jobs.pop(req.payload.get("job_id", ""), None)
            if job is not None:
                jconn, task = job
                await jconn.close()
                task.cancel()
            return {"ok": True}

        router.handle("ping", ping)
        router.handle("target_status", target_status)
        router.handle("backup", backup)
        router.handle("cleanup", cleanup)
        self._serve_task = asyncio.create_task(
            router.serve_connection(self.conn), name=f"simagent:{self.cn}")

    async def _maybe_crash(self, fs: SyntheticFS) -> None:
        if self.die_after_reads and fs.reads >= self.die_after_reads \
                and not self.dead \
                and (self.crash_gate is None or self.crash_gate()):
            self.crash()
            raise ConnectionResetError(
                f"simulated agent {self.cn} crashed mid-backup")

    async def churn(self) -> None:
        """Keepalive churn: abort the control transport (no FIN — the
        server learns of the death from its disconnect watch or from
        newest-wins eviction when the replacement registers) and redial
        immediately.  The agent stays usable for its next job wave."""
        if self._serve_task is not None:
            self._serve_task.cancel()
        if self.conn is not None:
            try:
                self.conn.writer.transport.abort()
            except Exception as e:          # already-dead transport
                L.debug("sim churn abort: %s", e)
        await self.start()

    def crash(self) -> None:
        """Simulated process death: abort every transport (no FIN, no
        cleanup RPC) — the server must notice via its disconnect watch."""
        self.dead = True
        for conn in self._conns:
            try:
                conn.writer.transport.abort()
            except Exception as e:       # already-dead transport
                L.debug("sim crash abort: %s", e)

    async def stop(self) -> None:
        for job_id in list(self._jobs):
            jconn, task = self._jobs.pop(job_id)
            await jconn.close()
            task.cancel()
        if self._serve_task is not None:
            self._serve_task.cancel()
        if self.conn is not None:
            await self.conn.close()

    def mux_stats(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for conn in self._conns:
            for k, v in conn.stats.items():
                out[k] = out.get(k, 0) + v
        return out


class HostileAgent(SimAgent):
    """The mux's abuse profiles driven at soak scale:

    1. **RX-credit violation.**  A hand-rolled call keeps its stream
       open after the response and floods DATA frames PAST the
       advertised credit (bypassing ``MuxStream.write``'s credit loop —
       exactly what a malicious client would do).  The server's
       ``_dispatch`` sees per-stream RX buffering blow through
       ``INITIAL_CREDIT + slack``, counts a ``flow_violation`` and
       resets the stream — bounded memory no matter how the peer
       behaves.
    2. **Slow-reader shed.**  The agent pauses its transport reads and
       keeps firing echo requests it never drains.  The server's
       response writes block on the full socket past
       ``mux_write_deadline_s`` and the connection is SHED
       (``write_deadline_sheds``) — the only safe unit, since skipping
       frames would desync the mux.

    Runs concurrently with the legit backup round; the soak asserts
    both counters fired server-side AND every legit agent still
    published.

    Three meaner profiles follow, selected per agent via
    ``profile`` (default ""/classic keeps the original pair):

    3. **reconnect-storm** (``reconnect_storm``): redials the SAME CN
       while the previous control connection is still open — every
       register must deterministically evict the predecessor
       (newest-wins; ``AgentsManager.evictions`` counted) and the storm
       ends with exactly one live session, never a leak.
    4. **stream-length liar** (``length_liar``): no connection abuse —
       the agent's agentfs serves a LYING pump (declared length >
       actual, clean FIN).  The runner runs its backup through a
       separate accounting lane; the server must refuse it with a typed
       ``StreamLengthError`` and count ``stream_length_violations``.
    5. **slowloris handshake** (``slowloris``): sends a bare handshake
       hello and dies before the server's ok frame (the
       ``arpc.handshake.accept`` delay failpoint holds the window
       open), stranding an admission reservation per round — reaped by
       the TTL sweep (``reservations_reaped``), never leaked.
    """

    def __init__(self, *args, profile: str = "", **kw):
        super().__init__(*args, **kw)
        self.profile = profile

    async def run_attacks(self, *, echo_calls: int, echo_bytes: int,
                          reconnects: int = 6,
                          slowloris_rounds: int = 3) -> None:
        kill_conns = True
        try:
            if self.profile == "flood":
                await self._attack_flow_violation()
            elif self.profile == "slow_reader":
                await self._attack_slow_reader(echo_calls, echo_bytes)
            elif self.profile == "reconnect_storm":
                await self._attack_reconnect_storm(reconnects)
                kill_conns = False      # ends with one LIVE session
            elif self.profile == "slowloris":
                await self._attack_slowloris(slowloris_rounds)
                kill_conns = False      # control session never abused
            elif self.profile == "length_liar":
                # the lying happens in the backup lane the runner
                # submits for this agent — the control session must
                # stay up to serve it
                return
            else:               # classic: the original pair
                await self._attack_flow_violation()
                await asyncio.sleep(0.05)
                await self._attack_slow_reader(echo_calls, echo_bytes)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass        # the server killed us — that is the assertion
        finally:
            if kill_conns:
                self.dead = True

    async def _attack_flow_violation(self) -> None:
        """Valid call, then a credit-bypassing flood on the same stream
        (the server half-closed after responding, so nothing drains the
        RX buffer — the bound must trip)."""
        from ..arpc.call import Request, read_envelope
        from ..arpc.mux import DATA, INITIAL_CREDIT, _RX_CREDIT_SLACK
        conn = self.conn
        st = await conn.open_stream()
        await st.write(Request("ping", {}).encode())
        await read_envelope(st)             # response consumed, NO close
        junk = b"\xa5" * (256 << 10)
        flood = INITIAL_CREDIT + _RX_CREDIT_SLACK + (1 << 20)
        sent = 0
        while sent < flood:
            try:
                await conn._send_frame(DATA, st.sid, junk)
            except ConnectionError:
                break                       # already reset hard enough
            sent += len(junk)

    async def _attack_slow_reader(self, echo_calls: int,
                                  echo_bytes: int) -> None:
        """Stop draining the socket, keep demanding payloads."""
        from ..arpc.call import Request
        conn = self.conn
        conn.writer.transport.pause_reading()
        blob = "x" * echo_bytes
        for i in range(echo_calls):
            if conn.closed:
                break                       # shed fired — done
            try:
                st = await conn.open_stream()
                await st.write(Request("echo", {"data": blob}).encode())
            except ConnectionError:
                break
            if i % 32 == 31:
                await asyncio.sleep(0)      # let the loop breathe

    async def _attack_reconnect_storm(self, rounds: int) -> None:
        """Kill/redial racing newest-wins eviction — except meaner: the
        redial lands while the PREVIOUS connection is still open, so
        every register() must evict its predecessor deterministically
        (an abort-first storm would race the server's disconnect watch
        and sometimes test plain re-registration instead)."""
        for _ in range(rounds):
            await self._dial({HDR_LOOPBACK_CN: self.cn})
            # the eviction closes the old server-side conn; give the
            # loop one breath so closes interleave with redials the way
            # a real flapping agent's would
            await asyncio.sleep(0.01)

    async def _attack_slowloris(self, rounds: int) -> None:
        """Hold admission reservations without ever registering: a bare
        handshake hello, then transport death before the server's ok
        frame.  The runner arms ``arpc.handshake.accept`` with a delay
        so the admit→register window is deterministically open when the
        abort lands — each round strands exactly one ceiling
        reservation for the TTL sweep to reap.  The close must be an
        RST (SO_LINGER 0): a plain FIN leaves the server's ok-frame
        write succeeding into the half-closed socket, so register()
        would still run and consume the reservation."""
        for r in range(rounds):
            reader, writer = await asyncio.open_connection(self.host,
                                                           self.port)
            try:
                body = codec.encode({"headers": {
                    HDR_LOOPBACK_CN: f"{self.cn}-loris-{r}"}})
                writer.write(HANDSHAKE_MAGIC + _HS_LEN.pack(len(body))
                             + body)
                await writer.drain()
                # the server reads the hello, admits (reservation
                # appended), and parks at the armed failpoint — die
                # inside that window
                await asyncio.sleep(0.05)
            finally:
                sock = writer.transport.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                writer.transport.abort()
            await asyncio.sleep(0.05)


class FleetServer:
    """The server side of the simulation: real AgentsManager admission,
    real JobsManager fairness, real datastore sessions — reached over
    real mux connections (the production ``Server`` minus DB/TLS/web)."""

    def __init__(self, datastore_dir: str, cfg: FleetConfig, *,
                 jobs: "JobsManager | None" = None,
                 shared_instance: str = "", device="cuda"):
        self.cfg = cfg
        max_sessions = cfg.max_sessions or (2 * cfg.n_agents + 16)
        self.agents = AgentsManager(
            is_expected=None, rate=cfg.client_rate, burst=cfg.client_burst,
            max_sessions=max_sessions, open_rate=cfg.open_rate,
            admission_deadline_ms=cfg.admission_deadline_ms)
        if cfg.reservation_ttl_s > 0:
            self.agents.reservation_ttl_s = cfg.reservation_ttl_s
        # an injected JobsManager lets the multiproc worker route every
        # enqueue through its JobQueueService (the DB-shared bound)
        # while this class keeps owning the data plane
        self.jobs = jobs if jobs is not None else JobsManager(
            max_concurrent=cfg.max_concurrent, max_queued=cfg.max_queued,
            tenant_weights=(conf.parse_tenant_weights(cfg.tenant_weights)
                            if cfg.tenant_weights else None))
        self.store = LocalStore(datastore_dir,
                                ChunkerParams(avg_size=cfg.chunk_avg),
                                shared_instance=shared_instance or None,
                                delta_tier=True if cfg.delta_tier else None,
                                device=device)
        self.router = Router()

        async def ping(req, ctx):
            return {"pong": True}
        self.router.handle("ping", ping)

        async def echo(req, ctx):
            """Payload mirror — gives the hostile slow-reader profile a
            server→agent byte stream to refuse to drain (the shed needs
            OUR writes to block, and backups stream agent→server)."""
            return {"data": req.payload.get("data", "")}
        self.router.handle("echo", echo)
        self._server: Optional[asyncio.AbstractServer] = None
        self.conns: list[MuxConnection] = []
        self.port = 0

    async def start(self) -> int:
        async def on_connection(conn, peer, headers):
            self.conns.append(conn)
            sess = await self.agents.register(peer, headers, conn)
            try:
                await self.router.serve_connection(conn, context=sess)
            finally:
                await self.agents.unregister(sess)

        self._server = await serve(
            "127.0.0.1", 0, None, on_connection=on_connection,
            admit=self.agents.admit, keepalive_s=0,
            write_deadline_s=self.cfg.mux_write_deadline_s)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for sess in self.agents.sessions():
            await sess.conn.close()
        for conn in self.conns:
            if not conn.closed:
                await conn.close()
        if self._server is not None:
            await self._server.wait_closed()

    def mux_stats(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for conn in self.conns:
            for k, v in conn.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    # -- the backup data plane (run_backup_job minus the DB rows) ----------
    async def backup_once(self, cn: str, job_id: str) -> dict:
        control = self.agents.get(cn)
        if control is None:
            raise ConnectionError(f"agent {cn!r} not connected")
        control_sess = Session(control.conn)
        st = await control_sess.call("target_status", {"path": "/"})
        if not st.data.get("ok"):
            raise RuntimeError(f"target path unavailable: {st.data}")
        client_id = f"{cn}|{job_id}"
        self.agents.expect(client_id)
        try:
            await control_sess.call(
                "backup", {"job_id": job_id, "source": "/"}, timeout=120)
            loop = asyncio.get_running_loop()
            with trace.span("backup.session_open"):
                job_sess = await self.agents.wait_session(client_id,
                                                          timeout=60)
                fs = AgentFSClient(Session(job_sess.conn))
                resume_ctx = None
                if self.cfg.checkpoint_interval:
                    resume_ctx = await loop.run_in_executor(
                        None, trace.wrap(lambda: checkpoint.open_resume(
                            self.store, backup_type="host",
                            backup_id=cn)))
                session_kw = {"previous_reader": resume_ctx[0]} \
                    if resume_ctx else {}
                session = await loop.run_in_executor(
                    None, trace.wrap(lambda: self.store.start_session(
                        backup_type="host", backup_id=cn, **session_kw)))
            try:
                if resume_ctx is not None:
                    session.resume_plan = resume_ctx[1]
                if self.cfg.checkpoint_interval:
                    await loop.run_in_executor(
                        None, lambda: checkpoint.attach(
                            session, self.cfg.checkpoint_interval))
                pump = RemoteTreeBackup(fs, session)
                disc = self.agents.watch_disconnect(job_sess)
                pump_task = asyncio.ensure_future(pump.run())
                try:
                    await asyncio.wait({pump_task, disc},
                                       return_when=asyncio.FIRST_COMPLETED)
                    if not pump_task.done():
                        pump_task.cancel()
                        await asyncio.gather(pump_task,
                                             return_exceptions=True)
                        raise ConnectionError(
                            f"agent job session lost mid-backup "
                            f"({client_id})")
                    result = await pump_task
                finally:
                    self.agents.unwatch_disconnect(job_sess, disc)
                    if not disc.done():
                        disc.cancel()
                    if not pump_task.done():
                        pump_task.cancel()
                        await asyncio.gather(pump_task,
                                             return_exceptions=True)
                def _publish():
                    with trace.span("backup.publish"):
                        return session.finish({"job": job_id})
                manifest = await loop.run_in_executor(
                    None, trace.wrap(_publish))
                if self.cfg.checkpoint_interval:
                    await loop.run_in_executor(
                        None, lambda: checkpoint.clear(
                            self.store.datastore, "host", cn, ""))
                return {"ref": session.ref, "manifest": manifest,
                        "entries": result.entries,
                        "bytes": result.bytes_total,
                        "resumed": resume_ctx is not None}
            except BaseException:
                session.abort()
                raise
        finally:
            self.agents.unexpect(client_id)
            sess_info = self.agents.get(client_id)
            if sess_info is not None:
                try:
                    await sess_info.conn.close()
                except Exception as e:
                    L.debug("sim job session close: %s", e)
            if not control.conn.closed:
                try:
                    await control_sess.call("cleanup", {"job_id": job_id},
                                            timeout=15)
                except Exception as e:
                    L.debug("sim cleanup rpc failed: %s", e)


@dataclass
class FleetReport:
    cfg: FleetConfig
    published: int = 0
    failed: int = 0
    resumed: int = 0
    requeued: int = 0
    wall_s: float = 0.0
    admission: dict = field(default_factory=dict)
    connect_rejects: int = 0
    mux_server: dict = field(default_factory=dict)
    mux_agents: dict = field(default_factory=dict)
    queued_max: int = 0
    running_max: int = 0
    sessions_max: int = 0
    queue_bound: int = 0
    bound_violated: bool = False
    refs: dict = field(default_factory=dict)      # cn → SnapshotRef
    failures: dict = field(default_factory=dict)  # cn → error string
    breaker_states: dict = field(default_factory=dict)
    # per-target breaker states right after round 1 (before the resume
    # round closes them again): the chaos test's "breakers open
    # per-target only" witness
    breaker_states_round1: dict = field(default_factory=dict)
    killed: set = field(default_factory=set)       # cns that crashed
    # replication traffic driven through the same fairness lanes
    sync_completed: int = 0
    sync_failed: int = 0
    sync_chunks: int = 0
    sync_wire_bytes: int = 0
    sync_failures: dict = field(default_factory=dict)  # job_id → error
    # hostile profile observations, SERVER side (the soak's assertion
    # surface: the abuse must be seen and survived by the server, not
    # merely attempted by the agents)
    hostile_run: int = 0
    server_flow_violations: int = 0
    server_write_deadline_sheds: int = 0
    # the meaner hostiles: liar backups ride their OWN accounting
    # lane (never report.failures — the chaos requeue keys on that),
    # the reconnect storm's evictions and the slowloris strands are
    # counted by AgentsManager, the lying streams by the server mux
    hostile_liar_published: int = 0
    hostile_liar_errors: list = field(default_factory=list)
    server_stream_length_violations: int = 0
    reservations_reaped: int = 0
    evictions: int = 0
    admission_waits: int = 0
    # mixed-traffic lanes (restore read-back + verify spot-check) and
    # keepalive churn through the same jobs plane as the backups
    restore_completed: int = 0
    restore_failed: int = 0
    restore_entries: int = 0
    restore_failures: dict = field(default_factory=dict)
    verify_completed: int = 0
    verify_failed: int = 0
    verify_checked: int = 0
    verify_failures: dict = field(default_factory=dict)
    churned: int = 0
    # mount-serve read lane: concurrent Zipf random-access
    # readers through the shared sharded chunk cache; cache counters
    # come straight from ChunkCache.snapshot() at soak end
    readserve_completed: int = 0
    readserve_failed: int = 0
    readserve_reads: int = 0
    readserve_bytes: int = 0
    readserve_failures: dict = field(default_factory=dict)
    readserve_cache: dict = field(default_factory=dict)
    # per-tenant CONTENDED grant counts (JobsManager.tenant_grants) —
    # the weighted-fair proportionality witness
    tenant_grants: dict = field(default_factory=dict)
    # per-histogram snapshot taken at soak start: the report's
    # percentiles are bucket-diff quantiles of the PROCESS-SHARED
    # /metrics histograms (one quantile implementation,
    # server/metrics.py, replacing the old ad-hoc sorted-list math)
    hist_baseline: dict = field(default_factory=dict)

    def _pct(self, hist_name: str, q: float,
             labels: "dict | None" = None) -> float:
        h = metrics.HISTOGRAMS[hist_name]
        return h.quantile(q, labels=labels,
                          since=self.hist_baseline.get(hist_name))

    def to_dict(self) -> dict:
        frames = self.mux_server.get("frames_tx", 0) + \
            self.mux_server.get("frames_rx", 0)
        return {
            "n_agents": self.cfg.n_agents,
            "tenants": self.cfg.tenants,
            "published": self.published,
            "failed": self.failed,
            "resumed": self.resumed,
            "requeued": self.requeued,
            "wall_s": round(self.wall_s, 3),
            "enqueue_to_publish_p50_s": round(
                self._pct("pbs_plus_job_enqueue_to_publish_seconds",
                          0.50, {"kind": "backup"}), 4),
            "enqueue_to_publish_p99_s": round(
                self._pct("pbs_plus_job_enqueue_to_publish_seconds",
                          0.99, {"kind": "backup"}), 4),
            "session_open_p50_s": round(
                self._pct("pbs_plus_session_open_seconds",
                          0.50, {"phase": "connect"}), 5),
            "session_open_p99_s": round(
                self._pct("pbs_plus_session_open_seconds",
                          0.99, {"phase": "connect"}), 5),
            "admission": dict(self.admission),
            "admission_rejected": sum(
                v for k, v in self.admission.items() if k != "admitted"),
            "connect_rejects_seen_by_agents": self.connect_rejects,
            "mux_frames_total": frames,
            "mux_frames_per_s": round(frames / self.wall_s, 1)
            if self.wall_s else 0.0,
            "mux_bytes_tx": self.mux_server.get("bytes_tx", 0),
            "mux_bytes_rx": self.mux_server.get("bytes_rx", 0),
            "write_deadline_sheds": self.mux_server.get(
                "write_deadline_sheds", 0) + self.mux_agents.get(
                "write_deadline_sheds", 0),
            "flow_violations": self.mux_server.get("flow_violations", 0)
            + self.mux_agents.get("flow_violations", 0),
            "syn_rejects": self.mux_server.get("syn_rejects", 0)
            + self.mux_agents.get("syn_rejects", 0),
            "queue_bound": self.queue_bound,
            "queued_max": self.queued_max,
            "running_max": self.running_max,
            "sessions_max": self.sessions_max,
            "bound_violated": self.bound_violated,
            "sync_completed": self.sync_completed,
            "sync_failed": self.sync_failed,
            "sync_chunks": self.sync_chunks,
            "sync_wire_bytes": self.sync_wire_bytes,
            "hostile_run": self.hostile_run,
            "server_flow_violations": self.server_flow_violations,
            "server_write_deadline_sheds": self.server_write_deadline_sheds,
            "hostile_liar_published": self.hostile_liar_published,
            "hostile_liar_errors": len(self.hostile_liar_errors),
            "server_stream_length_violations":
                self.server_stream_length_violations,
            "reservations_reaped": self.reservations_reaped,
            "evictions": self.evictions,
            "admission_waits": self.admission_waits,
            "restore_completed": self.restore_completed,
            "restore_failed": self.restore_failed,
            "restore_entries": self.restore_entries,
            "verify_completed": self.verify_completed,
            "verify_failed": self.verify_failed,
            "verify_checked": self.verify_checked,
            "churned": self.churned,
            "readserve_completed": self.readserve_completed,
            "readserve_failed": self.readserve_failed,
            "readserve_reads": self.readserve_reads,
            "readserve_bytes": self.readserve_bytes,
            "readserve_cache": dict(self.readserve_cache),
            "tenant_grants": dict(self.tenant_grants),
        }


async def run_fleet_async(datastore_dir: str, cfg: FleetConfig, *,
                          device="cuda") -> FleetReport:
    """Connect cfg.n_agents simulated agents, run one synthetic backup
    per agent through the real jobs plane (fair dequeue, breakers,
    bounded queue), re-enqueue chaos-killed jobs once as resumable, and
    report latency/throughput/bound observations."""
    import random
    rng = random.Random(cfg.seed)
    report = FleetReport(cfg=cfg, queue_bound=cfg.max_queued)
    # snapshot the shared latency histograms so the report's percentiles
    # cover THIS soak only (bucket diff), not the process's whole life
    for _hname in ("pbs_plus_job_enqueue_to_publish_seconds",
                   "pbs_plus_session_open_seconds"):
        report.hist_baseline[_hname] = metrics.HISTOGRAMS[_hname].snapshot()
    server = FleetServer(datastore_dir, cfg, device=device)
    port = await server.start()
    doomed = set()
    if cfg.kill_fraction > 0:
        k = max(1, int(cfg.n_agents * cfg.kill_fraction))
        doomed = set(rng.sample(range(cfg.n_agents), k))
    # keepalive churn set: seeded, sampled AFTER doomed (stable across
    # runs) and from the non-doomed pool — a churned agent must be alive
    # to churn, and overlapping the two chaos modes would make the
    # churned-count assertion depend on the kill schedule
    churn_set: set[int] = set()
    if cfg.churn_fraction > 0:
        pool = [i for i in range(cfg.n_agents) if i not in doomed]
        k = max(1, int(cfg.n_agents * cfg.churn_fraction))
        churn_set = set(rng.sample(pool, min(k, len(pool))))
    restored: set[int] = set()
    verified: set[int] = set()
    readserved: set[int] = set()
    # ONE sharded scan-resistant cache for the whole readserve lane:
    # every reader job's SplitReader shares it, like hundreds of mount
    # sessions over one server-wide cache (pxar/chunkcache.py)
    readserve_cache = None
    if cfg.readserve_readers > 0:
        from ..pxar import chunkcache
        readserve_cache = chunkcache.ChunkCache(64 << 20)

    trees = {i: synthetic_tree(cfg.seed, i, cfg.files_per_agent,
                               cfg.file_size)
             for i in range(cfg.n_agents)}
    agents: dict[str, SimAgent] = {}

    def make_agent(i: int, *, chaos: bool) -> SimAgent:
        cn = f"sim-{i:04d}"
        gate = None
        if chaos and cfg.checkpoint_interval:
            # crash only once a checkpoint exists: the kill then proves
            # RESUME at scale, not just retry-from-zero
            gate = lambda: has_checkpoint(server.store, cn)  # noqa: E731
        return SimAgent(
            cn, "127.0.0.1", port, trees[i],
            die_after_reads=cfg.kill_after_reads if chaos else 0,
            crash_gate=gate,
            connect_attempts=cfg.connect_attempts,
            write_deadline_s=cfg.mux_write_deadline_s)

    t_start = time.perf_counter()

    # -- connect storm, bounded concurrency --------------------------------
    gate = asyncio.Semaphore(cfg.connect_concurrency)

    async def connect_one(i: int) -> None:
        async with gate:
            a = make_agent(i, chaos=i in doomed)
            await a.start()
            agents[a.cn] = a

    results = await asyncio.gather(
        *(connect_one(i) for i in range(cfg.n_agents)),
        return_exceptions=True)
    connect_errors = [r for r in results if isinstance(r, BaseException)]
    if connect_errors:
        raise RuntimeError(
            f"{len(connect_errors)} agents failed to connect; first: "
            f"{connect_errors[0]!r}") from connect_errors[0]

    # -- queue-depth sampler (the bound assertion's witness) ---------------
    stop_sampling = asyncio.Event()

    async def sampler() -> None:
        while not stop_sampling.is_set():
            report.queued_max = max(report.queued_max,
                                    server.jobs.queued_count)
            report.running_max = max(report.running_max,
                                     server.jobs.running_count)
            report.sessions_max = max(report.sessions_max,
                                      len(server.agents.sessions()))
            if cfg.max_queued > 0 and \
                    server.jobs.queued_count > cfg.max_queued:
                report.bound_violated = True
            try:
                await asyncio.wait_for(stop_sampling.wait(), 0.01)
            except asyncio.TimeoutError:
                pass
    sampler_task = asyncio.create_task(sampler(), name="fleet-sampler")

    # -- enqueue backups, wave-chained per agent ---------------------------
    def submit(cn: str, idx: int, job_id: str, wave: int = 0) -> None:
        tenant = f"tenant-{idx % max(1, cfg.tenants)}"
        breaker = server.jobs.breaker(
            f"agent:{cn}", failure_threshold=cfg.breaker_threshold,
            reset_timeout_s=cfg.breaker_reset_s)

        async def execute():
            res = await breaker.call(
                lambda: server.backup_once(cn, job_id))
            report.published += 1
            report.refs[cn] = res["ref"]
            if res["resumed"]:
                report.resumed += 1
            report.failures.pop(cn, None)
            # post-publish chain (mixed traffic): keepalive
            # churn, then the agent's NEXT wave — two live job sessions
            # into one snapshot group would race the publish, so waves
            # chain on success — and the restore/verify read-back lanes
            # the moment this agent has a snapshot to read
            if idx in churn_set:
                churn_set.discard(idx)
                await agents[cn].churn()
                report.churned += 1
            if wave + 1 < cfg.jobs_per_agent:
                submit(cn, idx, f"job-{idx:04d}-w{wave + 2}", wave + 1)
            if idx < cfg.restore_jobs and idx not in restored:
                restored.add(idx)
                submit_restore(cn, idx, f"restore-{idx:04d}")
            if idx < cfg.verify_jobs and idx not in verified:
                verified.add(idx)
                submit_verify(cn, idx, f"verify-{idx:04d}")
            # readserve fan-out rides the publish events: each agent's
            # FIRST publish spawns its share of the reader fleet, so
            # reads always target live snapshots and contend with the
            # ingest still in flight through the same slots
            if cfg.readserve_readers > 0 and idx not in readserved:
                readserved.add(idx)
                base_n, extra = divmod(cfg.readserve_readers,
                                       cfg.n_agents)
                for j in range(base_n + (1 if idx < extra else 0)):
                    submit_readserve(idx * 4096 + j,
                                     f"readserve-{idx:04d}-{j:03d}")

        async def on_error(exc: BaseException):
            report.failed += 1
            report.failures[cn] = f"{type(exc).__name__}: {exc}"

        server.jobs.enqueue(Job(id=f"backup:{cn}:{job_id}", kind="backup",
                                tenant=tenant, execute=execute,
                                on_error=on_error))

    # -- mixed-traffic lanes: restore read-back + verify spot-check --------
    # (both run through the SAME jobs plane and fairness lanes as the
    # backups — docs/fleet.md "Mixed traffic"; each compares the real
    # datastore against the agent's synthetic tree, so a lost or torn
    # chunk under churn/failover is a hard failure, not a silent miss)
    def submit_restore(cn: str, idx: int, job_id: str) -> None:
        async def execute():
            from ..pxar.transfer import SplitReader
            ref = report.refs[cn]
            tree = trees[idx]

            def _read_back() -> int:
                reader = SplitReader.open_snapshot(
                    server.store.datastore, ref)
                n = 0
                for entry in reader.entries():
                    if not entry.is_file:
                        continue
                    rel = entry.path.lstrip("/")
                    want = tree.get(rel)
                    if want is None:
                        raise RuntimeError(
                            f"restored unknown entry {entry.path!r}")
                    got = reader.read_file(entry)
                    if got != want:
                        raise RuntimeError(
                            f"restore mismatch at {rel!r}: "
                            f"{len(got)} != {len(want)} bytes")
                    n += 1
                if n != len(tree):
                    raise RuntimeError(f"restore saw {n}/{len(tree)} files")
                return n

            n = await asyncio.get_running_loop().run_in_executor(
                None, trace.wrap(_read_back))
            report.restore_completed += 1
            report.restore_entries += n
            report.restore_failures.pop(job_id, None)

        async def on_error(exc: BaseException):
            report.restore_failed += 1
            report.restore_failures[job_id] = f"{type(exc).__name__}: {exc}"

        server.jobs.enqueue(Job(id=f"restore:{job_id}", kind="restore",
                                tenant="restore", execute=execute,
                                on_error=on_error))

    def submit_verify(cn: str, idx: int, job_id: str) -> None:
        async def execute():
            import numpy as np

            from ..models.verify import VerifyPipeline
            from ..pxar.transfer import SplitReader
            ref = report.refs[cn]

            def _spot_check():
                reader = SplitReader.open_snapshot(
                    server.store.datastore, ref)
                return VerifyPipeline(
                    device=server.store.device).verify_snapshot(
                    reader, sample_rate=1.0,
                    rng=np.random.default_rng(cfg.seed + idx))

            res = await asyncio.get_running_loop().run_in_executor(
                None, trace.wrap(_spot_check))
            if not res.ok:
                raise RuntimeError(
                    f"verify found corruption: {res.corrupt_paths}")
            report.verify_completed += 1
            report.verify_checked += res.checked
            report.verify_failures.pop(job_id, None)

        async def on_error(exc: BaseException):
            report.verify_failed += 1
            report.verify_failures[job_id] = f"{type(exc).__name__}: {exc}"

        server.jobs.enqueue(Job(id=f"verify:{job_id}", kind="verify",
                                tenant="verify", execute=execute,
                                on_error=on_error))

    # -- mount-serve read lane: Zipf random-access readers -----------------
    # (hundreds of concurrent readers over ONE sharded scan-resistant
    # chunk cache, through file_reader's clamped-range pump — the read
    # half of the mixed workload, in its own "readserve" fairness lane;
    # every byte is verified against the agent's synthetic tree, so a
    # stale cache segment or a torn delta-chain read is a hard failure)
    def submit_readserve(rid: int, job_id: str) -> None:
        async def execute():
            from ..pxar.transfer import SplitReader
            rrng = random.Random(cfg.seed * 1_000_003 + rid)
            # rank over the snapshots published SO FAR, hottest first —
            # later readers see (and spread over) a larger set
            cns = sorted(report.refs)
            if not cns:
                raise RuntimeError("readserve scheduled before any publish")

            def _serve() -> tuple[int, int]:
                readers: dict[str, tuple] = {}
                n_reads = n_bytes = 0
                for _ in range(cfg.readserve_reads):
                    cn = cns[zipf_rank(rrng, len(cns),
                                       cfg.readserve_zipf)]
                    cached = readers.get(cn)
                    if cached is None:
                        reader = SplitReader.open_snapshot(
                            server.store.datastore, report.refs[cn],
                            cache=readserve_cache)
                        files = [e for e in reader.entries()
                                 if e.is_file and e.size > 0]
                        if not files:
                            raise RuntimeError(
                                f"readserve: {cn} has no files")
                        cached = (reader, files)
                        readers[cn] = cached
                    reader, files = cached
                    entry = files[rrng.randrange(len(files))]
                    off = rrng.randrange(entry.size)
                    size = rrng.randint(1, entry.size - off)
                    fobj, n = reader.file_reader(entry, off, size)
                    got = bytearray()
                    while True:
                        piece = fobj.read(4096)   # window-sized pump
                        if not piece:
                            break
                        got += piece
                    want = trees[int(cn.split("-")[1])][
                        entry.path.lstrip("/")][off:off + size]
                    if bytes(got) != want:
                        raise RuntimeError(
                            f"readserve mismatch {cn}:{entry.path!r}"
                            f"[{off}:{off + size}] "
                            f"({len(got)} vs {len(want)} bytes)")
                    n_reads += 1
                    n_bytes += n
                return n_reads, n_bytes

            n_reads, n_bytes = await asyncio.get_running_loop() \
                .run_in_executor(None, trace.wrap(_serve))
            report.readserve_completed += 1
            report.readserve_reads += n_reads
            report.readserve_bytes += n_bytes
            report.readserve_failures.pop(job_id, None)

        async def on_error(exc: BaseException):
            report.readserve_failed += 1
            report.readserve_failures[job_id] = \
                f"{type(exc).__name__}: {exc}"

        server.jobs.enqueue(Job(id=f"readserve:{job_id}", kind="read",
                                tenant="readserve", execute=execute,
                                on_error=on_error))

    # -- length-liar lane: hostile backups on their OWN accounting ---------
    # (the server must refuse the short stream with the typed
    # StreamLengthError and publish nothing; never report.failures —
    # the chaos requeue keys on that dict)
    def submit_liar(ha: HostileAgent, job_id: str) -> None:
        async def execute():
            try:
                await server.backup_once(ha.cn, job_id)
            except Exception as e:
                report.hostile_liar_errors.append(
                    f"{type(e).__name__}: {e}")
                return
            report.hostile_liar_published += 1

        server.jobs.enqueue(Job(id=f"liar:{job_id}", kind="backup",
                                tenant="hostile", execute=execute))

    # -- concurrent replication traffic (the fleet tie-in) ------------------
    mirror_dir = cfg.sync_mirror_dir or f"{datastore_dir}-mirror"
    mirror_ds = None

    def submit_sync(job_id: str) -> None:
        from ..pxar.syncwire import (LocalSyncDest, LocalSyncSource,
                                     run_sync)

        async def execute():
            res = await asyncio.get_running_loop().run_in_executor(
                None, trace.wrap(lambda: run_sync(
                    LocalSyncSource(server.store.datastore),
                    LocalSyncDest(mirror_ds),
                    job_id=job_id, state_root=mirror_dir)))
            report.sync_completed += 1
            report.sync_chunks += res["chunks_transferred"]
            report.sync_wire_bytes += res["bytes_wire"]
            report.sync_failures.pop(job_id, None)

        async def on_error(exc: BaseException):
            report.sync_failed += 1
            report.sync_failures[job_id] = f"{type(exc).__name__}: {exc}"

        # ONE shared "sync" fairness lane for every replication job —
        # the verification crowding rule (docs/fleet.md "Fairness"): a
        # sync backlog competes as a single tenant and can never starve
        # backup tenants out of slot grants
        server.jobs.enqueue(Job(id=f"sync:{job_id}", kind="sync",
                                tenant="sync", execute=execute,
                                on_error=on_error))

    if cfg.sync_jobs > 0:
        from ..pxar.datastore import Datastore
        mirror_ds = Datastore(mirror_dir, device=server.store.device)

    for i in range(cfg.n_agents):
        submit(f"sim-{i:04d}", i, f"job-{i:04d}-r1")
    # interleave the replication backlog with the backup storm so both
    # kinds of traffic contend for the same execution slots
    for i in range(cfg.sync_jobs):
        submit_sync(f"fleet-sync-{i:02d}")
    # hostile agents attack CONCURRENTLY with the backup round: the
    # server must count + survive the abuse while the legit fleet
    # publishes (with the reconnect-storm, length-liar and slowloris
    # profiles — docs/fleet.md "Hostile clients").  Profiles
    # round-robin over cfg.hostile_profiles; "" keeps the classic
    # flood+slow-reader pair.
    profiles = [p.strip() for p in cfg.hostile_profiles.split(",")
                if p.strip()]
    assigned = [profiles[h % len(profiles)] if profiles else ""
                for h in range(cfg.hostile_agents)]
    hostile_tasks: list[asyncio.Task] = []
    hostiles: list[HostileAgent] = []
    loris_fp = None
    if "slowloris" in assigned:
        # hold the admit→register window open so every slowloris abort
        # deterministically lands between the ceiling reservation and
        # the ok frame (docs/fault-injection.md `arpc.handshake.accept`)
        loris_fp = failpoints.armed("arpc.handshake.accept", "delay",
                                    arg=0.2)
        loris_fp.__enter__()
    try:
        for h, profile in enumerate(assigned):
            ha = HostileAgent(f"hostile-{h:03d}", "127.0.0.1", port,
                              {"f.bin": b"\0" * 64},
                              connect_attempts=cfg.connect_attempts,
                              write_deadline_s=0.0,  # never shed OUR writes
                              profile=profile,
                              lie_bytes=(cfg.hostile_lie_bytes
                                         if profile == "length_liar"
                                         else 0))
            await ha.start()
            hostiles.append(ha)
            if profile == "length_liar":
                submit_liar(ha, f"liar-{h:03d}")
            hostile_tasks.append(asyncio.create_task(
                ha.run_attacks(echo_calls=cfg.hostile_echo_calls,
                               echo_bytes=cfg.hostile_echo_bytes,
                               reconnects=cfg.hostile_reconnects,
                               slowloris_rounds=cfg.hostile_slowloris_rounds),
                name=f"hostile:{ha.cn}"))
        if hostile_tasks:
            await asyncio.wait_for(asyncio.gather(*hostile_tasks),
                                   cfg.job_timeout_s)
            report.hostile_run = len(hostiles)
    finally:
        if loris_fp is not None:
            loris_fp.__exit__(None, None, None)
    if hostile_tasks:
        # the shed fires up to one write deadline AFTER the refused
        # responses were queued — wait it out (bounded), then read the
        # server-side counters the soak asserts on.  Expectations are
        # profile-aware: only flooding hostiles force flow violations,
        # only slow readers force a shed.
        exp_flood = sum(1 for p in assigned if p in ("", "flood"))
        exp_shed = 1 if any(p in ("", "slow_reader") for p in assigned) \
            else 0
        deadline = time.perf_counter() + \
            max(2.0, 3.0 * cfg.mux_write_deadline_s)
        while time.perf_counter() < deadline:
            srv_stats = server.mux_stats()
            if srv_stats.get("write_deadline_sheds", 0) >= exp_shed and \
                    srv_stats.get("flow_violations", 0) >= exp_flood:
                break
            await asyncio.sleep(0.05)
        srv_stats = server.mux_stats()
        report.server_flow_violations = srv_stats.get("flow_violations", 0)
        report.server_write_deadline_sheds = srv_stats.get(
            "write_deadline_sheds", 0)
    # drain AFTER the hostile gather: liar backups need the liar's live
    # control session, and the wave chain keeps enqueueing until every
    # agent's last wave (plus restore/verify read-backs) published
    await server.jobs.drain(timeout=cfg.job_timeout_s)
    if "slowloris" in assigned:
        # every stranded reservation must be REAPED (the ceiling slot
        # freed by the TTL sweep), not merely expired — wait it out,
        # bounded by a few sweep periods
        n_strands = cfg.hostile_slowloris_rounds * \
            sum(1 for p in assigned if p == "slowloris")
        deadline = time.perf_counter() + \
            3.0 * max(0.5, server.agents.reservation_ttl_s) + 5.0
        while time.perf_counter() < deadline and \
                server.agents.reservations_reaped < n_strands:
            await asyncio.sleep(0.05)
    for ha in hostiles:
        await ha.stop()
    report.breaker_states_round1 = {
        k: cb.state for k, cb in server.jobs._breakers.items()}
    report.killed = {a.cn for a in agents.values() if a.dead}

    # -- chaos round 2: killed agents restart, jobs re-enqueue resumable ---
    if report.failures:
        # let per-target breakers reach half-open so the re-enqueued job
        # is the single admitted probe (utils/resilience.py discipline)
        await asyncio.sleep(cfg.breaker_reset_s * 1.5)
        for cn in sorted(report.failures):
            i = int(cn.split("-")[1])
            old = agents.get(cn)
            if old is not None and old.dead:
                a = make_agent(i, chaos=False)     # restarted process
                await a.start()
                agents[cn] = a
            report.requeued += 1
            submit(cn, i, f"job-{i:04d}-r2")
        await server.jobs.drain(timeout=cfg.job_timeout_s)

    if cfg.sync_jobs > 0:
        # catch-up pass once every backup published: the mirror ends the
        # soak holding every snapshot (concurrent passes only mirrored
        # what was published when their listing ran)
        submit_sync("fleet-sync-final")
        await server.jobs.drain(timeout=cfg.job_timeout_s)

    report.wall_s = time.perf_counter() - t_start
    stop_sampling.set()
    await sampler_task

    if readserve_cache is not None:
        readserve_cache.drain()
        report.readserve_cache = readserve_cache.snapshot()
    report.connect_rejects = sum(a.connect_rejects
                                 for a in agents.values())
    report.admission = server.agents.admission_stats()
    report.reservations_reaped = server.agents.reservations_reaped
    report.evictions = server.agents.evictions
    report.admission_waits = server.agents.admission_waits
    report.tenant_grants = dict(server.jobs.tenant_grants)
    report.mux_server = server.mux_stats()
    report.server_stream_length_violations = report.mux_server.get(
        "stream_length_violations", 0)
    for a in agents.values():
        for k, v in a.mux_stats().items():
            report.mux_agents[k] = report.mux_agents.get(k, 0) + v
    report.breaker_states = {k: cb.state
                             for k, cb in server.jobs._breakers.items()}

    for a in agents.values():
        await a.stop()
    await server.stop()
    return report


def run_fleet(datastore_dir: str, cfg: FleetConfig, *,
              device="cuda") -> FleetReport:
    """Sync wrapper: one fresh event loop per soak."""
    return asyncio.run(run_fleet_async(datastore_dir, cfg, device=device))


# -- two-process shared-datastore soak ------------------------------------

@dataclass
class MultiProcConfig:
    """Knobs for ``run_multiproc_fleet``: two REAL server subprocesses
    (server/fleetproc.py) over ONE datastore directory and ONE SQLite
    database, agents dialing each over loopback aRPC from this
    process."""
    n_agents: int = 8                  # per server process
    shared_fraction: float = 0.5       # agents whose tree BYTES repeat
    #                                    across processes (the cross-
    #                                    process written-once probe)
    files_per_agent: int = 2
    file_size: int = 8 << 10
    chunk_avg: int = 4 << 10
    processes: int = 2
    max_concurrent: int = 4
    max_queued: int = 512              # the SHARED bound (db-wide)
    gc_ttl_s: float = 2.0
    gc_grace_s: float = 0.0
    kill_leader: bool = True           # SIGKILL the sweeping leader
    kill_slow_sweep_s: float = 6.0     # sweep stall while it dies
    seed: int = 2026
    job_timeout_s: float = 180.0
    spawn_timeout_s: float = 120.0
    # -- the combined soak (all default-off: the base two-process
    #    choreography is unchanged unless a knob below is set) ------------
    jobs_per_agent: int = 1            # backup waves per agent
    restore_jobs: int = 0              # read-back restores via worker 0
    verify_jobs: int = 0               # verify spot-checks via worker 1
    sync_jobs: int = 0                 # replication jobs via worker 0
    hostile_agents: int = 0            # hostile tasks vs worker 0
    hostile_profiles: str = ""         # round-robin profile list
    hostile_lie_bytes: int = 512
    hostile_reconnects: int = 4
    hostile_slowloris_rounds: int = 2
    tenant_weights: str = ""           # operator override, both workers
    admission_deadline_ms: float = 0.0
    reservation_ttl_s: float = 0.0
    fair_probe: bool = False           # deterministic DRR witness
    deadline_probe: bool = False       # filler-dial typed-reject probe


@dataclass
class MultiProcReport:
    cfg: MultiProcConfig
    published: int = 0
    failed: int = 0
    failures: dict = field(default_factory=dict)
    wall_s: float = 0.0
    # written-once accounting summed across the fleet's /metrics
    chunks_written_total: int = 0
    cross_process_hits: int = 0
    index_hits_total: int = 0
    distinct_chunks_after: int = 0
    chunks_removed_total: int = 0
    written_once: bool = False
    # exactly-once GC per cycle under the lease
    gc_cycles: int = 0
    gc_swept: int = 0
    gc_held: int = 0
    gc_outcomes: list = field(default_factory=list)   # per-cycle detail
    lease_counters: dict = field(default_factory=dict)   # proc → dict
    # leader-kill failover
    leader_killed: str = ""
    failover_s: float = 0.0
    failover_outcome: str = ""
    steals_total: int = 0
    doomed_resurrected: int = 0
    doomed_on_disk: int = 0
    live_missing: int = 0
    # per-service lock-wait histogram quantiles per process (the trace
    # ladder: where the old one-big-_prune_lock convoy would show)
    service_lock_wait: dict = field(default_factory=dict)
    queue_counts: dict = field(default_factory=dict)
    admission: dict = field(default_factory=dict)
    # combined-soak observations
    restore_completed: int = 0
    restore_failed: int = 0
    verify_completed: int = 0
    verify_failed: int = 0
    sync_completed: int = 0
    sync_failed: int = 0
    hostile_run: int = 0
    hostile_liar_published: int = 0
    hostile_liar_errors: list = field(default_factory=list)
    stream_length_violations: int = 0
    reservations_reaped: int = 0
    evictions: int = 0
    admission_waits: int = 0
    tenant_grants: dict = field(default_factory=dict)   # proc → dict
    enqueue_p99: dict = field(default_factory=dict)     # proc → seconds
    fair_order: list = field(default_factory=list)      # fair_probe grants
    deadline_rejects_seen: int = 0      # typed 503s the probe dials saw
    deadline_rejects_counted: int = 0   # shared-DB admission counter
    launches: dict = field(default_factory=dict)        # proc → K1/K2/K3

    def to_dict(self) -> dict:
        return {
            "processes": self.cfg.processes,
            "n_agents_per_proc": self.cfg.n_agents,
            "published": self.published,
            "failed": self.failed,
            "wall_s": round(self.wall_s, 3),
            "chunks_written_total": self.chunks_written_total,
            "cross_process_hits": self.cross_process_hits,
            "index_hits_total": self.index_hits_total,
            "distinct_chunks_after": self.distinct_chunks_after,
            "chunks_removed_total": self.chunks_removed_total,
            "written_once": self.written_once,
            "gc_cycles": self.gc_cycles,
            "gc_swept": self.gc_swept,
            "gc_held": self.gc_held,
            "gc_outcomes": list(self.gc_outcomes),
            "lease_counters": dict(self.lease_counters),
            "leader_killed": self.leader_killed,
            "failover_s": round(self.failover_s, 3),
            "failover_outcome": self.failover_outcome,
            "failover_ttl_s": self.cfg.gc_ttl_s,
            "steals_total": self.steals_total,
            "doomed_resurrected": self.doomed_resurrected,
            "doomed_on_disk": self.doomed_on_disk,
            "live_missing": self.live_missing,
            "service_lock_wait": dict(self.service_lock_wait),
            "queue_counts": dict(self.queue_counts),
            "admission": dict(self.admission),
            "restore_completed": self.restore_completed,
            "restore_failed": self.restore_failed,
            "verify_completed": self.verify_completed,
            "verify_failed": self.verify_failed,
            "sync_completed": self.sync_completed,
            "sync_failed": self.sync_failed,
            "hostile_run": self.hostile_run,
            "hostile_liar_published": self.hostile_liar_published,
            "hostile_liar_errors": len(self.hostile_liar_errors),
            "stream_length_violations": self.stream_length_violations,
            "reservations_reaped": self.reservations_reaped,
            "evictions": self.evictions,
            "admission_waits": self.admission_waits,
            "tenant_grants": dict(self.tenant_grants),
            "enqueue_p99": dict(self.enqueue_p99),
            "fair_order_len": len(self.fair_order),
            "deadline_rejects_seen": self.deadline_rejects_seen,
            "deadline_rejects_counted": self.deadline_rejects_counted,
            "launches": dict(self.launches),
        }


class _WorkerProc:
    """One fleetproc subprocess + its JSON event stream."""

    def __init__(self, name: str):
        self.name = name
        self.proc: "asyncio.subprocess.Process | None" = None
        self.port = 0
        self.pid = 0
        # runner-paced: a worker only ever emits in response to runner
        # commands (one event per command, one `done` per submitted
        # job), so depth is bounded by the runner's own outstanding
        # work — an explicit maxsize would just deadlock the pump
        # against a slow assertion.
        self._events: asyncio.Queue = \
            asyncio.Queue()   # pbslint: disable=bounded-queue-discipline
        self._pump: "asyncio.Task | None" = None

    async def spawn(self, argv: list[str], timeout: float) -> None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "pbs_plus_tpu_torch.server.fleetproc", *argv,
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            env=env)
        self._pump = asyncio.create_task(self._pump_events(),
                                         name=f"fleetproc-pump:{self.name}")
        ready = await self.expect("ready", timeout=timeout)
        self.port, self.pid = ready["port"], ready["pid"]

    async def _pump_events(self) -> None:
        assert self.proc is not None and self.proc.stdout is not None
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                self._events.put_nowait(None)       # EOF sentinel
                return
            try:
                self._events.put_nowait(json.loads(line))
            except ValueError:
                L.warning("fleetproc %s: bad event line %r",
                          self.name, line[:200])

    def send(self, msg: dict) -> None:
        assert self.proc is not None and self.proc.stdin is not None
        self.proc.stdin.write((json.dumps(msg) + "\n").encode())

    async def expect(self, event: str, timeout: float = 60.0) -> dict:
        """Next event of the given type.  Non-matching events are
        DROPPED, not re-buffered — the runner's command choreography
        must consume every command's reply in order (sending a second
        command before reading the first's event loses the reply)."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise asyncio.TimeoutError(
                    f"fleetproc {self.name}: no {event!r} within "
                    f"{timeout}s")
            msg = await asyncio.wait_for(self._events.get(), left)
            if msg is None:
                # keep the EOF sentinel visible: later expects must
                # fail fast too, not hang out their whole timeout
                self._events.put_nowait(None)
                raise ConnectionError(
                    f"fleetproc {self.name} exited while waiting for "
                    f"{event!r}")
            if msg.get("event") == event:
                return msg

    def kill(self) -> None:
        assert self.proc is not None
        self.proc.kill()                            # SIGKILL, no cleanup

    async def shutdown(self, timeout: float = 30.0) -> None:
        if self.proc is None:
            return
        if self.proc.returncode is None:
            try:
                self.send({"cmd": "exit"})
                await self.expect("bye", timeout=timeout)
            except (ConnectionError, asyncio.TimeoutError, OSError):
                try:
                    self.proc.kill()
                except ProcessLookupError:
                    pass        # died between the check and the kill
        await self.proc.wait()
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except asyncio.CancelledError:
                pass


def _multiproc_trees(cfg: MultiProcConfig) -> "dict[str, dict]":
    """cn → tree for every agent of every process.  The first
    ``shared_fraction`` of each process's agents share tree BYTES with
    their cross-process twin (same (seed, idx) → same chunks from two
    different processes — the written-once probe); the rest are unique
    per process."""
    trees: dict[str, dict] = {}
    n_shared = int(cfg.n_agents * cfg.shared_fraction)
    for w in range(cfg.processes):
        for i in range(cfg.n_agents):
            cn = f"p{w}-a{i:03d}"
            idx = i if i < n_shared else 1000 + w * cfg.n_agents + i
            trees[cn] = synthetic_tree(cfg.seed, idx,
                                       cfg.files_per_agent, cfg.file_size)
    return trees


async def run_multiproc_fleet_async(root_dir: str,
                                    cfg: MultiProcConfig, *,
                                    device="cuda") -> MultiProcReport:
    """The two-process shared-datastore soak:

    1. spawn ``cfg.processes`` fleetproc workers over one datastore +
       one DB; dial agents at each from this process (loopback aRPC);
    2. run one backup per agent through BOTH processes' job planes —
       every job must publish through the ONE shared bounded queue;
    3. written-once: Σ chunks_written across the fleet's /metrics must
       equal the distinct chunk files ever created (cross-process
       collisions resolve via the os.link claim, counted as
       cross_process_hits — asserted > 0, the collision really raced);
    4. GC cycles: both processes sweep on the same tick — exactly one
       wins the lease per cycle (swept + held == processes);
    5. leader-kill failover: SIGKILL the sweeping leader mid-sweep (a
       delay failpoint holds the sweep open); the survivor's next cycle
       STEALS the expired lease within one TTL and completes the sweep
       — zero double-unlinks, zero resurrected digests, zero lost live
       chunks (disk + index re-checked)."""
    from ..pxar.datastore import Datastore
    device = resolve(device)
    report = MultiProcReport(cfg=cfg)
    t_start = time.perf_counter()
    datastore_dir = os.path.join(root_dir, "ds")
    state_dir = os.path.join(root_dir, "state")
    os.makedirs(datastore_dir, exist_ok=True)
    os.makedirs(state_dir, exist_ok=True)

    workers = [_WorkerProc(f"p{w}") for w in range(cfg.processes)]
    agents: dict[str, SimAgent] = {}
    try:
        await asyncio.gather(*(
            w.spawn(["--state-dir", state_dir,
                     "--datastore", datastore_dir,
                     "--proc-id", w.name,
                     "--gc-ttl", str(cfg.gc_ttl_s),
                     "--chunk-avg", str(cfg.chunk_avg),
                     "--max-agents", str(2 * cfg.n_agents + 8),
                     "--max-concurrent", str(cfg.max_concurrent),
                     "--max-queued", str(cfg.max_queued),
                     "--device", str(device)]
                    + (["--tenant-weights", cfg.tenant_weights]
                       if cfg.tenant_weights else [])
                    + (["--admission-deadline-ms",
                        str(cfg.admission_deadline_ms)]
                       if cfg.admission_deadline_ms else [])
                    + (["--reservation-ttl", str(cfg.reservation_ttl_s)]
                       if cfg.reservation_ttl_s else []),
                    cfg.spawn_timeout_s)
            for w in workers))

        trees = _multiproc_trees(cfg)
        for w_i, w in enumerate(workers):
            for i in range(cfg.n_agents):
                cn = f"p{w_i}-a{i:03d}"
                a = SimAgent(cn, "127.0.0.1", w.port, trees[cn])
                await a.start()
                agents[cn] = a

        # -- one backup per agent through both job planes ------------------
        pending: dict[str, int] = {}
        for w_i, w in enumerate(workers):
            for i in range(cfg.n_agents):
                cn = f"p{w_i}-a{i:03d}"
                w.send({"cmd": "backup", "cn": cn, "job_id": f"job-{cn}",
                        "tenant": f"tenant-{i % 4}"})
                pending[f"job-{cn}"] = w_i
        for w_i, w in enumerate(workers):
            mine = sum(1 for v in pending.values() if v == w_i)
            for _ in range(mine):
                done = await w.expect("done", timeout=cfg.job_timeout_s)
                if done["ok"]:
                    report.published += 1
                else:
                    report.failed += 1
                    report.failures[done["job_id"]] = done.get("error", "")

        # -- the combined soak: later waves + RESTORE/VERIFY/SYNC ---------
        # interleaved with hostiles from every profile, all through the
        # same two job planes.  Every lane answers with a `done` event,
        # so one tally loop consumes the whole batch per worker (the
        # expect() drop semantics demand nothing else is in flight).
        import hashlib

        def _tree_hash(tree: dict) -> str:
            h = hashlib.sha256()
            for rel, data in sorted(tree.items()):
                h.update(rel.encode() + b"\0" + data + b"\0")
            return h.hexdigest()

        mirror_dir = os.path.join(root_dir, "mirror")
        profiles = [p.strip() for p in cfg.hostile_profiles.split(",")
                    if p.strip()]
        assigned = [profiles[h % len(profiles)] if profiles else ""
                    for h in range(cfg.hostile_agents)]
        hostiles: "list[HostileAgent]" = []
        hostile_tasks: "list[asyncio.Task]" = []
        extra_pending: dict[str, int] = {}      # job_id → worker idx
        expect_hash: dict[str, str] = {}        # restore job → tree hash
        sync_chunks_written = 0                 # mirror chunk creations
        if "slowloris" in assigned:
            # arm the admit→register window INSIDE worker 0 (the
            # failpoint must fire in the process that serves the dials)
            workers[0].send({"cmd": "failpoint",
                             "site": "arpc.handshake.accept",
                             "action": "delay", "arg": 0.2})
            await workers[0].expect("failpoint", timeout=30)
        for h, profile in enumerate(assigned):
            ha = HostileAgent(f"hostile-{h:03d}", "127.0.0.1",
                              workers[0].port, {"f.bin": b"\0" * 256},
                              write_deadline_s=0.0, profile=profile,
                              lie_bytes=(cfg.hostile_lie_bytes
                                         if profile == "length_liar"
                                         else 0))
            await ha.start()
            agents[ha.cn] = ha
            hostiles.append(ha)
            if profile == "length_liar":
                jid = f"liar-{h:03d}"
                workers[0].send({"cmd": "backup", "cn": ha.cn,
                                 "job_id": jid, "tenant": "hostile"})
                extra_pending[jid] = 0
            hostile_tasks.append(asyncio.create_task(
                ha.run_attacks(
                    echo_calls=12, echo_bytes=1 << 20,
                    reconnects=cfg.hostile_reconnects,
                    slowloris_rounds=cfg.hostile_slowloris_rounds),
                name=f"hostile:{ha.cn}"))
        # waves 2..N: one extra backup per agent per wave — waves after
        # the next are held back so a cn never runs two backups at once
        for wave in range(2, cfg.jobs_per_agent + 1):
            final_wave = wave == cfg.jobs_per_agent
            for w_i, w in enumerate(workers):
                for i in range(cfg.n_agents):
                    cn = f"p{w_i}-a{i:03d}"
                    jid = f"job-{cn}-w{wave}"
                    w.send({"cmd": "backup", "cn": cn, "job_id": jid,
                            "tenant": f"tenant-{i % 4}",
                            "weight": 3 if i % 4 == 0 else 1})
                    extra_pending[jid] = w_i
            if not final_wave:          # barrier between same-cn waves
                for w_i, w in enumerate(workers):
                    mine = sum(1 for v in extra_pending.values()
                               if v == w_i)
                    for _ in range(mine):
                        done = await w.expect("done",
                                              timeout=cfg.job_timeout_s)
                        if done["ok"]:
                            report.published += 1
                        else:
                            report.failed += 1
                            report.failures[done["job_id"]] = \
                                done.get("error", "")
                extra_pending.clear()
        # mixed read traffic rides CONCURRENTLY with the final wave
        for i in range(min(cfg.restore_jobs, cfg.n_agents)):
            cn, jid = f"p0-a{i:03d}", f"restore-{i:03d}"
            workers[0].send({"cmd": "restore", "cn": cn, "job_id": jid})
            extra_pending[jid] = 0
            expect_hash[jid] = _tree_hash(trees[cn])
        v_w = 1 % cfg.processes
        for i in range(min(cfg.verify_jobs, cfg.n_agents)):
            cn, jid = f"p{v_w}-a{i:03d}", f"verify-{i:03d}"
            workers[v_w].send({"cmd": "verify", "cn": cn, "job_id": jid,
                               "seed": cfg.seed + i})
            extra_pending[jid] = v_w
        # one mirror dir PER sync job: concurrent syncs into one mirror
        # would race tmp+rename on the same chunk files, double-counting
        # the per-process chunks_written metric and breaking the
        # written-once identity below — per-job mirrors keep every
        # mirror write attributable to exactly one sync's chunk count
        for s in range(cfg.sync_jobs):
            jid = f"sync-{s:02d}"
            workers[0].send({"cmd": "sync", "job_id": jid,
                             "mirror_dir": os.path.join(mirror_dir, jid)})
            extra_pending[jid] = 0
        for w_i, w in enumerate(workers):
            mine = sum(1 for v in extra_pending.values() if v == w_i)
            for _ in range(mine):
                done = await w.expect("done", timeout=cfg.job_timeout_s)
                jid, ok = done["job_id"], done["ok"]
                if jid.startswith("restore-"):
                    if ok and done.get("tree_hash") == expect_hash[jid]:
                        report.restore_completed += 1
                    else:
                        report.restore_failed += 1
                        report.failures[jid] = done.get(
                            "error", "restored tree hash mismatch")
                elif jid.startswith("verify-"):
                    if ok:
                        report.verify_completed += 1
                    else:
                        report.verify_failed += 1
                        report.failures[jid] = done.get("error", "")
                elif jid.startswith("sync-"):
                    if ok:
                        report.sync_completed += 1
                        sync_chunks_written += done.get("chunks", 0)
                    else:
                        report.sync_failed += 1
                        report.failures[jid] = done.get("error", "")
                elif jid.startswith("liar-"):
                    if ok:
                        report.hostile_liar_published += 1
                    else:
                        report.hostile_liar_errors.append(
                            done.get("error", ""))
                elif ok:
                    report.published += 1
                else:
                    report.failed += 1
                    report.failures[jid] = done.get("error", "")
        if hostiles:
            await asyncio.wait_for(asyncio.gather(*hostile_tasks), 120)
            report.hostile_run = len(hostiles)
            if "slowloris" in assigned:
                workers[0].send({"cmd": "failpoint",
                                 "site": "arpc.handshake.accept",
                                 "disarm": True})
                await workers[0].expect("failpoint", timeout=30)
                # every stranded reservation must be REAPED (ceiling
                # slot freed by worker 0's TTL sweep) before we move on
                n_strands = cfg.hostile_slowloris_rounds * sum(
                    1 for p in assigned if p == "slowloris")
                ttl = cfg.reservation_ttl_s if cfg.reservation_ttl_s > 0 \
                    else 20.0
                deadline = time.monotonic() + 3 * ttl + 5
                while time.monotonic() < deadline:
                    workers[0].send({"cmd": "metrics"})
                    m = await workers[0].expect("metrics", timeout=30)
                    if m["admission_extra"]["reservations_reaped"] >= \
                            n_strands:
                        break
                    await asyncio.sleep(0.2)
            for ha in hostiles:
                await ha.stop()
                agents.pop(ha.cn, None)
        # weighted-fair witness: deterministic contended-grant order
        # measured inside a worker (plug → backlog → release)
        if cfg.fair_probe:
            fp_w = workers[1 % cfg.processes]
            fp_w.send({"cmd": "fair_probe",
                       "tenants": {"fp-heavy": 3, "fp-mid": 2,
                                   "fp-light": 1},
                       "jobs_per_tenant": 12})
            fp = await fp_w.expect("fair_probe", timeout=120)
            report.fair_order = list(fp["order"])

        # -- GC cycle with both processes racing the lease -----------------
        def gc_all():
            for w in workers:
                w.send({"cmd": "gc", "grace": cfg.gc_grace_s})

        async def gc_results() -> list[dict]:
            out = []
            for w in workers:
                await w.expect("gc_running", timeout=30)
                res = await w.expect("gc_result", timeout=60)
                report.gc_outcomes.append(
                    {"proc": w.name, "outcome": res["outcome"],
                     "detail": res.get("detail", "")})
                out.append(res)
            return out

        ds_view = Datastore(datastore_dir, dedup_index_mb=0, device=device)

        def digests_of(refs) -> set:
            out = set()
            for ref in refs:
                for idx in ds_view.load_indexes(ref):
                    for k in range(len(idx.ends)):
                        out.add(idx.digests[k].tobytes())
            return out

        def split_live(doom_ids: set) -> tuple[set, set]:
            """(doomed-unique digests, live digests) for dropping the
            given backup_ids' snapshot groups."""
            all_refs = list(ds_view.list_snapshots(all_namespaces=True))
            doomed_refs = [r for r in all_refs if r.backup_id in doom_ids]
            live_refs = [r for r in all_refs if r.backup_id not in doom_ids]
            live = digests_of(live_refs)
            return digests_of(doomed_refs) - live, live

        # cycle 1: no garbage — still exactly-once (one swept, rest held)
        gc_all()
        res1 = await gc_results()
        report.gc_cycles += 1
        report.gc_swept += sum(1 for r in res1 if r["outcome"] == "swept")
        report.gc_held += sum(1 for r in res1 if r["outcome"] == "held")

        # cycle 2: real garbage (drop two p0-unique groups on worker 0)
        n_shared = int(cfg.n_agents * cfg.shared_fraction)
        doom1 = {f"p0-a{i:03d}" for i in (n_shared, n_shared + 1)
                 if i < cfg.n_agents}
        doomed1, _live1 = split_live(doom1)
        for cn in sorted(doom1):
            workers[0].send({"cmd": "drop_group", "cn": cn})
            await workers[0].expect("dropped", timeout=30)
        gc_all()
        res2 = await gc_results()
        report.gc_cycles += 1
        report.gc_swept += sum(1 for r in res2 if r["outcome"] == "swept")
        report.gc_held += sum(1 for r in res2 if r["outcome"] == "held")
        report.chunks_removed_total += sum(
            r.get("chunks_removed", 0) for r in res2)

        # written-once accounting BEFORE any kill: every chunk write
        # happened in the backup phase, and a SIGKILLed leader takes
        # its claim counters with it — collect while both are alive
        for w in workers:
            w.send({"cmd": "metrics"})
        for w in workers:
            m = await w.expect("metrics", timeout=30)
            report.chunks_written_total += m["store"]["chunks_written"]
            report.cross_process_hits += m["store"]["cross_process_hits"]
            report.index_hits_total += m["dedup_index"]["hits"]
            # the hostile counters live in the worker that saw the abuse —
            # collect them here too, while BOTH processes are alive (a
            # SIGKILLed leader takes its counters with it)
            ext = m.get("admission_extra", {})
            report.reservations_reaped += ext.get("reservations_reaped", 0)
            report.evictions += ext.get("evictions", 0)
            report.admission_waits += ext.get("admission_waits", 0)
            report.stream_length_violations += m.get("mux", {}).get(
                "stream_length_violations", 0)
            report.tenant_grants[w.name] = m.get("tenant_grants", {})
            report.enqueue_p99[w.name] = m.get(
                "enqueue_to_publish", {}).get("p99", 0.0)
            report.launches[w.name] = m["launches"]

        # -- leader-kill failover ------------------------------------------
        doomed2: set = set()
        live2: set = set()
        if cfg.kill_leader:
            doom2 = {f"p1-a{i:03d}" for i in (n_shared, n_shared + 1)
                     if i < cfg.n_agents}
            doomed2, live2 = split_live(doom2)
            for cn in sorted(doom2):
                workers[1].send({"cmd": "drop_group", "cn": cn})
                await workers[1].expect("dropped", timeout=30)
            leader, survivor = workers[0], workers[1]
            # the cycle-2 winner still HOLDS its lease as an unexpired
            # cycle marker — wait it out (or until the leader-designate
            # already owns it) so the stalled sweep below is guaranteed
            # to win the lease before the kill
            from . import database as _database
            ctrl_db = _database.Database(
                os.path.join(state_dir, conf.DEFAULT_DB_NAME))
            try:
                deadline = time.monotonic() + 3 * cfg.gc_ttl_s + 5
                while time.monotonic() < deadline:
                    lease = ctrl_db.get_gc_lease()
                    if lease is None or lease["holder"] == leader.name \
                            or lease["expires_at"] < time.time():
                        break
                    await asyncio.sleep(0.05)
            finally:
                ctrl_db.close()
            # leader alone runs a STALLED sweep (delay failpoint), so
            # the kill lands mid-sweep with the lease held
            leader.send({"cmd": "gc", "grace": cfg.gc_grace_s,
                         "slow": cfg.kill_slow_sweep_s})
            await leader.expect("gc_running", timeout=30)
            await leader.expect("gc_started", timeout=30)   # lease won
            leader.kill()
            report.leader_killed = leader.name
            t_kill = time.perf_counter()
            # the survivor hammers gc until the expired lease is stolen
            outcome = ""
            while time.perf_counter() - t_kill < \
                    cfg.gc_ttl_s + max(5.0, 3 * cfg.gc_ttl_s):
                survivor.send({"cmd": "gc", "grace": cfg.gc_grace_s})
                await survivor.expect("gc_running", timeout=30)
                res = await survivor.expect("gc_result", timeout=60)
                if res["outcome"] == "swept":
                    outcome = "swept"
                    report.failover_s = time.perf_counter() - t_kill
                    report.chunks_removed_total += res["chunks_removed"]
                    break
                await asyncio.sleep(min(0.25, cfg.gc_ttl_s / 4))
            report.failover_outcome = outcome

            # coherence re-check: doomed digests are GONE from disk and
            # from the survivor's index; live digests all present
            doomed_list = sorted(doomed1 | doomed2)
            report.doomed_on_disk = sum(
                ds_view.chunks.on_disk_many(doomed_list))
            survivor.send({"cmd": "probe",
                           "digests": [d.hex() for d in doomed_list]})
            probe = await survivor.expect("probe", timeout=30)
            report.doomed_resurrected = sum(probe["present"])
            live_list = sorted(live2)
            report.live_missing = len(live_list) - sum(
                ds_view.chunks.on_disk_many(live_list))

        # -- deadline-admission probe against the survivor -----------------
        # fill the session ceiling with raw dials, then keep dialing
        # until one waits out the bounded admission deadline and gets
        # the TYPED 503 — proving deadline queueing (not fast-fail)
        # still runs on the post-failover survivor, and that the reject
        # lands in the shared admission counters
        if cfg.deadline_probe and cfg.admission_deadline_ms > 0:
            from ..arpc.transport import (HDR_LOOPBACK_CN, HandshakeError,
                                          connect_to_server)
            surv = workers[1] if cfg.kill_leader and cfg.processes > 1 \
                else workers[0]
            fillers = []
            try:
                for f in range(4 * cfg.n_agents + 40):
                    try:
                        c = await connect_to_server(
                            "127.0.0.1", surv.port, None,
                            headers={HDR_LOOPBACK_CN: f"filler-{f:03d}"},
                            timeout=cfg.admission_deadline_ms / 1000 + 15)
                    except HandshakeError as e:
                        if e.code == 503 and "deadline" in e.reason:
                            report.deadline_rejects_seen += 1
                        break
                    fillers.append(c)
            finally:
                for c in fillers:
                    await c.close()
            surv.send({"cmd": "metrics"})
            m = await surv.expect("metrics", timeout=30)
            report.deadline_rejects_counted = m["admission"].get(
                "admission_deadline", 0)

        # -- lease counters + lock-wait ladder from the survivors ----------
        live_workers = [w for w in workers
                        if w.proc is not None and w.proc.returncode is None]
        for w in live_workers:
            w.send({"cmd": "metrics"})
        for w in live_workers:
            m = await w.expect("metrics", timeout=30)
            report.lease_counters[w.name] = m["gc_lease"]
            report.steals_total += m["gc_lease"]["steals"]
            report.service_lock_wait[w.name] = m["service_lock_wait"]
            report.queue_counts = m["queue_counts"]
            report.admission = m["admission"]
            report.launches[w.name] = m["launches"]
        report.distinct_chunks_after = sum(
            1 for _ in ds_view.chunks.iter_digests())
        # the written-once identity over the whole run: every chunk file
        # was CREATED exactly once (the link claim never overwrites), so
        # the fleet's summed claim counters — captured before any kill —
        # must equal distinct-ever == still-on-disk + swept, plus the
        # mirror chunk files the sync lane created (each sync owns its
        # own mirror dir, so its transferred count IS its creations)
        report.written_once = (
            report.chunks_written_total ==
            report.distinct_chunks_after + report.chunks_removed_total
            + sync_chunks_written)
    finally:
        for a in agents.values():
            try:
                await a.stop()
            except Exception as e:          # killed worker's peers
                L.debug("multiproc agent stop: %s", e)
        for w in workers:
            await w.shutdown()
    report.wall_s = time.perf_counter() - t_start
    return report


def run_multiproc_fleet(root_dir: str, cfg: MultiProcConfig, *,
                        device="cuda") -> MultiProcReport:
    """Sync wrapper: one fresh event loop per multiproc soak."""
    return asyncio.run(run_multiproc_fleet_async(root_dir, cfg,
                                                 device=device))
