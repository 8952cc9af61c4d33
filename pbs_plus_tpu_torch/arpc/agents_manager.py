"""Session registry: admission, routing, rate limiting, eviction.

Reference: internal/arpc/agents_manager.go:22-268 —
- clientID = cert CN, with job suffixes ``CN|BackupID`` /
  ``CN|RestoreID|restore`` / ``CN|VerifyID|verify`` taken from connection
  headers (the reference's X-PBS-Plus-* headers)
- expected-list gate (server-side DB of bootstrapped hosts) + optional
  custom cert check
- per-client token bucket (10/s, burst 20)
- duplicate-session eviction on reconnect (newest wins)
- WaitStreamPipe: a job (backup/restore) waits for the agent child's data
  session to appear

A copy of the JAX package's ``arpc/agents_manager.py``, its code byte
for byte apart from its imports, which name the port's own modules, and
its logger (``logging``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from ..utils import conf, failpoints
from .mux import MuxConnection

L = logging.getLogger(__name__)

HDR_BACKUP_ID = "X-PBS-Plus-BackupID"
HDR_RESTORE_ID = "X-PBS-Plus-RestoreID"
HDR_VERIFY_ID = "X-PBS-Plus-VerifyID"

# prune cadence / cap for the per-client token-bucket registry: a fleet
# cycling through millions of distinct CNs must not pin one bucket each
_BUCKET_PRUNE_INTERVAL_S = 60.0
_BUCKET_CAP = 8192

# admitted-but-unregistered ceiling reservations expire after this long
# (the transport handshake times out at 15s, so a reservation older than
# this belongs to a connection that died before register() — including
# a slowloris that admitted and then simply never registered)
_ADMIT_RESERVATION_TTL_S = 20.0

# deadline-admission wait queue bound (docs/fleet.md "Admission"): a
# handshake arriving at the session ceiling with a deadline configured
# waits here for capacity; past this many queued waiters the verdict is
# an immediate typed reject (kind=admission_queue_full) — the wait queue
# itself must hold the bounded-queue discipline it fronts for
_ADMIT_QUEUE_CAP = 1024


class AdmissionRejected(ConnectionError):
    """Typed fast-fail admission verdict (docs/fleet.md).

    ``code`` is the handshake rejection code sent on the wire (429 rate,
    503 capacity, 403 identity), ``reason`` the human string, ``kind``
    the stable counter label exported as
    ``pbs_plus_admission_rejected_total{reason=...}``."""

    def __init__(self, code: int, reason: str, kind: str):
        super().__init__(f"admission rejected ({code}): {reason}")
        self.code = code
        self.reason = reason
        self.kind = kind


class AdmissionDeadlineError(AdmissionRejected):
    """Deadline admission timed out: the handshake queued for capacity
    (PBS_PLUS_ADMISSION_DEADLINE_MS) and its per-request deadline
    expired before a session slot freed.  Subclasses AdmissionRejected
    so transport.serve converts it into the same 503 wire rejection
    frame; the distinct ``kind`` keeps deadline expiries countable apart
    from queue-full and plain ceiling rejects."""

    def __init__(self, reason: str, *, kind: str = "admission_deadline"):
        super().__init__(503, reason, kind)


def client_id_from(cn: str, headers: dict[str, str]) -> str:
    """Reference: getClientId (agents_manager.go:75-99)."""
    if HDR_BACKUP_ID in headers:
        return f"{cn}|{headers[HDR_BACKUP_ID]}"
    if HDR_RESTORE_ID in headers:
        return f"{cn}|{headers[HDR_RESTORE_ID]}|restore"
    if HDR_VERIFY_ID in headers:
        return f"{cn}|{headers[HDR_VERIFY_ID]}|verify"
    return cn


@dataclass
class ClientSession:
    client_id: str
    cn: str
    conn: MuxConnection
    headers: dict[str, str] = field(default_factory=dict)
    connected_at: float = field(default_factory=time.time)


class _TokenBucket:
    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = burst
        self.tokens = float(burst)
        self.last = time.monotonic()

    def allow(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


ExpectFn = Callable[[str, bytes], Awaitable[bool]]


class AgentsManager:
    """Connected-session registry with admission control."""

    def __init__(self, *, is_expected: ExpectFn | None = None,
                 rate: float | None = None,
                 burst: int | None = None,
                 max_sessions: int | None = None,
                 open_rate: float | None = None,
                 admission_deadline_ms: float | None = None,
                 admit_queue_cap: int = _ADMIT_QUEUE_CAP):
        e = conf.env()
        self._sessions: dict[str, ClientSession] = {}
        self._expected_ids: set[str] = set()         # Expect() one-shots
        self._waiters: dict[str, list[asyncio.Future]] = {}
        self._disc_watchers: dict[int, list[asyncio.Future]] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self._last_bucket_prune = time.monotonic()
        self._rate = e.agent_rate if rate is None else rate
        self._burst = e.agent_burst if burst is None else burst
        # hard ceiling on registered sessions (0 = unlimited) and a
        # GLOBAL session-open rate bucket (0 = disabled) on top of the
        # per-client bucket: bounded admission instead of unbounded accept
        self.max_sessions = (e.agent_max_sessions if max_sessions is None
                             else max_sessions)
        open_rate = e.agent_open_rate if open_rate is None else open_rate
        self._open_bucket = (_TokenBucket(open_rate,
                                          max(1, int(2 * open_rate)))
                             if open_rate > 0 else None)
        self._is_expected = is_expected
        self._lock = asyncio.Lock()
        # admitted-but-not-yet-registered handshakes: the ok-frame write
        # and register() happen awaits after admit(), so the session
        # ceiling counts these reservations too or a connect storm would
        # sail past it wholesale.  A reservation whose connection died
        # before register() expires after the handshake deadline.
        self._admit_reservations: deque[float] = deque()
        # deadline admission (docs/fleet.md "Admission"): >0 turns the
        # session-ceiling fast-fail into a bounded wait of at most this
        # many seconds (per request) for capacity; the waiter queue is
        # itself bounded at admit_queue_cap
        deadline_ms = (e.admission_deadline_ms
                       if admission_deadline_ms is None
                       else admission_deadline_ms)
        self.admission_deadline_s = max(0.0, deadline_ms / 1000.0)
        self.admit_queue_cap = admit_queue_cap
        self._admit_waiters: deque[asyncio.Future] = deque()
        # reservation TTL sweep: reservations used to be reaped only
        # lazily inside the NEXT admit() call, so a slowloris handshake
        # (admit, then never register) pinned ceiling capacity until
        # fresh traffic arrived.  A self-terminating sweeper task —
        # spawned when reservations/waiters exist, exiting when both
        # drain — reaps expired reservations on the idle-bucket prune
        # cadence and wakes deadline waiters into the freed capacity.
        self.reservation_ttl_s = _ADMIT_RESERVATION_TTL_S
        self.reservations_reaped = 0
        self._sweeper: asyncio.Task | None = None
        # observability counters kept OUT of _admission_counts: that
        # dict's non-"admitted" keys sum into admission_rejected, and
        # neither a wait that later admitted nor a newest-wins eviction
        # is a reject
        self.admission_waits = 0      # deadline waiters ever queued
        self.evictions = 0            # duplicate sessions evicted
        # cumulative admission verdicts, keyed by AdmissionRejected.kind
        # (plus "admitted") — rendered by server/metrics.py
        self._admission_counts: dict[str, int] = {"admitted": 0}

    def _reject(self, exc: AdmissionRejected) -> AdmissionRejected:
        self._admission_counts[exc.kind] = \
            self._admission_counts.get(exc.kind, 0) + 1
        return exc

    def _count_reject(self, code: int, reason: str,
                      kind: str) -> AdmissionRejected:
        return self._reject(AdmissionRejected(code, reason, kind))

    def admission_stats(self) -> dict[str, int]:
        """{"admitted": n, "<reject kind>": n, ...} — cumulative."""
        return dict(self._admission_counts)

    def _maybe_prune_buckets(self, now: float) -> None:
        """Drop idle per-client buckets.  A bucket whose idle time would
        refill it to burst carries no state (a fresh bucket is
        equivalent), so evicting those never weakens the limit; past
        _BUCKET_CAP a forced sweep evicts the COLDEST buckets too (those
        CNs get a fresh burst — the bounded registry is worth that
        slack) so a million distinct CNs can never pin a million
        buckets, and the sweep brings the dict back under cap so the
        over-cap path is not re-entered on every admit."""
        over = len(self._buckets) > _BUCKET_CAP
        if not over and \
                now - self._last_bucket_prune < _BUCKET_PRUNE_INTERVAL_S:
            return
        self._last_bucket_prune = now
        if self._rate > 0:
            ttl = self._burst / self._rate  # time-to-full from empty
            dead = [cn for cn, b in self._buckets.items()
                    if now - b.last >= ttl]
            for cn in dead:
                del self._buckets[cn]
        if len(self._buckets) > _BUCKET_CAP:
            # sweep to 7/8 of cap, not to cap exactly: leaving headroom
            # amortizes the O(n log n) sort across ~cap/8 admissions
            # instead of re-sorting the whole registry on every new CN
            target = _BUCKET_CAP - _BUCKET_CAP // 8
            coldest = sorted((b.last, cn)
                             for cn, b in self._buckets.items())
            for _, cn in coldest[:len(self._buckets) - target]:
                del self._buckets[cn]

    # -- admission (plugged into transport.serve's admit) ------------------
    async def admit(self, peer_info: dict, headers: dict) -> None:
        """Raises typed ``AdmissionRejected`` on any reject; returns None
        on accept (transport.serve converts the exception into the wire
        rejection frame)."""
        await failpoints.ahit("arpc.session.open")
        cn = peer_info.get("cn", "")
        now = time.monotonic()
        if not cn:
            raise self._count_reject(403, "client certificate has no CN",
                                     "no_cn")
        reserved = False
        if self.max_sessions > 0:
            # count registered sessions PLUS in-flight admitted
            # handshakes: registration happens awaits after this check,
            # so without the reservation a connect storm would overshoot
            # the ceiling by exactly the storm size
            deadline = now + self.admission_deadline_s
            while len(self._sessions) + self._reservations(now) >= \
                    self.max_sessions:
                if self.admission_deadline_s <= 0:
                    raise self._count_reject(
                        503,
                        f"session limit reached ({self.max_sessions})",
                        "session_limit")
                # deadline admission: queue (bounded) for capacity
                # instead of fast-failing; the two reject flavors stay
                # distinguishable by kind
                if len(self._admit_waiters) >= self.admit_queue_cap:
                    raise self._count_reject(
                        503,
                        f"admission wait queue full "
                        f"({self.admit_queue_cap})",
                        "admission_queue_full")
                remaining = deadline - now
                if remaining <= 0:
                    raise self._reject(AdmissionDeadlineError(
                        f"admission deadline "
                        f"({self.admission_deadline_s:g}s) expired at "
                        f"the session ceiling ({self.max_sessions})"))
                fut: asyncio.Future = \
                    asyncio.get_running_loop().create_future()
                self._admit_waiters.append(fut)
                self.admission_waits += 1
                self._ensure_sweeper()
                try:
                    await asyncio.wait_for(fut, remaining)
                except asyncio.TimeoutError:
                    raise self._reject(AdmissionDeadlineError(
                        f"admission deadline "
                        f"({self.admission_deadline_s:g}s) expired at "
                        f"the session ceiling ({self.max_sessions})")
                    ) from None
                finally:
                    try:
                        self._admit_waiters.remove(fut)
                    except ValueError:
                        pass        # already consumed by a wake
                now = time.monotonic()
            self._admit_reservations.append(now)
            reserved = True
            self._ensure_sweeper()
        try:
            if self._open_bucket is not None and \
                    not self._open_bucket.allow():
                raise self._count_reject(429, "session open rate limited",
                                         "open_rate")
            cid = client_id_from(cn, headers)
            if self._rate > 0:              # 0 disables the per-CN gate
                self._maybe_prune_buckets(now)
                bucket = self._buckets.setdefault(
                    cn, _TokenBucket(self._rate, self._burst))
                if not bucket.allow():
                    raise self._count_reject(429, "rate limited",
                                             "client_rate")
            # job sessions must have been announced via expect(); primary
            # sessions go through the expected-host check (cert in DB)
            if cid != cn:
                if cid not in self._expected_ids:
                    raise self._count_reject(
                        403, f"unexpected job session {cid!r}",
                        "unexpected_job_session")
            elif self._is_expected is not None:
                ok = await self._is_expected(cn,
                                             peer_info.get("cert_der", b""))
                if not ok:
                    raise self._count_reject(403, "host not expected",
                                             "host_not_expected")
        except BaseException:
            if reserved and self._admit_reservations:
                self._admit_reservations.pop()
            raise
        self._admission_counts["admitted"] += 1
        return None

    def _reservations(self, now: float) -> int:
        """Live admitted-but-unregistered count (expired ones belong to
        connections that died between admit() and register() — or to a
        slowloris that never intended to register)."""
        q = self._admit_reservations
        while q and now - q[0] > self.reservation_ttl_s:
            q.popleft()
            self.reservations_reaped += 1
        return len(q)

    def _wake_admit_waiters(self) -> None:
        """Hand freed ceiling capacity to queued deadline waiters (FIFO).
        A woken waiter re-checks the ceiling in its admit() loop, so an
        overshoot here only costs one extra wait round, never a slot."""
        if not self._admit_waiters:
            return
        now = time.monotonic()
        free = (self.max_sessions - len(self._sessions)
                - self._reservations(now))
        while free > 0 and self._admit_waiters:
            fut = self._admit_waiters.popleft()
            if fut.done():
                continue
            fut.set_result(None)
            free -= 1

    def _ensure_sweeper(self) -> None:
        """Spawn the reservation-TTL sweeper if pending state needs it.
        Self-terminating: the task exits once no reservations or
        deadline waiters remain, so an idle manager carries no task."""
        if self._sweeper is not None and not self._sweeper.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:        # constructed outside a loop
            return
        self._sweeper = loop.create_task(self._sweep_loop(),
                                         name="admit-reservation-sweep")

    async def _sweep_loop(self) -> None:
        """Reap expired admit reservations WITHOUT fresh traffic, on the
        same cadence family as the idle-bucket prune (which it also
        piggybacks): a slowloris holding a reservation frees its ceiling
        slot one TTL after admit even if no further admit() ever runs,
        and any queued deadline waiters are woken into the freed
        capacity."""
        try:
            while self._admit_reservations or self._admit_waiters:
                now = time.monotonic()
                if self._admit_reservations:
                    wait = (self.reservation_ttl_s
                            - (now - self._admit_reservations[0]))
                else:
                    wait = self.reservation_ttl_s
                await asyncio.sleep(
                    min(max(wait, 0.01), _BUCKET_PRUNE_INTERVAL_S))
                now = time.monotonic()
                self._reservations(now)         # reap expired heads
                self._maybe_prune_buckets(now)  # piggybacked idle prune
                if self.max_sessions > 0:
                    self._wake_admit_waiters()
        finally:
            self._sweeper = None

    def expect(self, client_id: str) -> None:
        """Announce an upcoming job session (reference: Expect(streamID),
        rpc/mount.go:112)."""
        self._expected_ids.add(client_id)

    def unexpect(self, client_id: str) -> None:
        self._expected_ids.discard(client_id)

    # -- registry ----------------------------------------------------------
    async def register(self, peer_info: dict, headers: dict,
                       conn: MuxConnection) -> ClientSession:
        cn = peer_info.get("cn", "")
        cid = client_id_from(cn, headers)
        sess = ClientSession(cid, cn, conn, dict(headers))
        if self._admit_reservations:
            # this registration consumes one admitted-handshake
            # reservation (FIFO — reservations are fungible)
            self._admit_reservations.popleft()
        async with self._lock:
            old = self._sessions.get(cid)
            self._sessions[cid] = sess
            waiters = self._waiters.pop(cid, [])
        if old is not None and not old.conn.closed:
            L.info("evicting duplicate session", )
            self.evictions += 1
            await old.conn.close()       # duplicate eviction: newest wins
        for f in waiters:
            if not f.done():
                f.set_result(sess)
        return sess

    async def unregister(self, sess: ClientSession) -> None:
        async with self._lock:
            cur = self._sessions.get(sess.client_id)
            if cur is sess:
                del self._sessions[sess.client_id]
            watchers = self._disc_watchers.pop(id(sess), [])
        for f in watchers:
            if not f.done():
                f.set_result(sess)
        if self.max_sessions > 0:
            # a departing session is freed ceiling capacity: hand it to
            # queued deadline waiters immediately, not at the next sweep
            self._wake_admit_waiters()

    def watch_disconnect(self, sess: ClientSession) -> asyncio.Future:
        """Future resolved when this exact session unregisters (its
        connection died or was evicted).  Crashed-job detection: a backup
        races its pump against this future, so an agent child crash fails
        the job in milliseconds even if the control session is still up
        (reference pattern: internal/server/vfs/arpcfs/fs.go:119-148 —
        primary up, job session severed → hard error)."""
        fut = asyncio.get_running_loop().create_future()
        if sess.conn.closed:
            fut.set_result(sess)
            return fut
        self._disc_watchers.setdefault(id(sess), []).append(fut)
        return fut

    def unwatch_disconnect(self, sess: ClientSession,
                           fut: asyncio.Future) -> None:
        ws = self._disc_watchers.get(id(sess))
        if ws and fut in ws:
            ws.remove(fut)
            if not ws:
                del self._disc_watchers[id(sess)]

    def get(self, client_id: str) -> Optional[ClientSession]:
        s = self._sessions.get(client_id)
        if s is not None and s.conn.closed:
            return None
        return s

    def sessions(self) -> list[ClientSession]:
        return [s for s in self._sessions.values() if not s.conn.closed]

    async def wait_session(self, client_id: str,
                           timeout: float = 60.0) -> ClientSession:
        """Wait for a (job) session to register (reference: WaitStreamPipe,
        agents_manager.go:197-215)."""
        s = self.get(client_id)
        if s is not None:
            return s
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(client_id, []).append(fut)
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            ws = self._waiters.get(client_id)
            if ws is not None:
                if fut in ws:
                    ws.remove(fut)
                if not ws:
                    # drop the empty key: a timed-out waiter must not pin
                    # a _waiters entry per client_id ever waited for
                    del self._waiters[client_id]
