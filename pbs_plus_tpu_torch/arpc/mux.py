"""Stream multiplexer over one byte-stream connection (the smux analog).

Reference: xtaci/smux as used by the reference's TCP data plane
(internal/arpc/pipe.go:183-188 — "smux streams over one TCP
conn, one stream per RPC").

Frame: type(u8) | stream_id(u32) | length(u32), little-endian, then payload.
Credit-based flow control per stream (initial credit = conf.
STREAM_BUFFER_SIZE, granted back as the consumer drains), ping/pong
keepalive, id-parity allocation (client odd / server even) so both sides
can open streams without coordination.

A copy of the JAX package's ``arpc/mux.py``, its code byte for byte
apart from its imports, which name the port's own modules; it logs
through ``logging``. The port's failpoints know only the ``raise``
action."""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Optional

from ..utils import conf, failpoints, trace

L = logging.getLogger(__name__)

_HDR = struct.Struct("<BII")

SYN, DATA, FIN, RST, PING, PONG, WINDOW = range(1, 8)

MAX_DATA_FRAME = 256 << 10
INITIAL_CREDIT = conf.STREAM_BUFFER_SIZE

# accepted-but-unclaimed streams per connection: a SYN-flooding peer gets
# RSTs past this point instead of allocating unbounded stream state
MAX_SYN_BACKLOG = 256

# slack on top of the advertised credit before a peer counts as violating
# flow control (grants and data frames cross on the wire)
_RX_CREDIT_SLACK = MAX_DATA_FRAME


class MuxError(ConnectionError):
    pass


class MuxStream:
    def __init__(self, conn: "MuxConnection", sid: int):
        self.conn = conn
        self.sid = sid
        self._rx = bytearray()
        self._rx_event = asyncio.Event()
        self._rx_eof = False
        self._rx_reset = False
        self._tx_credit = INITIAL_CREDIT
        self._tx_event = asyncio.Event()
        self._tx_event.set()
        self._closed = False
        self._consumed_since_grant = 0
        # bytes received and buffered but not yet granted back: a peer
        # honoring flow control keeps this ≤ INITIAL_CREDIT, so it is
        # the per-stream RX buffering bound (enforced in _dispatch)
        self._rx_unacked = 0

    # -- read -------------------------------------------------------------
    async def read(self, n: int = -1) -> bytes:
        """Read up to n bytes (all buffered if n<0); b"" at EOF."""
        while not self._rx and not self._rx_eof and not self._rx_reset:
            self._rx_event.clear()
            await self._rx_event.wait()
        if self._rx_reset:
            raise MuxError(f"stream {self.sid} reset by peer")
        if not self._rx:
            return b""
        if n < 0 or n >= len(self._rx):
            out = bytes(self._rx)
            self._rx.clear()
        else:
            out = bytes(self._rx[:n])
            del self._rx[:n]
        await self._grant(len(out))
        return out

    async def readexactly(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            part = await self.read(n - len(out))
            if not part:
                raise MuxError(f"stream {self.sid}: EOF after {len(out)}/{n}")
            out += part
        return bytes(out)

    async def _grant(self, n: int) -> None:
        self._consumed_since_grant += n
        if self._consumed_since_grant >= INITIAL_CREDIT // 4:
            grant = self._consumed_since_grant
            self._consumed_since_grant = 0
            self._rx_unacked = max(0, self._rx_unacked - grant)
            await self.conn._send_frame(WINDOW, self.sid,
                                        struct.pack("<I", grant))

    # -- write ------------------------------------------------------------
    def _check_writable(self) -> None:
        """Raise if no more data can ever be sent: peer RST, local
        close/reset, or connection death.  Any of these while a writer is
        blocked on exhausted credit would otherwise hang it forever
        — all of their setters also set _tx_event so
        blocked writers wake and re-check."""
        if self._rx_reset:
            raise MuxError(f"stream {self.sid} reset by peer")
        if self._closed:
            raise MuxError(f"stream {self.sid} closed")
        if self.conn.closed:
            raise MuxError("connection closed")

    async def write(self, data: bytes) -> None:
        self._check_writable()
        view = memoryview(data)
        while view:
            # re-checked every chunk, not only when blocked on credit: a
            # mid-stream peer RST with window remaining must fail the
            # write, not let it "succeed" into a void
            self._check_writable()
            while self._tx_credit <= 0:
                self._tx_event.clear()
                self._check_writable()
                await self._tx_event.wait()
                self._check_writable()
            n = min(len(view), MAX_DATA_FRAME, self._tx_credit)
            self._tx_credit -= n
            await self.conn._send_frame(DATA, self.sid, bytes(view[:n]))
            view = view[n:]

    # -- lifecycle --------------------------------------------------------
    def _maybe_retire(self) -> None:
        """Drop this stream from the connection table once BOTH sides are
        done (local FIN sent + peer FIN/RST seen).  Without this, every
        RPC leaks one table entry for the life of the connection — a
        long-lived control session would grow without bound.  A held
        reference stays readable; only frame routing ends (no DATA can
        arrive after the peer's FIN; late WINDOW grants are ignored)."""
        if self._closed and (self._rx_eof or self._rx_reset):
            self.conn._drop_stream(self.sid)

    async def close(self) -> None:
        """Half-close (FIN); reads continue until peer FIN."""
        if not self._closed:
            self._closed = True
            self._tx_event.set()          # wake writers blocked on credit
            if not self.conn.closed:
                try:
                    await self.conn._send_frame(FIN, self.sid, b"")
                except ConnectionError:
                    pass
            self._maybe_retire()

    async def reset(self) -> None:
        self._closed = True
        self._tx_event.set()              # wake writers blocked on credit
        if not self.conn.closed:
            try:
                await self.conn._send_frame(RST, self.sid, b"")
            except ConnectionError:
                pass
        self.conn._drop_stream(self.sid)

    async def __aenter__(self) -> "MuxStream":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- conn callbacks ---------------------------------------------------
    def _on_data(self, payload: bytes) -> None:
        self._rx += payload
        self._rx_unacked += len(payload)
        self._rx_event.set()

    def _on_fin(self) -> None:
        self._rx_eof = True
        self._rx_event.set()
        self._maybe_retire()

    def _on_rst(self) -> None:
        # no retire here: RST kills both directions, so _dispatch pops the
        # table entry unconditionally (single owner for RST retirement) —
        # unlike FIN, which must wait for the local side via _maybe_retire
        self._rx_reset = True
        self._rx_event.set()
        self._tx_event.set()

    def _on_window(self, grant: int) -> None:
        self._tx_credit += grant
        self._tx_event.set()


class MuxConnection:
    """Multiplexed connection over asyncio (reader, writer)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, is_client: bool,
                 keepalive_s: float = 30.0,
                 write_deadline_s: float | None = None):
        self.reader = reader
        # every frame write serializes on _wlock: two interleaved
        # writer.write calls corrupt the mux framing for the whole
        # connection (teardown is the one sanctioned exception — see
        # the justified disables in _shutdown/close)
        self.writer = writer                        # guarded-by: self._wlock
        self.is_client = is_client
        self._next_sid = 1 if is_client else 2
        self._streams: dict[int, MuxStream] = {}
        # bounded SYN backlog: _syn_backlog counts queued-not-yet-accepted
        # streams and caps at MAX_SYN_BACKLOG; the +1 slot is reserved for
        # the shutdown sentinel so put_nowait can never fail
        self._accept_q: asyncio.Queue[MuxStream | None] = \
            asyncio.Queue(maxsize=MAX_SYN_BACKLOG + 1)
        self._syn_backlog = 0
        self._wlock = asyncio.Lock()
        self.closed = False
        self.close_reason = ""
        self._keepalive_s = keepalive_s
        # slow-reader shed: a frame write blocked on a full transport for
        # longer than this kills the CONNECTION (frames cannot be skipped
        # without corrupting the mux) instead of buffering without bound;
        # 0 disables, None takes the conf default (PBS_PLUS_MUX_WRITE_DEADLINE)
        self._write_deadline_s = (conf.env().mux_write_deadline_s
                                  if write_deadline_s is None
                                  else write_deadline_s)
        self._last_rx = time.monotonic()
        self._tasks: list[asyncio.Task] = []
        # cheap observability for fleet soaks (docs/fleet.md): cumulative
        # frame/byte counters plus shed/reject/violation events
        self.stats = {"frames_tx": 0, "frames_rx": 0,
                      "bytes_tx": 0, "bytes_rx": 0,
                      "write_deadline_sheds": 0, "syn_rejects": 0,
                      "flow_violations": 0,
                      "stream_length_violations": 0}

    def start(self) -> None:
        self._tasks.append(asyncio.create_task(self._read_loop()))
        if self._keepalive_s > 0:
            self._tasks.append(asyncio.create_task(self._keepalive_loop()))

    # -- frame io ---------------------------------------------------------
    async def _send_frame(self, ftype: int, sid: int, payload: bytes) -> None:
        if self.closed:
            raise MuxError("connection closed")
        shed = False
        # histogram-only timing (trace.record, no ring span): frames are
        # the hottest traced site, and the tail of this histogram is
        # where slow readers show up before the shed fires.  The clock
        # starts INSIDE the write lock so a sample is this frame's
        # write+drain, not the queue of predecessors serialized ahead
        # of it (that queue depth is exactly what the tail would
        # otherwise multiply into).
        dur = 0.0
        async with self._wlock:
            t0 = time.perf_counter()
            try:
                # drop/corrupt here injects a transport-death / bitflip at
                # the frame layer; ConnectionResetError takes the same
                # shutdown path as a real dead socket
                payload = await failpoints.ahit("arpc.mux.write_frame",
                                                payload)
                self.writer.write(_HDR.pack(ftype, sid, len(payload)))
                if payload:
                    self.writer.write(payload)
                self.stats["frames_tx"] += 1
                self.stats["bytes_tx"] += _HDR.size + len(payload)
                if self._write_deadline_s > 0:
                    try:
                        await asyncio.wait_for(self.writer.drain(),
                                               self._write_deadline_s)
                    except asyncio.TimeoutError:
                        # slow reader: the peer has not drained its socket
                        # for a full deadline — shed the connection (the
                        # only safe unit; skipping frames would desync the
                        # mux) rather than queue unbounded bytes
                        shed = True
                else:
                    await self.writer.drain()
                dur = time.perf_counter() - t0
            except (ConnectionError, OSError) as e:
                await self._shutdown(f"write failed: {e}")
                raise MuxError(f"connection write failed: {e}") from e
        if shed:
            self.stats["write_deadline_sheds"] += 1
            await self._shutdown(
                f"write deadline ({self._write_deadline_s:g}s) exceeded: "
                "slow reader shed")
            raise MuxError(
                "connection shed: write blocked past deadline "
                f"({self._write_deadline_s:g}s)")
        trace.record("mux.write_frame", dur)

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self.reader.readexactly(_HDR.size)
                ftype, sid, ln = _HDR.unpack(hdr)
                payload = await self.reader.readexactly(ln) if ln else b""
                payload = await failpoints.ahit("arpc.mux.read_frame",
                                                payload)
                self._last_rx = time.monotonic()
                self.stats["frames_rx"] += 1
                self.stats["bytes_rx"] += _HDR.size + len(payload)
                await self._dispatch(ftype, sid, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            await self._shutdown(f"read loop ended: {e}")
        except asyncio.CancelledError:
            pass
        except Exception:
            L.exception("mux read loop crashed")
            await self._shutdown("read loop crashed")

    async def _dispatch(self, ftype: int, sid: int, payload: bytes) -> None:
        if ftype == SYN:
            if sid in self._streams:
                return
            if self._syn_backlog >= MAX_SYN_BACKLOG:
                # accept backlog full: shed the stream, not the memory —
                # the peer sees RST and may retry once we drain
                self.stats["syn_rejects"] += 1
                await self._send_frame(RST, sid, b"")
                return
            st = MuxStream(self, sid)
            self._streams[sid] = st
            self._syn_backlog += 1
            self._accept_q.put_nowait(st)   # can't fail: backlog < maxsize-1
        elif ftype == DATA:
            st = self._streams.get(sid)
            if st is not None:
                st._on_data(payload)
                if st._rx_unacked > INITIAL_CREDIT + _RX_CREDIT_SLACK:
                    # peer is writing past its advertised credit: reset
                    # the stream so per-stream RX buffering stays bounded
                    # no matter how the other side misbehaves
                    self.stats["flow_violations"] += 1
                    L.warning("stream %d exceeded rx credit (%d buffered); "
                              "resetting", sid, st._rx_unacked)
                    self._streams.pop(sid, None)
                    st._on_rst()
                    await self._send_frame(RST, sid, b"")
            else:
                await self._send_frame(RST, sid, b"")
        elif ftype == FIN:
            st = self._streams.get(sid)
            if st is not None:
                st._on_fin()
        elif ftype == RST:
            st = self._streams.get(sid)
            if st is not None:
                st._on_rst()
            self._streams.pop(sid, None)
        elif ftype == PING:
            await self._send_frame(PONG, 0, b"")
        elif ftype == PONG:
            pass
        elif ftype == WINDOW:
            st = self._streams.get(sid)
            if st is not None and len(payload) == 4:
                st._on_window(struct.unpack("<I", payload)[0])

    async def _keepalive_loop(self) -> None:
        try:
            while not self.closed:
                await asyncio.sleep(self._keepalive_s)
                if time.monotonic() - self._last_rx > 4 * self._keepalive_s:
                    await self._shutdown("keepalive timeout")
                    return
                try:
                    await self._send_frame(PING, 0, b"")
                except ConnectionError:
                    return
        except asyncio.CancelledError:
            pass

    # -- streams ----------------------------------------------------------
    async def open_stream(self) -> MuxStream:
        if self.closed:
            raise MuxError("connection closed")
        sid = self._next_sid
        self._next_sid += 2
        st = MuxStream(self, sid)
        self._streams[sid] = st
        await self._send_frame(SYN, sid, b"")
        return st

    async def accept_stream(self) -> Optional[MuxStream]:
        """None when the connection is closed."""
        if self.closed and self._accept_q.empty():
            return None
        st = await self._accept_q.get()
        if st is not None:
            self._syn_backlog -= 1
        return st

    def _drop_stream(self, sid: int) -> None:
        self._streams.pop(sid, None)

    # -- lifecycle --------------------------------------------------------
    async def _shutdown(self, reason: str) -> None:
        if self.closed:
            return
        self.closed = True
        self.close_reason = reason
        for st in list(self._streams.values()):
            st._on_rst()
        self._streams.clear()
        # the +1 maxsize slot is reserved for exactly this sentinel (the
        # backlog counter caps stream entries at MAX_SYN_BACKLOG)
        self._accept_q.put_nowait(None)
        # stop companion loops promptly (a dead conn must not keep its
        # keepalive task alive for up to a full interval — leak discipline)
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()
        try:
            # teardown: closed=True above means no _send_frame will touch
            # the transport again, and close() must not wait on _wlock (a
            # writer blocked on a full socket may hold it past the
            # deadline — the shed path would deadlock against itself)
            self.writer.close()   # pbslint: disable=guarded-by
        except Exception as e:
            L.debug("transport close on dead conn: %s", e)

    async def close(self) -> None:
        await self._shutdown("closed locally")   # cancels companion tasks
        for t in self._tasks:
            if t is not asyncio.current_task():
                try:
                    await t
                except asyncio.CancelledError:
                    pass        # we cancelled it above: expected
                except Exception as e:
                    L.debug("companion task died at close: %s", e)
        try:
            # teardown (see _shutdown): the conn is closed, companion
            # tasks are awaited dead — nothing can race this wait
            await self.writer.wait_closed()   # pbslint: disable=guarded-by
        except Exception as e:
            L.debug("transport wait_closed: %s", e)
