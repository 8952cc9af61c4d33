"""mTLS TCP transport + connection handshake.

Reference: internal/arpc/pipe.go:61-131 (ConnectToServer), listener.go:43-51,
quic_transport.go:434-461 (first-frame headers, rejection frame w/ code).

Connection open: TLS (mutual, CA-pinned) → client sends a headers frame
(magic ``TPRC`` + u32 len + msgpack map) → server replies an accept/reject
frame (``{ok: bool, code, reason}``) → mux starts.  The headers carry the
job-session routing keys (X-PBS-Plus-BackupID / RestoreID / VerifyID —
same header names as the reference, agents_manager.py).

Loopback plain mode: passing ``tls=None`` (both sides) skips TLS and
takes the peer identity from the ``X-PBS-Plus-Loopback-CN`` handshake
header instead of the certificate CN.  This exists ONLY for the
in-process fleet simulator and tests (`server/fleetsim.py`,
docs/fleet.md) — production servers always pass a ``TlsServerConfig``,
and a plain listener trusts whatever CN the peer claims.

A copy of the JAX package's ``arpc/transport.py``, its code byte for
byte apart from its imports, which name the port's own modules, and its
logger (``logging``).
"""

from __future__ import annotations

import asyncio
import logging
import ssl
import struct
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from ..utils import codec, failpoints
from .mux import MuxConnection

L = logging.getLogger(__name__)

HANDSHAKE_MAGIC = b"TPRC"
_LEN = struct.Struct("<I")
MAX_HANDSHAKE = 64 << 10

# loopback plain mode (tls=None) only: the claimed peer identity header
HDR_LOOPBACK_CN = "X-PBS-Plus-Loopback-CN"


class HandshakeError(ConnectionError):
    def __init__(self, code: int, reason: str):
        super().__init__(f"handshake rejected ({code}): {reason}")
        self.code = code
        self.reason = reason


@dataclass
class TlsServerConfig:
    cert_path: str
    key_path: str
    ca_path: str              # client certs must chain to this CA

    def context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_path, self.key_path)
        ctx.load_verify_locations(self.ca_path)
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx


@dataclass
class TlsClientConfig:
    cert_path: str
    key_path: str
    ca_path: str              # pin the server CA

    def context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_path, self.key_path)
        ctx.load_verify_locations(self.ca_path)
        ctx.check_hostname = False   # identity = cert CN (CA-pinned), not DNS
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx


async def _write_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    body = codec.encode(obj)
    writer.write(HANDSHAKE_MAGIC + _LEN.pack(len(body)) + body)
    await writer.drain()


async def _read_frame(reader: asyncio.StreamReader) -> dict:
    magic = await reader.readexactly(4)
    if magic != HANDSHAKE_MAGIC:
        raise ConnectionError(f"bad handshake magic {magic!r}")
    (n,) = _LEN.unpack(await reader.readexactly(4))
    if n > MAX_HANDSHAKE:
        raise ConnectionError("handshake frame too large")
    return codec.decode_map(await reader.readexactly(n))


async def connect_to_server(host: str, port: int,
                            tls: TlsClientConfig | None, *,
                            headers: dict[str, str] | None = None,
                            timeout: float = 15.0,
                            keepalive_s: float = 30.0,
                            write_deadline_s: float | None = None
                            ) -> MuxConnection:
    """Dial + handshake; returns a started MuxConnection (reference:
    arpc.ConnectToServer with header X-PBS-Plus-BackupID etc.).
    ``tls=None`` dials plain TCP (loopback simulator mode only)."""
    async def _dial() -> MuxConnection:
        await failpoints.ahit("arpc.transport.connect")
        reader, writer = await asyncio.open_connection(
            host, port, ssl=tls.context() if tls is not None else None)
        try:
            await _write_frame(writer, {"headers": headers or {}})
            resp = await _read_frame(reader)
            if not resp.get("ok"):
                raise HandshakeError(int(resp.get("code", 403)),
                                     str(resp.get("reason", "rejected")))
            conn = MuxConnection(reader, writer, is_client=True,
                                 keepalive_s=keepalive_s,
                                 write_deadline_s=write_deadline_s)
            conn.start()
            return conn
        except BaseException:
            writer.close()
            raise
    return await asyncio.wait_for(_dial(), timeout)


# server side ---------------------------------------------------------------

AcceptFn = Callable[[ssl.SSLObject | None, dict, asyncio.StreamWriter],
                    Awaitable[Optional[tuple[int, str]]]]
ConnFn = Callable[[MuxConnection, dict, dict], Awaitable[None]]


async def serve(host: str, port: int, tls: TlsServerConfig | None, *,
                on_connection: ConnFn,
                admit: Callable[[dict, dict], Awaitable[tuple[int, str] | None]]
                | None = None,
                keepalive_s: float = 30.0,
                write_deadline_s: float | None = None
                ) -> asyncio.AbstractServer:
    """Start the aRPC listener.  ``admit(peer_info, headers)`` returns None
    to accept, returns (code, reason) to reject, or raises the typed
    ``AdmissionRejected`` (agents_manager.py) — both reject forms send the
    same wire frame; ``on_connection(conn, peer_info, headers)`` owns the
    accepted connection (runs as its own task).  ``tls=None`` listens on
    plain TCP and takes the peer CN from the ``X-PBS-Plus-Loopback-CN``
    header — loopback simulator mode only, never production."""
    from .agents_manager import AdmissionRejected

    async def _client(reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = None
        try:
            sslobj = writer.get_extra_info("ssl_object")
            peercert = sslobj.getpeercert() if sslobj else None
            cn = ""
            if peercert:
                for rdn in peercert.get("subject", ()):
                    for k, v in rdn:
                        if k == "commonName":
                            cn = v
            hello = await asyncio.wait_for(_read_frame(reader), 15.0)
            headers = dict(hello.get("headers", {}))
            if tls is None and not cn:
                # plain loopback mode: identity is CLAIMED, not proven
                cn = str(headers.get(HDR_LOOPBACK_CN, ""))
            peer_info = {
                "cn": cn,
                "cert_der": sslobj.getpeercert(binary_form=True) if sslobj else b"",
                "addr": writer.get_extra_info("peername"),
                "insecure": tls is None,
            }
            if admit is not None:
                try:
                    verdict = await admit(peer_info, headers)
                except AdmissionRejected as e:
                    verdict = (e.code, e.reason)
                if verdict is not None:
                    code, reason = verdict
                    await _write_frame(writer, {"ok": False, "code": code,
                                                "reason": reason})
                    writer.close()
                    return
            # between admit() (ceiling reservation held) and register()
            # (reservation consumed): a peer that dies inside this window
            # strands its reservation until the TTL sweep — the site lets
            # chaos runs widen the window deterministically
            await failpoints.ahit("arpc.handshake.accept")
            await _write_frame(writer, {"ok": True})
            conn = MuxConnection(reader, writer, is_client=False,
                                 keepalive_s=keepalive_s,
                                 write_deadline_s=write_deadline_s)
            conn.start()
            await on_connection(conn, peer_info, headers)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, ssl.SSLError) as e:
            L.debug("connection setup failed: %s", e)
            writer.close()
        except asyncio.CancelledError:
            if conn:
                await conn.close()
            raise
        except Exception:
            L.exception("connection handler crashed")
            if conn:
                await conn.close()
            else:
                writer.close()

    server = await asyncio.start_server(
        _client, host, port, ssl=tls.context() if tls is not None else None)
    return server
