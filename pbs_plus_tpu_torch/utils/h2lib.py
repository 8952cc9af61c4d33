"""Minimal HTTP/2 over libnghttp2 (ctypes) — the transport a stock PBS
speaks after the ``proxmox-backup-protocol-v1`` 101 upgrade.

Reference role: the reference's PBS push path rides proxmox-backup-client,
which talks the h2-upgraded backup protocol
(internal/pxarmount/commit_orchestrate.go:127-163 consumes
it through the pxar lib).  This build's PBSStore previously spoke the
same endpoint vocabulary over HTTP/1.1 only; this module closes the
transport gap without new Python deps by binding the system libnghttp2
(the h2 engine inside curl), in the same ctypes style as the libfuse
frontend (``mount/fusefs.py``).

Blocking, socket-owning sessions:

- ``H2ClientSession(sock)``: sequential ``request()`` calls multiplex on
  stream ids; flow control / HPACK / SETTINGS are nghttp2's.
- ``H2ServerSession(sock, handler)``: serves requests arriving on the
  connection until EOF — used by the tests' upgrade bridge so the client
  side is exercised against the reference h2 implementation rather than
  a mirror of itself.

Only the PBS-shaped subset is implemented: request/response with full
bodies (the backup protocol's bodies are chunk-sized), no server push,
no trailers, no priorities.

A copy of the JAX package's ``utils/h2lib.py``, its code byte for byte
(it imports only the standard library).  libnghttp2 is looked up at
import, as there; ``available()`` says whether it loaded.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import socket
import threading
from dataclasses import dataclass, field

_LIB_CANDIDATES = ("libnghttp2.so.14", "libnghttp2.so",
                   ctypes.util.find_library("nghttp2"))


def _load() -> ctypes.CDLL | None:
    for name in _LIB_CANDIDATES:
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


_lib = _load()


def available() -> bool:
    return _lib is not None


# -- C ABI ----------------------------------------------------------------
_ssize_t = ctypes.c_ssize_t
NGHTTP2_NV_FLAG_NONE = 0
NGHTTP2_FLAG_END_STREAM = 0x01
NGHTTP2_DATA_FLAG_EOF = 0x01
NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS = 3
NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE = 4
NGHTTP2_FRAME_DATA = 0
NGHTTP2_FRAME_HEADERS = 1
NGHTTP2_FRAME_GOAWAY = 7


class _NV(ctypes.Structure):
    _fields_ = [("name", ctypes.POINTER(ctypes.c_uint8)),
                ("value", ctypes.POINTER(ctypes.c_uint8)),
                ("namelen", ctypes.c_size_t),
                ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


class _SettingsEntry(ctypes.Structure):
    _fields_ = [("settings_id", ctypes.c_int32),
                ("value", ctypes.c_uint32)]


class _FrameHd(ctypes.Structure):
    _fields_ = [("length", ctypes.c_size_t),
                ("stream_id", ctypes.c_int32),
                ("type", ctypes.c_uint8),
                ("flags", ctypes.c_uint8),
                ("reserved", ctypes.c_uint8)]


class _DataSource(ctypes.Union):
    _fields_ = [("fd", ctypes.c_int), ("ptr", ctypes.c_void_p)]


_DATA_READ_CB = ctypes.CFUNCTYPE(
    _ssize_t, ctypes.c_void_p, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(_DataSource),
    ctypes.c_void_p)


class _DataProvider(ctypes.Structure):
    _fields_ = [("source", _DataSource), ("read_callback", _DATA_READ_CB)]


_ON_HEADER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_FrameHd),
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.c_uint8, ctypes.c_void_p)
_ON_DATA_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_void_p)
_ON_FRAME_RECV_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_FrameHd), ctypes.c_void_p)
_ON_STREAM_CLOSE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32,
    ctypes.c_void_p)

if _lib is not None:
    _lib.nghttp2_session_callbacks_new.argtypes = [
        ctypes.POINTER(ctypes.c_void_p)]
    _lib.nghttp2_session_callbacks_del.argtypes = [ctypes.c_void_p]
    for setter in ("on_header_callback", "on_data_chunk_recv_callback",
                   "on_frame_recv_callback", "on_stream_close_callback"):
        fn = getattr(_lib, f"nghttp2_session_callbacks_set_{setter}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _lib.nghttp2_session_client_new.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    _lib.nghttp2_session_server_new.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    _lib.nghttp2_session_del.argtypes = [ctypes.c_void_p]
    _lib.nghttp2_session_mem_recv.restype = _ssize_t
    _lib.nghttp2_session_mem_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    _lib.nghttp2_session_mem_send.restype = _ssize_t
    _lib.nghttp2_session_mem_send.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    _lib.nghttp2_session_want_read.argtypes = [ctypes.c_void_p]
    _lib.nghttp2_session_want_write.argtypes = [ctypes.c_void_p]
    _lib.nghttp2_submit_settings.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.POINTER(_SettingsEntry),
        ctypes.c_size_t]
    _lib.nghttp2_submit_request.restype = ctypes.c_int32
    _lib.nghttp2_submit_request.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_NV),
        ctypes.c_size_t, ctypes.POINTER(_DataProvider), ctypes.c_void_p]
    _lib.nghttp2_submit_response.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(_NV),
        ctypes.c_size_t, ctypes.POINTER(_DataProvider)]
    _lib.nghttp2_submit_window_update.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32, ctypes.c_int32]
    _lib.nghttp2_submit_rst_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32, ctypes.c_uint32]
    _lib.nghttp2_strerror.restype = ctypes.c_char_p
    _lib.nghttp2_strerror.argtypes = [ctypes.c_int]


class H2Error(ConnectionError):
    pass


class H2StreamError(H2Error):
    """A single stream failed (e.g. RST_STREAM); the CONNECTION is still
    healthy — callers should not tear the session down for this."""


class H2ResetStream(Exception):
    """Raised by a server handler to RST_STREAM the current request
    instead of answering it (the client sees H2StreamError while the
    connection stays up).  ``error_code`` is the h2 error code sent."""

    def __init__(self, error_code: int = 0x2):       # INTERNAL_ERROR
        super().__init__(f"reset stream (error {error_code})")
        self.error_code = error_code


def read_h1_head(sock, initial: bytes = b"") -> tuple[str, dict, bytes]:
    """Read one HTTP/1.1 message head off ``sock``: returns
    ``(first_line, {lower-name: value}, leftover_bytes)``.  Shared by
    the client's upgrade exchange and the test bridge so both ends
    parse framing identically."""
    buf = initial
    while b"\r\n\r\n" not in buf:
        got = sock.recv(65536)
        if not got:
            raise ConnectionError("connection closed reading HTTP head")
        buf += got
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin1").split("\r\n")
    headers: dict[str, str] = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers, rest


def _err(rv: int) -> str:
    try:
        return _lib.nghttp2_strerror(int(rv)).decode()
    except Exception:
        return str(rv)


def _make_nva(headers: list[tuple[bytes, bytes]]):
    """Build an nghttp2_nv array; returns (array, keepalive buffers)."""
    arr = (_NV * len(headers))()
    keep = []
    for i, (name, value) in enumerate(headers):
        nb = ctypes.create_string_buffer(name, len(name))
        vb = ctypes.create_string_buffer(value, len(value))
        keep += [nb, vb]
        arr[i].name = ctypes.cast(nb, ctypes.POINTER(ctypes.c_uint8))
        arr[i].value = ctypes.cast(vb, ctypes.POINTER(ctypes.c_uint8))
        arr[i].namelen = len(name)
        arr[i].valuelen = len(value)
        arr[i].flags = NGHTTP2_NV_FLAG_NONE
    return arr, keep


@dataclass
class _Stream:
    headers: dict[str, str] = field(default_factory=dict)
    body: bytearray = field(default_factory=bytearray)
    ended: bool = False          # END_STREAM seen (request fully received)
    closed: bool = False
    error: int = 0


class _SessionBase:
    """Shared pump: socket IO ↔ nghttp2 memory API."""

    RECV_CHUNK = 1 << 16

    def __init__(self, sock: socket.socket):
        if _lib is None:
            raise H2Error("libnghttp2 not available")
        self.sock = sock
        self.streams: dict[int, _Stream] = {}
        self._session = ctypes.c_void_p()
        self._send_body: dict[int, tuple[bytes, int]] = {}
        self._keep: list = []          # ctypes objects that must outlive us
        self._closed = False
        self._cbs = ctypes.c_void_p()
        rv = _lib.nghttp2_session_callbacks_new(ctypes.byref(self._cbs))
        if rv:
            raise H2Error(f"callbacks_new: {_err(rv)}")

        @_ON_HEADER_CB
        def on_header(sess, frame, name, namelen, value, valuelen, flags, ud):
            sid = frame.contents.stream_id
            st = self.streams.setdefault(sid, _Stream())
            st.headers[ctypes.string_at(name, namelen).decode("latin1")] = \
                ctypes.string_at(value, valuelen).decode("latin1")
            return 0

        @_ON_DATA_CB
        def on_data(sess, flags, sid, data, length, ud):
            st = self.streams.setdefault(sid, _Stream())
            st.body += ctypes.string_at(data, length)
            return 0

        @_ON_FRAME_RECV_CB
        def on_frame(sess, frame, ud):
            hd = frame.contents
            if hd.type in (NGHTTP2_FRAME_DATA, NGHTTP2_FRAME_HEADERS) \
                    and hd.flags & NGHTTP2_FLAG_END_STREAM:
                self.streams.setdefault(hd.stream_id, _Stream()).ended = True
            return 0

        @_ON_STREAM_CLOSE_CB
        def on_close(sess, sid, error_code, ud):
            # only mark existing entries (the client's request loop owns
            # its entry); never resurrect popped ones — a long-lived
            # server connection must not accrete ghost streams
            st = self.streams.get(sid)
            if st is not None:
                st.closed, st.error = True, error_code
            self._send_body.pop(sid, None)     # response body fully sent
            return 0

        self._keep += [on_header, on_data, on_frame, on_close]
        _lib.nghttp2_session_callbacks_set_on_header_callback(
            self._cbs, ctypes.cast(on_header, ctypes.c_void_p))
        _lib.nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
            self._cbs, ctypes.cast(on_data, ctypes.c_void_p))
        _lib.nghttp2_session_callbacks_set_on_frame_recv_callback(
            self._cbs, ctypes.cast(on_frame, ctypes.c_void_p))
        _lib.nghttp2_session_callbacks_set_on_stream_close_callback(
            self._cbs, ctypes.cast(on_close, ctypes.c_void_p))

        @_DATA_READ_CB
        def read_body(sess, sid, buf, length, data_flags, source, ud):
            body, off = self._send_body.get(sid, (b"", 0))
            n = min(length, len(body) - off)
            if n > 0:
                ctypes.memmove(buf, body[off:off + n], n)
            off += n
            self._send_body[sid] = (body, off)
            if off >= len(body):
                data_flags[0] = NGHTTP2_DATA_FLAG_EOF
            return n

        self._keep.append(read_body)
        self._read_body_cb = read_body
        self._new_session()
        # bigger stream/connection windows: chunk uploads are ~1-4 MiB
        entries = (_SettingsEntry * 2)(
            _SettingsEntry(NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 128),
            _SettingsEntry(NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE, 1 << 20))
        rv = _lib.nghttp2_submit_settings(self._session, 0, entries, 2)
        if rv:
            raise H2Error(f"submit_settings: {_err(rv)}")
        _lib.nghttp2_submit_window_update(self._session, 0, 0,
                                          (1 << 20) - 65535)

    def _new_session(self) -> None:
        raise NotImplementedError

    # -- pump -------------------------------------------------------------
    def _flush_send(self) -> None:
        while True:
            buf = ctypes.POINTER(ctypes.c_uint8)()
            n = _lib.nghttp2_session_mem_send(self._session,
                                              ctypes.byref(buf))
            if n < 0:
                raise H2Error(f"mem_send: {_err(n)}")
            if n == 0:
                return
            self.sock.sendall(ctypes.string_at(buf, n))

    def _recv_some(self) -> bool:
        """One socket read fed to nghttp2; False on EOF."""
        data = self.sock.recv(self.RECV_CHUNK)
        if not data:
            return False
        n = _lib.nghttp2_session_mem_recv(self._session, data, len(data))
        if n < 0:
            raise H2Error(f"mem_recv: {_err(n)}")
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass
        if self._session:
            _lib.nghttp2_session_del(self._session)
            self._session = ctypes.c_void_p()
        if self._cbs:
            _lib.nghttp2_session_callbacks_del(self._cbs)
            self._cbs = ctypes.c_void_p()

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        # finalizer during interpreter teardown: the logging stack may
        # already be gone, so this one stays dark by design
        except Exception:   # pbslint: disable=no-silent-swallow
            pass


class H2ClientSession(_SessionBase):
    """Blocking h2 client over an established (post-101) socket.
    ``request()`` is serialized with a lock — the PBS writer protocol is
    sequential per session.

    ``initial_data``: bytes already read off the socket past the 101
    response head (the server's h2 SETTINGS may ride the same segment);
    they are fed to nghttp2 before the first socket read — dropping
    them would poison the whole connection (first frame from the server
    must be SETTINGS)."""

    def __init__(self, sock: socket.socket, *, initial_data: bytes = b""):
        self._lock = threading.Lock()
        super().__init__(sock)
        if initial_data:
            n = _lib.nghttp2_session_mem_recv(self._session, initial_data,
                                              len(initial_data))
            if n < 0:
                raise H2Error(f"mem_recv(initial): {_err(n)}")

    def _new_session(self) -> None:
        rv = _lib.nghttp2_session_client_new(
            ctypes.byref(self._session), self._cbs, None)
        if rv:
            raise H2Error(f"client_new: {_err(rv)}")

    def request(self, method: str, path: str,
                headers: dict[str, str] | None = None,
                body: bytes | None = None, *,
                authority: str = "localhost",
                scheme: str = "https") -> tuple[int, dict[str, str], bytes]:
        with self._lock:
            if self._closed:
                raise H2Error("h2 session closed")
            nv = [(b":method", method.encode()),
                  (b":path", path.encode()),
                  (b":scheme", scheme.encode()),
                  (b":authority", authority.encode())]
            for k, v in (headers or {}).items():
                nv.append((k.lower().encode(), str(v).encode()))
            arr, keep = _make_nva(nv)
            dp = None
            if body:
                dp = _DataProvider()
                dp.read_callback = self._read_body_cb
            sid = _lib.nghttp2_submit_request(
                self._session, None, arr, len(nv),
                ctypes.byref(dp) if dp is not None else None, None)
            del keep
            if sid < 0:
                raise H2Error(f"submit_request: {_err(sid)}")
            if body:
                self._send_body[sid] = (bytes(body), 0)
            self.streams[sid] = _Stream()
            try:
                self._flush_send()
                while not self.streams[sid].closed:
                    if not self._recv_some():
                        raise H2Error("connection closed mid-stream")
                    self._flush_send()
            except BaseException:
                # a half-pumped stream leaves nghttp2's state unknowable
                # — poison the session so the owner re-dials instead of
                # stalling on deferred DATA for the aborted stream
                self.close()
                raise
            finally:
                self._send_body.pop(sid, None)
                st = self.streams.pop(sid, None)
            if st is None:
                raise H2Error("stream state lost")
            if st.error:
                raise H2StreamError(f"stream error {st.error}")
            status = int(st.headers.get(":status", "0"))
            return status, st.headers, bytes(st.body)


# handler(method, path_with_query, headers, body) -> (status, headers, body)
Handler = "Callable[[str, str, dict, bytes], tuple[int, dict, bytes]]"


class H2ServerSession(_SessionBase):
    """Blocking h2 server side of one connection: dispatches every
    request stream to ``handler`` until the peer disconnects."""

    def __init__(self, sock: socket.socket, handler):
        self.handler = handler
        super().__init__(sock)

    def _new_session(self) -> None:
        rv = _lib.nghttp2_session_server_new(
            ctypes.byref(self._session), self._cbs, None)
        if rv:
            raise H2Error(f"server_new: {_err(rv)}")

    def serve(self) -> None:
        try:
            self._flush_send()
            while True:
                if not self._recv_some():
                    return
                # answer every fully-received request stream
                for sid, st in list(self.streams.items()):
                    if st.ended and not st.closed:
                        self._respond(sid, st)
                        self.streams.pop(sid, None)
                self._flush_send()
        except (OSError, H2Error):
            return
        finally:
            self.close()

    def _respond(self, sid: int, st: _Stream) -> None:
        method = st.headers.get(":method", "GET")
        path = st.headers.get(":path", "/")
        plain = {k: v for k, v in st.headers.items()
                 if not k.startswith(":")}
        try:
            status, hdrs, body = self.handler(method, path, plain,
                                              bytes(st.body))
        except H2ResetStream as rst:    # per-stream failure, session lives
            rv = _lib.nghttp2_submit_rst_stream(
                self._session, 0, sid, rst.error_code)
            if rv:
                raise H2Error(f"submit_rst_stream: {_err(rv)}")
            return
        except Exception as e:      # handler crash → 500, keep serving
            status, hdrs, body = 500, {"content-type": "text/plain"}, \
                str(e).encode()
        nv = [(b":status", str(status).encode())]
        for k, v in hdrs.items():
            nv.append((k.lower().encode(), str(v).encode()))
        arr, keep = _make_nva(nv)
        dp = None
        if body:
            dp = _DataProvider()
            dp.read_callback = self._read_body_cb
            self._send_body[sid] = (bytes(body), 0)
        rv = _lib.nghttp2_submit_response(
            self._session, sid, arr, len(nv),
            ctypes.byref(dp) if dp is not None else None)
        del keep
        if rv:
            raise H2Error(f"submit_response: {_err(rv)}")
