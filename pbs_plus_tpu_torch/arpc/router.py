"""Method router with per-stream tasks and panic containment.

Reference: internal/arpc/router.go:20-86 (method→handler map, per-stream
goroutine, recover()), internal/arpc/pipe.go:222-231 (serve recover).

A copy of the JAX package's ``arpc/router.py``, its code byte for byte
apart from its imports, which name the port's own modules, and its
logger (``logging``).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
from typing import Any, Awaitable, Callable

from ..utils import trace
from .call import (
    RawStreamHandler, Request, Response, STATUS_ERROR, STATUS_NOT_FOUND,
    STATUS_RAW_STREAM, read_envelope, _READY, _ACK,
)
from .mux import MuxConnection, MuxError, MuxStream

L = logging.getLogger(__name__)

Handler = Callable[..., Awaitable[Any]]


class HandlerError(RuntimeError):
    """Raise inside a handler to control the response status/message."""

    def __init__(self, message: str, status: int = STATUS_ERROR):
        super().__init__(message)
        self.status = status


class Router:
    def __init__(self) -> None:
        self._handlers: dict[str, Handler] = {}

    def handle(self, method: str, fn: Handler | None = None):
        """Register a handler: ``router.handle("ping", fn)`` or decorator.
        Handler signature: ``async def fn(request, context) -> Any`` —
        return value becomes Response.data; return a Response for full
        control; return a RawStreamHandler to upgrade (status 213)."""
        if fn is None:
            def deco(f: Handler) -> Handler:
                self._handlers[method] = f
                return f
            return deco
        self._handlers[method] = fn
        return fn

    def methods(self) -> list[str]:
        return sorted(self._handlers)

    async def serve_connection(self, conn: MuxConnection,
                               context: Any = None) -> None:
        """Accept streams until the connection dies; one task per stream."""
        tasks: set[asyncio.Task] = set()
        try:
            while True:
                st = await conn.accept_stream()
                if st is None:
                    return
                t = asyncio.create_task(self._serve_stream(st, context))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)

    async def _serve_stream(self, st: MuxStream, context: Any) -> None:
        try:
            req = Request.from_wire(await read_envelope(st))
            fn = self._handlers.get(req.method)
            if fn is None:
                await st.write(Response(
                    STATUS_NOT_FOUND, f"unknown method {req.method!r}").encode())
                return
            # re-attach the caller's trace context from the call
            # metadata: handler-side spans (including a remote peer's —
            # agent work under a server job) parent under the caller
            tctx = trace.parse_header(req.headers.get(trace.TRACE_HEADER))
            with trace.attached(tctx), \
                    trace.span("rpc.serve", method=req.method):
                try:
                    result = fn(req, context)
                    if inspect.isawaitable(result):
                        result = await result
                except HandlerError as e:
                    await st.write(Response(e.status, str(e)).encode())
                    return
                except Exception as e:          # panic containment
                    L.exception("handler %s crashed", req.method)
                    await st.write(Response(
                        STATUS_ERROR, f"{type(e).__name__}: {e}").encode())
                    return
                if isinstance(result, RawStreamHandler):
                    await st.write(Response(STATUS_RAW_STREAM,
                                            data=result.data).encode())
                    await st.write(_READY)
                    ack = await st.readexactly(1)
                    if ack != _ACK:
                        raise MuxError("raw-stream ack mismatch")
                    await result.fn(st)
                elif isinstance(result, Response):
                    await st.write(result.encode())
                else:
                    await st.write(Response(data=result).encode())
        except (MuxError, ConnectionError):
            pass                            # stream/conn died mid-RPC
        except asyncio.CancelledError:
            raise
        except Exception:
            L.exception("stream serve crashed")
        finally:
            try:
                await st.close()
            except Exception as e:
                L.debug("stream close after serve: %s", e)
