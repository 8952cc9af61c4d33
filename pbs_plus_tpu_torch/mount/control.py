"""Mount control socket + monitor hub.

Reference: internal/pxarmount/commit_listener.go:16-113 (newline KV
protocol on a unix socket driving commits) and monitor.go:16-121 (hub
broadcasting progress lines to subscribers).

Protocol (newline-delimited):
    client → "commit\n"                 run a commit; progress lines stream
    client → "status\n"                 one-line stats
    client → "monitor\n"                subscribe to progress broadcasts
    server → "phase=<p> key=val ...\n"  progress
    server → "ok snapshot=<ref>\n" | "err <message>\n"

A copy of the JAX package's ``mount/control.py``, its code byte for byte
apart from its imports, which name the port's own ``CommitEngine``; it
logs through ``logging``.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from .commit import CommitEngine

L = logging.getLogger(__name__)


class MountControl:
    def __init__(self, engine: CommitEngine, socket_path: str):
        self.engine = engine
        self.socket_path = socket_path
        self._server: Optional[asyncio.AbstractServer] = None
        self._monitors: set[asyncio.StreamWriter] = set()
        self._commit_lock = asyncio.Lock()
        engine.progress.listeners.append(self._on_progress)
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def _on_progress(self, phase: str, info: dict) -> None:
        line = f"phase={phase} " + " ".join(
            f"{k}={v}" for k, v in sorted(info.items())) + "\n"
        loop = self._loop
        if loop is None:
            return
        loop.call_soon_threadsafe(self._broadcast, line)

    def _broadcast(self, line: str) -> None:
        dead = []
        for w in self._monitors:
            try:
                w.write(line.encode())
            except Exception:
                dead.append(w)
        for w in dead:
            self._monitors.discard(w)

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        os.makedirs(os.path.dirname(self.socket_path) or ".", exist_ok=True)
        self._server = await asyncio.start_unix_server(
            self._client, self.socket_path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for w in list(self._monitors):
            w.close()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                cmd = line.decode().strip()
                if cmd == "commit":
                    await self._do_commit(writer)
                elif cmd == "status":
                    p = self.engine.progress
                    writer.write(
                        f"phase={p.phase} entries={p.entries} "
                        f"refs={p.ref_files} changed={p.changed_files} "
                        f"snapshot={p.snapshot}\n".encode())
                    await writer.drain()
                elif cmd == "monitor":
                    self._monitors.add(writer)
                    await writer.drain()
                elif cmd in ("quit", "exit"):
                    return
                else:
                    writer.write(f"err unknown command {cmd!r}\n".encode())
                    await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._monitors.discard(writer)
            writer.close()

    async def _do_commit(self, writer: asyncio.StreamWriter) -> None:
        # explicit busy flag: the check-and-set happens with no awaits in
        # between, so concurrent "commit" commands cannot both pass
        if self._commit_lock.locked():
            writer.write(b"err commit already running\n")
            await writer.drain()
            return
        async with self._commit_lock:
            try:
                ref = await asyncio.get_running_loop().run_in_executor(
                    None, self.engine.commit)
                writer.write(f"ok snapshot={ref}\n".encode())
            except Exception as e:
                L.exception("commit via control socket failed")
                writer.write(f"err {e}\n".encode())
            await writer.drain()


async def commit_via_socket(socket_path: str, *, timeout: float = 600.0) -> str:
    """Client side of the ``commit`` subcommand."""
    reader, writer = await asyncio.open_unix_connection(socket_path)
    try:
        writer.write(b"commit\n")
        await writer.drain()
        while True:
            line = (await asyncio.wait_for(reader.readline(), timeout)).decode()
            if not line:
                raise ConnectionError("control socket closed mid-commit")
            if line.startswith("ok "):
                return line.split("snapshot=", 1)[1].strip()
            if line.startswith("err "):
                raise RuntimeError(line[4:].strip())
            # progress line — ignore/print
    finally:
        writer.close()
