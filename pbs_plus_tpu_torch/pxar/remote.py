"""Remote archive access protocol: the server exposes a SplitReader over
aRPC for agent-side restores.

Reference: internal/pxar/remote.go:26-310 (RemoteServer handlers
GetRoot/LookupByPath/ReadDir/GetAttr/ReadContent/ReadContentAt/
CloseContent/ReadLink/ListXAttrs/Error/Done) and internal/pxar/client.go
(the agent-side client; hot loop ReadContentAt → raw binary streams,
SURVEY §3.3).

Methods:
    pxar.root        {}                    → root entry
    pxar.lookup      {path}                → entry | 404
    pxar.read_dir    {path}                → {entries: [...]}
    pxar.read_link   {path}                → {target}
    pxar.read_at     {path, off, n}        → 213 raw stream
    pxar.stats       {}                    → reader cache stats
    pxar.done        {}                    → server may tear down

A copy of the JAX package's ``pxar/remote.py``, its code byte for
byte; it serves and calls over the port's aRPC router, calls and
binary stream, so either package's client reads either package's
server.
"""

from __future__ import annotations

from ..arpc.binary_stream import send_data_from_reader
from ..arpc.call import RawStreamHandler
from ..arpc.router import HandlerError, Router
from .format import Entry
from .transfer import SplitReader

MAX_READ = 32 << 20


class RemoteArchiveServer:
    """Serves one snapshot's SplitReader on a job-session router."""

    def __init__(self, reader: SplitReader, *, subpath: str = ""):
        self.reader = reader
        self.subpath = subpath.strip("/")
        self.done = False

    def _rel(self, path: str) -> str:
        path = path.strip("/")
        if self.subpath:
            return f"{self.subpath}/{path}" if path else self.subpath
        return path

    def _strip(self, path: str) -> str:
        if self.subpath:
            if path == self.subpath:
                return ""
            return path[len(self.subpath) + 1:]
        return path

    def register(self, router: Router) -> None:
        router.handle("pxar.root", self._root)
        router.handle("pxar.lookup", self._lookup)
        router.handle("pxar.read_dir", self._read_dir)
        router.handle("pxar.read_link", self._read_link)
        router.handle("pxar.read_at", self._read_at)
        router.handle("pxar.stats", self._stats)
        router.handle("pxar.done", self._done)

    def _entry_or_404(self, path: str) -> Entry:
        e = self.reader.lookup(self._rel(path))
        if e is None:
            raise HandlerError(f"no such entry {path!r}", status=404)
        return e

    def _wire(self, e: Entry) -> dict:
        d = e.to_wire()
        d["p"] = self._strip(e.path)
        return d

    async def _root(self, req, ctx):
        return self._wire(self._entry_or_404(""))

    async def _lookup(self, req, ctx):
        return self._wire(self._entry_or_404(req.payload["path"]))

    async def _read_dir(self, req, ctx):
        rel = self._rel(req.payload["path"])
        try:
            entries = self.reader.read_dir(rel)
        except FileNotFoundError:
            raise HandlerError(f"no such dir {rel!r}", status=404)
        return {"entries": [self._wire(e) for e in entries]}

    async def _read_link(self, req, ctx):
        e = self._entry_or_404(req.payload["path"])
        return {"target": e.link_target}

    async def _read_at(self, req, ctx):
        e = self._entry_or_404(req.payload["path"])
        off = int(req.payload["off"])
        n = int(req.payload["n"])
        if n < 0 or n > MAX_READ:
            raise HandlerError(f"read size {n} out of range", status=400)
        # chunk-aligned pump through the shared chunk cache: the range is
        # never materialized whole, and agents reading a file in small
        # windows decompress each underlying chunk once, not once per
        # window (docs/data-plane.md "Read path")
        rdr, size = self.reader.file_reader(e, off, n)

        async def pump(stream):
            await send_data_from_reader(stream, rdr, size)
        return RawStreamHandler(pump, data={"n": size})

    async def _stats(self, req, ctx):
        hits, misses = self.reader.cache_stats
        return {"cache_hits": hits, "cache_misses": misses}

    async def _done(self, req, ctx):
        self.done = True
        return {"ok": True}


class RemoteArchiveClient:
    """Agent-side client of the protocol (reference: internal/pxar/client.go)."""

    def __init__(self, session):
        self.s = session

    async def root(self) -> Entry:
        return Entry.from_wire((await self.s.call("pxar.root")).data)

    async def lookup(self, path: str) -> Entry | None:
        from ..arpc.call import CallError
        try:
            return Entry.from_wire(
                (await self.s.call("pxar.lookup", {"path": path})).data)
        except CallError as e:
            if e.response.status == 404:
                return None
            raise

    async def read_dir(self, path: str) -> list[Entry]:
        resp = await self.s.call("pxar.read_dir", {"path": path})
        return [Entry.from_wire(d) for d in resp.data["entries"]]

    async def read_at(self, path: str, off: int, n: int) -> bytes:
        buf = bytearray()
        await self.s.call_binary_into(
            "pxar.read_at", {"path": path, "off": off, "n": n}, buf)
        return bytes(buf)

    async def done(self) -> None:
        await self.s.call("pxar.done")
