"""S3 targets: sigv4 client + the S3 tree backup source.

Reference: internal/server/vfs/s3fs (minio-go backed FUSE for read-only S3
backup sources, fs.go:32-379).  Here the S3 object tree is walked directly
by the archive writer (same no-FUSE shortcut as agent backups): keys map
to archive paths, '/' separators become directories, ranged GETs stream
content.

The client is a self-contained AWS SigV4 implementation over aiohttp
(no SDK in this image): list-objects-v2 pagination, HEAD, ranged GET.

A copy of the JAX package's ``server/s3.py``, its code byte for byte
apart from its imports, which name the port's own modules.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import hashlib
import hmac
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import AsyncIterator, Optional


_EMPTY_SHA = hashlib.sha256(b"").hexdigest()


@dataclass(frozen=True)
class S3Config:
    endpoint: str                 # http(s)://host:port
    bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    prefix: str = ""              # only back up keys under this prefix


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    def __init__(self, http, cfg: S3Config):
        self.http = http              # aiohttp.ClientSession
        self.cfg = cfg
        u = urllib.parse.urlparse(cfg.endpoint)
        self.host = u.netloc
        self.scheme = u.scheme or "http"

    def _headers(self, method: str, path: str, query: dict[str, str],
                 extra: dict[str, str] | None = None) -> dict[str, str]:
        """AWS SigV4 (path-style addressing)."""
        now = dt.datetime.now(dt.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        canonical_uri = urllib.parse.quote(path, safe="/")
        qs = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(query.items()))
        headers = {"host": self.host, "x-amz-date": amz_date,
                   "x-amz-content-sha256": _EMPTY_SHA}
        if extra:
            headers.update({k.lower(): v for k, v in extra.items()})
        signed = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in sorted(headers))
        creq = "\n".join([method, canonical_uri, qs, canonical_headers,
                          signed, _EMPTY_SHA])
        scope = f"{datestamp}/{self.cfg.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        k = _sign(("AWS4" + self.cfg.secret_key).encode(), datestamp)
        k = _sign(k, self.cfg.region)
        k = _sign(k, "s3")
        k = _sign(k, "aws4_request")
        sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.cfg.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")
        return headers

    def _url(self, path: str, query: dict[str, str]) -> str:
        qs = urllib.parse.urlencode(sorted(query.items()))
        return f"{self.scheme}://{self.host}{urllib.parse.quote(path, safe='/')}" + \
            (f"?{qs}" if qs else "")

    async def list_objects(self) -> AsyncIterator[dict]:
        """Paginated list-objects-v2 under cfg.prefix."""
        token: Optional[str] = None
        while True:
            q = {"list-type": "2", "max-keys": "1000"}
            if self.cfg.prefix:
                q["prefix"] = self.cfg.prefix
            if token:
                q["continuation-token"] = token
            path = f"/{self.cfg.bucket}"
            async with self.http.get(
                    self._url(path, q),
                    headers=self._headers("GET", path, q)) as r:
                if r.status != 200:
                    raise IOError(f"list-objects failed: {r.status} "
                                  f"{await r.text()}")
                body = await r.text()
            ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
            root = ET.fromstring(body)

            def f(el, name):
                x = el.find(f"s3:{name}", ns)
                if x is None:
                    x = el.find(name)
                return x
            for c in root.iter():
                if c.tag.endswith("Contents"):
                    key = f(c, "Key").text
                    size = int(f(c, "Size").text)
                    yield {"key": key, "size": size}
            trunc = f(root, "IsTruncated")
            if trunc is not None and trunc.text == "true":
                tok = f(root, "NextContinuationToken")
                token = tok.text if tok is not None else None
                if token is None:
                    return
            else:
                return

    async def get_range(self, key: str, start: int, length: int) -> bytes:
        path = f"/{self.cfg.bucket}/{key}"
        extra = {"range": f"bytes={start}-{start + length - 1}"}
        async with self.http.get(
                self._url(path, {}),
                headers=self._headers("GET", path, {}, extra)) as r:
            if r.status not in (200, 206):
                raise IOError(f"get {key} failed: {r.status}")
            return await r.read()


async def backup_s3_tree(client: S3Client, session, *,
                         exclusions: list[str] | None = None,
                         counters: dict | None = None) -> int:
    """Walk an S3 bucket (prefix) into a BackupSession — keys become
    archive paths, '/'-separated components become directories.
    Returns entries written; ``counters`` accumulates files/bytes.
    Exclusions use the one shared semantic (backup_job.match_exclusion),
    identical across agent/local/s3 target kinds."""
    import queue as _q
    import threading

    from ..pxar.format import Entry, KIND_DIR, KIND_FILE
    from .backup_job import _QueuePumpReader, _SENTINEL, match_exclusion

    objects = []
    async for o in client.list_objects():
        key = o["key"]
        rel = key[len(client.cfg.prefix):].lstrip("/") if client.cfg.prefix \
            else key
        if not rel or rel.endswith("/"):
            continue
        if exclusions and match_exclusion(rel, exclusions):
            continue
        objects.append((rel, key, o["size"]))
    objects.sort(key=lambda x: tuple(x[0].split("/")))

    w = session.writer
    w.write_entry(Entry(path="", kind=KIND_DIR, mode=0o755))
    n = 1
    emitted_dirs: set[str] = set()
    for rel, key, size in objects:
        parts = rel.split("/")
        for i in range(1, len(parts)):
            d = "/".join(parts[:i])
            if d not in emitted_dirs:
                w.write_entry(Entry(path=d, kind=KIND_DIR, mode=0o755))
                emitted_dirs.add(d)
                n += 1
        # stream the object through a pump queue (async fetch, sync writer).
        # All queue ops from the event-loop side go through the executor: a
        # blocking fq.put/t.join on the loop thread would freeze keepalives,
        # the web API, and every other job (advisor finding r1).
        fq: _q.Queue = _q.Queue(maxsize=4)
        exc: list[BaseException] = []
        reader = _QueuePumpReader(fq)
        loop = asyncio.get_running_loop()

        def writer_thread(entry=Entry(path=rel, kind=KIND_FILE, mode=0o644)):
            try:
                w.write_entry_reader(entry, reader)
            except BaseException as e:
                exc.append(e)
                reader.dead = True      # producer stops fetching
                if not reader._eof:     # sentinel not yet consumed
                    while fq.get() is not _SENTINEL:   # unblock producer
                        pass

        t = threading.Thread(target=writer_thread, daemon=True)
        t.start()
        off = 0
        try:
            while off < size:
                if reader.dead:
                    break
                block = await client.get_range(key, off, min(8 << 20,
                                                             size - off))
                if not block:
                    break
                await loop.run_in_executor(None, fq.put, block)
                off += len(block)
        finally:
            await loop.run_in_executor(None, fq.put, _SENTINEL)
            await loop.run_in_executor(None, t.join)
        if exc:
            raise exc[0]
        if counters is not None:
            counters["files"] = counters.get("files", 0) + 1
            counters["bytes"] = counters.get("bytes", 0) + size
        n += 1
    return n
