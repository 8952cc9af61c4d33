"""Distributed chunk index, service half: a consistent-hash-sharded
digest space served by N index processes, probed with batched
scatter/gather fan-out.

Counterpart of the service half of the JAX package's
``parallel/dist_index.py``, on the same wire: paths under
``/distidx/v1``, the bearer token, the request and reply bodies and the
``ShardMap`` bytes are the reference's, so a JAX ``DistIndexClient``
drives the port's shard nodes and the port's client drives JAX nodes.
The shard nodes hold the port's ``DedupIndex``, which probes with K3 on
the card when its device is CUDA.

- **ShardMap** -- a consistent-hash ring over the digest space (virtual
  points per shard), snapshotted with the tmp+rename + sha256-trailer
  discipline; a corrupt/truncated map degrades to a full re-read of
  shard epochs over the wire, never a wrong routing table.
- **IndexShardServer** -- one shard: a ``DedupIndex`` served over HTTP.
  Writes are ownership-FENCED by the installed map: stale-routed
  inserts/discards are rejected and the client re-routes, so a
  rebalance can never strand a write on a shard about to retire it.
  Handler threads share the index; its lock serializes their probes.
- **DistIndexClient** -- the ``probe_batch``/``insert_many``/
  ``discard_many`` membership surface: each batch is split by shard
  owner, ONE request per shard per batch goes out over persistent
  connections (concurrently), and one verdict vector is regathered
  through a permutation index.
- **Rebalance** -- membership change ships the immutable checksummed
  digestlog segments VERBATIM (fence everywhere first, then export ->
  verify -> adopt -> retire); every hop re-verifies the sha256 trailer.

Failure direction everywhere: an unreachable shard answers False (safe
false negative) and a discard without an ack leaves the chunk file on
disk -- never a false dedup skip, never a resurrected digest.

The device half (``_probe_local``, ``probe_row``, ``ShardedCuckooIndex``)
splits one cuckoo table over the ``index`` axis of a device mesh
(``parallel/mesh.py``): each index device probes its own row range, and
the partial hits are summed onto one device (``collectives.psum``).
``python -m pbs_plus_tpu_torch index-shard`` (or ``python -m
pbs_plus_tpu_torch.parallel.dist_index``) runs one shard node.
"""

from __future__ import annotations

import logging
import base64
import hashlib
import hmac
import http.client
import json
import os
import socket
import struct
import threading
import urllib.parse
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from ..ops.cuckoo import SLOTS, CuckooIndex, _fingerprint_buckets
from ..pxar.digestlog import parse_segment_bytes
from ..utils import atomicio, fswitness
from ..utils.device import host_tensor, resolve
from .collectives import psum, to_device
from .mesh import Mesh

L = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# device half: a cuckoo table sharded over a mesh's index axis
# ---------------------------------------------------------------------------

# calls of ``_probe_local`` (one per index shard of a probe), on any device
stats = {"probe_local": 0}


def _probe_local(table_shard: torch.Tensor, digests: torch.Tensor,
                 n_buckets: int, base: int) -> torch.Tensor:
    """table_shard int64[NB/ni, SLOTS]: rows ``base`` up to
    ``base + NB/ni`` of an ``n_buckets`` table (``CuckooIndex``'s slots as
    one int64 each); digests uint8[N, 32] on the same device -> partial
    hits bool[N], True where a bucket of the digest lies in this shard
    and holds its fingerprint.  The caller sums the partial hits of all
    shards (``collectives.psum``)."""
    stats["probe_local"] += 1
    rows = table_shard.shape[0]
    fpc, b1, b2 = _fingerprint_buckets(digests, n_buckets)

    def check(b):
        local = b - base
        in_range = (local >= 0) & (local < rows)
        got = table_shard[local.clamp(0, rows - 1)]
        return (got == fpc[:, None]).any(dim=1) & in_range

    return check(b1) | check(b2)


def probe_row(mesh: Mesh, tables: np.ndarray, digests: torch.Tensor,
              n_buckets: int, *, row: dict | None = None,
              index_axis: str = "index") -> torch.Tensor:
    """The index-sharded probe of one mesh row: ``digests`` uint8[N, 32]
    go to each ``index_axis`` device of the row at coordinates ``row``
    (every other axis at 0), each probes its row range of ``tables`` (a
    ``shard_table``), and the partial hits are summed onto the row's
    first device -> bool[N] there."""
    row = row or {}
    ni = mesh.shape[index_axis]
    rows = n_buckets // ni
    parts = []
    for k in range(ni):
        pos = mesh.position(**row, **{index_axis: k})
        parts.append(_probe_local(tables[pos],
                                  to_device(digests, mesh.devices[pos]),
                                  n_buckets, k * rows).to(torch.int32))
    return psum(parts, mesh.devices[mesh.position(**row)]) > 0


def shard_table(mesh: Mesh, table: np.ndarray, axis_name: str = "index"
                ) -> np.ndarray:
    """A host mirror uint32[NB, SLOTS, 2] placed over ``mesh``: an object
    array of the mesh's shape whose element at each position is the
    int64[NB/ni, SLOTS] row range of that position's ``axis_name`` index
    on its device (one upload per row range and device; a repeated
    device holds one copy)."""
    ni = mesh.shape[axis_name]
    nb = table.shape[0]
    if nb % ni:
        raise ValueError("n_buckets must divide by index-axis size")
    rows = nb // ni
    t64 = np.ascontiguousarray(table).view(np.int64).reshape(nb, SLOTS)
    axis = mesh.axis_names.index(axis_name)
    out = np.empty(mesh.devices.shape, dtype=object)
    placed: dict = {}
    for pos, dev in np.ndenumerate(mesh.devices):
        k = pos[axis]
        if (k, dev) not in placed:
            # a copy: the mirror keeps changing under later inserts
            placed[(k, dev)] = torch.from_numpy(
                t64[k * rows:(k + 1) * rows].copy()).to(dev)
        out[pos] = placed[(k, dev)]
    return out


class ShardedCuckooIndex:
    """Host-authoritative cuckoo index whose device table shards over the
    ``index`` axis of a mesh.  Inserts mutate the host mirror, a port
    ``CuckooIndex`` (so inserts and evictions stay byte-identical to the
    reference's); ``device_table`` re-places the whole table after a
    change, as the reference does.  ``device`` is where ``probe``
    gathers its verdicts (default: the mesh's first device)."""

    def __init__(self, mesh: Mesh, *, axis_name: str = "index",
                 n_buckets: int = 1 << 16, seed: int = 0, device=None):
        if n_buckets % mesh.shape[axis_name]:
            raise ValueError("n_buckets must divide by index-axis size")
        self.mesh = mesh
        self.axis_name = axis_name
        self.device = resolve(device) if device is not None \
            else mesh.devices.flat[0]
        self.inner = CuckooIndex(n_buckets=n_buckets, seed=seed,
                                 device=self.device)
        self._device_table: np.ndarray | None = None

    # host-authoritative ops delegate
    def insert(self, digest: bytes) -> bool:
        r = self.inner.insert(digest)
        if r:
            self._device_table = None
        return r

    def insert_many(self, digests) -> int:
        """Bulk preload: one vectorized host-mirror build, one sharded
        re-upload at the next ``device_table`` call."""
        added = self.inner.insert_many(list(digests))
        if added:
            self._device_table = None
        return added

    def contains_exact(self, digest: bytes) -> bool:
        return self.inner.contains_exact(digest)

    def __len__(self) -> int:
        return len(self.inner)

    def device_table(self) -> np.ndarray:
        """``shard_table`` of the host mirror, re-placed after a change."""
        if self._device_table is None:
            self._device_table = shard_table(self.mesh, self.inner._table,
                                             self.axis_name)
        return self._device_table

    def probe(self, digests: np.ndarray | torch.Tensor, *,
              data_axis: str | None = "data") -> torch.Tensor:
        """digests uint8[N,32] -> bool[N] on ``device``.  With
        ``data_axis``, N is zero-padded to a multiple of the data axis
        and splits over it (each data shard's digests go to every index
        shard of its row); the partial hits of a row's index shards are
        summed, and the row's verdicts gathered."""
        if isinstance(digests, torch.Tensor):
            d = digests.to(torch.uint8).reshape(-1, 32)
        else:
            d = host_tensor(np.ascontiguousarray(digests, dtype=np.uint8)
                            ).reshape(-1, 32)
        n = d.shape[0]
        tables = self.device_table()
        use_data = bool(data_axis) and data_axis in self.mesh.shape
        nd = self.mesh.shape[data_axis] if use_data else 1
        pad = (-n) % nd
        if pad:
            d = torch.cat([d, torch.zeros((pad, 32), dtype=torch.uint8,
                                          device=d.device)])
        hits = []
        for i, piece in enumerate(d.chunk(nd) if n + pad else [d]):
            row = {data_axis: i} if use_data else {}
            hits.append(to_device(
                probe_row(self.mesh, tables, piece, self.inner.n_buckets,
                          row=row, index_axis=self.axis_name), self.device))
        return torch.cat(hits)[:n]

    def probe_confirmed(self, digests: list[bytes]) -> list[bool]:
        arr = np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 32)
        maybe = self.probe(arr).cpu().numpy()
        return [bool(m) and self.contains_exact(d)
                for m, d in zip(maybe, digests)]


# ---------------------------------------------------------------------------
# service half
# ---------------------------------------------------------------------------


WIRE_PREFIX = "/distidx/v1"
MAP_MAGIC = b"TPXR"
_MAP_HDR = struct.Struct("<HQ")        # version, payload length
_MAP_VERSION = 1
DIGEST_SIZE = 32


class DistIndexError(RuntimeError):
    """Typed failure for the distributed index wire protocol."""


class DistIndexMetrics:
    """Process-wide counters of the port's distributed index (the JAX
    server exports only the JAX package's)."""

    _FIELDS = ("probes", "wire_requests", "batches", "dedup_saved",
               "inserts", "discards", "errors", "rebalances",
               "segments_shipped", "map_reloads")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            for f in self._FIELDS:
                setattr(self, f, 0)

    def add(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


METRICS = DistIndexMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def _split_digests(raw: bytes) -> "list[bytes]":
    if len(raw) % DIGEST_SIZE:
        raise ValueError(
            f"digest payload length {len(raw)} is not a multiple of 32")
    return [raw[i:i + DIGEST_SIZE] for i in range(0, len(raw), DIGEST_SIZE)]


def parse_endpoints(spec: str) -> "list[tuple[str, str]]":
    """``"s0=127.0.0.1:9001,s1=http://127.0.0.1:9002"`` →
    ``[("s0", "http://127.0.0.1:9001"), ...]``.  Empty spec → []."""
    out: "list[tuple[str, str]]" = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad shard spec {part!r}: expected <shard-id>=<endpoint>")
        sid, url = part.split("=", 1)
        sid, url = sid.strip(), url.strip()
        if not sid or not url:
            raise ValueError(f"bad shard spec {part!r}")
        if "://" not in url:
            url = "http://" + url
        out.append((sid, url))
    return out


class ShardMap:
    """Consistent-hash ring over the digest space.

    Each shard contributes ``points`` virtual ring positions
    (``sha256(f"{sid}:{v}")[:8]`` as big-endian u64); a digest is owned
    by the shard at the first ring point ≥ its leading-8-byte key
    (wrap-around).  Snapshots carry the tmp+rename + sha256-trailer
    discipline of the ``.chunkindex`` snapshot; any defect at load time
    yields ``None`` (caller degrades to a wire re-read of shard
    epochs), never a wrong routing table.
    """

    def __init__(self, shards: "Sequence[tuple[str, str]]", *,
                 epoch: int = 0, points: int = 64) -> None:
        if not shards:
            raise ValueError("ShardMap needs at least one shard")
        sids = [sid for sid, _ in shards]
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate shard ids in map")
        self.shards: "list[tuple[str, str]]" = [
            (str(sid), str(url)) for sid, url in shards]
        self.epoch = int(epoch)
        self.points = int(points)
        keys = []
        owners = []
        for idx, (sid, _url) in enumerate(self.shards):
            for v in range(self.points):
                h = hashlib.sha256(f"{sid}:{v}".encode()).digest()
                keys.append(int.from_bytes(h[:8], "big"))
                owners.append(idx)
        order = np.argsort(np.asarray(keys, dtype=np.uint64),
                           kind="stable")
        self._ring_keys = np.asarray(keys, dtype=np.uint64)[order]
        self._ring_owner = np.asarray(owners, dtype=np.int64)[order]

    # -- routing ------------------------------------------------------------
    def shard_index(self, sid: str) -> "int | None":
        for i, (s, _u) in enumerate(self.shards):
            if s == sid:
                return i
        return None

    def owner_indices(self, arr: np.ndarray) -> np.ndarray:
        """uint8[N,32] → int64[N] shard indexes (vectorized ring walk)."""
        a = np.ascontiguousarray(arr, dtype=np.uint8).reshape(-1, DIGEST_SIZE)
        keys = a[:, :8].copy().view(">u8").astype(np.uint64).ravel()
        pos = np.searchsorted(self._ring_keys, keys, side="left")
        pos[pos == len(self._ring_keys)] = 0
        return self._ring_owner[pos]

    def owner_of(self, digest: bytes) -> int:
        arr = np.frombuffer(digest, dtype=np.uint8).reshape(1, DIGEST_SIZE)
        return int(self.owner_indices(arr)[0])

    def owner_mask(self, arr: np.ndarray, shard_idx: int) -> np.ndarray:
        return self.owner_indices(arr) == int(shard_idx)

    def split(self, digests: "Sequence[bytes]"
              ) -> "dict[int, tuple[list[bytes], np.ndarray]]":
        """Group a batch by owning shard.  Returns
        ``{shard_idx: (digests, perm)}`` where ``perm`` indexes back
        into the input batch — the permutation index the client uses to
        regather one verdict vector from the per-shard answers."""
        if not digests:
            return {}
        arr = np.frombuffer(b"".join(digests), dtype=np.uint8
                            ).reshape(-1, DIGEST_SIZE)
        own = self.owner_indices(arr)
        out: "dict[int, tuple[list[bytes], np.ndarray]]" = {}
        for si in np.unique(own).tolist():
            perm = np.flatnonzero(own == si)
            out[int(si)] = ([digests[i] for i in perm.tolist()], perm)
        return out

    # -- snapshot -----------------------------------------------------------
    def to_bytes(self) -> bytes:
        payload = json.dumps({
            "epoch": self.epoch,
            "points": self.points,
            "shards": [[sid, url] for sid, url in self.shards],
        }, sort_keys=True).encode()
        body = MAP_MAGIC + _MAP_HDR.pack(_MAP_VERSION, len(payload)) + payload
        return body + hashlib.sha256(body).digest()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ShardMap | None":
        try:
            if len(raw) < len(MAP_MAGIC) + _MAP_HDR.size + DIGEST_SIZE:
                return None
            if raw[:4] != MAP_MAGIC:
                return None
            ver, plen = _MAP_HDR.unpack_from(raw, 4)
            if ver != _MAP_VERSION:
                return None
            end = 4 + _MAP_HDR.size + plen
            if len(raw) != end + DIGEST_SIZE:
                return None
            if not hmac.compare_digest(
                    hashlib.sha256(raw[:end]).digest(), raw[end:]):
                return None
            obj = json.loads(raw[4 + _MAP_HDR.size:end])
            shards = [(str(s), str(u)) for s, u in obj["shards"]]
            return cls(shards, epoch=int(obj["epoch"]),
                       points=int(obj["points"]))
        except (ValueError, KeyError, TypeError, struct.error):
            return None

    def save(self, path: str) -> None:
        # fsync'd: the shard map is the rebalance fence — a published
        # map that vanishes in a crash would re-route writes backwards
        atomicio.replace_bytes(path, self.to_bytes(), fsync=True)

    @classmethod
    def load(cls, path: str) -> "ShardMap | None":
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return None
        return cls.from_bytes(raw)


class _ShardConn:
    """One persistent HTTP connection to one index shard (the syncwire
    ``_WireClient`` idiom with the ``/distidx/v1`` prefix): serialized
    by a lock, one clean re-dial on connection-shaped failures, typed
    errors on bad status."""

    def __init__(self, url: str, token: str, timeout_s: float) -> None:
        p = urllib.parse.urlsplit(url)
        if p.scheme not in ("", "http"):
            raise DistIndexError(f"unsupported shard scheme {p.scheme!r}")
        self.host = p.hostname or "127.0.0.1"
        self.port = p.port or 80
        self.token = token
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._conn: "http.client.HTTPConnection | None" = None

    def _dial(self) -> http.client.HTTPConnection:
        if self._conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
            conn.connect()
            # Nagle + delayed-ACK on the small request/verdict frames
            # stalls every batch ~40ms — the whole point of batching
            # is sub-RTT amortization, so flush segments immediately
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = conn
        return self._conn

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass    # already torn down; nothing left to release
                self._conn = None

    def request(self, method: str, path: str, body: bytes = b"") -> bytes:
        headers = {
            "Authorization": f"Bearer {self.token}",
            "Content-Length": str(len(body)),
        }
        full = WIRE_PREFIX + path
        with self._lock:
            last: "Exception | None" = None
            for attempt in (0, 1):
                try:
                    conn = self._dial()
                    conn.request(method, full, body=body, headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    if resp.status != 200:
                        raise DistIndexError(
                            f"{method} {full} → {resp.status} "
                            f"{data[:200]!r}")
                    return data
                except (ConnectionError, http.client.HTTPException,
                        OSError) as exc:
                    last = exc
                    if self._conn is not None:
                        try:
                            self._conn.close()
                        except OSError:
                            pass    # dead socket; re-dialed below
                        self._conn = None
                    if attempt:
                        break
            raise DistIndexError(
                f"shard {self.host}:{self.port} unreachable: {last}")


class IndexShardServer:
    """One index shard: a ``DedupIndex`` behind the syncwire HTTP idiom.

    Writes (``/insert``, ``/discard``) are ownership-fenced by the
    installed shard map: digests this shard does not own under the map
    are rejected (returned base64 so the client can refresh its map and
    re-route exactly once).  Probes are never fenced — answering for a
    digest in flight to a new owner is at worst a safe false negative.
    """

    def __init__(self, shard_id: str, index, *, token: str = "",
                 host: str = "127.0.0.1", port: int = 0,
                 shard_map: "ShardMap | None" = None,
                 snapshot_path: "str | None" = None) -> None:
        self.shard_id = shard_id
        self.index = index
        self.token = token
        self.snapshot_path = snapshot_path
        self._map_lock = threading.Lock()
        self._map = shard_map
        self._host = host
        self._port = port
        self._httpd: "object | None" = None
        self._thread: "threading.Thread | None" = None

    # -- map / fencing ------------------------------------------------------
    def install_map(self, m: ShardMap) -> None:
        with self._map_lock:
            if self._map is None or m.epoch >= self._map.epoch:
                self._map = m

    def current_map(self) -> "ShardMap | None":
        with self._map_lock:
            return self._map

    def _fence(self, digests: "list[bytes]"
               ) -> "tuple[list[bytes], list[bytes]]":
        """Split a write batch into (owned, rejected) under the
        installed map.  No map installed → everything is owned."""
        m = self.current_map()
        if m is None or not digests:
            return digests, []
        mi = m.shard_index(self.shard_id)
        if mi is None:
            return [], list(digests)       # retired from the map entirely
        arr = np.frombuffer(b"".join(digests), dtype=np.uint8
                            ).reshape(-1, DIGEST_SIZE)
        mask = m.owner_mask(arr, mi)
        owned = [d for d, ok in zip(digests, mask) if ok]
        rejected = [d for d, ok in zip(digests, mask) if not ok]
        return owned, rejected

    def _epoch(self) -> int:
        m = self.current_map()
        return m.epoch if m is not None else 0

    # -- endpoint bodies ----------------------------------------------------
    def _do_probe(self, raw: bytes) -> bytes:
        digests = _split_digests(raw)
        return np.asarray(self.index.probe_batch(digests),
                          dtype=np.uint8).tobytes()

    def _do_insert(self, raw: bytes) -> dict:
        owned, rejected = self._fence(_split_digests(raw))
        added = self.index.insert_many(owned) if owned else 0
        return {"added": added,
                "rejected_b64": base64.b64encode(b"".join(rejected)).decode(),
                "epoch": self._epoch()}

    def _do_discard(self, raw: bytes) -> dict:
        owned, rejected = self._fence(_split_digests(raw))
        discarded = self.index.discard_many(owned) if owned else 0
        return {"discarded": discarded,
                "rejected_b64": base64.b64encode(b"".join(rejected)).decode(),
                "epoch": self._epoch()}

    def _do_map(self, raw: bytes) -> dict:
        m = ShardMap.from_bytes(raw)
        if m is None:
            raise ValueError("corrupt shard map payload")
        self.install_map(m)
        return {"ok": True, "epoch": self._epoch()}

    def _do_epoch(self) -> dict:
        m = self.current_map()
        return {"shard": self.shard_id,
                "count": len(self.index),
                "epoch": self._epoch(),
                "map_b64": (base64.b64encode(m.to_bytes()).decode()
                            if m is not None else "")}

    def _do_digests(self) -> bytes:
        return b"".join(self.index.digests())

    def _do_persist(self) -> dict:
        if self.snapshot_path:
            self.index.save_snapshot(self.snapshot_path)
        else:
            flush = getattr(getattr(self.index, "digestlog", None),
                            "flush", None)
            if flush is not None:
                flush()
        return {"ok": True, "count": len(self.index)}

    def _do_segments(self) -> dict:
        segs = self.index.export_segments()
        return {"epoch": self._epoch(),
                "segments": [[name, trailer, count]
                             for name, trailer, count in segs]}

    def _do_segment(self, name: str) -> bytes:
        return self.index.export_segment_bytes(name)

    def _do_adopt(self, raw: bytes, trailer_hex: str) -> dict:
        m = self.current_map()
        mi = m.shard_index(self.shard_id) if m is not None else None

        def keep(digs: np.ndarray) -> np.ndarray:
            if m is None or mi is None:
                return np.ones(len(digs), dtype=bool)
            return m.owner_mask(digs, mi)

        adopted = self.index.adopt_segment(
            raw, bytes.fromhex(trailer_hex), keep)
        return {"adopted": adopted, "epoch": self._epoch()}

    def _do_retire(self) -> dict:
        m = self.current_map()
        digs = list(self.index.digests())
        if m is None or not digs:
            return {"dropped": 0, "epoch": self._epoch()}
        mi = m.shard_index(self.shard_id)
        if mi is None:
            drop = digs                     # retired from the map entirely
        else:
            arr = np.frombuffer(b"".join(digs), dtype=np.uint8
                                ).reshape(-1, DIGEST_SIZE)
            mask = m.owner_mask(arr, mi)
            drop = [d for d, ok in zip(digs, mask) if not ok]
        dropped = self.index.discard_many(drop) if drop else 0
        return {"dropped": dropped, "epoch": self._epoch()}

    # -- HTTP plumbing ------------------------------------------------------
    def start(self) -> int:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        svc = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out as separate small writes; with
            # Nagle on, the second waits for the peer's delayed ACK
            # (~40ms per response) — fatal to a sub-RTT batch protocol
            disable_nagle_algorithm = True

            def log_message(self, *a):    # noqa: D102 — silence stderr
                pass

            def _q(self):
                u = urllib.parse.urlparse(self.path)
                return u.path, dict(urllib.parse.parse_qsl(
                    u.query, keep_blank_values=True))

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/octet-stream") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: dict) -> None:
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _authed(self) -> bool:
                got = self.headers.get("Authorization") or ""
                want = f"Bearer {svc.token}"
                if hmac.compare_digest(got, want):
                    return True
                self._json(403, {"error": "bad token"})
                return False

            def _serve(self, method: str) -> None:
                if svc._httpd is None:
                    # stopped node: keep-alive handler threads outlive
                    # the listener — drop the connection unanswered,
                    # the way a dead process would
                    self.close_connection = True
                    self.connection.close()
                    return
                if not self._authed():
                    return
                path, q = self._q()
                if not path.startswith(WIRE_PREFIX):
                    self._json(404, {"error": "unknown path"})
                    return
                ep = path[len(WIRE_PREFIX):]
                try:
                    if method == "POST" and ep == "/probe":
                        self._send(200, svc._do_probe(self._body()))
                    elif method == "POST" and ep == "/insert":
                        self._json(200, svc._do_insert(self._body()))
                    elif method == "POST" and ep == "/discard":
                        self._json(200, svc._do_discard(self._body()))
                    elif method == "POST" and ep == "/map":
                        self._json(200, svc._do_map(self._body()))
                    elif method == "GET" and ep == "/epoch":
                        self._json(200, svc._do_epoch())
                    elif method == "GET" and ep == "/digests":
                        self._send(200, svc._do_digests())
                    elif method == "POST" and ep == "/persist":
                        self._json(200, svc._do_persist())
                    elif method == "GET" and ep == "/segments":
                        self._json(200, svc._do_segments())
                    elif method == "GET" and ep == "/segment":
                        self._send(200, svc._do_segment(q.get("name", "")))
                    elif method == "POST" and ep == "/adopt":
                        self._json(200, svc._do_adopt(
                            self._body(), q.get("trailer", "")))
                    elif method == "POST" and ep == "/retire":
                        self._json(200, svc._do_retire())
                    else:
                        self._json(404, {"error": f"unknown endpoint {ep}"})
                except (ValueError, KeyError, RuntimeError) as exc:
                    self._json(400, {"error": str(exc)})
                except OSError as exc:
                    self._json(500, {"error": str(exc)})

            def do_GET(self):     # noqa: N802
                self._serve("GET")

            def do_POST(self):    # noqa: N802
                self._serve("POST")

        httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self._port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name=f"distidx-{self.shard_id}",
            daemon=True)
        self._thread.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    @property
    def endpoint(self) -> str:
        return f"http://{self._host}:{self._port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class DistIndexClient:
    """Batched scatter/gather client for the sharded index.

    Implements the ``probe_batch``/``insert_many``/``discard_many``
    membership surface of ``DedupIndex`` — the ONLY membership surface
    — by splitting each batch by shard owner, issuing ONE request per
    shard per batch concurrently over persistent connections, and
    regathering a single verdict vector through the permutation index
    from ``ShardMap.split``.  Intra-batch duplicate digests collapse
    before the wire and re-expand through the same index, so the
    returned vector is bit-identical to the un-deduped answer.

    An unreachable shard yields ``False`` verdicts / un-acked discards
    for its slice of the batch: the failure direction is always the
    safe false negative (re-upload, keep the chunk file).
    """

    def __init__(self, shard_map: "ShardMap | None" = None, *,
                 endpoints: "Sequence[tuple[str, str]] | None" = None,
                 token: str = "", timeout_s: float = 30.0,
                 map_path: str = "") -> None:
        self.token = token
        self.timeout_s = float(timeout_s)
        self.map_path = map_path
        self._lock = threading.Lock()
        self._conns: "dict[str, _ShardConn]" = {}
        self._pool: "object | None" = None
        self._datablobs: "set[bytes]" = set()
        self.loaded_sketches = None
        if shard_map is None and map_path:
            shard_map = ShardMap.load(map_path)
            if shard_map is None and os.path.exists(map_path):
                # corrupt/truncated snapshot: degrade to a wire re-read
                # of shard epochs — never guess a routing table
                L.warning("dist-index: corrupt shard map at %s; "
                          "re-reading epochs from shards", map_path)
        if shard_map is None:
            if not endpoints:
                raise DistIndexError(
                    "DistIndexClient needs a shard map, a readable map "
                    "snapshot, or explicit endpoints")
            shard_map = self._bootstrap_map(endpoints)
        self._map = shard_map

    # -- plumbing -----------------------------------------------------------
    def _bootstrap_map(self, endpoints) -> ShardMap:
        """Full re-read of shard epochs over the wire: adopt the
        highest-epoch map any shard reports, else synthesize epoch-0
        from the endpoint list."""
        best: "ShardMap | None" = None
        for _sid, url in endpoints:
            try:
                conn = _ShardConn(url, self.token, self.timeout_s)
                obj = json.loads(conn.request("GET", "/epoch"))
                conn.close()
                mb = obj.get("map_b64") or ""
                if mb:
                    m = ShardMap.from_bytes(base64.b64decode(mb))
                    if m is not None and (best is None
                                          or m.epoch > best.epoch):
                        best = m
            except DistIndexError:
                continue
        METRICS.add("map_reloads")
        return best if best is not None else ShardMap(list(endpoints))

    def _conn(self, url: str) -> _ShardConn:
        with self._lock:
            conn = self._conns.get(url)
            if conn is None:
                conn = self._conns[url] = _ShardConn(
                    url, self.token, self.timeout_s)
            return conn

    def _executor(self):
        from concurrent.futures import ThreadPoolExecutor
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, min(8, len(self._map.shards))),
                    thread_name_prefix="distidx-client")
            return self._pool

    def _fanout(self, jobs: "dict[int, tuple]", fn
                ) -> "dict[int, object]":
        """jobs: {shard_idx: payload}; fn(shard_idx, payload) → result.
        Concurrent when >1 shard is involved; exceptions are returned
        in-place (never raised) so one dead shard cannot sink a batch."""
        if not jobs:
            return {}
        if len(jobs) == 1:
            si, payload = next(iter(jobs.items()))
            try:
                return {si: fn(si, payload)}
            except Exception as exc:          # noqa: BLE001
                return {si: exc}
        pool = self._executor()
        items = list(jobs.items())
        # the calling thread takes one slice itself instead of parking
        # in result(): with N shards only N-1 pool dispatches (and
        # their wakeup latency) sit on the batch's critical path
        futs = {si: pool.submit(fn, si, payload)
                for si, payload in items[:-1]}
        out: "dict[int, object]" = {}
        si, payload = items[-1]
        try:
            out[si] = fn(si, payload)
        except Exception as exc:              # noqa: BLE001
            out[si] = exc
        for si, fut in futs.items():
            try:
                out[si] = fut.result()
            except Exception as exc:          # noqa: BLE001
                out[si] = exc
        return out

    # -- map management -----------------------------------------------------
    @property
    def shard_map(self) -> ShardMap:
        return self._map

    def refresh_map(self) -> None:
        """Re-read shard epochs over the wire and adopt the
        highest-epoch map reported (also the corrupt-snapshot
        degradation path)."""
        best = self._map
        for _sid, url in list(self._map.shards):
            try:
                obj = json.loads(self._conn(url).request("GET", "/epoch"))
                mb = obj.get("map_b64") or ""
                if mb:
                    m = ShardMap.from_bytes(base64.b64decode(mb))
                    if m is not None and m.epoch > best.epoch:
                        best = m
            except DistIndexError:
                continue
        METRICS.add("map_reloads")
        if best is not self._map:
            with self._lock:
                self._map = best
            if self.map_path:
                best.save(self.map_path)

    # -- membership surface (the ONLY one) ----------------------------------
    def probe_batch(self, digests: "Sequence[bytes]") -> "list[bool]":
        if not digests:
            return []
        METRICS.add("probes", len(digests))
        METRICS.add("batches")
        # intra-batch dedup: collapse repeats before the wire, re-expand
        # through the same permutation index (hardlinks / zero blocks).
        # The duplicate-free common case skips the position loop — a
        # set probe is ~4x cheaper and restore batches rarely repeat
        back: "list[int] | None" = None
        if len(set(digests)) == len(digests):
            uniq = list(digests)
        else:
            uniq_pos: "dict[bytes, int]" = {}
            uniq = []
            back = []
            for d in digests:
                j = uniq_pos.get(d)
                if j is None:
                    j = uniq_pos[d] = len(uniq)
                    uniq.append(d)
                back.append(j)
            METRICS.add("dedup_saved", len(digests) - len(uniq))
        m = self._map
        verdict = np.zeros(len(uniq), dtype=bool)
        parts = m.split(uniq)

        def one(si: int, payload):
            digs, _perm = payload
            raw = self._conn(m.shards[si][1]).request(
                "POST", "/probe", b"".join(digs))
            METRICS.add("wire_requests")
            if len(raw) != len(digs):
                raise DistIndexError(
                    f"probe verdict length {len(raw)} != {len(digs)}")
            return np.frombuffer(raw, dtype=np.uint8) != 0

        for si, res in self._fanout(parts, one).items():
            if isinstance(res, Exception):
                METRICS.add("errors")
                continue            # shard slice stays False: safe miss
            verdict[parts[si][1]] = res
        if back is None:
            return verdict.tolist()
        return verdict[np.asarray(back)].tolist()

    def contains(self, digest: bytes) -> bool:
        return self.probe_batch([digest])[0]

    def _member_op(self, ep: str, digests: "Sequence[bytes]",
                   count_field: str) -> "tuple[int, dict[bytes, bool]]":
        """Shared insert/discard fan-out with the re-route protocol:
        shard-side ownership fencing returns rejected digests; the
        client refreshes its map and re-routes the rejects exactly
        once.  Returns (count_total, acked-by-digest)."""
        acked: "dict[bytes, bool]" = {}
        total = 0
        pending = list(dict.fromkeys(digests))
        for attempt in (0, 1):
            m = self._map
            parts = m.split(pending)

            def one(si: int, payload, _m=m):
                digs, _perm = payload
                raw = self._conn(_m.shards[si][1]).request(
                    "POST", ep, b"".join(digs))
                METRICS.add("wire_requests")
                return json.loads(raw)

            rerouted: "list[bytes]" = []
            for si, res in self._fanout(parts, one).items():
                digs = parts[si][0]
                if isinstance(res, Exception):
                    METRICS.add("errors")
                    continue               # slice stays un-acked: safe
                total += int(res.get(count_field, 0))
                rej = set(_split_digests(
                    base64.b64decode(res.get("rejected_b64", ""))))
                for d in digs:
                    if d in rej:
                        rerouted.append(d)
                    else:
                        acked[d] = True
            if not rerouted:
                break
            if attempt == 0:
                self.refresh_map()
                pending = rerouted
            else:
                METRICS.add("errors", len(rerouted))
        return total, acked

    def insert_many(self, digests: "Sequence[bytes]") -> int:
        if not digests:
            return 0
        total, _acked = self._member_op("/insert", digests, "added")
        METRICS.add("inserts", total)
        return total

    def insert(self, digest: bytes) -> bool:
        return self.insert_many([digest]) > 0

    def discard_many(self, digests: "Sequence[bytes]") -> int:
        if not digests:
            return 0
        total, _acked = self._member_op("/discard", digests, "discarded")
        METRICS.add("discards", total)
        self._datablobs.difference_update(digests)
        return total

    def discard_many_acked(self, digests: "Sequence[bytes]"
                           ) -> "list[bool]":
        """Cross-process discard-before-unlink: the sweep may unlink a
        chunk file ONLY for digests acked here.  An unreachable shard
        → False → the file survives (safe false negative)."""
        if not digests:
            return []
        total, acked = self._member_op("/discard", digests, "discarded")
        METRICS.add("discards", total)
        self._datablobs.difference_update(
            d for d in digests if acked.get(d, False))
        for d in digests:
            if acked.get(d, False):
                # only ACKED digests fence the sweep's unlink — an
                # un-acked digest keeps its file, so no event for it
                fswitness.note("index.discard", d.hex())
        return [acked.get(d, False) for d in digests]

    def discard(self, digest: bytes) -> None:
        self.discard_many([digest])

    # -- DedupIndex-compatible shell ----------------------------------------
    @property
    def booted(self) -> bool:
        return True

    def mark_booted(self) -> None:
        pass

    def ensure_booted(self, *a, **k) -> None:
        pass

    @property
    def spillable(self) -> bool:
        return False

    @property
    def resident_bytes(self) -> int:
        return 0

    def __len__(self) -> int:
        n = 0
        for _sid, url in self._map.shards:
            try:
                obj = json.loads(self._conn(url).request("GET", "/epoch"))
                n += int(obj.get("count", 0))
            except DistIndexError:
                METRICS.add("errors")
        return n

    def rebuild(self, digests: "Iterable[bytes]") -> int:
        total = 0
        batch: "list[bytes]" = []
        for d in digests:
            batch.append(d)
            if len(batch) >= 4096:
                total += self.insert_many(batch)
                batch = []
        if batch:
            total += self.insert_many(batch)
        return total

    def digests(self) -> "Iterator[bytes]":
        for _sid, url in list(self._map.shards):
            raw = self._conn(url).request("GET", "/digests")
            yield from _split_digests(raw)

    def is_datablob(self, digest: bytes) -> bool:
        # client-local only: the datablob flag is advisory restore-path
        # metadata, not membership (docs/dist-index.md, limitations)
        return digest in self._datablobs

    def mark_datablob(self, digest: bytes) -> None:
        self._datablobs.add(digest)

    def save_snapshot(self, path: str, sketches=None) -> None:
        """Broadcast ``/persist`` — each shard flushes + snapshots to
        its OWN configured path; ``path`` only locates the client-side
        shard-map snapshot (written next to it when no explicit
        map_path is configured)."""
        for _sid, url in self._map.shards:
            try:
                self._conn(url).request("POST", "/persist")
            except DistIndexError:
                METRICS.add("errors")
        map_path = self.map_path or (f"{path}.shardmap" if path else "")
        if map_path:
            self._map.save(map_path)

    def load_snapshot(self, path: str, *a, **k) -> bool:
        return False

    # -- rebalance coordinator ----------------------------------------------
    def rebalance(self, new_map: ShardMap) -> dict:
        """Membership change via whole-segment handoff.

        Ordering (docs/dist-index.md):

        1. install ``new_map`` on EVERY shard (old ∪ new) — from this
           point stale-routed writes are rejected and re-routed, so no
           write can land on a shard that is about to retire it;
        2. each old shard flushes + exports its immutable segments;
           the coordinator fetches each one, re-verifies the sha256
           trailer, and POSTs it verbatim to every distinct new owner
           (the receiver re-verifies AGAIN and keeps only the rows it
           owns under the installed map);
        3. every old shard retires the digests it no longer owns.

        Probes are never fenced: during the window a digest may answer
        False from its new owner — the safe false negative.
        """
        old_map = self._map
        if new_map.epoch <= old_map.epoch:
            new_map = ShardMap(new_map.shards, epoch=old_map.epoch + 1,
                               points=new_map.points)
        METRICS.add("rebalances")
        by_url: "dict[str, str]" = {}
        for sid, url in list(old_map.shards) + list(new_map.shards):
            by_url.setdefault(url, sid)
        # 1. fence everywhere first — a shard that misses the map would
        #    keep accepting writes it is about to retire, so this step
        #    is all-or-nothing (map-install-before-retire,
        #    docs/protocols.md)
        self._install_map_on_all(by_url, new_map)
        with self._lock:
            self._map = new_map
        shipped = 0
        adopted = 0
        # 2. ship segments oldest→newest (preserves tombstone
        #    shadowing: each adopted segment lands as the receiver's
        #    newest)
        for si, (sid, url) in enumerate(old_map.shards):
            conn = self._conn(url)
            seg_list = json.loads(conn.request("GET", "/segments"))
            for name, trailer_hex, _count in seg_list["segments"]:
                raw = conn.request("GET",
                                   f"/segment?name={urllib.parse.quote(name)}")
                trailer = bytes.fromhex(trailer_hex)
                recs = parse_segment_bytes(raw, trailer)   # verify in transit
                owners = set(new_map.owner_indices(
                    recs[:, :DIGEST_SIZE]).tolist())
                for oi in sorted(owners):
                    osid, ourl = new_map.shards[oi]
                    if osid == sid:
                        continue           # staying put: retire keeps it
                    res = json.loads(self._conn(ourl).request(
                        "POST", f"/adopt?trailer={trailer_hex}", raw))
                    adopted += int(res.get("adopted", 0))
                    shipped += 1
                    METRICS.add("segments_shipped")
        # 3. retire: every old shard drops what it no longer owns
        dropped = self._retire_from_old(old_map)
        if self.map_path:
            new_map.save(self.map_path)
        return {"epoch": new_map.epoch, "segments_shipped": shipped,
                "adopted": adopted, "dropped": dropped}

    def _install_map_on_all(self, urls: "Iterable[str]",
                            new_map: ShardMap) -> None:
        """Step 1 of the rebalance protocol: POST the new map to every
        shard (old ∪ new) before anything else moves — the static
        ordering-discipline rule anchors on this call preceding
        ``_retire_from_old`` on every path."""
        payload = new_map.to_bytes()
        for url in urls:
            self._conn(url).request("POST", "/map", payload)
            METRICS.add("wire_requests")
            fswitness.note("map.install", url)

    def _retire_from_old(self, old_map: ShardMap) -> int:
        """Step 3: every old shard drops the digests it no longer owns
        under the (already installed) new map."""
        dropped = 0
        for _sid, url in old_map.shards:
            fswitness.note("shard.retire", url)
            res = json.loads(self._conn(url).request("POST", "/retire"))
            dropped += int(res.get("dropped", 0))
        return dropped

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            pool = self._pool
            self._pool = None
        for c in conns:
            c.close()
        if pool is not None:
            pool.shutdown(wait=False)


def main(argv: "list[str] | None" = None) -> int:
    """Subprocess entry for one index shard node:
    ``python -m pbs_plus_tpu_torch index-shard --shard-id s0 ...``.

    The flags, the ready line (``{"event": "ready", "port": ...}`` on
    stdout) and the stdin protocol (serve until ``exit`` or EOF) are the
    reference's; ``--device`` (default ``cuda``) places the shard's
    index, and the exit line also reports the K3 launches the node made.
    ``/persist`` is the durability point: a SIGKILL between inserts and
    the next ``/persist`` loses those inserts, which is safe, because
    nothing acked them durable.
    """
    import argparse

    ap = argparse.ArgumentParser(prog="index-shard")
    add_shard_arguments(ap)
    return serve_shard(ap.parse_args(argv))


def serve_shard(args) -> int:
    """Run one shard node from parsed ``add_shard_arguments`` flags
    (``main``'s body)."""
    import sys

    from ..ops import cuckoo
    from ..pxar.chunkindex import DedupIndex

    index = DedupIndex(
        budget_mb=args.budget_mb,
        spill_dir=args.spill_dir or None,
        resident_mb=args.resident_mb if args.spill_dir else 0.0,
        device=args.device,
    )
    if args.snapshot and os.path.exists(args.snapshot):
        # unlike the datastore's consume-once boot, a shard KEEPS its
        # snapshot: /persist rewrites it in place (tmp+rename)
        index.load_snapshot(args.snapshot)
    index.mark_booted()

    server = IndexShardServer(
        args.shard_id, index, token=args.token, host=args.host,
        port=args.port, snapshot_path=args.snapshot or None)
    port = server.start()
    print(json.dumps({"event": "ready", "shard": args.shard_id,
                      "port": port, "pid": os.getpid(),
                      "device": str(index.device)}), flush=True)
    try:
        for line in sys.stdin:
            if line.strip() == "exit":
                break
    except KeyboardInterrupt:
        pass
    try:
        if args.snapshot:
            index.save_snapshot(args.snapshot)
    finally:
        server.stop()
    print(json.dumps({"event": "exit", "shard": args.shard_id,
                      "device_probes": cuckoo.stats["device_probes"]}),
          flush=True)
    return 0


def add_shard_arguments(ap) -> None:
    """The shard node's flags: the reference's, plus ``--device``."""
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--token", default="")
    ap.add_argument("--spill-dir", default="")
    ap.add_argument("--budget-mb", type=float, default=64.0)
    ap.add_argument("--resident-mb", type=float, default=1.0)
    ap.add_argument("--snapshot", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


if __name__ == "__main__":
    raise SystemExit(main())
