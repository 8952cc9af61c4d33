"""Datastore replication: dedup-aware, resumable snapshot sync.

The reference PBS ships *sync jobs* that mirror snapshot groups between
datastores; content-defined chunking exists precisely so replicas
exchange only novel chunks (arXiv 2409.06066).  This module is the
store-to-store data plane:

- **Dedup-aware, batched negotiation.**  The puller parses the source
  snapshot's dynamic indexes and asks the DESTINATION for membership of
  whole digest batches: one vectorized ``DedupIndex.probe_batch`` per
  batch (``ChunkStore.on_disk_many`` — still a single batched call — is
  the fallback for index-less destinations).  Sync code never probes
  per digest; pbslint's ``sync-discipline`` rule guards the shape.
- **Compressed-as-stored transfer.**  Only missing chunks cross the
  wire, and they cross as the exact on-disk payload
  (``ChunkStore.get_raw`` → ``insert_raw``): raw zstd frames, PBS
  DataBlobs and delta blobs move without a decompress/recompress
  round-trip.  The receiving ``insert_raw`` verifies every payload
  before it becomes reachable, so a corrupt transfer is a typed
  failure, never a torn chunk.
- **Delta closure.**  A delta blob reassembles through its base chain;
  a mirror that receives the delta without the chain could never serve
  it.  Each batch's missing set is closed over
  ``ChunkStore.delta_closure`` on the SOURCE, closure members are
  membership-probed like any other digest, and transfers are ordered
  bases-first (full blobs, then deltas by ascending chain depth) so
  the destination's read-back verification always finds the base.
- **Resumable.**  Durable per-group progress rides
  ``<local store>/.sync/<job>/state.json`` (tmp+rename, the
  checkpoint discipline); snapshots publish atomically (tmp dir +
  rename), so a killed sync never leaves a half snapshot — and every
  chunk that already landed is a dedup hit on the next run's batched
  re-probe: a resume transfers strictly less than the full set.
- **Transports.**  Local↔local (two datastore directories) and
  loopback HTTP: ``SyncWireServer`` serves a datastore over the same
  ``http.client`` seam the pbsstore client uses
  (``HttpSyncSource``/``HttpSyncDest``), bearer-token authed.

Failpoint sites (docs/fault-injection.md): ``pbsstore.sync.probe``
before every membership batch, ``pbsstore.sync.transfer`` on every
chunk payload crossing the wire (``corrupt`` must be caught by the
destination's verification), ``pbsstore.sync.commit`` before the
atomic snapshot publish.

Observability: ``pbs_plus_sync_{jobs,chunks_probed,chunks_transferred,
bytes_wire,bytes_logical,resumes,errors}_total`` (+ probe batches,
skipped chunks, snapshots) rendered by server/metrics.py.

A copy of the JAX package's ``pxar/syncwire.py``, its code byte for byte
apart from its logger (``logging``).  Its imports name the port's own
modules, so ``LocalSyncDest.probe_chunks`` reaches the port's
``ChunkStore.probe_batch``: on a ``LocalStore(device="cuda")`` that is
the port's ``DedupIndex``, and every membership batch is a K3 probe on
the card at the destination.  ``insert_raw`` verifies every payload
with hashlib on the host, as the reference's does.
"""

from __future__ import annotations

import hmac
import http.client
import json
import logging
import os
import struct
import threading
import time
import urllib.parse
from typing import Iterable, Sequence

from ..utils import atomicio, conf, failpoints, trace, validate
from .datastore import Datastore, DynamicIndex, SnapshotRef, \
    parse_snapshot_ref

L = logging.getLogger(__name__)

SYNC_DIR = ".sync"
SYNC_STATE_FORMAT = "tpxar-sync-v1"
STATE_JSON = "state.json"
WIRE_PREFIX = "/sync/v1"
_MISSING = 0xFFFFFFFF          # wire sentinel: requested chunk absent
_LEN = struct.Struct("<I")
_NAME = struct.Struct("<H")
_MAX_FILE = 1 << 30            # per-file cap on the files frame
_MAX_FILES = 64                # snapshot dirs hold a handful of files


class SyncError(RuntimeError):
    """Typed sync failure: negotiation, transfer verification, or
    publish trouble.  A failed sync never leaves torn chunks or a
    half-published snapshot behind."""


class SyncWireError(SyncError):
    """The HTTP wire leg failed (transport death, bad status, protocol
    violation)."""


class SyncMetrics:
    """Process-global sync observability (rendered by server/metrics.py
    as ``pbs_plus_sync_*``)."""

    _COUNTERS = ("jobs", "snapshots", "chunks_probed", "probe_batches",
                 "chunks_transferred", "chunks_skipped", "bytes_wire",
                 "bytes_logical", "resumes", "errors")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._COUNTERS, 0)

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._c[counter] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


METRICS = SyncMetrics()


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


# -- wire-format helpers -----------------------------------------------------

def _parse_index_bytes(raw: bytes) -> DynamicIndex:
    """DynamicIndex from raw index-file bytes — sniffs stock-PBS didx
    vs native TPXD (one parser for mixed-format mirrors, the
    ``Datastore.parse`` discipline applied to in-memory bytes)."""
    import numpy as np

    from .pbsformat import DYNAMIC_INDEX_MAGIC, parse_dynamic_index_bytes
    if raw[:8] == DYNAMIC_INDEX_MAGIC:
        parsed = parse_dynamic_index_bytes(raw)
        ends = np.array([e for e, _ in parsed.records], dtype=np.uint64)
        digs = np.frombuffer(b"".join(d for _, d in parsed.records),
                             dtype=np.uint8).reshape(-1, 32) \
            if parsed.records else np.empty((0, 32), dtype=np.uint8)
        return DynamicIndex(ends, digs, parsed.uuid,
                            parsed.ctime_s * 1_000_000_000)
    from .pbsstore import index_from_bytes
    return index_from_bytes(raw)


def _split_digests(raw: bytes) -> list[bytes]:
    if len(raw) % 32:
        raise SyncWireError(f"digest payload not a multiple of 32 "
                            f"({len(raw)} bytes)")
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def _frame_files(files: dict[str, bytes]) -> bytes:
    out = []
    for name, blob in files.items():
        enc = name.encode()
        out.append(_NAME.pack(len(enc)) + enc + _LEN.pack(len(blob)) + blob)
    return b"".join(out)


def _unframe_files(raw: bytes) -> dict[str, bytes]:
    files: dict[str, bytes] = {}
    pos = 0
    while pos < len(raw):
        if pos + _NAME.size > len(raw):
            raise SyncWireError("truncated files frame (name header)")
        (nlen,) = _NAME.unpack_from(raw, pos)
        pos += _NAME.size
        name = raw[pos:pos + nlen].decode()
        pos += nlen
        if pos + _LEN.size > len(raw):
            raise SyncWireError("truncated files frame (length header)")
        (blen,) = _LEN.unpack_from(raw, pos)
        pos += _LEN.size
        if blen > _MAX_FILE or pos + blen > len(raw):
            raise SyncWireError("files frame length out of bounds")
        if "/" in name or "\\" in name or name in ("", ".", ".."):
            raise SyncWireError(f"unsafe file name {name!r} in frame")
        files[name] = raw[pos:pos + blen]
        pos += blen
        if len(files) > _MAX_FILES:
            raise SyncWireError("too many files in frame")
    return files


def _frame_chunks(pairs: Sequence[tuple[bytes, bytes]]) -> bytes:
    return b"".join(d + _LEN.pack(len(p)) + p for d, p in pairs)


def _unframe_chunks(raw: bytes) -> list[tuple[bytes, bytes]]:
    out: list[tuple[bytes, bytes]] = []
    pos = 0
    while pos < len(raw):
        if pos + 32 + _LEN.size > len(raw):
            raise SyncWireError("truncated chunk frame header")
        digest = raw[pos:pos + 32]
        (blen,) = _LEN.unpack_from(raw, pos + 32)
        pos += 32 + _LEN.size
        if blen == _MISSING:
            raise SyncWireError(
                f"peer reports chunk {digest.hex()[:16]} missing")
        if pos + blen > len(raw):
            raise SyncWireError("truncated chunk frame payload")
        out.append((digest, raw[pos:pos + blen]))
        pos += blen
    return out


# -- local endpoints ---------------------------------------------------------

class LocalSyncSource:
    """Read side of a sync over a local :class:`Datastore`."""

    def __init__(self, ds: Datastore):
        self.ds = ds

    def list_snapshots(self, backup_type: str = "", backup_id: str = "",
                       namespace: "str | None" = None) -> list[SnapshotRef]:
        """Published snapshots matching the group filter; ``namespace``
        None spans all namespaces."""
        return self.ds.list_snapshots(
            backup_type or None, backup_id or None,
            namespace=namespace or "",
            all_namespaces=namespace is None)

    def snapshot_files(self, ref: SnapshotRef) -> dict[str, bytes]:
        """Every regular file of the published snapshot dir, verbatim —
        indexes, manifest(s).  File-level copy is what makes the mirror
        bit-identical (uuids, csums and created_unix survive)."""
        d = self.ds.snapshot_dir(ref)
        out: dict[str, bytes] = {}
        try:
            names = sorted(os.listdir(d))
        except OSError as e:
            raise SyncError(f"snapshot {ref} unreadable: {e}") from e
        for name in names:
            p = os.path.join(d, name)
            if name.startswith(".") or not os.path.isfile(p):
                continue
            with open(p, "rb") as f:
                out[name] = f.read()
        if Datastore.MANIFEST not in out:
            raise SyncError(f"snapshot {ref} has no manifest")
        return out

    def fetch_chunks(self, digests: Sequence[bytes]) -> list[bytes]:
        """Raw compressed-as-stored payloads, in request order."""
        try:
            return [self.ds.chunks.get_raw(d) for d in digests]
        except FileNotFoundError as e:
            raise SyncError(f"source chunk vanished mid-sync: {e}") from e

    def closure_extra(self, digests: Sequence[bytes]) -> list[bytes]:
        """Delta-closure members BEYOND the given set: every chunk the
        given ones (transitively) reassemble from.  Empty for stores
        that never wrote a delta (the ``.delta-tier`` marker gate)."""
        s = set(digests)
        return sorted(self.ds.chunks.delta_closure(s) - s)


class LocalSyncDest:
    """Write side of a sync over a local :class:`Datastore`."""

    def __init__(self, ds: Datastore):
        self.ds = ds

    def has_snapshot(self, ref: SnapshotRef) -> bool:
        return os.path.isfile(os.path.join(
            self.ds.snapshot_dir(ref), Datastore.MANIFEST))

    def probe_chunks(self, digests: Sequence[bytes]) -> list[bool]:
        """ONE batched membership answer for the whole digest batch:
        the dedup index's vectorized ``probe_batch``, or the batched
        disk fallback for index-less stores — never a per-digest
        loop in sync code (pbslint ``sync-discipline``).  With the
        spillable exact tier (pxar/digestlog.py) an incremental sync's
        mostly-present batches confirm in sorted segment sweeps inside
        ``probe_batch`` — ~one read per touched 4 KiB block, not per
        digest — and the novel minority stays disk-free at the
        destination via the filter."""
        present = self.ds.chunks.probe_batch(list(digests))
        if present is None:
            present = self.ds.chunks.on_disk_many(list(digests))
        return present

    def insert_chunks(self, pairs: Sequence[tuple[bytes, bytes]]) -> int:
        """Store raw payloads (already transfer-ordered bases-first by
        the engine); each verifies inside ``insert_raw`` before it
        becomes reachable."""
        n = 0
        for digest, payload in pairs:
            self.ds.chunks.insert_raw(digest, payload)
            n += 1
        return n

    def publish(self, ref: SnapshotRef, files: dict[str, bytes]) -> None:
        """Atomically publish the mirrored snapshot dir (tmp dir +
        rename — the BackupSession.finish discipline, so a killed sync
        never leaves a half snapshot visible).  Idempotent when the
        snapshot already exists."""
        self.ds.ensure_group_dir(ref)
        final = self.ds.snapshot_dir(ref)
        if os.path.exists(final):
            return
        # tolerate_existing: a concurrent publisher may win the rename
        # race (two sync jobs mirroring one group) — identical content,
        # so the loser just drops its staging dir
        with atomicio.staged_dir(
                final,
                tmp=f"{final}.tmp.{os.getpid()}.{threading.get_ident()}",
                tolerate_existing=True) as tmp:
            for name, blob in files.items():
                if "/" in name or "\\" in name or name in ("", ".", ".."):
                    raise SyncError(f"unsafe snapshot file name {name!r}")
                atomicio.write_bytes(os.path.join(tmp, name), blob)


# -- durable progress state --------------------------------------------------

class SyncState:
    """Durable per-job progress under ``<store>/.sync/<job>/state.json``
    (tmp+rename).  ``in_progress`` survives a crash — the next run
    counts itself a resume; ``done`` keeps per-snapshot completion
    stats for observability (the authoritative skip signal stays the
    destination's published manifest)."""

    def __init__(self, path: str):
        self.path = path
        self.data: dict = {"format": SYNC_STATE_FORMAT, "done": {},
                           "in_progress": None}

    @classmethod
    def load(cls, path: str) -> "SyncState":
        st = cls(path)
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("format") == SYNC_STATE_FORMAT and \
                    isinstance(data.get("done"), dict):
                st.data = data
        except (OSError, ValueError) as e:
            L.debug("sync state unreadable at %s (fresh start): %s",
                    path, e)
        return st

    @property
    def resuming(self) -> bool:
        return bool(self.data.get("in_progress"))

    def mark_in_progress(self, refstr: str) -> None:
        self.data["in_progress"] = refstr

    def mark_done(self, refstr: str, info: dict | None = None) -> None:
        self.data["done"][refstr] = dict(info or {},
                                         completed_unix=time.time())
        if self.data.get("in_progress") == refstr:
            self.data["in_progress"] = None

    def save(self) -> None:
        self.data["updated_unix"] = time.time()
        atomicio.replace_json(self.path, self.data, makedirs=True)


def state_path(state_root: str, job_id: str) -> str:
    validate.job_id(job_id)
    return os.path.join(state_root, SYNC_DIR, job_id, STATE_JSON)


# -- the engine --------------------------------------------------------------

def _batches(items: Sequence, n: int) -> Iterable[Sequence]:
    for i in range(0, len(items), n):
        yield items[i:i + n]


def _probe(dest, digests: Sequence[bytes], stats: dict) -> list[bool]:
    """One membership batch against the destination — the single
    ``pbsstore.sync.probe`` site plus the probe accounting."""
    failpoints.hit("pbsstore.sync.probe")
    with trace.span("sync.negotiate", chunks=len(digests)):
        present = dest.probe_chunks(digests)
    if len(present) != len(digests):
        raise SyncError("destination answered a probe batch with the "
                        f"wrong arity ({len(present)}/{len(digests)})")
    stats["chunks_probed"] += len(digests)
    stats["probe_batches"] += 1
    hits = sum(1 for p in present if p)
    stats["chunks_skipped"] += hits
    METRICS.add("chunks_probed", len(digests))
    METRICS.add("probe_batches")
    if hits:
        METRICS.add("chunks_skipped", hits)
    return present


def _transfer_order(pairs: list[tuple[bytes, bytes]]
                    ) -> list[tuple[bytes, bytes]]:
    """Bases-first insert order: full blobs, then delta blobs by
    ascending chain depth — a delta's base (depth d-1) always lands
    before the delta (depth d), so the destination's read-back
    verification can reassemble immediately."""
    from .deltablob import DeltaError, is_delta, parse_header

    def key(pair: tuple[bytes, bytes]) -> int:
        payload = pair[1]
        if not is_delta(payload):
            return -1
        try:
            return parse_header(payload)[1]
        except DeltaError:
            return 255          # ordered last; insert_raw rejects it
    return sorted(pairs, key=key)


def _ordered_digests(midx: DynamicIndex, pidx: DynamicIndex) -> list[bytes]:
    """Unique digest list, meta stream first (its chunks decode the
    tree), preserving stream order."""
    seen: set[bytes] = set()
    out: list[bytes] = []
    for idx in (midx, pidx):
        for i in range(len(idx)):
            d = idx.digest(i)
            if d not in seen:
                seen.add(d)
                out.append(d)
    return out


def _mirror_one(source, dest, ref: SnapshotRef, batch: int,
                stats: dict, state: "SyncState | None") -> None:
    refstr = str(ref)
    if state is not None:
        state.mark_in_progress(refstr)
        state.save()
    files = source.snapshot_files(ref)
    meta_raw = files.get(Datastore.META_IDX) or \
        files.get(Datastore.META_IDX_PBS)
    payload_raw = files.get(Datastore.PAYLOAD_IDX) or \
        files.get(Datastore.PAYLOAD_IDX_PBS)
    if meta_raw is None or payload_raw is None:
        raise SyncError(f"snapshot {refstr} is missing index files "
                        f"({sorted(files)})")
    midx = _parse_index_bytes(meta_raw)
    pidx = _parse_index_bytes(payload_raw)
    snap_wire = 0
    snap_transferred = 0
    for chunk_batch in _batches(_ordered_digests(midx, pidx), batch):
        present = _probe(dest, chunk_batch, stats)
        missing = [d for d, ok in zip(chunk_batch, present) if not ok]
        if not missing:
            continue
        # close the missing set over delta bases on the SOURCE, then
        # membership-probe the closure like any other digests — only
        # absent bases transfer
        extra = source.closure_extra(missing)
        if extra:
            extra_present = _probe(dest, extra, stats)
            missing = [d for d, ok in zip(extra, extra_present)
                       if not ok] + missing
        with trace.span("sync.transfer", chunks=len(missing)):
            payloads = source.fetch_chunks(missing)
            pairs: list[tuple[bytes, bytes]] = []
            for digest, payload in zip(missing, payloads):
                # the one wire-fault site: raise/drop model transport
                # death, corrupt flips a payload byte that the
                # destination's verification MUST catch (no torn chunks)
                payload = failpoints.hit("pbsstore.sync.transfer",
                                         payload)
                pairs.append((digest, payload))
            dest.insert_chunks(_transfer_order(pairs))
        nbytes = sum(len(p) for _, p in pairs)
        snap_wire += nbytes
        snap_transferred += len(pairs)
        stats["chunks_transferred"] += len(pairs)
        stats["bytes_wire"] += nbytes
        METRICS.add("chunks_transferred", len(pairs))
        METRICS.add("bytes_wire", nbytes)
    # fires before the atomic publish: a fault here leaves transferred
    # chunks (they dedup on resume) but never a visible half-snapshot
    failpoints.hit("pbsstore.sync.commit")
    dest.publish(ref, files)
    try:
        man = json.loads(files[Datastore.MANIFEST])
        logical = int(man.get("payload_size", 0)) + \
            int(man.get("meta_size", 0))
    except (ValueError, TypeError):
        logical = 0
    stats["snapshots_synced"] += 1
    stats["bytes_logical"] += logical
    METRICS.add("snapshots")
    METRICS.add("bytes_logical", logical)
    if state is not None:
        state.mark_done(refstr, {
            "chunks_transferred": snap_transferred,
            "bytes_wire": snap_wire})
        state.save()


def run_sync(source, dest, *, job_id: str = "sync",
             state_root: "str | None" = None,
             backup_type: str = "", backup_id: str = "",
             namespace: "str | None" = None,
             batch: "int | None" = None) -> dict:
    """Replicate every matching published snapshot from ``source`` to
    ``dest``; returns the run's stats report.  Blocking — the job layer
    runs it in an executor.  Raises :class:`SyncError` on any failure;
    partial progress (transferred chunks, completed snapshots) is
    durable and strictly reduces the next run's work."""
    if batch is None:
        batch = conf.env().sync_batch
    batch = max(1, int(batch))
    t0 = time.perf_counter()
    METRICS.add("jobs")
    stats = {"snapshots_considered": 0, "snapshots_synced": 0,
             "snapshots_skipped": 0, "chunks_probed": 0,
             "probe_batches": 0, "chunks_skipped": 0,
             "chunks_transferred": 0, "bytes_wire": 0, "bytes_logical": 0,
             "resumed": False}
    state = None
    if state_root:
        state = SyncState.load(state_path(state_root, job_id))
        if state.resuming:
            stats["resumed"] = True
            METRICS.add("resumes")
    try:
        snaps = source.list_snapshots(backup_type, backup_id, namespace)
        snaps.sort(key=lambda r: (r.namespace, r.backup_type,
                                  r.backup_id, r.backup_time))
        for ref in snaps:
            stats["snapshots_considered"] += 1
            if dest.has_snapshot(ref):
                stats["snapshots_skipped"] += 1
                if state is not None and \
                        state.data.get("in_progress") == str(ref):
                    # a predecessor died between publish and mark_done:
                    # the snapshot IS there, so the entry is complete
                    state.mark_done(str(ref))
                continue
            try:
                _mirror_one(source, dest, ref, batch, stats, state)
            except SyncError:
                raise
            except Exception as e:
                raise SyncError(f"sync of {ref} failed: "
                                f"{type(e).__name__}: {e}") from e
        if state is not None:
            # a fully-successful pass owes no resume to anyone — clear
            # any stale in_progress (e.g. its snapshot was pruned from
            # the source) so later runs never miscount as resumes
            state.data["in_progress"] = None
            state.save()
    except BaseException:
        METRICS.add("errors")
        raise
    stats["wall_s"] = round(time.perf_counter() - t0, 3)
    return stats


# -- the loopback HTTP wire --------------------------------------------------

class SyncWireServer:
    """Serve a local datastore to sync peers over loopback HTTP
    (ThreadingHTTPServer; the client side is the same ``http.client``
    seam the pbsstore transport uses).  Bearer-token authed; both the
    source vocabulary (pull peers) and the destination vocabulary (push
    peers) are exposed."""

    def __init__(self, ds: Datastore, token: str,
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        source = LocalSyncSource(ds)
        dest = LocalSyncDest(ds)
        want = token

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):          # quiet
                pass

            def _q(self):
                u = urllib.parse.urlparse(self.path)
                # keep_blank_values: "ns=" means ROOT namespace only —
                # dropping the blank pair would silently widen the
                # filter to all namespaces (ns absent)
                return u.path, dict(urllib.parse.parse_qsl(
                    u.query, keep_blank_values=True))

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/octet-stream") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _authed(self) -> bool:
                got = self.headers.get("Authorization", "")
                if not got.startswith("Bearer "):
                    return False
                return hmac.compare_digest(got[7:], want)

            def _ref(self, params) -> SnapshotRef:
                return parse_snapshot_ref(params.get("snap", ""))

            def _handle(self, method: str) -> None:
                path, params = self._q()
                if not path.startswith(WIRE_PREFIX):
                    return self._json(404, {"error": "not found"})
                if not self._authed():
                    return self._json(401, {"error": "unauthorized"})
                ep = path[len(WIRE_PREFIX):]
                # attach the puller/pusher's trace context from the
                # request header (handler threads have none of their
                # own) — this server's spans join the caller's trace
                tctx = trace.parse_header(
                    self.headers.get(trace.TRACE_HEADER))
                with trace.attached(tctx), \
                        trace.span("sync.serve", endpoint=ep):
                    return self._serve(method, ep, params)

            def _serve(self, method: str, ep: str, params) -> None:
                try:
                    if method == "GET" and ep == "/snapshots":
                        ns = params.get("ns")
                        refs = source.list_snapshots(
                            params.get("type", ""), params.get("id", ""),
                            namespace=ns)
                        return self._json(200, {"data": [str(r)
                                                         for r in refs]})
                    if method == "GET" and ep == "/files":
                        files = source.snapshot_files(self._ref(params))
                        return self._send(200, _frame_files(files))
                    if method == "GET" and ep == "/has":
                        present = dest.has_snapshot(self._ref(params))
                        return self._json(200, {"present": present})
                    if method == "POST" and ep == "/closure":
                        digs = _split_digests(self._body())
                        return self._send(
                            200, b"".join(source.closure_extra(digs)))
                    if method == "POST" and ep == "/chunks":
                        digs = _split_digests(self._body())
                        out = []
                        for d in digs:
                            try:
                                payload = ds.chunks.get_raw(d)
                            except FileNotFoundError:
                                out.append(d + _LEN.pack(_MISSING))
                                continue
                            out.append(d + _LEN.pack(len(payload))
                                       + payload)
                        return self._send(200, b"".join(out))
                    if method == "POST" and ep == "/probe":
                        digs = _split_digests(self._body())
                        present = dest.probe_chunks(digs)
                        return self._send(
                            200, bytes(1 if p else 0 for p in present))
                    if method == "POST" and ep == "/upload":
                        pairs = _unframe_chunks(self._body())
                        n = dest.insert_chunks(pairs)
                        return self._json(200, {"inserted": n})
                    if method == "POST" and ep == "/publish":
                        files = _unframe_files(self._body())
                        dest.publish(self._ref(params), files)
                        return self._json(200, {"ok": True})
                    return self._json(404, {"error": f"no endpoint {ep}"})
                except (SyncError, ValueError) as e:
                    return self._json(400, {"error": str(e)})
                except OSError as e:
                    return self._json(500, {"error": str(e)})

            def do_GET(self):          # noqa: N802 (stdlib handler names)
                self._handle("GET")

            def do_POST(self):         # noqa: N802
                self._handle("POST")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: "threading.Thread | None" = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="sync-wire", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


class _WireClient:
    """Minimal persistent-connection HTTP client for the sync wire —
    the pbsstore ``_PBSHttp`` seam: one ``http.client`` connection,
    re-dialed once on transport death, every response status-checked."""

    def __init__(self, base_url: str, token: str, *,
                 timeout_s: float = 60.0):
        u = urllib.parse.urlparse(base_url)
        if u.scheme not in ("http", "https"):
            raise SyncWireError(f"unsupported wire scheme {u.scheme!r}")
        self._https = u.scheme == "https"
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if self._https else 80)
        self._token = token
        self._timeout = timeout_s
        self._conn: "http.client.HTTPConnection | None" = None
        self._lock = threading.Lock()

    def _connect(self) -> http.client.HTTPConnection:
        if self._conn is None:
            cls = (http.client.HTTPSConnection if self._https
                   else http.client.HTTPConnection)
            self._conn = cls(self._host, self._port,
                             timeout=self._timeout)
        return self._conn

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def request(self, method: str, ep: str,
                params: dict | None = None,
                body: bytes = b"") -> bytes:
        path = WIRE_PREFIX + ep
        if params:
            path += "?" + urllib.parse.urlencode(params)
        # trace context crosses the wire as an HTTP header, so the
        # peer's serve spans parent under this sync job's trace
        headers = trace.headers_out(
            {"Authorization": f"Bearer {self._token}",
             "Content-Length": str(len(body))})
        with self._lock:
            for attempt in (0, 1):
                conn = self._connect()
                try:
                    conn.request(method, path, body=body, headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    break
                except (ConnectionError, http.client.HTTPException,
                        OSError) as e:
                    # one clean re-dial: keep-alive raced the server's
                    # idle close; a second failure is real trouble
                    self._conn = None
                    if attempt:
                        raise SyncWireError(
                            f"wire {method} {ep} failed: {e}") from e
        if resp.status != 200:
            try:
                msg = json.loads(data).get("error", "")
            except ValueError:
                msg = data[:200].decode("latin1")
            raise SyncWireError(f"wire {method} {ep}: HTTP "
                                f"{resp.status}: {msg}")
        return data


class HttpSyncSource:
    """Pull-side remote source: a peer's :class:`SyncWireServer`."""

    def __init__(self, base_url: str, token: str, *,
                 timeout_s: float = 60.0):
        self._wire = _WireClient(base_url, token, timeout_s=timeout_s)

    def close(self) -> None:
        self._wire.close()

    def list_snapshots(self, backup_type: str = "", backup_id: str = "",
                       namespace: "str | None" = None) -> list[SnapshotRef]:
        params = {}
        if backup_type:
            params["type"] = backup_type
        if backup_id:
            params["id"] = backup_id
        if namespace is not None:
            params["ns"] = namespace
        raw = self._wire.request("GET", "/snapshots", params)
        return [parse_snapshot_ref(s)
                for s in json.loads(raw).get("data", [])]

    def snapshot_files(self, ref: SnapshotRef) -> dict[str, bytes]:
        raw = self._wire.request("GET", "/files", {"snap": str(ref)})
        return _unframe_files(raw)

    def fetch_chunks(self, digests: Sequence[bytes]) -> list[bytes]:
        raw = self._wire.request("POST", "/chunks",
                                 body=b"".join(digests))
        by_digest = dict(_unframe_chunks(raw))
        try:
            return [by_digest[d] for d in digests]
        except KeyError as e:
            raise SyncWireError(
                f"peer omitted requested chunk {e.args[0].hex()[:16]}"
            ) from e

    def closure_extra(self, digests: Sequence[bytes]) -> list[bytes]:
        raw = self._wire.request("POST", "/closure",
                                 body=b"".join(digests))
        return _split_digests(raw)


class HttpSyncDest:
    """Push-side remote destination: a peer's :class:`SyncWireServer`.
    Membership stays batched end to end — one POST /probe per batch is
    one vectorized ``probe_batch`` on the peer."""

    def __init__(self, base_url: str, token: str, *,
                 timeout_s: float = 60.0):
        self._wire = _WireClient(base_url, token, timeout_s=timeout_s)

    def close(self) -> None:
        self._wire.close()

    def has_snapshot(self, ref: SnapshotRef) -> bool:
        raw = self._wire.request("GET", "/has", {"snap": str(ref)})
        return bool(json.loads(raw).get("present"))

    def probe_chunks(self, digests: Sequence[bytes]) -> list[bool]:
        raw = self._wire.request("POST", "/probe",
                                 body=b"".join(digests))
        if len(raw) != len(digests):
            raise SyncWireError("probe answer arity mismatch")
        return [bool(b) for b in raw]

    def insert_chunks(self, pairs: Sequence[tuple[bytes, bytes]]) -> int:
        raw = self._wire.request("POST", "/upload",
                                 body=_frame_chunks(pairs))
        return int(json.loads(raw).get("inserted", 0))

    def publish(self, ref: SnapshotRef, files: dict[str, bytes]) -> None:
        self._wire.request("POST", "/publish", {"snap": str(ref)},
                           body=_frame_files(files))
