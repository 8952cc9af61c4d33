"""DeviceFeeder: the cross-stream batch aggregator for device dispatches.

Counterpart of the JAX package's ``models/feeder.py``.  N concurrent backup
writers each own a streaming ``CudaChunker``; without aggregation each feed
would dispatch its own ``[1, S]`` candidate kernel and its own SHA batch.

    writer threads ──submit──▶ pending queues ──▶ [feeder thread]
      candidate req (buf, history, params)          groups by params,
      sha req (chunk list)                          pads to [B, S_pad],
                                                    ONE device dispatch,
      ◀──────── per-request results ◀────────────── splits results

While the feeder thread dispatches batch *k*, new requests accumulate and
form batch *k+1*; a small optional linger widens batches when only one
request is pending.  Rows of a batched dispatch are computed independently,
so results are bit-identical to solo dispatches.  A failed batch is retried
one request at a time on the same device, so a failure reaches only its
owner; nothing is retried on the CPU.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..chunker.spec import ChunkerParams
from ..ops.rolling_hash import batched_candidate_hits, device_tables
from ..ops.sha256 import sha256_chunks
from ..utils.device import resolve

# combined SHA dispatch cap: bounds the one-dispatch device buffer when
# many writers flush 64 MiB hash batches at once
_SHA_BATCH_BYTES_CAP = 256 << 20
# candidate batch row cap per dispatch
_MASK_BATCH_ROWS_CAP = 64


@dataclass
class _MaskReq:
    buf: np.ndarray                 # uint8[S], S > 0
    history: np.ndarray             # uint8[WINDOW-1]
    key: tuple                      # (seed, mask, magic) — batch group key
    params: ChunkerParams
    done: threading.Event = field(default_factory=threading.Event)
    hits: Optional[np.ndarray] = None    # relative candidate positions
    exc: Optional[BaseException] = None


@dataclass
class _ShaReq:
    chunks: list                    # list[bytes]
    nbytes: int
    done: threading.Event = field(default_factory=threading.Event)
    digests: Optional[list] = None
    exc: Optional[BaseException] = None


class DeviceFeeder:
    """Aggregator for one device: many streams' device work → few batched
    dispatches.  All device calls happen on the one feeder thread."""

    def __init__(self, *, linger_s: float | None = None, device="cuda"):
        if linger_s is None:
            linger_s = float(os.environ.get("PBS_PLUS_FEEDER_LINGER_S",
                                            "0.002"))
        self.linger_s = linger_s
        self.device = resolve(device)
        self._cv = threading.Condition()
        self._mask_q: list[_MaskReq] = []
        self._sha_q: list[_ShaReq] = []
        self._thread: Optional[threading.Thread] = None
        self._tables_cache: dict[tuple, torch.Tensor] = {}
        self.stats = {"mask_dispatches": 0, "mask_rows": 0,
                      "max_mask_batch": 0, "sha_dispatches": 0,
                      "sha_streams": 0, "max_sha_streams": 0}

    # -- public API (writer threads) --------------------------------------
    def candidate_hits(self, buf: np.ndarray, history: np.ndarray,
                       params: ChunkerParams) -> np.ndarray:
        """Relative candidate positions (0-based, where the rolling hash
        matched) within ``buf``.  Blocks the calling writer thread until
        the batched dispatch lands."""
        req = _MaskReq(buf=buf, history=history,
                       key=(params.seed, params.mask, params.magic),
                       params=params)
        self._submit(self._mask_q, req)
        req.done.wait()
        if req.exc is not None:
            raise req.exc
        return req.hits

    def sha256_batch(self, chunks: list) -> list:
        """Digest a list of chunk buffers; coalesced with other streams'
        pending batches into one device dispatch."""
        if not chunks:
            return []
        req = _ShaReq(chunks=chunks, nbytes=sum(len(c) for c in chunks))
        self._submit(self._sha_q, req)
        req.done.wait()
        if req.exc is not None:
            raise req.exc
        return req.digests

    # -- internals ---------------------------------------------------------
    def _submit(self, q: list, req) -> None:
        with self._cv:
            q.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="device-feeder", daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._mask_q and not self._sha_q:
                    self._cv.wait()
                if (self.linger_s > 0
                        and len(self._mask_q) + len(self._sha_q) == 1):
                    self._cv.wait(self.linger_s)
                # drain in place: the queue list objects are permanent
                mask_reqs = self._mask_q[:]
                self._mask_q.clear()
                sha_reqs = self._take_sha_locked()
            # nothing may kill this thread while drained requests are
            # unserved: waiters block with no timeout
            try:
                if mask_reqs:
                    self._dispatch_masks(mask_reqs)
                if sha_reqs:
                    self._dispatch_sha(sha_reqs)
            except BaseException as e:
                for r in mask_reqs + sha_reqs:
                    if not r.done.is_set():
                        r.exc = e
                        r.done.set()

    def _take_sha_locked(self) -> list[_ShaReq]:
        out, total = [], 0
        while self._sha_q and (not out
                               or total + self._sha_q[0].nbytes
                               <= _SHA_BATCH_BYTES_CAP):
            r = self._sha_q.pop(0)
            out.append(r)
            total += r.nbytes
        return out

    def _tables(self, key: tuple, params: ChunkerParams) -> torch.Tensor:
        t = self._tables_cache.get(key)
        if t is None:
            t = self._tables_cache[key] = device_tables(params, self.device)
        return t

    def _dispatch_masks(self, reqs: list[_MaskReq]) -> None:
        groups: dict[tuple, list[_MaskReq]] = {}
        for r in reqs:
            groups.setdefault(r.key, []).append(r)
        for key, group in groups.items():
            for i in range(0, len(group), _MASK_BATCH_ROWS_CAP):
                self._dispatch_mask_group(key, group[i:i + _MASK_BATCH_ROWS_CAP])

    def _dispatch_mask_group(self, key: tuple, group: list[_MaskReq]) -> None:
        params = group[0].params
        try:
            hits = batched_candidate_hits([r.buf for r in group],
                                          [r.history for r in group],
                                          self._tables(key, params), params)
            self.stats["mask_dispatches"] += 1
            self.stats["mask_rows"] += len(group)
            self.stats["max_mask_batch"] = max(self.stats["max_mask_batch"],
                                               len(group))
            for r, h in zip(group, hits):
                r.hits = h
                r.done.set()
        except BaseException:
            # failure isolation: retry each stream's request alone, on the
            # same device, so a poisoned input (or a batch-sized OOM) fails
            # only its owner
            for r in group:
                try:
                    r.hits = batched_candidate_hits(
                        [r.buf], [r.history], self._tables(key, params),
                        params)[0]
                    self.stats["mask_dispatches"] += 1
                    self.stats["mask_rows"] += 1
                except BaseException as e:
                    r.exc = e
                r.done.set()

    def _dispatch_sha(self, reqs: list[_ShaReq]) -> None:
        try:
            all_chunks: list = []
            for r in reqs:
                all_chunks.extend(r.chunks)
            digests = sha256_chunks(all_chunks, device=self.device)
            self.stats["sha_dispatches"] += 1
            self.stats["sha_streams"] += len(reqs)
            self.stats["max_sha_streams"] = max(self.stats["max_sha_streams"],
                                                len(reqs))
            off = 0
            for r in reqs:
                r.digests = digests[off:off + len(r.chunks)]
                off += len(r.chunks)
                r.done.set()
        except BaseException:
            # same isolation contract as the mask path
            for r in reqs:
                try:
                    r.digests = sha256_chunks(r.chunks, device=self.device)
                    self.stats["sha_dispatches"] += 1
                    self.stats["sha_streams"] += 1
                except BaseException as e:
                    r.exc = e
                r.done.set()


_feeders: dict[str, DeviceFeeder] = {}
_feeders_lock = threading.Lock()


def get_feeder(device="cuda") -> DeviceFeeder:
    """The process-wide feeder of ``device`` (one per device)."""
    key = str(resolve(device))
    with _feeders_lock:
        f = _feeders.get(key)
        if f is None:
            f = _feeders[key] = DeviceFeeder(device=key)
        return f
