"""DedupPipeline: batched chunk + fingerprint + index probe on the card.

Counterpart of the JAX package's ``models/dedup.py``.  Dataflow per step
(B agent streams at once; the batch axis is the agent fan-in):

    host stream bytes → device rows uint8[B, S] (+ 63-byte histories)
      ├─ K1 candidate mask, hits extracted on the device     (device)
      ├─ greedy min/max cut selection over sparse candidates  (host)
      ├─ K2 SHA-256 over (start, length) slices → digests     (device)
      ├─ K3 cuckoo probe → maybe-present bool[N]              (device)
      └─ authoritative confirm + index insert                 (host)

Streams are processed in segments with 63-byte history halos, so results
are bit-identical to the streaming chunker (same spec, same greedy pass).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..chunker.spec import WINDOW, ChunkerParams, select_cuts
from ..ops.cuckoo import CuckooIndex
from ..ops.rolling_hash import batched_candidate_hits, device_tables
from ..ops.sha256 import sha256_stream_chunks
from ..utils.device import as_u8, host_tensor, resolve

_PIPE_MASK_ROWS = 32          # candidate-batch row cap per dispatch


@dataclass(frozen=True)
class DedupConfig:
    params: ChunkerParams = field(default_factory=lambda: ChunkerParams(avg_size=4 << 20))
    segment_bytes: int = 64 << 20        # device segment per stream per step
    index_buckets: int = 1 << 20         # initial cuckoo table (4M slots)


@dataclass
class ChunkRecord:
    offset: int          # absolute offset in the stream
    length: int
    digest: bytes
    is_new: bool         # not in the chunk index before this step


@dataclass
class StreamResult:
    chunks: list[ChunkRecord] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(c.length for c in self.chunks)

    @property
    def new_bytes(self) -> int:
        return sum(c.length for c in self.chunks if c.is_new)

    @property
    def dedup_ratio(self) -> float:
        t = self.total_bytes
        return 1.0 - (self.new_bytes / t) if t else 0.0


class DedupPipeline:
    """Batched multi-stream dedup on ``device`` (default the card).  Feed
    whole streams, collect per-stream ChunkRecords; cuts and digests are
    bit-identical to the JAX package's pipeline."""

    def __init__(self, config: DedupConfig | None = None, *,
                 index: CuckooIndex | None = None, device="cuda"):
        self.config = config or DedupConfig()
        self.params = self.config.params
        self.device = resolve(device)
        self.index = index if index is not None else CuckooIndex(
            n_buckets=self.config.index_buckets, device=self.device)
        self._tables = device_tables(self.params, self.device)
        self.stats = {"bytes_in": 0, "chunks": 0, "new_chunks": 0,
                      "device_steps": 0, "batched_rows": 0, "max_batch": 0}

    def fingerprint_streams(self, streams: dict[str, bytes | np.ndarray]
                            ) -> dict[str, tuple[list, list[bytes]]]:
        """Chunk + fingerprint complete streams, without the index:
        ``{name: (bounds, digests)}``.  Every stream crosses to the device
        once, into one buffer: segments from different streams are cut
        from it into ``[B, S]`` candidate dispatches (histories are raw
        stream bytes, so every segment is independent), and the SHA-256
        kernel reads every stream's chunks from it in place."""
        names = sorted(streams)
        arrs = {n: as_u8(streams[n]) for n in names}
        base, total = {}, 0
        for n in names:
            base[n] = total
            total += len(arrs[n])
        dstream = torch.empty(total, dtype=torch.uint8, device=self.device)
        for n in names:
            if len(arrs[n]):
                dstream[base[n]:base[n] + len(arrs[n])].copy_(
                    host_tensor(arrs[n]))
        seg = self.config.segment_bytes
        tasks_by_pad: dict[int, list[tuple[str, int, int]]] = {}
        for n in names:
            a = arrs[n]
            self.stats["bytes_in"] += len(a)
            for off in range(0, len(a), seg):
                S = min(seg, len(a) - off)
                S_pad = max(1 << 14, 1 << int(S - 1).bit_length())
                tasks_by_pad.setdefault(S_pad, []).append((n, off, S))
        ends_parts: dict[str, list[np.ndarray]] = {n: [] for n in names}
        for S_pad, tasks in sorted(tasks_by_pad.items()):
            for lo in range(0, len(tasks), _PIPE_MASK_ROWS):
                batch = tasks[lo:lo + _PIPE_MASK_ROWS]
                hits_rows = batched_candidate_hits(
                    [dstream[base[n] + off:base[n] + off + S]
                     for n, off, S in batch],
                    [dstream[base[n] + off - (WINDOW - 1):base[n] + off]
                     if off else None for n, off, S in batch],
                    self._tables, self.params)
                self.stats["device_steps"] += 1
                self.stats["batched_rows"] += len(batch)
                self.stats["max_batch"] = max(self.stats["max_batch"],
                                              len(batch))
                for (n, off, S), hits in zip(batch, hits_rows):
                    valid = hits + off >= WINDOW - 1
                    ends_parts[n].append(hits[valid] + 1 + off)
        bounds_by_stream: dict[str, list[tuple[int, int]]] = {}
        for n in names:
            ends = np.sort(np.concatenate(ends_parts[n])) \
                if ends_parts[n] else np.empty(0, np.int64)
            s = 0
            bounds = []
            for e in select_cuts(ends, len(arrs[n]), self.params):
                bounds.append((s, e))
                s = e
            bounds_by_stream[n] = bounds
        flat = sha256_stream_chunks(
            dstream, [(base[n] + s, base[n] + e) for n in names
                      for s, e in bounds_by_stream[n]])
        out, k = {}, 0
        for n in names:
            c = len(bounds_by_stream[n])
            out[n] = (bounds_by_stream[n], flat[k:k + c])
            k += c
        return out

    def process_streams(self, streams: dict[str, bytes | np.ndarray],
                        ) -> dict[str, StreamResult]:
        """Chunk + fingerprint + probe complete streams (each fully in
        memory): one cross-stream device probe, then the ordered host
        confirm and insert."""
        fp = self.fingerprint_streams(streams)
        names = sorted(fp)
        all_digs = [d for n in names for d in fp[n][1]]
        maybe_all = self.index.probe_confirmed(all_digs) if all_digs else []
        maybe_iter = iter(maybe_all)
        batch_seen: set[bytes] = set()
        out: dict[str, StreamResult] = {}
        for n in names:
            res = StreamResult()
            for (s, e), d in zip(*fp[n]):
                present = next(maybe_iter) or d in batch_seen
                is_new = not present
                if is_new:
                    self.index.insert(d)
                    batch_seen.add(d)
                res.chunks.append(ChunkRecord(s, e - s, d, is_new))
                self.stats["chunks"] += 1
                self.stats["new_chunks"] += int(is_new)
            out[n] = res
        return out


class CudaChunker:
    """Chunker-interface adapter (feed/finalize returning absolute cut
    offsets) whose candidates come from kernel K1.  Counterpart of the JAX
    package's ``TpuChunker``: segment bytes buffer on the host, and
    candidate evaluation goes through the DeviceFeeder of ``device``, which
    coalesces concurrent streams' feeds into ``[B, S]`` dispatches."""

    # device-dispatch counter across all instances
    device_dispatches = 0
    # per-session backend label (rendered in job stats and metrics)
    backend_name = "cuda"

    def __init__(self, params: ChunkerParams, *, device="cuda"):
        self.params = params
        self.device = resolve(device)
        self._tail = np.zeros(WINDOW - 1, dtype=np.uint8)
        self._seen = 0
        self._chunk_start = 0
        self._cand: list[int] = []
        self._cand_drained = 0
        self._finalized = False

    def _candidates(self, data: np.ndarray) -> np.ndarray:
        from .feeder import get_feeder
        CudaChunker.device_dispatches += 1
        hits = get_feeder(self.device).candidate_hits(data, self._tail,
                                                      self.params)
        valid = hits + self._seen >= WINDOW - 1
        return hits[valid] + 1 + self._seen

    def feed(self, data: bytes) -> list[int]:
        if self._finalized:
            raise RuntimeError("chunker already finalized")
        if not data:
            return []
        arr = as_u8(data)
        self._cand.extend(self._candidates(arr).tolist())
        self._seen += len(arr)
        joined = np.concatenate([self._tail, arr])
        self._tail = joined[-(WINDOW - 1):]
        return self._drain(final=False)

    def finalize(self) -> list[int]:
        if self._finalized:
            return []
        self._finalized = True
        return self._drain(final=True)

    def _drain(self, final: bool) -> list[int]:
        pending = np.array(self._cand[self._cand_drained:], dtype=np.int64)
        cuts = select_cuts(pending, self._seen, self.params,
                           start=self._chunk_start, final=final)
        if cuts:
            self._chunk_start = cuts[-1]
            k = self._cand_drained
            while k < len(self._cand) and self._cand[k] <= self._chunk_start:
                k += 1
            self._cand_drained = k
        return cuts
