"""VerifyPipeline: batched re-hash verification of stored chunks and files
on the card.

Counterpart of the JAX package's ``models/verify.py``: re-hash chunk
payloads with kernel K2 (``ops/sha256.py``), thousands of chunks per
launch, and compare with the index digests.  Where the JAX package probed
for a live accelerator, the device is explicit here: on ``cuda`` a
snapshot's fetched chunks are cross-checked through K2; on ``cpu`` the
fetch alone gives the verdict (a store's chunk read verifies SHA-256 on
load), as in the JAX package's CPU branch.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..ops.sha256 import sha256_chunks, sha256_stream_chunks
from ..utils.device import resolve

L = logging.getLogger(__name__)


@dataclass
class VerifyResult:
    checked: int = 0
    corrupt: list[int] = field(default_factory=list)   # indexes of failures
    # archive paths of the corrupt indexes, filled by verify_snapshot (the
    # sampled set is random, so bare indexes are unactionable in a report)
    corrupt_paths: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.corrupt


class VerifyPipeline:
    """Batch verifier on ``device``: compare recomputed digests against
    expected ones."""

    def __init__(self, *, device="cuda"):
        self.device = resolve(device)

    def verify_chunks(self, chunks: list[bytes],
                      expected: list[bytes]) -> VerifyResult:
        if len(chunks) != len(expected):
            raise ValueError("chunks/expected length mismatch")
        res = VerifyResult(checked=len(chunks))
        got = sha256_chunks(chunks, device=self.device)
        for i, (g, w) in enumerate(zip(got, expected)):
            if g != w:
                res.corrupt.append(i)
        return res

    def verify_stream(self, stream, bounds: list[tuple[int, int]],
                      expected: list[bytes]) -> VerifyResult:
        """Verify chunks of one stream buffer in place (bytes, an array, or
        a uint8 tensor already on the card)."""
        if len(bounds) != len(expected):
            raise ValueError("bounds/expected length mismatch")
        res = VerifyResult(checked=len(bounds))
        got = sha256_stream_chunks(stream, bounds, device=self.device)
        for i, (g, w) in enumerate(zip(got, expected)):
            if g != w:
                res.corrupt.append(i)
        return res

    def verify_snapshot(self, reader, *, sample_rate: float = 1.0,
                        rng: np.random.Generator | None = None,
                        workers: int = 0) -> VerifyResult:
        """Spot-check a snapshot through a duck-typed reader (``entries``,
        ``read_file``, ``meta_index``/``payload_index``, ``fetch_chunk``):
        systematic sampling of file entries, batched re-hash against the
        stored entry digests.

        ``workers > 1`` fetches on a thread pool; verdicts and their order
        are the same as the sequential run's, since parallelism reorders
        only the IO."""
        rng = rng or np.random.default_rng(0)
        files = [e for e in reader.entries()
                 if e.is_file and e.size and e.digest]
        if not files:
            # archives without per-entry digests: verify chunks against
            # the index digests, as a stock PBS verify job does
            return self._verify_snapshot_chunks(reader, sample_rate, rng,
                                                workers=workers)
        if sample_rate < 1.0:
            k = max(1, int(len(files) * sample_rate))
            idx = np.sort(rng.choice(len(files), size=k, replace=False))
            files = [files[i] for i in idx]
        if workers and workers > 1 and len(files) > 1:
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="verify") as pool:
                chunks = list(pool.map(reader.read_file, files))
        else:
            chunks = [reader.read_file(e) for e in files]
        res = self.verify_chunks(chunks, [e.digest for e in files])
        res.corrupt_paths = [files[i].path for i in res.corrupt]
        return res

    def _verify_snapshot_chunks(self, reader, sample_rate: float,
                                rng: np.random.Generator,
                                *, workers: int = 0) -> VerifyResult:
        digests: list[bytes] = []
        for index in (reader.meta_index, reader.payload_index):
            digests.extend(index.digest(i) for i in range(len(index.ends)))
        if sample_rate < 1.0 and digests:
            k = max(1, int(len(digests) * sample_rate))
            idx = np.sort(rng.choice(len(digests), size=k, replace=False))
            digests = [digests[i] for i in idx]
        digests = list(dict.fromkeys(digests))   # meta/payload may share
        res = VerifyResult(checked=len(digests))
        cross_check = self.device.type == "cuda"

        def fetch(d: bytes) -> bytes | None:
            # the store's chunk read verifies SHA-256 on load and never
            # admits a failed load, so a successful fetch is a verdict
            try:
                return reader.fetch_chunk(d)
            except Exception as e:
                L.debug("verify: chunk %s unreadable: %s", d.hex()[:16], e)
                return None

        pool = (ThreadPoolExecutor(max_workers=workers,
                                   thread_name_prefix="verify")
                if workers and workers > 1 and len(digests) > 1 else None)
        # waves bound the fetched bytes in flight; the wave size is fixed,
        # independent of the worker count, so the K2 flush boundaries and
        # therefore the verdict order are the same for any worker count
        wave = 8
        pending: list[tuple[int, bytes, bytes]] = []    # K2 cross-check
        pending_bytes = 0
        batch_bytes = 64 << 20

        def flush_device() -> None:
            nonlocal pending, pending_bytes
            if not pending:
                return
            sub = self.verify_chunks([g[2] for g in pending],
                                     [g[1] for g in pending])
            for j in sub.corrupt:
                res.corrupt.append(pending[j][0])
                res.corrupt_paths.append(f"chunk:{pending[j][1].hex()}")
            pending, pending_bytes = [], 0

        try:
            for base in range(0, len(digests), wave):
                batch = digests[base:base + wave]
                datas = list(pool.map(fetch, batch)) if pool is not None \
                    else [fetch(d) for d in batch]
                for j, (d, data) in enumerate(zip(batch, datas)):
                    if data is None:
                        res.corrupt.append(base + j)
                        res.corrupt_paths.append(f"chunk:{d.hex()}")
                    elif cross_check:
                        pending.append((base + j, d, data))
                        pending_bytes += len(data)
                # without the cross-check nothing is retained: the fetch
                # was the verdict, and the bytes are released per wave
                if pending_bytes >= batch_bytes:
                    flush_device()
            flush_device()
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        return res
