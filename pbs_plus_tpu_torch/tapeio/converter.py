"""MTF media → tpxar snapshot converter.

Reference: internal/tapeio/converter.go:14-330 — reads MTF entries
sequentially (tape-friendly), pipes file payloads through the spool, and
writes a deduplicated snapshot via the standard chunker interface
(buzhash CDC + dedup upload; here the pluggable CPU/TPU/sidecar backends).

A copy of the JAX package's ``tapeio/converter.py``, its code byte for
byte apart from its logger: ``utils/log.L`` becomes a ``logging``
logger. The session comes from the port's ``LocalStore`` or
``PBSStore``, whose ``device`` (default ``"cuda"``) runs the writer's
cuts (K1), digest flushes (K2) and index probes (K3).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import BinaryIO, Callable

from ..pxar.format import Entry, KIND_DIR, KIND_FILE
from .feeder import Spool, SpoolReader
from .mtf import MTFEntry, MTFReader

L = logging.getLogger(__name__)

READ_BLOCK = 8 << 20

ProgressFn = Callable[[dict], None]


@dataclass
class ConvertResult:
    entries: int = 0
    files: int = 0
    bytes: int = 0
    seconds: float = 0.0
    snapshot: str = ""
    errors: list[str] = field(default_factory=list)


def convert_mtf_to_snapshot(fp: BinaryIO, session, *,
                            spool_cap: int = 256 << 20,
                            spill_dir: str | None = None,
                            progress: ProgressFn | None = None,
                            ) -> ConvertResult:
    """Stream MTF media into an open BackupSession (caller finishes it)."""
    t0 = time.time()
    reader = MTFReader(fp)
    w = session.writer
    res = ConvertResult()
    w.write_entry(Entry(path="", kind=KIND_DIR, mode=0o755))
    res.entries += 1
    emitted_dirs: set[str] = set()

    # Collect + sort first: tape media order follows the original backup
    # tool's traversal, but the archive writer requires strict DFS order.
    # Content reads are ranged into the media file/BKF image (random access
    # is fine there; a streaming physical tape would spool to disk first).
    collected: list[MTFEntry] = []
    entry_iter = reader.entries()
    while True:
        try:
            collected.append(next(entry_iter))
        except StopIteration:
            break
        except Exception as e:
            res.errors.append(f"media: {e}")
            break
    collected.sort(key=lambda e: tuple(e.path.split("/")))

    def ensure_dirs(path: str) -> None:
        parts = path.split("/")[:-1]
        for i in range(1, len(parts) + 1):
            d = "/".join(parts[:i])
            if d and d not in emitted_dirs:
                emitted_dirs.add(d)
                w.write_entry(Entry(path=d, kind=KIND_DIR, mode=0o755))
                res.entries += 1

    for entry in collected:
        if entry.kind == "dir":
            ensure_dirs(entry.path + "/x")   # emits entry.path + parents once
            continue
        ensure_dirs(entry.path)
        # reader thread pumps tape blocks into the spool while the writer
        # chunks the previous blocks (reference: reader→spool→encoder
        # goroutine pipeline with bounded memory)
        spool = Spool(mem_cap=spool_cap, spill_dir=spill_dir)

        def pump(e: MTFEntry = entry, sp: Spool = spool) -> None:
            try:
                off = 0
                while off < e.size:
                    block = reader.read_content(e, off, READ_BLOCK)
                    if not block:
                        break
                    sp.write(block)
                    off += len(block)
            except BaseException as exc:
                sp.fail(exc)
            finally:
                sp.close()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        ok = True
        try:
            w.write_entry_reader(
                Entry(path=entry.path, kind=KIND_FILE, mode=0o644),
                SpoolReader(spool))
        except BaseException as e:
            ok = False
            res.errors.append(f"{entry.path}: {e}")
        t.join()
        spool.cleanup()
        if ok:
            res.entries += 1
            res.files += 1
            res.bytes += entry.size
        if progress is not None:
            dt = max(time.time() - t0, 1e-6)
            progress({"files": res.files, "bytes": res.bytes,
                      "mib_s": res.bytes / dt / (1 << 20)})
    res.seconds = time.time() - t0
    L.info("mtf convert: %d files, %d bytes in %.2fs",
           res.files, res.bytes, res.seconds)
    return res
