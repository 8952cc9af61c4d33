"""Tape ingestion: MTF/BKF archives → tpxar snapshots.

Reference: internal/tapeio + internal/changer + cmd/{bkf2pxar,mtfprobe}
(~3.5k LoC, SURVEY §2.8) — a Microsoft-Tape-Format reader (external
github.com/pbs-plus/go-mtf), a disk-backed spool/feeder pipeline with
bounded memory (feeder.go), the MTF→pxar converter with buzhash chunking +
dedup upload (converter.go:14-330), LTO drive control, PBS drive locks and
a SCSI media changer (sg ioctls).

This build implements:
- ``mtf``: a clean-room MTF 1.00a subset reader (TAPE/SSET/VOLB/DIRB/FILE
  descriptor blocks + data streams) — enough to walk BKF-style media and
  extract the directory/file payloads
- ``feeder``: bounded-memory spool between the (sequential, fast-wins)
  tape reader and the (possibly slower) dedup writer
- ``converter``: MTF media → BackupSession snapshot through the standard
  chunker interface (CPU/TPU/sidecar all apply)
- ``changer``: SCSI media-changer abstraction (mtx/sg gated on
  availability, with an injectable transport for tests)

A copy of the JAX package's ``tapeio/__init__.py``, its code byte for
byte.
"""

from .mtf import MTFReader, MTFEntry, write_synthetic_mtf
from .feeder import Spool
from .converter import convert_mtf_to_snapshot
from .changer import MediaChanger

__all__ = ["MTFReader", "MTFEntry", "write_synthetic_mtf", "Spool",
           "convert_mtf_to_snapshot", "MediaChanger"]
