"""Read/write archive mounts: immutable archive view + journaled mutation
overlay + the dedup re-snapshot (commit) engine.

Reference: internal/pxarmount (~7.6k LoC, SURVEY §2.3) — PxarFS (immutable
FUSE backend with HotSwap), Journal (pebble LSM overlay: nodes/edges/
whiteouts/xattrs, FNV checksums, integrity verify), MutableFS (journal-
over-archive merge, copy-up to a passthrough dir, whiteouts, freeze
barrier), and the 6-phase commit pipeline (freeze → prepare → walk →
upload → verify → hot-swap) with payload-offset-sorted WriteEntryRef
reuse — the north-star TPU path (SURVEY §3.4).

This build implements the engine as a VFS object (MutableFS) with a unix
control socket, so it is embeddable (server-side mounts, tests) — a
kernel-FUSE frontend is a thin adapter planned over libfuse via ctypes;
every operation the FUSE layer needs is already on MutableFS.

The port's copy of the JAX package's ``mount/`` package: ``journal``,
``pxarfs``, ``mutablefs``, ``control`` and ``fusefs`` are copies, and
``commit`` is the twin whose ``CommitEngine`` takes ``device=`` and
verifies on K2.  As there, this package does not import ``fusefs``.
"""

from .journal import Journal, JournalError
from .mutablefs import MutableFS
from .pxarfs import ArchiveView
from .commit import CommitEngine, CommitProgress

__all__ = ["Journal", "JournalError", "MutableFS", "ArchiveView",
           "CommitEngine", "CommitProgress"]
