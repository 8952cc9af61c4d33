"""Atomic publish of durable on-disk state.

A copy of what the port's index tier uses from the JAX package's
``utils/atomicio.py``: stage under a same-directory tmp name carrying the
pid, write, optionally fsync, then ``os.replace`` into place, so a reader
never sees a torn file and a crash leaves only reapable ``.tmp`` debris.  The staging names are
the reference's, so the two packages' fs witnesses classify the same
paths alike.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

# the staging-name vocabulary: every helper below stages under a name
# is_staging_path() recognizes, and the fs witness uses the same predicate
# to tell a staged write from a torn one
_STAGING_MARKERS = (".tmp.", ".tmp-", "stage-")


def is_staging_path(path: str) -> bool:
    """True when ``path`` names (or lives under) staging debris, never
    published state.  Checked against the whole path: a file written
    inside a staged directory is staged too."""
    p = path.replace(os.sep, "/")
    return any(m in p for m in _STAGING_MARKERS) or \
        os.path.basename(p).startswith(".gc-mark-")


def tmp_path_for(path: str) -> str:
    """Same-directory staging name for ``path`` (same filesystem, so the
    rename is atomic)."""
    return f"{path}.tmp.{os.getpid()}"


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass            # staging debris; the store sweep reaps leftovers


def replace_bytes(path: str, data: bytes, *, fsync: bool = False) -> None:
    """Atomically publish ``data`` at ``path`` (tmp + write + optional
    fsync + rename)."""
    tmp = tmp_path_for(path)
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        _unlink_quiet(tmp)
        raise


@contextmanager
def atomic_write(path: str):
    """Streamed atomic publish: yields a binary file over the staging
    name, renames into place on clean exit, unlinks the staging file on
    error."""
    tmp = tmp_path_for(path)
    try:
        with open(tmp, "wb") as fh:
            yield fh
        os.replace(tmp, path)
    except BaseException:
        _unlink_quiet(tmp)
        raise
