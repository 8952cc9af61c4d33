"""One-true atomic publish helpers for durable on-disk state.

Every durability path family the system owns — dedup-index snapshots
and manifests (``.chunkindex``), digestlog segments, backup checkpoints
(``.ckpt``), sync progress state (``.sync/state.json``), shard-map
snapshots, chunk payloads, snapshot manifests — must land through this
module.  The discipline is always the same: stage under a
same-directory tmp name carrying the pid (and tid where co-resident
writers exist), write, optionally fsync, then ``os.replace`` into
place, so a reader can never observe a torn file and a crash leaves
only reapable ``.tmp`` debris.  The shared-store variant
(``claim_bytes``) publishes by ``os.link`` CAS instead: the final path
is CREATED, never replaced, so exactly one process's bytes win.

This used to be copy-pasted into six persistence sites; pbslint's
``durable-write-discipline`` rule (tools/lint/protocols.py,
docs/protocols.md) now enforces structurally that durable modules
publish only through here, and the runtime witness
(``utils/fswitness.py``) asserts the same property dynamically by
intercepting the fs calls this module makes.

A copy of the JAX package's ``utils/atomicio.py``, its code byte for
byte apart from its imports, which name the port's own modules; the
staging names are the reference's, so the two packages' fs witnesses
classify the same paths alike."""

from __future__ import annotations

import os
import shutil
import threading
from contextlib import contextmanager

# the staging-name vocabulary: every helper below stages under a name
# is_staging_path() recognizes, and the runtime witness uses the same
# predicate to tell a staged write from a torn one
_STAGING_MARKERS = (".tmp.", ".tmp-", "stage-")


def is_staging_path(path: str) -> bool:
    """True when ``path`` names (or lives under) staging debris, never
    published state — the fs witness's write filter.  Checked against
    the WHOLE path: a file written inside a staged directory is staged
    too (the nested-rename case)."""
    p = path.replace(os.sep, "/")
    return any(m in p for m in _STAGING_MARKERS) or \
        os.path.basename(p).startswith(".gc-mark-")


def tmp_path_for(path: str, *, per_thread: bool = False) -> str:
    """Same-directory staging name for ``path`` (same filesystem, so
    the rename is atomic).  ``per_thread`` adds the thread id for
    paths co-resident writer threads may stage concurrently."""
    if per_thread:
        return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    return f"{path}.tmp.{os.getpid()}"


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass            # staging debris; the store sweep reaps leftovers


def write_bytes(path: str, data: bytes) -> None:
    """Plain (NON-atomic) write — only for paths inside a
    ``staged_dir`` whose publish is the atomic step, so the durable
    module never needs a raw ``open(..., "wb")`` of its own."""
    with open(path, "wb") as fh:
        fh.write(data)


def replace_bytes(path: str, data: bytes, *, fsync: bool = False,
                  per_thread: bool = False, makedirs: bool = False,
                  mode_bits: "int | None" = None) -> None:
    """Atomically publish ``data`` at ``path`` (tmp + write + optional
    fsync + rename).  ``mode_bits`` creates the file with restrictive
    permissions from the first byte (e.g. ``0o600`` key material) —
    chmod-after-write would race a reader."""
    if makedirs:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = tmp_path_for(path, per_thread=per_thread)
    try:
        if mode_bits is None:
            fh = open(tmp, "wb")
        else:
            fh = os.fdopen(os.open(
                tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode_bits),
                "wb")
        with fh:
            fh.write(data)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        _unlink_quiet(tmp)
        raise


def replace_json(path: str, obj, *, indent: int = 1,
                 sort_keys: bool = True, makedirs: bool = False) -> None:
    """Atomically publish ``obj`` as stable, diffable JSON."""
    import json
    replace_bytes(
        path,
        json.dumps(obj, indent=indent, sort_keys=sort_keys)
        .encode("utf-8"),
        makedirs=makedirs)


@contextmanager
def atomic_write(path: str, *, fsync: bool = False,
                 per_thread: bool = False):
    """Context manager for streamed atomic publishes: yields a binary
    file over the staging name, renames into place on clean exit,
    unlinks the staging file on error."""
    tmp = tmp_path_for(path, per_thread=per_thread)
    try:
        with open(tmp, "wb") as fh:
            yield fh
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        _unlink_quiet(tmp)
        raise


def claim_bytes(path: str, data: bytes) -> bool:
    """Shared-store publish: tmp + ``os.link`` CAS.  The final path is
    CREATED, never replaced, so exactly one writer's bytes become the
    file; False = another process already held it (a cross-process
    dedup hit, never a second write)."""
    tmp = tmp_path_for(path, per_thread=True)
    with open(tmp, "wb") as fh:
        fh.write(data)
    try:
        os.link(tmp, path)
    except FileExistsError:
        return False
    finally:
        _unlink_quiet(tmp)
    return True


@contextmanager
def staged_dir(final: str, *, tmp: "str | None" = None,
               tolerate_existing: bool = False):
    """Atomic DIRECTORY publish: yields a freshly-created staging dir;
    on clean exit renames it to ``final``, on error removes it.
    ``tolerate_existing`` absorbs the concurrent-publisher race (two
    writers staging identical content for one final dir): the rename
    loser just drops its staging dir."""
    if tmp is None:
        tmp = os.path.join(
            os.path.dirname(final),
            f".tmp-{os.path.basename(final)}.{os.getpid()}")
    os.makedirs(tmp)
    try:
        yield tmp
        try:
            os.replace(tmp, final)
        except OSError:
            if not (tolerate_existing and os.path.isdir(final)):
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def publish_staged(tmp: str, final: str) -> None:
    """Rename an externally-staged artifact into place — for staging
    that outlives one ``with`` block (a backup session's snapshot dir,
    a tool that writes its own output file).  The staging name must
    satisfy ``is_staging_path`` so the witness can tell the publish
    from a clobber."""
    os.replace(tmp, final)
