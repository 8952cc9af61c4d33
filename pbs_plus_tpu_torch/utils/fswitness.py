"""Runtime filesystem-protocol witness of the port.

A copy of the JAX package's ``utils/fswitness.py``.  While installed, the
witness wraps ``os.rename`` / ``os.replace`` / ``os.link`` / ``os.unlink``
/ ``os.fsync`` and ``builtins.open`` and records a per-path event stream;
the port's code reports semantic protocol events through :func:`note` (a
no-op unless a witness of THIS module is active).  The JAX package's
witness is a separate object: the port's ``note`` calls never reach it,
and its notes never reach this one.  Both wrap the same ``os`` functions,
so with both installed each sees every filesystem call.

Two properties are checked:

**Atomic publish**: a path matching a durability family
(``DEFAULT_FAMILIES``) is only ever written via a staged sibling
(``atomicio.is_staging_path``) that renames or links into place.

**Declared orderings** (``DEFAULT_ORDERINGS``): for every keyed pair --
index discard acked before a chunk file's unlink, digestlog tombstone
before filter fingerprint removal, shard-map install before retire, GC
mark before sweep -- the before-event must precede the after-event for
the same key, once the before-event has been observed at all.
"""

from __future__ import annotations

import builtins
import os
import re
import threading
from contextlib import contextmanager

from . import atomicio

# durability path families, as the JAX package's witness has them;
# ``re`` group "key" extracts the ordering key (e.g. the digest hex)
# where one exists
DEFAULT_FAMILIES = [
    {"key": "chunk-file",
     "re": r"/\.chunks/[0-9a-f]{4}/(?P<key>[0-9a-f]{64})$",
     "unlink_event": "chunk.unlink"},
    {"key": "index-snapshot",
     "re": r"/\.chunkindex/(?:proc-[^/]+/)?snapshot(?:-[^/]+)?$"},
    {"key": "digestlog-segment",
     "re": r"/\.chunkindex/(?:[^/]+/)*[0-9]+\.seg$"},
    {"key": "checkpoint",
     "re": r"/\.ckpt/ck-[0-9]{8}(?:/|$)"},
    {"key": "sync-state",
     "re": r"/\.sync/[^/]+/state\.json$"},
    {"key": "shard-map",
     "re": r"\.shardmap$"},
    {"key": "snapshot-manifest",
     "re": r"/manifest\.json$"},
]

# keyed before/after pairs; event names match the note() calls in the
# index tier and the fs-derived events above
DEFAULT_ORDERINGS = [
    {"key": "discard-before-unlink",
     "before": "index.discard", "after": "chunk.unlink"},
    {"key": "tombstone-before-fingerprint",
     "before": "digestlog.tombstone", "after": "filter.remove"},
    {"key": "map-install-before-retire",
     "before": "map.install", "after": "shard.retire"},
    {"key": "mark-before-sweep",
     "before": "gc.mark", "after": "gc.sweep"},
]

_install_mu = threading.Lock()
_installed: "FsWitness | None" = None
_install_depth = 0
_real = {}


class FsWitness:
    """Recorder + checker.  All intake paths are violation-collecting,
    never raising — a witness must not change program behavior; call
    :meth:`assert_clean` after the block under test."""

    def __init__(self, families=None, orderings=None):
        fams = DEFAULT_FAMILIES if families is None else families
        self.families = [dict(f, re=re.compile(f["re"]))
                         for f in fams]
        self.orderings = list(DEFAULT_ORDERINGS if orderings is None
                              else orderings)
        self._mu = threading.Lock()
        self._seq = 0
        self.events: "list[tuple[int, str, str]]" = []  # (seq, name, key)
        self.fs_ops: "list[tuple[str, str]]" = []       # (op, path)
        self.violations: "list[str]" = []
        self._seen: "dict[tuple[str, str], int]" = {}   # (name,key)→seq
        self._seen_names: "set[str]" = set()

    # -- classification ----------------------------------------------------
    def _family(self, path: str):
        p = os.path.abspath(path).replace(os.sep, "/")
        for fam in self.families:
            m = fam["re"].search(p)
            if m:
                key = (m.groupdict().get("key") or p)
                return fam, key
        return None, None

    # -- event intake ------------------------------------------------------
    def _record(self, name: str, key: str) -> None:
        with self._mu:
            self._seq += 1
            seq = self._seq
            self.events.append((seq, name, key))
            self._seen.setdefault((name, key), seq)
            self._seen_names.add(name)
            for o in self.orderings:
                if o["after"] == name:
                    # enforce only once the protocol is live (some
                    # before-event observed): an index-less store's
                    # unlinks have no discard to pair with
                    if o["before"] in self._seen_names and \
                            (o["before"], key) not in self._seen:
                        self.violations.append(
                            f"{o['key']}: `{name}`({key}) with no prior "
                            f"`{o['before']}` for that key")
                elif o["before"] == name:
                    after = self._seen.get((o["after"], key))
                    if after is not None and after < seq:
                        self.violations.append(
                            f"{o['key']}: `{name}`({key}) arrived AFTER "
                            f"`{o['after']}` for that key")

    def _note_fs(self, op: str, path: str,
                 dst: "str | None" = None) -> None:
        try:
            spath = os.fspath(path)
            if not isinstance(spath, str):
                spath = os.fsdecode(spath)
            sdst = None
            if dst is not None:
                sdst = os.fspath(dst)
                if not isinstance(sdst, str):
                    sdst = os.fsdecode(sdst)
        except TypeError:
            return                      # fd-relative or exotic target
        with self._mu:
            self.fs_ops.append((op, sdst or spath))
        if op in ("rename", "replace", "link"):
            fam, key = self._family(sdst)
            if fam is not None and not atomicio.is_staging_path(spath):
                with self._mu:
                    self.violations.append(
                        f"non-staged publish: {op}({spath!r} -> "
                        f"{sdst!r}) lands on durable family "
                        f"`{fam['key']}` from a non-staging source")
            return
        if op == "open":
            fam, key = self._family(spath)
            if fam is not None and not atomicio.is_staging_path(spath):
                with self._mu:
                    self.violations.append(
                        f"torn durable write: open({spath!r}, w) on "
                        f"family `{fam['key']}` — publish through "
                        "utils/atomicio.py instead")
            return
        if op == "unlink":
            fam, key = self._family(spath)
            if fam is not None and fam.get("unlink_event") and \
                    not atomicio.is_staging_path(spath):
                self._record(fam["unlink_event"], key)

    # -- assertions --------------------------------------------------------
    def assert_clean(self) -> None:
        with self._mu:
            bad = list(self.violations)
        if bad:
            raise AssertionError(
                "fswitness: %d protocol violation(s):\n  %s"
                % (len(bad), "\n  ".join(bad)))

    def saw(self, name: str) -> bool:
        with self._mu:
            return name in self._seen_names


# -- module-level hook API ---------------------------------------------------

def note(event: str, key: str) -> None:
    """Report a semantic protocol event (e.g. ``index.discard`` with
    the digest hex).  No-op unless a witness is installed — product
    call sites pay one global read."""
    w = _installed
    if w is not None:
        w._record(event, key)


_WRITE_MODE_RE = re.compile(r"[wax]")


def _wrap_os(op: str, w: "FsWitness"):
    real = _real[op]
    if op in ("rename", "replace", "link"):
        def patched(src, dst, *a, **kw):
            w._note_fs(op, src, dst)
            return real(src, dst, *a, **kw)
    elif op == "unlink":
        def patched(path, *a, **kw):
            # record AFTER success: a failed unlink leaves the file —
            # not an ordering event
            r = real(path, *a, **kw)
            w._note_fs(op, path)
            return r
    else:                               # fsync: record only
        def patched(fd, *a, **kw):
            r = real(fd, *a, **kw)
            with w._mu:
                w.fs_ops.append((op, str(fd)))
            return r
    return patched


def _wrap_open(w: "FsWitness"):
    real = _real["open"]

    def patched(file, mode="r", *a, **kw):
        try:
            if isinstance(mode, str) and _WRITE_MODE_RE.search(mode) \
                    and isinstance(file, (str, os.PathLike)):
                w._note_fs("open", file)
        # classification must never break the interpreter's open
        # builtin -- a witness bug must not change program behavior, so
        # this is the one deliberately silent handler in the module
        except Exception:
            pass
        return real(file, mode, *a, **kw)
    return patched


def install(witness: "FsWitness | None" = None) -> "FsWitness":
    """Patch the fs entry points; nested installs share the outermost
    witness (depth-counted)."""
    global _installed, _install_depth
    with _install_mu:
        if _install_depth == 0:
            w = witness or FsWitness()
            _real.update({
                "rename": os.rename, "replace": os.replace,
                "link": os.link, "unlink": os.unlink,
                "fsync": os.fsync, "open": builtins.open,
            })
            os.rename = _wrap_os("rename", w)
            os.replace = _wrap_os("replace", w)
            os.link = _wrap_os("link", w)
            os.unlink = _wrap_os("unlink", w)
            os.fsync = _wrap_os("fsync", w)
            builtins.open = _wrap_open(w)
            _installed = w
        _install_depth += 1
        return _installed


def uninstall() -> None:
    global _installed, _install_depth
    with _install_mu:
        if _install_depth == 0:
            return
        _install_depth -= 1
        if _install_depth == 0:
            os.rename = _real["rename"]
            os.replace = _real["replace"]
            os.link = _real["link"]
            os.unlink = _real["unlink"]
            os.fsync = _real["fsync"]
            builtins.open = _real["open"]
            _real.clear()
            _installed = None


@contextmanager
def watching(families=None, orderings=None):
    """Record fs + protocol events for the block; the caller asserts
    (``assert_clean``) after — mid-block raising would mask the
    original failure under test."""
    w = install(FsWitness(families=families, orderings=orderings))
    try:
        yield w
    finally:
        uninstall()
