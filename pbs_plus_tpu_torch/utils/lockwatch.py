"""Runtime lock-order witness: the dynamic half of pbslint's static
``lock-order`` pass (docs/static-analysis.md "Lock order").

The static pass proves the *resolvable* acquisition graph acyclic; this
module records what threads ACTUALLY did — every "lock B acquired while
lock A held" edge, per thread, with locks named by their allocation
site — and asserts the same no-cycle property over the observed graph.
Static and runtime views cross-check each other: an edge the resolver
could not see (locks reached through arbitrary objects, dynamic
dispatch) still lands here, and a static name that never shows up at
runtime is a hint the annotation went stale.

Usage (tests; the fleet chaos battery wires this under
``PBS_PLUS_LOCKWATCH``):

    from pbs_plus_tpu_torch.utils import lockwatch
    with lockwatch.watching() as watch:
        ...  # run the workload; locks created inside are auto-wrapped
    watch.assert_acyclic()

``install()`` monkeypatches ``threading.Lock``/``threading.RLock`` so
every lock allocated AFTER it is wrapped (locks created at import time
are not — wrap those explicitly with ``wrap(lock, name)`` if a test
needs them witnessed).  Reentrant re-acquisition of an RLock records no
self-edge, matching the static pass's exemption.  Overhead when not
installed: zero — production code never imports a wrapped lock.

A copy of the JAX package's ``utils/lockwatch.py``, its code byte for
byte apart from the site names: ``_site_name`` looks for
``pbs_plus_tpu_torch`` where the reference looks for ``pbs_plus_tpu``
(whose marker does not match the port's paths), and the usage line above
names the port.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

ENV_VAR = "PBS_PLUS_LOCKWATCH"

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


def enabled() -> bool:
    """True when PBS_PLUS_LOCKWATCH asks for the witness (1/true/yes)."""
    return os.environ.get(ENV_VAR, "").lower() in ("1", "true", "yes")


class LockWatch:
    """Acquisition-edge recorder shared by every wrapped lock."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        # (held_name, acquired_name) -> count; held-top only — the
        # stack discipline makes deeper pairs transitively implied
        self._edges: dict[tuple[str, str], int] = {}
        self._tls = threading.local()

    # -- per-thread held stack --------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquired(self, name: str, *, reentrant: bool) -> None:
        st = self._stack()
        # a reentrant lock re-entered ANYWHERE above records no edge
        # (matching the static pass's RLock exemption — even with other
        # locks interleaved, the re-entry cannot deadlock on itself)
        if st and not (reentrant and name in st):
            edge = (st[-1], name)
            with self._mu:
                self._edges[edge] = self._edges.get(edge, 0) + 1
        st.append(name)

    def note_released(self, name: str) -> None:
        st = self._stack()
        # release order may differ from acquisition order (try/finally
        # across helpers): drop the LAST occurrence
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    # -- results -----------------------------------------------------------
    def edges(self) -> "dict[tuple[str, str], int]":
        with self._mu:
            return dict(self._edges)

    def find_cycle(self) -> "list[str] | None":
        graph: dict[str, set] = {}
        for (a, b) in self.edges():
            if a != b:
                graph.setdefault(a, set()).add(b)
        color: dict[str, int] = {}
        stack: list[str] = []

        def dfs(n: str) -> "list[str] | None":
            color[n] = 1
            stack.append(n)
            for m in sorted(graph.get(n, ())):
                if color.get(m) == 1:
                    return stack[stack.index(m):]
                if color.get(m, 0) == 0:
                    found = dfs(m)
                    if found is not None:
                        return found
            stack.pop()
            color[n] = 2
            return None

        for n in sorted(set(graph) |
                        {m for vs in graph.values() for m in vs}):
            if color.get(n, 0) == 0:
                found = dfs(n)
                if found is not None:
                    return found
        return None

    def assert_acyclic(self) -> None:
        cycle = self.find_cycle()
        if cycle is not None:
            raise AssertionError(
                "lockwatch observed a lock-order cycle at runtime: "
                + " -> ".join(cycle + [cycle[0]])
                + " — the static pbslint lock-order pass missed an "
                  "edge; name the locks involved with `# pbslint: "
                  "lock-order <name>` and fix the ordering")


class _WatchedLock:
    """Proxy over a real lock that reports acquisitions to a watch.
    Everything not intercepted forwards to the wrapped lock, so it
    drops into Condition/Queue internals unchanged."""

    def __init__(self, inner, name: str, watch: LockWatch,
                 reentrant: bool):
        self._inner = inner
        self._name = name
        self._watch = watch
        self._reentrant = reentrant

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._watch.note_acquired(self._name,
                                      reentrant=self._reentrant)
        return got

    def release(self) -> None:
        self._inner.release()
        self._watch.note_released(self._name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, item):
        # Condition.wait bypasses acquire/release through these two;
        # keep the per-thread held stack honest across the wait window.
        # Resolved dynamically so a plain Lock (which lacks them) still
        # raises AttributeError and Condition keeps its fallback path.
        if item == "_release_save":
            inner = self._inner._release_save

            def _release_save():
                state = inner()
                self._watch.note_released(self._name)
                return state
            return _release_save
        if item == "_acquire_restore":
            inner = self._inner._acquire_restore

            def _acquire_restore(state):
                inner(state)
                self._watch.note_acquired(self._name,
                                          reentrant=self._reentrant)
            return _acquire_restore
        return getattr(self._inner, item)

    def __repr__(self) -> str:
        return f"<lockwatch {self._name} over {self._inner!r}>"


def wrap(lock, name: str, watch: LockWatch, *,
         reentrant: bool = False) -> _WatchedLock:
    """Explicitly witness one existing lock (import-time locks that
    ``install`` could not see)."""
    return _WatchedLock(lock, name, watch, reentrant)


def _site_name() -> str:
    """Allocation site of the Lock() call, repo-relative, matching the
    class-level naming the static pass uses closely enough to eyeball:
    every shard lock from one listcomp shares one file:line name."""
    import sys
    f = sys._getframe(2)
    fn = f.f_code.co_filename
    for marker in ("pbs_plus_tpu_torch", "tests", "tools"):
        i = fn.find(os.sep + marker + os.sep)
        if i >= 0:
            fn = fn[i + 1:]
            break
    return f"{fn.replace(os.sep, '/')}:{f.f_lineno}"


_install_mu = _REAL_LOCK()
_installed: "LockWatch | None" = None       # guarded-by: _install_mu
_install_depth = 0                          # guarded-by: _install_mu


def install(watch: "LockWatch | None" = None) -> LockWatch:
    """Monkeypatch threading.Lock/RLock so every lock allocated from now
    on is witnessed.  Returns the active watch.  Installs NEST: a second
    install joins the first watch (a DIFFERENT explicit watch is a
    caller bug and raises), and only the matching uninstall of the
    outermost install restores the real factories — an inner
    ``watching()`` block must not silently un-witness the rest of an
    outer one."""
    global _installed, _install_depth
    with _install_mu:
        if _installed is not None:
            if watch is not None and watch is not _installed:
                raise RuntimeError(
                    "lockwatch already installed with a different watch; "
                    "nest with the active one (or uninstall first)")
            _install_depth += 1
            return _installed
        w = watch or LockWatch()

        def make_lock():
            return _WatchedLock(_REAL_LOCK(), _site_name(), w,
                                reentrant=False)

        def make_rlock():
            return _WatchedLock(_REAL_RLOCK(), _site_name(), w,
                                reentrant=True)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        _installed = w
        _install_depth = 1
        return w


def uninstall() -> None:
    global _installed, _install_depth
    with _install_mu:
        if _installed is None:
            return
        _install_depth -= 1
        if _install_depth > 0:
            return                  # an outer install is still active
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        _installed = None


@contextmanager
def watching(watch: "LockWatch | None" = None):
    """Install for the duration of a block; never leaks the patch."""
    w = install(watch)
    try:
        yield w
    finally:
        uninstall()
