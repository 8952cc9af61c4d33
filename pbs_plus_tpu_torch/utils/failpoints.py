"""Deterministic fault injection: named failpoint sites.

The reference survives flaky agents and dying transports by design
(SURVEY §5.3 backoff discipline, internal/server/resilience.go), but
proving that requires *injecting* the faults on demand.  This module is
the failpoint engine (the freebsd/golang `fail()` pattern): production
code marks a named site with ``failpoints.hit("layer.site")`` /
``await failpoints.ahit(...)``; tests and an env knob arm an action at
that site with a deterministic trigger.

Actions
    raise    raise ``FailpointError`` (or a caller-supplied exception)
    delay    sleep ``arg`` seconds, then continue normally
    drop     raise ``ConnectionResetError`` — the injected-transport-death
             class every resilience path must map to retry/abort cleanly
    corrupt  flip one byte of the data passing through the site

Triggers (all deterministic)
    nth=N    fire on exactly the Nth hit of the armed site
    after=N  fire on every hit AFTER the Nth (let N operations commit,
             then fail the rest — partial-progress scenarios)
    p=X      seeded probability (``seed=`` fixes the sequence, so two
             identical armings fire on identical hit indexes)
    once     fire at most one time total (modifies any of the above)

Arming
    with failpoints.armed("pbsstore.chunk.insert", "raise", after=2):
        ...                                   # test API, auto-disarm
    PBS_PLUS_FAILPOINTS="arpc.mux.read_frame=drop@nth=3;sidecar.call=raise"
                                              # env knob, parsed at import

Disarmed sites cost one module-dict truthiness check — nothing is
looked up, locked, or allocated (``tests/test_failpoints.py`` pins the
overhead).  Counters per armed site survive disarming and are exported
by ``server/metrics.py`` as ``pbs_plus_failpoint_{hits,fires}_total``.

The site catalog lives in ``docs/fault-injection.md``; pbslint's
``failpoint-discipline`` rule keeps code and catalog in sync (literal,
globally-unique, documented names).

A copy of the JAX package's ``utils/failpoints.py``, its code byte for
byte apart from its logger (``logging``).  The registry is the port's
own: arming a site in the JAX package does not arm it here, and the
reverse.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Iterator

L = logging.getLogger(__name__)

ACTIONS = ("raise", "delay", "drop", "corrupt")


class FailpointError(RuntimeError):
    """Default exception injected by an armed ``raise`` site."""


class Failpoint:
    """One armed site: action + trigger state + counters."""

    __slots__ = ("site", "action", "arg", "nth", "after", "prob", "once",
                 "exc", "hits", "fires", "_rng")

    def __init__(self, site: str, action: str, *, arg: float = 0.0,
                 nth: int = 0, after: int = 0, prob: float | None = None,
                 seed: int = 0, once: bool = False, exc=None):
        if action not in ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"(want {'|'.join(ACTIONS)})")
        if nth and after:
            raise ValueError("nth= and after= are mutually exclusive")
        self.site = site
        self.action = action
        self.arg = float(arg)
        self.nth = int(nth)
        self.after = int(after)
        self.prob = prob
        self.once = bool(once)
        self.exc = exc                     # exception class/factory for raise
        # trigger state mutates under the MODULE lock (the docstring
        # contract on _should_fire), not a per-instance one
        self.hits = 0                      # guarded-by: _lock
        self.fires = 0                     # guarded-by: _lock
        self._rng = random.Random(seed)

    def _should_fire(self) -> bool:
        """Trigger decision; caller holds the module lock."""
        # the only caller is _decide, inside `with _lock:` — through a
        # receiver variable (fp._should_fire) the static resolver cannot
        # see, hence the explicit disables on the guarded state
        self.hits += 1          # pbslint: disable=guarded-by
        if self.once and self.fires:   # pbslint: disable=guarded-by
            return False
        if self.nth:
            fire = self.hits == self.nth
        elif self.after:
            fire = self.hits > self.after
        elif self.prob is not None:
            fire = self._rng.random() < self.prob
        else:
            fire = True
        if fire:
            self.fires += 1
        return fire


_lock = threading.Lock()
_armed: dict[str, Failpoint] = {}              # guarded-by: _lock
# cumulative per-site counters; survive disarm so /metrics can report a
# whole chaos run, not just the currently-armed instant
_counters: dict[str, dict[str, int]] = {}      # guarded-by: _lock


def arm(site: str, action: str, **kw) -> Failpoint:
    """Arm ``site`` (replacing any previous arming).  Keyword args are
    ``Failpoint``'s trigger/action parameters."""
    fp = Failpoint(site, action, **kw)
    with _lock:
        _armed[site] = fp
        _counters.setdefault(site, {"hits": 0, "fires": 0})
    L.info("failpoint armed: %s action=%s nth=%d after=%d prob=%s once=%s",
           site, action, fp.nth, fp.after, fp.prob, fp.once)
    return fp


def disarm(site: str) -> None:
    with _lock:
        _armed.pop(site, None)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


@contextmanager
def armed(site: str, action: str, **kw) -> Iterator[Failpoint]:
    """Test API: arm for the duration of the block, always disarm."""
    fp = arm(site, action, **kw)
    try:
        yield fp
    finally:
        disarm(site)


def _decide(site: str) -> Failpoint | None:
    """Counter bookkeeping + trigger decision; None = pass through."""
    with _lock:
        # the lookup belongs under the lock too (the guarded-by sweep's
        # catch): a concurrent disarm between a lock-free .get and
        # _should_fire would mutate trigger state on a Failpoint the
        # registry no longer owns — one hit could fire twice across a
        # rearm.  The disarmed fast path stays in hit()/ahit().
        fp = _armed.get(site)
        if fp is None:
            return None
        fire = fp._should_fire()
        c = _counters.setdefault(site, {"hits": 0, "fires": 0})
        c["hits"] += 1
        if fire:
            c["fires"] += 1
    return fp if fire else None


def _corrupt(data):
    """Flip the low bit of the last byte — detectable by any digest
    check, length-preserving so framing stays intact."""
    if not data:
        return data
    b = bytearray(data)
    b[-1] ^= 0x01
    return bytes(b)


def _raise_for(fp: Failpoint) -> None:
    if fp.action == "drop":
        raise ConnectionResetError(
            f"failpoint {fp.site}: injected connection drop")
    exc = fp.exc() if callable(fp.exc) else fp.exc
    raise exc if exc is not None else FailpointError(
        f"failpoint {fp.site}: injected fault (fire #{fp.fires})")


def hit(site: str, data=None):
    """Synchronous failpoint.  Returns ``data`` (possibly corrupted);
    raises for ``raise``/``drop`` actions.  Disarmed cost: one dict
    truthiness check."""
    # the lock-free truthiness probe IS the contract: disarmed sites on
    # hot paths cost one dict check, no lock; worst race is one hit
    # deciding against a just-armed site (tests arm before traffic)
    if not _armed:   # pbslint: disable=guarded-by
        return data
    fp = _decide(site)
    if fp is None:
        return data
    L.warning("failpoint firing: %s action=%s hit=%d", site, fp.action,
              fp.hits)
    if fp.action == "delay":
        time.sleep(fp.arg)
        return data
    if fp.action == "corrupt":
        return _corrupt(data)
    _raise_for(fp)


async def ahit(site: str, data=None):
    """Async failpoint — same semantics as ``hit`` but delays never
    block the event loop."""
    # same sanctioned lock-free fast path as hit() above
    if not _armed:   # pbslint: disable=guarded-by
        return data
    fp = _decide(site)
    if fp is None:
        return data
    L.warning("failpoint firing: %s action=%s hit=%d", site, fp.action,
              fp.hits)
    if fp.action == "delay":
        await asyncio.sleep(fp.arg)
        return data
    if fp.action == "corrupt":
        return _corrupt(data)
    _raise_for(fp)


def snapshot() -> dict:
    """Armed sites + cumulative counters (rendered by server/metrics.py)."""
    with _lock:
        return {
            "armed": {s: fp.action for s, fp in _armed.items()},
            "counters": {s: dict(c) for s, c in _counters.items()},
        }


def reset_counters() -> None:
    with _lock:
        _counters.clear()


# -- env knob ---------------------------------------------------------------

ENV_VAR = "PBS_PLUS_FAILPOINTS"


def arm_from_spec(spec: str) -> list[Failpoint]:
    """Parse and arm ``site=action[:arg][@trig[,trig...]]`` entries
    separated by ``;``.  Triggers: ``nth=N`` | ``after=N`` | ``p=X`` |
    ``seed=N`` | ``once``.  Example::

        arpc.mux.read_frame=drop@nth=3;pipeline.hash=delay:0.05@p=0.1,seed=7
    """
    out: list[Failpoint] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rhs = entry.partition("=")
        if not rhs:
            raise ValueError(f"failpoint spec {entry!r}: want site=action")
        action_part, _, trig_part = rhs.partition("@")
        action, _, arg = action_part.partition(":")
        kw: dict = {"arg": float(arg)} if arg else {}
        for trig in filter(None, (t.strip() for t in trig_part.split(","))):
            key, _, val = trig.partition("=")
            if key == "nth":
                kw["nth"] = int(val)
            elif key == "after":
                kw["after"] = int(val)
            elif key == "p":
                kw["prob"] = float(val)
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "once":
                kw["once"] = True
            else:
                raise ValueError(f"failpoint spec {entry!r}: "
                                 f"unknown trigger {trig!r}")
        out.append(arm(site.strip(), action.strip(), **kw))
    return out


_env_spec = os.environ.get(ENV_VAR, "")
if _env_spec:
    arm_from_spec(_env_spec)
