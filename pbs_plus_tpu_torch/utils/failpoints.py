"""Deterministic fault injection: named failpoint sites of the port.

A copy of the part of the JAX package's ``utils/failpoints.py`` that the
index tier, the store and its tests use: code marks a site with
``failpoints.hit("layer.site")`` (``await failpoints.ahit(...)`` in
coroutines), and a test arms it to raise::

    with failpoints.armed("pbsstore.digestlog.compact", "raise") as fp:
        ...
    assert fp.fires == 1

The registry is the port's own: arming a site in the JAX package does not
arm it here, and the reverse.  A disarmed site costs one dict truthiness
check.  The reference's other actions (delay, drop, corrupt) and
triggers (nth, after, prob) have no caller in the port yet.
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Iterator

L = logging.getLogger(__name__)


class FailpointError(RuntimeError):
    """The exception an armed ``raise`` site injects."""


class Failpoint:
    """One armed site and the times it fired."""

    __slots__ = ("site", "fires")

    def __init__(self, site: str):
        self.site = site
        self.fires = 0                     # guarded-by: _lock


_lock = threading.Lock()
_armed: dict[str, Failpoint] = {}          # guarded-by: _lock


@contextmanager
def armed(site: str, action: str = "raise") -> Iterator[Failpoint]:
    """Arm ``site`` for the duration of the block, always disarm."""
    if action != "raise":
        raise ValueError(f"unsupported failpoint action {action!r}")
    fp = Failpoint(site)
    with _lock:
        _armed[site] = fp
    L.info("failpoint armed: %s action=%s", site, action)
    try:
        yield fp
    finally:
        with _lock:
            _armed.pop(site, None)


def hit(site: str, data=None):
    """Raise ``FailpointError`` when ``site`` is armed, else return
    ``data`` (sites on a data path pass their bytes through, as the
    reference's do)."""
    # lock-free truthiness probe: disarmed sites cost one dict check
    if not _armed:
        return data
    with _lock:
        fp = _armed.get(site)
        if fp is None:
            return data
        fp.fires += 1
    L.warning("failpoint firing: %s fire=%d", site, fp.fires)
    raise FailpointError(f"failpoint {site}: injected fault (fire #{fp.fires})")


async def ahit(site: str, data=None):
    """``hit`` for coroutines: returns ``data`` when ``site`` is not
    armed, else raises ``FailpointError``."""
    return hit(site, data)
