"""Histogram observations of the port.

A copy of the part of the JAX package's ``utils/trace.py`` that the index
tier calls: ``record``, a histogram-only observation for hot sites, over
a closed registry of names (``SPANS``).  The reference feeds its
histograms to the server's metrics module; the port has no server, so
they accumulate here (``histograms()``) and nothing of the JAX package is
imported.  The reference's spans, ring and context propagation have no
caller in the port yet and are not copied.
"""

from __future__ import annotations

import threading

# name -> histogram it feeds.  The set is closed: record() rejects
# unknown names.
SPANS = {
    # spillable exact-confirm tier (pxar/digestlog.py)
    "digestlog.confirm": "pbs_plus_digestlog_confirm_read_seconds",
}

_lock = threading.Lock()
_hist: "dict[str, list]" = {}                   # guarded-by: _lock


def record(name: str, seconds: float) -> None:
    """One observation of ``seconds`` into the histogram ``name`` feeds."""
    if name not in SPANS:
        raise ValueError(f"unregistered span name {name!r}")
    with _lock:
        h = _hist.setdefault(SPANS[name], [0, 0.0])
        h[0] += 1
        h[1] += seconds


def histograms() -> "dict[str, dict]":
    """{histogram: {"count", "sum_s"}} of every observation so far."""
    with _lock:
        return {k: {"count": c, "sum_s": s} for k, (c, s) in _hist.items()}
