"""Histogram observations of the port.

A copy of the part of the JAX package's ``utils/trace.py`` that the index
tier, the ingest writers, the chunk cache, the aRPC mux and router and the
backup job call: ``span`` (a timed block), ``emit`` (a pre-measured one),
``record`` (a histogram-only observation for hot sites) and ``enabled``,
over a closed registry of names (``SPANS``); a name registered with no
histogram (``None``) is accepted and not observed.  The reference feeds its histograms to the
server's metrics module; the port has no server, so they accumulate here
(``histograms()``) and nothing of the JAX package is imported.  The
reference's span ring, context propagation and bench-only kill switch
are not copied: tracing is always on, span attributes are accepted and
dropped, and ``capture``/``attached``/``wrap``/``headers_out``/
``parse_header`` keep the reference's call shapes with no context to
carry.
"""

from __future__ import annotations

import threading
import time

# the call-metadata key the reference carries its trace context under
TRACE_HEADER = "x-pbs-trace"

# name -> (histogram it feeds, constant labels or None), or None for a
# span that feeds no histogram.  The set is closed: span(), emit() and
# record() reject unknown names.
SPANS = {
    # batched ingest stages (pxar/transfer.py, pxar/ingestbatch.py)
    "ingest.fused": ("pbs_plus_ingest_stage_seconds", {"stage": "fused"}),
    "ingest.cdc": ("pbs_plus_ingest_stage_seconds", {"stage": "cdc"}),
    "ingest.sha": ("pbs_plus_ingest_stage_seconds", {"stage": "sha"}),
    "ingest.probe": ("pbs_plus_ingest_stage_seconds", {"stage": "probe"}),
    "ingest.presketch": ("pbs_plus_ingest_stage_seconds",
                         {"stage": "presketch"}),
    # read path (pxar/chunkcache.py)
    "chunkcache.fetch": ("pbs_plus_chunk_cache_fetch_seconds", None),
    # spillable exact-confirm tier (pxar/digestlog.py)
    "digestlog.confirm": ("pbs_plus_digestlog_confirm_read_seconds", None),
    # rpc layer (arpc/mux.py, arpc/router.py)
    "mux.write_frame": ("pbs_plus_mux_frame_write_seconds", None),
    "rpc.serve": None,
    # the backup job (server/backup_job.py); the publish span feeds a
    # histogram of the port's own, since the port keeps no span ring
    "backup.session_open": ("pbs_plus_session_open_seconds",
                            {"phase": "job"}),
    "backup.publish": ("pbs_plus_backup_publish_seconds", None),
}


def _series(hist: str, labels: "dict | None") -> str:
    """The key of one histogram series: its name, with its labels in the
    exposition format (``name{stage="sha"}``) where it has any."""
    if not labels:
        return hist
    return hist + "{" + ",".join(f'{k}="{v}"'
                                 for k, v in sorted(labels.items())) + "}"


_KEYS = {name: _series(*spec) for name, spec in SPANS.items()
         if spec is not None}

_lock = threading.Lock()
_hist: "dict[str, list]" = {}                   # guarded-by: _lock


def _check(name: str) -> None:
    if name not in SPANS:
        raise ValueError(f"unregistered span name {name!r}")


def _observe(name: str, seconds: float) -> None:
    if name not in _KEYS:
        return
    with _lock:
        h = _hist.setdefault(_KEYS[name], [0, 0.0])
        h[0] += 1
        h[1] += seconds


def record(name: str, seconds: float) -> None:
    """One observation of ``seconds`` into the histogram ``name`` feeds."""
    _check(name)
    _observe(name, seconds)


def emit(name: str, seconds: float, **attrs) -> None:
    """A pre-measured span of ``seconds`` ending now: for aggregated
    measurements a context manager cannot bracket (the sequential
    writer's per-chunk stage accumulators)."""
    _check(name)
    _observe(name, seconds)


class _Span:
    """One open span; use only as a context manager.  It is observed on
    exit, also when the block raises."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _observe(self.name, time.perf_counter() - self._t0)
        return False


def span(name: str, **attrs) -> _Span:
    """Open a timed span (context manager) of a registered ``name``."""
    _check(name)
    return _Span(name)


def enabled() -> bool:
    """Always True: the port keeps no kill switch.  Instrumentation that
    pays per-chunk measurement cost outside the span calls (the writers'
    stage accumulators) asks this, as the reference's writers do."""
    return True


def capture() -> None:
    """The ambient trace context for hand-off to another thread: always
    None, since the port propagates none (the pipelined writer hands it
    to its workers as the reference's does)."""
    return None


class attached:
    """Attach a captured context for the block; with nothing to attach
    (the port's ``capture()`` is None) it keeps whatever is ambient, as
    the reference's ``attached(None)`` does."""

    __slots__ = ("_target",)

    def __init__(self, ctx: None):
        self._target = ctx

    def __enter__(self) -> "attached":
        return self

    def __exit__(self, *exc) -> bool:
        return False


def wrap(fn):
    """``fn`` to run on another thread under the caller's context: the
    port carries none, so ``fn`` itself."""
    return fn


def parse_header(value: "str | None") -> None:
    """The context an incoming ``TRACE_HEADER`` carries: always None,
    since the port re-attaches none (a peer's header is ignored)."""
    return None


def headers_out(headers: "dict | None" = None) -> dict:
    """An outgoing call's header dict with the ambient context injected;
    the port carries none, so the caller's headers (or ``{}``)."""
    return headers if headers is not None else {}


def histograms() -> "dict[str, dict]":
    """{series: {"count", "sum_s"}} of every observation so far; a
    labelled series is keyed ``name{label="value"}``."""
    with _lock:
        return {k: {"count": c, "sum_s": s} for k, (c, s) in _hist.items()}
