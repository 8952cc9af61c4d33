"""End-to-end tracing of the port: spans with contextvar propagation
across the data plane's concurrency seams, a ring of closed spans, and
the latency histograms of ``server/metrics.py``.

A copy of the JAX package's ``utils/trace.py``, its code byte for byte
apart from the lazy import of the metrics module, which is the port's
own (``server/metrics.py``), and one addition, ``histograms()``.

- **Spans.**  ``with trace.span("job.queue_wait", kind=...):`` opens a
  timed span parented under the ambient context (a ``contextvar``).
  Span names are a closed registry (``SPANS``): every name maps to the
  histogram it feeds (or ``None``); a ``"$attr"`` label value resolves
  from the span's attributes at close, so the jobs manager's ``kind``
  reaches ``pbs_plus_job_*_seconds{kind=...}``.
- **Propagation.**  ``capture()``/``attached(ctx)``/``wrap(fn)`` across
  threads (the pipeline pool, the backup writer thread, executor
  offloads); ``headers_out``/``parse_header`` across the aRPC mux.
- **Ring buffer.**  Closed spans land in a bounded in-process ring
  (``PBS_PLUS_TRACE_RING`` entries, oldest evicted): ``recent``,
  ``active_spans``, ``subscribe``/``unsubscribe``, ``dump_text``.
- **Histograms.**  Every span close and every ``record()`` feeds a
  fixed-bucket histogram of ``server/metrics.py`` through
  ``observe_histogram``, which reads the registry without a lock and
  locks only the one histogram, so the writer threads feed it with no
  global lock on the hot path.  ``histograms()`` reads the registry
  back as ``{series: {"count", "sum_s"}}``.

Tracing is always on; ``disabled()`` is the bench-only kill switch.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextvars import ContextVar

TRACE_HEADER = "x-pbs-trace"

# -- the span registry -------------------------------------------------------
# name -> histogram feed: None (span only), or (histogram_name, labels)
# where a "$attr" label value is resolved from the span's attrs at close
# time.  The set is CLOSED: span()/emit()/record() reject unknown names,
# pbslint's span-discipline requires literal names documented in
# docs/observability.md, and registry-consistency checks this dict
# against the call sites and the doc table in both directions.
SPANS = {
    # jobs plane (server/jobs.py)
    "job": None,
    "job.queue_wait": None,
    "job.enqueue_to_grant": ("pbs_plus_job_enqueue_to_grant_seconds",
                             {"kind": "$kind"}),
    "job.execute": ("pbs_plus_job_grant_to_publish_seconds",
                    {"kind": "$kind"}),
    "job.enqueue_to_publish": ("pbs_plus_job_enqueue_to_publish_seconds",
                               {"kind": "$kind"}),
    # backup data plane (server/backup_job.py, server/fleetsim.py)
    "backup.session_open": ("pbs_plus_session_open_seconds",
                            {"phase": "job"}),
    "backup.publish": None,
    "session.open": ("pbs_plus_session_open_seconds",
                     {"phase": "connect"}),
    # batched ingest stages (pxar/transfer.py, pxar/pipeline.py,
    # pxar/ingestbatch.py)
    "ingest.fused": ("pbs_plus_ingest_stage_seconds", {"stage": "fused"}),
    "ingest.cdc": ("pbs_plus_ingest_stage_seconds", {"stage": "cdc"}),
    "ingest.sha": ("pbs_plus_ingest_stage_seconds", {"stage": "sha"}),
    "ingest.probe": ("pbs_plus_ingest_stage_seconds", {"stage": "probe"}),
    "ingest.presketch": ("pbs_plus_ingest_stage_seconds",
                         {"stage": "presketch"}),
    # read path (pxar/chunkcache.py)
    "chunkcache.fetch": ("pbs_plus_chunk_cache_fetch_seconds", None),
    # spillable exact-confirm tier (pxar/digestlog.py)
    "digestlog.confirm": ("pbs_plus_digestlog_confirm_read_seconds",
                          None),
    # replication wire (pxar/syncwire.py)
    "sync.negotiate": ("pbs_plus_sync_batch_seconds",
                       {"phase": "negotiate"}),
    "sync.transfer": ("pbs_plus_sync_batch_seconds",
                      {"phase": "transfer"}),
    "sync.serve": None,
    # rpc layer (arpc/router.py, sidecar/client.py, arpc/mux.py)
    "rpc.serve": None,
    "sidecar.call": None,
    "mux.write_frame": ("pbs_plus_mux_frame_write_seconds", None),
    # per-service lock waits (server/services/): how long a
    # caller queued on a service's own lock — the histogram where the
    # old Server._prune_lock convoy would show up if the split ever
    # regressed into one big lock again
    "service.lock_wait": ("pbs_plus_service_lock_wait_seconds",
                          {"service": "$service"}),
}

_ctx: "ContextVar[tuple[str, str] | None]" = ContextVar(
    "pbs_plus_trace", default=None)

# ring capacity: enough that a fleet soak's LAST complete job traces
# survive the rpc.serve churn of earlier jobs (docs/observability.md)
_DEFAULT_RING = 8192


def _ring_capacity() -> int:
    try:
        return max(64, int(os.environ.get("PBS_PLUS_TRACE_RING",
                                          str(_DEFAULT_RING))))
    except ValueError:
        return _DEFAULT_RING


# closed spans, oldest evicted; deque append/snapshot are GIL-atomic so
# the hot path takes no lock
_ring: "deque[dict]" = deque(maxlen=_ring_capacity())
# open spans (orphan detection): span_id -> (name, wall-clock start)
_active: dict = {}
# per-close subscribers (test/chaos hooks); empty in production, and the
# close path skips the loop entirely when it is
_subs: list = []
_enabled = True          # bench-only kill switch (disabled() below)

# id generator: 64-bit counter seeded from urandom so two processes
# sharing a wire never collide; next() is GIL-atomic
_ids = itertools.count(int.from_bytes(os.urandom(8), "big") or 1)
_MASK = (1 << 64) - 1

_metrics = None          # lazy server.metrics binding (no import cycle)


def _new_id() -> str:
    return format(next(_ids) & _MASK, "016x")


def _feed_histogram(name: str, seconds: float, attrs: "dict | None") -> None:
    spec = SPANS[name]
    if spec is None:
        return
    global _metrics
    if _metrics is None:
        from ..server import metrics as _m      # light: stdlib + logging
        _metrics = _m
    hist, labels = spec
    if labels is not None:
        # $attr placeholders resolve even when the span carried no
        # attrs — a missing attr becomes the "" child, never the
        # literal "$kind" leaking into the exposition as a label value
        resolved = {}
        for k, v in labels.items():
            resolved[k] = str((attrs or {}).get(v[1:], "")) \
                if isinstance(v, str) and v.startswith("$") else v
        labels = resolved
    _metrics.observe_histogram(hist, seconds, labels)


def _close_record(rec: dict) -> None:
    _ring.append(rec)
    _feed_histogram(rec["name"], rec["dur_s"], rec.get("attrs"))
    if _subs:
        for fn in list(_subs):
            fn(rec)


class _Span:
    """One open span; use ONLY as a context manager (pbslint rule
    ``span-discipline``) — a begin without a guaranteed close would leak
    into ``active_spans()`` as an orphan."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "_t0", "_wall", "_token")

    def __init__(self, name: str, attrs: "dict | None"):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        cur = _ctx.get()
        if cur is None:
            self.trace_id = _new_id()
            self.parent_id = ""
        else:
            self.trace_id, self.parent_id = cur
        self.span_id = _new_id()
        self._token = _ctx.set((self.trace_id, self.span_id))
        self._wall = time.time()
        _active[self.span_id] = (self.name, self._wall)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        _ctx.reset(self._token)
        _active.pop(self.span_id, None)
        rec = {"name": self.name, "trace": self.trace_id,
               "span": self.span_id, "parent": self.parent_id,
               "start": self._wall, "dur_s": dur}
        if self.attrs:
            rec["attrs"] = self.attrs
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        _close_record(rec)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **attrs) -> "_Span | _NoopSpan":
    """Open a timed span (context manager).  ``name`` must be in the
    ``SPANS`` registry; ``attrs`` ride into the ring record and resolve
    ``$attr`` histogram labels."""
    if name not in SPANS:
        raise ValueError(f"unregistered span name {name!r} "
                         "(add it to trace.SPANS + docs/observability.md)")
    if not _enabled:
        return _NOOP
    return _Span(name, attrs or None)


def emit(name: str, seconds: float, **attrs) -> None:
    """One-shot pre-measured span: records a span of duration
    ``seconds`` ending now, parented under the ambient context — for
    aggregated measurements a context manager cannot bracket (the
    sequential writer's per-chunk stage accumulators)."""
    if name not in SPANS:
        raise ValueError(f"unregistered span name {name!r}")
    if not _enabled:
        return
    cur = _ctx.get()
    if cur is None:
        trace_id, parent = _new_id(), ""
    else:
        trace_id, parent = cur
    rec = {"name": name, "trace": trace_id, "span": _new_id(),
           "parent": parent, "start": time.time() - seconds,
           "dur_s": seconds}
    if attrs:
        rec["attrs"] = attrs
    _close_record(rec)


def enabled() -> bool:
    """True unless inside ``disabled()`` — instrumentation that pays
    per-chunk measurement cost outside the span APIs (the ingest stage
    accumulators) gates on this so the bench's tracing-off mode really
    removes the whole cost."""
    return _enabled


def record(name: str, seconds: float, **attrs) -> None:
    """Histogram-only observation (no ring entry) for hot sites where a
    per-event span would dominate the work being measured (mux frame
    writes).  The name still comes from the ``SPANS`` registry."""
    if name not in SPANS:
        raise ValueError(f"unregistered span name {name!r}")
    if not _enabled:
        return
    _feed_histogram(name, seconds, attrs or None)


# -- propagation -------------------------------------------------------------

def capture() -> "tuple[str, str] | None":
    """The ambient (trace_id, span_id), for hand-off to another thread."""
    return _ctx.get()


class attached:
    """Attach a captured context in this thread/task for the block.
    ``attached(None)`` is a no-op (keeps whatever is ambient)."""

    __slots__ = ("_target", "_token")

    def __init__(self, ctx: "tuple[str, str] | None"):
        self._target = ctx
        self._token = None

    def __enter__(self) -> "attached":
        if self._target is not None:
            self._token = _ctx.set(self._target)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _ctx.reset(self._token)
        return False


def wrap(fn):
    """Capture the ambient context NOW and return a callable that runs
    ``fn`` under it — the ``run_in_executor`` seam (executor threads
    do not inherit the caller's contextvars)."""
    ctx = _ctx.get()

    def inner(*a, **kw):
        with attached(ctx):
            return fn(*a, **kw)
    return inner


def headers_out(headers: "dict | None" = None) -> dict:
    """Inject the ambient context into an outgoing header dict (aRPC
    call metadata, sync wire HTTP) — returns the dict unchanged-ish
    when no context is ambient."""
    cur = _ctx.get()
    if cur is None:
        return headers if headers is not None else {}
    out = dict(headers) if headers else {}
    out[TRACE_HEADER] = f"{cur[0]}-{cur[1]}"
    return out


def parse_header(value: "str | None") -> "tuple[str, str] | None":
    """Parse an incoming ``TRACE_HEADER`` value; None when absent or
    malformed (a bad peer header must never kill the request)."""
    if not value:
        return None
    trace_id, _, span_id = value.partition("-")
    if len(trace_id) == 16 and len(span_id) == 16:
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        return (trace_id, span_id)
    return None


# -- introspection / dump ----------------------------------------------------

def recent(n: "int | None" = None,
           trace_id: "str | None" = None) -> list:
    """Closed spans, oldest first (the ring's retention window)."""
    out = list(_ring)
    if trace_id is not None:
        out = [r for r in out if r["trace"] == trace_id]
    if n is not None and n > 0:
        out = out[-n:]
    return out


def active_spans() -> list:
    """Open (never-closed) spans: (name, span_id, age_s).  Non-empty
    after an operation completed = an orphan — the propagation tests
    fail on it."""
    now = time.time()
    return [(name, sid, now - t0)
            for sid, (name, t0) in list(_active.items())]


def clear() -> None:
    """Drop ring + orphan state (test isolation only)."""
    _ring.clear()
    _active.clear()


def subscribe(fn) -> None:
    _subs.append(fn)


def unsubscribe(fn) -> None:
    try:
        _subs.remove(fn)
    except ValueError:
        pass


def dump_text(n: int = 50) -> str:
    """The last ``n`` spans formatted one per line — the crash/chaos
    dump hook (tests/fleet/conftest.py appends this to failed fleet
    test reports; operators get the same view from the traces
    endpoint)."""
    lines = []
    for r in recent(n):
        attrs = r.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in attrs.items())
        err = f" ERROR={r['error']}" if "error" in r else ""
        lines.append(
            f"{r['start']:.6f} {r['dur_s'] * 1e3:9.3f}ms "
            f"trace={r['trace']} span={r['span']} "
            f"parent={r['parent'] or '-':16s} {r['name']}"
            f"{' ' + extra if extra else ''}{err}")
    return "\n".join(lines)


class disabled:
    """Bench-only kill switch: spans/records become no-ops inside the
    block, so the tracing-on vs tracing-off ingest ratio is measurable
    (tests/test_bench_harness.py gates it ≥ 0.97).  NOT a production
    knob — tracing is always on."""

    __slots__ = ("_prev",)

    def __enter__(self) -> "disabled":
        global _enabled
        self._prev = _enabled
        _enabled = False
        return self

    def __exit__(self, *exc) -> bool:
        global _enabled
        _enabled = self._prev
        return False


_ring_lock = threading.Lock()


def configure_ring(capacity: int) -> None:
    """Resize the ring (server config / tests); keeps the newest
    entries."""
    global _ring
    with _ring_lock:
        _ring = deque(_ring, maxlen=max(64, int(capacity)))


def histograms() -> "dict[str, dict]":
    """{series: {"count", "sum_s"}} of every histogram child observed so
    far (``server/metrics.py``'s ``histogram_snapshot``)."""
    from ..server import metrics as _m
    return _m.histogram_snapshot()
