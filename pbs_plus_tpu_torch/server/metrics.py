"""Prometheus metrics (reference: internal/server/web/api/metrics.go:21-344
— ~45 gauges: per-backup last-run success/timestamps/duration, live
bytes/files speeds, snapshot sizes, totals).

Text exposition format rendered directly (no client library needed).

A copy of the JAX package's ``server/metrics.py``, its code byte for
byte apart from its imports, which name the port's own modules (its
lazy ones too: ``pipeline``, ``ingestbatch``, ``chunker.observe``,
``chunkindex``, ``digestlog``, ``similarityindex``, ``syncwire``,
``chunkcache``, ``checkpoint``, ``failpoints``, ``datastore``,
``services.prune_service`` and, where it is imported, the port's
``parallel.dist_index``), its logger (``logging``) and one addition,
``histogram_snapshot()``, which ``utils/trace.py``'s ``histograms()``
returns.  A port server so exports the port's own index, digest-log,
ingest and delta counters.  One family is the port's own:
``pbs_plus_device_kernel_launches_total`` counts the launches of K1, K2
and K3 in the server's process (``kernel_launches()``).
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import threading
import time
from typing import TYPE_CHECKING

L = logging.getLogger(__name__)

if TYPE_CHECKING:
    from .store import Server

_DATASTORE_SCAN_TTL = 15.0      # cache the chunk-dir walk between scrapes


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# -- histograms (docs/observability.md) -------------------------------------
#
# Fixed log-spaced buckets (1-2.5-5 ladder, 1 µs .. 10 s) shared by every
# latency histogram: span closes in utils/trace.py observe into these,
# and render() exposes the Prometheus histogram triple
# (`<name>_bucket{le=...}` / `<name>_sum` / `<name>_count`) so p50/p99
# are derivable by any scraper.  Fixed buckets keep observe() O(log B)
# with zero allocation; the ladder spans mux frame writes (µs) to whole
# job executions (s).

HIST_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket latency histogram with optional label children.

    A child is one (counts, sum, count) triple keyed by its sorted
    label items; the unlabeled histogram is the ``()`` child.  One lock
    per histogram: observe() holds it for two increments and a list
    index — uncontended nanoseconds, far under the traced work."""

    __slots__ = ("name", "help", "buckets", "_children", "_lock")

    def __init__(self, name: str, help_: str,
                 buckets: "tuple[float, ...]" = HIST_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self._lock = threading.Lock()
        # label-items tuple -> [counts per bucket (+inf last), sum, count]
        self._children: dict = {}       # guarded-by: self._lock

    @staticmethod
    def _key(labels: "dict | None") -> tuple:
        return tuple(sorted(labels.items())) if labels else ()

    def observe(self, seconds: float, labels: "dict | None" = None) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = \
                    [[0] * (len(self.buckets) + 1), 0.0, 0]
            child[0][i] += 1
            child[1] += seconds
            child[2] += 1

    def snapshot(self) -> dict:
        """{label_key: {"counts": [...], "sum": s, "count": n}} — the
        diffable view (FleetReport quantiles subtract a prior snapshot
        so a process-global histogram yields per-run percentiles)."""
        with self._lock:
            return {k: {"counts": list(c[0]), "sum": c[1], "count": c[2]}
                    for k, c in self._children.items()}

    def quantile(self, q: float, labels: "dict | None" = None,
                 since: "dict | None" = None) -> float:
        """q-quantile estimate from bucket counts (``since`` = a prior
        ``snapshot()`` to diff against).  THE quantile implementation —
        FleetReport and every report path derive percentiles here
        (property-tested against sorted-sample truth in
        tests/test_trace.py)."""
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            counts = list(child[0]) if child is not None else None
        if counts is None:
            return 0.0
        if since is not None and key in since:
            prior = since[key]["counts"]
            counts = [a - b for a, b in zip(counts, prior)]
        return quantile_from_counts(self.buckets, counts, q)


def quantile_from_counts(buckets: "tuple[float, ...]", counts: list,
                         q: float) -> float:
    """Linear-interpolated quantile from per-bucket counts (last bucket
    = +Inf, reported as the last finite edge — log buckets make the
    estimate's error one bucket width, which the exposition shares)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    q = min(1.0, max(0.0, q))
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            frac = (rank - cum) / c
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        cum += c
    return buckets[-1]


_hist_lock = threading.Lock()
HISTOGRAMS: dict[str, Histogram] = {}          # guarded-by: _hist_lock


def histogram(name: str, help_: str) -> Histogram:
    """Register (idempotent) and return the named histogram.  Names are
    literal and documented in docs/metrics.md — the registry-consistency
    rule checks this call's first argument like it checks gauge()."""
    with _hist_lock:
        h = HISTOGRAMS.get(name)
        if h is None:
            h = HISTOGRAMS[name] = Histogram(name, help_)
        return h


def observe_histogram(name: str, seconds: float,
                      labels: "dict | None" = None) -> None:
    """Span-close feed (utils/trace.py).  Unknown names raise: the
    span→histogram mapping is a closed registry, and a typo must fail a
    test, not silently drop observations."""
    # lock-free read on the hot path: the registry is append-only and
    # fully populated by the module-level declarations below — a lookup
    # can never observe a partially-built entry
    HISTOGRAMS[name].observe(seconds, labels)   # pbslint: disable=guarded-by


def histogram_snapshot() -> "dict[str, dict]":
    """{series: {"count", "sum_s"}} of every histogram child observed so
    far; a labelled series is keyed ``name{label="value"}`` (labels
    sorted)."""
    with _hist_lock:
        hists = list(HISTOGRAMS.values())
    out = {}
    for h in hists:
        for key, child in h.snapshot().items():
            series = h.name if not key else h.name + "{" + ",".join(
                f'{k}="{v}"' for k, v in key) + "}"
            out[series] = {"count": child["count"], "sum_s": child["sum"]}
    return out


def render_histograms() -> str:
    """Prometheus exposition of every registered histogram
    (``_bucket``/``_sum``/``_count``), cumulative le-counts per child."""
    lines: list[str] = []
    with _hist_lock:
        hists = list(HISTOGRAMS.values())
    for h in hists:
        lines.append(f"# HELP {h.name} {h.help}")
        lines.append(f"# TYPE {h.name} histogram")
        for key, child in sorted(h.snapshot().items()):
            base = list(key)
            cum = 0
            for edge, c in zip(h.buckets, child["counts"]):
                cum += c
                lbl = ",".join(
                    f'{k}="{_esc(str(v))}"'
                    for k, v in base + [("le", f"{edge:g}")])
                lines.append(f"{h.name}_bucket{{{lbl}}} {cum}")
            cum += child["counts"][-1]
            lbl = ",".join(f'{k}="{_esc(str(v))}"'
                           for k, v in base + [("le", "+Inf")])
            lines.append(f"{h.name}_bucket{{{lbl}}} {cum}")
            plain = ",".join(f'{k}="{_esc(str(v))}"' for k, v in base)
            suffix = f"{{{plain}}}" if plain else ""
            lines.append(f"{h.name}_sum{suffix} {child['sum']}")
            lines.append(f"{h.name}_count{suffix} {child['count']}")
    return "\n".join(lines)


# the data-plane latency histograms (fed by utils/trace.py span closes;
# vocabulary in docs/observability.md, rows in docs/metrics.md)
histogram("pbs_plus_job_enqueue_to_grant_seconds",
          "Enqueue to execution-slot grant (incl. pre-exec), by kind")
histogram("pbs_plus_job_grant_to_publish_seconds",
          "Job execution: slot grant to completion, by kind")
histogram("pbs_plus_job_enqueue_to_publish_seconds",
          "Whole job latency: enqueue to successful completion, by kind")
histogram("pbs_plus_session_open_seconds",
          "Session establishment: fleetsim's contended agent dial "
          "(phase=connect, soak-fed) and the backup job-session open "
          "(phase=job)")
histogram("pbs_plus_ingest_stage_seconds",
          "Batched ingest dispatch per stage (cdc/sha/probe/presketch)")
histogram("pbs_plus_chunk_cache_fetch_seconds",
          "Chunk-cache miss loads (disk read + decompress + verify)")
histogram("pbs_plus_digestlog_confirm_read_seconds",
          "Spillable exact-confirm tier segment reads (one fence-guided "
          "pread, or a bulk region read amortizing a batch sweep)")
histogram("pbs_plus_sync_batch_seconds",
          "Sync membership negotiation and chunk transfer, per batch")
histogram("pbs_plus_mux_frame_write_seconds",
          "Mux frame write incl. transport drain (slow readers surface "
          "in the tail)")
histogram("pbs_plus_service_lock_wait_seconds",
          "Wait to acquire a server service's own lock, by service "
          "(where the old Server._prune_lock convoy would "
          "reappear if the service split ever regressed)")


def kernel_launches() -> "dict[str, int]":
    """Launches of the port's kernels in this process so far: K1 and K2
    from their wrappers' counts, K3 from the cuckoo probe's device
    probes; 0 for a module this process never imported."""
    import sys as _sys
    rh = _sys.modules.get("pbs_plus_tpu_torch.ops.rolling_hash")
    sha = _sys.modules.get("pbs_plus_tpu_torch.ops.sha256")
    ck = _sys.modules.get("pbs_plus_tpu_torch.ops.cuckoo")
    return {"candidate_mask": rh.KERNEL.launches if rh else 0,
            "sha256_chunks": sha.KERNEL.launches if sha else 0,
            "cuckoo_probe": ck.stats["device_probes"] if ck else 0}


class MetricsRegistry:
    def __init__(self, server: "Server"):
        self.server = server
        self._ds_scan: tuple[float, int, int] = (0.0, 0, 0)
        # warn ONCE per unreadable manifest, not once per scrape: a
        # permanently corrupt snapshot would otherwise re-warn every
        # Prometheus interval
        self._warned_manifests: set[str] = set()

    def _datastore_usage(self) -> tuple[int, int]:
        """(chunk_count, chunk_disk_bytes), cached — walking the chunk
        dir on every scrape would hammer large datastores."""
        now = time.monotonic()
        t, n, b = self._ds_scan
        if now - t < _DATASTORE_SCAN_TTL:
            return n, b
        n = b = 0
        base = self.server.datastore.datastore.chunks.base
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                try:
                    b += os.path.getsize(os.path.join(dirpath, f))
                    n += 1
                except OSError:
                    pass
        self._ds_scan = (now, n, b)
        return n, b

    def render(self) -> str:
        s = self.server
        lines: list[str] = []

        def gauge(name: str, help_: str, samples: list[tuple[dict, float]]):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            for labels, value in samples:
                lbl = ",".join(f'{k}="{_esc(str(v))}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lbl}}} {value}"
                             if lbl else f"{name} {value}")

        jobs = s.db.list_backup_jobs()
        gauge("pbs_plus_backup_last_run_timestamp",
              "Unix time of the last run",
              [({"job": j.id}, j.last_run_at or 0) for j in jobs])
        gauge("pbs_plus_backup_last_run_success",
              "1 if the last run succeeded",
              [({"job": j.id},
                1.0 if j.last_status in ("success", "warnings") else 0.0)
               for j in jobs])
        gauge("pbs_plus_backup_running",
              "1 while the job is running",
              [({"job": j.id},
                1.0 if s.jobs.is_active(f"backup:{j.id}") else 0.0)
               for j in jobs])
        gauge("pbs_plus_jobs_active", "Active jobs",
              [({}, float(s.jobs.active_count))])
        gauge("pbs_plus_jobs_total", "Job counters",
              [({"result": k}, float(v)) for k, v in s.jobs.stats.items()])
        n_sessions = float(len(s.agents.sessions()))
        gauge("pbs_plus_agents_connected", "Connected agent sessions",
              [({}, n_sessions)])

        # -- fleet admission / queueing (docs/fleet.md) ----------------------
        gauge("pbs_plus_jobs_queued",
              "Jobs admitted but not yet holding an execution slot",
              [({}, float(s.jobs.queued_count))])
        gauge("pbs_plus_jobs_running",
              "Jobs currently holding an execution slot",
              [({}, float(s.jobs.running_count))])
        gauge("pbs_plus_jobs_active_by_tenant",
              "Executing jobs per fairness tenant",
              [({"tenant": t}, float(n))
               for t, n in sorted(s.jobs.tenant_active().items())])
        gauge("pbs_plus_sessions_active", "Registered agent sessions "
              "(alias of pbs_plus_agents_connected, named for the "
              "admission ceiling agent_max_sessions it is gauged against)",
              [({}, n_sessions)])
        adm = s.agents.admission_stats()
        gauge("pbs_plus_admission_rejected_total",
              "Session admissions rejected, by reason",
              [({"reason": k}, float(v))
               for k, v in sorted(adm.items()) if k != "admitted"])
        gauge("pbs_plus_admission_admitted_total",
              "Session admissions accepted",
              [({}, float(adm.get("admitted", 0)))])

        snaps = s.datastore.datastore.list_snapshots(all_namespaces=True)
        gauge("pbs_plus_snapshots_total", "Snapshots in the datastore",
              [({}, float(len(snaps)))])
        per_group: dict[str, int] = {}
        size_per_group: dict[str, int] = {}
        for ref in snaps:
            # ns-prefixed so tenants' same-named groups never merge
            key = f"{ref.ns_rel}{ref.backup_type}/{ref.backup_id}"
            per_group[key] = per_group.get(key, 0) + 1
            try:
                man = s.datastore.datastore.load_manifest(ref)
                size_per_group[key] = size_per_group.get(key, 0) + \
                    man.get("payload_size", 0)
            except Exception as e:
                # a corrupt manifest must not kill the scrape
                if str(ref) not in self._warned_manifests:
                    self._warned_manifests.add(str(ref))
                    L.warning("metrics: manifest unreadable for %s/%s: %s",
                              ref.backup_type, ref.backup_id, e)
        gauge("pbs_plus_snapshots_per_group", "Snapshots per backup group",
              [({"group": g}, float(n)) for g, n in per_group.items()])
        gauge("pbs_plus_snapshot_bytes", "Logical bytes per backup group",
              [({"group": g}, float(n)) for g, n in size_per_group.items()])

        # -- last-run details (reference: per-backup duration/size gauges,
        #    api/metrics.go:21-344) -----------------------------------------
        lr = s.last_run_stats
        gauge("pbs_plus_backup_last_duration_seconds",
              "Wall-clock duration of the last finished run",
              [({"job": j}, st["duration"]) for j, st in lr.items()])
        gauge("pbs_plus_backup_last_bytes",
              "Bytes streamed by the last finished run",
              [({"job": j}, float(st["bytes"])) for j, st in lr.items()])
        gauge("pbs_plus_backup_last_files",
              "Files streamed by the last finished run",
              [({"job": j}, float(st["files"])) for j, st in lr.items()])
        gauge("pbs_plus_backup_last_entries",
              "Archive entries written by the last finished run",
              [({"job": j}, float(st["entries"])) for j, st in lr.items()])
        gauge("pbs_plus_backup_last_error_count",
              "Per-file errors in the last finished run",
              [({"job": j}, float(st["errors"])) for j, st in lr.items()])
        gauge("pbs_plus_backup_last_chunker_backend",
              "Chunker backend pinned at stream open for the last "
              "finished run (cpu/vector/sidecar/tpu)",
              [({"job": j, "backend": st["chunker_backend"]}, 1.0)
               for j, st in lr.items() if st.get("chunker_backend")])

        # -- live speeds for running jobs (reference: live bytes/files
        #    speed gauges) ---------------------------------------------------
        now = time.time()
        live_bytes, live_files, live_speed = [], [], []
        for job_id, (t0, res) in list(s.live_progress.items()):
            if res is None:
                continue
            el = max(now - t0, 1e-3)
            live_bytes.append(({"job": job_id}, float(res.bytes_total)))
            live_files.append(({"job": job_id}, float(res.files)))
            live_speed.append(({"job": job_id}, res.bytes_total / el))
        gauge("pbs_plus_backup_live_bytes",
              "Bytes streamed so far by a running job", live_bytes)
        gauge("pbs_plus_backup_live_files",
              "Files completed so far by a running job", live_files)
        gauge("pbs_plus_backup_live_speed_bytes_per_second",
              "Average throughput of a running job", live_speed)

        # -- schedules --------------------------------------------------------
        import datetime as _dt

        from ..utils import calendar
        next_runs = []
        for j in jobs:
            if j.schedule and j.enabled:
                try:
                    # naive LOCAL time, matching the scheduler's own
                    # reference clock — a tz-aware base here would skew
                    # the gauge by the host's UTC offset
                    after = _dt.datetime.fromtimestamp(j.last_run_at or now)
                    nxt = calendar.compute_next_event(j.schedule, after)
                    if nxt is not None:
                        next_runs.append(({"job": j.id}, nxt.timestamp()))
                except ValueError:
                    pass
        gauge("pbs_plus_backup_next_run_timestamp",
              "Next scheduled run (unix time)", next_runs)
        gauge("pbs_plus_backup_jobs_configured", "Configured backup jobs",
              [({}, float(len(jobs)))])
        gauge("pbs_plus_backup_jobs_by_status", "Backup jobs by last status",
              [({"status": k}, float(v))
               for k, v in s.db.status_counts("backup_jobs").items()])

        # -- restores / tasks -------------------------------------------------
        gauge("pbs_plus_restores_by_status", "Restore jobs by status",
              [({"status": k}, float(v))
               for k, v in s.db.status_counts("restore_jobs").items()])
        gauge("pbs_plus_tasks_by_status", "Task log entries by status",
              [({"status": k}, float(v))
               for k, v in s.db.status_counts("task_log").items()])

        # -- agents / targets (reference: per-target volume usage) -----------
        sess_by_cn = {x.cn: x for x in s.agents.sessions()
                      if x.client_id == x.cn}
        hosts = s.db.list_agent_hosts()
        gauge("pbs_plus_agents_known", "Bootstrapped agent hosts",
              [({}, float(len(hosts)))])
        gauge("pbs_plus_agent_connected", "1 while the agent control "
              "session is up",
              [({"host": h["hostname"]},
                1.0 if h["hostname"] in sess_by_cn else 0.0)
               for h in hosts])
        gauge("pbs_plus_agent_session_age_seconds",
              "Age of the live control session",
              [({"host": cn}, now - x.connected_at)
               for cn, x in sess_by_cn.items()])
        vol_total, vol_free = [], []
        for h in hosts:
            try:
                drives = json.loads(h.get("drives") or "[]")
            except ValueError:
                continue
            for d in drives:
                lbl = {"host": h["hostname"],
                       "mountpoint": str(d.get("mountpoint", ""))}
                if "size_bytes" in d:
                    vol_total.append((lbl, float(d["size_bytes"] or 0)))
                if "free_bytes" in d:
                    vol_free.append((lbl, float(d["free_bytes"] or 0)))
        gauge("pbs_plus_target_volume_size_bytes",
              "Per-target volume capacity (agent drive inventory)",
              vol_total)
        gauge("pbs_plus_target_volume_free_bytes",
              "Per-target volume free space (agent drive inventory)",
              vol_free)
        targets = s.db.list_targets()
        gauge("pbs_plus_targets_configured", "Configured targets",
              [({}, float(len(targets)))])
        gauge("pbs_plus_target_online_timestamp",
              "Last successful target_status probe (unix time)",
              [({"target": t["name"]}, float(t.get("online_at") or 0))
               for t in targets])

        # -- datastore usage / dedup ------------------------------------------
        chunk_n, chunk_b = self._datastore_usage()
        logical = float(sum(size_per_group.values()))
        gauge("pbs_plus_datastore_chunks", "Chunks in the store",
              [({}, float(chunk_n))])
        gauge("pbs_plus_datastore_disk_bytes",
              "Compressed on-disk chunk bytes", [({}, float(chunk_b))])
        gauge("pbs_plus_datastore_dedup_ratio",
              "Logical snapshot bytes / on-disk chunk bytes",
              [({}, logical / chunk_b)] if chunk_b else [])

        # -- pipelined data plane (pxar/pipeline.py) --------------------------
        from ..pxar import pipeline as _pipeline
        snap = _pipeline.metrics_snapshot()
        gauge("pbs_plus_pipeline_stage_bytes_total",
              "Cumulative bytes processed per pipeline stage",
              [({"stage": st}, float(v["bytes"]))
               for st, v in snap["stages"].items()])
        gauge("pbs_plus_pipeline_stage_chunks_total",
              "Cumulative chunks processed per pipeline stage",
              [({"stage": st}, float(v["chunks"]))
               for st, v in snap["stages"].items() if st != "scan"])
        gauge("pbs_plus_pipeline_stage_busy_seconds_total",
              "Cumulative busy time per pipeline stage",
              [({"stage": st}, v["seconds"])
               for st, v in snap["stages"].items()])
        gauge("pbs_plus_pipeline_stage_throughput_mib_s",
              "Per-stage throughput (bytes / busy seconds)",
              [({"stage": st}, v["mib_s"])
               for st, v in snap["stages"].items()])
        gauge("pbs_plus_pipeline_active_streams",
              "PipelinedStreams currently open",
              [({}, float(snap["active_streams"]))])
        gauge("pbs_plus_pipeline_workers",
              "Hash workers across active pipelined streams",
              [({}, float(snap["workers"]))])
        gauge("pbs_plus_pipeline_queue_depth",
              "In-flight items per pipeline queue",
              [({"queue": q}, float(v))
               for q, v in snap["queues"].items()])

        # -- fused cross-session ingest (pxar/ingestbatch.py;
        #    docs/data-plane.md "Fused ingest") ------------------------------
        from ..pxar import ingestbatch as _ingestbatch
        ib = _ingestbatch.metrics_snapshot()
        gauge("pbs_plus_ingest_batch_flushes_total",
              "Fused ingest flushes (one fused scan/sha/probe/presketch "
              "pass each)", [({}, float(ib["flushes"]))])
        gauge("pbs_plus_ingest_batch_sessions_packed_total",
              "Per-flush distinct sessions, summed (divide by flushes "
              "for mean packing factor)",
              [({}, float(ib["sessions_packed"]))])
        gauge("pbs_plus_ingest_batch_rows_total",
              "Ragged scan rows packed across fused flushes",
              [({}, float(ib["rows"]))])
        gauge("pbs_plus_ingest_batch_padding_bytes_total",
              "Halo/alignment overhead bytes in packed scan buffers",
              [({}, float(ib["padding_bytes"]))])
        gauge("pbs_plus_ingest_batch_occupancy",
              "Payload fraction of packed scan buffers (1.0 = zero "
              "packing overhead)", [({}, float(ib["occupancy"]))])

        # -- chunker backends (chunker/observe.py; docs/data-plane.md
        #    "Chunking backends") -------------------------------------------
        from ..chunker import observe as _chunkobs
        co = _chunkobs.snapshot()
        gauge("pbs_plus_chunker_scan_bytes_total",
              "Payload bytes scanned per chunker backend implementation",
              [({"backend": b}, float(v))
               for b, v in sorted(co["scan_bytes"].items())])
        gauge("pbs_plus_chunker_vector_fallbacks_total",
              "Streams degraded vector -> scalar at bind time (failed "
              "vector self-test)",
              [({}, float(co["events"].get("vector_fallbacks", 0)))])

        # -- dedup index (pxar/chunkindex.py; docs/data-plane.md
        #    "Dedup index") ---------------------------------------------------
        from ..pxar import chunkindex as _chunkindex
        di = _chunkindex.metrics_snapshot()
        gauge("pbs_plus_dedup_index_probes_total",
              "Membership probes answered by the dedup index (batched "
              "probes count one per digest)", [({}, float(di["probes"]))])
        gauge("pbs_plus_dedup_index_hits_total",
              "Probes confirmed present (dedup hits)",
              [({}, float(di["hits"]))])
        gauge("pbs_plus_dedup_index_false_positives_total",
              "Filter positives rejected by the exact confirm (never a "
              "false dedup skip)", [({}, float(di["false_positives"]))])
        gauge("pbs_plus_dedup_index_inserts_total",
              "Digests inserted into the index",
              [({}, float(di["inserts"]))])
        gauge("pbs_plus_dedup_index_rebuilds_total",
              "Boot-time shard-scan rebuilds",
              [({}, float(di["rebuilds"]))])
        gauge("pbs_plus_dedup_index_discards_total",
              "Digests discarded by GC sweeps",
              [({}, float(di["discards"]))])
        gauge("pbs_plus_dedup_index_snapshot_loads_total",
              "Journaled index snapshots loaded at boot",
              [({}, float(di["snapshot_loads"]))])
        gauge("pbs_plus_dedup_index_snapshot_saves_total",
              "Journaled index snapshots persisted (post-sweep); a "
              "sweep without a matching save means boots re-pay the "
              "shard scan", [({}, float(di["snapshot_saves"]))])
        gauge("pbs_plus_dedup_index_entries",
              "Digests resident across live dedup indexes",
              [({}, float(di["entries"]))])
        gauge("pbs_plus_dedup_index_resident_bytes",
              "Actual resident bytes of live dedup indexes: filter "
              "table + memtable + fence pointers when the exact tier "
              "spills to segments, filter table + whole exact set in "
              "all-RAM mode",
              [({}, float(di["resident_bytes"]))])

        # -- spillable exact-confirm tier (pxar/digestlog.py;
        #    docs/data-plane.md "Spillable exact-confirm tier") -------------
        from ..pxar import digestlog as _digestlog
        dg = _digestlog.metrics_snapshot()
        gauge("pbs_plus_digestlog_segments",
              "Live on-disk digest segments across spillable indexes",
              [({}, float(dg["segments"]))])
        gauge("pbs_plus_digestlog_spills_total",
              "Memtable spills to a new immutable segment",
              [({}, float(dg["spills"]))])
        gauge("pbs_plus_digestlog_compactions_total",
              "Background segment merges completed",
              [({}, float(dg["compactions"]))])
        gauge("pbs_plus_digestlog_confirm_reads_total",
              "Exact-confirm segment reads (filter positives only — an "
              "all-novel backup performs zero)",
              [({}, float(dg["confirm_reads"]))])

        # -- similarity-dedup delta tier (pxar/similarityindex.py;
        #    docs/data-plane.md "Similarity tier") ---------------------------
        from ..pxar import similarityindex as _simindex
        dl = _simindex.metrics_snapshot()
        gauge("pbs_plus_delta_probes_total",
              "Novel chunks probed against the resemblance index",
              [({}, float(dl["probes"]))])
        gauge("pbs_plus_delta_candidates_total",
              "Banded sketch candidates examined across probes",
              [({}, float(dl["candidates"]))])
        gauge("pbs_plus_delta_hits_total",
              "Novel chunks stored as delta blobs against a base",
              [({}, float(dl["hits"]))])
        gauge("pbs_plus_delta_bytes_saved_total",
              "On-disk bytes saved vs the plain compressed blob",
              [({}, float(dl["bytes_saved"]))])
        gauge("pbs_plus_delta_chain_rejects_total",
              "Probes whose only candidates sat at the max chain depth",
              [({}, float(dl["chain_rejects"]))])
        gauge("pbs_plus_delta_encode_fallbacks_total",
              "Delta attempts that fell back to a full blob "
              "(unprofitable encode, vanished base, injected fault)",
              [({}, float(dl["encode_fallbacks"]))])
        gauge("pbs_plus_delta_reads_total",
              "Delta blobs reassembled on the read path",
              [({}, float(dl["delta_reads"]))])
        gauge("pbs_plus_delta_base_resolves_total",
              "Base-chunk resolutions performed for delta reassembly",
              [({}, float(dl["base_resolves"]))])
        gauge("pbs_plus_delta_read_errors_total",
              "Delta reassemblies that failed (corrupt payload/base — "
              "raised, never served)", [({}, float(dl["read_errors"]))])
        gauge("pbs_plus_delta_refolds_total",
              "Live deltas folded down by GC because their base was "
              "about to be swept (re-delta on GC)",
              [({}, float(dl["refolds"]))])
        gauge("pbs_plus_delta_entries",
              "Sketches resident across live resemblance indexes",
              [({}, float(dl["entries"]))])

        # -- datastore replication (pxar/syncwire.py; docs/sync.md) ----------
        from ..pxar import syncwire as _syncwire
        sy = _syncwire.metrics_snapshot()
        gauge("pbs_plus_sync_jobs_total",
              "Sync runs started", [({}, float(sy["jobs"]))])
        gauge("pbs_plus_sync_snapshots_total",
              "Snapshots mirrored to a destination",
              [({}, float(sy["snapshots"]))])
        gauge("pbs_plus_sync_chunks_probed_total",
              "Digests membership-probed at sync destinations "
              "(batched probes count one per digest)",
              [({}, float(sy["chunks_probed"]))])
        gauge("pbs_plus_sync_probe_batches_total",
              "Membership negotiation batches (one vectorized "
              "destination probe each)",
              [({}, float(sy["probe_batches"]))])
        gauge("pbs_plus_sync_chunks_transferred_total",
              "Chunks that crossed the wire (the destination was "
              "missing them)", [({}, float(sy["chunks_transferred"]))])
        gauge("pbs_plus_sync_chunks_skipped_total",
              "Chunks the destination already held (dedup skips)",
              [({}, float(sy["chunks_skipped"]))])
        gauge("pbs_plus_sync_bytes_wire_total",
              "Compressed-as-stored bytes transferred",
              [({}, float(sy["bytes_wire"]))])
        gauge("pbs_plus_sync_bytes_logical_total",
              "Logical snapshot bytes represented by mirrored "
              "snapshots", [({}, float(sy["bytes_logical"]))])
        gauge("pbs_plus_sync_resumes_total",
              "Sync runs that resumed an interrupted predecessor",
              [({}, float(sy["resumes"]))])
        gauge("pbs_plus_sync_errors_total",
              "Sync runs that failed (typed SyncError)",
              [({}, float(sy["errors"]))])
        sync_rows = s.db.list_sync_jobs()
        gauge("pbs_plus_sync_last_run_timestamp",
              "Unix time of the sync job's last run",
              [({"job": r["id"]}, r["last_run_at"] or 0)
               for r in sync_rows])
        gauge("pbs_plus_sync_last_run_success",
              "1 if the sync job's last run succeeded",
              [({"job": r["id"]},
                1.0 if r["last_status"] == "success" else 0.0)
               for r in sync_rows])

        # -- read-path chunk cache (pxar/chunkcache.py) -----------------------
        from ..pxar import chunkcache as _chunkcache
        cc = _chunkcache.metrics_snapshot()
        gauge("pbs_plus_chunk_cache_hits_total",
              "Chunk reads served from the shared decompressed-chunk "
              "cache", [({}, float(cc["hits"]))])
        gauge("pbs_plus_chunk_cache_misses_total",
              "Chunk reads that went to the chunk source",
              [({}, float(cc["misses"]))])
        gauge("pbs_plus_chunk_cache_evictions_total",
              "Chunks evicted to stay inside the byte budget",
              [({}, float(cc["evictions"]))])
        gauge("pbs_plus_chunk_cache_prefetch_issued_total",
              "Readahead chunk loads issued",
              [({}, float(cc["prefetch_issued"]))])
        gauge("pbs_plus_chunk_cache_prefetch_used_total",
              "Prefetched chunks later served as hits",
              [({}, float(cc["prefetch_used"]))])
        gauge("pbs_plus_chunk_cache_load_errors_total",
              "Chunk loads that failed verification or IO (never "
              "admitted)", [({}, float(cc["load_errors"]))])
        gauge("pbs_plus_chunk_cache_singleflight_shared_total",
              "Concurrent reads coalesced onto another caller's load",
              [({}, float(cc["singleflight_shared"]))])
        gauge("pbs_plus_chunk_cache_probation_admits_total",
              "First-touch chunks admitted to a segment's probationary "
              "region", [({}, float(cc["probation_admits"]))])
        gauge("pbs_plus_chunk_cache_probation_promotions_total",
              "Probationary chunks promoted to protected on "
              "re-reference", [({}, float(cc["probation_promotions"]))])
        gauge("pbs_plus_chunk_cache_base_warms_total",
              "Delta bases warmed alongside a prefetched delta chunk",
              [({}, float(cc["base_warms"]))])
        gauge("pbs_plus_chunk_cache_readahead_window",
              "Adaptive readahead window last used by a reader stream "
              "(chunks)", [({}, float(cc["readahead_window"]))])
        gauge("pbs_plus_chunk_cache_resident_bytes",
              "Decompressed bytes resident in the shared chunk cache",
              [({}, float(cc["resident_bytes"]))])
        gauge("pbs_plus_chunk_cache_budget_bytes",
              "Configured shared chunk cache byte budget",
              [({}, float(cc["budget_bytes"]))])

        # -- durable checkpoints / resume (server/checkpoint.py) -------------
        from . import checkpoint as _checkpoint
        cp = _checkpoint.metrics_snapshot()
        gauge("pbs_plus_checkpoints_written_total",
              "Backup checkpoints persisted", [({}, float(cp["written"]))])
        gauge("pbs_plus_checkpoint_write_failures_total",
              "Checkpoint flushes that failed (backup continued)",
              [({}, float(cp["write_failures"]))])
        gauge("pbs_plus_checkpoint_resumes_total",
              "Backups resumed from a checkpoint",
              [({}, float(cp["resumes"]))])
        gauge("pbs_plus_checkpoint_files_skipped_total",
              "Files spliced from checkpoints without agent reads",
              [({}, float(cp["files_skipped"]))])
        gauge("pbs_plus_checkpoint_bytes_skipped_total",
              "Bytes spliced from checkpoints without agent reads",
              [({}, float(cp["bytes_skipped"]))])
        gauge("pbs_plus_checkpoint_files_reread_total",
              "Files re-streamed by resumed runs (the tail)",
              [({}, float(cp["files_reread"]))])
        gauge("pbs_plus_checkpoint_bytes_reread_total",
              "Bytes re-streamed by resumed runs (the tail)",
              [({}, float(cp["bytes_reread"]))])
        gauge("pbs_plus_checkpoints_swept_total",
              "Stale checkpoints reaped by prune",
              [({}, float(cp["swept"]))])

        # -- fault injection (utils/failpoints.py; armed only in chaos
        #    runs — all three gauges render empty in production) -------------
        from ..utils import failpoints as _failpoints
        fp = _failpoints.snapshot()
        gauge("pbs_plus_failpoints_armed", "Currently armed failpoint sites",
              [({"site": s, "action": a}, 1.0)
               for s, a in fp["armed"].items()])
        gauge("pbs_plus_failpoint_hits_total",
              "Hits per failpoint site while armed (cumulative)",
              [({"site": s}, float(c["hits"]))
               for s, c in fp["counters"].items()])
        gauge("pbs_plus_failpoint_fires_total",
              "Faults injected per failpoint site (cumulative)",
              [({"site": s}, float(c["fires"]))
               for s, c in fp["counters"].items()])

        # -- mounts / server --------------------------------------------------
        ms = getattr(s, "mount_service", None)
        gauge("pbs_plus_mounts_active", "Active snapshot mounts",
              [({}, float(len(ms.mounts) if ms else 0))])
        gauge("pbs_plus_uptime_seconds", "Server uptime",
              [({}, now - s.started_at)])
        lp = getattr(s, "last_prune", {})
        gauge("pbs_plus_prune_last_run_timestamp",
              "Unix time of the last prune+GC",
              [({}, lp["at"])] if lp else [])
        gauge("pbs_plus_prune_last_removed_snapshots",
              "Snapshots removed by the last prune",
              [({}, float(lp["removed"]))] if lp else [])
        gauge("pbs_plus_prune_last_chunks_removed",
              "Chunks collected by the last GC",
              [({}, float(lp["chunks_removed"]))] if lp else [])
        gauge("pbs_plus_prune_last_bytes_freed",
              "Bytes freed by the last GC",
              [({}, float(lp["bytes_freed"]))] if lp else [])
        # -- shared-datastore scale-out (services/prune_service
        #    leader lease + pxar/datastore cross-process write claims) ------
        from ..pxar import datastore as _pxds
        from .services import prune_service as _prune_svc
        gl = _prune_svc.metrics_snapshot()
        gauge("pbs_plus_gc_lease_acquisitions_total",
              "GC leader-lease acquisitions by this process (fresh "
              "grants; renewals and steals counted separately)",
              [({}, float(gl["acquisitions"]))])
        gauge("pbs_plus_gc_lease_renewals_total",
              "GC leader-lease heartbeat renewals (ttl/3 cadence while "
              "a sweep runs)", [({}, float(gl["renewals"]))])
        gauge("pbs_plus_gc_lease_steals_total",
              "Expired GC leases stolen from a dead holder (failover "
              "within one TTL)", [({}, float(gl["steals"]))])
        gauge("pbs_plus_gc_lease_held_skips_total",
              "GC cycles skipped because a live peer held the lease "
              "(the exactly-once-per-cycle witness)",
              [({}, float(gl["held_skips"]))])
        st = _pxds.metrics_snapshot()
        gauge("pbs_plus_store_chunks_written_total",
              "Full-blob chunk writes this process claimed (shared "
              "datastores: summed across the fleet == distinct chunks "
              "written once)", [({}, float(st["chunks_written"]))])
        gauge("pbs_plus_store_cross_process_hits_total",
              "Novel-chunk claims lost to a sibling process that "
              "already held the chunk (the os.link CAS EEXIST — a "
              "cross-process dedup hit, never a second write)",
              [({}, float(st["cross_process_hits"]))])
        gauge("pbs_plus_jobs_queued_shared",
              "DB-wide queued jobs across every process sharing this "
              "datastore (the shared bound's denominator)",
              [({}, float(s.db.queue_depth()))])
        gauge("pbs_plus_db_bytes", "SQLite database size",
              [({}, float(s.db.file_size()))])
        # -- distributed dedup index (parallel/dist_index.py).
        #    Gated on the module being ALREADY imported: a scrape must
        #    never be the thing that pays the import — a process
        #    that never configured a dist index reports zeros.
        import sys as _sys
        _dist = _sys.modules.get("pbs_plus_tpu_torch.parallel.dist_index")
        di = _dist.metrics_snapshot() if _dist is not None else {
            "probes": 0, "wire_requests": 0, "batches": 0,
            "dedup_saved": 0, "inserts": 0, "discards": 0, "errors": 0,
            "rebalances": 0, "segments_shipped": 0, "map_reloads": 0}
        gauge("pbs_plus_dist_index_probes_total",
              "Digests probed through the distributed index client "
              "(batched probes count one per digest)",
              [({}, float(di["probes"]))])
        gauge("pbs_plus_dist_index_wire_requests_total",
              "HTTP requests issued to index shards (≤ shards per "
              "batch — the O(batches×shards) witness)",
              [({}, float(di["wire_requests"]))])
        gauge("pbs_plus_dist_index_probe_batches_total",
              "probe_batch fan-outs issued", [({}, float(di["batches"]))])
        gauge("pbs_plus_dist_index_batch_dedup_saved_total",
              "Intra-batch duplicate digests collapsed before the wire",
              [({}, float(di["dedup_saved"]))])
        gauge("pbs_plus_dist_index_errors_total",
              "Shard requests that failed (their slice answered the "
              "safe false negative)", [({}, float(di["errors"]))])
        gauge("pbs_plus_dist_index_rebalances_total",
              "Shard-map rebalances coordinated",
              [({}, float(di["rebalances"]))])
        gauge("pbs_plus_dist_index_segments_shipped_total",
              "Checksummed digestlog segments shipped during handoff",
              [({}, float(di["segments_shipped"]))])
        gauge("pbs_plus_dist_index_map_reloads_total",
              "Shard-map re-reads over the wire (bootstrap, reject "
              "re-route, corrupt snapshot degradation)",
              [({}, float(di["map_reloads"]))])
        # -- the port's device kernels: launches in this process (K1, K2
        #    and K3; read where the ops modules are already imported)
        gauge("pbs_plus_device_kernel_launches_total",
              "Device kernel launches of this process (candidate_mask = "
              "K1, sha256_chunks = K2, cuckoo_probe = K3)",
              [({"kernel": k}, float(n))
               for k, n in kernel_launches().items()])
        gauge("pbs_plus_scrape_timestamp", "Scrape time", [({}, time.time())])
        # -- latency histograms (utils/trace.py span closes) -----------------
        hist_block = render_histograms()
        if hist_block:
            lines.append(hist_block)
        return "\n".join(lines) + "\n"
