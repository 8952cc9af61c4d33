"""Shared-datastore fleet worker: ONE real server process of the
multi-process soak (docs/fleet.md "Two-process shared datastore",
written for the JAX package).

``fleetsim.run_multiproc_fleet`` spawns two of these as REAL
subprocesses against one datastore directory and one SQLite database,
then drives them over a JSON-per-line stdio protocol (logs go to
stderr, so stdout stays a clean event stream):

    stdin commands                  stdout events
    ------------------------------  ---------------------------------
    {"cmd":"backup","cn","job_id"}  {"event":"done","job_id","ok",...}
    {"cmd":"restore","cn","job_id"} {"event":"done",...,"tree_hash"}
    {"cmd":"verify","cn","job_id"}  {"event":"done",...,"checked"}
    {"cmd":"sync","job_id",
     "mirror_dir"}                  {"event":"done",...,"chunks"}
    {"cmd":"fair_probe","tenants"}  {"event":"fair_probe","order"}
    {"cmd":"failpoint","site",...}  {"event":"failpoint","armed"}
    {"cmd":"gc","grace","slow"}     {"event":"gc_running"} →
                                    {"event":"gc_started"} (lease won)
                                    → {"event":"gc_result","outcome"}
    {"cmd":"drop_group","cn"}       {"event":"dropped","removed"}
    {"cmd":"probe","digests":[hex]} {"event":"probe","present":[...]}
    {"cmd":"metrics"}               {"event":"metrics",...}
    {"cmd":"exit"}                  {"event":"bye"}
                                    {"event":"ready","port","pid"}

Mixed-traffic lanes: ``restore``/``verify``/``sync`` ride
the same shared bounded queue and fairness lanes as ``backup`` and all
answer with a ``done`` event, so the runner can interleave every kind
in one choreography and consume one ``done`` per submitted job.
``fair_probe`` is the deterministic weighted-fair witness (plug the
slots, backlog K jobs per tenant, report the contended grant order);
``failpoint`` arms/disarms a named site (the slowloris admit→register
window) inside THIS process.

This module is the multiproc worker's COMPOSITION ROOT (the second of
the two modules pbslint's ``service-discipline`` rule allows to
construct services): it wires ``JobQueueService`` (DB-shared bounded
queue over the fair JobsManager) and ``PruneService`` (GC leader
lease) around a ``FleetServer`` data plane, exactly like
``server/store.py`` does for the production ``Server`` minus TLS/web.

GC outcomes: ``swept`` (lease won, sweep ran), ``held`` (a live peer
holds the lease — the exactly-once witness), ``deferred`` (jobs still
running fleet-wide), ``error``.  ``--gc-ttl`` bounds failover: SIGKILL
the sweeping worker and a sibling's next ``gc`` steals the lease within
one TTL.

A copy of the JAX package's ``server/fleetproc.py``, its code byte for
byte apart from its imports, which name the port's own modules, its
logger (``logging``; the worker's scoped logger is a ``LoggerAdapter``
carrying the same ``component`` field) and these changes:

- ``--device`` (default ``cuda``; without a card the worker exits
  naming CUDA before it prints ``ready``; ``cpu`` runs the plain
  versions): the worker's ``FleetServer``, its ``JobQueueService``, the
  verify lane's ``VerifyPipeline`` and the sync lane's mirror
  ``Datastore`` are on it, so its sessions launch K1, K2 and K3 there
  and the ``probe`` command is a K3 probe of the worker's device table
  of the shared index;
- the ``metrics`` event carries ``launches``: this process's K1/K2/K3
  launches (``candidate_mask``, ``sha256_chunks``, ``cuckoo_probe``);
- ``main`` installs the package's JSON log with its dedup window on
  stderr (``utils/log.install``), which the reference's worker has from
  importing its log module.

    python -m pbs_plus_tpu_torch.server.fleetproc --state-dir <d>/state \
        --datastore <d>/ds --proc-id p0 --device cuda
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
import time

from ..utils import trace

L = logging.getLogger(__name__)


class FleetLaneError(Exception):
    """A mixed-traffic lane (restore read-back, verify spot-check)
    failed its own invariant — a missing published snapshot or detected
    corruption.  Part of the `fleet-services` typed taxonomy so the
    runner's `done` events carry a matchable name instead of a bare
    RuntimeError string (docs/protocols.md)."""


def _emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


async def _stdin_reader() -> asyncio.StreamReader:
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    return reader


class Worker:
    def __init__(self, args) -> None:
        from . import database
        from .fleetsim import FleetConfig, FleetServer
        from .prune import PrunePolicy
        from .services import (DistIndexService, JobQueueService,
                               PruneService)
        from ..utils import conf

        self.proc_id = args.proc_id
        self.db = database.Database(
            os.path.join(args.state_dir, conf.DEFAULT_DB_NAME))
        cfg = FleetConfig(
            n_agents=args.max_agents, chunk_avg=args.chunk_avg,
            max_concurrent=args.max_concurrent,
            max_queued=args.max_queued,
            mux_write_deadline_s=args.write_deadline,
            admission_deadline_ms=args.admission_deadline_ms,
            reservation_ttl_s=args.reservation_ttl)
        # composition (the store.py pattern, minus TLS/web): job queue
        # first, its JobsManager injected into the data plane, prune
        # last — cross-service needs as narrow late-bound callables
        self.job_queue = JobQueueService(
            db=self.db,
            gc_active=lambda: self.prune.fleet_gc_active(),
            max_concurrent=args.max_concurrent,
            max_queued=args.max_queued, owner=self.proc_id,
            tenant_weights=(conf.parse_tenant_weights(args.tenant_weights)
                            if args.tenant_weights else None),
            device=args.device)
        self.server = FleetServer(args.datastore, cfg,
                                  jobs=self.job_queue.jobs,
                                  shared_instance=self.proc_id,
                                  device=args.device)
        self.job_queue.agents = self.server.agents
        self.job_queue.datastore = self.server.store
        # distributed index: an explicit --dist-index spec
        # routes this worker's membership surface through the shard
        # fleet; without it, adopt any client the ChunkStore built from
        # the PBS_PLUS_DIST_INDEX_SHARDS environment knob
        self.dist_index = DistIndexService(
            shards=args.dist_index, token=args.dist_index_token)
        _chunks = self.server.store.datastore.chunks
        if self.dist_index.enabled:
            self.dist_index.attach(_chunks)
        else:
            self.dist_index.adopt(_chunks)
        self.prune = PruneService(
            datastore=self.server.store,
            policy_factory=PrunePolicy,
            jobs_active=lambda: self.job_queue.active_count,
            db=self.db, holder=self.proc_id,
            lease_ttl_s=args.gc_ttl)
        self._bg: list[asyncio.Task] = []
        self.log = logging.LoggerAdapter(
            L, {"component": f"fleetproc:{self.proc_id}"})

    async def start(self) -> int:
        port = await self.server.start()
        # force the lazy index boot NOW, on the empty/startup store:
        # chunks a sibling writes later must reach this process through
        # the cross-process claim path, not a conveniently timed boot
        # scan (the soak's written-once accounting depends on it)
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.server.store.datastore.chunks.has(
                b"\0" * 32))
        return port

    # -- commands ----------------------------------------------------------
    def cmd_backup(self, msg: dict) -> None:
        from .jobs import Job, QueueFullError
        cn, job_id = msg["cn"], msg["job_id"]
        tenant = msg.get("tenant", cn)
        weight = max(1, int(msg.get("weight", 1)))

        result_box: dict = {}

        async def execute():
            while self.prune.fleet_gc_active():    # never start mid-GC
                await asyncio.sleep(0.2)
            # serialize session startups exactly like the production
            # enqueue path, and feed the same per-service histogram
            t_mu = time.perf_counter()
            async with self.job_queue.jobs.startup_mu:   # pbslint: lock-order jobs.startup-mu
                trace.record("service.lock_wait",
                             time.perf_counter() - t_mu,
                             service="jobqueue")
            result_box["res"] = await self.server.backup_once(cn, job_id)

        async def on_success():
            # emitted from the SUCCESS hook, which the JobQueueService
            # wrapper runs AFTER the shared queue row flips to `done` —
            # the runner keys its GC ticks off this event, and emitting
            # from execute() left a window where a 'running' row made a
            # cycle report `deferred` (a phantom fleet-wide job)
            res = result_box["res"]
            _emit({"event": "done", "job_id": job_id, "ok": True,
                   "entries": res["entries"], "bytes": res["bytes"]})

        async def on_error(exc: BaseException):
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"})

        try:
            self.job_queue.submit(Job(
                id=f"backup:{cn}:{job_id}", kind="backup", tenant=tenant,
                weight=weight, execute=execute, on_success=on_success,
                on_error=on_error))
        except QueueFullError as e:
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"QueueFullError: {e}"})

    # -- mixed-traffic lanes: restore read-back, verify --------------------
    # spot-check and replication ride the SAME shared bounded queue and
    # fairness lanes as the backups; every lane answers with a `done`
    # event so the runner can interleave all kinds in one choreography
    def _latest_ref(self, cn: str):
        ds = self.server.store.datastore
        refs = [r for r in ds.list_snapshots(all_namespaces=True)
                if r.backup_id == cn]
        if not refs:
            raise FleetLaneError(f"no published snapshot for {cn}")
        return max(refs, key=lambda r: r.backup_time)

    def cmd_restore(self, msg: dict) -> None:
        from .jobs import Job, QueueFullError
        cn, job_id = msg["cn"], msg["job_id"]
        box: dict = {}

        async def execute():
            import hashlib

            from ..pxar.transfer import SplitReader
            ds = self.server.store.datastore
            ref = self._latest_ref(cn)

            def _read_back():
                reader = SplitReader.open_snapshot(ds, ref)
                files = []
                for entry in reader.entries():
                    if entry.is_file:
                        files.append((entry.path.lstrip("/"),
                                      reader.read_file(entry)))
                h = hashlib.sha256()
                for rel, data in sorted(files):
                    h.update(rel.encode() + b"\0" + data + b"\0")
                return len(files), h.hexdigest()

            n, tree_hash = await asyncio.get_running_loop() \
                .run_in_executor(None, trace.wrap(_read_back))
            box["n"], box["hash"] = n, tree_hash

        async def on_success():
            _emit({"event": "done", "job_id": job_id, "ok": True,
                   "entries": box["n"], "tree_hash": box["hash"]})

        async def on_error(exc: BaseException):
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"})

        try:
            self.job_queue.submit(Job(
                id=f"restore:{job_id}", kind="restore", tenant="restore",
                execute=execute, on_success=on_success,
                on_error=on_error))
        except QueueFullError as e:
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"QueueFullError: {e}"})

    def cmd_verify(self, msg: dict) -> None:
        from .jobs import Job, QueueFullError
        cn, job_id = msg["cn"], msg["job_id"]
        seed = int(msg.get("seed", 0))
        box: dict = {}

        async def execute():
            import numpy as np

            from ..models.verify import VerifyPipeline
            from ..pxar.transfer import SplitReader
            ds = self.server.store.datastore
            ref = self._latest_ref(cn)

            def _spot_check():
                reader = SplitReader.open_snapshot(ds, ref)
                return VerifyPipeline(
                    device=self.server.store.device).verify_snapshot(
                    reader, sample_rate=1.0,
                    rng=np.random.default_rng(seed))

            res = await asyncio.get_running_loop().run_in_executor(
                None, trace.wrap(_spot_check))
            if not res.ok:
                raise FleetLaneError(
                    f"verify found corruption: {res.corrupt_paths}")
            box["checked"] = res.checked

        async def on_success():
            _emit({"event": "done", "job_id": job_id, "ok": True,
                   "checked": box["checked"]})

        async def on_error(exc: BaseException):
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"})

        try:
            self.job_queue.submit(Job(
                id=f"verify:{job_id}", kind="verify", tenant="verify",
                execute=execute, on_success=on_success,
                on_error=on_error))
        except QueueFullError as e:
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"QueueFullError: {e}"})

    def cmd_sync(self, msg: dict) -> None:
        from .jobs import Job, QueueFullError
        job_id, mirror_dir = msg["job_id"], msg["mirror_dir"]
        box: dict = {}

        async def execute():
            from ..pxar.datastore import Datastore
            from ..pxar.syncwire import (LocalSyncDest, LocalSyncSource,
                                         run_sync)
            box["res"] = await asyncio.get_running_loop().run_in_executor(
                None, trace.wrap(lambda: run_sync(
                    LocalSyncSource(self.server.store.datastore),
                    LocalSyncDest(Datastore(
                        mirror_dir, device=self.server.store.device)),
                    job_id=job_id, state_root=mirror_dir)))

        async def on_success():
            res = box["res"]
            _emit({"event": "done", "job_id": job_id, "ok": True,
                   "chunks": res["chunks_transferred"],
                   "bytes_wire": res["bytes_wire"]})

        async def on_error(exc: BaseException):
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"{type(exc).__name__}: {exc}"})

        try:
            self.job_queue.submit(Job(
                id=f"sync:{job_id}", kind="sync", tenant="sync",
                execute=execute, on_success=on_success,
                on_error=on_error))
        except QueueFullError as e:
            _emit({"event": "done", "job_id": job_id, "ok": False,
                   "error": f"QueueFullError: {e}"})

    async def cmd_fair_probe(self, msg: dict) -> None:
        """Deterministic DRR measurement (docs/fleet.md "Fairness"):
        plug every execution slot, enqueue K jobs per tenant carrying
        the requested weights, release the plugs, and report the order
        in which the backlogged tenants won slot grants.  Every grant
        in that order is CONTENDED, so its all-backlogged prefix must
        split ∝ the weights (±10% — the runner's assertion)."""
        from .jobs import Job
        jobs = self.job_queue.jobs
        tenants: dict = msg.get("tenants", {})
        k = int(msg.get("jobs_per_tenant", 12))
        release = asyncio.Event()
        n_plugs = jobs.max_concurrent

        async def plug():
            await release.wait()

        for p in range(n_plugs):
            jobs.enqueue(Job(id=f"fairprobe:plug:{p}", kind="probe",
                             tenant="fairprobe-plug", execute=plug))
        while jobs.running_count < n_plugs:
            await asyncio.sleep(0)
        order: list = []
        total = len(tenants) * k
        all_done = asyncio.Event()

        async def granted(t: str):
            order.append(t)
            if len(order) >= total:
                all_done.set()

        for t, wgt in sorted(tenants.items()):
            for j in range(k):
                jobs.enqueue(Job(id=f"fairprobe:{t}:{j}", kind="probe",
                                 tenant=t, weight=max(1, int(wgt)),
                                 execute=(lambda t=t: granted(t))))
        release.set()
        await asyncio.wait_for(all_done.wait(), 60)
        _emit({"event": "fair_probe", "order": order})

    def cmd_failpoint(self, msg: dict) -> None:
        from ..utils import failpoints
        site = msg["site"]
        if msg.get("disarm"):
            failpoints.disarm(site)
        else:
            kw = {}
            if msg.get("arg") is not None:
                kw["arg"] = msg["arg"]
            failpoints.arm(site, msg["action"], **kw)
        _emit({"event": "failpoint", "site": site,
               "armed": not msg.get("disarm", False)})

    async def cmd_gc(self, msg: dict) -> None:
        from ..utils import failpoints
        from .services import GCLeaseHeldError
        grace = float(msg.get("grace", 0.0))
        slow = float(msg.get("slow", 0.0))
        _emit({"event": "gc_running"})
        started = asyncio.create_task(self._watch_lease())
        try:
            if slow > 0:
                # hold the sweep open so the runner can SIGKILL us
                # mid-sweep with the lease held (the failover probe)
                with failpoints.armed("pbsstore.chunk.sweep", "delay",
                                      arg=slow):
                    report = await self.prune.run_prune(gc_grace_s=grace)
            else:
                report = await self.prune.run_prune(gc_grace_s=grace)
            _emit({"event": "gc_result", "outcome": "swept",
                   "chunks_removed": report.chunks_removed,
                   "bytes_freed": report.bytes_freed,
                   "snapshots_removed": len(report.removed)})
        except GCLeaseHeldError as e:
            _emit({"event": "gc_result", "outcome": "held",
                   "detail": str(e)})
        except RuntimeError as e:
            _emit({"event": "gc_result", "outcome": "deferred",
                   "detail": str(e)})
        except Exception as e:
            self.log.exception("gc failed")
            _emit({"event": "gc_result", "outcome": "error",
                   "detail": f"{type(e).__name__}: {e}"})
        finally:
            started.cancel()

    async def _watch_lease(self) -> None:
        """Emit gc_started the moment THIS cycle's lease names us — the
        runner's structural I-am-the-leader signal (no sleeps-as-sync:
        the kill choreography keys off this event).  Matching requires
        a live SWEEPING lease renewed at/after this watch began: a
        stale idle row from a previous cycle we won (kept as the
        cycle marker, sweeping=0) must not fire the signal before the
        stalled sweep actually holds the lease."""
        t0 = time.time()
        try:
            while True:
                lease = self.db.get_gc_lease()
                if lease is not None and lease["holder"] == self.proc_id \
                        and lease["sweeping"] \
                        and lease["renewed_at"] >= t0 - 0.5:
                    _emit({"event": "gc_started",
                           "expires_at": lease["expires_at"]})
                    return
                await asyncio.sleep(0.03)
        except asyncio.CancelledError:
            raise

    async def cmd_drop_group(self, msg: dict) -> None:
        cn = msg["cn"]
        ds = self.server.store.datastore
        removed = 0
        for ref in list(ds.list_snapshots(all_namespaces=True)):
            if ref.backup_id == cn:
                await self.prune.delete_snapshot(ref)
                removed += 1
        _emit({"event": "dropped", "cn": cn, "removed": removed})

    def cmd_probe(self, msg: dict) -> None:
        digests = [bytes.fromhex(h) for h in msg.get("digests", [])]
        chunks = self.server.store.datastore.chunks
        present = chunks.probe_batch(digests)
        if present is None:     # index-less store: disk-true fallback
            present = chunks.on_disk_many(digests)
        _emit({"event": "probe", "present": [bool(p) for p in present]})

    def cmd_metrics(self) -> None:
        from ..ops import cuckoo, rolling_hash, sha256
        from ..pxar import chunkindex as _chunkindex
        from ..pxar import datastore as _pxds
        from . import metrics as _metrics
        from .services import prune_service as _prune_svc
        self.job_queue.flush_admission()
        h = _metrics.HISTOGRAMS["pbs_plus_service_lock_wait_seconds"]
        lock_wait = {
            svc: {"p50": h.quantile(0.50, {"service": svc}),
                  "p99": h.quantile(0.99, {"service": svc}),
                  "count": h.snapshot().get(
                      (("service", svc),), {}).get("count", 0)}
            for svc in ("prune", "jobqueue")}
        eh = _metrics.HISTOGRAMS["pbs_plus_job_enqueue_to_publish_seconds"]
        _emit({
            "event": "metrics",
            "proc": self.proc_id,
            "store": _pxds.metrics_snapshot(),
            "gc_lease": _prune_svc.metrics_snapshot(),
            "dedup_index": _chunkindex.metrics_snapshot(),
            "dist_index": self.dist_index.stats(),
            "jobs": dict(self.job_queue.jobs.stats),
            "tenant_grants": dict(self.job_queue.jobs.tenant_grants),
            "queue_counts": self.db.queue_counts(),
            "admission": self.db.admission_counters(),
            "admission_extra": {
                "reservations_reaped":
                    self.server.agents.reservations_reaped,
                "evictions": self.server.agents.evictions,
                "admission_waits": self.server.agents.admission_waits,
            },
            "enqueue_to_publish": {
                "p50": eh.quantile(0.50, {"kind": "backup"}),
                "p99": eh.quantile(0.99, {"kind": "backup"}),
            },
            "mux": self.server.mux_stats(),
            "service_lock_wait": lock_wait,
            "launches": {"candidate_mask": rolling_hash.KERNEL.launches,
                         "sha256_chunks": sha256.KERNEL.launches,
                         "cuckoo_probe": cuckoo.stats["device_probes"]},
        })

    async def run(self) -> None:
        port = await self.start()
        _emit({"event": "ready", "port": port, "pid": os.getpid(),
               "proc": self.proc_id})
        reader = await _stdin_reader()
        while True:
            line = await reader.readline()
            if not line:
                break
            try:
                msg = json.loads(line)
            except ValueError:
                self.log.warning("bad command line: %r", line[:200])
                continue
            cmd = msg.get("cmd", "")
            if cmd == "backup":
                self.cmd_backup(msg)
            elif cmd == "restore":
                self.cmd_restore(msg)
            elif cmd == "verify":
                self.cmd_verify(msg)
            elif cmd == "sync":
                self.cmd_sync(msg)
            elif cmd == "fair_probe":
                self._bg.append(
                    asyncio.create_task(self.cmd_fair_probe(msg)))
            elif cmd == "failpoint":
                self.cmd_failpoint(msg)
            elif cmd == "gc":
                self._bg.append(asyncio.create_task(self.cmd_gc(msg)))
            elif cmd == "drop_group":
                await self.cmd_drop_group(msg)
            elif cmd == "probe":
                self.cmd_probe(msg)
            elif cmd == "metrics":
                self.cmd_metrics()
            elif cmd == "exit":
                break
            else:
                self.log.warning("unknown command %r", cmd)
        await self.job_queue.drain(timeout=60)
        for t in self._bg:
            if not t.done():
                t.cancel()
        await asyncio.gather(*self._bg, return_exceptions=True)
        await self.server.stop()
        self.dist_index.close()
        self.job_queue.flush_admission()
        self.db.close()
        _emit({"event": "bye"})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fleetproc")
    ap.add_argument("--state-dir", required=True)
    ap.add_argument("--datastore", required=True)
    ap.add_argument("--proc-id", required=True)
    ap.add_argument("--gc-ttl", type=float, default=5.0)
    ap.add_argument("--chunk-avg", type=int, default=4 << 10)
    ap.add_argument("--max-agents", type=int, default=64)
    ap.add_argument("--max-concurrent", type=int, default=4)
    ap.add_argument("--max-queued", type=int, default=512)
    ap.add_argument("--write-deadline", type=float, default=60.0)
    ap.add_argument("--tenant-weights", default="",
                    help="fair-share weights 'tenant=w,...' "
                         "(PBS_PLUS_TENANT_WEIGHTS form; empty = 1x)")
    ap.add_argument("--admission-deadline-ms", type=float, default=0.0,
                    help="bounded admission wait at the session "
                         "ceiling (0 = fast-fail 503)")
    ap.add_argument("--reservation-ttl", type=float, default=0.0,
                    help="admission reservation TTL override in "
                         "seconds (0 = default)")
    ap.add_argument("--dist-index", default="",
                    help="distributed index shard spec "
                         "(s0=host:port,...); empty = local index")
    ap.add_argument("--dist-index-token", default="")
    ap.add_argument("--device", default="cuda",
                    help="the worker's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..utils import log
    from ..utils.device import CudaUnavailableError
    log.install()
    try:
        worker = Worker(args)
    except CudaUnavailableError as e:
        raise SystemExit(f"fleetproc: {e}")
    asyncio.run(worker.run())


if __name__ == "__main__":
    main()
