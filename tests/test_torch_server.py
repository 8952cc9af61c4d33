"""The port's server shell against the JAX package's.

``Server``, the scheduler, the jobs manager and queue service, the job
socket and the metrics render of ``pbs_plus_tpu_torch/server/`` are held
against the JAX package's on the same inputs, exactly:

- (a) ``calendar.compute_next_event`` over a seeded list of schedules in
  the forms ``tests/test_scheduler.py`` and ``tests/test_utils.py`` use,
  each at several seeded reference times, and ``CalendarError`` on the
  same malformed expressions;
- (b) the ``JobsManager``: one enqueue sequence over tenants, priority
  classes, weights and a queue bound gives the same grant order,
  ``tenant_grants``, ``QueueFullError``s and breaker states;
- (c) ``Scheduler.tick`` at fixed times over the same database rows
  enqueues the same ids (retries and the second-tick dedup included); a
  due sync row fires after the tick's backups and syncs as the JAX
  server's does, a row of the JAX package's ``"tpu"`` kind ends in
  error without holding back the rest of its tick (a ``"cpu"`` row, the
  JAX default, runs), and ``chunker_backend`` picks a ``"cpu"`` server's
  scan as the reference's does;
- (d) one agent job (the agent bootstrapped through
  ``Server.bootstrap_agent`` and connected over mTLS) and one local job,
  fired by a scheduler tick and run by each package's whole ``Server``
  (the JAX one with its ``"tpu"`` chunker kind, the port's with
  ``device="cpu"``): byte-identical chunk and index files, equal
  database rows, and equal ``status``/``list`` answers from the job
  socket, whichever package's ``call_job_rpc`` asks;
- (f) the metrics render after those jobs: the same series with the
  same label names and values, and every value that does not depend on
  time equal (each package's server runs in an interpreter of its own,
  so no earlier test moves its process-wide counters);
- (g) a database copied from a ``Server`` mid-job is reaped at the other
  package's boot exactly as at its own.

Trees chunk at a 1 KiB average and files stay at a few KiB: the plain
SHA-256 steps once per 64-byte block of a batch's longest chunk.  The
snapshot time, the index header's urandom(16) uuid and ``time_ns`` are
pinned (``test_torch_backup_job.pinned``).  The scheduler is ticked by
hand; nothing waits on its 30 s loop.
"""

import asyncio
import datetime as dt
import io
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.agent import lifecycle as ref_lc
from pbs_plus_tpu.agent import snapshots as ref_snaps
from pbs_plus_tpu import arpc as ref_arpc
from pbs_plus_tpu import chunker as ref_chunker
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu.server import database as ref_db
from pbs_plus_tpu.server import jobrpc as ref_jobrpc
from pbs_plus_tpu.server import jobs as ref_jobs
from pbs_plus_tpu.server import metrics as ref_metrics
from pbs_plus_tpu.server import scheduler as ref_sched
from pbs_plus_tpu.server import store as ref_store
from pbs_plus_tpu.utils import calendar as ref_cal
from pbs_plus_tpu.utils import mtls as ref_mtls
from pbs_plus_tpu_torch.agent import lifecycle as port_lc
from pbs_plus_tpu_torch.agent import snapshots as port_snaps
from pbs_plus_tpu_torch import arpc as port_arpc
from pbs_plus_tpu_torch.server import database as port_db
from pbs_plus_tpu_torch.server import jobrpc as port_jobrpc
from pbs_plus_tpu_torch.server import jobs as port_jobs
from pbs_plus_tpu_torch.server import metrics as port_metrics
from pbs_plus_tpu_torch.server import scheduler as port_sched
from pbs_plus_tpu_torch.server import store as port_store
from pbs_plus_tpu_torch.utils import calendar as port_cal
from pbs_plus_tpu_torch.utils import conf as port_conf
from pbs_plus_tpu_torch.utils import mtls as port_mtls
from pbs_plus_tpu_torch.utils import trace as port_trace
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError
from test_torch_backup_job import chunk_files, index_files, make_tree, pinned

REF = SimpleNamespace(name="ref", lc=ref_lc, snaps=ref_snaps, arpc=ref_arpc,
                      db=ref_db, jobrpc=ref_jobrpc, jobs=ref_jobs,
                      metrics=ref_metrics, sched=ref_sched, store=ref_store,
                      cal=ref_cal, mtls=ref_mtls,
                      config_kw={"chunker": "tpu"}, server_kw={})
PORT = SimpleNamespace(name="port", lc=port_lc, snaps=port_snaps,
                       arpc=port_arpc, db=port_db, jobrpc=port_jobrpc,
                       jobs=port_jobs, metrics=port_metrics, sched=port_sched,
                       store=port_store, cal=port_cal, mtls=port_mtls,
                       config_kw={}, server_kw={"device": "cpu"})
NOW = dt.datetime(2026, 7, 29, 2, 0, 10)
DB_NAME = port_conf.DEFAULT_DB_NAME


# -- (a) the calendar ----------------------------------------------------------

_DOWS = ("mon", "tue", "wed", "thu", "fri", "sat", "sun")


def _schedules(form: str, rng, n: int = 30) -> list[str]:
    """``n`` seeded expressions of one form."""
    out = []
    for _ in range(n):
        h, m, s = (int(rng.integers(0, 24)), int(rng.integers(0, 60)),
                   int(rng.integers(0, 60)))
        step = int(rng.integers(1, 31))
        d1, d2 = sorted(rng.choice(7, 2, replace=False))
        if form == "keyword":
            out.append(str(rng.choice(["minutely", "hourly", "daily",
                                       "weekly", "monthly", "yearly",
                                       "annually"])))
        elif form == "time":
            out.append(f"{h:02d}:{m:02d}" if rng.random() < 0.5
                       else f"{h}:{m:02d}:{s:02d}")
        elif form == "step":
            out.append(str(rng.choice([f"*:0/{step}", f"{h}/{1 + step % 5}:00",
                                       f"*:{m % 30}/{step}",
                                       f"{h}..{min(23, h + 3)}:0/{step}"])))
        elif form == "weekday":
            out.append(str(rng.choice([
                f"{_DOWS[d1]} {h:02d}:{m:02d}",
                f"{_DOWS[d1]}..{_DOWS[d2]} {h:02d}:00",
                f"{_DOWS[d1]},{_DOWS[d2]} {h:02d}:{m:02d}"])))
        elif form == "date":
            mon, day = int(rng.integers(1, 13)), int(rng.integers(1, 29))
            out.append(str(rng.choice([
                f"*-*-{day:02d} {h:02d}:{m:02d}",
                f"*-{mon:02d}-{day:02d} {h:02d}:00",
                f"2026-{mon:02d}-{day:02d} {h:02d}:{m:02d}:00",
                f"*-*-1/{1 + step % 10} 00:00"])))
        elif form == "list":
            h2 = (h + 1 + step % 12) % 24
            out.append(str(rng.choice([f"{h:02d},{h2:02d}:30",
                                       f"{min(h, h2)}..{max(h, h2)}:{m:02d}",
                                       f"*-*-* {h:02d}:{m:02d}:{s:02d}"])))
        else:                                  # malformed
            out.append(str(rng.choice([
                "", "99:99", "frob", "25:00", "*:*:*/0", f"{h}:{60 + m}",
                "mon..", "*-13-01", f"{_DOWS[d1]}day 02:00", "1..:00",
                "*-*-* *:*:*:*", f"{h}/0:00"])))
    return out


def _times(rng, n: int = 3) -> list[dt.datetime]:
    base = dt.datetime(2025, 1, 1)
    return [base + dt.timedelta(seconds=int(rng.integers(0, 3 * 365 * 86400)))
            for _ in range(n)]


def _next_or_error(cal, expr, t):
    try:
        return cal.compute_next_event(expr, t)
    except cal.CalendarError as e:
        return ("CalendarError", str(e))


FORMS = ("keyword", "time", "step", "weekday", "date", "list", "malformed")


@pytest.mark.parametrize("form", FORMS)
def test_calendar_next_event_matches_reference(form):
    """30 seeded expressions a form (210 in all), each at three seeded
    reference times: equal next events, or equal ``CalendarError``s."""
    rng = np.random.default_rng(FORMS.index(form))
    exprs = _schedules(form, rng)
    errors = 0
    for expr in exprs:
        for t in _times(rng):
            r = _next_or_error(ref_cal, expr, t)
            assert _next_or_error(port_cal, expr, t) == r, (expr, t)
            errors += isinstance(r, tuple)
    if form == "malformed":
        assert errors == 3 * len(exprs)
    else:
        assert errors == 0
    for expr in exprs:
        try:
            ev = ref_cal.parse(expr)
        except ref_cal.CalendarError:
            with pytest.raises(port_cal.CalendarError):
                port_cal.parse(expr)
            continue
        assert vars(port_cal.parse(expr)) == vars(ev)


# -- (b) the jobs manager ------------------------------------------------------

def _grant_order(pkg, plan, *, max_queued):
    """Run ``plan`` ([(job id, tenant, priority, weight)]) through one
    ``JobsManager`` with a single execution slot; the first job holds the
    slot until every other enqueue has been tried."""
    async def main():
        jm = pkg.jobs.JobsManager(max_concurrent=1, max_queued=max_queued,
                                  tenant_weights={"w3": 3})
        order, rejected = [], []
        gate = asyncio.Event()

        def make(jid):
            async def execute():
                order.append(jid)
                if jid == plan[0][0]:
                    await gate.wait()
            return execute
        for jid, tenant, prio, weight in plan:
            try:
                jm.enqueue(pkg.jobs.Job(id=jid, tenant=tenant,
                                        priority=prio, weight=weight,
                                        execute=make(jid)))
            except pkg.jobs.QueueFullError as e:
                rejected.append((jid, str(e)))
            await asyncio.sleep(0)
        dup = jm.enqueue(pkg.jobs.Job(id=plan[1][0], execute=make("x")))
        gate.set()
        await jm.drain(timeout=10)
        return (order, dict(jm.tenant_grants), rejected, dup,
                dict(jm.stats), jm.active_count, jm.queued_count)
    return asyncio.run(main())


PLANS = {
    "tenants": [(f"j{i}", t, 0, 1) for i, t in enumerate(
        ["a"] + ["noisy"] * 9 + ["b", "c", "noisy", "b"])],
    "priorities": [(f"j{i}", t, p, 1) for i, (t, p) in enumerate(
        [("a", 1), ("a", 1), ("b", 0), ("c", 2), ("b", 0), ("d", 1),
         ("c", 0), ("a", 2), ("d", 0)])],
    "weights": [(f"j{i}", t, 0, w) for i, (t, w) in enumerate(
        [("x", 1)] + [("w3", 1)] * 6 + [("w2", 2)] * 6 + [("w1", 1)] * 6)],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("max_queued", [0, 6])
def test_jobs_manager_grants_match_reference(plan, max_queued):
    r = _grant_order(REF, PLANS[plan], max_queued=max_queued)
    p = _grant_order(PORT, PLANS[plan], max_queued=max_queued)
    assert p == r
    order, grants, rejected, dup, stats, active, queued = p
    assert dup is False and active == queued == 0
    assert len(order) + len(rejected) == len(PLANS[plan])
    assert bool(rejected) == (max_queued == 6)


def test_breakers_match_reference():
    """Per-key breakers: trip, half-open, re-close, the warning path for
    a second threshold, and idle eviction past the registry cap."""
    async def run(pkg):
        jm = pkg.jobs.JobsManager(max_concurrent=2, max_breakers=3,
                                  breaker_idle_evict_s=0.0)
        out = []

        async def boom():
            raise OSError("agent gone")

        async def fine():
            return "ok"
        cb = jm.breaker("agent:a", failure_threshold=2, reset_timeout_s=30.0)
        for fn in (boom, boom, fine):
            try:
                out.append(await cb.call(fn))
            except Exception as e:
                out.append(type(e).__name__)
            out.append(cb.state)
        cb._opened_at -= 31.0           # the reset timeout has passed
        out.append(cb.state)
        out.append(await cb.call(fine))
        out.append(cb.state)
        assert jm.breaker("agent:a", failure_threshold=9) is cb
        for k in ("agent:b", "agent:c", "agent:d", "agent:e"):
            jm.breaker(k)
            out.append(jm.breaker_count)
        out.append(sorted(jm._breakers))
        return out
    r, p = asyncio.run(run(REF)), asyncio.run(run(PORT))
    assert p == r
    assert p[:6] == ["OSError", "closed", "OSError", "open",
                     "CircuitOpenError", "open"]
    assert p[6:9] == ["half-open", "ok", "closed"]


# -- (c) the scheduler ---------------------------------------------------------

def _scheduler_rows(db, pkg):
    rows = [
        ("due", "02:00", dt.datetime(2026, 7, 28, 2, 0, 5), "success", {}),
        ("later", "03:00", dt.datetime(2026, 7, 28, 3, 0, 5), "success", {}),
        ("fresh", "02:00", None, None, {}),
        ("bad", "not-a-schedule!!", None, None, {}),
        ("retry", "", time.time() - 10, "error",
         {"retry": 2, "retry_interval_s": 3600}),
        ("warn", "", time.time() - 10, "warnings",
         {"retry": 2, "retry_interval_s": 1}),
        ("off", "02:00", dt.datetime(2026, 7, 28, 2, 0, 5), "success",
         {"enabled": False}),
        ("every15", "*:0/15", dt.datetime(2026, 7, 29, 1, 40), "success", {}),
    ]
    for jid, sched, last, status, kw in rows:
        db.upsert_backup_job(pkg.db.BackupJobRow(
            id=jid, target="t", source_path="/s", schedule=sched, **kw))
        if last is not None:
            ts = last.timestamp() if isinstance(last, dt.datetime) else last
            with db._lock, db._conn:
                db._conn.execute(
                    "UPDATE backup_jobs SET last_run_at=?, last_status=? "
                    "WHERE id=?", (ts, status, jid))
    db.upsert_verification_job("v-due", schedule="03:00")
    db.record_verification_result("v-due", "success", {})
    with db._lock, db._conn:
        db._conn.execute("UPDATE verification_jobs SET last_run_at=? "
                         "WHERE id=?",
                         (dt.datetime(2026, 7, 28, 3, 0, 2).timestamp(),
                          "v-due"))
    db.upsert_verification_job("v-none", schedule="")
    db.upsert_verification_job("v-onbackup", run_on_backup=True)


def _ticks(pkg, base):
    db = pkg.db.Database(os.path.join(base, "db.sqlite"))
    _scheduler_rows(db, pkg)
    backups, verifies = [], []

    async def eb(row):
        backups.append(row.id)

    async def ev(v):
        verifies.append(v["id"])
    jm = pkg.jobs.JobsManager(max_concurrent=4)
    sched = pkg.sched.Scheduler(db, jm, enqueue_backup=eb,
                                enqueue_verification=ev)
    out = []

    async def main():
        for now in (dt.datetime(2026, 7, 29, 1, 59, 40), NOW, NOW,
                    dt.datetime(2026, 7, 29, 2, 0, 40),
                    dt.datetime(2026, 7, 29, 3, 0, 10)):
            await sched.tick(now)
            out.append((list(backups), list(verifies)))
        sched._retry_at["retry"] = time.time() - 1       # elapse it
        sched.on_backup_complete("")
        await asyncio.sleep(0.01)
        await sched.tick(dt.datetime(2026, 7, 29, 3, 0, 40))
        out.append((list(backups), list(verifies)))
    asyncio.run(main())
    db.close()
    return out


def test_scheduler_ticks_match_reference(tmp_path):
    r = _ticks(REF, str(tmp_path / "ref"))
    p = _ticks(PORT, str(tmp_path / "port"))
    assert p == r
    # the 02:00 slot fires once (second-tick dedup), the retry clock
    # arms and then fires, warnings never retry
    assert p[0][0] == ["every15"]
    assert sorted(p[1][0]) == ["due", "every15", "fresh"]
    assert p[2] == p[1]
    assert p[-1][0].count("retry") == 1 and "warn" not in p[-1][0]
    assert "off" not in p[-1][0] and "bad" not in p[-1][0]
    assert "v-onbackup" in p[-1][1] and "v-due" in p[-1][1]


def _cfg(pkg, base, **kw):
    return pkg.store.ServerConfig(
        state_dir=os.path.join(base, "state"),
        cert_dir=os.path.join(base, "certs"),
        datastore_dir=os.path.join(base, "ds"), chunk_avg=1024,
        dedup_index_mb=1, **{**pkg.config_kw, **kw})


def test_due_sync_row_raises_after_the_ticks_backups(tmp_path):
    """A due sync row fires in the tick after the backups and
    verifications, through the server's own ``_enqueue_sync``
    (``server/sync_job.py``), in both packages alike: the same firing
    order, and the sync run pulls the peer datastore's snapshot with the
    same report (bar its seconds) and the same task row."""
    peer = ref_bp.LocalStore(str(tmp_path / "peer"),
                             ref_chunker.ChunkerParams(avg_size=1024))
    sess = peer.start_session(backup_type="host", backup_id="p",
                              backup_time=1_700_000_000)
    sess.writer.write_entry(Entry(path="", kind=KIND_DIR))
    sess.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE),
                                   io.BytesIO(b"sync me\n" * 900))
    sess.finish()

    async def main(pkg):
        server = pkg.store.Server(_cfg(pkg, str(tmp_path / pkg.name)),
                                  **pkg.server_kw)
        fired = []

        async def eb(row):
            fired.append(row.id)

        async def ev(v):
            fired.append(v["id"])
        real_sync = server.scheduler.enqueue_sync

        async def es(row):
            fired.append(row["id"])
            await real_sync(row)
        server.scheduler.enqueue_backup = eb
        server.scheduler.enqueue_verification = ev
        server.scheduler.enqueue_sync = es
        server.db.upsert_backup_job(pkg.db.BackupJobRow(
            id="b", target="t", source_path="/s", schedule="02:00"))
        server.db.upsert_verification_job("v", schedule="02:00")
        server.db.upsert_sync_job("s", peer_path=str(tmp_path / "peer"),
                                  schedule="02:00")
        await server.scheduler.tick(NOW)
        await server.job_queue.drain(timeout=300)
        row = server.db.get_sync_job("s")
        report = json.loads(row["last_report"])
        report.pop("wall_s")
        tasks = [(t["job_id"], t["kind"], t["status"])
                 for t in server.db.list_tasks()]
        server.db.close()
        return fired, row["last_status"], report, tasks
    got, want = asyncio.run(main(PORT)), asyncio.run(main(REF))
    assert got == want
    fired, status, report, tasks = got
    assert fired == ["b", "v", "s"]
    assert status == "success" and tasks == [("s", "sync", "success")]
    assert report["snapshots_synced"] == 1 and report["chunks_transferred"] > 0


def test_unserved_chunker_row_fails_alone_in_its_tick(tmp_path):
    """A row naming the JAX package's ``"tpu"`` kind, which the port does
    not serve, ticks before a ``"cuda"`` row, a row at ``BackupJobRow``'s
    ``"cpu"`` default and a due verification: the ``"cuda"`` and
    ``"cpu"`` rows and the verification fire in that tick and succeed,
    the ``"tpu"`` row's run ends in error with its task row finished, and
    no task row is left running."""
    src = make_tree(tmp_path / "src", 23)

    async def main():
        server = port_store.Server(_cfg(PORT, str(tmp_path)), device="cpu")
        server.db.upsert_target("loc", "local", root_path=src)
        for jid, kw in (("a-tpu", {"chunker": "tpu"}),
                        ("b-cuda", {"chunker": "cuda"}),
                        ("c-default", {})):
            server.db.upsert_backup_job(port_db.BackupJobRow(
                id=jid, target="loc", source_path="", backup_id=jid,
                schedule="02:00", **kw))
        server.db.upsert_verification_job("v", schedule="02:00")
        await server.scheduler.tick(NOW)
        fired = [j for j in ("backup:a-tpu", "backup:b-cuda",
                             "backup:c-default", "verify:v")
                 if server.jobs.is_active(j)]
        await server.job_queue.drain(timeout=300)
        rows = {j.id: (j.last_status, j.last_error)
                for j in server.db.list_backup_jobs()}
        tasks = sorted((t["job_id"], t["kind"], t["status"])
                       for t in server.db.list_tasks())
        verified = server.db.get_verification_job("v")["last_status"]
        server.db.close()
        return fired, rows, tasks, verified
    fired, rows, tasks, verified = asyncio.run(main())
    assert fired == ["backup:b-cuda", "backup:c-default", "verify:v"]
    assert rows["b-cuda"] == rows["c-default"] == ("success", "")
    status, error = rows["a-tpu"]
    assert status == "error" and "'tpu' is the JAX package's" in error
    assert tasks == [("a-tpu", "backup", "error"),
                     ("b-cuda", "backup", "success"),
                     ("c-default", "backup", "success"),
                     ("v", "verify", "success")]
    assert verified == "success"


@pytest.mark.parametrize("field", ["chunker_backend", "pbs_auth_key_path",
                                   "pbs_csrf_key_path",
                                   "pbs_auth_allowed_users"])
def test_unported_config_field_raises_naming_its_module(tmp_path, field):
    """Every ``ServerConfig`` field of the reference is taken now.  The
    PBS ticket fields are read by the web API (``server/web.py``,
    ``server/pbsauth.py``), whose app loads them as the reference's does
    (a missing key file leaves ticket auth off).  ``chunker_backend``
    picks the scan of a server whose kind is ``"cpu"``, as the
    reference's does: ``"vector"`` the self-tested vector factory,
    anything else the scalar chunker (an unknown value with a warning)."""
    if field != "chunker_backend":
        server = port_store.Server(_cfg(PORT, str(tmp_path), **{field: "x"}),
                                   device="cpu")
        assert getattr(server.config, field) == "x"
        from pbs_plus_tpu_torch.server.web import build_app
        assert build_app(server) is not None
        return
    for value in ("vector", "scalar", "x"):
        kinds = []
        for pkg in (REF, PORT):
            server = pkg.store.Server(_cfg(
                pkg, str(tmp_path / f"{pkg.name}-{value}"), chunker="cpu",
                chunker_backend=value), **pkg.server_kw)
            factory = server.datastore._chunker_factory
            chunker = factory(server.datastore.params)
            kinds.append((type(factory).__name__, type(chunker).__name__,
                          server.datastore.batch_hasher))
            server.db.close()
        assert kinds[0] == kinds[1]
        assert kinds[1][1:] == ("VectorChunker" if value == "vector"
                                else "CpuChunker", None)


def test_server_without_device_raises_before_touching_disk(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        port_store.Server(_cfg(PORT, str(tmp_path)))
    assert os.listdir(tmp_path) == []
    assert port_store.ServerConfig("s", "c", "d").chunker == "cuda"
    assert ref_store.ServerConfig("s", "c", "d").chunker == "cpu"


# -- (d) whole servers, scheduled jobs, the job socket -------------------------

def _bootstrap(pkg, server, base, host):
    """``host``'s key and CSR, signed through a bootstrap token."""
    tid, secret = server.issue_bootstrap_token()
    key = pkg.mtls.generate_private_key()
    cert = server.bootstrap_agent(host, pkg.mtls.make_csr(key, host), tid,
                                  secret)
    paths = (os.path.join(base, f"{host}.pem"),
             os.path.join(base, f"{host}.key"))
    for p, data in zip(paths, (cert, pkg.mtls.key_pem(key))):
        with open(p, "wb") as f:
            f.write(data)
    return paths


async def _rpc_answers(sock):
    """status and list over the job socket, asked by both packages'
    ``call_job_rpc``."""
    out = {}
    for name, mod in (("ref", ref_jobrpc), ("port", port_jobrpc)):
        out[name] = [await mod.call_job_rpc(sock, req) for req in (
            {"op": "status", "job_id": "ja"},
            {"op": "status", "job_id": "jl"},
            {"op": "status", "job_id": "nope"},
            {"op": "list"}, {"op": "frob"})]
    return out


def _run_server(pkg, base, src, local_src):
    async def main():
        server = pkg.store.Server(_cfg(pkg, base), **pkg.server_kw)
        await server.start()
        cert, key = _bootstrap(pkg, server, base, "h0")
        tls = pkg.arpc.TlsClientConfig(cert, key, server.certs.ca_cert_path)
        agent = pkg.lc.AgentLifecycle(
            pkg.lc.AgentConfig(hostname="h0", server_host="127.0.0.1",
                               server_port=server.config.arpc_port, tls=tls,
                               drive_update_interval_s=0),
            snapshot_manager=pkg.snaps.SnapshotManager(prefer_direct=True))
        task = asyncio.ensure_future(agent.run())
        await server.agents.wait_session("h0", timeout=10)
        server.db.upsert_target("loc", "local", root_path=local_src)
        for jid, target in (("ja", "h0"), ("jl", "loc")):
            server.db.upsert_backup_job(pkg.db.BackupJobRow(
                id=jid, target=target, source_path=src if jid == "ja" else "",
                backup_id=jid, schedule="02:00", chunker="",
                exclusions=["*.tmp"]))
        server.db.add_exclusion("*.bak")
        await server.scheduler.tick(NOW)
        enqueued = server.jobs.stats["enqueued"]
        await server.scheduler.tick(NOW)
        assert server.jobs.stats["enqueued"] == enqueued == 2
        await server.job_queue.drain(timeout=60)
        sock = os.path.join(server.config.state_dir, "job.sock")
        answers = await _rpc_answers(sock)
        render = pkg.metrics.MetricsRegistry(server).render()
        rows = {j.id: {k: v for k, v in vars(j).items()
                       if k not in ("last_run_at",)}
                for j in server.db.list_backup_jobs()}
        tasks = sorted((t["job_id"], t["kind"], t["status"], t["detail"],
                        t["log"]) for t in server.db.list_tasks())
        with server.db._lock:
            queue = sorted(tuple(r) for r in server.db._conn.execute(
                "SELECT id, kind, tenant, status, error FROM job_queue"))
        await agent.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await server.stop()
        return dict(rows=rows, tasks=tasks, queue=queue, answers=answers,
                    render=render, ds=os.path.join(base, "ds"))
    return asyncio.run(main())


# One package's whole server in an interpreter of its own: the render's
# counters are process-wide, and in a test worker earlier tests (armed
# failpoints, indexes left for the collector) would move them
_CHILD = r"""
import functools, json, sys
sys.path.insert(0, sys.argv[1])
import conftest                          # jax on the CPU, the repo on the path
import test_torch_server as t
pkg = t.REF if sys.argv[2] == "ref" else t.PORT
with t.pinned() as mp:
    mp.setattr(pkg.snaps, "SnapshotManager", functools.partial(
        pkg.snaps.SnapshotManager, prefer_direct=True))
    out = t._run_server(pkg, *sys.argv[3:])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("servers")
    # two trees: the jobs run at once, and chunks the two sessions shared
    # would be probed once or twice as their flushes happen to meet
    src, local_src = make_tree(root / "src", 21), make_tree(root / "loc", 22)
    tests = os.path.dirname(os.path.abspath(__file__))
    procs = {pkg.name: subprocess.Popen(
        [sys.executable, "-c", _CHILD, tests, pkg.name, str(root / pkg.name),
         src, local_src], cwd=os.path.dirname(tests), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pkg in (REF, PORT)}
    out = {"src": src}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-4000:]
        out[name] = SimpleNamespace(**json.loads(stdout.splitlines()[-1]))
    return out


def test_scheduled_jobs_write_the_reference_files(servers):
    r, p = servers["ref"], servers["port"]
    assert chunk_files(p.ds) and chunk_files(p.ds) == chunk_files(r.ds)
    idx = index_files(p.ds)
    assert len(idx) == 4 and idx == index_files(r.ds)


def test_scheduled_jobs_leave_the_reference_rows(servers):
    r, p = servers["ref"], servers["port"]
    assert p.rows == r.rows
    assert {j: row["last_status"] for j, row in p.rows.items()} == {
        "ja": "success", "jl": "success"}
    assert p.tasks == r.tasks and [t[2] for t in p.tasks] == ["success", "success"]
    assert p.queue == r.queue == [
        ["backup:ja", "backup", "h0", "done", ""],
        ["backup:jl", "backup", "loc", "done", ""]]


def test_job_socket_answers_match_across_packages(servers):
    """``status``, ``list``, an unknown job and an unknown op: the same
    answers from either server, whichever package's client asks."""
    r, p = servers["ref"].answers, servers["port"].answers
    assert p["port"] == p["ref"] == r["ref"] == r["port"]
    status, _, unknown, listing, bad = p["port"]
    assert status["job"]["last_status"] == "success"
    assert not status["job"]["running"]
    assert unknown == {"ok": False, "error": "unknown job"}
    assert [j["running"] for j in listing["jobs"]] == [False, False]
    assert bad == {"ok": False, "error": "unknown op 'frob'"}


def test_restore_queue_names_the_missing_module(tmp_path):
    """``restore_queue`` is live (``server/restore_job.py`` is ported): a
    malformed snapshot ref is refused by the restore job itself, with the
    reference's answer, and no module is named missing."""
    async def main():
        server = port_store.Server(_cfg(PORT, str(tmp_path)), device="cpu")
        await server.start()
        try:
            return await port_jobrpc.call_job_rpc(
                os.path.join(server.config.state_dir, "job.sock"),
                {"op": "restore_queue", "target": "h", "snapshot": "s",
                 "destination": "/d"})
        finally:
            await server.stop()
    resp = asyncio.run(main())
    assert resp == {"ok": False, "error": "ValueError: bad snapshot ref 's' "
                                          "(want [ns/<n>/...]type/id/time)"}


# -- (f) the metrics render ----------------------------------------------------

def _series(text):
    """{(name, ((label, value), ...)): value} of a Prometheus render.  A
    ``backend`` label names the chunker that scanned (``tpu`` in the JAX
    package, ``cuda`` or ``torch-cpu`` in the port): it reads as one
    placeholder."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, rest = head.partition("{")
        labels = dict(kv.split("=", 1) for kv in rest.rstrip("}").split(",")
                      if kv) if rest else {}
        if "backend" in labels:
            labels["backend"] = "<chunker>"
        out[(name, tuple(sorted(labels.items())))] = float(value)
    return out


# Each package's server renders in an interpreter of its own, so every
# sample is the run's own and compares whole, except those that depend on
# time: timestamps, durations, ages and rates (a histogram's buckets and
# sum, but not its count), the database file's size, and the count of
# mux frame writes (the agent's connection sends a keepalive every 30 s,
# so the count depends on how long the run took).
_TIMED = ("timestamp", "_seconds", "speed", "throughput", "mib_s",
          "pbs_plus_db_bytes")


def _untimed(series):
    return {k: v for k, v in series.items()
            if k[0] != "pbs_plus_mux_frame_write_seconds_count"
            and (k[0].endswith("_seconds_count")
                 or not any(t in k[0] for t in _TIMED))}


# The port's own family: its kernels' launches (the JAX package has no
# such series); on the CPU every count is 0
PORT_ONLY = "pbs_plus_device_kernel_launches_total"


def _types(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE ") and PORT_ONLY not in line)


def port_only(series):
    """The port's series without its own family, which must be there."""
    assert {k[1] for k in series if k[0] == PORT_ONLY} == {
        (("kernel", f'"{k}"'),)
        for k in ("candidate_mask", "sha256_chunks", "cuckoo_probe")}
    return {k: v for k, v in series.items() if k[0] != PORT_ONLY}


def test_metrics_render_matches_reference(servers):
    r, p = servers["ref"], servers["port"]
    assert _types(p.render) == _types(r.render)
    rs, ps = _series(r.render), port_only(_series(p.render))
    assert set(ps) == set(rs)           # names, label names and values
    pv = _untimed(ps)
    assert pv == _untimed(rs)
    # the port's own index and job counters moved
    assert pv[("pbs_plus_dedup_index_probes_total", ())] > 0
    assert pv[("pbs_plus_dedup_index_inserts_total", ())] > 0
    assert pv[("pbs_plus_snapshots_total", ())] == 2
    assert pv[("pbs_plus_backup_last_run_success", (("job", '"ja"'),))] == 1
    kind = (("kind", '"backup"'),)
    assert pv[("pbs_plus_job_grant_to_publish_seconds_count", kind)] == 2


def test_span_closes_feed_labelled_histograms():
    """``$attr`` labels resolve from the span's attributes (a missing one
    is the empty label), ``record`` feeds the same registry, and
    ``histograms()`` reads it back; the span lands in the ring."""
    key = 'pbs_plus_job_enqueue_to_grant_seconds{kind="restore"}'
    empty = 'pbs_plus_service_lock_wait_seconds{service=""}'
    closed = []
    h0 = port_trace.histograms()
    port_trace.subscribe(closed.append)
    try:
        with port_trace.span("job", job_id="hist-test") as sp:
            port_trace.record("job.enqueue_to_grant", 0.002, kind="restore")
            port_trace.record("service.lock_wait", 0.001)
            assert sp.span_id in {sid for _, sid, _ in
                                  port_trace.active_spans()}
    finally:
        port_trace.unsubscribe(closed.append)
    h1 = port_trace.histograms()
    for k in (key, empty):
        assert h1[k]["count"] == h0.get(k, {"count": 0})["count"] + 1
    mine = [r for r in closed if r["span"] == sp.span_id]
    assert [r["name"] for r in mine] == ["job"]
    assert mine[0]["attrs"] == {"job_id": "hist-test"}
    assert mine[0] in port_trace.recent()
    assert sp.span_id not in {sid for _, sid, _ in port_trace.active_spans()}
    with pytest.raises(ValueError):
        port_trace.record("job.nope", 1.0)


# -- (g) reap at boot ----------------------------------------------------------

def _mid_job_copies(pkg, base, src, n=2):
    """A ``pkg`` server whose local job is inside its pre-script, which
    waits for a file: the database copied then (sqlite's backup API)
    ``n`` times, and the job released."""
    release = os.path.join(base, "release")

    async def main():
        server = pkg.store.Server(_cfg(pkg, base), **pkg.server_kw)
        await server.start()
        server.db.upsert_target("loc", "local", root_path=src)
        server.db.upsert_backup_job(pkg.db.BackupJobRow(
            id="jl", target="loc", source_path="", backup_id="jl",
            chunker="",
            pre_script=f"while [ ! -e '{release}' ]; do sleep 0.02; done"))
        server.db.upsert_backup_job(pkg.db.BackupJobRow(
            id="gone", target="loc", source_path="", enabled=False))
        server.db.create_task("UPID:dead", "gone", "backup")
        assert server.enqueue_backup("jl")
        db_path = os.path.join(server.config.state_dir, DB_NAME)
        for _ in range(3000):
            if server.db.queue_counts().get("running"):
                break
            await asyncio.sleep(0.01)
        copies = []
        for i in range(n):
            dst = os.path.join(base, f"copy{i}.db")
            with sqlite3.connect(db_path) as a, sqlite3.connect(dst) as b:
                a.backup(b)
            copies.append(dst)
        open(release, "w").close()
        await server.job_queue.drain(timeout=60)
        await server.stop()
        return copies
    return asyncio.run(main())


def _boot(pkg, base, db_copy, dead):
    """Boot a ``pkg`` server over ``db_copy`` (with the seal key and
    certificates of the server ``dead`` that wrote it) and read what the
    boot left."""
    async def main():
        cfg = _cfg(pkg, base, resume_requeue_delay_s=3600.0)
        shutil.copytree(os.path.join(dead, "certs"), cfg.cert_dir)
        os.makedirs(cfg.state_dir)
        shutil.copy(db_copy, os.path.join(cfg.state_dir, DB_NAME))
        shutil.copy(os.path.join(dead, "state", "secret.key"),
                    cfg.state_dir)
        server = pkg.store.Server(cfg, **pkg.server_kw)
        await server.start()
        tasks = sorted((t["job_id"], t["kind"], t["status"], t["log"])
                       for t in server.db.list_tasks())
        with server.db._lock:
            queue = sorted(tuple(r) for r in server.db._conn.execute(
                "SELECT id, kind, tenant, status, error FROM job_queue"))
        pending = len(server.checkpoints._tasks)
        await server.stop()
        return tasks, queue, pending
    return asyncio.run(main())


@pytest.mark.parametrize("died", [REF, PORT], ids=["ref-died", "port-died"])
def test_boot_reaps_a_dead_servers_database_like_reference(tmp_path, died):
    src = make_tree(tmp_path / "src", 4, files=2)
    base = str(tmp_path / "dead")
    a, b = _mid_job_copies(died, base, src)
    r = _boot(REF, str(tmp_path / "ref"), a, base)
    p = _boot(PORT, str(tmp_path / "port"), b, base)
    assert p == r
    tasks, queue, pending = p
    assert ("jl", "backup", "error",
            "error: interrupted by server restart\n"
            "re-enqueued for resume after restart\n") in tasks
    assert ("gone", "backup", "error",
            "error: interrupted by server restart\n") in tasks
    assert queue == [("backup:jl", "backup", "loc", "error",
                      "owner restarted")]
    assert pending == 1
