"""The port's verification job against the JAX package's.

Both jobs run over the same datastores: snapshots written by the JAX
``LocalStore`` and by the port's ``LocalStore(device="cpu")``, in the
native ``tpxd`` layout (tpxar entries carry a whole-file digest, so the
job re-hashes sampled files) and in the stock-PBS layout (pxar v2 entries
carry none, so the job re-reads and re-hashes chunks).  The port's job
runs with ``device="cpu"``: ``VerifyPipeline`` on the plain SHA-256.

Held exactly: the reports at a sample rate of 1.0; one flipped byte in a
payload chunk file, which the PBS layout reports as ``chunk:<hex>`` and
which the tpxd layout turns into an ``OSError`` ("corrupt on disk") out
of the file-level path, as the reference does (a fault of the reference
the port keeps); ``pick_snapshots``' order; ``verify_worker_count``;
``enqueue_verification`` against the JAX ``JobsManager`` and
``Database``, also with the queue at its bound (the JAX manager raises
its own ``QueueFullError``); and ``check_source_drift`` against an agent
served over an in-process aRPC pair.

Files stay under 4 KiB: the plain SHA-256 takes one step per 64-byte
block of the longest file.
"""

import asyncio
import hashlib
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.arpc.mux import MuxConnection as RefMux
from pbs_plus_tpu.arpc.router import HandlerError, Router
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar.backupproxy import LocalStore as RefLocalStore
from pbs_plus_tpu.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu.pxar.transfer import SplitReader as RefSplitReader
from pbs_plus_tpu.server import jobs as ref_jobs
from pbs_plus_tpu.server import verification_job as ref_vj
from pbs_plus_tpu.server.database import Database
from pbs_plus_tpu_torch.arpc import MuxConnection
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.pxar import format as port_fmt
from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
from pbs_plus_tpu_torch.pxar.transfer import SplitReader
from pbs_plus_tpu_torch.server import jobs as port_jobs
from pbs_plus_tpu_torch.server import verification_job as port_vj

PARAMS = dict(avg_size=1024, min_size=64, max_size=1024)
T0 = 1_700_000_000


def _files(seed, n=5):
    rng = np.random.default_rng(seed)
    return {f"f{i}.bin": rng.integers(0, 256, int(rng.integers(200, 4000)),
                                      np.uint8).tobytes() for i in range(n)}


def _backup(store, fmt, group, files, t):
    sess = store.start_session(backup_type="host", backup_id=group,
                               backup_time=t)
    w = sess.writer
    w.write_entry(fmt.Entry(path="", kind=fmt.KIND_DIR, mode=0o40755))
    for path, data in sorted(files.items()):
        w.write_entry_reader(fmt.Entry(path=path, kind=fmt.KIND_FILE,
                                       size=len(data)), io.BytesIO(data))
    sess.finish()


def _store(base, pbs, writer):
    """A datastore with two groups and three snapshots, written by
    either package; returns its ``Datastore``."""
    if writer == "ref":
        st = RefLocalStore(base, RefParams(**PARAMS), pbs_format=pbs,
                           dedup_index_mb=1)
        fmt = SimpleNamespace(Entry=Entry, KIND_DIR=KIND_DIR,
                              KIND_FILE=KIND_FILE)
    else:
        st = LocalStore(base, ChunkerParams(**PARAMS), pbs_format=pbs,
                        dedup_index_mb=1, device="cpu")
        fmt = port_fmt
    a1, b1 = _files(1), _files(2)
    a2 = dict(a1, **{"f1.bin": a1["f1.bin"][::-1]})
    _backup(st, fmt, "a", a1, T0)
    _backup(st, fmt, "b", b1, T0 + 10)
    _backup(st, fmt, "a", a2, T0 + 20)
    return st.datastore


def _server(ds, **kw):
    return SimpleNamespace(config=SimpleNamespace(verify_workers=0),
                           datastore=SimpleNamespace(datastore=ds), **kw)


def _run(job, server, v, **kw):
    return asyncio.run(job.run_verification(server, v, **kw))


def _flip_payload_chunk(ds):
    """Flip one byte in the middle of the first payload chunk of the
    newest snapshot; returns the snapshot and the chunk's digest."""
    ref = ds.list_snapshots()[-1]
    _midx, pidx = ds.load_indexes(ref)
    digest = pidx.digest(0)
    path = ds.chunks._path(digest)
    with open(path, "r+b") as f:
        raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0x40
        f.seek(0)
        f.write(raw)
    return ref, digest


WRITERS = ["ref", "port"]
CODECS = [False, True]


@pytest.mark.parametrize("pbs", CODECS, ids=["tpxd", "pbs"])
@pytest.mark.parametrize("writer", WRITERS, ids=["ref-written", "port-written"])
def test_reports_equal_reference(tmp_path, pbs, writer):
    ds = _store(str(tmp_path), pbs, writer)
    v = {"id": "v1", "sample_rate": 1.0}
    got = _run(port_vj, _server(ds), v, device="cpu")
    want = _run(ref_vj, _server(ds), v)
    assert got == want
    assert got["corrupt"] == [] and got["drift"] == []
    assert len(got["snapshots"]) == 3
    if pbs:
        # chunk level: each snapshot's distinct chunks, summed
        distinct = 0
        for ref in ds.list_snapshots():
            distinct += len({idx.digest(i) for idx in ds.load_indexes(ref)
                             for i in range(len(idx))})
        assert got["checked"] == distinct
    else:
        assert got["checked"] == 3 * 5


@pytest.mark.parametrize("writer", WRITERS, ids=["ref-written", "port-written"])
def test_flipped_chunk_reported_in_pbs_layout(tmp_path, writer):
    ds = _store(str(tmp_path), True, writer)
    ref, digest = _flip_payload_chunk(ds)
    v = {"id": "v1", "sample_rate": 1.0}
    got = _run(port_vj, _server(ds), v, device="cpu")
    want = _run(ref_vj, _server(ds), v)
    assert got == want
    assert {"snapshot": str(ref), "files": [f"chunk:{digest.hex()}"]} \
        in got["corrupt"]


@pytest.mark.parametrize("writer", WRITERS, ids=["ref-written", "port-written"])
def test_flipped_chunk_raises_in_tpxd_layout_as_reference(tmp_path, writer):
    """The reference's file-level path reads each sampled file through
    the chunk cache, and a chunk failing its digest raises out of
    ``read_file`` uncaught: the job ends in an error with no report.
    The port keeps that fault."""
    ds = _store(str(tmp_path), False, writer)
    _, digest = _flip_payload_chunk(ds)
    v = {"id": "v1", "sample_rate": 1.0}
    with pytest.raises(OSError, match="corrupt on disk") as want:
        _run(ref_vj, _server(ds), v)
    with pytest.raises(OSError, match="corrupt on disk") as got:
        _run(port_vj, _server(ds), v, device="cpu")
    assert str(got.value) == str(want.value)
    assert digest.hex() in str(got.value)


def test_pick_snapshots_same_order(tmp_path):
    """Oldest unverified first: ages from each manifest's creation or
    last verification, one snapshot verified recently goes last."""
    ds = _store(str(tmp_path), False, "ref")
    snaps = ds.list_snapshots()
    for i, ref in enumerate(snaps):
        man = ds.load_manifest(ref)
        man["created_unix"] = T0 - 1000 * (i + 1)
        if i == len(snaps) - 1:
            man["verified_at"] = T0 + 10 ** 9
        with open(os.path.join(ds.snapshot_dir(ref), ds.MANIFEST), "w") as f:
            json.dump(man, f)
    for k in (1, 2, 3, 5):
        got = port_vj.pick_snapshots(_server(ds), max_count=k)
        assert got == ref_vj.pick_snapshots(_server(ds), max_count=k)
    assert port_vj.pick_snapshots(_server(ds)) == \
        [snaps[1], snaps[0], snaps[2]]


@pytest.mark.parametrize("workers", [None, 0, 1, 3, -2, 64])
def test_verify_worker_count_same(workers):
    srv = SimpleNamespace(config=SimpleNamespace(verify_workers=workers))
    assert port_vj.verify_worker_count(srv) == ref_vj.verify_worker_count(srv)


def _task_row(db, vid):
    rows = db.list_tasks(job_id=vid)
    assert len(rows) == 1
    return rows[0]


@pytest.mark.parametrize("job", [ref_vj, port_vj], ids=["ref", "port"])
def test_enqueue_verification_on_reference_jobs_manager(tmp_path, job):
    ds = _store(str(tmp_path / "ds"), True, "ref")
    kw = {"device": "cpu"} if job is port_vj else {}

    async def main():
        db = Database(str(tmp_path / "db.sqlite"))
        db.upsert_verification_job("v1", sample_rate=1.0)
        jobs = ref_jobs.JobsManager(max_concurrent=1, max_queued=4)
        srv = _server(ds, db=db, jobs=jobs)
        assert job.enqueue_verification(srv, {"id": "v1",
                                              "sample_rate": 1.0}, **kw)
        # a second enqueue of the running job is deduplicated
        assert not job.enqueue_verification(srv, {"id": "v1"}, **kw)
        await jobs.wait("verify:v1", timeout=60)
        row = _task_row(db, "v1")
        assert (row["kind"], row["status"]) == ("verify", "success")
        assert row["upid"].startswith("UPID:") and ":verify:v1:" in row["upid"]
        assert "corruption reports" in row["log"]
        assert db.get_verification_job("v1")["last_status"] == "success"

        # the queue at its bound: the JAX manager raises its own
        # QueueFullError, and the task ends in error
        full = ref_jobs.JobsManager(max_concurrent=1, max_queued=1)

        async def idle():
            await asyncio.sleep(0)
        assert full.enqueue(ref_jobs.Job(id="other", execute=idle))
        srv2 = _server(ds, db=db, jobs=full)
        assert job.enqueue_verification(srv2, {"id": "v2"}, **kw) is False
        row = _task_row(db, "v2")
        assert row["status"] == "error" and "jobs queue full" in row["log"]
        await full.wait("other", timeout=10)
        db.close()
    asyncio.run(main())


def test_port_queue_full_is_caught_from_either_package():
    assert port_jobs.is_queue_full(port_jobs.QueueFullError("x"))
    assert port_jobs.is_queue_full(ref_jobs.QueueFullError("x"))
    assert not port_jobs.is_queue_full(RuntimeError("x"))

    class Sub(ref_jobs.QueueFullError):
        pass
    assert port_jobs.is_queue_full(Sub("x"))


def test_check_source_drift_same_as_reference(tmp_path):
    """An agent answering ``verify_start`` over an in-process aRPC pair:
    the right digest for one file, a wrong one for another, an error for
    a third.  Both jobs report the same drift, through their own mux."""
    files = {"ok.bin": b"o" * 3000, "changed.bin": b"c" * 2000,
             "gone.bin": b"g" * 1000}
    st = RefLocalStore(str(tmp_path / "ds"), RefParams(**PARAMS),
                       dedup_index_mb=1)
    fmt = SimpleNamespace(Entry=Entry, KIND_DIR=KIND_DIR, KIND_FILE=KIND_FILE)
    _backup(st, fmt, "job-a", files, T0)
    ds = st.datastore
    ref = ds.list_snapshots()[0]
    src = str(tmp_path / "src")

    router = Router()

    @router.handle("verify_start")
    async def verify_start(req, ctx):
        name = os.path.basename(req.payload["path"])
        assert os.path.dirname(req.payload["path"]) == src
        if name == "gone.bin":
            raise HandlerError("no such file")
        data = files[name] if name == "ok.bin" else b"edited"
        return {"sha256": hashlib.sha256(data).hexdigest()}

    db = SimpleNamespace(
        list_backup_jobs=lambda: [SimpleNamespace(
            id="j", backup_id="job-a", target="agent-1", source_path=src)],
        get_target=lambda name: {"hostname": "host-1"})

    async def drift(job, mux_cls, reader_cls):
        served = []

        async def on_conn(r, w):
            conn = RefMux(r, w, is_client=False, keepalive_s=0)
            conn.start()
            served.append(asyncio.create_task(router.serve_connection(conn)))

        srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        r, w = await asyncio.open_connection("127.0.0.1", port)
        conn = mux_cls(r, w, is_client=True, keepalive_s=0)
        conn.start()
        agents = {"host-1": SimpleNamespace(conn=conn)}
        server = _server(ds, db=db, agents=agents)
        try:
            return await job.check_source_drift(
                server, ref, reader_cls.open_snapshot(ds, ref),
                rng=np.random.default_rng(5))
        finally:
            await conn.close()
            for t in served:
                t.cancel()
            srv.close()
            await srv.wait_closed()

    got = asyncio.run(drift(port_vj, MuxConnection, SplitReader))
    want = asyncio.run(drift(ref_vj, RefMux, RefSplitReader))
    assert got == want
    assert got == {"sampled": 3, "drifted": ["changed.bin",
                                             "gone.bin (unreadable on agent)"]}

    # no connected agent: no drift check at all
    server = _server(ds, db=db, agents={})
    assert asyncio.run(port_vj.check_source_drift(
        server, ref, SplitReader.open_snapshot(ds, ref),
        rng=np.random.default_rng(5))) is None
