"""The port's datastore replication against the JAX package's.

``pxar/syncwire.py`` and ``server/sync_job.py`` of ``pbs_plus_tpu_torch``
are held against the JAX package's on the same source stores, made by the
JAX package's ``LocalStore`` from a numpy seed: a tpxd store whose newest
snapshot holds delta blobs whose bases only the delta closure reaches (the
snapshot that referenced them is deleted), and a pbs-layout store.  Each
package syncs each store local to local and over its ``SyncWireServer`` on
loopback (pull from a served source, push into a served destination) into
a destination of its own (the port's ``Datastore(device="cpu")``, whose
membership batches run the plain K3 through the port's ``DedupIndex``).
The destination directories must match byte for byte (``time.time`` is
pinned, so the resume state's times match too) and the stats dicts must be
equal apart from ``wall_s``.  A second run transfers 0 chunks; a run
broken at ``pbsstore.sync.commit`` resumes with fewer chunks; a payload
corrupted at ``pbsstore.sync.transfer`` raises ``SyncError`` and leaves no
chunk that does not verify.  A sync row runs through each package's whole
``Server`` (the port's with ``device="cpu"``): one scheduler tick, then the
five sync routes over HTTP, compared route by route as
``tests/test_torch_web.py`` compares.  Tolerance is exact.
"""

import asyncio
import datetime as dt
import io
import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar import datastore as ref_ds
from pbs_plus_tpu.pxar import syncwire as ref_sw
from pbs_plus_tpu.pxar.deltablob import is_delta, parse_header
from pbs_plus_tpu.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu.server import store as ref_store
from pbs_plus_tpu.server import web as ref_web
from pbs_plus_tpu.utils import failpoints as ref_fp
from pbs_plus_tpu_torch.pxar import datastore as port_ds
from pbs_plus_tpu_torch.pxar import syncwire as port_sw
from pbs_plus_tpu_torch.server import store as port_store
from pbs_plus_tpu_torch.server import web as port_web
from pbs_plus_tpu_torch.utils import failpoints as port_fp

from test_torch_backup_job import files_of

REF = SimpleNamespace(name="ref", sw=ref_sw, ds=ref_ds, fp=ref_fp,
                      store=ref_store, web=ref_web, ds_kw={}, server_kw={})
PORT = SimpleNamespace(name="port", sw=port_sw, ds=port_ds, fp=port_fp,
                       store=port_store, web=port_web,
                       ds_kw={"device": "cpu"}, server_kw={"device": "cpu"})
P = RefParams(avg_size=4 << 10)
T0 = 1_700_000_000.0
TOKEN = "sync-secret"


@pytest.fixture(autouse=True)
def _disarmed():
    for pkg in (REF, PORT):
        pkg.fp.disarm_all()
    yield
    for pkg in (REF, PORT):
        pkg.fp.disarm_all()


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` pinned: the resume state's ``completed_unix`` and
    ``updated_unix`` are the same in both packages."""
    monkeypatch.setattr(time, "time", lambda: T0)


def _snapshot(store, files, backup_id, backup_time):
    sess = store.start_session(backup_type="host", backup_id=backup_id,
                               backup_time=backup_time)
    sess.writer.write_entry(Entry(path="", kind=KIND_DIR))
    for name, data in sorted(files.items()):
        sess.writer.write_entry_reader(Entry(path=name, kind=KIND_FILE),
                                       io.BytesIO(data))
    sess.finish()
    return sess.ref


def _near_dup(data, every=8 << 10):
    out = bytearray(data)
    for off in range(0, len(out), every):
        out[off] ^= 0xFF
    return bytes(out)


def _digests(ds, ref):
    midx, pidx = ds.load_indexes(ref)
    return {midx.digest(i) for i in range(len(midx))} | \
        {pidx.digest(i) for i in range(len(pidx))}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The two source stores, written by the JAX package."""
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(23)
    out = {}
    # tpxd with a delta chain: gen1 is a near-duplicate of gen0, whose
    # snapshot is deleted so its bases are reachable only by the closure
    tpxd = ref_bp.LocalStore(str(root / "tpxd"), P, delta_tier=True)
    gen0 = rng.integers(0, 256, 96 << 10, dtype=np.uint8).tobytes()
    ref0 = _snapshot(tpxd, {"a.bin": gen0}, "a", T0 - 300)
    gen1 = _near_dup(gen0)
    ref1 = _snapshot(tpxd, {"a.bin": gen1, "n.txt": b"sync\n" * 900},
                     "a", T0 - 200)
    b = rng.integers(0, 256, 40 << 10, dtype=np.uint8).tobytes()
    _snapshot(tpxd, {"b.bin": b}, "b", T0 - 100)
    ds = tpxd.datastore
    deltas = [d for d in _digests(ds, ref1) if is_delta(ds.chunks.get_raw(d))]
    bases = {parse_header(ds.chunks.get_raw(d))[3] for d in deltas}
    assert deltas and not bases & _digests(ds, ref1)
    shutil.rmtree(ds.snapshot_dir(ref0))
    out["tpxd"] = SimpleNamespace(base=str(root / "tpxd"), pbs=False,
                                  deltas=deltas, bases=bases)
    pbs = ref_bp.LocalStore(str(root / "pbs"), P, pbs_format=True)
    c = rng.integers(0, 256, 80 << 10, dtype=np.uint8).tobytes()
    _snapshot(pbs, {"c.bin": c}, "c", T0 - 300)
    _snapshot(pbs, {"c.bin": c + b"tail" * 64, "d.bin": b}, "c", T0 - 200)
    out["pbs"] = SimpleNamespace(base=str(root / "pbs"), pbs=True)
    return out


def _open(pkg, base, pbs):
    return pkg.ds.Datastore(base, pbs_format=pbs, **pkg.ds_kw)


def _endpoints(pkg, mode, src_base, dst_base, pbs):
    """(source, dest, closers) of one sync in ``mode``."""
    sw = pkg.sw
    src, dst = _open(pkg, src_base, pbs), _open(pkg, dst_base, pbs)
    if mode == "local":
        return sw.LocalSyncSource(src), sw.LocalSyncDest(dst), []
    if mode == "http-pull":
        srv = sw.SyncWireServer(src, TOKEN)
        url = f"http://127.0.0.1:{srv.start()}"
        source = sw.HttpSyncSource(url, TOKEN)
        return source, sw.LocalSyncDest(dst), [source.close, srv.stop]
    srv = sw.SyncWireServer(dst, TOKEN)
    url = f"http://127.0.0.1:{srv.start()}"
    dest = sw.HttpSyncDest(url, TOKEN)
    return sw.LocalSyncSource(src), dest, [dest.close, srv.stop]


def _sync(pkg, mode, src_base, dst_base, pbs, **kw):
    """One ``run_sync``; its stats without ``wall_s``, or its error."""
    source, dest, closers = _endpoints(pkg, mode, src_base, dst_base, pbs)
    try:
        stats = pkg.sw.run_sync(source, dest, job_id="j1",
                                state_root=dst_base, batch=16, **kw)
        stats.pop("wall_s")
        return stats
    except pkg.sw.SyncError as e:
        return ("SyncError", type(e).__name__)
    finally:
        for close in closers:
            close()


def _tree(base):
    """Every file of a destination, bar its dedup index's own state."""
    return {k: v for k, v in files_of(base).items()
            if not k.startswith(".chunkindex")}


CASES = [("tpxd", "local"), ("tpxd", "http-pull"), ("pbs", "local"),
         ("pbs", "http-push")]
IDS = [f"{a}-{b}" for a, b in CASES]


@pytest.fixture(scope="module")
def mirrors(sources, tmp_path_factory):
    """Each case's two runs in each package, built on first use."""
    built = {}

    def get(layout, mode):
        if (layout, mode) not in built:
            src = sources[layout]
            root = tmp_path_factory.mktemp(f"mirror-{layout}-{mode}")
            out = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(time, "time", lambda: T0)
                for pkg in (REF, PORT):
                    dst = str(root / pkg.name)
                    first = _sync(pkg, mode, src.base, dst, src.pbs)
                    tree = _tree(dst)
                    second = _sync(pkg, mode, src.base, dst, src.pbs)
                    out[pkg.name] = SimpleNamespace(
                        base=dst, first=first, second=second, tree=tree,
                        after=_tree(dst))
            built[(layout, mode)] = out
        return built[(layout, mode)]
    return get


@pytest.mark.parametrize("layout,mode", CASES, ids=IDS)
def test_destination_is_byte_identical_to_reference(mirrors, sources,
                                                    layout, mode):
    m = mirrors(layout, mode)
    r, p = m["ref"], m["port"]
    assert p.first == r.first
    assert p.tree == r.tree
    assert p.first["snapshots_synced"] == 2 and not p.first["resumed"]
    assert p.first["chunks_transferred"] > 10
    # the mirror's snapshot dirs equal the source's, file for file
    src = files_of(sources[layout].base)
    snap = {k: v for k, v in p.tree.items() if k.startswith("host/")}
    assert snap and all(src[k] == v for k, v in snap.items())
    chunks = {k: v for k, v in p.tree.items() if k.startswith(".chunks/")}
    assert chunks and all(src[k] == v for k, v in chunks.items())


@pytest.mark.parametrize("layout,mode", CASES, ids=IDS)
def test_second_run_transfers_nothing_as_reference(mirrors, layout, mode):
    m = mirrors(layout, mode)
    r, p = m["ref"], m["port"]
    assert p.second == r.second
    assert p.second["chunks_transferred"] == 0
    assert p.second["snapshots_skipped"] == 2
    assert p.second["bytes_wire"] == 0
    assert p.after == r.after


def test_delta_chain_mirrors_with_its_bases(mirrors, sources):
    """The tpxd source's delta blobs land as stored, with the bases only
    the closure names; the mirror keeps the ``.delta-tier`` marker."""
    src = sources["tpxd"]
    p = mirrors("tpxd", "local")["port"]
    dst = _open(PORT, p.base, False)
    sds = ref_ds.Datastore(src.base)
    for d in list(src.deltas) + list(src.bases):
        assert dst.chunks.get_raw(d) == sds.chunks.get_raw(d)
    assert ".delta-tier" in p.tree


@pytest.mark.parametrize("layout", ["tpxd", "pbs"])
def test_commit_fault_resumes_with_fewer_chunks_as_reference(
        sources, tmp_path, clock, layout):
    """The second snapshot's publish fails at ``pbsstore.sync.commit``:
    the run raises ``SyncError`` with the first snapshot published, the
    next run counts itself a resume and transfers fewer chunks than a
    whole run; the directories match the reference's at each step."""
    src = sources[layout]
    out = {}
    for pkg in (REF, PORT):
        dst = str(tmp_path / pkg.name)
        with pkg.fp.armed("pbsstore.sync.commit", "raise", nth=2):
            failed = _sync(pkg, "local", src.base, dst, src.pbs)
        broken = _tree(dst)
        resumed = _sync(pkg, "local", src.base, dst, src.pbs)
        out[pkg.name] = (failed, broken, resumed, _tree(dst))
    assert out["port"] == out["ref"]
    failed, broken, resumed, tree = out["port"]
    assert failed == ("SyncError", "SyncError")
    whole = _sync(PORT, "local", src.base, str(tmp_path / "whole"), src.pbs)
    assert resumed["resumed"] is True
    assert resumed["chunks_transferred"] < whole["chunks_transferred"]
    assert resumed["snapshots_synced"] == 1
    assert resumed["snapshots_skipped"] == 1
    # bar the resume state's per-snapshot counts, the same as a whole run
    no_state = lambda t: {k: v for k, v in t.items()
                          if not k.startswith(".sync/")}
    assert no_state(tree) == no_state(_tree(str(tmp_path / "whole")))


@pytest.mark.parametrize("mode", ["local", "http-pull"])
def test_corrupt_transfer_raises_and_leaves_no_torn_chunk(
        sources, tmp_path, clock, mode):
    """A payload corrupted on the wire is caught by the destination's
    verification: ``SyncError``, no snapshot published, no ``.tmp`` debris,
    every chunk that landed verifies, in both packages alike."""
    src = sources["tpxd"]
    out = {}
    for pkg in (REF, PORT):
        dst = str(tmp_path / pkg.name)
        with pkg.fp.armed("pbsstore.sync.transfer", "corrupt", nth=5):
            failed = _sync(pkg, mode, src.base, dst, False)
        out[pkg.name] = (failed, _tree(dst))
    assert out["port"] == out["ref"]
    failed, tree = out["port"]
    assert failed == ("SyncError", "SyncError")
    assert not [k for k in tree if ".tmp" in k]
    assert not [k for k in tree if k.startswith("host/")]
    dst = _open(PORT, str(tmp_path / "port"), False)
    landed = list(dst.chunks.iter_digests())
    assert landed
    for d in landed:
        dst.chunks.get(d)               # decodes and hashes back


# -- a sync row through each package's server and web API ----------------------

NOW = dt.datetime(2026, 7, 29, 2, 0, 10)


async def _drive_server(pkg, base, peer):
    import aiohttp
    from test_torch_web import _norm

    server = pkg.store.Server(pkg.store.ServerConfig(
        state_dir=os.path.join(base, "state"),
        cert_dir=os.path.join(base, "certs"),
        datastore_dir=os.path.join(base, "ds"), chunk_avg=P.avg_size,
        dedup_index_mb=1), **pkg.server_kw)
    await server.start()
    server.scheduler.tick_s = 3600.0
    runner, port = await pkg.web.start_web(server, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{port}/api2/json/d2d"
    aid, secret = server.issue_api_token()
    auth = {"Authorization": f"Bearer {aid}:{secret.hex()}"}
    rec = {}
    try:
        server.db.upsert_sync_job("s1", peer_path=peer, schedule="02:00")
        await server.scheduler.tick(NOW)
        await server.job_queue.drain(timeout=300)
        async with aiohttp.ClientSession() as http:
            async def call(label, method, path, body=None):
                kw = {"json": body} if body is not None else {}
                async with http.request(method, url + path, headers=auth,
                                        **kw) as r:
                    rec[label] = [r.status, r.content_type, await r.json()]

            await call("results-tick", "GET", "/sync/s1/results")
            await call("list", "GET", "/sync")
            await call("add", "POST", "/sync",
                       {"id": "s2", "direction": "push",
                        "remote_url": "http://127.0.0.1:9/",
                        "remote_token": "tok", "schedule": "03:00"})
            await call("add-masked", "POST", "/sync",
                       {"id": "s2", "direction": "push",
                        "remote_url": "http://127.0.0.1:9/",
                        "remote_token": "***"})
            await call("add-bad", "POST", "/sync",
                       {"id": "s3", "direction": "sideways"})
            await call("add-no-id", "POST", "/sync", {"direction": "pull"})
            await call("list-two", "GET", "/sync")
            stored = server.db.get_sync_job("s2")
            await call("run", "POST", "/sync/s1/run")
            await server.job_queue.drain(timeout=300)
            await call("results-run", "GET", "/sync/s1/results")
            await call("run-unknown", "POST", "/sync/nope/run")
            await call("results-unknown", "GET", "/sync/nope/results")
            await call("delete", "DELETE", "/sync/s2")
            await call("list-after", "GET", "/sync")
            await call("tasks", "GET", "/tasks?job=s1")
    finally:
        await runner.cleanup()
        await server.stop()
    # the run's own seconds: ``wall_s`` of the results' report and of the
    # listing's ``last_report`` (a JSON string there)
    for v in rec.values():
        data = v[2].get("data")
        if isinstance(data, dict) and data.get("report"):
            data["report"].pop("wall_s")
        for row in data if isinstance(data, list) else []:
            if row.get("last_report"):
                report = json.loads(row["last_report"])
                report.pop("wall_s")
                row["last_report"] = report
    norm = {k: _norm(v, [(base, "<base>")]) for k, v in rec.items()}
    return norm, stored, _tree(os.path.join(base, "ds"))


def test_sync_row_through_server_and_web_matches_reference(sources,
                                                           tmp_path, clock):
    peer = sources["tpxd"].base
    out = {}
    for pkg in (REF, PORT):
        out[pkg.name] = asyncio.run(_drive_server(
            pkg, str(tmp_path / pkg.name), peer))
    (r, r_stored, r_tree), (p, p_stored, p_tree) = out["ref"], out["port"]
    assert sorted(p) == sorted(r)
    differ = [(k, p[k], r[k]) for k in sorted(r) if p[k] != r[k]]
    assert differ == []
    # not vacuous: the tick's run synced both snapshots, the run over HTTP
    # found them present, the token never echoed and survived the mask
    tick = p["results-tick"][2]["data"]
    assert tick["last_status"] == "success"
    assert tick["report"]["snapshots_synced"] == 2
    assert tick["report"]["chunks_transferred"] > 10
    again = p["results-run"][2]["data"]["report"]
    assert again["chunks_transferred"] == 0
    assert again["snapshots_skipped"] == 2
    assert p["add-bad"][0] == 400 and p["run-unknown"][0] == 404
    assert [row["remote_token"] for row in p["list-two"][2]["data"]] == \
        ["", "***"]
    assert p_stored["remote_token"] == r_stored["remote_token"] == "tok"
    # the server's own store holds the mirror, as the reference's does
    snap = {k: v for k, v in p_tree.items()
            if k.startswith(("host/", ".chunks/"))}
    assert snap and snap == {k: v for k, v in r_tree.items()
                             if k.startswith(("host/", ".chunks/"))}
