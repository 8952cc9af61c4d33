"""The port's prune and GC against the JAX package's.

Two identical stores, one a JAX ``LocalStore`` and one the port's
``LocalStore(device="cpu")``, get the same snapshots of the same trees
(made from a numpy seed; the index header's urandom(16) uuid and
``time_ns`` pinned); then each package's ``PruneService`` (its GC
leader lease in each package's ``Database``) prunes and sweeps its own.
Held exactly: the snapshots removed and kept, the chunk files swept
and left, the report and ``last_prune``, every digest's verdict from
the store's dedup index afterwards (the port's index answers through
its cuckoo table's plain probe on the CPU), and the index snapshot the
sweep writes, byte for byte, which each package's store then boots from
the other's.  The keep policies themselves (``select_keep``) are held
over seeded snapshot lists, and a second sweeper meets the same
``GCLeaseHeldError``.  Trees chunk at ``ChunkerParams(1024, 64, 1024)``.
"""

import asyncio
import datetime as dt
import os
import shutil

import numpy as np
import pytest

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar import chunkindex as ref_ci
from pbs_plus_tpu.pxar import walker as ref_walker
from pbs_plus_tpu.pxar.datastore import Datastore as RefDatastore
from pbs_plus_tpu.pxar.datastore import SnapshotRef as RefRef
from pbs_plus_tpu.server import database as ref_db
from pbs_plus_tpu.server import prune as ref_prune
from pbs_plus_tpu.server.services import prune_service as ref_ps
from pbs_plus_tpu_torch.chunker import ChunkerParams
from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
from pbs_plus_tpu_torch.pxar import chunkindex as port_ci
from pbs_plus_tpu_torch.pxar import walker as port_walker
from pbs_plus_tpu_torch.pxar.datastore import Datastore as PortDatastore
from pbs_plus_tpu_torch.pxar.datastore import SnapshotRef as PortRef
from pbs_plus_tpu_torch.server import database as port_db
from pbs_plus_tpu_torch.server import prune as port_prune
from pbs_plus_tpu_torch.server.services import prune_service as port_ps
from test_torch_backup_job import chunk_files, pinned

PARAMS = dict(avg_size=1024, min_size=64, max_size=1024)
T0 = 1_753_000_000


def _trees(root, n=3, seed=7):
    """``n`` versions of one tree: a file every version shares and one
    file of each version's own (its chunks die with the version)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, 6000, np.uint8).tobytes()
    out = []
    for i in range(n):
        d = os.path.join(root, f"v{i}")
        os.makedirs(os.path.join(d, "etc"))
        with open(os.path.join(d, "etc", "shared"), "wb") as f:
            f.write(shared)
        with open(os.path.join(d, f"own{i}"), "wb") as f:
            f.write(rng.integers(0, 256, 3000 + 500 * i, np.uint8).tobytes())
        out.append(d)
    return out


def _store(bp, Params, base, pbs, **kw):
    return bp.LocalStore(base, Params(**PARAMS), pbs_format=pbs,
                         dedup_index_mb=1, **kw)


def _fill(store, walker, trees):
    """Group ``a``: one snapshot a tree, a day apart; group ``b``: the
    last tree twice."""
    for group, versions in (("a", trees), ("b", trees[-1:] * 2)):
        for i, tree in enumerate(versions):
            sess = store.start_session(backup_type="host", backup_id=group,
                                       backup_time=T0 + i * 86_400)
            walker.backup_tree(sess, tree)
            sess.finish()


def _prune(ps_mod, db_mod, store, base, policy, **kw):
    async def main():
        db = db_mod.Database(os.path.join(base, "server.db"))
        svc = ps_mod.PruneService(datastore=store,
                                  policy_factory=lambda: policy,
                                  jobs_active=lambda: 0, db=db,
                                  holder="gc-test")
        rep = await svc.run_prune(**kw)
        db.close()
        last = {k: v for k, v in svc.last_prune.items() if k != "at"}
        return rep, last
    return asyncio.run(main())


@pytest.fixture(scope="module", params=[False, True], ids=["tpxd", "pbs"])
def pruned(request, tmp_path_factory):
    pbs = request.param
    root = tmp_path_factory.mktemp(f"prune-{'pbs' if pbs else 'tpxd'}")
    trees = _trees(str(root / "src"))
    out = {}
    with pinned():
        for name, bp, Params, walker, ps_mod, db_mod, prune_mod, kw in (
                ("ref", ref_bp, RefParams, ref_walker, ref_ps, ref_db,
                 ref_prune, {}),
                ("port", port_bp, ChunkerParams, port_walker, port_ps,
                 port_db, port_prune, {"device": "cpu"})):
            base = str(root / name)
            store = _store(bp, Params, os.path.join(base, "ds"), pbs, **kw)
            _fill(store, walker, trees)
            ds = store.datastore
            before = chunk_files(os.path.join(base, "ds"))
            digests = sorted(ds.chunks.iter_digests())
            dry, _ = _prune(ps_mod, db_mod, store, base,
                            prune_mod.PrunePolicy(keep_last=1), dry_run=True)
            assert chunk_files(os.path.join(base, "ds")) == before
            rep, last = _prune(ps_mod, db_mod, store, base,
                               prune_mod.PrunePolicy(keep_last=1),
                               gc_grace_s=0.0)
            with open(ds.chunks._index_snap, "rb") as f:
                snap = f.read()
            out[name] = dict(store=store, base=os.path.join(base, "ds"),
                             before=before, digests=digests, dry=dry,
                             rep=rep, last=last, snap=snap,
                             after=chunk_files(os.path.join(base, "ds")),
                             snaps=[str(r) for r in ds.list_snapshots()])
    probe = sorted(set(out["ref"]["digests"]) | set(out["port"]["digests"]))
    rng = np.random.default_rng(3)
    probe += [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(64)]
    out["probe"] = probe
    return out


def test_prune_removes_the_reference_snapshots(pruned):
    r, p = pruned["ref"], pruned["port"]
    assert vars(p["dry"]) == vars(r["dry"]) and p["dry"].dry_run
    assert vars(p["rep"]) == vars(r["rep"])
    assert p["last"] == r["last"] == {
        "removed": 3, "chunks_removed": p["rep"].chunks_removed,
        "bytes_freed": p["rep"].bytes_freed, "lease_lost": False}
    assert sorted(p["rep"].removed) == [
        "host/a/" + port_bp.format_backup_time(T0 + d) for d in (0, 86_400)
    ] + ["host/b/" + port_bp.format_backup_time(T0)]
    assert p["snaps"] == r["snaps"] and len(p["snaps"]) == 2


def test_gc_sweeps_the_reference_chunk_files(pruned):
    r, p = pruned["ref"], pruned["port"]
    assert p["before"] == r["before"]
    assert p["after"] == r["after"]
    assert p["rep"].chunks_removed > 0
    assert len(p["after"]) == len(p["before"]) - p["rep"].chunks_removed


def test_index_verdicts_after_gc_match_reference(pruned):
    """Every digest ever stored and 64 random ones: swept digests probe
    absent, kept ones present, in both packages alike."""
    r, p = pruned["ref"], pruned["port"]
    probe = pruned["probe"]
    rv = r["store"].datastore.chunks.index.probe_batch(probe)
    pv = p["store"].datastore.chunks.index.probe_batch(probe)
    assert pv == rv
    kept = {os.path.basename(k) for k in p["after"]}
    assert pv == [d.hex() in kept for d in probe]
    assert not all(pv) and any(pv)


def test_index_snapshots_are_byte_identical_and_boot_across(pruned, tmp_path):
    """The sweep's index snapshot: equal bytes, and each package's store
    boots from the other's file (no shard scan) to the same verdicts."""
    r, p = pruned["ref"], pruned["port"]
    assert p["snap"] and p["snap"] == r["snap"]
    probe = pruned["probe"]
    want = r["store"].datastore.chunks.index.probe_batch(probe)
    pbs = "pbs" in os.path.basename(os.path.dirname(r["base"]))
    for src, Ds, ci, kw in ((r, PortDatastore, port_ci, {"device": "cpu"}),
                            (p, RefDatastore, ref_ci, {})):
        dst = str(tmp_path / ci.__name__)
        shutil.copytree(src["base"], dst)
        with open(os.path.join(dst, os.path.relpath(
                src["store"].datastore.chunks._index_snap, src["base"])),
                "wb") as f:
            f.write(src["snap"])
        loads = ci.metrics_snapshot()["snapshot_loads"]
        ds = Ds(dst, pbs_format=pbs, dedup_index_mb=1, **kw)
        assert ds.chunks.index.probe_batch(probe) == want
        assert ci.metrics_snapshot()["snapshot_loads"] == loads + 1


def _snap_lists(rng, n_lists=40):
    out = []
    for _ in range(n_lists):
        base = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
        times = sorted({base + dt.timedelta(
            hours=int(rng.integers(0, 24 * 90))) for _ in range(
                int(rng.integers(0, 25)))})
        out.append([t.strftime("%Y-%m-%dT%H:%M:%SZ") for t in times])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_select_keep_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for times in _snap_lists(rng):
        kw = dict(keep_last=int(rng.integers(0, 4)),
                  keep_daily=int(rng.integers(0, 6)),
                  keep_weekly=int(rng.integers(0, 4)))
        r = ref_prune.select_keep([RefRef("host", "g", t) for t in times],
                                  ref_prune.PrunePolicy(**kw))
        p = port_prune.select_keep([PortRef("host", "g", t) for t in times],
                                   port_prune.PrunePolicy(**kw))
        assert sorted(x.backup_time for x in p) == \
            sorted(x.backup_time for x in r)
    for mod in (ref_prune, port_prune):
        with pytest.raises(ValueError, match="keep_last must be >= 0"):
            mod.PrunePolicy(keep_last=-1)


def test_second_sweeper_meets_the_lease_like_reference(tmp_path):
    """A live lease row of another holder: the typed loser error, the
    held-skip counter, and no sweep, in both packages."""
    out = []
    for name, bp, Params, ps_mod, db_mod, prune_mod, kw in (
            ("ref", ref_bp, RefParams, ref_ps, ref_db, ref_prune, {}),
            ("port", port_bp, ChunkerParams, port_ps, port_db, port_prune,
             {"device": "cpu"})):
        base = str(tmp_path / name)
        store = _store(bp, Params, os.path.join(base, "ds"), False, **kw)
        db = db_mod.Database(os.path.join(base, "server.db"))
        assert db.acquire_gc_lease("other", 60.0)["acquired"]
        db.close()
        skips = ps_mod.metrics_snapshot()["held_skips"]
        with pytest.raises(ps_mod.GCLeaseHeldError) as e:
            _prune(ps_mod, db_mod, store, base,
                   prune_mod.PrunePolicy(keep_last=1), gc_grace_s=0.0)
        out.append((str(e.value).split(" until ")[0],
                    ps_mod.metrics_snapshot()["held_skips"] - skips))
    assert out[0] == out[1] == ("GC lease held by 'other'", 1)
