"""The port's mount stack and commit engine against the JAX package's.

The reference's ``mounted`` fixture (a small tree backed up into a
``LocalStore`` and mounted as ``ArchiveView`` + ``Journal`` +
``MutableFS`` + ``CommitEngine``) is built once with the JAX package and
once with the port (``device="cpu"``: the plain K1 behind the port's
chunker, the plain SHA-256 behind its batch hasher and its verify, the
port's ``DedupIndex`` on the CPU), in both layouts (the native ``tpxd``
one and the stock-PBS one).  Both get the same mutations through their
``MutableFS`` and the same commits: the round trip, the rename chain,
five rapid-fire commits and a commit whose verify fails.

Chunk files and index files must match byte for byte after every commit
(the index header's random uuid and time, the journal's mtimes and the
snapshot time are pinned for both packages), manifests must be equal
apart from their creation second and the chunker backend's label, and
the ``CommitProgress`` counters, journal stats and raises must be equal.
Tolerance is exact.

The plain SHA-256 on the CPU takes one step per 64-byte block of a
batch's longest message, and the verify hashes whole changed files, so
the trees chunk at a 4 KiB average with 4 KiB at most and the changed
files stay small.
"""

import asyncio
import hashlib
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu import mount as ref_mount
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.mount import control as ref_control
from pbs_plus_tpu.mount import journal as ref_journal
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar import transfer as ref_tr
from pbs_plus_tpu.pxar import walker as ref_walker
from pbs_plus_tpu_torch import mount as port_mount
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.mount import control as port_control
from pbs_plus_tpu_torch.mount import journal as port_journal
from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
from pbs_plus_tpu_torch.pxar import chunkcache as port_cache
from pbs_plus_tpu_torch.pxar import transfer as port_tr
from pbs_plus_tpu_torch.pxar import walker as port_walker

REF = SimpleNamespace(name="ref", mount=ref_mount, bp=ref_bp, tr=ref_tr,
                      walker=ref_walker, journal=ref_journal,
                      control=ref_control, Params=RefParams, kw={}, ekw={})
PORT = SimpleNamespace(name="port", mount=port_mount, bp=port_bp, tr=port_tr,
                       walker=port_walker, journal=port_journal,
                       control=port_control, Params=ChunkerParams,
                       kw={"device": "cpu"}, ekw={"device": "cpu"})
PARAMS = dict(avg_size=4096, min_size=1024, max_size=4096)
T0 = 1_700_000_000
LAYOUTS = [False, True]
LAYOUT_IDS = ["tpxd", "pbs"]


def _blob(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def _src_tree(root):
    """The reference's ``mounted`` tree (tests/test_mount.py), mtimes
    pinned."""
    (root / "docs").mkdir(parents=True)
    (root / "data").mkdir()
    (root / "docs" / "a.txt").write_text("alpha " * 1000)
    (root / "docs" / "b.txt").write_text("beta " * 1000)
    (root / "data" / "big.bin").write_bytes(_blob(120_000, seed=1))
    (root / "root.txt").write_text("root file")
    for dp, dn, fn in os.walk(root):
        for n in dn + fn:
            os.utime(os.path.join(dp, n), ns=(T0 * 10**9, T0 * 10**9))
    os.utime(root, ns=(T0 * 10**9, T0 * 10**9))
    return root


class _Clock:
    """``time`` for the stores' modules: ``time()`` is pinned (snapshots
    of one second bump by +1 s, as the reference does), the rest real."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(T0)


def _pin(mp):
    """Index headers' uuid and time, journal mtimes and snapshot times
    pinned for both packages (the passthrough files' random names are
    left random)."""
    real = os.urandom
    mp.setattr(os, "urandom", lambda n: b"\x5a" * n if n == 16 else real(n))
    mp.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)
    for bp in (ref_bp, port_bp):
        mp.setattr(bp, "time", _Clock())


@pytest.fixture
def pinned(monkeypatch):
    _pin(monkeypatch)


def _mount(pkg, base, src, *, pbs, engine_cls=None, store=None):
    """``pkg``'s mount of a fresh backup of ``src`` under ``base``."""
    if store is None:
        store = pkg.bp.LocalStore(os.path.join(base, "ds"),
                                  pkg.Params(**PARAMS), pbs_format=pbs,
                                  dedup_index_mb=1, **pkg.kw)
        sess = store.start_session(backup_type="host", backup_id="m")
        pkg.walker.backup_tree(sess, str(src))
        sess.finish()
        ref = sess.ref
    else:
        ref = store.datastore.last_snapshot("host", "m")
    view = pkg.mount.ArchiveView(store.open_snapshot(ref))
    journal = pkg.mount.Journal(os.path.join(base, "journal", "j.db"))
    fs = pkg.mount.MutableFS(view, journal, os.path.join(base, "pass"))
    engine = (engine_cls or pkg.mount.CommitEngine)(
        fs, store, backup_id="m", previous=ref, **pkg.ekw)
    return SimpleNamespace(fs=fs, engine=engine, store=store, first=ref)


def _files(root, prefix=""):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            rel = os.path.relpath(p, root)
            if rel.startswith(prefix):
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _progress(p):
    return (p.phase, p.entries, p.ref_files, p.changed_files, p.verified,
            p.snapshot)


def _manifest(store, ref):
    m = dict(store.datastore.load_manifest(ref))
    m.pop("created_unix")
    m.pop("chunker_backend")
    return m


def _read_all(reader):
    return {e.path: (e.kind, e.size, e.digest,
                     reader.read_file(e) if e.is_file else None)
            for e in reader.entries()}


def _scenario(pkg, base, src, pbs):
    """The reference's commit tests, one after another on one mount:
    the round trip, the rename chain, five rapid-fire commits and a
    commit whose verify fails.  Returns each step's record."""
    m = _mount(pkg, base, src, pbs=pbs)
    fs, engine, store = m.fs, m.engine, m.store
    phases = []
    engine.progress.listeners.append(lambda ph, info: phases.append(ph))
    steps = {}

    def commit(name):
        before = fs.journal.stats()
        ref = engine.commit()
        steps[name] = SimpleNamespace(
            ref=str(ref), progress=_progress(engine.progress),
            journal_before=before, journal_after=fs.journal.stats(),
            manifest=_manifest(store, ref), generation=fs.view.generation,
            passthrough=os.listdir(fs.passthrough),
            read=_read_all(store.open_snapshot(ref)))

    fs.write("docs/a.txt", b"CHANGED!", 0)
    fs.mkdir("newdir")
    fs.create("newdir/new.bin")
    fs.write("newdir/new.bin", _blob(8_000, seed=9))
    fs.unlink("root.txt")
    commit("roundtrip")
    fs.rename("data/big.bin", "data/moved.bin")
    commit("rename")
    for i in range(5):
        fs.create(f"f{i}.txt")
        fs.write(f"f{i}.txt", f"cycle {i}".encode())
        commit(f"rapid{i}")
    fs.write("docs/a.txt", b"WILLFAIL", 0)
    before = store.datastore.list_snapshots()
    saved = type(engine)._verify

    def boom(self, reader):
        raise RuntimeError("verify exploded")
    type(engine)._verify = boom
    try:
        with pytest.raises(RuntimeError) as ei:
            engine.commit()
    finally:
        type(engine)._verify = saved
    steps["fail"] = SimpleNamespace(
        error=str(ei.value), snapshots_unchanged=
        store.datastore.list_snapshots() == before,
        generation=fs.view.generation, read=fs.read("docs/a.txt")[:8],
        journal=fs.journal.stats())
    fs.write("docs/a.txt", b"again", 0)
    return SimpleNamespace(m=m, steps=steps, phases=phases,
                           files=_files(os.path.join(base, "ds")))


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """Both packages' scenario per layout, built on first use."""
    built = {}

    def get(pbs):
        if pbs not in built:
            src = _src_tree(tmp_path_factory.mktemp("src") / "t")
            out = {}
            with pytest.MonkeyPatch.context() as mp:
                _pin(mp)
                for pkg in (REF, PORT):
                    base = tmp_path_factory.mktemp(f"{pkg.name}-{pbs}")
                    out[pkg.name] = _scenario(pkg, str(base), src, pbs)
            built[pbs] = out
        return built[pbs]
    return get


STEPS = ["roundtrip", "rename"] + [f"rapid{i}" for i in range(5)]


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_commit_roundtrip_matches_reference(scenarios, pbs):
    s = scenarios(pbs)
    r, p = s["ref"].steps["roundtrip"], s["port"].steps["roundtrip"]
    assert p.ref == r.ref == f"host/m/{port_bp.format_backup_time(T0 + 1)}"
    assert p.progress == r.progress
    assert p.manifest == r.manifest
    assert p.read == r.read
    # the reference test's checks, on the port
    assert "root.txt" not in p.read
    assert p.read["docs/a.txt"][3][:8] == b"CHANGED!"
    assert p.read["newdir/new.bin"][3] == _blob(8_000, seed=9)
    assert p.manifest["stats"]["ref_chunks"] > 0
    assert p.progress[2] >= 2                   # big.bin + docs/b.txt
    assert p.journal_after["edges"] == 0 and p.journal_before["edges"] > 0
    assert p.generation == 1 and p.passthrough == []


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_commit_rename_chain_matches_reference(scenarios, pbs):
    s = scenarios(pbs)
    r, p = s["ref"].steps["rename"], s["port"].steps["rename"]
    assert (p.ref, p.progress, p.manifest) == (r.ref, r.progress, r.manifest)
    assert p.manifest["stats"]["ref_chunks"] > 0
    assert p.read["data/moved.bin"][1] == 120_000
    assert p.read["data/moved.bin"][3] == _blob(120_000, seed=1)
    assert "data/big.bin" not in p.read


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_rapid_fire_commits_match_reference(scenarios, pbs):
    s = scenarios(pbs)
    for i in range(5):
        r, p = s["ref"].steps[f"rapid{i}"], s["port"].steps[f"rapid{i}"]
        assert (p.ref, p.progress, p.manifest, p.read) == \
            (r.ref, r.progress, r.manifest, r.read)
        for k in range(i + 1):
            assert p.read[f"f{k}.txt"][3] == f"cycle {k}".encode()
        assert p.generation == i + 3
    snaps = s["port"].m.store.datastore.list_snapshots("host", "m")
    assert len(snaps) == 8          # the backup, round trip, rename, 5 rapid
    assert [str(x) for x in snaps] == [
        str(x) for x in s["ref"].m.store.datastore.list_snapshots("host", "m")]


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_commit_failure_leaves_old_state_as_reference(scenarios, pbs):
    s = scenarios(pbs)
    r, p = s["ref"].steps["fail"], s["port"].steps["fail"]
    assert p.__dict__ == r.__dict__
    assert p.error == "verify exploded" and p.snapshots_unchanged
    assert p.generation == 7 and p.read == b"WILLFAIL"
    assert p.journal["edges"] > 0


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_chunk_and_index_files_match_reference(scenarios, pbs):
    s = scenarios(pbs)
    ref, port = s["ref"].files, s["port"].files
    chunks = [k for k in ref if k.startswith(".chunks")]
    assert chunks and sorted(k for k in port if k.startswith(".chunks")) \
        == sorted(chunks)
    assert all(ref[k] == port[k] for k in chunks)
    names = ("root.mpxar.didx", "root.ppxar.didx") if pbs \
        else ("root.midx", "root.pidx")
    idx = sorted(k for k in ref if os.path.basename(k) in names)
    assert len(idx) == 2 * 8
    assert idx == sorted(k for k in port if os.path.basename(k) in names)
    for k in idx:
        assert ref[k] == port[k], k


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_journal_stats_and_phases_match_reference(scenarios, pbs):
    s = scenarios(pbs)
    for name in STEPS:
        r, p = s["ref"].steps[name], s["port"].steps[name]
        assert (p.journal_before, p.journal_after) == \
            (r.journal_before, r.journal_after), name
    assert s["port"].phases == s["ref"].phases
    assert s["port"].phases[:7] == ["freeze", "prepare", "walk", "upload",
                                    "verify", "swap", "done"]
    assert s["port"].m.fs.journal.stats() == s["ref"].m.fs.journal.stats()
    assert s["port"].m.fs.stats == s["ref"].m.fs.stats


def _flip_one_digest(base):
    class FlippingEngine(base):
        """Flips one bit of one entry's expected digest before the real
        verify, so the verdict is the hash's own."""

        def _verify_entries(self, vp, reader, entries):
            e = entries[0]
            e.digest = bytes([e.digest[0] ^ 1]) + e.digest[1:]
            return super()._verify_entries(vp, reader, entries)
    return FlippingEngine


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_failing_digest_raises_as_reference(tmp_path, pinned, pbs):
    src = _src_tree(tmp_path / "src")
    got = {}
    for pkg in (REF, PORT):
        m = _mount(pkg, str(tmp_path / pkg.name), src, pbs=pbs,
                   engine_cls=_flip_one_digest(pkg.mount.CommitEngine))
        m.fs.write("docs/b.txt", b"flip", 0)
        before = m.store.datastore.list_snapshots()
        with pytest.raises(RuntimeError) as ei:
            m.engine.commit()
        got[pkg.name] = (str(ei.value), m.store.datastore.list_snapshots()
                         == before, m.fs.view.generation,
                         m.fs.read("docs/b.txt")[:4], m.fs.journal.stats(),
                         _progress(m.engine.progress))
    assert got["port"] == got["ref"]
    assert got["port"][:4] == ("commit verification failed for 1 files",
                               True, 0, b"flip")


@pytest.mark.parametrize("pbs", LAYOUTS, ids=LAYOUT_IDS)
def test_reference_snapshot_committed_by_port_reads_in_reference(
        tmp_path, pinned, pbs):
    """A JAX-written snapshot mounted and committed by the port; the
    port's commit read back through the JAX ``SplitReader``, equal to
    what the JAX package's own commit of the same mutations holds."""
    src = _src_tree(tmp_path / "src")
    ref_m = _mount(REF, str(tmp_path / "ref"), src, pbs=pbs)
    port_store = port_bp.LocalStore(str(tmp_path / "ref" / "ds"),
                                    ChunkerParams(**PARAMS), pbs_format=pbs,
                                    dedup_index_mb=1, device="cpu")
    port_m = _mount(PORT, str(tmp_path / "port"), src, pbs=pbs,
                    store=port_store)
    assert str(port_m.first) == str(ref_m.first)
    port_m.fs.write("docs/b.txt", b"PORT", 0)
    port_m.fs.symlink("link", "docs/a.txt")
    new = port_m.engine.commit()
    jax_reader = ref_tr.SplitReader.open_snapshot(ref_m.store.datastore, new)
    got = _read_all(jax_reader)
    assert got == _read_all(port_store.open_snapshot(new))
    assert got["docs/b.txt"][3][:4] == b"PORT"
    assert got["data/big.bin"][3] == _blob(120_000, seed=1)
    assert jax_reader.lookup("link").link_target == "docs/a.txt"
    # the JAX package commits the same mutations onto the same snapshot
    # in a copy: the same snapshot bytes
    other = _mount(REF, str(tmp_path / "ref2"), src, pbs=pbs)
    other.fs.write("docs/b.txt", b"PORT", 0)
    other.fs.symlink("link", "docs/a.txt")
    ref_new = other.engine.commit()
    assert str(ref_new) == str(new)
    assert _read_all(other.store.open_snapshot(ref_new)) == got
    assert _manifest(other.store, ref_new) == _manifest(port_store, new)


def test_oversize_file_verify_hashes_on_host_as_reference(tmp_path, pinned,
                                                          monkeypatch):
    """With ``VERIFY_BATCH_BYTES`` small, a file over it is stream-hashed
    by hashlib and the rest go through the verify pipeline in batches
    (tests/test_commit_edges.py:239)."""
    from pbs_plus_tpu_torch.models import verify as port_verify
    calls = []
    real = port_verify.VerifyPipeline.verify_chunks

    def spy(self, chunks, expected):
        calls.append(sorted(len(c) for c in chunks))
        return real(self, chunks, expected)
    monkeypatch.setattr(port_verify.VerifyPipeline, "verify_chunks", spy)
    src = _src_tree(tmp_path / "src")
    big = _blob(9_000, seed=40)
    got = {}
    for pkg in (REF, PORT):
        m = _mount(pkg, str(tmp_path / pkg.name), src, pbs=False)
        m.engine.VERIFY_BATCH_BYTES = 4 << 10
        m.fs.create("huge.bin")
        m.fs.write("huge.bin", big)
        for i in range(3):
            m.fs.create(f"s{i}.bin")
            m.fs.write(f"s{i}.bin", _blob(1_500 + 700 * i, seed=50 + i))
        ref = m.engine.commit()
        rd = m.store.open_snapshot(ref)
        by = {e.path: e for e in rd.entries()}
        assert hashlib.sha256(rd.read_file(by["huge.bin"])).digest() == \
            by["huge.bin"].digest
        got[pkg.name] = (_progress(m.engine.progress), _manifest(m.store, ref))
    assert got["port"] == got["ref"] and got["port"][0][4] == 4
    # huge.bin never reached the pipeline; the small ones went as one
    # batch, flushed once it held 4 KiB
    assert calls == [[1500, 2200, 2900]]


def test_commit_shares_the_ports_chunk_cache(tmp_path, pinned):
    """The mounted view, the session's previous reader and the swapped-in
    view share the port's ``chunkcache.shared_cache()``; the verify's
    reader is capped at the batch ceiling."""
    src = _src_tree(tmp_path / "src")
    store = port_bp.LocalStore(str(tmp_path / "ds"), ChunkerParams(**PARAMS),
                               dedup_index_mb=1, device="cpu")
    sess = store.start_session(backup_type="host", backup_id="m")
    port_walker.backup_tree(sess, str(src))
    sess.finish()
    shared = port_cache.shared_cache()
    view = port_mount.ArchiveView(store.open_snapshot(sess.ref, cache=shared))
    fs = port_mount.MutableFS(view, port_mount.Journal(
        str(tmp_path / "j" / "j.db")), str(tmp_path / "pass"))
    caps, prev = [], []
    real_start = store.start_session

    def start_session(**kw):
        s = real_start(**kw)
        prev.append(s.previous_reader._cache is shared)
        return s
    store.start_session = start_session

    class Spy(port_mount.CommitEngine):
        def _verify_entries(self, vp, reader, entries):
            caps.append((reader._cache is shared, reader._cache.max_bytes))
            return super()._verify_entries(vp, reader, entries)
    engine = Spy(fs, store, backup_id="m", previous=sess.ref, device="cpu")
    cap = shared.max_bytes
    fs.write("docs/a.txt", b"cached", 0)
    engine.commit()
    assert prev == [True]
    # the verify reads the staged snapshot through its own cache, capped
    # at the batch ceiling while it runs
    assert caps == [(False, engine.VERIFY_BATCH_BYTES)]
    assert shared.max_bytes == cap and fs.view.reader._cache is shared


def _journal_ops(mod, path):
    j = mod.Journal(path)
    n = mod.Node(0, "f", mode=0o600, size=5, content_path="x")
    j.put_node(n)
    j.set_edge(mod.ROOT_ID, "f1", n.id)
    j.add_whiteout(mod.ROOT_ID, "gone")
    j.set_xattr(n.id, "user.k", b"v")
    out = [n.id, n.checksum, j.verify_integrity(), j.stats()]
    j.sync()
    j.close()
    return out


def test_journal_integrity_and_orphan_gc_against_reference(tmp_path):
    """The same operations on both ``Journal``s give the same node ids,
    checksums, integrity reports and stats; each package reopens the
    other's database, finds the same corruption and collects the same
    orphan edges."""
    paths = {p.name: str(tmp_path / p.name / "j.db") for p in (REF, PORT)}
    assert _journal_ops(ref_journal, paths["ref"]) == \
        _journal_ops(port_journal, paths["port"])
    got = {}
    for reader, writer in ((PORT, REF), (REF, PORT)):
        j = reader.journal.Journal(paths[writer.name])
        nid = j.get_edge(reader.journal.ROOT_ID, "f1")
        state = [nid, j.is_whiteout(reader.journal.ROOT_ID, "gone"),
                 j.xattrs(nid)]
        j._conn.execute("UPDATE nodes SET mode=0 WHERE id=?", (nid,))
        j._conn.commit()
        j.set_edge(reader.journal.ROOT_ID, "ghost", 999)
        state += [j.verify_integrity(), j.gc_orphan_edges(),
                  j.verify_integrity()]
        got[reader.name] = state
        j.close()
    assert got["port"] == got["ref"]
    assert any("checksum" in p for p in got["port"][3])
    assert any("orphan" in p for p in got["port"][3])
    assert got["port"][4] == 1
    assert not any("orphan" in p for p in got["port"][5])


def test_overlay_operations_match_reference(tmp_path, pinned):
    """The reference's overlay sequence (tests/test_mount.py) through
    both ``MutableFS``s: every read, listing, attribute and counter
    equal."""
    src = _src_tree(tmp_path / "src")
    got = {}
    for pkg in (REF, PORT):
        fs = _mount(pkg, str(tmp_path / pkg.name), src, pbs=False).fs
        seen = [fs.read("docs/a.txt"), [e.name for e in fs.readdir("")],
                fs.getattr("data/big.bin").size]
        fs.write("docs/a.txt", b"REPLACED", 0)
        fs.mkdir("newdir")
        fs.create("newdir/new.txt")
        fs.write("newdir/new.txt", b"fresh content")
        fs.unlink("docs/b.txt")
        seen += [fs.read("docs/a.txt"), fs.read("newdir/new.txt"),
                 [e.name for e in fs.readdir("docs")]]
        with pytest.raises(FileNotFoundError):
            fs.read("docs/b.txt")
        fs.create("docs/b.txt")
        fs.write("docs/b.txt", b"reborn")
        fs.truncate("docs/a.txt", 4)
        fs.chmod("root.txt", 0o600)
        fs.set_xattr("root.txt", "user.tag", b"x")
        fs.symlink("link", "docs/a.txt")
        fs.rename("data/big.bin", "data/renamed.bin")
        fs.rename("docs", "papers")
        e = fs.getattr("root.txt")
        seen += [fs.read("papers/b.txt"), fs.read("papers/a.txt"),
                 (e.mode, e.size, e.mtime_ns), fs.get_xattrs("root.txt"),
                 fs.readlink("link"), fs.getattr("data/renamed.bin").size,
                 sorted(x.name for x in fs.readdir("")), dict(fs.stats),
                 fs.journal.stats(), fs.journal.verify_integrity()]
        got[pkg.name] = seen
    assert got["port"] == got["ref"]
    assert got["port"][5] == ["a.txt"] and got["port"][6] == b"reborn"


def test_control_socket_commit_as_reference(tmp_path, pinned):
    """``commit_via_socket`` against the port's ``MountControl``: the
    same snapshot and status line as the JAX package's."""
    src = _src_tree(tmp_path / "src")
    got = {}
    for pkg in (REF, PORT):
        m = _mount(pkg, str(tmp_path / pkg.name), src, pbs=False)
        m.fs.create("via-socket.txt")
        m.fs.write("via-socket.txt", b"socket commit")
        sock = str(tmp_path / f"{pkg.name}.sock")

        async def main():
            ctl = pkg.control.MountControl(m.engine, sock)
            await ctl.start()
            snap = await pkg.control.commit_via_socket(sock)
            reader, writer = await asyncio.open_unix_connection(sock)
            writer.write(b"status\n")
            await writer.drain()
            line = (await reader.readline()).decode()
            writer.close()
            await ctl.stop()
            return snap, line
        snap, line = asyncio.run(main())
        rd = m.store.open_snapshot(m.engine.previous)
        got[pkg.name] = (snap, line, rd.read_file(rd.lookup("via-socket.txt")))
    assert got["port"] == got["ref"]
    snap, line, data = got["port"]
    assert snap.startswith("host/m/") and "phase=done" in line
    assert f"snapshot={snap}" in line and data == b"socket commit"


def test_package_exports_match_reference():
    """``mount/__init__.py`` exports what the reference's does and, like
    it, does not import ``fusefs``."""
    import ast
    assert sorted(port_mount.__all__) == sorted(ref_mount.__all__)
    tree = ast.parse(open(port_mount.__file__, encoding="utf-8").read())
    assert sorted(n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)) == \
        ["commit", "journal", "mutablefs", "pxarfs"]
    assert port_mount.CommitEngine.VERIFY_BATCH_BYTES == \
        ref_mount.CommitEngine.VERIFY_BATCH_BYTES == 32 << 20
