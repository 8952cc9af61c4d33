"""The port's PBS wire store against the JAX package's.

The port's ``PBSStore(device="cpu")`` (the plain K1 behind its chunker,
the plain SHA-256 behind its batch hasher) and the JAX ``PBSStore`` (its
CPU chunker, hashlib) back up the same trees into two in-process mock PBS
servers (tests/mock_pbs.py), once over HTTP/1.1 and once through the
mock's ``H2UpgradeBridge`` (the 101 upgrade, then HTTP/2 over
libnghttp2).  The servers' stored chunks and index records must be
equal, and the manifest blobs equal apart from the chunker backend's
label.  A mount commits into the mock through each package's
``CommitEngine``: the store has no readable pre-publish staging, so the
verify runs after the publish, and a failing verify deletes the
published snapshot, as the reference's does.  Tolerance is exact.
"""

import json
import os
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu import mount as ref_mount
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import pbsstore as ref_pbs
from pbs_plus_tpu.pxar import walker as ref_walker
from pbs_plus_tpu.pxar.pbsformat import blob_decode
from pbs_plus_tpu_torch import mount as port_mount
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.models.dedup import CudaChunker
from pbs_plus_tpu_torch.pxar import pbsstore as port_pbs
from pbs_plus_tpu_torch.pxar import walker as port_walker
from pbs_plus_tpu_torch.utils import h2lib as port_h2lib

from mock_pbs import H2UpgradeBridge, MockPBS

REF = SimpleNamespace(name="ref", pbs=ref_pbs, mount=ref_mount,
                      walker=ref_walker, Params=RefParams, kw={})
PORT = SimpleNamespace(name="port", pbs=port_pbs, mount=port_mount,
                       walker=port_walker, Params=ChunkerParams,
                       kw={"device": "cpu"})
PARAMS = dict(avg_size=4096, min_size=1024, max_size=4096)
T0 = 1_753_750_000
WIRES = ["h1", "h2"]


class _Clock:
    """``time`` for the stores' module: each ``time()`` one second after
    the last, from T0, the rest real; both packages call it alike."""

    def __init__(self):
        self.t = T0 - 1

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        self.t += 1
        return float(self.t)


def _close(server):
    if isinstance(server, H2UpgradeBridge):
        # wake the bridge's blocking accept so that its loop sees the stop
        server._stop.set()
        socket.create_connection(("127.0.0.1", server.port)).close()
    server.close()


@pytest.fixture
def servers(monkeypatch):
    """A mock PBS per package, fronted by the h2 bridge when asked for;
    each package's store module on its own clock, the journal's mtimes
    pinned."""
    made = []
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.pbs, "time", _Clock())
    monkeypatch.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)

    def make(wire):
        mock = MockPBS()
        made.append(mock)
        if wire == "h1":
            return mock, mock.base_url, None
        bridge = H2UpgradeBridge(mock)
        made.append(bridge)
        return mock, bridge.base_url, bridge
    yield make
    for m in reversed(made):
        _close(m)


def _store(pkg, url, mock):
    return pkg.pbs.PBSStore(pkg.pbs.PBSConfig(
        base_url=url, datastore="tank", auth_token=mock.token),
        pkg.Params(**PARAMS), **pkg.kw)


def _blob(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def _tree(root, files):
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    for dp, dn, fn in os.walk(root):
        for n in dn + fn:
            os.utime(os.path.join(dp, n), ns=(T0 * 10**9, T0 * 10**9))
    os.utime(root, ns=(T0 * 10**9, T0 * 10**9))
    return root


def _state(mock):
    """What the server holds: chunks, each snapshot's index records and
    its manifest blob (decoded, the chunker backend's label dropped)."""
    snaps = {}
    for ref, snap in mock.snapshots.items():
        blob = json.loads(blob_decode(snap["blobs"]["index.json.blob"]))
        blob["unprotected"]["tpu-plus"].pop("chunker_backend")
        snaps[ref] = (snap["indexes"], blob)
    return dict(mock.chunks), snaps


FILES = {"etc/a.conf": b"alpha " * 700,
         "etc/b.conf": _blob(3_000, 2),
         "var/big.bin": _blob(60_000, 3),
         "var/empty": b""}


@pytest.mark.parametrize("wire", WIRES)
def test_backups_store_what_the_reference_stores(tmp_path, servers, wire):
    """Backup #1 of a tree, then #2 with one file changed: the rest is
    known from the previous snapshot's indexes and not uploaded again."""
    src = _tree(tmp_path / "src", FILES)
    got = {}
    for pkg in (REF, PORT):
        mock, url, bridge = servers(wire)
        store = _store(pkg, url, mock)
        s1 = store.start_session(backup_type="host", backup_id="pb")
        pkg.walker.backup_tree(s1, str(src))
        m1 = s1.finish()
        (src / "etc" / "b.conf").write_bytes(_blob(3_000, 4))
        os.utime(src / "etc" / "b.conf", ns=(T0 * 10**9, T0 * 10**9))
        s2 = store.start_session(backup_type="host", backup_id="pb")
        assert s2.previous_reader is not None
        pkg.walker.backup_tree(s2, str(src))
        m2 = s2.finish()
        (src / "etc" / "b.conf").write_bytes(FILES["etc/b.conf"])
        os.utime(src / "etc" / "b.conf", ns=(T0 * 10**9, T0 * 10**9))
        for m in (m1, m2):
            m.pop("chunker_backend")
        got[pkg.name] = (_state(mock), m1, m2, s2.sink.uploaded_chunks,
                         bridge.upgrades if bridge else 0)
    assert got["port"] == got["ref"]
    (chunks, snaps), m1, m2, uploaded, upgrades = got["port"]
    assert len(snaps) == 2 and len(chunks) > 10
    assert m2["stats"]["known_chunks"] > 0 and 0 < uploaded < len(chunks) // 2
    assert upgrades == (2 if wire == "h2" else 0)    # one per session


@pytest.mark.parametrize("wire", WIRES)
def test_mount_commit_against_the_mock(tmp_path, servers, wire):
    """The reference's mount commit against a PBS target
    (tests/test_pbsstore.py), by both packages: unchanged files splice
    by reference, the verify runs after the publish, the view swaps onto
    a reader session over the published snapshot."""
    src = _tree(tmp_path / "src", {"docs/a.txt": b"alpha " * 1000,
                                   "big.bin": _blob(40_000, 11)})
    got = {}
    for pkg in (REF, PORT):
        mock, url, _ = servers(wire)
        store = _store(pkg, url, mock)
        s0 = store.start_session(backup_type="host", backup_id="mc")
        pkg.walker.backup_tree(s0, str(src))
        s0.finish()
        fs = pkg.mount.MutableFS(
            pkg.mount.ArchiveView(store.open_snapshot(s0.ref)),
            pkg.mount.Journal(str(tmp_path / pkg.name / "j.db")),
            str(tmp_path / pkg.name / "pass"))
        engine = pkg.mount.CommitEngine(fs, store, backup_id="mc",
                                        previous=s0.ref, **pkg.kw)
        fs.write("docs/a.txt", b"EDITED! ", 0)
        fs.create("new.txt")
        fs.write("new.txt", b"fresh")
        ref = engine.commit()
        p = engine.progress
        reads = (fs.read("docs/a.txt")[:8], fs.read("big.bin"),
                 fs.read("new.txt"))
        fs.view.hot_swap(store.open_snapshot(ref))
        got[pkg.name] = (str(ref), _state(mock), reads, p.ref_files,
                         p.changed_files, p.verified)
    assert got["port"] == got["ref"]
    ref, (chunks, snaps), reads, ref_files, changed, verified = got["port"]
    assert len(snaps) == 2 and ref in snaps
    assert reads == (b"EDITED! ", _blob(40_000, 11), b"fresh")
    assert ref_files >= 1 and changed == 2 and verified == 2


def _flip_one_digest(base):
    class FlippingEngine(base):
        def _verify_entries(self, vp, reader, entries):
            e = entries[0]
            e.digest = bytes([e.digest[0] ^ 1]) + e.digest[1:]
            return super()._verify_entries(vp, reader, entries)
    return FlippingEngine


def test_failing_post_publish_verify_deletes_the_snapshot(tmp_path, servers):
    """K2's (here the plain SHA-256's) verdict on a flipped expected
    digest fails the post-publish verify: the published snapshot is
    deleted through the management API and the mount keeps its old view
    and journal, as with the JAX package."""
    src = _tree(tmp_path / "src", {"a.txt": b"alpha " * 500,
                                   "b.bin": _blob(9_000, 5)})
    got = {}
    for pkg in (REF, PORT):
        mock, url, _ = servers("h1")
        store = _store(pkg, url, mock)
        s0 = store.start_session(backup_type="host", backup_id="bad")
        pkg.walker.backup_tree(s0, str(src))
        s0.finish()
        fs = pkg.mount.MutableFS(
            pkg.mount.ArchiveView(store.open_snapshot(s0.ref)),
            pkg.mount.Journal(str(tmp_path / pkg.name / "j.db")),
            str(tmp_path / pkg.name / "pass"))
        engine = _flip_one_digest(pkg.mount.CommitEngine)(
            fs, store, backup_id="bad", previous=s0.ref, **pkg.kw)
        fs.write("a.txt", b"ALPHA", 0)
        with pytest.raises(RuntimeError) as ei:
            engine.commit()
        got[pkg.name] = (str(ei.value), sorted(mock.snapshots),
                         fs.view.generation, fs.read("a.txt")[:5],
                         fs.journal.stats(), engine.progress.phase,
                         [r for r in mock.request_log if "DELETE" in r])
    assert got["port"] == got["ref"]
    err, snaps, gen, data, journal, phase, deletes = got["port"]
    assert err == "commit verification failed for 1 files"
    assert snaps == [str(s0.ref)] and gen == 0 and data == b"ALPHA"
    assert journal["edges"] > 0 and phase == "verify" and len(deletes) == 1


def test_port_h2_server_session_serves_the_port_client(tmp_path, servers):
    """The bridge's HTTP/2 server side swapped for the port's
    ``H2ServerSession``: the port's client backs up and reads back
    through it."""
    src = _tree(tmp_path / "src", {"f.bin": _blob(20_000, 7)})
    mock, url, bridge = servers("h2")
    bridge._H2ServerSession = port_h2lib.H2ServerSession
    store = _store(PORT, url, mock)
    s = store.start_session(backup_type="host", backup_id="h2p")
    assert s._http._h2 is not None
    port_walker.backup_tree(s, str(src))
    s.finish()
    r = store.open_snapshot(s.ref)
    assert r.read_file(r.lookup("f.bin")) == _blob(20_000, 7)
    assert bridge.upgrades >= 2 and port_h2lib.available()


def test_pbs_store_builds_the_cuda_write_path_on_its_device():
    store = port_pbs.PBSStore(port_pbs.PBSConfig(
        base_url="http://127.0.0.1:9", datastore="tank", auth_token="t"),
        ChunkerParams(**PARAMS), device="cpu")
    assert str(store.device) == "cpu"
    assert isinstance(store._chunker_factory(store.params), CudaChunker)
    assert store.batch_hasher([b"abc"]) == \
        [bytes.fromhex("ba7816bf8f01cfea414140de5dae2223"
                       "b00361a396177a9cb410ff61f20015ad")]
    assert port_pbs.index_csum([(5, b"\x01" * 32)]) == \
        ref_pbs.index_csum([(5, b"\x01" * 32)])
