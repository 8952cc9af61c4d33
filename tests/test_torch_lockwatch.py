"""The port's runtime lock-order witness, ``safemap`` and ``memlimit``
against the JAX package's.

The scenarios of ``tests/test_lockwatch.py`` run through each package's
``lockwatch`` and must record equal edges and cycles (allocation-site
names compared with the package directory normalised); the port's site
names start with ``pbs_plus_tpu_torch/``, where the reference's marker
would have left an absolute path.  The port's ``ChunkStore`` insert and
sweep and a small tape conversion run under ``watching()`` and are
acyclic.  Only ``watching()`` is used, so nothing stays patched.
``memlimit.apply_rlimit`` runs in a child process only: it clamps the
address space.  Tolerance is exact.
"""

import io
import json
import os
import re
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.utils import lockwatch as ref_lw
from pbs_plus_tpu.utils import memlimit as ref_mem
from pbs_plus_tpu.utils import safemap as ref_safemap
from pbs_plus_tpu_torch.utils import lockwatch as port_lw
from pbs_plus_tpu_torch.utils import memlimit as port_mem
from pbs_plus_tpu_torch.utils import safemap as port_safemap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", lw=ref_lw, safemap=ref_safemap)
PORT = SimpleNamespace(name="port", lw=port_lw, safemap=port_safemap)


def _nested(lw):
    w = lw.LockWatch()
    a, b = lw.wrap(threading.Lock(), "A", w), lw.wrap(threading.Lock(), "B", w)
    with a:
        with b:
            pass
    return w


def _opposite(lw):
    w = _nested(lw)
    a, b = lw.wrap(threading.Lock(), "A", w), lw.wrap(threading.Lock(), "B", w)
    with b:
        with a:
            pass
    return w


def _rlock(lw):
    w = lw.LockWatch()
    r = lw.wrap(threading.RLock(), "R", w, reentrant=True)
    b = lw.wrap(threading.Lock(), "B", w)
    with r:
        with r:
            pass
    with r:
        with b:
            with r:
                pass
    return w


def _out_of_order(lw):
    w = lw.LockWatch()
    a, b = lw.wrap(threading.Lock(), "A", w), lw.wrap(threading.Lock(), "B", w)
    c = lw.wrap(threading.Lock(), "C", w)
    a.acquire()
    b.acquire()
    a.release()
    with c:
        pass
    b.release()
    return w


def _threads(lw):
    w = lw.LockWatch()
    a, b = lw.wrap(threading.Lock(), "A", w), lw.wrap(threading.Lock(), "B", w)

    def other():
        with b:
            with a:
                pass
    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join()
    with a:
        with b:
            pass
    return w


def _three_cycle(lw):
    w = lw.LockWatch()
    ls = {n: lw.wrap(threading.Lock(), n, w) for n in "XYZ"}
    for p, q in (("X", "Y"), ("Y", "Z"), ("Z", "X"), ("X", "Z")):
        with ls[p]:
            with ls[q]:
                pass
    return w


def _installed(lw):
    with lw.watching() as w:
        lk = threading.Lock()
        inner = lw.wrap(threading.RLock(), "X", w, reentrant=True)
        with lk:
            with inner:
                pass
        cv = threading.Condition()
        fired = []

        def waiter():
            with cv:
                cv.wait(timeout=5)
                fired.append(True)
        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        t.join(timeout=5)
        with lw.watching() as again:
            assert again is w
        assert isinstance(threading.Lock(), lw._WatchedLock)
    assert threading.Lock is lw._REAL_LOCK and fired == [True]
    return w


SCENARIOS = {f.__name__.strip("_"): f for f in
             (_nested, _opposite, _rlock, _out_of_order, _threads,
              _three_cycle, _installed)}


def _norm_edges(edges):
    return {tuple(re.sub(r"\d+$", "N", n) for n in e): c
            for e, c in edges.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_record_equal_edges(name):
    got = {}
    for pkg in (REF, PORT):
        w = SCENARIOS[name](pkg.lw)
        got[pkg.name] = (w.edges(), w.find_cycle())
    # the two scenario runs allocate their locks on the same lines of
    # this file, so even installed site names agree
    assert got["port"] == got["ref"]
    if name in ("opposite", "threads", "three_cycle"):
        assert got["port"][1] is not None
        with pytest.raises(AssertionError, match="lock-order cycle"):
            SCENARIOS[name](port_lw).assert_acyclic()
    else:
        assert got["port"][1] is None


def test_install_nesting_and_conflict_equal():
    for lw in (ref_lw, port_lw):
        try:
            w1 = lw.install()
            assert lw.install() is w1
            lw.uninstall()
            assert threading.Lock is not lw._REAL_LOCK
            with pytest.raises(RuntimeError, match="different watch"):
                lw.install(lw.LockWatch())
        finally:
            lw.uninstall()
        assert threading.Lock is lw._REAL_LOCK
        lw.uninstall()
        assert threading.Lock is lw._REAL_LOCK


def test_enabled_env_parse_equal(monkeypatch):
    for v in (None, "1", "true", "YES", "0", "no", ""):
        if v is None:
            monkeypatch.delenv("PBS_PLUS_LOCKWATCH", raising=False)
        else:
            monkeypatch.setenv("PBS_PLUS_LOCKWATCH", v)
        assert port_lw.enabled() == ref_lw.enabled()
    assert port_lw.ENV_VAR == ref_lw.ENV_VAR


def _safemap_edges(pkg):
    """A package's SafeMap used under its own lockwatch: the RLock's
    allocation site, with the package directory as its prefix."""
    with pkg.lw.watching() as w:
        m = pkg.safemap.SafeMap()
        outer = threading.Lock()
        with outer:
            m.set("k", 1)
            m.get_or_set("j", lambda: 2)
    return w.edges()


def test_site_names_name_each_package():
    ref, port = _safemap_edges(REF), _safemap_edges(PORT)
    ((a, b),) = port
    assert a.startswith("tests/test_torch_lockwatch.py:")
    assert b.startswith("pbs_plus_tpu_torch/utils/safemap.py:")
    # the port's copy carries a longer docstring: compare files, not lines
    assert _norm_edges({(x, y.replace("pbs_plus_tpu/", "pbs_plus_tpu_torch/"))
                        : c for (x, y), c in ref.items()}) == _norm_edges(port)
    assert not any(os.path.isabs(n) for e in port for n in e)


def test_port_chunk_store_and_tape_conversion_acyclic(tmp_path):
    from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
    from pbs_plus_tpu_torch.pxar.backupproxy import LocalStore
    from pbs_plus_tpu_torch.pxar.chunkindex import DedupIndex
    from pbs_plus_tpu_torch.pxar.datastore import ChunkStore
    from pbs_plus_tpu_torch.tapeio import (convert_mtf_to_snapshot,
                                           write_synthetic_mtf)
    import hashlib
    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, int(n), np.uint8).tobytes()
             for n in rng.integers(100, 5000, 24)]
    with port_lw.watching() as w:
        cs = ChunkStore(str(tmp_path / "cs"), device="cpu",
                        index=DedupIndex(budget_mb=1, device="cpu"))
        digs = [hashlib.sha256(b).digest() for b in blobs]
        threads = [threading.Thread(target=lambda i=i: [
            cs.insert(d, b) for d, b in list(zip(digs, blobs))[i::4]])
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cs.touch_many(digs[:12])
        removed = cs.sweep(time.time() + 3600)
        buf = io.BytesIO()
        write_synthetic_mtf(buf, {"a": None, "a/b.bin": blobs[0] * 8,
                                  "c.bin": blobs[1]})
        buf.seek(0)
        store = LocalStore(str(tmp_path / "ls"),
                           ChunkerParams(avg_size=1024, min_size=64,
                                         max_size=1024),
                           dedup_index_mb=1, device="cpu")
        sess = store.start_session(backup_type="host", backup_id="tape")
        res = convert_mtf_to_snapshot(buf, sess, spool_cap=4 << 10)
        sess.finish()
    assert removed[0] == 24 and res.files == 2 and not res.errors
    sites = {n for e in w.edges() for n in e}
    ours = [n for n in sites if "pbs_plus_tpu_torch" in n]
    assert ours and all(n.startswith("pbs_plus_tpu_torch/") for n in ours)
    w.assert_acyclic()


def test_safemap_equal():
    out = {}
    for pkg in (REF, PORT):
        m = pkg.safemap.SafeMap()
        log = [m.get("a"), m.get("a", 0)]
        m.set("a", 1)
        log += [m.get_or_set("a", lambda: 9), m.get_or_set("b", lambda: 2),
                m.compute("a", lambda v: v + 10), m.compute("b", lambda v: None),
                m.compute("c", lambda v: 5), m.delete("c"), m.delete("zz"),
                len(m), "a" in m, "b" in m, m.items(), m.keys(), list(m)]
        out[pkg.name] = log
    assert out["port"] == out["ref"]


def test_memlimit_effective_limit_equal(monkeypatch):
    for f in (0.9, 0.5, 1.0, 0.25):
        assert port_mem.effective_limit(f) == ref_mem.effective_limit(f)
    assert port_mem._cgroup_limit() == ref_mem._cgroup_limit()
    assert port_mem._system_total() == ref_mem._system_total()
    for cg in (None, 1 << 30, 1 << 50):
        for pkg in (ref_mem, port_mem):
            monkeypatch.setattr(pkg, "_cgroup_limit", lambda cg=cg: cg)
        assert port_mem.effective_limit() == ref_mem.effective_limit()


_CHILD = r"""
import json, resource, sys
sys.path.insert(0, sys.argv[1])
if sys.argv[2] == "port":
    from pbs_plus_tpu_torch.utils import memlimit
else:
    from pbs_plus_tpu.utils import memlimit
limit = memlimit.apply_rlimit(0.9)
print(json.dumps([limit, resource.getrlimit(resource.RLIMIT_AS)[0]]))
"""


def test_apply_rlimit_in_child_processes_equal():
    """Both packages clamp RLIMIT_AS to the same limit, each in a child
    that touches no card (the clamp would fail CUDA's reservations)."""
    got = []
    for name in ("ref", "port"):
        r = subprocess.run([sys.executable, "-c", _CHILD, REPO, name],
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr
        got.append(json.loads(r.stdout.split("\n")[-2]))
    assert got[0] == got[1]
    assert got[1][0] == port_mem.effective_limit(0.9)
