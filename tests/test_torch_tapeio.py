"""The port's tape ingestion against the JAX package's.

MTF media, spools, conversions into a store, the cartridge inventory,
the LTO drive and media changer, and the ``mtfprobe`` command: the same
inputs, made from a numpy seed, go through ``pbs_plus_tpu.tapeio`` and
``pbs_plus_tpu_torch.tapeio``.  Conversions run into the JAX
``LocalStore`` (its CPU chunker, hashlib) and the port's
``LocalStore(device="cpu")`` (the plain K1 behind ``CudaChunker``, the
plain SHA-256 behind the ``"cuda"`` batch hasher, the port's
``DedupIndex`` on the CPU), in both layouts, and must leave chunk and
index files byte for byte equal (the index header's random uuid and
time pinned), and manifests equal apart from the creation second and
the chunker backend's label.  Tolerance is exact.

The plain SHA-256 on the CPU steps once per 64-byte block of a batch's
longest chunk, so conversions chunk at a 1 KiB average with 1 KiB at
most, and media stay well under 1 MiB.
"""

import contextlib
import io
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu import cli as ref_cli
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import backupproxy as ref_bp
from pbs_plus_tpu.pxar import pbsstore as ref_pbs
from pbs_plus_tpu.pxar import transfer as ref_tr
from pbs_plus_tpu.tapeio import changer as ref_changer
from pbs_plus_tpu.tapeio import converter as ref_conv
from pbs_plus_tpu.tapeio import feeder as ref_feeder
from pbs_plus_tpu.tapeio import inventory as ref_inv
from pbs_plus_tpu.tapeio import lto as ref_lto
from pbs_plus_tpu.tapeio import mtf as ref_mtf
from pbs_plus_tpu_torch import __main__ as port_cli
from pbs_plus_tpu_torch.chunker.spec import ChunkerParams
from pbs_plus_tpu_torch.pxar import backupproxy as port_bp
from pbs_plus_tpu_torch.pxar import pbsstore as port_pbs
from pbs_plus_tpu_torch.pxar import transfer as port_tr
from pbs_plus_tpu_torch.tapeio import changer as port_changer
from pbs_plus_tpu_torch.tapeio import converter as port_conv
from pbs_plus_tpu_torch.tapeio import feeder as port_feeder
from pbs_plus_tpu_torch.tapeio import inventory as port_inv
from pbs_plus_tpu_torch.tapeio import lto as port_lto
from pbs_plus_tpu_torch.tapeio import mtf as port_mtf

from mock_pbs import MockPBS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", mtf=ref_mtf, feeder=ref_feeder,
                      conv=ref_conv, bp=ref_bp, pbs=ref_pbs, tr=ref_tr,
                      inv=ref_inv, lto=ref_lto, changer=ref_changer,
                      Params=RefParams, kw={})
PORT = SimpleNamespace(name="port", mtf=port_mtf, feeder=port_feeder,
                       conv=port_conv, bp=port_bp, pbs=port_pbs, tr=port_tr,
                       inv=port_inv, lto=port_lto, changer=port_changer,
                       Params=ChunkerParams, kw={"device": "cpu"})
PARAMS = dict(avg_size=1024, min_size=64, max_size=1024)
T0 = 1_753_000_000


def _tree(seed, *, files=6, max_size=40_000):
    """{path: bytes, or None for a directory} over a few levels, one
    empty directory and one empty file."""
    rng = np.random.default_rng(seed)
    tree = {"Users/empty": None}
    for i in range(files):
        n = int(rng.integers(1, max_size))
        path = f"Users/u{i % 2}/d{i % 3}/f{i}.bin"
        tree[path] = rng.integers(0, 256, n, np.uint8).tobytes()
    tree["Windows/system.ini"] = b"[boot]\nshell=explorer.exe\n"
    tree["Windows/zero"] = b""
    return tree


def _dirs(tree):
    """Every directory of ``tree``: the empty ones and every parent."""
    out = {p for p, v in tree.items() if v is None}
    for p in tree:
        parts = p.split("/")[:-1]
        out.update("/".join(parts[:i]) for i in range(1, len(parts) + 1))
    return out


def _media(pkg, tree, **kw) -> bytes:
    buf = io.BytesIO()
    pkg.mtf.write_synthetic_mtf(buf, tree, **kw)
    return buf.getvalue()


def _parse(pkg, data, *, strict=True):
    """(entries as tuples, contents, media and set names) or the error."""
    r = pkg.mtf.MTFReader(io.BytesIO(data), strict=strict)
    got = []
    try:
        for e in r.entries():
            got.append((e.kind, e.path, e.size, e.content_offset,
                        e.attributes,
                        r.read_content(e, 0, e.size) if e.kind == "file"
                        else None))
    except pkg.mtf.MTFError as e:
        return ("MTFError", str(e), got)
    return (got, r.media_name, r.set_name)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_synthetic_media_bytes_equal(seed):
    tree = _tree(seed)
    a = _media(REF, tree, media_name=f"LTO{seed:03d}")
    assert a == _media(PORT, tree, media_name=f"LTO{seed:03d}")
    assert len(a) % port_mtf.BLOCK_ALIGN == 0


@pytest.mark.parametrize("writer", [REF, PORT], ids=["ref-media",
                                                     "port-media"])
def test_readers_parse_each_others_media(writer):
    tree = _tree(4)
    data = _media(writer, tree, media_name="media-42")
    got = _parse(PORT, data)
    assert got == _parse(REF, data)
    entries, media, sset = got
    assert (media, sset) == ("media-42", "set-1")
    files = {p: c for kind, p, _s, _o, _a, c in entries if kind == "file"}
    assert files == {p: c for p, c in tree.items() if c is not None}
    dirs = {p for kind, p, *_ in entries if kind == "dir"}
    assert {"Users", "Users/empty", "Users/u0/d0", "Windows"} <= dirs


def _cut(data, k):
    return data[:len(data) - k]


_BAD = {
    "zeros": lambda d: b"\x00" * 4096,
    "unknown_dblk": lambda d: d[:1024] + b"XXXX" + d[1028:],
    "half": lambda d: d[:len(d) // 2],
    "no_eset": lambda d: _cut(d, 1024),
    "eset_header_cut": lambda d: _cut(d, 1020),
    "cut_800": lambda d: _cut(d, 800),
    "empty": lambda d: b"",
}


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
@pytest.mark.parametrize("case", sorted(_BAD))
def test_garbage_and_truncation_give_equal_results(case, strict):
    data = _BAD[case](_media(REF, _tree(5)))
    got = _parse(PORT, data, strict=strict)
    assert got == _parse(REF, data, strict=strict)
    if case in ("zeros", "unknown_dblk"):
        assert got[0] == "MTFError"
    if case in ("half", "no_eset", "eset_header_cut"):
        assert (got[0] == "MTFError") == strict
    if case == "cut_800":
        # the ESET block's header survives a cut inside its padding, so
        # both readers end the set there and see the whole medium
        assert got[0] != "MTFError"


def _spool_run(pkg, data, *, mem_cap, block, writes):
    sp = pkg.feeder.Spool(mem_cap=mem_cap, block=block)
    cuts = np.linspace(0, len(data), writes + 1).astype(int)

    def produce():
        for a, b in zip(cuts[:-1], cuts[1:]):
            sp.write(data[a:b])
        sp.close()
    t = threading.Thread(target=produce)
    t.start()
    t.join()            # the whole stream is spooled before it is read
    blocks = list(sp.blocks())
    sp.cleanup()
    return blocks, dict(sp.stats)


@pytest.mark.parametrize("mem_cap,block,writes", [
    (64 << 10, 16 << 10, 7), (1 << 20, 4 << 10, 3), (8 << 10, 8 << 10, 1)])
def test_spool_spill_order_and_stats_equal(mem_cap, block, writes):
    data = np.random.default_rng(1).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes()
    got = _spool_run(PORT, data, mem_cap=mem_cap, block=block, writes=writes)
    assert got == _spool_run(REF, data, mem_cap=mem_cap, block=block,
                             writes=writes)
    blocks, stats = got
    assert b"".join(blocks) == data and stats["bytes"] == len(data)
    assert (stats["spilled"] > 0) == (mem_cap < len(data))


def test_spool_reader_and_failure_equal():
    out = {}
    for pkg in (REF, PORT):
        sp = pkg.feeder.Spool()
        sp.write(b"hello world")
        sp.close()
        r = pkg.feeder.SpoolReader(sp)
        reads = [r.read(5), r.read(), r.read()]
        bad = pkg.feeder.Spool()
        bad.write(b"abc")
        bad.fail(OSError("tape read error"))
        rb = pkg.feeder.SpoolReader(bad)
        first = rb.read()
        with pytest.raises(OSError, match="tape read error"):
            rb.read()
        closed = pkg.feeder.Spool()
        closed.close()
        with pytest.raises(ValueError, match="spool closed"):
            closed.write(b"x")
        out[pkg.name] = (reads, first)
    assert out["ref"] == out["port"] == ([b"hello", b" world", b""], b"abc")


def _files(root):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _convert(pkg, base, data, *, pbs, n):
    """Conversion ``n`` of ``data`` into ``pkg``'s LocalStore at ``base``:
    (manifest, result without its seconds)."""
    store = pkg.bp.LocalStore(base, pkg.Params(**PARAMS), pbs_format=pbs,
                              dedup_index_mb=1, **pkg.kw)
    sess = store.start_session(backup_type="host", backup_id="tape",
                               backup_time=T0 + 3600 * n)
    prog = []
    res = pkg.conv.convert_mtf_to_snapshot(io.BytesIO(data), sess,
                                           spool_cap=16 << 10,
                                           progress=prog.append)
    man = sess.finish({"source_media": "LTO042"})
    r = vars(res).copy()
    r.pop("seconds")
    return store, man, r, [(p["files"], p["bytes"]) for p in prog]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both packages' conversions #1 and #2 of one medium per layout."""
    built = {}

    def get(pbs):
        if pbs not in built:
            tree = _tree(9)
            data = _media(REF, tree)
            out = {"tree": tree}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(os, "urandom", lambda n: b"\x5a" * n)
                mp.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)
                for pkg in (REF, PORT):
                    base = str(tmp_path_factory.mktemp(f"{pkg.name}-{pbs}"))
                    runs = [_convert(pkg, base, data, pbs=pbs, n=n)
                            for n in (1, 2)]
                    out[pkg.name] = SimpleNamespace(base=base,
                                                    store=runs[-1][0],
                                                    runs=runs)
            built[pbs] = out
        return built[pbs]
    return get


LAYOUTS = pytest.mark.parametrize("pbs", [False, True], ids=["tpxd", "pbs"])


@LAYOUTS
def test_conversion_files_match_reference(converted, pbs):
    b = converted(pbs)
    ref, port = _files(b["ref"].base), _files(b["port"].base)
    names = ("root.mpxar.didx", "root.ppxar.didx") if pbs \
        else ("root.midx", "root.pidx")
    chunks = [k for k in ref if k.startswith(".chunks")]
    idx = [k for k in ref if os.path.basename(k) in names]
    assert chunks and len(idx) == 2 * len(names)
    assert sorted(k for k in port if k.startswith(".chunks")) == sorted(chunks)
    for k in chunks + idx:
        assert ref[k] == port[k], k


@LAYOUTS
def test_conversion_results_and_manifests_match_reference(converted, pbs):
    b = converted(pbs)
    tree = b["tree"]
    n_files = sum(v is not None for v in tree.values())
    for (_, mr, rr, pr), (_, mp, rp, pp) in zip(b["ref"].runs, b["port"].runs):
        assert rp == rr and pp == pr
        assert rp["files"] == n_files and rp["errors"] == []
        assert rp["bytes"] == sum(len(v) for v in tree.values() if v)
        assert mr.pop("chunker_backend") == "cpu"
        assert mp.pop("chunker_backend") == "cuda"
        mr.pop("created_unix"), mp.pop("created_unix")
        assert mr == mp
        assert mp["source_media"] == "LTO042"
    assert b["port"].runs[0][1]["stats"]["new_chunks"] > 0
    assert b["port"].runs[1][1]["stats"]["new_chunks"] == 0


@LAYOUTS
def test_converted_snapshot_reads_back_with_hashlib_digests(converted, pbs):
    import hashlib
    b = converted(pbs)
    ds = b["port"].store.datastore
    for ref in ds.list_snapshots():
        rd = port_tr.SplitReader.open_snapshot(ds, ref)
        by = {e.path: e for e in rd.entries()}
        for path, content in b["tree"].items():
            if content is None:
                assert by[path].is_dir
            else:
                assert rd.read_file(by[path]) == content
                # pxar v2 entries (the pbs layout) carry no file digest
                assert by[path].digest == (
                    b"" if pbs else hashlib.sha256(content).digest())


def test_truncated_conversion_errors_equal(tmp_path):
    """Media without an ESET block convert every file they hold, end in
    the ESET error, and publish nothing once the caller aborts."""
    data = _cut(_media(REF, _tree(11)), 1024)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "urandom", lambda n: b"\x5a" * n)
        for pkg in (REF, PORT):
            store = pkg.bp.LocalStore(str(tmp_path / pkg.name),
                                      pkg.Params(**PARAMS), dedup_index_mb=1,
                                      **pkg.kw)
            sess = store.start_session(backup_type="host", backup_id="trunc",
                                       backup_time=T0)
            res = pkg.conv.convert_mtf_to_snapshot(io.BytesIO(data), sess)
            sess.abort()
            r = vars(res).copy()
            r.pop("seconds")
            out[pkg.name] = (r, store.datastore.list_snapshots())
    assert out["port"] == out["ref"]
    r, snaps = out["port"]
    assert r["errors"] and "ESET" in r["errors"][-1] and snaps == []


class _Clock:
    """``time`` for the PBS stores' module: each ``time()`` one second
    after the last, from T0, the rest real."""

    def __init__(self):
        self.t = T0 - 1

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        self.t += 1
        return float(self.t)


def test_conversion_into_pbs_store_over_mock_matches_reference(
        tmp_path, monkeypatch):
    """MTF media → converter → PBS upload (the mock) → cartridge
    inventory, through each package: the mocks' payload and meta
    streams are equal, and the payload is the files' bytes in DFS
    order behind pxar v2 headers."""
    from pbs_plus_tpu_torch.pxar.datastore import Datastore
    from pbs_plus_tpu_torch.pxar.pxarv2 import (payload_header,
                                                payload_start_marker)
    tree = {"acme": None, "acme/db.bak": b"D" * 40_000,
            "acme/logs": None, "acme/logs/app.log": b"log line\n" * 500}
    media = tmp_path / "LTO007.bkf"
    media.write_bytes(_media(PORT, tree))
    monkeypatch.setattr(time, "time_ns", lambda: T0 * 10**9 + 123)
    out = {}
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.pbs, "time", _Clock())
        pbs = MockPBS()
        try:
            store = pkg.pbs.PBSStore(
                pkg.pbs.PBSConfig(base_url=pbs.base_url, datastore="tank",
                                  auth_token=pbs.token),
                pkg.Params(**PARAMS), **pkg.kw)
            sess = store.start_session(backup_type="host",
                                       backup_id="tape-acme",
                                       backup_time=T0)
            with open(media, "rb") as f:
                res = pkg.conv.convert_mtf_to_snapshot(f, sess)
            sess.finish({"source_media": "LTO007"})
            (ref,) = pbs.snapshots
            streams = [pbs.read_stream(ref, n) for n in
                       (Datastore.META_IDX_PBS, Datastore.PAYLOAD_IDX_PBS)]
            inv = pkg.inv.CartridgeInventory(str(tmp_path / f"{pkg.name}.db"))
            inv.record_dataset("LTO007", "acme", file_mark=0, snapshot=ref,
                               bytes_=len(streams[1]))
            hit = inv.find_dataset("acme")
            left = inv.unconverted()
            inv.close()
            out[pkg.name] = (ref, streams, (res.files, res.entries,
                                            res.bytes, res.errors),
                             [(h["volume_tag"], h["snapshot"], h["bytes"])
                              for h in hit], left)
        finally:
            pbs.close()
    assert out["port"] == out["ref"]
    ref, (_meta, payload), counts, hits, left = out["port"]
    a, b = tree["acme/db.bak"], tree["acme/logs/app.log"]
    assert payload == (payload_start_marker() + payload_header(len(a)) + a
                       + payload_header(len(b)) + b)
    assert counts[:2] == (2, 5) and hits == [("LTO007", ref, len(payload))]
    assert left == []


def test_cartridge_inventory_rows_equal(tmp_path, monkeypatch):
    status = _CHANGER_STATUS
    out = {}
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.inv, "time", _Clock())
        inv = pkg.inv.CartridgeInventory(str(tmp_path / pkg.name / "t.db"))
        ch = pkg.changer.MediaChanger(transport=lambda a: status)
        seen = inv.sync_from_changer(ch.inventory())
        inv.upsert_cartridge("TAPE001", pool="weekly", notes="first")
        inv.upsert_cartridge("TAPE001", location="vault", write_protected=True)
        inv.set_location("TAPE002", "offsite")
        inv.record_dataset("TAPE001", "acme", file_mark=2, bytes_=10,
                           meta={"k": 1})
        inv.record_dataset("TAPE001", "beta", file_mark=1)
        inv.record_dataset("TAPE001", "acme", snapshot="host/acme/x")
        inv.record_dataset("LTO009", "gamma", file_mark=0)
        rows = (seen, inv.get_cartridge("TAPE001"), inv.get_cartridge("NOPE"),
                inv.list_cartridges(), inv.list_cartridges(pool="weekly"),
                inv.datasets_on("TAPE001"), inv.find_dataset("acme"),
                inv.unconverted(), list(inv._conn.iterdump()))
        inv.close()
        out[pkg.name] = rows
    assert out["port"] == out["ref"]
    assert out["port"][0] == 3 and len(out["port"][7]) == 2


_CHANGER_STATUS = """\
  Storage Changer /dev/sg2:1 Drives, 4 Slots ( 1 Import/Export )
Data Transfer Element 0:Full (Storage Element 3 Loaded):VolumeTag = TAPE003
      Storage Element 1:Full :VolumeTag=TAPE001
      Storage Element 2:Full :VolumeTag=TAPE002
      Storage Element 3:Empty
      Storage Element 4 IMPORT/EXPORT:Empty"""

_MT_STATUS = """\
SCSI 2 tape drive:
File number=3, block number=17, partition=0.
Tape block size 0 bytes. Density code 0x5a (LTO-7).
Soft error count since last status=0
General status bits on (41010000):
 BOT ONLINE IM_REP_EN WR_PROT"""


class _Script:
    """One scripted transport: records every command, answers status
    queries, and raises where told."""

    def __init__(self, answers=None, fail=()):
        self.calls = []
        self.answers = answers or {}
        self.fail = fail

    def __call__(self, args):
        self.calls.append(list(args))
        if args and args[0] in self.fail:
            raise self.error(f"{args[0]} failed")
        return self.answers.get(args[0], "")


def _drive_and_changer(pkg, tmp):
    script = _Script({"status": _MT_STATUS})
    script.error = pkg.lto.DriveError
    d = pkg.lto.TapeDrive("/dev/nst0", transport=script)
    d.seek_file(0)
    d.seek_file(4)
    d.erase_quick()
    st = vars(d.status())
    d.eject()
    blank = pkg.lto.TapeDrive(transport=_Script({"status": "DR_OPEN"}))
    st2 = vars(blank.status())
    bad = _Script(fail=("rewind",))
    bad.error = pkg.lto.DriveError
    with pytest.raises(pkg.lto.DriveError, match="rewind failed"):
        pkg.lto.TapeDrive(transport=bad).seek_file(2)
    lock = pkg.lto.DriveLock("drive0", lock_dir=str(tmp / pkg.name))
    other = pkg.lto.DriveLock("drive0", lock_dir=str(tmp / pkg.name))
    locks = [lock.acquire(), other.acquire()]
    lock.release()
    locks.append(other.acquire())
    other.release()
    with lock:
        locks.append(open(lock.path).read() == str(os.getpid()))
    cs = _Script({"status": _CHANGER_STATUS})
    cs.error = pkg.changer.ChangerError
    ch = pkg.changer.MediaChanger(transport=cs)
    inv = ch.inventory()
    ch.load_by_tag("TAPE002")
    ch.load(1, 0)
    ch.unload(3, 0)
    with pytest.raises(pkg.changer.ChangerError):
        ch.load_by_tag("NOPE")
    return (script.calls, st, st2, bad.calls, locks, cs.calls,
            [vars(s) for s in inv.drives], [vars(s) for s in inv.slots],
            vars(inv.find_tag("TAPE003")))


def test_drive_lock_and_changer_under_one_script_equal(tmp_path):
    got = _drive_and_changer(PORT, tmp_path)
    assert got == _drive_and_changer(REF, tmp_path)
    calls, st, st2 = got[:3]
    assert calls[:3] == [["rewind"], ["rewind"], ["fsf", "4"]]
    assert (st["file_number"], st["block_number"], st["write_protected"],
            st["density"]) == (3, 17, True, "0x5a")
    assert st2["online"] is False and got[4] == [True, False, True, True]
    assert got[8]["kind"] == "drive"


def _probe_media(tmp):
    tree = _tree(13)
    data = _media(REF, tree)
    paths = {}
    for name, blob in (("intact", data), ("cut_800", _cut(data, 800)),
                       ("no_eset", _cut(data, 1024))):
        p = tmp / f"{name}.bkf"
        p.write_bytes(blob)
        paths[name] = str(p)
    return tree, paths


PROBES = [("intact", []), ("intact", ["-v"]), ("cut_800", []),
          ("cut_800", ["--lenient"]), ("no_eset", []),
          ("no_eset", ["--lenient"]), ("no_eset", ["-v", "--lenient"])]


@pytest.mark.parametrize("media,flags", PROBES,
                         ids=["-".join([m] + f) for m, f in PROBES])
def test_mtfprobe_output_and_exit_code_equal(tmp_path, capsys, media, flags):
    tree, paths = _probe_media(tmp_path)
    argv = ["mtfprobe", paths[media], *flags]
    rc_ref = ref_cli.main(argv)
    out_ref = capsys.readouterr().out
    rc_port = port_cli.main(argv)
    out_port = capsys.readouterr().out
    assert (rc_port, out_port) == (rc_ref, out_ref)
    strict_fail = media == "no_eset" and "--lenient" not in flags
    assert rc_port == (1 if strict_fail else 0)
    if not strict_fail:
        files = [v for v in tree.values() if v is not None]
        assert out_port.splitlines()[-1] == (
            f"{paths[media]}: {len(_dirs(tree))} dirs, {len(files)} files, "
            f"{sum(map(len, files))} content bytes")


def test_mtfprobe_runs_as_the_port_command(tmp_path):
    """``python -m pbs_plus_tpu_torch mtfprobe`` as a process: strict
    media without ESET exit 1 with the JAX command's line."""
    _tree_, paths = _probe_media(tmp_path)
    r = subprocess.run([sys.executable, "-m", "pbs_plus_tpu_torch",
                        "mtfprobe", paths["no_eset"]],
                       capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ref_cli.main(["mtfprobe", paths["no_eset"]])
    assert (r.returncode, r.stdout) == (rc, buf.getvalue())
    assert rc == 1 and r.stdout.startswith(
        "MTF error: media ended without ESET")
