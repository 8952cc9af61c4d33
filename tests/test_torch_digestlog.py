"""The port's DigestLog against the JAX package's, on the CPU.

The same seeded operations go through both logs, each in its own
directory; the segment files and the manifests must be byte-identical, a
segment exported by either package must be adopted by the other, and a
compaction killed at the port's own failpoint must leave the old segments
authoritative.  Tolerance is exact.
"""

import os

import numpy as np

from pbs_plus_tpu.pxar import digestlog as ref_log
from pbs_plus_tpu.utils import failpoints as ref_failpoints
from pbs_plus_tpu_torch.pxar import digestlog as port_log
from pbs_plus_tpu_torch.utils import failpoints, fswitness, trace


def _digests(n, seed):
    arr = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [arr[i].tobytes() for i in range(n)]


def _files(root):
    return {n: open(os.path.join(root, n), "rb").read()
            for n in sorted(os.listdir(root))}


def _drive(log, digs, gone, blobs):
    """Spill three times, tombstone across segments, flag DataBlobs, and
    compact: the same calls in the same order for either package."""
    for i in range(0, 24_000, 6_000):
        log.add_many(digs[i:i + 6_000])
        log.drain()
    for d in gone:
        log.discard(d)
    for d in blobs:
        log.set_flags(d, ref_log.FLAG_DATABLOB)
    log.add_many(digs[24_000:])
    log.flush()
    log.compact(wait=True)
    log.drain()


def test_segments_and_manifest_byte_identical(tmp_path):
    digs = _digests(30_000, seed=1)
    gone, blobs = digs[100:400], digs[20_000:20_050]
    ref = ref_log.DigestLog(str(tmp_path / "ref"), budget_bytes=1 << 20)
    port = port_log.DigestLog(str(tmp_path / "port"), budget_bytes=1 << 20)
    with fswitness.watching() as w:
        _drive(ref, digs, gone, blobs)
        _drive(port, digs, gone, blobs)
    w.assert_clean()
    # the port's tombstones reach the port's witness, in order
    assert w.saw("digestlog.tombstone")
    assert port.segment_count >= 2
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert port.manifest_bytes() == ref.manifest_bytes()
    assert port.live_count == ref.live_count == 30_000 - len(gone)
    assert list(port.iter_live()) == list(ref.iter_live())
    probe = digs[::97] + _digests(50, seed=2)
    assert port.flags_many(probe) == ref.flags_many(probe)
    assert port.contains_many(probe) == ref.contains_many(probe)
    # confirm reads feed the port's trace histogram
    assert trace.histograms()["pbs_plus_digestlog_confirm_read_seconds"][
        "count"] > 0

    # each package's manifest boots the other's segment directory
    for src, dst_mod in ((ref, port_log), (port, ref_log)):
        other = dst_mod.DigestLog(src.root, budget_bytes=1 << 20)
        ok, used = other.load_manifest_bytes(src.manifest_bytes())
        assert ok and used == len(src.manifest_bytes())
        assert other.live_count == src.live_count
        assert other.flags_many(probe) == src.flags_many(probe)


def test_adopt_segment_across_packages(tmp_path):
    digs = _digests(9_000, seed=3)
    keep_half = lambda a: (a[:, 0] & 1) == 0           # noqa: E731
    for src_mod, dst_mod in ((ref_log, port_log), (port_log, ref_log)):
        tag = src_mod.__name__.split(".")[0]
        src = src_mod.DigestLog(str(tmp_path / f"src-{tag}"))
        src.add_many(digs)
        src.discard(digs[0])
        segs = src.export_segments()
        assert len(segs) == 1
        name, trailer_hex, count = segs[0]
        raw = src.export_segment_bytes(name)
        dst = dst_mod.DigestLog(str(tmp_path / f"dst-{tag}"))
        twin = src_mod.DigestLog(str(tmp_path / f"twin-{tag}"))
        live = dst.adopt_segment(raw, bytes.fromhex(trailer_hex), keep_half)
        want = twin.adopt_segment(raw, bytes.fromhex(trailer_hex), keep_half)
        assert np.array_equal(live, want)
        assert _files(dst.root) == _files(twin.root)
        assert dst.live_count == twin.live_count == len(want)
        kept = [d for d in digs[1:] if d[0] % 2 == 0]
        assert sorted(kept) == [bytes(r) for r in live]
        # a damaged copy is refused by both
        bad = raw[:-1] + bytes([raw[-1] ^ 1])
        for mod in (port_log, ref_log):
            try:
                mod.parse_segment_bytes(bad, bytes.fromhex(trailer_hex))
            except ValueError:
                continue
            raise AssertionError(f"{mod.__name__} adopted a damaged segment")


def test_compaction_killed_at_port_failpoint(tmp_path):
    log = port_log.DigestLog(str(tmp_path / "segs"), budget_bytes=1 << 20)
    digs = _digests(16_000, seed=4)
    for i in range(0, 16_000, 8_000):           # under the budget: no spill
        log.add_many(digs[i:i + 8_000])
        log.flush()
        log.drain()
    before = _files(log.root)
    assert len(before) == 2
    fails = port_log.metrics_snapshot()["compaction_failures"]
    # the JAX package's registry is a different one: arming it there does
    # not stop the port's compaction, and the port's arming does
    with ref_failpoints.armed("pbsstore.digestlog.compact", "raise"):
        with failpoints.armed("pbsstore.digestlog.compact", "raise") as fp:
            log.compact(wait=True)
    assert fp.fires == 1
    assert port_log.metrics_snapshot()["compaction_failures"] == fails + 1
    assert _files(log.root) == before
    assert log.contains_many(digs[::101]) == [True] * len(digs[::101])
    with ref_failpoints.armed("pbsstore.digestlog.compact", "raise"):
        log.compact(wait=True)
    assert log.segment_count == 1
    assert log.live_count == 16_000
    assert log.contains_many(digs[::101]) == [True] * len(digs[::101])
