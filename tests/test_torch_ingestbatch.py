"""The port's cross-session fused-ingest collector against the JAX package's.

The same sessions, made from a numpy seed, go through the JAX
``FusedIngestStream`` + ``IngestCollector`` over a JAX ``ChunkStore`` and
through the port's, with ``device="cpu"`` (the plain K1 and the plain
SHA-256), over a second ``ChunkStore`` whose index is the port's
``DedupIndex``.  Records, ``WriterStats``, the stored digests and, for a
lone session, every collector counter must be equal; threaded sessions
must also equal the port's staged ``_ChunkedStream`` on the ``"cuda"``
chunker and batch hasher.  The failure paths (deadline, registration,
poisoning), a JAX pipelined ``SessionWriter`` depositing into the port's
collector, and the small pieces (``_tail_of``, the ingest backends,
``collector_for`` and its environment knobs) are held too.  Tolerance is
exact.

The plain SHA-256 on the CPU takes one step per 64-byte block of a
flush's longest chunk, so the sessions chunk at a 1 KiB average (4 KiB
at most) and write in few, large pieces.
"""

import dataclasses
import hashlib
import io
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.pxar import ingestbatch as ref_ib
from pbs_plus_tpu.pxar import ingestbackend as ref_be
from pbs_plus_tpu.pxar.datastore import ChunkStore
from pbs_plus_tpu.pxar.format import KIND_FILE, Entry
from pbs_plus_tpu.pxar.pipeline import PipelinedStream
from pbs_plus_tpu.pxar.transfer import SessionWriter
from pbs_plus_tpu.pxar.transfer import _ChunkedStream as RefStream
from pbs_plus_tpu.utils import conf as ref_conf
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.models import make_batch_hasher, make_chunker_factory
from pbs_plus_tpu_torch.ops import ingest as port_ingest
from pbs_plus_tpu_torch.pxar import ingestbatch as port_ib
from pbs_plus_tpu_torch.pxar import ingestbackend as port_be
from pbs_plus_tpu_torch.pxar import pipeline as port_pipeline
from pbs_plus_tpu_torch.pxar.chunkindex import DedupIndex
from pbs_plus_tpu_torch.pxar.transfer import _ChunkedStream
from pbs_plus_tpu_torch.utils import trace

REF_P = RefParams(avg_size=1024)
P = params_from_reference(REF_P.avg_size, REF_P.min_size, REF_P.max_size,
                          REF_P.seed)


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _ref_store(tmp_path, name):
    return ChunkStore(str(tmp_path / name), index_budget_mb=1)


def _port_store(tmp_path, name):
    return ChunkStore(str(tmp_path / name),
                      index=DedupIndex(budget_mb=1, device="cpu"))


def _delta(after, before):
    return {k: after[k] - before[k] for k in before if k != "occupancy"}


def _occupancy(d):
    total = d["bytes_packed"] + d["padding_bytes"]
    return d["bytes_packed"] / total if total else 0.0


def _write(stream, data, pieces):
    for k in range(0, len(data), pieces):
        stream.write(data[k:k + pieces])


# ------------------------------------------------------ records and stores


def test_lone_session_records_stats_store_and_counters(tmp_path):
    data = _data(150_000, seed=1)

    def run(ib, store, params, **kw):
        # a lone registered stream flushes on the all-deposited trigger at
        # once; the long wait keeps a stalled host from turning a flush
        # into a linger flush on one side only
        coll = ib.IngestCollector(store, max_wait=10.0, **kw)
        before = ib.metrics_snapshot()
        stream = ib.FusedIngestStream(store, params, coll)
        _write(stream, data, 50_000)
        records = stream.finish()
        return (records, dataclasses.asdict(stream.stats),
                set(store.iter_digests()),
                _delta(ib.metrics_snapshot(), before))

    ref = run(ref_ib, _ref_store(tmp_path, "ref"), REF_P)
    sha0 = port_ingest.stats["sha_dispatches"]
    port = run(port_ib, _port_store(tmp_path, "port"), P, device="cpu")
    assert port[0] == ref[0] and len(ref[0]) > 50
    s = 0
    for end, digest in port[0]:
        assert digest == hashlib.sha256(data[s:end]).digest()
        s = end
    assert s == len(data)
    assert port[1] == ref[1] and ref[1]["new_chunks"] == len(ref[0])
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert ref[3]["flushes"] == 4 and ref[3]["probe_dispatches"] == 4
    assert ref[3]["linger_flushes"] == ref[3]["deadline_flushes"] == 0
    assert _occupancy(port[3]) == _occupancy(ref[3]) > 0.99
    assert port_ingest.stats["sha_dispatches"] - sha0 == 4


def test_threaded_sessions_equal_jax_and_staged(tmp_path):
    """Four sessions in threads with ragged writes, a splice and a forced
    cut; flush counts are timing-bound here and not compared."""
    payloads = [(_data(n, seed=10 + k), _data(6_000, seed=20 + k))
                for k, n in enumerate((20_000, 35_000, 12_000, 28_000))]
    spliced = b"spliced chunk"
    sp_digest = hashlib.sha256(spliced).digest()

    def drive(stream, k):
        first, second = payloads[k]
        rng = np.random.default_rng(30 + k)
        off = 0
        while off < len(first):
            step = int(rng.integers(1, 25_000))
            stream.write(first[off:off + step])
            off += step
        stream.append_ref(sp_digest, len(spliced))
        stream.write(second)
        stream.flush_chunker()
        stream.write(second[:2_000])
        return stream.finish(), dataclasses.asdict(stream.stats)

    def run(store, make):
        store.insert(sp_digest, spliced, verify=False)
        out, errs = [None] * 4, []

        def one(k):
            try:
                out[k] = drive(make(store), k)
            except BaseException as e:
                errs.append(e)

        threads = [threading.Thread(target=one, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errs and not any(t.is_alive() for t in threads), errs
        return out, set(store.iter_digests())

    ref_store = _ref_store(tmp_path, "ref")
    ref_coll = ref_ib.IngestCollector(ref_store, max_wait=0.02)
    ref = run(ref_store, lambda s: ref_ib.FusedIngestStream(s, REF_P, ref_coll))
    port_store = _port_store(tmp_path, "port")
    port_coll = port_ib.IngestCollector(port_store, device="cpu", max_wait=0.02)
    port = run(port_store,
               lambda s: port_ib.FusedIngestStream(s, P, port_coll))
    staged_store = _port_store(tmp_path, "staged")
    factory = make_chunker_factory("cuda", device="cpu")
    hasher = make_batch_hasher("cuda", device="cpu")
    staged = run(staged_store,
                 lambda s: _ChunkedStream(s, P, factory, batch_hasher=hasher))
    # new/known split between sessions depends on who stored a shared
    # digest first; records and the union do not
    assert [r for r, _ in port[0]] == [r for r, _ in ref[0]] \
        == [r for r, _ in staged[0]]
    for got in (port, staged):
        assert [(s["bytes_streamed"], s["ref_chunks"], s["bytes_reffed"])
                for _, s in got[0]] == \
            [(s["bytes_streamed"], s["ref_chunks"], s["bytes_reffed"])
             for _, s in ref[0]]
    assert port[1] == ref[1] == staged[1]
    assert not port_coll._streams and not ref_coll._streams


def test_collector_under_thread_switching_stress(tmp_path, monkeypatch):
    """Twelve writers with the interpreter switching threads every
    microsecond: every record equals the JAX staged writer's and the
    counters add up (a lost update in the collector would break one).
    The digest stage is hashlib here, so the test is the policy's."""
    monkeypatch.setattr(port_ingest, "digest_chunks", lambda chunks, *, device:
                        [hashlib.sha256(c).digest() for c in chunks])
    payloads = [_data(9_000 + 700 * k, seed=40 + k) for k in range(12)]
    store = _port_store(tmp_path, "s")
    coll = port_ib.IngestCollector(store, device="cpu", max_wait=0.005)
    out, errs = [None] * len(payloads), []
    before = port_ib.metrics_snapshot()

    def one(k):
        try:
            stream = port_ib.FusedIngestStream(store, P, coll)
            _write(stream, payloads[k], 2_500)
            out[k] = stream.finish()
        except BaseException as e:
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(k,))
                   for k in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errs and not any(t.is_alive() for t in threads), errs
    d = _delta(port_ib.metrics_snapshot(), before)
    for k, data in enumerate(payloads):
        ref = RefStream(_ref_store(tmp_path, f"ref{k}"), REF_P)
        _write(ref, data, 2_500)
        assert out[k] == ref.finish()
    assert d["chunks"] == sum(len(r) for r in out)
    assert d["bytes_packed"] == sum(len(p) for p in payloads)
    assert d["sessions_packed"] >= d["flushes"] > 0
    assert d["failed_flushes"] == 0 and not coll._streams


# ----------------------------------------------------------- failure paths


def test_deadline_bounds_lone_session_beside_idle_stream(tmp_path,
                                                        monkeypatch):
    """The all-deposited trigger cannot fire while an idle stream is
    registered, so the linger or the deadline must: the session takes at
    most a few waits of ``max_wait`` more than with no idle stream.  The
    digest stage is hashlib here, so the time is the policy's."""
    monkeypatch.setattr(port_ingest, "digest_chunks", lambda chunks, *, device:
                        [hashlib.sha256(c).digest() for c in chunks])
    data = _data(12_000, seed=3)
    max_wait = 0.05

    def run(name, idle):
        store = _port_store(tmp_path, name)
        coll = port_ib.IngestCollector(store, device="cpu", max_wait=max_wait)
        other = port_ib.FusedIngestStream(store, P, coll) if idle else None
        before = port_ib.metrics_snapshot()
        t0 = time.monotonic()
        stream = port_ib.FusedIngestStream(store, P, coll)
        stream.write(data)
        records = stream.finish()
        elapsed = time.monotonic() - t0
        if other is not None:
            other.close()
        return records, elapsed, _delta(port_ib.metrics_snapshot(), before)

    alone, t_alone, _ = run("alone", idle=False)
    records, elapsed, d = run("idle", idle=True)
    assert records == alone and all(dg for _, dg in records)
    assert d["linger_flushes"] + d["deadline_flushes"] == d["flushes"] == 2
    assert elapsed < t_alone + 20 * max_wait, (elapsed, t_alone)


def test_failed_construction_never_leaks_registration(tmp_path):
    store = _port_store(tmp_path, "s")
    coll = port_ib.IngestCollector(store, device="cpu", max_wait=0.01)

    def bad_factory(params):
        raise RuntimeError("bind failed")

    with pytest.raises(RuntimeError):
        PipelinedStream(store, REF_P, bad_factory, workers=1, collector=coll)
    with pytest.raises(RuntimeError):
        _ChunkedStream(store, P, bad_factory, collector=coll)
    assert len(coll._streams) == 0
    stream = port_ib.FusedIngestStream(store, P, coll)
    assert len(coll._streams) == 1
    stream.finish()
    assert len(coll._streams) == 0


class _Boom(RuntimeError):
    pass


class _FailingInserts:
    """A store whose inserts raise; everything else is the wrapped one's."""

    def __init__(self, store):
        self._store = store

    def insert(self, digest, data, *, verify=True):
        raise _Boom("disk full")

    def __getattr__(self, name):
        return getattr(self._store, name)


def _two_in_one_batch(coll, stores, payloads):
    """Two fused streams that deposit one parcel each, together, so the
    all-deposited trigger packs them into one flush; -> {k: records or
    the exception}."""
    streams = [port_ib.FusedIngestStream(s, P, coll) for s in stores]
    barrier = threading.Barrier(2)
    out = {}

    def one(k):
        streams[k].write(payloads[k])      # below the deposit block
        barrier.wait()
        try:
            out[k] = streams[k].finish()
        except BaseException as e:
            out[k] = e
            streams[k].close()

    threads = [threading.Thread(target=one, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_stage_error_poisons_the_whole_batch(tmp_path, monkeypatch):
    store = _port_store(tmp_path, "s")
    coll = port_ib.IngestCollector(store, device="cpu", max_wait=10.0)

    def explode(chunks, *, device):
        raise _Boom("sha stage down")

    monkeypatch.setattr(port_ingest, "digest_chunks", explode)
    before = port_ib.metrics_snapshot()
    out = _two_in_one_batch(coll, [store, store],
                            [_data(3_000, seed=4), _data(2_000, seed=5)])
    d = _delta(port_ib.metrics_snapshot(), before)
    assert isinstance(out[0], _Boom) and isinstance(out[1], _Boom)
    assert d["flushes"] == d["failed_flushes"] == 1
    assert d["sessions_packed"] == 2


def test_insert_error_poisons_only_its_parcel(tmp_path):
    store = _port_store(tmp_path, "s")
    coll = port_ib.IngestCollector(store, device="cpu", max_wait=10.0)
    payloads = [_data(3_000, seed=6), _data(2_000, seed=7)]
    before = port_ib.metrics_snapshot()
    out = _two_in_one_batch(coll, [_FailingInserts(store), store], payloads)
    d = _delta(port_ib.metrics_snapshot(), before)
    assert isinstance(out[0], _Boom)
    assert d["flushes"] == 1 and d["failed_flushes"] == 0
    assert d["sessions_packed"] == 2
    ref = RefStream(_ref_store(tmp_path, "ref"), REF_P)
    ref.write(payloads[1])
    assert out[1] == ref.finish()
    assert set(store.iter_digests()) == {dg for _, dg in out[1]}


# ---------------------------------------------------- the pipelined route


def test_jax_pipelined_writer_deposits_into_port_collector(tmp_path):
    data = _data(120_000, seed=8)

    def run(store, coll):
        w = SessionWriter(store, payload_params=REF_P, pipeline_workers=2,
                          ingest_collector=coll)
        w.write_entry_reader(Entry(path="f", kind=KIND_FILE, size=len(data)),
                             io.BytesIO(data))
        _, pidx, stats = w.finish()
        return [pidx.digest(i) for i in range(len(pidx))], stats.new_chunks

    s1 = _ref_store(tmp_path, "ref")
    want = run(s1, ref_ib.IngestCollector(s1, max_wait=0.01))
    s2 = _port_store(tmp_path, "port")
    before = port_ib.metrics_snapshot()
    got = run(s2, port_ib.IngestCollector(s2, device="cpu", max_wait=0.01))
    d = _delta(port_ib.metrics_snapshot(), before)
    assert got == want and want[1] > 0
    assert d["flushes"] >= 1 and d["rows"] == 0        # chunk parcels only
    assert d["chunks"] == len(want[0]) and d["probe_dispatches"] == d["flushes"]
    assert set(s2.iter_digests()) == set(s1.iter_digests())


# ------------------------------------------------------------ small pieces


def test_tail_of_equals_jax_on_random_splits():
    rng = np.random.default_rng(9)
    for _ in range(200):
        prev = _data(int(rng.integers(0, 64)), seed=int(rng.integers(1 << 30)))
        n = int(rng.integers(0, 5))
        blocks = [_data(int(rng.integers(0, 90)), seed=int(rng.integers(1 << 30)))
                  for _ in range(n)]
        views = [memoryview(b) for b in blocks]
        want = ref_ib._tail_of(prev, blocks)
        assert port_ib._tail_of(prev, blocks) == want
        assert port_ib._tail_of(prev, views) == want
        assert want == (prev + b"".join(blocks))[-63:]


def test_resolve_ingest_backend_matches_jax(tmp_path):
    class Declared:
        def ingest_capabilities(self):
            return port_be.IngestCapabilities(probe=True, presketch=False)

        def probe_batch(self, digests):
            return [True] * len(digests)

    class Undeclared:
        def insert(self, digest, data, *, verify=True):
            return True

    indexed = _ref_store(tmp_path, "indexed")
    for store, kind in ((Declared(), "StoreIngestBackend"),
                        (indexed, "StoreIngestBackend"),
                        (Undeclared(), "InlineIngestBackend")):
        got = port_be.resolve_ingest_backend(store)
        want = ref_be.resolve_ingest_backend(store)
        assert type(got).__name__ == type(want).__name__ == kind
        assert tuple(got.capabilities) == tuple(want.capabilities)
    assert port_be.resolve_ingest_backend(indexed).capabilities.probe is True
    inline = port_be.resolve_ingest_backend(Undeclared())
    assert inline.capabilities == port_be.NO_CAPABILITIES
    with pytest.raises(TypeError):
        inline.probe_batch([b"x" * 32])
    with pytest.raises(TypeError):
        inline.presketch_batch([], [], None)


def test_collector_for_memoizes_per_store_and_device(tmp_path):
    a, b = _port_store(tmp_path, "a"), _port_store(tmp_path, "b")
    ca = port_ib.collector_for(a, device="cpu")
    assert port_ib.collector_for(a, device="cpu") is ca
    assert port_ib.collector_for(b, device="cpu") is not ca
    assert ca.device == torch.device("cpu")
    # the JAX package memoizes on its own attribute: no cross-talk
    assert ref_ib.collector_for(a) is not ca
    assert isinstance(ref_ib.collector_for(a), ref_ib.IngestCollector)
    # the memo names the device the store's collector runs on
    ca.device = torch.device("cuda", 0)
    with pytest.raises(ValueError):
        port_ib.collector_for(a, device="cpu")


def test_locked_store_shares_the_jax_writers_lock(tmp_path):
    from pbs_plus_tpu.pxar.pipeline import locked_store as ref_locked

    store = _port_store(tmp_path, "s")
    assert port_pipeline.locked_store(store) is store     # thread-safe

    class Plain:
        def insert(self, digest, data, *, verify=True):
            return True

        def touch(self, digest):
            pass

    plain = Plain()
    proxy = port_pipeline.locked_store(plain)
    assert ref_locked(plain) is proxy is port_pipeline.locked_store(proxy)


@pytest.mark.parametrize("env,want", [
    ({}, (16 << 20, 0.025)),
    ({"PBS_PLUS_INGEST_BATCH_BYTES": "1234",
      "PBS_PLUS_INGEST_MAX_WAIT_MS": "40"}, (1234, 0.04)),
    ({"PBS_PLUS_INGEST_BATCH_BYTES": "16MiB",
      "PBS_PLUS_INGEST_MAX_WAIT_MS": "x"}, (16 << 20, 0.025)),
], ids=["unset", "set", "bad"])
def test_collector_for_environment_knobs(tmp_path, monkeypatch, env, want):
    for k in ("PBS_PLUS_INGEST_BATCH_BYTES", "PBS_PLUS_INGEST_MAX_WAIT_MS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref_conf.env.cache_clear()
    try:
        e = ref_conf.env()
        assert (e.ingest_batch_bytes, e.ingest_max_wait_ms / 1000.0) == want
    finally:
        ref_conf.env.cache_clear()
    coll = port_ib.collector_for(_port_store(tmp_path, "s"), device="cpu")
    assert (coll.batch_bytes, coll.max_wait, coll.batch_chunks) == (*want, 4096)
    explicit = port_ib.collector_for(_port_store(tmp_path, "t"), device="cpu",
                                     batch_bytes=7, batch_chunks=9,
                                     max_wait=0.5)
    assert (explicit.batch_bytes, explicit.batch_chunks,
            explicit.max_wait) == (7, 9, 0.5)


def test_stage_spans_feed_the_ingest_stage_histogram(tmp_path):
    before = trace.histograms()
    store = _port_store(tmp_path, "s")
    coll = port_ib.IngestCollector(store, device="cpu")
    stream = port_ib.FusedIngestStream(store, P, coll)
    stream.write(_data(3_000, seed=11))        # one deposit, at finish
    stream.finish()
    after = trace.histograms()
    for stage in ("fused", "cdc", "sha", "probe"):
        key = f'pbs_plus_ingest_stage_seconds{{stage="{stage}"}}'
        n0 = before.get(key, {"count": 0})["count"]
        assert after[key]["count"] == n0 + 1, stage
    with pytest.raises(ValueError):
        trace.span("ingest.nope")
