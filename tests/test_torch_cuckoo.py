"""The port's cuckoo index against the JAX package's: identical host-mirror
bytes after the same seeded insert sequence (evictions, growth,
``insert_many``, ``discard``), and probe answers (K3 on the CPU) equal to
the JAX ``_lookup`` and ``lookup_host``.  Tolerance is exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from pbs_plus_tpu.ops import cuckoo as ref
from pbs_plus_tpu_torch.convert import index_from_reference
from pbs_plus_tpu_torch.ops import cuckoo as port


def _digests(n, seed):
    rows = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [bytes(r) for r in rows]


def _same(a, b):
    assert a.n_buckets == b.n_buckets
    assert a._table.tobytes() == b._table.tobytes()
    assert a._known == b._known


def test_table_bytes_identical_after_same_inserts():
    r, p = ref.CuckooIndex(n_buckets=1 << 6, seed=3), \
        port.CuckooIndex(n_buckets=1 << 6, seed=3, device="cpu")
    singles = _digests(240, 1)          # 94% of 256 slots: eviction chains
    for d in singles:
        assert r.insert(d) == p.insert(d)
    _same(r, p)
    bulk = _digests(700, 2) + singles[:10]
    assert r.insert_many(bulk) == p.insert_many(bulk)
    assert p.n_buckets > 1 << 6        # grew
    _same(r, p)
    for d in singles[::7]:
        assert r.discard(d) == p.discard(d)
    _same(r, p)
    more = _digests(300, 3)
    for d in more:
        r.insert(d)
        p.insert(d)
    _same(r, p)


def test_filter_only_mode_matches():
    r, p = ref.CuckooIndex(n_buckets=1 << 6, seed=4), \
        port.CuckooIndex(n_buckets=1 << 6, seed=4, device="cpu")
    live = _digests(400, 5)
    r.attach_digest_source(lambda: iter(live))
    p.attach_digest_source(lambda: iter(live))
    for d in live[:150]:
        r.insert_fp(d)
        p.insert_fp(d)
    r.insert_fp_many(live[150:])
    p.insert_fp_many(live[150:])
    assert r._n_fp == p._n_fp
    _same(r, p)
    assert all(p.maybe_contains(d) for d in live)


def test_probe_matches_reference_lookup():
    r = ref.CuckooIndex(n_buckets=1 << 8, seed=7)
    known = _digests(600, 6)
    zero_fp = bytes(8) + bytes(range(24))   # fp0 = fp1 = 0: 0x5A5A5A5A
    r.insert_many(known + [zero_fp])
    p = index_from_reference(r._table, r._known, n_buckets=r.n_buckets,
                             seed=7, device="cpu")
    probes = known[:300] + _digests(300, 8) + [zero_fp, bytes(32)]
    arr = np.frombuffer(b"".join(probes), dtype=np.uint8).reshape(-1, 32)
    want = np.asarray(ref._lookup(jnp.asarray(r._table), jnp.asarray(arr)))
    got = p.probe(arr).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, port.lookup_host(p._table, arr))
    assert got[:300].all() and got[-2]
    assert p.probe_confirmed(probes) == r.probe_confirmed(probes)


def test_index_from_reference_checks_shape():
    with pytest.raises(ValueError):
        index_from_reference(np.zeros((4, 4, 2), np.uint32), [],
                             n_buckets=8, device="cpu")


def test_buckets_for_bytes_matches():
    for budget in (0, 1 << 15, 1 << 20, 32 << 20, (32 << 20) - 1):
        assert port.buckets_for_bytes(budget) == ref.buckets_for_bytes(budget)


def test_concurrent_insert_and_probe_stay_exact():
    """Writer and prober threads share one index, as the sidecar's gRPC
    handlers do: every digest whose insert returned before a probe began
    answers present, no digest outside the inserted pool does, and the
    device table equals the host mirror at the end."""
    import threading

    idx = port.CuckooIndex(n_buckets=1 << 14, seed=3, device="cpu")
    writers, batches, width = 4, 60, 48
    pools = [_digests(batches * width, 100 + w) for w in range(writers)]
    absent = _digests(256, 99)
    done: set[bytes] = set()
    done_lock = threading.Lock()
    stop = threading.Event()
    errors: list[str] = []

    def write(pool):
        for i in range(0, len(pool), width):
            batch = pool[i:i + width]
            idx.insert_many(batch)
            with done_lock:
                done.update(batch)

    def probe(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set() and not errors:
            with done_lock:
                settled = list(done)
            if not settled:
                stop.wait(0.001)
                continue
            pick = [settled[int(i)] for i in
                    rng.integers(0, len(settled), 64)] + absent[:16]
            got = idx.probe_confirmed(pick)
            if not all(got[:64]) or any(got[64:]):
                errors.append("answer differs from the set")

    probers = [threading.Thread(target=probe, args=(s,)) for s in range(3)]
    threads = [threading.Thread(target=write, args=(p,)) for p in pools]
    for t in probers + threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    for t in probers:
        t.join()
    assert not errors
    everything = [d for p in pools for d in p]
    assert idx.probe_confirmed(everything) == [True] * len(everything)
    assert not any(idx.probe_confirmed(absent))
    assert np.array_equal(idx.device_table().numpy(),
                          idx._table.view(np.int64).reshape(-1, port.SLOTS))
