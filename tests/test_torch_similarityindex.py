"""The port's SimilarityIndex against the JAX package's, on the CPU.

The same chunks -- generations of near-duplicate edits of a few bases,
plus unrelated ones -- go through the write path's calls on both indexes
(``presketch``, ``take_sketch``, ``take_candidate``, ``add``,
``candidate``, ``discard``) with a small ``max_entries`` so that eviction
runs.  Sketches, candidate answers, band buckets, the recency window,
``export_entries`` and the counters must be equal.  Tolerance is exact.
"""

import numpy as np

from pbs_plus_tpu.pxar import similarityindex as ref_si
from pbs_plus_tpu_torch.ops.similarity import content_sketch_host
from pbs_plus_tpu_torch.pxar import similarityindex as port_si


def _corpus(seed):
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 256, 3_000 + 500 * i, dtype=np.uint8)
             for i in range(6)]
    out = []
    for gen in range(5):
        for b in bases:
            c = b.copy()
            at = rng.integers(0, len(c) - 64, 3)
            for a in at:
                c[a:a + 16] = rng.integers(0, 256, 16, dtype=np.uint8)
            out.append(c.tobytes())
        out.append(rng.integers(0, 256, 2_000, dtype=np.uint8).tobytes())
    out.append(b"ab")                                 # shorter than a window
    return out


def _digest(i):
    return i.to_bytes(4, "big") * 8


def _drive(si, chunks):
    """The write path's calls, batch by batch; returns every answer."""
    answers = []
    for lo in range(0, len(chunks), 7):
        batch = chunks[lo:lo + 7]
        digs = [_digest(lo + k) for k in range(len(batch))]
        known = [(lo + k) % 5 == 4 for k in range(len(batch))]
        answers.append(si.presketch(digs, batch, known))
        for k, (d, c) in enumerate(zip(digs, batch)):
            s = si.take_sketch(d, c)
            cand = si.take_candidate(d, s, exclude=digs[0])
            answers.append((s, cand, si.candidate(s)))
            depth = 0 if cand is None else cand[1] + 1
            si.add(d, s, depth)
        if lo % 21 == 14:
            answers.append(si.discard(digs[len(digs) // 2]))
            answers.append(si.discard(_digest(10_000 + lo)))
    answers.append(si.discard_many([_digest(i) for i in range(0, 40, 3)]))
    return answers


def test_sketches_candidates_bands_and_entries_match():
    chunks = _corpus(seed=1)
    kw = {"threshold": 20, "max_chain": 2, "max_entries": 10}
    ref = ref_si.SimilarityIndex(**kw)
    port = port_si.SimilarityIndex(device="cpu", **kw)
    assert np.array_equal(port.sketch_batch(chunks),
                          ref_si.SimilarityIndex.sketch_batch(chunks))
    assert np.array_equal(port.sketch_batch(chunks),
                          content_sketch_host(chunks))
    m0, p0 = ref_si.metrics_snapshot(), port_si.metrics_snapshot()
    got, want = _drive(port, chunks), _drive(ref, chunks)
    assert got == want
    assert any(a[1] is not None for a in want if isinstance(a, tuple))
    m1, p1 = ref_si.metrics_snapshot(), port_si.metrics_snapshot()
    for k in ("probes", "candidates", "chain_rejects"):
        assert p1[k] - p0[k] == m1[k] - m0[k], k
    assert m1["chain_rejects"] > m0["chain_rejects"]
    assert len(port) == len(ref) > 0
    assert port.export_entries() == ref.export_entries()
    assert port._bands == ref._bands
    assert list(port._recent) == list(ref._recent)
    for i in range(0, len(chunks), 5):
        assert port.has(_digest(i)) == ref.has(_digest(i))
        assert port.depth_of(_digest(i)) == ref.depth_of(_digest(i))

    # entries exported by either package re-seed the other identically
    for src, dst in ((ref, port_si.SimilarityIndex(device="cpu", **kw)),
                     (port, ref_si.SimilarityIndex(**kw))):
        assert dst.load_entries(src.export_entries()) == len(src)
        assert dst.export_entries() == src.export_entries()
        assert dst._bands == src._bands
        s = int(src.export_entries()[3][1])
        assert dst.candidate(s ^ 0b101) == src.candidate(s ^ 0b101)
