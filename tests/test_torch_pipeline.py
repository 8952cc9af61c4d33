"""The port's whole-stream ``DedupPipeline`` on the CPU against the JAX
package's, on the streams of ``tests/test_models.py``: equal
``ChunkRecord``s (cuts, digests, ``is_new``), index bytes and stats, across
a first backup and a second, fully deduplicated one.  Tolerance is exact."""

import hashlib

import numpy as np

from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.models import DedupConfig as RefConfig
from pbs_plus_tpu.models import DedupPipeline as RefPipeline
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.models import DedupConfig, DedupPipeline

REF_P = RefParams(avg_size=4 << 10)
P = params_from_reference(REF_P.avg_size, REF_P.min_size, REF_P.max_size,
                          REF_P.seed)


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def _records(res):
    return {n: [(c.offset, c.length, c.digest, c.is_new) for c in r.chunks]
            for n, r in res.items()}


def test_pipeline_records_match_reference():
    shared = _data(120_000, seed=1)
    streams = {"agent-a": shared + _data(50_000, seed=2),
               "agent-b": shared + _data(50_000, seed=3)}
    ref = RefPipeline(RefConfig(params=REF_P, segment_bytes=1 << 16,
                                index_buckets=1 << 10))
    port = DedupPipeline(DedupConfig(params=P, segment_bytes=1 << 16,
                                     index_buckets=1 << 10), device="cpu")
    got = _records(port.process_streams(streams))
    assert got == _records(ref.process_streams(streams))
    for name, data in streams.items():
        for off, n, digest, _ in got[name]:
            assert digest == hashlib.sha256(data[off:off + n]).digest()
    assert any(not new for *_, new in got["agent-b"])   # cross-stream dedup
    assert port.index._table.tobytes() == ref.index._table.tobytes()
    # second backup of one stream: everything known on both sides
    again = {"agent-a": streams["agent-a"]}
    got2 = _records(port.process_streams(again))
    assert got2 == _records(ref.process_streams(again))
    assert not any(new for *_, new in got2["agent-a"])
    assert port.stats == ref.stats
