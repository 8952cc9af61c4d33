"""The port's VerifyPipeline on the CPU against the JAX package's:
``verify_chunks`` and ``verify_stream`` verdicts, and ``verify_snapshot``
over the JAX package's own stores, clean and with a tampered chunk, with
the same verdicts in the same order for 0 and 4 workers.  Tolerance is
exact.  Chunks stay at a few KiB: the plain K2 runs here."""

import hashlib
import io

import numpy as np
import pytest

from pbs_plus_tpu.chunker import ChunkerParams
from pbs_plus_tpu.models.verify import VerifyPipeline as RefVerify
from pbs_plus_tpu.pxar import Entry, KIND_DIR, KIND_FILE, LocalStore, chunkcache
from pbs_plus_tpu_torch.models import VerifyPipeline, VerifyResult
from pbs_plus_tpu_torch.utils.device import CudaUnavailableError

P = ChunkerParams(avg_size=4 << 10)


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8
                                                ).tobytes()


def _fields(res):
    return res.checked, res.corrupt, res.corrupt_paths, res.ok


def test_verify_chunks_and_stream_match_reference():
    chunks = [_data(n, n) for n in (0, 100, 2000, 1500)]
    expected = [hashlib.sha256(c).digest() for c in chunks]
    bad = list(chunks)
    bad[2] = bad[2][:-1] + bytes([bad[2][-1] ^ 1])
    port, ref = VerifyPipeline(device="cpu"), RefVerify()
    for cs in (chunks, bad):
        got = port.verify_chunks(cs, expected)
        assert isinstance(got, VerifyResult)
        assert _fields(got) == _fields(ref.verify_chunks(cs, expected))
    assert port.verify_chunks(bad, expected).corrupt == [2]
    with pytest.raises(ValueError):
        port.verify_chunks(chunks, expected[:1])

    stream = b"".join(bad)
    bounds, off = [], 0
    for c in bad:
        bounds.append((off, off + len(c)))
        off += len(c)
    got = port.verify_stream(stream, bounds, expected)
    assert _fields(got) == _fields(ref.verify_stream(stream, bounds, expected))
    assert got.corrupt == [2]


def _snapshot(tmp_path, name, size, **store_kw):
    store = LocalStore(str(tmp_path / name), P, **store_kw)
    s = store.start_session(backup_type="host", backup_id="v")
    s.writer.write_entry(Entry(path="", kind=KIND_DIR))
    for i in range(3):
        blob = _data(size, seed=i)
        s.writer.write_entry_reader(
            Entry(path=f"f{i}.bin", kind=KIND_FILE, size=len(blob)),
            io.BytesIO(blob))
    s.finish()
    return store, s.ref


def _open(store, ref):
    return store.open_snapshot(ref, cache=chunkcache.ChunkCache(64 << 20))


def test_verify_snapshot_matches_reference_for_any_worker_count(tmp_path):
    """A pxar2 snapshot (no per-entry digests: chunk-level verify), clean
    and then with one chunk tampered on disk; the port and the JAX
    package give the same verdicts, in the same order, for 0 and 4
    workers."""
    from pbs_plus_tpu.pxar.pbsformat import blob_encode

    store, ref = _snapshot(tmp_path, "pbs", 6000, pbs_format=True)
    port, want = VerifyPipeline(device="cpu"), RefVerify()
    clean = _fields(want.verify_snapshot(_open(store, ref)))
    assert clean[3] and clean[0] > 1
    for workers in (0, 4):
        assert _fields(port.verify_snapshot(_open(store, ref),
                                            workers=workers)) == clean
    bad = _open(store, ref).payload_index.digest(1)
    with open(store.datastore.chunks._path(bad), "wb") as f:
        f.write(blob_encode(b"tampered"))     # valid DataBlob, wrong bytes
    broken = _fields(want.verify_snapshot(_open(store, ref)))
    assert not broken[3] and f"chunk:{bad.hex()}" in broken[2]
    for workers in (0, 4):
        assert _fields(port.verify_snapshot(_open(store, ref),
                                            workers=workers)) == broken


def test_verify_snapshot_file_digests_match_reference(tmp_path):
    """A snapshot whose entries carry digests: files are re-hashed (the
    plain K2 here) and compared with them, sampled or whole."""
    store, ref = _snapshot(tmp_path, "tpxd", 1500)
    port, want = VerifyPipeline(device="cpu"), RefVerify()
    for rate in (1.0, 0.5):
        got = port.verify_snapshot(_open(store, ref), sample_rate=rate,
                                   workers=4)
        assert _fields(got) == _fields(want.verify_snapshot(
            _open(store, ref), sample_rate=rate))
        assert got.ok and got.checked >= 1


def test_verify_pipeline_raises_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        VerifyPipeline()
