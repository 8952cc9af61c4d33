"""The port's dedup sidecar on the CPU against the JAX package's: equal
wire responses to one request sequence, the JAX package's client,
``SidecarChunker`` and writer backing up through the port's server, and
the port's client against the JAX server.  Tolerance is exact.  Data stays
at tens of KiB: the plain K2 runs here."""

import hashlib
import io

import numpy as np
import pytest

from pbs_plus_tpu.chunker import ChunkerParams, chunk_bounds
from pbs_plus_tpu.sidecar import SidecarChunker
from pbs_plus_tpu.sidecar import SidecarClient as RefClient
from pbs_plus_tpu.sidecar import serve_sidecar as ref_serve
from pbs_plus_tpu_torch.__main__ import main as port_main
from pbs_plus_tpu_torch.convert import params_from_reference
from pbs_plus_tpu_torch.sidecar import DedupService, SidecarClient, serve_sidecar

P = ChunkerParams(avg_size=1 << 10)           # chunks of 256 B to 4 KiB
PORT_P = params_from_reference(P.avg_size, P.min_size, P.max_size, P.seed)


@pytest.fixture(scope="module")
def servers():
    ref_server, ref_port, _ = ref_serve(params=P, use_tpu=False)
    port_server, port_port, svc = serve_sidecar(params=PORT_P, device="cpu")
    yield f"127.0.0.1:{ref_port}", f"127.0.0.1:{port_port}", svc
    ref_server.stop(grace=None)
    port_server.stop(grace=None)


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _feed(client, sid, data, page):
    out = [client._call("/pbsplus.Dedup/Chunk", {
        "stream_id": sid, "data": data[off:off + page], "eof": False})
        for off in range(0, len(data), page)]
    out.append(client._call("/pbsplus.Dedup/Chunk",
                            {"stream_id": sid, "data": b"", "eof": True}))
    return out


def _sequence(client, sid):
    """One request sequence over the raw wire: every response map.  Pages
    are at least ``max_size``: below it the JAX package's CPU chunker
    holds a page back to scan it with the next (its feed coalescing), so
    its cuts of a small page arrive one response later."""
    data = _data(16_384, seed=1)
    out = _feed(client, sid, data, 8192)
    digests = [d for r in out for d in r["digests"]]
    other = [hashlib.sha256(bytes([i, 42])).digest() for i in range(20)]
    for method, req in (("ProbeIndex", {"digests": digests + other}),
                        ("InsertIndex", {"digests": digests}),
                        ("InsertIndex", {"digests": digests[:3] + other[:2]}),
                        ("ProbeIndex", {"digests": other + digests}),
                        ("ProbeIndex", {"digests": []}),
                        ("Similarity", {"digests": digests + other}),
                        ("Stats", {})):
        out.append(client._call(f"/pbsplus.Dedup/{method}", req))
    return out, data, digests


def test_port_server_answers_like_reference(servers):
    ref_addr, port_addr, _ = servers
    clients = [SidecarClient(ref_addr), SidecarClient(port_addr)]
    try:
        (ref, data, digests), (got, _, _) = [_sequence(c, "seq")
                                             for c in clients]
        small = _data(6000, seed=5)
        ref_small, got_small = [_feed(c, "small", small, 2000)
                                for c in clients]
    finally:
        for c in clients:
            c.close()
    assert got == ref
    want = chunk_bounds(data, P)
    assert [c for r in ref[:3] for c in r["cuts"]] == [e for _, e in want]
    assert digests == [hashlib.sha256(data[s:e]).digest() for s, e in want]
    assert got[-1]["use_tpu"] is False and len(got[-2]["signature"]) == 128
    # small pages: the same cuts, digests and sizes, in the same order
    for key in ("cuts", "digests", "sizes"):
        assert [x for r in got_small for x in r[key]] == \
            [x for r in ref_small for x in r[key]]


def test_reference_writer_backs_up_through_port_server(servers, tmp_path):
    """The JAX package's client, SidecarChunker and writer, unmodified,
    chunk through the port's server; the restore is bit-identical and the
    chunk boundaries are the CPU chunker's."""
    from pbs_plus_tpu.pxar import Entry, KIND_DIR, KIND_FILE, LocalStore
    _, port_addr, svc = servers
    client = RefClient(port_addr)
    try:
        store = LocalStore(str(tmp_path / "ds"), P,
                           chunker_factory=lambda p: SidecarChunker(p, client))
        s = store.start_session(backup_type="host", backup_id="sc")
        s.writer.write_entry(Entry(path="", kind=KIND_DIR))
        data = _data(20_000, seed=2)
        s.writer.write_entry_reader(Entry(path="f", kind=KIND_FILE),
                                    io.BytesIO(data))
        s.finish()
        r = store.open_snapshot(s.ref)
        e = [x for x in r.entries() if x.is_file][0]
        assert r.read_file(e) == data
        assert len(list(r.payload_index.records())) == len(chunk_bounds(data, P))
        assert client.stats()["chunker"]["avg"] == P.avg_size
    finally:
        client.close()
    assert svc.stats["streams"] >= 1 and not svc._streams


def test_port_client_against_reference_server(servers):
    ref_addr, _, _ = servers
    client = SidecarClient(ref_addr, timeout_s=60)
    try:
        data = _data(10_000, seed=3)
        r1 = client.chunk("pc", data[:6000])
        r2 = client.chunk("pc", data[6000:], eof=True)
        want = chunk_bounds(data, P)
        assert r1["cuts"] + r2["cuts"] == [e for _, e in want]
        digs = r1["digests"] + r2["digests"]
        assert digs == [hashlib.sha256(data[s:e]).digest() for s, e in want]
        fresh = [hashlib.sha256(bytes([i, 7])).digest() for i in range(10)]
        assert client.probe_index(fresh) == [False] * 10
        assert client.insert_index(fresh) == 10
        assert client.probe_index(fresh) == [True] * 10
        assert len(client.snapshot_signature(fresh)) == 128
        assert client.stats()["chunker"]["seed"] == P.seed
    finally:
        client.close()


def test_service_in_process_matches_wire(servers):
    """The handlers called with dicts give what the wire gives."""
    _, port_addr, _ = servers
    svc = DedupService(params=PORT_P, device="cpu")
    client = SidecarClient(port_addr)
    try:
        digs = [hashlib.sha256(bytes([i, 9])).digest() for i in range(30)]
        assert svc.handlers()["Similarity"]({"digests": digs}) == \
            client._call("/pbsplus.Dedup/Similarity", {"digests": digs})
        data = _data(5000, seed=4)
        req = {"stream_id": "ip", "data": data, "eof": True}
        assert svc.chunk(req) == client._call("/pbsplus.Dedup/Chunk", req)
        assert svc.get_stats({})["use_tpu"] is False
    finally:
        client.close()


def test_sidecar_command_refuses_cuda_without_card():
    import torch
    from pbs_plus_tpu_torch.utils.device import CudaUnavailableError
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CudaUnavailableError):
        port_main(["sidecar", "--listen", "127.0.0.1:0", "--device", "cuda"])
    with pytest.raises(SystemExit):
        port_main(["sidecar", "--device", "auto"])
