"""The port's distributed index (service half) against the JAX package's.

``ShardMap`` bytes and routing must be equal; the JAX ``DistIndexClient``
must drive the port's ``IndexShardServer`` nodes and the port's client
the JAX nodes, in process, with equal verdicts, at most one wire request
per shard per batch, and byte-identical ``/persist`` snapshots and
segments; a rebalance across a mixed cluster must leave every digest with
exactly one owner; and ``python -m pbs_plus_tpu_torch index-shard`` must
keep the node protocol (ready line, stdin ``exit``, snapshot).  Tolerance
is exact.
"""

import json
import os
import queue
import subprocess
import sys
import threading

import numpy as np

from pbs_plus_tpu.parallel import dist_index as ref_di
from pbs_plus_tpu.pxar.chunkindex import DedupIndex as RefIndex
from pbs_plus_tpu_torch.parallel import dist_index as port_di
from pbs_plus_tpu_torch.pxar.chunkindex import DedupIndex as PortIndex
from pbs_plus_tpu_torch.utils import fswitness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digests(n, seed):
    arr = np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)
    return [arr[i].tobytes() for i in range(n)]


def _node(pkg, sid, root, *, snapshot=True):
    """One in-process shard node of ``pkg`` ("ref" or "port")."""
    kw = {"budget_mb": 1, "spill_dir": str(root / f"spill-{pkg}-{sid}"),
          "resident_mb": 1}
    idx = RefIndex(**kw) if pkg == "ref" else PortIndex(device="cpu", **kw)
    idx.mark_booted()
    mod = ref_di if pkg == "ref" else port_di
    srv = mod.IndexShardServer(
        sid, idx, token="t0k",
        snapshot_path=str(root / f"snap-{pkg}-{sid}") if snapshot else None)
    srv.start()
    return srv


def test_shard_map_bytes_and_routing_match(tmp_path):
    shards = [("s0", "http://127.0.0.1:9001"), ("s1", "http://h:9002"),
              ("s2", "http://127.0.0.1:9003")]
    ref, port = ref_di.ShardMap(shards, epoch=7), port_di.ShardMap(shards, epoch=7)
    assert port.to_bytes() == ref.to_bytes()
    arr = np.frombuffer(b"".join(_digests(5_000, seed=1)), np.uint8).reshape(-1, 32)
    assert np.array_equal(port.owner_indices(arr), ref.owner_indices(arr))
    ref.save(str(tmp_path / "ref.shardmap"))
    port.save(str(tmp_path / "port.shardmap"))
    assert (tmp_path / "port.shardmap").read_bytes() == \
        (tmp_path / "ref.shardmap").read_bytes()
    back = port_di.ShardMap.load(str(tmp_path / "ref.shardmap"))
    assert back.to_bytes() == ref.to_bytes()
    assert ref_di.ShardMap.from_bytes(port.to_bytes()).epoch == 7
    raw = bytearray(port.to_bytes())
    raw[10] ^= 1
    assert port_di.ShardMap.from_bytes(bytes(raw)) is None
    assert port_di.parse_endpoints("s0=127.0.0.1:1,s1=http://h:2") == \
        ref_di.parse_endpoints("s0=127.0.0.1:1,s1=http://h:2")


def test_clients_and_servers_across_packages(tmp_path):
    """JAX client -> port nodes and port client -> JAX nodes give the
    answers of JAX client -> JAX nodes; the nodes' /persist snapshots and
    segments are byte-identical to the JAX nodes'."""
    digs = _digests(6_000, seed=2)
    fresh = _digests(1_000, seed=3)
    sids = ["s0", "s1"]
    nodes = {pkg: [_node(pkg, s, tmp_path) for s in sids]
             for pkg in ("ref", "port")}
    answers = {}
    try:
        for cli_mod, srv_pkg in ((ref_di, "ref"), (ref_di, "port"),
                                 (port_di, "ref")):
            if (cli_mod, srv_pkg) == (port_di, "ref"):
                # fresh JAX nodes for the port's client
                for n in nodes["ref"]:
                    n.stop()
                nodes["ref"] = [_node("ref", s + "b", tmp_path) for s in sids]
            eps = [(n.shard_id, n.endpoint) for n in nodes[srv_pkg]]
            m = cli_mod.ShardMap(eps, epoch=1)
            for n in nodes[srv_pkg]:
                n.install_map(m)
            cli = cli_mod.DistIndexClient(m, token="t0k")
            out = [cli.insert_many(digs[i:i + 1_024])
                   for i in range(0, len(digs), 1_024)]
            w0 = cli_mod.METRICS.snapshot()
            batches = 0
            for i in range(0, 4_000, 1_024):
                batch = digs[i:i + 512] + fresh[i // 4:i // 4 + 512]
                out.append(cli.probe_batch(batch + batch[:8]))   # repeats
                batches += 1
            w1 = cli_mod.METRICS.snapshot()
            assert w1["wire_requests"] - w0["wire_requests"] <= \
                len(sids) * batches
            with fswitness.watching() as w:
                acks = cli.discard_many_acked(digs[:300])
            assert w.saw("index.discard") == (cli_mod is port_di)
            out += [acks, cli.probe_batch(digs[:600]), len(cli)]
            out.append(sorted(cli.digests()) == sorted(digs[300:]))
            cli.save_snapshot(str(tmp_path / f"client-{srv_pkg}"))
            cli.close()
            answers[(cli_mod.__name__, srv_pkg)] = out
        first, *rest = answers.values()
        for got in rest:
            assert got == first
        assert first[-1] is True
        # the JAX nodes (first pair) and the port nodes persisted the same
        for s in sids:
            a = (tmp_path / f"snap-ref-{s}").read_bytes()
            b = (tmp_path / f"snap-port-{s}").read_bytes()
            assert a == b and a[:4] == b"TPXM"
            segs = sorted(os.listdir(tmp_path / f"spill-ref-{s}" / "segments"))
            assert segs == sorted(os.listdir(
                tmp_path / f"spill-port-{s}" / "segments"))
            for name in segs:
                assert (tmp_path / f"spill-ref-{s}" / "segments" / name
                        ).read_bytes() == (tmp_path / f"spill-port-{s}"
                                           / "segments" / name).read_bytes()
    finally:
        for ns in nodes.values():
            for n in ns:
                n.stop()


def test_rebalance_mixed_cluster_one_owner(tmp_path):
    """The port's client grows a two-node port cluster by a JAX node:
    the port's nodes ship their segments to the JAX node, and every
    digest ends on exactly its new owner."""
    nodes = [_node("port", "s0", tmp_path), _node("port", "s1", tmp_path)]
    try:
        m = port_di.ShardMap([(n.shard_id, n.endpoint) for n in nodes], epoch=1)
        for n in nodes:
            n.install_map(m)
        cli = port_di.DistIndexClient(m, token="t0k")
        digs = _digests(3_000, seed=4)
        assert cli.insert_many(digs) == len(digs)
        nodes.append(_node("ref", "s2", tmp_path))
        new_map = port_di.ShardMap([(n.shard_id, n.endpoint) for n in nodes],
                                   epoch=2)
        with fswitness.watching() as w:
            res = cli.rebalance(new_map)
        w.assert_clean()
        assert w.saw("map.install") and w.saw("shard.retire")
        assert res["epoch"] == 2 and res["segments_shipped"] > 0
        holders = {}
        for si, n in enumerate(nodes):
            assert n.current_map().epoch == 2
            for d in n.index.digests():
                assert d not in holders, "digest on two shards"
                holders[d] = si
        assert set(holders) == set(digs)
        assert all(new_map.owner_of(d) == si for d, si in holders.items())
        assert cli.probe_batch(digs) == [True] * len(digs)
        ref_cli = ref_di.DistIndexClient(
            endpoints=[(n.shard_id, n.endpoint) for n in nodes], token="t0k")
        assert ref_cli.shard_map.to_bytes() == new_map.to_bytes()
        assert ref_cli.probe_batch(digs[::7]) == [True] * len(digs[::7])
        ref_cli.close()
        cli.close()
    finally:
        for n in nodes:
            n.stop()


def test_index_shard_command_protocol(tmp_path):
    """``python -m pbs_plus_tpu_torch index-shard --device cpu``: the ready
    line, the wire, ``exit`` on stdin, the snapshot, and the exit line."""
    snap = tmp_path / "snap-s0"
    err_path = tmp_path / "stderr.txt"
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pbs_plus_tpu_torch", "index-shard",
             "--shard-id", "s0", "--port", "0", "--token", "k",
             "--spill-dir", str(tmp_path / "spill"), "--budget-mb", "1",
             "--resident-mb", "1", "--snapshot", str(snap), "--device", "cpu"],
            cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    # every stdout line goes through a queue, so no read below can block
    # past its timeout
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        try:
            first = lines.get(timeout=60)
        except queue.Empty:
            raise AssertionError("no ready line in 60 s; stderr: "
                                 + err_path.read_text()) from None
        ready = json.loads(first)
        assert ready["event"] == "ready" and ready["device"] == "cpu"
        cli = ref_di.DistIndexClient(
            endpoints=[("s0", f"http://127.0.0.1:{ready['port']}")], token="k")
        digs = _digests(2_000, seed=5)
        assert cli.insert_many(digs) == len(digs)
        assert cli.probe_batch(digs[:10] + _digests(10, seed=6)) == \
            [True] * 10 + [False] * 10
        cli.close()
        proc.stdin.write(b"exit\n")
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0, err_path.read_text()
        reader.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    assert rest, "no exit line; stderr: " + err_path.read_text()
    exit_line = json.loads(rest[-1])
    assert exit_line == {"event": "exit", "shard": "s0", "device_probes": 0}
    # the node kept its snapshot; the JAX index boots from it
    idx = RefIndex(budget_mb=1, spill_dir=str(tmp_path / "spill"), resident_mb=1)
    assert idx.load_snapshot(str(snap))
    assert len(idx) == len(digs)
