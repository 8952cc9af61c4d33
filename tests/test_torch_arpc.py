"""The port's aRPC fabric, agent and server utilities against the JAX
package's.

Admission verdicts of ``AgentsManager`` (codes, reasons, kinds and the
cumulative counters) for every reject the manager has, in process and
over the wire through ``serve``/``connect_to_server``; the agentfs
protocol (``AgentFSServer``/``AgentFSClient``) served and called across
packages over plain loopback; the agent's control handlers; the failpoint
engine's actions and triggers; the circuit breaker and retry; sealed
secrets and certificates; the database (either package opens a file the
other wrote); the snapshot handlers' command protocol.  Tolerance is
exact.
"""

import asyncio
import hashlib
import os
import re
import sqlite3

import numpy as np
import pytest

from pbs_plus_tpu import arpc as ref_arpc
from pbs_plus_tpu.agent import agentfs as ref_afs
from pbs_plus_tpu.agent import drives as ref_drives
from pbs_plus_tpu.agent import lifecycle as ref_lc
from pbs_plus_tpu.agent import snapshots as ref_snaps
from pbs_plus_tpu.arpc import agents_manager as ref_am
from pbs_plus_tpu.arpc import transport as ref_tr
from pbs_plus_tpu.server import database as ref_db
from pbs_plus_tpu.utils import crypto as ref_crypto
from pbs_plus_tpu.utils import failpoints as ref_fp
from pbs_plus_tpu.utils import mtls as ref_mtls
from pbs_plus_tpu.utils import resilience as ref_res
from pbs_plus_tpu_torch import arpc as port_arpc
from pbs_plus_tpu_torch.agent import agentfs as port_afs
from pbs_plus_tpu_torch.agent import drives as port_drives
from pbs_plus_tpu_torch.agent import lifecycle as port_lc
from pbs_plus_tpu_torch.agent import snapshots as port_snaps
from pbs_plus_tpu_torch.arpc import agents_manager as port_am
from pbs_plus_tpu_torch.arpc import transport as port_tr
from pbs_plus_tpu_torch.server import database as port_db
from pbs_plus_tpu_torch.utils import crypto as port_crypto
from pbs_plus_tpu_torch.utils import failpoints as port_fp
from pbs_plus_tpu_torch.utils import mtls as port_mtls
from pbs_plus_tpu_torch.utils import resilience as port_res

@pytest.fixture(autouse=True)
def _disarmed():
    for fp in (ref_fp, port_fp):
        fp.disarm_all()
    yield
    for fp in (ref_fp, port_fp):
        fp.disarm_all()


# -- admission ----------------------------------------------------------------

async def _verdicts(mod, am, steps):
    """Each admit of ``steps`` as "ok" or (code, reason, kind)."""
    out = []
    for cn, headers in steps:
        try:
            await am.admit({"cn": cn}, headers)
            out.append("ok")
        except mod.AdmissionRejected as e:
            out.append((e.code, e.reason, e.kind))
    return out


def _admission_cases(mod):
    bid = {mod.HDR_BACKUP_ID: "j1"}

    async def deny(cn, der):
        return cn != "stranger"

    def mk(**kw):
        return mod.AgentsManager(**{"rate": 0, "max_sessions": 0,
                                    "open_rate": 0,
                                    "admission_deadline_ms": 0, **kw})

    async def run():
        out = {}
        am = mk(is_expected=deny)
        out["identity"] = await _verdicts(mod, am, [
            ("", {}), ("h", bid), ("stranger", {}), ("h", {})])
        am.expect("h|j1")
        out["expected_job"] = await _verdicts(mod, am, [("h", bid)])
        am.unexpect("h|j1")
        out["unexpected_again"] = await _verdicts(mod, am, [("h", bid)])
        out["identity_stats"] = am.admission_stats()
        # rates low enough that no token refills within the test
        am = mk(rate=0.001, burst=2)
        out["client_rate"] = await _verdicts(mod, am, [("h", {})] * 3
                                             + [("g", {})])
        am = mk(open_rate=0.001)
        out["open_rate"] = await _verdicts(mod, am, [("h", {})] * 2)
        am = mk(max_sessions=1)
        out["ceiling"] = await _verdicts(mod, am, [("h", {}), ("g", {})])
        am = mk(max_sessions=1, admission_deadline_ms=30)
        out["deadline"] = await _verdicts(mod, am, [("h", {}), ("g", {})])
        out["deadline_waits"] = am.admission_waits
        am = mk(max_sessions=1, admission_deadline_ms=30, admit_queue_cap=0)
        out["queue_full"] = await _verdicts(mod, am, [("h", {}), ("g", {})])
        out["stats"] = am.admission_stats()
        out["client_ids"] = [mod.client_id_from("h", h) for h in (
            {}, bid, {mod.HDR_RESTORE_ID: "r"}, {mod.HDR_VERIFY_ID: "v"})]
        return out
    return asyncio.run(run())


def test_admission_verdicts_match_reference():
    ref, port = _admission_cases(ref_am), _admission_cases(port_am)
    assert ref == port
    assert port["identity"] == [
        (403, "client certificate has no CN", "no_cn"),
        (403, "unexpected job session 'h|j1'", "unexpected_job_session"),
        (403, "host not expected", "host_not_expected"), "ok"]
    assert port["client_rate"][2] == (429, "rate limited", "client_rate")
    assert port["open_rate"] == ["ok", (429, "session open rate limited",
                                        "open_rate")]
    assert port["ceiling"][1][0] == 503 and port["deadline"][1][2] == \
        "admission_deadline" and port["queue_full"][1][2] == \
        "admission_queue_full"


@pytest.mark.parametrize("server,client", [(port_arpc, ref_arpc),
                                           (ref_arpc, port_arpc)],
                         ids=["port-server", "ref-server"])
def test_handshake_rejection_codes_cross_the_wire(server, client):
    """A rejected handshake reaches either package's client as the same
    ``HandshakeError``; an accepted one serves calls across packages."""
    async def main():
        am = server.AgentsManager(rate=0, max_sessions=0, open_rate=0,
                                  admission_deadline_ms=0)

        async def on_connection(conn, peer, headers):
            sess = await am.register(peer, headers, conn)
            router = server.Router()
            router.handle("echo", lambda req, ctx: {"cn": ctx.cn,
                                                    "x": req.payload})
            try:
                await router.serve_connection(conn, context=sess)
            finally:
                await am.unregister(sess)

        lis = await server.serve("127.0.0.1", 0, None,
                                 on_connection=on_connection, admit=am.admit)
        port = lis.sockets[0].getsockname()[1]
        tr = ref_tr if client is ref_arpc else port_tr
        out = []
        for headers in ({}, {tr.HDR_LOOPBACK_CN: "h",
                             "X-PBS-Plus-BackupID": "nope"}):
            try:
                await client.connect_to_server("127.0.0.1", port, None,
                                               headers=headers)
            except tr.HandshakeError as e:
                out.append((e.code, e.reason, str(e)))
        conn = await client.connect_to_server(
            "127.0.0.1", port, None, headers={tr.HDR_LOOPBACK_CN: "h"})
        r = await client.Session(conn).call("echo", {"a": b"\x00\x01"})
        out.append(r.data)
        try:
            await client.Session(conn).call("nope")
        except Exception as e:
            out.append(str(e))
        await conn.close()
        lis.close()
        await lis.wait_closed()
        return out, am.admission_stats()
    out, stats = asyncio.run(main())
    assert out == [
        (403, "client certificate has no CN",
         "handshake rejected (403): client certificate has no CN"),
        (403, "unexpected job session 'h|nope'",
         "handshake rejected (403): unexpected job session 'h|nope'"),
        {"cn": "h", "x": {"a": b"\x00\x01"}},
        "rpc failed (404): unknown method 'nope'"]
    assert stats == {"admitted": 1, "no_cn": 1, "unexpected_job_session": 1}


# -- agentfs ------------------------------------------------------------------

def _tree(root):
    rng = np.random.default_rng(3)
    os.makedirs(root / "d" / "e")
    for i in range(7):
        (root / "d" / f"n{i}").write_bytes(
            rng.integers(0, 256, 100 + 37 * i, np.uint8).tobytes())
    (root / "big").write_bytes(rng.integers(0, 256, 70_000,
                                            np.uint8).tobytes())
    os.symlink("d/n1", root / "ln")
    os.symlink("/etc", root / "out")
    os.setxattr(root / "d" / "n2", "user.k", b"v")
    os.mkfifo(root / "fifo")
    return root


async def _fs_calls(client, FSClient):
    fs = FSClient(client)
    out = {}

    async def grab(name, coro):
        try:
            out[name] = await coro
        except Exception as e:
            out[name] = f"{type(e).__name__}: {e}"

    await grab("attr_root", fs.attr(""))
    await grab("attr_ln", fs.attr("ln"))
    await grab("ls", fs.read_dir(""))
    await grab("ls_d", fs.read_dir("d"))
    d = await fs.s.call("agentfs.read_dir", {"path": "d", "max": 3})
    out["page"] = d.data
    d = await fs.s.call("agentfs.read_dir", {"path": "d", "max": 0,
                                             "start": "n3"})
    out["page_after"] = d.data
    await grab("link", fs.read_link("ln"))
    await grab("xattrs", fs.xattrs("d/n2"))
    await grab("escape", fs.read_dir("out"))
    await grab("dotdot", fs.attr("../x"))
    await grab("open_dir", fs.open("d"))
    await grab("open_fifo", fs.open("fifo"))
    await grab("open_out", fs.open("out/hostname"))
    await grab("missing", fs.attr("nope"))
    h = await fs.open("big")
    out["handle"] = h
    out["read"] = hashlib.sha256(await fs.read_at(h, 1000, 50_000)).hexdigest()
    out["read_tail"] = await fs.read_at(h, 69_990, 100)
    out["lseek"] = (await fs.s.call("agentfs.lseek",
                                    {"handle": h, "off": 5,
                                     "whence": 2})).data
    await grab("too_big", fs.read_at(h, 0, (32 << 20) + 1))
    await fs.close(h)
    await grab("closed", fs.read_at(h, 0, 10))
    st = await fs.stat_fs()
    out["stat_fs_keys"] = sorted(st)
    return out


@pytest.mark.parametrize("server,client", [(port_arpc, ref_arpc),
                                           (ref_arpc, port_arpc),
                                           (port_arpc, port_arpc)],
                         ids=["port-server", "ref-server", "port-both"])
def test_agentfs_answers_match_reference(tmp_path, server, client):
    root = _tree(tmp_path / "t")

    async def serve_with(afs_mod, srv, cli):
        fs = afs_mod.AgentFSServer(str(root))
        router = srv.Router()
        fs.register(router)

        async def on_connection(conn, peer, headers):
            await router.serve_connection(conn)

        lis = await srv.serve("127.0.0.1", 0, None,
                              on_connection=on_connection)
        port = lis.sockets[0].getsockname()[1]
        tr = ref_tr if cli is ref_arpc else port_tr
        conn = await cli.connect_to_server(
            "127.0.0.1", port, None, headers={tr.HDR_LOOPBACK_CN: "h"})
        fs_cli = (ref_afs if cli is ref_arpc else port_afs).AgentFSClient
        try:
            return await _fs_calls(cli.Session(conn), fs_cli), fs.stats
        finally:
            await conn.close()
            fs.close_all()
            lis.close()
            await lis.wait_closed()

    afs = port_afs if server is port_arpc else ref_afs
    want, want_stats = asyncio.run(serve_with(ref_afs, ref_arpc, ref_arpc))
    got, stats = asyncio.run(serve_with(afs, server, client))
    assert got == want and stats == want_stats
    assert got["escape"].endswith("symlink escapes root: 'out'")
    assert [e["name"] for e in got["page"]["entries"]] == ["e", "n0", "n1"]
    assert got["xattrs"] == {"user.k": b"v"}
    assert got["read_tail"] == (root / "big").read_bytes()[69_990:]


def test_entry_map_matches_reference(tmp_path):
    root = _tree(tmp_path / "t")
    for p in ("", "d", "d/n3", "ln", "fifo"):
        st = os.lstat(root / p)
        assert port_afs._entry_map(p, st, "t") == ref_afs._entry_map(p, st,
                                                                     "t")


# -- the agent's control handlers --------------------------------------------

def test_agent_handlers_match_reference(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b.txt").write_text("x")

    async def calls(lc_mod):
        lc = lc_mod.AgentLifecycle(lc_mod.AgentConfig(
            hostname="h", server_host="127.0.0.1", server_port=1, tls=None,
            drive_update_interval_s=0))
        out = []
        for method, payload in (
                ("ping", {}), ("target_status", {"path": str(tmp_path)}),
                ("target_status", {"path": str(tmp_path / "nope")}),
                ("filetree", {"path": str(tmp_path)}),
                ("filetree", {"path": str(tmp_path / "nope")}),
                ("cleanup", {"job_id": "j"})):
            fn = lc.router._handlers[method]
            try:
                out.append(await fn(SimpleReq(payload), None))
            except Exception as e:
                out.append((type(e).__name__, str(e), getattr(e, "status",
                                                              None)))
        return out, sorted(lc.router.methods())

    ref, ref_methods = asyncio.run(calls(ref_lc))
    port, port_methods = asyncio.run(calls(port_lc))
    assert ref == port
    # every handler of the reference is served, self-update and the
    # source cross-check included
    assert port_methods == ref_methods == [
        "backup", "cleanup", "cleanup_restore", "drives", "filetree",
        "ping", "profile", "restore", "target_status", "update_now",
        "verify_start"]

    async def verify_and_update(lc_mod, **cfg):
        lc = lc_mod.AgentLifecycle(lc_mod.AgentConfig(
            hostname="h", server_host="x", server_port=1, tls=None, **cfg))
        out = []
        for method, payload in (
                ("verify_start", {"path": str(tmp_path / "b.txt")}),
                ("verify_start", {"path": str(tmp_path / "nope")}),
                ("verify_start", {"path": str(tmp_path / "a")}),
                ("update_now", {})):
            try:
                out.append(await lc.router._handlers[method](
                    SimpleReq(payload), None))
            except Exception as e:
                out.append((type(e).__name__, str(e),
                            getattr(e, "status", None)))
        return out
    got = asyncio.run(verify_and_update(port_lc))
    assert got == asyncio.run(verify_and_update(ref_lc))
    assert got[0] == {"sha256": hashlib.sha256(b"x").hexdigest()}
    assert got[1][0] == "HandlerError" and got[1][2] == 404
    assert got[3] == {"updated": False, "message": "updates not configured"}
    # configured self-update is taken at construction, as the reference's;
    # subprocess isolation without a certificate is refused
    cfg = {"update_base_url": "http://127.0.0.1:1",
           "update_binary_path": str(tmp_path / "agent.pyz"),
           "update_state_dir": str(tmp_path / "st"),
           "update_signer_pub": b"k", "update_interval_s": 0}
    port_lc.AgentLifecycle(port_lc.AgentConfig(
        hostname="h", server_host="x", server_port=1, tls=None, **cfg))
    with pytest.raises(ValueError, match="certificate"):
        port_lc.AgentLifecycle(port_lc.AgentConfig(
            hostname="h", server_host="x", server_port=1, tls=None,
            job_isolation="subprocess"))


class SimpleReq:
    def __init__(self, payload):
        self.payload = payload


def test_drives_match_reference():
    """The same volumes; free space is left out, since other writers move
    it between the two calls."""
    def volumes(vols):
        return [{k: v for k, v in d.items() if k != "free_bytes"}
                for d in vols]
    assert volumes(port_drives.enumerate_drives()) == \
        volumes(ref_drives.enumerate_drives())
    assert volumes(port_drives._from_proc_mounts()) == \
        volumes(ref_drives._from_proc_mounts())


def test_snapshot_handlers_run_the_reference_commands(tmp_path):
    """The LVM and freeze handlers issue the same commands (an injected
    ``run`` records them; nothing is executed), and the manager falls
    through a failing handler to the direct one as the JAX one does."""
    mounts = tmp_path / "mounts"
    mounts.write_text("/dev/vg0/data /srv ext4 rw 0 0\n/dev/sda1 / ext4 rw 0 0\n")

    class R:
        def __init__(self, out=""):
            self.stdout, self.returncode = out, 0

    def script(mod):
        log = []

        def run(cmd, **kw):
            log.append(list(cmd))
            if cmd[0] == "lvs":
                return R("  vg0 data\n")
            if cmd[0] == "mount":
                raise RuntimeError("mount failed")
            return R()
        which = lambda n: "/usr/sbin/" + n
        out = []
        lvm = mod.LvmHandler(run=run, which=which, mounts_path=str(mounts))
        fr = mod.FreezeHandler(run=run, which=which, mounts_path=str(mounts))
        out.append((lvm.available("ext4"), fr.available("xfs"),
                    mod.detect_fs("/srv/x", str(mounts))))
        for h in (lvm, fr):
            for path in ("/srv/x", "/x"):
                try:
                    s = h.create(path)
                    out.append((s.source_path, s.snapshot_path, s.method))
                    h.cleanup(s)
                except Exception as e:
                    out.append(str(e))
        mgr = mod.SnapshotManager(handlers=[lvm], mounts_path=str(mounts))
        s = mgr.create("/srv/x")
        out.append((s.snapshot_path, s.method))
        mgr.cleanup(s)
        # the snapshot names and mount dirs are random: masked
        return re.sub(r"pbs-plus-(snap-[0-9a-f]{8}|lvm-\w+)", "<name>",
                      repr((out, log)))

    ref, port = script(ref_snaps), script(port_snaps)
    assert ref == port
    assert "['lvcreate', '-s', '-n', '<name>', '-l', '10%ORIGIN', " \
        "'vg0/data']" in port
    assert "('/srv/x', 'direct')" in port


# -- failpoints, resilience ---------------------------------------------------

def _fp_script(fp):
    out = []
    fp.arm_from_spec("a.b=drop@nth=2;c.d=corrupt@after=1;"
                     "e.f=raise@p=0.5,seed=7;g.h=delay:0.001@once")
    for site, data in (("a.b", None), ("a.b", None), ("a.b", None),
                       ("c.d", b"xy"), ("c.d", b"xy"), ("c.d", b""),
                       *[("e.f", None)] * 8, ("g.h", 1), ("g.h", 2)):
        try:
            out.append(fp.hit(site, data))
        except Exception as e:
            out.append(type(e).__name__ + ": " + str(e))
    try:
        asyncio.run(fp.ahit("a.b"))
        out.append("async pass")
    except ConnectionResetError as e:
        out.append(str(e))
    snap = fp.snapshot()
    out.append((snap["armed"], {k: v for k, v in snap["counters"].items()
                                if k in ("a.b", "c.d", "e.f", "g.h")}))
    for bad in ("x", "x=bogus", "x=raise@nth=1,after=1", "x=raise@when=1"):
        try:
            fp.arm_from_spec(bad)
        except ValueError as e:
            out.append(str(e))
    with fp.armed("z.z", "raise", exc=KeyError("k")) as f:
        try:
            fp.hit("z.z")
        except KeyError as e:
            out.append((repr(e), f.fires, f.hits))
    return out


def test_failpoint_engine_matches_reference():
    ref, port = _fp_script(ref_fp), _fp_script(port_fp)
    assert ref == port
    assert port[1] == "ConnectionResetError: failpoint a.b: injected " \
                      "connection drop"
    assert port[3:6] == [b"xy", b"xx", b""]


def _res_script(mod):
    out = []
    br = mod.CircuitBreaker(failure_threshold=2, reset_timeout_s=60.0,
                            name="t")

    def boom():
        raise OSError("down")
    for _ in range(3):
        try:
            br.call_sync(boom)
        except Exception as e:
            out.append((type(e).__name__, str(e), br.state))
    br._opened_at -= 61.0          # the reset timeout has passed
    out.append(br.state)
    out.append(br.call_sync(lambda: "up"))
    out.append(br.state)
    calls = []

    async def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError(f"try {len(calls)}")
        return len(calls)
    out.append(asyncio.run(mod.with_retry(flaky, attempts=3,
                                          base_delay_s=0.001)))
    try:
        mod.retry_sync(boom, attempts=2, base_delay_s=0.001)
    except OSError as e:
        out.append(str(e))

    async def opened():
        raise mod.CircuitOpenError("open")
    n = []

    async def count():
        n.append(1)
        return await opened()
    try:
        asyncio.run(mod.with_retry(count, attempts=3, base_delay_s=0.001))
    except mod.CircuitOpenError:
        out.append(("never retried", len(n)))
    return out


def test_circuit_breaker_and_retry_match_reference():
    ref, port = _res_script(ref_res), _res_script(port_res)
    assert ref == port
    assert port[2][0] == "CircuitOpenError" and port[3] == "half-open"


# -- secrets, certificates, the database --------------------------------------

def test_sealed_secrets_and_certificates_cross_packages(tmp_path):
    key = port_crypto.load_or_create_key(str(tmp_path / "k" / "seal.key"))
    assert ref_crypto.load_or_create_key(str(tmp_path / "k" / "seal.key")) \
        == key
    for a, b in ((port_crypto, ref_crypto), (ref_crypto, port_crypto)):
        assert b.unseal(key, a.seal(key, b"secret", b"id"), b"id") == \
            b"secret"
    assert port_crypto.sha256_hex(b"x") == ref_crypto.sha256_hex(b"x")
    cm = port_mtls.CertManager(str(tmp_path / "certs"))
    cm.load_or_create_ca()
    cm.validate()
    cm.ensure_server_identity("srv")
    cert, _ = cm.issue("agent-7")
    assert ref_mtls.common_name(cert) == port_mtls.common_name(cert) == \
        "agent-7"
    assert not ref_mtls.needs_renewal(cert)
    ref_cm = ref_mtls.CertManager(str(tmp_path / "certs"))
    ref_cm.load_or_create_ca()
    assert ref_mtls.cert_fingerprint(ref_cm.ca_cert) == \
        port_mtls.cert_fingerprint(cm.ca_cert)
    assert ref_mtls.common_name(ref_cm.sign_csr(port_mtls.make_csr(
        port_mtls.generate_private_key(), "x"))) == "x"


def _fill(db_mod, path):
    db = db_mod.Database(path, seal_key=b"\x01" * 32)
    db.upsert_target("h", "agent", hostname="h")
    db.upsert_target("s", "s3", config={"bucket": "b"})
    db.upsert_backup_job(db_mod.BackupJobRow(
        id="j", target="h", source_path="/src", exclusions=["*.tmp"],
        pipeline_workers=2, namespace="a/b"))
    db.add_exclusion("*.bak")
    db.add_exclusion("cache/", job_id="j")
    db.put_token("t", b"s3cret")
    db.create_task("UPID:1", "j", "backup")
    db.record_backup_result("j", db_mod.STATUS_SUCCESS,
                            snapshot="host/h/x")
    db.close()


def _dump(db_mod, path):
    db = db_mod.Database(path, seal_key=b"\x01" * 32)
    row = db.get_backup_job("j")
    out = (vars(row), db.get_target("s"), db.list_exclusions("j"),
           db.check_token("t", b"s3cret"), db.check_token("t", b"no"),
           db.list_running_tasks()[0]["upid"], sorted(db.list_targets(),
                                                     key=lambda t: t["name"]))
    db.close()
    return out


def test_database_files_open_in_either_package(tmp_path):
    for writer, reader in ((ref_db, port_db), (port_db, ref_db)):
        p = str(tmp_path / f"{writer.__name__}.db")
        _fill(writer, p)
        got = _dump(reader, p)
        want = _dump(writer, p)
        for g, w in zip(got, want):
            if isinstance(g, dict) and "last_run_at" in g:
                assert {k: v for k, v in g.items() if k != "last_run_at"} == \
                    {k: v for k, v in w.items() if k != "last_run_at"}
            else:
                assert g == w
    schema = lambda p: sorted(sqlite3.connect(p).execute(
        "SELECT type, name, sql FROM sqlite_master").fetchall(),
        key=lambda r: r[1])
    assert schema(str(tmp_path / f"{ref_db.__name__}.db")) == \
        schema(str(tmp_path / f"{port_db.__name__}.db"))
    assert port_db.STATUS_ERROR == "error" and port_db.should_retry("error")
