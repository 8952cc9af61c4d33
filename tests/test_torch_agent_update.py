"""The port's agent registry, self-update and ``signer`` against the JAX
package's, and the agent's ``verify_start`` over aRPC.

- ``agent/registry.py``: the same operations give the same answers, a
  registry file written by either package reads back in the other, and
  ``open_registry`` on Windows returns each package's own
  ``agent/win/registry.WinRegistry``.
- ``signer``: keys made and artifacts signed by either package's command
  verify under the other's ``signer verify`` and ``verify_signature``,
  Ed25519 and ECDSA P-256 alike; a bad signature fails in both.
- ``agent/updater.py``: ``Updater``, ``BinSwap`` and ``Watchdog`` against
  a local HTTP release endpoint (aiohttp) leave the same files and answer
  the same, with ``time.time`` pinned.
- ``update_now`` over aRPC: a port and a JAX agent, each with self-update
  configured, connected over mTLS to a port server side, answer the
  server's pushed update the same way (swapped, then pending restart).
- ``verify_start``: the verification job's ``check_source_drift`` over
  mTLS against a port agent and a JAX agent, on a tree with one unchanged,
  one edited and one deleted file, reports the same two drifted files.
"""

import asyncio
import hashlib
import io
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.agent import registry as ref_reg
from pbs_plus_tpu.agent import updater as ref_up
from pbs_plus_tpu.chunker import ChunkerParams as RefParams
from pbs_plus_tpu.cli import main as ref_main
from pbs_plus_tpu.pxar.backupproxy import LocalStore as RefLocalStore
from pbs_plus_tpu.pxar.format import KIND_DIR, KIND_FILE, Entry
from pbs_plus_tpu_torch.__main__ import main as port_main
from pbs_plus_tpu_torch.agent import registry as port_reg
from pbs_plus_tpu_torch.agent import updater as port_up
from pbs_plus_tpu_torch.arpc import Session
from pbs_plus_tpu_torch.pxar.datastore import Datastore as PortDatastore
from pbs_plus_tpu_torch.pxar.transfer import SplitReader
from pbs_plus_tpu_torch.server import verification_job as port_vj

from test_torch_backup_job import PORT, REF, Side, pki  # noqa: F401

T0 = 1_700_000_000.0
PKGS = {"ref": (ref_reg, ref_up, ref_main), "port": (port_reg, port_up,
                                                     port_main)}


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)


# -- the registry ----------------------------------------------------------------

def _registry_ops(reg_mod, base):
    r = reg_mod.Registry(os.path.join(base, "agent.json"))
    out = []
    r.set("server", "pbs.example:8008")
    r.set("port", 8008)
    r.set_secret("bootstrap_token", b"s3cret")
    out.append(r.get("server"))
    out.append(r.get("port"))
    out.append(r.get("missing", "dflt"))
    out.append(r.get_secret("bootstrap_token"))
    out.append(r.get_secret("nope"))
    for bad in (lambda: r.get("bootstrap_token"),
                lambda: r.get_secret("server")):
        with pytest.raises(ValueError) as e:
            bad()
        out.append(str(e.value))
    out.append(r.seed_from_env(environ={
        "PBS_PLUS_INIT_SERVER": "ignored", "PBS_PLUS_INIT_HOSTNAME": "h1",
        "PBS_PLUS_INIT_API_TOKEN": "t0k", "PBS_PLUS_INIT_X_SECRET": "x",
        "OTHER": "y"}))
    out.append(r.get_secret("api_token"))
    out.append(r.get_secret("x_secret"))
    r.delete("port")
    r.delete("never")
    out.append(r.keys())
    return out


def test_registry_answers_as_reference(tmp_path):
    got = _registry_ops(port_reg, str(tmp_path / "port"))
    want = _registry_ops(ref_reg, str(tmp_path / "ref"))
    assert got == want
    assert got[3] == b"s3cret" and got[7] == 3
    pem = " -----BEGIN X-----\r\n  abc \n\n-----END X-----  "
    assert port_reg.normalize_pem(pem) == ref_reg.normalize_pem(pem) == \
        b"-----BEGIN X-----\nabc\n-----END X-----\n"
    assert port_reg.normalize_pem(pem.encode()) == ref_reg.normalize_pem(pem)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_registry_file_reads_back_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "agent.json")
    w = PKGS[writer][0].open_registry(path)
    w.set("hostname", "h7")
    w.set_secret("token", b"tok-bytes")
    r = PKGS[reader][0].open_registry(path)
    assert r.get("hostname") == "h7"
    assert r.get_secret("token") == b"tok-bytes"
    assert r.keys() == ["hostname", "token"]
    with open(path, "w") as f:
        f.write("{not json")
    for mod in (port_reg, ref_reg):
        with pytest.raises(ValueError, match="corrupt registry"):
            mod.Registry(path).get("hostname")


def test_open_registry_on_windows_names_the_unported_module(monkeypatch,
                                                            tmp_path):
    """Since the port has ``agent/win/``, ``open_registry`` on Windows
    returns its own ``WinRegistry``, as the reference returns its own
    (winreg stubbed: this host has none)."""
    from pbs_plus_tpu.agent.win import registry as ref_win
    from pbs_plus_tpu_torch.agent.win import registry as port_win
    got = {}
    for mod, win in ((port_reg, port_win), (ref_reg, ref_win)):
        monkeypatch.setattr(win, "_real_winreg", lambda: "winreg")
        with monkeypatch.context() as m:
            m.setattr(mod.os, "name", "nt")
            r = mod.open_registry(str(tmp_path / "r.json"))
        assert type(r) is win.WinRegistry and r._reg == "winreg"
        got[mod] = (type(r).__module__, r._path)
    assert got[port_reg] == (
        "pbs_plus_tpu_torch.agent.win.registry", got[ref_reg][1])
    assert got[ref_reg][0] == "pbs_plus_tpu.agent.win.registry"


# -- signer ----------------------------------------------------------------------

def _ecdsa_key(path):
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    key = ec.generate_private_key(ec.SECP256R1())
    with open(path, "wb") as f:
        f.write(key.private_bytes(serialization.Encoding.PEM,
                                  serialization.PrivateFormat.PKCS8,
                                  serialization.NoEncryption()))
    with open(f"{path}.pub", "wb") as f:
        f.write(key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo))


@pytest.mark.parametrize("key", ["ed25519", "ecdsa"])
@pytest.mark.parametrize("signer,checker", [("ref", "port"), ("port", "ref")])
def test_signer_signatures_verify_across_packages(tmp_path, capsys, key,
                                                  signer, checker):
    k = str(tmp_path / "release.pem")
    art = tmp_path / "agent.pyz"
    art.write_bytes(np.random.default_rng(4).bytes(50_000))
    sign_main, check_main = PKGS[signer][2], PKGS[checker][2]
    if key == "ed25519":
        assert sign_main(["signer", "keygen", "--key", k]) == 0
    else:
        _ecdsa_key(k)
    assert sign_main(["signer", "sign", "--key", k, "--file", str(art)]) == 0
    sig = (tmp_path / "agent.pyz.sig").read_bytes()
    pub = open(f"{k}.pub", "rb").read()
    capsys.readouterr()
    assert check_main(["signer", "verify", "--key", f"{k}.pub",
                       "--file", str(art)]) == 0
    assert capsys.readouterr().out.strip() == "OK"
    data = art.read_bytes()
    for up in (port_up, ref_up):
        assert up.verify_signature(data, sig, pub) is True
        assert up.verify_signature(data + b"x", sig, pub) is False
        assert up.verify_signature(data, sig, b"not a key") is False
    (tmp_path / "bad.sig").write_bytes(bytes(len(sig)))
    for m in (port_main, ref_main):
        assert m(["signer", "verify", "--key", f"{k}.pub", "--file",
                  str(art), "--sig", str(tmp_path / "bad.sig")]) == 1
        assert capsys.readouterr().out.strip() == "BAD SIGNATURE"
        assert m(["signer", "sign", "--key", k]) == 2
        assert capsys.readouterr().out.strip() == \
            "signer sign requires --file"


def test_signer_keygen_writes_the_reference_files(tmp_path, capsys):
    for name, m in (("ref", ref_main), ("port", port_main)):
        k = str(tmp_path / f"{name}.pem")
        assert m(["signer", "keygen", "--key", k]) == 0
        assert oct(os.stat(k).st_mode & 0o777) == "0o600"
        assert open(f"{k}.pub", "rb").read().startswith(
            b"-----BEGIN PUBLIC KEY-----")
    out = capsys.readouterr().out.splitlines()
    assert [line.replace(str(tmp_path), "") for line in out] == [
        "wrote /ref.pem and /ref.pem.pub", "wrote /port.pem and /port.pem.pub"]


# -- the updater against a release endpoint --------------------------------------

def _release(tmp_path, version="v2", payload=None):
    """A signing key and a release: (public PEM, binary, version info)."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ed25519
    key = ed25519.Ed25519PrivateKey.generate()
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    binary = payload or (b"#!/usr/bin/env python3\n# agent " +
                         version.encode() + b"\n") * 64
    info = {"version": version, "signature": key.sign(binary).hex()}
    return pub, binary, info


async def _serve_release(info, binary):
    from aiohttp import web
    app = web.Application()
    state = {"info": info, "binary": binary}

    async def version(request):
        return web.json_response(state["info"])

    async def blob(request):
        return web.Response(body=state["binary"])
    app.router.add_get("/plus/agent/version", version)
    app.router.add_get("/plus/agent/binary", blob)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}", state


def _files(d):
    """The regular files directly in ``d``, by name."""
    out = {}
    for n in sorted(os.listdir(d)):
        if os.path.isfile(os.path.join(d, n)):
            with open(os.path.join(d, n), "rb") as f:
                out[n] = f.read()
    return out


def _update_cycle(up, base, pub, binary, info, *, tamper=False):
    """Check, stage, swap, boot three times, against one release."""
    os.makedirs(base)
    live = os.path.join(base, "agent.pyz")
    with open(live, "wb") as f:
        f.write(b"old agent\n")
    swap = up.BinSwap(up.SwapState(live, os.path.join(base, "state")))
    out = []

    async def check(current):
        import aiohttp
        runner, url, state = await _serve_release(
            info, binary + (b"!" if tamper else b""))
        try:
            async with aiohttp.ClientSession() as http:
                return await up.Updater(
                    swap, current_version=current,
                    signing_pubkey_pem=pub).check_and_stage(http, url)
        finally:
            await runner.cleanup()
    out.append(asyncio.run(check(info["version"])))       # up to date
    out.append(asyncio.run(check("v1")))
    out.append(_files(os.path.join(base, "state")))
    if out[-2] is None:
        return out
    swap.swap()
    out.append((_files(base), _files(os.path.join(base, "state"))))
    wd = up.Watchdog(swap, grace_s=60.0)
    out.append([wd.on_boot() for _ in range(3)])
    out.append((_files(base), _files(os.path.join(base, "state"))))
    return out


@pytest.mark.parametrize("tamper", [False, True], ids=["signed", "tampered"])
def test_updater_stages_swaps_and_rolls_back_as_reference(tmp_path, clock,
                                                          tamper):
    pub, binary, info = _release(tmp_path)
    got = _update_cycle(port_up, str(tmp_path / "port"), pub, binary, info,
                        tamper=tamper)
    want = _update_cycle(ref_up, str(tmp_path / "ref"), pub, binary, info,
                         tamper=tamper)
    assert got == want
    assert got[0] is None
    if tamper:
        assert got[1] is None and got[2] == {}
        return
    assert got[1] == "v2"
    assert got[2]["staged.bin"] == binary
    assert json.loads(got[2]["pending-update.json"])["state"] == "staged"
    live, state = got[3]
    assert live["agent.pyz"] == binary
    assert state["previous.bin"] == b"old agent\n"
    # a crash-looping new binary: two boots in grace, the third rolls back
    assert got[4] == ["grace", "grace", "rolled-back"]
    assert got[5][0]["agent.pyz"] == b"old agent\n"


def test_watchdog_commits_a_healthy_boot_as_reference(tmp_path, clock):
    out = {}
    for name, up in (("ref", ref_up), ("port", port_up)):
        d = tmp_path / name
        d.mkdir()
        (d / "agent.pyz").write_bytes(b"old")
        swap = up.BinSwap(up.SwapState(str(d / "agent.pyz"), str(d / "st")))
        swap.stage(b"new", "v9")
        swap.swap()
        wd = up.Watchdog(swap, grace_s=5.0)
        seen = [wd.on_boot()]
        wd.mark_healthy()
        seen.append(wd.on_boot())
        seen.append(swap.rollback())
        out[name] = (seen, _files(str(d)), _files(str(d / "st")))
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["grace", "no-pending", False]
    assert out["port"][2] == {}


# -- over aRPC: update_now and verify_start --------------------------------------

async def _agent(side, pkg, host, **cfg):
    """A ``pkg`` agent for ``host`` on ``side`` (mTLS), with ``cfg``."""
    tls = pkg.arpc.TlsClientConfig(*side.pki.agents[host], side.pki.ca)
    lc = pkg.lc.AgentLifecycle(
        pkg.lc.AgentConfig(hostname=host, server_host="127.0.0.1",
                           server_port=side.port, tls=tls,
                           drive_update_interval_s=0, **cfg),
        snapshot_manager=pkg.snaps.SnapshotManager(prefer_direct=True))
    task = asyncio.ensure_future(lc.run())
    side.lifecycles.append((lc, task))
    await side.agents.wait_session(host, timeout=300)
    return lc


def _update_over_arpc(tmp_path, pki, agent_pkg, pub, binary, info):
    base = tmp_path / agent_pkg.name
    base.mkdir()
    live = base / "agent.pyz"
    live.write_bytes(b"old agent\n")

    async def main():
        runner, url, _ = await _serve_release(info, binary)
        side = await Side(PORT, str(base / "server"), pki).start()
        try:
            await _agent(side, agent_pkg, "h0", update_base_url=url,
                         update_binary_path=str(live),
                         update_state_dir=str(base / "st"),
                         update_signer_pub=pub, update_interval_s=0)
            sess = Session(side.agents.get("h0").conn)
            answers = [(await sess.call("update_now", {}, timeout=300)).data
                       for _ in range(2)]
        finally:
            await side.close()
            await runner.cleanup()
        return answers, _files(str(base)), _files(str(base / "st"))
    return asyncio.run(main())


def test_update_now_over_arpc_answers_as_reference(tmp_path, pki, clock):
    pub, binary, info = _release(tmp_path)
    got = _update_over_arpc(tmp_path, pki, PORT, pub, binary, info)
    want = _update_over_arpc(tmp_path, pki, REF, pub, binary, info)
    assert got == want
    (first, second), live, state = got
    assert first == {"updated": True, "version": "v2",
                     "message": "staged + swapped; effective on restart"}
    assert second["updated"] is False
    assert second["message"] == "update pending restart; not re-swapping"
    assert second["version"] == hashlib.sha256(binary).hexdigest()[:16]
    assert live["agent.pyz"] == binary and \
        state["previous.bin"] == b"old agent\n"


def test_update_now_unconfigured_answers_as_reference(tmp_path, pki):
    async def main(pkg):
        side = await Side(PORT, str(tmp_path / pkg.name), pki).start()
        try:
            await _agent(side, pkg, "h0")
            sess = Session(side.agents.get("h0").conn)
            return (await sess.call("update_now", {}, timeout=300)).data
        finally:
            await side.close()
    got, want = asyncio.run(main(PORT)), asyncio.run(main(REF))
    assert got == want == {"updated": False,
                           "message": "updates not configured"}


def test_check_source_drift_against_port_and_jax_agents(tmp_path, pki):
    """A fault of the port's agent, repaired: it answered ``verify_start``
    with 501, which ``check_source_drift`` counts as drift, so every
    sampled file read as unreadable.  Against either package's
    agent over mTLS, only the edited and the deleted file drift."""
    src = tmp_path / "src"
    src.mkdir()
    files = {"ok.bin": b"o" * 3000, "changed.bin": b"c" * 2000,
             "gone.bin": b"g" * 1000}
    for name, data in files.items():
        (src / name).write_bytes(data)
    st = RefLocalStore(str(tmp_path / "ds"), RefParams(avg_size=1024),
                       dedup_index_mb=1)
    sess = st.start_session(backup_type="host", backup_id="h0",
                            backup_time=T0)
    sess.writer.write_entry(Entry(path="", kind=KIND_DIR, mode=0o40755))
    for name, data in sorted(files.items()):
        sess.writer.write_entry_reader(
            Entry(path=name, kind=KIND_FILE, size=len(data)),
            io.BytesIO(data))
    sess.finish()
    (src / "changed.bin").write_bytes(b"edited")
    (src / "gone.bin").unlink()
    ds = PortDatastore(str(tmp_path / "ds"), device="cpu")
    ref = ds.list_snapshots()[0]

    async def drift(agent_pkg):
        side = await Side(PORT, str(tmp_path / f"srv-{agent_pkg.name}"),
                          pki).start()
        try:
            side.job("h0", str(src))
            await _agent(side, agent_pkg, "h0")
            server = SimpleNamespace(db=side.db, agents=side.agents)
            return await port_vj.check_source_drift(
                server, ref, SplitReader.open_snapshot(ds, ref),
                rng=np.random.default_rng(5))
        finally:
            await side.close()
    want = {"sampled": 3, "drifted": ["changed.bin",
                                      "gone.bin (unreadable on agent)"]}
    assert asyncio.run(drift(REF)) == want
    assert asyncio.run(drift(PORT)) == want
