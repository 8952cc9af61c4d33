"""The port's web API and its ``server``/``agent`` commands against the
JAX package's.

``server/web.py`` of ``pbs_plus_tpu_torch`` is held against the JAX
package's route by route: each package's whole ``Server`` (the JAX one
with its ``"tpu"`` chunker kind, on the CPU here, the port's with ``device="cpu"``; both
at a 64 KiB average chunk) serves its own ``build_app`` through
``start_web``, one agent of the same package enrols over ``POST
/plus/agent/bootstrap``, and the same requests go to both over HTTP: job,
target, exclusion, script, token and alert CRUD, a backup run and its
task, the snapshot listing, a restore to disk, a verification run and its
results and exports, the snapshot zip and tree, the live agent's tree
and drives, target status, push-update, prune, mounts, the debug routes,
the install scripts and the agent bundle.  Status codes and JSON bodies
compare exactly after normalisation: token ids, restore ids and UPIDs
read as placeholders, Unix times as ``<t>``, each server's directory as
``<base>``, and the job's chunker kind as ``<chunker>``.  Routes whose
answer is the run's own (the debug dumps, the profile, the CA and key
material in the install scripts and the release signature) compare
their status, content type and shape.  ``/plus/metrics``
compares under the rules of ``test_torch_server``'s render test, and the
``snapshot-zip`` bytes are identical (the tree's mtimes are pinned).

Each package's server runs in an interpreter of its own, since the
render's counters, the shared chunk cache and the bundle's release cache
are process-wide.  Snapshot times are pinned (the stores' clock).

The command test starts ``python -m pbs_plus_tpu_torch server --device
cpu --print-token`` and an ``agent`` process with its default
``subprocess`` job isolation: the agent enrols over HTTP, its control
session registers, and a backup queued over HTTP runs in an
``agent-job`` child.  ``server --device cuda`` exits nonzero without a
card, naming CUDA, and ``signer`` mints a key pair, signs and verifies
an artifact as the JAX package's command does.
"""

import asyncio
import hashlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
import zipfile
from types import SimpleNamespace

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
T0 = 1_700_000_000
CHUNK_AVG = 64 << 10


def _pkg(name):
    root = "pbs_plus_tpu" if name == "ref" else "pbs_plus_tpu_torch"
    mods = {m: importlib.import_module(f"{root}.{p}") for m, p in (
        ("store", "server.store"), ("web", "server.web"),
        ("db", "server.database"), ("lc", "agent.lifecycle"),
        ("snaps", "agent.snapshots"), ("arpc", "arpc"),
        ("mtls", "utils.mtls"), ("bp", "pxar.backupproxy"),
        ("nf", "server.notifications"), ("tpl", "server.notify_templates"))}
    return SimpleNamespace(
        name=name, **mods,
        config_kw={"chunker": "tpu"} if name == "ref" else {},
        server_kw={} if name == "ref" else {"device": "cpu"})


class _Clock:
    """The stores' ``time``: ``time()`` pinned (snapshots of one second
    bump by +1 s), the rest real."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(T0)


async def _wait(fn, what, timeout=300.0):
    t_end = time.monotonic() + timeout
    while True:
        v = await fn()
        if v:
            return v
        if time.monotonic() > t_end:
            raise TimeoutError(what)
        await asyncio.sleep(0.05)


async def _drive_server(pkg, base, src):
    import aiohttp

    server = pkg.store.Server(pkg.store.ServerConfig(
        state_dir=os.path.join(base, "state"),
        cert_dir=os.path.join(base, "certs"),
        datastore_dir=os.path.join(base, "ds"), chunk_avg=CHUNK_AVG,
        dedup_index_mb=1, **pkg.config_kw), **pkg.server_kw)
    spool = os.path.join(base, "state", "notify-spool")
    server.notifications = pkg.nf.BatchTracker(
        sink=pkg.nf.file_spool_sink(spool), window_s=0.05,
        templates=pkg.tpl.TemplateSet())
    await server.start()
    server.scheduler.tick_s = 3600.0
    runner, port = await pkg.web.start_web(server, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{port}"
    aid, asecret = server.issue_api_token()
    auth = {"Authorization": f"Bearer {aid}:{asecret.hex()}"}
    ids = [aid]
    rec = {}
    agent = agent_task = None

    async with aiohttp.ClientSession() as http:
        async def call(label, method, path, body=None, *, headers=auth,
                       data=None):
            kw = {"json": body} if body is not None else {}
            if data is not None:
                kw["data"] = data
            async with http.request(method, url + path, headers=headers,
                                    **kw) as r:
                raw = await r.read()
                ct = r.content_type
            if ct == "application/json":
                val = json.loads(raw)
            elif ct in ("application/zip", "application/octet-stream"):
                val = raw
            else:
                val = raw.decode()
            if label is not None:
                assert label not in rec, label
                rec[label] = [r.status, ct, val]
            return val

        api = "/api2/json/d2d"
        await call("healthz", "GET", "/plus/healthz")
        await call("readyz", "GET", "/plus/readyz")
        await call("no-auth", "GET", f"{api}/backup", headers={})
        await call("bad-auth", "GET", f"{api}/backup",
                   headers={"Authorization": "Bearer nope:00"})
        await call("ui", "GET", "/plus/ui")
        tok = await call("token-create", "POST", f"{api}/token",
                         {"ttl_s": 600})
        ids += [tok["token_id"], tok["token_secret"]]
        # the agent enrols over HTTP, as the agent command does
        key = pkg.mtls.generate_private_key()
        csr = pkg.mtls.make_csr(key, "h0").decode()
        await call("bootstrap-bad-secret", "POST", "/plus/agent/bootstrap",
                   {"hostname": "h0", "csr": csr, "token_id": tok["token_id"],
                    "token_secret": "00" * 24})
        await call("bootstrap-bad-host", "POST", "/plus/agent/bootstrap",
                   {"hostname": "bad host", "csr": csr,
                    "token_id": tok["token_id"],
                    "token_secret": tok["token_secret"]})
        boot = await call(None, "POST", "/plus/agent/bootstrap",
                          {"hostname": "h0", "csr": csr,
                           "token_id": tok["token_id"],
                           "token_secret": tok["token_secret"]})
        rec["bootstrap"] = [200, "application/json", sorted(boot)]
        paths = [os.path.join(base, n) for n in ("h0.pem", "h0.key", "ca.pem")]
        for p, data in zip(paths, (boot["cert"].encode(),
                                   pkg.mtls.key_pem(key), boot["ca"].encode())):
            with open(p, "wb") as f:
                f.write(data)
        agent = pkg.lc.AgentLifecycle(
            pkg.lc.AgentConfig(hostname="h0", server_host="127.0.0.1",
                               server_port=server.config.arpc_port,
                               tls=pkg.arpc.TlsClientConfig(*paths),
                               drive_update_interval_s=0),
            snapshot_manager=pkg.snaps.SnapshotManager(prefer_direct=True))
        agent_task = asyncio.ensure_future(agent.run())
        await server.agents.wait_session("h0", timeout=300)
        renew = await call(None, "POST", "/plus/agent/renew",
                           {"hostname": "h0", "csr": csr})
        rec["renew"] = [200, "application/json", sorted(renew)]
        other = pkg.mtls.make_csr(pkg.mtls.generate_private_key(), "h0")
        await call("renew-other-key", "POST", "/plus/agent/renew",
                   {"hostname": "h0", "csr": other.decode()})
        await call("renew-unknown", "POST", "/plus/agent/renew",
                   {"hostname": "nope", "csr": csr})
        await call("renew-bad-csr", "POST", "/plus/agent/renew",
                   {"hostname": "h0", "csr": "junk"})

        # targets, exclusions, scripts, alert settings
        await call("target-add", "POST", f"{api}/target",
                   {"name": "h0", "kind": "agent", "hostname": "h0"})
        await call("target-add-local", "POST", f"{api}/target",
                   {"name": "loc", "kind": "local", "root_path": src})
        await call("target-add-bad", "POST", f"{api}/target",
                   {"name": "../x", "kind": "local"})
        await call("target-list", "GET", f"{api}/target")
        await call("exclusion-add", "POST", f"{api}/exclusion",
                   {"pattern": "*.bak", "comment": "global"})
        await call("exclusion-list", "GET", f"{api}/exclusion")
        await call("script-add", "POST", f"{api}/script",
                   {"name": "pre", "content": "#!/bin/sh\ntrue\n",
                    "description": "d"})
        await call("script-add-bad", "POST", f"{api}/script", {"name": "x"})
        await call("script-list", "GET", f"{api}/script")
        await call("alerts-empty", "GET", f"{api}/alert-settings")
        await call("alerts-put", "POST", f"{api}/alert-settings",
                   {"quiet_hours": "22-6", "cooldown_s": 60})
        await call("alerts-put-bad", "POST", f"{api}/alert-settings", [1])
        await call("alerts", "GET", f"{api}/alert-settings")

        # backup jobs: the chunker left to the server's default
        await call("backup-add", "POST", f"{api}/backup",
                   {"id": "j1", "target": "h0", "source_path": src,
                    "backup_id": "web", "exclusions": ["*.tmp"]})
        await call("backup-add-bad-store", "POST", f"{api}/backup",
                   {"id": "j2", "target": "h0", "source_path": src,
                    "store": "nfs"})
        await call("backup-add-pbs-unset", "POST", f"{api}/backup",
                   {"id": "j2", "target": "h0", "source_path": src,
                    "store": "pbs"})
        await call("backup-add-bad-workers", "POST", f"{api}/backup",
                   {"id": "j2", "target": "h0", "source_path": src,
                    "pipeline_workers": 99})
        await call("backup-add-cpu", "POST", f"{api}/backup",
                   {"id": "jcpu", "target": "h0", "source_path": src,
                    "chunker": "cpu"})
        # a JAX server stored that row; the port refused it
        await call("backup-delete-cpu", "DELETE", f"{api}/backup/jcpu")
        await call("backup-run-unknown", "POST", f"{api}/backup/nope/run")
        await call("backup-run", "POST", f"{api}/backup/j1/run")

        async def finished():
            t = await call(None, "GET", f"{api}/tasks?job=j1")
            return t["data"] and t["data"][0]["status"] != "running" and t
        tasks = await _wait(finished, "backup task")
        upid = tasks["data"][0]["upid"]
        await call("task", "GET", f"{api}/tasks/{upid}")
        await call("task-unknown", "GET", f"{api}/tasks/nope")
        await call("backup-list", "GET", f"{api}/backup")
        snaps = await call("snapshots", "GET", f"{api}/snapshots")
        snap = snaps["data"][0]["snapshot"]

        # restore through the agent
        dest = os.path.join(base, "restored")
        await call("restore-bad-ref", "POST", f"{api}/restore",
                   {"target": "h0", "snapshot": "../x", "destination": dest})
        r = await call(None, "POST", f"{api}/restore",
                       {"target": "h0", "snapshot": snap,
                        "destination": dest})
        rid = r["restore_id"]
        ids.append(rid)

        async def restored():
            r = await call(None, "GET", f"{api}/restore/{rid}")
            return r["data"]["status"] in ("success", "error") and r
        await _wait(restored, "restore")
        await call("restore", "GET", f"{api}/restore/{rid}")
        await call("restore-unknown", "GET", f"{api}/restore/nope")
        await call("restores", "GET", f"{api}/restores")

        # verification
        await call("verification-add", "POST", f"{api}/verification",
                   {"id": "v1", "sample_rate": 1.0})
        await call("verification-run-unknown", "POST",
                   f"{api}/verification/nope/run")
        await call("verification-run", "POST", f"{api}/verification/v1/run")

        async def verified():
            v = await call(None, "GET", f"{api}/verification")
            return v["data"][0].get("last_status") and v
        await _wait(verified, "verification")
        await server.job_queue.drain(timeout=60)
        await call("verification-list", "GET", f"{api}/verification")
        await call("verification-results", "GET",
                   f"{api}/verification/v1/results")
        await call("verification-results-unknown", "GET",
                   f"{api}/verification/nope/results")
        await call("verification-export", "GET",
                   f"{api}/verification/v1/export")
        await call("verification-export-unknown", "GET",
                   f"{api}/verification/nope/export")
        await call("verification-aggregate", "GET",
                   f"{api}/verification-aggregate")

        # the stored snapshot
        await call("zip", "GET", f"{api}/snapshot-zip?snapshot={snap}"
                                  "&path=etc")
        await call("zip-root", "GET", f"{api}/snapshot-zip?snapshot={snap}")
        await call("zip-missing", "GET", f"{api}/snapshot-zip?snapshot={snap}"
                                          "&path=nope")
        await call("zip-bad-ref", "GET", f"{api}/snapshot-zip?snapshot=a/b")
        await call("tree-root", "GET",
                   f"{api}/snapshot-filetree?snapshot={snap}")
        await call("tree-etc", "GET",
                   f"{api}/snapshot-filetree?snapshot={snap}&path=etc")
        await call("tree-bad-ref", "GET",
                   f"{api}/snapshot-filetree?snapshot=x")

        # the live agent
        await call("filetree", "GET", f"{api}/filetree?target=h0&path={src}")
        await call("filetree-offline", "GET", f"{api}/filetree?target=nope")
        await call("drives", "GET", f"{api}/drives?target=h0")
        await call("drives-offline", "GET", f"{api}/drives?target=nope")
        await call("target-status-cached", "GET", f"{api}/target-status")
        await call("target-status", "GET", f"{api}/target-status?refresh=true")
        await call("push-update", "POST", f"{api}/push-update", {})
        await call("push-update-offline", "POST", f"{api}/push-update",
                   {"hostnames": ["nope"]})
        await call("push-update-none", "POST", f"{api}/push-update",
                   {"hostnames": []})
        await call("push-update-bad", "POST", f"{api}/push-update",
                   {"hostnames": "h0"})
        await call("push-update-bad-timeout", "POST", f"{api}/push-update",
                   {"timeout": "nan"})

        # notifications (the tracker flushed the runs), exports, tokens
        await asyncio.sleep(0.3)
        await call("notifications", "GET", "/plus/notifications")
        await call("backup-export", "GET", f"{api}/backup-export")
        await call("tokens", "GET", f"{api}/token")
        await call("token-delete", "DELETE", f"{api}/token/{tok['token_id']}")
        await call("tokens-after", "GET", f"{api}/token")

        # prune, mounts, sync
        await call("prune-dry", "POST", f"{api}/prune",
                   {"keep_last": 1, "dry_run": True})
        await call("prune-no-policy", "POST", f"{api}/prune", {})
        await call("prune-bad-grace", "POST", f"{api}/prune",
                   {"keep_last": 1, "gc_grace_s": -1})
        await call("prune-bad-body", "POST", f"{api}/prune", [1])
        await call("mounts", "GET", f"{api}/mount")
        await call("mount-bad-ref", "POST", f"{api}/mount",
                   {"snapshot": "../x"})
        await call("mount-delete-unknown", "DELETE", f"{api}/mount/nope")
        for label, method, path in (
                ("sync-list", "GET", "/sync"), ("sync-add", "POST", "/sync"),
                ("sync-delete", "DELETE", "/sync/s1"),
                ("sync-run", "POST", "/sync/s1/run"),
                ("sync-results", "GET", "/sync/s1/results")):
            await call(label, method, api + path,
                       {"id": "s1", "remote_url": "http://x"}
                       if method == "POST" else None)

        # debug, profile, traces, install scripts, the agent bundle
        for label, path in (("debug-tasks", "/plus/debug/tasks"),
                            ("debug-stats", "/plus/debug/stats"),
                            ("debug-stacks", "/plus/debug/stacks"),
                            ("traces", f"{api}/traces?n=5")):
            await call(label, "GET", path)
        await call("profile", "POST", "/plus/debug/profile", {"seconds": 0.1})
        await call("profile-text", "POST", "/plus/debug/profile?format=text",
                   {"seconds": 0.1})
        await call("profile-agent", "POST", "/plus/debug/profile",
                   {"seconds": 0.1, "target": "h0"})
        await call("profile-no-session", "POST", "/plus/debug/profile",
                   {"seconds": 0.1, "target": "nope"})
        await call("profile-bad-seconds", "POST", "/plus/debug/profile",
                   {"seconds": 999})
        await call("profile-bad-body", "POST", "/plus/debug/profile", [1])
        await call("install-sh", "GET", "/plus/agent/install.sh")
        await call("install-ps1", "GET", "/plus/agent/install.ps1")
        await call("signer-pub", "GET", "/plus/agent/signer.pub")
        await call("version", "GET", "/plus/agent/version")
        await call("pyz", "GET", "/plus/agent/pyz")

        # deletes, the metrics render last
        await call("snapshot-delete-bad", "DELETE", f"{api}/snapshots/a/b")
        await call("snapshot-delete-unknown", "DELETE",
                   f"{api}/snapshots/host/nope/2020-01-01T00:00:00Z")
        await call("snapshot-delete", "DELETE", f"{api}/snapshots/{snap}")
        await call("snapshots-after", "GET", f"{api}/snapshots")
        await call("exclusion-delete", "DELETE", f"{api}/exclusion/1")
        await call("exclusion-delete-bad", "DELETE", f"{api}/exclusion/x")
        await call("script-delete", "DELETE", f"{api}/script/pre")
        await call("backup-delete", "DELETE", f"{api}/backup/j1")
        await call("target-delete", "DELETE", f"{api}/target/loc")
        await call("target-list-after", "GET", f"{api}/target")
        await call("metrics", "GET", "/plus/metrics")

    await agent.stop()
    agent_task.cancel()
    await asyncio.gather(agent_task, return_exceptions=True)
    await runner.cleanup()
    await server.stop()
    return rec, ids, dest


def _drive(name, base, src):
    """One package's server, driven over HTTP; its answers as JSON (bytes
    as hex)."""
    pkg = _pkg(name)
    pkg.bp.time = _Clock()
    rec, ids, dest = asyncio.run(_drive_server(pkg, base, src))
    for v in rec.values():
        if isinstance(v[2], bytes):
            v[2] = {"hex": v[2].hex()}
    return {"rec": rec, "ids": ids, "base": base, "dest": dest}


_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
if sys.argv[2] == "ref":
    import conftest                      # jax on the CPU
import test_torch_web as t
print(json.dumps(t._drive(*sys.argv[2:])))
"""

_UPID = re.compile(r"UPID:[^:\s]*:[0-9A-F]{8}:[0-9A-F]{8}:[0-9A-F]{8}:"
                   r"[0-9A-F]{8}:")
_TIME = re.compile(r"\b(1[6-9]|2[01])\d{8}(\.\d+)?\b")


def _norm(x, subs):
    """Run-specific values as placeholders: the ids the run minted, the
    server's directory, UPIDs and Unix times."""
    if isinstance(x, dict):
        return {k: _norm(v, subs) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v, subs) for v in x]
    if isinstance(x, (int, float)) and not isinstance(x, bool) \
            and 1.6e9 <= x < 2.2e9:
        return "<t>"
    if isinstance(x, str):
        for a, b in subs:
            x = x.replace(a, b)
        return _TIME.sub("<t>", _UPID.sub("UPID:<n>:", x))
    return x


@pytest.fixture(scope="module")
def webs(tmp_path_factory):
    from test_torch_backup_job import make_tree
    root = tmp_path_factory.mktemp("web")
    src = make_tree(root / "src", 31, files=4)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _CHILD, TESTS, name, str(root / name), src],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("ref", "port")}
    out = {"src": src}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-6000:]
        got = json.loads(stdout.splitlines()[-1])
        subs = [(got["base"], "<base>")] + [
            (i, f"<id{n}>") for n, i in enumerate(got["ids"])]
        got["norm"] = {k: _norm(v, subs) for k, v in got["rec"].items()}
        out[name] = SimpleNamespace(**got)
    return out


# routes whose answer depends on the run itself: status, type and shape
_SHAPE_ONLY = {"debug-tasks", "debug-stats", "debug-stacks", "traces",
               "profile",
               "profile-text", "profile-agent", "signer-pub", "version",
               "pyz", "metrics", "install-sh", "install-ps1", "drives"}
# the job's chunker kind: the servers' defaults differ ("tpu" / "cuda")
_CHUNKER = {"backup-add", "backup-list", "backup-export"}


def _chunker_free(label, val, kind):
    val = json.loads(json.dumps(val))
    if label == "backup-export":
        return val.replace(f",{kind},", ",<chunker>,")
    rows = val["data"] if isinstance(val["data"], list) else [val["data"]]
    for r in rows:
        assert r["chunker"] == kind
        r["chunker"] = "<chunker>"
    return val


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()} if len(v) < 12 \
            else sorted(v)
    if isinstance(v, list):
        return [type(v).__name__, len(v) > 0]
    return type(v).__name__


def test_routes_answer_like_reference(webs):
    r, p = webs["ref"].norm, webs["port"].norm
    assert sorted(p) == sorted(r)
    differ = []
    for label in sorted(r):
        rs, rt, rv = r[label]
        ps, pt, pv = p[label]
        if label in _SHAPE_ONLY:
            if pt == "application/json" and label != "drives":
                rv, pv = _shape(rv), _shape(pv)
            else:
                rv = pv = None
        elif label in _CHUNKER:
            rv = _chunker_free(label, rv, "tpu")
            pv = _chunker_free(label, pv, "cuda")
        if (ps, pt, pv) != (rs, rt, rv):
            differ.append((label, (ps, pt, pv), (rs, rt, rv)))
    assert differ == []


def test_the_run_did_its_work(webs):
    """The normalised answers above are not vacuous: the backup, the
    restore and the verification succeeded, and the sync routes answered
    as the JAX server's: a row stored, deleted, then unknown to run and
    results."""
    p = webs["port"].norm
    assert p["task"][2]["data"]["status"] == "success"
    assert p["restore"][2]["data"]["status"] == "success"
    ver = p["verification-results"][2]["data"]
    assert ver["last_status"] == "success"
    assert ver["last_report"]["checked"] > 0
    assert ver["last_report"]["corrupt"] == []
    assert p["snapshots"][2]["data"][0]["entries"] > 4
    assert p["notifications"][2]["data"]
    assert p["backup-list"][2]["data"][0]["last_status"] == "success"
    r = webs["ref"].norm
    for label, status in (("sync-list", 200), ("sync-add", 200),
                          ("sync-delete", 200), ("sync-run", 404),
                          ("sync-results", 404)):
        assert p[label] == r[label] and p[label][0] == status
    assert p["sync-list"][2] == {"data": []}


def _tree(root, *, exclude=()):
    out = {}
    for dp, dn, fn in os.walk(root):
        dn.sort()
        for n in sorted(fn):
            path = os.path.join(dp, n)
            rel = os.path.relpath(path, root)
            if any(rel == e or rel.startswith(e + "/") for e in exclude):
                continue
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            else:
                with open(path, "rb") as f:
                    out[rel] = ("file", hashlib.sha256(f.read()).hexdigest())
    return out


def test_restored_trees_equal_the_source(webs):
    want = _tree(webs["src"], exclude=("skip.tmp", "etc/old.bak"))
    assert _tree(webs["port"].dest) == _tree(webs["ref"].dest) == want


def test_snapshot_zip_bytes_match_reference(webs):
    """The zip of a subtree is byte-identical, and its members are the
    source files."""
    for label in ("zip", "zip-root"):
        r, p = webs["ref"].rec[label], webs["port"].rec[label]
        assert p == r and p[0] == 200 and p[1] == "application/zip"
    zf = zipfile.ZipFile(io.BytesIO(bytes.fromhex(
        webs["port"].rec["zip"][2]["hex"])))
    src = webs["src"]
    members = {n: zf.read(n) for n in zf.namelist()}
    want = {}
    for n in sorted(os.listdir(os.path.join(src, "etc"))):
        if n.endswith(".bak"):
            continue
        with open(os.path.join(src, "etc", n), "rb") as f:
            want[n] = f.read()
    assert members == want


def test_chunker_default_and_unserved_kind(webs):
    """The job row takes the server's chunker default; a body naming
    ``cpu``, the JAX default, is stored as the JAX server stores it."""
    r, p = webs["ref"].norm, webs["port"].norm
    assert p["backup-add"][2]["data"]["chunker"] == "cuda"
    assert p["backup-add-cpu"] == r["backup-add-cpu"]
    assert p["backup-add-cpu"][0] == 200
    assert p["backup-delete-cpu"] == r["backup-delete-cpu"]


def test_push_update_answers_per_host(webs):
    """Neither agent has self-update configured: both answer that updates
    are not configured, and both report the host as not updated."""
    r, p = webs["ref"].norm["push-update"], webs["port"].norm["push-update"]
    assert p == r
    assert p[:2] == [200, "application/json"]
    assert p[2]["success"] is False
    (ph,) = p[2]["data"]
    assert ph["hostname"] == "h0" and ph["updated"] is False
    assert ph["message"] == "updates not configured"


def test_agent_bundle_packs_the_port(webs):
    names = zipfile.ZipFile(io.BytesIO(bytes.fromhex(
        webs["port"].rec["pyz"][2]["hex"]))).namelist()
    zf = zipfile.ZipFile(io.BytesIO(bytes.fromhex(
        webs["port"].rec["pyz"][2]["hex"])))
    assert zf.read("__main__.py").startswith(
        b"from pbs_plus_tpu_torch.__main__ import main\n")
    assert "pbs_plus_tpu_torch/server/web.py" in names
    assert "pbs_plus_tpu_torch/ops/csrc/rolling_hash.cu" in names
    assert "pbs_plus_tpu_torch/ops/csrc/sha256.cu" in names
    assert "pbs_plus_tpu_torch/ops/simhash_projection.npz" in names
    assert not any(n.startswith("pbs_plus_tpu/") for n in names)
    version = webs["port"].rec["version"][2]
    assert version["size"] == len(bytes.fromhex(
        webs["port"].rec["pyz"][2]["hex"]))


def test_metrics_render_matches_reference_over_http(webs):
    from test_torch_server import _series, _types, _untimed, port_only
    r, p = webs["ref"].rec["metrics"][2], webs["port"].rec["metrics"][2]
    assert _types(p) == _types(r)
    rs, ps = _series(r), port_only(_series(p))
    assert set(ps) == set(rs)
    pv = _untimed(ps)
    assert pv == _untimed(rs)
    assert pv[("pbs_plus_snapshots_total", ())] == 0     # deleted at the end
    assert pv[("pbs_plus_dedup_index_probes_total", ())] > 0
    kind = (("kind", '"backup"'),)
    assert pv[("pbs_plus_job_grant_to_publish_seconds_count", kind)] == 1


# -- the server and agent commands ---------------------------------------------

def _lines_until(proc, pred, timeout):
    """stdout lines of ``proc`` until one satisfies ``pred``, read on a
    thread (a select on the pipe misses lines the text buffer holds)."""
    import queue
    import threading
    lines_q = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines_q.put(line.rstrip("\n"))
        lines_q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    lines, t_end = [], time.monotonic() + timeout
    while time.monotonic() < t_end:
        try:
            line = lines_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if line is None:
            break
        lines.append(line)
        if pred(line):
            return lines
    raise AssertionError(f"no such line: {lines}")


def test_signer_command_names_its_missing_module(tmp_path, capsys):
    """The reference's ``signer`` flags run the reference's command: a key
    pair, a signature the JAX package's ``verify_signature`` accepts, and
    ``verify`` answering OK (exit 0)."""
    from pbs_plus_tpu.agent.updater import verify_signature
    from pbs_plus_tpu_torch.__main__ import main
    key, art = str(tmp_path / "k.pem"), tmp_path / "a.bin"
    art.write_bytes(b"artifact" * 100)
    assert main(["signer", "keygen", "--key", key]) == 0
    assert main(["signer", "sign", "--key", key, "--file", str(art)]) == 0
    sig = (tmp_path / "a.bin.sig").read_bytes()
    assert verify_signature(art.read_bytes(), sig,
                            open(f"{key}.pub", "rb").read())
    capsys.readouterr()
    assert main(["signer", "verify", "--key", f"{key}.pub",
                 "--file", str(art)]) == 0
    assert capsys.readouterr().out.strip() == "OK"


def test_server_cuda_without_card_exits_naming_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "pbs_plus_tpu_torch", "server",
         "--datastore", str(tmp_path / "ds"), "--state-dir",
         str(tmp_path / "st"), "--cert-dir", str(tmp_path / "ct"),
         "--device", "cuda"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in \
        r.stderr
    assert not os.path.exists(tmp_path / "st")


def test_server_and_agent_commands(tmp_path):
    import aiohttp
    from test_torch_backup_job import make_tree
    src = make_tree(tmp_path / "src", 41, files=2)
    env = dict(os.environ, PYTHONPATH=REPO)
    # stderr to files: an unread pipe would stall a process that logs
    logs = {n: tmp_path / f"{n}.stderr" for n in ("server", "agent")}
    with open(logs["server"], "w") as err:
        server = subprocess.Popen(
            [sys.executable, "-m", "pbs_plus_tpu_torch", "server",
             "--datastore", str(tmp_path / "ds"), "--state-dir",
             str(tmp_path / "st"), "--cert-dir", str(tmp_path / "ct"),
             "--host", "127.0.0.1", "--arpc-port", "0", "--web-port", "0",
             "--chunk-avg", str(CHUNK_AVG), "--print-token", "--device",
             "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
            text=True)
    agent = None
    try:
        lines = _lines_until(server, lambda s: s.startswith("api token"), 300)
        ports = re.search(r"aRPC :(\d+), web :(\d+)", lines[0]).groups()
        boot = lines[1].split()[-1]
        api_tok = lines[2].split()[-1]
        with open(logs["agent"], "w") as err:
            agent = subprocess.Popen(
                [sys.executable, "-m", "pbs_plus_tpu_torch", "agent",
                 "--hostname", "h0", "--server", f"127.0.0.1:{ports[0]}",
                 "--state-dir", str(tmp_path / "agent"), "--bootstrap-url",
                 f"http://127.0.0.1:{ports[1]}", "--bootstrap-token", boot,
                 "--snapshots", "direct"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        _lines_until(agent, lambda s: s.startswith("bootstrapped"), 300)
        url = f"http://127.0.0.1:{ports[1]}/api2/json/d2d"
        auth = {"Authorization": f"Bearer {api_tok}"}

        async def main():
            async with aiohttp.ClientSession(headers=auth) as http:
                async def get(path):
                    async with http.get(url + path) as r:
                        return await r.json()

                async def post(path, body=None):
                    async with http.post(url + path, json=body) as r:
                        return r.status, await r.json()
                assert (await post("/target", {"name": "h0",
                                               "kind": "agent"}))[0] == 200

                async def connected():
                    return (await get("/target"))["data"][0]["connected"]
                await _wait(connected, "control session")
                assert (await post("/backup", {
                    "id": "j", "target": "h0", "source_path": src}))[0] == 200
                assert await post("/backup/j/run") == (200, {"started": True})

                async def done():
                    t = (await get("/tasks?job=j"))["data"]
                    return t and t[0]["status"] != "running" and t[0]
                return await _wait(done, "backup"), \
                    (await get("/snapshots"))["data"]
        task, snaps = asyncio.run(main())
        assert task["status"] == "success", task
        assert snaps and snaps[0]["id"] == "h0"
    finally:
        for proc in (agent, server):
            if proc is not None:
                proc.terminate()
        for proc in (agent, server):
            if proc is not None:
                proc.wait(timeout=30)
    # the agent ran the job in an agent-job child
    err = logs["server"].read_text()
    assert "agent accepted backup (snapshot=child)" in err, err
