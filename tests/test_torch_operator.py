"""The port's Kubernetes operator against the JAX package's.

Both packages' ``Operator`` and ``LeaderElector`` talk, through their own
``KubeClient`` over aiohttp, to one fake kube API (the pattern of
``tests/test_operator.py``) that records every request.  The same
cluster states must draw the same requests (method, path, JSON body) and
the same reconcile results, with the lease clock pinned.  The agent
pod's ``args`` parse with the port's own ``agent`` command.  Tolerance
is exact.
"""

import asyncio
import datetime as dt
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
from aiohttp import ClientSession, web

from pbs_plus_tpu.operator import kube as ref_kube
from pbs_plus_tpu.operator import leader as ref_leader
from pbs_plus_tpu.operator import operator as ref_op
from pbs_plus_tpu_torch.operator import kube as port_kube
from pbs_plus_tpu_torch.operator import leader as port_leader
from pbs_plus_tpu_torch.operator import operator as port_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", kube=ref_kube, leader=ref_leader,
                      op=ref_op)
PORT = SimpleNamespace(name="port", kube=port_kube, leader=port_leader,
                       op=port_op)
NOW = dt.datetime(2026, 7, 29, 2, 0, 0, 123456, tzinfo=dt.timezone.utc)


class RecordingKube:
    """In-memory PVCs, pods, snapshots and leases behind the kube REST
    surface; every request lands in ``requests``."""

    def __init__(self):
        self.pvcs, self.pods, self.snaps, self.leases = {}, {}, {}, {}
        self.snap_ready = True
        self.fail = {}                     # (method, kind) -> status
        self.requests = []

    def app(self):
        app = web.Application(middlewares=[self._record])
        r = app.router
        pvc = "/api/v1/namespaces/{ns}/persistentvolumeclaims"
        r.add_get(pvc, self._list_pvcs)
        r.add_post(pvc, self._create("pvcs"))
        r.add_delete(pvc + "/{name}", self._delete("pvcs"))
        pods = "/api/v1/namespaces/{ns}/pods"
        r.add_get(pods + "/{name}", self._get("pods"))
        r.add_post(pods, self._create("pods"))
        r.add_delete(pods + "/{name}", self._delete("pods"))
        snaps = "/apis/snapshot.storage.k8s.io/v1/namespaces/{ns}/volumesnapshots"
        r.add_post(snaps, self._create("snaps"))
        r.add_get(snaps + "/{name}", self._get("snaps"))
        r.add_delete(snaps + "/{name}", self._delete("snaps"))
        leases = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"
        r.add_post(leases, self._create("leases"))
        r.add_get(leases + "/{name}", self._get("leases"))
        r.add_put(leases + "/{name}", self._put_lease)
        return app

    @web.middleware
    async def _record(self, req, handler):
        body = await req.text()
        self.requests.append((req.method, req.path,
                              json.loads(body) if body else None,
                              req.headers.get("Authorization")))
        return await handler(req)

    def _failing(self, req, kind):
        return self.fail.get((req.method, kind))

    async def _list_pvcs(self, req):
        return web.json_response({"items": list(self.pvcs.values())})

    def _create(self, kind):
        async def h(req):
            if self._failing(req, kind):
                return web.json_response({}, status=self._failing(req, kind))
            body = await req.json()
            store = getattr(self, kind)
            name = body["metadata"]["name"]
            if name in store:
                return web.json_response({"reason": "AlreadyExists"},
                                         status=409)
            if kind == "pods":
                body.setdefault("status", {"phase": "Running"})
            if kind == "snaps":
                body["status"] = {"readyToUse": self.snap_ready}
            store[name] = body
            return web.json_response(body)
        return h

    def _get(self, kind):
        async def h(req):
            obj = getattr(self, kind).get(req.match_info["name"])
            if obj is None:
                return web.json_response({"reason": "NotFound"}, status=404)
            if kind == "snaps":
                obj["status"] = {"readyToUse": self.snap_ready}
            return web.json_response(obj)
        return h

    def _delete(self, kind):
        async def h(req):
            if getattr(self, kind).pop(req.match_info["name"], None) is None:
                return web.json_response({"reason": "NotFound"}, status=404)
            return web.json_response({})
        return h

    async def _put_lease(self, req):
        if self._failing(req, "leases"):
            return web.json_response({}, status=self._failing(req, "leases"))
        body = await req.json()
        self.leases[req.match_info["name"]] = body
        return web.json_response(body)


async def _serve(fake, fn, pkg):
    runner = web.AppRunner(fake.app())
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    try:
        async with ClientSession() as http:
            kube = pkg.kube.KubeClient(http, f"http://127.0.0.1:{port}",
                                       token="sa-token", namespace="backup")
            return await fn(kube)
    finally:
        await runner.cleanup()


def _pvc(name, *, annotated=True, rwo=False):
    return {"metadata": {"name": name,
                         "annotations": {"pbs-plus.io/backup": "true"}
                         if annotated else {}},
            "spec": {"accessModes": ["ReadWriteOnce"] if rwo
                     else ["ReadWriteMany"],
                     "resources": {"requests": {"storage": "1Gi"}}}}


def _operator_script(pkg, fake):
    """Four rounds over a mixed cluster: RWX and RWO volumes, a snapshot
    not yet ready, a clone that already exists, a clone that fails,
    finished pods cleaned."""
    fake.pvcs = {"data-a": _pvc("data-a"), "ignored": _pvc("ignored",
                                                            annotated=False),
                 "pgdata": _pvc("pgdata", rwo=True),
                 "logs": _pvc("logs", rwo=True)}
    fake.snap_ready = False

    async def fn(kube):
        op = pkg.op.Operator(kube, pkg.op.OperatorConfig(
            server_url="srv:8008", bootstrap_url="http://srv:8017",
            bootstrap_token="t:s", snapshot_class="csi-snap"))
        out = [vars(await op.reconcile())]
        fake.snap_ready = True
        fake.pvcs["pbs-clone-logs"] = {"metadata": {"name": "pbs-clone-logs"}}
        out.append(vars(await op.reconcile()))
        for p in fake.pods.values():
            p["status"]["phase"] = "Succeeded"
        fake.pvcs["fresh"] = _pvc("fresh", rwo=True)
        fake.fail[("POST", "pvcs")] = 500
        out.append(vars(await op.reconcile()))
        del fake.fail[("POST", "pvcs")]
        out.append(vars(await op.reconcile()))
        return out
    return fn


def test_operator_requests_and_results_equal():
    got = {}
    for pkg in (REF, PORT):
        fake = RecordingKube()
        res = asyncio.run(_serve(fake, _operator_script(pkg, fake), pkg))
        got[pkg.name] = (res, fake.requests, sorted(fake.pods),
                         sorted(fake.pvcs), sorted(fake.snaps))
    assert got["port"] == got["ref"]
    res, reqs = got["port"][:2]
    assert res[0]["created_snapshots"] == ["pbs-snap-pgdata",
                                           "pbs-snap-logs"]
    assert res[0]["created_pods"] == ["pbs-agent-data-a"]
    assert res[1]["created_pods"] == ["pbs-agent-pgdata", "pbs-agent-logs"]
    assert sorted(res[2]["cleaned"]) == ["pbs-agent-data-a", "pbs-agent-logs",
                                         "pbs-agent-pgdata"]
    assert "fresh (clone create failed)" in res[2]["skipped"]
    assert "pbs-agent-fresh" in res[3]["created_pods"]
    assert all(r[3] == "Bearer sa-token" for r in reqs)
    assert any(r[0] == "POST" and r[2]["spec"].get(
        "volumeSnapshotClassName") == "csi-snap" for r in reqs
        if r[1].endswith("/volumesnapshots"))


def test_operator_128_pvc_fan_in_requests_equal():
    """128 annotated PVCs draw 128 agent pods, the same requests in the
    same order from both packages."""
    got = {}
    for pkg in (REF, PORT):
        fake = RecordingKube()
        fake.pvcs = {f"pvc-{i:03d}": _pvc(f"pvc-{i:03d}") for i in range(128)}

        async def fn(kube, pkg=pkg):
            op = pkg.op.Operator(kube, pkg.op.OperatorConfig(
                server_url="srv:8008", bootstrap_url="http://srv:8017"))
            return vars(await op.reconcile())
        res = asyncio.run(_serve(fake, fn, pkg))
        got[pkg.name] = (res, fake.requests)
    assert got["port"] == got["ref"]
    res, reqs = got["port"]
    assert len(res["created_pods"]) == 128
    assert sum(r[0] == "POST" for r in reqs) == 128


def _lease(holder, *, renew, transitions=3, duration=15):
    return {"metadata": {"name": "op-lease", "resourceVersion": "7"},
            "spec": {"holderIdentity": holder,
                     "leaseDurationSeconds": duration,
                     "acquireTime": "2026-07-29T01:00:00.000000Z",
                     "renewTime": renew, "leaseTransitions": transitions}}


FRESH = "2026-07-29T01:59:55.000000Z"
STALE = "2026-07-29T01:59:00.000000Z"
LEASE_CASES = {
    "absent": (None, {}),
    "create_race": (None, {("POST", "leases"): 409}),
    "create_fails": (None, {("POST", "leases"): 500}),
    "ours": (_lease("me", renew=FRESH), {}),
    "other_fresh": (_lease("other", renew=FRESH), {}),
    "other_expired": (_lease("other", renew=STALE), {}),
    "no_holder": (_lease("", renew=FRESH), {}),
    "bad_time": (_lease("other", renew="garbage"), {}),
    "update_conflict": (_lease("other", renew=STALE), {("PUT", "leases"): 409}),
}


@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_leader_election_requests_equal(monkeypatch, case):
    lease, fail = LEASE_CASES[case]
    got = {}
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.leader, "_now", lambda: NOW)
        fake = RecordingKube()
        fake.fail = dict(fail)
        if lease is not None:
            fake.leases["op-lease"] = json.loads(json.dumps(lease))

        async def fn(kube, pkg=pkg):
            el = pkg.leader.LeaderElector(kube, lease_name="op-lease",
                                          identity="me")
            steps = []
            for _ in range(2):
                try:
                    steps.append(await el.try_acquire_or_renew())
                except pkg.kube.KubeError as e:
                    steps.append(("KubeError", e.status))
            return steps
        steps = asyncio.run(_serve(fake, fn, pkg))
        got[pkg.name] = (steps, fake.requests, fake.leases)
    assert got["port"] == got["ref"]
    steps = got["port"][0]
    want = {"absent": [True, True], "create_race": [False, False],
            "create_fails": [("KubeError", 500)] * 2, "ours": [True, True],
            "other_fresh": [False, False], "other_expired": [True, True],
            "no_holder": [True, True], "bad_time": [True, True],
            "update_conflict": [False, False]}[case]
    assert steps == want


def test_operator_run_idles_while_not_leader_equal():
    """``run(leader=...)`` reconciles only under the lease, in both."""
    got = {}
    for pkg in (REF, PORT):
        fake = RecordingKube()
        fake.pvcs = {"a": _pvc("a")}

        async def fn(kube, pkg=pkg):
            op = pkg.op.Operator(kube, pkg.op.OperatorConfig(
                server_url="s:1", bootstrap_url="http://b",
                poll_interval_s=0.01))
            gate = SimpleNamespace(is_leader=False)
            task = asyncio.create_task(op.run(leader=gate))
            await asyncio.sleep(0.05)
            before = len(fake.requests)
            gate.is_leader = True
            while "pbs-agent-a" not in fake.pods:
                await asyncio.sleep(0.01)
            op.stop()
            await task
            return before
        before = asyncio.run(_serve(fake, fn, pkg))
        got[pkg.name] = (before, sorted(fake.pods))
    assert got["port"] == got["ref"] == (0, ["pbs-agent-a"])


def test_agent_pod_args_parse_with_the_port_agent_command():
    from pbs_plus_tpu_torch.__main__ import _cmd_agent, build_parser
    op = port_op.Operator(None, port_op.OperatorConfig(
        server_url="srv:8008", bootstrap_url="http://srv:8017",
        bootstrap_token="tok:s"))
    spec = op.agent_pod_spec(_pvc("db"), "pbs-clone-db")
    args = spec["spec"]["containers"][0]["args"]
    assert args == ref_op.Operator(None, ref_op.OperatorConfig(
        server_url="srv:8008", bootstrap_url="http://srv:8017",
        bootstrap_token="tok:s")).agent_pod_spec(
            _pvc("db"), "pbs-clone-db")["spec"]["containers"][0]["args"]
    ns = build_parser().parse_args(args)
    assert ns.fn is _cmd_agent
    assert (ns.hostname, ns.server, ns.bootstrap_url, ns.bootstrap_token,
            ns.state_dir) == ("pvc-db", "srv:8008", "http://srv:8017",
                              "tok:s", "/state")
    assert ns.job_isolation == "subprocess" and ns.snapshots == "auto"


def test_operator_module_runs_as_a_command():
    """``python -m pbs_plus_tpu_torch.operator`` needs its environment:
    without ``PBS_PLUS_SERVER_URL`` in a cluster it stops on the missing
    service host, as the JAX entry point does."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KUBERNETES_", "PBS_PLUS_"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "pbs_plus_tpu_torch.operator"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=120)
    assert r.returncode == 1
    assert "KeyError: 'KUBERNETES_SERVICE_HOST'" in r.stderr
