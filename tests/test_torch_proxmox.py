"""The port's PBS task logs and management client against the JAX
package's.

``TaskLogDir``/``WorkerTask`` in each package write their task files
into a directory of their own with the clock, the UPID counter and the
host name pinned: every file must be byte for byte equal.
``PBSManagerClient`` talks to one ``tests/mock_pbs.MockPBS`` per package
(its token secrets pinned) and must give equal answers and errors.
Tolerance is exact.
"""

import os
import secrets
import time
from types import SimpleNamespace

import pytest

from pbs_plus_tpu import proxmox as ref_proxmox
from pbs_plus_tpu.proxmox import manager as ref_manager
from pbs_plus_tpu.proxmox import tasklog as ref_tasklog
from pbs_plus_tpu.proxmox import upid as ref_upid
from pbs_plus_tpu.pxar import pbsstore as ref_pbs
from pbs_plus_tpu_torch import proxmox as port_proxmox
from pbs_plus_tpu_torch.proxmox import manager as port_manager
from pbs_plus_tpu_torch.proxmox import tasklog as port_tasklog
from pbs_plus_tpu_torch.proxmox import upid as port_upid
from pbs_plus_tpu_torch.pxar import pbsstore as port_pbs

from mock_pbs import MockPBS

REF = SimpleNamespace(name="ref", pkg=ref_proxmox, tasklog=ref_tasklog,
                      upid=ref_upid, manager=ref_manager, pbs=ref_pbs)
PORT = SimpleNamespace(name="port", pkg=port_proxmox, tasklog=port_tasklog,
                       upid=port_upid, manager=port_manager, pbs=port_pbs)
T0 = 1_753_750_000


class _Clock:
    """``time`` for the task-log and UPID modules: ``time()`` steps a
    second a call from T0; ``strftime`` renders that second in UTC."""

    def __init__(self):
        self.t = T0

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        self.t += 1
        return float(self.t)

    def strftime(self, fmt, *a):
        return time.strftime(fmt.replace("%z", "+0000"),
                             time.gmtime(self.t))


def test_package_exports_equal():
    assert port_proxmox.__all__ == ref_proxmox.__all__
    assert {n: getattr(port_proxmox, n).__module__.replace(
        "pbs_plus_tpu_torch.", "pbs_plus_tpu.") for n in port_proxmox.__all__} \
        == {n: getattr(ref_proxmox, n).__module__ for n in ref_proxmox.__all__}


def _files(root):
    out = {}
    for dp, _dn, fn in os.walk(root):
        for f in fn:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _tasks(pkg, base):
    logs = pkg.pkg.TaskLogDir(base)
    t = pkg.pkg.WorkerTask(logs, "backup", "store:vm/100", node="pbs1")
    active = [logs.list_active()]
    t.log("starting")
    t.warn("minor issue")
    t2 = pkg.pkg.WorkerTask(logs, "restore", "r1", node="pbs1",
                            auth_id="alice@pbs")
    active.append(logs.list_active())
    statuses = [t.finish(), t2.finish("disk exploded")]
    t3 = pkg.pkg.WorkerTask(logs, "verify", "v1", node="pbs1")
    statuses.append(t3.finish())
    reads = [logs.read_status(x.upid) for x in (t, t2, t3)]
    missing = pkg.upid.new_upid("gc", "x", node="pbs1")
    reads.append(logs.read_status(missing))
    logs._remove_line(os.path.join(base, "nope"), "x")
    return (active + [logs.list_active()], statuses, reads,
            [str(x.upid) for x in (t, t2, t3)], t.read_log(),
            pkg.pkg.TaskLogDir(os.path.join(base, "fresh")).list_active())


@pytest.mark.parametrize("seed_tasks", [0, 3])
def test_task_log_files_byte_identical(tmp_path, monkeypatch, seed_tasks):
    got = {}
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.tasklog, "time", _Clock())
        monkeypatch.setattr(pkg.upid, "time", _Clock())
        monkeypatch.setattr(pkg.upid, "_counter", iter(range(seed_tasks,
                                                             1 << 30)))
        base = str(tmp_path / pkg.name)
        res = _tasks(pkg, base)
        got[pkg.name] = (res, _files(base))
    assert got["port"] == got["ref"]
    (active, statuses, reads, upids, body, fresh), files = got["port"]
    assert statuses == ["WARNINGS: 1", "ERROR: disk exploded", "OK"]
    assert reads == statuses + [None] and active[-1] == [] and fresh == []
    assert "TASK WARNINGS: 1" in body and {"active", "archive"} <= set(files)
    assert port_upid.parse_upid(upids[1]).auth_id == "alice@pbs"


def _manager(pkg, monkeypatch):
    monkeypatch.setattr(secrets, "token_hex", lambda n: "ab" * n)
    pbs = MockPBS()
    try:
        c = pkg.manager.PBSManagerClient(pkg.pbs.PBSConfig(
            base_url=pbs.base_url, datastore="tank", auth_token=pbs.token))
        out = []

        def step(fn, *a, **kw):
            try:
                r = fn(*a, **kw)
                out.append(("ok", vars(r) if hasattr(r, "__dict__") else r))
            except pkg.pbs.PBSError as e:
                out.append((type(e).__name__, e.status, str(e)))
        step(c.version)
        step(c.list_datastores)
        step(c.datastore_status)
        step(c.datastore_status, "tank")
        step(c.create_api_token, "root@pam", "sync", comment="nightly")
        step(c.create_api_token, "root@pam", "sync")
        step(c.refresh_api_token, "root@pam", "sync")
        step(c.delete_api_token, "root@pam", "sync")
        step(c.delete_api_token, "root@pam", "sync")
        step(c.refresh_api_token, "root@pam", "fresh")
        c.close()
        return out, dict(pbs.api_tokens)
    finally:
        pbs.close()


def test_manager_client_against_mock_pbs_equal(monkeypatch):
    got = _manager(PORT, monkeypatch)
    assert got == _manager(REF, monkeypatch)
    out, tokens = got
    assert out[4] == ("ok", {"tokenid": "root@pam!sync", "value": "ab" * 16})
    assert out[5][0] == "PBSError" and out[8][:2] == ("PBSError", 404)
    assert tokens == {"root@pam!fresh": "ab" * 16}
