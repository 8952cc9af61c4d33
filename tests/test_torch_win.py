"""The port's Windows agent seams against the JAX package's.

``pbs_plus_tpu_torch.agent.win`` is a copy of ``pbs_plus_tpu.agent.win``:
SIDs, binary security descriptors and SDDL, the ACL, registry, drive,
VSS, service and restore-metadata seams.  On Linux every Windows call
goes through an injected runner, so both packages run the same inputs
(the reference's test inputs plus a seeded set) under one scripted
runner and must give equal bytes, strings, call lists (the service's
command line names its own package), parses and errors.  The four
places where the agent reaches these modules (drives, registry, VSS,
the restore applier) import the port's own ``agent/win`` modules.
Tolerance is exact.
"""

import ast
import asyncio
import json
import os
import re
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

from pbs_plus_tpu.agent.win import acls as ref_acls
from pbs_plus_tpu.agent.win import drives as ref_drives
from pbs_plus_tpu.agent.win import registry as ref_registry
from pbs_plus_tpu.agent.win import restore as ref_restore
from pbs_plus_tpu.agent.win import secdesc as ref_sd
from pbs_plus_tpu.agent.win import service as ref_service
from pbs_plus_tpu.agent.win import vss as ref_vss
from pbs_plus_tpu_torch.agent.win import acls as port_acls
from pbs_plus_tpu_torch.agent.win import drives as port_drives
from pbs_plus_tpu_torch.agent.win import registry as port_registry
from pbs_plus_tpu_torch.agent.win import restore as port_restore
from pbs_plus_tpu_torch.agent.win import secdesc as port_sd
from pbs_plus_tpu_torch.agent.win import service as port_service
from pbs_plus_tpu_torch.agent.win import vss as port_vss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", sd=ref_sd, acls=ref_acls,
                      drives=ref_drives, registry=ref_registry,
                      restore=ref_restore, service=ref_service, vss=ref_vss)
PORT = SimpleNamespace(name="port", sd=port_sd, acls=port_acls,
                       drives=port_drives, registry=port_registry,
                       restore=port_restore, service=port_service,
                       vss=port_vss)


def _outcome(fn, *args):
    """fn(*args), or the error's type name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:          # compared across packages below
        return (type(e).__name__, str(e))


# -- SIDs ---------------------------------------------------------------

_SIDS = ["S-1-5-32-544", "S-1-1-0", "S-1-5-18",
         "S-1-5-21-397955417-626881126-188441444-512", "S-1-15-2-1",
         "X-1-5-18", "S-1-5", "S-1-5-x",
         "S-1-5-" + "-".join(["1"] * 16)]


def _seeded_sids(n=12, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        subs = rng.integers(0, 2**32, int(rng.integers(0, 16)),
                            dtype=np.uint64)
        out.append("S-1-" + str(int(rng.integers(0, 2**40)))
                   + "".join(f"-{int(s)}" for s in subs))
    return out


@pytest.mark.parametrize("sid", _SIDS + _seeded_sids())
def test_sid_bytes_equal(sid):
    got = _outcome(port_sd.sid_to_bytes, sid)
    assert got == _outcome(ref_sd.sid_to_bytes, sid)
    if got[0] == "ok":
        raw = got[1]
        back = _outcome(port_sd.sid_from_bytes, raw)
        assert back == _outcome(ref_sd.sid_from_bytes, raw)
        assert back == ("ok", (sid, len(raw)))


@pytest.mark.parametrize("raw", [b"\x01\x02\x00\x00",
                                 bytes([2, 1, 0, 0, 0, 0, 0, 5, 1, 0, 0, 0]),
                                 b"", bytes([1, 0, 0, 0, 0, 0, 0, 5])])
def test_sid_parse_errors_equal(raw):
    assert _outcome(port_sd.sid_from_bytes, raw) == \
        _outcome(ref_sd.sid_from_bytes, raw)


# -- security descriptors and SDDL -----------------------------------------

_SDDL = [
    "O:BAG:SYD:(A;;FA;;;WD)",
    "O:BAG:BAD:P(A;OICI;FA;;;BA)(A;OICIID;FR;;;BU)(D;;FW;;;AN)",
    "D:(A;;0x1301bf;;;AU)",
    "O:S-1-5-21-1-2-3-512G:BU",
    "O:S-1-5-21-1-2-3-512D:(A;CI;GR;;;WD)",
    "O:SYD:PAI(A;ID;FA;;;SY)S:(AU;SA;FA;;;WD)",
    "O:SYS:P(AU;FA;FA;;;BA)",
    "O:BAD:NO_ACCESS_CONTROL",
    "O:BAD:PNO_ACCESS_CONTROL",
    "D:ARAINO_ACCESS_CONTROL",
    "O:BAD:",
    "O:BAG:SYD:P(A;OICI;FA;;;BA)(D;ID;FR;;;WD)S:(AU;SA;FA;;;SY)",
    "O:BAG:SYD:(A;OICI;FA;;;BA)(A;;FR;;;BU)",
    # rejected
    "D:NO_ACCESS_CONTROL(A;;FA;;;WD)",
    "D:P(A;;FA;;;WD)NO_ACCESS_CONTROL",
    "D:(A;;FA;;;NOPE)", "D:(Z;;FA;;;WD)", "D:(A;QQ;FA;;;WD)",
    "D:(A;;XX;;;WD)", "D:(A;;FA;guid;;WD)",
    "O:S-1-junk'hereD:(A;;FA;;;WD)", "D:(A;;FA;;;S-1-5-x)",
    "O:BA'; Remove-Item -Recurse C:\\ #", "$(Invoke-Expression x)",
    "O:BAD:(A;;FA;;;WD)'; evil '",
]


def _seeded_sddl(n=24, seed=11):
    """Random grammar-valid SDDL over the codec's aliases, flags and
    rights, raw SIDs and hex masks among them."""
    rng = np.random.default_rng(seed)
    aliases = sorted(ref_sd._SID_ALIASES)
    rights = [k for k, _ in ref_sd._RIGHTS_SDDL]
    flags = [f for _, f in ref_sd._ACE_FLAG_SDDL]

    def sid():
        if rng.random() < 0.3:
            return "S-1-5-21-" + "-".join(str(int(x)) for x in
                                          rng.integers(0, 2**32, 4))
        return aliases[int(rng.integers(len(aliases)))]

    def ace(types):
        f = "".join(x for x in flags if rng.random() < 0.25)
        r = (f"0x{int(rng.integers(1, 2**32)):x}" if rng.random() < 0.3
             else "".join(rights[int(i)] for i in
                          rng.choice(len(rights), int(rng.integers(1, 3)),
                                     replace=False)))
        return f"({types[int(rng.integers(len(types)))]};{f};{r};;;{sid()})"

    out = []
    for _ in range(n):
        s = ""
        if rng.random() < 0.8:
            s += "O:" + sid()
        if rng.random() < 0.6:
            s += "G:" + sid()
        ctl = lambda: "".join(c for c in ("P", "AR", "AI")
                              if rng.random() < 0.3)
        if rng.random() < 0.9:
            s += "D:" + ctl() + ("NO_ACCESS_CONTROL" if rng.random() < 0.1
                                 else "".join(ace(["A", "D"]) for _ in
                                              range(int(rng.integers(0, 5)))))
        if rng.random() < 0.3:
            s += "S:" + ctl() + "".join(ace(["AU"]) for _ in
                                        range(int(rng.integers(1, 3))))
        out.append(s)
    return out


def _sd_view(pkg, sddl):
    """What one package makes of an SDDL string: the parse, the
    canonical string, the binary form and its parse back."""
    sd = pkg.sd.SecurityDescriptor.from_sddl(sddl)
    raw = sd.to_bytes()
    back = pkg.sd.SecurityDescriptor.from_bytes(raw)

    def fields(x):
        return (x.owner, x.group, x.control, x.null_dacl,
                [vars(a) for a in x.dacl], [vars(a) for a in x.sacl])
    again = pkg.sd.SecurityDescriptor.from_sddl(sd.to_sddl())
    return (fields(sd), sd.to_sddl(), raw, fields(back), back.to_sddl(),
            fields(again))


@pytest.mark.parametrize("sddl", _SDDL + _seeded_sddl())
def test_security_descriptor_bytes_and_sddl_equal(sddl):
    got = _outcome(_sd_view, PORT, sddl)
    assert got == _outcome(_sd_view, REF, sddl)
    if got[0] == "ok":
        fields, canon, _raw, back, _back_sddl, again = got[1]
        assert again == fields          # SDDL round trip
        assert back[:2] == fields[:2] and back[4:] == fields[4:]


def test_seeded_sddl_set_is_mostly_valid():
    oks = [_outcome(_sd_view, PORT, s)[0] == "ok" for s in _seeded_sddl()]
    assert sum(oks) >= len(oks) - 2


@pytest.mark.parametrize("raw", [b"\x02" + b"\x00" * 30, b"\x01\x00",
                                 b"\xff" * 10, b""])
def test_security_descriptor_parse_errors_equal(raw):
    f = lambda pkg: _outcome(pkg.sd.SecurityDescriptor.from_bytes, raw)
    assert f(PORT) == f(REF)
    assert f(PORT)[0] != "ok"


# -- the runner seams -----------------------------------------------------

class Scripted:
    """A subprocess.run stand-in: records argv, answers by substring."""

    def __init__(self, outputs=None):
        self.calls = []
        self.outputs = outputs or {}

    def __call__(self, argv, check=False, capture_output=False,
                 text=False, timeout=None):
        self.calls.append(list(argv))
        for key, out in self.outputs.items():
            if key in " ".join(argv):
                if isinstance(out, Exception):
                    raise out
                return subprocess.CompletedProcess(argv, 0, out, "")
        return subprocess.CompletedProcess(argv, 0, "" if text else b"", "")


def _norm(calls, pkg):
    """Call lists with the ADS temp files' random names and the
    service's package name normalised."""
    s = json.dumps(calls)
    s = re.sub(r"pbsplus-ads-[A-Za-z0-9_]+", "pbsplus-ads-X", s)
    return json.loads(s.replace("-m pbs_plus_tpu_torch ", "-m PKG ")
                      .replace("-m pbs_plus_tpu ", "-m PKG "))


def _acls_run(pkg):
    sddl = "O:BAG:SYD:(A;OICI;FA;;;BA)(A;;FR;;;BU)"
    run = Scripted({"Get-Acl": sddl + "\n"})
    a = pkg.acls.WinAcls(run=run)
    x = a.to_xattrs(r"C:\it's here\f.txt")
    applied = [a.apply(r"C:\x", s) for s in
               ("O:BAG:SYD:(A;;FA;;;WD)", "O:BA'; Remove-Item C:\\ #",
                "$(Invoke-Expression x)")]
    bad = dict(x)
    bad[pkg.acls.SD_XATTR] = b"\xff" * 10
    back = [a.from_xattrs(r"C:\g", x), a.from_xattrs(r"C:\g", bad),
            a.from_xattrs(r"C:\g", {})]
    return run.calls, x, applied, back


def _registry_run(pkg):
    from test_win_seams import FakeDpapi, FakeWinreg
    reg = FakeWinreg()
    r = pkg.registry.WinRegistry(reg=reg, dpapi=FakeDpapi())
    r.set("server_url", "https://pbs:8017")
    r.set("n", 5)
    r.set_secret("bootstrap", b"\x01\x02secret")
    got = [r.get("server_url"), r.get("n"), r.get("missing", "dflt"),
           r.get_secret("bootstrap"), sorted(r.keys())]
    r.delete("bootstrap")
    r.delete("never")
    got += [r.get_secret("bootstrap"),
            r.seed_from_env(environ={"PBS_PLUS_INIT_SERVER_URL": "x",
                                     "PBS_PLUS_INIT_NEWKEY": "y",
                                     "OTHER": "z"}),
            r.get("newkey")]
    return got, dict(reg.store)


_DISKS = json.dumps([
    {"DeviceID": "C:", "FileSystem": "NTFS", "Size": 1000,
     "FreeSpace": 400, "DriveType": 3},
    {"DeviceID": "D:", "FileSystem": "exFAT", "Size": 64,
     "FreeSpace": 60, "DriveType": 2},
    {"DeviceID": "E:", "FileSystem": None, "Size": None,
     "FreeSpace": None, "DriveType": 3},
    {"DeviceID": "Z:", "FileSystem": "NTFS", "Size": 9,
     "FreeSpace": 1, "DriveType": 4}])


def _drives_run(pkg):
    out = []
    for payload in (_DISKS, json.dumps({"DeviceID": "C:", "FileSystem": "NTFS",
                                        "Size": 5, "FreeSpace": 2,
                                        "DriveType": 3}), "", "not json"):
        run = Scripted({"Win32_LogicalDisk": payload})
        out.append((_outcome(lambda: pkg.drives.enumerate_drives_windows(
            run=run)), run.calls))
    return out


def _vss_run(pkg):
    run = Scripted({
        "Win32_ShadowCopy": json.dumps({"ReturnValue": 0,
                                        "ShadowID": "{3f00-aa}"}),
        "list shadows": ("Contents of shadow copy set ID ...\n"
                         "   Shadow Copy Volume: \\\\?\\GLOBALROOT\\Device"
                         "\\HarddiskVolumeShadowCopy7\n")})
    h = pkg.vss.VssHandler(run=run)
    snap = h.create(r"C:\Users\data")
    h.cleanup(snap)
    fail = Scripted({"Win32_ShadowCopy": json.dumps({"ReturnValue": 5,
                                                     "ShadowID": ""})})
    err = _outcome(pkg.vss.VssHandler(run=fail).create, r"D:\x")
    return (vars(snap), run.calls, err, fail.calls,
            [h.available(t) for t in ("ntfs", "NTFS", "refs", "ext4")])


def _service_run(pkg):
    run = Scripted()
    s = pkg.service.WinService(run=run)
    s.install(server="pbs:8008", state_dir=r"C:\ProgramData\pbs")
    s.start()
    s.stop()
    s.uninstall()
    return _norm(run.calls, pkg)


def _applier_run(pkg):
    R = pkg.restore
    run = Scripted()
    app = R.WinMetaApplier(run=run)
    app.apply(r"C:\data\f.txt", 1_753_750_000 * 10**9, {
        "win.sddl": b"O:BAG:SYD:(A;;FA;;;WD)",
        R.ATTRS_XATTR: b"READONLY,HIDDEN",
        R.ADS_PREFIX + "Zone.Identifier": b"[ZoneTransfer]\r\nZoneId=3"})
    app.apply(r"C:\x", 0, {R.ADS_PREFIX + "..\\evil": b"x",
                           R.ADS_PREFIX + "a'; rm -rf '": b"x"})
    flags = [app.apply_attributes(r"C:\x", {R.ATTRS_XATTR: b"SPARKLE"}),
             app.apply_attributes(r"C:\x", {R.ATTRS_XATTR: b"READONLY"},
                                  is_symlink=True)]

    class FailAcls:
        def from_xattrs(self, path, xattrs):
            return False
    app3 = R.WinMetaApplier(run=Scripted(), acls=FailAcls())
    app3.apply(r"C:\x", 0, {"win.sddl": b"garbage"})
    broken = R.WinMetaApplier(run=Scripted({"LastWriteTimeUtc":
                                            OSError("denied")}))
    broken.apply(r"C:\y", 5, {})
    cap_run = Scripted({"Get-Acl": "O:BAG:SY\n",
                        ".Attributes.ToString()": "Archive, Hidden, Bogus\n",
                        "-Stream * |": "Zone.Identifier\nbad'name\n",
                        "ToBase64String": "aGVsbG8=\n"})
    cap = R.WinMetaCapture(run=cap_run).capture(r"C:\c.txt")
    return (_norm(run.calls, pkg), app.errors, flags, app3.errors,
            broken.errors, cap, _norm(cap_run.calls, pkg))


SEAMS = {"acls": _acls_run, "registry": _registry_run,
         "drives": _drives_run, "vss": _vss_run, "service": _service_run,
         "applier": _applier_run}


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_seam_call_lists_and_results_equal(seam):
    got = SEAMS[seam](PORT)
    assert got == SEAMS[seam](REF)
    if seam == "service":
        assert "-m PKG agent" in got[0][4]
    if seam == "acls":
        assert got[2] == [True, False, False]


def test_service_registers_the_port_command():
    run = Scripted()
    port_service.WinService(run=run).install(server="s:8008", state_dir="C:\\")
    bin_path = run.calls[0][4]
    assert " -m pbs_plus_tpu_torch agent --server s:8008 " in bin_path


def test_restore_engine_drives_port_applier_only_for_win_entries(tmp_path):
    from pbs_plus_tpu_torch.agent.restore import RestoreEngine
    from pbs_plus_tpu_torch.pxar.format import KIND_DIR, KIND_FILE, Entry

    class FakeClient:
        tree = {"": [Entry(path="plain.txt", kind=KIND_FILE, mode=0o644,
                           size=5, mtime_ns=10**18),
                     Entry(path="winfile.txt", kind=KIND_FILE, mode=0o644,
                           size=5, mtime_ns=10**18,
                           xattrs={port_restore.ATTRS_XATTR: b"ARCHIVE",
                                   "win.sddl": b"O:BAG:SYD:(A;;FA;;;WD)"}),
                     Entry(path="sub", kind=KIND_DIR, mode=0o755,
                           xattrs={"win.attrs": b"HIDDEN"})],
                "sub": [Entry(path="sub/x", kind=KIND_FILE, mode=0o644,
                              size=5, mtime_ns=10**18)]}

        async def root(self):
            return Entry(path="", kind=KIND_DIR, mode=0o755)

        async def read_dir(self, rel):
            return self.tree.get(rel, [])

        async def read_at(self, rel, off, n):
            return b"hello"[off:off + n]

        async def done(self):
            pass

    run = Scripted()
    eng = RestoreEngine(FakeClient(), str(tmp_path / "out"), verify=False,
                        apply_ownership=False,
                        win_meta=port_restore.WinMetaApplier(run=run))
    res = asyncio.run(eng.run())
    assert res.files == 3 and not res.errors
    joined = "\n".join(c[-1] for c in run.calls)
    assert "winfile.txt" in joined and "sub" in joined
    assert "plain.txt" not in joined and "sub\\x" not in joined \
        and "sub/x" not in joined
    assert (tmp_path / "out" / "plain.txt").read_bytes() == b"hello"


_STUBS = {"agent/drives.py": "win.drives", "agent/registry.py": "win.registry",
          "agent/snapshots.py": "win.vss", "agent/restore.py": "win.restore"}


@pytest.mark.parametrize("rel", sorted(_STUBS))
def test_former_stubs_import_the_port_win_modules(rel):
    """Each Windows branch imports ``pbs_plus_tpu_torch.agent.win.*`` (a
    relative import inside the port's ``agent`` package), and nothing
    in the port raises naming ``agent/win`` any more."""
    path = os.path.join(REPO, "pbs_plus_tpu_torch", rel)
    tree = ast.parse(open(path).read())
    rels = [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 1]
    assert _STUBS[rel] in rels
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Raise)
                and "agent/win" in ast.unparse(n)]
    import importlib
    mod = importlib.import_module("pbs_plus_tpu_torch." + _STUBS[rel]
                                  .replace("win.", "agent.win."))
    assert mod.__name__.startswith("pbs_plus_tpu_torch.agent.win")


def test_windows_branches_take_the_port_modules(monkeypatch, tmp_path):
    """With ``os.name`` set to ``"nt"`` the agent's drive, registry, VSS
    and restore branches build the port's own Windows objects."""
    import pbs_plus_tpu_torch.agent.drives as drives
    import pbs_plus_tpu_torch.agent.registry as registry
    import pbs_plus_tpu_torch.agent.restore as restore
    import pbs_plus_tpu_torch.agent.snapshots as snapshots
    got = {}
    monkeypatch.setattr(port_drives, "enumerate_drives_windows",
                        lambda: ["win-drives"])
    monkeypatch.setattr(port_registry, "_real_winreg", lambda: "winreg")
    with monkeypatch.context() as m:
        m.setattr(os, "name", "nt")
        got["drives"] = drives.enumerate_drives()
        got["registry"] = type(registry.open_registry(str(tmp_path / "r")))
        got["vss"] = [type(h) for h in snapshots.SnapshotManager().handlers]
        got["restore"] = type(restore.RestoreEngine(
            None, str(tmp_path / "o")).win_meta)
    assert got == {"drives": ["win-drives"],
                   "registry": port_registry.WinRegistry,
                   "vss": [port_vss.VssHandler],
                   "restore": port_restore.WinMetaApplier}
