"""Windows restore metadata: file attributes, timestamps, alternate
data streams, and ACLs re-applied from archive xattrs.

Reference parity: internal/pxar/restore_windows.go —
``applyMeta`` (SetFileTime + basic-info attributes, :39-127),
``restoreWindowsACLsFromPath`` (:129-154),
``writeAlternateDataStreams`` (:268-282), and
``buildFileAttributes`` (:295-311).  The capture side mirrors what the
Windows agentfs emits so Linux↔Windows archives stay structurally
identical: everything rides the entry xattr map.

Xattr vocabulary (the wire contract both sides share):

- ``win.sddl`` / ``win.sd``  — security descriptor (``acls.py``)
- ``win.attrs``              — comma-joined attribute tokens
                               (READONLY,HIDDEN,SYSTEM,ARCHIVE)
- ``win.ads.<name>``         — one alternate data stream's bytes

Like every ``agent/win`` module, all host interaction goes through an
injectable PowerShell runner so the protocol is testable off-Windows;
attributes are applied BEFORE the readonly bit would block later steps,
and never to reparse points (restore_windows.go:222-224 — writing
attributes could clear FILE_ATTRIBUTE_REPARSE_POINT).

A copy of the JAX package's ``agent/win/restore.py``, its code byte for
byte apart from its logger: ``utils/log.L`` becomes a ``logging``
logger."""

from __future__ import annotations

import logging
import re
import subprocess

from .acls import Runner, WinAcls, _ps, _q

L = logging.getLogger(__name__)

ATTRS_XATTR = "win.attrs"
ADS_PREFIX = "win.ads."
# the restorable subset, exactly the reference's buildFileAttributes map
ATTR_TOKENS = ("READONLY", "HIDDEN", "SYSTEM", "ARCHIVE")
_ADS_NAME_RE = re.compile(r"[A-Za-z0-9_. \-]{1,255}\Z")

# byte-mode flags differ between Windows PowerShell 5.1 (-Encoding Byte)
# and pwsh 6+ (-AsByteStream); the script branches at runtime so either
# host works (restore_windows.go has no such problem — it calls Win32)
_BYTE_FLAG = ("$bf = if ($PSVersionTable.PSVersion.Major -ge 6) "
              "{ @{AsByteStream=$true} } else { @{Encoding='Byte'} }; ")


class WinMetaApplier:
    """Applies Windows-only entry metadata after content lands."""

    def __init__(self, *, run: Runner = subprocess.run,
                 acls: WinAcls | None = None):
        self._run = run
        self.acls = acls if acls is not None else WinAcls(run=run)
        self.errors: list[str] = []

    def _sh(self, what: str, path: str, script: str) -> bool:
        try:
            self._run(_ps(script), check=True, capture_output=True,
                      timeout=60)
            return True
        except Exception as e:
            self.errors.append(f"{path}: {what}: {e}")
            return False

    # -- pieces ----------------------------------------------------------
    def apply_attributes(self, path: str, xattrs: dict[str, bytes],
                         *, is_symlink: bool = False) -> bool:
        raw = xattrs.get(ATTRS_XATTR)
        if not raw or is_symlink:
            # never touch attribute bits on a reparse point
            return False
        tokens = [t for t in raw.decode(errors="replace").upper().split(",")
                  if t in ATTR_TOKENS]
        if not tokens:
            return False
        val = ", ".join(t.capitalize() for t in tokens)
        return self._sh("set attributes", path,
                        f"(Get-Item -LiteralPath {_q(path)} -Force)"
                        f".Attributes = {_q(val)}")

    def apply_times(self, path: str, mtime_ns: int) -> bool:
        if mtime_ns <= 0:
            return False
        secs = mtime_ns / 1e9
        script = (f"$t = [DateTimeOffset]::FromUnixTimeMilliseconds("
                  f"{int(secs * 1000)}).UtcDateTime; "
                  f"$i = Get-Item -LiteralPath {_q(path)} -Force; "
                  f"$i.LastWriteTimeUtc = $t")
        return self._sh("set file time", path, script)

    def apply_streams(self, path: str, xattrs: dict[str, bytes]) -> int:
        """Alternate data streams: ``win.ads.<name>`` → ``path:<name>``.
        Stream names are validated — a tampered archive must not smuggle
        path separators or PowerShell metacharacters into the target.
        Bytes travel via a temp file, never the command line (the
        CreateProcess command line caps at 32K chars — inline base64
        would break any stream over ~24 KB)."""
        import os
        import tempfile
        n = 0
        for key, data in sorted(xattrs.items()):
            if not key.startswith(ADS_PREFIX):
                continue
            name = key[len(ADS_PREFIX):]
            if not _ADS_NAME_RE.fullmatch(name):
                self.errors.append(f"{path}: ADS name rejected: {name!r}")
                continue
            fd, tmp = tempfile.mkstemp(prefix="pbsplus-ads-")
            try:
                os.write(fd, data)
                os.close(fd)
                script = (_BYTE_FLAG +
                          f"Set-Content -LiteralPath {_q(path)} "
                          f"-Stream {_q(name)} -Value "
                          f"(Get-Content -LiteralPath {_q(tmp)} "
                          f"-Raw @bf) -Force @bf")
                if self._sh(f"write ADS {name}", path, script):
                    n += 1
            finally:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return n

    # -- the applyMeta analog -------------------------------------------
    def apply(self, path: str, mtime_ns: int, xattrs: dict[str, bytes],
              *, is_symlink: bool = False) -> None:
        """Order matters (restore_windows.go applyMeta): ACLs and
        streams first, then attributes, then times LAST — earlier steps
        rewrite the file and would bump LastWriteTime; and a readonly
        attribute set early would block the stream writes."""
        from .acls import SD_XATTR, SDDL_XATTR
        if not is_symlink:
            has_acl = SD_XATTR in xattrs or SDDL_XATTR in xattrs
            if has_acl and not self.acls.from_xattrs(path, xattrs):
                # the security-critical step must never fail silently
                self.errors.append(f"{path}: ACL restore failed")
            self.apply_streams(path, xattrs)
        self.apply_attributes(path, xattrs, is_symlink=is_symlink)
        self.apply_times(path, mtime_ns)


class WinMetaCapture:
    """Capture side: what the Windows agentfs walk attaches per entry
    (the GetWinACLs + FindStreams + attribute read of the reference's
    Windows server, agentfs/acls_windows.go + syscalls_windows.go)."""

    def __init__(self, *, run: Runner = subprocess.run,
                 acls: WinAcls | None = None):
        self._run = run
        self.acls = acls if acls is not None else WinAcls(run=run)

    def capture(self, path: str) -> dict[str, bytes]:
        out: dict[str, bytes] = {}
        out.update(self.acls.to_xattrs(path))
        try:
            r = self._run(_ps(
                f"(Get-Item -LiteralPath {_q(path)} -Force)"
                f".Attributes.ToString()"), check=True,
                capture_output=True, text=True, timeout=60)
            tokens = [t.strip().upper() for t in r.stdout.split(",")]
            keep = [t for t in tokens if t in ATTR_TOKENS]
            if keep:
                out[ATTRS_XATTR] = ",".join(keep).encode()
        except Exception as e:
            L.debug("attribute capture skipped for %s: %s", path, e)
        try:
            r = self._run(_ps(
                f"Get-Item -LiteralPath {_q(path)} -Stream * | "
                f"Where-Object Stream -ne ':$DATA' | "
                f"Select-Object -ExpandProperty Stream"), check=True,
                capture_output=True, text=True, timeout=60)
            for name in (ln.strip() for ln in r.stdout.splitlines()):
                if not name or not _ADS_NAME_RE.fullmatch(name):
                    continue
                rb = self._run(_ps(
                    _BYTE_FLAG +
                    f"[Convert]::ToBase64String((Get-Content -LiteralPath "
                    f"{_q(path)} -Stream {_q(name)} -Raw @bf))"),
                    check=True, capture_output=True, text=True, timeout=60)
                import base64
                out[ADS_PREFIX + name] = base64.b64decode(
                    rb.stdout.strip() or "")
        except Exception as e:
            L.debug("ADS capture skipped for %s: %s", path, e)
        return out
