"""Windows ACL capture/restore (reference:
internal/agent/agentfs/acls_windows.go:1-310 — per-file security
descriptors carried through the archive).

Protocol: SDDL strings via PowerShell (runner-seam testable):

    capture: (Get-Acl -LiteralPath <p>).Sddl
    restore: $a = Get-Acl -LiteralPath <p>; $a.SetSecurityDescriptorSddl
             Form('<sddl>'); Set-Acl -LiteralPath <p> -AclObject $a

The SDDL travels in the archive's xattr map under ``win.sddl`` (the
unix build carries POSIX ACLs under ``system.posix_acl_access`` the
same way), so Linux↔Windows archives stay structurally identical.

A copy of the JAX package's ``agent/win/acls.py``, its code byte for
byte."""

from __future__ import annotations

import re
import struct
import subprocess
from typing import Callable

Runner = Callable[..., "subprocess.CompletedProcess"]

SDDL_XATTR = "win.sddl"
SD_XATTR = "win.sd"            # binary self-relative SECURITY_DESCRIPTOR


def _ps(script: str) -> list[str]:
    return ["powershell", "-NoProfile", "-NonInteractive", "-Command",
            script]


def _q(path: str) -> str:
    return "'" + path.replace("'", "''") + "'"


class WinAcls:
    def __init__(self, *, run: Runner = subprocess.run):
        self._run = run

    def capture(self, path: str) -> str:
        """SDDL of ``path`` ('' when unreadable — never fails a walk)."""
        try:
            r = self._run(_ps(f"(Get-Acl -LiteralPath {_q(path)}).Sddl"),
                          check=True, capture_output=True, text=True,
                          timeout=60)
            return r.stdout.strip()
        except Exception:
            return ""

    def apply(self, path: str, sddl: str) -> bool:
        """Apply an SDDL from an archive.  The SDDL is UNTRUSTED input
        (a tampered archive must not execute PowerShell as the agent):
        parse it with the structured codec and apply the CANONICAL
        re-emission — only grammar-valid SDDL ever reaches PowerShell.
        Descriptors beyond the codec's grammar (object/conditional
        ACEs) fall back to a strict charset allowlist."""
        if not sddl:
            return False
        from .secdesc import SecurityDescriptor
        try:
            sddl = SecurityDescriptor.from_sddl(sddl).to_sddl()
        except (ValueError, struct.error):
            if not re.fullmatch(r"[A-Za-z0-9:;()\-_. ]+", sddl):
                return False
        script = (f"$a = Get-Acl -LiteralPath {_q(path)}; "
                  f"$a.SetSecurityDescriptorSddlForm({_q(sddl)}); "
                  f"Set-Acl -LiteralPath {_q(path)} -AclObject $a")
        try:
            self._run(_ps(script), check=True, capture_output=True,
                      timeout=60)
            return True
        except Exception:
            return False

    def to_xattrs(self, path: str) -> dict[str, bytes]:
        """Archive form: the SDDL string, plus the binary descriptor
        when the SDDL round-trips through the structured codec (so
        restores can use either; inspection tools get typed ACEs)."""
        sddl = self.capture(path)
        if not sddl:
            return {}
        out = {SDDL_XATTR: sddl.encode()}
        from .secdesc import SecurityDescriptor
        try:
            out[SD_XATTR] = SecurityDescriptor.from_sddl(sddl).to_bytes()
        except (ValueError, struct.error):
            pass                     # beyond codec grammar: SDDL only
        return out

    def from_xattrs(self, path: str, xattrs: dict[str, bytes]) -> bool:
        """Restore precedence: binary descriptor (rendered to canonical
        SDDL by the codec) over the raw SDDL string."""
        raw_sd = xattrs.get(SD_XATTR)
        if raw_sd:
            from .secdesc import SecurityDescriptor
            try:
                return self.apply(
                    path, SecurityDescriptor.from_bytes(raw_sd).to_sddl())
            except (ValueError, struct.error):
                pass                 # corrupt binary: try the string
        raw = xattrs.get(SDDL_XATTR)
        return self.apply(path, raw.decode()) if raw else False
