"""Windows registry + DPAPI config backend (reference:
internal/agent/registry/registry_windows.go + billgraziano/dpapi).

Same surface as the unix ``agent.registry.Registry`` (get/set/
set_secret/get_secret/delete/keys/seed_from_env) so the lifecycle code
is platform-blind.  Secrets are DPAPI-sealed per machine
(CryptProtectData via ctypes — no pywin32).  Both OS seams are
injectable: ``reg`` is a winreg-shaped object, ``dpapi`` a
protect/unprotect pair — Linux tests inject fakes; on Windows the
defaults bind the real APIs lazily.

A copy of the JAX package's ``agent/win/registry.py``, its code byte for
byte."""

from __future__ import annotations

import base64
import json
from typing import Any, Optional

KEY_PATH = r"SOFTWARE\PBSPlusTPU\Agent"


def _real_winreg():
    import winreg
    return winreg


class _Dpapi:
    """CryptProtectData/CryptUnprotectData via ctypes (DPAPI)."""

    def protect(self, data: bytes) -> bytes:      # pragma: no cover - win
        import ctypes
        from ctypes import wintypes

        class BLOB(ctypes.Structure):
            _fields_ = [("cbData", wintypes.DWORD),
                        ("pbData", ctypes.POINTER(ctypes.c_char))]

        crypt32 = ctypes.windll.crypt32
        kernel32 = ctypes.windll.kernel32
        inp = BLOB(len(data), ctypes.cast(
            ctypes.create_string_buffer(data, len(data)),
            ctypes.POINTER(ctypes.c_char)))
        out = BLOB()
        if not crypt32.CryptProtectData(ctypes.byref(inp), None, None,
                                        None, None, 0, ctypes.byref(out)):
            raise OSError("CryptProtectData failed")
        try:
            return ctypes.string_at(out.pbData, out.cbData)
        finally:
            kernel32.LocalFree(out.pbData)

    def unprotect(self, data: bytes) -> bytes:    # pragma: no cover - win
        import ctypes
        from ctypes import wintypes

        class BLOB(ctypes.Structure):
            _fields_ = [("cbData", wintypes.DWORD),
                        ("pbData", ctypes.POINTER(ctypes.c_char))]

        crypt32 = ctypes.windll.crypt32
        kernel32 = ctypes.windll.kernel32
        inp = BLOB(len(data), ctypes.cast(
            ctypes.create_string_buffer(data, len(data)),
            ctypes.POINTER(ctypes.c_char)))
        out = BLOB()
        if not crypt32.CryptUnprotectData(ctypes.byref(inp), None, None,
                                          None, None, 0, ctypes.byref(out)):
            raise OSError("CryptUnprotectData failed")
        try:
            return ctypes.string_at(out.pbData, out.cbData)
        finally:
            kernel32.LocalFree(out.pbData)


class WinRegistry:
    """winreg-backed key/value store with DPAPI-sealed secrets."""

    def __init__(self, key_path: str = KEY_PATH, *,
                 reg=None, dpapi=None):
        self._reg = reg if reg is not None else _real_winreg()
        self._dpapi = dpapi if dpapi is not None else _Dpapi()
        self._path = key_path

    def _open(self, write: bool = False):
        r = self._reg
        access = r.KEY_READ | (r.KEY_WRITE if write else 0)
        try:
            return r.OpenKey(r.HKEY_LOCAL_MACHINE, self._path, 0, access)
        except OSError:
            if not write:
                raise
            return r.CreateKey(r.HKEY_LOCAL_MACHINE, self._path)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            with self._open() as k:
                val, _typ = self._reg.QueryValueEx(k, key)
        except OSError:
            return default
        try:
            return json.loads(val)
        except (ValueError, TypeError):
            return val

    def set(self, key: str, value: Any) -> None:
        with self._open(write=True) as k:
            self._reg.SetValueEx(k, key, 0, self._reg.REG_SZ,
                                 json.dumps(value))

    def set_secret(self, key: str, value: bytes) -> None:
        sealed = base64.b64encode(self._dpapi.protect(value)).decode()
        with self._open(write=True) as k:
            self._reg.SetValueEx(k, f"sec:{key}", 0, self._reg.REG_SZ,
                                 sealed)

    def get_secret(self, key: str) -> Optional[bytes]:
        try:
            with self._open() as k:
                val, _ = self._reg.QueryValueEx(k, f"sec:{key}")
        except OSError:
            return None
        return self._dpapi.unprotect(base64.b64decode(val))

    def delete(self, key: str) -> None:
        try:
            with self._open(write=True) as k:
                for name in (key, f"sec:{key}"):
                    try:
                        self._reg.DeleteValue(k, name)
                    except OSError:
                        pass
        except OSError:
            pass

    def keys(self) -> list[str]:
        out = []
        try:
            with self._open() as k:
                i = 0
                while True:
                    try:
                        name, _v, _t = self._reg.EnumValue(k, i)
                    except OSError:
                        break
                    out.append(name[4:] if name.startswith("sec:")
                               else name)
                    i += 1
        except OSError:
            pass
        return sorted(set(out))

    def seed_from_env(self, *, environ: dict[str, str] | None = None) -> int:
        """PBS_PLUS_INIT_* → registry values (reference env seeding)."""
        import os
        env = environ if environ is not None else dict(os.environ)
        n = 0
        for k, v in env.items():
            if not k.startswith("PBS_PLUS_INIT_"):
                continue
            name = k[len("PBS_PLUS_INIT_"):].lower()
            if self.get(name) is None:
                self.set(name, v)
                n += 1
        return n
