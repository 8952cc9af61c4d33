"""Agent configuration registry: durable config with sealed secrets.

Reference: internal/agent/registry (992 LoC) — TOML file + flock + AES-GCM
sealed secrets on unix (registry_unix.go:52-155), Windows registry + DPAPI
on Windows, PEM normalization, ``PBS_PLUS_INIT_*`` env seeding.

Here: JSON + flock + utils.crypto sealing (machine-local key file).
Secret values are stored sealed and transparently unsealed on read;
``seed_from_env`` imports PBS_PLUS_INIT_* variables once.

A copy of the JAX package's ``agent/registry.py``, its code byte for
byte apart from its imports, which name the port's own modules; on
Windows ``open_registry`` returns the port's ``agent/win/registry.py``
``WinRegistry``.
"""

from __future__ import annotations

import contextlib
import json
import os

if os.name != "nt":          # fcntl is unix-only; the nt path uses
    import fcntl             # winreg (see open_registry)
from typing import Any, Optional

from ..utils import crypto

SECRET_PREFIX = "sealed:"
ENV_SEED_PREFIX = "PBS_PLUS_INIT_"


def open_registry(path: str, *, key_path: str | None = None):
    """Platform-dispatched config store: flock+AES-GCM TOML file on
    unix (this module's Registry), winreg+DPAPI on Windows
    (agent/win/registry.WinRegistry) — one surface either way
    (reference: registry_unix.go / registry_windows.go split)."""
    if os.name == "nt":
        from .win.registry import WinRegistry
        return WinRegistry()
    return Registry(path, key_path=key_path)


class Registry:
    def __init__(self, path: str, *, key_path: str | None = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock_path = path + ".lock"
        self._key = crypto.load_or_create_key(
            key_path or os.path.join(os.path.dirname(path), "registry.key"))

    # -- inter-process locking --------------------------------------------
    # a dedicated lockfile guards the whole read-modify-write cycle, so
    # concurrent daemon/CLI writers never lose updates (the reference's
    # flock discipline, registry_unix.go)
    @contextlib.contextmanager
    def _locked(self):
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _load(self) -> dict[str, Any]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
        except json.JSONDecodeError:
            raise ValueError(f"corrupt registry {self.path}")

    def _store(self, data: dict[str, Any]) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- typed access ------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        with self._locked():
            v = self._load().get(key, default)
        if isinstance(v, str) and v.startswith(SECRET_PREFIX):
            raise ValueError(f"{key} is a secret; use get_secret")
        return v

    def set(self, key: str, value: Any) -> None:
        with self._locked():
            d = self._load()
            d[key] = value
            self._store(d)

    def set_secret(self, key: str, value: bytes) -> None:
        sealed = crypto.seal(self._key, value, aad=key.encode())
        with self._locked():
            d = self._load()
            d[key] = SECRET_PREFIX + sealed.hex()
            self._store(d)

    def get_secret(self, key: str) -> Optional[bytes]:
        with self._locked():
            v = self._load().get(key)
        if v is None:
            return None
        if not (isinstance(v, str) and v.startswith(SECRET_PREFIX)):
            raise ValueError(f"{key} is not a sealed secret")
        return crypto.unseal(self._key, bytes.fromhex(v[len(SECRET_PREFIX):]),
                             aad=key.encode())

    def delete(self, key: str) -> None:
        with self._locked():
            d = self._load()
            if d.pop(key, None) is not None:
                self._store(d)

    def keys(self) -> list[str]:
        with self._locked():
            return sorted(self._load())

    # -- env seeding (reference: PBS_PLUS_INIT_* at first start) ----------
    def seed_from_env(self, *, environ: dict[str, str] | None = None) -> int:
        env = environ if environ is not None else dict(os.environ)
        with self._locked():
            return self._seed_locked(env)

    def _seed_locked(self, env: dict[str, str]) -> int:
        d = self._load()
        n = 0
        for k, v in env.items():
            if not k.startswith(ENV_SEED_PREFIX):
                continue
            name = k[len(ENV_SEED_PREFIX):].lower()
            if name in d:
                continue                  # seeding never overwrites
            if name.endswith("_secret") or name.endswith("token"):
                sealed = crypto.seal(self._key, v.encode(),
                                     aad=name.encode())
                d[name] = SECRET_PREFIX + sealed.hex()
            else:
                d[name] = v
            n += 1
        if n:
            self._store(d)
        return n


def normalize_pem(pem: str | bytes) -> bytes:
    """PEM normalization (reference: registry PEM handling) — strips
    whitespace variance so fingerprint comparisons are stable."""
    if isinstance(pem, bytes):
        pem = pem.decode()
    lines = [ln.strip() for ln in pem.strip().splitlines() if ln.strip()]
    return ("\n".join(lines) + "\n").encode()
