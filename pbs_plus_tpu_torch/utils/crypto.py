"""Secret sealing and hashing helpers.

Reference: internal/crypto — AES-GCM sealed secrets (agent registry,
DB-stored credentials), FIPS assertion, sha256 helpers.  The reference seals
DB secrets via ``crypto.Seal`` (internal/server/store/store.go:21) and agent
registry secrets on unix (internal/agent/registry/registry_unix.go:52-155).

A copy of the JAX package's ``utils/crypto.py``, its code byte for
byte.
"""

from __future__ import annotations

import hashlib
import hmac
import os

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:         # image lacks the wheel: importing this module
    AESGCM = None           # must not poison every transitive importer
                            # (server.database, server.backup_job, agent.
                            # registry); seal/unseal raise lazily instead

_NONCE_LEN = 12
_KEY_LEN = 32


def _require_aesgcm() -> None:
    if AESGCM is None:
        raise RuntimeError(
            "secret sealing unavailable: the 'cryptography' package is "
            "not installed in this image")


def generate_key() -> bytes:
    return os.urandom(_KEY_LEN)


def seal(key: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """AES-256-GCM seal: nonce || ciphertext+tag."""
    _require_aesgcm()
    if len(key) != _KEY_LEN:
        raise ValueError("seal key must be 32 bytes")
    nonce = os.urandom(_NONCE_LEN)
    return nonce + AESGCM(key).encrypt(nonce, plaintext, aad)


def unseal(key: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    _require_aesgcm()
    if len(key) != _KEY_LEN:
        raise ValueError("seal key must be 32 bytes")
    if len(sealed) < _NONCE_LEN + 16:
        raise ValueError("sealed blob too short")
    nonce, ct = sealed[:_NONCE_LEN], sealed[_NONCE_LEN:]
    return AESGCM(key).decrypt(nonce, ct, aad)


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def constant_time_equal(a: bytes, b: bytes) -> bool:
    return hmac.compare_digest(a, b)


def load_or_create_key(path: str) -> bytes:
    """Persist a sealing key at ``path`` with 0600 perms (reference: server
    secret-key generation during bootstrap, internal/server/bootstrap.go:34)."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            key = f.read()
        if len(key) != _KEY_LEN:
            raise ValueError(f"corrupt key file {path}")
        return key
    key = generate_key()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    except FileExistsError:
        # concurrent bootstrap: another process won the O_EXCL race
        with open(path, "rb") as f:
            key = f.read()
        if len(key) != _KEY_LEN:
            raise ValueError(f"corrupt key file {path}")
        return key
    try:
        os.write(fd, key)
    finally:
        os.close(fd)
    return key
