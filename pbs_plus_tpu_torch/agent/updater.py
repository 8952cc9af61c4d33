"""Agent self-update: version poll, signed download, staged binary swap
with boot watchdog + rollback.

Reference: internal/agent/updater/updater.go:70-486 (poll server version,
download binary + ECDSA/Ed25519 signature verify, staged swap),
watchdog.go:11-33 (pending-update marker on boot, health mark after first
successful connect, rollback via grace window), binswap/binswap.go:26
(atomic binary swap with .old retention).

Artifacts here are the agent's code bundle (a tar/zip or single file);
the swap mechanics are identical to the reference's ELF swap: stage →
atomic rename with previous retained → watchdog marker → health
confirmation or rollback.

A copy of the JAX package's ``agent/updater.py``, its code byte for
byte apart from its logger (``logging``).  Keys and signatures are the
same bytes in both packages: an artifact signed by either package's
``signer`` verifies under the other's ``verify_signature``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, ed25519, padding

L = logging.getLogger(__name__)

GRACE_WINDOW_S = 10 * 60.0       # rollback window after a swap


def verify_signature(data: bytes, signature: bytes, pubkey_pem: bytes) -> bool:
    """ECDSA-P256/SHA-256 or Ed25519, keyed by the public key type
    (reference: dual ECDSA/Ed25519 verify)."""
    try:
        key = serialization.load_pem_public_key(pubkey_pem)
        if isinstance(key, ed25519.Ed25519PublicKey):
            key.verify(signature, data)
        elif isinstance(key, ec.EllipticCurvePublicKey):
            key.verify(signature, data, ec.ECDSA(hashes.SHA256()))
        else:
            return False
        return True
    except (InvalidSignature, ValueError):
        return False


@dataclass
class SwapState:
    target_path: str             # the live binary/bundle path
    state_dir: str               # staging + markers

    @property
    def staged_path(self) -> str:
        return os.path.join(self.state_dir, "staged.bin")

    @property
    def old_path(self) -> str:
        return os.path.join(self.state_dir, "previous.bin")

    @property
    def marker_path(self) -> str:
        return os.path.join(self.state_dir, "pending-update.json")


class BinSwap:
    """Staged atomic swap with rollback (reference: internal/agent/binswap)."""

    def __init__(self, state: SwapState):
        self.st = state
        os.makedirs(state.state_dir, exist_ok=True)

    def stage(self, data: bytes, version: str) -> None:
        tmp = self.st.staged_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self.st.staged_path)
        with open(self.st.marker_path + ".tmp", "w") as f:
            json.dump({"version": version, "staged_at": time.time(),
                       "state": "staged"}, f)
        os.replace(self.st.marker_path + ".tmp", self.st.marker_path)

    def swap(self) -> None:
        """Move live → previous, staged → live; marker enters the grace
        window (watchdog decides commit or rollback)."""
        if not os.path.exists(self.st.staged_path):
            raise FileNotFoundError("no staged update")
        if os.path.exists(self.st.target_path):
            os.replace(self.st.target_path, self.st.old_path)
        os.replace(self.st.staged_path, self.st.target_path)
        m = self._marker()
        m.update(state="swapped", swapped_at=time.time())
        self._write_marker(m)

    def rollback(self) -> bool:
        if not os.path.exists(self.st.old_path):
            return False
        os.replace(self.st.old_path, self.st.target_path)
        m = self._marker()
        m.update(state="rolled-back", rolled_back_at=time.time())
        self._write_marker(m)
        L.warning("update rolled back to previous version")
        return True

    def commit(self) -> None:
        """Health confirmed: drop the previous version + marker."""
        try:
            os.unlink(self.st.old_path)
        except OSError:
            pass
        try:
            os.unlink(self.st.marker_path)
        except OSError:
            pass

    def _marker(self) -> dict:
        try:
            with open(self.st.marker_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _write_marker(self, m: dict) -> None:
        with open(self.st.marker_path + ".tmp", "w") as f:
            json.dump(m, f)
        os.replace(self.st.marker_path + ".tmp", self.st.marker_path)


class Watchdog:
    """Boot-time update accounting (reference: updater/watchdog.go).

    Call ``on_boot()`` at service start: if a swap is pending past its
    grace window without a health mark, roll back.  Call
    ``mark_healthy()`` after the first successful server connect."""

    def __init__(self, swap: BinSwap, *, grace_s: float = GRACE_WINDOW_S):
        self.swap = swap
        self.grace_s = grace_s

    def on_boot(self) -> str:
        m = self.swap._marker()
        state = m.get("state")
        if state != "swapped":
            return "no-pending"
        # the grace clock starts at the FIRST BOOT of the new binary, not
        # at swap time: a long-running service may swap hours before its
        # next restart, and that delay says nothing about binary health
        now = time.time()
        first_boot = m.get("first_boot_at")
        if first_boot is not None and now - first_boot > self.grace_s:
            return "rolled-back" if self.swap.rollback() else "rollback-failed"
        boots = m.get("boots", 0) + 1
        if boots >= 3:                      # crash-looping on the new binary
            return "rolled-back" if self.swap.rollback() else "rollback-failed"
        m["boots"] = boots
        if first_boot is None:
            m["first_boot_at"] = now
        self.swap._write_marker(m)
        return "grace"

    def mark_healthy(self) -> None:
        m = self.swap._marker()
        if m.get("state") == "swapped":
            self.swap.commit()
            L.info("update confirmed healthy (version %s)", m.get("version"))


class Updater:
    """Poll → verify → stage → swap (reference: updater.go)."""

    def __init__(self, swap: BinSwap, *, current_version: str,
                 signing_pubkey_pem: bytes):
        self.swap = swap
        self.current_version = current_version
        self.pubkey = signing_pubkey_pem

    async def check_and_stage(self, http, base_url: str) -> Optional[str]:
        """Returns the staged version if an update was downloaded."""
        async with http.get(f"{base_url}/plus/agent/version") as r:
            if r.status != 200:
                return None
            info = await r.json()
        if info.get("version") == self.current_version:
            return None
        async with http.get(f"{base_url}/plus/agent/binary") as r:
            if r.status != 200:
                return None
            data = await r.read()
        sig = bytes.fromhex(info.get("signature", ""))
        if not verify_signature(data, sig, self.pubkey):
            L.error("update signature verification FAILED — discarding")
            return None
        self.swap.stage(data, info["version"])
        L.info("update %s staged", info["version"])
        return info["version"]
