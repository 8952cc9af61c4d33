"""PBS-ticket authenticator: validate Proxmox Backup Server auth
cookies against the PBS host's signing key.

Reference role: internal/server/web/auth.go:55-297 — the sidecar runs on
a PBS host, reads PBS's own ticket-signing private key
(/etc/proxmox-backup/authkey.key), and accepts the ``PBSAuthCookie`` /
``__Host-PBSAuthCookie`` the PBS web UI already gave the operator, so
the dashboard needs no second login.

Ticket wire format (what PBS emits)::

    PBS:<userid>:<HEXTIME>::<base64 signature over everything left of ::>

The reference tolerates several proxy manglings seen in the field and we
match them: URL-encoded cookies (``%3A%3A`` separator, percent-escaped
left half), a stray leading ``:`` on the signature, ``+`` flattened to
space, and url-safe base64 alphabets.  Signature schemes: Ed25519 (new
PBS) or RSA-PKCS#1v1.5-SHA256 (older PBS), auto-detected from the key.

One deliberate divergence: the reference checks only the signature; we
also enforce the ticket timestamp window (PBS tickets live 2 hours) so a
leaked old cookie cannot authenticate forever.

A copy of the JAX package's ``server/pbsauth.py``, its code byte for
byte apart from its logger (``logging``, one module logger where the
reference imports its own inside the two loaders).
"""

from __future__ import annotations

import base64
import binascii
import logging
import os
import time
import urllib.parse
from dataclasses import dataclass

TICKET_LIFETIME_S = 2 * 3600      # PBS ticket validity
CLOCK_SKEW_S = 300                # tolerate slightly-future timestamps
_PREFIX = "PBS"

L = logging.getLogger(__name__)


@dataclass
class Ticket:
    userid: str
    issued_at: float
    raw_left: str


class PBSTicketAuthenticator:
    """Verifies PBS auth tickets with the PBS host's signing key."""

    def __init__(self, key_pem: bytes, *,
                 lifetime_s: float = TICKET_LIFETIME_S):
        from cryptography.hazmat.primitives.asymmetric import ed25519, rsa
        from cryptography.hazmat.primitives.serialization import (
            load_pem_private_key)
        key = load_pem_private_key(key_pem, password=None)
        if isinstance(key, ed25519.Ed25519PrivateKey):
            self.key_type = "ed25519"
        elif isinstance(key, rsa.RSAPrivateKey):
            self.key_type = "rsa"
        else:
            raise ValueError(f"unsupported PBS auth key type: {type(key)}")
        self._key = key
        self._pub = key.public_key()
        self.lifetime_s = lifetime_s

    @classmethod
    def from_key_file(cls, path: str, **kw) -> "PBSTicketAuthenticator":
        with open(path, "rb") as f:
            return cls(f.read(), **kw)

    # -- verification ------------------------------------------------------
    def verify_ticket(self, cookie_val: str, *,
                      now: float | None = None) -> Ticket | None:
        """Full check: signature AND timestamp window.  Returns the
        parsed ticket on success, None on any failure (never raises on
        malformed input — auth paths must not 500)."""
        try:
            left, sig = _split_ticket(cookie_val)
            if left is None:
                return None
            if not self._verify_signature(left, sig):
                return None
            parts = left.split(":")
            # PBS:<userid>:<HEXTIME>  (userid itself contains no ':' —
            # user@realm — but be lenient and re-join middles)
            if len(parts) < 3 or parts[0] != _PREFIX:
                return None
            userid = ":".join(parts[1:-1])
            issued = float(int(parts[-1], 16))
            t = time.time() if now is None else now
            if issued > t + CLOCK_SKEW_S:
                return None                       # from the future
            if t - issued > self.lifetime_s:
                return None                       # expired
            return Ticket(userid=userid, issued_at=issued, raw_left=left)
        except Exception:
            return None

    def _verify_signature(self, left: str, sig: bytes) -> bool:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        try:
            if self.key_type == "ed25519":
                self._pub.verify(sig, left.encode())
            else:
                self._pub.verify(sig, left.encode(), padding.PKCS1v15(),
                                 hashes.SHA256())
            return True
        except InvalidSignature:
            return False

    # -- minting (tests / mock-PBS contract; real tickets come from PBS) --
    def make_ticket(self, userid: str, *, now: float | None = None) -> str:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding
        t = int(time.time() if now is None else now)
        left = f"{_PREFIX}:{userid}:{t:08X}"
        if self.key_type == "ed25519":
            sig = self._key.sign(left.encode())
        else:
            sig = self._key.sign(left.encode(), padding.PKCS1v15(),
                                 hashes.SHA256())
        return left + "::" + base64.b64encode(sig).decode().rstrip("=")


def _split_ticket(raw: str) -> tuple[str | None, bytes]:
    """Split ``<left>::<b64sig>`` tolerating the reference's field
    manglings (auth.go splitPBS + the signature cleanups)."""
    left = sig_str = None
    if "::" in raw:
        left, sig_str = raw.split("::", 1)
    elif "%3A%3A" in raw:
        left, sig_str = raw.split("%3A%3A", 1)
        if "%" in left:
            left = urllib.parse.unquote(left)
    if left is None or sig_str is None:
        return None, b""
    if sig_str.startswith(":"):
        sig_str = sig_str[1:]
    # trailing whitespace is proxy padding — trim it (reference trims
    # both sides); a LEADING space is '+'-mangling of the signature's
    # first char, so restore rather than strip it
    sig_str = sig_str.rstrip(" \t").lstrip("\t").replace(" ", "+")
    pad = "=" * (-len(sig_str) % 4)
    try:
        return left, base64.b64decode(sig_str + pad, validate=True)
    except (binascii.Error, ValueError):
        if "-" in sig_str or "_" in sig_str:
            try:
                return left, base64.b64decode(sig_str + pad,
                                              altchars=b"-_", validate=True)
            except (binascii.Error, ValueError):
                return None, b""
        return None, b""


class CSRFTokenValidator:
    """PBS ``CSRFPreventionToken`` validation: HMAC over the token
    timestamp + userid with the PBS host's CSRF secret
    (/etc/proxmox-backup/csrf.key).  Token wire format::

        <HEXTIME>:<base64 HMAC-SHA256 over "<HEXTIME>:<userid>">

    Cookie-authenticated state-changing requests must present one (real
    PBS enforces this for its own API; the reference sidecar has no
    CSRF layer — a gap this build closes rather than inherits)."""

    MIN_SECRET_BYTES = 16

    def __init__(self, secret: bytes, *,
                 lifetime_s: float = TICKET_LIFETIME_S):
        secret = secret.strip()
        try:                      # csrf.key ships base64-encoded
            decoded = base64.b64decode(secret, validate=True)
            if decoded:
                secret = decoded
        except (binascii.Error, ValueError):
            pass
        if len(secret) < self.MIN_SECRET_BYTES:
            # an empty/placeholder csrf.key must disable cookie writes,
            # not silently degrade to a forgeable HMAC key
            raise ValueError(
                f"CSRF secret too short ({len(secret)} bytes; "
                f"need >= {self.MIN_SECRET_BYTES})")
        self._secret = secret
        self.lifetime_s = lifetime_s

    @classmethod
    def from_key_file(cls, path: str, **kw) -> "CSRFTokenValidator":
        with open(path, "rb") as f:
            return cls(f.read(), **kw)

    def _mac(self, msg: str) -> str:
        import hashlib
        import hmac
        dig = hmac.new(self._secret, msg.encode(), hashlib.sha256).digest()
        return base64.b64encode(dig).decode().rstrip("=")

    def make_token(self, userid: str, *, now: float | None = None) -> str:
        t = int(time.time() if now is None else now)
        stamp = f"{t:08X}"
        return f"{stamp}:{self._mac(f'{stamp}:{userid}')}"

    def verify_token(self, token: str, userid: str, *,
                     now: float | None = None) -> bool:
        import hmac as hmac_mod
        try:
            stamp, mac = token.split(":", 1)
            issued = float(int(stamp, 16))
        except (ValueError, AttributeError):
            return False
        t = time.time() if now is None else now
        if issued > t + CLOCK_SKEW_S or t - issued > self.lifetime_s:
            return False
        want = self._mac(f"{stamp}:{userid}")
        return hmac_mod.compare_digest(mac.rstrip("="), want)


def parse_allowed_users(spec: str) -> frozenset[str] | None:
    """``pbs_auth_allowed_users`` config: CSV of userids granted sidecar
    access via PBS cookie; ``"*"`` admits any authenticated PBS user;
    default restricts to root@pam (a restricted PBS realm login must not
    escalate to backup-admin — review finding r3)."""
    spec = (spec or "").strip()
    if spec == "*":
        return None                       # no restriction
    if not spec:
        return frozenset({"root@pam"})
    return frozenset(u.strip() for u in spec.split(",") if u.strip())


def load_authenticator(path: str) -> PBSTicketAuthenticator | None:
    """Best-effort load for server startup: absent/garbled key file
    disables ticket auth rather than failing the server."""
    if not path or not os.path.exists(path):
        return None
    try:
        return PBSTicketAuthenticator.from_key_file(path)
    except Exception as e:      # encrypted PEM, odd key types, bad perms
        L.warning("PBS auth key at %s unusable (%s); ticket auth disabled",
                  path, e)
        return None


def load_csrf_validator(path: str) -> CSRFTokenValidator | None:
    """Best-effort load of the PBS CSRF secret (same contract as
    ``load_authenticator``)."""
    if not path or not os.path.exists(path):
        return None
    try:
        return CSRFTokenValidator.from_key_file(path)
    except Exception as e:
        L.warning("PBS CSRF key at %s unusable (%s)", path, e)
        return None
