"""Certificate manager: CA, CSR signing, leaf issuance, renewal checks.

Reference: internal/mtls/certManager.go:35 (CertManager), :83 (SignCSR).
The identity model (SURVEY §5.8): the mTLS certificate CN is the routing
key — agents bootstrap with a CSR, the server signs it and stores the cert
in the DB as the "expected" list for aRPC admission.

A copy of the JAX package's ``utils/mtls.py``, its code the same apart
from one local name (``draft``) and one change: ``cryptography`` is
imported inside the functions that use it (``_crypto``), not when the
module is imported, so the package imports on a host without the
wheel.
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import os

_ONE_DAY = _dt.timedelta(days=1)


def _crypto(*names: str):
    """The named ``cryptography`` modules (``x509``, ``hashes``,
    ``serialization``, ``ec``, ``NameOID``), imported on first use so the
    package imports on a host without the wheel."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    mods = {"x509": x509, "hashes": hashes, "serialization": serialization,
            "ec": ec, "NameOID": NameOID}
    return tuple(mods[n] for n in names)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def generate_private_key() -> ec.EllipticCurvePrivateKey:
    (ec,) = _crypto("ec")
    return ec.generate_private_key(ec.SECP256R1())


def key_pem(key: ec.EllipticCurvePrivateKey) -> bytes:
    (serialization,) = _crypto("serialization")
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def cert_pem(cert: x509.Certificate) -> bytes:
    (serialization,) = _crypto("serialization")
    return cert.public_bytes(serialization.Encoding.PEM)


def make_csr(key: ec.EllipticCurvePrivateKey, common_name: str) -> bytes:
    x509, hashes, serialization, NameOID = _crypto(
        "x509", "hashes", "serialization", "NameOID")
    csr = (
        x509.CertificateSigningRequestBuilder()
        .subject_name(x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]))
        .sign(key, hashes.SHA256())
    )
    return csr.public_bytes(serialization.Encoding.PEM)


def cert_fingerprint(cert: x509.Certificate) -> str:
    (hashes,) = _crypto("hashes")
    return cert.fingerprint(hashes.SHA256()).hex()


class CertManager:
    """Owns the CA and issues server/agent leaf certificates.

    Files live under ``cert_dir``: ca.pem / ca.key, server.pem / server.key.
    """

    def __init__(self, cert_dir: str, ca_common_name: str = "pbs-plus-tpu-ca"):
        self.cert_dir = cert_dir
        self.ca_cn = ca_common_name
        self.ca_cert: x509.Certificate | None = None
        self.ca_key: ec.EllipticCurvePrivateKey | None = None

    # -- paths ------------------------------------------------------------
    @property
    def ca_cert_path(self) -> str: return os.path.join(self.cert_dir, "ca.pem")
    @property
    def ca_key_path(self) -> str: return os.path.join(self.cert_dir, "ca.key")
    @property
    def server_cert_path(self) -> str: return os.path.join(self.cert_dir, "server.pem")
    @property
    def server_key_path(self) -> str: return os.path.join(self.cert_dir, "server.key")

    # -- CA lifecycle -----------------------------------------------------
    def load_or_create_ca(self, valid_days: int = 3650) -> None:
        x509, hashes, serialization, ec, NameOID = _crypto(
            "x509", "hashes", "serialization", "ec", "NameOID")
        if os.path.exists(self.ca_cert_path) and os.path.exists(self.ca_key_path):
            with open(self.ca_cert_path, "rb") as f:
                self.ca_cert = x509.load_pem_x509_certificate(f.read())
            with open(self.ca_key_path, "rb") as f:
                key = serialization.load_pem_private_key(f.read(), None)
            assert isinstance(key, ec.EllipticCurvePrivateKey)
            self.ca_key = key
            return
        os.makedirs(self.cert_dir, exist_ok=True)
        key = generate_private_key()
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, self.ca_cn)])
        cert = (
            x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(_now() - _ONE_DAY)
            .not_valid_after(_now() + valid_days * _ONE_DAY)
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False), critical=True)
            .sign(key, hashes.SHA256())
        )
        self.ca_cert, self.ca_key = cert, key
        with open(self.ca_cert_path, "wb") as f:
            f.write(cert_pem(cert))
        fd = os.open(self.ca_key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, key_pem(key))
        finally:
            os.close(fd)

    def validate(self) -> None:
        """Reference: CertManager.Validate during bootstrap."""
        if self.ca_cert is None:
            raise RuntimeError("CA not loaded")
        if self.ca_cert.not_valid_after_utc < _now():
            raise RuntimeError("CA certificate expired")

    # -- issuance ---------------------------------------------------------
    def sign_csr(self, csr_pem: bytes, valid_days: int = 365,
                 server_auth: bool = False) -> bytes:
        """Sign an agent/server CSR (reference: certManager.go:83 SignCSR).
        The CSR's CN is preserved — it becomes the aRPC client identity."""
        x509, hashes, NameOID = _crypto("x509", "hashes", "NameOID")
        assert self.ca_cert is not None and self.ca_key is not None
        csr = x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        eku = [x509.ExtendedKeyUsageOID.CLIENT_AUTH]
        if server_auth:
            eku.append(x509.ExtendedKeyUsageOID.SERVER_AUTH)
        draft = (
            x509.CertificateBuilder()
            .subject_name(csr.subject)
            .issuer_name(self.ca_cert.subject)
            .public_key(csr.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(_now() - _ONE_DAY)
            .not_valid_after(_now() + valid_days * _ONE_DAY)
            .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
            .add_extension(x509.ExtendedKeyUsage(eku), critical=False)
        )
        cn = csr.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        if cn:
            sans: list[x509.GeneralName] = [x509.DNSName(str(cn[0].value))]
            try:
                sans.append(x509.IPAddress(ipaddress.ip_address(str(cn[0].value))))
            except ValueError:
                pass
            sans.append(x509.DNSName("localhost"))
            sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
            draft = draft.add_extension(
                x509.SubjectAlternativeName(sans), critical=False)
        cert = draft.sign(self.ca_key, hashes.SHA256())
        return cert_pem(cert)

    def issue(self, common_name: str, valid_days: int = 365,
              server_auth: bool = False) -> tuple[bytes, bytes]:
        """Issue a fresh key+cert pair directly (server identity, tests)."""
        key = generate_private_key()
        csr = make_csr(key, common_name)
        cert = self.sign_csr(csr, valid_days=valid_days, server_auth=server_auth)
        return cert, key_pem(key)

    def ensure_server_identity(self, common_name: str) -> None:
        x509, NameOID = _crypto("x509", "NameOID")
        if os.path.exists(self.server_cert_path) and os.path.exists(self.server_key_path):
            with open(self.server_cert_path, "rb") as f:
                cert = x509.load_pem_x509_certificate(f.read())
            attrs = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
            cn_matches = bool(attrs) and str(attrs[0].value) == common_name
            chains = False
            if self.ca_cert is not None:
                try:
                    cert.verify_directly_issued_by(self.ca_cert)
                    chains = True
                except Exception:
                    chains = False  # CA rotated → reissue below
            if cn_matches and chains and \
                    cert.not_valid_after_utc > _now() + 30 * _ONE_DAY:
                return
        cert_bytes, key_bytes = self.issue(common_name, server_auth=True)
        with open(self.server_cert_path, "wb") as f:
            f.write(cert_bytes)
        fd = os.open(self.server_key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, key_bytes)
        finally:
            os.close(fd)


def needs_renewal(cert_pem_bytes: bytes, before_days: int = 30) -> bool:
    """Hourly renewal check (reference: cmd/agent/main_unix.go:104-115)."""
    (x509,) = _crypto("x509")
    cert = x509.load_pem_x509_certificate(cert_pem_bytes)
    return cert.not_valid_after_utc < _now() + before_days * _ONE_DAY


def common_name(cert_pem_bytes: bytes) -> str:
    x509, NameOID = _crypto("x509", "NameOID")
    cert = x509.load_pem_x509_certificate(cert_pem_bytes)
    attrs = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
    return str(attrs[0].value) if attrs else ""
