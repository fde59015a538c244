"""Self-managed PKI for the admission webhook.

Role-equivalent to pkg/admission/webhook_manager.go:57-799's cert handling +
pki/certs.go:39-199: self-signed CA pairs (12-month expiry, keep the best of
two and rotate the older — reference :644-770), server certificates signed by
the freshest CA, and the caBundle used to patch webhook configurations.

The JAX package's admission/pki.py, copied with its imports rewritten to the
port's modules; host code, it touches no device. One difference: each CA
carries a subject key identifier and each server certificate the matching
authority key identifier, as Go's x509 writes them for the reference. The
two CAs share one subject name, and without the identifiers a client that
trusts the bundle may pick the wrong one and fail the signature check.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Tuple

# The PKI needs the `cryptography` package, which an installation may lack
# (the scheduler path never touches it; only the admission webhook binary's
# TLS does). Importing this MODULE stays safe either way: the first actual
# PKI operation raises a clear RuntimeError instead of a deep
# ModuleNotFoundError at import time (the PKI tests skip without it).
try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    HAVE_CRYPTOGRAPHY = True
    _IMPORT_ERROR: Optional[BaseException] = None
except ImportError as _e:  # pragma: no cover - environment-dependent
    HAVE_CRYPTOGRAPHY = False
    _IMPORT_ERROR = _e
    x509 = hashes = serialization = rsa = NameOID = None  # type: ignore


def _require_cryptography() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "the admission webhook's PKI requires the 'cryptography' "
            f"package, which is not installed: {_IMPORT_ERROR}")


CA_VALIDITY_DAYS = 365        # 12-month expiry (reference webhook_manager.go)
SERVER_VALIDITY_DAYS = 365


@dataclasses.dataclass
class CertPair:
    cert_pem: bytes
    key_pem: bytes

    @property
    def certificate(self) -> x509.Certificate:
        return x509.load_pem_x509_certificate(self.cert_pem)

    def expires_at(self) -> datetime.datetime:
        return self.certificate.not_valid_after_utc

    def seconds_until_expiry(self) -> float:
        return (self.expires_at() - datetime.datetime.now(datetime.timezone.utc)).total_seconds()


def _new_key() -> rsa.RSAPrivateKey:
    _require_cryptography()
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _key_pem(key: rsa.RSAPrivateKey) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def generate_ca(common_name: str = "yunikorn-admission-ca") -> CertPair:
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=CA_VALIDITY_DAYS))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_cert_sign=True, crl_sign=True,
            content_commitment=False, key_encipherment=False, data_encipherment=False,
            key_agreement=False, encipher_only=False, decipher_only=False,
        ), critical=True)
        .add_extension(x509.SubjectKeyIdentifier.from_public_key(
            key.public_key()), critical=False)
        .sign(key, hashes.SHA256())
    )
    return CertPair(cert.public_bytes(serialization.Encoding.PEM), _key_pem(key))


def generate_server_cert(ca: CertPair, dns_names: List[str]) -> CertPair:
    ca_cert = ca.certificate
    ca_key = serialization.load_pem_private_key(ca.key_pem, password=None)
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=SERVER_VALIDITY_DAYS))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(n) for n in dns_names]),
            critical=False,
        )
        # both CAs of a collection carry one subject name: the key
        # identifier is what picks the signer out of the bundle
        .add_extension(x509.AuthorityKeyIdentifier.from_issuer_public_key(
            ca_key.public_key()), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return CertPair(cert.public_bytes(serialization.Encoding.PEM), _key_pem(key))


class CACollection:
    """Best-of-two CA rotation (reference webhook_manager.go:644-770).

    Two CA pairs are kept; the freshest signs server certs; when the older one
    crosses the rotation threshold it is regenerated. The combined bundle (both
    CAs) is what webhook configurations carry so rotation never breaks trust.
    """

    ROTATE_BEFORE_SECONDS = 90 * 24 * 3600.0

    def __init__(self, pairs: Optional[List[CertPair]] = None):
        _require_cryptography()
        self.pairs: List[CertPair] = pairs or [generate_ca(), generate_ca()]

    def best(self) -> CertPair:
        return max(self.pairs, key=lambda p: p.expires_at())

    def rotate_if_needed(self) -> bool:
        rotated = False
        for i, pair in enumerate(self.pairs):
            if pair.seconds_until_expiry() < self.ROTATE_BEFORE_SECONDS:
                self.pairs[i] = generate_ca()
                rotated = True
        return rotated

    def ca_bundle(self) -> bytes:
        return b"".join(p.cert_pem for p in self.pairs)

    def server_credentials(self, dns_names: List[str]) -> Tuple[CertPair, bytes]:
        return generate_server_cert(self.best(), dns_names), self.ca_bundle()
