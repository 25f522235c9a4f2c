"""TLS: self-signed server certs + hot-reloading credentials.

Mirror of reference internal/tls/tls.go:33-74 (10-year self-signed cert,
generated at startup when no cert dir is mounted) and pkg/common/certs.go:
35-103 (filesystem watcher + debounce hot-reload). The reloader plugs into
grpc.dynamic_ssl_server_credentials so mounted cert rotations apply without
restarting the listener.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional

import grpc


def create_self_signed_cert(
    common_name: str = "gie-tpu-epp", days: int = 3650
) -> tuple[bytes, bytes]:
    """(cert_pem, key_pem); RSA-4096, 10-year validity like the reference
    (tls.go:38-52).

    cryptography imports lazily: only the self-signed path needs it, and
    containers serving with mounted certs (or --insecure-serving) must not
    fail to IMPORT the runtime because an optional generator dependency is
    absent."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=4096)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(common_name),
                                         x509.DNSName("localhost")]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


class CertReloader:
    """Poll-based cert hot-reloader (fsnotify equivalent; 250 ms debounce
    like reference certs.go:60-80)."""

    def __init__(self, cert_path: str, key_path: str, poll_s: float = 0.25):
        self.cert_path = cert_path
        self.key_path = key_path
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._mtimes: tuple[float, float] = (0.0, 0.0)
        self._current: Optional[tuple[bytes, bytes]] = None
        self._stop = threading.Event()
        self._load()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def current(self) -> tuple[bytes, bytes]:
        with self._lock:
            assert self._current is not None
            return self._current

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def _load(self) -> None:
        with open(self.cert_path, "rb") as f:
            cert = f.read()
        with open(self.key_path, "rb") as f:
            key = f.read()
        with self._lock:
            self._current = (cert, key)
            self._mtimes = (
                os.path.getmtime(self.cert_path),
                os.path.getmtime(self.key_path),
            )

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                m = (
                    os.path.getmtime(self.cert_path),
                    os.path.getmtime(self.key_path),
                )
                if m != self._mtimes:
                    # Debounce: let the writer finish both files.
                    self._stop.wait(0.25)
                    self._load()
            except OSError:
                continue  # mid-rotation; retry next poll


def server_credentials(
    cert_dir: Optional[str] = None,
) -> tuple[grpc.ServerCredentials, Optional[CertReloader]]:
    """Server creds: mounted cert dir (hot-reloading) when given, else a
    fresh self-signed pair (reference runserver.go:99-114 behavior)."""
    if cert_dir:
        reloader = CertReloader(
            os.path.join(cert_dir, "tls.crt"), os.path.join(cert_dir, "tls.key")
        )

        def fetch():
            cert, key = reloader.current()
            return grpc.ssl_server_certificate_configuration([(key, cert)])

        creds = grpc.dynamic_ssl_server_credentials(
            fetch(), lambda: fetch(), require_client_authentication=False
        )
        return creds, reloader
    cert, key = create_self_signed_cert()
    return grpc.ssl_server_credentials([(key, cert)]), None
