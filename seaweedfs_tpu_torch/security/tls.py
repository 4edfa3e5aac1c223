"""TLS plumbing: certificate generation, HTTPS server wrap, gRPC creds.

The port's copy of seaweedfs_tpu/security/tls.py, counterpart of the
reference's weed/security/tls.go (security.toml wires a CA + per-component
cert/key; gRPC servers require client certs signed by the CA).  Here:

  * :func:`generate_ca` / :func:`issue_cert` mint a local CA and leaf
    certs (cryptography lib) — the ``cli tls.gen`` bootstrap and the
    tests' fixture factory.
  * :func:`wrap_http_server` turns any bound ``PooledHTTPServer`` socket
    into HTTPS.
  * :func:`grpc_server_credentials` / :func:`grpc_channel_credentials`
    build mTLS credentials for rpc.py's one server/channel seam — set
    ``WEEDTPU_TLS_CA/CERT/KEY`` and every
    internal gRPC hop is mutually authenticated.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl


# ---------------------------------------------------------------------------
# certificate minting (cryptography lib is baked into the image)
# ---------------------------------------------------------------------------

def _name(cn: str):
    from cryptography.x509 import Name, NameAttribute
    from cryptography.x509.oid import NameOID

    return Name([NameAttribute(NameOID.COMMON_NAME, cn)])


def _write_key_cert(dir_path: str, stem: str, key, cert) -> tuple[str, str]:
    from cryptography.hazmat.primitives import serialization

    os.makedirs(dir_path, exist_ok=True)
    key_path = os.path.join(dir_path, f"{stem}.key")
    cert_path = os.path.join(dir_path, f"{stem}.crt")
    with open(key_path, "wb") as f:
        os.fchmod(f.fileno(), 0o600)
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_path, key_path


def generate_ca(dir_path: str, cn: str = "weedtpu-ca") -> tuple[str, str]:
    """Mint a CA; returns (ca_cert_path, ca_key_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(cn))
        .issuer_name(_name(cn))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .sign(key, hashes.SHA256())
    )
    return _write_key_cert(dir_path, "ca", key, cert)


def issue_cert(
    dir_path: str,
    stem: str,
    ca_cert_path: str,
    ca_key_path: str,
    cn: str = "localhost",
    hosts: tuple[str, ...] = ("localhost", "127.0.0.1"),
) -> tuple[str, str]:
    """Issue a CA-signed leaf cert (server or client); returns
    (cert_path, key_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import load_pem_private_key

    with open(ca_key_path, "rb") as f:
        ca_key = load_pem_private_key(f.read(), password=None)
    with open(ca_cert_path, "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())

    sans = []
    for h in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(cn))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=825))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return _write_key_cert(dir_path, stem, key, cert)


# ---------------------------------------------------------------------------
# HTTPS for the HTTP servers
# ---------------------------------------------------------------------------

def server_ssl_context(
    cert_path: str, key_path: str, ca_path: str | None = None
) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if ca_path:
        ctx.load_verify_locations(ca_path)
        ctx.verify_mode = ssl.CERT_REQUIRED  # mTLS
    return ctx


def wrap_http_server(httpd, cert_path: str, key_path: str, ca_path: str | None = None):
    """Switch a bound HTTP server's listening socket to TLS.

    The handshake is deferred to the first read (``do_handshake_on_connect
    =False``) so it runs in the per-connection worker thread — with it on,
    accept() performs the handshake inside the single serve_forever loop
    and one client that never sends a ClientHello blocks every new
    connection."""
    ctx = server_ssl_context(cert_path, key_path, ca_path)
    httpd.socket = ctx.wrap_socket(
        httpd.socket, server_side=True, do_handshake_on_connect=False
    )
    return httpd


# ---------------------------------------------------------------------------
# gRPC credentials (consumed by rpc.py's single server/channel seam)
# ---------------------------------------------------------------------------

def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def grpc_server_credentials(cert_path: str, key_path: str, ca_path: str | None = None):
    import grpc

    return grpc.ssl_server_credentials(
        [(_read(key_path), _read(cert_path))],
        root_certificates=_read(ca_path) if ca_path else None,
        require_client_auth=bool(ca_path),
    )


def grpc_channel_credentials(
    ca_path: str, cert_path: str | None = None, key_path: str | None = None
):
    import grpc

    return grpc.ssl_channel_credentials(
        root_certificates=_read(ca_path),
        private_key=_read(key_path) if key_path else None,
        certificate_chain=_read(cert_path) if cert_path else None,
    )


TLS_ENV = ("WEEDTPU_TLS_CA", "WEEDTPU_TLS_CERT", "WEEDTPU_TLS_KEY")


class TlsConfig:
    """Cluster gRPC TLS settings, resolved once from the environment
    (WEEDTPU_TLS_CA / WEEDTPU_TLS_CERT / WEEDTPU_TLS_KEY, the JAX
    package's names).  With all three set, rpc.py serves and dials with
    mutual TLS; with none, plaintext, like the reference's empty
    security.toml.  Some but not all of them is a misconfiguration and
    raises ValueError: TLS was asked for, so nothing may fall back to
    plaintext without a word (the JAX package's TlsConfig does)."""

    def __init__(self, env=os.environ):
        self.ca, self.cert, self.key = (env.get(name, "") for name in TLS_ENV)
        missing = [name for name, v in zip(TLS_ENV, (self.ca, self.cert, self.key)) if not v]
        if 0 < len(missing) < len(TLS_ENV):
            raise ValueError(f"TLS half configured: {', '.join(missing)} unset "
                             f"(set all of {', '.join(TLS_ENV)}, or none for plaintext)")

    @property
    def enabled(self) -> bool:
        return bool(self.ca and self.cert and self.key)

    def server_credentials(self):
        return grpc_server_credentials(self.cert, self.key, self.ca)

    def channel_credentials(self):
        return grpc_channel_credentials(self.ca, self.cert, self.key)
