"""``cli tls.gen``: mint a cluster CA and component certs.

The port's copy of seaweedfs_tpu/commands/tls_cmd.py, counterpart of the
reference's security.toml bootstrap (weed/security/tls.go expects
operator-provided CA + per-component certs).  One command mints
everything:

    python -m seaweedfs_tpu_torch.cli tls.gen -dir certs -host 127.0.0.1,node1

then run every component with
    WEEDTPU_TLS_CA=certs/ca.crt WEEDTPU_TLS_CERT=certs/node.crt \
    WEEDTPU_TLS_KEY=certs/node.key python -m seaweedfs_tpu_torch.cli master ...
and all gRPC hops are mutually authenticated; pass -tlsCert/-tlsKey to
the s3/filer/server commands for HTTPS on their client-facing ports.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("tls.gen", "generate a CA plus node certificate for TLS/mTLS")
def run_tls_gen(args) -> int:
    import os

    from seaweedfs_tpu_torch.security.tls import generate_ca, issue_cert

    hosts = tuple(h.strip() for h in args.host.split(",") if h.strip())
    if not hosts:
        raise SystemExit("tls.gen: -host needs at least one DNS name or IP")
    ca_cert = os.path.join(args.dir, "ca.crt")
    ca_key = os.path.join(args.dir, "ca.key")
    if os.path.exists(ca_cert) and os.path.exists(ca_key):
        print(f"reusing CA {ca_cert}")
    else:
        ca_cert, ca_key = generate_ca(args.dir)
        print(f"minted CA {ca_cert}")
    cert, key = issue_cert(
        args.dir, args.name, ca_cert, ca_key, cn=hosts[0], hosts=hosts
    )
    print(f"issued {cert} / {key} for {', '.join(hosts)}")
    print(
        f"export WEEDTPU_TLS_CA={ca_cert} "
        f"WEEDTPU_TLS_CERT={cert} WEEDTPU_TLS_KEY={key}"
    )
    return 0


def _flags(p):
    p.add_argument("-dir", default="certs", help="output directory")
    p.add_argument(
        "-name", default="node", help="file stem for the issued cert"
    )
    p.add_argument(
        "-host",
        default="localhost,127.0.0.1",
        help="comma list of DNS names / IPs the cert must cover",
    )


run_tls_gen.configure = _flags
