"""``webdav``, ``iam`` and ``sftp``: the gateway daemons.

The port of seaweedfs_tpu/commands/gateway_cmd.py (reference `weed
webdav`, weed/command/webdav.go, `weed iam`, weed/command/iam.go, and
`weed sftp`, weed/command/sftp.go).  ``webdav`` serves
``server/webdav_server.WebDavServer`` over a filer's gRPC address.  ``sftp``
refuses with the JAX package's message (rc 1) while paramiko is missing.
In ``iam``, ``-credentials`` picks the store:
``filer_etc`` (the default; ``/etc/iam/identities.json`` in the filer),
``memory``, or a ``postgres://`` URL (refused, as the JAX package refuses
it without ``psycopg2``).  The filer is ``-filer`` (a filer's gRPC address,
or a comma list of shards) reached through the port's ``RemoteFiler`` or
``ShardedFilerClient``; the JAX command goes through its mount client,
which writes the same document.  None of the three runs a kernel or takes
a device.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("webdav", "run a WebDAV gateway over the filer")
def run_webdav(args) -> int:
    from seaweedfs_tpu_torch.commands.servers import _wait_forever
    from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

    dav = WebDavServer(
        args.filer,
        args.master,
        ip=args.ip,
        port=args.port,
        root=args.filerPath,
        tls_cert=args.tlsCert,
        tls_key=args.tlsKey,
    )
    dav.start()
    try:
        print(f"webdav on {dav.url} (root {args.filerPath})", flush=True)
        _wait_forever()
    finally:
        dav.stop()
    return 0


def _webdav_flags(p) -> None:
    from seaweedfs_tpu_torch.commands.servers import _tls_flags

    p.add_argument("-filer", default="127.0.0.1:18888", help="filer gRPC address")
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=7333)
    p.add_argument("-filerPath", default="/", help="filer subtree to expose")
    _tls_flags(p)


run_webdav.configure = _webdav_flags


@command("iam", "run the IAM query API over a credential store")
def run_iam(args) -> int:
    from seaweedfs_tpu_torch.commands.servers import _wait_forever
    from seaweedfs_tpu_torch.filer.shard_ring import filer_client
    from seaweedfs_tpu_torch.iam import IamApiServer
    from seaweedfs_tpu_torch.iam.credentials import make_credential_store
    from seaweedfs_tpu_torch.wdclient import MasterClient

    store = make_credential_store(
        args.credentials, lambda: filer_client(args.filer, MasterClient(args.master))
    )
    iam = IamApiServer(store, ip=args.ip, port=args.port)
    iam.start()
    try:
        print(f"iam api on {iam.url} (credential store: {store.name})", flush=True)
        _wait_forever()
    finally:
        iam.stop()
    return 0


def _iam_flags(p) -> None:
    p.add_argument("-filer", default="127.0.0.1:18888",
                   help="filer gRPC address, or a comma list of shards")
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8111)
    p.add_argument(
        "-credentials", default="",
        help="store: filer_etc (default, /etc/iam in the filer), memory, "
        "postgres://u:p@h/db (needs psycopg2)",
    )


run_iam.configure = _iam_flags


@command("sftp", "run an SFTP gateway over the filer")
def run_sftp(args) -> int:
    import os

    from seaweedfs_tpu_torch.sftpd import paramiko_available, serve_sftp

    if not paramiko_available():
        print(
            "sftp: the paramiko package is not available in this image.\n"
            "The filesystem layer itself is available programmatically:\n"
            "  from seaweedfs_tpu_torch.mount import WeedFS"
        )
        return 1
    if not args.hostKey or not os.path.exists(args.hostKey):
        print(
            "sftp: -hostKey must name an existing RSA private key file "
            "(generate one with: ssh-keygen -t rsa -f hostkey -N '')"
        )
        return 1
    from seaweedfs_tpu_torch.mount import WeedFS

    fs = WeedFS(args.filer, args.master, root=args.filerPath)
    users = {}
    if args.user:
        name, _, password = args.user.partition(":")
        users[name] = password
    print(f"sftp on {args.ip}:{args.port} (root {args.filerPath})")
    try:
        serve_sftp(fs, args.hostKey, ip=args.ip, port=args.port, users=users or None)
    finally:
        fs.close()
    return 0


def _sftp_flags(p) -> None:
    p.add_argument("-filer", default="127.0.0.1:18888", help="filer gRPC address")
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=2022)
    p.add_argument("-filerPath", default="/", help="filer subtree to expose")
    p.add_argument("-hostKey", default="", help="RSA host key file")
    p.add_argument("-user", default="", help="name:password for auth")


run_sftp.configure = _sftp_flags
