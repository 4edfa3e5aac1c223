"""``iam``: the IAM query API over a credential store.

The port of seaweedfs_tpu/commands/gateway_cmd.py's ``iam`` (reference
`weed iam`, weed/command/iam.go).  ``-credentials`` picks the store:
``filer_etc`` (the default; ``/etc/iam/identities.json`` in the filer),
``memory``, or a ``postgres://`` URL (refused, as the JAX package refuses
it without ``psycopg2``).  The filer is ``-filer`` (a filer's gRPC address,
or a comma list of shards) reached through the port's ``RemoteFiler`` or
``ShardedFilerClient``; the JAX command goes through its mount client,
which writes the same document.  It runs no kernel and takes no device.
``webdav`` and ``sftp`` are not ported (ROADMAP Queue A item 4).
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


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
