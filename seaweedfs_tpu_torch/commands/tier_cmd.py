"""``volume.tier.local``: move a sealed local volume's .dat to or from an
object-store tier, with no server running.

The port of seaweedfs_tpu/commands/tier_cmd.py, the local counterpart of
the reference's volume.tier.upload / volume.tier.download shell commands
(weed/shell/command_volume_tier_*.go over storage/backend/s3_backend): the
directory-backed ``LocalObjectStoreClient`` is the object store.  It runs
no kernel and takes no device.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("volume.tier.local", "move a sealed volume's .dat to/from a tier")
def run_tier(args) -> int:
    from seaweedfs_tpu_torch.storage.backend import LocalObjectStoreClient
    from seaweedfs_tpu_torch.storage.volume import Volume

    client = LocalObjectStoreClient(args.dest)
    vol = Volume(args.dir, args.volumeId, args.collection, create=False)
    try:
        if args.mode == "upload":
            if not vol.read_only:
                if not args.force:
                    raise SystemExit(f"volume {args.volumeId} is not sealed readonly; "
                                     "seal it first (volume.mark) or pass -force")
                vol.set_read_only(True)  # -force persists the seal
            key = vol.tier_upload(client)
            print(f"volume {args.volumeId} tiered to {args.dest} as {key}")
        else:
            vol.tier_download(client)
            print(f"volume {args.volumeId} downloaded back to {args.dir}")
    finally:
        vol.close()
    return 0


def _flags(p) -> None:
    p.add_argument("mode", choices=["upload", "download"])
    p.add_argument("-dir", default=".", help="volume directory")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-dest", required=True, help="object-store directory")
    p.add_argument("-force", action="store_true",
                   help="seal an unsealed volume (persisted) before tiering")


run_tier.configure = _flags
