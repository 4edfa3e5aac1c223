"""``backup``: pull one volume's .dat and .idx to a local directory.

The port of seaweedfs_tpu/commands/backup_cmd.py (reference `weed backup`,
weed/command/backup.go): find a holder through the master's
``LookupVolume``, stream ``.idx`` and then ``.dat`` over the holder's
``CopyFile`` gRPC (the stream volume.move rides) into ``.tmp`` files, and
rename them into place, ``.idx`` first.  The result is a mountable volume:
point a volume server's ``-dir`` at it.  It runs no kernel and takes no
device.
"""

from __future__ import annotations

import os

from seaweedfs_tpu_torch.commands import command


@command("backup", "stream one volume's .dat/.idx from the cluster to a dir")
def run_backup(args) -> int:
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage.volume import volume_file_name

    lookup = rpc.master_stub(args.master).LookupVolume(
        m_pb.LookupVolumeRequest(volume_or_file_ids=[str(args.volumeId)]))
    loc = lookup.volume_id_locations[0]
    if loc.error or not loc.locations:
        raise SystemExit(f"volume {args.volumeId}: {loc.error or 'no holders'}")
    holder = loc.locations[0]
    stub = rpc.volume_stub(f"{holder.url.rsplit(':', 1)[0]}:{holder.grpc_port}")

    os.makedirs(args.dir, exist_ok=True)
    base = volume_file_name(args.dir, args.collection, args.volumeId)
    total = 0
    # .idx first: every index entry then points at data older than the
    # .dat copied after it, so concurrent appends never leave the backup's
    # index past its .dat (a concurrent vacuum still invalidates a backup:
    # freeze with volume.mark for a strict one)
    for ext in (".idx", ".dat"):
        with open(base + ext + ".tmp", "wb") as out:
            for resp in stub.CopyFile(vs_pb.CopyFileRequest(
                    volume_id=args.volumeId, collection=args.collection, ext=ext)):
                out.write(resp.file_content)
                total += len(resp.file_content)
    # publish .idx before .dat: mount discovery keys on the .dat
    for ext in (".idx", ".dat"):
        os.replace(base + ext + ".tmp", base + ext)
    print(f"backed up volume {args.volumeId} from {holder.url} to {base}.dat/.idx "
          f"({total} bytes)")
    return 0


def _flags(p) -> None:
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dir", default=".", help="local destination directory")


run_backup.configure = _flags
