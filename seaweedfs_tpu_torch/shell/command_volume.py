"""Volume, collection and lock shell commands.

The port's copy of seaweedfs_tpu/shell/command_volume.py (reference
shell/command_volume_list.go, command_volume_vacuum.go,
command_volume_delete.go, command_volume_mark.go, command_collection_*.go
and command_lock_unlock.go): ``lock``, ``unlock``, ``help``,
``volume.list``, ``collection.list``, ``collection.delete``,
``volume.vacuum``, ``volume.delete`` and ``volume.mark``."""

from __future__ import annotations

from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import SHELL_REGISTRY, shell_command
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr, parallel_exec
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits


def _grpc_of(dn: m_pb.DataNodeInfo) -> str:
    return grpc_addr(dn.url, dn.grpc_port)


def _each_data_node(topo: m_pb.TopologyInfo):
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                yield dc.id, rack.id, dn


@shell_command("lock", "acquire the cluster-exclusive admin lock")
def cmd_lock(env, args, out):
    env.acquire_lock()
    print("lock acquired", file=out)


@shell_command("unlock", "release the cluster-exclusive admin lock")
def cmd_unlock(env, args, out):
    env.release_lock()
    print("lock released", file=out)


@shell_command("help", "list shell commands")
def cmd_help(env, args, out):
    for name in sorted(SHELL_REGISTRY):
        print(f"  {name:24s} {SHELL_REGISTRY[name].help}", file=out)


@shell_command("volume.list", "print the cluster topology tree")
def cmd_volume_list(env, args, out):
    resp = env.collect_topology()
    topo = resp.topology_info
    print(f"Topology volumeSizeLimit:{resp.volume_size_limit_mb} MB", file=out)
    for dc in topo.data_center_infos:
        print(f"  DataCenter {dc.id}", file=out)
        for rack in dc.rack_infos:
            print(f"    Rack {rack.id}", file=out)
            for dn in rack.data_node_infos:
                nvol = sum(d.volume_count for d in dn.disk_infos.values())
                print(
                    f"      DataNode {dn.id} volumes:{nvol}",
                    file=out,
                )
                all_vols = [
                    v for d in dn.disk_infos.values() for v in d.volume_infos
                ]
                all_ec = [
                    e for d in dn.disk_infos.values() for e in d.ec_shard_infos
                ]
                for v in sorted(all_vols, key=lambda v: v.id):
                    flags = " readonly" if v.read_only else ""
                    coll = f" collection:{v.collection}" if v.collection else ""
                    print(
                        f"        volume id:{v.id}{coll} size:{v.size}"
                        f" file_count:{v.file_count}"
                        f" replica:{v.replica_placement}{flags}",
                        file=out,
                    )
                for e in sorted(all_ec, key=lambda e: e.volume_id):
                    print(
                        f"        ec volume id:{e.volume_id}"
                        f" collection:{e.collection}"
                        f" shards:{ShardBits(e.shard_bits).ids()}",
                        file=out,
                    )


@shell_command("collection.list", "list collections")
def cmd_collection_list(env, args, out):
    resp = env.master().CollectionList(
        m_pb.CollectionListRequest(
            include_normal_volumes=True, include_ec_volumes=True
        )
    )
    for c in resp.collections:
        print(f"collection:\"{c.name}\"", file=out)


@shell_command("collection.delete", "delete all volumes of a collection")
def cmd_collection_delete(env, args, out):
    env.confirm_is_locked()
    name = args.collection
    topo = env.collect_topology().topology_info
    tasks = []
    deleted = ec_deleted = 0
    for _, _, dn in _each_data_node(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.collection != name:
                    continue
                grpc, vid = _grpc_of(dn), v.id
                tasks.append(
                    lambda grpc=grpc, vid=vid: env.volume(grpc).VolumeDelete(
                        vs_pb.VolumeDeleteRequest(volume_id=vid)
                    )
                )
                deleted += 1
            # the collection's volumes may have been EC-encoded — those
            # shards are part of the collection too
            for e in disk.ec_shard_infos:
                if e.collection != name:
                    continue
                grpc, vid = _grpc_of(dn), e.volume_id
                ids = ShardBits(e.shard_bits).ids()

                def _drop_ec(grpc=grpc, vid=vid, ids=ids):
                    env.volume(grpc).EcShardsUnmount(
                        vs_pb.EcShardsUnmountRequest(
                            volume_id=vid, shard_ids=ids
                        )
                    )
                    env.volume(grpc).EcShardsDelete(
                        vs_pb.EcShardsDeleteRequest(
                            volume_id=vid, collection=name, shard_ids=ids
                        )
                    )

                tasks.append(_drop_ec)
                ec_deleted += len(ids)
    parallel_exec(tasks)
    env.master().CollectionDelete(m_pb.CollectionDeleteRequest(name=name))
    print(
        f"deleted {deleted} volumes and {ec_deleted} EC shards of "
        f"collection {name!r}",
        file=out,
    )


cmd_collection_delete.configure = lambda p: p.add_argument(
    "-collection", required=True
)


@shell_command("volume.vacuum", "compact volumes above a garbage threshold")
def cmd_volume_vacuum(env, args, out):
    env.confirm_is_locked()
    topo = env.collect_topology().topology_info
    total = 0
    for _, _, dn in _each_data_node(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if args.volumeId and v.id != args.volumeId:
                    continue
                resp = env.volume(_grpc_of(dn)).VolumeVacuum(
                    vs_pb.VolumeVacuumRequest(
                        volume_id=v.id,
                        garbage_threshold=args.garbageThreshold,
                    )
                )
                if resp.reclaimed_bytes:
                    print(
                        f"volume {v.id} on {dn.id}: reclaimed"
                        f" {resp.reclaimed_bytes} bytes",
                        file=out,
                    )
                    total += resp.reclaimed_bytes
    print(f"total reclaimed: {total} bytes", file=out)


def _vacuum_flags(p):
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument("-volumeId", type=int, default=0)


cmd_volume_vacuum.configure = _vacuum_flags


@shell_command("volume.delete", "delete a volume from one server")
def cmd_volume_delete(env, args, out):
    env.confirm_is_locked()
    env.volume(args.node).VolumeDelete(
        vs_pb.VolumeDeleteRequest(volume_id=args.volumeId)
    )
    print(f"deleted volume {args.volumeId} on {args.node}", file=out)


def _delete_flags(p):
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-node", required=True, help="host:grpc_port")


cmd_volume_delete.configure = _delete_flags


@shell_command("volume.mark", "mark a volume readonly/writable everywhere")
def cmd_volume_mark(env, args, out):
    env.confirm_is_locked()
    locations = env.lookup_volume(args.volumeId)
    req = vs_pb.VolumeMarkRequest(volume_id=args.volumeId)
    for loc in locations:
        stub = env.volume(grpc_addr(loc.url, loc.grpc_port))
        if args.writable:
            stub.VolumeMarkWritable(req)
        else:
            stub.VolumeMarkReadonly(req)
    state = "writable" if args.writable else "readonly"
    print(
        f"marked volume {args.volumeId} {state} on {len(locations)} nodes",
        file=out,
    )


def _mark_flags(p):
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-writable", action="store_true")


cmd_volume_mark.configure = _mark_flags
