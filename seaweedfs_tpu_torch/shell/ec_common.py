"""Shared EC-orchestration helpers: cluster EC view, shard moves, fan-out.

The port's copy of seaweedfs_tpu/shell/ec_common.py (reference
shell/command_ec_common.go): the `EcNode`
view over the master topology, the copy+mount/unmount+delete shard-move
primitive (:254-310), and the bounded-parallel error-collecting fan-out
(`ErrorWaitGroup`, shell/common.go)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import (
    make_scheme,
    scheme_local_groups,
)
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits

from seaweedfs_tpu_torch.shell.command_env import CommandEnv


def grpc_addr(url: str, grpc_port: int) -> str:
    """host:port URL + gRPC port -> host:grpc_port (single conversion
    point for every shell call site)."""
    return f"{url.rsplit(':', 1)[0]}:{grpc_port}"


def parallel_exec(tasks, max_parallelization: int = 10) -> None:
    """Run thunks concurrently; raise the collected errors at the end
    (reference ErrorWaitGroup semantics)."""
    if not tasks:
        return
    errors = []
    with ThreadPoolExecutor(max_workers=max(1, max_parallelization)) as pool:
        for fut in [pool.submit(t) for t in tasks]:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — collect, raise combined
                errors.append(e)
    if errors:
        raise RuntimeError("; ".join(str(e) for e in errors))


@dataclass
class EcNode:
    """One volume server as seen by the balancer."""

    info: m_pb.DataNodeInfo
    dc: str
    rack: str
    free_ec_slots: int
    # vid -> shards held (mutated locally as moves are planned/applied)
    shards: dict[int, ShardBits] = field(default_factory=dict)
    # when the view was collected for one disk type, moves into this
    # node must land on that type's disks
    disk_type: str = ""
    # vids this node already holds on OTHER disk types: the store mounts
    # one EcVolume per vid per node, so copying the same vid onto a
    # second disk type would orphan files — never pick such destinations
    blocked_vids: frozenset[int] = frozenset()

    @property
    def grpc_address(self) -> str:
        return grpc_addr(self.info.url, self.info.grpc_port)

    def shard_count(self) -> int:
        return sum(b.count() for b in self.shards.values())

    def add(self, vid: int, shard_id: int) -> None:
        self.shards[vid] = self.shards.get(vid, ShardBits(0)).add(shard_id)
        self.free_ec_slots -= 1

    def remove(self, vid: int, shard_id: int) -> None:
        bits = self.shards.get(vid, ShardBits(0)).remove(shard_id)
        if bits.count():
            self.shards[vid] = bits
        else:
            self.shards.pop(vid, None)
        self.free_ec_slots += 1


# Reference: each EC shard is 1/DataShardsCount of a volume, so one volume
# slot fits data_shards shards (command_ec_common.go erasure_coding.DataShardsCount).
def collect_ec_nodes(
    topo: m_pb.TopologyInfo,
    scheme: EcScheme = DEFAULT_SCHEME,
    disk_type: str = "",
) -> tuple[list[EcNode], dict[int, str], dict[int, EcScheme]]:
    """Build the balancer's node view; also return vid -> collection and
    vid -> RS(k, m) scheme as reported by shard holders' heartbeats.

    ``disk_type`` restricts the view to one disk type: free slots are
    counted only on matching disks and only those disks' shards appear —
    so every placement decision downstream is per-disk-type (reference
    command_ec_common.go:377-381 countFreeShardSlots(dn, diskType))."""
    nodes: list[EcNode] = []
    collections: dict[int, str] = {}
    schemes: dict[int, EcScheme] = {}
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                shards: dict[int, ShardBits] = {}
                blocked: set[int] = set()
                free = 0
                for dt, disk in dn.disk_infos.items():
                    if disk_type and (dt or "hdd") != disk_type:
                        blocked.update(
                            es.volume_id for es in disk.ec_shard_infos
                        )
                        continue
                    free += (
                        int(disk.max_volume_count) - int(disk.volume_count)
                    ) * scheme.data_shards
                    for es in disk.ec_shard_infos:
                        bits = ShardBits(es.shard_bits)
                        shards[es.volume_id] = shards.get(
                            es.volume_id, ShardBits(0)
                        ).plus(bits)
                        collections[es.volume_id] = es.collection
                        if es.data_shards:
                            schemes[es.volume_id] = make_scheme(
                                es.data_shards,
                                es.parity_shards,
                                es.local_groups,
                            )
                        free -= bits.count()
                nodes.append(
                    EcNode(
                        info=dn,
                        dc=dc.id,
                        rack=rack.id,
                        free_ec_slots=free,
                        shards=shards,
                        disk_type=disk_type,
                        blocked_vids=frozenset(blocked),
                    )
                )
    return nodes, collections, schemes


def shards_by_vid(nodes: list[EcNode]) -> dict[int, dict[str, ShardBits]]:
    """vid -> node_id -> bits (cluster-wide shard census)."""
    out: dict[int, dict[str, ShardBits]] = {}
    for n in nodes:
        for vid, bits in n.shards.items():
            out.setdefault(vid, {})[n.info.id] = bits
    return out


def scheme_desc(scheme: EcScheme) -> str:
    """Human tag for a storage class: RS(10,4) / LRC(10,2,2)."""
    groups = scheme_local_groups(scheme)
    if groups:
        return (
            f"LRC({scheme.data_shards},{groups},"
            f"{scheme.parity_shards - groups})"
        )
    return f"RS({scheme.data_shards},{scheme.parity_shards})"


def geometry_msg(scheme: EcScheme) -> vs_pb.EcGeometry:
    return vs_pb.EcGeometry(
        data_shards=scheme.data_shards,
        parity_shards=scheme.parity_shards,
        local_groups=scheme_local_groups(scheme),
    )


def copy_shards(
    env: CommandEnv,
    vid: int,
    collection: str,
    shard_ids: list[int],
    src_grpc: str,
    dst_grpc: str,
    copy_index_files: bool = True,
    disk_type: str = "",
) -> None:
    env.volume(dst_grpc).EcShardsCopy(
        vs_pb.EcShardsCopyRequest(
            volume_id=vid,
            collection=collection,
            shard_ids=shard_ids,
            copy_ecx_file=copy_index_files,
            copy_ecj_file=copy_index_files,
            copy_vif_file=copy_index_files,
            source_data_node=src_grpc,
            disk_type=disk_type,
        )
    )


def mount_shards(
    env: CommandEnv, vid: int, collection: str, shard_ids: list[int], grpc: str
) -> None:
    env.volume(grpc).EcShardsMount(
        vs_pb.EcShardsMountRequest(
            volume_id=vid, collection=collection, shard_ids=shard_ids
        )
    )


def unmount_shards(
    env: CommandEnv, vid: int, shard_ids: list[int], grpc: str
) -> None:
    env.volume(grpc).EcShardsUnmount(
        vs_pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=shard_ids)
    )


def delete_shards(
    env: CommandEnv, vid: int, collection: str, shard_ids: list[int], grpc: str
) -> None:
    env.volume(grpc).EcShardsDelete(
        vs_pb.EcShardsDeleteRequest(
            volume_id=vid, collection=collection, shard_ids=shard_ids
        )
    )


def move_shard(
    env: CommandEnv, vid: int, collection: str, shard_id: int,
    src: EcNode, dst: EcNode,
) -> None:
    """Copy one shard src->dst, mount at dst, unmount+delete at src
    (reference moveMountedShardToEcNode, command_ec_common.go:254)."""
    copy_shards(
        env, vid, collection, [shard_id], src.grpc_address, dst.grpc_address,
        disk_type=dst.disk_type,
    )
    mount_shards(env, vid, collection, [shard_id], dst.grpc_address)
    unmount_shards(env, vid, [shard_id], src.grpc_address)
    delete_shards(env, vid, collection, [shard_id], src.grpc_address)
    src.remove(vid, shard_id)
    dst.add(vid, shard_id)
