"""volume.balance — even out plain-volume counts across volume servers.

The port's copy of seaweedfs_tpu/shell/command_volume_balance.py, the
counterpart of the reference's shell/command_volume_balance.go: per
collection (or all), compute the ideal volume ratio
(total volumes / total slots), then repeatedly move one volume from the
fullest server to the emptiest while that strictly improves the spread —
never placing a volume on a server already holding a replica of it.

The data path of one move is the reference's VolumeCopy flow: freeze the
source replica (mark readonly), destination pulls .dat/.idx over the
CopyFile stream and mounts, then the source unmounts and deletes
(command_volume_move.go LiveMoveVolume, scaled to this framework's
readonly-freeze instead of tailing).

Planning is separated from execution behind :class:`VolumeMover` so the
algorithm is unit-testable against textual topology fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr


@dataclass
class VolumeNode:
    """One volume server as seen by the balancer."""

    id: str
    url: str
    grpc_port: int
    dc: str
    rack: str
    max_slots: int
    volumes: dict[int, m_pb.VolumeStat] = field(default_factory=dict)

    @property
    def grpc_address(self) -> str:
        return grpc_addr(self.url, self.grpc_port)

    def ratio(self) -> float:
        return len(self.volumes) / self.max_slots if self.max_slots else 1.0

    def next_ratio(self) -> float:
        return (len(self.volumes) + 1) / self.max_slots if self.max_slots else 1.0


def collect_volume_nodes(topo: m_pb.TopologyInfo) -> list[VolumeNode]:
    nodes: list[VolumeNode] = []
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                node = VolumeNode(
                    id=dn.id,
                    url=dn.url,
                    grpc_port=dn.grpc_port,
                    dc=dc.id,
                    rack=rack.id,
                    max_slots=0,
                )
                for disk in dn.disk_infos.values():
                    node.max_slots += int(disk.max_volume_count)
                    for v in disk.volume_infos:
                        node.volumes[v.id] = v
                nodes.append(node)
    return nodes


class VolumeMover:
    def move(self, v: m_pb.VolumeStat, src: VolumeNode, dst: VolumeNode):
        raise NotImplementedError


class PlanVolumeMover(VolumeMover):
    def __init__(self):
        self.plan: list[tuple[int, str, str]] = []

    def move(self, v, src, dst):
        dst.volumes[v.id] = v
        src.volumes.pop(v.id, None)
        self.plan.append((v.id, src.id, dst.id))

    @property
    def moves(self):
        return len(self.plan)


class RpcVolumeMover(VolumeMover):
    def __init__(self, env: CommandEnv):
        self.env = env
        self.moves = 0

    def move(self, v, src, dst):
        """Freeze, pull to dst, drop from src (reference LiveMoveVolume,
        command_volume_move.go, with readonly-freeze semantics)."""
        src_stub = self.env.volume(src.grpc_address)
        dst_stub = self.env.volume(dst.grpc_address)
        was_writable = not v.read_only
        if was_writable:
            src_stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=v.id))
        try:
            dst_stub.VolumeCopy(
                vs_pb.VolumeCopyRequest(
                    volume_id=v.id,
                    collection=v.collection,
                    source_data_node=src.grpc_address,
                )
            )
        except Exception:
            if was_writable:  # roll the freeze back; the volume never moved
                src_stub.VolumeMarkWritable(vs_pb.VolumeMarkRequest(volume_id=v.id))
            raise
        # VolumeDelete unregisters and removes the files in one step (the
        # store's delete_volume requires the volume mounted)
        src_stub.VolumeDelete(vs_pb.VolumeDeleteRequest(volume_id=v.id))
        if was_writable:
            dst_stub.VolumeMarkWritable(vs_pb.VolumeMarkRequest(volume_id=v.id))
        else:
            # the copy mounts writable by default — a volume the operator
            # froze must stay frozen on its new home
            dst_stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=v.id))
        dst.volumes[v.id] = v
        src.volumes.pop(v.id, None)
        self.moves += 1


def balance_volumes_view(
    nodes: list[VolumeNode],
    mover: VolumeMover,
    *,
    collection: str | None = None,
) -> None:
    """Move volumes fullest→emptiest while the spread strictly improves
    (reference balanceVolumeServers/attemptToMoveOneVolume)."""
    pool = [n for n in nodes if n.max_slots > 0]
    if len(pool) < 2:
        return
    # replica census: never collocate two replicas of one volume
    holders: dict[int, set[str]] = {}
    for n in pool:
        for vid in n.volumes:
            holders.setdefault(vid, set()).add(n.id)

    def eligible(n: VolumeNode):
        return [
            v
            for vid, v in sorted(n.volumes.items())
            if (collection is None or v.collection == collection)
        ]

    # ratios must count the same population `ideal` does — with a
    # collection filter, other collections' volumes are invisible to both
    def ratio(n: VolumeNode) -> float:
        return len(eligible(n)) / n.max_slots

    def next_ratio(n: VolumeNode) -> float:
        return (len(eligible(n)) + 1) / n.max_slots

    total = sum(len(eligible(n)) for n in pool)
    slots = sum(n.max_slots for n in pool)
    ideal = total / slots
    while True:
        pool.sort(key=ratio)
        low, high = pool[0], pool[-1]
        if ratio(high) <= ideal or next_ratio(low) > ideal:
            return
        moved = False
        for v in eligible(high):
            if low.id in holders.get(v.id, set()):
                continue  # replica already there
            mover.move(v, high, low)
            holders[v.id].discard(high.id)
            holders[v.id].add(low.id)
            moved = True
            break
        if not moved:
            return


def balance_volumes(
    env: CommandEnv, collection: str | None = None, apply: bool = True
) -> VolumeMover:
    topo = env.collect_topology().topology_info
    nodes = collect_volume_nodes(topo)
    mover: VolumeMover = RpcVolumeMover(env) if apply else PlanVolumeMover()
    balance_volumes_view(nodes, mover, collection=collection)
    return mover


@shell_command("volume.balance", "even out volume counts across servers")
def cmd_volume_balance(env, args, out):
    env.confirm_is_locked()
    mover = balance_volumes(
        env, args.collection or None, apply=not args.noApply
    )
    if args.noApply:
        for vid, src, dst in mover.plan:
            print(f"plan: move volume {vid} {src} -> {dst}", file=out)
    print(f"volume.balance moved {mover.moves} volumes", file=out)


def _balance_flags(p):
    p.add_argument("-collection", default="")
    p.add_argument(
        "-noApply", action="store_true", help="print the plan, move nothing"
    )


cmd_volume_balance.configure = _balance_flags
