"""ec.balance — dedup and spread EC shards across racks and nodes.

The port's copy of seaweedfs_tpu/shell/command_ec_balance.py (reference
shell/command_ec_balance.go +
command_ec_common.go:46-114 (algorithm text) / :574-1023 (ecBalancer):

  1. per volume, keep exactly one copy of each shard (dedup);
  2. spread each volume's shards across racks, capping every rack at
     ceil(total/racks) + rack_tolerance (the replica placement's
     different-rack count, reference pickRackToBalanceShardsInto);
  3. within each rack, cap every node at ceil(rack_total/nodes);
  4. finally even out *total* shard counts inside each rack across
     volumes (reference balanceEcRack:934-1003).

Planning is separated from execution behind the :class:`EcMover` seam so
the algorithm is unit-testable against textual topology fixtures (the
reference's command_ec_common_test.go / volume.ecshards.txt pattern)
without any servers.
"""

from __future__ import annotations

import math

from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.ec_common import (
    EcNode,
    collect_ec_nodes,
    delete_shards,
    move_shard,
    shards_by_vid,
    unmount_shards,
)
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits


class EcMover:
    """Execution seam: apply one move / one dedup-delete.  Implementations
    must also update the EcNode bookkeeping, because later placement
    decisions read it."""

    def move(self, vid: int, collection: str, sid: int, src: EcNode, dst: EcNode):
        raise NotImplementedError

    def dedup_delete(self, vid: int, collection: str, sid: int, node: EcNode):
        raise NotImplementedError


class RpcEcMover(EcMover):
    def __init__(self, env: CommandEnv):
        self.env = env
        self.moves = 0

    def move(self, vid, collection, sid, src, dst):
        move_shard(self.env, vid, collection, sid, src, dst)
        self.moves += 1

    def dedup_delete(self, vid, collection, sid, node):
        unmount_shards(self.env, vid, [sid], node.grpc_address)
        delete_shards(self.env, vid, collection, [sid], node.grpc_address)
        node.remove(vid, sid)
        self.moves += 1


class PlanEcMover(EcMover):
    """Dry-run recorder: mutates the in-memory view only."""

    def __init__(self):
        self.plan: list[tuple[str, int, int, str, str]] = []

    def move(self, vid, collection, sid, src, dst):
        src.remove(vid, sid)
        dst.add(vid, sid)
        self.plan.append(("move", vid, sid, src.info.id, dst.info.id))

    def dedup_delete(self, vid, collection, sid, node):
        node.remove(vid, sid)
        self.plan.append(("delete", vid, sid, node.info.id, ""))

    @property
    def moves(self):
        return len(self.plan)


def _dedup(mover: EcMover, nodes: list[EcNode], vid: int, collection: str) -> None:
    """Keep exactly one holder per shard id (reference deduplicateEcShards)."""
    holders: dict[int, list[EcNode]] = {}
    for n in nodes:
        for sid in n.shards.get(vid, ()).ids() if vid in n.shards else []:
            holders.setdefault(sid, []).append(n)
    for sid, ns in holders.items():
        if len(ns) <= 1:
            continue
        # keep the copy on the node with the fewest shards of this volume
        ns.sort(key=lambda n: n.shards[vid].count())
        for extra in ns[1:]:
            mover.dedup_delete(vid, collection, sid, extra)


def _vid_count(n: EcNode, vid: int) -> int:
    return n.shards[vid].count() if vid in n.shards else 0


def _pick_node(candidates: list[EcNode], vid: int) -> EcNode | None:
    """Most free slots, fewest shards of this volume already (reference
    pickEcNodeToBalanceShardsInto)."""
    fit = [
        n for n in candidates
        if n.free_ec_slots > 0 and vid not in n.blocked_vids
    ]
    if not fit:
        return None
    return max(fit, key=lambda n: (n.free_ec_slots, -_vid_count(n, vid)))


def _cap_node_loss_exposure(
    mover: EcMover, nodes: list[EcNode], vid: int, collection: str, scheme
) -> None:
    """Durability cap: no node may hold more shards of ``vid`` than the
    scheme's ``max_shards_per_disk`` — the largest count whose loss is
    ALWAYS decodable.  RS(k, m) tolerates any m per node, but LRC is not
    MDS: 4 shards of one LRC(10,2,2) local group on a single node is an
    unrecoverable single-node loss, a failure mode RS never had.  When
    evicting, the shard from the node's most-represented local group
    goes first (that's the concentration that makes patterns
    rank-deficient).  Best effort: on clusters smaller than
    ``min_total_disks`` there may be no destination — the count spread
    above still applies."""
    if scheme is None:
        return
    cap = scheme.max_shards_per_disk

    def crowded_first(bits) -> list[int]:
        """Held shard ids, most-crowded local group's members first —
        that concentration is what makes loss patterns rank-deficient."""
        counts = {g: c for g, c in bits.group_counts(scheme).items() if c}
        if not counts:
            return list(bits.ids())
        order = sorted(counts, key=lambda g: (-counts[g], g))
        rank = {g: i for i, g in enumerate(order)}
        return sorted(
            bits.ids(),
            key=lambda s: rank.get(scheme.group_of(s), len(order)),
        )

    for src in list(nodes):
        # phase 1: hard count cap while an under-cap destination exists
        while vid in src.shards and src.shards[vid].count() > cap:
            sid = crowded_first(src.shards[vid])[0]
            dst = _pick_node(
                [
                    n for n in nodes
                    if n is not src and _vid_count(n, vid) < cap
                ],
                vid,
            )
            if dst is None:
                break
            mover.move(vid, collection, sid, src, dst)
        # phase 2: on clusters too small for the cap, still refuse FATAL
        # held sets — a node whose own loss is rank-deficient (e.g. four
        # shards of one LRC group) moves its crowded-group shards to any
        # node that stays recoverable, trading balance for durability
        while (
            vid in src.shards
            and not scheme.loss_recoverable(tuple(src.shards[vid].ids()))
        ):
            moved = False
            for sid in crowded_first(src.shards[vid]):
                dst = _pick_node(
                    [
                        n for n in nodes
                        if n is not src
                        and scheme.loss_recoverable(
                            tuple(
                                n.shards.get(vid, ShardBits(0))
                                .add(sid).ids()
                            )
                        )
                    ],
                    vid,
                )
                if dst is not None:
                    mover.move(vid, collection, sid, src, dst)
                    moved = True
                    break
            if not moved:
                break  # nowhere safe; the count spread above still holds


def _balance_one_volume(
    mover: EcMover,
    nodes: list[EcNode],
    vid: int,
    collection: str,
    rack_tolerance: int = 0,
    scheme=None,
) -> None:
    _dedup(mover, nodes, vid, collection)
    racks: dict[tuple[str, str], list[EcNode]] = {}
    for n in nodes:
        racks.setdefault((n.dc, n.rack), []).append(n)

    def rack_count(members: list[EcNode]) -> int:
        return sum(_vid_count(n, vid) for n in members)

    def rack_free(members: list[EcNode]) -> int:
        return sum(max(0, n.free_ec_slots) for n in members)

    total = sum(rack_count(ms) for ms in racks.values())
    if total == 0:
        return

    # -- spread across racks: cap ceil(total/racks) + tolerance ------------
    # (tolerance = replica placement's different-rack count; reference
    # command_ec_common.go:714 averageShardsPerEcRack + DiffRackCount)
    cap = math.ceil(total / max(1, len(racks))) + rack_tolerance
    over = [(k, ms) for k, ms in racks.items() if rack_count(ms) > cap]
    for key, members in over:
        while rack_count(members) > cap:
            src = max(
                (n for n in members if vid in n.shards),
                key=lambda n: n.shards[vid].count(),
            )
            sid = src.shards[vid].ids()[-1]
            # rack-first pick: under-cap racks, most free slots first
            # (proportional spread, reference pickRackToBalanceShardsInto)
            dest_racks = sorted(
                (
                    (k2, ms2)
                    for k2, ms2 in racks.items()
                    if k2 != key and rack_count(ms2) < cap and rack_free(ms2) > 0
                ),
                key=lambda kv: (-rack_free(kv[1]), rack_count(kv[1])),
            )
            dst = None
            for _k2, ms2 in dest_racks:
                dst = _pick_node(ms2, vid)
                if dst is not None:
                    break
            if dst is None:
                break
            mover.move(vid, collection, sid, src, dst)

    # -- spread within each rack: cap ceil(rack_total / nodes) -------------
    for members in racks.values():
        rt = rack_count(members)
        if rt == 0 or len(members) < 2:
            continue
        ncap = math.ceil(rt / len(members))
        for src in members:
            while vid in src.shards and src.shards[vid].count() > ncap:
                sid = src.shards[vid].ids()[-1]
                dst = _pick_node(
                    [
                        n
                        for n in members
                        if n is not src and _vid_count(n, vid) < ncap
                    ],
                    vid,
                )
                if dst is None:
                    break
                mover.move(vid, collection, sid, src, dst)

    _cap_node_loss_exposure(mover, nodes, vid, collection, scheme)


def _balance_rack_totals(
    mover: EcMover,
    nodes: list[EcNode],
    collections: dict[int, str],
    collection: str | None = None,
) -> None:
    """Even out total per-node shard counts inside each rack, moving only
    volumes the destination doesn't already hold (reference balanceEcRack:
    keeps per-volume distribution intact while levelling totals).  A
    collection filter scopes which volumes may be touched."""

    def movable(vid: int) -> bool:
        return (
            collection is None
            or collection == ""
            or collections.get(vid, "") == collection
        )

    racks: dict[tuple[str, str], list[EcNode]] = {}
    for n in nodes:
        racks.setdefault((n.dc, n.rack), []).append(n)
    for members in racks.values():
        if len(members) < 2:
            continue
        avg = sum(n.shard_count() for n in members) / len(members)
        moved = True
        while moved:
            moved = False
            members.sort(key=lambda n: n.shard_count())
            low, high = members[0], members[-1]
            if high.shard_count() <= avg or low.shard_count() + 1 > avg:
                break
            if low.free_ec_slots <= 0:
                break
            for vid, bits in sorted(high.shards.items()):
                if (
                    not movable(vid)
                    or vid in low.shards
                    or vid in low.blocked_vids
                ):
                    # scoped out, would break per-volume spread, or the
                    # destination holds this vid on another disk type
                    continue
                sid = bits.ids()[-1]
                mover.move(vid, collections.get(vid, ""), sid, high, low)
                moved = True
                break


def balance_ec_shards_view(
    nodes: list[EcNode],
    collections: dict[int, str],
    mover: EcMover,
    *,
    collection: str | None = None,
    rack_tolerance: int = 0,
    schemes: dict | None = None,
) -> None:
    """Run the full balance over an in-memory cluster view (pure but for
    the mover's side effects) — the testable core.  ``schemes`` (vid ->
    EcScheme, from the holders' heartbeats) drives the per-node
    loss-exposure cap — group-aware for LRC volumes."""
    census = shards_by_vid(nodes)
    for vid in sorted(census):
        coll = collections.get(vid, "")
        if collection is not None and collection != "" and coll != collection:
            continue
        _balance_one_volume(
            mover, nodes, vid, coll, rack_tolerance=rack_tolerance,
            scheme=(schemes or {}).get(vid),
        )
    _balance_rack_totals(mover, nodes, collections, collection)


def balance_ec_shards(
    env: CommandEnv,
    collection: str | None = None,
    rack_tolerance: int = 0,
    apply: bool = True,
    disk_type: str = "",
) -> EcMover:
    """Balance every EC volume (optionally one collection).  Moves run
    sequentially: each move mutates the shared EcNode bookkeeping the
    next placement decision reads.  ``disk_type`` restricts sources and
    destinations to one disk type's slots (reference
    command_ec_common.go:377-381)."""
    nodes, collections, schemes = collect_ec_nodes(
        env.collect_topology().topology_info, disk_type=disk_type
    )
    mover: EcMover = RpcEcMover(env) if apply else PlanEcMover()
    balance_ec_shards_view(
        nodes, collections, mover,
        collection=collection, rack_tolerance=rack_tolerance,
        schemes=schemes,
    )
    return mover


def balance_ec_volume(env: CommandEnv, vid: int) -> EcMover:
    """Spread one EC volume's shards across racks and nodes, as
    ``ec.balance`` would, and move no other volume's: what the
    maintenance worker runs after its encode."""
    nodes, collections, schemes = collect_ec_nodes(env.collect_topology().topology_info)
    mover = RpcEcMover(env)
    _balance_one_volume(mover, nodes, vid, collections.get(vid, ""), scheme=schemes.get(vid))
    return mover


@shell_command("ec.balance", "spread EC shards across racks and nodes")
def cmd_ec_balance(env, args, out):
    env.confirm_is_locked()
    tolerance = _rack_tolerance(args.replicaPlacement)
    mover = balance_ec_shards(
        env, args.collection or None, rack_tolerance=tolerance,
        apply=not args.noApply, disk_type=args.diskType,
    )
    if args.noApply:
        for step in mover.plan:
            print("plan: %s vid=%d shard=%d %s -> %s" % step, file=out)
    print(f"ec.balance moved {mover.moves} shards", file=out)


def _rack_tolerance(placement: str) -> int:
    """xyz replica placement -> y (different-rack count), the extra
    shards a rack may hold above the even split."""
    return int(placement[1]) if len(placement) == 3 and placement.isdigit() else 0


def _ec_balance_flags(p):
    p.add_argument("-collection", default="")
    p.add_argument(
        "-replicaPlacement", default="000",
        help="xyz placement; y = extra per-rack shard tolerance",
    )
    p.add_argument(
        "-noApply", action="store_true", help="print the plan, move nothing"
    )
    p.add_argument(
        "-diskType", default="",
        help="balance only this disk type's slots (hdd/ssd/...)",
    )


cmd_ec_balance.configure = _ec_balance_flags
