"""ec.encode / ec.rebuild / ec.decode shell commands.

The port's copy of seaweedfs_tpu/shell/command_ec.py (reference
shell/command_ec_encode.go:73-262: mark readonly -> generate -> mount ->
balance -> delete originals; command_ec_rebuild.go:62-256: copy survivors
to one rebuilder -> rebuild RPC -> mount -> drop temp copies;
command_ec_decode.go:89-119: collect all shards -> decode to .dat/.idx ->
mount volume -> drop shards).  The encode and rebuild behind these RPCs
run in the volume servers, through K1 on the card.  ``ec.encode
-streaming`` picks every shard's holder before the generate, which then
sends each shard to its holder as the pipeline produces it (reference
worker ec_task.go:534)."""

from __future__ import annotations

import time

from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits

from seaweedfs_tpu_torch.shell import ShellError, shell_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.ec_common import (
    collect_ec_nodes,
    grpc_addr,
    copy_shards,
    delete_shards,
    geometry_msg,
    make_scheme,
    mount_shards,
    parallel_exec,
    scheme_desc,
    shards_by_vid,
    unmount_shards,
)


def _loc_grpc(loc) -> str:
    return grpc_addr(loc.url, loc.grpc_port)


def _scheme_from_args(args) -> EcScheme | None:
    """The storage class + geometry the user explicitly asked for, or
    None — callers fall back to the geometry each volume's holders
    report (recorded in .vif), so rebuild/decode of custom-geometry
    volumes never sends a wrong explicit geometry to the server.

    ``-code lrc`` selects the locally-repairable class (default
    LRC(10,2,2): 2 local XOR parities + 2 global RS parities — RS(10,4)
    durability footprint, single-loss repair reads halved);
    ``-localGroups`` adjusts l."""
    k = getattr(args, "dataShards", 0)
    m = getattr(args, "parityShards", 0)
    code = getattr(args, "code", "") or ""
    groups = getattr(args, "localGroups", 0)
    if code == "lrc" or groups:
        return make_scheme(k, m, groups or 2)
    if code and code != "rs":
        raise ShellError(f"unknown -code {code!r} (rs | lrc)")
    if not k and not m and not code:
        return None
    return EcScheme(
        data_shards=k or DEFAULT_SCHEME.data_shards,
        parity_shards=m or DEFAULT_SCHEME.parity_shards,
    )


# ---------------------------------------------------------------------------
# ec.encode


def collect_volume_ids_for_ec_encode(
    env: CommandEnv, collection: str, full_percent: float, quiet_seconds: float
) -> list[int]:
    """Volumes ≥ full_percent% of the size limit and quiet for
    quiet_seconds (reference collectVolumeIdsForEcEncode,
    command_ec_encode.go:278)."""
    resp = env.collect_topology()
    limit = resp.volume_size_limit_mb * 1024 * 1024
    out: set[int] = set()
    now_ns = time.time_ns()
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for disk in dn.disk_infos.values():
                    for v in disk.volume_infos:
                        if v.collection != collection:
                            continue
                        if v.size < limit * full_percent / 100.0:
                            continue
                        if quiet_seconds > 0:
                            grpc = grpc_addr(dn.url, dn.grpc_port)
                            st = env.volume(grpc).VolumeStatus(
                                vs_pb.VolumeStatusRequest(volume_id=v.id)
                            )
                            if (
                                st.last_modified_ns
                                # weedlint: disable=W005 — volume mtime is wall-clock
                                and now_ns - st.last_modified_ns
                                < quiet_seconds * 1e9
                            ):
                                continue
                        out.add(v.id)
    return sorted(out)


def do_ec_encode(
    env: CommandEnv,
    vid: int,
    collection: str,
    scheme: EcScheme,
    max_parallelization: int = 10,
) -> None:
    locations = env.lookup_volume(vid)
    if not locations:
        raise ShellError(f"volume {vid} not found")
    # mark all replicas readonly (encode must see a frozen .dat)
    for loc in locations:
        env.volume(_loc_grpc(loc)).VolumeMarkReadonly(
            vs_pb.VolumeMarkRequest(volume_id=vid)
        )
    source = _loc_grpc(locations[0])
    env.volume(source).EcShardsGenerate(
        vs_pb.EcShardsGenerateRequest(
            volume_id=vid, collection=collection, geometry=geometry_msg(scheme)
        )
    )
    mount_shards(
        env, vid, collection, list(range(scheme.total_shards)), source
    )
    # delete original replicas — reads flow through the EC path from here
    parallel_exec(
        [
            (
                lambda g=_loc_grpc(loc): env.volume(g).VolumeDelete(
                    vs_pb.VolumeDeleteRequest(volume_id=vid)
                )
            )
            for loc in locations
        ],
        max_parallelization,
    )


def pick_streaming_targets(env: CommandEnv, scheme: EcScheme, disk_type: str = "") -> list[str]:
    """One destination gRPC address per shard, decided BEFORE the encode so
    shards stream straight to their holders.  Capacity-weighted: each
    shard goes to the node with the most remaining free EC slots (ties
    broken by node id for determinism) and every placement consumes a
    slot, the same pressure ec.balance converges to."""
    nodes, _, _ = collect_ec_nodes(env.collect_topology().topology_info, scheme, disk_type)
    remaining = {n.info.id: n.free_ec_slots for n in nodes if n.free_ec_slots > 0}
    by_id = {n.info.id: n for n in nodes}
    total_free = sum(remaining.values())
    if total_free < scheme.total_shards:
        raise ShellError(
            f"streaming encode needs {scheme.total_shards} free EC slots"
            + (f" on {disk_type} disks" if disk_type else "")
            + f", cluster has {total_free}")
    targets = []
    assigned: dict[str, list[int]] = {}
    cap = scheme.max_shards_per_disk
    for sid in range(scheme.total_shards):
        # durability first: prefer nodes under the max_shards_per_disk cap;
        # past the cap (a cluster smaller than min_total_disks), still
        # refuse placements whose single-node loss would be rank-deficient
        # (e.g. a whole LRC local group on one node) unless nothing else
        # has a slot
        live = {i: r for i, r in remaining.items() if r > 0}
        tiers = [
            {i: r for i, r in live.items() if len(assigned.get(i, [])) < cap},
            {i: r for i, r in live.items()
             if scheme.loss_recoverable(tuple(assigned.get(i, []) + [sid]))},
            live,
        ]
        pool = next(t for t in tiers if t)
        nid = max(pool, key=lambda i: (pool[i], i))
        remaining[nid] -= 1
        assigned.setdefault(nid, []).append(sid)
        n = by_id[nid]
        targets.append(grpc_addr(n.info.url, n.info.grpc_port))
    return targets


def do_ec_encode_streaming(env: CommandEnv, vid: int, collection: str, scheme: EcScheme,
                           disk_type: str = "", max_parallelization: int = 10) -> None:
    """Distributed generate: shards stream to their destination holders as
    they are produced (reference worker ec_task.go:534
    sendShardFileToDestination): no shard is written locally only to be
    copied to its holder afterwards (the k+m/k write amplification of
    generate-then-balance)."""
    locations = env.lookup_volume(vid)
    if not locations:
        raise ShellError(f"volume {vid} not found")
    for loc in locations:
        env.volume(_loc_grpc(loc)).VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=vid))
    source = _loc_grpc(locations[0])
    targets = pick_streaming_targets(env, scheme, disk_type)
    env.volume(source).EcShardsGenerate(vs_pb.EcShardsGenerateRequest(
        volume_id=vid, collection=collection, geometry=geometry_msg(scheme), targets=targets,
        disk_type=disk_type))
    by_dest: dict[str, list[int]] = {}
    for sid, dest in enumerate(targets):
        by_dest.setdefault(dest or source, []).append(sid)
    # every holder needs the needle index beside its shards; the .ecx/.vif
    # are small, so copying them is not the write wall the shards were
    for dest, sids in sorted(by_dest.items()):
        if dest != source:
            copy_shards(env, vid, collection, [], source, dest, copy_index_files=True,
                        disk_type=disk_type)
        mount_shards(env, vid, collection, sids, dest)
    if source not in by_dest:
        # the generating server holds no shards: drop its orphaned index
        # files (EcShardsDelete with no ids sweeps .ecx/.ecj/.vif)
        env.volume(source).EcShardsDelete(vs_pb.EcShardsDeleteRequest(
            volume_id=vid, collection=collection, shard_ids=[]))
    parallel_exec(
        [(lambda g=_loc_grpc(loc): env.volume(g).VolumeDelete(
            vs_pb.VolumeDeleteRequest(volume_id=vid))) for loc in locations],
        max_parallelization,
    )


def _wait_for_registered_shards(
    env: CommandEnv, vid: int, total: int, timeout: float = 15.0
) -> None:
    """Block until the master's topology shows `total` shards for vid —
    generate/mount land via heartbeat deltas, so balancing immediately
    after mount would act on a stale shard map."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        nodes, _, _ = collect_ec_nodes(env.collect_topology().topology_info)
        seen = ShardBits(0)
        for n in nodes:
            if vid in n.shards:
                seen = seen.plus(n.shards[vid])
        if seen.count() >= total:
            return
        time.sleep(0.1)
    raise ShellError(
        f"volume {vid}: EC shards never reached the master topology"
    )


@shell_command("ec.encode", "erasure-code volumes (encode through K1 on the card)")
def cmd_ec_encode(env, args, out):
    env.confirm_is_locked()
    scheme = _scheme_from_args(args) or DEFAULT_SCHEME
    if args.volumeId:
        vids = [args.volumeId]
    else:
        vids = collect_volume_ids_for_ec_encode(
            env, args.collection, args.fullPercent, args.quietFor
        )
    if not vids:
        print("no volumes to encode", file=out)
        return
    for vid in vids:
        if args.streaming:
            do_ec_encode_streaming(env, vid, args.collection, scheme, disk_type=args.diskType,
                                   max_parallelization=args.maxParallelization)
        else:
            do_ec_encode(env, vid, args.collection, scheme, args.maxParallelization)
        print(f"ec.encode volume {vid} -> {scheme_desc(scheme)}"
              + (" [streamed to holders]" if args.streaming else ""), file=out)
    if not args.skipBalance:
        from seaweedfs_tpu_torch.shell.command_ec_balance import balance_ec_shards

        for vid in vids:
            _wait_for_registered_shards(env, vid, scheme.total_shards)
        mover = balance_ec_shards(env, args.collection, disk_type=args.diskType)
        print(f"ec.balance moved {mover.moves} shards", file=out)


def _encode_flags(p):
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-fullPercent", type=float, default=95.0)
    p.add_argument("-quietFor", type=float, default=3600.0)
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)
    p.add_argument(
        "-code", default="",
        help="storage class: rs (default) | lrc (local-group repair: "
        "single-loss rebuilds read the local group, not k shards)",
    )
    p.add_argument(
        "-localGroups", type=int, default=0,
        help="LRC local group count l (default 2; parityShards counts "
        "l local XOR parities + the global RS parities)",
    )
    p.add_argument("-maxParallelization", type=int, default=10)
    p.add_argument("-skipBalance", action="store_true")
    p.add_argument(
        "-streaming", action="store_true",
        help="stream shards straight to destination holders during "
        "generate instead of materializing locally and balancing",
    )
    p.add_argument(
        "-diskType", default="",
        help="post-encode balance places shards on this disk type only",
    )


cmd_ec_encode.configure = _encode_flags


# ---------------------------------------------------------------------------
# ec.rebuild


def rebuild_one_ec_volume(
    env: CommandEnv,
    vid: int,
    collection: str,
    nodes,
    scheme: EcScheme,
    explicit: bool = False,
    out=None,
) -> None:
    census = {
        n.info.id: n.shards[vid] for n in nodes if vid in n.shards
    }
    present = ShardBits(0)
    for bits in census.values():
        present = present.plus(bits)
    if present.count() >= scheme.total_shards:
        return  # intact
    missing = tuple(
        s for s in range(scheme.total_shards) if not present.has(s)
    )
    # plan-driven staging: ship the rebuilder ONLY the survivors the
    # repair plan reads — for a single-loss LRC volume that is the lost
    # shard's local group (group_size shards moved cross-server, not all
    # ~total-1 survivors: the repair-traffic halving applies to the
    # orchestrated rebuild too, not just local file reads)
    try:
        _mat, plan_inputs, _mode = scheme.repair_plan(
            tuple(present.has(s) for s in range(scheme.total_shards)),
            missing,
        )
    except ValueError as e:
        raise ShellError(
            f"volume {vid} unrepairable: only {present.count()} of "
            f"{scheme.total_shards} shards survive ({e})"
        ) from e
    # rebuilder: most free EC slots (reference rebuildOneEcVolume target)
    rebuilder = max(nodes, key=lambda n: n.free_ec_slots)
    local = rebuilder.shards.get(vid, ShardBits(0))
    # pull the plan's input shards the rebuilder lacks (temp copies)
    copied: list[int] = []
    copy_index = local.count() == 0
    for n in nodes:
        if n is rebuilder or vid not in n.shards:
            continue
        want = [s for s in n.shards[vid].ids()
                if s in plan_inputs and s not in local.ids()
                and s not in copied]
        if not want:
            continue
        copy_shards(
            env, vid, collection, want, n.grpc_address,
            rebuilder.grpc_address, copy_index_files=copy_index,
        )
        copy_index = False
        copied.extend(want)
    # only send an explicit geometry when the user asked for one —
    # otherwise the server reads the volume's own .vif geometry
    resp = env.volume(rebuilder.grpc_address).EcShardsRebuild(
        vs_pb.EcShardsRebuildRequest(
            volume_id=vid,
            collection=collection,
            geometry=geometry_msg(scheme) if explicit else None,
            # only the cluster-lost shards: the rebuilder's disk holds
            # just the plan inputs, and "absent here" != "lost"
            target_shard_ids=missing,
        )
    )
    rebuilt = list(resp.rebuilt_shard_ids)
    mount_shards(env, vid, collection, rebuilt, rebuilder.grpc_address)
    for sid in rebuilt:
        rebuilder.add(vid, sid)
    # drop the unmounted temp copies
    temps = [s for s in copied if s not in rebuilt]
    if temps:
        delete_shards(env, vid, collection, temps, rebuilder.grpc_address)
    print(
        f"ec.rebuild volume {vid}: rebuilt shards {rebuilt} on "
        f"{rebuilder.info.id}",
        file=out,
    )


@shell_command("ec.rebuild", "rebuild missing EC shards (through K1 on the card)")
def cmd_ec_rebuild(env, args, out):
    env.confirm_is_locked()
    args_scheme = _scheme_from_args(args)
    nodes, collections, schemes = collect_ec_nodes(
        env.collect_topology().topology_info
    )
    census = shards_by_vid(nodes)
    vids = [args.volumeId] if args.volumeId else sorted(census)
    errors = []
    for vid in vids:
        if vid not in census:
            raise ShellError(f"no EC shards for volume {vid}")
        scheme = args_scheme or schemes.get(vid) or DEFAULT_SCHEME
        try:
            rebuild_one_ec_volume(
                env, vid, args.collection or collections.get(vid, ""),
                nodes, scheme, explicit=args_scheme is not None, out=out,
            )
        except ShellError as e:
            if args.volumeId:
                raise
            # sweep mode: one hopeless volume must not strand the rest
            errors.append(str(e))
            print(f"ec.rebuild: {e}", file=out)
    if errors:
        raise ShellError("; ".join(errors))


def _rebuild_flags(p):
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)
    p.add_argument("-maxParallelization", type=int, default=10)


cmd_ec_rebuild.configure = _rebuild_flags


# ---------------------------------------------------------------------------
# ec.decode


@shell_command("ec.decode", "decode EC shards back into a normal volume")
def cmd_ec_decode(env, args, out):
    env.confirm_is_locked()
    args_scheme = _scheme_from_args(args)
    nodes, collections, schemes = collect_ec_nodes(
        env.collect_topology().topology_info
    )
    census = shards_by_vid(nodes)
    if args.volumeId:
        vids = [args.volumeId]
    else:
        vids = sorted(
            v for v in census
            if not args.collection or collections.get(v, "") == args.collection
        )
    for vid in vids:
        if vid not in census:
            raise ShellError(f"no EC shards for volume {vid}")
        collection = args.collection or collections.get(vid, "")
        holders = [n for n in nodes if vid in n.shards]
        target = max(holders, key=lambda n: n.shards[vid].count())
        local = target.shards[vid]
        have = set(local.ids())
        for n in holders:
            if n is target:
                continue
            want = [s for s in n.shards[vid].ids() if s not in have]
            if not want:
                continue
            copy_shards(
                env, vid, collection, want, n.grpc_address,
                target.grpc_address, copy_index_files=False,
            )
            have.update(want)
        env.volume(target.grpc_address).EcShardsToVolume(
            vs_pb.EcShardsToVolumeRequest(
                volume_id=vid,
                collection=collection,
                geometry=(
                    geometry_msg(args_scheme) if args_scheme else None
                ),
            )
        )
        env.volume(target.grpc_address).VolumeMount(
            vs_pb.VolumeMountRequest(volume_id=vid, collection=collection)
        )
        # drop every EC shard (mounted ones first, then files everywhere)
        for n in holders:
            ids = n.shards[vid].ids()
            unmount_shards(env, vid, ids, n.grpc_address)
        delete_shards(
            env, vid, collection, sorted(have), target.grpc_address
        )
        for n in holders:
            if n is not target:
                delete_shards(
                    env, vid, collection, n.shards[vid].ids(), n.grpc_address
                )
            n.shards.pop(vid, None)
        print(f"ec.decode volume {vid} -> normal volume on {target.info.id}",
              file=out)


def _decode_flags(p):
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)


cmd_ec_decode.configure = _decode_flags
