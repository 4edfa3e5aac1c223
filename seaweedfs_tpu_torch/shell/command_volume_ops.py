"""volume.* ops long tail: copy/move/mount/grow/repair/evacuate/tier.move.

The port's copy of seaweedfs_tpu/shell/command_volume_ops.py: the
reference's shell/command_volume_copy.go, _move.go, _mount.go,
_unmount.go, _grow (master vol/grow), _configure_replication.go,
_fix_replication.go, _delete_empty.go, _server_evacuate.go,
_server_leave.go, _tier_move.go, _tier_upload.go and _tier_download.go,
and command_volume_fsck.go (``volume.fsck``, which walks the filer of the
shell's ``-filer``), driven over the master, volume and filer gRPC
contracts.  Two repairs against the JAX ``volume.fsck``, each of a needle
the JAX command reports as an orphan while a file references it (and
``-reallyDeleteFromVolume`` would delete, leaving the file unreadable): a
batch-assigned chunk's ``fid_N`` names needle key + N (the JAX parse
reads the ``_N`` into the key's hex), and a manifest file's manifest
chunks count as referenced beside its data chunks."""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr
from seaweedfs_tpu_torch.util import wlog


# ---------------------------------------------------------------------------
# topology helpers
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    id: str
    url: str
    grpc: str
    dc: str
    rack: str
    free_slots: int
    volumes: dict[int, m_pb.VolumeStat]


def _collect_nodes(env) -> list[_Node]:
    topo = env.collect_topology().topology_info
    nodes = []
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                vols: dict[int, m_pb.VolumeStat] = {}
                free = 0
                for disk in dn.disk_infos.values():
                    free += disk.free_volume_count
                    for v in disk.volume_infos:
                        vols[v.id] = v
                nodes.append(
                    _Node(
                        id=dn.id,
                        url=dn.url,
                        grpc=grpc_addr(dn.url, dn.grpc_port),
                        dc=dc.id,
                        rack=rack.id,
                        free_slots=free,
                        volumes=vols,
                    )
                )
    return nodes


def _find_node(nodes: list[_Node], which: str) -> _Node:
    for n in nodes:
        if which in (n.id, n.url, n.grpc):
            return n
    raise RuntimeError(f"no volume server {which!r} in the topology")


def _live_move(env, vid: int, collection: str, read_only: bool,
               src: _Node, dst: _Node, disk_type: str = "") -> None:
    """Freeze → pull to dst → drop from src (reference LiveMoveVolume,
    command_volume_move.go, with readonly-freeze semantics).
    ``disk_type`` pins the landing disk (volume.tier.move)."""
    src_stub = env.volume(src.grpc)
    dst_stub = env.volume(dst.grpc)
    if not read_only:
        src_stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=vid))
    try:
        dst_stub.VolumeCopy(
            vs_pb.VolumeCopyRequest(
                volume_id=vid, collection=collection,
                source_data_node=src.grpc, disk_type=disk_type,
            )
        )
    except Exception:
        if not read_only:
            src_stub.VolumeMarkWritable(vs_pb.VolumeMarkRequest(volume_id=vid))
        raise
    src_stub.VolumeDelete(vs_pb.VolumeDeleteRequest(volume_id=vid))
    if not read_only:
        dst_stub.VolumeMarkWritable(vs_pb.VolumeMarkRequest(volume_id=vid))
    else:
        dst_stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=vid))


# ---------------------------------------------------------------------------
# copy / move / mount / unmount / grow
# ---------------------------------------------------------------------------

@shell_command("volume.copy", "copy a volume from one server to another")
def cmd_volume_copy(env, args, out):
    env.confirm_is_locked()
    nodes = _collect_nodes(env)
    src = _find_node(nodes, args.source)
    dst = _find_node(nodes, args.target)
    v = src.volumes.get(args.volumeId)
    if v is None:
        raise RuntimeError(f"volume {args.volumeId} not on {args.source}")
    env.volume(dst.grpc).VolumeCopy(
        vs_pb.VolumeCopyRequest(
            volume_id=args.volumeId,
            collection=v.collection,
            source_data_node=src.grpc,
        )
    )
    print(f"copied volume {args.volumeId} {src.id} -> {dst.id}", file=out)


def _copy_flags(p):
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-source", required=True, help="source node id/url")
    p.add_argument("-target", required=True, help="target node id/url")


cmd_volume_copy.configure = _copy_flags


@shell_command("volume.move", "move a volume between servers (freeze+copy+drop)")
def cmd_volume_move(env, args, out):
    env.confirm_is_locked()
    nodes = _collect_nodes(env)
    src = _find_node(nodes, args.source)
    dst = _find_node(nodes, args.target)
    v = src.volumes.get(args.volumeId)
    if v is None:
        raise RuntimeError(f"volume {args.volumeId} not on {args.source}")
    _live_move(env, args.volumeId, v.collection, v.read_only, src, dst)
    print(f"moved volume {args.volumeId} {src.id} -> {dst.id}", file=out)


cmd_volume_move.configure = _copy_flags


@shell_command("volume.mount", "mount an unmounted volume on a server")
def cmd_volume_mount(env, args, out):
    env.confirm_is_locked()
    node = _find_node(_collect_nodes(env), args.node)
    env.volume(node.grpc).VolumeMount(
        vs_pb.VolumeMountRequest(
            volume_id=args.volumeId, collection=args.collection
        )
    )
    print(f"mounted volume {args.volumeId} on {node.id}", file=out)


def _mount_flags(p):
    p.add_argument("-node", required=True, help="node id/url")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")


cmd_volume_mount.configure = _mount_flags


@shell_command("volume.unmount", "unmount a volume (files stay on disk)")
def cmd_volume_unmount(env, args, out):
    env.confirm_is_locked()
    node = _find_node(_collect_nodes(env), args.node)
    env.volume(node.grpc).VolumeUnmount(
        vs_pb.VolumeMountRequest(volume_id=args.volumeId)
    )
    print(f"unmounted volume {args.volumeId} on {node.id}", file=out)


def _unmount_flags(p):
    p.add_argument("-node", required=True, help="node id/url")
    p.add_argument("-volumeId", type=int, required=True)


cmd_volume_unmount.configure = _unmount_flags


@shell_command("volume.grow", "pre-allocate volumes for a layout")
def cmd_volume_grow(env, args, out):
    env.confirm_is_locked()
    resp = env.master().VolumeGrow(
        m_pb.VolumeGrowRequest(
            collection=args.collection,
            replication=args.replication,
            ttl_seconds=args.ttl,
            count=args.count,
            disk_type=args.disk,
        )
    )
    print(f"grew volumes {list(resp.volume_ids)}", file=out)


def _grow_flags(p):
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", type=int, default=0)
    p.add_argument("-count", type=int, default=1)
    p.add_argument("-disk", default="", help="disk type (default hdd)")


cmd_volume_grow.configure = _grow_flags


@shell_command("volume.configure.replication",
               "change a volume's replica placement code")
def cmd_configure_replication(env, args, out):
    env.confirm_is_locked()
    if not args.volumeId and not args.collection:
        # never rewrite the whole cluster's placement implicitly
        raise RuntimeError("scope with -volumeId or -collection")
    nodes = _collect_nodes(env)
    changed = 0
    for n in nodes:
        for vid, v in sorted(n.volumes.items()):
            if args.volumeId and vid != args.volumeId:
                continue
            if args.collection and v.collection != args.collection:
                continue
            env.volume(n.grpc).VolumeConfigureReplication(
                vs_pb.VolumeConfigureReplicationRequest(
                    volume_id=vid, replication=args.replication
                )
            )
            print(f"volume {vid} on {n.id}: replication -> {args.replication}",
                  file=out)
            changed += 1
    if changed == 0:
        raise RuntimeError("no volumes matched the given scope")
    print(f"{changed} volume replicas reconfigured "
          "(run volume.fix.replication to realize the new placement)",
          file=out)


def _conf_repl_flags(p):
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-replication", required=True, help="xyz placement code")


cmd_configure_replication.configure = _conf_repl_flags


# ---------------------------------------------------------------------------
# replication repair
# ---------------------------------------------------------------------------

def plan_fix_replication(nodes: list[_Node], collection: str | None = None):
    """Pure planner: returns (under, over) move lists.

    under: (vid, src_node, dst_node) copies to create;
    over:  (vid, node) replicas to delete.
    Placement math mirrors the reference's command_volume_fix_replication.go:
    expected copies = 1 + sum of the xyz placement digits; new replicas
    prefer racks not already holding one.
    """
    holders: dict[int, list[_Node]] = {}
    stats: dict[int, m_pb.VolumeStat] = {}
    for n in nodes:
        for vid, v in n.volumes.items():
            if collection is not None and v.collection != collection:
                continue
            holders.setdefault(vid, []).append(n)
            stats[vid] = v
    under, over = [], []
    free = {n.id: n.free_slots for n in nodes}
    for vid, hs in sorted(holders.items()):
        rp = stats[vid].replica_placement or "000"
        expected = 1 + sum(int(c) for c in rp if c.isdigit())
        if len(hs) < expected:
            need_other_rack = len(rp) == 3 and rp[1] != "0"
            held_racks = {n.rack for n in hs}
            held_ids = {n.id for n in hs}
            candidates = [
                n for n in nodes
                if n.id not in held_ids and free.get(n.id, 0) > 0
            ]
            if need_other_rack:
                preferred = [n for n in candidates if n.rack not in held_racks]
                candidates = preferred or candidates
            candidates.sort(key=lambda n: -free.get(n.id, 0))
            for dst in candidates[: expected - len(hs)]:
                under.append((vid, hs[0], dst))
                free[dst.id] -= 1
        elif len(hs) > expected:
            # drop extras from the fullest nodes first
            extras = sorted(hs, key=lambda n: free.get(n.id, 0))
            for n in extras[: len(hs) - expected]:
                over.append((vid, n))
    return under, over


@shell_command("volume.fix.replication", "repair under/over-replicated volumes")
def cmd_fix_replication(env, args, out):
    env.confirm_is_locked()
    nodes = _collect_nodes(env)
    under, over = plan_fix_replication(
        nodes, args.collection if args.collection else None
    )
    for vid, src, dst in under:
        print(f"replicate volume {vid}: {src.id} -> {dst.id}", file=out)
        if not args.noApply:
            v = src.volumes[vid]
            env.volume(dst.grpc).VolumeCopy(
                vs_pb.VolumeCopyRequest(
                    volume_id=vid,
                    collection=v.collection,
                    source_data_node=src.grpc,
                )
            )
            if v.read_only:
                env.volume(dst.grpc).VolumeMarkReadonly(
                    vs_pb.VolumeMarkRequest(volume_id=vid)
                )
    for vid, node in over:
        print(f"delete extra replica of volume {vid} on {node.id}", file=out)
        if not args.noApply:
            env.volume(node.grpc).VolumeDelete(
                vs_pb.VolumeDeleteRequest(volume_id=vid)
            )
    print(
        f"{'planned' if args.noApply else 'fixed'} "
        f"{len(under)} under- and {len(over)} over-replicated",
        file=out,
    )


def _fix_flags(p):
    p.add_argument("-collection", default="")
    p.add_argument("-noApply", action="store_true", help="plan only")


cmd_fix_replication.configure = _fix_flags


# ---------------------------------------------------------------------------
# empty-volume reaping, evacuation, leave
# ---------------------------------------------------------------------------

@shell_command("volume.deleteEmpty", "delete volumes holding no live files")
def cmd_delete_empty(env, args, out):
    env.confirm_is_locked()
    deleted = 0
    for n in _collect_nodes(env):
        for vid, v in sorted(n.volumes.items()):
            if v.file_count - v.delete_count > 0:
                continue
            print(f"delete empty volume {vid} on {n.id}", file=out)
            if args.force:
                env.volume(n.grpc).VolumeDelete(
                    vs_pb.VolumeDeleteRequest(volume_id=vid, only_empty=True)
                )
                deleted += 1
    print(f"{deleted} deleted (use -force to apply)" if not args.force
          else f"{deleted} deleted", file=out)


cmd_delete_empty.configure = lambda p: p.add_argument(
    "-force", action="store_true", help="actually delete"
)


@shell_command("volume.server.evacuate", "move all volumes off one server")
def cmd_server_evacuate(env, args, out):
    env.confirm_is_locked()
    nodes = _collect_nodes(env)
    victim = _find_node(nodes, args.node)
    others = [n for n in nodes if n.id != victim.id]
    if not others:
        raise RuntimeError("no other volume servers to evacuate to")
    moved = 0
    for vid, v in sorted(victim.volumes.items()):
        # avoid nodes already holding a replica of this volume
        targets = [
            n for n in others if vid not in n.volumes and n.free_slots > 0
        ]
        if not targets:
            print(f"volume {vid}: no target with free slots", file=out)
            continue
        dst = max(targets, key=lambda n: n.free_slots)
        print(f"move volume {vid}: {victim.id} -> {dst.id}", file=out)
        if not args.noApply:
            _live_move(env, vid, v.collection, v.read_only, victim, dst)
            dst.volumes[vid] = v
            dst.free_slots -= 1
            moved += 1
    print(f"evacuated {moved} volumes from {victim.id}", file=out)


def _evac_flags(p):
    p.add_argument("-node", required=True, help="node id/url to empty")
    p.add_argument("-noApply", action="store_true", help="plan only")


cmd_server_evacuate.configure = _evac_flags


@shell_command("volume.server.leave", "ask a server to stop heartbeating")
def cmd_server_leave(env, args, out):
    env.confirm_is_locked()
    node = _find_node(_collect_nodes(env), args.node)
    env.volume(node.grpc).VolumeServerLeave(vs_pb.VolumeServerLeaveRequest())
    print(f"{node.id} is leaving the cluster", file=out)


cmd_server_leave.configure = lambda p: p.add_argument(
    "-node", required=True, help="node id/url"
)


# ---------------------------------------------------------------------------
# tiering to an object store (reference command_volume_tier_upload.go,
# command_volume_tier_download.go)
# ---------------------------------------------------------------------------

@shell_command("volume.tier.upload", "move a sealed volume's .dat to a tier")
def cmd_tier_upload(env, args, out):
    env.confirm_is_locked()
    node = _find_node(_collect_nodes(env), args.node)
    resp = env.volume(node.grpc).VolumeTierMove(vs_pb.VolumeTierMoveRequest(
        volume_id=args.volumeId, collection=args.collection, dest=args.dest,
        force_seal=args.force))
    print(f"volume {args.volumeId} tiered to {args.dest} as {resp.key}", file=out)


def _tier_up_flags(p):
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dest", required=True, help="object-store location")
    p.add_argument("-force", action="store_true", help="seal if writable")


cmd_tier_upload.configure = _tier_up_flags


@shell_command("volume.tier.download", "bring a tiered volume's .dat back")
def cmd_tier_download(env, args, out):
    env.confirm_is_locked()
    node = _find_node(_collect_nodes(env), args.node)
    env.volume(node.grpc).VolumeTierMove(vs_pb.VolumeTierMoveRequest(
        volume_id=args.volumeId, collection=args.collection, dest=args.dest, download=True))
    print(f"volume {args.volumeId} downloaded from {args.dest}", file=out)


def _tier_down_flags(p):
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dest", required=True)


cmd_tier_download.configure = _tier_down_flags


# ---------------------------------------------------------------------------
# volume.tier.move (reference command_volume_tier_move.go)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------

@shell_command("volume.fsck", "find needles no filer entry references")
def cmd_volume_fsck(env, args, out):
    """Orphan census (reference command_volume_fsck.go): walk the filer
    for referenced fids, walk every volume's needle map, diff."""
    env.confirm_is_locked()
    from seaweedfs_tpu_torch.filer import manifest
    from seaweedfs_tpu_torch.filer.reader import fetch_chunk
    from seaweedfs_tpu_torch.shell.command_fs import _master_client, _walk

    mc = _master_client(env)
    referenced: dict[int, set[int]] = {}  # vid -> needle keys
    for e in _walk(env, "/"):
        if e.is_directory or e.content:
            continue
        try:
            data, manifests = manifest.resolve_chunk_manifest(
                lambda fid: fetch_chunk(mc, fid), e.chunks)
        except Exception as err:  # noqa: BLE001 — counted by fs.verify instead
            if wlog.V(2):
                wlog.info("volume.orphans: resolve %s failed: %s", e.full_path, err)
            continue
        for c in data + manifests:
            vid_str, _, rest = c.fid.partition(",")
            # batch assigns: fid_N is needle key + N, under the base's cookie
            rest, _, index = rest.partition("_")
            try:
                vid = int(vid_str)
                key = int(rest[:-8] or "0", 16)  # strip 8-hex-digit cookie
            except ValueError:
                continue
            key += int(index) if index.isdigit() else 0
            referenced.setdefault(vid, set()).add(key)

    import time as _time

    cutoff_ns = (_time.time() - args.cutoffAgeSeconds) * 1e9
    orphans = orphan_bytes = checked = skipped_fresh = 0
    for n in _collect_nodes(env):
        for vid in sorted(n.volumes):
            if args.reallyDeleteFromVolume:
                # in-flight uploads write needles before their filer entry
                # exists; never purge from a volume written to after the
                # cutoff (reference fsck -cutoffTimeAgo guard)
                st = env.volume(n.grpc).VolumeStatus(
                    vs_pb.VolumeStatusRequest(volume_id=vid)
                )
                if st.last_modified_ns > cutoff_ns:
                    skipped_fresh += 1
                    print(
                        f"volume {vid} on {n.id}: modified within "
                        f"{args.cutoffAgeSeconds}s — not purging",
                        file=out,
                    )
                    continue
            resp = env.volume(n.grpc).VolumeNeedleIds(
                vs_pb.VolumeNeedleIdsRequest(volume_id=vid)
            )
            refs = referenced.get(vid, set())
            checked += len(resp.keys)
            for key, size, offset in zip(resp.keys, resp.sizes, resp.offsets):
                if key in refs:
                    continue
                orphans += 1
                orphan_bytes += size
                print(f"orphan needle {vid},{key:x} ({size}B) on {n.id}",
                      file=out)
                if args.reallyDeleteFromVolume:
                    # recover the cookie from the needle header to form a
                    # deletable fid (cookie 4B big-endian leads the header)
                    blob = env.volume(n.grpc).ReadNeedleBlob(
                        vs_pb.ReadNeedleBlobRequest(
                            volume_id=vid, needle_id=key,
                            offset=offset, size=16,
                        )
                    ).needle_blob
                    cookie = int.from_bytes(blob[0:4], "big")
                    fid = f"{vid},{key:x}{cookie:08x}"
                    _http_delete(n.url, fid, mc.sign_write(fid))
    verdict = "purged" if args.reallyDeleteFromVolume else "found"
    print(
        f"checked {checked} needles: {verdict} {orphans} orphans "
        f"({orphan_bytes}B)",
        file=out,
    )


def _http_delete(url: str, fid: str, auth: str) -> None:
    from seaweedfs_tpu_torch.util.http_pool import shared_pool

    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    status, _body = shared_pool().request(
        url, "DELETE", f"/{fid}", headers=headers, timeout=15
    )
    if status >= 300:
        raise IOError(f"delete {fid}: HTTP {status}")


def _fsck_flags(p):
    p.add_argument(
        "-reallyDeleteFromVolume", action="store_true",
        help="delete the orphaned needles from the volumes",
    )
    p.add_argument(
        "-cutoffAgeSeconds", type=int, default=300,
        help="never purge from volumes written to this recently",
    )


cmd_volume_fsck.configure = _fsck_flags


def _nodes_with_disks(env):
    """Like _collect_nodes but keeps the per-disk-type split the tier
    mover plans with: (node, {disk_type: (volumes, free_slots)})."""
    topo = env.collect_topology().topology_info
    out = []
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                disks: dict[str, tuple[dict, int]] = {}
                for dt, disk in dn.disk_infos.items():
                    vols = {v.id: v for v in disk.volume_infos}
                    disks[dt or "hdd"] = (vols, disk.free_volume_count)
                out.append(
                    (
                        _Node(
                            id=dn.id, url=dn.url,
                            grpc=grpc_addr(dn.url, dn.grpc_port),
                            dc=dc.id, rack=rack.id, free_slots=0, volumes={},
                        ),
                        disks,
                    )
                )
    return out


@shell_command(
    "volume.tier.move",
    "move volumes from one disk type to another (hdd <-> ssd)",
)
def cmd_volume_tier_move(env, args, out):
    """For each volume of -collection sitting on -fromDiskType, pull it
    to a server with free -toDiskType capacity (landing disk pinned via
    VolumeCopy disk_type), then drop the source — the reference's
    command_volume_tier_move.go doVolumeTierMove."""
    env.confirm_is_locked()
    src_type = args.fromDiskType or "hdd"
    dst_type = args.toDiskType
    if not dst_type:
        raise RuntimeError("-toDiskType is required")
    if src_type == dst_type:
        raise RuntimeError("from and to disk types are identical")
    nodes = _nodes_with_disks(env)
    dest_view = nodes  # refreshed only after a successful move
    moved = 0
    for node, disks in nodes:
        vols, _free = disks.get(src_type, ({}, 0))
        for vid, v in sorted(vols.items()):
            if args.collection != v.collection:
                continue
            if args.volumeId and vid != args.volumeId:
                continue
            # busiest-capacity destination with the target disk type that
            # does not already hold vid
            candidates = []
            for dnode, ddisks in dest_view:
                _dvols, dfree = ddisks.get(dst_type, ({}, 0))
                already = any(vid in dd[0] for dd in ddisks.values())
                if dfree > 0 and not already:
                    candidates.append((dfree, dnode))
            if not candidates:
                print(
                    f"volume {vid}: no {dst_type} capacity available",
                    file=out,
                )
                continue
            dst = max(candidates, key=lambda c: (c[0], c[1].id))[1]
            _live_move(
                env, vid, v.collection, v.read_only, node, dst,
                disk_type=dst_type,
            )
            print(
                f"moved volume {vid} {node.id}({src_type}) -> "
                f"{dst.id}({dst_type})",
                file=out,
            )
            moved += 1
            # capacity shifted: refresh the destination view (only now —
            # one topology RPC per MOVE, not per candidate)
            dest_view = _nodes_with_disks(env)
    print(f"volume.tier.move moved {moved} volumes", file=out)


def _tier_move_flags(p):
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, default=0, help="one volume only")
    p.add_argument("-fromDiskType", default="hdd")
    p.add_argument("-toDiskType", default="")


cmd_volume_tier_move.configure = _tier_move_flags
