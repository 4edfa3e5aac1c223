"""volume.check.disk — detect and repair replica divergence.

The port's copy of seaweedfs_tpu/shell/command_volume_check.py, the
counterpart of the reference's shell/command_volume_check_disk.go: for
every volume with multiple replicas, pull each replica's .idx over the
CopyFile stream, diff the live needle sets, and append the missing
needles to the lagging replicas (blob fetched via ReadNeedleBlob, written
back through the HTTP write path with ?type=replicate so no re-fan-out).
``-syncDeletions`` additionally propagates tombstones: a needle deleted
on any replica is deleted everywhere (deletion wins — the conservative
direction the reference takes when timestamps are unavailable).
"""

from __future__ import annotations

import io

from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr
from seaweedfs_tpu_torch.storage.needle import Needle, FLAG_IS_COMPRESSED
from seaweedfs_tpu_torch.storage.needle_map import walk_index_file
from seaweedfs_tpu_torch.storage.types import (
    CURRENT_VERSION,
    get_actual_size,
    size_is_deleted,
)


def _fetch_offset_width(
    env: CommandEnv, grpc: str, vid: int, collection: str
) -> int:
    """Index offset width from the replica's superblock (first 8 bytes of
    .dat over the CopyFile stream) — width-5 volumes store 17-byte .idx
    entries that a width-4 replay would misparse."""
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    head = b""
    for resp in env.volume(grpc).CopyFile(
        vs_pb.CopyFileRequest(
            volume_id=vid, collection=collection, ext=".dat", stop_offset=8
        )
    ):
        head += resp.file_content
        if len(head) >= 8:
            break
    try:
        return SuperBlock.from_bytes(head).offset_width
    except ValueError:
        return 4


def _fetch_idx_state(
    env: CommandEnv, grpc: str, vid: int, collection: str
) -> tuple[dict[int, tuple[int, int]], set[int]]:
    """Replay a replica's .idx → ({key: (offset, size)} live, {key} deleted)."""
    width = _fetch_offset_width(env, grpc, vid, collection)
    buf = io.BytesIO()
    for resp in env.volume(grpc).CopyFile(
        vs_pb.CopyFileRequest(volume_id=vid, collection=collection, ext=".idx")
    ):
        buf.write(resp.file_content)
    live: dict[int, tuple[int, int]] = {}
    deleted: set[int] = set()

    def visit(key: int, offset: int, size: int) -> None:
        if offset > 0 and not size_is_deleted(size):
            live[key] = (offset, size)
            deleted.discard(key)
        else:
            live.pop(key, None)
            deleted.add(key)

    buf.seek(0)
    # non-strict: this .idx was fetched from a LIVE replica and may tear
    # legitimately mid-append; the in-flight needle shows up as "missing"
    # and converges on the next pass
    walk_index_file(buf, visit, offset_width=width)
    return live, deleted


def _fetch_needle(env: CommandEnv, grpc: str, vid: int, key: int, offset: int, size: int) -> Needle:
    resp = env.volume(grpc).ReadNeedleBlob(
        vs_pb.ReadNeedleBlobRequest(
            volume_id=vid,
            needle_id=key,
            offset=offset,
            size=get_actual_size(size, CURRENT_VERSION),
        )
    )
    return Needle.from_bytes(bytes(resp.needle_blob), CURRENT_VERSION)


def _http(
    url: str, method: str, path: str, body: bytes = b"", auth: str = ""
) -> int:
    from seaweedfs_tpu_torch.util.http_pool import shared_pool

    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    status, _body = shared_pool().request(
        url, method, path, body=body or None, headers=headers, timeout=30
    )
    return status


def check_volume(
    env: CommandEnv,
    vid: int,
    collection: str,
    holders: list,  # [(http_url, grpc_addr)]
    *,
    apply: bool = True,
    sync_deletions: bool = False,
    sign_write=None,  # fid -> JWT (or ""); required when the cluster signs
) -> tuple[int, int]:
    """Returns (copied, deleted) repair counts across all replicas."""
    sign = sign_write or (lambda fid: "")
    states = {
        grpc: _fetch_idx_state(env, grpc, vid, collection)
        for _url, grpc in holders
    }
    all_deleted: set[int] = set()
    if sync_deletions:
        for _live, dead in states.values():
            all_deleted |= dead
    # union of live needles, each pinned to the replica it was SEEN on —
    # repairs never read from a replica's mutated local view, so a
    # 3+-replica repair can't chase a just-written copy at a bogus offset
    union: dict[int, tuple[str, int, int]] = {}
    for _url, grpc in holders:
        for key, (offset, size) in states[grpc][0].items():
            union.setdefault(key, (grpc, offset, size))
    copied = removed = 0
    for url, grpc in holders:
        live, _dead = states[grpc]
        for key, (src_grpc, offset, size) in sorted(union.items()):
            if key in live or key in all_deleted or src_grpc == grpc:
                continue
            if apply:
                n = _fetch_needle(env, src_grpc, vid, key, offset, size)
                fid = f"{vid},{key:x}{n.cookie:08x}"
                extra = "&compressed=true" if n.has(FLAG_IS_COMPRESSED) else ""
                status = _http(
                    url, "POST",
                    f"/{fid}?type=replicate{extra}",
                    bytes(n.data),
                    auth=sign(fid),
                )
                if status >= 300:
                    continue  # leave for the next pass
            copied += 1
        if sync_deletions:
            for key in sorted(all_deleted & set(live)):
                if apply:
                    fid = f"{vid},{key:x}{0:08x}"
                    status = _http(
                        url, "DELETE", f"/{fid}?type=replicate", auth=sign(fid)
                    )
                    if status >= 300 and status != 404:
                        continue  # unauthorized/unreachable: not synced
                removed += 1
    return copied, removed


@shell_command("volume.check.disk", "find and repair replica divergence")
def cmd_volume_check_disk(env, args, out):
    env.confirm_is_locked()
    topo = env.collect_topology().topology_info
    # vid -> [(http_url, grpc)] holders of plain volumes
    holders: dict[int, list] = {}
    colls: dict[int, str] = {}
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for disk in dn.disk_infos.values():
                    for v in disk.volume_infos:
                        holders.setdefault(v.id, []).append(
                            (dn.url, grpc_addr(dn.url, dn.grpc_port))
                        )
                        colls[v.id] = v.collection
    from seaweedfs_tpu_torch.wdclient import MasterClient

    signer = MasterClient(env.master_address).sign_write
    total_copied = total_deleted = 0
    for vid, hs in sorted(holders.items()):
        if len(hs) < 2:
            continue
        if args.volumeId and vid != args.volumeId:
            continue
        copied, removed = check_volume(
            env, vid, colls.get(vid, ""), hs,
            apply=not args.noApply,
            sync_deletions=args.syncDeletions,
            sign_write=signer,
        )
        if copied or removed:
            print(
                f"volume {vid}: +{copied} needles copied, "
                f"-{removed} deletions synced", file=out,
            )
        total_copied += copied
        total_deleted += removed
    print(
        f"volume.check.disk: {total_copied} copied, {total_deleted} deleted"
        + (" (plan only)" if args.noApply else ""),
        file=out,
    )


def _check_flags(p):
    p.add_argument("-volumeId", type=int, default=0, help="limit to one volume")
    p.add_argument("-noApply", action="store_true")
    p.add_argument(
        "-syncDeletions", action="store_true",
        help="propagate tombstones everywhere (deletion wins)",
    )


cmd_volume_check_disk.configure = _check_flags
