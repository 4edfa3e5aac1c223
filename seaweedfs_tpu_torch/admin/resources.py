"""Admin resource management: volumes, EC shards, collections, S3 buckets;
the port's copy of seaweedfs_tpu/admin/resources.py.

The pages the reference admin dashboard manages cluster resources with
(weed/admin/dash/volume_management.go:14,311, ec_shard_management.go:28,
collection_management.go, bucket_management.go:41,68), re-done as JSON
APIs + actions over the same master/volume/filer gRPC contracts the
shell uses.  All mutations run synchronously against the cluster; the
admin server wires these behind its session auth.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell.command_s3 import BUCKETS_ROOT
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits


@dataclass
class _Node:
    id: str
    url: str
    grpc: str
    dc: str
    rack: str
    volumes: list = field(default_factory=list)  # (disk_type, VolumeStat)
    ec_shards: list = field(default_factory=list)  # (disk_type, EcShardStat)


class ResourceManager:
    """Cluster-resource read/mutate layer for the admin server.

    ``scanner`` provides the cached master + volume stubs; ``filer``
    is a zero-arg callable returning the admin's RemoteFiler (raises
    AdminServer.NoFiler when unconfigured — bucket pages surface that
    as a 503 like the file browser does)."""

    def __init__(self, scanner, filer):
        self.scanner = scanner
        self._filer = filer

    # -- topology walk ----------------------------------------------------

    def _nodes(self) -> list[_Node]:
        resp = self.scanner.master.VolumeList(m_pb.VolumeListRequest())
        nodes = []
        for dc in resp.topology_info.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    n = _Node(
                        id=dn.id,
                        url=dn.url,
                        grpc=grpc_addr(dn.url, dn.grpc_port),
                        dc=dc.id,
                        rack=rack.id,
                    )
                    for dtype, disk in dn.disk_infos.items():
                        for v in disk.volume_infos:
                            n.volumes.append((dtype, v))
                        for e in disk.ec_shard_infos:
                            n.ec_shards.append((dtype, e))
                    nodes.append(n)
        return nodes

    def _holders(self, vid: int) -> list[tuple[_Node, object]]:
        out = []
        for n in self._nodes():
            for _dtype, v in n.volumes:
                if v.id == vid:
                    out.append((n, v))
        return out

    # -- volumes (volume_management.go:14,311) ----------------------------

    _VOLUME_SORT = {
        "id": lambda r: r["id"],
        "server": lambda r: r["server"],
        "collection": lambda r: r["collection"],
        "size": lambda r: r["size"],
        "file_count": lambda r: r["file_count"],
        "garbage": lambda r: r["garbage_ratio"],
    }

    def list_volumes(
        self,
        sort: str = "id",
        order: str = "asc",
        page: int = 1,
        page_size: int = 100,
        collection: str | None = None,
    ) -> dict:
        """One row per (volume, holder), sorted + paged server-side so a
        10k-volume cluster costs one page of JSON per request."""
        if sort not in self._VOLUME_SORT:
            raise ValueError(
                f"sort must be one of {sorted(self._VOLUME_SORT)}"
            )
        rows = []
        for n in self._nodes():
            for dtype, v in n.volumes:
                if collection is not None and v.collection != collection:
                    continue
                rows.append(
                    {
                        "id": v.id,
                        "server": n.id,
                        "collection": v.collection,
                        "size": v.size,
                        "file_count": v.file_count,
                        "delete_count": v.delete_count,
                        "deleted_bytes": v.deleted_bytes,
                        "garbage_ratio": (
                            round(v.deleted_bytes / v.size, 4) if v.size else 0.0
                        ),
                        "read_only": v.read_only,
                        "replication": v.replica_placement,
                        "disk_type": dtype,
                        "version": v.version,
                    }
                )
        rows.sort(key=self._VOLUME_SORT[sort], reverse=order == "desc")
        total = len(rows)
        page = max(1, page)
        page_size = max(1, min(page_size, 1000))
        start = (page - 1) * page_size
        return {
            "volumes": rows[start : start + page_size],
            "total": total,
            "page": page,
            "page_size": page_size,
            "sort": sort,
            "order": order,
        }

    def volume_detail(self, vid: int) -> dict:
        """All holders of one volume, each with a live VolumeStatus probe
        (the topology row can lag a heartbeat)."""
        holders = []
        for n, v in self._holders(vid):
            row = {
                "server": n.id,
                "dc": n.dc,
                "rack": n.rack,
                "size": v.size,
                "file_count": v.file_count,
                "deleted_bytes": v.deleted_bytes,
                "read_only": v.read_only,
                "collection": v.collection,
                "replication": v.replica_placement,
            }
            try:
                st = self.scanner.volume(n.grpc).VolumeStatus(
                    vs_pb.VolumeStatusRequest(volume_id=vid), timeout=5.0
                )
                row["live_size"] = st.volume_size
                row["live_file_count"] = st.file_count
                row["live_read_only"] = st.read_only
            except Exception as e:  # noqa: BLE001 — holder down: say so
                row["live_error"] = str(e)
            holders.append(row)
        if not holders:
            raise FileNotFoundError(f"volume {vid} not in the topology")
        return {"id": vid, "replicas": holders}

    # -- volume actions ---------------------------------------------------

    def vacuum_volume(self, vid: int) -> dict:
        """Force-vacuum every holder (threshold 0 = unconditional — the
        operator clicked the button; the scanner applies thresholds)."""
        holders = self._holders(vid)
        if not holders:
            raise FileNotFoundError(f"volume {vid} not in the topology")
        reclaimed = {}
        for n, _v in holders:
            resp = self.scanner.volume(n.grpc).VolumeVacuum(
                vs_pb.VolumeVacuumRequest(volume_id=vid, garbage_threshold=0.0)
            )
            reclaimed[n.id] = resp.reclaimed_bytes
        return {"reclaimed_bytes": reclaimed}

    def _node_by_name(self, which: str, nodes: list[_Node] | None = None) -> _Node:
        for n in nodes if nodes is not None else self._nodes():
            if which in (n.id, n.url, n.grpc):
                return n
        raise FileNotFoundError(f"no volume server {which!r} in the topology")

    def unmount_volume(self, vid: int, server: str) -> None:
        n = self._node_by_name(server)
        self.scanner.volume(n.grpc).VolumeUnmount(
            vs_pb.VolumeMountRequest(volume_id=vid)
        )

    def mount_volume(self, vid: int, server: str, collection: str = "") -> None:
        n = self._node_by_name(server)
        self.scanner.volume(n.grpc).VolumeMount(
            vs_pb.VolumeMountRequest(volume_id=vid, collection=collection)
        )

    def move_volume(self, vid: int, source: str, target: str) -> None:
        """Freeze -> copy to target -> drop from source (the shell's
        volume.move / reference LiveMoveVolume semantics)."""
        nodes = self._nodes()  # one topology snapshot for both lookups
        src = self._node_by_name(source, nodes)
        dst = self._node_by_name(target, nodes)
        v = next((v for _d, v in src.volumes if v.id == vid), None)
        if v is None:
            raise FileNotFoundError(f"volume {vid} not on {source}")
        src_stub = self.scanner.volume(src.grpc)
        dst_stub = self.scanner.volume(dst.grpc)
        if not v.read_only:
            src_stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=vid))
        try:
            dst_stub.VolumeCopy(
                vs_pb.VolumeCopyRequest(
                    volume_id=vid,
                    collection=v.collection,
                    source_data_node=src.grpc,
                )
            )
        except Exception:
            if not v.read_only:
                src_stub.VolumeMarkWritable(
                    vs_pb.VolumeMarkRequest(volume_id=vid)
                )
            raise
        src_stub.VolumeDelete(vs_pb.VolumeDeleteRequest(volume_id=vid))
        mark = (
            dst_stub.VolumeMarkReadonly
            if v.read_only
            else dst_stub.VolumeMarkWritable
        )
        mark(vs_pb.VolumeMarkRequest(volume_id=vid))

    # -- EC shards (ec_shard_management.go:28) ----------------------------

    def list_ec_volumes(self) -> dict:
        """Per EC volume: which server holds which shards, totals and
        missing shard ids; plus the per-server aggregate view."""
        vols: dict[int, dict] = {}
        per_server: dict[str, int] = {}
        for n in self._nodes():
            for dtype, e in n.ec_shards:
                ids = ShardBits(e.shard_bits).ids()
                per_server[n.id] = per_server.get(n.id, 0) + len(ids)
                v = vols.setdefault(
                    e.volume_id,
                    {
                        "id": e.volume_id,
                        "collection": e.collection,
                        "data_shards": e.data_shards or 10,
                        "parity_shards": e.parity_shards or 4,
                        "shards": {},
                        "size": 0,
                    },
                )
                for i, sid in enumerate(ids):
                    v["shards"].setdefault(str(sid), []).append(n.id)
                    if i < len(e.shard_sizes):
                        v["size"] += e.shard_sizes[i]
        out = []
        for v in sorted(vols.values(), key=lambda v: v["id"]):
            want = v["data_shards"] + v["parity_shards"]
            have = {int(s) for s in v["shards"]}
            v["missing"] = sorted(set(range(want)) - have)
            out.append(v)
        return {"ec_volumes": out, "per_server": per_server}

    def rebuild_ec_volume(self, vid: int) -> dict:
        """Regenerate missing shards on a holder that has the .ecx (the
        page's mutating action; the full placement dance stays with
        ec.rebuild in the shell / worker fleet).  Holders are tried in
        turn — only the one(s) that kept the .ecx can rebuild, and the
        topology doesn't say which that is."""
        last_err = None
        tried = False
        for n in self._nodes():
            e = next(
                (e for _d, e in n.ec_shards if e.volume_id == vid), None
            )
            if e is None:
                continue
            tried = True
            try:
                resp = self.scanner.volume(n.grpc).EcShardsRebuild(
                    vs_pb.EcShardsRebuildRequest(
                        volume_id=vid, collection=e.collection
                    )
                )
            except Exception as err:  # noqa: BLE001 — try the next holder
                last_err = err
                continue
            return {
                "server": n.id,
                "rebuilt_shard_ids": list(resp.rebuilt_shard_ids),
            }
        if not tried:
            raise FileNotFoundError(f"EC volume {vid} not in the topology")
        raise RuntimeError(f"no holder could rebuild vid {vid}: {last_err}")

    # -- collections (collection_management.go) ---------------------------

    def list_collections(self) -> dict:
        agg: dict[str, dict] = {}

        def row(name: str) -> dict:
            return agg.setdefault(
                name,
                {
                    "name": name,
                    "volumes": 0,
                    "ec_volumes": 0,
                    "size": 0,
                    "file_count": 0,
                },
            )

        ec_seen: set[tuple[str, int]] = set()
        for n in self._nodes():
            for _d, v in n.volumes:
                r = row(v.collection)
                r["volumes"] += 1
                r["size"] += v.size
                r["file_count"] += v.file_count
            for _d, e in n.ec_shards:
                r = row(e.collection)
                r["size"] += sum(e.shard_sizes)
                if (e.collection, e.volume_id) not in ec_seen:
                    ec_seen.add((e.collection, e.volume_id))
                    r["ec_volumes"] += 1
        return {
            "collections": sorted(agg.values(), key=lambda r: r["name"])
        }

    def delete_collection(self, name: str) -> dict:
        """Drop every volume + EC shard of the collection, then tell the
        master to forget it (shell collection.delete flow)."""
        if not name:
            raise ValueError(
                "refusing to delete the default collection by accident: "
                "pass its volumes to volume actions individually"
            )
        deleted = ec_deleted = 0
        for n in self._nodes():
            stub = self.scanner.volume(n.grpc)
            for _d, v in n.volumes:
                if v.collection != name:
                    continue
                stub.VolumeDelete(vs_pb.VolumeDeleteRequest(volume_id=v.id))
                deleted += 1
            for _d, e in n.ec_shards:
                if e.collection != name:
                    continue
                ids = ShardBits(e.shard_bits).ids()
                stub.EcShardsUnmount(
                    vs_pb.EcShardsUnmountRequest(
                        volume_id=e.volume_id, shard_ids=ids
                    )
                )
                stub.EcShardsDelete(
                    vs_pb.EcShardsDeleteRequest(
                        volume_id=e.volume_id, collection=name, shard_ids=ids
                    )
                )
                ec_deleted += len(ids)
        self.scanner.master.CollectionDelete(
            m_pb.CollectionDeleteRequest(name=name)
        )
        return {"deleted_volumes": deleted, "deleted_ec_shards": ec_deleted}

    # -- S3 buckets (bucket_management.go:41,68) --------------------------

    def list_buckets(self) -> dict:
        """Buckets = directories under /buckets; size/file_count come
        from the same-named collection's aggregate (how the reference
        bucket page reports usage) so listing stays O(buckets)."""
        rf = self._filer()
        colls = {
            c["name"]: c for c in self.list_collections()["collections"]
        }
        buckets = []
        for e in rf.list_entries(BUCKETS_ROOT, limit=1000):
            if not e.is_directory:
                continue
            c = colls.get(e.name, {})
            quota = e.extended.get("quota_bytes", b"")
            buckets.append(
                {
                    "name": e.name,
                    "size": c.get("size", 0),
                    "volumes": c.get("volumes", 0),
                    "quota_bytes": int(quota) if quota else 0,
                    "quota_frozen": bool(e.extended.get("quota_readonly")),
                    "created": e.attr.mtime,
                }
            )
        return {"buckets": sorted(buckets, key=lambda b: b["name"])}

    def create_bucket(self, name: str) -> None:
        # S3 naming rules — and, crucially for the filer, no "/" or ".."
        if not re.fullmatch(r"[a-z0-9][a-z0-9.-]{1,61}[a-z0-9]", name):
            raise ValueError(f"invalid bucket name {name!r}")
        rf = self._filer()
        if rf.find_entry(f"{BUCKETS_ROOT}/{name}") is not None:
            raise ValueError(f"bucket {name} already exists")
        rf.mkdirs(BUCKETS_ROOT)
        rf.create_entry(
            Entry(
                full_path=f"{BUCKETS_ROOT}/{name}",
                is_directory=True,
                attr=Attr.now(0o755),
            )
        )

    def delete_bucket(self, name: str) -> None:
        rf = self._filer()
        e = rf.find_entry(f"{BUCKETS_ROOT}/{name}")
        if e is None or not e.is_directory:
            raise FileNotFoundError(f"bucket {name} does not exist")
        rf.delete_entry(f"{BUCKETS_ROOT}/{name}", recursive=True)

    def set_bucket_quota(self, name: str, quota_bytes: int) -> None:
        """quota_bytes <= 0 clears the quota (and any frozen mark)."""
        rf = self._filer()
        e = rf.find_entry(f"{BUCKETS_ROOT}/{name}")
        if e is None or not e.is_directory:
            raise FileNotFoundError(f"bucket {name} does not exist")
        if quota_bytes <= 0:
            e.extended.pop("quota_bytes", None)
            e.extended.pop("quota_readonly", None)
        else:
            e.extended["quota_bytes"] = str(quota_bytes).encode()
        rf.update_entry(e)
