""".vif volume-info sidecar file.

JSON encoding of the reference's VolumeInfo message (protojson of
weed/pb/volume_server.proto:520-528, written by weed/storage/volume_info/
volume_info.go): camelCase keys {version, replication, datFileSize,
expireAtSec, readOnly, bytesOffset}.  Records the original .dat size for EC
volumes so the interval geometry can recover LargeBlockRowsCount exactly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class VolumeInfo:
    version: int = 3
    replication: str = ""
    dat_file_size: int = 0
    expire_at_sec: int = 0
    read_only: bool = False
    bytes_offset: int = 8  # needle padding granularity
    # index offset width of the source volume (4 = reference-compatible,
    # 5 = 8TB volumes; .ecx entries are 17 bytes) — our per-volume
    # extension of the reference's 5BytesOffset build flavor
    offset_width: int = 4
    # RS(k, m) geometry — our extension (the reference hard-codes 10+4;
    # SURVEY.md §2.4 note asks for first-class configurable geometry).
    # 0 means "default": readers fall back to the 10+4 scheme.
    data_shards: int = 0
    parity_shards: int = 0
    # storage class: > 0 selects LRC(k, l, r) with l = local_groups and
    # r = parity_shards - local_groups; 0 = plain RS.  Recorded at
    # generate time so mounts/rebuilds recover the repair algebra.
    local_groups: int = 0
    # backend tiering (reference VolumeInfo.files RemoteFile list): where
    # the sealed .dat lives when it's been moved off local disk
    remote: dict = field(default_factory=dict)  # {"backend","key","root","fileSize"}

    def to_json(self) -> str:
        obj: dict = {"version": self.version}
        if self.replication:
            obj["replication"] = self.replication
        if self.bytes_offset:
            obj["bytesOffset"] = self.bytes_offset
        if self.dat_file_size:
            obj["datFileSize"] = str(self.dat_file_size)  # protojson int64 = string
        if self.expire_at_sec:
            obj["expireAtSec"] = str(self.expire_at_sec)
        if self.read_only:
            obj["readOnly"] = True
        if self.offset_width != 4:
            obj["offsetWidth"] = self.offset_width
        if self.data_shards:
            obj["dataShards"] = self.data_shards
        if self.parity_shards:
            obj["parityShards"] = self.parity_shards
        if self.local_groups:
            obj["localGroups"] = self.local_groups
        if self.remote:
            obj["remote"] = self.remote
        return json.dumps(obj, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "VolumeInfo":
        obj = json.loads(text)
        return cls(
            version=int(obj.get("version", 3)),
            replication=obj.get("replication", ""),
            dat_file_size=int(obj.get("datFileSize", 0)),
            expire_at_sec=int(obj.get("expireAtSec", 0)),
            read_only=bool(obj.get("readOnly", False)),
            bytes_offset=int(obj.get("bytesOffset", 8)),
            offset_width=int(obj.get("offsetWidth", 4)),
            data_shards=int(obj.get("dataShards", 0)),
            parity_shards=int(obj.get("parityShards", 0)),
            local_groups=int(obj.get("localGroups", 0)),
            remote=obj.get("remote") or {},
        )


def save_volume_info(path: str | os.PathLike, info: VolumeInfo) -> None:
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "w") as f:
        f.write(info.to_json())
    os.replace(tmp, path)


def maybe_load_volume_info(path: str | os.PathLike) -> VolumeInfo | None:
    try:
        with open(path) as f:
            return VolumeInfo.from_json(f.read())
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        return None
