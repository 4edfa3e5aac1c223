"""EC volume helpers: the part of seaweedfs_tpu/storage/erasure_coding/
ec_volume.py that ``ec.decode.local`` needs.  The ``EcVolume`` class (needle
reads from mounted shards) is not ported yet."""

from __future__ import annotations

from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, maybe_load_volume_info


def ec_offset_width(base_file_name: str, info: VolumeInfo | None = None) -> int:
    """Index offset width of an EC volume: the .vif records it at generate
    time; an older .vif falls back to the source superblock at the head of
    a locally-present first shard (the superblock is the first 8 bytes of
    the .dat, hence of .ec00); 4 otherwise."""
    if info is None:
        info = maybe_load_volume_info(base_file_name + ".vif")
    if info is not None and info.offset_width:
        return info.offset_width
    try:
        with open(base_file_name + ".ec00", "rb") as f:
            return SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE)).offset_width
    except (OSError, ValueError):
        return 4
