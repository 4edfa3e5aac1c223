"""ShardBits: compact uint32 bitset of shard ids held by a node (the port's
copy of seaweedfs_tpu/storage/erasure_coding/shard_bits.py).

Same wire semantics as the reference's master-side shard bookkeeping
(EcVolumeInfo.ShardBits, weed/storage/erasure_coding/ec_volume_info.go:
119-217): bit i set means shard i present; popcount indexing for the
per-shard size arrays in heartbeats.
"""

from __future__ import annotations


class ShardBits(int):
    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self >> shard_id & 1)

    def count(self) -> int:
        return int(self).bit_count()

    def ids(self) -> list[int]:
        return [i for i in range(32) if self.has(i)]

    def index_of(self, shard_id: int) -> int:
        """Rank of shard_id among set bits (for dense size arrays); -1 if
        absent."""
        if not self.has(shard_id):
            return -1
        return (int(self) & ((1 << shard_id) - 1)).bit_count()

    def plus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self & ~int(other))

    # -- storage-class-aware group views (LRC) -----------------------------

    def group_counts(self, scheme) -> dict[int, int]:
        """Per-local-group counts of held shards for an LRC scheme
        (group -> how many of its members this bitset holds); {} for RS.
        Placement/balance uses this to keep a group's members apart —
        co-locating a whole group turns its local repair into a loss."""
        groups = getattr(scheme, "local_groups", 0)
        if not groups:
            return {}
        return {
            g: (int(self) & scheme.group_shard_bits(g)).bit_count()
            for g in range(groups)
        }

    def missing_group_members(self, scheme, group: int) -> list[int]:
        """The LRC group's members NOT in this bitset — exactly what a
        local repair of that group must fetch from elsewhere."""
        return [s for s in scheme.group_members(group) if not self.has(s)]
