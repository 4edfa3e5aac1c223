"""Interval geometry: logical .dat offsets -> (shard, shard offset) ranges
(the port's copy of seaweedfs_tpu/storage/erasure_coding/ec_locate.py).

Replicates the reference's striped layout math exactly (behavior of
weed/storage/erasure_coding/ec_locate.go, pinned by the golden vectors in
its ec_test.go TestLocateData2/3): a .dat is laid out as rows of k
consecutive blocks — nLargeRows rows of 1GB blocks, then 1MB-block rows —
with block i of a row living in shard i.  A needle byte-range therefore maps
to a list of intervals, each wholly inside one block of one shard.

The row count is derived from the *shard* size: n_large_rows =
(shard_size - 1) // large_block, where shard_size is dat_size / k when the
true dat size is known (.vif), else the .ec00 file size minus one.
"""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme


@dataclass(frozen=True)
class Interval:
    block_index: int  # index among large blocks, or among small blocks
    inner_offset: int
    size: int
    is_large_block: bool
    large_block_rows: int

    def to_shard_and_offset(self, scheme: EcScheme) -> tuple[int, int]:
        """-> (shard_id, offset within the .ecNN file)."""
        row = self.block_index // scheme.data_shards
        off = self.inner_offset
        if self.is_large_block:
            off += row * scheme.large_block_size
        else:
            off += (
                self.large_block_rows * scheme.large_block_size
                + row * scheme.small_block_size
            )
        return self.block_index % scheme.data_shards, off


def locate_data(
    scheme: EcScheme, shard_size: int, offset: int, size: int
) -> list[Interval]:
    """Map the .dat byte range [offset, offset+size) to shard intervals."""
    large, small = scheme.large_block_size, scheme.small_block_size
    k = scheme.data_shards
    large_row_bytes = large * k
    n_large_rows = (shard_size - 1) // large

    if offset < n_large_rows * large_row_bytes:
        is_large = True
        block_index, inner = divmod(offset, large)
    else:
        is_large = False
        block_index, inner = divmod(offset - n_large_rows * large_row_bytes, small)

    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (large if is_large else small) - inner
        take = min(size, block_remaining)
        intervals.append(
            Interval(
                block_index=block_index,
                inner_offset=inner,
                size=take,
                is_large_block=is_large,
                large_block_rows=int(n_large_rows),
            )
        )
        size -= take
        if size <= 0:
            break
        block_index += 1
        if is_large and block_index == n_large_rows * k:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
