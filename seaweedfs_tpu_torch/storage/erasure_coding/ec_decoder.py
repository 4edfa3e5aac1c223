"""EC decode: reassemble a normal volume from its data shards.

The port of seaweedfs_tpu/storage/erasure_coding/ec_decoder.py, itself the
counterpart of the reference's weed/storage/erasure_coding/ec_decoder.go:
``write_dat_file`` (de-stripe .ec00-.ec{k-1} back into .dat),
``write_idx_file_from_ec_index`` (.ecx + .ecj -> .idx) and
``find_dat_file_size`` (the original .dat length from the largest live
entry's end).  Host only, as in the JAX package: both codes are
systematic, so the data shards hold the .dat verbatim and no matrix apply
runs.  Both outputs are staged (.tmp), fsynced and renamed into place.
"""

from __future__ import annotations

import contextlib
import os

from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.needle_map import walk_index_file
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from seaweedfs_tpu_torch.storage.types import (
    NEEDLE_ID_SIZE,
    TOMBSTONE_FILE_SIZE,
    Version,
    get_actual_size,
    pack_index_entry,
    size_is_deleted,
)


def write_dat_file(
    base_file_name: str,
    dat_file_size: int,
    shard_file_names: list[str] | None = None,
    scheme: EcScheme = DEFAULT_SCHEME,
) -> None:
    """De-stripe data shards into base_file_name + '.dat' (truncated to the
    original size: the last row's zero padding is dropped)."""
    k = scheme.data_shards
    names = shard_file_names or [
        base_file_name + scheme.shard_ext(i) for i in range(k)
    ]
    if len(names) < k:
        raise ValueError(f"need {k} data shard files")
    # ExitStack: a failed open mid-list must close the ones already open
    with contextlib.ExitStack() as stack:
        ins = [stack.enter_context(open(p, "rb")) for p in names[:k]]
        remaining = dat_file_size
        # staged + renamed: a crash mid-decode must not leave a half-written
        # .dat where a volume mount would find it
        tmp = base_file_name + ".dat.tmp"
        with open(tmp, "wb") as out:
            positions = [0] * k
            # Large rows use the encoder's strict `>`, so an exact multiple
            # of k*large_block decodes as small rows, the layout the encoder
            # produced.  (The reference decoder uses `>=` here, which
            # reassembles that boundary wrongly; the shards are the same.)
            while remaining > k * scheme.large_block_size:
                for i in range(k):
                    _copy(ins[i], out, positions[i], scheme.large_block_size)
                    positions[i] += scheme.large_block_size
                remaining -= k * scheme.large_block_size
            # small rows (the last one truncated to the true size)
            while remaining > 0:
                for i in range(k):
                    take = min(remaining, scheme.small_block_size)
                    if take <= 0:
                        break
                    _copy(ins[i], out, positions[i], take)
                    positions[i] += take
                    remaining -= take
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, base_file_name + ".dat")


def _copy(src, dst, src_offset: int, length: int) -> None:
    data = os.pread(src.fileno(), length, src_offset)
    if len(data) != length:
        raise IOError(
            f"short read from {src.name} at {src_offset}: {len(data)} != {length}"
        )
    dst.write(data)


def write_idx_file_from_ec_index(
    base_file_name: str, offset_width: int = 4
) -> None:
    """.ecx (+ .ecj tombstones) -> .idx replay log (staged and renamed, so
    a crash never leaves a half-replayed index beside a complete .dat)."""
    tmp = base_file_name + ".idx.tmp"
    with open(base_file_name + ".ecx", "rb") as ecx, open(tmp, "wb") as idx:
        while chunk := ecx.read(1 << 20):
            idx.write(chunk)
        ecj_path = base_file_name + ".ecj"
        if os.path.exists(ecj_path):
            with open(ecj_path, "rb") as ecj:
                while len(b := ecj.read(NEEDLE_ID_SIZE)) == NEEDLE_ID_SIZE:
                    key = int.from_bytes(b, "big")
                    idx.write(
                        pack_index_entry(key, 0, TOMBSTONE_FILE_SIZE, offset_width)
                    )
        idx.flush()
        os.fsync(idx.fileno())
    os.replace(tmp, base_file_name + ".idx")


def find_dat_file_size(base_file_name: str, scheme: EcScheme = DEFAULT_SCHEME) -> int:
    """Original .dat size = max end offset over live .ecx entries."""
    sb = read_ec_super_block(base_file_name, scheme)
    dat_size = 0

    def visit(key: int, offset: int, size: int) -> None:
        nonlocal dat_size
        if size_is_deleted(size):
            return
        dat_size = max(dat_size, offset + get_actual_size(size, sb.version))

    with open(base_file_name + ".ecx", "rb") as f:
        # strict: a generated .ecx is a sealed artifact; a torn tail is
        # damage, and dropping entries would shrink the recovered .dat
        walk_index_file(f, visit, offset_width=sb.offset_width, strict=True)
    return dat_size


def read_ec_super_block(
    base_file_name: str, scheme: EcScheme = DEFAULT_SCHEME
) -> SuperBlock:
    """Super block from the head of shard 0 (the super block is the first
    8 bytes of the .dat, hence of .ec00): version and offset width."""
    with open(base_file_name + scheme.shard_ext(0), "rb") as f:
        return SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))


def read_ec_volume_version(
    base_file_name: str, scheme: EcScheme = DEFAULT_SCHEME
) -> Version:
    """Needle version from the super block at the head of shard 0."""
    return read_ec_super_block(base_file_name, scheme).version
