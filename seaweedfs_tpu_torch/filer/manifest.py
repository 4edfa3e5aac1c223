"""Manifest-compressed chunk lists for huge files: the port's copy of
seaweedfs_tpu/filer/manifest.py.

Counterpart of the reference's weed/filer/filechunk_manifest.go: when a
file accumulates more than ``MANIFEST_BATCH`` chunks, batches of chunk
records are serialized into a ``FileChunkManifest`` protobuf blob which is
itself stored as a chunk (flagged ``is_chunk_manifest``).  The entry then
holds a handful of manifest chunks instead of tens of thousands of data
chunks.  Resolution is recursive, so manifests of manifests work and
entry size stays O(log n) in the chunk count.

Unlike the reference (gzip via util.GzipData inside the saved blob), the
blob here is raw protobuf: entries are already compact, and keeping the
payload bit-transparent lets the integrity check (CRC32C at the needle
layer) cover the actual manifest bytes.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Iterable

from seaweedfs_tpu_torch.filer.entry import FileChunk
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

# Chunks per manifest blob (reference filechunk_manifest.go:23 ManifestBatch).
MANIFEST_BATCH = 1000

# save_fn(data) -> fid; provided by the caller (filer upload path).
SaveFn = Callable[[bytes], str]
# fetch_fn(fid) -> bytes; provided by the caller (chunk reader).
FetchFn = Callable[[str], bytes]


def has_chunk_manifest(chunks: Iterable[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(
    chunks: list[FileChunk],
) -> tuple[list[FileChunk], list[FileChunk]]:
    manifest = [c for c in chunks if c.is_chunk_manifest]
    data = [c for c in chunks if not c.is_chunk_manifest]
    return manifest, data


def merge_into_manifest(save_fn: SaveFn, data_chunks: list[FileChunk]) -> FileChunk:
    """Serialize ``data_chunks`` into one stored manifest chunk
    (reference mergeIntoManifest, filechunk_manifest.go:250)."""
    min_offset = min(c.offset for c in data_chunks)
    max_stop = max(c.offset + c.size for c in data_chunks)
    blob = f_pb.FileChunkManifest(
        chunks=[c.to_pb() for c in data_chunks]
    ).SerializeToString()
    fid = save_fn(blob)
    return FileChunk(
        fid=fid,
        offset=min_offset,
        size=max_stop - min_offset,
        modified_ts_ns=time.time_ns(),
        e_tag=hashlib.md5(blob).hexdigest(),
        is_chunk_manifest=True,
    )


def maybe_manifestize(
    save_fn: SaveFn,
    chunks: list[FileChunk],
    merge_factor: int = MANIFEST_BATCH,
) -> list[FileChunk]:
    """Fold data chunks into manifest chunks in batches of ``merge_factor``
    (reference MaybeManifestize/doMaybeManifestize, filechunk_manifest.go:213).

    Existing manifest chunks pass through untouched; a trailing partial
    batch stays as plain data chunks so small appends don't churn."""
    unmergeable, data = separate_manifest_chunks(chunks)
    remaining = data
    while len(remaining) > merge_factor:
        batch, remaining = remaining[:merge_factor], remaining[merge_factor:]
        unmergeable.append(merge_into_manifest(save_fn, batch))
    return unmergeable + remaining


def resolve_chunk_manifest(
    fetch_fn: FetchFn, chunks: list[FileChunk]
) -> tuple[list[FileChunk], list[FileChunk]]:
    """Expand manifest chunks recursively.

    Returns (data_chunks, manifest_chunks) — the latter so delete paths
    can reclaim the manifest blobs themselves (reference
    ResolveChunkManifest, filechunk_manifest.go:52)."""
    data: list[FileChunk] = []
    manifests: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            data.append(c)
            continue
        blob = fetch_fn(c.fid)
        m = f_pb.FileChunkManifest.FromString(blob)
        manifests.append(c)
        sub_data, sub_manifests = resolve_chunk_manifest(
            fetch_fn, [FileChunk.from_pb(p) for p in m.chunks]
        )
        data.extend(sub_data)
        manifests.extend(sub_manifests)
    return data, manifests
