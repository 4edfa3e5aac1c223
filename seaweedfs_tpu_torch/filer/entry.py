"""Filer entry model: the port's copy of seaweedfs_tpu/filer/entry.py
(reference weed/filer/entry.go).

An :class:`Entry` is a file or directory at an absolute path: attributes
plus, for files, either a chunk list (bytes on volume servers) or small
inlined ``content``.  Entries serialize to/from the ``weedtpu.filer``
protobuf messages so stores and the gRPC surface share one codec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb


@dataclass
class FileChunk:
    """One chunk of a file living at ``fid`` on a volume server."""

    fid: str
    offset: int  # logical offset within the file
    size: int
    modified_ts_ns: int
    e_tag: str = ""
    is_chunk_manifest: bool = False  # payload is a FileChunkManifest blob

    def to_pb(self) -> f_pb.FileChunk:
        return f_pb.FileChunk(
            fid=self.fid,
            offset=self.offset,
            size=self.size,
            modified_ts_ns=self.modified_ts_ns,
            e_tag=self.e_tag,
            is_chunk_manifest=self.is_chunk_manifest,
        )

    @staticmethod
    def from_pb(p: f_pb.FileChunk) -> "FileChunk":
        return FileChunk(
            p.fid, p.offset, p.size, p.modified_ts_ns, p.e_tag, p.is_chunk_manifest
        )


@dataclass
class Attr:
    """File attributes (reference entry.go Attr)."""

    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_seconds: int = 0
    collection: str = ""
    replication: str = ""

    @staticmethod
    def now(mode: int = 0o644, **kw) -> "Attr":
        t = time.time()
        return Attr(mtime=t, crtime=t, mode=mode, **kw)


@dataclass
class Entry:
    full_path: str  # absolute, "/" separated, no trailing slash except root
    is_directory: bool = False
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, bytes] = field(default_factory=dict)
    content: bytes = b""  # small files inlined instead of chunked

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1] or "/"

    @property
    def parent(self) -> str:
        if self.full_path == "/":
            return "/"
        return self.full_path.rsplit("/", 1)[0] or "/"

    @property
    def size(self) -> int:
        from seaweedfs_tpu_torch.filer.filechunks import total_size

        if self.content:
            return len(self.content)
        return total_size(self.chunks)

    # ---- protobuf codec (shared by stores and gRPC) ---------------------
    def to_pb(self) -> f_pb.Entry:
        return f_pb.Entry(
            name=self.name,
            is_directory=self.is_directory,
            chunks=[c.to_pb() for c in self.chunks],
            attributes=f_pb.FuseAttributes(
                file_size=self.size,
                mtime=int(self.attr.mtime),
                crtime=int(self.attr.crtime),
                file_mode=self.attr.mode,
                uid=self.attr.uid,
                gid=self.attr.gid,
                mime=self.attr.mime,
                ttl_seconds=self.attr.ttl_seconds,
                collection=self.attr.collection,
                replication=self.attr.replication,
            ),
            extended=self.extended,
            content=self.content,
        )

    @staticmethod
    def from_pb(directory: str, p: f_pb.Entry) -> "Entry":
        a = p.attributes
        path = directory.rstrip("/") + "/" + p.name if p.name != "/" else "/"
        return Entry(
            full_path=path,
            is_directory=p.is_directory,
            attr=Attr(
                mtime=float(a.mtime),
                crtime=float(a.crtime),
                mode=a.file_mode or 0o644,
                uid=a.uid,
                gid=a.gid,
                mime=a.mime,
                ttl_seconds=a.ttl_seconds,
                collection=a.collection,
                replication=a.replication,
            ),
            chunks=[FileChunk.from_pb(c) for c in p.chunks],
            extended=dict(p.extended),
            content=bytes(p.content),
        )

    def encode(self) -> bytes:
        return self.to_pb().SerializeToString()

    @staticmethod
    def decode(full_path: str, blob: bytes) -> "Entry":
        p = f_pb.Entry.FromString(blob)
        parent = full_path.rsplit("/", 1)[0] or "/"
        e = Entry.from_pb(parent, p)
        e.full_path = full_path
        return e
