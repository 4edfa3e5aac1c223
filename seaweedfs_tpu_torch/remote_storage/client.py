"""Remote storage clients (reference remote_storage/remote_storage.go
RemoteStorageClient interface; s3/gcs/azure implementations).

The shipped implementation is directory-backed (no network needed); a
real S3/GCS client implements the same four calls.

The port's copy of seaweedfs_tpu/remote_storage/client.py.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass


@dataclass
class RemoteObject:
    key: str
    size: int
    mtime: float


class RemoteStorageClient(ABC):
    name = "abstract"

    @abstractmethod
    def list_objects(self, prefix: str = "") -> list[RemoteObject]: ...

    @abstractmethod
    def read_object(self, key: str, offset: int = 0, size: int = -1) -> bytes: ...

    @abstractmethod
    def write_object(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def delete_object(self, key: str) -> None: ...


class LocalDirRemoteClient(RemoteStorageClient):
    """A directory tree as the 'remote' bucket."""

    name = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key.lstrip("/")))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise ValueError(f"key escapes the remote root: {key}")
        return path

    def list_objects(self, prefix: str = "") -> list[RemoteObject]:
        out: list[RemoteObject] = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if prefix and not key.startswith(prefix):
                    continue
                st = os.stat(full)
                out.append(RemoteObject(key=key, size=st.st_size, mtime=st.st_mtime))
        return sorted(out, key=lambda o: o.key)

    def read_object(self, key: str, offset: int = 0, size: int = -1) -> bytes:
        with open(self._path(key), "rb") as fh:
            fh.seek(offset)
            return fh.read() if size < 0 else fh.read(size)

    def write_object(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def delete_object(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


def make_client(spec: str) -> RemoteStorageClient:
    """'local:/path' -> client (the registry seam a real S3 client joins
    via 's3:bucket' etc.)."""
    kind, _, rest = spec.partition(":")
    if kind == "local":
        return LocalDirRemoteClient(rest)
    raise ValueError(f"unknown remote storage kind {kind!r}")
