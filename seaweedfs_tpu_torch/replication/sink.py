"""Replication sinks: where mirrored entries land.

Counterpart of the reference's weed/replication/sink/ (ReplicationSink
interface in sink.go; filer and local implementations).  A sink receives
already-materialized file bytes via a ``read_data`` callback so each sink
stays transport-agnostic — the replicator owns reading chunks from the
source cluster.

The port's copy of seaweedfs_tpu/replication/sink.py.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Callable

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.util import wlog

ReadData = Callable[[], bytes]


class ReplicationSink(ABC):
    name = "abstract"

    @abstractmethod
    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        """Mirror a create/update: ``key`` is the sink-side absolute path."""

    @abstractmethod
    def delete_entry(self, key: str, is_directory: bool) -> None: ...

    def close(self) -> None:
        pass


class LocalSink(ReplicationSink):
    """Materialize the tree under a local directory — filer.backup
    (reference replication/sink/localsink/local_sink.go)."""

    name = "local"

    def __init__(self, root_dir: str):
        self.root = os.path.abspath(root_dir)
        os.makedirs(self.root, exist_ok=True)

    def _target(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key.lstrip("/")))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise ValueError(f"replication key escapes sink root: {key}")
        return path

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        path = self._target(key)
        if entry.is_directory:
            os.makedirs(path, exist_ok=True)
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as fh:
            fh.write(read_data())
        os.replace(tmp, path)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        path = self._target(key)
        try:
            if is_directory:
                import shutil

                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
        except FileNotFoundError:
            pass


class FilerSink(ReplicationSink):
    """Mirror into another filer cluster over its gRPC surface —
    filer.sync's receiving side (reference replication/sink/filersink/).

    Data is re-uploaded through the *target* cluster's master so the two
    clusters share nothing but this sync stream."""

    name = "filer"

    def __init__(self, filer_grpc_address: str, target_path: str = "/"):
        import grpc as _grpc  # local import keeps module importable w/o grpc

        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        self._rpc = rpc
        self._f_pb = f_pb
        self._grpc = _grpc
        self.address = filer_grpc_address
        self.target_path = target_path.rstrip("/")
        self.stub = rpc.make_stub(filer_grpc_address, f_pb, "Filer")

    def _sink_key(self, key: str) -> str:
        return self.target_path + key if self.target_path else key

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        f_pb = self._f_pb
        key = self._sink_key(key)
        directory, name = key.rsplit("/", 1)
        pb_entry = entry.to_pb()
        pb_entry.name = name
        if not entry.is_directory:
            data = read_data()
            del pb_entry.chunks[:]
            pb_entry.content = b""
            if data:
                chunks, content = self._upload(data, entry)
                pb_entry.content = content
                pb_entry.chunks.extend(c.to_pb() for c in chunks)
        resp = self.stub.CreateEntry(
            f_pb.CreateEntryRequest(directory=directory or "/", entry=pb_entry)
        )
        if resp.error:
            raise IOError(f"sink create {key}: {resp.error}")

    def _upload(self, data: bytes, entry: Entry):
        """Chunk ``data`` into the sink cluster via the sink filer's
        AssignVolume (the filer proxies its master)."""
        import hashlib
        import time as _time

        from seaweedfs_tpu_torch.filer.entry import FileChunk
        from seaweedfs_tpu_torch.filer.upload import INLINE_LIMIT, http_put_chunk

        if len(data) <= INLINE_LIMIT:
            return [], data
        f_pb = self._f_pb
        chunk_size = 4 * 1024 * 1024
        chunks: list[FileChunk] = []
        for offset in range(0, len(data), chunk_size):
            piece = data[offset : offset + chunk_size]
            assign = self.stub.AssignVolume(
                f_pb.AssignVolumeRequest(
                    count=1,
                    collection=entry.attr.collection,
                    ttl_seconds=entry.attr.ttl_seconds,
                )
            )
            if assign.error:
                raise IOError(f"sink assign: {assign.error}")
            http_put_chunk(assign.url, assign.fid, piece, auth=assign.auth)
            chunks.append(
                FileChunk(
                    fid=assign.fid,
                    offset=offset,
                    size=len(piece),
                    modified_ts_ns=_time.time_ns(),
                    e_tag=hashlib.md5(piece).hexdigest(),
                )
            )
        return chunks, b""

    def delete_entry(self, key: str, is_directory: bool) -> None:
        f_pb = self._f_pb
        key = self._sink_key(key)
        directory, name = key.rsplit("/", 1)
        resp = self.stub.DeleteEntry(
            f_pb.DeleteEntryRequest(
                directory=directory or "/",
                name=name,
                is_delete_data=True,
                is_recursive=is_directory,
            )
        )
        if resp.error:
            raise IOError(f"sink delete {key}: {resp.error}")


class S3Sink(ReplicationSink):
    """Mirror into any S3-compatible endpoint — filer.backup's cloud
    target (reference replication/sink/s3sink/), spoken with the stdlib
    and SigV4 header signing (reusing the gateway's signing-key
    derivation), so it needs no cloud SDK and works against this
    framework's own S3 gateway.

    Spec: ``s3://access:secret@host:port/bucket[/prefix]`` (http; the
    sink is for in-cluster/backup endpoints — TLS endpoints can front it
    with the gateway's -tlsCert).  Directories are not materialized (S3
    has no directories); a recursive directory delete removes the
    prefix's objects via ListObjectsV2."""

    name = "s3"

    def __init__(self, spec: str, region: str = "us-east-1"):
        from urllib.parse import unquote, urlparse

        u = urlparse(spec)
        if not u.hostname or not u.username or not u.password:
            raise ValueError(
                f"bad s3 sink spec {spec!r}: need "
                "s3://access:secret@host:port/bucket[/prefix]"
            )
        self.host = u.hostname
        self.port = u.port or 8333
        self.access = unquote(u.username)
        self.secret = unquote(u.password)
        parts = u.path.strip("/").split("/", 1)
        if not parts[0]:
            raise ValueError(f"s3 sink spec {spec!r} names no bucket")
        self.bucket = parts[0]
        self.prefix = parts[1].strip("/") if len(parts) > 1 else ""
        self.region = region

    # -- stdlib SigV4 request plumbing ------------------------------------

    def _request(
        self, method: str, key: str, body: bytes = b"", query: str = ""
    ):
        """One signed S3 request over the shared keep-alive pool (the
        pool retries once on a stale socket; signed headers replay
        unchanged — the signature covers method/path/payload, not the
        connection).  Signing rides the gateway's own client signer
        (s3/client_sign.sign_headers), so the canonical URI/query
        encoding matches the verifier exactly — keys with spaces, '%',
        or non-ASCII sign and transit correctly."""
        from urllib.parse import quote

        from seaweedfs_tpu_torch.s3.client_sign import sign_headers
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        path = f"/{self.bucket}"
        if key:
            path += "/" + quote(key, safe="/")
        headers = sign_headers(
            method, path, query, f"{self.host}:{self.port}", body,
            self.access, self.secret, region=self.region,
        )
        return shared_pool().request(
            f"{self.host}:{self.port}",
            method,
            path + (f"?{query}" if query else ""),
            body=body or None,
            headers=headers,
            timeout=30,
        )

    def close(self) -> None:
        pass  # connections live in the process-wide shared pool

    def _object_key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.prefix}/{k}" if self.prefix else k

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        if entry.is_directory:
            return  # S3 has no directories
        status, data = self._request(
            "PUT", self._object_key(key), body=read_data()
        )
        if status >= 300:
            raise IOError(f"s3 sink PUT {key}: HTTP {status} {data[:200]!r}")

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if not is_directory:
            status, data = self._request("DELETE", self._object_key(key))
            if status >= 300 and status != 404:
                raise IOError(
                    f"s3 sink DELETE {key}: HTTP {status} {data[:200]!r}"
                )
            return
        # recursive prefix delete via ListObjectsV2 pages, parsed with a
        # real XML parser: regex+unescape missed keys whose text the
        # server entity- or CDATA-encodes (quotes, '<', '&') so their
        # DELETEs targeted names that do not exist.
        # encoding-type=url is requested too — keys holding characters
        # XML 1.0 cannot carry at all (control chars) come back
        # percent-encoded; the unquote step is gated on the server
        # actually echoing <EncodingType>url</EncodingType>, so servers
        # that ignore the parameter (this framework's own gateway) never
        # get keys containing literal '%' mangled.
        import xml.etree.ElementTree as ET
        from urllib.parse import quote, unquote_plus

        def _local(el) -> str:
            return el.tag.rpartition("}")[2]  # strip any xmlns prefix

        prefix = self._object_key(key).rstrip("/") + "/"
        token = ""
        while True:
            query = (
                "list-type=2&encoding-type=url"
                f"&prefix={quote(prefix, safe='')}"
            )
            if token:
                query += f"&continuation-token={quote(token, safe='')}"
            status, data = self._request("GET", "", query=query)
            if status >= 300:
                raise IOError(f"s3 sink LIST {prefix}: HTTP {status}")
            try:
                root = ET.fromstring(data)
            except ET.ParseError as e:
                raise IOError(f"s3 sink LIST {prefix}: bad XML ({e})") from e
            url_encoded = any(
                _local(el) == "EncodingType" and (el.text or "") == "url"
                for el in root.iter()
            )
            token = ""
            for el in root.iter():
                name = _local(el)
                if name == "Key":
                    k = el.text or ""
                    if url_encoded:
                        # unquote_plus: AWS's list url-encoding writes a
                        # space as '+' (botocore decodes the same way)
                        k = unquote_plus(k)
                    st, _d = self._request("DELETE", k)
                    if st >= 300 and st != 404:
                        raise IOError(f"s3 sink DELETE {k!r}: HTTP {st}")
                elif name == "NextContinuationToken":
                    token = el.text or ""
            if not token:
                return


class GcsSink(ReplicationSink):
    """Google Cloud Storage sink (reference replication/sink/gcssink/) —
    gated on google-cloud-storage.  Spec: ``gcs://bucket[/prefix]``."""

    name = "gcs"

    def __init__(self, spec: str):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "gcs sink needs the google-cloud-storage package "
                "(pip install google-cloud-storage)"
            ) from e
        rest = spec.split("://", 1)[1]
        bucket, _, prefix = rest.partition("/")
        try:
            self.bucket = storage.Client().bucket(bucket)
        except Exception as e:  # noqa: BLE001 — DefaultCredentialsError etc.
            raise RuntimeError(
                f"gcs sink: no usable Google credentials ({e})"
            ) from e
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.prefix}/{k}" if self.prefix else k

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        if entry.is_directory:
            return
        self.bucket.blob(self._key(key)).upload_from_string(read_data())

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if is_directory:
            for blob in self.bucket.list_blobs(
                prefix=self._key(key).rstrip("/") + "/"
            ):
                blob.delete()
        else:
            self.bucket.blob(self._key(key)).delete()


class AzureSink(ReplicationSink):
    """Azure Blob Storage sink (reference replication/sink/azuresink/) —
    gated on azure-storage-blob.  Spec: ``azure://container[/prefix]``
    with credentials from the environment (AZURE_STORAGE_CONNECTION_STRING)."""

    name = "azure"

    def __init__(self, spec: str):
        try:
            from azure.storage.blob import (  # type: ignore
                ContainerClient,
            )
        except ImportError as e:
            raise RuntimeError(
                "azure sink needs the azure-storage-blob package "
                "(pip install azure-storage-blob)"
            ) from e
        conn_str = os.environ.get("AZURE_STORAGE_CONNECTION_STRING", "")
        if not conn_str:
            raise RuntimeError(
                "azure sink needs $AZURE_STORAGE_CONNECTION_STRING"
            )
        rest = spec.split("://", 1)[1]
        container, _, prefix = rest.partition("/")
        self.client = ContainerClient.from_connection_string(
            conn_str, container
        )
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.prefix}/{k}" if self.prefix else k

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        if entry.is_directory:
            return
        self.client.upload_blob(self._key(key), read_data(), overwrite=True)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if is_directory:
            for blob in self.client.list_blobs(
                name_starts_with=self._key(key).rstrip("/") + "/"
            ):
                self.client.delete_blob(blob.name)
        else:
            self.client.delete_blob(self._key(key))


class B2Sink(ReplicationSink):
    """Backblaze B2 sink (reference replication/sink/b2sink/) — gated on
    b2sdk.  Spec: ``b2://bucket[/prefix]`` with B2_APPLICATION_KEY_ID /
    B2_APPLICATION_KEY from the environment."""

    name = "b2"

    def __init__(self, spec: str):
        try:
            from b2sdk.v2 import B2Api, InMemoryAccountInfo  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "b2 sink needs the b2sdk package (pip install b2sdk)"
            ) from e
        key_id = os.environ.get("B2_APPLICATION_KEY_ID", "")
        key = os.environ.get("B2_APPLICATION_KEY", "")
        if not key_id or not key:
            raise RuntimeError(
                "b2 sink needs $B2_APPLICATION_KEY_ID and $B2_APPLICATION_KEY"
            )
        api = B2Api(InMemoryAccountInfo())
        api.authorize_account("production", key_id, key)
        rest = spec.split("://", 1)[1]
        bucket, _, prefix = rest.partition("/")
        self.bucket = api.get_bucket_by_name(bucket)
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.prefix}/{k}" if self.prefix else k

    def create_entry(self, key: str, entry: Entry, read_data: ReadData) -> None:
        if entry.is_directory:
            return
        self.bucket.upload_bytes(read_data(), self._key(key))

    def delete_entry(self, key: str, is_directory: bool) -> None:
        if is_directory:
            for version, _ in self.bucket.ls(
                self._key(key).rstrip("/") + "/", recursive=True
            ):
                self.bucket.delete_file_version(
                    version.id_, version.file_name
                )
        else:
            for version, _ in self.bucket.ls(self._key(key)):
                self.bucket.delete_file_version(
                    version.id_, version.file_name
                )


def make_sink(spec: str) -> ReplicationSink:
    """Sink factory for filer.backup -sink (reference replication/sink
    registry): ``dir:path`` / bare path → local directory,
    ``filer://grpc-addr[/path]`` → another filer cluster,
    ``s3://ak:sk@host:port/bucket[/prefix]`` → S3-compatible endpoint,
    ``gcs://…`` / ``azure://…`` / ``b2://…`` → cloud SDK sinks (gated)."""
    scheme = spec.split("://", 1)[0] if "://" in spec else ""
    if scheme == "s3":
        return S3Sink(spec)
    if scheme == "gcs":
        return GcsSink(spec)
    if scheme == "azure":
        return AzureSink(spec)
    if scheme == "b2":
        return B2Sink(spec)
    if scheme == "filer":
        rest = spec.split("://", 1)[1]
        addr, _, path = rest.partition("/")
        return FilerSink(addr, target_path="/" + path if path else "/")
    if spec.startswith("dir:"):
        return LocalSink(spec[4:])
    if "://" in spec:
        # a typo'd scheme must NOT silently mirror into a local
        # directory named "s3:…" (with credentials in the path)
        raise ValueError(f"unknown sink scheme in {spec!r}")
    return LocalSink(spec)
