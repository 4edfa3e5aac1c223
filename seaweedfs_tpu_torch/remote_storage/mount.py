"""Remote mount operations over a filer.

Counterpart of the reference's filer.remote.mount / remote.cache /
remote.uncache shell commands (weed/shell/command_remote_*.go) and the
placeholder-entry model of weed/filer/remote_storage (entries carrying
Remote metadata instead of chunks).

Placeholder entries carry extended attributes:
  remote.client  — client spec ("local:/path") recorded on the mount dir
  remote.key     — object key within the remote prefix
  remote.size    — object size (listings/getattr without fetching)
  remote.cached  — "1" once the bytes live as cluster chunks

``filer`` is either an in-process Filer or a mount.FilerClient (the
same duck-typing seam the credential store uses).

The port's copy of seaweedfs_tpu/remote_storage/mount.py.
"""

from __future__ import annotations

import io
import json

from seaweedfs_tpu_torch.filer import upload as chunk_upload
from seaweedfs_tpu_torch.filer.entry import Attr, Entry

MOUNT_ATTR = "remote.mount"
CLIENT_ATTR = "remote.client"
KEY_ATTR = "remote.key"
SIZE_ATTR = "remote.size"
CACHED_ATTR = "remote.cached"


from seaweedfs_tpu_torch.filer.duck import find_entry as _find
from seaweedfs_tpu_torch.filer.duck import master_of as _master
from seaweedfs_tpu_torch.filer.duck import put_entry as _put

from seaweedfs_tpu_torch.util import wlog


def mount_remote(filer, client, dir_path: str, spec: str, prefix: str = "") -> int:
    """Attach ``dir_path`` to the remote and sync its metadata in;
    returns the number of placeholder entries created."""
    dir_path = "/" + dir_path.strip("/")
    mount_entry = _find(filer, dir_path)
    if mount_entry is None:
        mount_entry = Entry(
            dir_path, is_directory=True, attr=Attr.now(mode=0o755)
        )
    mount_entry.extended[MOUNT_ATTR] = json.dumps(
        {"client": spec, "prefix": prefix}
    ).encode()
    _put(filer, mount_entry)
    return sync_metadata(filer, client, dir_path, prefix)


def mount_config(filer, dir_path: str) -> dict | None:
    entry = _find(filer, "/" + dir_path.strip("/"))
    if entry is None or MOUNT_ATTR not in entry.extended:
        return None
    return json.loads(entry.extended[MOUNT_ATTR])


def sync_metadata(filer, client, dir_path: str, prefix: str = "") -> int:
    """Pull the remote listing into placeholder entries (no data);
    already-cached entries keep their chunks."""
    dir_path = "/" + dir_path.strip("/")
    created = 0
    cfg = mount_config(filer, dir_path) or {"client": client.name, "prefix": prefix}
    for obj in client.list_objects(prefix):
        rel = obj.key[len(prefix):].lstrip("/") if prefix else obj.key
        path = f"{dir_path}/{rel}"
        existing = _find(filer, path)
        if existing is not None:
            if existing.extended.get(CACHED_ATTR) == b"1":
                continue  # cached data stays; remote e-divergence is the
                # operator's call (uncache + re-cache to refresh)
            if KEY_ATTR not in existing.extended:
                # a file written locally into the mount dir is NOT a
                # placeholder — overwriting it would destroy user data
                continue
            if (
                existing.extended.get(KEY_ATTR, b"").decode() == obj.key
                and existing.extended.get(SIZE_ATTR, b"").decode()
                == str(obj.size)
            ):
                continue  # placeholder already current
            # placeholder exists but the remote changed: refresh its size
        _put(
            filer,
            Entry(
                path,
                attr=Attr.now(),
                extended={
                    CLIENT_ATTR: cfg["client"].encode(),
                    KEY_ATTR: obj.key.encode(),
                    SIZE_ATTR: str(obj.size).encode(),
                    CACHED_ATTR: b"0",
                },
            ),
        )
        created += 1
    return created


def cache_entry(filer, client, path: str) -> int:
    """Pull one placeholder's bytes into cluster chunks; returns bytes
    cached (0 if it was already cached)."""
    path = "/" + path.strip("/")
    entry = _find(filer, path)
    if entry is None:
        raise FileNotFoundError(path)
    if entry.extended.get(CACHED_ATTR) == b"1" or KEY_ATTR not in entry.extended:
        return 0
    key = entry.extended[KEY_ATTR].decode()
    data = client.read_object(key)
    chunks, content, _etag = chunk_upload.upload_stream(
        _master(filer), io.BytesIO(data)
    )
    entry.chunks = chunks
    entry.content = content
    entry.extended[CACHED_ATTR] = b"1"
    entry.extended[SIZE_ATTR] = str(len(data)).encode()
    _put(filer, entry)
    return len(data)


def uncache_entry(filer, path: str) -> bool:
    """Drop a cached entry's local chunks, keeping the placeholder."""
    path = "/" + path.strip("/")
    entry = _find(filer, path)
    if entry is None:
        raise FileNotFoundError(path)
    if entry.extended.get(CACHED_ATTR) != b"1":
        return False
    old_chunks = list(entry.chunks)
    entry.chunks = []
    entry.content = b""
    entry.extended[CACHED_ATTR] = b"0"
    _put(filer, entry)
    if old_chunks:
        stub = Entry(path, chunks=old_chunks)
        if hasattr(filer, "reclaim_chunks"):
            filer.reclaim_chunks(stub)
        else:
            from seaweedfs_tpu_torch.filer import reader

            for c in old_chunks:
                try:
                    reader.delete_chunk(_master(filer), c.fid)
                except Exception as e:  # noqa: BLE001 — orphans get vacuumed
                    if wlog.V(1):
                        wlog.info("remote: chunk %s not deleted (vacuum will): %s", c.fid, e)
    return True


def cache_tree(filer, client, dir_path: str) -> tuple[int, int]:
    """remote.cache on a directory: cache every placeholder under it;
    returns (files_cached, bytes)."""
    from seaweedfs_tpu_torch.filer.duck import list_all

    dir_path = "/" + dir_path.strip("/")
    files = bytes_total = 0
    stack = [dir_path]
    while stack:
        d = stack.pop()
        for e in list_all(filer, d):  # paginated: >1024-entry dirs too
            if e.is_directory:
                stack.append(e.full_path)
            elif KEY_ATTR in e.extended:
                n = cache_entry(filer, client, e.full_path)
                if n:
                    files += 1
                    bytes_total += n
    return files, bytes_total
