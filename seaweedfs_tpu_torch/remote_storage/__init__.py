"""Remote storage: external buckets mounted as cached filer folders.

The port's counterpart of the reference's weed/remote_storage/ and
the filer.remote.* shell commands: a filer directory maps onto a prefix
in an external object store; metadata syncs in as placeholder entries,
bytes are pulled into cluster chunks on demand (remote.cache) and can be
dropped again (remote.uncache) while the placeholders remain readable
metadata.

The port's copy of seaweedfs_tpu/remote_storage/__init__.py.
"""

from seaweedfs_tpu_torch.remote_storage.client import (
    LocalDirRemoteClient,
    RemoteObject,
    RemoteStorageClient,
)
from seaweedfs_tpu_torch.remote_storage.mount import (
    cache_entry,
    mount_remote,
    sync_metadata,
    uncache_entry,
)

__all__ = [
    "LocalDirRemoteClient",
    "RemoteObject",
    "RemoteStorageClient",
    "cache_entry",
    "mount_remote",
    "sync_metadata",
    "uncache_entry",
]
