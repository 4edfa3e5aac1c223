"""Mount layer: a POSIX-shaped filesystem view over the filer.

The port's counterpart of seaweedfs_tpu/mount (reference weed/mount/,
weedfs.go:78 and friends): the filesystem object (:class:`WeedFS`) with
lookup/getattr/readdir/create/open/read/write/flush/rename, a write-back
page cache (page_writer.py ~ mount/page_writer/), a metadata cache
invalidated by the filer's event subscription (meta_cache.py ~
mount/meta_cache/), and :class:`FilerClient`, the gRPC face of a filer
that the remote-storage commands and duck-typed helpers (filer/duck.py)
drive too.  The kernel-FUSE binding (fuse_adapter.py) is gated on the
`fuse` package; everything above it runs without a kernel.
"""

from seaweedfs_tpu_torch.mount.filer_client import FilerClient
from seaweedfs_tpu_torch.mount.meta_cache import MetaCache
from seaweedfs_tpu_torch.mount.page_writer import PageWriter
from seaweedfs_tpu_torch.mount.weedfs import FuseError, WeedFS

__all__ = ["FilerClient", "FuseError", "MetaCache", "PageWriter", "WeedFS"]
