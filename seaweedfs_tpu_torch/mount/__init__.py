"""Mount layer: a POSIX-shaped filesystem view over the filer.

The port's counterpart of seaweedfs_tpu/mount (reference weed/mount/).
So far only its filer client is ported: :class:`FilerClient`, the gRPC
face of a filer that the remote-storage commands and duck-typed helpers
(filer/duck.py) drive.  The filesystem object, its page writer, metadata
cache and FUSE adapter are ROADMAP Queue A item 4.
"""

from seaweedfs_tpu_torch.mount.filer_client import FilerClient

__all__ = ["FilerClient"]
