"""Kernel-FUSE binding for WeedFS, gated on the `fuse` (fusepy) package.

The reference links go-fuse directly (weed/mount/weedfs.go); the binding
imports lazily and `cli mount` explains itself when no FUSE userspace is
importable.  Every operation of the binding delegates to the WeedFS
object, which holds all the semantics and works without a kernel.

The port's copy of seaweedfs_tpu/mount/fuse_adapter.py: ``fuse_available``
and the refusal of :func:`mount` without FUSE, with the JAX package's
text.  The operation table (the JAX package's ``_Ops``) waits for a
machine that has `fuse` to test it on (ROADMAP Queue A item 4).
"""

from __future__ import annotations

from seaweedfs_tpu_torch.mount.weedfs import WeedFS


def fuse_available() -> bool:
    try:
        import fuse  # noqa: F401

        return True
    except ImportError:
        return False


def mount(fs: WeedFS, mountpoint: str, foreground: bool = True):
    """Block serving the kernel until unmounted.  Raises RuntimeError
    when no FUSE userspace is importable."""
    try:
        from fuse import FUSE, Operations  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "kernel FUSE unavailable: install fusepy (`fuse` module) and "
            "fuse3 userspace; the WeedFS object itself works without it"
        ) from e
    raise NotImplementedError(
        "the kernel FUSE operation table is not ported to seaweedfs_tpu_torch "
        "yet (ROADMAP Queue A item 4); the WeedFS object works without it")
