"""`cli mount` — attach a filer tree at a local mountpoint.

Counterpart of the reference's `weed mount` (weed/command/mount.go).
Needs a FUSE userspace; without one the command explains itself instead
of half-working (the WeedFS object the tests drive needs no kernel).

The port's copy of seaweedfs_tpu/commands/mount_cmd.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("mount", "mount a filer tree via FUSE")
def run_mount(args) -> int:
    from seaweedfs_tpu_torch.mount import WeedFS
    from seaweedfs_tpu_torch.mount.fuse_adapter import fuse_available, mount

    if not fuse_available():
        # checked before any network/thread setup: the actionable error
        # must not hide behind gRPC noise from an unrelated subsystem
        print(
            "mount: no FUSE userspace found (python `fuse` module missing).\n"
            "The filesystem layer itself is available programmatically:\n"
            "  from seaweedfs_tpu_torch.mount import WeedFS"
        )
        return 1
    fs = WeedFS(
        args.filer,
        args.master,
        root=args.filerPath,
        chunk_size=args.chunkSizeLimitMB * 1024 * 1024,
    )
    print(f"mounting {args.filer}{args.filerPath} at {args.dir}")
    try:
        mount(fs, args.dir, foreground=True)
    finally:
        fs.close()
    return 0


def _mount_flags(p):
    p.add_argument("-filer", default="127.0.0.1:18888", help="filer gRPC address")
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-dir", required=True, help="local mountpoint")
    p.add_argument("-filerPath", default="/", help="filer subtree to mount")
    p.add_argument("-chunkSizeLimitMB", type=int, default=4)


run_mount.configure = _mount_flags
