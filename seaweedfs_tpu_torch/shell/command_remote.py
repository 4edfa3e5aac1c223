"""remote.mount / remote.cache / remote.uncache / remote.meta.sync —
shell commands attaching external buckets to filer directories
(reference weed/shell/command_remote_*.go).

The port's copy of seaweedfs_tpu/shell/command_remote.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.shell import shell_command


def _client_and_filer(env, args):
    from seaweedfs_tpu_torch.mount.filer_client import FilerClient
    from seaweedfs_tpu_torch.remote_storage import mount as rmount
    from seaweedfs_tpu_torch.remote_storage.client import make_client

    filer = FilerClient(args.filer, env.master_address)
    spec = getattr(args, "remote", "") or ""
    if not spec:
        cfg = rmount.mount_config(filer, args.dir)
        if cfg is None:
            raise RuntimeError(f"{args.dir} is not a remote mount")
        spec = cfg["client"]
    return filer, make_client(spec)


@shell_command("remote.mount", "attach an external bucket to a filer dir")
def cmd_remote_mount(env, args, out):
    from seaweedfs_tpu_torch.remote_storage import mount_remote

    filer, client = _client_and_filer(env, args)
    n = mount_remote(filer, client, args.dir, args.remote, args.prefix)
    print(f"mounted {args.remote} at {args.dir}: {n} entries synced", file=out)


def _mount_flags(p):
    p.add_argument("-filer", required=True, help="filer gRPC address")
    p.add_argument("-dir", required=True, help="filer directory")
    p.add_argument("-remote", required=True, help="client spec, e.g. local:/data")
    p.add_argument("-prefix", default="", help="remote key prefix")


cmd_remote_mount.configure = _mount_flags


@shell_command("remote.meta.sync", "refresh a remote mount's placeholders")
def cmd_remote_meta_sync(env, args, out):
    from seaweedfs_tpu_torch.remote_storage import mount as rmount

    filer, client = _client_and_filer(env, args)
    cfg = rmount.mount_config(filer, args.dir) or {}
    n = rmount.sync_metadata(filer, client, args.dir, cfg.get("prefix", ""))
    print(f"synced {n} new entries into {args.dir}", file=out)


def _sync_flags(p):
    p.add_argument("-filer", required=True)
    p.add_argument("-dir", required=True)


cmd_remote_meta_sync.configure = _sync_flags


@shell_command("remote.cache", "pull remote bytes into cluster chunks")
def cmd_remote_cache(env, args, out):
    from seaweedfs_tpu_torch.remote_storage import cache_entry
    from seaweedfs_tpu_torch.remote_storage.mount import cache_tree

    filer, client = _client_and_filer(env, args)
    if args.path:
        n = cache_entry(filer, client, args.path)
        print(f"cached {n} bytes for {args.path}", file=out)
    else:
        files, total = cache_tree(filer, client, args.dir)
        print(f"cached {files} files ({total} bytes) under {args.dir}", file=out)


def _cache_flags(p):
    p.add_argument("-filer", required=True)
    p.add_argument("-dir", required=True, help="mount directory")
    p.add_argument("-path", default="", help="one file (default: whole tree)")


cmd_remote_cache.configure = _cache_flags


@shell_command("remote.uncache", "drop cached chunks, keep placeholders")
def cmd_remote_uncache(env, args, out):
    from seaweedfs_tpu_torch.remote_storage import uncache_entry

    filer, _client = _client_and_filer(env, args)
    dropped = uncache_entry(filer, args.path)
    print(
        f"{args.path}: {'chunks dropped' if dropped else 'was not cached'}",
        file=out,
    )


def _uncache_flags(p):
    p.add_argument("-filer", required=True)
    p.add_argument("-dir", required=True, help="mount directory")
    p.add_argument("-path", required=True)


cmd_remote_uncache.configure = _uncache_flags


@shell_command("remote.unmount", "detach a remote mount, dropping placeholders")
def cmd_remote_unmount(env, args, out):
    """Inverse of remote.mount (reference command_remote_unmount.go):
    removes the mount marker and every UNCACHED placeholder under the
    directory.  Entries holding cached chunks or locally-written files
    are kept (deleting data the operator cached is volume.delete's job,
    not unmount's)."""
    from seaweedfs_tpu_torch.filer.duck import find_entry, put_entry
    from seaweedfs_tpu_torch.remote_storage.mount import (
        CACHED_ATTR,
        KEY_ATTR,
        MOUNT_ATTR,
        mount_config,
    )

    from seaweedfs_tpu_torch.mount.filer_client import FilerClient

    filer = FilerClient(args.filer, env.master_address)
    dir_path = "/" + args.dir.strip("/")
    if mount_config(filer, dir_path) is None:
        raise RuntimeError(f"{dir_path} is not a remote mount")
    removed = kept = 0

    # remote keys with '/' sync into NESTED placeholder entries — a
    # top-level-only sweep would orphan them once the mount marker is gone
    def _sweep(directory: str) -> None:
        nonlocal removed, kept
        for entry in list(filer.list(directory, limit=1 << 30)):
            if entry.is_directory:
                _sweep(entry.full_path)
                continue
            if KEY_ATTR not in entry.extended:
                kept += 1  # locally-written file, never a placeholder
                continue
            if entry.extended.get(CACHED_ATTR) == b"1":
                kept += 1
                continue
            filer.delete(entry.full_path)
            removed += 1

    _sweep(dir_path)
    mount_entry = find_entry(filer, dir_path)
    if mount_entry is not None:
        mount_entry.extended.pop(MOUNT_ATTR, None)
        put_entry(filer, mount_entry)
    print(
        f"unmounted {dir_path}: {removed} placeholders dropped, "
        f"{kept} local/cached entries kept",
        file=out,
    )


def _unmount_flags(p):
    p.add_argument("-dir", required=True, help="mounted filer directory")
    p.add_argument("-filer", required=True, help="filer gRPC address")


cmd_remote_unmount.configure = _unmount_flags
