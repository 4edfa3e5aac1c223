"""fs.* shell commands: browse and manipulate the filer namespace.  The
port's copy of seaweedfs_tpu/shell/command_fs.py.

Counterparts of the reference's shell/command_fs_*.go family (fs.cd,
fs.ls, fs.du, fs.tree, fs.cat, fs.mkdir, fs.mv, fs.rm, fs.meta.save,
fs.meta.load, fs.meta.cat, fs.verify) — driven over the filer gRPC
contract (pb/filer.proto) with chunk reads through the master-cached
volume locations (filer/reader.py)."""

from __future__ import annotations

import base64
import json
import stat
import time

from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.shell import ShellError, shell_command
from seaweedfs_tpu_torch.wdclient import MasterClient

from seaweedfs_tpu_torch.util import wlog


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _norm(path: str) -> str:
    out = []
    for part in path.split("/"):
        if part in ("", "."):
            continue
        if part == "..":
            if out:
                out.pop()
            continue
        out.append(part)
    return "/" + "/".join(out)


def _resolve(env, raw: str) -> str:
    """Resolve a command path against the shell's working directory."""
    if not raw:
        return env.current_dir
    if raw.startswith("/"):
        return _norm(raw)
    return _norm(env.current_dir + "/" + raw)


def _master_client(env) -> MasterClient:
    return env.remote_filer().master_client


def _lookup(env, path: str) -> Entry | None:
    return env.remote_filer().find_entry(path.rstrip("/") or "/")


def _list(env, directory: str) -> list[Entry]:
    return env.remote_filer().list_entries(directory, limit=1 << 30)


def _walk(env, directory: str):
    """Yield every entry under ``directory``, depth-first, parents first."""
    for e in _list(env, directory):
        yield e
        if e.is_directory:
            yield from _walk(env, e.full_path)


# ---------------------------------------------------------------------------
# navigation
# ---------------------------------------------------------------------------

@shell_command("fs.cd", "change the shell working directory on the filer")
def cmd_fs_cd(env, args, out):
    target = args.path
    # `fs.cd host:grpc_port/path` also (re)points the filer connection,
    # like the reference's original fs.cd URL form
    if target and not target.startswith("/") and ":" in target.split("/", 1)[0]:
        addr, _, rest = target.partition("/")
        env.filer_address = addr
        target = "/" + rest
    path = _resolve(env, target)
    entry = _lookup(env, path)
    if entry is None or not entry.is_directory:
        raise RuntimeError(f"{path}: no such directory")
    env.current_dir = path
    print(path, file=out)


cmd_fs_cd.configure = lambda p: p.add_argument("path", nargs="?", default="/")


@shell_command("fs.pwd", "print the shell working directory")
def cmd_fs_pwd(env, args, out):
    print(env.current_dir, file=out)


@shell_command("fs.ls", "list entries under a filer directory")
def cmd_fs_ls(env, args, out):
    path = _resolve(env, args.path)
    entry = _lookup(env, path)
    if entry is None:
        raise RuntimeError(f"{path}: no such entry")
    entries = _list(env, path) if entry.is_directory else [entry]
    for e in sorted(entries, key=lambda e: e.name):
        if args.l:
            kind = "d" if e.is_directory else "-"
            mode = stat.filemode(
                (stat.S_IFDIR if e.is_directory else stat.S_IFREG) | (e.attr.mode & 0o7777)
            )[1:]
            mtime = time.strftime("%Y-%m-%d %H:%M", time.localtime(e.attr.mtime))
            print(
                f"{kind}{mode} {e.attr.uid:>5} {e.attr.gid:>5} "
                f"{e.size:>12} {mtime} {e.name}",
                file=out,
            )
        else:
            print(e.name + ("/" if e.is_directory else ""), file=out)


def _ls_flags(p):
    p.add_argument("-l", action="store_true", help="long format")
    p.add_argument("path", nargs="?", default="")


cmd_fs_ls.configure = _ls_flags


@shell_command("fs.tree", "recursively print the filer tree")
def cmd_fs_tree(env, args, out):
    root = _resolve(env, args.path)

    def rec(directory: str, depth: int):
        for e in sorted(_list(env, directory), key=lambda e: e.name):
            print("  " * depth + e.name + ("/" if e.is_directory else ""), file=out)
            if e.is_directory:
                rec(e.full_path, depth + 1)

    print(root, file=out)
    rec(root, 1)


cmd_fs_tree.configure = lambda p: p.add_argument("path", nargs="?", default="")


@shell_command("fs.du", "disk usage: directories, files, bytes")
def cmd_fs_du(env, args, out):
    root = _resolve(env, args.path)
    n_dir = n_file = n_bytes = 0
    for e in _walk(env, root):
        if e.is_directory:
            n_dir += 1
        else:
            n_file += 1
            n_bytes += e.size
    print(f"dir:{n_dir} file:{n_file} size:{n_bytes} {root}", file=out)


cmd_fs_du.configure = lambda p: p.add_argument("path", nargs="?", default="")


# ---------------------------------------------------------------------------
# content
# ---------------------------------------------------------------------------

@shell_command("fs.cat", "stream a filer file's bytes to the output")
def cmd_fs_cat(env, args, out):
    path = _resolve(env, args.path)
    entry = _lookup(env, path)
    if entry is None or entry.is_directory:
        raise RuntimeError(f"{path}: no such file")
    from seaweedfs_tpu_torch.filer.reader import read_entry

    data = read_entry(_master_client(env), entry)
    try:
        out.write(data.decode())
    except UnicodeDecodeError:
        out.write(data.decode("latin-1"))


cmd_fs_cat.configure = lambda p: p.add_argument("path")


@shell_command("fs.mkdir", "create a directory on the filer")
def cmd_fs_mkdir(env, args, out):
    path = _resolve(env, args.path)
    env.remote_filer().create_entry(
        Entry(full_path=path, is_directory=True, attr=Attr.now(0o755))
    )
    print(path, file=out)


cmd_fs_mkdir.configure = lambda p: p.add_argument("path")


@shell_command("fs.mv", "move/rename a filer entry")
def cmd_fs_mv(env, args, out):
    src = _resolve(env, args.src)
    dst = _resolve(env, args.dst)
    src_entry = _lookup(env, src)
    if src_entry is None:
        raise RuntimeError(f"{src}: no such entry")
    dst_entry = _lookup(env, dst)
    if dst_entry is not None and dst_entry.is_directory:
        dst = dst.rstrip("/") + "/" + src_entry.name  # move into directory
    env.remote_filer().rename(src, dst)
    print(f"{src} -> {dst}", file=out)


def _mv_flags(p):
    p.add_argument("src")
    p.add_argument("dst")


cmd_fs_mv.configure = _mv_flags


@shell_command("fs.rm", "remove a filer entry (use -r for directories)")
def cmd_fs_rm(env, args, out):
    for raw in args.paths:
        path = _resolve(env, raw)
        entry = _lookup(env, path)
        if entry is None:
            if not args.f:
                raise RuntimeError(f"{path}: no such entry")
            continue
        if entry.is_directory and not args.r:
            raise RuntimeError(f"{path}: is a directory (use -r)")
        try:
            env.remote_filer().delete_entry(
                path, recursive=entry.is_directory
            )
        except (RuntimeError, FileNotFoundError):
            if not args.f:
                raise
        print(f"removed {path}", file=out)


def _rm_flags(p):
    p.add_argument("-r", action="store_true", help="recurse into directories")
    p.add_argument("-f", action="store_true", help="ignore missing entries")
    p.add_argument("paths", nargs="+")


cmd_fs_rm.configure = _rm_flags


# ---------------------------------------------------------------------------
# metadata export / import / inspection
# ---------------------------------------------------------------------------

@shell_command("fs.meta.save", "export filer metadata to a local file")
def cmd_fs_meta_save(env, args, out):
    root = _resolve(env, args.path)
    dest = args.o or (
        "filer-meta-" + time.strftime("%Y%m%d-%H%M%S") + ".jsonl"
    )
    count = 0
    with open(dest, "w") as f:
        for e in _walk(env, root):
            f.write(
                json.dumps(
                    {
                        "path": e.full_path,
                        "pb": base64.b64encode(e.encode()).decode(),
                    }
                )
                + "\n"
            )
            count += 1
    print(f"saved {count} entries from {root} to {dest}", file=out)


def _meta_save_flags(p):
    p.add_argument("-o", default="", help="output file (default timestamped)")
    p.add_argument("path", nargs="?", default="")


cmd_fs_meta_save.configure = _meta_save_flags


@shell_command("fs.meta.load", "import filer metadata from a saved file")
def cmd_fs_meta_load(env, args, out):
    count = 0
    with open(args.file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            entry = Entry.decode(rec["path"], base64.b64decode(rec["pb"]))
            env.remote_filer().create_entry(entry)
            count += 1
    print(f"loaded {count} entries from {args.file}", file=out)


cmd_fs_meta_load.configure = lambda p: p.add_argument("file")


@shell_command("fs.meta.cat", "print one entry's metadata (proto text)")
def cmd_fs_meta_cat(env, args, out):
    from google.protobuf import text_format

    path = _resolve(env, args.path)
    entry = _lookup(env, path)
    if entry is None:
        raise RuntimeError(f"{path}: no such entry")
    print(f"directory: {entry.parent}", file=out)
    print(text_format.MessageToString(entry.to_pb()), file=out)


cmd_fs_meta_cat.configure = lambda p: p.add_argument("path")


@shell_command("fs.log", "print recent filer metadata events")
def cmd_fs_log(env, args, out):
    """Tail of the filer's metadata event log (reference
    shell/command_fs_log.go over the same subscribe seam filer.sync
    uses)."""
    import time as _time

    from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

    import grpc as grpc_mod

    since_ns = int((_time.time() - args.sinceSeconds) * 1e9)
    prefix = _resolve(env, args.path)
    count = 0
    # the subscription follows live events forever; a short deadline
    # drains history then cuts the stream (this is a log *view*)
    stream = env.filer().SubscribeMetadata(
        f_pb.SubscribeMetadataRequest(
            client_name="shell-fs-log",
            path_prefix=prefix,
            since_ts_ns=since_ns,
        ),
        timeout=1.0,
    )
    try:
        for ev in stream:
            old = ev.old_entry.name if ev.old_entry.name else ""
            new = ev.new_entry.name if ev.new_entry.name else ""
            if old and new:
                kind = "rename" if ev.new_parent_path else "update"
            elif new:
                kind = "create"
            else:
                kind = "delete"
            ts = _time.strftime("%H:%M:%S", _time.localtime(ev.ts_ns / 1e9))
            print(f"  {ts} {kind:7s} {ev.directory.rstrip('/')}/{new or old}",
                  file=out)
            count += 1
            if count >= args.limit:
                break
    except grpc_mod.RpcError as e:
        if e.code() != grpc_mod.StatusCode.DEADLINE_EXCEEDED:
            raise
    finally:
        stream.cancel()  # every exit path, or failed runs leak streams
    print(f"{count} events", file=out)


def _fs_log_flags(p):
    p.add_argument("-sinceSeconds", type=int, default=600)
    p.add_argument("-limit", type=int, default=100)
    p.add_argument("path", nargs="?", default="")


cmd_fs_log.configure = _fs_log_flags


@shell_command("fs.verify", "verify every file chunk is readable")
def cmd_fs_verify(env, args, out):
    root = _resolve(env, args.path)
    mc = _master_client(env)
    from seaweedfs_tpu_torch.filer.reader import fetch_chunk, resolve_chunks

    files = broken = 0
    for e in _walk(env, root):
        if e.is_directory or e.content:
            continue
        files += 1
        try:
            chunks = resolve_chunks(mc, e)
        except Exception as ex:  # noqa: BLE001 — unreadable manifest
            print(f"BROKEN {e.full_path}: manifest: {ex}", file=out)
            broken += 1
            continue
        for c in chunks:
            vid = int(c.fid.split(",")[0])
            try:
                locations = mc.lookup(vid)
            except Exception as e:  # noqa: BLE001 — reported as BROKEN below
                if wlog.V(2):
                    wlog.info("fs.verify: lookup vid=%d failed: %s", vid, e)
                locations = []
            if not locations:
                print(f"BROKEN {e.full_path}: chunk {c.fid} has no locations",
                      file=out)
                broken += 1
                continue
            if args.verifyData:
                try:
                    data = fetch_chunk(mc, c.fid)
                    if len(data) != c.size:
                        raise IOError(f"size {len(data)} != {c.size}")
                except Exception as ex:  # noqa: BLE001
                    print(f"BROKEN {e.full_path}: chunk {c.fid}: {ex}", file=out)
                    broken += 1
    print(f"verified {files} files, {broken} broken", file=out)


def _verify_flags(p):
    p.add_argument(
        "-verifyData", action="store_true", help="fetch every chunk's bytes"
    )
    p.add_argument("path", nargs="?", default="")


cmd_fs_verify.configure = _verify_flags


@shell_command(
    "fs.configure",
    "per-path storage rules: collection/replication/TTL/disk/readOnly",
)
def cmd_fs_configure(env, args, out):
    """Edit the filer's location rules (reference
    command_fs_configure.go:24-41 / filer_conf.go): uploads under a
    configured prefix inherit its collection/replication/TTL/disk type;
    readOnly freezes the subtree.  Without -apply the change is shown
    but not persisted."""
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    from seaweedfs_tpu_torch.filer.filer_conf import (
        CONF_DIR,
        CONF_PATH,
        FilerConf,
        PathConf,
    )

    rf = env.remote_filer()
    entry = rf.find_entry(CONF_PATH)
    conf = FilerConf.from_bytes(entry.content if entry is not None else None)
    changed = False
    if args.locationPrefix:
        if not args.locationPrefix.startswith("/"):
            raise ShellError("-locationPrefix must be an absolute path")
        if args.isDelete:
            if not conf.delete(args.locationPrefix):
                print(f"no rule for {args.locationPrefix}", file=out)
                return
        else:
            conf.upsert(
                PathConf(
                    location_prefix=args.locationPrefix,
                    collection=args.collection,
                    replication=args.replication,
                    ttl_seconds=args.ttlSec,
                    disk_type=args.diskType,
                    read_only=args.readOnly,
                    volume_growth_count=args.volumeGrowthCount,
                    max_file_name_length=args.maxFileNameLength,
                )
            )
        changed = True
    print(conf.to_bytes().decode(), file=out)
    if changed and args.apply:
        rf.mkdirs(CONF_DIR)
        rf.create_entry(
            Entry(
                full_path=CONF_PATH,
                attr=Attr.now(mime="application/json"),
                content=conf.to_bytes(),
            )
        )
        print("applied", file=out)
    elif changed:
        print("(dry run; pass -apply to persist)", file=out)


def _configure_flags(p):
    p.add_argument("-locationPrefix", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttlSec", type=int, default=0)
    p.add_argument("-diskType", default="")
    p.add_argument("-volumeGrowthCount", type=int, default=0)
    p.add_argument("-maxFileNameLength", type=int, default=0)
    p.add_argument("-readOnly", action="store_true")
    p.add_argument("-isDelete", action="store_true")
    p.add_argument("-apply", action="store_true")


cmd_fs_configure.configure = _configure_flags
