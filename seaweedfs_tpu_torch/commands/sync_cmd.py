"""filer.sync / filer.backup subcommands.

Counterpart of the reference's weed/command/filer_sync.go and
filer_backup.go: continuous metadata-event-driven mirroring from a source
filer to another filer cluster or a local directory.  ``-once`` drains
the whole backlog, pass after pass (``FilerSyncer.drain``), where the JAX
package's stops after one stream deadline.

The port's copy of seaweedfs_tpu/commands/sync_cmd.py.
"""

from __future__ import annotations

import time

from seaweedfs_tpu_torch.commands import command


@command("filer.sync", "mirror a filer tree into another filer cluster")
def run_filer_sync(args) -> int:
    from seaweedfs_tpu_torch.replication import FilerSink, FilerSyncer

    sink = FilerSink(args.toFiler, target_path=args.toPath)
    syncer = FilerSyncer(
        args.fromFiler,
        args.fromMaster,
        sink,
        source_dir=args.fromPath,
        exclude_dirs=tuple(d for d in (args.exclude or "").split(",") if d),
        checkpoint_path=args.checkpoint or None,
        client_name="filer.sync",
    )
    if args.once:
        syncer.drain(max_events=args.maxEvents or None)
        print(f"applied {syncer.applied} events, {len(syncer.errors)} errors")
        for e in syncer.errors[:10]:
            print(f"  error: {e}")
        return 1 if syncer.errors else 0
    syncer.start()
    print(f"syncing {args.fromFiler}{args.fromPath} -> {args.toFiler}{args.toPath}")
    try:
        while True:
            time.sleep(5)
            if syncer.errors:
                print(f"[sync] {len(syncer.errors)} errors, last: {syncer.errors[-1]}")
    except KeyboardInterrupt:
        syncer.stop()
        return 0


def _sync_flags(p):
    p.add_argument("-fromFiler", required=True, help="source filer gRPC address")
    p.add_argument("-fromMaster", required=True, help="source master gRPC address")
    p.add_argument("-toFiler", required=True, help="target filer gRPC address")
    p.add_argument("-fromPath", default="/", help="source subtree")
    p.add_argument("-toPath", default="/", help="target subtree prefix")
    p.add_argument("-exclude", default="", help="comma-separated dirs to skip")
    p.add_argument("-checkpoint", default="", help="checkpoint file path")
    p.add_argument("-once", action="store_true", help="drain pending events and exit")
    p.add_argument("-maxEvents", type=int, default=0)


run_filer_sync.configure = _sync_flags


@command("filer.backup", "mirror a filer tree into a sink (dir/S3/cloud)")
def run_filer_backup(args) -> int:
    from seaweedfs_tpu_torch.replication import FilerSyncer, make_sink

    if not (args.sink or args.dir):
        raise SystemExit("filer.backup: need -sink or -dir")
    sink = make_sink(args.sink or args.dir)
    syncer = FilerSyncer(
        args.filer,
        args.master,
        sink,
        source_dir=args.path,
        checkpoint_path=args.checkpoint or None,
        client_name="filer.backup",
    )
    if args.once:
        syncer.drain(max_events=args.maxEvents or None)
        print(f"applied {syncer.applied} events, {len(syncer.errors)} errors")
        return 1 if syncer.errors else 0
    syncer.start()
    print(f"backing up {args.filer}{args.path} -> {args.sink or args.dir}")
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        syncer.stop()
        return 0


def _backup_flags(p):
    p.add_argument("-filer", required=True, help="source filer gRPC address")
    p.add_argument("-master", required=True, help="source master gRPC address")
    p.add_argument("-dir", default="", help="local destination directory")
    p.add_argument(
        "-sink", default="",
        help="destination: dir:path, filer://grpc[/path], "
        "s3://ak:sk@host:port/bucket[/prefix], gcs:// azure:// b2:// "
        "(overrides -dir)",
    )
    p.add_argument("-path", default="/", help="source subtree")
    p.add_argument("-checkpoint", default="", help="checkpoint file path")
    p.add_argument("-once", action="store_true")
    p.add_argument("-maxEvents", type=int, default=0)


run_filer_backup.configure = _backup_flags


@command("filer.meta.tail", "follow the filer's metadata event stream")
def run_meta_tail(args) -> int:
    """Live metadata event follower (reference command/filer_meta_tail.go):
    prints one JSON line per create/update/rename/delete under -path."""
    import json
    import sys
    import time as _time

    import grpc

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

    since_ns = int((_time.time() - args.sinceSeconds) * 1e9)
    printed = 0
    while True:
        stream = rpc.filer_stub(args.filer).SubscribeMetadata(
            f_pb.SubscribeMetadataRequest(
                client_name="filer.meta.tail",
                path_prefix=args.path,
                since_ts_ns=since_ns,
            )
        )
        try:
            for ev in stream:
                since_ns = max(since_ns, ev.ts_ns)
                old = ev.old_entry.name or ""
                new = ev.new_entry.name or ""
                print(
                    json.dumps(
                        {
                            "ts_ns": ev.ts_ns,
                            "dir": ev.directory,
                            "old": old or None,
                            "new": new or None,
                            "rename_to": ev.new_parent_path or None,
                        },
                        separators=(",", ":"),
                    ),
                    flush=True,
                )
                printed += 1
                if args.maxEvents and printed >= args.maxEvents:
                    stream.cancel()
                    return 0
            # clean server-side end (e.g. filer shutting down): back off
            # before re-subscribing, or this loop spins at 100% CPU
            _time.sleep(1)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.CANCELLED:
                return 0
            print(f"stream broke ({e.code()}); reconnecting", file=sys.stderr)
            _time.sleep(1)
        except KeyboardInterrupt:
            stream.cancel()
            return 0


def _meta_tail_flags(p):
    p.add_argument("-filer", required=True, help="filer gRPC address")
    p.add_argument("-path", default="/", help="subtree to follow")
    p.add_argument("-sinceSeconds", type=int, default=0, help="replay history")
    p.add_argument(
        "-maxEvents", type=int, default=0, help="exit after N events (0=follow)"
    )


run_meta_tail.configure = _meta_tail_flags
