"""s3.* shell commands: bucket admin, quota, multipart GC, circuit breaker.

Counterparts of the reference's shell/command_s3_bucket_*.go,
command_s3_clean_uploads.go and command_s3_circuitbreaker.go.  Buckets are
directories under /buckets in the filer; quota state and the breaker
config live in filer entries the S3 gateways poll.

The port's copy of seaweedfs_tpu/shell/command_s3.py.  ``s3.configure``
edits the IAM identity document (iam/credentials.py) through
``env.remote_filer()``, the shard router when the shell has a filer list.
"""

from __future__ import annotations

import json
import time

from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.s3.circuit_breaker import CONFIG_PATH as CB_CONFIG_PATH
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.command_fs import _list, _lookup, _walk

BUCKETS_ROOT = "/buckets"


def _bucket_entry(env, name: str):
    e = _lookup(env, f"{BUCKETS_ROOT}/{name}")
    if e is None or not e.is_directory:
        raise RuntimeError(f"bucket {name} does not exist")
    return e


def _update_entry(env, entry) -> None:
    env.remote_filer().update_entry(entry)


@shell_command("s3.bucket.list", "list buckets with sizes")
def cmd_bucket_list(env, args, out):
    for b in sorted(_list(env, BUCKETS_ROOT), key=lambda e: e.name):
        if not b.is_directory:
            continue
        n_files = size = 0
        for e in _walk(env, b.full_path):
            if not e.is_directory:
                n_files += 1
                size += e.size
        quota = b.extended.get("quota_bytes", b"")
        quota_txt = f" quota:{int(quota)}B" if quota else ""
        frozen = " FROZEN" if b.extended.get("quota_readonly") else ""
        print(f"  {b.name}\tsize:{size}\tfile:{n_files}{quota_txt}{frozen}",
              file=out)


@shell_command("s3.bucket.create", "create a bucket")
def cmd_bucket_create(env, args, out):
    if _lookup(env, f"{BUCKETS_ROOT}/{args.name}") is not None:
        raise RuntimeError(f"bucket {args.name} already exists")
    env.remote_filer().create_entry(
        Entry(
            full_path=f"{BUCKETS_ROOT}/{args.name}",
            is_directory=True,
            attr=Attr.now(0o755),
        )
    )
    print(f"created bucket {args.name}", file=out)


cmd_bucket_create.configure = lambda p: p.add_argument("-name", required=True)


@shell_command("s3.bucket.delete", "delete a bucket and all its objects")
def cmd_bucket_delete(env, args, out):
    env.confirm_is_locked()
    _bucket_entry(env, args.name)
    env.remote_filer().delete_entry(
        f"{BUCKETS_ROOT}/{args.name}", recursive=True
    )
    print(f"deleted bucket {args.name}", file=out)


cmd_bucket_delete.configure = lambda p: p.add_argument("-name", required=True)


@shell_command("s3.bucket.quota", "set or clear a bucket's size quota")
def cmd_bucket_quota(env, args, out):
    b = _bucket_entry(env, args.name)
    if args.remove:
        b.extended.pop("quota_bytes", None)
        b.extended.pop("quota_readonly", None)
        _update_entry(env, b)
        print(f"removed quota on {args.name}", file=out)
        return
    if args.sizeMB <= 0:
        raise RuntimeError("-sizeMB must be positive (or use -remove)")
    b.extended["quota_bytes"] = str(args.sizeMB * 1024 * 1024).encode()
    _update_entry(env, b)
    print(f"set quota on {args.name}: {args.sizeMB}MB", file=out)


def _quota_flags(p):
    p.add_argument("-name", required=True)
    p.add_argument("-sizeMB", type=int, default=0)
    p.add_argument("-remove", action="store_true")


cmd_bucket_quota.configure = _quota_flags


@shell_command("s3.bucket.quota.check", "freeze/unfreeze buckets vs quota")
def cmd_bucket_quota_check(env, args, out):
    """Walk each quota'd bucket; over-quota buckets get the
    quota_readonly mark the gateways enforce on writes (reference
    command_s3_bucket_quota_check.go)."""
    env.confirm_is_locked()
    for b in _list(env, BUCKETS_ROOT):
        if not b.is_directory:
            continue
        quota = b.extended.get("quota_bytes")
        if not quota:
            continue
        used = sum(
            e.size for e in _walk(env, b.full_path) if not e.is_directory
        )
        over = used > int(quota)
        frozen = bool(b.extended.get("quota_readonly"))
        state = f"{b.name}: used {used} / quota {int(quota)}"
        if over and not frozen:
            b.extended["quota_readonly"] = b"1"
            _update_entry(env, b)
            print(f"{state} — FREEZING writes", file=out)
        elif not over and frozen:
            b.extended.pop("quota_readonly", None)
            _update_entry(env, b)
            print(f"{state} — unfreezing", file=out)
        else:
            print(f"{state} — {'frozen' if frozen else 'ok'}", file=out)


@shell_command("s3.clean.uploads", "purge stale multipart upload staging")
def cmd_clean_uploads(env, args, out):
    env.confirm_is_locked()
    # weedlint: disable=W005 — compared to upload entry wall-clock mtimes
    cutoff = time.time() - args.timeAgoSeconds
    removed = 0
    for b in _list(env, BUCKETS_ROOT):
        if not b.is_directory:
            continue
        uploads_dir = f"{b.full_path}/.uploads"
        for u in _list(env, uploads_dir):
            if u.attr.crtime > cutoff:
                continue
            try:
                env.remote_filer().delete_entry(u.full_path, recursive=True)
            except (RuntimeError, FileNotFoundError):
                continue
            removed += 1
            print(f"removed stale upload {b.name}/{u.name}", file=out)
    print(f"{removed} stale multipart uploads removed", file=out)


cmd_clean_uploads.configure = lambda p: p.add_argument(
    "-timeAgoSeconds", type=int, default=24 * 3600,
    help="purge uploads started earlier than this",
)


@shell_command("s3.circuitbreaker", "configure S3 gateway request limits")
def cmd_circuitbreaker(env, args, out):
    cfg_entry = _lookup(env, CB_CONFIG_PATH)
    config = {}
    if cfg_entry is not None and cfg_entry.content:
        try:
            config = json.loads(cfg_entry.content)
        except json.JSONDecodeError:
            config = {}

    if args.show or not any(
        (args.enable, args.disable, args.delete,
         args.countRead >= 0, args.countWrite >= 0,
         args.bytesRead >= 0, args.bytesWrite >= 0)
    ):
        print(json.dumps(config, indent=2, sort_keys=True), file=out)
        return

    if args.delete:
        if args.bucket:
            config.get("buckets", {}).pop(args.bucket, None)
        else:
            config = {}
    else:
        scope = (
            config.setdefault("buckets", {}).setdefault(args.bucket, {})
            if args.bucket
            else config.setdefault("global", {})
        )
        if args.enable:
            config.setdefault("global", {})["enabled"] = True
        if args.disable:
            config.setdefault("global", {})["enabled"] = False
        for flag, key in (
            ("countRead", "readCount"), ("countWrite", "writeCount"),
            ("bytesRead", "readBytes"), ("bytesWrite", "writeBytes"),
        ):
            v = getattr(args, flag)
            if v >= 0:
                scope[key] = v

    blob = json.dumps(config, sort_keys=True).encode()
    env.remote_filer().create_entry(
        Entry(full_path=CB_CONFIG_PATH, attr=Attr.now(0o644), content=blob)
    )
    print(json.dumps(config, indent=2, sort_keys=True), file=out)


def _cb_flags(p):
    p.add_argument("-bucket", default="", help="scope to one bucket")
    p.add_argument("-enable", action="store_true")
    p.add_argument("-disable", action="store_true")
    p.add_argument("-delete", action="store_true", help="drop the scope's limits")
    p.add_argument("-show", action="store_true")
    p.add_argument("-countRead", type=int, default=-1)
    p.add_argument("-countWrite", type=int, default=-1)
    p.add_argument("-bytesRead", type=int, default=-1)
    p.add_argument("-bytesWrite", type=int, default=-1)


cmd_circuitbreaker.configure = _cb_flags


from seaweedfs_tpu_torch.util.limiter import QOS_CONFIG_PATH


@shell_command("s3.qos", "configure tenant/bucket QoS (rates + quotas)")
def cmd_s3_qos(env, args, out):
    """Edit /etc/s3/qos.json — the tenant-QoS document every S3 gateway
    polls (util/limiter.TenantQos): per-tenant/bucket token-bucket op
    rates (shed with 429 + Retry-After) and per-bucket quotas enforced
    on the write path.  Without flags, shows the current config."""
    cfg_entry = _lookup(env, QOS_CONFIG_PATH)
    config = {}
    if cfg_entry is not None and cfg_entry.content:
        try:
            config = json.loads(cfg_entry.content)
        except json.JSONDecodeError:
            config = {}

    touched = any(
        (args.delete, args.opsPerSec >= 0, args.burst >= 0,
         args.quotaMB >= 0, args.quotaObjects >= 0)
    )
    if args.show or not touched:
        print(json.dumps(config, indent=2, sort_keys=True), file=out)
        return

    if args.delete:
        if args.bucket:
            config.get("buckets", {}).pop(args.bucket, None)
        elif args.tenant:
            config.get("tenants", {}).pop(args.tenant, None)
        else:
            config = {}
    else:
        if args.bucket:
            scope = config.setdefault("buckets", {}).setdefault(args.bucket, {})
        elif args.tenant:
            scope = config.setdefault("tenants", {}).setdefault(args.tenant, {})
        else:
            scope = config.setdefault("default", {})
        for flag, key, scale in (
            ("opsPerSec", "opsPerSec", 1),
            ("burst", "burst", 1),
            ("quotaMB", "quotaBytes", 1024 * 1024),
            ("quotaObjects", "quotaObjects", 1),
        ):
            v = getattr(args, flag)
            if v >= 0:
                scope[key] = v * scale

    blob = json.dumps(config, sort_keys=True).encode()
    env.remote_filer().create_entry(
        Entry(full_path=QOS_CONFIG_PATH, attr=Attr.now(0o644), content=blob)
    )
    print(json.dumps(config, indent=2, sort_keys=True), file=out)


def _qos_flags(p):
    p.add_argument("-tenant", default="", help="scope to one access key")
    p.add_argument("-bucket", default="", help="scope to one bucket")
    p.add_argument("-delete", action="store_true", help="drop the scope's limits")
    p.add_argument("-show", action="store_true")
    p.add_argument("-opsPerSec", type=float, default=-1)
    p.add_argument("-burst", type=float, default=-1)
    p.add_argument("-quotaMB", type=int, default=-1)
    p.add_argument("-quotaObjects", type=int, default=-1)


cmd_s3_qos.configure = _qos_flags


@shell_command(
    "s3.configure", "manage S3 identities: users, keys, allowed actions"
)
def cmd_s3_configure(env, args, out):
    """Edit the shared identity document (/etc/iam/identities.json) the
    S3 gateways read — the reference's command_s3_configure.go over its
    identities config.  Without -apply the change is shown, not saved."""
    from seaweedfs_tpu_torch.iam.credentials import FilerEtcCredentialStore

    store = FilerEtcCredentialStore(env.remote_filer())
    if args.user and args.apply:
        actions = [a for a in args.actions.split(",") if a]
        if args.isDelete:
            if args.accessKey:
                store.delete_access_key(args.user, args.accessKey)
            else:
                store.delete_user(args.user)
        else:
            try:
                store.create_user(args.user, actions or None)
            except ValueError:  # exists: update actions if given
                if actions:
                    store.set_actions(args.user, actions)
            if args.accessKey:
                if not args.secretKey:
                    raise RuntimeError("-secret_key required with -access_key")
                store.put_access_key(args.user, args.accessKey, args.secretKey)
    elif args.user and not args.apply:
        print("(dry run; pass -apply to persist)", file=out)
    for user in sorted(store.load().values(), key=lambda u: u.name):
        keys = ", ".join(ak for ak, _ in user.keys) or "-"
        print(
            f"{user.name}  actions={','.join(user.actions)}  keys={keys}",
            file=out,
        )


def _s3_configure_flags(p):
    p.add_argument("-user", default="")
    p.add_argument("-actions", default="", help="comma list, e.g. Read,Write")
    p.add_argument("-access_key", dest="accessKey", default="")
    p.add_argument("-secret_key", dest="secretKey", default="")
    p.add_argument("-isDelete", action="store_true")
    p.add_argument("-apply", action="store_true")


cmd_s3_configure.configure = _s3_configure_flags
