"""Client-side CLI tools: upload, download, filer.copy.  The port's copy of
seaweedfs_tpu/commands/client_cmd.py; they run no kernel and take no
device.

Counterparts of the reference's weed/command/{upload,download,filer_copy}.go:
one-shot clients that talk to the cluster the way external apps do —
assign + POST to volume servers for blobs, filer HTTP for tree copies.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("upload", "upload local files as needles; prints one fid per file")
def run_upload(args) -> int:
    import json
    import os

    from seaweedfs_tpu_torch.filer.upload import save_blob
    from seaweedfs_tpu_torch.wdclient import MasterClient

    mc = MasterClient(args.master)
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        try:
            fid = save_blob(
                mc,
                data,
                collection=args.collection,
                replication=args.replication,
                ttl_seconds=args.ttl,
                disk_type=args.disk,
            )
        except IOError as e:
            raise SystemExit(f"{path}: {e}") from e
        print(
            json.dumps(
                {
                    "file": os.path.basename(path),
                    "fid": fid,
                    "url": f"http://{mc.lookup_file_id(fid)}/{fid}",
                    "size": len(data),
                },
                separators=(",", ":"),
            )
        )
    return 0


def _upload_flags(p):
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", type=int, default=0, help="seconds")
    p.add_argument("-disk", default="", help="disk type (default hdd)")
    p.add_argument("files", nargs="+")


run_upload.configure = _upload_flags


@command("download", "fetch needles by fid into local files")
def run_download(args) -> int:
    import os

    from seaweedfs_tpu_torch.util.http_pool import shared_pool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    mc = MasterClient(args.master)
    os.makedirs(args.dir, exist_ok=True)
    for fid in args.fids:
        url = mc.lookup_file_id(fid)
        status, body = shared_pool().request(url, "GET", f"/{fid}", timeout=60)
        if status != 200:
            raise SystemExit(f"{fid}: HTTP {status} from {url}")
        dest = os.path.join(args.dir, fid.replace(",", "_"))
        with open(dest, "wb") as f:
            f.write(body)
        print(f"{fid} -> {dest} ({len(body)} bytes)")
    return 0


def _download_flags(p):
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC")
    p.add_argument("-dir", default=".", help="destination directory")
    p.add_argument("fids", nargs="+")


run_download.configure = _download_flags


@command("filer.copy", "copy local files/trees into the filer namespace")
def run_filer_copy(args) -> int:
    import os

    copied = 0
    for src in args.files:
        if os.path.isdir(src):
            base = os.path.basename(os.path.normpath(src))
            for root, _dirs, names in os.walk(src):
                rel = os.path.relpath(root, src)
                for name in sorted(names):
                    local = os.path.join(root, name)
                    remote = "/".join(
                        p for p in (
                            args.path.rstrip("/"), base,
                            "" if rel == "." else rel, name,
                        ) if p
                    )
                    _copy_one(args.filer, local, "/" + remote.lstrip("/"))
                    copied += 1
        else:
            remote = args.path.rstrip("/") + "/" + os.path.basename(src)
            _copy_one(args.filer, src, "/" + remote.lstrip("/"))
            copied += 1
    print(f"copied {copied} files to {args.filer}{args.path}")
    return 0


def _copy_one(filer_http: str, local: str, remote: str) -> None:
    from urllib.parse import quote

    from seaweedfs_tpu_torch.util.http_pool import shared_pool

    with open(local, "rb") as f:
        data = f.read()
    # spaces/%/#/non-ASCII in names must ride the request line encoded
    status, _body = shared_pool().request(
        filer_http, "POST", quote(remote), body=data, timeout=120
    )
    if status not in (200, 201):
        raise SystemExit(f"{local} -> {remote}: HTTP {status}")


def _filer_copy_flags(p):
    p.add_argument("-filer", default="127.0.0.1:8888", help="filer HTTP address")
    p.add_argument("-path", default="/", help="destination directory in the filer")
    p.add_argument("files", nargs="+", help="local files or directories")


run_filer_copy.configure = _filer_copy_flags
