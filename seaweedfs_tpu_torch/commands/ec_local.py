"""Local (offline) EC commands: encode or rebuild a volume in place.

The port of seaweedfs_tpu/commands/ec_local.py's ``ec.encode.local`` and
``ec.rebuild.local``, with the same flags plus ``-device`` (default
``cuda``; ``cpu`` runs the plain PyTorch codec on the host).  Each prints a
summary line and a ``stages:`` line, the JSON stage breakdown of the
pipeline run.
"""

from __future__ import annotations

import json
import os
import time

from seaweedfs_tpu_torch.commands import command


def _base(args) -> str:
    from seaweedfs_tpu_torch.storage.volume import volume_file_name

    return volume_file_name(args.dir, args.collection, args.volume_id)


def _scheme(args):
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme

    return EcScheme(
        data_shards=args.data_shards or DEFAULT_SCHEME.data_shards,
        parity_shards=args.parity_shards or DEFAULT_SCHEME.parity_shards,
    )


def _scheme_for_existing(args, base: str):
    """Scheme for an ALREADY-encoded volume: explicit flags win, else the
    geometry the encode recorded in .vif."""
    if args.data_shards or args.parity_shards:
        return _scheme(args)
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
    from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info

    info = maybe_load_volume_info(base + ".vif")
    if info and info.local_groups:
        raise NotImplementedError(
            f"{base}.vif records an LRC volume; LRC is not ported yet "
            "(ROADMAP.md, 'Still to port': LRC)"
        )
    if info and info.data_shards:
        return EcScheme(info.data_shards, info.parity_shards)
    return _scheme(args)


def _common_flags(p) -> None:
    p.add_argument("-dir", dest="dir", default=".", help="volume directory")
    p.add_argument("-collection", dest="collection", default="")
    p.add_argument(
        "-volumeId", dest="volume_id", type=int, required=True, metavar="VID"
    )
    # 0 = unset: encode takes the 10+4 default; rebuild takes the
    # volume's own .vif geometry (_scheme_for_existing)
    p.add_argument("-dataShards", dest="data_shards", type=int, default=0)
    p.add_argument("-parityShards", dest="parity_shards", type=int, default=0)
    p.add_argument(
        "-device", dest="device", default="cuda",
        help="torch device of the codec: cuda (default) | cpu",
    )


def _print_stages(st: dict) -> None:
    print("stages: " + json.dumps(st, sort_keys=True))


@command("ec.encode.local", "erasure-code a local volume into .ec shards")
def ec_encode_local(args) -> int:
    from seaweedfs_tpu_torch.ops.select import pipeline_codec_for
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import (
        write_ec_files,
        write_sorted_ecx_file,
    )
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

    base = _base(args)
    scheme = _scheme(args)
    codec = pipeline_codec_for(scheme, args.device)  # no device: raise first
    dat_size = os.path.getsize(base + ".dat")
    with open(base + ".dat", "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
    t0 = time.monotonic()
    stats: dict = {}
    write_ec_files(base, scheme, codec=codec, stats=stats)
    write_sorted_ecx_file(base, offset_width=sb.offset_width)
    save_volume_info(
        base + ".vif",
        VolumeInfo(
            version=int(sb.version),
            dat_file_size=dat_size,
            offset_width=sb.offset_width,
            data_shards=scheme.data_shards,
            parity_shards=scheme.parity_shards,
        ),
    )
    dt = time.monotonic() - t0
    print(
        f"encoded {base}.dat ({dat_size} bytes) -> {scheme.total_shards} shards "
        f"in {dt:.2f}s ({dat_size / dt / 1e9:.2f} GB/s) on {codec.device}"
    )
    _print_stages(stats)
    return 0


ec_encode_local.configure = _common_flags


@command("ec.rebuild.local", "rebuild missing .ec shards from survivors")
def ec_rebuild_local(args) -> int:
    from seaweedfs_tpu_torch.ops.select import pipeline_codec_for
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import rebuild_ec_files

    base = _base(args)
    scheme = _scheme_for_existing(args, base)
    codec = pipeline_codec_for(scheme, args.device)
    t0 = time.monotonic()
    stats: dict = {}
    rebuilt = rebuild_ec_files(base, scheme, codec=codec, stats=stats)
    dt = time.monotonic() - t0
    if rebuilt:
        size = os.path.getsize(base + scheme.shard_ext(rebuilt[0]))
        print(
            f"rebuilt shards {rebuilt} ({size} bytes each) in {dt:.2f}s "
            f"({len(rebuilt) * size / dt / 1e9:.2f} GB/s generated) on {codec.device}"
        )
        _print_stages(stats)
    else:
        print("nothing to rebuild")
    return 0


ec_rebuild_local.configure = _common_flags
