"""Local (offline) EC commands: encode, rebuild or decode a volume in place.

The port of seaweedfs_tpu/commands/ec_local.py's ``ec.encode.local``,
``ec.rebuild.local`` and ``ec.decode.local``, with the same flags
(``-code lrc`` / ``-localGroups N`` select the LRC storage class; a
flag-less rebuild or decode reads the class and geometry from the .vif)
plus ``-device`` (default ``cuda``; ``cpu`` runs the plain PyTorch codec on
the host).  Encode and rebuild each print a summary line and a ``stages:``
line, the JSON stage breakdown of the pipeline run.  Decode runs no codec:
both codes are systematic, so it only de-stripes the data shards.
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
    from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme

    groups = args.local_groups
    if args.code == "lrc" and not groups:
        groups = 2
    return make_scheme(args.data_shards, args.parity_shards, groups)


def _scheme_for_existing(args, base: str):
    """Scheme for an ALREADY-encoded volume: explicit flags win, else the
    geometry and storage class the encode recorded in .vif — a flag-less
    rebuild of an LRC volume must not regenerate shards with the RS matrix
    (same sizes, wrong bytes)."""
    if args.data_shards or args.parity_shards or args.code or args.local_groups:
        return _scheme(args)
    from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme
    from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info

    info = maybe_load_volume_info(base + ".vif")
    if info and info.data_shards:
        return make_scheme(info.data_shards, info.parity_shards, info.local_groups)
    return _scheme(args)


def _common_flags(p) -> None:
    p.add_argument("-dir", dest="dir", default=".", help="volume directory")
    p.add_argument("-collection", dest="collection", default="")
    p.add_argument(
        "-volumeId", dest="volume_id", type=int, required=True, metavar="VID"
    )
    # 0 = unset: encode takes the 10+4 default; rebuild and decode take the
    # volume's own .vif geometry (_scheme_for_existing)
    p.add_argument("-dataShards", dest="data_shards", type=int, default=0)
    p.add_argument("-parityShards", dest="parity_shards", type=int, default=0)
    p.add_argument(
        "-code", dest="code", default="", choices=("", "rs", "lrc"),
        help="storage class: rs (default) | lrc",
    )
    p.add_argument(
        "-localGroups", dest="local_groups", type=int, default=0,
        help="LRC local group count l (implies -code lrc)",
    )
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
    from seaweedfs_tpu_torch.storage.erasure_coding.lrc import scheme_local_groups
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
            local_groups=scheme_local_groups(scheme),
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


@command("ec.decode.local", "reassemble a volume .dat from its .ec shards")
def ec_decode_local(args) -> int:
    """De-stripe the data shards into .dat and replay .ecx (+ .ecj) into
    .idx, on the host: no codec and no device work, for RS and LRC alike
    (both are systematic).  ``-device`` is accepted and unused."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_decoder import (
        find_dat_file_size,
        write_dat_file,
        write_idx_file_from_ec_index,
    )
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ec_offset_width

    base = _base(args)
    scheme = _scheme_for_existing(args, base)
    dat_size = find_dat_file_size(base, scheme)
    write_dat_file(base, dat_size, scheme=scheme)
    write_idx_file_from_ec_index(base, offset_width=ec_offset_width(base))
    print(f"decoded {base}.dat ({dat_size} bytes) from {scheme.data_shards} shards")
    return 0


ec_decode_local.configure = _common_flags
