"""The port's ``ec.decode.local`` and EC decoder against the JAX package's.

A real volume (written with the JAX package's Volume, with deletions) is
encoded by the JAX CLI as RS(10,4) and as LRC(10,2,2); the port's decode
and the JAX decode must then write byte-identical .dat and .idx, with and
without .ecj tombstones.  The decoder's row geometry is held at the exact
k x large-block boundary (small block sizes), and its error paths (a torn
.ecx, a missing data shard) against the JAX package's.  Decode runs no
codec, so nothing here needs a device.
"""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import cli as jax_cli
from seaweedfs_tpu.storage.erasure_coding import ec_decoder as jax_dec
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec
from seaweedfs_tpu.storage.erasure_coding.ec_volume import ec_offset_width as jax_offset_width
from seaweedfs_tpu.storage.erasure_coding.lrc import LrcScheme as JaxLrcScheme
from seaweedfs_tpu.storage.erasure_coding.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.types import Version as JaxVersion
from seaweedfs_tpu.storage.types import get_actual_size as jax_actual_size
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder, ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ec_offset_width
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import LrcScheme
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

CODES = {"rs": (), "lrc": ("-code", "lrc")}


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """{code: directory} of one volume encoded by the JAX CLI as RS and as
    LRC; the originals' bytes under "dat" / "idx"."""
    src = tmp_path_factory.mktemp("vol")
    rng = random.Random(11)
    v = Volume(src, vid=5, collection="pics")
    for i in range(250):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 3000)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    for i in range(0, 250, 9):
        v.delete_needle(i + 1)
    v.close()
    out = {"dat": (src / "pics_5.dat").read_bytes()}
    for code, flags in CODES.items():
        d = tmp_path_factory.mktemp(code)
        shutil.copytree(src, d, dirs_exist_ok=True)
        assert jax_cli.main(["ec.encode.local", *_flags(d, *flags)]) == 0
        out[code] = d
    return out


def _flags(d, *extra):
    return ["-dir", str(d), "-collection", "pics", "-volumeId", "5", *extra]


def _decoded(d) -> tuple[bytes, bytes]:
    return (d / "pics_5.dat").read_bytes(), (d / "pics_5.idx").read_bytes()


@pytest.mark.parametrize("tombstones", [False, True], ids=["no-ecj", "ecj"])
@pytest.mark.parametrize("code", sorted(CODES))
def test_decode_matches_jax_cli(encoded, tmp_path, code, tombstones, capsys):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    for d in (jd, pd):
        shutil.copytree(encoded[code], d)
        for ext in (".dat", ".idx"):
            os.remove(d / f"pics_5{ext}")
        if tombstones:  # 3 deleted ids and a torn 3-byte tail, which is ignored
            ids = b"".join(n.to_bytes(8, "big") for n in (2, 40, 10**12))
            (d / "pics_5.ecj").write_bytes(ids + b"\x01\x02\x03")
        # the data shards alone suffice: parity shards are not read
        for sid in (10, 11, 12, 13):
            os.remove(d / f"pics_5.ec{sid:02d}")
    assert jax_cli.main(["ec.decode.local", *_flags(jd)]) == 0
    before = rs_cuda.launches
    assert cli.main(["ec.decode.local", *_flags(pd)]) == 0  # -device defaults to cuda, unused
    assert rs_cuda.launches == before
    out = capsys.readouterr().out
    assert "decoded" in out and "from 10 shards" in out and "cuda" not in out
    dat, idx = _decoded(pd)
    assert (dat, idx) == _decoded(jd)
    assert encoded["dat"].startswith(dat) and len(dat) > 0.9 * len(encoded["dat"])
    ecx = (pd / "pics_5.ecx").read_bytes()
    if tombstones:
        tail = b"".join(types.pack_index_entry(n, 0, types.TOMBSTONE_FILE_SIZE)
                        for n in (2, 40, 10**12))
        assert idx == ecx + tail
    else:
        assert idx == ecx
    assert not any(f.endswith(".tmp") for f in os.listdir(pd))


def test_decode_after_an_lrc_rebuild_restores_the_volume(encoded, tmp_path):
    """Rebuild a local and a global LRC loss with the port, then decode: the
    .dat is the JAX decode's."""
    d = tmp_path / "v"
    shutil.copytree(encoded["lrc"], d)
    jax_dat = tmp_path / "j"
    shutil.copytree(encoded["lrc"], jax_dat)
    assert jax_cli.main(["ec.decode.local", *_flags(jax_dat)]) == 0
    for lost in [(3,), (0, 5, 12, 13)]:
        for sid in lost:
            os.remove(d / f"pics_5.ec{sid:02d}")
        assert cli.main(["ec.rebuild.local", *_flags(d, "-device", "cpu")]) == 0
    os.remove(d / "pics_5.dat")
    assert cli.main(["ec.decode.local", *_flags(d, "-device", "cpu")]) == 0
    assert _decoded(d) == _decoded(jax_dat)


GEOMS = {
    "rs3_2": (EcScheme(3, 2, 4096, 1024), JaxScheme(3, 2, 4096, 1024)),
    "lrc4_3": (LrcScheme(4, 3, 4096, 1024, local_groups=2),
               JaxLrcScheme(4, 3, 4096, 1024, local_groups=2)),
}


@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("rows", [(1, 0), (2, 0), (1, 1), (1, -1), (0, 5000), (0, 1024)],
                         ids=["1-large-row", "2-large-rows", "past", "short", "5000", "small-row"])
def test_roundtrip_at_the_large_row_boundary(tmp_path, geom, rows):
    """A .dat of exactly n x k x large_block bytes is laid out as small rows
    (strict `>`): the port's encode and decode round-trip it, and the JAX
    decoder reassembles the port's shards identically."""
    scheme, jax_scheme = GEOMS[geom]
    n_large, extra = rows
    size = n_large * scheme.data_shards * scheme.large_block_size + extra
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    base = str(tmp_path / "9")
    with open(base + ".dat", "wb") as f:
        f.write(payload)
    ec_encoder.write_ec_files(base, scheme, chunk=4096, device="cpu")
    os.remove(base + ".dat")
    ec_decoder.write_dat_file(base, size, scheme=scheme)
    assert open(base + ".dat", "rb").read() == payload
    os.remove(base + ".dat")
    jax_dec.write_dat_file(base, size, scheme=jax_scheme)
    assert open(base + ".dat", "rb").read() == payload
    if n_large and not extra:  # the last whole large row went as small rows
        kinds = [type(t).__name__ for t in ec_encoder._plan_tasks(scheme, size, 4096)]
        assert kinds.count("_LargeSeg") == n_large - 1 and kinds[-1] == "_SmallBatch"


def test_dat_size_and_versions_match_jax(encoded, tmp_path):
    base = str(encoded["rs"] / "pics_5")
    assert ec_decoder.find_dat_file_size(base) == jax_dec.find_dat_file_size(base)
    assert ec_decoder.read_ec_volume_version(base) == jax_dec.read_ec_volume_version(base) == 3
    for size in (0, 1, 7, 100, 4095):
        for version in (1, 2, 3):
            assert types.get_actual_size(size, types.Version(version)) == jax_actual_size(
                size, JaxVersion(version))
            assert types.get_actual_size(size, types.Version(version)) % 8 == 0


def test_torn_ecx_raises_as_in_jax(encoded, tmp_path):
    d = tmp_path / "v"
    shutil.copytree(encoded["rs"], d)
    with open(d / "pics_5.ecx", "ab") as f:
        f.write(b"\x00" * 5)
    base = str(d / "pics_5")
    with pytest.raises(ValueError, match="truncated"):
        ec_decoder.find_dat_file_size(base)
    with pytest.raises(ValueError, match="truncated"):
        jax_dec.find_dat_file_size(base)
    os.remove(d / "pics_5.dat")
    assert cli.main(["ec.decode.local", *_flags(d, "-device", "cpu")]) == 1
    assert not os.path.exists(d / "pics_5.dat")


def test_missing_data_shard_is_a_clean_error(encoded, tmp_path, capsys):
    for sid in (0, 4):
        for pkg in ("jax", "port"):
            d = tmp_path / f"{pkg}{sid}"
            shutil.copytree(encoded["lrc"], d)
            os.remove(d / "pics_5.dat")
            os.remove(d / f"pics_5.ec{sid:02d}")
            main = jax_cli.main if pkg == "jax" else cli.main
            assert main(["ec.decode.local", *_flags(d)]) == 1
            assert "No such file" in capsys.readouterr().err
            assert sorted(f for f in os.listdir(d) if f.startswith("pics_5.dat")) == []
    with pytest.raises(ValueError, match="need 10 data shard files"):
        ec_decoder.write_dat_file(str(tmp_path / "x"), 10, shard_file_names=["a"])


def test_offset_width_matches_jax(tmp_path):
    base = str(tmp_path / "3")
    assert ec_offset_width(base) == jax_offset_width(base) == 4  # nothing on disk
    with open(base + ".ec00", "wb") as f:
        f.write(SuperBlock(offset_width=5).to_bytes() + b"\0" * 8)
    assert ec_offset_width(base) == jax_offset_width(base) == 5  # from the superblock
    save_volume_info(base + ".vif", VolumeInfo(offset_width=4))
    assert ec_offset_width(base) == jax_offset_width(base) == 4  # the .vif wins
    info = VolumeInfo(offset_width=5)
    assert ec_offset_width(base, info) == 5


def test_write_idx_of_a_width_5_volume_matches_jax(tmp_path):
    base = str(tmp_path / "2")
    entries = [types.pack_index_entry(n, 8 * n, 100 + n, 5) for n in range(1, 40)]
    (tmp_path / "2.ecx").write_bytes(b"".join(entries))
    (tmp_path / "2.ecj").write_bytes((7).to_bytes(8, "big"))
    ec_decoder.write_idx_file_from_ec_index(base, offset_width=5)
    port = (tmp_path / "2.idx").read_bytes()
    jax_dec.write_idx_file_from_ec_index(base, offset_width=5)
    assert port == (tmp_path / "2.idx").read_bytes()
    assert len(port) == 40 * 17


def test_encode_of_the_jax_ecx_sorted_and_decoded(encoded, tmp_path):
    """The port's .ecx of the same volume equals the JAX CLI's, so either
    package's decode replays the same .idx."""
    d = tmp_path / "v"
    shutil.copytree(encoded["rs"], d)
    base = str(d / "pics_5")
    want = (d / "pics_5.ecx").read_bytes()
    os.remove(base + ".ecx")
    ec_encoder.write_sorted_ecx_file(base)
    assert (d / "pics_5.ecx").read_bytes() == want
    jax_ec.write_sorted_ecx_file(base)
    assert (d / "pics_5.ecx").read_bytes() == want
