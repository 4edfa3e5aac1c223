"""The port's CLI and codec selection against the JAX package's.

``ec.encode.local`` and ``ec.rebuild.local`` with ``-device cpu`` through
the port's ``cli.main`` must leave the same files as ``seaweedfs_tpu.cli``;
without ``-device cpu`` on a machine with no CUDA device they raise.
"""

from __future__ import annotations

import os
import random
import shutil

import pytest
import torch

from seaweedfs_tpu import cli as jax_cli
from seaweedfs_tpu.storage.erasure_coding.lrc import LrcScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.ops import select
from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vol")
    rng = random.Random(7)
    v = Volume(d, vid=5, collection="pics")
    for i in range(200):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 4000)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    for i in range(0, 200, 13):
        v.delete_needle(i + 1)
    v.close()
    return d


def _files(d) -> dict[str, bytes]:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _flags(d, *extra):
    return ["-dir", str(d), "-collection", "pics", "-volumeId", "5", *extra]


def _no_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")


@pytest.mark.parametrize(
    "geometry,lost",
    [((), (0, 3, 10, 13)), (("-dataShards", "6", "-parityShards", "3"), (0, 3, 7))],
    ids=["rs10_4", "rs6_3"],
)
def test_encode_and_rebuild_match_jax_cli(volume_dir, tmp_path, geometry, lost, capsys):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(volume_dir, jd)
    shutil.copytree(volume_dir, pd)
    assert jax_cli.main(["ec.encode.local", *_flags(jd, *geometry)]) == 0
    assert cli.main(["ec.encode.local", *_flags(pd, *geometry), "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "stages: {" in out
    assert _files(pd) == _files(jd)
    encoded = _files(pd)
    for d in (jd, pd):
        for sid in lost:  # data and parity shards, as many as the code tolerates
            os.remove(os.path.join(d, f"pics_5.ec{sid:02d}"))
    # rebuild takes the geometry from the .vif the encode wrote
    assert jax_cli.main(["ec.rebuild.local", *_flags(jd)]) == 0
    assert cli.main(["ec.rebuild.local", *_flags(pd), "-device", "cpu"]) == 0
    assert _files(pd) == _files(jd) == encoded
    assert cli.main(["ec.rebuild.local", *_flags(pd), "-device", "cpu"]) == 0
    assert "nothing to rebuild" in capsys.readouterr().out


def test_without_device_cpu_the_commands_raise(volume_dir, tmp_path):
    _no_cuda()
    d = tmp_path / "v"
    shutil.copytree(volume_dir, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["ec.encode.local", *_flags(d)])
    assert not any(f.startswith("pics_5.ec") for f in os.listdir(d))  # nothing written
    assert cli.main(["ec.encode.local", *_flags(d, "-device", "cpu")]) == 0
    os.remove(d / "pics_5.ec02")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["ec.rebuild.local", *_flags(d)])
    assert not (d / "pics_5.ec02").exists()


def test_rebuild_of_an_lrc_volume_is_not_ported(volume_dir, tmp_path):
    d = tmp_path / "v"
    shutil.copytree(volume_dir, d)
    save_volume_info(d / "pics_5.vif", VolumeInfo(data_shards=10, parity_shards=4, local_groups=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["ec.rebuild.local", *_flags(d, "-device", "cpu")])


def test_missing_volume_is_a_clean_error(tmp_path, capsys):
    assert cli.main(["ec.encode.local", *_flags(tmp_path, "-device", "cpu")]) == 1
    assert "error:" in capsys.readouterr().err
    assert cli.main([]) == 1


def test_codec_selection():
    codec = select.pipeline_codec_for(EcScheme(), device="cpu")
    assert type(codec) is ReedSolomonTorch and codec.device.type == "cpu"
    assert select.bulk_codec(10, 4, device="cpu") is codec  # cached
    assert select.pipeline_codec_for(EcScheme(6, 3), device="cpu").data_shards == 6
    assert select.small_read_codec_for(EcScheme()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select.pipeline_codec_for(LrcScheme(), device="cpu")
    with pytest.raises(NotImplementedError):
        select.small_read_codec_for(LrcScheme())
    if torch.cuda.is_available():
        assert type(select.pipeline_codec_for(EcScheme())) is ReedSolomonCuda
    else:
        with pytest.raises(RuntimeError):
            select.pipeline_codec_for(EcScheme())
