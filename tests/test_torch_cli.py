"""The port's CLI and codec selection against the JAX package's.

``ec.encode.local`` and ``ec.rebuild.local`` with ``-device cpu`` through
the port's ``cli.main`` must leave the same files as ``seaweedfs_tpu.cli``,
for RS and for LRC (``-code lrc`` / ``-localGroups 2``; a flag-less rebuild
takes the storage class from the .vif); without ``-device cpu`` on a
machine with no CUDA device they raise.
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
from seaweedfs_tpu_torch.ops.lrc_codec import LrcCuda, LrcTorch
from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import LrcScheme as PortLrcScheme
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info


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
    [((), (0, 3, 10, 13)), (("-dataShards", "6", "-parityShards", "3"), (0, 3, 7)),
     (("-code", "lrc"), (3,)), (("-localGroups", "2"), (0, 5, 12, 13)),
     (("-code", "lrc", "-dataShards", "6", "-parityShards", "3"), (1, 4))],
    ids=["rs10_4", "rs6_3", "lrc10_2_2_local", "lrc10_2_2_global", "lrc6_2_1"],
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


def test_without_device_cpu_the_lrc_commands_raise(volume_dir, tmp_path):
    _no_cuda()
    d = tmp_path / "v"
    shutil.copytree(volume_dir, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["ec.encode.local", *_flags(d, "-code", "lrc")])
    assert not any(f.startswith("pics_5.ec") for f in os.listdir(d))
    assert cli.main(["ec.encode.local", *_flags(d, "-code", "lrc", "-device", "cpu")]) == 0
    os.remove(d / "pics_5.ec03")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["ec.rebuild.local", *_flags(d)])  # LRC from the .vif, on the default device
    assert not (d / "pics_5.ec03").exists()


def test_rebuild_of_an_lrc_volume_is_not_ported(volume_dir, tmp_path):
    """A flag-less rebuild of an LRC volume the JAX CLI encoded takes the
    storage class from its .vif and writes the JAX CLI's shards; the RS
    matrix (forced with -code rs) would write other bytes of the same
    size."""
    jd, pd, rd = tmp_path / "jax", tmp_path / "port", tmp_path / "rs"
    shutil.copytree(volume_dir, jd)
    assert jax_cli.main(["ec.encode.local", *_flags(jd, "-localGroups", "2")]) == 0
    info = maybe_load_volume_info(jd / "pics_5.vif")
    assert (info.data_shards, info.parity_shards, info.local_groups) == (10, 4, 2)
    encoded = _files(jd)
    shutil.copytree(jd, pd)
    shutil.copytree(jd, rd)
    lost = (0, 5, 12, 13)
    for d in (jd, pd, rd):
        for sid in lost:
            os.remove(d / f"pics_5.ec{sid:02d}")
    assert jax_cli.main(["ec.rebuild.local", *_flags(jd)]) == 0
    assert cli.main(["ec.rebuild.local", *_flags(pd, "-device", "cpu")]) == 0
    assert _files(pd) == _files(jd) == encoded
    assert cli.main(["ec.rebuild.local", *_flags(rd, "-code", "rs", "-device", "cpu")]) == 0
    wrong = _files(rd)
    for sid in lost:
        name = f"pics_5.ec{sid:02d}"
        assert len(wrong[name]) == len(encoded[name]) and wrong[name] != encoded[name]


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
    # the JAX package's LrcScheme selects the port's LRC codecs too: only
    # local_groups is read
    for scheme in (LrcScheme(), PortLrcScheme()):
        lrc = select.pipeline_codec_for(scheme, device="cpu")
        assert type(lrc) is LrcTorch and lrc.device.type == "cpu"
        assert (lrc.local_groups, lrc.global_parities) == (2, 2)
        small = select.small_read_codec_for(scheme)
        assert type(small) is LrcTorch and small.device.type == "cpu"
    if torch.cuda.is_available():
        assert type(select.pipeline_codec_for(EcScheme())) is ReedSolomonCuda
        assert type(select.pipeline_codec_for(PortLrcScheme())) is LrcCuda
    else:
        for scheme in (EcScheme(), PortLrcScheme()):
            with pytest.raises(RuntimeError, match="CUDA"):
                select.pipeline_codec_for(scheme)
