"""The port's EC pipeline against the JAX package's, file for file.

A real volume (built with the JAX package's Volume) is encoded by both
packages at a small geometry (large blocks 4096, small 1024) so that large
segments, small batches and a zero-padded tail all run.  Shards, .ecx and
.vif must be byte-identical, and a 4-shard loss must rebuild across the two
packages in both directions.  The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ops.rs_jax import ReedSolomonJax
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec
from seaweedfs_tpu.storage.erasure_coding.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.storage.volume_info import VolumeInfo as JaxVolumeInfo
from seaweedfs_tpu.storage.volume_info import save_volume_info as jax_save_vif
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.storage.volume_info import (
    VolumeInfo,
    maybe_load_volume_info,
    save_volume_info,
)

GEOM = dict(data_shards=10, parity_shards=4, large_block_size=4096, small_block_size=1024)
SCHEME = EcScheme(**GEOM)
JAX_SCHEME = JaxScheme(**GEOM)
LOST = (0, 3, 10, 13)  # 2 data + 2 parity


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    """A volume of ~150 KB: three 40 KB large rows, then small rows and a
    tail; some needles deleted so the .idx carries tombstones."""
    d = tmp_path_factory.mktemp("vol")
    rng = random.Random(42)
    v = Volume(d, vid=1)
    for i in range(300):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 900)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    for i in range(0, 300, 17):
        v.delete_needle(i + 1)
    v.close()
    return d


def _copy(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst / "1")


def _files(base: str) -> dict[str, bytes]:
    d = os.path.dirname(base)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_plan_tasks_match():
    for size in (0, 1, 4095, 40960, 40961, 150_001, 400_000):
        for chunk in (512, 2048, 1 << 20):
            got = ec_encoder._plan_tasks(SCHEME, size, chunk)
            want = jax_ec._plan_tasks(JAX_SCHEME, size, chunk)
            assert [type(t).__name__ for t in got] == [type(t).__name__ for t in want]
            assert [vars(t) for t in got] == [vars(t) for t in want]
    assert SCHEME.shard_file_size(150_001) == JAX_SCHEME.shard_file_size(150_001)


@pytest.mark.parametrize("chunk", [2048, 1 << 20], ids=["split-large", "batched-small"])
def test_encode_files_identical_to_jax(volume_dir, tmp_path, chunk):
    jb = _copy(volume_dir, tmp_path / "jax")
    pb = _copy(volume_dir, tmp_path / "port")
    dat_size = os.path.getsize(jb + ".dat")
    assert dat_size > 3 * 10 * 4096  # large rows run
    assert ec_encoder._plan_tasks(SCHEME, dat_size, chunk)[-1].__class__.__name__ == "_SmallBatch"
    jax_ec.write_ec_files(jb, JAX_SCHEME, codec=ReedSolomonJax(10, 4), chunk=chunk)
    jax_ec.write_sorted_ecx_file(jb)
    jax_save_vif(jb + ".vif", JaxVolumeInfo(dat_file_size=dat_size, data_shards=10, parity_shards=4))
    stats: dict = {}
    ec_encoder.write_ec_files(pb, SCHEME, chunk=chunk, stats=stats, device="cpu")
    ec_encoder.write_sorted_ecx_file(pb)
    save_volume_info(pb + ".vif", VolumeInfo(dat_file_size=dat_size, data_shards=10, parity_shards=4))
    assert _files(pb) == _files(jb)
    assert stats["engine"] == "ReedSolomonTorch" and stats["data_bytes"] == dat_size
    for key in ("read_s", "dispatch_s", "fetch_s", "write_s", "wall_s"):
        assert stats[key] >= 0.0
    info = maybe_load_volume_info(pb + ".vif")
    assert (info.dat_file_size, info.data_shards, info.parity_shards) == (dat_size, 10, 4)


def test_encode_through_sinks(volume_dir, tmp_path):
    class MemSink:
        def __init__(self):
            self.buf = bytearray()
            self.closed = False

        def write_at(self, offset, data):
            data = bytes(data)
            if len(self.buf) < offset + len(data):
                self.buf.extend(b"\0" * (offset + len(data) - len(self.buf)))
            self.buf[offset : offset + len(data)] = data

        def close(self):
            self.closed = True

        def abort(self):
            raise AssertionError("aborted")

    jb = _copy(volume_dir, tmp_path / "jax")
    jax_ec.write_ec_files(jb, JAX_SCHEME, codec=ReedSolomonJax(10, 4), chunk=4096)
    sinks = [MemSink() for _ in range(14)]
    ec_encoder.write_ec_files(str(volume_dir / "1"), SCHEME, chunk=4096, sinks=sinks, device="cpu")
    for sid, sink in enumerate(sinks):
        assert sink.closed
        assert bytes(sink.buf) == open(jb + SCHEME.shard_ext(sid), "rb").read()
    with pytest.raises(ValueError, match="sinks"):
        ec_encoder.write_ec_files(str(volume_dir / "1"), SCHEME, sinks=sinks[:3], device="cpu")


def _drop(base: str, lost=LOST) -> dict[int, bytes]:
    kept = {}
    for sid in lost:
        path = base + SCHEME.shard_ext(sid)
        kept[sid] = open(path, "rb").read()
        os.remove(path)
    return kept


@pytest.mark.parametrize("chunk", [3001, 1 << 20])
def test_port_rebuilds_shards_jax_encoded(volume_dir, tmp_path, chunk):
    base = _copy(volume_dir, tmp_path / "v")
    jax_ec.write_ec_files(base, JAX_SCHEME, codec=ReedSolomonJax(10, 4))
    lost = _drop(base)
    stats: dict = {}
    rebuilt = ec_encoder.rebuild_ec_files(base, SCHEME, chunk=chunk, stats=stats, device="cpu")
    assert rebuilt == sorted(LOST)
    for sid, want in lost.items():
        assert open(base + SCHEME.shard_ext(sid), "rb").read() == want
    # the same accounting as the JAX pipeline's
    _drop(base)
    jax_stats: dict = {}
    jax_ec.rebuild_ec_files(base, JAX_SCHEME, codec=ReedSolomonJax(10, 4), stats=jax_stats)
    for key in ("read_bytes", "written_bytes", "mode", "inputs"):
        assert stats[key] == jax_stats[key], key
    assert ec_encoder.rebuild_ec_files(base, SCHEME, device="cpu") == []


def test_jax_rebuilds_shards_port_encoded(volume_dir, tmp_path):
    base = _copy(volume_dir, tmp_path / "v")
    ec_encoder.write_ec_files(base, SCHEME, device="cpu")
    lost = _drop(base)
    assert jax_ec.rebuild_ec_files(base, JAX_SCHEME, codec=ReedSolomonJax(10, 4)) == sorted(LOST)
    for sid, want in lost.items():
        assert open(base + SCHEME.shard_ext(sid), "rb").read() == want


def test_rebuild_targets_and_unrepairable(volume_dir, tmp_path):
    base = _copy(volume_dir, tmp_path / "v")
    ec_encoder.write_ec_files(base, SCHEME, device="cpu")
    lost = _drop(base)
    codec = ReedSolomonTorch(10, 4, device="cpu")
    assert ec_encoder.rebuild_ec_files(base, SCHEME, codec=codec, targets=[3]) == [3]
    assert open(base + ".ec03", "rb").read() == lost[3]
    assert not os.path.exists(base + ".ec00")
    _drop(base, (1, 2, 3))  # 7 lost in all: beyond RS(10,4)
    with pytest.raises(ValueError, match="unrepairable"):
        ec_encoder.rebuild_ec_files(base, SCHEME, codec=codec)


def test_sorted_ecx_strict_on_torn_idx(volume_dir, tmp_path):
    base = _copy(volume_dir, tmp_path / "v")
    with open(base + ".idx", "ab") as f:
        f.write(b"\x01\x02\x03")
    with pytest.raises(ValueError, match="truncated"):
        ec_encoder.write_sorted_ecx_file(base)


@pytest.mark.parametrize("offset_width", [4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_ecx_matches_jax_on_random_logs(tmp_path, offset_width, seed):
    """The bulk .idx replay against the JAX package's MemDb replay: ids
    written, overwritten, deleted (zero offset or tombstone size) and
    written again, in any order; the last entry of an id decides."""
    from seaweedfs_tpu.storage.types import pack_index_entry

    rng = np.random.default_rng([seed, offset_width])
    ids = rng.integers(1, 1 << 63, 300, dtype=np.uint64)
    ids[:3] = [1, (1 << 64) - 1, 1 << 63]  # the ends of the key space sort as unsigned
    log = []
    for _ in range(3000):
        nid = int(rng.choice(ids))
        kind = rng.integers(0, 4)
        if kind == 0:
            log.append(pack_index_entry(nid, 0, -1, offset_width))  # tombstone
        elif kind == 1:
            log.append(pack_index_entry(nid, 0, int(rng.integers(1, 1 << 20)), offset_width))
        else:
            off = 8 * int(rng.integers(1, 1 << (8 * offset_width)))
            log.append(pack_index_entry(nid, off, int(rng.integers(0, 1 << 30)), offset_width))
    for d in ("port", "ref"):
        os.mkdir(tmp_path / d)
        (tmp_path / d / "1.idx").write_bytes(b"".join(log))
    ec_encoder.write_sorted_ecx_file(str(tmp_path / "port" / "1"), offset_width=offset_width)
    jax_ec.write_sorted_ecx_file(str(tmp_path / "ref" / "1"), offset_width=offset_width)
    got = (tmp_path / "port" / "1.ecx").read_bytes()
    assert got == (tmp_path / "ref" / "1.ecx").read_bytes()
    assert 0 < len(got) < 300 * (12 + offset_width)


def test_sorted_ecx_of_an_empty_idx(tmp_path):
    (tmp_path / "1.idx").write_bytes(b"")
    ec_encoder.write_sorted_ecx_file(str(tmp_path / "1"))
    assert (tmp_path / "1.ecx").read_bytes() == b""


def test_preadv_padded_zero_fills_past_eof(tmp_path, monkeypatch):
    path = tmp_path / "f"
    payload = bytes(range(200))
    path.write_bytes(payload)
    monkeypatch.setattr(ec_encoder, "_IOV_MAX", 3)  # several preadv groups
    bufs = [np.full(37, 0xAA, np.uint8) for _ in range(8)]
    with open(path, "rb") as f:
        ec_encoder._preadv_padded(f.fileno(), bufs, 50)
    got = b"".join(b.tobytes() for b in bufs)
    assert got == payload[50:] + b"\0" * (8 * 37 - 150)


def test_storage_formats_match_jax():
    from seaweedfs_tpu.storage import super_block as jax_sb
    from seaweedfs_tpu.storage import types as jax_types
    from seaweedfs_tpu.storage import volume_info as jax_vif
    from seaweedfs_tpu_torch.storage import super_block, types

    for raw in (bytes([3, 0, 0, 0, 0, 0, 0, 0]), bytes([2, 12, 5, 3, 0, 9, 5, 0xFF]),
                bytes([3, 1, 0, 0, 1, 2, 0, 7])):
        got, want = super_block.SuperBlock.from_bytes(raw), jax_sb.SuperBlock.from_bytes(raw)
        assert (int(got.version), got.replica_placement.to_byte(), got.ttl,
                got.compaction_revision, got.offset_width) == (
            int(want.version), want.replica_placement.to_byte(), want.ttl,
            want.compaction_revision, want.offset_width)
        assert got.to_bytes() == want.to_bytes()
    for width in (4, 5):
        entry = types.pack_index_entry(2**40 + 7, 8 * 123456789, -1, width)
        assert entry == jax_types.pack_index_entry(2**40 + 7, 8 * 123456789, -1, width)
        assert types.unpack_index_entry(entry) == jax_types.unpack_index_entry(entry)
    info = dict(version=3, replication="010", dat_file_size=123, offset_width=5,
                data_shards=6, parity_shards=3, remote={"backend": "s3"})
    assert VolumeInfo(**info).to_json() == jax_vif.VolumeInfo(**info).to_json()
    assert VolumeInfo.from_json(VolumeInfo(**info).to_json()) == VolumeInfo(**info)
