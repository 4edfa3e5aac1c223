"""The port's volume server EC service against the JAX package's
``VolumeServerGrpcServicer``: each EC method is called on both with the
same request, each server over its own copy of one directory, and the
files (shards, .ecx, .ecj, .vif, the decoded .dat/.idx), the responses and
the abort codes must be identical.  Then one real localhost gRPC round
trip through ``python -m seaweedfs_tpu_torch.cli volume -device cpu``, and
the refusal to start without a GPU unless ``-device cpu`` is given."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import grpc
import pytest
import torch

from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb
from seaweedfs_tpu_torch.server import volume_server

from test_torch_ec_read import write_needle_volume

REPO = Path(__file__).resolve().parent.parent
LOST = [0, 3, 10, 13]


class Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(code, details)
        self.code, self.details = code, details


class Context:
    def abort(self, code, details):
        raise Aborted(code, details)


def _call(servicer, method: str, request):
    """(response or list of streamed responses, None) or (None, (code, details))."""
    try:
        out = getattr(servicer, method)(request, Context())
        if method == "ec_shard_read":
            out = list(out)
        return out, None
    except Aborted as e:
        return None, (e.code, e.details)


def _files(directory: str) -> dict[str, str]:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def pair(tmp_path):
    """A needle volume in two identical directories, one served by the
    JAX servicer and one by the port's (started on the CPU)."""
    src = tmp_path / "src"
    src.mkdir()
    vol = write_needle_volume(str(src), seed=5, n=300, big=4, dead=8)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    shutil.copytree(src, port_dir)
    shutil.copytree(src, ref_dir)
    ref = jax_vs.VolumeServer([str(ref_dir)], "127.0.0.1:1")
    port = volume_server.VolumeServer([str(port_dir)], grpc_port=0, device="cpu")
    port.start()
    try:
        yield (volume_server.VolumeServerGrpcServicer(port), str(port_dir),
               jax_vs.VolumeServerGrpcServicer(ref), str(ref_dir), vol, src)
    finally:
        port.stop()
        ref.stop()  # never started: closes its store and pools


def _both(pair, method: str, request):
    port, port_dir, ref, ref_dir = pair[:4]
    got, want = _call(port, method, request), _call(ref, method, request)
    assert got == want, method
    return got


def _same_files(pair, with_dat: bool = False):
    """Every EC file (and with ``with_dat`` the .dat) identical in both
    directories; the JAX server loads the .dat as a volume, and its needle
    map may add files beside it."""
    def keep(name: str) -> bool:
        return name.split(".")[-1].startswith(("ec", "vif")) or (with_dat and name.endswith(".dat"))

    got = {k: v for k, v in _files(pair[1]).items() if keep(k)}
    assert got == {k: v for k, v in _files(pair[3]).items() if keep(k)}
    return got


def _generate(pair, **geometry):
    req = pb.EcShardsGenerateRequest(volume_id=1, geometry=pb.EcGeometry(**geometry))
    _both(pair, "ec_shards_generate", req)
    return _same_files(pair)


@pytest.mark.parametrize("geometry", [{}, dict(data_shards=10, parity_shards=4, local_groups=2),
                                      dict(data_shards=6, parity_shards=3)],
                         ids=["rs_default", "lrc", "rs_6_3"])
def test_generate_files_identical(pair, geometry):
    files = _generate(pair, **geometry)
    k = geometry.get("data_shards", 10) + geometry.get("parity_shards", 4)
    assert sorted(files) == sorted([f"1.ec{i:02d}" for i in range(k)] + ["1.ecx", "1.vif"])


def test_mount_info_read_delete_rebuild_to_volume(pair):
    vol, src = pair[4], pair[5]
    _generate(pair)
    _both(pair, "ec_shards_mount", pb.EcShardsMountRequest(volume_id=1, shard_ids=range(14)))
    info, _ = _both(pair, "ec_shards_info", pb.EcShardsInfoRequest(volume_id=1))
    assert [s.shard_id for s in info.shards] == list(range(14))
    assert len({s.size for s in info.shards}) == 1
    # streamed reads: 1 MiB chunks, a range past the end, a live file_key
    for shard_id, offset, size in ((0, 0, 100), (5, 7, 1 << 20), (13, 3, 2 << 20), (2, 0, 0)):
        _both(pair, "ec_shard_read",
              pb.EcShardReadRequest(volume_id=1, shard_id=shard_id, offset=offset, size=size))
    live = sorted(vol["live"])
    out, _ = _both(pair, "ec_shard_read",
                   pb.EcShardReadRequest(volume_id=1, shard_id=1, offset=0, size=64,
                                         file_key=live[0]))
    assert not out[0].is_deleted and len(out[0].data) == 64
    # blob delete: the tombstone in the .ecx and the .ecj journal
    for nid in (live[3], live[40], 999):
        _both(pair, "ec_blob_delete", pb.EcBlobDeleteRequest(volume_id=1, file_key=nid))
    files = _same_files(pair)
    assert "1.ecj" in files
    out, _ = _both(pair, "ec_shard_read",
                   pb.EcShardReadRequest(volume_id=1, shard_id=1, offset=0, size=64,
                                         file_key=live[3]))
    assert [r.is_deleted for r in out] == [True]
    # lose four shards, rebuild them (and replay the .ecj into the .ecx)
    before = _same_files(pair)
    _both(pair, "ec_shards_unmount", pb.EcShardsUnmountRequest(volume_id=1, shard_ids=LOST))
    _both(pair, "ec_shards_delete", pb.EcShardsDeleteRequest(volume_id=1, shard_ids=LOST))
    assert not any(f"1.ec{s:02d}" in _same_files(pair) for s in LOST)
    resp, _ = _both(pair, "ec_shards_rebuild", pb.EcShardsRebuildRequest(volume_id=1))
    assert list(resp.rebuilt_shard_ids) == LOST
    after = _same_files(pair)
    # the journal is replayed and dropped; its tombstones were already in
    # the .ecx, written in place by the deletes, and the shards come back
    assert "1.ecj" not in after
    assert after == {k: v for k, v in before.items() if k != "1.ecj"}
    # back to a normal volume, from the data shards
    for d in (pair[1], pair[3]):
        os.remove(os.path.join(d, "1.dat"))
        os.remove(os.path.join(d, "1.idx"))
    _both(pair, "ec_shards_to_volume", pb.EcShardsToVolumeRequest(volume_id=1))
    for name in ("1.dat", "1.idx"):
        with open(os.path.join(pair[1], name), "rb") as a, open(os.path.join(pair[3], name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(pair[1], "1.dat"), "rb") as a, open(os.path.join(src, "1.dat"), "rb") as b:
        assert a.read() == b.read()


def test_lrc_rebuild_and_to_volume_with_missing_data_shards(pair):
    _generate(pair, data_shards=10, parity_shards=4, local_groups=2)
    for d in (pair[1], pair[3]):
        for sid in (3, 7):
            os.remove(os.path.join(d, f"1.ec{sid:02d}"))
    resp, _ = _both(pair, "ec_shards_rebuild",
                    pb.EcShardsRebuildRequest(volume_id=1, target_shard_ids=[3]))
    assert list(resp.rebuilt_shard_ids) == [3]
    _same_files(pair)
    for d in (pair[1], pair[3]):
        os.remove(os.path.join(d, "1.dat"))
    _both(pair, "ec_shards_to_volume", pb.EcShardsToVolumeRequest(volume_id=1))
    files = _same_files(pair, with_dat=True)
    assert "1.ec07" in files


ABORTS = [
    ("ec_shards_generate", pb.EcShardsGenerateRequest(volume_id=9)),
    ("ec_shards_rebuild", pb.EcShardsRebuildRequest(volume_id=9)),
    ("ec_shards_to_volume", pb.EcShardsToVolumeRequest(volume_id=9)),
    ("ec_shards_mount", pb.EcShardsMountRequest(volume_id=9, shard_ids=[0])),
    ("ec_shard_read", pb.EcShardReadRequest(volume_id=9, shard_id=0, size=10)),
    ("ec_blob_delete", pb.EcBlobDeleteRequest(volume_id=9, file_key=1)),
]


@pytest.mark.parametrize("method,request_", ABORTS, ids=[m for m, _ in ABORTS])
def test_abort_codes_and_messages_match_jax(pair, method, request_):
    _out, err = _both(pair, method, request_)
    assert err is not None and err[0] == grpc.StatusCode.NOT_FOUND


def test_unmounted_shard_read_and_empty_info_match_jax(pair):
    _generate(pair)
    _both(pair, "ec_shards_mount", pb.EcShardsMountRequest(volume_id=1, shard_ids=[1, 2]))
    _out, err = _both(pair, "ec_shard_read", pb.EcShardReadRequest(volume_id=1, shard_id=0, size=4))
    assert err[0] == grpc.StatusCode.NOT_FOUND
    info, _ = _both(pair, "ec_shards_info", pb.EcShardsInfoRequest(volume_id=7))
    assert not info.shards
    _both(pair, "ec_shards_unmount", pb.EcShardsUnmountRequest(volume_id=1, shard_ids=[1, 2]))
    info, _ = _both(pair, "ec_shards_info", pb.EcShardsInfoRequest(volume_id=1))
    assert not info.shards


def test_generate_with_targets_is_refused_not_encoded_locally(pair):
    port, port_dir = pair[0], pair[1]
    before = sorted(os.listdir(port_dir))
    _out, err = _call(port, "ec_shards_generate",
                      pb.EcShardsGenerateRequest(volume_id=1, targets=["127.0.0.1:1"] * 14))
    assert err[0] == grpc.StatusCode.UNIMPLEMENTED
    assert sorted(os.listdir(port_dir)) == before


# -- a real server process --------------------------------------------------------


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_grpc_round_trip_through_the_cli_server(tmp_path):
    vol = write_needle_volume(str(tmp_path), seed=9, n=200, big=2, dead=4)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume", "-dir", str(tmp_path),
         "-port", "0", "-metricsPort", "0", "-device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    try:
        line = proc.stdout.readline()
        bound = re.search(r"gRPC on 127\.0\.0\.1:(\d+) \(device cpu\), metrics on "
                          r"127\.0\.0\.1:(\d+)$", line.strip())
        assert bound, (line, proc.stderr.read() if proc.poll() else "")
        grpc_port, metrics_port = int(bound[1]), int(bound[2])
        stub = rpc.volume_stub(f"127.0.0.1:{grpc_port}")
        stub.EcShardsGenerate(pb.EcShardsGenerateRequest(volume_id=1), timeout=120)
        stub.EcShardsMount(pb.EcShardsMountRequest(volume_id=1, shard_ids=range(14)), timeout=30)
        info = stub.EcShardsInfo(pb.EcShardsInfoRequest(volume_id=1), timeout=30)
        assert [s.shard_id for s in info.shards] == list(range(14))
        got = b"".join(r.data for r in stub.EcShardRead(
            pb.EcShardReadRequest(volume_id=1, shard_id=4, offset=10, size=3000), timeout=30))
        with open(tmp_path / "1.ec04", "rb") as f:
            f.seek(10)
            assert got == f.read(3000)
        stub.EcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=1, shard_ids=[3]), timeout=30)
        stub.EcShardsDelete(pb.EcShardsDeleteRequest(volume_id=1, shard_ids=[3]), timeout=30)
        resp = stub.EcShardsRebuild(pb.EcShardsRebuildRequest(volume_id=1), timeout=120)
        assert list(resp.rebuilt_shard_ids) == [3]
        nid = min(vol["live"])
        stub.EcBlobDelete(pb.EcBlobDeleteRequest(volume_id=1, file_key=nid), timeout=30)
        out = list(stub.EcShardRead(pb.EcShardReadRequest(volume_id=1, shard_id=0, size=8,
                                                          file_key=nid), timeout=30))
        assert [r.is_deleted for r in out] == [True]
        with pytest.raises(grpc.RpcError) as err:
            stub.EcShardsCopy(pb.EcShardsCopyRequest(volume_id=1), timeout=30)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'weedtpu_ec_operations_total{op="encode"} 1' in text
        assert 'weedtpu_ec_operations_total{op="rebuild"} 1' in text
        assert "# TYPE weedtpu_ec_sched_cache_total counter" in text
        assert 'weedtpu_repair_bytes_total{code="rs",dir="read",mode="global"}' in text
        # the plain codec on the CPU launches no kernel
        assert 'weedtpu_cuda_kernel_launches{kernel="gf_apply"} 0' in text
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, proc.stderr.read()


def test_server_refuses_to_start_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would start on it")
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume", "-dir", str(tmp_path),
         "-port", "0"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device available" in proc.stderr
    assert "gRPC on" not in proc.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        volume_server.VolumeServer([str(tmp_path)], device=None).start()
