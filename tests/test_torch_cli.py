"""The port's CLI and codec selection against the JAX package's.

``ec.encode.local`` and ``ec.rebuild.local`` with ``-device cpu`` through
the port's ``cli.main`` must leave the same files as ``seaweedfs_tpu.cli``,
for RS and for LRC (``-code lrc`` / ``-localGroups 2``; a flag-less rebuild
takes the storage class from the .vif); without ``-device cpu`` on a
machine with no CUDA device they raise.  The filer's entry points: ``cli
filer`` and ``cli server -filer -device cpu`` as processes, the flags that
wait for later work raising, and ``upload``, ``download`` and
``filer.copy`` against an in-process cluster.  The S3 gateway's: ``cli s3
-filer`` over ``cli filer`` and ``cli server -filer -s3 -device cpu`` as
processes, each taking signed requests and stopping on SIGTERM with rc 0.
"""

from __future__ import annotations

import os
import random
import shutil
import time

import pytest
import torch

from seaweedfs_tpu import cli as jax_cli
from seaweedfs_tpu.storage.erasure_coding.lrc import LrcScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.ops import select
from seaweedfs_tpu_torch.ops.lrc_codec import LrcCPU, LrcCuda, LrcTorch
from seaweedfs_tpu_torch.ops.rs_cpu import ReedSolomonCPU
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


def test_fix_rebuilds_the_idx_as_the_jax_cli(volume_dir, tmp_path, capsys):
    """``cli fix`` (ROADMAP Queue C item 21: the JAX CLI had it, the port's
    refused it as an unknown command) rebuilds a lost .idx from the .dat log
    into the same bytes as the JAX command, and prints the same line."""
    out = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / name
        shutil.copytree(volume_dir, d)
        idx = d / "pics_5.idx"
        idx.unlink()
        assert main(["fix", *_flags(d)]) == 0
        out[name] = (capsys.readouterr().out, idx.read_bytes())
    assert out["jax"] == out["port"]
    assert out["port"][0] == "rebuilt index: 184 live needles\n"
    assert len(out["port"][1]) == 184 * 16  # one 16-byte entry per live needle


def test_missing_volume_is_a_clean_error(tmp_path, capsys):
    assert cli.main(["ec.encode.local", *_flags(tmp_path, "-device", "cpu")]) == 1
    assert "error:" in capsys.readouterr().err
    assert cli.main([]) == 1


def test_codec_selection():
    codec = select.pipeline_codec_for(EcScheme(), device="cpu")
    assert type(codec) is ReedSolomonTorch and codec.device.type == "cpu"
    assert select.bulk_codec(10, 4, device="cpu") is codec  # cached
    assert select.pipeline_codec_for(EcScheme(6, 3), device="cpu").data_shards == 6
    assert type(select.small_read_codec_for(EcScheme())) is ReedSolomonCPU  # native host apply
    # the JAX package's LrcScheme selects the port's LRC codecs too: only
    # local_groups is read
    for scheme in (LrcScheme(), PortLrcScheme()):
        lrc = select.pipeline_codec_for(scheme, device="cpu")
        assert type(lrc) is LrcTorch and lrc.device.type == "cpu"
        assert (lrc.local_groups, lrc.global_parities) == (2, 2)
        small = select.small_read_codec_for(scheme)
        assert type(small) is LrcCPU and (small.local_groups, small.global_parities) == (2, 2)
    if torch.cuda.is_available():
        assert type(select.pipeline_codec_for(EcScheme())) is ReedSolomonCuda
        assert type(select.pipeline_codec_for(PortLrcScheme())) is LrcCuda
    else:
        for scheme in (EcScheme(), PortLrcScheme()):
            with pytest.raises(RuntimeError, match="CUDA"):
                select.pipeline_codec_for(scheme)


# -- the filer's entry points --------------------------------------------------


def _get(addr: str, path: str, method: str = "GET", body: bytes = b""):
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=body or None)
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def test_cli_master_volume_and_filer_processes(tmp_path):
    """``cli master``, ``cli volume -device cpu`` and ``cli filer -db D``
    as processes: an upload, a read and a listing through the filer, and
    each stops on SIGTERM with rc 0.  The filer takes no ``-device``."""
    from test_torch_shell import _start, _stop

    procs = []
    try:
        m, mb = _start(["master", "-port", "0"], r"master gRPC on (127\.0\.0\.1:\d+)")
        procs.append(m)
        (tmp_path / "v").mkdir()
        v, _vb = _start(["volume", "-dir", str(tmp_path / "v"), "-port", "0", "-device", "cpu",
                         "-mserver", mb[1]], r"gRPC on")
        procs.append(v)
        f, fb = _start(["filer", "-master", mb[1], "-port", "0", "-db", str(tmp_path / "db"),
                        "-maxMB", "1"],
                       r"filer on (127\.0\.0\.1:\d+) \(gRPC 127\.0\.0\.1:\d+, store=leveldb\)")
        procs.append(f)
        data = os.urandom(3 * 1024 * 1024 + 5)
        deadline = 60
        while _get(fb[1], "/cli/a.bin", "POST", data)[0] != 201:  # until the first heartbeat
            deadline -= 1
            assert deadline > 0
            time.sleep(0.5)
        assert _get(fb[1], "/cli/a.bin") == (200, data)
        status, body = _get(fb[1], "/cli")
        assert status == 200 and '"FullPath": "/cli/a.bin"' in body.decode()
    finally:
        rcs = [_stop(p) for p in reversed(procs)]
    assert rcs == [0] * len(procs), [p.stderr.read() for p in procs]


def test_cli_server_with_filer_on_the_cpu(tmp_path):
    """``cli server -filer -device cpu``: master, volume server and filer
    in one process take an upload and a read, and stop on SIGTERM."""
    from test_torch_shell import _start, _stop

    proc, bound = _start(["server", "-filer", "-device", "cpu", "-dir", str(tmp_path),
                          "-masterPort", "0", "-port", "0", "-filerPort", "0"],
                         r"server: master .*volume .*device cpu.*filer (127\.0\.0\.1:\d+) ")
    try:
        data = os.urandom(5000)
        deadline = 60
        while _get(bound[1], "/s/x.bin", "POST", data)[0] != 201:
            deadline -= 1
            assert deadline > 0
            time.sleep(0.5)
        assert _get(bound[1], "/s/x.bin") == (200, data)
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stderr.read()


def test_cli_server_needs_a_gpu_without_device_cpu(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        cli.main(["server", "-dir", str(tmp_path), "-masterPort", "0", "-port", "0"])


@pytest.mark.parametrize("argv, ported", [
    (["server", "-s3", "-webdav"], "gpu"), (["server", "-webdav"], "gpu"),
    (["filer", "-notify", "log:/nonexistent-dir/events.jsonl", "-port", "0"], True),
    (["filer", "-tlsCert", "c", "-tlsKey", "k", "-port", "0"], True),
    (["s3", "-workers", "2", "-port", "8334"], 2),
    (["s3", "-tlsCert", "c", "-tlsKey", "k", "-port", "0"], True),
    (["s3", "-filer", "127.0.0.1:1,127.0.0.1:2", "-workers", "2", "-port", "0"], 2)],
    ids=["server-s3", "server-webdav", "filer-notify", "filer-tls", "s3-workers", "s3-tls",
         "s3-filer-list"])
def test_cli_flags_that_wait_for_later_work_raise(argv, ported, capsys, tmp_path):
    """Flags of later work raise "not ported".  ``server -webdav`` is
    ported: like any ``server`` without ``-device cpu`` it reaches the volume
    server, which raises without a CUDA device.  ``-tlsCert``/``-tlsKey`` and
    ``-notify`` are ported: a certificate that cannot be loaded, or a bus
    log that cannot be opened, fails the start loudly (rc 1, the error on
    stderr) instead of serving without it.  ``-workers``
    and a comma list in ``-filer`` are ported: a worker group without a
    fixed ``-port`` or without ``-filer`` is refused with the JAX
    package's message and rc 2, before anything forks."""
    if not ported:
        with pytest.raises(NotImplementedError, match="not ported"):
            cli.main(argv)
        return
    if ported == "gpu":
        _no_cuda()
        with pytest.raises(RuntimeError, match="no CUDA device available"):
            cli.main(argv + ["-dir", str(tmp_path), "-masterPort", "0", "-port", "0",
                             "-filerPort", "0", "-s3Port", "0", "-webdavPort", "0"])
        return
    if ported == 2:
        assert cli.main(argv) == 2
        assert "s3: -workers needs" in capsys.readouterr().err
        return
    assert cli.main(argv) == 1
    assert "error:" in capsys.readouterr().err


def _s3(addr: str, method: str, path: str, body: bytes = b"", access: str = "AKCLI",
        secret: str = "cli-secret"):
    """One request signed by the port's ``client_sign``."""
    import http.client

    from seaweedfs_tpu_torch.s3 import client_sign

    headers = client_sign.sign_headers(method, path, "", addr, body, access, secret)
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_cli_s3_over_cli_filer(tmp_path):
    """``cli s3 -filer`` over ``cli filer`` (and ``cli master``, ``cli
    volume -device cpu``), SigV4 required: a bucket, a signed PUT and GET,
    an unsigned GET refused, and every process stops on SIGTERM with rc 0.
    The gateway takes no ``-device``."""
    from test_torch_shell import _start, _stop

    procs = []
    try:
        m, mb = _start(["master", "-port", "0"], r"master gRPC on (127\.0\.0\.1:\d+)")
        procs.append(m)
        (tmp_path / "v").mkdir()
        v, _vb = _start(["volume", "-dir", str(tmp_path / "v"), "-port", "0", "-device", "cpu",
                         "-mserver", mb[1]], r"gRPC on")
        procs.append(v)
        f, fb = _start(["filer", "-master", mb[1], "-port", "0", "-db", str(tmp_path / "db")],
                       r"filer on (127\.0\.0\.1:\d+) \(gRPC (127\.0\.0\.1:\d+), store=leveldb\)")
        procs.append(f)
        g, gb = _start(["s3", "-master", mb[1], "-filer", fb[2], "-port", "0", "-accessKey",
                        "AKCLI", "-secretKey", "cli-secret", "-cacheMB", "4"],
                       r"s3 gateway on (127\.0\.0\.1:\d+) \(auth=sigv4\)")
        procs.append(g)
        assert _s3(gb[1], "PUT", "/clib")[0] == 200
        data = os.urandom(300_000)
        deadline = 60
        while _s3(gb[1], "PUT", "/clib/a.bin", data)[0] != 200:  # until the first heartbeat
            deadline -= 1
            assert deadline > 0
            time.sleep(0.5)
        assert _s3(gb[1], "GET", "/clib/a.bin") == (200, data)
        assert _get(gb[1], "/clib/a.bin")[0] == 403
        assert _s3(gb[1], "GET", "/clib/a.bin", secret="wrong")[0] == 403
        # the filer serves what the gateway wrote
        assert _get(fb[1], "/buckets/clib/a.bin") == (200, data)
    finally:
        rcs = [_stop(p) for p in reversed(procs)]
    assert rcs == [0] * len(procs), [p.stderr.read() for p in procs]


def test_cli_server_with_s3_on_the_cpu(tmp_path):
    """``cli server -filer -s3 -device cpu``: master, volume server, filer
    and gateway in one process take a signed PUT and GET and stop on
    SIGTERM with rc 0."""
    from test_torch_shell import _start, _stop

    proc, bound = _start(["server", "-filer", "-s3", "-device", "cpu", "-dir", str(tmp_path),
                          "-masterPort", "0", "-port", "0", "-filerPort", "0", "-s3Port", "0",
                          "-s3AccessKey", "AKCLI", "-s3SecretKey", "cli-secret"],
                         r"server: master .*device cpu.*filer .*s3 (127\.0\.0\.1:\d+) \(sigv4\)")
    try:
        assert _s3(bound[1], "PUT", "/one")[0] == 200
        data = os.urandom(70_000)
        deadline = 60
        while _s3(bound[1], "PUT", "/one/x.bin", data)[0] != 200:
            deadline -= 1
            assert deadline > 0
            time.sleep(0.5)
        assert _s3(bound[1], "GET", "/one/x.bin") == (200, data)
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stderr.read()


def test_cli_upload_download_and_filer_copy(tmp_path, capsys):
    """``upload`` prints the JAX command's JSON line per file, ``download``
    fetches the needles back, and ``filer.copy`` puts a local tree into the
    filer namespace."""
    import json

    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    ms = MasterServer(port=0, grpc_port=0)
    ms.start()
    (tmp_path / "v").mkdir()
    vs = VolumeServer([str(tmp_path / "v")], ms.grpc_address, port=0, grpc_port=0,
                      heartbeat_interval=0.2, device="cpu")
    vs.start()
    fs = FilerServer(ms.grpc_address, port=0, grpc_port=0, chunk_size=4096)
    fs.start()
    try:
        deadline = time.monotonic() + 60
        while not ms.topology.nodes:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        src = tmp_path / "src"
        (src / "deep").mkdir(parents=True)
        files = {"a.txt": b"alpha" * 10, "b.bin": os.urandom(9000),
                 "deep/c.bin": os.urandom(20000)}
        for name, data in files.items():
            (src / name).write_bytes(data)
        capsys.readouterr()
        assert cli.main(["upload", "-master", ms.grpc_address, str(src / "a.txt"),
                         str(src / "b.bin")]) == 0
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert [(d["file"], d["size"]) for d in lines] == [("a.txt", 50), ("b.bin", 9000)]
        assert all(set(d) == {"file", "fid", "url", "size"} for d in lines)
        assert cli.main(["download", "-master", ms.grpc_address, "-dir", str(tmp_path / "dl"),
                         *[d["fid"] for d in lines]]) == 0
        for d, name in zip(lines, ("a.txt", "b.bin")):
            assert (tmp_path / "dl" / d["fid"].replace(",", "_")).read_bytes() == files[name]
        assert cli.main(["filer.copy", "-filer", fs.url, "-path", "/copied", str(src)]) == 0
        assert "copied 3 files" in capsys.readouterr().out
        for name, data in files.items():
            assert _get(fs.url, f"/copied/src/{name}") == (200, data)
    finally:
        fs.stop()
        vs.stop()
        ms.stop()
