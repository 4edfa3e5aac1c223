"""The port's shell against the JAX package's, and its command line.

- ``ec.encode`` issues JAX's RPCs in JAX's order (mark read-only on every
  replica, then generate and mount on the first, then delete every
  replica), checked with a recording environment fed to both shells.
- The shell's own rules: commands that mutate need ``lock``, unknown
  commands raise ``ShellError``, ``-streaming`` is taken (it goes on to the
  master), ``help`` lists what is ported.
- The command line: ``cli master``, two ``cli volume -mserver ... -device
  cpu`` and ``cli shell -c "lock; ec.encode -volumeId 1; unlock"`` as
  subprocesses on localhost; and ``cli volume`` without ``-device cpu``
  refuses to start on a box with no GPU.

Every wait polls a condition with a deadline of at least 30 s."""

from __future__ import annotations

import io
import os
import re
import signal
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

import grpc
import pytest
import torch

from seaweedfs_tpu.shell import command_ec as jax_command_ec
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.shell import SHELL_REGISTRY, ShellError, command_ec, run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv, NotLockedError

from test_torch_ec_read import write_needle_volume

REPO = Path(__file__).resolve().parent.parent


class RecordingEnv:
    """A CommandEnv whose master knows two replicas of every volume and
    whose volume stubs record each call as (address, method, request)."""

    def __init__(self):
        self.calls: list[tuple[str, str, bytes]] = []
        self.lock_token = 1

    def confirm_is_locked(self):
        pass

    def lookup_volume(self, vid):
        return [m_pb.Location(url="10.0.0.1:8080", grpc_port=18080),
                m_pb.Location(url="10.0.0.2:8080", grpc_port=18080)]

    def volume(self, address):
        env = self

        class Stub:
            def __getattr__(self, method):
                def call(request, **_kw):
                    env.calls.append((address, method, request.SerializeToString(deterministic=True)))
                return call

        return Stub()


@pytest.mark.parametrize("code", ["rs", "lrc"])
def test_ec_encode_rpc_order_matches_jax(code):
    traces = []
    for mod in (command_ec, jax_command_ec):
        env = RecordingEnv()
        args = Namespace(dataShards=0, parityShards=0, code=code, localGroups=0)
        mod.do_ec_encode(env, 7, "c", mod._scheme_from_args(args), max_parallelization=1)
        traces.append(env.calls)
    assert traces[0] == traces[1]
    assert [(a, m) for a, m, _ in traces[0]] == [
        ("10.0.0.1:18080", "VolumeMarkReadonly"), ("10.0.0.2:18080", "VolumeMarkReadonly"),
        ("10.0.0.1:18080", "EcShardsGenerate"), ("10.0.0.1:18080", "EcShardsMount"),
        ("10.0.0.1:18080", "VolumeDelete"), ("10.0.0.2:18080", "VolumeDelete")]


def test_shell_rules():
    env = CommandEnv("127.0.0.1:1")
    with pytest.raises(NotLockedError):
        run_command(env, "ec.encode -volumeId 9", io.StringIO())
    with pytest.raises(ShellError, match="unknown command"):
        run_command(env, "volume.list", io.StringIO())
    with pytest.raises(ShellError, match="bad arguments"):
        run_command(env, "ec.rebuild -noSuchFlag", io.StringIO())
    env.lock_token = 1  # as if leased: -streaming is parsed and goes on to the (absent) master
    with pytest.raises(grpc.RpcError):
        run_command(env, "ec.encode -volumeId 9 -streaming", io.StringIO())
    out = io.StringIO()
    run_command(env, "help", out)
    assert sorted(SHELL_REGISTRY) == ["cluster.check", "cluster.ps", "cluster.raft.add",
                                      "cluster.raft.ps", "cluster.raft.remove", "ec.balance",
                                      "ec.decode", "ec.encode", "ec.rebuild", "help", "lock",
                                      "unlock"]
    for name in SHELL_REGISTRY:
        assert name in out.getvalue()


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def _start(args: list[str], pattern: str) -> tuple[subprocess.Popen, re.Match]:
    proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env())
    line = proc.stdout.readline().strip()
    bound = re.search(pattern, line)
    if bound is None:
        proc.kill()
        raise AssertionError((line, proc.stderr.read()))
    return proc, bound


def _stop(proc: subprocess.Popen) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def test_cli_master_volumes_and_shell(tmp_path):
    dirs = [tmp_path / "v0", tmp_path / "v1"]
    for d in dirs:
        d.mkdir()
    write_needle_volume(str(dirs[0]), seed=21, n=150)
    procs = []
    try:
        master, bound = _start(["master", "-port", "0"],
                               r"^master gRPC on (127\.0\.0\.1:\d+), HTTP on 127\.0\.0\.1:\d+$")
        procs.append(master)
        maddr = bound[1]
        for i, d in enumerate(dirs):
            vol, _ = _start(["volume", "-dir", str(d), "-mserver", maddr, "-port", "0",
                             "-rack", f"rack{i}", "-device", "cpu"],
                            r"gRPC on 127\.0\.0\.1:\d+ \(device cpu\)")
            procs.append(vol)
        shell = [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "shell", "-master", maddr,
                 "-c", "lock; ec.encode -volumeId 1; unlock"]
        deadline = time.monotonic() + 60
        while True:  # until both servers' first heartbeats have landed
            run = subprocess.run(shell, capture_output=True, text=True, env=_env(), timeout=120)
            if run.returncode == 0 or time.monotonic() > deadline:
                break
            assert "volume 1 not found" in run.stderr, run.stderr
            time.sleep(0.2)
        assert run.returncode == 0, run.stderr
        assert "ec.encode volume 1 -> RS(10,4)" in run.stdout
        assert "ec.balance moved" in run.stdout and "lock released" in run.stdout
        shards = sorted(n for d in dirs for n in os.listdir(d) if re.fullmatch(r"1\.ec\d\d", n))
        assert shards == [f"1.ec{i:02d}" for i in range(14)]
        assert all(any(re.fullmatch(r"1\.ec\d\d", n) for n in os.listdir(d)) for d in dirs)
        assert not (dirs[0] / "1.dat").exists()
    finally:
        rcs = [_stop(p) for p in reversed(procs)]
    assert rcs == [0] * len(procs), [p.stderr.read() for p in procs]


def test_cli_volume_refuses_to_start_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would start on it")
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume", "-dir", str(tmp_path),
         "-port", "0", "-mserver", "127.0.0.1:1", "-rack", "rack1"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device available" in proc.stderr
    assert "gRPC on" not in proc.stdout
