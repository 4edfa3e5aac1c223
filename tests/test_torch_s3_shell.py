"""The s3.* shell commands, the port's shell against the JAX package's.

Two port filer servers (memory stores) over one port master hold the same
seeded namespace: buckets with objects, a pending multipart upload's
staging entries.  The JAX shell runs a script of every s3.* command
(bucket list/create/delete, quota and quota.check, clean.uploads,
circuitbreaker, qos, their refusals) against one, the port's shell the
same script against the other: the transcripts are equal.  Then both
shells read one namespace (the one the JAX shell changed) and print the
same; each package's gateway adopts the breaker and QoS documents a shell
wrote alike; and the port's ``s3.configure`` writes the identity document
the JAX shell's does.

Every server binds port 0."""

from __future__ import annotations

import io

import numpy as np
import pytest

from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server import filer_server, master_server
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.wdclient import MasterClient

SCRIPT = """s3.bucket.list
s3.bucket.create -name newb
s3.bucket.create -name b1
s3.bucket.list
s3.bucket.quota -name b1 -sizeMB 1
s3.bucket.quota -name nob -sizeMB 1
s3.bucket.quota -name b2 -sizeMB 0
s3.bucket.quota.check
lock
s3.bucket.quota.check
s3.bucket.list
s3.bucket.quota -name b1 -remove
s3.bucket.quota.check
s3.bucket.quota -name b2 -sizeMB 1
s3.bucket.quota.check
s3.clean.uploads -timeAgoSeconds 3600
s3.clean.uploads -timeAgoSeconds 0
s3.circuitbreaker
s3.circuitbreaker -enable -countWrite 8 -bytesRead 1000
s3.circuitbreaker -bucket b1 -countRead 2 -bytesWrite 4096
s3.circuitbreaker -bucket b2 -countRead 3
s3.circuitbreaker -bucket b2 -delete
s3.circuitbreaker -show
s3.qos
s3.qos -tenant AKID -opsPerSec 5 -burst 10
s3.qos -bucket b1 -quotaMB 2 -quotaObjects 100
s3.qos -opsPerSec 50
s3.qos -bucket b3 -opsPerSec 1
s3.qos -bucket b3 -delete
s3.qos -show
s3.bucket.delete -name newb
s3.bucket.delete -name nob
unlock
s3.bucket.delete -name b2
s3.bucket.list"""


def _populate(filer) -> None:
    rng = np.random.default_rng(95)
    filer.mkdirs("/buckets")
    for b, n in (("b1", 12), ("b2", 3), ("empty", 0)):
        filer.create_entry(Entry(f"/buckets/{b}", is_directory=True, attr=Attr.now(0o755)))
        for i in range(n):
            filer.create_entry(Entry(f"/buckets/{b}/d{i % 3}/k{i}",
                                     content=rng.bytes(int(rng.integers(1000, 200_000))),
                                     attr=Attr.now()))
    up = "/buckets/b1/.uploads/0123456789abcdef0123456789abcdef"
    filer.create_entry(Entry(up, is_directory=True, attr=Attr.now(0o755)))
    filer.create_entry(Entry(f"{up}/0001.part", content=b"p" * 5000, attr=Attr.now()))


@pytest.fixture(scope="module")
def cluster():
    mp = pytest.MonkeyPatch()
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    master = master_server.MasterServer(port=0, grpc_port=0)
    master.start()
    filers = []
    try:
        for _ in range(2):
            fs = filer_server.FilerServer(master.grpc_address, port=0, grpc_port=0)
            fs.start()
            filers.append(fs)
            _populate(RemoteFiler(fs.grpc_address, MasterClient(master.grpc_address)))
        yield master, filers
    finally:
        for fs in filers:
            fs.stop()
        master.stop()
        mp.undo()


def _runner(pkg: str, master_addr: str, filer_addr: str):
    if pkg == "port":
        env, run = CommandEnv(master_addr, filer_grpc_address=filer_addr), run_command
    else:
        env, run = JaxCommandEnv(master_addr, filer_grpc_address=filer_addr), jax_run_command

    def one(line: str) -> str:
        out = io.StringIO()
        try:
            run(env, line, out)
        except Exception as e:  # noqa: BLE001 — the error text is part of the transcript
            out.write(f"error {type(e).__name__}: {e}\n")
        return f"$ {line}\n{out.getvalue()}"

    return one


def test_s3_shell_transcripts_match(cluster):
    master, filers = cluster
    jax = _runner("jax", master.grpc_address, filers[0].grpc_address)
    port = _runner("port", master.grpc_address, filers[1].grpc_address)
    # one after the other: the two shells share the master's admin lock
    want = [jax(line) for line in SCRIPT.splitlines()]
    got = [port(line) for line in SCRIPT.splitlines()]
    for line, g, w in zip(SCRIPT.splitlines(), got, want):
        assert g == w, line
    # one namespace: both shells read what the JAX shell wrote
    for pkg in ("jax", "port"):
        run = _runner(pkg, master.grpc_address, filers[0].grpc_address)
        cluster_out = [run(line) for line in ("s3.bucket.list", "s3.circuitbreaker -show",
                                              "s3.qos -show")]
        if pkg == "jax":
            want = cluster_out
    assert cluster_out == want
    assert "b1\tsize:" in want[0] and '"writeCount": 8' in want[1] and '"AKID"' in want[2]


def test_gateways_adopt_the_shell_documents(cluster):
    """The breaker and QoS documents a shell wrote configure each
    package's gateway alike."""
    master, filers = cluster
    run = _runner("port", master.grpc_address, filers[0].grpc_address)
    run("s3.circuitbreaker -enable -countWrite 4")
    run("s3.qos -tenant AK9 -opsPerSec 7")
    gws = {"port": S3ApiServer(master.grpc_address, port=0, filer=RemoteFiler(
               filers[0].grpc_address, MasterClient(master.grpc_address)),
               lifecycle_sweep_interval=0, chunk_cache_mb=0),
           "jax": JaxS3(master.grpc_address, port=0, filer=JaxRemoteFiler(
               filers[0].grpc_address, JaxMasterClient(master.grpc_address)),
               lifecycle_sweep_interval=0, chunk_cache_mb=0)}
    try:
        snaps = {k: (g.circuit_breaker.snapshot(), g.qos.snapshot()) for k, g in gws.items()}
        assert snaps["port"] == snaps["jax"]
        assert snaps["port"][1]["enabled"] and snaps["port"][1]["tenants"]["AK9"]["ops_per_s"] == 7
    finally:
        for g in gws.values():
            g.stop()


def test_port_s3_configure_is_not_ported(cluster):
    """``s3.configure`` is ported: the same script gives the JAX shell's
    transcript, and the JAX shell reads the identity document the port's
    wrote."""
    master, filers = cluster
    script = ["s3.configure -user alice -actions Read -apply",
              "s3.configure -user alice -access_key AKALICE -secret_key s1 -apply",
              "s3.configure -user bob -actions Read,Write -access_key AKBOB -secret_key s2 -apply",
              "s3.configure -user bob -access_key AKALICE -secret_key s3 -apply",
              "s3.configure -user carol",
              "s3.configure -user alice -access_key AKALICE -isDelete -apply",
              "s3.configure"]
    got = {pkg: [_runner(pkg, master.grpc_address, filers[i].grpc_address)(line)
                 for line in script]
           for i, pkg in enumerate(("jax", "port"))}
    assert got["port"] == got["jax"]
    assert "already belongs to user alice" in got["port"][3]
    assert got["port"][-1].endswith("alice  actions=Read  keys=-\n"
                                    "bob  actions=Read,Write  keys=AKBOB\n")
    cross = _runner("jax", master.grpc_address, filers[1].grpc_address)("s3.configure")
    assert cross == got["port"][-1]
