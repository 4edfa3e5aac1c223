"""The port stands alone: no module of seaweedfs_tpu_torch, and none of
its chip scripts (chip_smoke.py, chip_table_variants.py), imports jax or
anything of the JAX package, names a path into the JAX package's native
library (``seaweedfs_tpu/native``), or loads that library at run time; and
its maintenance plane (``cli admin``, ``cli worker``), its file gateways
(``cli webdav``, ``cli sftp``, ``cli mount``) and its message queue
(``cli mq.broker``) never initialise CUDA."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu")


def port_sources() -> list[Path]:
    return sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + sorted(REPO.glob("chip_*.py"))


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_scan_finds_the_port():
    names = {p.relative_to(REPO).as_posix() for p in port_sources()}
    assert {"chip_smoke.py", "chip_table_variants.py", "chip_phase.py", "seaweedfs_tpu_torch/ops/rs_cuda.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/ec_encoder.py",
            "seaweedfs_tpu_torch/ops/lrc_matrix.py", "seaweedfs_tpu_torch/ops/lrc_codec.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/lrc.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/ec_decoder.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/ec_volume.py",
            "seaweedfs_tpu_torch/parallel/__init__.py", "seaweedfs_tpu_torch/parallel/mesh.py",
            "seaweedfs_tpu_torch/parallel/gf2.py", "seaweedfs_tpu_torch/parallel/distributed_ec.py",
            "seaweedfs_tpu_torch/stats/__init__.py", "seaweedfs_tpu_torch/stats/plane.py",
            "seaweedfs_tpu_torch/util/__init__.py", "seaweedfs_tpu_torch/util/limiter.py",
            "seaweedfs_tpu_torch/ops/repair_budget.py",
            "seaweedfs_tpu_torch/ops/sched_cache.py",
            "seaweedfs_tpu_torch/util/crc32c.py", "seaweedfs_tpu_torch/util/wlog.py",
            "seaweedfs_tpu_torch/storage/needle.py", "seaweedfs_tpu_torch/storage/store.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/ec_locate.py",
            "seaweedfs_tpu_torch/storage/erasure_coding/shard_bits.py",
            "seaweedfs_tpu_torch/server/store_ec.py",
            "seaweedfs_tpu_torch/server/volume_server.py", "seaweedfs_tpu_torch/rpc.py",
            "seaweedfs_tpu_torch/pb/volume_server_pb2.py",
            "seaweedfs_tpu_torch/commands/servers.py",
            "seaweedfs_tpu_torch/commands/version.py",
            "seaweedfs_tpu_torch/pb/master_pb2.py", "seaweedfs_tpu_torch/storage/volume.py",
            "seaweedfs_tpu_torch/storage/backend.py", "seaweedfs_tpu_torch/storage/needle_map.py",
            "seaweedfs_tpu_torch/topology/topology.py", "seaweedfs_tpu_torch/util/resilience.py",
            "seaweedfs_tpu_torch/server/master_server.py", "seaweedfs_tpu_torch/shell/__init__.py",
            "seaweedfs_tpu_torch/shell/command_env.py", "seaweedfs_tpu_torch/shell/ec_common.py",
            "seaweedfs_tpu_torch/shell/command_ec_balance.py",
            "seaweedfs_tpu_torch/shell/command_ec.py", "seaweedfs_tpu_torch/shell/command_volume.py",
            "seaweedfs_tpu_torch/commands/shell_cmd.py",
            "seaweedfs_tpu_torch/security/__init__.py", "seaweedfs_tpu_torch/security/jwt.py",
            "seaweedfs_tpu_torch/wdclient/__init__.py", "seaweedfs_tpu_torch/images/__init__.py",
            "seaweedfs_tpu_torch/images/resize.py", "seaweedfs_tpu_torch/util/httpd.py",
            "seaweedfs_tpu_torch/util/http_pool.py", "seaweedfs_tpu_torch/util/http_range.py",
            "seaweedfs_tpu_torch/storage/compression.py",
            "seaweedfs_tpu_torch/commands/benchmark_cmd.py",
            "seaweedfs_tpu_torch/cluster/__init__.py", "seaweedfs_tpu_torch/cluster/raft.py",
            "seaweedfs_tpu_torch/cluster/election.py", "seaweedfs_tpu_torch/cluster/registry.py",
            "seaweedfs_tpu_torch/shell/command_cluster.py",
            "seaweedfs_tpu_torch/filer/redis_store.py", "seaweedfs_tpu_torch/filer/nosql_stores.py",
            "seaweedfs_tpu_torch/filer/sql_stores.py", "seaweedfs_tpu_torch/filer/duck.py",
            "seaweedfs_tpu_torch/replication/__init__.py",
            "seaweedfs_tpu_torch/replication/notification.py",
            "seaweedfs_tpu_torch/replication/replicator.py",
            "seaweedfs_tpu_torch/replication/sink.py", "seaweedfs_tpu_torch/replication/sync.py",
            "seaweedfs_tpu_torch/commands/sync_cmd.py", "seaweedfs_tpu_torch/mount/__init__.py",
            "seaweedfs_tpu_torch/mount/filer_client.py",
            "seaweedfs_tpu_torch/remote_storage/__init__.py",
            "seaweedfs_tpu_torch/remote_storage/client.py",
            "seaweedfs_tpu_torch/remote_storage/mount.py",
            "seaweedfs_tpu_torch/shell/command_remote.py",
            "seaweedfs_tpu_torch/stats/events.py", "seaweedfs_tpu_torch/storage/vacuum.py",
            "seaweedfs_tpu_torch/storage/scrub.py",
            "seaweedfs_tpu_torch/shell/command_volume_ops.py",
            "seaweedfs_tpu_torch/shell/command_volume_balance.py",
            "seaweedfs_tpu_torch/shell/command_volume_check.py",
            "seaweedfs_tpu_torch/shell/command_volume_scrub.py",
            "seaweedfs_tpu_torch/shell/command_volume_repair.py",
            "seaweedfs_tpu_torch/util/lsm.py", "seaweedfs_tpu_torch/ops/gf256_native.py",
            "seaweedfs_tpu_torch/ops/rs_cpu.py", "seaweedfs_tpu_torch/commands/tier_cmd.py",
            "seaweedfs_tpu_torch/commands/backup_cmd.py",
            "seaweedfs_tpu_torch/pb/filer_pb2.py", "seaweedfs_tpu_torch/util/btree.py",
            "seaweedfs_tpu_torch/filer/__init__.py", "seaweedfs_tpu_torch/filer/entry.py",
            "seaweedfs_tpu_torch/filer/filechunks.py", "seaweedfs_tpu_torch/filer/filerstore.py",
            "seaweedfs_tpu_torch/filer/leveldb_store.py", "seaweedfs_tpu_torch/filer/meta_log.py",
            "seaweedfs_tpu_torch/filer/filer.py", "seaweedfs_tpu_torch/filer/manifest.py",
            "seaweedfs_tpu_torch/filer/upload.py", "seaweedfs_tpu_torch/filer/reader.py",
            "seaweedfs_tpu_torch/filer/filer_conf.py", "seaweedfs_tpu_torch/filer/remote.py",
            "seaweedfs_tpu_torch/server/filer_server.py", "seaweedfs_tpu_torch/shell/command_fs.py",
            "seaweedfs_tpu_torch/commands/client_cmd.py",
            "seaweedfs_tpu_torch/s3/__init__.py", "seaweedfs_tpu_torch/s3/s3_server.py",
            "seaweedfs_tpu_torch/s3/auth.py", "seaweedfs_tpu_torch/s3/client_sign.py",
            "seaweedfs_tpu_torch/s3/sigv2.py", "seaweedfs_tpu_torch/s3/acl.py",
            "seaweedfs_tpu_torch/s3/policy.py", "seaweedfs_tpu_torch/s3/cors.py",
            "seaweedfs_tpu_torch/s3/sse.py", "seaweedfs_tpu_torch/s3/circuit_breaker.py",
            "seaweedfs_tpu_torch/util/chunk_cache.py", "seaweedfs_tpu_torch/filer/entry_cache.py",
            "seaweedfs_tpu_torch/filer/meta_subscriber.py",
            "seaweedfs_tpu_torch/security/kms.py",
            "seaweedfs_tpu_torch/shell/command_s3.py",
            "seaweedfs_tpu_torch/stats/trace.py", "seaweedfs_tpu_torch/stats/sketch.py",
            "seaweedfs_tpu_torch/stats/cluster_agg.py", "seaweedfs_tpu_torch/util/faults.py",
            "seaweedfs_tpu_torch/util/slo.py", "seaweedfs_tpu_torch/util/debugz.py",
            "seaweedfs_tpu_torch/security/tls.py", "seaweedfs_tpu_torch/commands/tls_cmd.py",
            "seaweedfs_tpu_torch/shell/command_trace.py",
            "seaweedfs_tpu_torch/shell/command_slo.py",
            "seaweedfs_tpu_torch/shell/command_resilience.py",
            "seaweedfs_tpu_torch/filer/shard_ring.py", "seaweedfs_tpu_torch/filer/inval_bus.py",
            "seaweedfs_tpu_torch/shell/command_filer_shard.py",
            "seaweedfs_tpu_torch/iam/__init__.py", "seaweedfs_tpu_torch/iam/credentials.py",
            "seaweedfs_tpu_torch/iam/iam_api.py", "seaweedfs_tpu_torch/commands/gateway_cmd.py",
            "seaweedfs_tpu_torch/s3/post_policy.py", "seaweedfs_tpu_torch/query/__init__.py",
            "seaweedfs_tpu_torch/query/select.py", "seaweedfs_tpu_torch/admin/__init__.py",
            "seaweedfs_tpu_torch/admin/tasks.py", "seaweedfs_tpu_torch/admin/scanner.py",
            "seaweedfs_tpu_torch/admin/worker.py", "seaweedfs_tpu_torch/admin/resources.py",
            "seaweedfs_tpu_torch/admin/dashboard.py", "seaweedfs_tpu_torch/admin/admin_server.py",
            "seaweedfs_tpu_torch/commands/admin_cmd.py",
            "seaweedfs_tpu_torch/native/__init__.py", "seaweedfs_tpu_torch/native/dataplane.py",
            "seaweedfs_tpu_torch/filer/splice.py", "seaweedfs_tpu_torch/mount/page_writer.py",
            "seaweedfs_tpu_torch/mount/meta_cache.py", "seaweedfs_tpu_torch/mount/weedfs.py",
            "seaweedfs_tpu_torch/mount/fuse_adapter.py", "seaweedfs_tpu_torch/commands/mount_cmd.py",
            "seaweedfs_tpu_torch/server/webdav_server.py", "seaweedfs_tpu_torch/sftpd/__init__.py",
            "seaweedfs_tpu_torch/sftpd/sftp_adapter.py", "seaweedfs_tpu_torch/pb/mq_pb2.py",
            "seaweedfs_tpu_torch/mq/__init__.py", "seaweedfs_tpu_torch/mq/balancer.py",
            "seaweedfs_tpu_torch/mq/schema.py", "seaweedfs_tpu_torch/mq/log_store.py",
            "seaweedfs_tpu_torch/mq/tier.py", "seaweedfs_tpu_torch/mq/groups.py",
            "seaweedfs_tpu_torch/mq/broker.py", "seaweedfs_tpu_torch/mq/agent.py",
            "seaweedfs_tpu_torch/commands/mq_cmd.py", "seaweedfs_tpu_torch/shell/command_mq.py",
            "seaweedfs_tpu_torch/util/config.py", "seaweedfs_tpu_torch/commands/config_cmd.py",
            "seaweedfs_tpu_torch/cluster/telemetry.py",
            "seaweedfs_tpu_torch/cluster/telemetry_server.py"} <= names


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


_JAX_NATIVE = ("seaweedfs_tpu/native", "lib_seaweed_native")


def _code_strings(tree: ast.AST) -> list[str]:
    """Every string constant of a module but its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_path_into_the_jax_native_library(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [s for s in _code_strings(tree) if any(j in s for j in _JAX_NATIVE)]
    assert not bad, f"{path.name} names the JAX package's native library: {bad}"


def test_the_native_path_scan_catches_one():
    tree = ast.parse('"""seaweedfs_tpu/native is the JAX one."""\n'
                     'import ctypes\nctypes.CDLL("seaweedfs_tpu/native/lib_seaweed_native.so")\n')
    assert [s for s in _code_strings(tree) if any(j in s for j in _JAX_NATIVE)] == [
        "seaweedfs_tpu/native/lib_seaweed_native.so"]


def test_the_data_plane_loads_only_the_port_library(tmp_path):
    """A fresh interpreter starts a port volume server with the native plane
    on (the default) and loads the splice verbs: the process maps the
    port's own build of csrc/dp.cpp and never the JAX package's library."""
    script = textwrap.dedent(f"""
        import os
        os.environ.pop("SEAWEEDFS_TPU_NATIVE_DP", None)
        os.environ.pop("SEAWEEDFS_TPU_NATIVE_PX", None)
        from seaweedfs_tpu_torch.native import dataplane
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        vs = VolumeServer([{str(tmp_path)!r}], "", port=0, grpc_port=0, device="cpu")
        vs.start()
        assert vs._dp is not None and dataplane.px_lib() is not None
        maps = open("/proc/self/maps").read()
        vs.stop()
        print("PORT", "build/kernels/libdp-" in maps)
        print("JAX", any(j in maps for j in {_JAX_NATIVE!r}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PORT True" in proc.stdout and "JAX False" in proc.stdout


def test_the_scan_catches_a_forbidden_import():
    tree = ast.parse("import jax.numpy\nfrom seaweedfs_tpu.ops import gf256\n"
                     "importlib.import_module('jax')\n")
    assert [n.split(".")[0] for n in _imported(tree)] == ["jax", "seaweedfs_tpu", "jax"]


def test_importing_the_port_and_encoding_loads_no_jax(tmp_path):
    """A fresh interpreter imports every module of the port and runs a CPU
    encode and rebuild through the CLI; jax and seaweedfs_tpu never load."""
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        import numpy as np
        import seaweedfs_tpu_torch
        for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch."):
            importlib.import_module(m.name)
        from seaweedfs_tpu_torch import cli
        d = {str(tmp_path)!r}
        with open(os.path.join(d, "1.dat"), "wb") as f:
            f.write(bytes([3, 0, 0, 0, 0, 0, 0, 0]) + np.random.default_rng(0).bytes(300_000))
        open(os.path.join(d, "1.idx"), "wb").close()
        assert cli.main(["ec.encode.local", "-dir", d, "-volumeId", "1", "-device", "cpu"]) == 0
        os.remove(os.path.join(d, "1.ec11"))
        assert cli.main(["ec.rebuild.local", "-dir", d, "-volumeId", "1", "-device", "cpu"]) == 0
        os.remove(os.path.join(d, "1.dat"))
        assert cli.main(["ec.decode.local", "-dir", d, "-volumeId", "1"]) == 0
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu"))
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["1.dat", "1.idx", "1.ecx", "1.vif"] + [f"1.ec{i:02d}" for i in range(14)])


def test_admin_and_worker_initialise_no_cuda(tmp_path):
    """The maintenance plane never touches CUDA: a fresh interpreter imports
    seaweedfs_tpu_torch.admin, runs ``cli worker -h`` and ``cli admin -h``,
    starts an AdminServer and a Worker (against a master nobody serves),
    lets the worker poll and stops both; torch.cuda's lazy initialisation
    is never called."""
    script = textwrap.dedent("""
        import sys, time
        import torch
        calls = []
        real = torch.cuda._lazy_init
        torch.cuda._lazy_init = lambda: calls.append(1) or real()
        import seaweedfs_tpu_torch.admin as admin
        from seaweedfs_tpu_torch import cli
        for argv in (["worker", "-h"], ["admin", "-h"]):
            try:
                cli.main(argv)
            except SystemExit as e:
                assert e.code == 0, e.code
        srv = admin.AdminServer("127.0.0.1:1", port=0, password="pw")
        srv.start()
        w = admin.Worker("127.0.0.1:1", admin_address=srv.url, poll_interval=0.1,
                         http_auth=("admin", "pw"))
        w.start()
        time.sleep(1.0)
        w.stop()
        srv.stop()
        assert list(srv.status()["workers_seen_ago"]) == [w.worker_id]
        print("CUDA", calls, torch.cuda.is_initialized())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CUDA [] False" in proc.stdout


def test_gateways_and_broker_initialise_no_cuda(tmp_path):
    """The file gateways and the message queue never touch CUDA: a fresh
    interpreter runs ``cli webdav -h`` and ``cli mq.broker -h``, lets ``cli
    sftp`` and ``cli mount`` refuse without paramiko and FUSE (rc 1), starts
    a WebDavServer and an MqBroker (against a master and a filer nobody
    serves), publishes nothing and stops both; torch.cuda's lazy
    initialisation is never called."""
    script = textwrap.dedent(f"""
        import torch
        calls = []
        real = torch.cuda._lazy_init
        torch.cuda._lazy_init = lambda: calls.append(1) or real()
        from seaweedfs_tpu_torch import cli
        from seaweedfs_tpu_torch.mq import MqBroker
        from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
        for argv in (["webdav", "-h"], ["mq.broker", "-h"]):
            try:
                cli.main(argv)
            except SystemExit as e:
                assert e.code == 0, e.code
        assert cli.main(["sftp"]) == 1
        assert cli.main(["mount", "-dir", {str(tmp_path / "mnt")!r}]) == 1
        dav = WebDavServer("127.0.0.1:1", "127.0.0.1:1", port=0)
        dav.start()
        b = MqBroker({str(tmp_path / "mq")!r}, "127.0.0.1:1", register_interval=0.1)
        b.start()
        b.stop()
        dav.stop()
        print("CUDA", calls, torch.cuda.is_initialized())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CUDA [] False" in proc.stdout
