"""The port stands alone: no module of seaweedfs_tpu_torch, and none of
its chip scripts (chip_smoke.py, chip_table_variants.py), imports jax or
anything of the JAX package."""

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
    assert {"chip_smoke.py", "chip_table_variants.py", "seaweedfs_tpu_torch/ops/rs_cuda.py",
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
            "seaweedfs_tpu_torch/shell/command_cluster.py"} <= names


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


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
