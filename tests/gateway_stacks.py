"""One small cluster per package for the gateway and message-queue tests
(test_torch_mount.py, test_torch_webdav.py, test_torch_mq.py,
test_torch_mq_cluster.py): a master, one volume server (the port's with
``device="cpu"``; the JAX one on its Python data plane) and a filer, all
on port 0, built by the named package's own modules."""

from __future__ import annotations

import http.client
import importlib
import os
import shutil
import tempfile
import time

import pytest

WAIT_S = 60.0
PACKAGES = {"port": "seaweedfs_tpu_torch", "jax": "seaweedfs_tpu"}


def wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def http_req(addr: str, method: str, path: str, body=b"", headers=None, timeout=30.0):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def pkg(name: str, module: str):
    """``seaweedfs_tpu_torch.<module>`` or ``seaweedfs_tpu.<module>``."""
    return importlib.import_module(f"{PACKAGES[name]}.{module}")


def isolated_env() -> pytest.MonkeyPatch:
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    return mp


class Stack:
    """master + one volume server + filer of one package."""

    def __init__(self, name: str, root: str, *, chunk_size: int = 64 * 1024,
                 volume_mb: int = 64, manifest_batch: int | None = None):
        self.name = name
        self.dir = os.path.join(root, f"{name}-vol")
        os.makedirs(self.dir)
        ms = pkg(name, "server.master_server")
        vs_mod = pkg(name, "server.volume_server")
        fs_mod = pkg(name, "server.filer_server")
        self.master = ms.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=volume_mb)
        self.master.start()
        kw = {"device": "cpu"} if name == "port" else {}
        self.vs = vs_mod.VolumeServer([self.dir], self.master.grpc_address, port=0,
                                      grpc_port=0, heartbeat_interval=0.2, **kw)
        self.vs.start()
        wait(lambda: len(self.master.topology.nodes) == 1, f"{name} heartbeat")
        fkw = {} if manifest_batch is None else {"manifest_batch": manifest_batch}
        self.filer = fs_mod.FilerServer(self.master.grpc_address, port=0, grpc_port=0,
                                        chunk_size=chunk_size, **fkw)
        self.filer.start()

    def stop(self) -> None:
        self.filer.stop()
        self.vs.stop()
        self.master.stop()


def stacks_fixture(prefix: str, **kw):
    """A module-scoped generator of {"port": Stack, "jax": Stack}."""
    mp = isolated_env()
    root = tempfile.mkdtemp(prefix=prefix)
    made = {}
    try:
        for name in ("port", "jax"):
            made[name] = Stack(name, root, **kw)
        yield made
    finally:
        for s in made.values():
            s.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)
