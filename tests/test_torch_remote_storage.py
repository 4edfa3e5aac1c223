"""The port's remote storage (seaweedfs_tpu_torch/remote_storage/,
mount/filer_client.py, filer/duck.py and the shell's remote.* commands)
held against the JAX package's.

One port cluster on the CPU (a master, a ``device="cpu"`` volume server
and a filer) serves both packages: each package's functions and shell run
the same lifecycle (mount, meta.sync, cache, uncache, unmount) over its own
``FilerClient`` into a directory of its own, and the placeholders'
extended attributes, the cached bytes and the printed text must be equal
(the directory names substituted).  The tolerance is byte equality; entry
mtimes and fids are not compared.
"""

from __future__ import annotations

import http.client
import io
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.mount.filer_client import FilerClient as JaxFilerClient
from seaweedfs_tpu.remote_storage import client as jax_client
from seaweedfs_tpu.remote_storage import mount as jax_mount
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu_torch.filer import duck
from seaweedfs_tpu_torch.mount import FilerClient
from seaweedfs_tpu_torch.remote_storage import client as rclient
from seaweedfs_tpu_torch.remote_storage import mount as rmount
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv

WAIT_S = 60.0


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _get(addr: str, path: str):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def cluster():
    from seaweedfs_tpu_torch.server import filer_server, master_server, volume_server

    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    d = tempfile.mkdtemp(prefix="torch-remote-")
    master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.start()
    vs = volume_server.VolumeServer([d], master.grpc_address, port=0, grpc_port=0,
                                    heartbeat_interval=0.2, device="cpu", scrub_interval_s=0)
    vs.start()
    _wait(lambda: len(master.topology.nodes) == 1, "the heartbeat")
    fs = filer_server.FilerServer(master.grpc_address, port=0, grpc_port=0,
                                  chunk_size=64 * 1024)
    fs.start()
    yield master, fs
    fs.stop()
    vs.stop()
    master.stop()
    shutil.rmtree(d, ignore_errors=True)
    mp.undo()


def _bucket(root: str, seed: int, n: int = 12) -> dict:
    """A seeded local 'bucket' of objects, some nested, one > 64 KiB."""
    rng = np.random.default_rng(seed)
    objs = {}
    for i in range(n):
        key = f"{['a', 'b/c', 'docs'][i % 3]}/o{i}.bin"
        objs[key] = rng.bytes(int(rng.integers(1, 4096)) if i else 150_000)
    for key, data in objs.items():
        p = os.path.join(root, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fh:
            fh.write(data)
    return objs


# -- the client ---------------------------------------------------------------------


def test_local_client_lists_and_reads_as_jax(tmp_path):
    objs = _bucket(str(tmp_path / "b"), 1)
    port, jax = rclient.LocalDirRemoteClient(str(tmp_path / "b")), \
        jax_client.LocalDirRemoteClient(str(tmp_path / "b"))
    for prefix in ("", "b/", "docs/o", "zz"):
        assert ([(o.key, o.size, o.mtime) for o in port.list_objects(prefix)]
                == [(o.key, o.size, o.mtime) for o in jax.list_objects(prefix)])
    for key, data in objs.items():
        assert port.read_object(key) == jax.read_object(key) == data
        assert port.read_object(key, 1, 3) == jax.read_object(key, 1, 3) == data[1:4]
    port.write_object("new/x", b"x")
    port.delete_object("a/o0.bin")
    port.delete_object("absent")
    assert [o.key for o in port.list_objects()] == [o.key for o in jax.list_objects()]
    assert "new/x" in [o.key for o in jax.list_objects()]


@pytest.mark.parametrize("key", ["../../etc/passwd", "/../x", "a/../../x"])
def test_key_that_escapes_the_remote_root_is_refused_alike(tmp_path, key):
    outcomes = []
    for mod in (rclient, jax_client):
        c = mod.LocalDirRemoteClient(str(tmp_path / "root"))
        for call in (lambda: c.read_object(key), lambda: c.write_object(key, b"x")):
            with pytest.raises(ValueError) as e:
                call()
            outcomes.append(str(e.value))
    assert outcomes[:2] == outcomes[2:]
    assert not (tmp_path / "x").exists()


def test_make_client_answers_as_jax(tmp_path):
    for spec in (f"local:{tmp_path}", "s3:bucket", "gcs:x", "nothing"):
        out = []
        for mod in (rclient, jax_client):
            try:
                out.append(type(mod.make_client(spec)).__name__)
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], spec


# -- the lifecycle through each package's functions --------------------------------


def _placeholders(fc, d: str) -> dict:
    """{path relative to d: (extended attrs, chunk sizes, content)}."""
    out = {}
    stack = [d]
    while stack:
        for e in duck.list_all(fc, stack.pop()):
            if e.is_directory:
                stack.append(e.full_path)
            else:
                out[e.full_path[len(d) + 1:]] = (dict(e.extended),
                                                 sorted(c.size for c in e.chunks),
                                                 bytes(e.content))
    return out


def test_mount_cache_uncache_lifecycle_as_jax(cluster, tmp_path):
    master, fs = cluster
    root = str(tmp_path / "bucket")
    objs = _bucket(root, 2)
    sides = {"port": (rmount, FilerClient(fs.grpc_address, master.grpc_address),
                      rclient.LocalDirRemoteClient(root)),
             "jax": (jax_mount, JaxFilerClient(fs.grpc_address, master.grpc_address),
                     jax_client.LocalDirRemoteClient(root))}
    seen = {}
    for name, (mod, fc, client) in sides.items():
        d = f"/life-{name}"
        steps = [mod.mount_remote(fc, client, d, f"local:{root}", prefix="")]
        steps.append(mod.mount_config(fc, d))
        steps.append(_placeholders(fc, d))
        steps.append(mod.cache_entry(fc, client, f"{d}/a/o0.bin"))
        steps.append(mod.cache_entry(fc, client, f"{d}/a/o0.bin"))  # already cached: 0
        steps.append(_placeholders(fc, d))
        steps.append(mod.uncache_entry(fc, f"{d}/a/o0.bin"))
        steps.append(mod.uncache_entry(fc, f"{d}/a/o0.bin"))  # was not cached: False
        steps.append(mod.cache_tree(fc, client, d))
        steps.append(_placeholders(fc, d))
        with pytest.raises(FileNotFoundError):
            mod.cache_entry(fc, client, f"{d}/absent")
        seen[name] = steps
    assert seen["port"] == seen["jax"]
    # the cached bytes read back through the filer
    for key, data in objs.items():
        assert _get(fs.url, f"/life-port/{key}") == (200, data), key
    assert seen["port"][0] == len(objs)
    assert seen["port"][1] == {"client": f"local:{root}", "prefix": ""}
    assert seen["port"][3] == len(objs["a/o0.bin"]) and seen["port"][4] == 0


def test_meta_sync_picks_up_new_objects_and_keeps_cached(cluster, tmp_path):
    master, fs = cluster
    out = {}
    for name, mod, fcls, ccls in (("port", rmount, FilerClient, rclient.LocalDirRemoteClient),
                                  ("jax", jax_mount, JaxFilerClient,
                                   jax_client.LocalDirRemoteClient)):
        root = str(tmp_path / name)
        _bucket(root, 3, n=6)
        fc, client = fcls(fs.grpc_address, master.grpc_address), ccls(root)
        d = f"/ms-{name}"
        mod.mount_remote(fc, client, d, f"local:{root}", prefix="docs/")
        mod.cache_entry(fc, client, f"{d}/o2.bin")
        client.write_object("docs/late.bin", b"late")
        client.write_object("a/outside-the-prefix.bin", b"no")
        fc.create(type(fc.lookup(d))(f"{d}/local.txt", content=b"mine"))
        n = mod.sync_metadata(fc, client, d, "docs/")
        again = mod.sync_metadata(fc, client, d, "docs/")
        found = {k: ({a: v.replace(root.encode(), b"ROOT") for a, v in ext.items()}, sizes,
                     content) for k, (ext, sizes, content) in _placeholders(fc, d).items()}
        out[name] = (n, again, found)
    assert out["port"] == out["jax"]
    n, again, found = out["port"]
    assert (n, again) == (1, 0)
    assert found["o2.bin"][0]["remote.cached"] == b"1" and found["o2.bin"][1]
    assert found["late.bin"][0]["remote.cached"] == b"0"
    assert found["local.txt"] == ({}, [], b"mine")


# -- the shell ------------------------------------------------------------------------


def _shells(master):
    return {"port": (run_command, CommandEnv(master.grpc_address)),
            "jax": (jax_run_command, JaxCommandEnv(master.grpc_address, client_name="rs"))}


def test_remote_commands_print_what_the_jax_shell_prints(cluster, tmp_path):
    master, fs = cluster
    root = str(tmp_path / "bucket")
    objs = _bucket(root, 4, n=9)
    g = fs.grpc_address
    texts = {}
    for name, (runner, env) in _shells(master).items():
        d = f"/sh-{name}"
        lines = [f"remote.mount -filer {g} -dir {d} -remote local:{root}",
                 f"remote.cache -filer {g} -dir {d} -path {d}/a/o0.bin",
                 f"remote.uncache -filer {g} -dir {d} -path {d}/a/o0.bin",
                 f"remote.uncache -filer {g} -dir {d} -path {d}/a/o0.bin",
                 f"remote.meta.sync -filer {g} -dir {d}",
                 f"remote.cache -filer {g} -dir {d}",
                 f"remote.uncache -filer {g} -dir {d} -path {d}/b/c/o1.bin",
                 f"remote.unmount -filer {g} -dir {d}"]
        got = []
        for line in lines:
            out = io.StringIO()
            runner(env, line, out)
            got.append(out.getvalue().replace(name, "X"))
            if line.startswith("remote.cache -filer") and "-path" not in line:
                for key, data in objs.items():
                    if key != "b/c/o1.bin":
                        assert _get(fs.url, f"{d}/{key}") == (200, data), key
        # after unmount: the mount marker is gone, cached files stay
        fc = FilerClient(g, master.grpc_address)
        assert rmount.mount_config(fc, d) is None
        got.append(sorted(k for k in _placeholders(fc, d)))
        with pytest.raises(Exception, match="not a remote mount"):
            runner(env, f"remote.meta.sync -filer {g} -dir {d}", io.StringIO())
        texts[name] = got
    assert texts["port"] == texts["jax"]
    assert texts["port"][0] == f"mounted local:{root} at /sh-X: {len(objs)} entries synced\n"
    assert "1 placeholders dropped" in texts["port"][7]


def test_remote_commands_are_the_jax_shell_s():
    from seaweedfs_tpu.shell import SHELL_REGISTRY as JAX_REGISTRY
    from seaweedfs_tpu_torch.shell import SHELL_REGISTRY

    jax = {n: c.help for n, c in JAX_REGISTRY.items() if n.startswith("remote.")}
    port = {n: c.help for n, c in SHELL_REGISTRY.items() if n.startswith("remote.")}
    assert port == jax and len(port) == 5


# -- the filer client and the duck-typed seam -------------------------------------------


def test_filer_client_verbs_as_jax(cluster):
    master, fs = cluster
    fcs = {"port": FilerClient(fs.grpc_address, master.grpc_address),
           "jax": JaxFilerClient(fs.grpc_address, master.grpc_address)}
    seen = {}
    for name, fc in fcs.items():
        d = f"/fc-{name}"
        E = type(fc.lookup("/"))
        fc.create(E(f"{d}/a", content=b"alpha"))
        fc.create(E(f"{d}/b", content=b"beta"))
        e = fc.lookup(f"{d}/a")
        e.content = b"alpha2"
        fc.update(e)
        fc.rename(f"{d}/b", f"{d}/c")
        steps = [[(x.name, bytes(x.content)) for x in fc.list(d)],
                 fc.lookup(f"{d}/b"), bytes(fc.lookup(f"{d}/a").content)]
        fc.delete(f"{d}/c")
        steps.append([x.name for x in fc.list(d, limit=1)])
        steps.append([x.name for x in fc.list(d, start_from="a")])
        try:
            fc.rename(f"{d}/nope", f"{d}/x")
            steps.append(None)
        except Exception as ex:  # noqa: BLE001 — both raise their FilerError
            steps.append((type(ex).__name__, str(ex).replace(name, "X")))
        fc.delete(d, recursive=True)
        steps.append(fc.lookup(d))
        seen[name] = steps
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [("a", b"alpha2"), ("c", b"beta")]


def test_duck_helpers_over_a_filer_and_a_filer_client(cluster):
    from seaweedfs_tpu_torch.filer.entry import Entry

    master, fs = cluster
    fc = FilerClient(fs.grpc_address, master.grpc_address)
    for i in range(5):
        duck.put_entry(fs.filer if i % 2 else fc, Entry(f"/duck/f{i}", content=b"%d" % i))
    for f in (fs.filer, fc):
        assert duck.find_entry(f, "/duck/f3").content == b"3"
        assert [e.name for e in duck.list_all(f, "/duck", page=2)] == [f"f{i}" for i in range(5)]
    assert duck.master_of(fs.filer) is fs.filer.master_client
    assert duck.master_of(fc) is fc.master
