"""The gateway's worker group (``cli s3 -workers N``) and its invalidation
bus (filer/inval_bus.py) in the port, held against the JAX package's.

- ``InvalBus`` datagrams are byte-equal to the JAX bus's for the same
  seeded paths, the 60 KB split included, and each package's receiver
  parses the other's datagrams into the same lines.
- Two in-process gateways, one port and one JAX, joined by one bus and
  with no metadata subscription: an overwrite through either evicts the
  other's cached entry, so only the bus can have carried it.
- ``cli s3 -workers 3`` as a subprocess over two filer shards: every
  worker serves (counted from each ``-metricsPort``), an overwrite reaches
  every worker inside the entry-cache TTL, and after one worker is
  SIGKILLed the survivors converge within the TTL.
- The parent forks with CUDA not initialised, and refuses ``-port 0`` or a
  missing ``-filer`` with exit code 2.

Every read of a subprocess goes through a queue with a deadline, and every
HTTP call has a timeout."""

from __future__ import annotations

import http.client
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.filer import inval_bus as jax_bus
from seaweedfs_tpu.filer.entry import Attr as JaxAttr
from seaweedfs_tpu.filer.entry import Entry as JaxEntry
from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.filer import inval_bus
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.wdclient import MasterClient

REPO = Path(__file__).resolve().parent.parent
WORKERS = 3
TTL = 2.0  # the gateway entry-cache default
WAIT_S = 60.0
HTTP_TIMEOUT = 30


def _seeded_paths(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 5 == 4:
            out.append(f"{inval_bus.FID_PREFIX}{int(rng.integers(1, 99))},"
                       f"{int(rng.integers(1, 1 << 40)):x}")
        else:
            depth = int(rng.integers(1, 6))
            out.append("/buckets/" + "/".join(
                f"d{int(rng.integers(0, 1 << 30)):x}é" * int(rng.integers(1, 4))
                for _ in range(depth)))
    return out


def _drain(sock: socket.socket, timeout: float = 0.5) -> list[bytes]:
    sock.settimeout(timeout)
    got = []
    while True:
        try:
            got.append(sock.recv(65536))
        except socket.timeout:
            return got


@pytest.mark.parametrize("n", [1, 40, 3000], ids=["one", "forty", "split"])
def test_bus_datagrams_are_the_jax_bytes(n):
    paths = _seeded_paths(1600 + n, n)
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    got = {}
    try:
        for name, mod in (("port", inval_bus), ("jax", jax_bus)):
            s = mod.InvalBus.bind()
            bus = mod.InvalBus(s, [s.getsockname()[1], sink.getsockname()[1]])
            try:
                bus.publish(paths)
                got[name] = (_drain(sink), bus.published)
            finally:
                bus.close()
    finally:
        sink.close()
    assert got["port"] == got["jax"]
    dgrams = got["port"][0]
    assert all(len(d) <= inval_bus._MAX_DGRAM for d in dgrams)
    assert b"\n".join(dgrams).decode().split("\n") == paths
    if n == 3000:
        assert len(dgrams) > 1


def test_each_bus_parses_the_others_datagrams():
    paths = _seeded_paths(1616, 2500)
    heard = {"port": [], "jax": []}
    socks = {"port": inval_bus.InvalBus.bind(), "jax": jax_bus.InvalBus.bind()}
    ports = [s.getsockname()[1] for s in socks.values()]
    buses = {"port": inval_bus.InvalBus(socks["port"], ports),
             "jax": jax_bus.InvalBus(socks["jax"], ports)}
    try:
        for name, bus in buses.items():
            bus.start(heard[name].extend)
        buses["port"].publish(paths)
        buses["jax"].publish(paths)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(len(v) == len(paths)
                                                      for v in heard.values()):
            time.sleep(0.02)
        assert heard["port"] == heard["jax"] == paths
        assert buses["port"].stats()["received"] == len(paths)
    finally:
        for bus in buses.values():
            bus.close()


# ---------------------------------------------------------------------------
# a cluster: port master, one port volume server, two port filer shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-s3w-")
    started = []
    try:
        master = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        master.start()
        started.append(master)
        vs = VolumeServer([root], master.grpc_address, port=0, grpc_port=0,
                          heartbeat_interval=0.2, device="cpu")
        vs.start()
        started.append(vs)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not master.topology.nodes:
            time.sleep(0.05)
        assert master.topology.nodes, "the volume server never registered"
        filers = []
        for _ in range(2):
            fs = FilerServer(master.grpc_address, port=0, grpc_port=0)
            fs.start()
            started.append(fs)
            filers.append(fs)
        yield master, filers
    finally:
        for s in reversed(started):
            s.stop()
        shutil.rmtree(root, ignore_errors=True)
        mp.undo()


def _http(addr: str, method: str, path: str, body: bytes = b"", timeout: float = HTTP_TIMEOUT):
    """One request on a fresh connection, so the kernel picks a worker."""
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body=body or None)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("ETag")
    finally:
        conn.close()


def _http_retry(addr, method, path, body=b"", tries=8):
    last = None
    for _ in range(tries):
        try:
            return _http(addr, method, path, body)
        except OSError as e:  # a killed worker's connection: ask again
            last = e
            time.sleep(0.2)
    raise AssertionError(f"no worker answered {method} {path}: {last}")


def test_bus_alone_keeps_a_port_and_a_jax_gateway_coherent(cluster):
    """No metadata subscription and a 30 s entry TTL: only a datagram can
    evict the other gateway's cached entry, in both directions."""
    master, filers = cluster
    socks = [inval_bus.InvalBus.bind(), jax_bus.InvalBus.bind()]
    ports = [s.getsockname()[1] for s in socks]
    addr = filers[0].grpc_address
    port_gw = S3ApiServer(master.grpc_address, port=0,
                          filer=RemoteFiler(addr, MasterClient(master.grpc_address)),
                          entry_cache_ttl=30.0, meta_subscribe=False,
                          inval_bus=inval_bus.InvalBus(socks[0], ports),
                          lifecycle_sweep_interval=0, credential_refresh=0, chunk_cache_mb=0)
    jax_gw = JaxS3(master.grpc_address, port=0,
                   filer=JaxRemoteFiler(addr, JaxMasterClient(master.grpc_address)),
                   entry_cache_ttl=30.0, meta_subscribe=False,
                   inval_bus=jax_bus.InvalBus(socks[1], ports),
                   lifecycle_sweep_interval=0, credential_refresh=0, chunk_cache_mb=0)
    try:
        assert port_gw.meta_subscriber is None and port_gw.entry_cache is not None
        port_gw.create_bucket("busco")
        path = port_gw.object_path("busco", "obj")
        for writer, reader, body in ((port_gw, jax_gw, b"one"), (jax_gw, port_gw, b"two"),
                                     (port_gw, jax_gw, b"three")):
            reader.find_entry_cached(path)  # cache what the reader sees now
            if writer is port_gw:
                writer.filer.create_entry(Entry(path, attr=Attr.now(), content=body))
            else:
                writer.filer.create_entry(JaxEntry(path, attr=JaxAttr.now(), content=body))
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                e = reader.find_entry_cached(path)
                if e is not None and e.content == body:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError(f"{body!r} never reached the other gateway's cache")
        assert port_gw.inval_bus.published >= 2 and port_gw.inval_bus.received >= 1
    finally:
        port_gw.stop()
        jax_gw.stop()


def test_gateway_without_a_cache_still_publishes(cluster):
    master, filers = cluster
    s = inval_bus.InvalBus.bind()
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    gw = S3ApiServer(master.grpc_address, port=0,
                     filer=RemoteFiler(filers[1].grpc_address, MasterClient(master.grpc_address)),
                     entry_cache_ttl=0, chunk_cache_mb=0,
                     inval_bus=inval_bus.InvalBus(s, [s.getsockname()[1], sink.getsockname()[1]]),
                     lifecycle_sweep_interval=0, credential_refresh=0)
    try:
        gw.create_bucket("nocache")
        gw.filer.create_entry(Entry("/buckets/nocache/k", attr=Attr.now(), content=b"x"))
        lines = b"\n".join(_drain(sink, 1.0)).decode().split("\n")
        assert "/buckets/nocache/k" in lines and "/buckets/nocache" in lines
        assert gw.inval_bus._thread is None  # nothing to invalidate here: no receiver
    finally:
        gw.stop()
        sink.close()


# ---------------------------------------------------------------------------
# cli s3 -workers as a subprocess
# ---------------------------------------------------------------------------


def _free_reuse_port() -> int:
    with socket.socket() as probe:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _free_run(n: int) -> int:
    """A base port with ``n`` free ports from it (the workers' -metricsPort + i)."""
    for _ in range(50):
        base = _free_reuse_port()
        if base + n >= 65535:
            continue
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no run of free ports")


class _Group:
    """``cli s3 -workers`` in a subprocess; its stdout read by a thread."""

    def __init__(self, master_addr: str, filer_list: str, workers: int):
        self.port = _free_reuse_port()
        self.metrics = _free_run(workers)
        self.workers = workers
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "s3", "-master", master_addr,
             "-filer", filer_list, "-port", str(self.port), "-workers", str(workers),
             "-metricsPort", str(self.metrics)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        self.addr = f"127.0.0.1:{self.port}"

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_up(self, timeout: float = WAIT_S) -> list[str]:
        banners, seen = [], []
        deadline = time.monotonic() + timeout
        while len(banners) < self.workers:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(f"{len(banners)}/{self.workers} workers up: {seen}")
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                continue
            if line is None:
                raise AssertionError(f"the group exited (rc {self.proc.poll()}): {seen}")
            seen.append(line)
            if "s3 gateway on" in line:
                banners.append(line.strip())
        return banners

    def _metric(self, prefix: str) -> list[float]:
        """The sum of each worker's series starting with ``prefix`` (its
        own -metricsPort)."""
        out = []
        for i in range(self.workers):
            conn = http.client.HTTPConnection("127.0.0.1", self.metrics + i, timeout=HTTP_TIMEOUT)
            try:
                conn.request("GET", "/metrics")
                text = conn.getresponse().read().decode()
            finally:
                conn.close()
            out.append(sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith(prefix)))
        return out

    def served(self) -> list[float]:
        """Requests each worker counted."""
        return self._metric("weedtpu_s3_request_total{")

    def bus(self) -> list[tuple[float, float]]:
        """(datagrams sent, datagrams received) on each worker's bus."""
        return list(zip(
            self._metric('weedtpu_s3_inval_bus_datagrams_total{direction="sent"}'),
            self._metric('weedtpu_s3_inval_bus_datagrams_total{direction="received"}')))

    def children(self) -> list[int]:
        out: set[int] = set()
        try:
            for t in os.listdir(f"/proc/{self.proc.pid}/task"):
                with open(f"/proc/{self.proc.pid}/task/{t}/children") as fh:
                    out.update(int(x) for x in fh.read().split())
        except OSError:
            pass
        return sorted(out)

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
            return -9


def _converge(addr: str, key: str, new: bytes, old: bytes, streak: int) -> float:
    """GET on fresh connections until ``streak`` answers in a row are the
    new body; returns how long after the call an old body was last seen."""
    t0 = time.monotonic()
    last_stale = 0.0
    fresh = 0
    while fresh < streak:
        st, body, _ = _http_retry(addr, "GET", key)
        assert st == 200
        if body == new:
            fresh += 1
            continue
        assert body == old, "a third body"
        fresh = 0
        last_stale = time.monotonic() - t0
        assert last_stale < TTL + 1.5, f"still the old body {last_stale:.2f}s after the PUT"
    return last_stale


def _until_every_worker_served(group, request, base: list[float], rounds: int = 100) -> list[float]:
    """Call ``request`` (each call on a fresh connection, which the kernel
    hands to a worker by its hash) until every worker's request count is
    above ``base``; the counts then.  A worker with no request in
    ``rounds`` rounds of ``group.workers`` calls fails the test."""
    for _ in range(rounds):
        for _ in range(group.workers):
            request()
        now = group.served()
        if all(a > b for a, b in zip(now, base)):
            return now
    raise AssertionError(f"a worker served none of {rounds * group.workers} requests: "
                         f"{base} -> {now}")


def test_worker_group_serves_and_stays_coherent(cluster):
    master, filers = cluster
    group = _Group(master.grpc_address, ",".join(f.grpc_address for f in filers), WORKERS)
    rng = np.random.default_rng(1633)
    try:
        banners = group.wait_up()
        assert sorted(b.rsplit("[", 1)[1] for b in banners) == [
            f"worker {i + 1}/{WORKERS}]" for i in range(WORKERS)]
        assert len(group.children()) == WORKERS
        assert _http_retry(group.addr, "PUT", "/wk")[0] == 200
        old, new = rng.bytes(20_000), rng.bytes(20_000)
        assert _http_retry(group.addr, "PUT", "/wk/obj", old)[0] == 200

        def get(want: bytes):
            assert _http_retry(group.addr, "GET", "/wk/obj")[:2] == (200, want)

        for _ in range(6 * WORKERS):  # warm the workers' caches
            get(old)
        _until_every_worker_served(group, lambda: get(old), [0.0] * WORKERS)
        before, bus_before = group.served(), group.bus()
        assert all(n > 0 for n in before), before
        assert _http_retry(group.addr, "PUT", "/wk/obj", new)[0] == 200
        _converge(group.addr, "/wk/obj", new, old, 4 * WORKERS)
        # every worker answers the new body, however the kernel spread
        # the converging GETs
        _until_every_worker_served(group, lambda: get(new), before)
        after, bus_after = group.served(), group.bus()
        assert all(a > b for a, b in zip(after, before)), (before, after)
        # the overwrite's worker sent a datagram to each sibling, and every
        # sibling received one: the bus, not the TTL, carried it
        sent = [a[0] - b[0] for a, b in zip(bus_after, bus_before)]
        got = [a[1] - b[1] for a, b in zip(bus_after, bus_before)]
        assert sum(1 for n in sent if n >= WORKERS - 1) >= 1, (bus_before, bus_after)
        assert all(g >= 1 or s >= WORKERS - 1 for s, g in zip(sent, got)), (bus_before, bus_after)
    finally:
        rc = group.stop()
    assert rc == 0


def test_survivors_converge_after_a_worker_is_killed(cluster):
    master, filers = cluster
    group = _Group(master.grpc_address, ",".join(f.grpc_address for f in filers), WORKERS)
    rng = np.random.default_rng(1634)
    try:
        group.wait_up()
        assert _http_retry(group.addr, "PUT", "/kl")[0] == 200
        old, new = rng.bytes(30_000), rng.bytes(30_000)
        assert _http_retry(group.addr, "PUT", "/kl/obj", old)[0] == 200
        for _ in range(2 * WORKERS):
            assert _http_retry(group.addr, "GET", "/kl/obj")[:2] == (200, old)
        victims = group.children()
        assert len(victims) == WORKERS
        os.kill(victims[0], signal.SIGKILL)
        assert _http_retry(group.addr, "PUT", "/kl/obj", new)[0] == 200
        _converge(group.addr, "/kl/obj", new, old, 2 * (WORKERS - 1))
        for _ in range(2 * (WORKERS - 1)):  # no flip-back
            assert _http_retry(group.addr, "GET", "/kl/obj")[:2] == (200, new)
    finally:
        rc = group.stop()
    # the killed worker was not a forwarded signal: 128 + 9
    assert rc == 128 + signal.SIGKILL


# ---------------------------------------------------------------------------
# the parent: refusals, and no CUDA before the fork
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv, msg", [
    (["s3", "-workers", "2", "-port", "0", "-filer", "127.0.0.1:1"], "needs a fixed -port"),
    (["s3", "-workers", "2", "-port", "18444"], "needs -filer"),
], ids=["port-0", "no-filer"])
def test_worker_group_refusals_match_jax(argv, msg, capsys):
    from seaweedfs_tpu import cli as jax_cli

    assert cli.main(argv) == 2
    port_err = capsys.readouterr().err
    assert jax_cli.main(argv) == 2
    assert port_err == capsys.readouterr().err and msg in port_err


def test_parent_forks_with_cuda_uninitialised(monkeypatch):
    """The gateway runs no kernel; its parent must not initialise CUDA
    before it forks.  The fork is intercepted: the state at that moment is
    recorded and the fork refused, so nothing is started."""
    seen = []

    def fork():
        torch = sys.modules.get("torch")
        seen.append(torch is not None and torch.cuda.is_initialized())
        raise OSError("fork intercepted")

    monkeypatch.setattr(os, "fork", fork)
    with pytest.raises(OSError, match="fork intercepted"):
        from seaweedfs_tpu_torch.commands import servers

        servers.run_s3(cli._build_parser().parse_args(
            ["s3", "-workers", "2", "-port", str(_free_reuse_port()), "-filer", "127.0.0.1:1"]))
    assert seen == [False]
