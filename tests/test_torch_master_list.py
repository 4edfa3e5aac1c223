"""A volume server's list of masters, and a lease-mode takeover, held
against the JAX package (ROADMAP Queue C item 3).

- A volume server started with ``-mserver dead,live`` re-homes its
  heartbeat to the live master; its remote EC reads must follow it.  The
  port's EC locator asks the master the heartbeat reaches now, then the
  rest of the list, so every needle reads back on every holder.  The JAX
  locator asks only the first configured master, so a holder without the
  needle's shard cannot find it and drops the connection: the test
  records that answer.
- A lease-mode standby adopts the leader's sequence ceiling once a probe
  interval.  A key issued and its leader stopped within one interval is
  above the ceiling the standby holds; the port's new leader jumps past it
  on takeover and issues a higher key, the JAX one issues the same key
  again.

Every wait polls a condition with a deadline of at least 30 s."""

from __future__ import annotations

import http.client
import io
import json
import shutil
import socket
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server import volume_server as port_vs
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv

WAIT_S = 30.0
INTERVAL = 0.3  # the lease election's probe interval, as in the JAX tests


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _dead_address() -> str:
    """A localhost port nothing listens on."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _http(addr: str, method: str, path: str, body: bytes = b""):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request(method, path, body=body or None)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _fill_volume(master, collection: str, count: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    payloads, vid = {}, None
    while len(payloads) < count:
        status, body = _http(master.advertise, "GET", f"/dir/assign?collection={collection}")
        assert status == 200, body
        a = json.loads(body)
        v = int(a["fid"].split(",")[0])
        vid = vid or v
        if v != vid:
            continue
        data = rng.bytes(int(rng.integers(2_000, 20_000)))
        assert _http(a["url"], "POST", f"/{a['fid']}", data)[0] == 201
        payloads[a["fid"]] = data
    return vid, payloads


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_remote_ec_read_with_a_dead_first_master(pkg, monkeypatch):
    """Two volume servers with ``-mserver dead,live``: an EC volume's
    needles lie on shard 0 (one 1 MiB row), so the server without shard 0
    reads them remotely.  The port answers 200 with the payload on both;
    the JAX server without shard 0 cannot locate it."""
    monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    ms_mod, vs_mod = (port_ms, port_vs) if pkg == "port" else (jax_ms, jax_vs)
    kw = {"device": "cpu"} if pkg == "port" else {}
    master = ms_mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.start()
    masters = f"{_dead_address()},{master.grpc_address}"
    dirs = [tempfile.mkdtemp(prefix=f"mlist-{pkg}{i}-") for i in range(2)]
    servers = [vs_mod.VolumeServer([d], masters, port=0, grpc_port=0, rack=f"rack{i}",
                                   heartbeat_interval=0.2, max_volume_counts=[8], **kw)
               for i, d in enumerate(dirs)]
    for vs in servers:
        vs.start()
    try:
        _wait(lambda: len(master.topology.nodes) == 2, "both heartbeats at the live master")
        assert all(vs.master_address == master.grpc_address for vs in servers)
        collection = f"mlist-{pkg}"
        vid, payloads = _fill_volume(master, collection)
        env = (CommandEnv(master.grpc_address) if pkg == "port"
               else JaxCommandEnv(master.grpc_address, client_name="jax-shell"))
        runner = run_command if pkg == "port" else jax_run_command
        try:
            runner(env, "lock", io.StringIO())
            runner(env, f"ec.encode -volumeId {vid} -collection {collection}", io.StringIO())
        finally:
            env.release_lock()
        _wait(lambda: sum(len(ns) for ns in master.topology.lookup_ec_shards(vid).values()) >= 14,
              "14 shards at the master")
        holders = {i: sorted(ev.shard_ids()) for i, vs in enumerate(servers)
                   if (ev := vs.store.find_ec_volume(vid)) is not None}
        assert sorted(holders) == [0, 1], holders
        remote = next(i for i, sids in holders.items() if 0 not in sids)
        got = {}
        for fid, data in payloads.items():
            for i, vs in enumerate(servers):
                try:
                    status, body = _http(vs.url, "GET", f"/{fid}")
                except http.client.RemoteDisconnected:
                    status, body = "dropped", b""
                got[(fid, i)] = status, body == data
        local = [v for (fid, i), v in got.items() if i != remote]
        assert local == [(200, True)] * len(payloads)
        answers = [v for (fid, i), v in got.items() if i == remote]
        if pkg == "port":
            assert answers == [(200, True)] * len(payloads)
        else:
            # the JAX locator asked the dead master only: its handler dies
            # on the lookup's UNAVAILABLE and drops the connection
            assert answers == [("dropped", False)] * len(payloads), answers
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_lease_takeover_within_one_probe_interval(pkg):
    """The leader issues its first key (raising its ceiling a margin
    ahead) and stops before the standby's next probe: the standby holds
    the old ceiling when it takes over.  The port's new leader issues a
    higher key; the JAX one issues the same key again."""
    mod = port_ms if pkg == "port" else jax_ms
    pair = [mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64,
                             election_interval=INTERVAL) for _ in range(2)]
    for m in pair:
        m.start()
    try:
        for m in pair:
            m.set_peers([p.advertise for p in pair])
        _wait(lambda: pair[0].leader_http == pair[1].leader_http and
              all(m.election.alive().keys() == {p.advertise for p in pair} for m in pair),
              "one leader both masters agree on")
        leader = next(m for m in pair if m.is_leader)
        standby = next(m for m in pair if m is not leader)
        key = leader.topology.next_file_key()
        leader.stop()
        # the scenario: the standby never saw the ceiling that covers key
        assert standby.topology.sequence_watermarks()[1] < key
        _wait(lambda: standby.is_leader, "the standby's takeover")
        got = standby.topology.next_file_key()
        if pkg == "port":
            assert got > key
        else:
            assert got == key
    finally:
        for m in pair:
            m.stop()
