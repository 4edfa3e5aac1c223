"""The port's maintenance plane (seaweedfs_tpu_torch/admin) held against
the JAX package's (seaweedfs_tpu/admin), mirroring tests/test_admin.py.

- The task queue: one seeded script (seeds 0-3) of submits, claims,
  reports, cancels, activity queries and clock advances gives equal
  ``to_json()`` lists, ``counts()`` and answers after every step, and equal
  ``weedtpu_admin_tasks_total`` increments.
- The scanner: a seeded ``VolumeListResponse`` (sizes around 95% of the
  limit, deleted ratios around 0.3, TTL volumes old, fresh or of unknown
  age, partial RS and LRC shard sets, an unreachable holder), built with
  the JAX messages and parsed by the port's, and ``VolumeStatus`` answers
  from fake stubs: two consecutive ``scan_once`` calls submit the same
  tasks in both packages.
- Each package's cluster with no shell, ``[jax, port]``: auto EC encode
  (the port's shards byte-equal to the JAX package's encode of a copy of
  the .dat, and spread over the servers, where the JAX worker leaves
  them all on one), auto vacuum, auto rebuild of an RS shard set and of an LRC
  single loss (staging only its local group), TTL expiry with a rewound
  clock, auth and the management plane, the policy persisted across a
  restart, a worker against a secured admin, the dashboard and the
  topology endpoint.

Servers bind port 0 and the port's run with ``device="cpu"``; every wait
polls a condition with a deadline.  The results are bytes, JSON and
states: the comparisons are exact."""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

import seaweedfs_tpu.admin as jax_admin
from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.admin import scanner as jax_scanner_mod
from seaweedfs_tpu.admin import tasks as jax_tasks
from seaweedfs_tpu.admin.dashboard import DASHBOARD_HTML as JAX_DASHBOARD_HTML
from seaweedfs_tpu.pb import master_pb2 as jax_m_pb
from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec_encoder
from seaweedfs_tpu.storage.erasure_coding.lrc import make_scheme as jax_make_scheme
from seaweedfs_tpu_torch import admin as port_admin
from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.admin import scanner as port_scanner_mod
from seaweedfs_tpu_torch.admin import tasks as port_tasks
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server import volume_server as port_vs
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits

WAIT_S = 60.0
KINDS = (port_tasks.EC_ENCODE, port_tasks.EC_REBUILD, port_tasks.VACUUM, port_tasks.TTL_DELETE)

PKG = {
    "port": dict(admin=port_admin, tasks=port_tasks, scanner=port_scanner_mod, stats=stats,
                 ms=port_ms, vs=port_vs, vs_pb=vs_pb, make_scheme=make_scheme,
                 vs_kw={"device": "cpu"}),
    "jax": dict(admin=jax_admin, tasks=jax_tasks, scanner=jax_scanner_mod, stats=jax_stats,
                ms=jax_ms, vs=jax_vs, vs_pb=jax_vs_pb, make_scheme=jax_make_scheme, vs_kw={}),
}


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _http(addr: str, method: str, path: str, body: bytes = b"", headers: dict | None = None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    hdrs = dict(resp.headers)
    conn.close()
    return resp.status, data, hdrs


def _delta(family, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in family.series().items()
            if v != before.get(k, 0.0)}


# -- the task queue ----------------------------------------------------------------


def _queue_script(seed: int, T, clock: list) -> list:
    """A seeded run of queue operations; the transcript of every step."""
    rng = np.random.default_rng(seed)
    q = T.TaskQueue(max_attempts=2, assign_timeout=300.0, max_finished=6)
    ops = ("submit", "claim", "report", "cancel", "advance", "active")
    out = []
    for step in range(160):
        op = ops[int(rng.choice(len(ops), p=[0.3, 0.25, 0.2, 0.07, 0.1, 0.08]))]
        ids = [t.id for t in q.all()]
        try:
            if op == "submit":
                kind = KINDS[int(rng.integers(len(KINDS)))]
                params = {"garbage_threshold": 0.3} if rng.integers(2) else {}
                t = q.submit(kind, int(rng.integers(1, 7)), ("", "c")[int(rng.integers(2))],
                             **params)
                res = t.to_json() if t else None
            elif op == "claim":
                kinds = None if rng.integers(2) else [KINDS[int(rng.integers(len(KINDS)))]]
                t = q.claim(f"w{int(rng.integers(2))}", kinds)
                res = t.to_json() if t else None
            elif op == "report":
                tid = int(rng.choice(ids + [999])) if ids else 999
                owner = q.get(tid).worker_id if q.get(tid) else "w0"
                worker = owner if rng.integers(4) else "intruder"
                res = q.report(tid, worker, bool(rng.integers(2)), f"error {step}").to_json()
            elif op == "cancel":
                tid = int(rng.choice(ids + [999])) if ids else 999
                res = q.cancel(tid).to_json()
            elif op == "advance":
                clock[0] += float(rng.choice([1.0, 60.0, 250.0, 400.0]))
                res = clock[0]
            else:
                res = q.has_active(KINDS[int(rng.integers(len(KINDS)))], int(rng.integers(1, 7)))
        except (ValueError, KeyError) as e:
            res = (type(e).__name__, str(e))
        out.append((step, op, res, [t.to_json() for t in q.all()], q.counts()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_task_queue_matches_jax(seed, monkeypatch):
    clock = [1_000_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    got = {}
    for name in ("port", "jax"):
        family = PKG[name]["stats"].ADMIN_TASKS
        before = family.series()
        clock[0] = 1_000_000.0
        got[name] = (_queue_script(seed, PKG[name]["tasks"], clock), _delta(family, before))
    for want, have in zip(got["jax"][0], got["port"][0]):
        assert have == want
    assert got["port"][1] == got["jax"][1]
    # the script reached every outcome
    outcomes = {dict(k)["outcome"] for k in got["port"][1]}
    assert {"ok", "retried", "failed"} <= outcomes, outcomes


# -- the scanner ---------------------------------------------------------------------


NOW_NS = 1_800_000_000 * 10**9
LIMIT_MB = 100


def _scan_fixture(seed: int):
    """(JAX VolumeListResponse, {grpc address: {vid: last_modified_ns}},
    the unreachable address)."""
    pb = jax_m_pb
    rng = np.random.default_rng(seed)
    limit = LIMIT_MB << 20
    nodes = [(f"dc{i % 2}", f"r{i % 3}", f"10.0.0.{i}:8080", 18080 + i) for i in range(6)]
    down = f"10.0.0.5:{18080 + 5}"
    held: dict[str, list] = {n[2]: [] for n in nodes}
    ec: dict[str, list] = {n[2]: [] for n in nodes}
    status: dict[str, dict] = {f"{n[2].split(':')[0]}:{n[3]}": {} for n in nodes}

    def age(ttl: int) -> int:
        which = int(rng.integers(4))
        if which == 0:
            return 0  # unknown clock
        if which == 1:
            return NOW_NS - int(rng.integers(2, 5)) * max(ttl, 3600) * 10**9  # old
        return NOW_NS - int(rng.integers(1, 30)) * 10**9  # fresh

    for vid in range(1, 31):
        kind = ("plain", "plain", "ttl", "ec")[int(rng.integers(4))]
        coll = ("", "a", "b")[int(rng.integers(3))]
        if kind in ("plain", "ttl"):
            size = int(limit * rng.uniform(0.88, 1.0)) if rng.integers(3) else int(rng.integers(0, 4096))
            deleted = int(size * rng.uniform(0.2, 0.4))
            ttl = int(rng.choice([60, 3600, 86400])) if kind == "ttl" else 0
            picks = rng.choice(len(nodes), size=int(rng.integers(1, 3)), replace=False)
            for p in picks:
                url, gport = nodes[p][2], nodes[p][3]
                held[url].append(pb.VolumeStat(id=vid, collection=coll, size=size,
                                               deleted_bytes=deleted, ttl_seconds=ttl,
                                               file_count=int(rng.integers(1, 100))))
                status[f"{url.split(':')[0]}:{gport}"][vid] = age(ttl)
        if kind == "ec" or rng.integers(8) == 0:
            geometry = ((10, 4, 0), (10, 4, 2), (0, 0, 0))[int(rng.integers(3))]
            total = 14
            full = rng.integers(3) == 0
            sids = list(range(total)) if full else sorted(
                int(s) for s in rng.choice(total, size=int(rng.integers(1, total)), replace=False))
            split = rng.choice(len(nodes), size=int(rng.integers(1, 4)), replace=False)
            for j, p in enumerate(split):
                bits = sum(1 << s for s in sids[j::len(split)])
                if bits:
                    ec[nodes[p][2]].append(pb.EcShardStat(
                        volume_id=vid, collection=coll, shard_bits=bits,
                        data_shards=geometry[0], parity_shards=geometry[1],
                        local_groups=geometry[2]))
    topo = pb.TopologyInfo(id="topo")
    for dc in sorted({n[0] for n in nodes}):
        dci = pb.DataCenterInfo(id=dc)
        for rack in sorted({n[1] for n in nodes if n[0] == dc}):
            dns = []
            for _dc, _r, url, gport in (n for n in nodes if n[0] == dc and n[1] == rack):
                disk = pb.DiskInfo(type="hdd", max_volume_count=40, volume_count=len(held[url]))
                disk.volume_infos.extend(held[url])
                disk.ec_shard_infos.extend(ec[url])
                dns.append(pb.DataNodeInfo(id=url, url=url, grpc_port=gport,
                                           disk_infos={"hdd": disk}))
            dci.rack_infos.append(pb.RackInfo(id=rack, data_node_infos=dns))
        topo.data_center_infos.append(dci)
    return pb.VolumeListResponse(topology_info=topo, volume_size_limit_mb=LIMIT_MB), status, down


class _FakeMaster:
    def __init__(self, resp):
        self.resp = resp

    def VolumeList(self, request, **kw):
        return self.resp


class _FakeVolume:
    def __init__(self, pb, statuses: dict, down: bool):
        self.pb, self.statuses, self.down = pb, statuses, down

    def VolumeStatus(self, request, **kw):
        if self.down:
            raise ConnectionError("holder unreachable")
        return self.pb.VolumeStatusResponse(last_modified_ns=self.statuses.get(request.volume_id, 0))


@pytest.mark.parametrize("seed", range(4))
def test_scanner_decides_as_jax(seed, monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: NOW_NS)
    jax_resp, status, down = _scan_fixture(seed)
    wire = jax_resp.SerializeToString()
    port_resp = m_pb.VolumeListResponse.FromString(wire)
    assert port_resp.SerializeToString() == wire
    policy_kw = dict(ec_full_percent=95.0, ec_quiet_seconds=3600.0, vacuum_garbage_ratio=0.3)
    got = {}
    for name, resp in (("port", port_resp), ("jax", jax_resp)):
        mods = PKG[name]
        queue = mods["tasks"].TaskQueue()
        scanner = mods["scanner"].MaintenanceScanner(
            "fake:1", queue, mods["scanner"].MaintenancePolicy(**policy_kw))
        scanner._master = _FakeMaster(resp)
        scanner._volumes = {addr: _FakeVolume(mods["vs_pb"], st, addr == down)
                            for addr, st in status.items()}
        scans = [[(t.kind, t.volume_id, t.collection, t.params) for t in scanner.scan_once()]
                 for _ in range(2)]
        got[name] = scans, [t.to_json() for t in queue.all()]
    assert got["port"] == got["jax"]
    kinds = {k for scan in got["port"][0] for k, *_ in scan}
    assert kinds, "the seed submitted nothing"


def test_scanner_fixtures_cover_every_decision(monkeypatch):
    """Across seeds 0-3 the scans submit every kind of task."""
    monkeypatch.setattr(time, "time_ns", lambda: NOW_NS)
    kinds = set()
    for seed in range(4):
        resp, status, down = _scan_fixture(seed)
        queue = port_tasks.TaskQueue()
        scanner = port_scanner_mod.MaintenanceScanner("fake:1", queue)
        scanner._master = _FakeMaster(m_pb.VolumeListResponse.FromString(resp.SerializeToString()))
        scanner._volumes = {a: _FakeVolume(vs_pb, st, a == down) for a, st in status.items()}
        for _ in range(2):
            kinds |= {t.kind for t in scanner.scan_once()}
    assert kinds == set(KINDS)


# -- clusters with no shell ------------------------------------------------------------


class _Cluster:
    def __init__(self, pkg: str, n: int, limit_mb: int, heartbeat_s: float = 0.2):
        self.pkg, self.mods = pkg, PKG[pkg]
        self.master = self.mods["ms"].MasterServer(port=0, grpc_port=0,
                                                   volume_size_limit_mb=limit_mb)
        self.master.start()
        self.dirs = [tempfile.mkdtemp(prefix=f"torch-admin-{pkg}{i}-") for i in range(n)]
        self.servers = []
        for i, d in enumerate(self.dirs):
            vs = self.mods["vs"].VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                              rack=f"rack{i % 2}", heartbeat_interval=heartbeat_s,
                                              **self.mods["vs_kw"])
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == n, "every server's heartbeat")

    def stop(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()
        for d in self.dirs:
            shutil.rmtree(d, ignore_errors=True)

    def fill(self, collection: str, n: int = 10, size: int = 60_000):
        """n needles of ``size`` bytes POSTed into one volume: (vid, {fid: payload})."""
        payloads, vid = {}, None
        while len(payloads) < n:
            status, body, _ = _http(self.master.advertise, "GET",
                                    f"/dir/assign?collection={collection}")
            assert status == 200, body
            a = json.loads(body)
            v = int(a["fid"].split(",")[0])
            vid = vid or v
            if v != vid:
                continue
            data = (f"needle-{len(payloads)}-{collection}-".encode() * size)[:size]
            assert _http(a["url"], "POST", f"/{a['fid']}", data)[0] == 201
            payloads[a["fid"]] = data
        return vid, payloads

    def read(self, fid: str) -> tuple[int, bytes]:
        """GET ``fid`` from the servers until one answers 200."""
        status = None
        for vs in self.servers:
            status, body, _ = _http(vs.url, "GET", f"/{fid}")
            if status == 200:
                return status, body
        return status, b""

    def shard_count(self, vid: int) -> int:
        return sum(ShardBits(int(n.ec_shards.get(vid, 0))).count()
                   for n in list(self.master.topology.nodes.values()))

    def view_is_disk(self, vid: int) -> bool:
        """The master's shard map of ``vid`` is the shards mounted on disk."""
        disk = {vs.url: sorted(ev.shard_ids()) for vs in self.servers
                if (ev := vs.store.find_ec_volume(vid)) is not None}
        view = {n.id: ShardBits(int(n.ec_shards.get(vid, 0))).ids()
                for n in list(self.master.topology.nodes.values())}
        return {k: sorted(v) for k, v in view.items() if v} == disk

    def shard_files(self, name: str) -> dict[int, str]:
        out = {}
        for d in self.dirs:
            for f in os.listdir(d):
                if f.startswith(name + ".ec") and f[-2:].isdigit():
                    assert int(f[-2:]) not in out, f"shard {f} on two servers"
                    out[int(f[-2:])] = os.path.join(d, f)
        return out

    def tasks(self, admin, kind: str, state: str = "completed") -> list[int]:
        return [t.volume_id for t in admin.queue.all()
                if t.kind == kind and t.state.value == state]


@pytest.fixture
def make_cluster(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    made = []

    def make(pkg: str, n: int = 2, limit_mb: int = 1, heartbeat_s: float = 0.2) -> _Cluster:
        made.append(_Cluster(pkg, n, limit_mb, heartbeat_s))
        return made[-1]

    yield make
    for c in made:
        c.stop()


def _auto_policy(mods, **kw):
    return mods["admin"].MaintenancePolicy(**{
        "ec_full_percent": 40.0, "ec_quiet_seconds": 0.0, "vacuum_garbage_ratio": 0.9,
        "scan_interval": 0.3, **kw})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_auto_ec_encode_no_shell(pkg, make_cluster, tmp_path):
    c = make_cluster(pkg)
    mods = c.mods
    vid, payloads = c.fill("autoec")  # ~600 KB of a 1 MB limit
    # the .dat as the scanner will find it, before it acts
    dat = next(os.path.join(d, f"autoec_{vid}.dat") for d in c.dirs
               if os.path.exists(os.path.join(d, f"autoec_{vid}.dat")))
    ref = str(tmp_path / "ref")
    shutil.copy(dat, ref + ".dat")
    admin = mods["admin"].AdminServer(c.master.grpc_address, policy=_auto_policy(mods))
    admin.start()
    worker = mods["admin"].Worker(c.master.grpc_address, admin_address=admin.url,
                                  poll_interval=0.2)
    worker.start()
    try:
        _wait(lambda: vid in c.master.topology.ec_shard_map, f"volume {vid} auto-EC-encoded")
        _wait(lambda: all(vs.store.find_volume(vid) is None for vs in c.servers),
              "the .dat replicas gone")
        _wait(lambda: c.shard_count(vid) == 14 and c.view_is_disk(vid), "14 shards at the master")
        for fid, data in payloads.items():
            assert c.read(fid) == (200, data), fid
        _wait(lambda: c.tasks(admin, mods["tasks"].EC_ENCODE) == [vid],
              "one completed ec_encode task")
    finally:
        worker.stop()
        admin.stop()
    jax_ec_encoder.write_ec_files(ref)
    files = c.shard_files(f"autoec_{vid}")
    assert {sid: _sha(p) for sid, p in files.items()} == {
        sid: _sha(f"{ref}.ec{sid:02d}") for sid in range(14)}
    # the port's worker spreads the shards as the shell's ec.encode does;
    # the JAX worker leaves all of them on the generating server
    holders = {os.path.dirname(p) for p in files.values()}
    assert len(holders) == (2 if pkg == "port" else 1), holders


def test_a_scan_right_after_an_encode_submits_nothing(make_cluster):
    """The port's worker reports an encode done only once the master sees
    the shards and no .dat, so a scan at once after the report submits no
    second encode (which would fail three times: "volume not found").  The
    JAX worker reports before the servers' heartbeats land."""
    c = make_cluster("port")
    T = port_tasks
    vid, _payloads = c.fill("rescan")
    queue = T.TaskQueue()
    scanner = port_admin.MaintenanceScanner(c.master.grpc_address, queue,
                                            _auto_policy(PKG["port"]))
    created = []
    # the volume's size reaches the master with a full heartbeat
    _wait(lambda: created.extend(scanner.scan_once()) or created, "the encode's submission")
    assert [(t.kind, t.volume_id) for t in created] == [(T.EC_ENCODE, vid)]
    worker = port_admin.Worker(c.master.grpc_address, queue=queue)
    assert worker.run_one()
    assert [t.state for t in queue.all()] == [T.TaskState.COMPLETED]
    assert scanner.scan_once() == []
    assert scanner.scan_once() == []


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_scan_right_after_a_vacuum(pkg, make_cluster):
    """Servers beating every 2 s send their full state every 10 s.  The
    port's VolumeVacuum announces the compacted volume in its next beat,
    so the master drops the garbage at once and a scan after the vacuum
    submits nothing; the JAX master keeps the old garbage ratio until the
    full beat, and the scan submits the same vacuum again."""
    c = make_cluster(pkg, n=1, heartbeat_s=2.0)
    T = c.mods["tasks"]
    vid, payloads = c.fill("revac", n=8)
    for fid in list(payloads)[:6]:
        assert _http(c.servers[0].url, "DELETE", f"/{fid}")[0] == 202
    queue = T.TaskQueue()
    scanner = c.mods["admin"].MaintenanceScanner(
        c.master.grpc_address, queue,
        c.mods["admin"].MaintenancePolicy(ec_full_percent=1000.0, vacuum_garbage_ratio=0.3))
    created = []
    _wait(lambda: created.extend(scanner.scan_once()) or created, "the vacuum's submission")
    assert [(t.kind, t.volume_id) for t in created] == [(T.VACUUM, vid)]
    assert c.mods["admin"].Worker(c.master.grpc_address, queue=queue).run_one()
    if pkg == "port":
        node = next(iter(c.master.topology.nodes.values()))
        _wait(lambda: node.volumes[vid].deleted_bytes == 0, "the compacted volume at the master",
              timeout=1.5)
        assert scanner.scan_once() == []
    else:
        assert [(t.kind, t.volume_id) for t in scanner.scan_once()] == [(T.VACUUM, vid)]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_auto_vacuum_no_shell(pkg, make_cluster):
    c = make_cluster(pkg)
    mods = c.mods
    T = mods["tasks"]
    vid, payloads = c.fill("autovac", n=8)
    fids = list(payloads)

    def holder_url():
        return next(vs.url for vs in c.servers if vs.store.find_volume(vid) is not None)

    for fid in fids[:6]:  # 75% deleted: a garbage ratio far above 0.3
        assert _http(holder_url(), "DELETE", f"/{fid}")[0] in (200, 202, 204)

    def stat():
        for node in list(c.master.topology.nodes.values()):
            r = node.volumes.get(vid)
            if r is not None:
                return r
        return None

    _wait(lambda: stat() is not None and stat().deleted_bytes > 0, "the deletions at the master")
    size_before = stat().size
    queue = T.TaskQueue()
    scanner = mods["admin"].MaintenanceScanner(
        c.master.grpc_address, queue,
        mods["admin"].MaintenancePolicy(ec_full_percent=1000.0, vacuum_garbage_ratio=0.3))
    created = scanner.scan_once()
    assert [(t.kind, t.volume_id, t.params) for t in created] == [
        (T.VACUUM, vid, {"garbage_threshold": 0.3})]
    assert scanner.scan_once() == []  # no second task while the first is pending
    worker = mods["admin"].Worker(c.master.grpc_address, queue=queue, poll_interval=0.1)
    assert worker.run_one()
    task = queue.get(created[0].id)
    assert task.state is T.TaskState.COMPLETED, task.error
    _wait(lambda: (s := stat()) is not None and s.size < size_before and s.deleted_bytes == 0,
          "the compacted volume at the master")
    for fid in fids[6:]:
        assert _http(holder_url(), "GET", f"/{fid}")[:2] == (200, payloads[fid])
    for fid in fids[:6]:
        assert _http(holder_url(), "GET", f"/{fid}")[0] == 404


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("code", ["rs", "lrc"])
def test_auto_rebuild_no_shell(pkg, code, make_cluster):
    """The scanner encodes a full volume, a shard set is lost (RS: the
    two lowest shards of the fullest holder; LRC: shard 3 alone), and
    after two scans that see it degraded an EC_REBUILD task restores the
    shards byte-equal.  The LRC rebuild stages only shard 3's local group."""
    c = make_cluster(pkg, n=3)
    mods = c.mods
    T = mods["tasks"]
    scheme = mods["make_scheme"](10, 4, 2 if code == "lrc" else 0)
    collection = f"autoreb{code}"
    vid, payloads = c.fill(collection)
    admin = mods["admin"].AdminServer(c.master.grpc_address, policy=_auto_policy(mods))
    admin.start()
    worker = mods["admin"].Worker(c.master.grpc_address, admin_address=admin.url,
                                  poll_interval=0.2, scheme=scheme)
    worker.start()
    try:
        _wait(lambda: c.shard_count(vid) == 14 and c.view_is_disk(vid)
              and c.tasks(admin, T.EC_ENCODE) == [vid], "14 shards of the auto encode")
        assert c.master.topology.ec_schemes[vid] == (10, 4, 2 if code == "lrc" else 0)
        files = c.shard_files(f"{collection}_{vid}")
        want = {sid: _sha(p) for sid, p in files.items()}
        by_dir = {}
        for sid, p in files.items():
            by_dir.setdefault(os.path.dirname(p), []).append(sid)
        if code == "lrc":
            victim_dir, lost = os.path.dirname(files[3]), [3]
        else:
            victim_dir = max(by_dir, key=lambda d: len(by_dir[d]))
            lost = sorted(by_dir[victim_dir])[:2]
        holder = c.servers[c.dirs.index(victim_dir)]
        stub = rpc.volume_stub(f"{holder.ip}:{holder.grpc_port}")
        before = mods["stats"].REPAIR_BYTES.series()
        stub.EcShardsUnmount(vs_pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=lost),
                             timeout=30)
        stub.EcShardsDelete(vs_pb.EcShardsDeleteRequest(volume_id=vid, collection=collection,
                                                        shard_ids=lost), timeout=30)
        _wait(lambda: c.tasks(admin, T.EC_REBUILD) == [vid], "a completed ec_rebuild task")
        _wait(lambda: c.shard_count(vid) == 14 and c.view_is_disk(vid), "14 shards again")
        moved = _delta(mods["stats"].REPAIR_BYTES, before)
        assert not [t for t in admin.queue.all() if t.state.value == "failed"]
    finally:
        worker.stop()
        admin.stop()
    got = {sid: _sha(p) for sid, p in c.shard_files(f"{collection}_{vid}").items()}
    assert got == want
    for fid, data in payloads.items():
        assert c.read(fid) == (200, data), fid
    if code == "lrc":
        shard_size = os.path.getsize(files[0])
        staged = moved.get((("code", "lrc"), ("dir", "moved"), ("mode", "move")), 0.0)
        # the staging copies carry only shard 3's group (0, 1, 2, 4, 10)
        assert 0 < staged <= 5 * shard_size, (staged, shard_size)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ttl_volume_expiry_no_shell(pkg, make_cluster):
    """A TTL volume whose last write is older than its TTL is reclaimed
    (reference topology_vacuum.go TTL expiry); a fresh one is not."""
    c = make_cluster(pkg)
    mods = c.mods
    vid = c.master.topology.grow_volumes("ttlcol", "000", ttl=60)
    _wait(lambda: len(c.master.topology.lookup(vid)) == 1, "the TTL volume at the master")
    status, body, _ = _http(c.master.advertise, "GET", "/dir/assign?collection=ttlcol&ttl=60")
    assign = json.loads(body)
    assert int(assign["fid"].split(",")[0]) == vid
    assert _http(assign["url"], "POST", f"/{assign['fid']}", b"short-lived")[0] == 201
    admin = mods["admin"].AdminServer(c.master.grpc_address, port=0)
    admin.start()
    worker = mods["admin"].Worker(c.master.grpc_address, admin_address=admin.url,
                                  poll_interval=0.1)
    worker.start()
    try:
        created = admin.scanner.scan_once()
        assert not any(t.kind == "ttl_delete" for t in created)
        holder = next(s for s in c.servers if s.store.find_volume(vid))
        # rewind the holder's last-append clock two minutes: the scanner
        # reads it as VolumeStatus.last_modified_ns
        holder.store.find_volume(vid).last_append_at_ns -= 120 * 1_000_000_000
        created = admin.scanner.scan_once()
        assert [(t.kind, t.volume_id, t.params) for t in created
                if t.kind == "ttl_delete"] == [("ttl_delete", vid, {"ttl_seconds": 60})]
        _wait(lambda: all(s.store.find_volume(vid) is None for s in c.servers),
              "the expired volume dropped")
        _wait(lambda: not c.master.topology.lookup(vid), "the master forgets it")
        _wait(lambda: c.tasks(admin, "ttl_delete") == [vid], "a completed ttl_delete task")
    finally:
        worker.stop()
        admin.stop()


def _management_transcript(pkg: str, make_cluster, tmp_path) -> list:
    """Authenticated UI and API, session login, policy edits persisted,
    manual task create and cancel: (method, path, status, body) of every
    request."""
    c = make_cluster(pkg, n=1)
    cfg = str(tmp_path / "admin.json")
    admin = c.mods["admin"].AdminServer(c.master.grpc_address, port=0, username="op",
                                        password="hunter2", config_path=cfg)
    admin.start()
    out = []
    try:
        def call(method, path, payload=None, headers=None):
            body = json.dumps(payload).encode() if payload is not None else b""
            status, data, hdrs = _http(admin.url, method, path, body, headers)
            text = data.decode()
            out.append((method, path, status, json.loads(text) if text.startswith("{")
                        else ("Sign in" in text, "Maintenance tasks" in text)))
            return status, data, hdrs

        assert call("GET", "/status")[0] == 401
        assert call("GET", "/")[0] == 200
        assert call("POST", "/config", {"scan_interval": 1})[0] == 401
        assert call("POST", "/login", {"username": "op", "password": "wrong"})[0] == 403
        status, _, hdrs = call("POST", "/login", {"username": "op", "password": "hunter2"})
        assert status == 200
        sess = {"Cookie": hdrs["Set-Cookie"].split(";")[0]}
        assert hdrs["Set-Cookie"].endswith("; HttpOnly; SameSite=Strict; Path=/")
        basic = {"Authorization": "Basic " + base64.b64encode(b"op:hunter2").decode()}
        bad = {"Authorization": "Basic " + base64.b64encode(b"op:nope").decode()}
        assert call("GET", "/tasks", headers=basic)[0] == 200
        assert call("GET", "/tasks", headers=bad)[0] == 401
        assert call("GET", "/", headers=sess)[0] == 200
        assert call("POST", "/config", {"vacuum_garbage_ratio": 0.5, "enable_vacuum": False},
                    headers=sess)[0] == 200
        assert admin.scanner.policy.vacuum_garbage_ratio == 0.5
        assert admin.scanner.policy.enable_vacuum is False
        assert call("POST", "/config", {"no_such_knob": 1}, headers=sess)[0] == 400
        assert call("POST", "/config", {"enable_ec": "false"}, headers=sess)[0] == 400
        assert json.loads(open(cfg).read())["vacuum_garbage_ratio"] == 0.5
        status, data, _ = call("POST", "/tasks/create", {"kind": "vacuum", "volume_id": 424242},
                               headers=sess)
        assert status == 200
        tid = json.loads(data)["task"]["id"]
        assert call("POST", "/tasks/create", {"kind": "vacuum", "volume_id": 424242},
                    headers=sess)[0] == 409
        assert call("POST", "/tasks/create", {"kind": "nope", "volume_id": 1},
                    headers=sess)[0] == 400
        assert call("POST", "/tasks/cancel", {"task_id": tid}, headers=sess)[0] == 200
        assert call("POST", "/tasks/cancel", {"task_id": tid}, headers=sess)[0] == 400
        assert call("POST", "/tasks/create", {"kind": "vacuum", "volume_id": 424242},
                    headers=sess)[0] == 200
        call("GET", "/config", headers=sess)
        call("POST", "/tasks/create", {"volume_id": 1}, headers=sess)
        call("GET", "/no/such", headers=sess)
        call("POST", "/no/such", {}, headers=sess)
    finally:
        admin.stop()
    return out


def test_admin_auth_and_management_plane(make_cluster, tmp_path):
    got = {}
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        got[pkg] = _management_transcript(pkg, make_cluster, tmp_path / pkg)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_admin_config_persists_across_restart(pkg, make_cluster, tmp_path):
    c = make_cluster(pkg, n=1)
    cfg = str(tmp_path / "admin2.json")
    AdminServer = c.mods["admin"].AdminServer
    admin = AdminServer(c.master.grpc_address, port=0, password="pw", config_path=cfg)
    admin.start()
    try:
        tok = admin.login("admin", "pw")
        status, _, _ = _http(admin.url, "POST", "/config",
                             json.dumps({"ec_full_percent": 42.0, "scan_interval": 7}).encode(),
                             {"Cookie": f"weedtpu_admin_session={tok}"})
        assert status == 200
    finally:
        admin.stop()
    again = AdminServer(c.master.grpc_address, port=0, password="pw", config_path=cfg)
    assert again.scanner.policy.ec_full_percent == 42.0
    assert again.scanner.policy.scan_interval == 7.0
    assert again.config() == {"policy": json.loads(open(cfg).read()), "persisted": True}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_worker_authenticates_against_secured_admin(pkg, make_cluster):
    """The worker presents Basic credentials and completes a task against
    an auth-enabled admin; an unauthenticated claim is refused."""
    c = make_cluster(pkg, n=1)
    mods = c.mods
    vid, _payloads = c.fill("wauth", n=2, size=2000)
    admin = mods["admin"].AdminServer(c.master.grpc_address, port=0, password="fleetpw")
    admin.start()
    worker = None
    try:
        assert _http(admin.url, "POST", "/worker/claim",
                     json.dumps({"worker_id": "anon"}).encode())[0] == 401
        admin.queue.submit(mods["tasks"].VACUUM, vid, "wauth")
        worker = mods["admin"].Worker(c.master.grpc_address, admin_address=admin.url,
                                      poll_interval=0.2, http_auth=("admin", "fleetpw"))
        worker.start()
        _wait(lambda: c.tasks(admin, mods["tasks"].VACUUM) == [vid], "the vacuum task completed")
        status = admin.status()
        assert list(status["workers_seen_ago"]) == [worker.worker_id]
        assert status["tasks"] == {"completed": 1}
    finally:
        if worker is not None:
            worker.stop()
        admin.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_dashboard_and_topology_endpoint(pkg, make_cluster):
    c = make_cluster(pkg)
    c.fill("uicol", n=4)
    admin = c.mods["admin"].AdminServer(c.master.grpc_address, port=0)
    admin.start()
    try:
        status, body, hdrs = _http(admin.url, "GET", "/")
        assert status == 200 and hdrs["Content-Type"] == "text/html; charset=utf-8"
        assert body.decode() == JAX_DASHBOARD_HTML
        assert "http://" not in body.decode() and "https://" not in body.decode()
        status, body, _ = _http(admin.url, "GET", "/topology")
        assert status == 200
        topo = json.loads(body)
        assert len(topo["nodes"]) == 2
        assert sorted(n["id"] for n in topo["nodes"]) == sorted(vs.url for vs in c.servers)
        vols = [v for n in topo["nodes"] for v in n["volumes"]]
        assert vols and all(v["collection"] == "uicol" for v in vols)
        # file counts reach the master with the servers' full heartbeats
        _wait(lambda: sum(v["file_count"] for n in json.loads(_http(
            admin.url, "GET", "/topology")[1])["nodes"] for v in n["volumes"]) == 4,
            "the four files in the topology")
        assert all("free_slots" in n and n["ec_volumes"] == [] for n in topo["nodes"])
    finally:
        admin.stop()
