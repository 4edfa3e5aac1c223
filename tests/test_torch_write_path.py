"""The port's write path on the CPU, held against the JAX package.

- The topology's write half: the same nodes and the same seeded
  ``random`` give the JAX ``Topology``'s placements, fids, growth and
  errors.
- The volume's fsync policy: ``parse_fsync_policy`` as the JAX one,
  ``always`` syncing every write and ``interval`` at most once an interval,
  and a volume server started with ``fsync="always"`` acknowledging a POST
  only after its sync.
- The host helpers the HTTP plane rides: gzip compression, per-fid JWTs
  and Range parsing, each byte-identical to (or interchangeable with) the
  JAX package's.
- An in-process cluster of one port master and three port volume servers
  (``device="cpu"``) next to the same cluster of the JAX package (native
  data plane off): assign, write, read, lookup, delete, replicated writes,
  redirects, ranges, gzip, JWTs and ``ReadNeedleBlob`` answer with the same
  status codes and bodies; the JAX ``run_benchmark`` drives the port's
  cluster with no error, and the port's reports carry the JAX keys.

Every wait polls a condition with a deadline of at least 30 s."""

from __future__ import annotations

import http.client
import json
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.commands import benchmark_cmd as jax_bench
from seaweedfs_tpu.security import jwt as jax_jwt
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.storage import compression as jax_compression
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.super_block import ReplicaPlacement as JaxReplicaPlacement
from seaweedfs_tpu.topology import topology as jax_topology
from seaweedfs_tpu.util import http_range as jax_http_range
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.commands import benchmark_cmd
from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb
from seaweedfs_tpu_torch.security import jwt
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.storage import compression, volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.storage.types import get_actual_size
from seaweedfs_tpu_torch.topology import topology
from seaweedfs_tpu_torch.util import http_range
from seaweedfs_tpu_torch.wdclient import AssignError, MasterClient

from test_torch_shell import first_line

WAIT_S = 60.0
N_SERVERS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


# -- the topology's write half ------------------------------------------------


LAYOUT = [  # node id, data center, rack, max volumes, volumes already held
    ("n1", "dc1", "r1", 8, 0), ("n2", "dc1", "r1", 6, 2), ("n3", "dc1", "r2", 8, 1),
    ("n4", "dc1", "r2", 4, 0), ("n5", "dc2", "r3", 8, 3), ("n6", "dc2", "r3", 2, 0),
    ("n7", "dc2", "r4", 8, 0),
]


def _topologies(layout=LAYOUT):
    """The same cluster as a port and a JAX ``Topology``, whose volume
    allocations are recorded rather than sent."""
    out = []
    for mod in (topology, jax_topology):
        topo = mod.Topology(volume_size_limit=1 << 30)
        topo.allocated = []
        topo._allocate_on = lambda nodes, vid, *a, topo=topo, **k: topo.allocated.append(
            (vid, [n.id for n in nodes]))
        for nid, dc, rack, cap, held in layout:
            node = topo.register_node(mod.DataNode(nid, "10.0.0.1", int(nid[1:]), 18000,
                                                   data_center=dc, rack=rack,
                                                   max_volume_count=cap))
            topo.sync_full_volumes(node, [mod.VolumeRecord(id=1000 + 10 * int(nid[1:]) + i)
                                          for i in range(held)])
        out.append(topo)
    return out


@pytest.mark.parametrize("placement", ["000", "001", "010", "100"])
def test_choose_nodes_matches_jax(placement):
    port, ref = _topologies()
    for seed in range(40):
        random.seed(seed)
        got = [n.id for n in port._choose_nodes(ReplicaPlacement.parse(placement))]
        random.seed(seed)
        want = [n.id for n in ref._choose_nodes(JaxReplicaPlacement.parse(placement))]
        assert got == want, (placement, seed)
        assert len(got) == ReplicaPlacement.parse(placement).copy_count


def test_pick_for_write_grows_and_assigns_as_jax():
    port, ref = _topologies()
    now = int(time.time())
    for topo in (port, ref):
        topo._file_key = now << 20  # one clock for both
        topo.max_volume_id = 2000
    for collection, replication, count, growth in [("a", "000", 1, 1), ("a", "000", 16, 1),
                                                   ("b", "010", 4, 2), ("b", "010", 1, 1),
                                                   ("c", "001", 3, 1)]:
        picks = []
        for topo in (port, ref):
            random.seed(hash((collection, count)) & 0xFFFF)
            fid, nodes = topo.pick_for_write(count, collection, replication, 0,
                                             growth_count=growth)
            picks.append((fid, sorted(n.id for n in nodes)))
        assert picks[0] == picks[1]
        fid = picks[0][0]
        assert re.fullmatch(r"\d+,[0-9a-f]+[0-9a-f]{8}", fid)
        vid, key, cookie = volume_server.parse_fid(fid)
        assert (vid, key, cookie) == jax_vs.parse_fid(fid)
        # the batch convention: fid_i names key + i with the same cookie
        assert volume_server.parse_fid(f"{fid}_{count - 1}") == (vid, key + count - 1, cookie)
    assert port.allocated == ref.allocated
    assert [v for v, _ in port.allocated] == [2001, 2002, 2003, 2004]  # b grew 2 at once
    assert port.next_volume_id() == ref.next_volume_id() == 2005


def test_concurrent_assigns_on_an_empty_layout_grow_once():
    port, _ = _topologies()
    fids, errors = [], []

    def assign():
        try:
            fids.append(port.pick_for_write(1, "burst", "000", 0)[0])
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=assign) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(port.allocated) == 1 and len(set(fids)) == 16
    assert {volume_server.parse_fid(f)[0] for f in fids} == {port.allocated[0][0]}


def test_no_free_slots_and_unsatisfiable_placements_fail_as_jax():
    full = [("n1", "dc1", "r1", 2, 2), ("n2", "dc1", "r1", 1, 1)]
    for layout, placement in [(full, "000"), (LAYOUT, "030"), (LAYOUT[:2], "010")]:
        errs = []
        for topo in _topologies(layout):
            random.seed(3)
            with pytest.raises(RuntimeError) as e:
                topo.pick_for_write(1, "x", placement, 0)
            errs.append(str(e.value))
            assert not topo.allocated and all(n.reserved == 0 for n in topo.nodes.values())
        assert errs[0] == errs[1]
    assert errs[0].startswith("placement unsatisfiable")


def test_growth_reservations_count_against_free_slots():
    port, _ = _topologies([("n1", "dc1", "r1", 2, 0)])
    node = port.nodes["n1"]
    seen = []
    port._allocate_on = lambda nodes, *a, **k: seen.append(
        (node.reserved, node.free_slots(), node.free_slots("hdd")))
    port.grow_volumes("r", "000", 0)
    assert seen == [(1, 1, 1)] and node.reserved == 0 and node.free_slots() == 1


# -- the fsync policy ---------------------------------------------------------


@pytest.mark.parametrize("spec", ["", "always", "ALWAYS", "interval", "interval:0.25", " close ",
                                  "never", "interval:0", "interval:-1", "sometimes", "interval:x"])
def test_parse_fsync_policy_matches_jax(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(volume.parse_fsync_policy) == run(jax_volume.parse_fsync_policy)


def _spy_syncs(monkeypatch, calls: list) -> None:
    real = volume.Volume.sync

    def spy(self):
        calls.append(self.file_count())
        real(self)

    monkeypatch.setattr(volume.Volume, "sync", spy)


def test_always_syncs_every_write_and_interval_at_most_once_an_interval(tmp_path, monkeypatch):
    calls: list = []
    _spy_syncs(monkeypatch, calls)
    v = volume.Volume(tmp_path, 1, fsync="always")
    for i in range(5):
        v.write_needle(Needle(id=i + 1, cookie=7, data=b"x" * (i + 1)))
        assert calls[-1] == i + 1  # synced with this needle in the index
    v.delete_needle(3)
    assert len(calls) == 6
    v.close()

    clock = [100.0]
    monkeypatch.setattr(volume, "time", types.SimpleNamespace(monotonic=lambda: clock[0],
                                                              time_ns=time.time_ns))
    calls.clear()
    v = volume.Volume(tmp_path, 2, fsync="interval:2")
    for step in [0.5, 0.5, 0.5, 1.0, 0.1, 0.1, 3.0, 0.1]:
        clock[0] += step
        v.write_needle(Needle(id=int(clock[0] * 10), cookie=1, data=b"y"))
    # 100 -> writes at 100.5 .. 106.8: syncs once 2 s have passed since the
    # last (102.5), then at 105.7; never twice within one interval
    assert calls == [4, 7]
    v.close()
    calls.clear()
    v = volume.Volume(tmp_path, 3, fsync="close")
    v.write_needle(Needle(id=1, cookie=1, data=b"z"))
    assert calls == []
    v.close()


def test_fsync_always_acknowledges_a_post_only_after_its_sync(tmp_path, monkeypatch):
    calls: list = []
    _spy_syncs(monkeypatch, calls)
    ms = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    ms.start()
    vs = volume_server.VolumeServer([str(tmp_path)], ms.grpc_address, port=0, grpc_port=0,
                                    heartbeat_interval=0.2, device="cpu", fsync="always")
    vs.start()
    try:
        _wait(lambda: ms.topology.nodes, "the heartbeat")
        for i in range(6):
            a = MasterClient(ms.grpc_address).assign(collection="durable")
            status, _ = _http(a.location.url, "POST", f"/{a.fid}", b"d" * (100 + i))
            assert status == 201
            vol = vs.store.find_volume(volume_server.parse_fid(a.fid)[0])
            assert len(calls) == i + 1 and calls[-1] == vol.file_count() == i + 1
    finally:
        vs.stop()
        ms.stop()


def test_a_bad_fsync_policy_is_refused_at_construction(tmp_path):
    with pytest.raises(ValueError, match="unknown fsync policy"):
        volume_server.VolumeServer([str(tmp_path)], port=0, device="cpu", fsync="often")


# -- compression, JWTs, ranges --------------------------------------------------


def test_compression_is_byte_identical_to_jax():
    rng = np.random.default_rng(11)
    mimes = ["", "text/plain", "application/json; charset=utf-8", "image/png", "image/svg+xml",
             "application/octet-stream", "TEXT/HTML"]
    names = ["", "a.txt", "b.JSON", "c.jpg", "d.gz", "e.bin", "f.csv"]
    words = [b"seaweed ", b"needle ", b"volume ", b"shard "]
    for i in range(60):
        n = int(rng.integers(0, 4096))
        if i % 3 == 0:
            data = rng.bytes(n)  # incompressible
        else:
            data = b"".join(words[j] for j in rng.integers(0, 4, n // 6 + 1))[:n]
        mime, name = mimes[i % len(mimes)], names[(i // 2) % len(names)]
        assert compression.maybe_compress(data, mime, name) == jax_compression.maybe_compress(
            data, mime, name)
        assert compression.is_gzippable(mime, name) == jax_compression.is_gzippable(mime, name)
        assert compression.compress(data) == jax_compression.compress(data)
        assert compression.decompress(jax_compression.compress(data)) == data


def test_jwts_cross_verify_and_refuse_alike():
    key, fid = "secret", "3,01637037d6"
    for sign, verify in [(jwt.sign_fid, jax_jwt.verify_fid), (jax_jwt.sign_fid, jwt.verify_fid)]:
        token = sign(key, fid)
        verify(key, token, fid)
        verify(key, token, fid + "_7")  # a batch token covers fid_N
    for mod in (jwt, jax_jwt):
        for token, target, why in [(mod.sign_fid(key, fid), "3,01637037d7", "does not cover"),
                                   (mod.sign_fid(key, fid, ttl_s=-5), fid, "token expired"),
                                   (mod.sign_fid("other", fid), fid, "bad signature"),
                                   ("garbage", fid, "malformed token"),
                                   ("", fid, "missing write token")]:
            for verify in (jwt.verify_fid, jax_jwt.verify_fid):
                with pytest.raises((jwt.JwtError, jax_jwt.JwtError), match=why):
                    verify(key, token, target)


RANGES = ["", None, "bytes=0-0", "bytes=0-99", "bytes=10-", "bytes=-10", "bytes=-0", "bytes=5-3",
          "bytes=100-", "bytes=99-200", "bytes=0-1,5-6", "bytes=a-b", "items=0-1", "bytes=-",
          "bytes=-500", "bytes= 3-4", "bytes=0-"]


@pytest.mark.parametrize("size", [0, 1, 100])
def test_parse_range_matches_jax(size):
    def run(mod, header):
        try:
            return mod.parse_range(header, size)
        except mod.RangeNotSatisfiable as e:
            return ("416", e.size, str(e))

    for header in RANGES:
        assert run(http_range, header) == run(jax_http_range, header), header


def _png(width: int, height: int, seed: int) -> bytes:
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
    out = io.BytesIO()
    img.save(out, format="PNG")
    return out.getvalue()


def test_resize_matches_jax_and_serves_the_original_without_pillow(monkeypatch):
    from seaweedfs_tpu.images import resize_image as jax_resize_image
    from seaweedfs_tpu_torch.images import resize_image

    png = _png(40, 30, 5)
    for args in [(10, 0, "fit"), (0, 12, "fit"), (16, 16, "fill"), (0, 0, "fit")]:
        got = resize_image(png, *args)
        assert got == jax_resize_image(png, *args)
        assert got[1] == "image/png"
    assert resize_image(b"not an image", 10, 10) == (b"not an image", "application/octet-stream")
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow absent
    assert resize_image(png, 10, 0) == (png, "image/png")


# -- the HTTP plane against the JAX package's -----------------------------------


def _http(addr: str, method: str, path: str, body: bytes = b"", headers: dict | None = None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out = resp.status, data
    if headers is not None:
        out += ({k: v for k, v in resp.getheaders()},)
    conn.close()
    return out


class _Cluster:
    def __init__(self, master, servers, dirs):
        self.master, self.servers, self.dirs = master, servers, dirs

    def assign(self, query: str = "") -> dict:
        status, body = _http(self.master.advertise, "GET", f"/dir/assign{query}")
        assert status == 200, body
        return json.loads(body)

    def holders(self, vid: int) -> list:
        return [vs for vs in self.servers if vs.store.find_volume(vid) is not None]


def _start_cluster(ms_mod, vs_mod, jwt_key: str = "", **vs_kwargs) -> _Cluster:
    master = ms_mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64, jwt_key=jwt_key)
    master.start()
    dirs, servers = [], []
    for i in range(N_SERVERS):
        dirs.append(tempfile.mkdtemp(prefix=f"torch-write-{i}-"))
        vs = vs_mod.VolumeServer([dirs[-1]], master.grpc_address, port=0, grpc_port=0,
                                 rack=f"rack{i % 2}", heartbeat_interval=0.2, jwt_key=jwt_key,
                                 **vs_kwargs)
        vs.start()
        servers.append(vs)
    _wait(lambda: len(master.topology.nodes) == N_SERVERS, "every server's heartbeat")
    return _Cluster(master, servers, dirs)


def _stop_cluster(c: _Cluster) -> None:
    for vs in c.servers:
        vs.stop()
    c.master.stop()
    for d in c.dirs:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def clusters():
    """{"port": the port's cluster, "jax": the JAX package's (Python data
    plane: its native plane off)}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
        mp.setenv("WEED_SCRUB_INTERVAL", "0")
        made = {}
        try:
            made["port"] = _start_cluster(master_server, volume_server, device="cpu")
            made["jax"] = _start_cluster(jax_ms, jax_vs)
            yield made
        finally:
            for c in made.values():
                _stop_cluster(c)


def _both(clusters, script) -> dict:
    """Run ``script(cluster)`` against both clusters; their transcripts must
    be equal."""
    got = {name: script(c) for name, c in clusters.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_assign_write_read_delete_as_jax(clusters):
    def script(c):
        a = c.assign()
        fid, url = a["fid"], a["url"]
        vid = fid.split(",")[0]
        out = [sorted(a), a["count"], a["publicUrl"] == url]
        payload = b"hello weedtpu" * 100
        out.append(_http(url, "POST", f"/{fid}", payload))
        out.append(_http(url, "GET", f"/{fid}"))
        status, body = _http(c.master.advertise, "GET", f"/dir/lookup?volumeId={vid}")
        out.append((status, json.loads(body) == {"volumeId": vid, "locations": [
            {"url": url, "publicUrl": url}]}))
        out.append(_http(c.master.advertise, "GET", "/dir/lookup?volumeId=999"))
        out.append(_http(url, "DELETE", f"/{fid}"))
        out.append(_http(url, "GET", f"/{fid}"))
        out.append(_http(url, "DELETE", f"/{fid}"))
        out.append(_http(url, "GET", f"/{vid},1234"))  # malformed fid
        out.append(_http(url, "POST", f"/{vid},zz", b"x")[0])
        a2 = c.assign()
        _http(a2["url"], "POST", f"/{a2['fid']}", b"cookie")
        wrong_cookie = f"{a2['fid'][:-8]}{(int(a2['fid'][-8:], 16) ^ 1):08x}"
        out.append(_http(a2["url"], "GET", f"/{wrong_cookie}"))
        return out

    got = _both(clusters, script)
    assert got[3] == (201, b'{"size": %d}' % (4 + 1300 + 1 + 5))  # size, data, flags, mtime
    assert got[4] == (200, b"hello weedtpu" * 100)
    assert got[6] == (404, b'{"volumeId": "999", "error": "not found"}')
    assert got[7] == (202, b"{}") and got[8] == (404, b"not found")


def test_replicated_write_is_on_both_holders_as_jax(clusters):
    def script(c):
        a = c.assign("?replication=001&collection=rep")
        vid = int(a["fid"].split(",")[0])
        out = [_http(a["url"], "POST", f"/{a['fid']}", b"replica me")]
        holders = c.holders(vid)
        out.append(len(holders))
        out += [_http(vs.url, "GET", f"/{a['fid']}") for vs in holders]
        status, body = _http(c.master.advertise, "GET", f"/dir/lookup?volumeId={vid}")
        out.append(sorted(l["url"] for l in json.loads(body)["locations"])
                   == sorted(vs.url for vs in holders))
        # a replicated delete leaves neither copy
        out.append(_http(a["url"], "DELETE", f"/{a['fid']}"))
        out += [_http(vs.url, "GET", f"/{a['fid']}") for vs in holders]
        return out

    got = _both(clusters, script)
    assert got[1] == 2 and got[2] == got[3] == (200, b"replica me") and got[4]


def test_a_transient_lookup_failure_does_not_fail_a_replicated_write(clusters):
    """The primary's master lookup for the replica holders answers
    UNAVAILABLE once (a channel re-dialling under load; injected by the
    fault harness on the stub): the stub retries the lookup, as the JAX
    package's stubs retry it, and the write is acknowledged on both holders
    instead of failing "replication short"."""
    from seaweedfs_tpu_torch.util import faults

    c = clusters["port"]
    a = c.assign("?replication=001&collection=flaky")
    vid = int(a["fid"].split(",")[0])
    primary = next(vs for vs in c.servers if vs.url == a["url"])
    primary._lookup_cache.pop(vid, None)
    glob = c.master.grpc_address.replace(":", "#")
    plan = faults.configure(f"client/master@{glob}:LookupVolume:unavailable:x1", seed=0)
    try:
        assert _http(a["url"], "POST", f"/{a['fid']}", b"retried")[0] == 201
        assert plan.snapshot()[0]["fired"] == 1
    finally:
        faults.reset()
    assert [_http(vs.url, "GET", f"/{a['fid']}") for vs in c.holders(vid)] == [
        (200, b"retried")] * 2


def test_redirect_range_head_and_gzip_as_jax(clusters):
    def script(c):
        a = c.assign("?collection=shape")
        fid, url = a["fid"], a["url"]
        text = b"the quick brown fox jumps over the lazy dog\n" * 40
        out = [_http(url, "POST", f"/{fid}?name=fox.txt", text)]
        out.append(_http(url, "GET", f"/{fid}", headers={"Range": "bytes=4-8"})[:2])
        out.append(_http(url, "GET", f"/{fid}", headers={"Range": "bytes=-3"})[:2])
        status, body, hdr = _http(url, "GET", f"/{fid}", headers={"Range": "bytes=99999-"})
        out.append((status, body, hdr.get("Content-Range")))
        status, body, hdr = _http(url, "HEAD", f"/{fid}", headers={})
        out.append((status, body, hdr.get("Content-Length")))
        status, body, hdr = _http(url, "GET", f"/{fid}", headers={"Accept-Encoding": "gzip"})
        out.append((status, compression.decompress(body) == text, hdr.get("Content-Encoding")))
        other = next(vs for vs in c.servers if vs.url != url)
        status, body, hdr = _http(other.url, "GET", f"/{fid}", headers={})
        out.append((status, hdr.get("Location") == f"http://{url}/{fid}"))
        out.append(_http(other.url, "GET", "/777,0123456789ab"))
        out.append(_http(url, "GET", "/status")[0])
        img = c.assign("?collection=shape")
        _http(img["url"], "POST", f"/{img['fid']}", _png(40, 30, 6))
        out.append(_http(img["url"], "GET", f"/{img['fid']}?width=10&height=x"))
        return out

    got = _both(clusters, script)
    assert got[0][0] == 201 and int(json.loads(got[0][1])["size"]) < 1760  # gzip on write
    assert got[1] == (206, b"quick") and got[2] == (206, b"og\n")
    assert got[3] == (416, b"", "bytes */1760") and got[4] == (200, b"", "1760")
    assert got[5] == (200, True, "gzip") and got[6] == (302, True)
    assert got[9][0] == 200 and got[9][1] != _png(40, 30, 6)  # resized


def test_metrics_count_the_requests(clusters):
    c = clusters["port"]
    a = c.assign("?collection=counted")
    _http(a["url"], "POST", f"/{a['fid']}", b"m" * 10)
    _http(a["url"], "GET", f"/{a['fid']}")
    _http(a["url"], "DELETE", f"/{a['fid']}")
    status, body = _http(a["url"], "GET", "/metrics")
    text = body.decode()
    assert status == 200
    for kind in ("read", "write", "delete"):
        assert re.search(rf'weedtpu_volume_server_request_total{{type="{kind}"}} [1-9]', text)
    assert 'weedtpu_volume_server_request_seconds_count{type="write"}' in text
    status, body = _http(c.master.advertise, "GET", "/metrics")
    assert status == 200 and "# TYPE weedtpu_master_request_total counter" in body.decode()


def test_read_needle_blob_is_the_dat_record(clusters):
    c = clusters["port"]
    a = c.assign("?collection=blob")
    payload = bytes(range(256)) * 3
    assert _http(a["url"], "POST", f"/{a['fid']}", payload)[0] == 201
    vid, nid, cookie = volume_server.parse_fid(a["fid"])
    vs = c.holders(vid)[0]
    vol = vs.store.find_volume(vid)
    nv = vol.nm.get(nid)
    with open(vol.base + ".dat", "rb") as f:
        f.seek(nv.offset)
        record = f.read(get_actual_size(nv.size, vol.version))
    stub = rpc.volume_stub(f"{vs.ip}:{vs.grpc_port}")
    by_id = stub.ReadNeedleBlob(pb.ReadNeedleBlobRequest(volume_id=vid, needle_id=nid, offset=-1),
                                timeout=30).needle_blob
    by_offset = stub.ReadNeedleBlob(pb.ReadNeedleBlobRequest(
        volume_id=vid, offset=nv.offset, size=len(record)), timeout=30).needle_blob
    assert by_id == by_offset == record
    n = Needle.from_bytes(record, vol.version)
    assert (n.id, n.cookie, n.data) == (nid, cookie, payload)
    with pytest.raises(Exception, match="not in volume"):
        stub.ReadNeedleBlob(pb.ReadNeedleBlobRequest(volume_id=vid, needle_id=nid + 999,
                                                     offset=-1), timeout=30)


def test_master_client_assigns_and_caches_lookups(clusters):
    c = clusters["port"]
    mc = MasterClient(c.master.grpc_address)
    a = mc.assign(count=4, collection="mc")
    fids = [a.fid] + [f"{a.fid}_{i}" for i in range(1, 4)]
    assert a.count == 4 and volume_server.parse_fid(fids[3])[1] == volume_server.parse_fid(a.fid)[1] + 3
    for fid in fids:
        assert _http(a.location.url, "POST", f"/{fid}", fid.encode())[0] == 201
        assert _http(mc.lookup_file_id(fid), "GET", f"/{fid}") == (200, fid.encode())
    vid = int(a.fid.split(",")[0])
    assert mc.lookup(vid) == [a.location.url]
    c.master.topology.lookup = lambda *_a, **_k: []  # the cache answers without the master
    try:
        assert mc.lookup(vid) == [a.location.url]
        mc.invalidate(vid)
        assert mc.lookup(vid) == []
        with pytest.raises(KeyError, match=f"volume {vid} not found"):
            mc.lookup_file_id(a.fid)
    finally:
        del c.master.topology.lookup
    with pytest.raises(AssignError, match="invalid replica placement"):
        mc.assign(replication="9x")


def test_volume_grow_rpc_adds_writable_volumes(clusters):
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb

    c = clusters["port"]
    resp = rpc.master_stub(c.master.grpc_address).VolumeGrow(
        m_pb.VolumeGrowRequest(collection="grown", replication="010", count=2), timeout=30)
    assert len(resp.volume_ids) == 2
    for vid in resp.volume_ids:
        holders = c.holders(vid)
        assert len(holders) == 2 and len({vs.rack for vs in holders}) == 2


def test_jwt_guards_writes_in_both_packages():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
        mp.setenv("WEED_SCRUB_INTERVAL", "0")
        made = {}
        try:
            made["port"] = _start_cluster(master_server, volume_server, jwt_key="k1", device="cpu")
            made["jax"] = _start_cluster(jax_ms, jax_vs, jwt_key="k1")

            def script(c):
                a = c.assign("?replication=001")
                fid, url, auth = a["fid"], a["url"], a["auth"]
                out = [_http(url, "POST", f"/{fid}", b"nope")]
                out.append(_http(url, "POST", f"/{fid}?jwt={auth}", b"signed")[0])
                out.append([_http(vs.url, "GET", f"/{fid}")
                            for vs in c.holders(int(fid.split(",")[0]))])
                out.append(_http(url, "DELETE", f"/{fid}")[0])
                out.append(_http(url, "DELETE", f"/{fid}",
                                 headers={"Authorization": f"Bearer {auth}"})[:2])
                return out

            got = _both(made, script)
            assert got[0] == (401, b"missing write token") and got[1] == 201
            assert got[2] == [(200, b"signed")] * 2 and got[3] == 401 and got[4] == (202, b"{}")
        finally:
            for c in made.values():
                _stop_cluster(c)


def test_jax_run_benchmark_drives_the_ports_cluster(clusters):
    c = clusters["port"]
    reports = jax_bench.run_benchmark(c.master.grpc_address, count=200, size=1024,
                                      concurrency=4, collection="jaxbench")
    assert [r["phase"] for r in reports] == ["write", "read"]
    assert all(r["errors"] == 0 and r["requests"] == 200 for r in reports), reports
    reports = jax_bench.run_benchmark(c.master.grpc_address, count=40, size=512, concurrency=4,
                                      collection="jaxrep", replication="001")
    assert all(r["errors"] == 0 and r["requests"] == 40 for r in reports), reports


def test_the_ports_run_benchmark_reports_the_jax_keys(clusters):
    got = benchmark_cmd.run_benchmark(clusters["port"].master.grpc_address, count=120, size=2048,
                                      concurrency=4, collection="portbench", assign_batch=8)
    want = jax_bench.run_benchmark(clusters["jax"].master.grpc_address, count=120, size=2048,
                                   concurrency=4, collection="portbench", assign_batch=8)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert all(r["errors"] == 0 and r["requests"] == 120 for r in got + want), (got, want)
    assert got[0]["mb_per_sec"] > 0 and got[1]["p99_ms"] >= got[1]["p50_ms"]


def test_cli_benchmark_against_cli_servers(tmp_path):
    """``cli master``, two ``cli volume -device cpu -fsync always -jwtKey``
    and ``cli benchmark`` as subprocesses: every write and read answered."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    cli = [sys.executable, "-m", "seaweedfs_tpu_torch.cli"]
    procs = []

    def start(args: list[str], pattern: str) -> re.Match:
        procs.append(subprocess.Popen(cli + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env))
        line = first_line(procs[-1]).strip()
        bound = re.search(pattern, line)
        assert bound, (line, procs[-1].stderr.read() if procs[-1].poll() is not None else "")
        return bound

    try:
        bound = start(["master", "-port", "0", "-jwtKey", "k2"],
                      r"gRPC on (127\.0\.0\.1:\d+), HTTP on (127\.0\.0\.1:\d+)$")
        maddr, mhttp = bound[1], bound[2]
        for i in range(2):
            d = tmp_path / f"v{i}"
            d.mkdir()
            start(["volume", "-dir", str(d), "-mserver", maddr, "-port", "0", "-device", "cpu",
                   "-fsync", "always", "-jwtKey", "k2", "-rack", f"rack{i}"],
                  r"^volume server HTTP on 127\.0\.0\.1:\d+, gRPC on 127\.0\.0\.1:\d+ "
                  r"\(device cpu\)$")
        _wait(lambda: len(json.loads(_http(mhttp, "GET", "/dir/assign")[1]).get("fid", "")) > 0,
              "a writable volume at the master")
        run = subprocess.run(cli + ["benchmark", "-master", maddr, "-n", "300", "-size", "700",
                                    "-c", "4", "-collection", "clibench"],
                             capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr
        reports = [json.loads(line) for line in run.stdout.splitlines()]
        assert [(r["phase"], r["requests"], r["errors"]) for r in reports] == [
            ("write", 300, 0), ("read", 300, 0)]
    finally:
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
    assert rcs == [0, 0, 0], [p.stderr.read() for p in procs]
