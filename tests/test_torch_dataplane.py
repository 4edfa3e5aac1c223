"""The port's native data plane (csrc/dp.cpp + native/dataplane.py) on the
CPU, held against the JAX package's (seaweedfs_tpu/native).  Each package
builds its plane from its own sources here (g++), and both volume servers
run with the plane on, the default.

- The same POST/DELETE script leaves the same ``.idx`` bytes and the same
  ``.dat`` bytes (the two clock fields of each record, last-modified and
  append time, masked) on every needle-map kind and at 5-byte offsets.
- GET, HEAD, ranged GETs, a cookie mismatch, a missing needle and a query
  string that forwards answer with the same status, body and framing
  headers, each reply with an ``X-Request-ID``.
- EC GETs: served natively from local shards, forwarded when a shard is
  not local (the Python path reconstructs), and in the port a short read
  answers 503; an EC DELETE is forwarded (the native DELETE takes normal
  volumes only).
- 001 writes fan out natively to the replica and fail loudly (500) when a
  replica is down; vacuum interleaves with native writes; a Python-side
  read sees a native write at once; traced native requests land in the
  trace ring; ``/metrics`` carries the plane's families.
- ``disk:`` fault rules: the JAX plane's native append skips them (the
  rule never fires); the port keeps the plane off every volume while one
  is armed, so the rule fires as with the plane off.
- The opt-out variables, a failed build that raises at start, and the
  ``// py:`` ABI markers of the port's dp.cpp against its dataplane.py.

Every wait polls a condition with a deadline."""

from __future__ import annotations

import ast
import hashlib
import http.client
import os
import re
import shutil
import struct
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu import rpc as jax_rpc
from seaweedfs_tpu.native import dataplane as jax_dp
from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.stats import trace as jax_trace
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.native import dataplane
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage.needle import (
    FLAG_HAS_LAST_MODIFIED,
    FLAG_HAS_MIME,
    FLAG_HAS_NAME,
)
from seaweedfs_tpu_torch.storage.types import Version
from seaweedfs_tpu_torch.storage.needle import body_length
from seaweedfs_tpu_torch.util import faults
from seaweedfs_tpu_torch.wdclient import MasterClient

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 30.0

PKGS = {
    "port": dict(ms=master_server, vs=volume_server, mc=MasterClient, rpc=rpc, pb=vs_pb,
                 dp=dataplane, trace=trace, faults=faults, kw={"device": "cpu"}),
    "jax": dict(ms=jax_ms, vs=jax_vs, mc=JaxMasterClient, rpc=jax_rpc, pb=jax_vs_pb,
                dp=jax_dp, trace=jax_trace, faults=jax_faults, kw={}),
}


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _http(addr: str, method: str, path: str, body: bytes = b"", headers: dict | None = None,
          timeout: float = 30.0):
    """One request on a fresh connection -> (status, {lower header: value}, body)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
    finally:
        conn.close()


def _fid(vid: int, key: int, cookie: int) -> str:
    return f"{vid},{key:x}{cookie:08x}"


class _Cluster:
    def __init__(self, pkg: str, n: int, root: str, **vs_kw):
        m = PKGS[pkg]
        self.pkg = pkg
        self.master = m["ms"].MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        self.master.start()
        self.servers = []
        for i in range(n):
            d = os.path.join(root, f"{pkg}{i}")
            os.makedirs(d)
            vs = m["vs"].VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                      heartbeat_interval=0.2, max_volume_counts=[16],
                                      **m["kw"], **vs_kw)
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == n, f"{pkg} volume servers to register")
        self.mc = m["mc"](self.master.grpc_address)

    def holder(self, vid: int):
        return next(vs for vs in self.servers if vs.store.find_volume(vid) is not None)

    def stop(self) -> None:
        for vs in self.servers:
            vs.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def clusters():
    """{"port": two port volume servers (device cpu), "jax": two JAX ones},
    each behind its own master, the native plane on in all four."""
    mp = pytest.MonkeyPatch()
    mp.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    mp.delenv("SEAWEEDFS_TPU_NATIVE_PX", raising=False)
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-dataplane-")
    made = {}
    try:
        for pkg in PKGS:
            made[pkg] = _Cluster(pkg, 2, root)
        yield made
    finally:
        for c in made.values():
            c.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _both(fn) -> dict:
    return {pkg: fn(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def masters():
    """A master of each package for the single volume servers below (they
    come and go; the two-server clusters' masters must not see them)."""
    made = {pkg: PKGS[pkg]["ms"].MasterServer(port=0, grpc_port=0) for pkg in PKGS}
    for m in made.values():
        m.start()
    yield made
    for m in made.values():
        m.stop()


def _solo(pkg: str, masters, d, **kw):
    """One volume server of ``pkg`` behind that package's solo master."""
    m = PKGS[pkg]
    os.makedirs(d, exist_ok=True)
    vs = m["vs"].VolumeServer([str(d)], masters[pkg].grpc_address, port=0, grpc_port=0,
                              heartbeat_interval=0.2, max_volume_counts=[16], **m["kw"], **kw)
    vs.start()
    return vs


# -- the plane is on, and its ABI ------------------------------------------------


def test_the_plane_fronts_every_volume_server(clusters):
    for pkg, c in clusters.items():
        for vs in c.servers:
            assert vs._dp is not None, pkg
            assert vs.port == vs._dp.port, pkg
            # the Python handler moved to a loopback port behind the loop
            assert vs._http_server.server_address[0] == "127.0.0.1"
            assert vs._http_server.server_address[1] != vs.port


_CPP_CONST_RE = re.compile(r"constexpr\s+\w+\s+k\w+\s*=\s*(-?\d+)\s*;\s*//\s*py:\s*(_\w+)")
_CPP_SIZE_RE = re.compile(r"static_assert\(\s*sizeof\(\w+\)\s*==\s*(\d+)\b[^;]*;\s*//\s*py:\s*(_\w+)")


def _cpp_markers(path: Path) -> dict[str, int]:
    out = {}
    for line in path.read_text().splitlines():
        m = _CPP_CONST_RE.search(line) or _CPP_SIZE_RE.search(line)
        if m is not None:
            out[m.group(2)] = int(m.group(1))
    return out


def _py_mirrors(path: Path) -> dict[str, int]:
    """Module-level int constants and struct.Struct sizes of a module."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name, v, sign = node.targets[0].id, node.value, 1
        if isinstance(v, ast.UnaryOp) and isinstance(v.op, ast.USub):
            v, sign = v.operand, -1
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            out[name] = sign * v.value
        elif (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
              and v.func.attr == "Struct" and v.args and isinstance(v.args[0], ast.Constant)):
            out[name] = struct.calcsize(v.args[0].value)
    return out


def test_abi_markers_mirror_the_port_dataplane():
    """Every ``// py: _NAME`` marker of the port's dp.cpp has a module-level
    mirror of the same value in the port's native/dataplane.py (the check
    weedlint's W013 makes for the JAX package), and the port's markers are
    the JAX package's."""
    cpp = _cpp_markers(REPO / "seaweedfs_tpu_torch" / "csrc" / "dp.cpp")
    py = _py_mirrors(REPO / "seaweedfs_tpu_torch" / "native" / "dataplane.py")
    assert len(cpp) == 14, cpp
    for name, want in cpp.items():
        assert name in py, f"dp.cpp marker py: {name} has no mirror in dataplane.py"
        assert py[name] == want, (name, py[name], want)
    assert cpp == _cpp_markers(REPO / "seaweedfs_tpu" / "native" / "dp.cpp")


def test_the_abi_check_catches_drift(tmp_path):
    cpp = tmp_path / "dp.cpp"
    cpp.write_text("constexpr int64_t kPxNoSend = -7;       // py: _PX_NO_SEND\n"
                   "static_assert(sizeof(Event) == 41, \"e\");  // py: _EVENT\n")
    py = _py_mirrors(REPO / "seaweedfs_tpu_torch" / "native" / "dataplane.py")
    got = _cpp_markers(cpp)
    assert got == {"_PX_NO_SEND": -7, "_EVENT": 41}
    assert [n for n, v in got.items() if py[n] != v] == ["_PX_NO_SEND", "_EVENT"]


# -- .dat / .idx byte identity ----------------------------------------------------


def _masked_dat(dat: bytes) -> bytes:
    """The .dat with each v3 record's two clock fields zeroed: the 5-byte
    last-modified stamp and the 8-byte append time after the CRC."""
    out = bytearray(dat)
    off = 8  # superblock
    while off + 16 <= len(dat):
        size = int.from_bytes(dat[off + 12:off + 16], "big", signed=True)
        total = 16 + body_length(max(size, 0), Version.V3)
        if size > 0:
            p = off + 16
            p += 4 + int.from_bytes(dat[p:p + 4], "big")
            flags = dat[p]
            p += 1
            if flags & FLAG_HAS_NAME:
                p += 1 + dat[p]
            if flags & FLAG_HAS_MIME:
                p += 1 + dat[p]
            if flags & FLAG_HAS_LAST_MODIFIED:
                out[p:p + 5] = bytes(5)
        tail = off + 16 + max(size, 0) + 4
        out[tail:tail + 8] = bytes(8)
        off += total
    assert off == len(dat), (off, len(dat))
    return bytes(out)


def _write_script(addr: str, vid: int, seed: int) -> list:
    """POSTs of 24 seeded needles (one compressible text body, which the
    plane forwards to Python's gzip heuristic), 3 overwrites, 6 deletes and
    one delete of an absent key; returns every (status, body)."""
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.choice(np.arange(1, 1 << 20), 24, replace=False)]
    cookies = {k: int(c) for k, c in zip(keys, rng.integers(1, 1 << 32, 24))}
    out = []
    for i, k in enumerate(keys):
        body = rng.bytes(int(rng.integers(1, 6000)))
        headers = {}
        if i == 5:
            body, headers = b"all work and no play " * 200, {"Content-Type": "text/plain"}
        st, _, b = _http(addr, "POST", "/" + _fid(vid, k, cookies[k]), body, headers)
        out.append((st, b))
    for k in keys[:3]:
        st, _, b = _http(addr, "POST", "/" + _fid(vid, k, cookies[k]), rng.bytes(777))
        out.append((st, b))
    for k in keys[3:9] + [123456789]:
        st, _, b = _http(addr, "DELETE", "/" + _fid(vid, k, cookies.get(k, 1)))
        out.append((st, b))
    for k in keys + [123456789]:
        st, _, b = _http(addr, "GET", "/" + _fid(vid, k, cookies.get(k, 1)))
        out.append((st, hashlib.sha256(b).hexdigest()))
    return out


@pytest.mark.parametrize("kind,width", [("memory", 4), ("compact", 4), ("leveldb", 4),
                                        ("memory", 5)])
def test_dat_and_idx_match_the_jax_plane(masters, tmp_path, kind, width, monkeypatch):
    """One volume server of each package with the given needle-map kind and
    offset width; the same write script against a fresh volume; the
    answers, the .idx bytes and the masked .dat bytes are equal, and a
    restarted port server serves every needle natively."""
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    vid = {"memory": 70, "compact": 71, "leveldb": 72}[kind] + 10 * (width - 4)
    answers, files, servers = {}, {}, []
    try:
        for pkg in PKGS:
            vs = _solo(pkg, masters, tmp_path / pkg, needle_map_kind=kind, offset_width=width)
            servers.append(vs)
            vol = vs.store.add_volume(vid, "dpb", "000")
            assert vol._dp is vs._dp, pkg
            answers[pkg] = _write_script(vs.url, vid, seed=11)
            stats = vs._dp.stats()
            assert stats["native_writes"] >= 24 and stats["forwarded"] >= 1, (pkg, stats)
            vs._dp.flush_events()
            assert vol.file_count() == 18, pkg
            base = vol.base
            vs.stop()
            servers.remove(vs)
            files[pkg] = {ext: Path(base + ext).read_bytes() for ext in (".dat", ".idx")}
        assert answers["port"] == answers["jax"]
        assert [a[0] for a in answers["port"][:27]] == [201] * 27
        assert files["port"][".idx"] == files["jax"][".idx"]
        assert len(files["port"][".dat"]) == len(files["jax"][".dat"])
        assert _masked_dat(files["port"][".dat"]) == _masked_dat(files["jax"][".dat"])
        # reopened: the map kind replays the natively written .idx
        vs = _solo("port", masters, tmp_path / "port", needle_map_kind=kind)
        servers.append(vs)
        assert vs.store.find_volume(vid)._dp is vs._dp
        got = [(st, hashlib.sha256(b).hexdigest()) for st, _, b in
               (_http(vs.url, "GET", "/" + f) for f in _script_fids(vid, 11))]
        assert got == answers["port"][-25:]
        assert vs._dp.stats()["native_reads"] == 18 and vs._dp.stats()["forwarded"] == 0
    finally:
        for vs in servers:
            vs.stop()


def _script_fids(vid: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.choice(np.arange(1, 1 << 20), 24, replace=False)]
    cookies = {k: int(c) for k, c in zip(keys, rng.integers(1, 1 << 32, 24))}
    return [_fid(vid, k, cookies.get(k, 1)) for k in keys + [123456789]]


# -- reads and their answers -------------------------------------------------------


READ_CASES = [
    ("GET", "", {}),
    ("HEAD", "", {}),
    ("GET", "", {"Range": "bytes=0-9"}),
    ("GET", "", {"Range": "bytes=250-"}),
    ("GET", "", {"Range": "bytes=-6"}),
    ("GET", "", {"Range": "bytes=100-99"}),
    ("GET", "", {"Range": "bananas"}),
    ("GET", "", {"Range": "bytes=999-"}),
    ("GET", "?readDeleted=true", {}),
    ("GET", "", {"X-Request-ID": "abc-123"}),
]


def test_reads_answer_as_the_jax_plane(clusters):
    payload = bytes(range(256))

    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="reads")
        vs = c.holder(int(a.fid.split(",")[0]))
        st, h, _ = _http(a.location.url, "POST", f"/{a.fid}", payload)
        assert st == 201 and h.get("x-request-id")
        before = vs._dp.stats()
        out = []
        for method, query, headers in READ_CASES:
            st, h, b = _http(a.location.url, method, f"/{a.fid}{query}", headers=headers)
            assert h.get("x-request-id"), (pkg, method, query, headers)
            if "X-Request-ID" in headers:
                assert h["x-request-id"] == headers["X-Request-ID"]
            out.append((st, b, h.get("content-type"), h.get("content-range"),
                        h.get("content-length")))
        vid = a.fid.split(",")[0]
        flipped = a.fid[:-1] + ("0" if a.fid[-1] != "0" else "1")
        for path in (f"/{flipped}", f"/{vid},00000deadbeef"):
            st, h, b = _http(a.location.url, "GET", path)
            assert h.get("x-request-id")
            out.append((st, b))
        after = vs._dp.stats()
        # every case but the query string ran on the native loop
        assert after["forwarded"] - before["forwarded"] == 1, (pkg, before, after)
        return out

    got = _both(script)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 200 and got["port"][0][1] == payload
    assert got["port"][-2][0] == 404 and b"cookie" in got["port"][-2][1]


def test_python_side_read_sees_a_native_write_at_once(clusters):
    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="reads")
        assert _http(a.location.url, "POST", f"/{a.fid}", b"visible")[0] == 201
        vid, nid, cookie = volume_server.parse_fid(a.fid)
        vol = c.holder(vid).store.find_volume(vid)
        n = vol.read_needle(nid, cookie)  # a miss folds the pending events in
        return bytes(n.data), n.append_at_ns > 0, vol.last_append_at_ns >= n.append_at_ns

    assert _both(script) == {"port": (b"visible", True, True), "jax": (b"visible", True, True)}


def test_traced_native_requests_reach_the_trace_ring(clusters):
    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="reads")
        vs = c.holder(int(a.fid.split(",")[0]))
        tid = hashlib.md5(pkg.encode()).hexdigest()
        tp = {"traceparent": f"00-{tid}-{'ab' * 8}-01"}
        assert _http(a.location.url, "POST", f"/{a.fid}", b"traced", headers=tp)[0] == 201
        assert _http(a.location.url, "GET", f"/{a.fid}", headers=tp)[0] == 200
        vs._dp.drain_trace_events()
        spans = PKGS[pkg]["trace"].default_buffer.spans(tid)
        return sorted((s.name, s.service, s.parent_id) for s in spans)

    got = _both(script)
    assert got["port"] == got["jax"] == [("get", "native_dp", "ab" * 8),
                                         ("post", "native_dp", "ab" * 8)]


def test_metrics_carry_the_plane_families(masters, tmp_path):
    def script(pkg):
        # the per-verb family follows the last server started in a process
        vs = _solo(pkg, masters, tmp_path / pkg)
        made.append(vs)
        vs.store.add_volume(61, "metrics", "000")
        assert _http(vs.url, "POST", "/" + _fid(61, 5, 9), b"m" * 100)[0] == 201
        assert _http(vs.url, "GET", "/" + _fid(61, 5, 9))[0] == 200
        st, _, body = _http(vs.url, "GET", "/metrics")
        text = body.decode()
        kinds = sorted(re.findall(r'seaweedfs_volume_native_dp\{kind="(\w+)"\}', text))
        verbs = sorted(set(re.findall(
            r'weedtpu_volume_server_native_request_total\{verb="(\w+)"\} [1-9]', text)))
        st2, _, status = _http(vs.url, "GET", "/status")
        return st, kinds, verbs, st2, b"NativeDataPlane" in status

    made: list = []
    try:
        got = _both(script)
    finally:
        for vs in made:
            vs.stop()
    assert got["port"] == got["jax"]
    assert got["port"][1] and {"get", "post"} <= set(got["port"][2])


# -- writes -------------------------------------------------------------------------


def test_replicated_writes_fan_out_natively(clusters):
    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="fan", replication="001")
        for vs in c.servers:
            vs._dp._push_replicas(force=True)
        vid = int(a.fid.split(",")[0])
        holders = [vs for vs in c.servers if vs.store.find_volume(vid) is not None]
        primary = next(vs for vs in c.servers if vs.url == a.location.url)
        before = {vs.url: vs._dp.stats() for vs in holders}
        payload = b"native-fanout" * 17
        assert _http(a.location.url, "POST", f"/{a.fid}", payload)[0] == 201
        after = {vs.url: vs._dp.stats() for vs in holders}
        writes = sorted(after[u]["native_writes"] - before[u]["native_writes"] for u in after)
        fwd = after[primary.url]["forwarded"] - before[primary.url]["forwarded"]
        copies = {hashlib.sha256(_http(vs.url, "GET", f"/{a.fid}")[2]).hexdigest()
                  for vs in holders}
        st_del = _http(a.location.url, "DELETE", f"/{a.fid}")[0]
        gone = [_http(vs.url, "GET", f"/{a.fid}")[0] for vs in holders]
        return len(holders), writes, fwd, copies == {hashlib.sha256(payload).hexdigest()}, \
            st_del, gone

    got = _both(script)
    assert got["port"] == got["jax"] == (2, [1, 1], 0, True, 202, [404, 404])


def test_a_dead_replica_fails_the_write_loudly(clusters):
    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="fanfail", replication="001")
        primary = next(vs for vs in c.servers if vs.url == a.location.url)
        vid = int(a.fid.split(",")[0])
        resolver, primary._dp.replica_resolver = primary._dp.replica_resolver, None
        time.sleep(0.2)  # let a push in flight finish
        try:
            primary._dp._lib.sw_dp_set_replicas(primary._dp._h, vid, b"127.0.0.1:1")
            st, _, body = _http(a.location.url, "POST", f"/{a.fid}", b"x" * 64)
        finally:
            primary._dp.replica_resolver = resolver
        for vs in c.servers:
            vs._dp._push_replicas(force=True)
        st2 = _http(a.location.url, "POST", f"/{a.fid}", b"y" * 64)[0]
        return st, b"write failed" in body, st2

    got = _both(script)
    assert got["port"] == got["jax"] == (500, True, 201)


def test_vacuum_interleaves_with_native_writes(clusters):
    def script(pkg):
        c = clusters[pkg]
        a = c.mc.assign(collection="vac")
        vid, _nid, _cookie = volume_server.parse_fid(a.fid)
        vs = c.holder(vid)
        for i in range(4):
            assert _http(a.location.url, "POST", f"/{a.fid}", b"%d" % i * 200)[0] == 201
        vol = vs.store.find_volume(vid)
        vs._dp.flush_events()
        ratio = vol.garbage_ratio()
        reclaimed = vol.vacuum()
        reads = [_http(a.location.url, "GET", f"/{a.fid}")[2]]
        assert _http(a.location.url, "POST", f"/{a.fid}", b"post-vac")[0] == 201
        reads.append(_http(a.location.url, "GET", f"/{a.fid}")[2])
        return ratio > 0.5, reclaimed > 0, reads, vol._dp is vs._dp

    got = _both(script)
    assert got["port"] == got["jax"] == (True, True, [b"3" * 200, b"post-vac"], True)


# -- EC reads and deletes ----------------------------------------------------------


def test_ec_reads_native_from_local_shards(clusters):
    """Needles of 100 B to 3 MiB (across 1 MiB stripe blocks) read back
    from an EC volume with every shard local: natively, byte-equal, with
    the same answers as the JAX plane; a missing local shard forwards to
    the Python path, which reconstructs; an EC DELETE is forwarded."""

    def script(pkg):
        c = clusters[pkg]
        m = PKGS[pkg]
        rng = np.random.default_rng(5)
        a = c.mc.assign(collection="ndpec")
        vid = int(a.fid.split(",")[0])
        vs = c.holder(vid)
        payloads = {}
        for i, size in enumerate([100, 4096, 3 * 1024 * 1024, 70000]):
            fid = a.fid if i == 0 else f"{a.fid}_{i}"
            payloads[fid] = rng.bytes(size)
            assert _http(a.location.url, "POST", f"/{fid}", payloads[fid])[0] == 201
        stub = m["rpc"].volume_stub(f"{vs.ip}:{vs.grpc_port}")
        pb = m["pb"]
        stub.VolumeMarkReadonly(pb.VolumeMarkRequest(volume_id=vid))
        stub.EcShardsGenerate(pb.EcShardsGenerateRequest(volume_id=vid, collection="ndpec"))
        stub.EcShardsMount(pb.EcShardsMountRequest(volume_id=vid, collection="ndpec",
                                                   shard_ids=list(range(14))))
        stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))
        out = []
        before = vs._dp.stats()
        for fid, payload in payloads.items():
            st, _, body = _http(a.location.url, "GET", f"/{fid}")
            out.append((st, body == payload))
        st, _, body = _http(a.location.url, "GET", f"/{a.fid}_2",
                            headers={"Range": "bytes=1048570-1048585"})
        out.append((st, body == payloads[f"{a.fid}_2"][1048570:1048586]))
        flipped = a.fid[:-1] + ("0" if a.fid[-1] != "0" else "1")
        out.append(_http(a.location.url, "GET", f"/{flipped}")[0])
        after = vs._dp.stats()
        out.append((after["native_reads"] - before["native_reads"],
                    after["forwarded"] - before["forwarded"]))
        # DELETE of an EC needle: forwarded (normal volumes only natively)
        st_del = _http(a.location.url, "DELETE", f"/{a.fid}_3")[0]
        out.append((st_del, vs._dp.stats()["forwarded"] - after["forwarded"]))
        out.append(_http(a.location.url, "GET", f"/{a.fid}_3")[0])
        # a data shard the 3 MiB needle needs goes away locally: forwarded,
        # and the Python path reconstructs it from the 13 survivors
        fwd = vs._dp.stats()["forwarded"]
        stub.EcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[1]))
        ev = vs.store.find_ec_volume(vid)
        os.remove(ev.base + ".ec01")
        st, _, body = _http(a.location.url, "GET", f"/{a.fid}_2")
        out.append((st, body == payloads[f"{a.fid}_2"], vs._dp.stats()["forwarded"] - fwd))
        st, _, body = _http(a.location.url, "GET", f"/{a.fid}")
        out.append((st, body == payloads[a.fid]))
        return out, (vs, stub, pb, vid, ev, a)

    got = _both(script)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0][:6] == [(200, True)] * 4 + [(206, True), 404]
    assert got["port"][0][6] == (5, 0)
    assert got["port"][0][7:] == [(202, 1), 404, (200, True, 1), (200, True)]
    # the port's short read: with five data shards gone no server reaches
    # k shards for the 3 MiB needle, and the answer is a 503 (another
    # holder may), not a 404 about the needle
    vs, stub, pb, vid, ev, a = got["port"][1]
    stub.EcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[2, 3, 4, 5]))
    for sid in (2, 3, 4, 5):
        os.remove(ev.base + f".ec{sid:02d}")
    fwd = vs._dp.stats()["forwarded"]
    st, _, _ = _http(a.location.url, "GET", f"/{a.fid}_2")
    assert st == 503
    assert vs._dp.stats()["forwarded"] == fwd + 1
    # the small needle's interval lies on shard 0, still local: native
    st, _, body = _http(a.location.url, "GET", f"/{a.fid}")
    assert st == 200 and vs._dp.stats()["forwarded"] == fwd + 1


# -- what the JAX plane loses and the port keeps ------------------------------------


def test_a_corrupt_read_reaches_the_scrubber_only_in_the_port(masters, tmp_path, monkeypatch):
    """A needle whose data bytes rotted on disk: both planes answer 500
    "crc mismatch"; the JAX plane answers it natively and so neither counts
    the corruption nor flags the needle for the scrubber's repair, while the
    port's plane forwards the read to the Python path, which does both."""
    from seaweedfs_tpu import stats as jax_stats
    from seaweedfs_tpu_torch import stats

    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    got = {}
    for pkg, st_mod in (("port", stats), ("jax", jax_stats)):
        vs = _solo(pkg, masters, tmp_path / pkg)
        try:
            vol = vs.store.add_volume(12, "", "000")
            assert _http(vs.url, "POST", "/" + _fid(12, 1, 7), b"rot" * 300)[0] == 201
            vs._dp.flush_events()
            nv = vol.nm.get(1)
            with open(vol.base + ".dat", "r+b") as f:
                at = nv.offset + 16 + 4 + 100  # inside the data
                f.seek(at)
                byte = f.read(1)
                f.seek(at)
                f.write(bytes([byte[0] ^ 0xFF]))
            flagged: list = []
            vs.scrubber.flag = lambda vid, nid, flagged=flagged: flagged.append((vid, nid))
            before = st_mod.DISK_CORRUPTION.value(path="read")
            st, _, body = _http(vs.url, "GET", "/" + _fid(12, 1, 7))
            got[pkg] = (st, body, flagged, st_mod.DISK_CORRUPTION.value(path="read") - before)
        finally:
            vs.stop()
    assert got["port"] == (500, b"crc mismatch", [(12, 1)], 1)
    assert got["jax"] == (500, b"crc mismatch", [], 0)


def test_fsync_always_syncs_writes_through_the_native_appender(masters, tmp_path, monkeypatch):
    """With ``-fsync always`` every write forwards to Python, which appends
    through the native appender (one appender a volume); the JAX volume
    returns before its fsync policy runs, the port's syncs each write."""
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    got = {}
    for pkg in PKGS:
        vs = _solo(pkg, masters, tmp_path / pkg, fsync="always")
        try:
            vol = vs.store.add_volume(13, "", "000")
            assert vol._dp is vs._dp
            syncs: list = []
            real = vol.sync
            vol.sync = lambda real=real, syncs=syncs: (syncs.append(1), real())
            for k in range(1, 4):
                assert _http(vs.url, "POST", "/" + _fid(13, k, 7), b"durable" * 20)[0] == 201
            assert _http(vs.url, "DELETE", "/" + _fid(13, 1, 7))[0] == 202
            got[pkg] = (len(syncs), vs._dp.stats()["native_writes"], vs._dp.stats()["forwarded"])
        finally:
            vs.stop()
    assert got["port"] == (4, 0, 4)
    assert got["jax"] == (0, 0, 4)


def test_a_short_holder_set_fails_the_write_loudly(clusters):
    """A volume placed on three copies ("002") whose master names only one
    other holder: the write is refused ("replication short", 500) and the
    other holder gets no copy, in both packages (the JAX plane refuses it
    natively; the port's drainer pushes only a full holder set, so the
    write forwards and Python's write-all refuses it)."""

    def script(pkg):
        c = clusters[pkg]
        vid = 40
        for vs in c.servers:
            vs.store.add_volume(vid, "short", "002")
        primary, other = c.servers
        resolver = primary._dp.replica_resolver
        primary._dp.replica_resolver = lambda v: [other.url] if v == vid else resolver(v)
        try:
            primary._dp._push_replicas(force=True)
            st, _, body = _http(primary.url, "POST", "/" + _fid(vid, 1, 7), b"x" * 64)
            copies = [_http(vs.url, "GET", "/" + _fid(vid, 1, 7))[0] for vs in c.servers]
        finally:
            primary._dp.replica_resolver = resolver
        return st, copies, b"replication short" in body

    got = _both(script)
    assert got["port"] == got["jax"] == (500, [200, 404], True)


# -- disk faults ---------------------------------------------------------------------


def test_disk_faults_fire_under_the_port_plane(masters, tmp_path, monkeypatch):
    """``disk@*.dat:append:torn:x1`` armed while a server runs: the JAX
    plane's native POST never reaches the backend, so the rule does not
    fire and the write is acknowledged; the port takes its volumes off the
    plane while the rule is armed, so the same POST tears (500) and the
    rule fires once, and clearing the plan hands the volumes back."""
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.delenv("WEED_FAULTS", raising=False)
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    got, servers = {}, []
    try:
        for pkg, m in PKGS.items():
            vs = _solo(pkg, masters, tmp_path / pkg)
            servers.append(vs)
            vol = vs.store.add_volume(9, "", "000")
            assert _http(vs.url, "POST", "/" + _fid(9, 1, 7), b"before" * 10)[0] == 201
            fm = m["faults"]
            plan = fm.configure("disk@*.dat:append:torn:x1", seed=0)
            try:
                before = vs._dp.stats()["native_writes"]
                st, _, _ = _http(vs.url, "POST", "/" + _fid(9, 2, 7), b"during" * 10)
                native = vs._dp.stats()["native_writes"] - before
                fired = plan.rules[0].fired
                owned = vol._dp is vs._dp
            finally:
                fm.configure(None)
            got[pkg] = (st, fired, native, owned, vol._dp is vs._dp)
    finally:
        for vs in servers:
            vs.stop()
    assert got["jax"] == (201, 0, 1, True, True)
    # the torn append leaves a misaligned .dat tail, which the plane will
    # not register until a restart truncates it: the volume stays Python
    assert got["port"] == (500, 1, 0, False, False)


def test_a_disk_rule_at_start_keeps_every_volume_off_the_plane(tmp_path, monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    d = tmp_path / "v"
    d.mkdir()
    vs = volume_server.VolumeServer([str(d)], "", port=0, grpc_port=0, device="cpu")
    vs.start()
    assert vs.store.add_volume(3, "", "000")._dp is vs._dp
    vs.stop()
    monkeypatch.setenv("WEED_FAULTS", "disk@*.dat:append:eio:x1")
    faults.reset()
    vs = volume_server.VolumeServer([str(d)], "", port=0, grpc_port=0, device="cpu")
    try:
        vs.start()
        assert vs._dp is not None and vs.store.find_volume(3)._dp is None
        st, _, _ = _http(vs.url, "POST", "/" + _fid(3, 1, 7), b"x" * 10)
        assert st == 500 and faults.active().rules[0].fired == 1
        assert vs._dp.stats()["forwarded"] == 1
    finally:
        vs.stop()
        monkeypatch.delenv("WEED_FAULTS")
        faults.reset()


# -- the opt-outs and a failed build ------------------------------------------------


def test_opt_out_variables(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    assert not dataplane.enabled() and not dataplane.px_enabled()
    assert dataplane.px_lib() is None and dataplane.px_loop_mode() == dataplane._PX_LOOP_OFF
    vs = volume_server.VolumeServer([str(tmp_path)], "", port=0, grpc_port=0, device="cpu")
    vs.start()
    try:
        assert vs._dp is None and vs.store.dp is None
        vol = vs.store.add_volume(4, "", "000")
        assert vol._dp is None
        assert _http(vs.url, "POST", "/" + _fid(4, 1, 7), b"python")[0] == 201
        st, _, body = _http(vs.url, "GET", "/status")
        assert st == 200 and b"NativeDataPlane" not in body
    finally:
        vs.stop()
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP")
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_PX")
    assert dataplane.enabled() and dataplane.px_enabled()
    assert dataplane.px_lib() is not None


def test_an_enabled_plane_whose_build_fails_raises_at_start(tmp_path, monkeypatch):
    """No Python stand-in: with the plane enabled and the library not
    buildable, the volume server, the filer and the S3 gateway refuse to
    start."""
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer

    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_DP", raising=False)
    monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_PX", raising=False)

    def broken():
        raise RuntimeError("build failed for csrc/dp.cpp: (simulated)")

    monkeypatch.setattr(dataplane, "load", broken)
    monkeypatch.setattr(dataplane, "_px_lib", None)
    vs = volume_server.VolumeServer([str(tmp_path)], "", port=0, grpc_port=0, device="cpu")
    with pytest.raises(RuntimeError, match="build failed"):
        vs.start()
    assert vs._grpc_server is None and vs._http_server is None
    vs.store.close()
    for server in (FilerServer("127.0.0.1:1", port=0, grpc_port=0),
                   S3ApiServer("127.0.0.1:1", port=0)):
        with pytest.raises(RuntimeError, match="build failed"):
            server.start()
    # the opt-out variables are the only ways to run without it
    monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    vs = volume_server.VolumeServer([str(tmp_path)], "", port=0, grpc_port=0, device="cpu")
    vs.start()
    vs.stop()
