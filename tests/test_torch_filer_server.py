"""The port's filer server on the CPU, held against the JAX package's.

- Two clusters side by side, each of one master, two volume servers
  (the port's with ``device="cpu"``; the JAX one's Python data plane) and a
  filer on an LSM store: the same seeded uploads (inline, one chunk, many
  chunks, manifest files) answer with the same statuses and bodies, Range,
  416 and HEAD replies, paged JSON listings and recursive deletes, whose
  chunks then answer 404 on the volume servers.
- Crossed clusters: the port's filer over the JAX master and volume
  servers, and the JAX filer over the port's.
- ``FidPool`` against a port master that signs writes: one Assign covers
  ``fid``, ``fid_1`` ... and the base fid's token admits every one.
- A refused upload leaves the keep-alive connection parseable; the
  ``SubscribeMetadata`` stream, ``Statistics`` and the filer metrics; a
  restart on the same ``-db`` (and the JAX filer on the port's store); and
  uploads read back through the filer after ``ec.encode``
  (``device="cpu"``) from EC shards.

Every server binds port 0 and every wait polls."""

from __future__ import annotations

import http.client
import json
import os
import re
import shutil
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.server import filer_server as jax_fs
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.filer.upload import FidPool
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.server import filer_server, master_server, volume_server
from seaweedfs_tpu_torch.wdclient import MasterClient

WAIT_S = 60.0
CHUNK = 4096
MANIFEST_BATCH = 4


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _http(addr: str, method: str, path: str, body: bytes = b"", headers=None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    keep = {k: resp.getheader(k) for k in ("Content-Length", "Content-Range", "ETag",
                                            "Content-Type") if resp.getheader(k) is not None}
    conn.close()
    return resp.status, data, keep


class _Cluster:
    def __init__(self, ms_mod, vs_mod, fs_mod, root: str, name: str, filer_master=None,
                 jwt_key: str = "", **vs_kwargs):
        self.dirs = [os.path.join(root, f"{name}-v{i}") for i in range(2)]
        self.master = ms_mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64,
                                          jwt_key=jwt_key)
        self.master.start()
        self.servers = []
        for i, d in enumerate(self.dirs):
            os.makedirs(d)
            vs = vs_mod.VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                     rack=f"rack{i}", heartbeat_interval=0.2, jwt_key=jwt_key,
                                     **vs_kwargs)
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == 2, "both heartbeats")
        self.fs_mod, self.db = fs_mod, os.path.join(root, f"{name}-db")
        self.filer_master = filer_master or self.master.grpc_address
        self.filer = None
        self.start_filer()

    def start_filer(self, fs_mod=None) -> None:
        self.filer = (fs_mod or self.fs_mod).FilerServer(
            self.filer_master, port=0, grpc_port=0, store_path=self.db, chunk_size=CHUNK,
            manifest_batch=MANIFEST_BATCH)
        self.filer.start()

    def stop(self) -> None:
        if self.filer is not None:
            self.filer.stop()
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def _env():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    return mp


@pytest.fixture(scope="module")
def clusters():
    """{"port": the port's cluster, "jax": the JAX package's}."""
    mp = _env()
    root = tempfile.mkdtemp(prefix="torch-filer-")
    made = {}
    try:
        made["port"] = _Cluster(master_server, volume_server, filer_server, root, "port",
                                device="cpu")
        made["jax"] = _Cluster(jax_ms, jax_vs, jax_fs, root, "jax")
        yield made
    finally:
        for c in made.values():
            c.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _both(clusters, script):
    got = {name: script(c) for name, c in clusters.items()}
    assert got["port"] == got["jax"]
    return got["port"]


SIZES = [0, 100, 2047, 2048, 2049, 4096, 5000, 3 * CHUNK + 17, 9 * CHUNK + 1]


def _body(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _listing(body: bytes) -> dict:
    doc = json.loads(body)
    for e in doc["Entries"]:
        e["Mtime"] = 0  # each filer's own clock
    return doc


def test_uploads_reads_and_listings_answer_as_jax(clusters):
    def script(c):
        url = c.filer.url
        out = []
        for i, size in enumerate(SIZES):
            out.append(_http(url, "POST", f"/up/d{i % 3}/f{i}.bin", _body(i, size)))
        out.append(_http(url, "PUT", "/up/notes.txt", b"plain text " * 300))
        out.append(_http(url, "POST", "/up/newdir/"))
        for i, size in enumerate(SIZES):
            out.append(_http(url, "GET", f"/up/d{i % 3}/f{i}.bin"))
            out.append(_http(url, "HEAD", f"/up/d{i % 3}/f{i}.bin"))
            if size:
                rng = np.random.default_rng(i + 50)
                for _ in range(4):  # ranges that cross chunk boundaries
                    lo = int(rng.integers(0, size))
                    hi = int(rng.integers(lo, size))
                    out.append(_http(url, "GET", f"/up/d{i % 3}/f{i}.bin",
                                     headers={"Range": f"bytes={lo}-{hi}"}))
                out.append(_http(url, "GET", f"/up/d{i % 3}/f{i}.bin",
                                 headers={"Range": f"bytes=-{min(size, 3000)}"}))
                out.append(_http(url, "HEAD", f"/up/d{i % 3}/f{i}.bin",
                                 headers={"Range": "bytes=1-"}))
            out.append(_http(url, "GET", f"/up/d{i % 3}/f{i}.bin",
                             headers={"Range": f"bytes={size + 5}-"}))
        out.append(_http(url, "GET", "/up/missing"))
        for path in ("/up", "/up/d0", "/up/d1?limit=2", "/up/d1?limit=2&lastFileName=f1.bin", "/"):
            status, body, hdrs = _http(url, "GET", path)
            out.append((status, _listing(body), hdrs["Content-Type"]))
        return out

    got = _both(clusters, script)
    assert sum(1 for r in got if r[0] == 206) >= 4 * (len(SIZES) - 1)
    assert any(r[0] == 416 for r in got)


def test_chunking_and_manifests_as_jax(clusters):
    """The stored entries: inline under 2 KiB, CHUNK-sized chunks above,
    manifests beyond MANIFEST_BATCH chunks."""
    def script(c):
        shape = []
        for i, size in enumerate(SIZES):
            e = c.filer.filer.find_entry(f"/up/d{i % 3}/f{i}.bin")
            shape.append((size, len(e.content), len(e.chunks),
                          sum(ch.is_chunk_manifest for ch in e.chunks),
                          [(ch.offset, ch.size) for ch in e.chunks if not ch.is_chunk_manifest]))
        return shape

    shape = _both(clusters, script)
    assert shape[1][1] == 100 and shape[3][1] == 2048 and shape[4][2] == 1
    assert shape[-1][3] >= 1


def test_recursive_delete_as_jax(clusters):
    def script(c):
        url = c.filer.url
        fids = []
        for i in range(6):
            _http(url, "POST", f"/del/t/x{i}", _body(100 + i, 3 * CHUNK))
        _http(url, "POST", "/del/t/sub/deep", _body(200, 2 * CHUNK))
        for i in range(6):
            fids += [ch.fid for ch in c.filer.filer.find_entry(f"/del/t/x{i}").chunks]
        out = [_http(url, "DELETE", "/del/t"), _http(url, "DELETE", "/del/t?recursive=true"),
               _http(url, "GET", "/del/t/x0"), _http(url, "GET", "/del/t/sub/deep"),
               _http(url, "DELETE", "/del/t"), _http(url, "GET", "/del")]
        gone = []
        for fid in fids:
            vid = int(fid.split(",")[0])
            holders = [vs for vs in c.servers if vs.store.find_volume(vid) is not None]
            gone.append({_http(vs.url, "GET", f"/{fid}")[0] for vs in holders})
        return out + [gone]

    got = _both(clusters, script)
    assert got[0][0] == 409 and got[1][0] == 204 and got[2][0] == 404
    assert all(s == {404} for s in got[-1])


def test_crossed_clusters_serve_each_other(clusters, tmp_path):
    """The port's filer over the JAX master and volume servers, and the
    JAX filer over the port's: uploads, reads and deletes work."""
    pairs = [(filer_server, clusters["jax"].master.grpc_address),
             (jax_fs, clusters["port"].master.grpc_address)]
    for mod, maddr in pairs:
        fs = mod.FilerServer(maddr, port=0, grpc_port=0, chunk_size=CHUNK)
        fs.start()
        try:
            data = _body(7, 5 * CHUNK + 3)
            assert _http(fs.url, "POST", "/cross/a.bin", data)[0] == 201
            assert _http(fs.url, "POST", "/cross/s.txt", b"tiny")[0] == 201
            assert _http(fs.url, "GET", "/cross/a.bin")[1] == data
            status, body, _h = _http(fs.url, "GET", "/cross/a.bin",
                                     headers={"Range": f"bytes={CHUNK - 5}-{CHUNK + 5}"})
            assert status == 206 and body == data[CHUNK - 5:CHUNK + 6]
            assert _http(fs.url, "DELETE", "/cross?recursive=true")[0] == 204
            assert _http(fs.url, "GET", "/cross/a.bin")[0] == 404
        finally:
            fs.stop()


def test_fid_pool_against_a_signing_port_master(tmp_path):
    mp = _env()
    c = _Cluster(master_server, volume_server, filer_server, str(tmp_path), "jwt",
                 jwt_key="k3y", device="cpu")
    try:
        mc = MasterClient(c.master.grpc_address)  # no key: the assign's token must serve
        pool = FidPool(mc, batch=8, stripes=2)
        taken = pool.take(12, collection="pool")
        bases = {f.split("_")[0] for f, _u, _a in taken}
        assert len(taken) == 12 and len({f for f, _u, _a in taken}) == 12
        for fid, url, auth in taken:
            suffix = fid.partition("_")[2]
            assert suffix == "" or 1 <= int(suffix) < 12
            assert _http(url, "POST", f"/{fid}", b"body " + fid.encode(),
                         {"Authorization": f"Bearer {auth}"})[0] == 201
            assert _http(url, "POST", f"/{fid}", b"x")[0] == 401  # unsigned: refused
        assert len(bases) <= 2
        for fid, url, _auth in taken:
            assert _http(url, "GET", f"/{fid}")[1] == b"body " + fid.encode()
        # one stripe serves its batch in order; a reservation older than
        # the ttl is dropped and the next take assigns afresh
        aging = FidPool(mc, batch=8, ttl=0.3, stripes=1)
        first, second = aging.take(1)[0][0], aging.take(1)[0][0]
        assert second == first + "_1"
        time.sleep(0.35)
        assert aging.take(1)[0][0].split("_")[0] != first
        # the filer uploads through its pool with the master signing
        fs = filer_server.FilerServer(c.master.grpc_address, port=0, grpc_port=0,
                                      chunk_size=CHUNK)
        fs.master.jwt_key = "k3y"
        fs.start()
        try:
            data = _body(9, 6 * CHUNK)
            assert _http(fs.url, "POST", "/signed.bin", data)[0] == 201
            assert _http(fs.url, "GET", "/signed.bin")[1] == data
        finally:
            fs.stop()
    finally:
        c.filer.stop()
        c.filer = None
        c.stop()
        mp.undo()


def test_assign_batch_is_the_jax_convention(clusters):
    got = {}
    for name, c in clusters.items():
        rows = MasterClient(c.master.grpc_address).assign_batch_located(4, collection="ab")
        base = rows[0][0]
        got[name] = [(fid.replace(base, "B"), url == rows[0][1], auth == rows[0][2], reps)
                     for fid, url, auth, reps in rows]
    assert got["port"] == got["jax"] == [("B", True, True, ()), ("B_1", True, True, ()),
                                         ("B_2", True, True, ()), ("B_3", True, True, ())]


def test_refused_upload_keeps_the_connection_parseable(clusters):
    """A read-only rule refuses an upload before its body is read; the
    body is drained, and the next request on the same connection is
    answered (both packages)."""
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    from seaweedfs_tpu_torch.filer.filer_conf import CONF_PATH, FilerConf, PathConf

    conf = FilerConf([PathConf(location_prefix="/frozen/", read_only=True)])
    for name, c in clusters.items():
        blob = conf.to_bytes()
        if name == "port":
            c.filer.filer.create_entry(Entry(CONF_PATH, attr=Attr.now(), content=blob))
        else:
            from seaweedfs_tpu.filer.entry import Attr as JA
            from seaweedfs_tpu.filer.entry import Entry as JE

            c.filer.filer.create_entry(JE(CONF_PATH, attr=JA.now(), content=blob))
        c.filer.conf.invalidate()
        host, port = c.filer.url.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.request("POST", "/frozen/x.bin", body=_body(3, 3 * CHUNK))
            resp = conn.getresponse()
            assert (resp.status, resp.read()) == (403, b"read-only location (fs.configure)")
            conn.request("POST", "/frozen/dir/")
            resp = conn.getresponse()
            assert resp.status == 403
            resp.read()
            conn.request("GET", "/up/d0/f0.bin")
            resp = conn.getresponse()
            assert resp.status == 200 and resp.read() == b""
        finally:
            conn.close()
        c.filer.filer.delete_entry(CONF_PATH)
        c.filer.conf.invalidate()


def test_grpc_contract_as_jax(clusters):
    def script(c):
        stub = rpc.filer_stub(c.filer.grpc_address)
        out = []
        out.append(stub.CreateEntry(f_pb.CreateEntryRequest(
            directory="/g", entry=f_pb.Entry(name="e1", content=b"abc"))).error)
        out.append(stub.CreateEntry(f_pb.CreateEntryRequest(
            directory="/g/e1", entry=f_pb.Entry(name="under", content=b"x"))).error)
        lk = stub.LookupDirectoryEntry(f_pb.LookupDirectoryEntryRequest(directory="/g", name="e1"))
        out.append((lk.error, lk.entry.name, lk.entry.content, lk.entry.attributes.file_size))
        out.append(stub.LookupDirectoryEntry(
            f_pb.LookupDirectoryEntryRequest(directory="/g", name="nope")).error)
        out.append(stub.AtomicRenameEntry(f_pb.AtomicRenameEntryRequest(
            old_directory="/g", old_name="e1", new_directory="/g2", new_name="e2")).error)
        out.append(stub.AtomicRenameEntry(f_pb.AtomicRenameEntryRequest(
            old_directory="/g", old_name="e1", new_directory="/g2", new_name="e3")).error)
        out.append([r.entry.name for r in stub.ListEntries(f_pb.ListEntriesRequest(directory="/g2"))])
        out.append(stub.DeleteEntry(f_pb.DeleteEntryRequest(directory="/", name="g2")).error)
        out.append(stub.DeleteEntry(f_pb.DeleteEntryRequest(directory="/", name="g2",
                                                            is_recursive=True)).error)
        out.append(stub.DeleteEntry(f_pb.DeleteEntryRequest(directory="/", name="g2")).error)
        a = stub.AssignVolume(f_pb.AssignVolumeRequest(count=3, collection="grpc"))
        out.append((a.error, a.count, bool(re.fullmatch(r"\d+,[0-9a-f]{9,}", a.fid)), bool(a.url)))
        return out

    got = _both(clusters, script)
    assert got[0] == "" and "is a file" in got[1]


def test_subscribe_metadata_and_statistics(clusters):
    c = clusters["port"]
    stub = rpc.filer_stub(c.filer.grpc_address)
    since = time.time_ns()
    _http(c.filer.url, "POST", "/sub/a.txt", b"first")
    _http(c.filer.url, "POST", "/sub/a.txt", b"second")
    _http(c.filer.url, "DELETE", "/sub/a.txt")
    stream = stub.SubscribeMetadata(f_pb.SubscribeMetadataRequest(
        client_name="t", path_prefix="/sub", since_ts_ns=since), timeout=2.0)
    seen = []
    try:
        for ev in stream:
            seen.append((ev.directory, ev.old_entry.content, ev.new_entry.content))
            if len(seen) == 3:
                break
    finally:
        stream.cancel()
    assert seen == [("/sub", b"", b"first"), ("/sub", b"first", b"second"),
                    ("/sub", b"second", b"")]
    st = stub.Statistics(f_pb.FilerStatisticsRequest())
    files, dirs = c.filer.filer.statistics()
    assert (st.entry_count, st.directory_count) == (files, dirs) and files > 0 and dirs > 0
    text = stats.render_text()
    assert re.search(r'weedtpu_filer_request_total\{type="read"\} \d+', text)
    assert re.search(r'weedtpu_filer_request_seconds_count\{type="write"\} \d+', text)


def test_restart_on_the_same_db_and_cross_package_reopen(clusters):
    """The port's filer stops and a new one opens its LSM store: the
    listing and reads are the same; then the JAX filer opens the same
    store and serves the same bytes."""
    c = clusters["port"]
    before = _http(c.filer.url, "GET", "/up/d2")[1]
    reads = [_http(c.filer.url, "GET", f"/up/d{i % 3}/f{i}.bin")[1] for i in range(len(SIZES))]
    for mod in (filer_server, jax_fs, filer_server):
        c.filer.stop()
        c.start_filer(mod)
        assert _listing(_http(c.filer.url, "GET", "/up/d2")[1]) == _listing(before)
        assert [_http(c.filer.url, "GET", f"/up/d{i % 3}/f{i}.bin")[1]
                for i in range(len(SIZES))] == reads


def test_reads_through_the_filer_after_ec_encode(clusters):
    """Files of collection ``ecf`` are EC-encoded (``device="cpu"``); every
    one reads back through the filer from the shards, whole and ranged."""
    from seaweedfs_tpu_torch.shell import run_command
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    c = clusters["port"]
    files = {f"/ec/f{i}": _body(300 + i, (i + 1) * 3000) for i in range(8)}
    for path, data in files.items():
        assert _http(c.filer.url, "POST", path + "?collection=ecf", data)[0] == 201
    vids = sorted({int(ch.fid.split(",")[0]) for p in files
                   for ch in c.filer.filer.find_entry(p).chunks})
    for path, data in files.items():  # warm the filer's location cache
        assert _http(c.filer.url, "GET", path)[1] == data
    env = CommandEnv(c.master.grpc_address)
    out = __import__("io").StringIO()
    try:
        run_command(env, "lock", out)
        for vid in vids:
            run_command(env, f"ec.encode -volumeId {vid} -collection ecf", out)
    finally:
        env.release_lock()
    _wait(lambda: all(vs.store.find_volume(v) is None for vs in c.servers for v in vids),
          "the encoded volumes to go")
    for path, data in files.items():
        assert _http(c.filer.url, "GET", path)[1] == data, path
        status, body, _h = _http(c.filer.url, "GET", path, headers={"Range": "bytes=10-2999"})
        assert status == 206 and body == data[10:3000]


def test_flags_that_wait_for_later_work_raise(tmp_path):
    # -notify is ported: an unknown bus is refused with the JAX text before
    # any store opens, the mq bus publishes through the port's MqClient, and
    # a log bus is attached to the filer and closed by stop()
    with pytest.raises(ValueError, match="unknown notification bus spec"):
        filer_server.FilerServer("127.0.0.1:1", notify="bogus:x")
    mq_fs = filer_server.FilerServer("127.0.0.1:1", notify="mq://127.0.0.1:1/t")
    assert type(mq_fs._notifier.bus).__name__ == "MqBus"
    assert mq_fs._notifier.bus.topic == "t"
    mq_fs.stop()
    fs = filer_server.FilerServer("127.0.0.1:1", notify=f"log:{tmp_path / 'ev.jsonl'}")
    assert fs.filer.notifier is fs._notifier and fs._notifier is not None
    fs.stop()
    assert not fs._notifier._worker.is_alive()
    # TLS is ported: a pair that does not load fails at once, before a
    # listener binds, and half a pair is refused
    with pytest.raises(OSError):
        filer_server.FilerServer("127.0.0.1:1", tls_cert="c", tls_key="k")
    with pytest.raises(ValueError, match="both"):
        filer_server.FilerServer("127.0.0.1:1", tls_cert="c")
