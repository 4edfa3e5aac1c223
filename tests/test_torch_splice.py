"""The port's gateway splice (filer/splice.py over csrc/dp.cpp's px verbs)
on the CPU, held against the JAX package's: one stack of each package
(master, volume server, open-access S3 gateway), the same seeded objects in
both, and each answer compared.

- GET parity: one chunk, many chunks, sparse holes, a body below
  ``MIN_SPLICE_BYTES`` and a 416, over a matrix of ranges: the same status,
  body, Content-Range and plane attribution (``x-weed-spliced``) as the JAX
  splice, and the same bytes as the port's own Python path.
- PUT: the in-stream MD5 ETag of one chunk and of many, the read-back, the
  fan-out counters; a mid-object fan-out failure rides the Python ladder
  byte-exact (and is counted); both px loop modes give the same bytes.
- ``StreamingBody.pushback``/``take_buffered`` round trips, the native fid
  stash, the hot-chunk cache tier (``sw_px_cache_send``), and a volume
  server SIGKILLed mid-splice (the response completes through the failover
  ladder).  Every subprocess read has a deadline."""

from __future__ import annotations

import hashlib
import http.client
import io
import os
import select
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import upload as jax_upload
from seaweedfs_tpu.filer.entry import Attr as JaxAttr
from seaweedfs_tpu.filer.entry import Entry as JaxEntry
from seaweedfs_tpu.filer.entry import FileChunk as JaxFileChunk
from seaweedfs_tpu.native import dataplane as jax_dp
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3ApiServer
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.util.httpd import StreamingBody as JaxStreamingBody
from seaweedfs_tpu_torch.filer import splice
from seaweedfs_tpu_torch.filer import upload
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.native import dataplane
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.util.httpd import StreamingBody

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0
CHUNK = 256 * 1024  # the gateways' PUT chunk size here

PKGS = {
    "port": dict(ms=master_server, vs=volume_server, s3=S3ApiServer, upload=upload, dp=dataplane,
                 entry=(Entry, Attr, FileChunk), kw={"device": "cpu"}),
    "jax": dict(ms=jax_ms, vs=jax_vs, s3=JaxS3ApiServer, upload=jax_upload, dp=jax_dp,
                entry=(JaxEntry, JaxAttr, JaxFileChunk), kw={}),
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


class _Stack:
    def __init__(self, pkg: str, root: str, n_volumes: int = 1, **gw_kw):
        m = PKGS[pkg]
        self.pkg = pkg
        self.master = m["ms"].MasterServer(port=0, grpc_port=0, volume_size_limit_mb=256)
        self.master.start()
        self.servers = []
        for i in range(n_volumes):
            d = os.path.join(root, f"{pkg}-v{i}")
            os.makedirs(d)
            vs = m["vs"].VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                      heartbeat_interval=0.2, max_volume_counts=[16], **m["kw"])
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == n_volumes, f"{pkg} volume servers")
        self.gw = m["s3"](self.master.grpc_address, port=0, chunk_size=CHUNK, **gw_kw)
        self.gw.start()
        assert _http(self.gw.url, "PUT", "/parity")[0] == 200

    def install(self, key: str, payload: bytes, chunk_size: int,
                gaps: list[tuple[int, int]] | None = None) -> bytes:
        """``payload`` as /parity/<key> in explicit chunks (``gaps`` left
        unwritten as sparse holes); returns the body a GET must give."""
        Entry_, Attr_, FileChunk_ = PKGS[self.pkg]["entry"]
        chunks, logical = [], bytearray(payload)
        for off in range(0, len(payload), chunk_size):
            piece = payload[off:off + chunk_size]
            if any(lo <= off < hi for lo, hi in gaps or []):
                logical[off:off + len(piece)] = bytes(len(piece))
                continue
            fid = PKGS[self.pkg]["upload"].save_blob(self.gw.master, piece)
            chunks.append(FileChunk_(fid=fid, offset=off, size=len(piece),
                                     modified_ts_ns=time.time_ns()))
        path = self.gw.object_path("parity", key)
        self.gw.filer.mkdirs(path.rsplit("/", 1)[0])
        entry = Entry_(full_path=path, chunks=chunks, attr=Attr_.now(mime="application/octet-stream"))
        entry.extended["etag"] = hashlib.md5(bytes(logical)).hexdigest().encode()
        self.gw.filer.create_entry(entry)
        return bytes(logical)

    def stop(self) -> None:
        self.gw.stop()
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def _stacks(root: str, **gw_kw) -> dict:
    made = {}
    try:
        for pkg in PKGS:
            made[pkg] = _Stack(pkg, os.path.join(root, pkg), **gw_kw)
    except BaseException:
        for s in made.values():
            s.stop()
        raise
    return made


@pytest.fixture(scope="module")
def stacks():
    mp = pytest.MonkeyPatch()
    for var in ("SEAWEEDFS_TPU_NATIVE_DP", "SEAWEEDFS_TPU_NATIVE_PX", "SEAWEEDFS_TPU_PX_URING",
                "SEAWEEDFS_TPU_PX_LOOP"):
        mp.delenv(var, raising=False)
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-splice-")
    made = _stacks(root, chunk_cache_mb=0)
    try:
        yield made
    finally:
        for s in made.values():
            s.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _rng_bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


# -- GET ------------------------------------------------------------------------------

RANGES = [None, "bytes=0-65535", "bytes=1000-200000", "bytes=65536-65536", "bytes=-70000",
          "bytes=131072-"]


def _get_matrix(stacks, key: str, ranges=RANGES, monkeypatch=None) -> dict:
    out = {}
    for pkg, s in stacks.items():
        rows = []
        for rng in ranges:
            st, h, b = _http(s.gw.url, "GET", f"/parity/{key}",
                             headers={"Range": rng} if rng else {})
            rows.append((st, hashlib.sha256(b).hexdigest(), h.get("content-range"),
                         h.get("x-weed-spliced"), h.get("x-weed-cache")))
        out[pkg] = rows
    if monkeypatch is not None:  # the port's own Python path, the splice off
        monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
        rows = []
        for rng in ranges:
            st, h, b = _http(stacks["port"].gw.url, "GET", f"/parity/{key}",
                             headers={"Range": rng} if rng else {})
            assert "x-weed-spliced" not in h, "the python path must not claim a splice"
            rows.append((st, hashlib.sha256(b).hexdigest(), h.get("content-range")))
        monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_PX")
        out["python"] = rows
    return out


@pytest.mark.parametrize("shape", ["single", "multi", "sparse"])
def test_get_splice_answers_as_the_jax_splice(stacks, shape, monkeypatch):
    size, chunk, gaps = {
        "single": (256 * 1024, 1 << 20, None),
        "multi": (5 * 64 * 1024 + 12345, 64 * 1024, None),
        "sparse": (6 * 64 * 1024, 64 * 1024, [(64 * 1024, 192 * 1024), (256 * 1024, 320 * 1024)]),
    }[shape]
    payload = _rng_bytes(len(shape), size)
    bodies = {pkg: s.install(shape, payload, chunk, gaps) for pkg, s in stacks.items()}
    assert bodies["port"] == bodies["jax"]
    before = dataplane.px_stats()
    got = _get_matrix(stacks, shape, monkeypatch=monkeypatch)
    assert got["port"] == got["jax"]
    assert [r[:3] for r in got["port"]] == got["python"]
    assert got["port"][0][:2] == (200, hashlib.sha256(bodies["port"]).hexdigest())
    assert got["port"][0][3] == "1"  # the whole-body GET rode the native relay
    after = dataplane.px_stats()
    assert after["get_spliced"] > before["get_spliced"]
    if shape == "sparse":  # a range inside a hole: zeros on both packages
        for s in stacks.values():
            st, _, b = _http(s.gw.url, "GET", "/parity/sparse", headers={"Range": "bytes=70000-80000"})
            assert (st, b) == (206, bytes(10001))


def test_small_bodies_and_416_answer_as_the_jax_splice(stacks):
    payload = _rng_bytes(3, 4096)
    assert len(payload) < splice.MIN_SPLICE_BYTES  # the Python path serves it
    for s in stacks.values():
        s.install("tiny", payload, 1 << 20)
        s.install("r416", _rng_bytes(4, 64 * 1024), 1 << 20)
    got = _get_matrix(stacks, "tiny", ranges=[None, "bytes=10-20"])
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == (200, hashlib.sha256(payload).hexdigest())
    assert got["port"][0][3] is None
    got = _get_matrix(stacks, "r416", ranges=["bytes=9999999-"])
    assert got["port"] == got["jax"] and got["port"][0][0] == 416


# -- PUT ------------------------------------------------------------------------------


@pytest.mark.parametrize("size", [300 * 1024, 2 * CHUNK + 12345], ids=["one_chunk", "three_chunks"])
def test_put_splice_etag_and_read_back(stacks, size):
    payload = _rng_bytes(size, size)
    out = {}
    for pkg, s in stacks.items():
        dp = PKGS[pkg]["dp"]
        before = dp.px_stats()["fanout_ok"]
        st, h, _ = _http(s.gw.url, "PUT", "/parity/put", payload)
        st2, _, b = _http(s.gw.url, "GET", "/parity/put")
        out[pkg] = (st, h["etag"], h.get("x-weed-spliced"), int(h["x-weed-put-ack-us"]) >= 0,
                    dp.px_stats()["fanout_ok"] - before, st2, b == payload)
    want = (200, f'"{hashlib.md5(payload).hexdigest()}"', "1", True, -(-size // CHUNK), 200, True)
    assert out["port"] == out["jax"] == want


def test_put_below_min_splice_and_with_the_splice_off(stacks, monkeypatch):
    small = _rng_bytes(1, 1024)
    big = _rng_bytes(2, 200 * 1024)
    out = {}
    for pkg, s in stacks.items():
        dp = PKGS[pkg]["dp"]
        before = dp.px_stats()["fanout_ok"]
        st, h, _ = _http(s.gw.url, "PUT", "/parity/put-small", small)
        rows = [(st, h["etag"], h.get("x-weed-spliced"), dp.px_stats()["fanout_ok"] - before)]
        monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
        st, h, _ = _http(s.gw.url, "PUT", "/parity/put-python", big)
        monkeypatch.delenv("SEAWEEDFS_TPU_NATIVE_PX")
        rows.append((st, h["etag"], h.get("x-weed-spliced")))
        rows.append(_http(s.gw.url, "GET", "/parity/put-python")[2] == big)
        out[pkg] = rows
    assert out["port"] == out["jax"] == [
        (200, f'"{hashlib.md5(small).hexdigest()}"', None, 0),
        (200, f'"{hashlib.md5(big).hexdigest()}"', None), True]


def test_mid_object_failure_rides_the_ladder_byte_exact(stacks, monkeypatch):
    """Chunk 2 of 3 finds its fan-out unreachable (_PX_NO_SEND): it replays
    through the Python ladder, the next chunk drains the bytes the ladder's
    read pulled past the boundary, and the ETag covers every chunk."""
    payload = _rng_bytes(7, 2 * CHUNK + 54321)
    out = {}
    for pkg, s in stacks.items():
        dp = PKGS[pkg]["dp"]
        calls = {"n": 0}
        real = dp.px_put_fanout

        def flaky(addrs, path, extra, initial, fd, sock_rem, state, dp=dp, real=real,
                  calls=calls, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                return (dp._PX_NO_SEND, "", None, [dp._PX_NO_SEND], 0, b"", 0, [])
            return real(addrs, path, extra, initial, fd, sock_rem, state, **kw)

        ladder = dataplane.px_stats()["ladder_put_replay"]
        monkeypatch.setattr(dp, "px_put_fanout", flaky)
        st, h, _ = _http(s.gw.url, "PUT", "/parity/ladder-mid", payload)
        monkeypatch.setattr(dp, "px_put_fanout", real)
        out[pkg] = (st, calls["n"], h["etag"], _http(s.gw.url, "GET", "/parity/ladder-mid")[2]
                    == payload)
        if pkg == "port":
            assert dataplane.px_stats()["ladder_put_replay"] == ladder + 1
    assert out["port"] == out["jax"] == (200, 3, f'"{hashlib.md5(payload).hexdigest()}"', True)


def test_loop_modes_are_byte_exact(stacks, monkeypatch):
    """The px loop's readiness engines share one state machine: PUT + GET
    under io_uring (where the kernel grants it; the loop falls back to
    epoll otherwise), under epoll (SEAWEEDFS_TPU_PX_URING=0) and with the
    loop off (SEAWEEDFS_TPU_PX_LOOP=0) give the JAX splice's ETag and the
    same bytes."""
    payload = _rng_bytes(9, (1 << 20) + 777)
    want = f'"{hashlib.md5(payload).hexdigest()}"'
    s = stacks["port"]
    modes = {}
    stats0 = dataplane.px_stats()
    try:
        for name, env in (("default", {}), ("epoll", {"SEAWEEDFS_TPU_PX_URING": "0"}),
                          ("off", {"SEAWEEDFS_TPU_PX_LOOP": "0"})):
            dataplane.px_loop_reset()
            for var in ("SEAWEEDFS_TPU_PX_URING", "SEAWEEDFS_TPU_PX_LOOP"):
                monkeypatch.delenv(var, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            mode = dataplane.px_loop_mode()
            st, h, _ = _http(s.gw.url, "PUT", f"/parity/loop-{name}", payload)
            st2, h2, b = _http(s.gw.url, "GET", f"/parity/loop-{name}")
            modes[name] = (mode, st, h["etag"], h.get("x-weed-spliced"), st2,
                           h2.get("x-weed-spliced"), b == payload)
    finally:
        dataplane.px_loop_reset()
    assert modes["default"][0] in (dataplane._PX_LOOP_URING, dataplane._PX_LOOP_EPOLL)
    assert modes["epoll"][0] == dataplane._PX_LOOP_EPOLL
    assert modes["off"][0] == dataplane._PX_LOOP_OFF
    for name, row in modes.items():
        assert row[1:] == (200, want, "1", 200, "1", True), name
    st, h, _ = _http(stacks["jax"].gw.url, "PUT", "/parity/loop-jax", payload)
    assert (st, h["etag"]) == (200, want)
    stats1 = dataplane.px_stats()
    assert stats1["loop_get_jobs"] >= stats0["loop_get_jobs"] + 2
    assert stats1["loop_put_jobs"] >= stats0["loop_put_jobs"] + 2


# -- StreamingBody, the fid stash ----------------------------------------------------


@pytest.mark.parametrize("cls", [StreamingBody, JaxStreamingBody], ids=["port", "jax"])
def test_pushback_and_take_buffered_round_trips(cls):
    body = cls(io.BufferedReader(io.BytesIO(b"abcdef")), 6)
    first = body.read(2)
    assert (first, body.remaining) == (b"ab", 4)
    body.pushback(first)
    assert body.remaining == 6 and body.read() == b"abcdef"
    raw = io.BufferedReader(io.BytesIO(b"x" * 100 + b"NEXT"))
    raw.peek()
    body = cls(raw, 100)
    held = body.take_buffered()
    assert held == b"x" * 100 and body.remaining == 0  # never past Content-Length
    body.pushback(held[:40])
    assert body.remaining == 40 and body.read(10) == b"x" * 10 and body.read() == b"x" * 30
    assert raw.read() == b"NEXT"


def test_fid_stash_round_robin_and_expiry():
    dataplane.px_stash_clear()
    key = 0xFEED
    assert dataplane.px_stash_push(key, 0, "1,aa01", ["127.0.0.1:80"], "t0", 5000)
    assert dataplane.px_stash_push(key, 1, "2,bb01", ["127.0.0.1:81", "127.0.0.1:82"], "t1", 5000)
    assert dataplane.px_stash_depth(key) == 2
    first, second = dataplane.px_stash_take(key), dataplane.px_stash_take(key)
    assert {first[0], second[0]} == {"1,aa01", "2,bb01"}
    assert (first[3], second[3]) == (1, 0)
    by_fid = {e[0]: e for e in (first, second)}
    assert by_fid["2,bb01"][1:3] == (["127.0.0.1:81", "127.0.0.1:82"], "t1")
    assert dataplane.px_stash_take(key) is None
    assert dataplane.px_stash_push(key, 0, "3,cc01", ["127.0.0.1:80"], "", 1)
    time.sleep(0.05)
    assert dataplane.px_stash_take(key) is None
    dataplane.px_stash_clear()


def test_the_gateway_pool_parks_reservations_natively(stacks):
    out = {}
    for pkg, s in stacks.items():
        st, _, _ = _http(s.gw.url, "PUT", "/parity/stash-warm", _rng_bytes(11, 64 * 1024))
        key = s.gw.fid_pool._stash_key(("", "", 0, "", 0))
        depth = PKGS[pkg]["dp"].px_stash_depth(key)
        ent = PKGS[pkg]["dp"].px_stash_take(key)
        out[pkg] = (st, depth > 0, ent is not None and "," in ent[0] and bool(ent[1]))
    assert out["port"] == out["jax"] == (200, True, True)


# -- the cache tier --------------------------------------------------------------------


def test_cache_tier_serves_warm_gets_as_the_jax_gateway(tmp_path, monkeypatch):
    """With a hot-chunk cache, the cold GET fills it, the warm one goes out
    of the cache (``x-weed-cache: 1``; a segment-tier hit through
    ``sw_px_cache_send``), byte-exact against the JAX gateway and the
    port's own Python path, for one chunk and a 4 KiB object (RAM tier)."""
    for var in ("SEAWEEDFS_TPU_NATIVE_DP", "SEAWEEDFS_TPU_NATIVE_PX"):
        monkeypatch.delenv(var, raising=False)
    made = _stacks(str(tmp_path), chunk_cache_mb=64)
    try:
        big, tiny = _rng_bytes(21, 256 * 1024), _rng_bytes(22, 4096)
        for s in made.values():
            s.install("c-big", big, 1 << 20)
            s.install("c-tiny", tiny, 1 << 20)
        sends = dataplane.px_stats()["cache_send_ok"]
        got = {}
        for pkg, s in made.items():
            rows = []
            for key in ("c-big", "c-tiny"):
                for rng in (None, None, "bytes=1000-9999"):
                    st, h, b = _http(s.gw.url, "GET", f"/parity/{key}",
                                     headers={"Range": rng} if rng else {})
                    rows.append((st, hashlib.sha256(b).hexdigest(), h.get("x-weed-cache"),
                                 h.get("x-weed-spliced")))
            got[pkg] = rows
        assert got["port"] == got["jax"]
        assert [r[2] for r in got["port"]] == [None, "1", None, None, "1", None]
        assert got["port"][1][:2] == (200, hashlib.sha256(big).hexdigest())
        assert dataplane.px_stats()["cache_send_ok"] >= sends + 1
        monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
        st, _, b = _http(made["port"].gw.url, "GET", "/parity/c-big")
        assert (st, b) == (200, big)
    finally:
        for s in made.values():
            s.stop()


# -- a holder SIGKILLed mid-splice --------------------------------------------------------

_VICTIM = """
import sys, time
sys.path.insert(0, {repo!r})
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
vs = VolumeServer([{d!r}], {master!r}, port=0, grpc_port=0, heartbeat_interval=0.2,
                  max_volume_counts=[16], device="cpu")
vs.start()
print("UP", flush=True)
while True:
    time.sleep(3600)
"""


def _readline(proc, timeout: float) -> str:
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, f"no line from the subprocess within {timeout}s"
    return proc.stdout.readline()


def test_a_holder_killed_mid_splice_completes_through_the_ladder(tmp_path, monkeypatch):
    """A 6 MiB object in 512 KiB chunks on two holders (001), one of them a
    real port volume-server process; the client stalls with most of the
    body undelivered and that holder is SIGKILLed: the response still ends
    byte-exact, finished from the survivor."""
    for var in ("SEAWEEDFS_TPU_NATIVE_DP", "SEAWEEDFS_TPU_NATIVE_PX"):
        monkeypatch.delenv(var, raising=False)
    master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=256)
    master.start()
    survivor = victim = gw = None
    try:
        survivor = volume_server.VolumeServer([str(tmp_path / "s")], master.grpc_address, port=0,
                                              grpc_port=0, heartbeat_interval=0.2,
                                              max_volume_counts=[16], device="cpu")
        os.makedirs(tmp_path / "s", exist_ok=True)
        survivor.start()
        os.makedirs(tmp_path / "v")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        victim = subprocess.Popen(
            [sys.executable, "-c", _VICTIM.format(repo=REPO, d=str(tmp_path / "v"),
                                                  master=master.grpc_address)],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        assert _readline(victim, 60).strip() == "UP"
        _wait(lambda: len(master.topology.nodes) == 2, "both holders")
        gw = S3ApiServer(master.grpc_address, port=0, chunk_cache_mb=0)
        gw.start()
        assert _http(gw.url, "PUT", "/chaos")[0] == 200
        payload = _rng_bytes(31, 6 * 1024 * 1024)
        chunks, content, _ = upload.upload_stream(gw.master, io.BytesIO(payload),
                                                  chunk_size=512 * 1024, replication="001",
                                                  inline_limit=0)
        assert content == b"" and len(chunks) == 12
        entry = Entry(full_path=gw.object_path("chaos", "big"), chunks=chunks,
                      attr=Attr.now(mime="application/octet-stream"))
        entry.extended["etag"] = hashlib.md5(payload).hexdigest().encode()
        gw.filer.create_entry(entry)
        host, port = gw.url.split(":")
        sock = socket.create_connection((host, int(port)), timeout=60)
        try:
            sock.sendall(b"GET /chaos/big HTTP/1.1\r\nHost: t\r\n\r\n")
            got = bytearray()
            while b"\r\n\r\n" not in got:
                got += sock.recv(65536)
            time.sleep(0.3)
            victim.kill()  # SIGKILL, mid-splice
            victim.wait(timeout=10)
            want_total = got.index(b"\r\n\r\n") + 4 + len(payload)
            deadline = time.monotonic() + 90
            while len(got) < want_total:
                assert time.monotonic() < deadline, "the splice failover hung"
                piece = sock.recv(1 << 20)
                if not piece:
                    break
                got += piece
        finally:
            sock.close()
        body = bytes(got[got.index(b"\r\n\r\n") + 4:])
        assert body == payload, f"{len(body)}/{len(payload)} bytes"
    finally:
        if gw is not None:
            gw.stop()
        if victim is not None and victim.poll() is None:
            victim.kill()
            victim.wait(timeout=10)
        if survivor is not None:
            survivor.stop()
        master.stop()
