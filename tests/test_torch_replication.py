"""The port's replication layer (seaweedfs_tpu_torch/replication/, the
filer's ``-notify`` bus, ``cli filer.sync``) held against the JAX package's.

- ``Replicator`` over ``LocalSink``: the same seeded event list (creates,
  updates, deletes, renames, events outside the source dir or under an
  excluded one, and a path that escapes the sink) writes the same tree in
  both packages, and both refuse the escape alike.
- ``Notifier`` over ``LogFileBus``: the same filer mutations give the same
  JSON lines from both packages' filers (``ts_ns`` masked).
- End to end, two port clusters on the CPU: A with its filer on
  tests/mini_redis.py (``redis://``) and a ``-notify`` log, B with its
  filer on tests/mini_etcd.py (``etcd://``).  ``FilerSyncer`` with
  ``FilerSink`` replicates A's tree into B; a fresh syncer resumes from
  the checkpoint and misses no event; ``S3Sink`` backs up into the port's
  own gateway; a restarted source filer is followed again once its
  breaker has opened (the half-open probe slot is given back).
- Across packages: the JAX ``FilerSyncer`` follows a port filer and the
  port's follows a JAX filer; both land the same tree.
- The slice as a whole: B, filled by ``filer.sync``, is EC-encoded
  (``ec.encode -collection syncdata``, ``device="cpu"``), its shards equal
  ``ReedSolomonCPU``'s on the volumes' ``.dat``, and every synced file
  reads back from the shards.

The tolerance is byte equality, with the clocks each test names masked.
Every server binds port 0 (a restarted filer binds its old ports) and
every wait polls with a deadline.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
from mini_etcd import MiniEtcdServer
from mini_redis import MiniRedisServer

from seaweedfs_tpu.filer import entry as jax_entry
from seaweedfs_tpu.filer import filer as jax_filer_mod
from seaweedfs_tpu.replication import notification as jax_notification
from seaweedfs_tpu.replication import replicator as jax_replicator
from seaweedfs_tpu.replication import sink as jax_sink
from seaweedfs_tpu_torch.filer import entry
from seaweedfs_tpu_torch.filer import filer as filer_mod
from seaweedfs_tpu_torch.replication import notification, replicator, sink

WAIT_S = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _http(addr: str, method: str, path: str, body: bytes = b""):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body or None)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _body(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _tree(root: str) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirs:
            out[os.path.normpath(os.path.join(rel, d)) + "/"] = None
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


# -- the replicator over a local sink ------------------------------------------------


def _events(seed: int) -> list[tuple]:
    """Package-neutral event list: (old, new, new_parent) with entries as
    (path, is_dir, mtime) or None."""
    rng = np.random.default_rng(seed)
    names = [f"f{i}" for i in range(12)]
    dirs = ["/src", "/src/a", "/src/a/b", "/src/tmp", "/other"]
    live: dict[str, tuple] = {}
    out: list[tuple] = []
    for d in dirs:
        e = (d, True, 1)
        out.append((None, e, ""))
        live[d] = e
    for i in range(90):
        r = rng.random()
        files = [p for p, e in live.items() if not e[1]]
        if r < 0.5 or not files:
            d = dirs[int(rng.integers(len(dirs)))]
            p = d + "/" + names[int(rng.integers(len(names)))]
            new = (p, False, 100 + i)
            out.append((live.get(p), new, ""))
            live[p] = new
        elif r < 0.7:
            p = files[int(rng.integers(len(files)))]
            out.append((live.pop(p), None, ""))
        elif r < 0.9:
            p = files[int(rng.integers(len(files)))]
            d = dirs[int(rng.integers(len(dirs)))]
            q = d + "/r" + names[int(rng.integers(len(names)))]
            if q in live:
                continue
            old = live.pop(p)
            new = (q, False, old[2])
            out.append((old, new, d))
            live[q] = new
        else:
            out.append((live.get("/src/a/b"), None, ""))  # a directory delete
            for p in [p for p in live if p.startswith("/src/a/b")]:
                live.pop(p)
            out.append((None, ("/src/a/b", True, 2), ""))
            live["/src/a/b"] = ("/src/a/b", True, 2)
    return out


def _replay(mods, root: str, events, **kw) -> list:
    emod, fmod, rmod, smod = mods

    def mk(t):
        if t is None:
            return None
        return emod.Entry(t[0], is_directory=t[1], attr=emod.Attr(mtime=t[2], crtime=t[2]))

    rep = rmod.Replicator(smod.LocalSink(root),
                          lambda e: hashlib.sha256(f"{e.full_path}@{e.attr.mtime}".encode())
                          .digest() * 40, **kw)
    errors = []
    for i, (old, new, parent) in enumerate(events):
        try:
            rep.replicate(fmod.MetaEvent(1000 + i, "/", mk(old), mk(new), parent))
        except ValueError as e:
            errors.append((i, str(e)))
    return errors


JAX_MODS = (jax_entry, jax_filer_mod, jax_replicator, jax_sink)
PORT_MODS = (entry, filer_mod, replicator, sink)


@pytest.mark.parametrize("kw", [
    dict(), dict(source_dir="/src"), dict(source_dir="/src", exclude_dirs=("/src/tmp",)),
    dict(exclude_dirs=("/other", "/src/a/b"))], ids=["root", "rebase", "exclude", "no_rebase"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replicator_writes_the_jax_tree(tmp_path, seed, kw):
    events = _events(seed)
    got = _replay(PORT_MODS, str(tmp_path / "port"), events, **kw)
    want = _replay(JAX_MODS, str(tmp_path / "jax"), events, **kw)
    assert got == want
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    assert len(_tree(str(tmp_path / "jax"))) > 3


@pytest.mark.parametrize("key", ["/../evil", "/a/../../evil", "/../../etc/passwd"])
def test_path_that_escapes_the_sink_is_refused_alike(tmp_path, key):
    outcomes = []
    for mods, name in ((PORT_MODS, "port"), (JAX_MODS, "jax")):
        emod, _f, _r, smod = mods
        s = smod.LocalSink(str(tmp_path / name))
        with pytest.raises(ValueError) as e:
            s.create_entry(key, emod.Entry(key), lambda: b"x")
        outcomes.append(str(e.value))
        with pytest.raises(ValueError):
            s.delete_entry(key, False)
    assert outcomes[0] == outcomes[1]
    assert not os.path.exists(tmp_path / "evil")


def test_rebase_refuses_a_path_outside_the_source_alike():
    for rmod in (replicator, jax_replicator):
        r = rmod.Replicator(None, None, source_dir="/src", exclude_dirs=("/src/x",))
        assert [r._rebase(p) for p in ("/src", "/src/a", "/srcx/a", "/x", "/src/x/y",
                                       "/src/xy")] == ["/", "/a", None, None, None, "/xy"]


def test_sink_factory_answers_as_jax(tmp_path):
    # (gcs:// and pubsub: are left out: with their SDK installed they look
    # for cloud credentials, which can mean a metadata-server probe)
    specs = ["azure://container", "b2://bucket", "s3://missing-creds",
             "s3://a:b@h:1", "ftp://x", f"dir:{tmp_path / 'd'}", str(tmp_path / "e"),
             "filer://127.0.0.1:1/p", "s3://a:b@h:1/bk/pre/fix"]
    for spec in specs:
        out = []
        for smod in (sink, jax_sink):
            try:
                s = smod.make_sink(spec)
                out.append((type(s).__name__, getattr(s, "bucket", None),
                            getattr(s, "prefix", None), getattr(s, "target_path", None)))
            except (RuntimeError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], spec


# -- the notification bus -------------------------------------------------------------


def _mutate(emod, f, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(40):
        p = f"/n/d{int(rng.integers(3))}/f{int(rng.integers(8))}"
        e = emod.Entry(p, attr=emod.Attr(mtime=float(i), crtime=float(i)),
                       content=rng.bytes(int(rng.integers(0, 50))))
        if f.find_entry(p) is None:
            f.create_entry(e)
        else:
            f.update_entry(e)
        if i % 7 == 3:
            f.rename(p, p + ".moved")
        if i % 11 == 5:
            f.delete_entry(p + ".moved" if i % 7 == 3 else p)
    f.delete_entry("/n/d1", recursive=True)


def test_an_event_stamped_like_the_last_still_reaches_a_subscriber(monkeypatch):
    """Two mutations in one clock tick: a subscriber that has seen the
    first resumes at ``ts > its stamp``.  The JAX filer stamps both alike
    and the second never reaches it; the port's stamps strictly increase
    (ROADMAP Queue C item 20)."""
    seen = {}
    for name, fmod, emod in (("port", filer_mod, entry), ("jax", jax_filer_mod, jax_entry)):
        f = fmod.Filer()
        with monkeypatch.context() as m:
            m.setattr(time, "time_ns", lambda: 1_000_000)
            f.create_entry(emod.Entry("/q/a", content=b"a"))
            cursor = f.meta_log.events[-1].ts_ns
            f.create_entry(emod.Entry("/q/b", content=b"b"))
        seen[name] = [ev.new_entry.full_path for ev in f.read_meta_events(cursor)]
        stamps = [ev.ts_ns for ev in f.meta_log.events]
        assert stamps == sorted(stamps)
    assert seen == {"port": ["/q/b"], "jax": []}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_log_bus_lines_match_jax(tmp_path, seed):
    lines = {}
    for name, fmod, emod, nmod in (("port", filer_mod, entry, notification),
                                   ("jax", jax_filer_mod, jax_entry, jax_notification)):
        path = str(tmp_path / f"{name}.jsonl")
        f = fmod.Filer()
        f.notifier = nmod.Notifier(nmod.LogFileBus(path))
        _mutate(emod, f, seed)
        n = len(f.meta_log.events)
        _wait(lambda: f.notifier.delivered == n, f"{name}'s bus to drain")
        f.notifier.close()
        assert f.notifier.dropped == 0 and f.notifier.errors == 0
        with open(path) as fh:
            got = [json.loads(line) for line in fh]
        stamps = [d.pop("ts_ns") for d in got]
        assert stamps == sorted(stamps) == [ev.ts_ns for ev in f.meta_log.events]
        lines[name] = got
    assert lines["port"] == lines["jax"]
    assert any(d["new_path"] is None for d in lines["port"])


def test_make_bus_answers_as_jax(tmp_path):
    for spec in ("bogus:x", "kafka://h:9092/t", "sqs:https://q", "mq://127.0.0.1:1/t"):
        out = []
        for nmod in (notification, jax_notification):
            try:
                out.append(type(nmod.make_bus(spec)).__name__)
            except Exception as e:  # noqa: BLE001 — the refusal is the outcome
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], spec
    for nmod in (notification, jax_notification):
        b = nmod.make_bus(f"log:{tmp_path / 'x.jsonl'}")
        assert type(b).__name__ == "LogFileBus"
        b.close()


def test_webhook_bus_posts_each_event_as_jax(tmp_path):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    got: list = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers["Content-Length"])
            got.append((self.path, self.headers["Content-Type"], self.rfile.read(n)))
            self.send_response(204 if len(got) % 5 else 500)
            self.send_header("Content-Length", "0")
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        seen = {}
        for name, nmod in (("port", notification), ("jax", jax_notification)):
            start = len(got)
            bus = nmod.WebhookBus(f"http://127.0.0.1:{srv.server_address[1]}/hook")
            errors = 0
            for i in range(6):
                try:
                    bus.send({"i": i, "directory": "/d"})
                except IOError:
                    errors += 1
            seen[name] = (got[start:], errors)
        assert seen["port"][0] == seen["jax"][0] and len(seen["port"][0]) == 6
        assert seen["port"][1] == seen["jax"][1] == 1
    finally:
        srv.shutdown()
        srv.server_close()


# -- two port clusters, end to end ------------------------------------------------------


class _Stack:
    """One port cluster on the CPU: a master, volume servers, a filer."""

    def __init__(self, root: str, name: str, store: str, n_servers: int = 2, notify: str = ""):
        from seaweedfs_tpu_torch.server import master_server, volume_server

        self.root, self.name, self.store, self.notify = root, name, store, notify
        self.master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=8)
        self.master.start()
        self.servers = []
        for i in range(n_servers):
            d = os.path.join(root, f"{name}-v{i}")
            os.makedirs(d)
            vs = volume_server.VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                            rack=f"rack{i % 2}", heartbeat_interval=0.2,
                                            device="cpu", scrub_interval_s=0)
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == n_servers, f"{name}'s heartbeats")
        self.filer = None
        self.start_filer()

    def start_filer(self, port: int = 0, grpc_port: int = 0) -> None:
        from seaweedfs_tpu_torch.server import filer_server

        self.filer = filer_server.FilerServer(
            self.master.grpc_address, port=port, grpc_port=grpc_port, store_path=self.store,
            chunk_size=64 * 1024, meta_log_dir=os.path.join(self.root, f"{self.name}-metalog"),
            notify=self.notify)
        self.filer.start()

    def stop(self) -> None:
        if self.filer is not None:
            self.filer.stop()
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def _files(addr: str, d: str) -> dict:
    """{path: bytes} of every file under ``d`` through a filer's HTTP API."""
    out: dict = {}
    last = ""
    while True:
        st, body = _http(addr, "GET", f"{d}/?limit=100&lastFileName={last}")
        if st == 404:
            return out
        assert st == 200, (d, st)
        entries = json.loads(body)["Entries"] or []
        for e in entries:
            p = e["FullPath"]
            if e["IsDirectory"]:
                out.update(_files(addr, p))
            else:
                out[p] = _http(addr, "GET", p)[1]
        if len(entries) < 100:
            return out
        last = entries[-1]["FullPath"].rsplit("/", 1)[1]


@pytest.fixture(scope="module")
def clusters():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-repl-")
    redis, etcd = MiniRedisServer().start(), MiniEtcdServer().start()
    made = {}
    try:
        made["a"] = _Stack(root, "a", f"redis://127.0.0.1:{redis.port}/0",
                           notify=f"log:{os.path.join(root, 'events.jsonl')}")
        made["b"] = _Stack(root, "b", f"etcd://127.0.0.1:{etcd.port}", n_servers=3)
        made["root"] = root
        yield made
    finally:
        for k in ("a", "b"):
            if k in made:
                made[k].stop()
        redis.stop()
        etcd.stop()
        shutil.rmtree(root, ignore_errors=True)
        mp.undo()


def _fill(c, prefix: str, seed: int, n: int = 12) -> dict:
    rng = np.random.default_rng(seed)
    files = {}
    for i in range(n):
        size = int(rng.choice([100, 2000, 5000, 70_000, 200_000]))
        p = f"{prefix}/d{i % 3}/f{i}.bin"
        files[p] = _body(seed * 1000 + i, size)
        st, _ = _http(c.filer.url, "POST", p + "?collection=syncdata", files[p])
        assert st == 201, p
    return files


def _syncer(clusters, src: str, dst: str, ckpt: str, **kw):
    from seaweedfs_tpu_torch.replication import FilerSink, FilerSyncer

    a, b = clusters["a"], clusters["b"]
    return FilerSyncer(a.filer.grpc_address, a.master.grpc_address,
                       FilerSink(b.filer.grpc_address, target_path=dst), source_dir=src,
                       checkpoint_path=ckpt, poll_timeout=1.0, **kw)


def _rebased(files: dict, src: str, dst: str) -> dict:
    return {dst + p[len(src):]: d for p, d in files.items()}


def test_sync_replicates_the_tree_and_resumes_from_the_checkpoint(clusters):
    a, b = clusters["a"], clusters["b"]
    ckpt = os.path.join(clusters["root"], "sync1.ckpt")
    files = _fill(a, "/s1", 1)
    s = _syncer(clusters, "/s1", "/t1", ckpt)
    s.drain()
    assert not s.errors, s.errors
    assert _files(b.filer.url, "/t1") == _rebased(files, "/s1", "/t1")
    applied_first = s.applied
    # mutations, replayed by a FRESH syncer from the checkpoint alone
    more = _fill(a, "/s1", 2, n=6)
    files.update(more)
    gone = sorted(files)[:3]
    for p in gone:
        assert _http(a.filer.url, "DELETE", p)[0] in (200, 202, 204)
        files.pop(p)
    moved = sorted(files)[-1]
    a.filer.filer.rename(moved, "/s1/renamed.bin")
    files["/s1/renamed.bin"] = files.pop(moved)
    # one event at a time across three processes' worth of syncers: none is lost
    s2 = _syncer(clusters, "/s1", "/t1", ckpt)
    s2.drain(max_events=2)
    s3 = _syncer(clusters, "/s1", "/t1", ckpt)
    s3.drain()
    assert not s2.errors and not s3.errors, (s2.errors, s3.errors)
    assert s2.applied + s2.skipped == 2 and s3.applied > 0
    assert _files(b.filer.url, "/t1") == _rebased(files, "/s1", "/t1")
    for p in gone:
        assert _http(b.filer.url, "GET", "/t1" + p[len("/s1"):])[0] == 404
    # nothing is applied twice: the checkpoint holds the last event
    s4 = _syncer(clusters, "/s1", "/t1", ckpt)
    s4.drain()
    assert s4.applied == 0 and applied_first > len(files) // 2


def test_event_whose_source_chunk_is_gone_is_skipped_not_retried(clusters):
    """A replay that reaches an overwrite whose chunks a later delete
    removed: the JAX syncer stops at it on every pass (the source answers
    404), the port's skips it and lands the final tree (ROADMAP Queue C
    item 18)."""
    from seaweedfs_tpu.replication import FilerSink as JaxFilerSink
    from seaweedfs_tpu.replication import FilerSyncer as JaxFilerSyncer

    a, b = clusters["a"], clusters["b"]
    files = _fill(a, "/gone", 10, n=6)
    for p in sorted(files)[:2]:  # overwrite, then delete: the overwrite's chunks go
        assert _http(a.filer.url, "POST", p, _body(99, 80_000))[0] == 201
        assert _http(a.filer.url, "DELETE", p)[0] in (200, 202, 204)
        files.pop(p)
    root = clusters["root"]
    jax = JaxFilerSyncer(a.filer.grpc_address, a.master.grpc_address,
                         JaxFilerSink(b.filer.grpc_address, target_path="/gone-jax"),
                         source_dir="/gone", checkpoint_path=os.path.join(root, "gj.ckpt"),
                         poll_timeout=1.0)
    port = _syncer(clusters, "/gone", "/gone-port", os.path.join(root, "gp.ckpt"))
    for _ in range(5):  # passes until the JAX syncer reaches the stale event
        jax.run_once()
        if jax.errors:
            break
    jax.run_once()  # and stops at it again
    port.drain()
    assert jax.errors and all("HTTP 404" in e for e in jax.errors)
    assert _files(b.filer.url, "/gone-jax") != _rebased(files, "/gone", "/gone-jax")
    assert not port.errors and port.skipped >= 2
    assert _files(b.filer.url, "/gone-port") == _rebased(files, "/gone", "/gone-port")


class _SlowSink:
    """A sink that takes ``delay`` seconds an event: a backlog longer than
    one stream pass."""

    def __init__(self, smod, root: str, delay: float):
        self.inner, self.delay = smod.LocalSink(root), delay

    def create_entry(self, key, entry, read_data):
        time.sleep(self.delay)
        self.inner.create_entry(key, entry, read_data)

    def delete_entry(self, key, is_directory):
        time.sleep(self.delay)
        self.inner.delete_entry(key, is_directory)


def test_once_drains_a_backlog_longer_than_one_pass(clusters, tmp_path):
    """``-once`` of the JAX commands is one ``run_once`` pass, which the
    stream's deadline ends with the backlog half applied; the port's
    ``drain`` runs passes until one applies nothing (ROADMAP Queue C item
    19)."""
    from seaweedfs_tpu.replication import FilerSyncer as JaxFilerSyncer
    from seaweedfs_tpu.replication import sink as jsink
    from seaweedfs_tpu_torch.replication import FilerSyncer

    a = clusters["a"]
    files = _fill(a, "/drain", 11, n=12)
    got = {}
    for name, cls, smod, call in (("jax", JaxFilerSyncer, jsink, "run_once"),
                                  ("port", FilerSyncer, sink, "drain")):
        s = cls(a.filer.grpc_address, a.master.grpc_address,
                _SlowSink(smod, str(tmp_path / name), 0.15), source_dir="/drain",
                checkpoint_path=str(tmp_path / f"{name}.ckpt"), poll_timeout=0.8)
        getattr(s, call)()
        assert not s.errors
        got[name] = {k: v for k, v in _tree(str(tmp_path / name)).items() if v is not None}
    want = {p[len("/drain/"):]: d for p, d in files.items()}
    assert got["port"] == want
    assert len(got["jax"]) < len(want)


def test_notify_log_holds_every_metadata_event(clusters):
    a = clusters["a"]
    _fill(a, "/nt", 3, n=4)
    log = os.path.join(clusters["root"], "events.jsonl")
    n_events = len(a.filer.filer.read_meta_events(0, "/nt"))

    def lines():
        with open(log) as fh:
            return [json.loads(x) for x in fh]

    _wait(lambda: len([d for d in lines() if (d["new_path"] or d["old_path"] or "")
                       .startswith("/nt")]) == n_events, "the notify log to catch up")
    got = [d for d in lines() if (d["new_path"] or d["old_path"] or "").startswith("/nt")]
    assert [d["ts_ns"] for d in got] == sorted(d["ts_ns"] for d in got)
    assert {d["new_path"] for d in got} >= {f"/nt/d{i % 3}/f{i}.bin" for i in range(4)}


def test_s3_sink_backs_up_into_the_port_gateway(clusters):
    from seaweedfs_tpu_torch.filer.remote import RemoteFiler
    from seaweedfs_tpu_torch.replication import FilerSyncer, make_sink
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.s3.auth import Identity
    from seaweedfs_tpu_torch.wdclient import MasterClient

    a, b = clusters["a"], clusters["b"]
    gw = S3ApiServer(b.master.grpc_address, port=0,
                     filer=RemoteFiler(b.filer.grpc_address, MasterClient(b.master.grpc_address)),
                     identities={"AKBAK": Identity("AKBAK", "SKBAK", "admin")})
    gw.start()
    try:
        s3 = make_sink(f"s3://AKBAK:SKBAK@{gw.url}/backup/pre")
        assert s3._request("PUT", "")[0] in (200, 409)
        files = _fill(a, "/s3b", 4, n=8)
        syncer = FilerSyncer(a.filer.grpc_address, a.master.grpc_address, s3,
                             source_dir="/s3b", poll_timeout=1.0)
        syncer.drain()
        assert not syncer.errors, syncer.errors
        for p, data in files.items():
            assert s3._request("GET", "pre" + p[len("/s3b"):]) == (200, data), p
        assert _http(a.filer.url, "DELETE", "/s3b/d1?recursive=true")[0] in (200, 202, 204)
        syncer.drain()
        assert not syncer.errors, syncer.errors
        for p in files:
            st, _ = s3._request("GET", "pre" + p[len("/s3b"):])
            assert st == (404 if p.startswith("/s3b/d1/") else 200), p
    finally:
        gw.stop()


def test_restarted_source_filer_is_followed_again(clusters):
    """The syncer tails A while A's filer goes down long enough for the
    breaker to open, then comes back on its old ports (same ``redis://``
    store, same meta log): the next write reaches B, and the breaker is
    closed again — the idle stream gave its half-open probe slot back."""
    from seaweedfs_tpu_torch.util import resilience

    a, b = clusters["a"], clusters["b"]
    ckpt = os.path.join(clusters["root"], "sync-restart.ckpt")
    files = _fill(a, "/rs", 5, n=4)
    s = _syncer(clusters, "/rs", "/rs", ckpt)
    s.start()
    try:
        _wait(lambda: _files(b.filer.url, "/rs") == files, "the first pass at B")
        port, grpc_port, addr = a.filer.port, int(a.filer.grpc_address.rsplit(":", 1)[1]), \
            a.filer.grpc_address
        a.filer.stop()
        _wait(lambda: (br := resilience.breakers.get(addr)) is not None and br.state == "open",
              "the source filer's breaker to open")
        a.start_filer(port=port, grpc_port=grpc_port)
        assert _http(a.filer.url, "GET", next(iter(files)))[1] == files[next(iter(files))]
        late = {"/rs/late.bin": _body(77, 9000)}
        assert _http(a.filer.url, "POST", "/rs/late.bin?collection=syncdata",
                     late["/rs/late.bin"])[0] == 201
        files.update(late)
        _wait(lambda: _files(b.filer.url, "/rs") == files, "the late write at B")
        _wait(lambda: resilience.breakers.get(addr).state == "closed",
              "the breaker to close again")
    finally:
        s.stop()


def test_filer_sync_command_runs_as_a_process(clusters, tmp_path):
    a, b = clusters["a"], clusters["b"]
    files = _fill(a, "/cmd", 6, n=5)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    argv = [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "filer.sync", "-fromFiler",
            a.filer.grpc_address, "-fromMaster", a.master.grpc_address, "-toFiler",
            b.filer.grpc_address, "-fromPath", "/cmd", "-toPath", "/cmd", "-checkpoint",
            str(tmp_path / "cmd.ckpt"), "-once"]
    r = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("applied ") and r.stdout.rstrip().endswith(", 0 errors")
    assert _files(b.filer.url, "/cmd") == files
    tail = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "filer.meta.tail", "-filer",
         a.filer.grpc_address, "-path", "/cmd", "-sinceSeconds", "600", "-maxEvents", "3"],
        env=env, capture_output=True, text=True, timeout=120)
    assert tail.returncode == 0, tail.stderr
    lines = [json.loads(x) for x in tail.stdout.splitlines()]
    assert len(lines) == 3 and all(set(d) == {"ts_ns", "dir", "old", "new", "rename_to"}
                                   for d in lines)


# -- across packages ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cluster():
    """One JAX master + volume server + filer (its Python data plane)."""
    from seaweedfs_tpu.server.filer_server import FilerServer
    from seaweedfs_tpu.server.master_server import MasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer

    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    d = tempfile.mkdtemp(prefix="jax-repl-")
    master = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([d], master.grpc_address, port=0, grpc_port=0, heartbeat_interval=0.2)
    vs.start()
    _wait(lambda: len(master.topology.nodes) == 1, "the JAX heartbeat")
    fs = FilerServer(master.grpc_address, port=0, grpc_port=0, chunk_size=64 * 1024)
    fs.start()
    yield master, fs
    fs.stop()
    vs.stop()
    master.stop()
    shutil.rmtree(d, ignore_errors=True)
    mp.undo()


def test_each_package_syncer_follows_the_other_package_filer(clusters, jax_cluster, tmp_path):
    from seaweedfs_tpu.replication import FilerSyncer as JaxFilerSyncer
    from seaweedfs_tpu.replication import LocalSink as JaxLocalSink
    from seaweedfs_tpu_torch.replication import FilerSyncer, LocalSink

    a = clusters["a"]
    jm, jf = jax_cluster
    files = {}
    for target in (a.filer.url, jf.url):
        rng = np.random.default_rng(8)
        for i in range(6):
            p = f"/x/d{i % 2}/f{i}"
            files[p] = _body(800 + i, int(rng.choice([300, 3000, 150_000])))
            assert _http(target, "POST", p, files[p])[0] == 201
        assert _http(target, "DELETE", "/x/d1/f1")[0] in (200, 202, 204)
    files.pop("/x/d1/f1")
    jax_syncer = JaxFilerSyncer(a.filer.grpc_address, a.master.grpc_address,
                                JaxLocalSink(str(tmp_path / "jax_from_port")),
                                source_dir="/x", poll_timeout=1.0,
                                checkpoint_path=str(tmp_path / "jax.ckpt"))
    while True:  # the JAX syncer has no drain: passes until one applies nothing
        before = jax_syncer.applied
        jax_syncer.run_once()
        if jax_syncer.applied == before or jax_syncer.errors:
            break
    port_syncer = FilerSyncer(jf.grpc_address, jm.grpc_address,
                              LocalSink(str(tmp_path / "port_from_jax")),
                              source_dir="/x", poll_timeout=1.0)
    port_syncer.drain()
    assert not jax_syncer.errors and not port_syncer.errors
    want = {p[len("/x/"):]: d for p, d in files.items()}
    for tree in (_tree(str(tmp_path / "jax_from_port")), _tree(str(tmp_path / "port_from_jax"))):
        assert {k: v for k, v in tree.items() if v is not None} == want


# -- the slice: sync, then ec.encode at the target ---------------------------------------


def _oracle_shards(dat: bytes) -> list[bytes]:
    """RS(10,4) shards of a .dat under the small-block layout (1 MiB
    blocks, rows of 10, zero-padded), parity by ReedSolomonCPU."""
    from seaweedfs_tpu_torch.ops.rs_cpu import ReedSolomonCPU

    k, block = 10, 1024 * 1024
    row = k * block
    assert len(dat) <= 1024 * 1024 * 1024 * k  # no large-block rows at this size
    padded = dat + bytes(-len(dat) % row)
    rows = np.frombuffer(padded, dtype=np.uint8).reshape(-1, k, block)
    data = np.ascontiguousarray(rows.transpose(1, 0, 2).reshape(k, -1))
    parity = ReedSolomonCPU(10, 4).encode(data)
    return [data[i].tobytes() for i in range(k)] + [parity[i].tobytes() for i in range(4)]


def test_synced_cluster_ec_encodes_to_the_cpu_oracle(clusters):
    from seaweedfs_tpu_torch.shell import run_command
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    a, b = clusters["a"], clusters["b"]
    files = _fill(a, "/ecs", 9, n=15)
    s = _syncer(clusters, "/ecs", "/ecs", os.path.join(clusters["root"], "ec.ckpt"))
    s.drain()
    assert not s.errors, s.errors
    assert _files(b.filer.url, "/ecs") == files
    vids = sorted({int(c.fid.split(",")[0]) for p in files
                   for c in b.filer.filer.find_entry(p).chunks})
    assert vids
    dats = {}
    for vid in vids:
        (vol,) = [vs.store.find_volume(vid) for vs in b.servers if vs.store.find_volume(vid)]
        assert vol.collection == "syncdata"
        with open(vol.base + ".dat", "rb") as fh:
            dats[vid] = fh.read()
    env = CommandEnv(b.master.grpc_address)
    out = io.StringIO()
    try:
        run_command(env, "lock", out)
        run_command(env, "ec.encode -collection syncdata -fullPercent 0 -quietFor 0", out)
    finally:
        env.release_lock()
    _wait(lambda: all(vs.store.find_volume(v) is None for vs in b.servers for v in vids),
          "the encoded volumes to go")
    for vid in vids:
        shards: dict = {}
        for vs in b.servers:
            d = vs.store.locations[0].directory
            for sid in range(14):
                p = os.path.join(d, f"syncdata_{vid}.ec{sid:02d}")
                if os.path.exists(p):
                    with open(p, "rb") as fh:
                        shards[sid] = fh.read()
        assert sorted(shards) == list(range(14)), (vid, sorted(shards))
        assert [shards[i] for i in range(14)] == _oracle_shards(dats[vid]), vid
    for p, data in files.items():
        assert _http(b.filer.url, "GET", p) == (200, data), p
