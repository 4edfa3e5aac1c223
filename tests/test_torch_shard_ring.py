"""The port's sharded filer plane (filer/shard_ring.py), held against the
JAX package's on the CPU.

- ``ShardRing``: seeded paths go to the same owner in both packages, for 1-5
  shards and when a shard is added; ``route_prefix`` and the ownership
  shares agree.
- ``ShardedFilerClient``: the JAX package's router battery (CRUD, ring
  placement, merged shallow listings, the same-shard rename, the two-phase
  move, shallow deletes, statistics, liveness) runs through a port router
  over three port filer servers and through a JAX router over three JAX
  filer servers, with equal results.
- With one shard the port's router makes the calls a bare ``RemoteFiler``
  makes, call for call, and the JAX router's sequence is the same.
- A JAX router reads what the port's router wrote over the same port shards.
- A dead shard: its buckets answer 503 with Retry-After through the port's
  and the JAX gateway alike, the other buckets 200.

Every server binds port 0 and every wait has a deadline."""

from __future__ import annotations

import http.client
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import shard_ring as jax_ring
from seaweedfs_tpu.filer.entry import Attr as JaxAttr
from seaweedfs_tpu.filer.entry import Entry as JaxEntry
from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
from seaweedfs_tpu.server.master_server import MasterServer as JaxMasterServer
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.filer import shard_ring
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.wdclient import MasterClient

HTTP_TIMEOUT = 30


def _addresses(rng, n: int) -> list[str]:
    return [f"10.{int(rng.integers(0, 256))}.{int(rng.integers(0, 256))}.{i}:"
            f"{int(rng.integers(1024, 65536))}" for i in range(n)]


def _paths(rng, n: int) -> list[str]:
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 5))
        out.append("/" + "/".join(f"p{int(rng.integers(0, 1 << 20)):x}" for _ in range(depth)))
    return out + ["/", "/buckets", "/buckets/b0", "/buckets/b0/k", "/etc/iam/identities.json"]


# ---------------------------------------------------------------------------
# ring math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_routes_like_the_jax_ring(n):
    rng = np.random.default_rng(1600 + n)
    addrs = _addresses(rng, n)
    port, jax = shard_ring.ShardRing(addrs), jax_ring.ShardRing(addrs)
    assert port._points == jax._points
    for p in _paths(rng, 400):
        assert shard_ring.route_prefix(p) == jax_ring.route_prefix(p)
        assert shard_ring.route_prefix(p, 3) == jax_ring.route_prefix(p, 3)
        assert port.shard_for(p) == jax.shard_for(p), p
        assert port.shard_for(p, 1) == jax.shard_for(p, 1), p
    assert port.ownership(2048) == jax.ownership(2048)
    assert abs(sum(port.ownership(2048).values()) - 1.0) < 1e-9


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_adding_a_shard_moves_the_same_prefixes(n):
    rng = np.random.default_rng(1700 + n)
    addrs = _addresses(rng, n + 1)
    paths = _paths(rng, 600)
    moved = {}
    for name, mod in (("port", shard_ring), ("jax", jax_ring)):
        before, after = mod.ShardRing(addrs[:n]), mod.ShardRing(addrs)
        moved[name] = [p for p in paths if before.shard_for(p) != after.shard_for(p)]
    assert moved["port"] == moved["jax"]
    # consistent hashing: a naive mod-N ring would move most of them
    assert len(moved["port"]) / len(paths) < 0.7


def test_ring_dedups_and_needs_a_shard():
    r = shard_ring.ShardRing(["s1:1", "s1:1"])
    assert r.addresses == ["s1:1"] and r.shard_for("/anything") == "s1:1"
    with pytest.raises(ValueError):
        shard_ring.ShardRing([])
    assert shard_ring.DEFAULT_DEPTH == jax_ring.DEFAULT_DEPTH == 2
    assert shard_ring.DEFAULT_VNODES == jax_ring.DEFAULT_VNODES


# ---------------------------------------------------------------------------
# the router over real filer servers, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    out, started = {}, []
    try:
        for pkg, master_cls, filer_cls in (("port", MasterServer, FilerServer),
                                           ("jax", JaxMasterServer, JaxFilerServer)):
            master = master_cls(port=0, grpc_port=0)
            master.start()
            started.append(master)
            filers = []
            for _ in range(3):
                f = filer_cls(master.grpc_address, port=0, grpc_port=0)
                f.start()
                started.append(f)
                filers.append(f)
            out[pkg] = (master, filers)
        yield out
    finally:
        for s in reversed(started):
            s.stop()
        mp.undo()


def _router(pkg: str, master, filers):
    if pkg == "port":
        return shard_ring.ShardedFilerClient([f.grpc_address for f in filers],
                                             MasterClient(master.grpc_address))
    return jax_ring.ShardedFilerClient([f.grpc_address for f in filers],
                                       JaxMasterClient(master.grpc_address))


def _entry(pkg: str, path: str, content: bytes):
    if pkg == "port":
        return Entry(path, attr=Attr.now(), content=content)
    return JaxEntry(path, attr=JaxAttr.now(), content=content)


def _mk_tree(pkg, router, buckets=6, keys=3):
    for b in range(buckets):
        router.mkdirs(f"/buckets/b{b}")
        for k in range(keys):
            router.create_entry(_entry(pkg, f"/buckets/b{b}/k{k}", b"v"))


def _crud(pkg, r):
    _mk_tree(pkg, r)
    e = r.find_entry("/buckets/b2/k1")
    got = [e.content]
    e.content = b"v2"
    r.update_entry(e)
    got.append(r.find_entry("/buckets/b2/k1").content)
    r.delete_entry("/buckets/b2/k1")
    got.append(r.find_entry("/buckets/b2/k1"))
    return got


def _owner(pkg, r):
    """Each bucket's entries exist on the shard the ring names only."""
    _mk_tree(pkg, r, buckets=4)
    placed = []
    for b in range(4):
        path = f"/buckets/b{b}/k0"
        owner = r.ring.shard_for(path, r.depth)
        placed.append(sorted((addr == owner, rf.find_entry(path) is not None)
                             for addr, rf in r._shards.items()))
    return placed


def _merged_listing(pkg, r):
    _mk_tree(pkg, r)
    return ([(e.name, e.is_directory) for e in r.list_entries("/buckets")],
            [e.name for e in r.list_entries("/buckets", limit=3)],
            [e.name for e in r.list_entries("/buckets", start_file_name="b2")],
            [e.name for e in r.list_entries("/buckets", prefix="b1")])


def _deep_listing(pkg, r):
    _mk_tree(pkg, r, buckets=2)
    return [e.name for e in r.list_entries("/buckets/b1")]


def _same_shard_rename(pkg, r):
    _mk_tree(pkg, r, buckets=2)
    r.rename("/buckets/b1/k0", "/buckets/b1/k0r")
    return r.find_entry("/buckets/b1/k0"), r.find_entry("/buckets/b1/k0r").content


def _cross_shard_move(pkg, r):
    _mk_tree(pkg, r)
    src = dst = None
    for b in range(6):
        for suffix in ("x", "y", "z", "w"):
            a, c = f"/buckets/b{b}", f"/buckets/b{b}-{suffix}"
            if r.ring.shard_for(a) != r.ring.shard_for(c):
                src, dst = a, c
                break
        if src:
            break
    assert src is not None, "ring hashed every candidate together"
    r.rename(src, dst)
    left = [rf.find_entry(f"{src}/k1") for rf in r._shards.values()]
    return (r.find_entry(src), sorted(e.name for e in r.list_entries(dst)),
            r.find_entry(f"{dst}/k1").content, left)


def _shallow_nonrecursive_delete(pkg, r):
    _mk_tree(pkg, r, buckets=3)
    try:
        r.delete_entry("/buckets", recursive=False)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return type(e).__name__, "non-empty directory" in str(e)
    return None


def _shallow_recursive_delete(pkg, r):
    _mk_tree(pkg, r, buckets=3)
    r.delete_entry("/buckets", recursive=True)
    return r.list_entries("/buckets"), [rf.find_entry("/buckets/b0") for rf in r._shards.values()]


def _statistics(pkg, r):
    _mk_tree(pkg, r, buckets=3, keys=2)
    files, _dirs = r.statistics()
    return files >= 6


def _shard_status(pkg, r):
    st = r.shard_status()
    return (set(st) == set(r.shard_addresses), all(row["alive"] for row in st.values()),
            abs(sum(row["share"] for row in st.values()) - 1.0) < 0.01)


BATTERY = {f.__name__.lstrip("_"): f for f in (
    _crud, _owner, _merged_listing, _deep_listing, _same_shard_rename, _cross_shard_move,
    _shallow_nonrecursive_delete, _shallow_recursive_delete, _statistics, _shard_status)}
EXPECT = {
    "crud": [b"v", b"v2", None],
    "owner": [[(False, False), (False, False), (True, True)]] * 4,
    "merged_listing": ([(f"b{i}", True) for i in range(6)], ["b0", "b1", "b2"],
                       ["b3", "b4", "b5"], ["b1"]),
    "deep_listing": ["k0", "k1", "k2"],
    "same_shard_rename": (None, b"v"),
    "cross_shard_move": (None, ["k0", "k1", "k2"], b"v", [None, None, None]),
    "shallow_nonrecursive_delete": ("FilerError", True),
    "shallow_recursive_delete": ([], [None, None, None]),
    "statistics": True,
    "shard_status": (True, True, True),
}


@pytest.mark.parametrize("step", list(BATTERY))
def test_router_battery_matches_jax(clusters, step):
    got = {}
    for pkg in ("port", "jax"):
        master, filers = clusters[pkg]
        r = _router(pkg, master, filers)
        try:
            got[pkg] = BATTERY[step](pkg, r)
        finally:
            try:
                r.delete_entry("/buckets", recursive=True)
            except FileNotFoundError:
                pass
            r.close()
    assert got["port"] == got["jax"] == EXPECT[step]


def test_fanouts_are_counted(clusters):
    master, filers = clusters["port"]
    r = _router("port", master, filers)
    try:
        _mk_tree("port", r, buckets=2)
        before = {op: stats.FILER_SHARD_FANOUT.value(op=op) for op in ("list", "delete")}
        r.list_entries("/buckets/b1")  # deep: one shard
        assert stats.FILER_SHARD_FANOUT.value(op="list") == before["list"]
        r.list_entries("/buckets")  # shallow: merged
        assert stats.FILER_SHARD_FANOUT.value(op="list") == before["list"] + 1
        r.delete_entry("/buckets", recursive=True)
        assert stats.FILER_SHARD_FANOUT.value(op="delete") == before["delete"] + 1
        assert stats.FILER_SHARD_REQUESTS.value(op="find", shard=r.shard_addresses[0]) >= 0
    finally:
        r.close()


def _spy(rf, calls: list) -> None:
    for name in ("find_entry", "list_entries", "create_entry", "update_entry",
                 "delete_entry", "rename", "mkdirs"):
        orig = getattr(rf, name)

        def wrap(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        setattr(rf, name, wrap)


def _one_shard_battery(pkg, client, root: str) -> None:
    client.mkdirs(f"{root}/b")
    client.create_entry(_entry(pkg, f"{root}/b/k", b"1"))
    client.find_entry(f"{root}/b/k")
    client.list_entries(root)  # shallow
    client.rename(f"{root}/b", f"{root}-b")  # cross-prefix
    client.delete_entry(f"{root}-b", recursive=True)  # shallow
    client.delete_entry(f"{root}/never-there")  # idempotent no-op


def test_one_shard_is_remote_filer_call_for_call(clusters):
    """With one shard the router makes exactly a bare RemoteFiler's calls
    (no fan-out, no extra lookup), and the JAX router's sequence is the
    same."""
    seqs = {}
    for pkg, remote_cls, mod, mc_cls in (("port", RemoteFiler, shard_ring, MasterClient),
                                         ("jax", JaxRemoteFiler, jax_ring, JaxMasterClient)):
        master, filers = clusters[pkg]
        mc = mc_cls(master.grpc_address)
        direct = remote_cls(filers[0].grpc_address, mc)
        seqs[f"{pkg}-direct"] = []
        _spy(direct, seqs[f"{pkg}-direct"])
        _one_shard_battery(pkg, direct, "/pin-direct")
        r = mod.ShardedFilerClient([filers[0].grpc_address], mc)
        try:
            seqs[f"{pkg}-routed"] = []
            _spy(r._shards[r.shard_addresses[0]], seqs[f"{pkg}-routed"])
            if pkg == "port":
                fan = {op: stats.FILER_SHARD_FANOUT.value(op=op)
                       for op in ("list", "rename", "delete")}
            _one_shard_battery(pkg, r, "/pin-routed")
            if pkg == "port":
                assert {op: stats.FILER_SHARD_FANOUT.value(op=op) for op in fan} == fan
        finally:
            r.close()
    assert seqs["port-routed"] == seqs["port-direct"] == seqs["jax-routed"] == seqs["jax-direct"]


def test_jax_router_reads_what_the_port_router_wrote(clusters):
    """Same shards, same ring: the JAX router finds every entry the port's
    router placed, on the same shard, and merges the same listing."""
    master, filers = clusters["port"]
    port = _router("port", master, filers)
    jax = jax_ring.ShardedFilerClient([f.grpc_address for f in filers],
                                      JaxMasterClient(master.grpc_address))
    rng = np.random.default_rng(1616)
    try:
        names = sorted({f"bk{int(x)}" for x in rng.integers(0, 10_000, 12)})
        for b in names:
            for k in range(2):
                port.create_entry(Entry(f"/buckets/{b}/o{k}", attr=Attr.now(),
                                        content=rng.bytes(int(rng.integers(1, 64)))))
        for b in names:
            path = f"/buckets/{b}/o1"
            assert jax.ring.shard_for(path) == port.ring.shard_for(path)
            owner = jax._shards[jax.ring.shard_for(path)]
            assert owner.find_entry(path).content == port.find_entry(path).content
            assert jax.find_entry(path).content == port.find_entry(path).content
        assert [e.name for e in jax.list_entries("/buckets")] == names
        assert [e.name for e in port.list_entries("/buckets")] == names
        # and the other way: a JAX router's two-phase move, read by the port
        src, dst = f"/buckets/{names[0]}", None
        for suffix in "abcdefgh":
            if port.ring.shard_for(src + suffix) != port.ring.shard_for(src):
                dst = src + suffix
                break
        assert dst is not None
        jax.rename(src, dst)
        assert port.find_entry(src) is None
        assert sorted(e.name for e in port.list_entries(dst)) == ["o0", "o1"]
    finally:
        try:
            port.delete_entry("/buckets", recursive=True)
        except FileNotFoundError:
            pass
        port.close()
        jax.close()


# ---------------------------------------------------------------------------
# a dead shard through the gateways
# ---------------------------------------------------------------------------


def _http(addr: str, method: str, path: str):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, resp.getheader("Retry-After"), body
    finally:
        conn.close()


def test_dead_shard_answers_503_and_the_others_serve():
    master = MasterServer(port=0, grpc_port=0)
    master.start()
    filers = [FilerServer(master.grpc_address, port=0, grpc_port=0) for _ in range(2)]
    for f in filers:
        f.start()
    addrs = [f.grpc_address for f in filers]
    gws = {
        "port": S3ApiServer(master.grpc_address, port=0,
                            filer=shard_ring.ShardedFilerClient(addrs, MasterClient(
                                master.grpc_address)),
                            entry_cache_ttl=0, lifecycle_sweep_interval=0, credential_refresh=0,
                            chunk_cache_mb=0),
        "jax": JaxS3(master.grpc_address, port=0,
                     filer=jax_ring.ShardedFilerClient(addrs, JaxMasterClient(
                         master.grpc_address)),
                     entry_cache_ttl=0, lifecycle_sweep_interval=0, credential_refresh=0,
                     chunk_cache_mb=0),
    }
    for gw in gws.values():
        gw.start()
    victim = addrs[1]
    ring = shard_ring.ShardRing(addrs)
    dead = [f"db{i}" for i in range(60) if ring.shard_for(f"/buckets/db{i}") == victim][:3]
    live = [f"lb{i}" for i in range(60) if ring.shard_for(f"/buckets/lb{i}") != victim][:3]
    try:
        for b in dead + live:
            assert _http(gws["port"].url, "PUT", f"/{b}")[0] == 200
        filers[1].stop()
        got = {}
        for pkg, gw in gws.items():
            t0 = time.monotonic()
            rows = []
            for b in dead + live:
                st, retry, body = _http(gw.url, "GET", f"/{b}")
                rows.append((b, st, retry, b"SlowDown" in body))
            got[pkg] = rows
            assert time.monotonic() - t0 < 60, "the shed was not bounded"
        assert got["port"] == got["jax"]
        for b, st, retry, slow in got["port"]:
            if b in dead:
                assert st == 503 and float(retry) > 0 and slow, (b, st, retry)
            else:
                assert st == 200 and retry is None, (b, st)
    finally:
        for gw in gws.values():
            gw.filer.close()
            gw.stop()
        filers[0].stop()
        master.stop()


def test_shard_unavailable_is_a_filer_error():
    e = shard_ring.ShardUnavailable("a:1", "UNAVAILABLE", retry_after=2.5)
    assert isinstance(e, FilerError) and e.shard == "a:1" and e.retry_after == 2.5
    assert str(e) == str(jax_ring.ShardUnavailable("a:1", "UNAVAILABLE"))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_idle_stream_holds_no_half_open_probe(clusters, pkg):
    """A breaker past its cooldown: an idle SubscribeMetadata stream (the
    gateway's metadata subscriber re-opens one every poll) takes the
    half-open probe.  In the JAX package it keeps the slot while it is
    open, so a unary call to the recovered peer is shed as "circuit open"
    (a restarted shard's buckets answer 503 while the subscriber polls);
    the port's stream gives the slot back, and the unary call closes the
    breaker (ROADMAP Queue C)."""
    if pkg == "port":
        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
        from seaweedfs_tpu_torch.util import resilience
    else:
        from seaweedfs_tpu import rpc
        from seaweedfs_tpu.pb import filer_pb2 as f_pb
        from seaweedfs_tpu.util import resilience
    addr = clusters["port"][1][2].grpc_address
    br = resilience.breakers.get(addr)
    while br.state != "open":
        br.record_failure()
    br._opened_at = time.monotonic() - 60.0  # past the cooldown
    stream = rpc.filer_stub(addr).SubscribeMetadata(
        f_pb.SubscribeMetadataRequest(client_name="probe-test", path_prefix="/",
                                      since_ts_ns=time.time_ns()), timeout=5.0)
    try:
        assert br.state == "half_open"
        lookup = f_pb.LookupDirectoryEntryRequest(directory="/", name="nothing-here")
        if pkg == "port":
            rpc.filer_stub(addr).LookupDirectoryEntry(lookup)
            assert br.state == "closed"
        else:
            with pytest.raises(resilience.CircuitOpenError):
                rpc.filer_stub(addr).LookupDirectoryEntry(lookup)
            assert br.state == "half_open"
    finally:
        stream.cancel()
        resilience.breakers.reset()
