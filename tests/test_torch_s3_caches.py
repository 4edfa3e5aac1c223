"""The gateway's caches and admission layers, the port against the JAX
package, under one seeded op trace and a fake clock:

- ``EntryCache``: hits, negative hits, misses, TTL expiry, invalidations
  and LRU capacity;
- ``ChunkCache``: S3-FIFO admissions, ghost promotions, evictions, segment
  reclaim, TTL, fid invalidation and manifest lineage (``link_fids``);
- ``TenantQos``: admissions, shed scopes and ``Retry-After`` values, and
  quota refusals, across config reloads;
- ``CircuitBreaker``: in-flight count and byte ceilings, global and per
  bucket;
- ``MetaSubscriber``: the paths (and retired ``fid:`` lines) each
  package's subscriber delivers from the port's filer server's
  ``SubscribeMetadata`` stream.

Each step's answer and each cache's counters must be equal."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.filer import entry as jax_entry
from seaweedfs_tpu.filer import entry_cache as jax_entry_cache
from seaweedfs_tpu.filer import meta_subscriber as jax_meta_sub
from seaweedfs_tpu.s3 import circuit_breaker as jax_cb
from seaweedfs_tpu.util import chunk_cache as jax_chunk_cache
from seaweedfs_tpu.util import limiter as jax_limiter
from seaweedfs_tpu_torch.filer import entry, entry_cache, meta_subscriber
from seaweedfs_tpu_torch.s3 import circuit_breaker
from seaweedfs_tpu_torch.server import filer_server, master_server
from seaweedfs_tpu_torch.util import chunk_cache, limiter

WAIT_S = 30.0


class _Clock:
    """A module's ``time``, with ``monotonic`` (and ``time``) under the
    test's hand; everything else is the real module's."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def module(self):
        fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                        if not k.startswith("__")})
        fake.monotonic = lambda: self.now
        fake.time = lambda: self.now
        return fake


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (entry_cache, jax_entry_cache, chunk_cache, jax_chunk_cache, limiter,
                jax_limiter):
        monkeypatch.setattr(mod, "time", c.module())
    return c


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome compared
        return type(e).__name__, str(e)


# ---- EntryCache --------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_entry_cache_trace(seed, clock):
    rng = np.random.default_rng([seed, 80])
    paths = [f"/buckets/b/k{i}" for i in range(12)]
    pkgs = {"port": (entry_cache, entry), "jax": (jax_entry_cache, jax_entry)}
    caches = {name: mod.EntryCache(ttl=2.0, capacity=6, neg_ttl=0.5)
              for name, (mod, _e) in pkgs.items()}
    store: dict[str, bytes] = {}
    for step in range(400):
        op = rng.choice(["get", "get", "get", "put", "delete", "invalidate", "tick", "clear"],
                        p=[0.2, 0.2, 0.2, 0.12, 0.08, 0.1, 0.09, 0.01])
        path = paths[int(rng.integers(len(paths)))]
        if op == "put":
            store[path] = rng.bytes(int(rng.integers(1, 40)))
            continue
        if op == "delete":
            store.pop(path, None)
            continue
        if op == "tick":
            clock.now += float(rng.choice([0.1, 0.3, 0.6, 1.5, 2.5]))
            continue
        got = {}
        for name, (_mod, emod) in pkgs.items():
            cache = caches[name]
            if op == "get":
                def loader(p, emod=emod):
                    blob = store.get(p)
                    return None if blob is None else emod.Entry(p, content=blob)

                e = cache.get(path, loader)
                got[name] = None if e is None else (e.full_path, e.content)
            elif op == "invalidate":
                got[name] = cache.invalidate(path)
            else:
                got[name] = cache.clear()
            got[name] = (got[name], cache.stats())
        assert got["port"] == got["jax"], (step, op, path)


# ---- ChunkCache --------------------------------------------------------------

@pytest.mark.parametrize("seed,ttl", [(s, t) for s in range(4) for t in (0.0, 1.0)])
def test_chunk_cache_trace(seed, ttl, clock, tmp_path):
    rng = np.random.default_rng([seed, 81])
    fids = [f"{v},{k:x}0000abcd" for v in (1, 2) for k in range(20)]
    sizes = {f: int(rng.choice([512, 4096, 48 * 1024, 100 * 1024, 200 * 1024, 600 * 1024]))
             for f in fids}
    caches = {}
    for name, mod in (("port", chunk_cache), ("jax", jax_chunk_cache)):
        d = tmp_path / name
        d.mkdir()
        caches[name] = mod.ChunkCache(2 << 20, ram_bytes=256 << 10, directory=str(d),
                                      segment_bytes=512 << 10, max_chunk=256 << 10, ttl=ttl)
    try:
        for step in range(500):
            op = rng.choice(["lookup", "fill", "insert", "invalidate", "link", "tick"],
                            p=[0.35, 0.35, 0.1, 0.08, 0.04, 0.08])
            fid = fids[int(rng.integers(len(fids)))]
            size = sizes[fid]
            lo = int(rng.integers(0, 2)) * (size // 2)
            hi = size - 1
            body = np.random.default_rng([seed, 82, fids.index(fid)]).bytes(size)[lo:hi + 1]
            if op == "tick":
                clock.now += float(rng.choice([0.2, 0.7, 1.3]))
                continue
            children = rng.choice(fids, 2).tolist() if op == "link" else []
            got = {}
            for name, cache in caches.items():
                if op == "lookup":
                    hit = cache.lookup(fid, lo, hi)
                    if hit is not None:
                        try:
                            got[name] = hit.bytes_view() == body
                        finally:
                            hit.close()
                    else:
                        got[name] = None
                elif op == "fill":
                    got[name] = cache.fill(fid, lo, hi, lambda: body) == body
                elif op == "insert":
                    got[name] = cache.insert(fid, lo, hi, body)
                elif op == "invalidate":
                    got[name] = cache.invalidate_fid(fid)
                else:
                    got[name] = cache.link_fids(fid, children)
                stats = cache.stats()
                stats.pop("ttl_s", None)
                got[name] = (got[name], stats, cache.cacheable(size),
                             cache.contains(fid, lo, hi))
            assert got["port"] == got["jax"], (step, op, fid)
    finally:
        for cache in caches.values():
            cache.close()


# ---- TenantQos ---------------------------------------------------------------

_QOS_CONFIGS = [
    {"default": {"opsPerSec": 5, "burst": 8}},
    {"default": {"opsPerSec": 20}, "tenants": {"AK1": {"opsPerSec": 3, "burst": 2}},
     "buckets": {"b1": {"opsPerSec": 4, "quotaBytes": 10_000, "quotaObjects": 6}}},
    {"buckets": {"b2": {"quotaObjects": 3}}, "enabled": True},
    {},
    {"default": {"opsPerSec": 0.5}, "tenants": {"AK2": {"opsPerSec": 50}}},
]


@pytest.mark.parametrize("seed", range(5))
def test_tenant_qos_trace(seed, clock):
    rng = np.random.default_rng([seed, 83])
    qos = {"port": limiter.TenantQos(_QOS_CONFIGS[seed]),
           "jax": jax_limiter.TenantQos(_QOS_CONFIGS[seed])}
    usage = {"b1": [0, 0], "b2": [0, 0], "b3": [0, 0]}
    for step in range(600):
        op = rng.choice(["admit", "admit", "admit", "tick", "reload"], p=[0.3, 0.3, 0.3, 0.09,
                                                                         0.01])
        if op == "tick":
            clock.now += float(rng.choice([0.01, 0.1, 0.5, 2.0]))
            continue
        if op == "reload":
            cfg = _QOS_CONFIGS[int(rng.integers(len(_QOS_CONFIGS)))]
            blob = __import__("json").dumps(cfg)
            for q in qos.values():
                q.load_json(blob)
            continue
        tenant = ["AK1", "AK2", "anonymous", ""][int(rng.integers(4))]
        bucket = ["b1", "b2", "b3", ""][int(rng.integers(4))]
        write = int(rng.choice([-1, 0, 500, 4000]))
        got = {}
        for name, q in qos.items():
            adm = q.admit(tenant, bucket, write_bytes=write,
                          usage=(lambda b=bucket: tuple(usage[b])) if bucket else None)
            got[name] = (adm.ok, adm.scope, adm.limit, round(adm.retry_after, 12),
                         q.snapshot())
        assert got["port"] == got["jax"], (step, tenant, bucket, write)
        if got["port"][0] and bucket and write >= 0:
            usage[bucket][0] += write
            usage[bucket][1] += 1
    limiter.register_debug(qos["port"])
    assert limiter.debug_snapshot() == qos["port"].snapshot()


def test_debug_pages_on_the_metrics_listener(tmp_path):
    """``/debug/cachez`` and ``/debug/qos`` on the metrics listener render
    the registered cache's and QoS's ``debug_snapshot``, as the JAX
    package's listener does."""
    import json
    import urllib.request

    from seaweedfs_tpu_torch import stats

    cache = chunk_cache.ChunkCache(1 << 20, directory=str(tmp_path))
    qos = limiter.TenantQos(_QOS_CONFIGS[1])
    server = stats.start_metrics_server(0)
    try:
        chunk_cache.register_debug(cache)
        limiter.register_debug(qos)
        cache.insert("1,01", 0, 9, b"0123456789")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        pages = {}
        for page in ("cachez", "qos"):
            with urllib.request.urlopen(f"{base}/debug/{page}", timeout=30) as r:
                pages[page] = json.loads(r.read())
        assert pages["qos"] == json.loads(json.dumps(qos.snapshot()))
        mine = [c for c in pages["cachez"]["caches"] if c == json.loads(json.dumps(cache.stats()))]
        assert mine and mine[0]["entries"] == 1
    finally:
        server.shutdown()
        server.server_close()
        cache.close()


def test_token_bucket_try_charge(clock):
    for rate, burst in ((10.0, None), (2.5, 7.0), (0.0, None)):
        tb = {"port": limiter.TokenBucket(rate, burst), "jax": jax_limiter.TokenBucket(rate, burst)}
        for n in (1, 3, 5, 8, 2, 1, 9, 0.5):
            waits = {k: b.try_charge(n) for k, b in tb.items()}
            assert waits["port"] == waits["jax"], (rate, burst, n)
            clock.now += 0.15


# ---- CircuitBreaker ----------------------------------------------------------

_CB_CONFIGS = [
    {"global": {"enabled": True, "writeCount": 3, "readCount": 4}},
    {"global": {"enabled": True, "readBytes": 10_000, "writeBytes": 8_000},
     "buckets": {"hot": {"writeCount": 1, "readBytes": 3000}}},
    {"global": {"enabled": False, "writeCount": 1}},
    {"buckets": {"hot": {"enabled": True, "readCount": 2}}},
]


@pytest.mark.parametrize("seed", range(len(_CB_CONFIGS)))
def test_circuit_breaker_trace(seed):
    rng = np.random.default_rng([seed, 84])
    cbs = {"port": circuit_breaker.CircuitBreaker(_CB_CONFIGS[seed]),
           "jax": jax_cb.CircuitBreaker(_CB_CONFIGS[seed])}
    held: dict[str, list] = {"port": [], "jax": []}
    for step in range(300):
        if held["port"] and rng.random() < 0.4:
            i = int(rng.integers(len(held["port"])))
            for name in cbs:
                held[name].pop(i)()
            continue
        bucket = ["hot", "cold", ""][int(rng.integers(3))]
        is_write = bool(rng.integers(2))
        nbytes = int(rng.choice([0, 100, 2500, 6000]))
        got = {}
        for name, cb in cbs.items():
            out = _outcome(lambda: cb.acquire(bucket, is_write, nbytes))
            if out[0] == "ok":
                held[name].append(out[1])
                out = ("ok",)
            got[name] = (out, cb.snapshot(), cb.wants_read_bytes(bucket))
        assert got["port"] == got["jax"], (step, bucket, is_write, nbytes)
    cbs["port"].load_json(b"not json")
    cbs["jax"].load_json(b"not json")
    assert cbs["port"].snapshot() == cbs["jax"].snapshot()


# ---- MetaSubscriber ----------------------------------------------------------

def _wait(predicate, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {WAIT_S}s waiting for {what}")


def test_meta_subscriber_paths_from_the_port_filer(monkeypatch):
    monkeypatch.setenv("WEED_SCRUB_INTERVAL", "0")
    master = master_server.MasterServer(port=0, grpc_port=0)
    master.start()
    fs = filer_server.FilerServer(master.grpc_address, port=0, grpc_port=0)
    fs.start()
    got: dict = {"port": [], "jax": []}
    gaps: dict = {"port": 0, "jax": 0}
    subs = {}
    try:
        for name, mod in (("port", meta_subscriber), ("jax", jax_meta_sub)):
            subs[name] = mod.MetaSubscriber(
                [fs.grpc_address], on_paths=got[name].append, poll_timeout=0.5,
                on_gap=lambda name=name: gaps.__setitem__(name, gaps[name] + 1))
            subs[name].start()
        f = fs.filer
        chunk = entry.FileChunk(fid="3,01637037d6", offset=0, size=10, modified_ts_ns=1)
        chunk2 = entry.FileChunk(fid="3,02637037d7", offset=0, size=10, modified_ts_ns=2)
        f.mkdirs("/buckets/b")
        f.create_entry(entry.Entry("/buckets/b/k1", content=b"x"))
        f.create_entry(entry.Entry("/buckets/b/k2", chunks=[chunk]))
        f.create_entry(entry.Entry("/buckets/b/k2", chunks=[chunk2]))  # overwrite retires chunk
        f.rename("/buckets/b/k1", "/buckets/b/k3")
        f.delete_entry("/buckets/b/k3")
        want = [["/buckets/b/k1"], ["/buckets/b/k2"],
                ["/buckets/b/k2", "/buckets/b/k2", meta_subscriber.FID_PREFIX + "3,01637037d6"],
                ["/buckets/b/k1", "/buckets/b/k3", "/buckets/b/k3"], ["/buckets/b/k3"]]
        _wait(lambda: len(got["port"]) >= len(want) and len(got["jax"]) >= len(want),
              "both subscribers' events")
        time.sleep(0.6)  # a quiet poll window: nothing more may arrive
        assert got["port"] == got["jax"] == want
        flat = [p for ev in got["port"] for p in ev]
        assert "/buckets/b/k1" in flat and "/buckets/b/k3" in flat
        assert meta_subscriber.FID_PREFIX + "3,01637037d6" in flat
        assert gaps == {"port": 0, "jax": 0}
        assert subs["port"].stats() == subs["jax"].stats()
        # the helpers on in-process dataclass entries
        old, new = entry.Entry("/d/x", chunks=[chunk, chunk2]), entry.Entry("/d/x",
                                                                            chunks=[chunk2])
        assert meta_subscriber.event_fids(old, new) == jax_meta_sub.event_fids(old, new) \
            == ["3,01637037d6"]
        assert meta_subscriber.event_paths("/d", old, new, "/e") == \
            jax_meta_sub.event_paths("/d", old, new, "/e")
    finally:
        for sub in subs.values():
            sub.stop()
        fs.stop()
        master.stop()
