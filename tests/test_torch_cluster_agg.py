"""The port's cluster aggregator (stats/cluster_agg.py) and flight recorder
(stats/events.py) held against the JAX package's.

- ``parse_metrics_text`` gives the same families for the same text,
  including the port's own /metrics rendering.
- ``ClusterView`` over the same member scrapes gives the same dict and
  text: merged sketches, plane bytes, breakers, cache, requests and the
  merged event timeline; a dead member degrades to a listed error.
- A live scrape of two metrics listeners in this process, one the
  port's and one the JAX package's, fed the same latencies: the views
  both packages build from one raw scrape are equal, and the live
  aggregator's merged count is the sum of the members' ``/debug/sketchz``
  counts.
- The event ring renders the same text, merges timelines the same way
  and answers /debug/eventz the same way (kinds, limits, JSON, 400s).

Comparison: equality of parsed families, view dicts (the scrape time
aside), rendered text and event rows; no tolerance.
"""

from __future__ import annotations

import json
import textwrap
import time

import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.stats import cluster_agg as jax_agg
from seaweedfs_tpu.stats import events as jax_events
from seaweedfs_tpu.stats import sketch as jax_sketch
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.stats import cluster_agg, events, sketch
from seaweedfs_tpu_torch.util.http_pool import shared_pool

TEXT = textwrap.dedent("""\
    # HELP weedtpu_plane_bytes_total bytes per plane
    # TYPE weedtpu_plane_bytes_total counter
    weedtpu_plane_bytes_total{plane="serve",dir="read"} 1024
    weedtpu_plane_bytes_total{plane="scrub",dir="read"} 4.5e3
    weedtpu_s3_request_total{action="GetObject",code="200"} 7
    weedtpu_s3_request_total{action="PutObject",code="503"} 2
    weedtpu_rpc_breaker_state{peer="127.0.0.1:8080"} 2
    weedtpu_chunk_cache_total{event="hit"} 3
    weedtpu_chunk_cache_total{event="miss"} 1
    weedtpu_uptime_seconds 12.5
    python_gc_collections_total{generation="0"} 999
    weedtpu_broken_sample this_is_not_a_number
""")


@pytest.mark.parametrize("text", [TEXT, "", "# only comments\n"])
def test_parse_metrics_text_equal(text):
    assert cluster_agg.parse_metrics_text(text) == jax_agg.parse_metrics_text(text)


def test_parse_port_render_text_equal():
    text = stats.render_text()
    assert cluster_agg.parse_metrics_text(text) == jax_agg.parse_metrics_text(text)
    assert "weedtpu_rpc_breaker_state" in text and "weedtpu_faults_injected_total" in text


def _member(agg_mod, sk_mod, addr: str, seed: int, ok: bool = True):
    m = agg_mod.MemberScrape(addr)
    m.ok = ok
    if not ok:
        m.error = "connection refused"
        return m
    m.families = agg_mod.parse_metrics_text(TEXT.replace("1024", str(1024 * seed)))
    for op in (sk_mod.OP_S3_PUT, sk_mod.OP_META_LOOKUP):
        sk = sk_mod.Sketch()
        for i in range(20 + seed):
            sk.add(0.001 * (i % 9 + seed))
        m.sketches[op] = sk
    m.events = [{"seq": i, "ts": 1_700_000_000.0 + i * 0.5 + seed * 0.1, "kind": "breaker.open",
                 "peer": f"p{seed}"} for i in range(3)]
    return m


@pytest.mark.parametrize("members", [[1], [1, 2], [1, 2, 0], [0]])
def test_cluster_view_equal(members):
    views = []
    for agg_mod, sk_mod in ((cluster_agg, sketch), (jax_agg, jax_sketch)):
        view = agg_mod.ClusterView([_member(agg_mod, sk_mod, f"h{s}:{s}", s, ok=s > 0)
                                    for s in members])
        d = view.to_dict()
        d.pop("ts")
        views.append((d, view.render_text()))
    assert views[0] == views[1]


@pytest.fixture
def listeners():
    """One metrics listener of each package in this process, their
    op-latency windows and event rings fed the same samples."""
    for sk_mod in (sketch, jax_sketch):
        sk_mod.OP_LATENCY.reset()
        for i in range(64):
            sk_mod.record(sk_mod.OP_S3_PUT, 0.001 * (i % 11 + 1))
    for ev in (events, jax_events):
        ev.record(ev.BREAKER_OPEN, peer="127.0.0.1:1")
    port_srv = stats.start_metrics_server(0)
    jax_srv = jax_stats.start_metrics_server(0)
    yield [f"127.0.0.1:{port_srv.server_address[1]}", f"127.0.0.1:{jax_srv.server_address[1]}"]
    for srv in (port_srv, jax_srv):
        srv.shutdown()
        srv.server_close()
    sketch.OP_LATENCY.reset()
    jax_sketch.OP_LATENCY.reset()


def _raw_scrapes(addrs: list[str]) -> list[tuple]:
    """Each member's /metrics text, sketch dump and event JSON, fetched once."""
    out = []
    for addr in addrs:
        got = []
        for path in ("/metrics", "/debug/sketchz?binary=1", "/debug/eventz?json=1&limit=200"):
            status, body = shared_pool().request(addr, "GET", path)
            assert status == 200, (addr, path, body[:200])
            got.append(body)
        out.append((addr, *got))
    return out


def _view_of(agg_mod, sk_mod, raw):
    members = []
    for addr, text, dump, evs in raw:
        m = agg_mod.MemberScrape(addr)
        m.families = agg_mod.parse_metrics_text(text.decode())
        m.sketches = sk_mod.parse_dump(dump)
        m.events = json.loads(evs)
        m.ok = True
        members.append(m)
    d = agg_mod.ClusterView(members).to_dict()
    d.pop("ts")
    return d


def test_live_scrape_equal(listeners):
    raw = _raw_scrapes(listeners)
    assert _view_of(cluster_agg, sketch, raw) == _view_of(jax_agg, jax_sketch, raw)
    port = cluster_agg.ClusterAggregator(listeners).scrape()
    assert all(m.ok for m in port.members), [m.error for m in port.members]
    counts = []
    for addr in listeners:
        status, body = shared_pool().request(addr, "GET", "/debug/sketchz")
        assert status == 200
        counts.append(json.loads(body)["ops"]["s3.put"]["count"])
    assert counts == [64, 64]
    assert port.op_latency()["s3.put"]["count"] == sum(counts)
    code, body = cluster_agg.debug_body({"members": [",".join(listeners)], "json": ["1"]})
    assert code == 200 and json.loads(body)["op_latency"]["s3.put"]["count"] == 128
    assert cluster_agg.debug_body({})[0] == jax_agg.debug_body({})[0] == 400


def test_dead_member_degrades(listeners):
    view = cluster_agg.ClusterAggregator(listeners + ["127.0.0.1:1"], timeout=2).scrape()
    assert [m.ok for m in view.members] == [True, True, False]
    assert "UNREACHABLE" in view.render_text()


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def _ring(mod):
    ring = mod.EventRing(capacity=16)
    for i in range(20):
        kind = sorted(mod.KINDS)[i % len(mod.KINDS)]
        ring.record(kind, peer=f"p{i}", n=i)
    return ring


@pytest.mark.parametrize("kind", [None, "breaker.open", "scrub.repaired"])
@pytest.mark.parametrize("limit", [0, 3, 100])
def test_event_ring_renders_alike(fixed_clock, kind, limit):
    port, jax = _ring(events), _ring(jax_events)
    assert len(port) == len(jax) == 16
    assert port.to_dicts(kind, limit) == jax.to_dicts(kind, limit)
    assert port.render_text(kind, limit or 100) == jax.render_text(kind, limit or 100)


def test_event_rules_alike():
    for mod in (events, jax_events):
        with pytest.raises(ValueError, match="unregistered"):
            mod.default_ring.record("free.text")
        with pytest.raises(ValueError, match="shadow"):
            mod.default_ring.record(mod.BREAKER_OPEN, seq=1)
    assert events.KINDS == jax_events.KINDS


def test_merge_timelines_alike():
    lines = [("h1:1", [{"seq": 1, "ts": 5.0, "kind": "breaker.open"},
                       {"seq": 2, "ts": 7.0, "kind": "breaker.close"}]),
             ("h0:0", [{"seq": 9, "ts": 5.0, "kind": "scrub.repaired"},
                       {"seq": 10, "ts": 6.0, "kind": "fault.injected"}])]
    assert events.merge_timelines(lines) == jax_events.merge_timelines(lines)
    assert [e["member"] for e in events.merge_timelines(lines)] == ["h0:0", "h1:1", "h0:0",
                                                                    "h1:1"]


@pytest.mark.parametrize("query", [{}, {"kind": ["nope"]}, {"kind": ["breaker.open"]},
                                   {"limit": ["x"]}, {"json": ["1"], "limit": ["2"]}])
def test_eventz_body_alike(fixed_clock, query, monkeypatch):
    monkeypatch.setattr(events, "default_ring", _ring(events))
    monkeypatch.setattr(jax_events, "default_ring", _ring(jax_events))
    assert events.debug_body(query) == jax_events.debug_body(query)
