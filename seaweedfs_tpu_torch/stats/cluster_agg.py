"""Cluster aggregator: one view of every member's /metrics + sketches.

The port's copy of seaweedfs_tpu/stats/cluster_agg.py.  Per-process metrics stop being useful the moment the stack is real —
a master, volume servers, filer shards, and SO_REUSEPORT gateway
workers each keep their own counters and sketches.  This module scrapes
every member's metrics listener over the shared HTTP pool
(``/metrics`` text, ``/debug/sketchz?binary=1`` sketch dumps,
``/debug/eventz?json=1`` flight-recorder rings), merges the sketches
exactly (stats/sketch.py bucket-count addition — the whole reason they
exist), sums the plane/cache/scrub/repair counters, and renders the
result for the ``cluster.status`` shell command and ``/debug/clusterz``.

Member discovery is explicit (a list of metrics addresses): the
aggregator is a *reader* of the cluster, deliberately not a
participant — it must work against a half-dead stack, so every member
scrape failure degrades to a listed error, never an exception.
"""

from __future__ import annotations

import json
import re
import threading
import time

from seaweedfs_tpu_torch.stats import events, sketch
from seaweedfs_tpu_torch.util.http_pool import shared_pool

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)$'
)
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>[^"]*)"')


def parse_metrics_text(text: str, prefix: str = "weedtpu_") -> dict:
    """{family: [(labels dict, value)]} for every sample under ``prefix``
    (comments, TYPE lines, and other families skipped)."""
    out: dict[str, list] = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or not line.startswith(prefix):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            lm.group("k"): lm.group("v")
            for lm in _LABEL_RE.finditer(m.group("labels") or "")
        }
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def _family_sum(families: dict, name: str, by: tuple[str, ...]) -> dict:
    """Sum one family's samples grouped by the ``by`` label values."""
    out: dict[tuple, float] = {}
    for labels, value in families.get(name, ()):
        key = tuple(labels.get(k, "") for k in by)
        out[key] = out.get(key, 0.0) + value
    return out


class MemberScrape:
    def __init__(self, addr: str):
        self.addr = addr
        self.ok = False
        self.error = ""
        self.families: dict = {}
        self.sketches: dict[str, sketch.Sketch] = {}
        self.events: list[dict] = []


class ClusterView:
    """The merged cluster state one scrape produced."""

    def __init__(self, members: list[MemberScrape]):
        self.ts = time.time()
        self.members = members
        self.sketches: dict[str, sketch.Sketch] = {}
        self.plane_bytes: dict[tuple, float] = {}
        self.breakers: dict[str, dict] = {}
        self.cache: dict[str, float] = {}
        self.scrub_bytes = 0.0
        self.repair_bytes = 0.0
        self.requests_total = 0
        self.requests_errors = 0
        self.events: list[dict] = []
        for m in members:
            if not m.ok:
                continue
            for op, sk in m.sketches.items():
                if op in self.sketches:
                    self.sketches[op].merge(sk)
                else:
                    self.sketches[op] = sk.copy()
            for key, v in _family_sum(
                m.families, "weedtpu_plane_bytes_total", ("plane", "dir")
            ).items():
                if not key[0]:
                    continue  # the empty-family placeholder sample
                self.plane_bytes[key] = self.plane_bytes.get(key, 0.0) + v
            for labels, v in m.families.get("weedtpu_rpc_breaker_state", ()):
                peer = labels.get("peer", "")
                if peer:
                    self.breakers.setdefault(m.addr, {})[peer] = int(v)
            for (event,), v in _family_sum(
                m.families, "weedtpu_chunk_cache_total", ("event",)
            ).items():
                self.cache[event] = self.cache.get(event, 0.0) + v
            for _, v in m.families.get("weedtpu_scrub_bytes_total", ()):
                self.scrub_bytes += v
            for _, v in m.families.get("weedtpu_repair_bytes_total", ()):
                self.repair_bytes += v
            for labels, v in m.families.get("weedtpu_s3_request_total", ()):
                self.requests_total += int(v)
                code = labels.get("code", "")
                if code.isdigit() and int(code) >= 500:
                    self.requests_errors += int(v)
        self.events = events.merge_timelines(
            [(m.addr, m.events) for m in members if m.ok]
        )

    def cache_hit_rate(self) -> float | None:
        lookups = self.cache.get("hit", 0.0) + self.cache.get("miss", 0.0)
        return (self.cache.get("hit", 0.0) / lookups) if lookups else None

    def op_latency(self) -> dict[str, dict]:
        return {op: sk.to_dict() for op, sk in sorted(self.sketches.items())}

    def to_dict(self) -> dict:
        open_breakers = {
            addr: {peer: state for peer, state in peers.items() if state}
            for addr, peers in self.breakers.items()
        }
        return {
            "ts": self.ts,
            "members": {
                m.addr: ({"ok": True} if m.ok else {"ok": False, "error": m.error})
                for m in self.members
            },
            "op_latency": self.op_latency(),
            "plane_bytes": {
                f"{plane}/{direction}": v
                for (plane, direction), v in sorted(self.plane_bytes.items())
            },
            "breakers_open": {k: v for k, v in open_breakers.items() if v},
            "cache": self.cache,
            "cache_hit_rate": self.cache_hit_rate(),
            "scrub_bytes": self.scrub_bytes,
            "repair_bytes": self.repair_bytes,
            "requests_total": self.requests_total,
            "requests_errors": self.requests_errors,
            "events": self.events[-200:],
        }

    def render_text(self) -> str:
        lines = [f"cluster view over {len(self.members)} members"]
        for m in self.members:
            lines.append(
                f"  member {m.addr}: " + ("ok" if m.ok else f"UNREACHABLE ({m.error})")
            )
        lines.append("op latency (merged window):")
        for op, row in self.op_latency().items():
            if not row.get("count"):
                continue
            lines.append(
                f"  {op:<16s} n={row['count']:<8d}"
                f" p50={row['p50_ms']:.1f}ms p90={row['p90_ms']:.1f}ms"
                f" p99={row['p99_ms']:.1f}ms max={row['max_ms']:.1f}ms"
            )
        if self.plane_bytes:
            lines.append("plane bytes:")
            for (plane, direction), v in sorted(self.plane_bytes.items()):
                lines.append(f"  {plane:<12s} {direction:<6s} {int(v):>14d}")
        hit = self.cache_hit_rate()
        if hit is not None:
            lines.append(f"chunk cache hit rate: {hit:.1%}")
        lines.append(
            f"scrub bytes: {int(self.scrub_bytes)}  "
            f"repair bytes: {int(self.repair_bytes)}"
        )
        if self.requests_total:
            lines.append(
                f"s3 requests: {self.requests_total}"
                f" ({self.requests_errors} 5xx)"
            )
        opened = [
            f"{addr}->{peer}={state}"
            for addr, peers in sorted(self.breakers.items())
            for peer, state in sorted(peers.items())
            if state
        ]
        lines.append(
            "breakers: " + (", ".join(opened) if opened else "all closed")
        )
        if self.events:
            lines.append(f"last {min(len(self.events), 20)} events:")
            for ev in self.events[-20:]:
                stamp = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
                attrs = " ".join(
                    f"{k}={v}" for k, v in ev.items()
                    if k not in ("seq", "ts", "kind", "member")
                )
                lines.append(
                    f"  {stamp} [{ev.get('member', '?')}]"
                    f" {ev.get('kind', '?'):<22s} {attrs}"
                )
        return "\n".join(lines) + "\n"


class ClusterAggregator:
    """Scrapes ``members`` (metrics addresses, host:port) on demand or
    on an interval; keeps the last view."""

    def __init__(self, members: list[str], timeout: float = 5.0):
        self.members = list(members)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._last: ClusterView | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _scrape_member(self, addr: str) -> MemberScrape:
        m = MemberScrape(addr)
        pool = shared_pool()
        try:
            status, body = pool.request(
                addr, "GET", "/metrics", timeout=self.timeout
            )
            if status != 200:
                raise IOError(f"/metrics -> HTTP {status}")
            m.families = parse_metrics_text(body.decode("utf-8", "replace"))
            status, dump = pool.request(
                addr, "GET", "/debug/sketchz?binary=1", timeout=self.timeout
            )
            if status == 200:
                m.sketches = sketch.parse_dump(dump)
            status, evs = pool.request(
                addr, "GET", "/debug/eventz?json=1&limit=200",
                timeout=self.timeout,
            )
            if status == 200:
                m.events = json.loads(evs.decode("utf-8", "replace"))
            m.ok = True
        except Exception as e:  # noqa: BLE001 — a half-dead cluster must still render
            m.error = str(e) or type(e).__name__
        return m

    def scrape(self) -> ClusterView:
        view = ClusterView([self._scrape_member(a) for a in self.members])
        with self._lock:
            self._last = view
        return view

    def last(self) -> ClusterView | None:
        with self._lock:
            return self._last

    def start(self, interval_s: float = 15.0) -> None:
        """Background interval scraping (the production-day shape)."""

        def loop():
            from seaweedfs_tpu_torch.util import wlog

            while not self._stop.wait(interval_s):
                try:
                    self.scrape()
                except Exception as e:  # noqa: BLE001 — keep the loop alive
                    wlog.warning("cluster-agg scrape failed: %s", e)

        self._thread = threading.Thread(
            target=loop, name="cluster-agg", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def debug_body(q: dict) -> tuple[int, bytes]:
    """/debug/clusterz?members=host:port,host:port[&json=1] — scrapes
    the listed members (or WEED_CLUSTER_MEMBERS) and renders the merged
    view.  The endpoint is a one-shot scrape: the process serving it is
    usually one OF the members, so keeping a background aggregator in
    every process would scrape N^2."""
    import os

    raw = q.get("members", [""])[0] or os.environ.get("WEED_CLUSTER_MEMBERS", "")
    members = [a.strip() for a in raw.split(",") if a.strip()]
    if not members:
        return 400, (
            b"no members: pass ?members=host:port,... or set "
            b"WEED_CLUSTER_MEMBERS\n"
        )
    view = ClusterAggregator(members).scrape()
    if q.get("json", [""])[0]:
        return 200, json.dumps(view.to_dict(), indent=2).encode()
    return 200, view.render_text().encode()
