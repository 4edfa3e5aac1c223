"""Targeted protocol scenarios for the port's weedrace interleaving
explorer: the same six protocols as the repo's weedrace/scenarios.py,
driving the port's modules.

Each scenario is a callable ``scenario(gate) -> check`` per the
:func:`seaweedfs_tpu_torch.weedrace.sched.run_schedule` contract: it
builds the state under test, registers controlled threads via
``gate.spawn``, and returns a zero-arg ``check()`` that asserts the
protocol invariant after the schedule completes (or ``None``).  The
explorer then drives every preemption-bounded interleaving of the
controlled threads through the real product code, with racecheck's vector
clocks watching every access.

These target the port's known-delicate concurrent state machines:
chunk-cache single-flight fill vs invalidation/reclaim,
breaker open→half-open single-probe slots, FidPool take-vs-refill,
``WindowedSketch`` slot rotation vs record, the splice ``_addr_cache``,
and two-phase cross-shard moves.

Scenario-local helper state (result lists, fake shards, the fake clock)
lives in THIS file, which racecheck never traces (nothing of the
``weedrace`` package is in its scope) — only accesses made by the port's
product code are checked, so harness bookkeeping never manufactures
findings.
"""

from __future__ import annotations

import shutil
import tempfile


# -- chunk cache: single-flight fill vs invalidation ------------------------


def chunk_cache_single_flight(gate):
    """Two concurrent fills of one key (single-flight) racing an
    invalidate_fid that reclaims the entry mid-flight.  Invariant: every
    fill returns the full loaded bytes regardless of interleaving."""
    from seaweedfs_tpu_torch.util.chunk_cache import ChunkCache

    tmp = tempfile.mkdtemp(prefix="weedrace-cc-")
    cache = ChunkCache(
        1 << 20, ram_bytes=8 << 10, directory=tmp,
        segment_bytes=64 << 10, small_max=256, max_chunk=8 << 10,
    )
    payload = b"\xa5" * 4096  # > small_max: lands in the segment tier
    results = []

    def filler():
        results.append(cache.fill("7,aa11", 0, 4096, lambda: payload))

    def invalidator():
        cache.invalidate_fid("7,aa11")
        cache.invalidate_fid("7,aa11")  # idempotent second pass

    gate.spawn(filler, "fill-a")
    gate.spawn(filler, "fill-b")
    gate.spawn(invalidator, "invalidate")

    def check():
        try:
            assert len(results) == 2, f"fills completed: {len(results)}/2"
            assert all(r == payload for r in results), "fill returned bad bytes"
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    return check


# -- breaker: open -> half-open single probe slot ---------------------------


def breaker_probe(gate):
    """Two callers hit an open breaker whose cooldown has expired.
    Invariant: exactly ONE wins the half-open probe slot — a double
    probe is the storm the breaker exists to prevent."""
    from seaweedfs_tpu_torch.util.resilience import CircuitBreaker, Policy

    pol = Policy(breaker_threshold=1, breaker_cooldown_s=0.0)
    br = CircuitBreaker("vol1:8080", pol)
    br.record_failure()  # threshold 1: straight to open
    outcomes = []

    def caller(name):
        def body():
            outcomes.append((name, br.allow()))
        return body

    gate.spawn(caller("a"), "probe-a")
    gate.spawn(caller("b"), "probe-b")

    def check():
        allowed = [n for n, ok in outcomes if ok]
        assert len(outcomes) == 2, f"callers finished: {len(outcomes)}/2"
        assert len(allowed) == 1, f"half-open probe slot won by {allowed}"
        assert br.state == "half_open", br.state

    return check


# -- FidPool: concurrent take vs refill -------------------------------------


class _FakeMaster:
    """Duck-typed master: mints monotonically unique fids.  Lives outside
    the trace scope; the gate serializes callers so the unlocked counter
    is deterministic per schedule."""

    def __init__(self):
        self.master_addresses = ["master:9333"]
        self.minted = 0

    def assign_batch_located(self, n, **kw):
        out = []
        for _ in range(n):
            self.minted += 1
            out.append(
                (f"3,{self.minted:08x}", "vol1:8080", "", ("vol2:8080",))
            )
        return out


def fidpool_take_refill(gate):
    """Two takers drain a small pool, forcing concurrent refill batches.
    Invariant: no fid is ever handed out twice."""
    from seaweedfs_tpu_torch.filer.upload import FidPool

    master = _FakeMaster()
    pool = FidPool(master, batch=2, ttl=30.0, stripes=2, native_stash=False)
    taken = []

    def taker():
        for _ in range(2):
            for fid, _url, _auth, _replicas in pool.take_located(1):
                taken.append(fid)

    gate.spawn(taker, "take-a")
    gate.spawn(taker, "take-b")

    def check():
        assert len(taken) == 4, f"takes completed: {len(taken)}/4"
        assert len(set(taken)) == len(taken), f"duplicate fid handed out: {taken}"

    return check


# -- WindowedSketch: slot rotation vs record --------------------------------


def sketch_rotation(gate):
    """Recorders racing the window's slot rotation while a reader merges.
    Invariant: merged() never over-counts and never crashes mid-rotation."""
    from seaweedfs_tpu_torch.stats.sketch import WindowedSketch

    now = [100.0]  # fake clock, advanced by the recorders (untraced)
    ws = WindowedSketch(alpha=0.02, window_s=4.0, slots=2, clock=lambda: now[0])
    merged_counts = []

    def recorder(base):
        def body():
            ws.add(base + 1.0)
            now[0] += 2.0  # cross a slot boundary: forces rotation
            ws.add(base + 2.0)
        return body

    def reader():
        for _ in range(2):
            merged_counts.append(ws.merged().count)

    gate.spawn(recorder(10.0), "record-a")
    gate.spawn(recorder(20.0), "record-b")
    gate.spawn(reader, "merge")

    def check():
        assert len(merged_counts) == 2, merged_counts
        assert all(0 <= c <= 4 for c in merged_counts), merged_counts
        assert ws.merged().count <= 4

    return check


# -- splice: _addr_cache fill under concurrency -----------------------------


def splice_addr_cache(gate):
    """Two threads resolve the same address through the module-level
    ``_addr_cache`` (the benign double-resolve TOCTOU).  Invariant: both
    get the right answer and the cache converges to one entry."""
    from seaweedfs_tpu_torch.filer import splice
    from seaweedfs_tpu_torch.util import sync_seam

    # the module-level _addr_lock predates install() whenever anything
    # imported splice first (the full test session always has) — swap it
    # for an instrumented lock so its release->acquire edges exist
    sync_seam.rearm_module_locks(splice)
    with splice._addr_lock:
        splice._addr_cache.clear()
    answers = []

    def resolver():
        answers.append(splice._numeric_addr("127.0.0.1:8080"))
        answers.append(splice._numeric_addr("127.0.0.2:9333"))

    gate.spawn(resolver, "resolve-a")
    gate.spawn(resolver, "resolve-b")

    def check():
        assert len(answers) == 4, answers
        assert answers.count("127.0.0.1:8080") == 2, answers
        assert answers.count("127.0.0.2:9333") == 2, answers
        with splice._addr_lock:
            # keyed by host: both resolvers converge on one entry per host
            assert len(splice._addr_cache) == 2, dict(splice._addr_cache)

    return check


# -- sharded filer: two-phase cross-shard move ------------------------------


class _FakeShard:
    """In-memory RemoteFiler stand-in (outside trace scope; the gate
    serializes the controlled callers)."""

    def __init__(self):
        self.entries = {}

    def find_entry(self, full_path):
        return self.entries.get(full_path)

    def create_entry(self, entry, *, emit=True):
        self.entries[entry.full_path] = entry

    def update_entry(self, entry):
        self.entries[entry.full_path] = entry

    def delete_entry(self, full_path, *, recursive=False, delete_data=True):
        if full_path not in self.entries:
            raise FileNotFoundError(full_path)
        del self.entries[full_path]

    def rename(self, old_path, new_path):
        e = self.entries.pop(old_path)
        e.full_path = new_path
        self.entries[new_path] = e


def shard_move_two_phase(gate):
    """A cross-shard rename (copy-then-delete) raced by a reader polling
    both names.  Invariant: the entry is visible under at least one name
    at every observation — two-phase ordering means a crash can leave a
    duplicate, never a loss."""
    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.shard_ring import ShardedFilerClient

    client = ShardedFilerClient(["shard-a:8888", "shard-b:8888"], None)
    for addr in list(client._shards):
        client._shards[addr] = _FakeShard()

    # pick a destination that routes to the OTHER shard (ring hashing)
    old_path = "/bkt/t1/src.bin"
    old_shard = client.ring.shard_for(old_path, client.depth)
    new_path = None
    for i in range(64):
        cand = f"/bkt/dst{i}/moved.bin"
        if client.ring.shard_for(cand, client.depth) != old_shard:
            new_path = cand
            break
    assert new_path is not None, "no cross-shard destination found"
    client.create_entry(Entry(full_path=old_path))
    observations = []

    def mover():
        client.rename(old_path, new_path)

    def observer():
        for _ in range(3):
            observations.append((
                client.find_entry(old_path) is not None,
                client.find_entry(new_path) is not None,
            ))

    gate.spawn(mover, "move")
    gate.spawn(observer, "observe")

    def check():
        assert len(observations) == 3, observations
        for old_seen, new_seen in observations:
            assert old_seen or new_seen, "entry lost mid-move"
        assert client.find_entry(new_path) is not None
        assert client.find_entry(old_path) is None

    return check


# the port's module each scenario drives: the racecheck scope that tier-1
# and chip_smoke.py give it (suffixes relative to seaweedfs_tpu_torch)
SCOPES = {
    "chunk_cache_single_flight": "util.chunk_cache",
    "breaker_probe": "util.resilience",
    "fidpool_take_refill": "filer.upload",
    "sketch_rotation": "stats.sketch",
    "splice_addr_cache": "filer.splice",
    "shard_move_two_phase": "filer.shard_ring",
}

SCENARIOS = {
    "chunk_cache_single_flight": chunk_cache_single_flight,
    "breaker_probe": breaker_probe,
    "fidpool_take_refill": fidpool_take_refill,
    "sketch_rotation": sketch_rotation,
    "splice_addr_cache": splice_addr_cache,
    "shard_move_two_phase": shard_move_two_phase,
}
