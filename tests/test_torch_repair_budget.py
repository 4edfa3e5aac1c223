"""The port's repair budget, plane billing and schedule cache against the
JAX package's: ``TokenBucket`` and ``RepairBudget`` under one fake clock
(the same charges must give the same sleeps), the counters ``account``
feeds, and the rebuild (``rebuild_ec_files``), which must wait under
``WEED_REPAIR_RATE_MB``, run under the ``ec_repair`` plane and record the
same ``weedtpu_repair_bytes_total`` series as the JAX rebuild for the same
losses.  Times are fake, so every comparison is exact."""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.ops import repair_budget as jax_budget
from seaweedfs_tpu.ops import sched_cache as jax_sched_cache
from seaweedfs_tpu.ops.lrc_codec import LrcCPU
from seaweedfs_tpu.ops.rs_jax import ReedSolomonJax
from seaweedfs_tpu.stats import plane as jax_plane
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec
from seaweedfs_tpu.storage.erasure_coding import lrc as jax_lrc
from seaweedfs_tpu.storage.erasure_coding.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu.util import limiter as jax_limiter
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import repair_budget, rs_cuda, sched_cache
from seaweedfs_tpu_torch.ops.lrc_codec import LrcTorch
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.stats import plane
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder, lrc
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.util import limiter

GEOM = dict(data_shards=10, parity_shards=4, large_block_size=4096, small_block_size=1024)
LRC_GEOM = dict(GEOM, local_groups=2)


class FakeTime:
    """A clock that moves only when slept on; records every sleep."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock for each package's limiter module."""
    port, ref = FakeTime(), FakeTime()
    monkeypatch.setattr(limiter, "time", port)
    monkeypatch.setattr(jax_limiter, "time", ref)
    return port, ref


CHARGES = [  # (seconds of clock that pass before the charge, bytes)
    (0.0, 500), (0.0, 700), (0.25, 300), (3.0, 100), (0.0, 12_000), (0.1, 1), (0.0, 0),
]


@pytest.mark.parametrize("rate,burst", [(1000.0, None), (1000.0, 250.0), (0.0, None), (64.0, 1.0)])
def test_token_bucket_sleeps_as_the_jax_one(clocks, rate, burst):
    port_clock, ref_clock = clocks
    port, ref = limiter.TokenBucket(rate, burst), jax_limiter.TokenBucket(rate, burst)
    assert (port.rate_bytes_s, port.burst) == (ref.rate_bytes_s, ref.burst)
    for advance, nbytes in CHARGES:
        port_clock.now += advance
        ref_clock.now += advance
        assert port.throttle(nbytes) == ref.throttle(nbytes)
        assert port._budget == ref._budget
    assert port_clock.sleeps == ref_clock.sleeps
    if rate > 0:  # a deficit is slept off in slices of at most 5 s
        assert max(port_clock.sleeps) <= 5.0 and sum(port_clock.sleeps) > 5.0


def test_token_bucket_wait_replaces_sleep_and_a_true_return_stops_it(clocks):
    port_clock, ref_clock = clocks
    for bucket, clock in [(limiter.TokenBucket(10.0), port_clock),
                          (jax_limiter.TokenBucket(10.0), ref_clock)]:
        calls = []

        def stop(seconds, calls=calls, clock=clock):
            calls.append(seconds)
            clock.now += 0.5
            return True

        assert bucket.throttle(1010, wait=stop) == 0.5  # measured, not the 100 s deficit
        assert calls == [5.0] and clock.sleeps == []


def test_repair_budget_matches_the_jax_one(clocks):
    port_clock, ref_clock = clocks
    port, ref = repair_budget.RepairBudget(0.001), jax_budget.RepairBudget(0.001)
    assert port.rate_bytes_s == ref.rate_bytes_s == 0.001 * 1024 * 1024
    waits = (stats.REPAIR_WAIT_SECONDS.value(), jax_stats.REPAIR_WAIT_SECONDS.value())
    for nbytes in (500, 2000, 10, 4096):
        assert port.throttle(nbytes) == ref.throttle(nbytes)
    assert port_clock.sleeps == ref_clock.sleeps and sum(port_clock.sleeps) > 0
    assert (stats.REPAIR_WAIT_SECONDS.value() - waits[0]
            == jax_stats.REPAIR_WAIT_SECONDS.value() - waits[1] == sum(port_clock.sleeps))

    before = (stats.REPAIR_BYTES.series(), jax_stats.REPAIR_BYTES.series(),
              stats.REPAIR_OPS.series(), jax_stats.REPAIR_OPS.series())
    for b in (port, ref):
        b.account("rs", "global", read=1000)
        b.account("lrc", "local", read=500, moved=100)
        b.account("lrc", "local")
    for now, was, ref_now, ref_was in [
        (stats.REPAIR_BYTES, before[0], jax_stats.REPAIR_BYTES, before[1]),
        (stats.REPAIR_OPS, before[2], jax_stats.REPAIR_OPS, before[3]),
    ]:
        delta = {k: v - was.get(k, 0.0) for k, v in now.series().items() if v != was.get(k, 0.0)}
        ref_delta = {k: v - ref_was.get(k, 0.0) for k, v in ref_now.series().items()
                     if v != ref_was.get(k, 0.0)}
        assert delta == ref_delta and delta
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert sorted(snap) == sorted(ref_snap)
    assert (snap["rate_mb_s"], snap["waited_s"]) == (ref_snap["rate_mb_s"], ref_snap["waited_s"])
    assert snap["bytes"]["{code=lrc,dir=moved,mode=local}"] >= 100


def test_shared_budget_reads_weed_repair_rate_mb(monkeypatch):
    monkeypatch.setenv("WEED_REPAIR_RATE_MB", "12.5")
    try:
        assert repair_budget.reload().rate_bytes_s == 12.5 * 1024 * 1024
        assert repair_budget.shared() is repair_budget.shared()
        assert repair_budget.snapshot()["rate_mb_s"] == 12.5
        monkeypatch.delenv("WEED_REPAIR_RATE_MB")
        assert repair_budget.reload().rate_bytes_s == 0
        assert repair_budget.shared().throttle(1 << 40) == 0.0  # unlimited
    finally:
        repair_budget.reload()


def test_plane_tags_and_billing_match_the_jax_module():
    assert plane.PLANES == jax_plane.PLANES and plane.current() == jax_plane.current() == "serve"
    with plane.tagged(plane.SCRUB):
        assert plane.current() == "scrub"
        carried = plane.carrying(plane.current)
        with plane.tagged(plane.EC_REPAIR):
            assert plane.current() == "ec_repair"
    assert plane.current() == "serve" and carried() == "scrub"
    with pytest.raises(ValueError, match="unknown plane"):
        with plane.tagged("nope"):
            pass
    before = plane.snapshot().get("vacuum", {})
    with plane.tagged(plane.VACUUM):
        plane.account(4096, "read", seconds=0.5)
        plane.account(0, "write")
    after = plane.snapshot()["vacuum"]
    assert after["read"] - before.get("read", 0.0) == 4096
    assert after["op_seconds"] - before.get("op_seconds", 0.0) == 0.5
    assert "write" not in after or after["write"] == before.get("write")


def test_sched_cache_counts_hits_and_misses_as_the_jax_one():
    for cache in (sched_cache, jax_sched_cache):
        cache.cache_clear("t")
        before = cache.snapshot().get("t", {"hit": 0.0, "miss": 0.0})
        builds = []
        assert cache.get_or_build("t", ("k", 1), lambda: builds.append(1) or "v") == "v"
        assert cache.get_or_build("t", ("k", 1), lambda: builds.append(2) or "w") == "v"
        cache.cache_clear("t")
        assert cache.get_or_build("t", ("k", 1), lambda: builds.append(3) or "x") == "x"
        after = cache.snapshot()["t"]
        assert builds == [1, 3]
        assert (after["hit"] - before["hit"], after["miss"] - before["miss"]) == (1, 2)
    assert sched_cache.SCHED_CACHE_EVENTS.name == jax_sched_cache.SCHED_CACHE_EVENTS.name


def test_the_cpu_plain_path_caches_nothing():
    before = sched_cache.snapshot()
    x = torch.arange(40, dtype=torch.uint8).reshape(10, 4)
    mat = np.arange(40, dtype=np.uint8).reshape(4, 10)
    rs_cuda.apply_matrix_cuda(mat, x)
    rs_cuda.apply_bits_planes(np.eye(8 * 10, dtype=np.uint8)[:8],
                              torch.zeros((10, rs_cuda.BLOCK_WORDS), dtype=torch.uint32))
    assert sched_cache.snapshot() == before


# -- the rebuild -----------------------------------------------------------------


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vol")
    rng = random.Random(5)
    v = Volume(d, vid=1)
    for i in range(200):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 900)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    v.close()
    return d


CASES = {  # name: (port scheme, JAX scheme, JAX codec, lost, code, mode)
    "rs_4loss": (EcScheme(**GEOM), JaxScheme(**GEOM), ReedSolomonJax(10, 4),
                 (0, 3, 10, 13), "rs", "global"),
    "lrc_local": (lrc.LrcScheme(**LRC_GEOM), jax_lrc.LrcScheme(**LRC_GEOM), LrcCPU(10, 2, 2),
                  (3,), "lrc", "local"),
}


def _repair_bytes_delta(counter, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in counter.series().items()
            if v != before.get(k, 0.0)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rebuild_waits_on_the_budget_and_accounts_as_the_jax_rebuild(
        volume_dir, tmp_path, monkeypatch, clocks, name):
    scheme, jax_scheme, jax_codec, lost, code, mode = CASES[name]
    port_clock, ref_clock = clocks
    bases = {}
    for side in ("port", "jax"):
        base = str(shutil.copytree(volume_dir, tmp_path / side) / "1")
        ec_encoder.write_ec_files(base, scheme, device="cpu")
        for sid in lost:
            os.remove(base + scheme.shard_ext(sid))
        bases[side] = base
    shard_size = os.path.getsize(bases["port"] + ".ec01")
    monkeypatch.setenv("WEED_REPAIR_RATE_MB", "0.001")  # 1048.576 B/s: the rebuild must wait
    repair_budget.reload()
    jax_budget.reload()

    planes_seen = []
    codec = ReedSolomonTorch(10, 4, device="cpu") if code == "rs" else LrcTorch(10, 2, 2, device="cpu")
    real = codec.reconstruct_device

    def spy(*args):
        planes_seen.append(plane.current())
        return real(*args)

    monkeypatch.setattr(codec, "reconstruct_device", spy)
    port_before = (stats.REPAIR_BYTES.series(), stats.REPAIR_WAIT_SECONDS.value())
    ref_before = (jax_stats.REPAIR_BYTES.series(), jax_stats.REPAIR_WAIT_SECONDS.value())
    st: dict = {}
    try:
        assert ec_encoder.rebuild_ec_files(bases["port"], scheme, codec=codec, chunk=3000,
                                           stats=st) == sorted(lost)
        assert jax_ec.rebuild_ec_files(bases["jax"], jax_scheme, codec=jax_codec,
                                       chunk=3000) == sorted(lost)
    finally:
        monkeypatch.delenv("WEED_REPAIR_RATE_MB")
        repair_budget.reload()
        jax_budget.reload()
    assert planes_seen and set(planes_seen) == {"ec_repair"} and plane.current() == "serve"
    rate = 0.001 * 1024 * 1024
    assert st["mode"] == mode and st["read_bytes"] == len(st["inputs"]) * shard_size
    # the same charges, one per chunk before its read, give the same sleeps;
    # all in all the read bytes less the 1 s burst, at the rate
    assert port_clock.sleeps == ref_clock.sleeps
    assert sum(port_clock.sleeps) == pytest.approx((st["read_bytes"] - rate) / rate)
    assert stats.REPAIR_WAIT_SECONDS.value() - port_before[1] == pytest.approx(
        sum(port_clock.sleeps))
    got = _repair_bytes_delta(stats.REPAIR_BYTES, port_before[0])
    assert got == _repair_bytes_delta(jax_stats.REPAIR_BYTES, ref_before[0])
    assert got == {(("code", code), ("dir", "read"), ("mode", mode)): float(st["read_bytes"])}
    assert st["sched_cache"] == {}  # on the CPU: no plane moved
    for sid in lost:
        assert (open(bases["port"] + scheme.shard_ext(sid), "rb").read()
                == open(bases["jax"] + scheme.shard_ext(sid), "rb").read())


def test_rebuild_with_no_budget_does_not_wait(volume_dir, tmp_path, monkeypatch, clocks):
    monkeypatch.delenv("WEED_REPAIR_RATE_MB", raising=False)
    repair_budget.reload()
    base = str(shutil.copytree(volume_dir, tmp_path / "v") / "1")
    ec_encoder.write_ec_files(base, EcScheme(**GEOM), device="cpu")
    os.remove(base + ".ec05")
    assert ec_encoder.rebuild_ec_files(base, EcScheme(**GEOM), device="cpu") == [5]
    assert clocks[0].sleeps == []
