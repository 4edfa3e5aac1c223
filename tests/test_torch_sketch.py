"""The port's latency sketches (stats/sketch.py) held against the JAX
package's.

- The same seeded samples give byte-equal binary dumps (the
  /debug/sketchz?binary=1 wire format), equal quantiles, sums and
  to_dict rows, for several alphas and value ranges.
- Dumps merge across packages: a JAX dump parsed and merged by the port
  (and the other way round) equals the merge of the samples in one
  sketch, bucket for bucket.
- The sliding window (WindowedSketch on an injected clock) expires the
  same slots, the op-latency family renders the same /metrics summary,
  and ``s3_op_class`` maps every action the same way.

Comparison: byte equality of dumps, equality of floats computed the same
way (no tolerance); the rank error of the quantiles is checked against
alpha.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from seaweedfs_tpu.stats import sketch as jax_sketch
from seaweedfs_tpu_torch.stats import sketch

SEEDS = [0, 1, 2, 3]
ALPHAS = [0.01, 0.02, 0.05]


def _samples(seed: int, n: int = 2000) -> list[float]:
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(mean=-5.0, sigma=1.5, size=n)
    vals[::97] = 0.0  # durations that round to zero
    return [float(v) for v in vals]


def _filled(mod, alpha: float, values: list[float]):
    sk = mod.Sketch(alpha)
    for v in values:
        sk.add(v)
    return sk


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_dumps_byte_equal(seed, alpha):
    vals = _samples(seed)
    port, jax = _filled(sketch, alpha, vals), _filled(jax_sketch, alpha, vals)
    dump = sketch.dump_sketches({"s3.put": port, "volume.read": port.copy()})
    assert dump == jax_sketch.dump_sketches({"s3.put": jax, "volume.read": jax.copy()})
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert port.quantile(q) == jax.quantile(q)
    assert port.to_dict() == jax.to_dict()
    # the rank error stays within alpha of the true quantile
    ordered = sorted(vals)
    for q in (0.5, 0.9, 0.99):
        true = ordered[int(q * (len(ordered) - 1))]
        assert abs(port.quantile(q) - true) <= alpha * true + 1e-12


@pytest.mark.parametrize("seed", SEEDS)
def test_dumps_merge_across_packages(seed):
    a, b = _samples(seed), _samples(seed + 100, 700)
    port_a = sketch.dump_sketches({"s3.put": _filled(sketch, 0.01, a)})
    jax_b = jax_sketch.dump_sketches({"s3.put": _filled(jax_sketch, 0.01, b),
                                      "meta.lookup": _filled(jax_sketch, 0.01, b[:50])})
    one = _filled(sketch, 0.01, a + b)
    for merged in (sketch.merge_dumps([port_a, jax_b]), jax_sketch.merge_dumps([port_a, jax_b])):
        assert merged["s3.put"].buckets == one.buckets
        assert (merged["s3.put"].count, merged["s3.put"].zero) == (one.count, one.zero)
        assert math.isclose(merged["s3.put"].sum, one.sum, rel_tol=1e-12)
        assert merged["meta.lookup"].count == 50
    assert sketch.dump_sketches(sketch.merge_dumps([port_a, jax_b])) == \
        jax_sketch.dump_sketches(jax_sketch.merge_dumps([port_a, jax_b]))


@pytest.mark.parametrize("data", [b"", b"WSKD", b"XXXX" + bytes(10),
                                  b"WSKD" + (2).to_bytes(2, "little") + bytes(4)])
def test_bad_dumps_refused_alike(data):
    with pytest.raises(ValueError) as port:
        sketch.parse_dump(data)
    with pytest.raises(ValueError) as jax:
        jax_sketch.parse_dump(data)
    assert str(port.value) == str(jax.value)


def test_merge_refuses_other_alpha():
    with pytest.raises(ValueError, match="alpha"):
        sketch.Sketch(0.01).merge(sketch.Sketch(0.02))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("step", [1.0, 7.5, 30.0])
def test_window_expires_alike(step):
    got = []
    for mod in (sketch, jax_sketch):
        clock = _Clock()
        w = mod.WindowedSketch(0.01, window_s=60.0, slots=6, clock=clock)
        rows = []
        for i in range(40):
            w.add(0.001 * (i + 1))
            clock.t += step
            m = w.merged()
            rows.append((m.count, m.quantile(0.5), m.quantile(0.99)))
        got.append(rows)
    assert got[0] == got[1]


@pytest.fixture
def port_family():
    """A port family, unregistered from /metrics after the test."""
    from seaweedfs_tpu_torch import stats

    fam = sketch.SketchFamily("weedtpu_test_latency", "test")
    yield fam
    with stats._FAMILIES_LOCK:
        stats._FAMILIES.remove(fam)


def test_family_renders_alike(port_family):
    port = port_family
    jax = jax_sketch.SketchFamily("weedtpu_test_latency", "test",
                                  registry=jax_sketch.stats.Registry())
    for i, v in enumerate(_samples(9, 300)):
        op = sorted(sketch.OP_CLASSES)[i % 5]
        port.record(op, v)
        jax.record(op, v)
    assert port.render() == jax.render()
    assert port.dump() == jax.dump() and port.dump_b64() == jax.dump_b64()
    assert port.snapshot() == jax.snapshot()
    with pytest.raises(ValueError, match="unregistered op class"):
        port.record("free.text", 1.0)
    port.reset()
    assert port.snapshot() == {}


ACTIONS = ["GetObject", "PutObject", "UploadPart", "CompleteMultipartUpload", "CopyObject",
           "CreateMultipartUpload", "DeleteObject", "DeleteObjects", "AbortMultipartUpload",
           "ListObjectsV2", "ListObjects", "ListBuckets", "ListMultipartUploads", "ListParts",
           "ListObjectVersions", "ListBucket", "ListAllMyBuckets", "ListBucketVersions",
           "ListBucketMultipartUploads", "ListMultipartUploadParts", "HeadObject",
           "HeadBucket", "PutBucketPolicy", "GetObjectTagging", "CreateBucket", ""]


@pytest.mark.parametrize("size", [0, 64 * 1024, 64 * 1024 + 1])
def test_op_classes_equal(size):
    assert sketch.OP_CLASSES == jax_sketch.OP_CLASSES
    assert [sketch.s3_op_class(a, size) for a in ACTIONS] == \
        [jax_sketch.s3_op_class(a, size) for a in ACTIONS]


def test_debug_snapshot_shape():
    snap = sketch.debug_snapshot()
    assert set(snap) == set(jax_sketch.debug_snapshot()) == {"alpha", "window_s", "ops"}
