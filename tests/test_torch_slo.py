"""The port's SLO engine (util/slo.py) held against the JAX package's.

- ``SloSpec.parse``/``from_json``/``from_env`` accept the same specs and
  refuse the same bad ones with the same message.
- ``evaluate`` over the same table of inputs gives equal reports: the
  same rules, limits, actuals, margins, verdicts and skips
  (``to_dict``) and the same rendered text, including the worst rule.
- The process glue: after the same recorded latencies and counters,
  ``evaluate_process`` reports the same rules in both packages; the
  /debug/sloz body answers the same way with no spec, a bad spec, and
  ``?json=1``; ``dump_artifacts`` writes the same file names.

Comparison: equality of report dicts and rendered text; no tolerance.
"""

from __future__ import annotations

import json
import os

import pytest

from seaweedfs_tpu.util import slo as jax_slo
from seaweedfs_tpu_torch.util import slo

SPECS = [
    {"window_s": 30, "ops": {"s3.get.small": {"p50_ms": 50, "p99_ms": 250, "min_count": 5},
                             "s3.put": {"p99_ms": 500}},
     "error_rate_max": 0.01, "cache_hit_min": 0.25, "plane_mb_s": {"scrub": 32, "ec_repair": 16}},
    {"ops": {"meta.lookup": {"p99_ms": 5}}},
    {"error_rate_max": 0.0},
    {"cache_hit_min": 0.0},
    {"plane_mb_s": {"serve": 0}},
    {},
]

BAD = [
    {"p99_ms": 250},
    {"ops": {"s3.get.medium": {"p99_ms": 1}}},
    {"ops": {"s3.put": {"p95_ms": 1}}},
    {"plane_mb_s": {"compaction": 8}},
    [1, 2],
]

INPUTS = [
    dict(duration_s=10.0),
    dict(duration_s=10.0, op_stats={"s3.put": {"count": 50, "p50_ms": 5.0, "p99_ms": 150.0},
                                    "s3.get.small": {"count": 3, "p50_ms": 1.0,
                                                     "p99_ms": 9.0},
                                    "meta.lookup": {"count": 9, "p99_ms": 4.0}},
         requests_total=200, requests_errors=3, cache_hits=30, cache_misses=90,
         plane_bytes={"scrub": 4e8, "ec_repair": 1e7, "serve": 5.0}),
    dict(duration_s=0.0, op_stats={"s3.get.small": {"count": 500, "p50_ms": 49.9,
                                                    "p99_ms": 250.0}},
         requests_total=1, requests_errors=0, cache_hits=1, cache_misses=0),
    dict(duration_s=60.0, requests_total=10, requests_errors=10,
         plane_bytes={"scrub": 32e6 * 60}),
]


def _spec_pair(obj):
    return slo.SloSpec.parse(obj), jax_slo.SloSpec.parse(obj)


@pytest.mark.parametrize("inputs", range(len(INPUTS)))
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_reports_equal(spec, inputs):
    port_spec, jax_spec = _spec_pair(SPECS[spec])
    port = slo.evaluate(port_spec, slo.SloInputs(**INPUTS[inputs]))
    jax = jax_slo.evaluate(jax_spec, jax_slo.SloInputs(**INPUTS[inputs]))
    assert port.to_dict() == jax.to_dict()
    assert port.render_text() == jax.render_text()


@pytest.mark.parametrize("obj", BAD)
def test_bad_specs_refused_alike(obj):
    with pytest.raises(slo.SloSpecError) as port:
        slo.SloSpec.parse(obj)
    with pytest.raises(jax_slo.SloSpecError) as jax:
        jax_slo.SloSpec.parse(obj)
    assert str(port.value) == str(jax.value)


def test_from_json_and_env_alike(tmp_path, monkeypatch):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(SPECS[0]))
    for text in (json.dumps(SPECS[1]), f"@{path}"):
        assert slo.SloSpec.from_json(text).__dict__.keys() == \
            jax_slo.SloSpec.from_json(text).__dict__.keys()
        assert slo.SloSpec.from_json(text).window_s == jax_slo.SloSpec.from_json(text).window_s
    with pytest.raises(slo.SloSpecError, match="not valid JSON"):
        slo.SloSpec.from_json("{nope")
    monkeypatch.delenv("WEED_SLO", raising=False)
    assert slo.SloSpec.from_env() is None and jax_slo.SloSpec.from_env() is None
    monkeypatch.setenv("WEED_SLO", '{"cache_hit_min": 0.9}')
    assert slo.SloSpec.from_env().cache_hit_min == jax_slo.SloSpec.from_env().cache_hit_min


def _feed(pkg: str) -> None:
    """The same latencies and counters into one package's singletons."""
    if pkg == "port":
        from seaweedfs_tpu_torch import stats
        from seaweedfs_tpu_torch.stats import sketch
    else:
        from seaweedfs_tpu import stats
        from seaweedfs_tpu.stats import sketch
    for i in range(40):
        sketch.record(sketch.OP_S3_PUT, 0.002 * (i % 7 + 1))
        sketch.record(sketch.OP_META_LOOKUP, 0.0005 * (i % 3 + 1))
    stats.S3_REQUESTS.inc(38, action="PutObject", code="200")
    stats.S3_REQUESTS.inc(2, action="PutObject", code="503")
    stats.CHUNK_CACHE.inc(30, event="hit")
    stats.CHUNK_CACHE.inc(10, event="miss")


def test_process_evaluation_alike():
    spec = {"ops": {"s3.put": {"p99_ms": 100, "min_count": 10},
                    "meta.lookup": {"p50_ms": 10}},
            "error_rate_max": 0.1, "cache_hit_min": 0.5}
    bases = (slo.capture(), jax_slo.capture())
    _feed("port")
    _feed("jax")
    port = slo.evaluate_process(slo.SloSpec.parse(spec), bases[0]).to_dict()
    jax = jax_slo.evaluate_process(jax_slo.SloSpec.parse(spec), bases[1]).to_dict()
    for rep in (port, jax):
        rep.pop("duration_s")
    # latencies come from each process window (which other tests may have
    # fed too): the rules, verdicts and counter-derived actuals must agree
    assert [(r["rule"], r["limit"], r["passed"]) for r in port["results"]] == \
        [(r["rule"], r["limit"], r["passed"]) for r in jax["results"]]
    by_rule = {r["rule"]: r for r in port["results"]}
    assert by_rule["error_rate"]["actual"] == 2 / 40
    assert by_rule["cache_hit_rate"]["actual"] == 30 / 40


@pytest.mark.parametrize("query", [{}, {"spec": ["{bad"]}, {"spec": [json.dumps(SPECS[2])]},
                                   {"spec": [json.dumps(SPECS[2])], "json": ["1"]}])
def test_debug_body_alike(query, monkeypatch):
    monkeypatch.delenv("WEED_SLO", raising=False)
    q = dict(query, cumulative=["1"])
    code, body = slo.debug_body(q)
    jcode, jbody = jax_slo.debug_body(q)
    assert code == jcode
    if code != 200 or not body.startswith((b"SLO", b"{")):
        assert body == jbody
    elif q.get("json"):
        assert json.loads(body).keys() == json.loads(jbody).keys()
    else:
        assert body.splitlines()[0].split(b" (")[0] == jbody.splitlines()[0].split(b" (")[0]


def test_dump_artifacts_alike(tmp_path):
    report = slo.evaluate(slo.SloSpec.parse(SPECS[2]), slo.SloInputs(duration_s=1.0))
    jreport = jax_slo.evaluate(jax_slo.SloSpec.parse(SPECS[2]), jax_slo.SloInputs(duration_s=1.0))
    port = slo.dump_artifacts(str(tmp_path / "p"), report=report)
    jax = jax_slo.dump_artifacts(str(tmp_path / "j"), report=jreport)
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in jax]
    with open(tmp_path / "p" / "report.json") as f:
        assert json.load(f) == report.to_dict()
