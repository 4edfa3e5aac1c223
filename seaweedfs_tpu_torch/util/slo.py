"""Declarative SLOs evaluated over windows: pass/fail with margins.

The port's copy of seaweedfs_tpu/util/slo.py.  An operator asserts
sentences like "p99 of small GETs stayed under 250ms while scrub moved at
most 32 MB/s"; this module turns that sentence into data.  A spec (JSON,
inline or ``@file``, usually via the WEED_SLO env var) declares:

    {
      "window_s": 60,
      "ops": {
        "s3.get.small": {"p50_ms": 50, "p99_ms": 250, "min_count": 20},
        "s3.put":       {"p99_ms": 500}
      },
      "error_rate_max": 0.01,
      "cache_hit_min": 0.25,
      "plane_mb_s": {"scrub": 32, "ec_repair": 16}
    }

``evaluate(spec, inputs)`` is pure — table-testable — and returns per
rule (limit, actual, margin, passed), where margin is the normalized
headroom: (limit-actual)/limit for ceilings, (actual-floor)/floor for
floors; negative margin == violated.  Rules with too little data are
*skipped* (passed, flagged) rather than vacuously failed.

``capture()``/``evaluate_process()`` glue the pure evaluator to the
process singletons: latency quantiles come from the live sketch window
(stats/sketch.py), counters (errors, cache, plane bytes) are diffed
against a baseline snapshot so rates are over the evaluation interval,
not process lifetime.  /debug/sloz serves the result; the ``slo.status``
shell command reads it.
"""

from __future__ import annotations

import json
import os
import threading
import time

from seaweedfs_tpu_torch import stats

_EPS = 1e-12
_PROC_START = time.monotonic()  # lifetime-mode rate denominator


class SloSpecError(ValueError):
    pass


class OpSlo:
    __slots__ = ("p50_ms", "p99_ms", "min_count")

    def __init__(self, p50_ms=None, p99_ms=None, min_count=1):
        self.p50_ms = p50_ms
        self.p99_ms = p99_ms
        self.min_count = min_count


class SloSpec:
    def __init__(
        self,
        window_s: float = 60.0,
        ops: dict[str, OpSlo] | None = None,
        error_rate_max: float | None = None,
        cache_hit_min: float | None = None,
        plane_mb_s: dict[str, float] | None = None,
    ):
        self.window_s = window_s
        self.ops = ops or {}
        self.error_rate_max = error_rate_max
        self.cache_hit_min = cache_hit_min
        self.plane_mb_s = plane_mb_s or {}

    @classmethod
    def parse(cls, obj: dict) -> "SloSpec":
        from seaweedfs_tpu_torch.stats import sketch

        if not isinstance(obj, dict):
            raise SloSpecError(f"SLO spec must be an object, got {type(obj).__name__}")
        known = {"window_s", "ops", "error_rate_max", "cache_hit_min", "plane_mb_s"}
        unknown = set(obj) - known
        if unknown:
            raise SloSpecError(f"unknown SLO spec keys: {sorted(unknown)}")
        ops = {}
        for op, rule in (obj.get("ops") or {}).items():
            if op not in sketch.OP_CLASSES:
                raise SloSpecError(
                    f"unknown op class {op!r}; classes: {sorted(sketch.OP_CLASSES)}"
                )
            bad = set(rule) - {"p50_ms", "p99_ms", "min_count"}
            if bad:
                raise SloSpecError(f"unknown keys in ops[{op!r}]: {sorted(bad)}")
            ops[op] = OpSlo(
                p50_ms=rule.get("p50_ms"),
                p99_ms=rule.get("p99_ms"),
                min_count=int(rule.get("min_count", 1)),
            )
        from seaweedfs_tpu_torch.stats import plane as plane_mod

        planes = {}
        for plane, mbs in (obj.get("plane_mb_s") or {}).items():
            if plane not in plane_mod.PLANES:
                raise SloSpecError(
                    f"unknown plane {plane!r}; planes: {list(plane_mod.PLANES)}"
                )
            planes[plane] = float(mbs)
        return cls(
            window_s=float(obj.get("window_s", 60.0)),
            ops=ops,
            error_rate_max=obj.get("error_rate_max"),
            cache_hit_min=obj.get("cache_hit_min"),
            plane_mb_s=planes,
        )

    @classmethod
    def from_json(cls, text: str) -> "SloSpec":
        """Inline JSON, or ``@/path/to/spec.json``."""
        text = text.strip()
        if text.startswith("@"):
            with open(text[1:], encoding="utf-8") as f:
                text = f.read()
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise SloSpecError(f"SLO spec is not valid JSON: {e}") from e
        return cls.parse(obj)

    @classmethod
    def from_env(cls) -> "SloSpec | None":
        """The WEED_SLO spec, or None when unset."""
        raw = os.environ.get("WEED_SLO", "").strip()
        if not raw:
            return None
        return cls.from_json(raw)


class SloInputs:
    """Everything evaluate() reads, decoupled from where it came from
    (process singletons, a cluster scrape, or a test table)."""

    def __init__(
        self,
        duration_s: float,
        op_stats: dict[str, dict] | None = None,
        requests_total: int = 0,
        requests_errors: int = 0,
        cache_hits: int = 0,
        cache_misses: int = 0,
        plane_bytes: dict[str, float] | None = None,
    ):
        self.duration_s = max(duration_s, _EPS)
        self.op_stats = op_stats or {}
        self.requests_total = requests_total
        self.requests_errors = requests_errors
        self.cache_hits = cache_hits
        self.cache_misses = cache_misses
        self.plane_bytes = plane_bytes or {}


class SloResult:
    def __init__(self, rule, limit, actual, margin, passed, skipped=False, note=""):
        self.rule = rule
        self.limit = limit
        self.actual = actual
        self.margin = margin
        self.passed = passed
        self.skipped = skipped
        self.note = note

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "limit": self.limit,
            "actual": self.actual,
            "margin": self.margin,
            "passed": self.passed,
            "skipped": self.skipped,
            "note": self.note,
        }


class SloReport:
    def __init__(self, results: list[SloResult], duration_s: float):
        self.results = results
        self.duration_s = duration_s

    @property
    def passed(self) -> bool:
        return all(r.passed for r in self.results)

    @property
    def worst(self) -> SloResult | None:
        """The evaluated (non-skipped) rule with the least headroom."""
        live = [r for r in self.results if not r.skipped]
        return min(live, key=lambda r: r.margin) if live else None

    def to_dict(self) -> dict:
        worst = self.worst
        return {
            "passed": self.passed,
            "duration_s": self.duration_s,
            "worst_rule": worst.rule if worst else "",
            "worst_margin": worst.margin if worst else None,
            "results": [r.to_dict() for r in self.results],
        }

    def render_text(self) -> str:
        lines = [
            f"SLO: {'PASS' if self.passed else 'FAIL'}"
            f" (over {self.duration_s:.1f}s)"
        ]
        for r in self.results:
            if r.skipped:
                lines.append(f"  skip  {r.rule:<28s} {r.note}")
                continue
            verdict = "ok  " if r.passed else "FAIL"
            lines.append(
                f"  {verdict}  {r.rule:<28s} actual {r.actual:.4g}"
                f" vs {r.limit:.4g}  margin {r.margin:+.1%}"
            )
        return "\n".join(lines) + "\n"


def _ceiling(rule: str, limit: float, actual: float) -> SloResult:
    margin = (limit - actual) / limit if limit > _EPS else (
        0.0 if actual <= limit else -1.0
    )
    return SloResult(rule, limit, actual, margin, margin >= 0.0)


def _floor(rule: str, floor: float, actual: float) -> SloResult:
    margin = (actual - floor) / floor if floor > _EPS else (
        0.0 if actual >= floor else -1.0
    )
    return SloResult(rule, floor, actual, margin, margin >= 0.0)


def _skip(rule: str, note: str) -> SloResult:
    return SloResult(rule, None, None, 0.0, True, skipped=True, note=note)


def evaluate(spec: SloSpec, inputs: SloInputs) -> SloReport:
    """Pure rule evaluation — no globals, no clocks."""
    results: list[SloResult] = []
    for op in sorted(spec.ops):
        rule = spec.ops[op]
        row = inputs.op_stats.get(op) or {}
        count = int(row.get("count", 0))
        if count < max(rule.min_count, 1):
            results.append(_skip(
                f"latency:{op}", f"{count} samples < min_count {rule.min_count}"
            ))
            continue
        if rule.p50_ms is not None:
            results.append(_ceiling(
                f"p50:{op}", float(rule.p50_ms), float(row.get("p50_ms", 0.0))
            ))
        if rule.p99_ms is not None:
            results.append(_ceiling(
                f"p99:{op}", float(rule.p99_ms), float(row.get("p99_ms", 0.0))
            ))
    if spec.error_rate_max is not None:
        if inputs.requests_total <= 0:
            results.append(_skip("error_rate", "no requests in window"))
        else:
            results.append(_ceiling(
                "error_rate", float(spec.error_rate_max),
                inputs.requests_errors / inputs.requests_total,
            ))
    if spec.cache_hit_min is not None:
        lookups = inputs.cache_hits + inputs.cache_misses
        if lookups <= 0:
            results.append(_skip("cache_hit_rate", "no cache lookups in window"))
        else:
            results.append(_floor(
                "cache_hit_rate", float(spec.cache_hit_min),
                inputs.cache_hits / lookups,
            ))
    for plane in sorted(spec.plane_mb_s):
        limit = spec.plane_mb_s[plane]
        mb_s = inputs.plane_bytes.get(plane, 0.0) / inputs.duration_s / 1e6
        results.append(_ceiling(f"plane_mb_s:{plane}", float(limit), mb_s))
    return SloReport(results, inputs.duration_s)


# ---- process glue --------------------------------------------------------


class Baseline:
    """Counter values at window start; diffed by inputs_since()."""

    __slots__ = ("t", "s3_requests", "cache", "plane_bytes")

    def __init__(self):
        self.t = time.monotonic()
        self.s3_requests = stats.S3_REQUESTS.series()
        self.cache = stats.CHUNK_CACHE.series()
        self.plane_bytes = stats.PLANE_BYTES.series()


def capture() -> Baseline:
    return Baseline()


def _series_delta(now: dict, base: dict) -> dict:
    return {k: v - base.get(k, 0.0) for k, v in now.items()}


def inputs_since(baseline: Baseline | None) -> SloInputs:
    """Live SloInputs: sketch-window quantiles + counter deltas since
    ``baseline`` (process lifetime when None)."""
    from seaweedfs_tpu_torch.stats import sketch

    now = Baseline()
    if baseline is None:
        s3 = now.s3_requests
        cache = now.cache
        planes = now.plane_bytes
        duration = max(time.monotonic() - _PROC_START, _EPS)
    else:
        s3 = _series_delta(now.s3_requests, baseline.s3_requests)
        cache = _series_delta(now.cache, baseline.cache)
        planes = _series_delta(now.plane_bytes, baseline.plane_bytes)
        duration = max(now.t - baseline.t, _EPS)
    total = errors = 0
    for key, v in s3.items():
        labels = dict(key)
        total += int(v)
        code = labels.get("code", "")
        if code.isdigit() and int(code) >= 500:
            errors += int(v)
    hits = misses = 0
    for key, v in cache.items():
        event = dict(key).get("event", "")
        if event == "hit":
            hits += int(v)
        elif event == "miss":
            misses += int(v)
    plane_bytes: dict[str, float] = {}
    for key, v in planes.items():
        plane = dict(key).get("plane", "?")
        plane_bytes[plane] = plane_bytes.get(plane, 0.0) + v
    return SloInputs(
        duration_s=duration,
        op_stats=sketch.OP_LATENCY.snapshot(),
        requests_total=total,
        requests_errors=errors,
        cache_hits=hits,
        cache_misses=misses,
        plane_bytes=plane_bytes,
    )


def evaluate_process(spec: SloSpec, baseline: Baseline | None = None) -> SloReport:
    return evaluate(spec, inputs_since(baseline))


# /debug/sloz keeps a rolling baseline: each scrape evaluates the
# interval since the previous one (first scrape: process lifetime),
# so repeated scrapes see current rates, not lifetime averages.
_sloz_lock = threading.Lock()
_sloz_baseline: Baseline | None = None


def debug_body(q: dict) -> tuple[int, bytes]:
    global _sloz_baseline
    spec_arg = q.get("spec", [""])[0]
    try:
        spec = SloSpec.from_json(spec_arg) if spec_arg else SloSpec.from_env()
    except (SloSpecError, OSError) as e:
        return 400, f"bad SLO spec: {e}\n".encode()
    if spec is None:
        return 200, (
            b"no SLO spec configured: set WEED_SLO (inline JSON or @file) "
            b"or pass ?spec=...\n"
        )
    with _sloz_lock:
        baseline = _sloz_baseline
        report = evaluate_process(spec, baseline)
        if not q.get("cumulative", [""])[0]:
            _sloz_baseline = capture()
    if q.get("json", [""])[0]:
        return 200, json.dumps(report.to_dict(), indent=2).encode()
    return 200, report.render_text().encode()


# ---- violation artifacts -------------------------------------------------


def dump_artifacts(
    artifact_dir: str,
    members: tuple[str, ...] | list[str] = (),
    report: SloReport | None = None,
    timeout: float = 5.0,
) -> list[str]:
    """Capture the forensic state behind an SLO violation into
    ``artifact_dir``, one call: the flight-recorder event timeline, the
    mergeable latency-sketch dumps, the repair-budget counters, and the
    breaker states — locally and (when ``members`` names metrics
    endpoints) from every member via its /debug endpoints.  Used by
    ``slo.status -artifacts``.

    Best-effort per source: a dead member costs an entry in
    ``errors.json``, never the rest of the dump.  Returns the paths
    written: report.json, events.json, sketch.bin, repair.json and
    breakers.json locally; events-merged.json, sketch-<member>.bin,
    repair-<member>.json and breakers-<member>.json from the members;
    errors.json for whatever failed)."""
    from seaweedfs_tpu_torch.stats import events, sketch

    os.makedirs(artifact_dir, exist_ok=True)
    written: list[str] = []
    errors: dict[str, str] = {}

    def _write(name: str, data: bytes) -> None:
        path = os.path.join(artifact_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        written.append(path)

    def _jwrite(name: str, obj) -> None:
        _write(name, json.dumps(obj, indent=2).encode() + b"\n")

    if report is not None:
        _jwrite("report.json", report.to_dict())

    # local process state first — always available
    _jwrite("events.json", events.default_ring.to_dicts())
    _write("sketch.bin", sketch.OP_LATENCY.dump())
    try:
        from seaweedfs_tpu_torch.ops import repair_budget
        from seaweedfs_tpu_torch.util import resilience

        _jwrite("repair.json", repair_budget.snapshot())
        _jwrite("breakers.json", resilience.snapshot())
    except Exception as e:  # noqa: BLE001 — forensics must not throw away the rest
        errors["local"] = str(e) or type(e).__name__

    if members:
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        pool = shared_pool()
        timelines: list[tuple[str, list[dict]]] = []
        for member in members:
            tag = member.replace(":", "_").replace("/", "_")
            try:
                status, evs = pool.request(
                    member, "GET", "/debug/eventz?json=1&limit=0",
                    timeout=timeout,
                )
                if status == 200:
                    timelines.append(
                        (member, json.loads(evs.decode("utf-8", "replace")))
                    )
                status, dump = pool.request(
                    member, "GET", "/debug/sketchz?binary=1", timeout=timeout
                )
                if status == 200:
                    _write(f"sketch-{tag}.bin", dump)
                for path, name in (
                    ("/debug/repair", f"repair-{tag}.json"),
                    ("/debug/breakers", f"breakers-{tag}.json"),
                ):
                    status, body = pool.request(
                        member, "GET", path, timeout=timeout
                    )
                    if status == 200:
                        _write(name, body)
            except Exception as e:  # noqa: BLE001 — a dead member can't block the dump
                errors[member] = str(e) or type(e).__name__
        if timelines:
            _jwrite("events-merged.json", events.merge_timelines(timelines))
    if errors:
        _jwrite("errors.json", errors)
    return written
