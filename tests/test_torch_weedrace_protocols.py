"""Explorer-driven protocol suites over the port: every scenario of the
port's weedrace (seaweedfs_tpu_torch.weedrace) stays clean.

Each targeted protocol (chunk-cache single-flight, breaker half-open
probe, FidPool take-vs-refill, WindowedSketch rotation, splice addr
cache, two-phase cross-shard move) is driven through the port's modules
in preemption-bounded schedules with the port's racecheck installed and
its scope narrowed to the code under test.  Zero unsuppressed races, zero
invariant violations, zero deadlocks, in any test-file order: the port's
detector keys a ``__slots__`` object (the sketch's) by an id() that no
later object can take while its cells exist.  The full sweep is ``python
-m seaweedfs_tpu_torch.weedrace`` (max_runs 64, whole-package scope).
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from seaweedfs_tpu_torch.util import racecheck  # noqa: E402
from torch_seam_helpers import no_jax_seam  # noqa: E402,F401 (autouse)

# scenario -> module scope for the tracer, relative to seaweedfs_tpu_torch
SCOPES = {
    "chunk_cache_single_flight": "util.chunk_cache",
    "breaker_probe": "util.resilience",
    "fidpool_take_refill": "filer.upload",
    "sketch_rotation": "stats.sketch",
    "splice_addr_cache": "filer.splice",
    "shard_move_two_phase": "filer.shard_ring",
}


@pytest.mark.parametrize("name", sorted(SCOPES))
def test_protocol_clean_under_explored_schedules(name, monkeypatch):
    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS
    from seaweedfs_tpu_torch.weedrace.sched import explore

    assert name in SCENARIOS, f"scenario registry lost {name}"
    monkeypatch.delenv("WEED_RACECHECK_SCHEDULE", raising=False)
    monkeypatch.setenv("WEED_RACECHECK_MODULES", SCOPES[name])
    racecheck.install()
    try:
        racecheck.reset()
        results = explore(SCENARIOS[name], bound=2, max_runs=12)
        assert results, "explorer produced no runs"
        for r in results:
            assert not r.deadlock, f"{name} deadlocked under {r.schedule_used}"
            assert not r.errors, (
                f"{name} invariant violated under {r.schedule_used}: {r.errors}"
            )
        report = racecheck.report()
        assert report["races"] == [], (
            f"{name}: unsuppressed races: {report['races']}"
        )
        assert report["bare_directives"] == 0
    finally:
        racecheck.reset()
        racecheck.uninstall()


def test_scenario_registry_matches_the_scopes():
    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS
    from seaweedfs_tpu_torch.weedrace.scenarios import SCOPES as PORT_SCOPES

    assert set(SCENARIOS) == set(SCOPES)
    assert PORT_SCOPES == SCOPES


def test_scenarios_drive_the_port_modules():
    """Each scenario imports the port's module named in its scope, never
    the JAX package's."""
    import inspect

    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS

    for name, scope in SCOPES.items():
        src = inspect.getsource(SCENARIOS[name])
        pkg, leaf = ("seaweedfs_tpu_torch." + scope).rsplit(".", 1)
        assert f"{pkg}.{leaf} import" in src or f"from {pkg} import {leaf}" in src, name
        assert "seaweedfs_tpu." not in src.replace("seaweedfs_tpu_torch.", "")


def test_cli_explores_every_scenario_clean(tmp_path):
    """``python -m seaweedfs_tpu_torch.weedrace`` at tier-1's depth: no
    finding, SARIF out, and a second run served from its cache."""
    import json
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WEED_RACECHECK_MODULES", "WEED_RACECHECK_SCHEDULE")}
    env["PYTHONPATH"] = repo
    argv = [sys.executable, "-m", "seaweedfs_tpu_torch.weedrace", "--max-runs", "12", "--cache"]
    first = subprocess.run([*argv, "--format", "sarif", "--output", str(tmp_path / "r.sarif")],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stdout + first.stderr
    doc = json.loads((tmp_path / "r.sarif").read_text())
    assert doc["runs"][0]["tool"]["driver"]["name"] == "weedrace"
    assert doc["runs"][0]["results"] == []
    assert (tmp_path / ".weedrace-torch-cache.json").is_file()
    again = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr
    last = again.stdout.strip().splitlines()[-1]
    assert "0 finding(s) over 72 explored run(s)" in last and last.endswith("(cached)"), last
    unknown = subprocess.run([*argv[:3], "no_such_scenario"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
    assert unknown.returncode == 2 and "no_such_scenario" in unknown.stderr
