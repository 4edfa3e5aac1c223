"""weedrace CLI over the port: explore protocol scenarios, report races as
findings.

Examples (from the repo root)::

    python -m seaweedfs_tpu_torch.weedrace                  # all scenarios, bound 2
    python -m seaweedfs_tpu_torch.weedrace breaker_probe --bound 3
    python -m seaweedfs_tpu_torch.weedrace --format sarif --output sarif_race.json
    python -m seaweedfs_tpu_torch.weedrace --modules util.chunk_cache --max-runs 12
    WEED_RACECHECK_SCHEDULE=1,0 python -m seaweedfs_tpu_torch.weedrace breaker_probe

The run installs the port's racecheck, drives every preemption-bounded
schedule of each selected scenario through the port's product code, and
emits one finding per (deduplicated) race, deadlock, bare suppression
directive, and violated invariant.  Exit 1 when any finding is left,
2 on a usage error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

from seaweedfs_tpu_torch.weedrace import Violation, race_violation

_PKG = Path(__file__).resolve().parent.parent
CACHE_FILE = ".weedrace-torch-cache.json"  # in the working directory


def run_scenarios(names, bound, max_runs, schedule=None):
    """Explore each named scenario; returns (violations, stats dict)."""
    from seaweedfs_tpu_torch.util import racecheck
    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS
    from seaweedfs_tpu_torch.weedrace.sched import explore

    scen_path = os.path.relpath(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "scenarios.py")
    )
    violations: list[Violation] = []
    stats = {"scenarios": {}, "runs": 0}
    for name in names:
        results = explore(SCENARIOS[name], bound=bound, max_runs=max_runs,
                          schedule=schedule)
        stats["runs"] += len(results)
        n_races = 0
        for res in results:
            sched = ",".join(str(c) for c in res.schedule_used) or "-"
            n_races += len(res.races)
            if res.deadlock:
                violations.append(Violation(
                    "R003", scen_path, 1,
                    f"{name}: deadlock under schedule [{sched}]: "
                    + "; ".join(res.deadlock),
                ))
            for who, err in res.errors:
                violations.append(Violation(
                    "R004", scen_path, 1,
                    f"{name}: {who} under schedule [{sched}]: {err}",
                ))
        stats["scenarios"][name] = {
            "runs": len(results), "raw_races": n_races,
        }
    report = racecheck.report()
    violations += [race_violation(race) for race in report["races"]]
    # a justified benign directive suppresses R001 but is counted
    stats["suppressed"] = len(report["suppressed"])
    # the bare directives already surface as R001 (they do not suppress);
    # add the R002 hygiene finding per covered site
    seen = set()
    for race in report["races"]:
        for side in ("a", "b"):
            path, line = race[side]["site"]
            verdict, ln = racecheck._directive_at(path, line)
            if verdict == "bare" and (path, ln) not in seen:
                seen.add((path, ln))
                violations.append(Violation(
                    "R002", os.path.relpath(path), ln,
                    "bare '# racecheck: benign' without a "
                    "justification (does not suppress)",
                ))
    stats["bare_directives"] = report["bare_directives"]
    stats["dropped_cells"] = report.get("dropped_cells", 0)
    return violations, stats


def _cache_key(names, bound, max_runs, modules) -> str:
    """Exploration results are a function of the port's sources (the
    harness included), the interpreter, and the run parameters."""
    h = hashlib.sha256()
    h.update(f"{sys.version_info}|{bound}|{max_runs}|{sorted(names)}|{modules}".encode())
    for py in sorted(_PKG.rglob("*.py")):
        h.update(str(py.relative_to(_PKG)).encode())
        h.update(py.read_bytes())
    return h.hexdigest()


def main(argv=None) -> int:
    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS
    from seaweedfs_tpu_torch.weedrace.sched import DEFAULT_PREEMPTION_BOUND

    parser = argparse.ArgumentParser(
        prog="python -m seaweedfs_tpu_torch.weedrace",
        description="happens-before race detection + schedule exploration "
                    "over the port",
    )
    parser.add_argument("scenarios", nargs="*",
                        help="scenario names (default: all)")
    parser.add_argument("--bound", type=int, default=DEFAULT_PREEMPTION_BOUND,
                        help="preemption bound (default 2)")
    parser.add_argument("--max-runs", type=int, default=64,
                        help="schedule cap per scenario (default 64)")
    parser.add_argument("--modules", default=None,
                        help="comma-separated racecheck scope (module "
                             "suffixes relative to seaweedfs_tpu_torch); "
                             "default WEED_RACECHECK_MODULES, else the package")
    parser.add_argument("--format", choices=("text", "sarif"), default="text")
    parser.add_argument("--output", help="write the report here instead of "
                        "stdout")
    parser.add_argument("--cache", action="store_true",
                        help=f"reuse results in {CACHE_FILE} when sources + "
                             "params unchanged")
    args = parser.parse_args(argv)

    names = args.scenarios or sorted(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"weedrace: unknown scenario(s): {', '.join(unknown)}",
              file=sys.stderr)
        return 2

    violations = None
    stats = {}
    key = None
    if args.cache:
        key = _cache_key(names, args.bound, args.max_runs, args.modules)
        try:
            data = json.loads(Path(CACHE_FILE).read_text())
            if data.get("key") == key:
                violations = [Violation(**v) for v in data["violations"]]
                stats = data.get("stats", {})
                stats["cache"] = "hit"
        except (OSError, ValueError, TypeError, KeyError):
            pass

    if violations is None:
        from seaweedfs_tpu_torch.util import racecheck

        try:
            racecheck.install(modules=args.modules)
        except RuntimeError as e:
            print(f"weedrace: {e}", file=sys.stderr)
            return 2
        try:
            violations, stats = run_scenarios(names, args.bound, args.max_runs)
        finally:
            racecheck.uninstall()
        if key is not None:
            Path(CACHE_FILE).write_text(json.dumps({
                "key": key,
                "violations": [vars(v) for v in violations],
                "stats": stats,
            }, indent=1))

    violations.sort(key=lambda v: (v.rule, v.path, v.line, v.message))

    if args.format == "sarif":
        from seaweedfs_tpu_torch.weedrace.sarif import to_sarif

        out = json.dumps(to_sarif(violations), indent=1)
    else:
        lines = [str(v) for v in violations]
        lines.append(
            f"weedrace: {len(violations)} finding(s) over "
            f"{stats.get('runs', '?')} explored run(s); "
            f"{stats.get('suppressed', 0)} suppressed"
            + (" (cached)" if stats.get("cache") == "hit" else "")
        )
        out = "\n".join(lines)

    if args.output:
        Path(args.output).write_text(out + "\n")
    else:
        print(out)
    return 1 if violations else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
