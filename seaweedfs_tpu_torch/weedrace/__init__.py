"""weedrace — happens-before race detection + interleaving exploration
over the port: the counterpart of the repo's ``weedrace`` tool.

It drives the port's delicate concurrent protocols through every
preemption-bounded interleaving (bound 2 by default) with
:mod:`seaweedfs_tpu_torch.util.racecheck`'s vector clocks watching every
attribute access, and reports:

  R001  data race — two unordered accesses to one ``(object, attr)``
        cell, at least one a write, with both stack traces and the locks
        held on each side
  R002  bare suppression — a ``# racecheck: benign`` directive with no
        written justification (unexplained suppressions are findings,
        not shields)
  R003  schedule deadlock — a cyclic blocking state reached under the
        explorer (reproducible from the reported schedule)
  R004  protocol invariant violated — a scenario's post-schedule check
        failed or a controlled thread raised (the interleaving that did
        it is in the message, replayable via ``WEED_RACECHECK_SCHEDULE``)

Run as ``python -m seaweedfs_tpu_torch.weedrace`` (see :mod:`.cli`).
``--format sarif`` emits SARIF 2.1.0; ``--cache`` reuses a result while
the sources and parameters are unchanged.  Suppress a benign race with
``# racecheck: benign — reason`` on (or above) either access line; the
reason is mandatory (R002).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__version__ = "0.1.0"


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass(frozen=True)
class Rule:
    code: str
    summary: str


RULES = [
    Rule("R001", "data race: unordered conflicting accesses to shared state"),
    Rule("R002", "bare '# racecheck: benign' without a justification"),
    Rule("R003", "schedule deadlock under the interleaving explorer"),
    Rule("R004", "protocol invariant violated under an explored schedule"),
]


def _rel(path: str) -> str:
    try:
        return os.path.relpath(path)
    except ValueError:  # pragma: no cover - different drive (windows)
        return path


def _fmt_side(side: dict) -> str:
    path, line = side["site"]
    locks = ",".join(side["locks"]) or "none"
    return f"{os.path.basename(path)}:{line} [{side['thread']}; locks: {locks}]"


def race_violation(race: dict, rule: str = "R001") -> Violation:
    """One reported race (racecheck dict) as a Violation anchored at the
    first access site."""
    a, b = race["a"], race["b"]
    msg = (
        f"{race['object']}.{race['attr']} {race['kind']}: "
        f"{_fmt_side(a)} vs {_fmt_side(b)}"
    )
    return Violation(rule, _rel(a["site"][0]), a["site"][1], msg)


__all__ = [
    "RULES",
    "Rule",
    "Violation",
    "race_violation",
    "__version__",
]
