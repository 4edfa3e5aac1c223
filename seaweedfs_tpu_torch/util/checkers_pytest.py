"""pytest plugin: the port's lock-order and race checkers for a test run.

    python -m pytest -p seaweedfs_tpu_torch.util.checkers_pytest \\
        --weed-lockcheck --weed-racecheck tests/test_torch_*.py

``--weed-lockcheck`` installs :mod:`seaweedfs_tpu_torch.util.lockcheck` and
``--weed-racecheck`` :mod:`seaweedfs_tpu_torch.util.racecheck` (scoped by
``WEED_RACECHECK_MODULES``, suffixes relative to ``seaweedfs_tpu_torch``)
at configure time, before collection imports the port, so the port's
module locks are instrumented.  At session end it prints the
``LOCKCHECK:`` and ``RACECHECK:`` lines the repo's own harness prints for
the JAX package.

The plugin reads only its own options, never ``WEED_LOCKCHECK`` or
``WEED_RACECHECK`` (which install the JAX package's checkers), and the
port's seam refuses to install while another seam has patched
``threading``: a run that asks for both stops with a usage error instead
of stacking one seam on the other.  The checkers see one process, so a
run under pytest-xdist (``-n``/``--dist``) is refused as well: its
controller runs no test and would print a verdict nothing measured.  A
run that finds a cycle or an unsuppressed race exits non-zero.
"""

from __future__ import annotations

import sys

import pytest

_active = {"lockcheck": False, "racecheck": False}


def pytest_addoption(parser):
    group = parser.getgroup("weed-checkers", "the port's concurrency checkers")
    group.addoption("--weed-lockcheck", action="store_true", default=False,
                    help="record lock-order cycles and long holds in the port")
    group.addoption("--weed-racecheck", action="store_true", default=False,
                    help="report happens-before data races in the port")


def pytest_configure(config):
    from seaweedfs_tpu_torch.util import lockcheck, racecheck

    wanted = config.getoption("--weed-lockcheck") or config.getoption("--weed-racecheck")
    distributed = (getattr(config.option, "numprocesses", None)
                   or getattr(config.option, "dist", "no") != "no"
                   or hasattr(config, "workerinput"))
    if wanted and distributed:
        raise pytest.UsageError(
            "checkers_pytest: the checkers see one process; run without -n/--dist")
    try:
        if config.getoption("--weed-lockcheck"):
            lockcheck.install()
            _active["lockcheck"] = True
        if config.getoption("--weed-racecheck"):
            racecheck.install()
            _active["racecheck"] = True
    except RuntimeError as e:
        _uninstall()
        raise pytest.UsageError(f"checkers_pytest: {e}") from None


def _uninstall() -> None:
    from seaweedfs_tpu_torch.util import lockcheck, racecheck

    if _active["racecheck"]:
        racecheck.uninstall()
    if _active["lockcheck"]:
        lockcheck.uninstall()


def pytest_sessionfinish(session, exitstatus):
    out = sys.stderr
    found = False
    if _active["lockcheck"]:
        from seaweedfs_tpu_torch.util import lockcheck

        rep = lockcheck.report()
        found |= bool(rep["cycles"])
        if rep["cycles"]:
            print("LOCKCHECK: CYCLES DETECTED (potential deadlocks):", file=out)
            for cyc in rep["cycles"]:
                print("  " + " -> ".join(cyc + [cyc[0]]), file=out)
        else:
            print("LOCKCHECK: no lock-order cycles", file=out)
        for h in rep["held_too_long"][:10]:
            print(
                f"LOCKCHECK: held-too-long {h['site']} {h['seconds']}s",
                file=out,
            )
    if _active["racecheck"]:
        from seaweedfs_tpu_torch.util import racecheck

        rep = racecheck.report()
        races = rep["races"]
        found |= bool(races)
        if races:
            print(f"RACECHECK: {len(races)} RACE(S) DETECTED:", file=out)
            for race in races[:20]:
                a, b = race["a"], race["b"]
                print(
                    f"  {race['object']}.{race['attr']} ({race['kind']}): "
                    f"{a['site'][0]}:{a['site'][1]} [{a['thread']}] vs "
                    f"{b['site'][0]}:{b['site'][1]} [{b['thread']}]",
                    file=out,
                )
        else:
            print("RACECHECK: no unsuppressed races", file=out)
        if rep["bare_directives"]:
            print(
                f"RACECHECK: {rep['bare_directives']} bare benign "
                "directive(s) (no justification — not suppressing)",
                file=out,
            )
    if found and session.exitstatus == pytest.ExitCode.OK:
        session.exitstatus = pytest.ExitCode.TESTS_FAILED


def pytest_unconfigure(config):
    _uninstall()
    _active.update(lockcheck=False, racecheck=False)
