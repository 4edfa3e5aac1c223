"""Per-plane I/O attribution: the port of seaweedfs_tpu/stats/plane.py.

A thread-local tag names the plane (serve, scrub, vacuum, ec_repair,
replication, cache_fill) that caused the work in progress, so the seams
that move bytes can bill them to it:

    weedtpu_plane_bytes_total{plane,dir}      dir: read | write
    weedtpu_plane_op_seconds_total{plane}

The default plane is "serve".  The EC rebuild runs under
``tagged(EC_REPAIR)``; code handing work to an executor wraps the callable
with ``carrying`` so the tag survives the thread hop.
"""

from __future__ import annotations

import contextlib
import threading

from seaweedfs_tpu_torch import stats

SERVE = "serve"
SCRUB = "scrub"
VACUUM = "vacuum"
EC_REPAIR = "ec_repair"
REPLICATION = "replication"
CACHE_FILL = "cache_fill"

PLANES = (SERVE, SCRUB, VACUUM, EC_REPAIR, REPLICATION, CACHE_FILL)

_tls = threading.local()


def current() -> str:
    """The calling thread's plane tag ("serve" unless inside tagged())."""
    return getattr(_tls, "plane", SERVE)


@contextlib.contextmanager
def tagged(plane: str):
    """Attribute all I/O inside the block to ``plane``."""
    if plane not in PLANES:
        raise ValueError(f"unknown plane {plane!r}")
    prev = getattr(_tls, "plane", SERVE)
    _tls.plane = plane
    try:
        yield
    finally:
        _tls.plane = prev


def carrying(fn):
    """Wrap ``fn`` so it runs under the CALLER's current plane tag."""
    plane = current()

    def run(*args, **kwargs):
        with tagged(plane):
            return fn(*args, **kwargs)

    return run


def account(nbytes: int, direction: str, seconds: float = 0.0) -> None:
    """Bill ``nbytes`` (and optionally op time) to the current plane: the
    only emission site of the weedtpu_plane_* families."""
    p = current()
    if nbytes:
        stats.PLANE_BYTES.inc(nbytes, plane=p, dir=direction)
    if seconds > 0.0:
        stats.PLANE_OP_SECONDS.inc(seconds, plane=p)


def snapshot() -> dict:
    """{plane: {"read": bytes, "write": bytes, "op_seconds": s}}."""
    out: dict[str, dict] = {}
    for key, v in stats.PLANE_BYTES.series().items():
        labels = dict(key)
        row = out.setdefault(labels.get("plane", "?"), {})
        row[labels.get("dir", "?")] = row.get(labels.get("dir", "?"), 0.0) + v
    for key, v in stats.PLANE_OP_SECONDS.series().items():
        labels = dict(key)
        out.setdefault(labels.get("plane", "?"), {})["op_seconds"] = v
    return out
