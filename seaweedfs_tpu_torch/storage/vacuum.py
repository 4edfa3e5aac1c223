"""Background auto-vacuum: compact volumes whose garbage crosses a
threshold, without an operator running ``volume.vacuum`` in the shell.

The port's copy of seaweedfs_tpu/storage/vacuum.py.  Delete churn leaves
tombstoned and overwritten bytes in .dat files; ``Volume.garbage_ratio``
tracks them incrementally.  Two knobs, the same shape as the scrubber's:

* ``WEED_VACUUM_INTERVAL_S``: seconds between passes (0 = disabled, the
  default: vacuum stays an explicit operation unless asked for).
* ``WEED_VACUUM_GARBAGE``: the garbage ratio a volume must reach before a
  pass compacts it (default 0.3, upstream's ``-garbageThreshold``).

Each pass walks the store's mounted volumes and calls ``Volume.vacuum``
(which bills its copy I/O to the ``vacuum`` plane).  ``on_volume_done(vol)``
fires after a successful compaction so the server can enqueue a heartbeat
delta: the master's size view follows the swap.  :func:`snapshot` gives
every live loop's state (``/debug/vacuum`` on the volume server).
"""

from __future__ import annotations

import os
import threading
import time
import weakref

from seaweedfs_tpu_torch.storage.needle import NeedleError
from seaweedfs_tpu_torch.util import wlog

_active: "weakref.WeakSet[AutoVacuum]" = weakref.WeakSet()


def snapshot() -> list[dict]:
    """All live auto-vacuum loops' states (for /debug/vacuum)."""
    return [v.snapshot() for v in list(_active)]


class AutoVacuum:
    """Periodic garbage-threshold compaction over one Store's volumes."""

    def __init__(self, store, interval_s: float | None = None,
                 garbage_threshold: float | None = None, on_volume_done=None):
        self.store = store
        if interval_s is None:
            interval_s = float(os.environ.get("WEED_VACUUM_INTERVAL_S", "0") or 0)
        if garbage_threshold is None:
            garbage_threshold = float(os.environ.get("WEED_VACUUM_GARBAGE", "0.3") or 0.3)
        self.interval_s = interval_s
        self.garbage_threshold = garbage_threshold
        self.on_volume_done = on_volume_done
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._passes = 0
        self._vacuumed = 0
        self._reclaimed_bytes = 0
        self._last_pass_ns = 0
        self._last_errors: dict[int, str] = {}  # vid -> last failure
        _active.add(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="auto-vacuum")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        next_pass = time.monotonic() + self.interval_s
        while not self._stop.is_set():
            self._stop.wait(1.0)
            if time.monotonic() >= next_pass:
                try:
                    self.vacuum_pass()
                except Exception as e:  # noqa: BLE001 — the loop must outlive one bad pass
                    wlog.warning("vacuum: pass failed: %s", e)
                next_pass = time.monotonic() + self.interval_s

    # -- passes ------------------------------------------------------------

    def vacuum_pass(self) -> list[dict]:
        """One pass: compact every mounted volume at or over the garbage
        threshold.  Returns per-volume results (also kept for
        :meth:`snapshot`)."""
        out = []
        for loc in self.store.locations:
            with loc.lock:
                vols = list(loc.volumes.values())
            for vol in vols:
                if self._stop.is_set():
                    return out
                ratio = vol.garbage_ratio()
                if ratio < self.garbage_threshold:
                    continue
                try:
                    reclaimed = vol.vacuum()  # plane-tagged inside
                except (NeedleError, OSError) as e:
                    wlog.warning("vacuum: volume %d failed: %s", vol.id, e)
                    with self._lock:
                        self._last_errors[vol.id] = str(e)
                    continue
                with self._lock:
                    self._vacuumed += 1
                    self._reclaimed_bytes += reclaimed
                    self._last_errors.pop(vol.id, None)
                wlog.info("vacuum: volume %d compacted (garbage %.2f, reclaimed %d bytes)",
                          vol.id, ratio, reclaimed)
                out.append({"vid": vol.id, "garbage": ratio, "reclaimed": reclaimed})
                if self.on_volume_done is not None:
                    self.on_volume_done(vol)
        with self._lock:
            self._passes += 1
            self._last_pass_ns = time.monotonic_ns()
        return out

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "garbage_threshold": self.garbage_threshold,
                "passes": self._passes,
                "volumes_vacuumed": self._vacuumed,
                "reclaimed_bytes": self._reclaimed_bytes,
                "last_pass_ns": self._last_pass_ns,
                "errors": dict(self._last_errors),
            }
