"""Background scrubber: find silent disk corruption before readers do.

The port's copy of seaweedfs_tpu/storage/scrub.py.  The volume server
runs a bounded-rate background walk that CRC-verifies every live needle
of every volume (and every needle reachable through its locally held EC
shards), repairs what it can, and feeds the result into the heartbeat so
the master's health view follows it.

Repair sources, in order of preference:

* **replica**: the raw on-disk record is fetched from another holder of
  the same volume (``ReadNeedleBlob``), CRC-verified, and written back over
  the corrupt record in place: a byte-exact restore that works on sealed
  volumes too.
* **EC reconstruction**: a corrupt local shard interval is rebuilt from
  the other shards, through ``EcShardLocator.recover_interval`` (local or
  remote holders; an LRC shard tries its local group first) or, with no
  locator, from the locally mounted shards alone (:func:`_reconstruct_local`,
  the scheme's repair plan), and pwritten back into the shard file.  The
  decode runs on the host small-read codec (``select.small_read_codec_for``),
  not on the card: one interval is at most a 1 MiB block, a latency-bound
  job that a device round trip would only slow down.  Repair reads and
  moves are billed to the repair budget, under the ``scrub`` plane tag.

Everything is observable: the ``weedtpu_scrub_*`` and
``weedtpu_disk_corruption_total`` metrics, the flight recorder's
``scrub.*`` events, :func:`snapshot` (``/debug/scrub``), the
``volume.scrub`` shell command (the VolumeScrub RPC) and
``last_scrub_ns``/``scrub_corrupt`` on the heartbeat's VolumeStat.  A
read-path CrcMismatch calls :meth:`VolumeScrubber.flag`, and the scrub
thread repairs that needle on its next 1-second tick.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

import numpy as np

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import repair_budget
from seaweedfs_tpu_torch.ops.select import small_read_codec_for
from seaweedfs_tpu_torch.stats import events, plane
from seaweedfs_tpu_torch.storage.backend import DiskFile
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import _read_entry
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError
from seaweedfs_tpu_torch.storage.types import get_actual_size, size_is_deleted, size_is_valid
from seaweedfs_tpu_torch.storage.volume import NotFoundError
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.limiter import TokenBucket

_active: "weakref.WeakSet[VolumeScrubber]" = weakref.WeakSet()


def snapshot() -> list[dict]:
    """All live scrubbers' states (for /debug/scrub)."""
    return [s.snapshot() for s in list(_active)]


def _reconstruct_local(ev, missing_sid: int, offset: int, length: int, wait=None) -> bytes:
    """Rebuild one shard interval from locally mounted shards only (the
    repair path when no EcShardLocator is wired in).

    Plan-driven "read only what you rebuild": the scheme decides which
    survivors feed the math (an LRC group-covered shard reads just its
    local group, RS any k), and only those intervals are read.  Traffic is
    budget-throttled and accounted per storage class."""
    scheme = ev.scheme
    usable = {sid for sid in ev.shards if sid != missing_sid}
    shards: list = [None] * scheme.total_shards
    bytes_read = 0
    # survivor substitution: a short-reading plan input is excluded and
    # the plan recomputed over the rest; each round removes one shard, so
    # this terminates
    while True:
        local = tuple(sid in usable for sid in range(scheme.total_shards))
        try:
            _mat, inputs, mode = scheme.repair_plan(local, (missing_sid,))
        except ValueError as e:
            raise IOError(f"vid {ev.vid}: local shards cannot rebuild shard {missing_sid}: {e}") from e
        short = None
        for sid in inputs:
            if shards[sid] is not None:
                continue  # read in an earlier round
            try:
                data = ev.shards[sid].read_at(offset, length)
            except OSError as e:  # a bad sector is not unrepairable: substitute
                wlog.warning("scrub: shard %d.%d interval read failed (%s), substituting a spare "
                             "survivor", ev.vid, sid, e)
                data = b""
            if len(data) != length:
                short = sid
                break
            bytes_read += length
            shards[sid] = np.frombuffer(data, dtype=np.uint8)
        if short is None:
            break
        usable.discard(short)
    budget = repair_budget.shared()
    budget.throttle(bytes_read, wait=wait)
    budget.account(scheme.code_name, mode, read=bytes_read)
    plan_view: list = [None] * scheme.total_shards
    for sid in inputs:
        plan_view[sid] = shards[sid]
    codec = small_read_codec_for(scheme)
    return codec.reconstruct(plan_view, targets=(missing_sid,))[missing_sid].tobytes()


class VolumeScrubber:
    """Bounded-rate CRC walk + repair over one Store's volumes.

    ``replica_fetcher(vid, collection, needle_id, size)`` returns the raw
    on-disk record of the needle from another replica holder (or None):
    the volume server wires it to a master lookup and a peer's
    ReadNeedleBlob.  ``ec_locator`` is an EcShardLocator (or None for
    local-only reconstruction).  ``on_volume_done(vol)`` fires after each
    volume pass so the server can enqueue a heartbeat delta.
    """

    def __init__(self, store, rate_mb_s: float | None = None, interval_s: float | None = None,
                 replica_fetcher=None, ec_locator=None, on_volume_done=None):
        self.store = store
        if rate_mb_s is None:
            rate_mb_s = float(os.environ.get("WEED_SCRUB_RATE_MB", "32") or 32)
        if interval_s is None:
            interval_s = float(os.environ.get("WEED_SCRUB_INTERVAL", "600") or 600)
        self.rate_bytes_s = rate_mb_s * 1024 * 1024
        self.interval_s = interval_s
        self.replica_fetcher = replica_fetcher
        self.ec_locator = ec_locator
        self.on_volume_done = on_volume_done
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # read-path flags: (vid, needle_id) pairs repaired on the next tick.
        # A set, not a queue: a hot corrupt needle read 100x/s must become
        # one repair attempt, not a repair-RPC storm
        self._flagged: set[tuple[int, int]] = set()
        self._lock = threading.Lock()
        # (vid, nid) pairs a repair attempt failed for: not retried per tick
        # (the next full pass retries); sized per volume into the
        # heartbeat's scrub_corrupt so one needle counts once
        self._known_corrupt: set[tuple[int, int]] = set()
        self._results: dict[int, dict] = {}  # vid -> last pass result
        self._passes = 0
        self._last_pass_ns = 0
        # token bucket (1 s burst) over bytes verified: a foreground
        # VolumeScrub RPC and the background pass share the rate bound,
        # and the stop event interrupts throttle sleeps
        self._bucket = TokenBucket(self.rate_bytes_s)
        _active.add(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="volume-scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def flag(self, vid: int, needle_id: int) -> None:
        """The read path found a corrupt needle: repair it on the next
        tick.  Deduplicated; a needle whose repair already failed waits
        for the next full pass instead of hammering the replicas per read."""
        pair = (vid, needle_id)
        with self._lock:
            if pair not in self._known_corrupt:
                self._flagged.add(pair)

    def _loop(self) -> None:
        next_pass = time.monotonic() + self.interval_s
        while not self._stop.is_set():
            self._stop.wait(1.0)
            self._drain_flagged()
            if self.interval_s > 0 and time.monotonic() >= next_pass:
                try:
                    self.scrub_all()
                except Exception as e:  # noqa: BLE001 — scrub must outlive one bad pass
                    wlog.warning("scrub: pass failed: %s", e)
                next_pass = time.monotonic() + self.interval_s

    def _drain_flagged(self) -> None:
        with self._lock:
            batch, self._flagged = self._flagged, set()
        if not batch:
            return
        with plane.tagged(plane.SCRUB):
            self._repair_flagged(batch)

    def _local_fetcher(self, ev):
        """read_interval's fetcher shape (vid, shard_id, offset, length)
        over the locally mounted shards."""
        return lambda _vid, sid, off, ln: _reconstruct_local(ev, sid, off, ln, wait=self._stop.wait)

    def _repair_flagged(self, batch: set[tuple[int, int]]) -> None:
        for vid, nid in sorted(batch):
            vol = self.store.find_volume(vid)
            ev = self.store.find_ec_volume(vid) if vol is None else None
            if vol is not None:
                fixed = self._repair_needle(vol, nid)
            elif ev is not None:
                fetcher = (self.ec_locator.make_fetcher(ev) if self.ec_locator is not None
                           else self._local_fetcher(ev))
                fixed = self._repair_ec_needle(ev, nid, fetcher)
            else:
                continue  # volume unmounted since the flag
            wlog.info("scrub: read-path flagged needle %x in volume %d: %s", nid, vid,
                      "repaired" if fixed else "NOT repaired")
            if not fixed:
                with self._lock:
                    self._known_corrupt.add((vid, nid))
                if vol is not None:
                    self._publish_corrupt_count(vol)

    def _publish_corrupt_count(self, vol) -> None:
        """scrub_corrupt counts DISTINCT known-corrupt needles (one hot
        needle read 100x is still one corrupt needle)."""
        with self._lock:
            count = sum(1 for v, _ in self._known_corrupt if v == vol.id)
        with vol._acct_lock:
            vol.scrub_corrupt = count
        if self.on_volume_done is not None:
            self.on_volume_done(vol)

    # -- rate bound --------------------------------------------------------

    def _throttle(self, nbytes: int) -> None:
        self._bucket.throttle(nbytes, wait=self._stop.wait)

    # -- passes ------------------------------------------------------------

    def scrub_all(self, repair: bool = True) -> list[dict]:
        out = []
        for loc in self.store.locations:
            with loc.lock:
                vols = list(loc.volumes.values())
                evs = list(loc.ec_volumes.values())
            for vol in vols:
                if self._stop.is_set():
                    return out
                out.append(self.scrub_volume(vol, repair=repair))
            for ev in evs:
                if self._stop.is_set():
                    return out
                out.append(self.scrub_ec_volume(ev, repair=repair))
        self._passes += 1
        self._last_pass_ns = time.time_ns()
        return out

    def scrub_volume(self, vol, repair: bool = True) -> dict:
        """CRC-verify every live needle of one plain volume."""
        # every backend read and replica fetch below bills to the scrub
        # plane; foreground traffic keeps billing to serve
        with plane.tagged(plane.SCRUB):
            return self._scrub_volume(vol, repair)

    def _scrub_volume(self, vol, repair: bool) -> dict:
        with vol._write_lock:  # MemDb is a bare dict guarded by the write lock
            keys = [nv.key for nv in vol.nm.db.values()]
        scanned = corrupt = repaired = 0
        failed_keys = []
        for key in keys:
            if self._stop.is_set():
                break
            # re-resolve per needle: a concurrent vacuum swaps offsets
            nv = vol.nm.get(key)
            if nv is None or not size_is_valid(nv.size):
                continue
            size = get_actual_size(nv.size, vol.version)
            self._throttle(size)
            scanned += 1
            stats.SCRUB_BYTES.inc(size)
            if self._record_ok(vol, key, nv):
                stats.SCRUB_NEEDLES.inc(result="ok")
                continue
            stats.SCRUB_NEEDLES.inc(result="corrupt")
            stats.DISK_CORRUPTION.inc(path="scrub")
            events.record(events.SCRUB_CORRUPTION, volume=vol.id, needle=format(key, "x"), ec=False)
            corrupt += 1
            if repair and self._repair_needle(vol, key):
                repaired += 1
            else:
                failed_keys.append(key)
        failed = corrupt - repaired
        with self._lock:
            # a full pass is the authority on this volume's corrupt set
            self._known_corrupt = ({p for p in self._known_corrupt if p[0] != vol.id}
                                   | {(vol.id, k) for k in failed_keys})
        with vol._acct_lock:
            vol.scrub_corrupt = failed
            vol.last_scrub_at_ns = time.time_ns()
        stats.SCRUB_PASSES.inc(kind="volume")
        result = dict(volume_id=vol.id, ec=False, scanned=scanned, corrupt=corrupt,
                      repaired=repaired, failed=failed)
        with self._lock:
            self._results[vol.id] = result
        if corrupt:
            wlog.warning("scrub: volume %d: %d corrupt, %d repaired, %d FAILED", vol.id, corrupt,
                         repaired, failed)
        if self.on_volume_done is not None:
            self.on_volume_done(vol)
        return result

    def _record_ok(self, vol, key: int, nv) -> bool:
        buf = vol._pread(nv.offset, get_actual_size(nv.size, vol.version))
        try:
            n = Needle.from_bytes(buf, vol.version)
        except NeedleError:
            return False
        return n.id == key

    def _repair_needle(self, vol, key: int) -> bool:
        """In-place byte-exact restore of one needle from a replica.
        Returns True when the record is healthy afterwards (including "it
        was deleted or rewritten meanwhile" and "false alarm")."""
        nv = vol.nm.get(key)
        if nv is None or not size_is_valid(nv.size):
            return True  # deleted under us: nothing to repair
        # second opinion under the write lock: the first read may have
        # raced a vacuum swap
        with vol._write_lock:
            nv = vol.nm.get(key)
            if nv is None or not size_is_valid(nv.size):
                return True
            if self._record_ok(vol, key, nv):
                return True
        if self.replica_fetcher is None:
            stats.SCRUB_REPAIRS.inc(source="replica", outcome="unavailable")
            return False
        want = get_actual_size(nv.size, vol.version)
        try:
            record = self.replica_fetcher(vol.id, vol.collection, key, nv.size)
        except Exception as e:  # noqa: BLE001 — peer trouble is not a scrub crash
            wlog.warning("scrub: replica fetch of %x in volume %d failed: %s", key, vol.id, e)
            record = None
        if record is None or len(record) != want:
            stats.SCRUB_REPAIRS.inc(source="replica", outcome="unavailable")
            return False
        try:
            peer = Needle.from_bytes(record, vol.version)  # CRC-verified
        except NeedleError as e:
            wlog.warning("scrub: replica copy of %x in volume %d is corrupt too: %s", key,
                         vol.id, e)
            stats.SCRUB_REPAIRS.inc(source="replica", outcome="peer_corrupt")
            return False
        if peer.id != key:
            stats.SCRUB_REPAIRS.inc(source="replica", outcome="peer_corrupt")
            return False
        # cross-server repair traffic: the whole record moved from a
        # replica holder (budget-throttled like EC reconstruction reads)
        budget = repair_budget.shared()
        budget.throttle(len(record), wait=self._stop.wait)
        budget.account("volume", "replica", read=len(record), moved=len(record))
        with vol._write_lock:
            now = vol.nm.get(key)
            if now is None or (now.offset, now.size) != (nv.offset, nv.size):
                return True  # overwritten or deleted while we fetched
            vol._dat.write_at(nv.offset, record)
            vol._dat.sync()  # a repair that can evaporate is no repair
        stats.SCRUB_REPAIRS.inc(source="replica", outcome="fixed")
        events.record(events.SCRUB_REPAIRED, volume=vol.id, needle=format(key, "x"),
                      source="replica")
        wlog.info("scrub: repaired needle %x in volume %d from replica", key, vol.id)
        return True

    # -- EC volumes --------------------------------------------------------

    def scrub_ec_volume(self, ev, repair: bool = True) -> dict:
        """Verify every needle reachable through this EC volume's index;
        repair corrupt LOCAL shard intervals by reconstruction."""
        with plane.tagged(plane.SCRUB):
            return self._scrub_ec_volume(ev, repair)

    def _scrub_ec_volume(self, ev, repair: bool) -> dict:
        fetcher = (self.ec_locator.make_fetcher(ev) if self.ec_locator is not None
                   else self._local_fetcher(ev))
        scanned = corrupt = repaired = 0
        failed_keys, recheck = [], []
        total = ev.ecx_size // ev.entry_size
        for i in range(total):
            if self._stop.is_set():
                break
            key, _offset, size = _read_entry(ev._ecx.fileno(), ev.entry_size, i)
            if size_is_deleted(size):
                continue
            rec_size = get_actual_size(size, ev.version)
            self._throttle(rec_size)
            scanned += 1
            stats.SCRUB_BYTES.inc(rec_size)
            try:
                ok = ev.read_needle(key, fetcher).id == key
            except NeedleError:
                ok = False
            except (IOError, KeyError) as e:
                wlog.warning("scrub: ec volume %d needle %x unreadable: %s", ev.vid, key, e)
                continue  # unreachable is not corrupt on local media
            if ok:
                stats.SCRUB_NEEDLES.inc(result="ok")
                continue
            if repair and self._repair_ec_needle(ev, key, fetcher):
                self._count_ec_corrupt(ev, key)
                corrupt += 1
                repaired += 1
            else:
                recheck.append(key)
        if recheck:
            # A needle still corrupt here may be corrupt on another holder's
            # shard, which that holder's own scrubber (running at the same
            # time under volume.scrub) rewrites moments later.  Re-read each
            # once, at the end of the pass, with fresh shard locations, and
            # count it only if it is still corrupt.
            if self.ec_locator is not None:
                try:
                    self.ec_locator.shard_locations(ev.vid, fresh=True)
                except Exception as e:  # noqa: BLE001 — the cached locations stand
                    wlog.warning("scrub: ec volume %d: no fresh locations: %s", ev.vid, e)
            for key in recheck:
                try:
                    ok = ev.read_needle(key, fetcher).id == key
                except NeedleError:
                    ok = False
                except (IOError, KeyError) as e:
                    # deleted or unreachable meanwhile: as in the pass
                    wlog.warning("scrub: ec volume %d needle %x unreadable: %s", ev.vid, key, e)
                    continue
                if ok:
                    stats.SCRUB_NEEDLES.inc(result="ok")
                    continue
                self._count_ec_corrupt(ev, key)
                corrupt += 1
                failed_keys.append(key)
        with self._lock:
            self._known_corrupt = ({p for p in self._known_corrupt if p[0] != ev.vid}
                                   | {(ev.vid, k) for k in failed_keys})
        stats.SCRUB_PASSES.inc(kind="ec")
        result = dict(volume_id=ev.vid, ec=True, scanned=scanned, corrupt=corrupt,
                      repaired=repaired, failed=corrupt - repaired)
        with self._lock:
            self._results[ev.vid] = result
        if corrupt:
            wlog.warning("scrub: ec volume %d: %d corrupt, %d repaired", ev.vid, corrupt, repaired)
        return result

    @staticmethod
    def _count_ec_corrupt(ev, key: int) -> None:
        stats.SCRUB_NEEDLES.inc(result="corrupt")
        stats.DISK_CORRUPTION.inc(path="scrub")
        events.record(events.SCRUB_CORRUPTION, volume=ev.vid, needle=format(key, "x"), ec=True)

    def _repair_ec_needle(self, ev, key: int, fetcher) -> bool:
        """Rebuild the corrupt local shard interval(s) of one EC needle
        from the other shards, pwrite them back, re-verify."""
        try:
            _, _, intervals = ev.locate(key)
        except NotFoundError:
            return True  # deleted meanwhile
        touched = False
        for iv in intervals:
            sid, shard_off = iv.to_shard_and_offset(ev.scheme)
            shard = ev.shards.get(sid)
            if shard is None:
                continue  # not our media; the holder's scrubber repairs it
            local = shard.read_at(shard_off, iv.size)
            try:
                if self.ec_locator is not None:
                    rebuilt = self.ec_locator.recover_interval(ev, sid, shard_off, iv.size)
                else:
                    rebuilt = _reconstruct_local(ev, sid, shard_off, iv.size, wait=self._stop.wait)
            except Exception as e:  # noqa: BLE001 — fewer than k shards reachable
                wlog.warning("scrub: cannot reconstruct shard %d.%d interval: %s", ev.vid, sid, e)
                continue
            if rebuilt != local:
                # through the backend: short-write-safe pwrite loop and a
                # durable sync, the same contract as .dat repairs
                bf = DiskFile(shard.path, create=False)
                try:
                    bf.write_at(shard_off, rebuilt)
                    bf.sync()
                finally:
                    bf.close()
                touched = True
                wlog.info("scrub: rewrote %d corrupt bytes of shard %d.%d at %d", len(rebuilt),
                          ev.vid, sid, shard_off)
        try:
            ok = ev.read_needle(key, fetcher).id == key
        except (NeedleError, IOError, KeyError):
            ok = False
        stats.SCRUB_REPAIRS.inc(source="ec_reconstruct",
                                outcome="fixed" if ok else ("dirty" if touched else "unavailable"))
        if ok and touched:
            events.record(events.SCRUB_REPAIRED, volume=ev.vid, needle=format(key, "x"),
                          source="ec_reconstruct")
            wlog.info("scrub: repaired ec needle %x in volume %d by reconstruction", key, ev.vid)
        return ok

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            results = dict(self._results)
        return {
            "rate_mb_s": self.rate_bytes_s / 1024 / 1024,
            "interval_s": self.interval_s,
            "passes": self._passes,
            "last_pass_ns": self._last_pass_ns,
            "flagged_pending": len(self._flagged),
            "known_corrupt": len(self._known_corrupt),
            "volumes": results,
        }
