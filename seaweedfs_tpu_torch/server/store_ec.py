"""EC store operations: serve needle reads from EC shards, wherever they are.

The port's copy of seaweedfs_tpu/server/store_ec.py (reference
store_ec.go): read locally mounted shards; for missing shards look up
locations at the master (TTL-cached, store_ec.go:244-285), stream the
interval from a peer volume server (``EcShardRead``, hedged to the next
holder after ``WEED_EC_HEDGE_MS``, failing holders forgotten unless the
failure is a live holder's transient refusal), and only
when no holder answers, fan out reads of the surviving shards (local or
remote) and reconstruct the lost interval (recoverOneRemoteEcShardInterval,
store_ec.go:345-399): the LRC local plan first (group_size reads instead
of k), then the global decode through ``select.small_read_codec_for``, on
the host by design (degraded reads are latency-bound).  Every repair read
is throttled and accounted by ops/repair_budget as in the JAX package
(``weedtpu_repair_bytes_total{code,mode,dir}``).  A locator built with no
master address knows no remote holder: every missing interval is
reconstructed from the local shards.

Unlike the JAX package, a holder is not forgotten for one UNAVAILABLE
while its breaker is still closed: the read is asked once more, and
the location stays cached.  The JAX locator forgets it on any failure,
for the cache's TTL (7 min once 10 shards are located), so a single
transient refusal makes that server reconstruct every read of the
shard, and with a server down as well can leave fewer than 10 shards.
A dead holder still goes: its breaker opens after a few failures.  And
an interval that cannot gather k shards raises ShardsUnreachableError,
which the volume server answers with 503, so that the client asks the
next server holding the volume; the JAX package raises NotFoundError, a
404 that no client retries.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import grpc
import numpy as np
import torch

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.ops import repair_budget
from seaweedfs_tpu_torch.ops.rs_torch import apply_matrix_reference
from seaweedfs_tpu_torch.ops.select import small_read_codec_for
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.volume import NotFoundError
from seaweedfs_tpu_torch.util import resilience, wlog

# TTL tiers by shard-location coverage (reference store_ec.go:259-266)
_TTL_FEW = 11.0
_TTL_ENOUGH = 7 * 60.0


class ShardsUnreachableError(NotFoundError):
    """Fewer than k shards of an interval answered: the needle exists but
    cannot be read from this server now."""


class EcShardLocator:
    """Master-lookup cache + remote read + reconstruct fan-out."""

    def __init__(self, master_address: str = "", local_grpc_address: str = "", masters=None):
        self.master_address = master_address
        # the masters to ask, in order: a volume server passes the one its
        # heartbeat reaches now, then the rest of its -mserver list
        self.masters = masters or (lambda: [self.master_address])
        self.local_grpc_address = local_grpc_address
        # after this long with no answer from the primary holder, hedge
        # the same read to the next holder and take whichever lands first
        self.hedge_delay_s = float(os.environ.get("WEED_EC_HEDGE_MS", "30") or 30) / 1e3
        self._cache: dict[int, tuple[float, float, dict[int, list[str]]]] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=16)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    # -- lookups -----------------------------------------------------------

    def shard_locations(self, vid: int, fresh: bool = False) -> dict[int, list[str]]:
        """shard_id -> [grpc addresses], TTL-cached; ``fresh`` asks the
        master anew."""
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(vid)
            if hit and not fresh and now - hit[0] < hit[1]:
                return hit[2]
        req = m_pb.LookupEcVolumeRequest(volume_id=vid)
        resp = resilience.failover_call(self.masters(), lambda addr: rpc.master_stub(
            addr).LookupEcVolume(req, timeout=resilience.policy().deadline_s))
        locs = {sl.shard_id: [f"{l.url.split(':')[0]}:{l.grpc_port}" for l in sl.locations]
                for sl in resp.shard_id_locations}
        ttl = _TTL_ENOUGH if len(locs) >= 10 else _TTL_FEW
        with self._lock:
            self._cache[vid] = (now, ttl, locs)
        return locs

    def forget_shard(self, vid: int, shard_id: int, address: str) -> None:
        """Drop a dead location (reference forgetShardId, store_ec.go:237)."""
        with self._lock:
            hit = self._cache.get(vid)
            if hit and shard_id in hit[2]:
                try:
                    hit[2][shard_id].remove(address)
                except ValueError:
                    pass

    @staticmethod
    def _transient(address: str, e: Exception) -> bool:
        """A live holder's passing refusal: UNAVAILABLE while its breaker
        is closed (fewer than the policy's threshold of failures in a
        row).  An open breaker, a deadline or any other error is not."""
        br = resilience.breakers.get(address)
        return (resilience.error_code(e) is grpc.StatusCode.UNAVAILABLE and br is not None
                and br.state == "closed")

    def _holder_failed(self, vid: int, shard_id: int, address: str, e: Exception) -> None:
        """A failed interval read forgets its holder, unless the failure
        is transient: a live holder stays located."""
        if not self._transient(address, e):
            self.forget_shard(vid, shard_id, address)

    # -- interval fetch chain ----------------------------------------------

    def _holders(self, vid: int, shard_id: int) -> list[str]:
        """Remote holders of one shard, breaker-available peers first."""
        if not self.master_address:
            return []
        locs = self.shard_locations(vid)
        # iterate a copy: forget_shard mutates the cached list
        return resilience.rank_by_breaker(
            a for a in list(locs.get(shard_id, [])) if a != self.local_grpc_address)

    def make_fetcher(self, ev: EcVolume):
        """fetcher(vid, shard_id, offset, length) for EcVolume.read_interval:
        hedged remote read first, reconstruction as last resort."""

        def fetch(vid: int, shard_id: int, offset: int, length: int) -> bytes:
            addrs = self._holders(vid, shard_id)
            if addrs:
                try:
                    return self.hedged_read(vid, shard_id, addrs, offset, length)
                except Exception as e:  # noqa: BLE001 — all holders down: recover
                    if wlog.V(1):
                        wlog.info("ec: shard %d.%d unreadable from %d holders (%s), reconstructing",
                                  vid, shard_id, len(addrs), e)
            stats.EC_OPS.inc(op="reconstruct")
            stats.EC_DEGRADED_READS.inc(mode="reconstruct")
            return self.recover_interval(ev, shard_id, offset, length)

        return fetch

    def hedged_read(self, vid: int, shard_id: int, addrs: list[str], offset: int,
                    length: int) -> bytes:
        """Race the interval read across holders: the primary gets
        ``hedge_delay_s`` to answer before the next holder is asked the
        same question; first success wins, failures forget the holder
        unless transient."""
        futs: dict = {}
        launched = 0
        pending: set = set()
        last_err: Exception | None = None
        failed = 0
        while True:
            if launched < len(addrs):
                f = self._pool.submit(self.read_remote, addrs[launched], vid, shard_id, offset,
                                      length)
                futs[f] = addrs[launched]
                pending.add(f)
                launched += 1
            if not pending:
                break
            timeout = self.hedge_delay_s if launched < len(addrs) else None
            done, pending = wait(pending, timeout=timeout, return_when=FIRST_COMPLETED)
            winner, new_failures, batch_err = self._settle_batch(vid, shard_id, futs, done)
            failed += new_failures
            if batch_err is not None:
                last_err = batch_err
            if winner is not None:
                addr, data = winner
                if failed:
                    stats.EC_DEGRADED_READS.inc(mode="failover")
                elif addr != addrs[0]:
                    stats.EC_DEGRADED_READS.inc(mode="hedge")
                self._reap_losers(vid, shard_id, futs, pending)
                return data
        assert last_err is not None
        raise last_err

    def _settle_batch(self, vid: int, shard_id: int, futs: dict, done):
        """Settle one wait() wake-up, failures first: a dead holder whose
        future completed in the same batch as the winner must still be
        forgotten."""
        failures = 0
        last_err: Exception | None = None
        winner: tuple[str, bytes] | None = None
        for f in done:
            exc = f.exception()
            if exc is None:
                continue
            failures += 1
            last_err = exc
            self._holder_failed(vid, shard_id, futs[f], exc)
            if wlog.V(1):
                wlog.info("ec: shard %d.%d read from %s failed: %s", vid, shard_id, futs[f], exc)
        for f in done:
            if f.exception() is None:
                winner = (futs[f], f.result())
                break
        return winner, failures, last_err

    def _reap_losers(self, vid: int, shard_id: int, futs: dict, pending) -> None:
        """A winner returned: cancel losers still queued, and observe the
        in-flight ones in the background: a loser that fails late must
        still forget its holder."""

        def observe(f, addr: str):
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — losing hedge failed late
                self._holder_failed(vid, shard_id, addr, e)
                if wlog.V(1):
                    wlog.info("ec: losing hedge %d.%d from %s failed: %s", vid, shard_id, addr, e)

        for f in pending:
            if not f.cancel():
                f.add_done_callback(lambda fut, a=futs[f]: observe(fut, a))

    def read_remote(self, address: str, vid: int, shard_id: int, offset: int,
                    length: int) -> bytes:
        """One interval from one holder over ``EcShardRead``, asked once
        more after a transient refusal: the stub never replays a stream,
        but this one only reads, so the locator may re-issue it."""
        try:
            return self._read_remote_once(address, vid, shard_id, offset, length)
        except grpc.RpcError as e:
            if not self._transient(address, e):
                raise
            if wlog.V(1):
                wlog.info("ec: shard %d.%d read from %s refused (%s), asking again", vid,
                          shard_id, address, e)
        return self._read_remote_once(address, vid, shard_id, offset, length)

    def _read_remote_once(self, address: str, vid: int, shard_id: int, offset: int,
                          length: int) -> bytes:
        """Streams get no default deadline (some are long-lived by design),
        but a shard read must never hang a degraded read past the policy
        deadline; the stub feeds the outcome to the holder's breaker."""
        chunks = []
        for resp in rpc.volume_stub(address).EcShardRead(
                vs_pb.EcShardReadRequest(volume_id=vid, shard_id=shard_id, offset=offset,
                                         size=length),
                timeout=resilience.policy().deadline_s):
            if resp.is_deleted:
                raise NotFoundError(f"vid {vid} deleted blob")
            chunks.append(resp.data)
        data = b"".join(chunks)
        if len(data) != length:
            raise OSError(f"short remote read {len(data)} != {length} from {address}")
        return data

    def recover_interval(self, ev: EcVolume, missing_shard: int, offset: int, length: int) -> bytes:
        """Reconstruct one missing shard interval, cheapest plan first.

        For an LRC volume a group-covered shard tries its LOCAL plan before
        anything else: read the interval from its group co-members only,
        falling back to the global decode when a co-member is unreachable.
        RS (and the LRC fallback) read the same offset range from every
        other shard (local or remote, in parallel) and decode.  All traffic
        lands in weedtpu_repair_bytes_total{code,mode,dir} and is throttled
        by the WEED_REPAIR_RATE_MB budget."""
        scheme = ev.scheme
        k = scheme.data_shards
        budget = repair_budget.shared()

        local = self._recover_interval_local(ev, missing_shard, offset, length)
        if local is not None:
            return local

        def read_one(sid: int) -> tuple[int, bytes, bool] | None:
            if sid == missing_shard:
                return None
            data, remote = self._read_shard_interval(ev, sid, offset, length)
            return (sid, data, remote) if data else None

        results = [r for r in self._pool.map(read_one, range(scheme.total_shards)) if r is not None]
        if len(results) < k:
            raise ShardsUnreachableError(
                f"vid {ev.vid}: only {len(results)} shards reachable, need {k}")
        shards: list = [None] * scheme.total_shards
        for sid, data, _remote in results:
            shards[sid] = np.frombuffer(data, dtype=np.uint8)
        # scheme-aware codec: an LRC decode must rank-select independent
        # survivor rows (first-k-present can be singular off-MDS)
        rebuilt = small_read_codec_for(scheme).reconstruct(shards, targets=(missing_shard,))
        budget.throttle(len(results) * length)
        budget.account(scheme.code_name, "global", read=len(results) * length,
                       moved=sum(length for _sid, _d, remote in results if remote))
        return rebuilt[missing_shard].tobytes()

    def _read_shard_interval(self, ev: EcVolume, sid: int, offset: int,
                             length: int) -> tuple[bytes, bool]:
        """One shard's interval bytes: the local file first, then each
        remote holder in breaker order (dead holders forgotten).
        -> (data or b"", fetched remotely)."""
        shard = ev.shards.get(sid)
        if shard is not None:
            try:
                data = shard.read_at(offset, length)
            except OSError as e:
                if wlog.V(1):
                    wlog.info("ec: local shard %d.%d read failed: %s", ev.vid, sid, e)
                data = b""
            if len(data) == length:
                return data, False
        for addr in self._holders(ev.vid, sid):
            try:
                return self.read_remote(addr, ev.vid, sid, offset, length), True
            except Exception as e:  # noqa: BLE001 — try the next holder
                if wlog.V(1):
                    wlog.info("ec: shard %d.%d read from %s failed: %s", ev.vid, sid, addr, e)
                self._holder_failed(ev.vid, sid, addr, e)
        return b"", False

    def _recover_interval_local(self, ev: EcVolume, missing_shard: int, offset: int,
                                length: int) -> bytes | None:
        """The LRC local plan: rebuild the interval from the missing shard's
        group co-members only.  None when the scheme has no local plan for
        this shard or a co-member read fails (callers fall back to the
        global decode)."""
        scheme = ev.scheme
        try:
            mat, inputs, mode = scheme.repair_plan(
                tuple(i != missing_shard for i in range(scheme.total_shards)), (missing_shard,))
        except ValueError:
            return None
        if mode != "local":
            return None
        # parallel like the global fan-out: degraded reads are latency-bound
        results = list(self._pool.map(
            lambda sid: (sid, *self._read_shard_interval(ev, sid, offset, length)), inputs))
        got = {sid: data for sid, data, _ in results if len(data) == length}
        moved = sum(length for _sid, data, remote in results if remote and len(data) == length)
        budget = repair_budget.shared()
        # bytes read count even when the plan is abandoned: the global
        # fallback re-reads on top of them
        budget.throttle(len(got) * length)
        budget.account(scheme.code_name, "local", read=len(got) * length, moved=moved)
        if len(got) != len(inputs):
            if wlog.V(1):
                wlog.info("ec: vid %d shard %d local plan abandoned (co-members %s unreachable), "
                          "falling back to global decode",
                          ev.vid, missing_shard, sorted(set(inputs) - set(got)))
            return None
        rows = torch.from_numpy(np.stack([np.frombuffer(got[sid], dtype=np.uint8) for sid in inputs]))
        return apply_matrix_reference(np.asarray(mat), rows)[0].numpy().tobytes()
