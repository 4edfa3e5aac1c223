"""EC store operations: serve needle reads from EC shards, rebuilding the
intervals of missing shards from the local survivors.

The local half of seaweedfs_tpu/server/store_ec.py (reference
store_ec.go: recoverOneRemoteEcShardInterval, :345-399): a read of a shard
that is not mounted is reconstructed from the shards that are, the LRC
local plan first (group_size reads instead of k), then the global decode
through ``select.small_read_codec_for``, on the host by design (degraded
reads are latency-bound).  Every repair read is throttled and accounted
by ops/repair_budget as in the JAX package
(``weedtpu_repair_bytes_total{code,mode,dir}``).  The remote half (the
master's shard locations, hedged reads from peer servers,
``forget_shard``) is not ported: with no remote holder, a missing interval
goes straight to reconstruction, as the JAX locator does when the master
knows no holder.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import repair_budget
from seaweedfs_tpu_torch.ops.rs_torch import apply_matrix_reference
from seaweedfs_tpu_torch.ops.select import small_read_codec_for
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.volume import NotFoundError
from seaweedfs_tpu_torch.util import wlog


class EcShardLocator:
    """Reconstruction fan-out for the intervals of missing shards."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=16)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def make_fetcher(self, ev: EcVolume):
        """fetcher(vid, shard_id, offset, length) for EcVolume.read_interval:
        reconstruction of the interval from the local survivors."""

        def fetch(vid: int, shard_id: int, offset: int, length: int) -> bytes:
            stats.EC_OPS.inc(op="reconstruct")
            stats.EC_DEGRADED_READS.inc(mode="reconstruct")
            return self.recover_interval(ev, shard_id, offset, length)

        return fetch

    def recover_interval(self, ev: EcVolume, missing_shard: int, offset: int, length: int) -> bytes:
        """Reconstruct one missing shard interval, cheapest plan first.

        For an LRC volume a group-covered shard tries its LOCAL plan before
        anything else: read the interval from its group co-members only,
        falling back to the global decode when a co-member is missing.  RS
        (and the LRC fallback) read the same offset range from every other
        shard at hand (in parallel) and decode.  All traffic lands in
        weedtpu_repair_bytes_total{code,mode,dir} and is throttled by the
        WEED_REPAIR_RATE_MB budget."""
        scheme = ev.scheme
        k = scheme.data_shards
        budget = repair_budget.shared()

        local = self._recover_interval_local(ev, missing_shard, offset, length)
        if local is not None:
            return local

        def read_one(sid: int) -> tuple[int, bytes] | None:
            if sid == missing_shard:
                return None
            data = self._read_shard_interval(ev, sid, offset, length)
            return (sid, data) if data else None

        results = [r for r in self._pool.map(read_one, range(scheme.total_shards)) if r is not None]
        if len(results) < k:
            raise NotFoundError(f"vid {ev.vid}: only {len(results)} shards reachable, need {k}")
        shards: list = [None] * scheme.total_shards
        for sid, data in results:
            shards[sid] = np.frombuffer(data, dtype=np.uint8)
        # scheme-aware codec: an LRC decode must rank-select independent
        # survivor rows (first-k-present can be singular off-MDS)
        rebuilt = small_read_codec_for(scheme).reconstruct(shards, targets=(missing_shard,))
        budget.throttle(len(results) * length)
        budget.account(scheme.code_name, "global", read=len(results) * length)
        return rebuilt[missing_shard].tobytes()

    def _read_shard_interval(self, ev: EcVolume, sid: int, offset: int, length: int) -> bytes:
        """One shard's interval bytes from its local file; b"" when the
        shard is not mounted or the read fails or comes up short."""
        shard = ev.shards.get(sid)
        if shard is None:
            return b""
        try:
            data = shard.read_at(offset, length)
        except OSError as e:
            if wlog.V(1):
                wlog.info("ec: local shard %d.%d read failed: %s", ev.vid, sid, e)
            return b""
        return data if len(data) == length else b""

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
            lambda sid: (sid, self._read_shard_interval(ev, sid, offset, length)), inputs))
        got = {sid: data for sid, data in results if len(data) == length}
        budget = repair_budget.shared()
        # bytes read count even when the plan is abandoned: the global
        # fallback re-reads on top of them
        budget.throttle(len(got) * length)
        budget.account(scheme.code_name, "local", read=len(got) * length)
        if len(got) != len(inputs):
            if wlog.V(1):
                wlog.info("ec: vid %d shard %d local plan abandoned (co-members %s unreachable), "
                          "falling back to global decode",
                          ev.vid, missing_shard, sorted(set(inputs) - set(got)))
            return None
        rows = torch.from_numpy(np.stack([np.frombuffer(got[sid], dtype=np.uint8) for sid in inputs]))
        return apply_matrix_reference(np.asarray(mat), rows)[0].numpy().tobytes()
