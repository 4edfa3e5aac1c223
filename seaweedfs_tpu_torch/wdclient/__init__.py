"""Client-side master connection with a volume-id -> locations cache: the
port of seaweedfs_tpu/wdclient's ``MasterClient`` and ``AssignError``.

Counterpart of the reference's wdclient (weed/wdclient/masterclient.go,
vid_map.go): callers assign fids and resolve them to volume-server URLs
through a local cache kept fresh by TTL expiry and explicit invalidation.
Lookups populate lazily via LookupVolume and expire on a short TTL.  A
comma-separated master list (HA) fails over on connection errors through
util/resilience.failover_call, like the reference's KeepConnectedToMaster
rotation (wdclient/masterclient.go:134).

``sign_write`` mints a per-fid write token when the cluster signs writes
(``jwt_key`` or ``$WEED_JWT_KEY``).  Batch assigns (``assign_batch``,
``assign_batch_located``: one Assign covering ``count`` fids by the
``fid_N`` convention), the read path's failover order (``lookup_urls``,
``forget_location``) and the EC shard-location cache
(``lookup_ec_shards``, vid_map.go:192 addEcLocation) serve the filer.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.security import sign_fid
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.util import resilience, wlog


class AssignError(RuntimeError):
    pass


class FailoverStub:
    """A master stub over a master list: each RPC runs through
    ``resilience.failover_call``, so connection-class failures rotate the
    masters with jittered backoff between full rotations, peers with open
    breakers go last, and application errors (PERMISSION_DENIED, ...) are
    the answer and raise at once.  With peers to rotate to, each master
    gets one attempt (``wd_max_attempts=1``: rotation is the retry, and
    the stub's own policy must not retry underneath it); a lone master
    keeps the stub's full retry budget.  ``holder`` is any object whose
    ``master_address`` is tried first and follows the master that last
    answered (the port's ``MasterClient._FailoverStub`` and the shell's
    master list share it)."""

    def __init__(self, holder, addresses: list[str]):
        self._holder = holder
        self._addresses = addresses

    def __getattr__(self, rpc_name: str):
        holder, addresses = self._holder, self._addresses

        def call(request):
            addrs = [holder.master_address] + [a for a in addresses
                                               if a != holder.master_address]
            per_peer = 1 if len(addrs) > 1 else None

            def call_at(addr: str):
                # the stub runs the policy (deadline, breaker, eviction)
                return getattr(rpc.master_stub(addr), rpc_name)(request,
                                                                wd_max_attempts=per_peer)

            def on_success(addr: str) -> None:
                holder.master_address = addr

            return resilience.failover_call(addrs, call_at, on_success=on_success)

        return call


class MasterClient:
    """Assign and lookup against the masters, with a TTL'd vid -> locations
    cache.  ``master_address`` is one master's gRPC address or a
    comma-separated list of them (HA)."""

    def __init__(self, master_address: str, cache_ttl: float = 10.0, jwt_key: str = ""):
        self.jwt_key = jwt_key or os.environ.get("WEED_JWT_KEY", "")
        self.master_addresses = [a.strip() for a in master_address.split(",") if a.strip()]
        self.master_address = self.master_addresses[0]
        self.cache_ttl = cache_ttl
        self._lock = threading.Lock()
        self._vid_cache: dict[int, tuple[float, list[str]]] = {}  # vid -> (expiry, urls)
        # vid -> (expiry, {shard_id: [url, ...]})
        self._ec_cache: dict[int, tuple[float, dict[int, list[str]]]] = {}

    @property
    def _stub(self) -> FailoverStub:
        return FailoverStub(self, self.master_addresses)

    def sign_write(self, fid: str) -> str:
        """A fresh per-fid write token, or "" when the cluster does not
        sign writes."""
        if not self.jwt_key:
            return ""
        return sign_fid(self.jwt_key, fid)

    def assign(self, count: int = 1, collection: str = "", replication: str = "",
               ttl_seconds: int = 0, disk_type: str = "",
               writable_volume_count: int = 0) -> m_pb.AssignResponse:
        # a client span only when the caller is already traced: assign is
        # cluster-internal chatter otherwise (the context itself rides
        # every stub call as gRPC metadata)
        ctx = trace.current()
        span = (trace.span("assign", service="master_client", parent=ctx)
                if ctx is not None else contextlib.nullcontext())
        with span:
            resp = self._stub.Assign(m_pb.AssignRequest(
                count=count, collection=collection, replication=replication,
                ttl_seconds=ttl_seconds, disk_type=disk_type,
                writable_volume_count=writable_volume_count))
        if resp.error:
            raise AssignError(resp.error)
        return resp

    def assign_batch(self, count: int, *, collection: str = "", replication: str = "",
                     ttl_seconds: int = 0, disk_type: str = "",
                     writable_volume_count: int = 0) -> list[tuple[str, str, str]]:
        """One Assign RPC covering ``count`` fids via the ``fid_N``
        convention (the master reserves ``count`` sequential keys;
        derivatives share the base fid's cookie and locations, and the
        base fid's write token covers them).  Returns [(fid, url, auth),
        ...] in write order."""
        return [t[:3] for t in self.assign_batch_located(
            count, collection=collection, replication=replication, ttl_seconds=ttl_seconds,
            disk_type=disk_type, writable_volume_count=writable_volume_count)]

    def assign_batch_located(self, count: int, *, collection: str = "", replication: str = "",
                             ttl_seconds: int = 0, disk_type: str = "",
                             writable_volume_count: int = 0
                             ) -> list[tuple[str, str, str, tuple[str, ...]]]:
        """assign_batch plus the OTHER holders of the assigned volume:
        [(fid, primary_url, auth, (replica_url, ...)), ...]."""
        resp = self.assign(count=count, collection=collection, replication=replication,
                           ttl_seconds=ttl_seconds, disk_type=disk_type,
                           writable_volume_count=writable_volume_count)
        url = resp.location.url
        replicas = tuple(loc.url for loc in resp.replicas)
        return [(resp.fid if i == 0 else f"{resp.fid}_{i}", url, resp.auth, replicas)
                for i in range(max(1, resp.count))]

    def lookup(self, vid: int) -> list[str]:
        """Volume-server URLs holding ``vid`` (replicas or EC shard holders)."""
        now = time.monotonic()
        with self._lock:
            hit = self._vid_cache.get(vid)
            if hit and hit[0] > now:
                return list(hit[1])
        resp = self._stub.LookupVolume(m_pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)]))
        urls: list[str] = []
        for loc in resp.volume_id_locations:
            if loc.error:
                # a master-side lookup error silently becoming "no replicas"
                # is how reads 404 with no trail: log it
                wlog.warning("lookup vid=%d: %s", vid, loc.error)
            else:
                urls = [l.url for l in loc.locations]
        with self._lock:
            self._vid_cache[vid] = (now + self.cache_ttl, urls)
        return list(urls)

    def lookup_file_id(self, fid: str) -> str:
        """One URL (randomized among replicas) serving ``fid``."""
        return self.lookup_urls(fid)[0]

    def lookup_urls(self, fid: str) -> list[str]:
        """Every replica URL serving ``fid``, shuffled: the read path's
        failover order (try them in turn, forget the dead ones)."""
        vid = int(fid.split(",")[0])
        urls = self.lookup(vid)
        if not urls:
            raise KeyError(f"volume {vid} not found")
        random.shuffle(urls)
        return urls

    def lookup_ec_shards(self, vid: int) -> dict[int, list[str]]:
        """{shard id: [holder url, ...]} of an EC volume, TTL-cached."""
        now = time.monotonic()
        with self._lock:
            hit = self._ec_cache.get(vid)
            if hit and hit[0] > now:
                return dict(hit[1])
        resp = self._stub.LookupEcVolume(m_pb.LookupEcVolumeRequest(volume_id=vid))
        shards = {sl.shard_id: [l.url for l in sl.locations] for sl in resp.shard_id_locations}
        with self._lock:
            self._ec_cache[vid] = (now + self.cache_ttl, shards)
        return dict(shards)

    def invalidate(self, vid: int) -> None:
        """Forget cached locations (a dead replica: vid_map deleteLocation)."""
        with self._lock:
            self._vid_cache.pop(vid, None)
            self._ec_cache.pop(vid, None)

    def forget_location(self, vid: int, url: str) -> None:
        """Drop one dead replica URL, keeping its siblings cached; the last
        one dropped empties the entry so the next lookup re-fetches
        (vid_map deleteLocation)."""
        with self._lock:
            hit = self._vid_cache.get(vid)
            if hit is None or url not in hit[1]:
                return
            hit[1].remove(url)
            if not hit[1]:
                self._vid_cache.pop(vid, None)
