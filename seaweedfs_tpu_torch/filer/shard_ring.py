"""Sharded filer metadata plane: consistent-hash namespace partitioning.

One filer process is the metadata wall on the road to millions of
tenants: every stat/list/create funnels through a single store no
matter how wide the byte path scales.  This module partitions the filer
NAMESPACE over N independent filer processes the way volumes partition
the byte path over volume servers:

- :class:`ShardRing` — a consistent-hash ring (virtual nodes) over the
  shard gRPC addresses, keyed by the **routing prefix** of a path: its
  first ``depth`` components (default 2, i.e. ``/buckets/<bucket>``
  granularity).  Every path under one bucket routes to ONE shard, so
  the hot operations — object stat, object create, in-bucket listing —
  are single-shard; adding a shard moves only ~1/N of the prefixes.

- :class:`ShardedFilerClient` — the router the gateways (S3, IAM,
  shell) ride transparently: it implements the same duck-type as
  :class:`~seaweedfs_tpu_torch.filer.remote.RemoteFiler` (which it composes,
  one per shard — every per-shard RPC keeps the resilient stub's policy:
  per-address deadlines, retries, circuit breakers, channel eviction).
  Operations that cross shard boundaries are handled explicitly:

  * **shallow listings** (directories above the routing depth, e.g.
    ``/buckets`` for ListBuckets) fan out to every shard with bounded
    concurrency and merge into one ordered, de-duplicated listing;
  * **renames** whose source and destination route to the same shard
    (and whose subtrees cannot span shards) stay the native atomic
    RPC; anything else becomes a **two-phase move** — copy the
    metadata to the destination shard(s), then delete the source with
    ``delete_data=False`` (chunks stay in place; both phases emit
    through each shard's meta_log, so subscribers see the move and a
    crash between phases leaves a duplicate, never a loss);
  * **recursive deletes** of shallow directories fan out to every
    shard (each holds its own slice of the subtree).

With ONE shard the router degenerates to exactly the RemoteFiler call
sequence — no fan-outs, no extra lookups — pinned by tests, so the
single-filer deployment shape is byte-identical to today.

Availability: a dead shard must cost bounded latency, not a wedged
gateway.  Shard RPC failures that mean "this shard is unreachable"
(UNAVAILABLE, DEADLINE_EXCEEDED, open breaker) surface as
:class:`ShardUnavailable` carrying a ``retry_after`` hint; the S3
gateway maps it to 503 + Retry-After (and QoS sheds with 429 before
that, see util/limiter.py).  1/N of prefixes degrade; the rest of the
namespace keeps serving.

The port's copy of seaweedfs_tpu/filer/shard_ring.py over the port's
``RemoteFiler``: the hash, the vnode names and the ring order are the JAX
package's, so a JAX gateway and a port gateway over the same shards route
every path to the same shard.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor

import grpc

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.util import wlog

DEFAULT_DEPTH = 2  # /buckets/<bucket> granularity
DEFAULT_VNODES = 64
DEFAULT_FANOUT = 4  # concurrent shards per merged operation


class ShardUnavailable(FilerError):
    """A filer shard is unreachable; callers should shed, not queue.

    ``retry_after`` is the seconds a client should back off before
    retrying (the gateway copies it into the Retry-After header)."""

    def __init__(self, shard: str, cause: str, retry_after: float = 1.0):
        super().__init__(f"filer shard {shard} unavailable: {cause}")
        self.shard = shard
        self.retry_after = retry_after


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


def route_prefix(path: str, depth: int = DEFAULT_DEPTH) -> str:
    """The ring key for ``path``: its first ``depth`` components (the
    whole path when shallower).  ``/`` routes as ``/``."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        return "/"
    return "/" + "/".join(parts[:depth])


def _depth(path: str) -> int:
    return len([p for p in path.split("/") if p])


def filer_client(addresses: list[str] | str, master_client):
    """The filer-API client of a ``-filer`` spec: a ``RemoteFiler`` for one
    address, the shard router for a comma list (what the gateways, the
    shell and ``cli iam`` build from their ``-filer``)."""
    if isinstance(addresses, str):
        addresses = [a.strip() for a in addresses.split(",") if a.strip()]
    if not addresses:
        raise ValueError("no filer address given")
    if len(addresses) > 1:
        return ShardedFilerClient(addresses, master_client)
    return RemoteFiler(addresses[0], master_client)


class ShardRing:
    """Consistent-hash ring over shard addresses with virtual nodes.

    Deterministic for a given member set (every gateway and shell
    process computes the same ownership), and adding/removing a member
    remaps only the vnodes it owned — the property that makes growing
    the metadata plane a data migration, not a full reshuffle."""

    def __init__(self, addresses: list[str], vnodes: int = DEFAULT_VNODES):
        if not addresses:
            raise ValueError("ShardRing needs at least one shard address")
        self.addresses = list(dict.fromkeys(addresses))  # order-stable dedup
        self.vnodes = vnodes
        points: list[tuple[int, str]] = []
        for addr in self.addresses:
            for i in range(vnodes):
                points.append((_hash(f"{addr}#{i}"), addr))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def shard_for_prefix(self, prefix: str) -> str:
        if len(self.addresses) == 1:
            return self.addresses[0]
        from bisect import bisect_right

        h = _hash(prefix)
        i = bisect_right(self._hashes, h)
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def shard_for(self, path: str, depth: int = DEFAULT_DEPTH) -> str:
        return self.shard_for_prefix(route_prefix(path, depth))

    def ownership(self, samples: int = 4096) -> dict[str, float]:
        """Approximate hash-space share per shard (for status display)."""
        counts = dict.fromkeys(self.addresses, 0)
        for i in range(samples):
            counts[self.shard_for_prefix(f"sample-{i}")] += 1
        return {a: c / samples for a, c in counts.items()}


class ShardedFilerClient:
    """The shard router: RemoteFiler's duck-type over a ShardRing.

    Gateways construct it from a comma-separated ``-filer`` list; with
    one address it IS a RemoteFiler call-for-call.  ``listeners`` is the
    same in-process mutation seam RemoteFiler exposes — every per-shard
    client shares this router's list, so gateway entry caches and the
    worker-group inval bus see mutations no matter which shard served
    them."""

    remote = True  # duck-type marker (see RemoteFiler.remote)

    def __init__(
        self,
        addresses: list[str] | str,
        master_client,
    ):
        if isinstance(addresses, str):
            addresses = [a.strip() for a in addresses.split(",") if a.strip()]
        self.ring = ShardRing(addresses)
        self.depth = DEFAULT_DEPTH
        self.master_client = master_client
        self.listeners: list = []
        self._shards: dict[str, RemoteFiler] = {}
        for addr in self.ring.addresses:
            rf = RemoteFiler(addr, master_client)
            rf.listeners = self.listeners  # shared seam (see docstring)
            self._shards[addr] = rf
        # bounded fan-out for merged listings / tree ops: one shared
        # executor, at most DEFAULT_FANOUT shards in flight per call
        self._fanout = max(1, min(DEFAULT_FANOUT, len(self.ring.addresses)))
        self._pool = ThreadPoolExecutor(
            max_workers=self._fanout, thread_name_prefix="filer-shard"
        )

    # ---- plumbing --------------------------------------------------------
    @property
    def shard_addresses(self) -> list[str]:
        return list(self.ring.addresses)

    @property
    def address(self) -> str:
        """Compatibility with RemoteFiler consumers that display one
        address; the first shard stands for the group."""
        return self.ring.addresses[0]

    def _shard(self, path: str) -> tuple[str, RemoteFiler]:
        addr = self.ring.shard_for(path, self.depth)
        return addr, self._shards[addr]

    def _call(self, addr: str, op: str, fn, *args, **kwargs):
        """One routed shard call: metered, with unreachability mapped to
        ShardUnavailable so callers shed with bounded latency instead of
        surfacing a raw transport error."""
        from seaweedfs_tpu_torch import stats
        from seaweedfs_tpu_torch.util import resilience

        stats.FILER_SHARD_REQUESTS.inc(op=op, shard=addr)
        from seaweedfs_tpu_torch.stats import events

        try:
            return fn(*args, **kwargs)
        except resilience.CircuitOpenError as e:
            stats.FILER_SHARD_UNAVAILABLE.inc(shard=addr)
            events.record(
                events.SHARD_UNAVAILABLE, shard=addr, op=op,
                reason="circuit open",
            )
            raise ShardUnavailable(addr, "circuit open") from e
        except grpc.RpcError as e:
            code = resilience.error_code(e)
            if code in (
                grpc.StatusCode.UNAVAILABLE,
                grpc.StatusCode.DEADLINE_EXCEEDED,
            ):
                stats.FILER_SHARD_UNAVAILABLE.inc(shard=addr)
                events.record(
                    events.SHARD_UNAVAILABLE, shard=addr, op=op,
                    reason=code.name,
                )
                raise ShardUnavailable(addr, code.name) from e
            raise

    def _contained(self, path: str) -> bool:
        """Whether every possible descendant of ``path`` routes to the
        same shard as ``path`` itself (true at or below the routing
        depth: descendants share the first-``depth`` components)."""
        return _depth(path) >= self.depth

    @property
    def _single(self) -> bool:
        return len(self.ring.addresses) == 1

    # ---- single-shard ops ------------------------------------------------
    def find_entry(self, full_path: str) -> Entry | None:
        addr, rf = self._shard(full_path)
        return self._call(addr, "find", rf.find_entry, full_path)

    def create_entry(self, entry: Entry, *, emit: bool = True) -> None:
        addr, rf = self._shard(entry.full_path)
        self._call(addr, "create", rf.create_entry, entry, emit=emit)

    def update_entry(self, entry: Entry) -> None:
        addr, rf = self._shard(entry.full_path)
        self._call(addr, "update", rf.update_entry, entry)

    def mkdirs(self, full_path: str, mode: int = 0o755) -> None:
        addr, rf = self._shard(full_path)
        self._call(addr, "mkdirs", rf.mkdirs, full_path, mode)

    # ---- delete ----------------------------------------------------------
    def delete_entry(
        self,
        full_path: str,
        *,
        recursive: bool = False,
        delete_data: bool = True,
    ) -> None:
        addr, rf = self._shard(full_path)
        if self._single or self._contained(full_path):
            self._call(
                addr, "delete", rf.delete_entry, full_path,
                recursive=recursive, delete_data=delete_data,
            )
            return
        # shallow path: the subtree (if a directory) may span shards
        entry = self.find_entry(full_path)
        if entry is not None and not entry.is_directory:
            # a shallow FILE routes by its own full path — owner only
            self._call(
                addr, "delete", rf.delete_entry, full_path,
                recursive=recursive, delete_data=delete_data,
            )
            return
        # directory — or no canonical entry: sibling shards may still
        # hold implicit copies + children (every shard's parent
        # auto-creation makes its own), so the emptiness probe and the
        # delete itself must consult ALL shards, not the ring owner.
        # strict=True: a dead shard's slice reading as "empty" must shed
        # the delete (503, retryable), never ack a no-op that leaves the
        # dead shard's children behind on restart
        children = self._merged_list(full_path, "", False, 2, "", strict=True)
        if entry is None and not children:
            return  # nothing anywhere: idempotent no-op
        if not recursive and children:
            raise FilerError(f"{full_path} is a non-empty directory")
        # fan the delete out (idempotent on shards that never saw the
        # prefix — every shard may hold a slice or an implicit copy)
        from seaweedfs_tpu_torch import stats

        stats.FILER_SHARD_FANOUT.inc(op="delete")
        errors: list[Exception] = []

        def _one(a: str) -> None:
            try:
                self._call(
                    a, "delete", self._shards[a].delete_entry, full_path,
                    recursive=recursive, delete_data=delete_data,
                )
            except FileNotFoundError:
                pass  # this shard never held a slice of the prefix
            except Exception as e:  # noqa: BLE001 — collected below
                errors.append(e)

        self._fan(_one)
        if errors:
            raise errors[0]

    # ---- listing ---------------------------------------------------------
    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        if self._single or self._contained(dir_path):
            addr, rf = self._shard(dir_path)
            return self._call(
                addr, "list", rf.list_entries, dir_path,
                start_file_name, inclusive, limit, prefix,
            )
        return self._merged_list(dir_path, start_file_name, inclusive, limit, prefix)

    def _merged_list(
        self, dir_path, start_file_name, inclusive, limit, prefix,
        strict: bool = False,
    ) -> list[Entry]:
        """Shallow-directory listing: every shard may hold children (each
        child routes by its OWN prefix) — list them all with bounded
        fan-out and merge ordered by name.  Directory entries duplicate
        across shards (every shard's implicit-parent creation makes its
        own copy); the merge keeps one, preferring the child's canonical
        owner shard so attributes come from where the entry was actually
        created.  ``strict`` raises on a dead shard instead of degrading
        — mutation probes (deletes) must never mistake an outage for
        emptiness; plain listings degrade by design."""
        from seaweedfs_tpu_torch import stats

        stats.FILER_SHARD_FANOUT.inc(op="list")
        results: dict[str, list[Entry]] = {}
        errors: list[Exception] = []

        def _one(addr: str) -> None:
            try:
                results[addr] = self._call(
                    addr, "list", self._shards[addr].list_entries, dir_path,
                    start_file_name, inclusive, limit, prefix,
                )
            except ShardUnavailable as e:
                if strict:
                    errors.append(e)
                    return
                # a dead shard degrades the listing (its slice is
                # missing) instead of failing the whole namespace; the
                # caller-visible contract is the same TTL-bounded
                # staleness a killed filer always meant
                wlog.warning("shard list degraded: %s", e)
                results[addr] = []
            except Exception as e:  # noqa: BLE001 — collected below
                errors.append(e)

        self._fan(_one)
        if errors:
            raise errors[0]
        merged: dict[str, tuple[str, Entry]] = {}
        for addr, entries in results.items():
            for e in entries:
                cur = merged.get(e.name)
                if cur is None:
                    merged[e.name] = (addr, e)
                    continue
                # duplicate name across shards: prefer the canonical
                # owner shard's copy
                owner = self.ring.shard_for(e.full_path, self.depth)
                if addr == owner and cur[0] != owner:
                    merged[e.name] = (addr, e)
        out = [e for _, (_, e) in sorted(merged.items())]
        return out[:limit]

    def _fan(self, fn) -> None:
        """Run ``fn(addr)`` for every shard with bounded concurrency."""
        futs = [self._pool.submit(fn, a) for a in self.ring.addresses]
        for f in futs:
            f.result()

    # ---- rename ----------------------------------------------------------
    def rename(self, old_path: str, new_path: str) -> None:
        if self._single:
            self._call(
                self.ring.addresses[0], "rename",
                self._shards[self.ring.addresses[0]].rename,
                old_path, new_path,
            )
            return
        old_shard = self.ring.shard_for(old_path, self.depth)
        new_shard = self.ring.shard_for(new_path, self.depth)
        if (
            old_shard == new_shard
            and self._contained(old_path)
            and self._contained(new_path)
        ):
            # subtree cannot span shards: the native atomic rename holds
            self._call(
                old_shard, "rename", self._shards[old_shard].rename,
                old_path, new_path,
            )
            return
        self._move_cross_shard(old_path, new_path)

    def _move_cross_shard(self, old_path: str, new_path: str) -> None:
        """Two-phase metadata move: copy entries to their destination
        shards, then delete the source WITHOUT touching chunk data.
        Phase ordering makes a crash leave a duplicate (re-runnable),
        never a loss; both phases flow through each shard's meta_log so
        metadata subscribers (filer.sync, gateway caches) observe the
        move as create+delete — the same event shape a single-filer
        rename emits per moved entry."""
        from dataclasses import replace as _replace

        from seaweedfs_tpu_torch import stats

        stats.FILER_SHARD_FANOUT.inc(op="rename")
        src = self.find_entry(old_path)
        if src is None:
            raise FileNotFoundError(old_path)
        # phase 1: copy (depth-first so parents exist before children)
        for from_p, to_p, entry in self._walk_move(src, old_path, new_path):
            moved = _replace(entry, chunks=list(entry.chunks))
            moved.full_path = to_p
            moved.extended = dict(entry.extended)
            self.create_entry(moved)
        # phase 2: delete the source names; data stays (it now belongs
        # to the destination entries)
        self.delete_entry(old_path, recursive=True, delete_data=False)

    def _walk_move(self, src: Entry, old_path: str, new_path: str):
        """Yield (old, new, entry) for src and every descendant."""
        yield old_path, new_path, src
        if not src.is_directory:
            return
        stack = [old_path]
        while stack:
            d = stack.pop()
            start = ""
            while True:
                batch = self.list_entries(d, start_file_name=start, limit=1024)
                for child in batch:
                    tail = child.full_path[len(old_path):]
                    yield child.full_path, new_path + tail, child
                    if child.is_directory:
                        stack.append(child.full_path)
                if len(batch) < 1024:
                    break
                start = batch[-1].name

    # ---- misc ------------------------------------------------------------
    def statistics(self) -> tuple[int, int]:
        files = dirs = 0
        for st in self.shard_status().values():
            files += st.get("files", 0)
            dirs += st.get("dirs", 0)
        return files, dirs

    def shard_status(self) -> dict[str, dict]:
        """Per-shard liveness + entry counts (the filer.shard.status
        shell command and /debug surface)."""
        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        out: dict[str, dict] = {}
        share = self.ring.ownership()
        for addr in self.ring.addresses:
            row: dict = {"share": round(share.get(addr, 0.0), 4)}
            try:
                resp = rpc.filer_stub(addr).Statistics(
                    f_pb.FilerStatisticsRequest(), timeout=5.0
                )
                row.update(
                    alive=True,
                    files=int(resp.entry_count),
                    dirs=int(resp.directory_count),
                )
            except Exception as e:  # noqa: BLE001 — a dead shard is a report row
                row.update(alive=False, error=str(e)[:200])
            out[addr] = row
        return out

    def _delete_chunks(self, entry: Entry) -> None:
        from seaweedfs_tpu_torch.filer import reader

        reader.delete_entry_chunks(self.master_client, entry)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
