"""MQ broker: owns partition logs, serves the weedtpu.mq contract.

Counterpart of the reference's weed/mq/broker/: publish routes by key
hash to a partition; the broker either owns it (append to its log) or
answers with the owner so clients re-route.  Brokers register with the
master's cluster registry (type=broker) and derive partition ownership
by rendezvous hashing over the live broker set — see balancer.py.

The port's copy of seaweedfs_tpu/mq/broker.py.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import urllib.parse

import grpc

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.mq.balancer import (
    group_coordinator,
    hash_key_to_partition,
    partition_owner,
    partition_replicas,
)
from seaweedfs_tpu_torch.mq.groups import GroupCoordinator, OffsetStore
from seaweedfs_tpu_torch.mq.log_store import PartitionLog
from seaweedfs_tpu_torch.pb import mq_pb2 as mq


class _BrokerServicer:
    def __init__(self, broker: "MqBroker"):
        self.b = broker

    # ---- topic lifecycle -------------------------------------------------
    def configure_topic(self, request, context):
        t = request.topic
        if not t.name:
            return mq.ConfigureTopicResponse(error="topic name required")
        count = request.partition_count or 4
        if request.record_type_json:
            from seaweedfs_tpu_torch.mq.schema import RecordType, SchemaError

            try:  # reject unreadable schemas at configure time
                RecordType.from_json(request.record_type_json)
            except SchemaError as e:
                return mq.ConfigureTopicResponse(error=f"bad schema: {e}")
        if request.replication < -1:
            return mq.ConfigureTopicResponse(
                error="replication must be >= 0 (-1 resets to the broker default)"
            )
        self.b.save_topic_config(
            t.namespace or "default", t.name, count,
            request.record_type_json, request.replication,
        )
        if not request.no_forward:
            for peer in self.b.live_brokers():
                if peer == self.b.advertise:
                    continue
                try:
                    self.b.stub(peer).ConfigureTopic(
                        mq.ConfigureTopicRequest(
                            topic=t, partition_count=count, no_forward=True,
                            record_type_json=request.record_type_json,
                            replication=request.replication,
                        )
                    )
                except grpc.RpcError:
                    pass  # peer learns the config lazily on first lookup
        return mq.ConfigureTopicResponse()

    def list_topics(self, request, context):
        out = mq.ListTopicsResponse()
        for (ns, name), (count, schema, repl) in sorted(
            self.b.topic_configs().items()
        ):
            out.topics.append(
                mq.TopicInfo(
                    topic=mq.Topic(namespace=ns, name=name),
                    partition_count=count,
                    record_type_json=schema,
                    replication=repl,
                )
            )
        return out

    def lookup_topic(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        count = self.b.topic_partition_count(ns, t.name)
        if count is None:
            return mq.LookupTopicResponse(error=f"unknown topic {ns}/{t.name}")
        brokers = self.b.live_brokers()
        resp = mq.LookupTopicResponse(partition_count=count)
        for p in range(count):
            owner = partition_owner(brokers, ns, t.name, p)
            resp.assignments.append(
                mq.PartitionAssignment(partition=p, broker=owner or "")
            )
        return resp

    # ---- data plane ------------------------------------------------------
    def publish(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        count = self.b.topic_partition_count(ns, t.name)
        if count is None:
            return mq.PublishResponse(error=f"unknown topic {ns}/{t.name}")
        p = request.partition
        if p < 0:
            p = hash_key_to_partition(bytes(request.key), count)
        owner = partition_owner(self.b.live_brokers(), ns, t.name, p)
        if owner and owner != self.b.advertise:
            if request.no_forward:
                # divergent broker views must not ping-pong a publish
                # between brokers — fail it back to the client instead
                return mq.PublishResponse(
                    error=f"not the owner of partition {p} (owner {owner})"
                )
            # not ours: proxy ONE hop so any broker accepts any publish
            # (the reference's agent re-routes; proxying keeps the client
            # dumb; no_forward caps the hop count at one)
            try:
                return self.b.stub(owner).Publish(
                    mq.PublishRequest(
                        topic=t, partition=p,
                        key=request.key, value=request.value,
                        no_forward=True,
                    ),
                    timeout=10,
                )
            except grpc.RpcError as e:
                return mq.PublishResponse(error=f"owner {owner}: {e.code()}")
        log = self.b.partition_log(ns, t.name, p)
        self.b.ensure_caught_up(ns, t.name, p, log)
        key, value = bytes(request.key), bytes(request.value)
        offset, ts = log.append_with_ts(key, value)
        self.b.replicate_append(ns, t.name, p, log, offset, ts, key, value)
        return mq.PublishResponse(partition=p, offset=offset)

    def replicate_records(self, request, context):
        """Successor side of owner->successor log replication: apply
        records at the owner's offsets (idempotent on overlap, refuse on
        gap so the owner backfills) and fold in committed offsets."""
        t = request.topic
        ns = t.namespace or "default"
        log = self.b.partition_log(ns, t.name, request.partition)
        for rec in request.records:
            st = log.append_external(
                rec.offset, rec.ts_ns, bytes(rec.key), bytes(rec.value)
            )
            if st == "gap":
                break  # report have_next, owner backfills
            if st == "duplicate":
                # content-blind acceptance would mask a split-brain
                # double-ack (divergent registry views electing two
                # owners).  Detect and shout; reconciliation needs an
                # operator — neither copy can be silently dropped.
                stored = next(iter(log.read(rec.offset)), None)
                if stored is not None and stored.offset == rec.offset and (
                    stored.key != bytes(rec.key)
                    or stored.value != bytes(rec.value)
                ):
                    wlog.warning(
                        "mq DIVERGENCE %s/%s p%d offset %d: replicated "
                        "record differs from local copy (split-brain "
                        "double-ack); keeping local record",
                        ns, t.name, request.partition, rec.offset,
                    )
        if request.group_offsets:
            self.b.offset_store(ns, t.name, request.partition).replace(
                dict(request.group_offsets)
            )
        return mq.ReplicateRecordsResponse(have_next=log.next_offset)

    def subscribe(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        count = self.b.topic_partition_count(ns, t.name)
        if count is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown topic {t.name}")
        log = self.b.partition_log(ns, t.name, request.partition)
        cursor = (
            log.next_offset if request.start_offset < 0 else request.start_offset
        )
        while context.is_active() and not self.b._stopping.is_set():
            served = False
            for msg in log.read(cursor):
                yield mq.SubscribeResponse(
                    offset=msg.offset, ts_ns=msg.ts_ns,
                    key=msg.key, value=msg.value,
                )
                cursor = msg.offset + 1
                served = True
                if not context.is_active():
                    return
            if not request.follow:
                return
            if not served:
                log.wait_for(cursor, timeout=0.5)

    # ---- consumer groups -------------------------------------------------
    def _route_remote(self, request, target, rpc_name, resp_cls, local_fn):
        """One-hop routing shared by the group/offset RPCs (the Publish
        pattern): serve locally when this broker IS the target; proxy
        once otherwise; and on a no_forward request that still lands on
        a non-target broker, FAIL it back — divergent broker views must
        never split group state or persist offsets beside the wrong log
        (mirrors the publish handler's ping-pong guard)."""
        if target and target != self.b.advertise:
            if request.no_forward:
                resp = resp_cls()
                resp.error = (
                    f"not the broker for this {rpc_name} (want {target})"
                )
                return resp
            try:
                fwd = type(request)()
                fwd.CopyFrom(request)
                fwd.no_forward = True
                return getattr(self.b.stub(target), rpc_name)(fwd, timeout=10)
            except grpc.RpcError as e:
                resp = resp_cls()
                resp.error = f"{rpc_name} target {target}: {e.code()}"
                return resp
        return local_fn()

    def _route_coordinator(self, request, context, rpc_name, local_fn):
        t = request.topic
        ns = t.namespace or "default"
        coord = group_coordinator(
            self.b.live_brokers(), ns, t.name, request.group
        )
        resp_cls = {
            "JoinGroup": mq.JoinGroupResponse,
            "GroupHeartbeat": mq.GroupHeartbeatResponse,
            "LeaveGroup": mq.LeaveGroupResponse,
            "DescribeGroup": mq.DescribeGroupResponse,
        }[rpc_name]
        return self._route_remote(
            request, coord, rpc_name, resp_cls,
            lambda: local_fn(ns, coord or self.b.advertise),
        )

    def join_group(self, request, context):
        def local(ns, coord):
            count = self.b.topic_partition_count(ns, request.topic.name)
            if count is None:
                return mq.JoinGroupResponse(
                    error=f"unknown topic {ns}/{request.topic.name}"
                )
            gen, parts = self.b.groups.join(
                ns, request.topic.name, request.group,
                request.instance_id, count,
            )
            return mq.JoinGroupResponse(
                generation=gen, partitions=parts, coordinator=coord
            )

        return self._route_coordinator(request, context, "JoinGroup", local)

    def group_heartbeat(self, request, context):
        def local(ns, coord):
            rejoin, gen = self.b.groups.heartbeat(
                ns, request.topic.name, request.group,
                request.instance_id, request.generation,
            )
            return mq.GroupHeartbeatResponse(rejoin=rejoin, generation=gen)

        return self._route_coordinator(
            request, context, "GroupHeartbeat", local
        )

    def leave_group(self, request, context):
        def local(ns, coord):
            self.b.groups.leave(
                ns, request.topic.name, request.group, request.instance_id
            )
            return mq.LeaveGroupResponse()

        return self._route_coordinator(request, context, "LeaveGroup", local)

    def describe_group(self, request, context):
        def local(ns, coord):
            gen, members = self.b.groups.describe(
                ns, request.topic.name, request.group
            )
            resp = mq.DescribeGroupResponse(generation=gen)
            for inst in sorted(members):
                resp.members.append(
                    mq.GroupMember(
                        instance_id=inst, partitions=members[inst]
                    )
                )
            return resp

        return self._route_coordinator(
            request, context, "DescribeGroup", local
        )

    def _route_partition_owner(self, request, rpc_name, local_fn, err_resp):
        """Offset RPCs go to the partition OWNER (offsets persist beside
        the log they index) — same one-hop routing as Publish."""
        t = request.topic
        ns = t.namespace or "default"
        owner = partition_owner(
            self.b.live_brokers(), ns, t.name, request.partition
        )
        return self._route_remote(
            request, owner, rpc_name, err_resp, lambda: local_fn(ns)
        )

    def commit_offset(self, request, context):
        def local(ns):
            self.b.offset_store(
                ns, request.topic.name, request.partition
            ).commit(request.group, request.offset)
            # committed offsets are part of the durability contract: a
            # takeover must resume the group where it left off
            self.b.replicate_offsets(
                ns, request.topic.name, request.partition,
                {request.group: request.offset},
            )
            return mq.CommitOffsetResponse()

        return self._route_partition_owner(
            request, "CommitOffset", local, mq.CommitOffsetResponse
        )

    def fetch_offset(self, request, context):
        def local(ns):
            off = self.b.offset_store(
                ns, request.topic.name, request.partition
            ).fetch(request.group)
            return mq.FetchOffsetResponse(offset=off)

        return self._route_partition_owner(
            request, "FetchOffset", local, mq.FetchOffsetResponse
        )

    def seal_segments(self, request, context):
        """Force open partition logs into the columnar tier (the shell's
        mq.topic.compact; reference mq compaction is log_to_parquet)."""
        return mq.SealSegmentsResponse(
            sealed_count=self.b.seal_old_segments(evict=request.evict)
        )

    def partition_offsets(self, request, context):
        t = request.topic
        ns = t.namespace or "default"
        log = self.b.partition_log(ns, t.name, request.partition)
        resp = mq.PartitionOffsetsResponse(
            earliest=log.earliest_offset(), next=log.next_offset
        )
        for group, off in self.b.offset_store(
            ns, t.name, request.partition
        ).all().items():
            resp.group_offsets[group] = off
        return resp


class MqBroker:
    def __init__(
        self,
        data_dir: str,
        master_http: str,
        *,
        ip: str = "127.0.0.1",
        grpc_port: int = 0,
        register_interval: float = 5.0,
        group_session_timeout: float = 10.0,
        replication: int = 2,
        filer_http: str = "",
    ):
        self.dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        # sealed-segment offload into the filer (reference
        # logstore/log_to_parquet.go stores parquet in the filer so
        # broker disks stay bounded and history survives broker loss)
        self._tier = None
        if filer_http:
            from seaweedfs_tpu_torch.mq.tier import FilerSegmentTier

            self._tier = FilerSegmentTier(filer_http)
        self.master_http = master_http
        self.ip = ip
        self._grpc_port = grpc_port
        self.register_interval = register_interval
        self._logs: dict[tuple[str, str, int], PartitionLog] = {}
        self.groups = GroupCoordinator(group_session_timeout)
        self._offset_stores: dict[tuple[str, str, int], OffsetStore] = {}
        # (ns, name) -> (partition_count, record_type_json)
        self._configs: dict[tuple[str, str], tuple[int, str]] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._grpc_server = None
        self._last_brokers: list[str] = []  # last-known-good registry view
        # copies per partition including the owner (1 = no replication)
        self.replication = max(1, replication)
        # (ns, name, p) -> broker-set snapshot the partition was reconciled
        # against; ownership re-checks when the live set changes
        self._caught_up: dict[tuple[str, str, int], tuple[str, ...]] = {}
        self._caught_up_retry: dict[tuple[str, str, int], float] = {}
        # peer -> last failure time; a hung successor is skipped briefly
        self._peer_down: dict[str, float] = {}
        # (peer, ns, name, p) backfills currently streaming in background
        self._backfilling: set[tuple[str, str, str, int]] = set()
        self._load_configs()

    # ---- config persistence ---------------------------------------------
    def _config_path(self) -> str:
        return os.path.join(self.dir, "topics.json")

    def _load_configs(self) -> None:
        try:
            with open(self._config_path()) as fh:
                raw = json.load(fh)
            self._configs = {}
            for k, v in raw.items():
                ns, name = k.split("/", 1)
                if isinstance(v, int):  # pre-schema config files
                    self._configs[(ns, name)] = (v, "", 0)
                else:
                    repl = int(v[2]) if len(v) > 2 else 0
                    self._configs[(ns, name)] = (int(v[0]), str(v[1]), repl)
        except (
            FileNotFoundError,
            json.JSONDecodeError,
            ValueError,
            IndexError,
            TypeError,
            KeyError,
        ):
            # a corrupt/hand-edited config must reset, not crash startup
            self._configs = {}

    def save_topic_config(
        self, ns: str, name: str, count: int, schema: str = "",
        replication: int = 0,
    ) -> None:
        with self._lock:
            prev = self._configs.get((ns, name))
            if prev is not None:
                # a re-partition that omits schema/replication keeps them;
                # replication == -1 explicitly resets to the broker default
                schema = schema or prev[1]
                replication = replication if replication else prev[2]
            if replication < 0:
                replication = 0
            self._configs[(ns, name)] = (count, schema, replication)
            tmp = self._config_path() + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(
                    {
                        f"{k[0]}/{k[1]}": list(v)
                        for k, v in self._configs.items()
                    },
                    fh,
                )
            os.replace(tmp, self._config_path())

    def topic_configs(self) -> dict:
        with self._lock:
            return dict(self._configs)

    def topic_partition_count(self, ns: str, name: str) -> int | None:
        with self._lock:
            conf = self._configs.get((ns, name))
        if conf is not None:
            return conf[0]
        # lazy learn: another broker may hold the config
        for peer in self.live_brokers():
            if peer == self.advertise:
                continue
            try:
                resp = self.stub(peer).ListTopics(mq.ListTopicsRequest())
            except grpc.RpcError:
                continue
            for info in resp.topics:
                if (info.topic.namespace or "default") == ns and info.topic.name == name:
                    self.save_topic_config(
                        ns, name, info.partition_count,
                        info.record_type_json, info.replication,
                    )
                    return info.partition_count
        return None

    # ---- logs ------------------------------------------------------------
    def partition_log(self, ns: str, name: str, partition: int) -> PartitionLog:
        key = (ns, name, partition)
        with self._lock:
            log = self._logs.get(key)
        if log is not None:
            return log
        # construction may list/download from the filer tier (recovery):
        # never under the broker-wide lock, or a slow filer freezes every
        # publish/lookup on every partition
        log = PartitionLog(
            os.path.join(self.dir, ns, name, f"p{partition:04d}"),
            tier=self._tier,
            tier_path=f"{ns}/{name}/p{partition:04d}",
        )
        with self._lock:
            existing = self._logs.get(key)
            if existing is not None:
                log.close()  # lost the construction race
                return existing
            self._logs[key] = log
        return log

    def offset_store(self, ns: str, name: str, partition: int) -> OffsetStore:
        key = (ns, name, partition)
        with self._lock:
            store = self._offset_stores.get(key)
            if store is None:
                store = OffsetStore(
                    os.path.join(self.dir, ns, name, f"p{partition:04d}")
                )
                os.makedirs(os.path.dirname(store.path), exist_ok=True)
                self._offset_stores[key] = store
            return store

    # ---- owner->successor replication (durability; see balancer
    # partition_replicas and pb ReplicateRecords) --------------------------

    def topic_replication(self, ns: str, name: str) -> int:
        """Copies per partition for this topic: the topic's configured
        value, else the broker default (-replication flag)."""
        with self._lock:
            conf = self._configs.get((ns, name))
        if conf is not None and conf[2] > 0:
            return conf[2]
        return self.replication

    def replicas_for(self, ns: str, name: str, p: int) -> list[str]:
        return partition_replicas(
            self.live_brokers(), ns, name, p, self.topic_replication(ns, name)
        )

    _PEER_DOWN_TTL = 2.0  # seconds a failing successor is skipped

    def _peer_usable(self, peer: str) -> bool:
        import time as _time

        return _time.monotonic() - self._peer_down.get(peer, -10.0) > (
            self._PEER_DOWN_TTL
        )

    def _mark_peer_down(self, peer: str) -> None:
        import time as _time

        self._peer_down[peer] = _time.monotonic()

    def replicate_append(
        self, ns: str, name: str, p: int, log, offset: int, ts: int,
        key: bytes, value: bytes,
    ) -> None:
        """Synchronously push one acked record to every successor; a
        trailing successor is backfilled from our log.  A dead successor
        degrades redundancy (logged + negative-cached so a hung peer
        costs one short timeout, not 10s on EVERY publish), never
        availability — matching the reference's behavior when its filer
        replica set is short."""
        topic = mq.Topic(namespace=ns, name=name)
        for peer in self.replicas_for(ns, name, p)[1:]:
            if peer == self.advertise or not self._peer_usable(peer):
                continue
            try:
                resp = self.stub(peer).ReplicateRecords(
                    mq.ReplicateRecordsRequest(
                        topic=topic, partition=p,
                        records=[mq.LogRecord(
                            offset=offset, ts_ns=ts, key=key, value=value
                        )],
                    ),
                    timeout=1.5,
                )
                if resp.have_next <= offset:
                    gap = offset - resp.have_next + 1
                    if gap > 1000:
                        # a large catch-up must not serialize inside this
                        # publish (the one-hop forward caps Publish at 10s;
                        # a multi-GB transfer would fail every client):
                        # stream it in the background, deduped per target
                        self._backfill_async(topic, p, log, peer,
                                             resp.have_next)
                    else:
                        self._backfill(topic, p, log, peer, resp.have_next)
            except grpc.RpcError as e:
                self._mark_peer_down(peer)
                wlog.warning(
                    "mq replicate %s/%s p%d -> %s failed: %s",
                    ns, name, p, peer, e.code(),
                )

    def _push_offsets(
        self, peer: str, topic, p: int, offsets: dict[str, int]
    ) -> None:
        """Mirror committed offsets to one successor (shared by the
        per-commit replication and the backfill tail)."""
        try:
            req = mq.ReplicateRecordsRequest(topic=topic, partition=p)
            for group, off in offsets.items():
                req.group_offsets[group] = off
            self.stub(peer).ReplicateRecords(req, timeout=1.5)
        except grpc.RpcError as e:
            self._mark_peer_down(peer)
            wlog.warning(
                "mq offset replicate %s/%s p%d -> %s failed: %s",
                topic.namespace, topic.name, p, peer, e.code(),
            )

    def replicate_offsets(
        self, ns: str, name: str, p: int, offsets: dict[str, int]
    ) -> None:
        topic = mq.Topic(namespace=ns, name=name)
        for peer in self.replicas_for(ns, name, p)[1:]:
            if peer == self.advertise or not self._peer_usable(peer):
                continue
            self._push_offsets(peer, topic, p, offsets)

    def _backfill_async(
        self, topic, p: int, log, peer: str, from_offset: int
    ) -> None:
        ns = topic.namespace or "default"
        key = (peer, ns, topic.name, p)
        with self._lock:
            if key in self._backfilling:
                return  # already streaming to this target
            self._backfilling.add(key)

        def run() -> None:
            try:
                self._backfill(topic, p, log, peer, from_offset)
            finally:
                with self._lock:
                    self._backfilling.discard(key)

        threading.Thread(
            target=run, daemon=True, name=f"mq-backfill-{peer}"
        ).start()

    def _backfill(
        self, topic, p: int, log, peer: str, from_offset: int,
        batch: int = 500,
    ) -> None:
        """Stream our log tail to a trailing successor until it's caught
        up (a fresh successor starts at 0 and pulls the whole log)."""
        cursor = from_offset
        while cursor < log.next_offset:
            recs = []
            for msg in log.read(cursor):
                recs.append(mq.LogRecord(
                    offset=msg.offset, ts_ns=msg.ts_ns,
                    key=msg.key, value=msg.value,
                ))
                if len(recs) >= batch:
                    break
            if not recs:
                return
            resp = self.stub(peer).ReplicateRecords(
                mq.ReplicateRecordsRequest(
                    topic=topic, partition=p, records=recs
                ),
                timeout=30,
            )
            if resp.have_next <= cursor:
                return  # no progress: don't spin
            cursor = resp.have_next
        # the log is the data; the committed offsets are the bookmark —
        # a successor needs both to take over seamlessly
        ns = topic.namespace or "default"
        offsets = self.offset_store(ns, topic.name, p).all()
        if offsets:
            self._push_offsets(peer, topic, p, offsets)

    def ensure_caught_up(self, ns: str, name: str, p: int, log) -> None:
        """Ownership-change reconciliation: before the first append under
        a new live-broker view, pull any records (and committed offsets) a
        successor holds that we don't.  A broker that rejoins after a
        death — and whose rendezvous score makes it owner again — must
        not fork the offset sequence it missed."""
        import time as _time

        key = (ns, name, p)
        brokers = tuple(self.live_brokers())
        now = _time.monotonic()
        with self._lock:
            if self._caught_up.get(key) == brokers:
                return
            # a peer that stays unreachable must not add its RPC timeout
            # to EVERY publish while the registry ages it out: throttle
            # failed reconcile attempts (appends proceed best-effort in
            # between — the peer that can't answer also can't be fetched)
            if now - self._caught_up_retry.get(key, -10.0) < 2.0:
                return
            self._caught_up_retry[key] = now
        topic = mq.Topic(namespace=ns, name=name)
        all_peers_ok = True
        for peer in partition_replicas(
            list(brokers), ns, name, p,
            max(self.topic_replication(ns, name), 2),
        ):
            if peer == self.advertise:
                continue
            try:
                off = self.stub(peer).PartitionOffsets(
                    mq.PartitionOffsetsRequest(topic=topic, partition=p),
                    timeout=5,
                )
                while off.next > log.next_offset:
                    advanced = False
                    for resp in self.stub(peer).Subscribe(
                        mq.SubscribeRequest(
                            topic=topic, partition=p,
                            start_offset=log.next_offset, follow=False,
                        ),
                        timeout=30,
                    ):
                        log.append_external(
                            resp.offset, resp.ts_ns,
                            bytes(resp.key), bytes(resp.value),
                        )
                        advanced = True
                        if log.next_offset >= off.next:
                            break
                    if not advanced:
                        break
                if off.group_offsets:
                    self.offset_store(ns, name, p).replace(
                        dict(off.group_offsets)
                    )
            except grpc.RpcError:
                # an unreachable peer may hold records we miss: do NOT
                # mark caught-up, or the very fork this guards against
                # (a stale rejoined owner re-issuing offsets) gets through
                all_peers_ok = False
                continue
        if all_peers_ok:
            with self._lock:
                self._caught_up[key] = brokers

    def seal_old_segments(self, evict: bool = False) -> int:
        """Columnar-tier every open partition (ops hook / cron); with
        ``evict``, archives safely uploaded to the filer tier also drop
        their local copies (read-through serves them).

        Only the partition OWNER uploads/evicts: replicas seal locally
        but their independently-chosen seal boundaries must never
        overwrite (or be trusted to replace) the owner's tier archives —
        a narrower replica archive clobbering a wider one would orphan
        acked records."""
        sealed = 0
        with self._lock:
            logs = list(self._logs.items())
        brokers = self.live_brokers()
        for (ns, name, p), log in logs:
            owns = (
                partition_owner(brokers, ns, name, p) == self.advertise
            )
            sealed += log.seal_to_columnar(upload=owns)
            if evict and owns:
                log.evict_tiered()
        return sealed

    # ---- cluster membership ---------------------------------------------
    @property
    def advertise(self) -> str:
        return f"{self.ip}:{self._grpc_port}"

    def stub(self, address: str) -> rpc.Stub:
        return rpc.make_stub(address, mq, "MqBroker")

    def _master_get(self, path: str) -> bytes:
        """GET against the master, following one leader redirect."""
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        status, hdrs, body = shared_pool().request_meta(
            self.master_http, "GET", path, timeout=5
        )
        if status in (301, 302, 307):
            loc = urllib.parse.urlparse(hdrs.get("Location", ""))
            _status, _hdrs, body = shared_pool().request_meta(
                f"{loc.hostname}:{loc.port}",
                "GET",
                loc.path + ("?" + loc.query if loc.query else ""),
                timeout=5,
            )
        return body

    _BROKERS_TTL = 1.0  # seconds; publish/replicate consult this per message

    def live_brokers(self) -> list[str]:
        """The registry view, TTL-cached: replication consults it on every
        publish (routing + replica set + catch-up check), and three
        blocking master GETs per message would make the master the MQ
        bottleneck."""
        import time as _time

        now = _time.monotonic()
        cached = getattr(self, "_brokers_cache", None)
        if cached is not None and now - cached[1] < self._BROKERS_TTL:
            return list(cached[0])
        addrs = self._live_brokers_uncached()
        self._brokers_cache = (list(addrs), now)
        return addrs

    def _live_brokers_uncached(self) -> list[str]:
        try:
            body = json.loads(self._master_get("/cluster/nodes?type=broker"))
            addrs = [n["address"] for n in body.get("nodes", [])]
            if addrs:
                self._last_brokers = addrs
                return addrs
        except (OSError, json.JSONDecodeError, ValueError) as e:
            if wlog.V(1):
                wlog.warning("broker registry fetch failed: %s", e)
        # registry blip: keep routing by the last-known set — falling back
        # to [self] would make this broker claim every partition and
        # scatter writes into logs subscribers never read
        if self._last_brokers:
            return self._last_brokers
        return [self.advertise]  # genuinely alone (bootstrap)

    def _register_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                self._master_get(
                    f"/cluster/register?type=broker&address={self.advertise}"
                )
            except OSError:
                pass
            self._stopping.wait(self.register_interval)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._grpc_server = rpc.make_server()
        rpc.add_service(self._grpc_server, mq, "MqBroker", _BrokerServicer(self))
        self._grpc_port = rpc.add_port(self._grpc_server, 
            f"{self.ip}:{self._grpc_port}"
        )
        self._grpc_server.start()
        threading.Thread(target=self._register_loop, daemon=True).start()

    def stop(self) -> None:
        self._stopping.set()
        if self._grpc_server:
            self._grpc_server.stop(grace=1).wait()
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs = {}
