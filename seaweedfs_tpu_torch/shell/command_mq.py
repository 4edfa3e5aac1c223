"""mq.* shell commands: topic admin over the broker fleet.

Counterparts of the reference's shell/command_mq_topic_{list,desc,
configure}.go, command_mq_topic_compact.go and command_mq_balance.go —
brokers are discovered through the master's typed cluster registry
(ListClusterNodes type=broker) and driven over the MqBroker gRPC
contract (pb/mq.proto).

The port's copy of seaweedfs_tpu/shell/command_mq.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import mq_pb2 as mq_pb
from seaweedfs_tpu_torch.shell import shell_command


def _brokers(env) -> list[str]:
    resp = env.master().ListClusterNodes(
        m_pb.ListClusterNodesRequest(node_type="broker")
    )
    return [n.address for n in resp.nodes]


def _broker_stub(address: str) -> rpc.Stub:
    from seaweedfs_tpu_torch.pb import mq_pb2

    return rpc.make_stub(address, mq_pb2, "MqBroker")


def _any_broker(env) -> tuple[str, rpc.Stub]:
    brokers = _brokers(env)
    if not brokers:
        raise RuntimeError("no mq brokers registered with the master")
    return brokers[0], _broker_stub(brokers[0])


@shell_command("mq.topic.list", "list message-queue topics")
def cmd_topic_list(env, args, out):
    _, stub = _any_broker(env)
    resp = stub.ListTopics(mq_pb.ListTopicsRequest())
    for t in resp.topics:
        print(f"  {t.topic.namespace}.{t.topic.name}"
              f"\tpartitions:{t.partition_count}", file=out)


@shell_command("mq.topic.desc", "describe one topic's partitions")
def cmd_topic_desc(env, args, out):
    ns, name = _split_topic(args.topic)
    addr, stub = _any_broker(env)
    lookup = stub.LookupTopic(
        mq_pb.LookupTopicRequest(topic=mq_pb.Topic(namespace=ns, name=name))
    )
    if not lookup.assignments:
        raise RuntimeError(f"topic {args.topic} not found")
    print(f"topic {ns}.{name}: {len(lookup.assignments)} partitions", file=out)
    for a in lookup.assignments:
        offs = _broker_stub(a.broker).PartitionOffsets(
            mq_pb.PartitionOffsetsRequest(
                topic=mq_pb.Topic(namespace=ns, name=name),
                partition=a.partition,
            )
        )
        print(
            f"  p{a.partition:04d} on {a.broker}"
            f" offsets [{offs.earliest}, {offs.next})",
            file=out,
        )


cmd_topic_desc.configure = lambda p: p.add_argument(
    "-topic", required=True, help="namespace.name"
)


@shell_command("mq.topic.configure", "create or re-partition a topic")
def cmd_topic_configure(env, args, out):
    ns, name = _split_topic(args.topic)
    _, stub = _any_broker(env)
    resp = stub.ConfigureTopic(
        mq_pb.ConfigureTopicRequest(
            topic=mq_pb.Topic(namespace=ns, name=name),
            partition_count=args.partitionCount,
            replication=args.replication,
        )
    )
    if resp.error:
        raise RuntimeError(resp.error)
    extra = f", replication {args.replication}" if args.replication else ""
    print(
        f"topic {ns}.{name}: {args.partitionCount} partitions{extra}",
        file=out,
    )


def _configure_flags(p):
    p.add_argument("-topic", required=True, help="namespace.name")
    p.add_argument("-partitionCount", type=int, default=4)
    p.add_argument(
        "-replication", type=int, default=0,
        help="copies per partition incl. the owner (0 = keep current / "
        "broker default, -1 = reset an override to the broker default)",
    )


cmd_topic_configure.configure = _configure_flags


@shell_command("mq.topic.compact", "seal open partition logs to columnar")
def cmd_topic_compact(env, args, out):
    env.confirm_is_locked()
    total = 0
    for addr in _brokers(env):
        resp = _broker_stub(addr).SealSegments(mq_pb.SealSegmentsRequest())
        print(f"  {addr}: sealed {resp.sealed_count} messages", file=out)
        total += resp.sealed_count
    print(f"{total} messages moved to the columnar tier", file=out)


@shell_command("mq.balance", "show topic->broker partition ownership")
def cmd_mq_balance(env, args, out):
    """Ownership is rendezvous-hashed, so 'balancing' is a report: show
    the partition spread per broker (the reference's balancer moves
    partitions; rendezvous hashing keeps the spread even by design and
    reassigns minimally on membership change)."""
    brokers = _brokers(env)
    if not brokers:
        raise RuntimeError("no mq brokers registered with the master")
    stub = _broker_stub(brokers[0])
    counts = {b: 0 for b in brokers}
    for t in stub.ListTopics(mq_pb.ListTopicsRequest()).topics:
        lookup = stub.LookupTopic(mq_pb.LookupTopicRequest(topic=t.topic))
        for a in lookup.assignments:
            counts[a.broker] = counts.get(a.broker, 0) + 1
    for b in sorted(counts):
        print(f"  {b}: {counts[b]} partitions", file=out)


def _split_topic(raw: str) -> tuple[str, str]:
    if "." not in raw:
        return "default", raw
    ns, _, name = raw.partition(".")
    return ns, name


@shell_command("mq.group.desc", "describe a consumer group's members and offsets")
def cmd_group_desc(env, args, out):
    """Reference shell has no direct analogue; the admin surface for
    sub_coordinator state (mq/sub_coordinator/consumer_group.go) — shows
    generation, member assignments, and per-partition committed offsets
    vs the log head (lag)."""
    ns, name = _split_topic(args.topic)
    _, stub = _any_broker(env)
    topic = mq_pb.Topic(namespace=ns, name=name)
    d = stub.DescribeGroup(
        mq_pb.DescribeGroupRequest(topic=topic, group=args.group)
    )
    if d.error:
        raise RuntimeError(d.error)
    print(
        f"group {args.group} on {ns}.{name}: generation {d.generation},"
        f" {len(d.members)} member(s)",
        file=out,
    )
    for m in d.members:
        parts = ",".join(str(p) for p in m.partitions)
        print(f"  {m.instance_id}\tpartitions [{parts}]", file=out)
    lookup = stub.LookupTopic(mq_pb.LookupTopicRequest(topic=topic))
    for a in lookup.assignments:
        offs = _broker_stub(a.broker).PartitionOffsets(
            mq_pb.PartitionOffsetsRequest(topic=topic, partition=a.partition)
        )
        fo = _broker_stub(a.broker).FetchOffset(
            mq_pb.FetchOffsetRequest(
                topic=topic, group=args.group, partition=a.partition
            )
        )
        if fo.error:
            # proto3 default offset is 0 — an errored fetch must never
            # read as "committed 0, fully lagged"
            print(
                f"  p{a.partition:04d} offsets unavailable: {fo.error}",
                file=out,
            )
            continue
        committed = fo.offset if fo.offset >= 0 else "-"
        lag = (offs.next - fo.offset) if fo.offset >= 0 else offs.next
        print(
            f"  p{a.partition:04d} committed {committed}"
            f" head {offs.next} lag {lag}",
            file=out,
        )


def _group_desc_flags(p):
    p.add_argument("-topic", required=True, help="namespace.name")
    p.add_argument("-group", required=True)


cmd_group_desc.configure = _group_desc_flags
