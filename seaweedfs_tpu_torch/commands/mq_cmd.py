"""mq.broker daemon + mq.topic.* client subcommands.

Counterpart of the reference's `weed mq.broker` / `weed mq.topic.*`
commands (weed/command/mq_broker.go).

The port's copy of seaweedfs_tpu/commands/mq_cmd.py.
"""

from __future__ import annotations

import time

from seaweedfs_tpu_torch.commands import command


@command("mq.broker", "run a message-queue broker")
def run_broker(args) -> int:
    from seaweedfs_tpu_torch.mq import MqBroker

    b = MqBroker(
        args.dir,
        args.master,
        ip=args.ip,
        grpc_port=args.port,
        replication=args.replication,
        filer_http=args.filer,
    )
    b.start()
    print(f"mq broker on {b.advertise} (data {args.dir})", flush=True)
    try:
        while True:
            time.sleep(args.sealEvery)
            sealed = b.seal_old_segments(evict=bool(args.filer))
            if sealed:
                print(f"[mq] sealed {sealed} messages into columnar tier", flush=True)
    except KeyboardInterrupt:
        b.stop()
        return 0


def _broker_flags(p):
    p.add_argument("-dir", default="./mq-data", help="partition log directory")
    p.add_argument("-master", default="127.0.0.1:9333", help="master HTTP address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=17777, help="broker gRPC port")
    p.add_argument(
        "-sealEvery", type=float, default=300.0,
        help="seconds between columnar-tier sweeps",
    )
    p.add_argument(
        "-replication", type=int, default=2,
        help="default copies per partition incl. the owner "
        "(topics may override at configure time)",
    )
    p.add_argument(
        "-filer", default="",
        help="filer HTTP address: sealed archives tier into the filer "
        "and evict from broker disk (read-through serves them)",
    )


run_broker.configure = _broker_flags


def run_mq_benchmark(
    broker: str,
    *,
    count: int = 5000,
    size: int = 1024,
    concurrency: int = 8,
    partitions: int = 4,
    replication: int = 0,
    topic: str = "mq-benchmark",
) -> list[dict]:
    """Programmatic publish/consume load run (tests use this); returns
    phase reports shaped like `cli benchmark`'s."""
    import random
    import threading
    import time

    from seaweedfs_tpu_torch.commands.benchmark_cmd import _Stats
    from seaweedfs_tpu_torch.mq import MqClient

    client = MqClient(broker)
    client.configure_topic(
        topic, partitions=partitions, replication=replication
    )
    payload = random.randbytes(size)

    pub = _Stats()

    def publisher(n: int, seed: int) -> None:
        # NOTE: MqClient stubs ride rpc.cached_channel — all threads
        # multiplex ONE gRPC channel per broker address, like real
        # clients in one process.  The numbers measure that shape.
        c = MqClient(broker)
        for i in range(n):
            try:
                t0 = time.perf_counter()
                c.publish(topic, b"k%d-%d" % (seed, i), payload)
                pub.ok(time.perf_counter() - t0, size)
            except Exception as e:  # noqa: BLE001
                pub.fail(str(e))

    per = count // concurrency
    extra = count - per * concurrency
    threads = [
        threading.Thread(
            target=publisher, args=(per + (1 if i < extra else 0), i)
        )
        for i in range(concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reports = [pub.report("publish", time.perf_counter() - t0)]

    sub = _Stats()

    def consumer(p: int) -> None:
        c = MqClient(broker)
        try:
            t_prev = time.perf_counter()
            for m in c.subscribe_partition(topic, p, start_offset=0):
                now = time.perf_counter()
                sub.ok(now - t_prev, len(m.value))
                t_prev = now
        except Exception as e:  # noqa: BLE001
            sub.fail(str(e))

    threads = [
        threading.Thread(target=consumer, args=(p,))
        for p in range(partitions)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reports.append(sub.report("consume", time.perf_counter() - t0))
    return reports


@command("mq.benchmark", "publish/consume load run against a broker")
def run_mq_benchmark_cmd(args) -> int:
    import json

    reports = run_mq_benchmark(
        args.broker,
        count=args.n,
        size=args.size,
        concurrency=args.c,
        partitions=args.partitions,
        replication=args.replication,
        topic=args.topic,
    )
    for r in reports:
        print(json.dumps(r))
    return 0


def _mq_bench_flags(p):
    p.add_argument("-broker", default="127.0.0.1:17777", help="broker gRPC")
    p.add_argument("-n", type=int, default=5000, help="records to publish")
    p.add_argument("-size", type=int, default=1024, help="record bytes")
    p.add_argument("-c", type=int, default=8, help="concurrent publishers")
    p.add_argument("-partitions", type=int, default=4)
    p.add_argument(
        "-replication", type=int, default=0,
        help="copies per partition incl. owner (0 = broker default)",
    )
    p.add_argument("-topic", default="mq-benchmark")


run_mq_benchmark_cmd.configure = _mq_bench_flags


@command("mq.topic.configure", "create/resize a topic")
def run_topic_configure(args) -> int:
    from seaweedfs_tpu_torch.mq import MqClient

    MqClient(args.broker, args.namespace).configure_topic(
        args.topic, args.partitions
    )
    print(f"topic {args.namespace}/{args.topic}: {args.partitions} partitions")
    return 0


def _topic_flags(p):
    p.add_argument("-broker", default="127.0.0.1:17777")
    p.add_argument("-namespace", default="default")
    p.add_argument("-topic", required=True)
    p.add_argument("-partitions", type=int, default=4)


run_topic_configure.configure = _topic_flags


@command("mq.topic.list", "list topics on a broker")
def run_topic_list(args) -> int:
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import mq_pb2 as mq

    stub = rpc.make_stub(args.broker, mq, "MqBroker")
    for info in stub.ListTopics(mq.ListTopicsRequest()).topics:
        print(
            f"{info.topic.namespace or 'default'}/{info.topic.name}"
            f"  partitions={info.partition_count}"
        )
    return 0


run_topic_list.configure = lambda p: p.add_argument(
    "-broker", default="127.0.0.1:17777"
)
