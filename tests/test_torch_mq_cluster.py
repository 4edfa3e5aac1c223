"""The port's message queue as a cluster, on the CPU, with the JAX
package's outcome recorded beside each of the port's.

- tests/test_mq_replication.py's scenarios, each on a port cluster (a
  master and three brokers) and on a JAX one: an acked publish reaches
  the successor's log, a committed offset replicates, a late successor is
  backfilled, the owner's death loses no acked record and the group
  resumes from its committed offset, and a rejoining ex-owner reconciles
  before it appends.
- tests/test_mq_tier.py's seal, upload, evict and read-through, into each
  package's own filer: a ``PartitionLog`` over ``FilerSegmentTier``, a
  fresh log that recovers from the tier alone, and a broker's
  ``SealSegments(evict=true)``.
- ``mq.benchmark``, ``cli mq.topic.configure`` / ``mq.topic.list`` and
  the shell's six ``mq.*`` commands of both packages against the same
  port brokers: equal text.
- ``-notify mq://``: a filer of each package publishes its metadata
  events into a port broker, one event per mutation, keyed by directory;
  the two topics hold equal events (``ts_ns`` masked) in the filers' own
  stamp order within each directory.  The admin's MQ pages of both
  packages answer equal topic inventories and details.

Every wait polls with a deadline."""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import tempfile
import types
from contextlib import redirect_stdout

import pytest

from gateway_stacks import http_req, isolated_env, pkg, stacks_fixture, wait

from seaweedfs_tpu_torch.mq import MqBroker, MqClient

SEG = 256


def _mods(name: str):
    mq = pkg(name, "mq")
    return types.SimpleNamespace(
        MqBroker=mq.MqBroker, MqClient=mq.MqClient,
        partition_replicas=pkg(name, "mq.balancer").partition_replicas,
        MasterServer=pkg(name, "server.master_server").MasterServer,
        log_store=pkg(name, "mq.log_store"), tier=pkg(name, "mq.tier"),
        mq_pb2=pkg(name, "pb.mq_pb2"))


class _MqCluster:
    """A master and ``n`` brokers of one package, with a fast-aging
    registry so failover runs at test speed."""

    def __init__(self, name: str, n: int = 3):
        self.m = _mods(name)
        self.root = tempfile.mkdtemp(prefix=f"torch-mqc-{name}-")
        self.master = self.m.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        self.master.start()
        self.master.registry.ttl = 2.0
        self.brokers = []
        for i in range(n):
            b = self.m.MqBroker(os.path.join(self.root, f"b{i}"), self.master.advertise,
                                grpc_port=0, register_interval=0.4)
            b.start()
            self.brokers.append(b)
        wait(lambda: all(len(b.live_brokers()) == n for b in self.brokers),
             f"{name} brokers to see each other")

    def owner_and_successor(self, topic: str, p: int = 0):
        live = self.brokers[0].live_brokers()
        ranked = self.m.partition_replicas(live, "default", topic, p, 2)
        by_addr = {b.advertise: b for b in self.brokers}
        return by_addr[ranked[0]], by_addr[ranked[1]]

    def stop(self) -> None:
        for b in self.brokers:
            b.stop()
        self.master.stop()
        shutil.rmtree(self.root, ignore_errors=True)


@pytest.fixture(scope="module")
def mq_clusters():
    made = {}
    try:
        for name in ("port", "jax"):
            made[name] = _MqCluster(name)
        yield made
    finally:
        for c in made.values():
            c.stop()


def _both(clusters, scenario):
    got = {name: scenario(c) for name, c in clusters.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---- replication (tests/test_mq_replication.py on each package) --------

def test_publish_reaches_the_successor_as_jax(mq_clusters):
    def scenario(c):
        client = c.m.MqClient(c.brokers[0].advertise)
        client.configure_topic("repl-t", partitions=1)
        acks = [client.publish("repl-t", b"k%d" % i, b"v%d" % i) for i in range(10)]
        owner, successor = c.owner_and_successor("repl-t")
        log = successor.partition_log("default", "repl-t", 0)
        return (owner is not successor, acks, log.next_offset,
                [(m.offset, m.value) for m in log.read(0)])

    got = _both(mq_clusters, scenario)
    assert got[0] is True and got[2] == 10 and got[3][:2] == [(0, b"v0"), (1, b"v1")]


def test_commit_replicates_as_jax(mq_clusters):
    def scenario(c):
        client = c.m.MqClient(c.brokers[0].advertise)
        client.configure_topic("repl-o", partitions=1)
        for i in range(5):
            client.publish("repl-o", b"k", b"v%d" % i)
        client.commit_offset("repl-o", "g1", 0, 3)
        _owner, successor = c.owner_and_successor("repl-o")
        return successor.offset_store("default", "repl-o", 0).fetch("g1")

    assert _both(mq_clusters, scenario) == 3


def test_late_successor_backfilled_as_jax(mq_clusters):
    def scenario(c):
        client = c.m.MqClient(c.brokers[0].advertise)
        client.configure_topic("repl-b", partitions=1)
        owner, successor = c.owner_and_successor("repl-b")
        log = owner.partition_log("default", "repl-b", 0)
        for i in range(7):
            log.append(b"", b"old%d" % i)
        ack = client.publish("repl-b", b"k", b"new")
        slog = successor.partition_log("default", "repl-b", 0)
        wait(lambda: slog.next_offset == 8, "the backfill", 10)
        return ack, [m.value for m in slog.read(0)]

    got = _both(mq_clusters, scenario)
    assert got == ((0, 7), [b"old%d" % i for i in range(7)] + [b"new"])


def test_rejoining_ex_owner_reconciles_as_jax(mq_clusters):
    def scenario(c):
        client = c.m.MqClient(c.brokers[0].advertise)
        client.configure_topic("repl-r", partitions=1)
        owner, successor = c.owner_and_successor("repl-r")
        slog = successor.partition_log("default", "repl-r", 0)
        for i in range(6):
            slog.append(b"", b"missed%d" % i)
        successor.offset_store("default", "repl-r", 0).commit("g", 4)
        olog = owner.partition_log("default", "repl-r", 0)
        before = olog.next_offset
        owner.ensure_caught_up("default", "repl-r", 0, olog)
        return (before, olog.next_offset, [m.value for m in olog.read(0)],
                owner.offset_store("default", "repl-r", 0).fetch("g"),
                client.publish("repl-r", b"k", b"fresh"))

    got = _both(mq_clusters, scenario)
    assert got == (0, 6, [b"missed%d" % i for i in range(6)], 4, (0, 6))


def test_owner_death_zero_loss_and_offset_resume_as_jax():
    """Kill the partition owner: the successor serves every acked record
    and the committed offset, and the offsets continue without a fork."""
    outs = {}
    for name in ("port", "jax"):
        c = _MqCluster(name)
        try:
            client = c.m.MqClient(c.brokers[0].advertise)
            client.configure_topic("repl-f", partitions=1)
            for i in range(20):
                client.publish("repl-f", b"k%d" % i, b"m%d" % i)
            client.commit_offset("repl-f", "g", 0, 12)
            owner, successor = c.owner_and_successor("repl-f")
            owner.stop()
            c.brokers.remove(owner)
            wait(lambda: owner.advertise not in c.brokers[0].live_brokers(),
                 "the registry to age the owner out", 15)
            new_owner = c.m.partition_replicas(c.brokers[0].live_brokers(), "default",
                                               "repl-f", 0, 1)[0]
            c2 = c.m.MqClient(successor.advertise)
            got = [m.value for m in c2.subscribe_partition("repl-f", 0, start_offset=0,
                                                           refresh=True)]
            outs[name] = (new_owner == successor.advertise, got,
                          c2.fetch_offset("repl-f", "g", 0),
                          c2.publish("repl-f", b"k", b"after-failover"))
        finally:
            c.stop()
    assert outs["port"] == outs["jax"]
    assert outs["port"] == (True, [b"m%d" % i for i in range(20)], 12, (0, 20))


# ---- the filer tier (tests/test_mq_tier.py on each package) -------------

@pytest.fixture(scope="module")
def stacks():
    yield from stacks_fixture("torch-mqtier-")


@pytest.fixture()
def small_segments(monkeypatch):
    for name in ("port", "jax"):
        monkeypatch.setattr(pkg(name, "mq.log_store"), "SEGMENT_BYTES", SEG)


def test_seal_upload_evict_readthrough_as_jax(stacks, small_segments, tmp_path):
    outs = {}
    for name, s in stacks.items():
        m = _mods(name)
        tier = m.tier.FilerSegmentTier(s.filer.url)
        log = m.log_store.PartitionLog(str(tmp_path / name / "p0"), tier=tier,
                                       tier_path="ns1/t1/p0000")
        for i in range(40):
            log.append(b"k%02d" % i, b"payload-%02d-" % i + b"x" * 40)
        sealed = log.seal_to_columnar()
        local = sorted(f for f in os.listdir(log.dir) if f.endswith(".npz"))
        listed = tier.list("ns1/t1/p0000")
        sizes = {n: os.path.getsize(os.path.join(log.dir, n)) for n in local}
        evicted = log.evict_tiered()
        left = [f for f in os.listdir(log.dir) if f.endswith(".npz")]
        keys = [msg.key for msg in log.read(0)]
        log.close()
        fresh = m.log_store.PartitionLog(str(tmp_path / name / "fresh"), tier=tier,
                                         tier_path="ns1/t1/p0000")
        vals = [msg.key for msg in fresh.read(0)]
        top = fresh.next_offset
        post = fresh.append(b"", b"post-loss")
        fresh.close()
        outs[name] = (sealed, local, listed == sizes, evicted, left, keys, vals, top, post)
    assert outs["port"] == outs["jax"]
    sealed, local, same, evicted, left, keys, vals, top, post = outs["port"]
    assert sealed > 0 and local and same and evicted == len(local) and left == []
    assert keys == [b"k%02d" % i for i in range(40)]
    assert vals == keys[:len(vals)] and len(vals) == top == post and top > 0


def test_broker_seal_evict_rpc_as_jax(stacks, small_segments, tmp_path):
    outs = {}
    for name, s in stacks.items():
        m = _mods(name)
        s.master.registry.ttl = 2.0
        d = str(tmp_path / name)
        b = m.MqBroker(d, s.master.advertise, grpc_port=0, register_interval=0.4,
                       filer_http=s.filer.url)
        b.start()
        try:
            wait(lambda: b.live_brokers() == [b.advertise], "the broker alone in the registry")
            client = m.MqClient(b.advertise)
            client.configure_topic("tiered", partitions=1)
            for i in range(40):
                client.publish("tiered", b"k", b"rec-%02d" % i)
            resp = b.stub(b.advertise).SealSegments(m.mq_pb2.SealSegmentsRequest(evict=True))
            pdir = os.path.join(d, "default", "tiered", "p0000")
            left = [f for f in os.listdir(pdir) if f.endswith(".npz")]
            got = [msg.value for msg in client.subscribe_partition("tiered", 0, start_offset=0)]
            tiered = sorted(m.tier.FilerSegmentTier(s.filer.url).list("default/tiered/p0000"))
            outs[name] = (resp.sealed_count, left, got, len(tiered))
        finally:
            b.stop()
        wait(lambda: not s.master.registry.list("broker"), "the broker to age out", 15)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] > 0 and outs["port"][1] == [] and outs["port"][3] > 0
    assert outs["port"][2] == [b"rec-%02d" % i for i in range(40)]


# ---- commands against the same port brokers -----------------------------

@pytest.fixture(scope="module")
def port_brokers():
    """A port master and two port brokers at the JAX default -replication 2."""
    c = _MqCluster("port", n=2)
    try:
        yield c
    finally:
        c.stop()


def _addr_names(c) -> dict:
    return {b: f"<broker{i}>" for i, b in enumerate(sorted(b.advertise for b in c.brokers))}


def _sub(text: str, names: dict) -> str:
    for a, n in names.items():
        text = text.replace(a, n)
    return text


def test_mq_benchmark_matches_jax(port_brokers):
    outs = []
    for name in ("port", "jax"):
        run = pkg(name, "commands.mq_cmd").run_mq_benchmark
        reports = run(port_brokers.brokers[0].advertise, count=400, size=512, concurrency=4,
                      partitions=2, topic=f"bench-{name}")
        outs.append([(r["phase"], r["requests"], r["errors"], sorted(r)) for r in reports])
        pub = reports[0]
        assert pub["req_per_sec"] > 0 and pub["p99_ms"] >= pub["p50_ms"]
    assert outs[0] == outs[1]
    assert [o[:3] for o in outs[0]] == [("publish", 400, 0), ("consume", 400, 0)]


def test_cli_mq_topic_commands_match_jax(port_brokers):
    broker = port_brokers.brokers[0].advertise
    outs = []
    for name in ("port", "jax"):
        cli = pkg(name, "cli")
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc1 = cli.main(["mq.topic.configure", "-broker", broker, "-topic", "cli-t",
                            "-partitions", "3"])
            rc2 = cli.main(["mq.topic.list", "-broker", broker])
        outs.append((rc1, rc2, buf.getvalue()))
    assert outs[0] == outs[1]
    assert "default/cli-t  partitions=3" in outs[0][2]


def test_shell_mq_commands_match_jax(port_brokers, small_segments):
    """Each read-only command runs in both shells on one state; each
    mutating one (configure, compact) runs in each shell on a fresh topic
    of equal content."""
    c = port_brokers
    names = _addr_names(c)
    shells = {}
    for name in ("port", "jax"):
        env = pkg(name, "shell.command_env").CommandEnv(c.master.grpc_address,
                                                        client_name=f"mq-{name}")
        shells[name] = (pkg(name, "shell"), env)
    client = MqClient(c.brokers[0].advertise, "sh")

    def run(name, *argv):
        shell, env = shells[name]
        out = io.StringIO()
        shell.run_command(env, list(argv), out)
        return re.sub(r"-(port|jax)\b", "-<pkg>", _sub(out.getvalue(), names))

    outs = {"port": [], "jax": []}
    for name in outs:
        outs[name].append(run(name, "mq.topic.configure", "-topic", f"sh.events-{name}",
                              "-partitionCount", "3"))
    for name in outs:
        for i in range(30):
            client.publish(f"events-{name}", b"k%d" % i, b"v%d" % i * 20)
        client.commit_offset(f"events-{name}", "shg", 0, 2)
    for argv in (["mq.topic.list"], ["mq.topic.desc", "-topic", "sh.events-port"],
                 ["mq.topic.desc", "-topic", "sh.events-jax"], ["mq.balance"],
                 ["mq.group.desc", "-topic", "sh.events-port", "-group", "shg"]):
        for name in outs:
            outs[name].append(run(name, *argv))
    for argv in (["lock"], ["mq.topic.compact"], ["unlock"]):
        run("port", *argv)  # seal what the topics above hold: not compared
    for name in outs:
        # a fresh topic of equal content for each shell's compact to seal
        client.configure_topic(f"compact-{name}", partitions=1)
        for i in range(30):
            client.publish(f"compact-{name}", b"k", b"c%d" % i * 20)
        outs[name] += [run(name, "lock"), run(name, "mq.topic.compact"), run(name, "unlock")]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == "topic sh.events-<pkg>: 3 partitions\n"
    assert "sh.events-<pkg>\tpartitions:3" in outs["port"][1]
    assert "lag" in outs["port"][5]
    compact = outs["port"][7].splitlines()
    assert compact[-1].endswith("messages moved to the columnar tier")
    assert int(compact[-1].split()[0]) > 0


def _admin_pages(name: str, master_grpc: str, names: dict):
    admin = pkg(name, "admin").AdminServer(master_grpc, port=0)
    admin.start()
    try:
        pages = []
        for path in ("/mq/topics", "/mq/topic?namespace=default&name=admin-t",
                     "/mq/topic?name=missing"):
            status, body, _h = http_req(admin.url, "GET", path)
            pages.append((status, _sub(body.decode(), names)))
        return pages
    finally:
        admin.stop()


def test_notify_mq_and_admin_pages_match_jax(stacks, port_brokers):
    c = port_brokers
    broker = c.brokers[0].advertise
    client = MqClient(broker)
    client.configure_topic("admin-t", partitions=2)
    for i in range(9):
        client.publish("admin-t", b"k%d" % i, b"v")
    client.commit_offset("admin-t", "ag", 1, 2)
    mp = isolated_env()
    events = {}
    try:
        for name, s in stacks.items():
            topic = f"filer-events-{name}"
            fs = pkg(name, "server.filer_server").FilerServer(
                s.master.grpc_address, port=0, grpc_port=0, notify=f"mq://{broker}/{topic}")
            fs.start()
            try:
                emod = pkg(name, "filer.entry")
                f = fs.filer
                mutations = 0
                for d in ("/n/a", "/n/b", "/n/c"):
                    for i in range(4):
                        f.create_entry(emod.Entry(f"{d}/f{i}", attr=emod.Attr.now(),
                                                  content=b"x" * (i + 1)))
                        mutations += 1
                f.delete_entry("/n/a/f0")
                f.rename("/n/b/f1", "/n/c/moved")
                mutations += 2
                expected = [e for e in f.meta_log.events if e.directory.startswith("/n")]
                wait(lambda: fs._notifier.delivered >= len(f.meta_log.events),
                     "the notifier to deliver every event")
                assert fs._notifier.errors == 0 and fs._notifier.dropped == 0
            finally:
                fs.stop()
            got = [json.loads(m.value) for m in client.consume_all(topic)]
            by_dir = {}
            for ev in got:
                by_dir.setdefault(ev["directory"], []).append(ev)
            for d, evs in by_dir.items():
                stamps = [e["ts_ns"] for e in evs]
                assert stamps == sorted(stamps), d
                assert stamps == [e.ts_ns for e in f.meta_log.events if e.directory == d], d
            ours = [e for e in got if e["directory"].startswith("/n")]
            assert len(ours) == len(expected) >= mutations
            events[name] = sorted((e["directory"], e["old_path"] or "", e["new_path"] or "",
                                   e["is_directory"], e["size"]) for e in ours)
    finally:
        mp.undo()
    assert events["port"] == events["jax"]
    names = _addr_names(c)
    pages = {name: _admin_pages(name, c.master.grpc_address, names) for name in ("port", "jax")}
    assert pages["port"] == pages["jax"]
    topics = json.loads(pages["port"][0][1])
    assert pages["port"][0][0] == 200 and len(topics["brokers"]) == 2
    assert {"admin-t", "filer-events-port", "filer-events-jax"} <= {
        t["name"] for t in topics["topics"]}
    detail = json.loads(pages["port"][1][1])
    assert [p["next"] for p in detail["partitions"]] != [0, 0]
    assert pages["port"][2][0] in (404, 502)
    assert re.search(r"<broker[01]>", pages["port"][0][1])
