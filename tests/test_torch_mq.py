"""The port's message queue (seaweedfs_tpu_torch/mq/) held against the JAX
package's, on the CPU.

- ``balancer``: rendezvous scores, partition owners and replica lists,
  group coordinators and key-to-partition hashes agree bit for bit over
  10,000 seeded keys and several broker sets (a JAX client and a port
  broker must agree on ownership).
- ``schema``: 10,000 seeded records of a nested record type encode to
  equal bytes, decode to equal values in either direction, and
  columnarise to equal arrays; inference and the JSON form agree.
- ``groups.assign_partitions`` and ``OffsetStore`` files.
- ``PartitionLog`` with a small ``SEGMENT_BYTES`` patched into both
  packages: equal segment bytes, equal archive arrays after
  ``seal_to_columnar``, and equal reads from every offset.
- The carry-over of a broker's data directory (``topics.json``, the
  partitions' ``.log`` segments, the columnar archives and the offset
  stores) both ways: a directory the JAX broker wrote opens in the port's
  broker and serves the same records, offsets and committed group
  offsets, and the reverse.
- Wire compatibility: a JAX ``MqClient`` against a port broker and a port
  ``MqClient`` against a JAX broker get the same partitions, offsets and
  records.

The tolerance is exact equality.  The columnar archives are compared by
their arrays (zip entries carry mtimes); timestamps stamped by two
different brokers are not compared."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.mq import balancer as jax_bal
from seaweedfs_tpu.mq import groups as jax_groups
from seaweedfs_tpu.mq import log_store as jax_ls
from seaweedfs_tpu.mq import schema as jax_schema
from seaweedfs_tpu.mq.agent import MqClient as JaxMqClient
from seaweedfs_tpu.mq.broker import MqBroker as JaxMqBroker
from seaweedfs_tpu_torch.mq import balancer as port_bal
from seaweedfs_tpu_torch.mq import groups as port_groups
from seaweedfs_tpu_torch.mq import log_store as port_ls
from seaweedfs_tpu_torch.mq import schema as port_schema
from seaweedfs_tpu_torch.mq.agent import MqClient as PortMqClient
from seaweedfs_tpu_torch.mq.broker import MqBroker as PortMqBroker

DEAD_MASTER = "127.0.0.1:1"  # nobody serves it: each broker routes alone


def _keys(n: int = 10_000, seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]


# ---- balancer -----------------------------------------------------------

def test_key_hash_and_scores_match_jax():
    keys = _keys()
    for count in (1, 3, 4, 16):
        assert [port_bal.hash_key_to_partition(k, count) for k in keys] == [
            jax_bal.hash_key_to_partition(k, count) for k in keys]
    for k in keys[:2000]:
        b = k.hex() or "x"
        assert port_bal.rendezvous_score(b, "ns/t", len(k)) == jax_bal.rendezvous_score(
            b, "ns/t", len(k))


@pytest.mark.parametrize("n_brokers", [1, 2, 3, 7])
def test_ownership_matches_jax(n_brokers):
    rng = np.random.default_rng(n_brokers)
    brokers = [f"10.0.{int(rng.integers(0, 255))}.{i}:{17777 + i}" for i in range(n_brokers)]
    for topic in ("t", "filer-events", "mq-benchmark", "orders"):
        for p in range(64):
            assert port_bal.partition_owner(brokers, "default", topic, p) == \
                jax_bal.partition_owner(brokers, "default", topic, p)
            for n in (1, 2, 3):
                assert port_bal.partition_replicas(brokers, "default", topic, p, n) == \
                    jax_bal.partition_replicas(brokers, "default", topic, p, n)
        for g in range(32):
            assert port_bal.group_coordinator(brokers, "ns", topic, f"g{g}") == \
                jax_bal.group_coordinator(brokers, "ns", topic, f"g{g}")
    assert port_bal.partition_owner([], "d", "t", 0) is jax_bal.partition_owner([], "d", "t", 0)


# ---- schema -------------------------------------------------------------

def _order_type(mod):
    return mod.RecordType([
        mod.Field("user", mod.STRING), mod.Field("amount", mod.DOUBLE),
        mod.Field("items", mod.INT64, is_list=True), mod.Field("paid", mod.BOOL),
        mod.Field("blob", mod.BYTES), mod.Field("count", mod.INT32),
        mod.Field("address", mod.RecordType([mod.Field("city", mod.STRING),
                                             mod.Field("zip", mod.INT64)]))])


def _records(n: int = 10_000, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = {"user": rng.bytes(int(rng.integers(0, 12))).hex(),
             "amount": float(rng.normal()) * 100,
             "items": [int(x) for x in rng.integers(-2**40, 2**40, int(rng.integers(0, 5)))],
             "paid": bool(rng.integers(0, 2)), "blob": rng.bytes(int(rng.integers(0, 30))),
             "count": int(rng.integers(-2**31, 2**31)),
             "address": {"city": f"c{int(rng.integers(0, 100))}",
                         "zip": int(rng.integers(0, 10**6))}}
        if i % 7 == 3:
            r.pop("amount")
        if i % 11 == 5:
            r.pop("address")
        out.append(r)
    return out


def test_schema_encodings_match_jax():
    prt, jrt = _order_type(port_schema), _order_type(jax_schema)
    assert prt.to_json() == jrt.to_json()
    assert port_schema.RecordType.from_json(jrt.to_json()).to_json() == prt.to_json()
    recs = _records()
    penc = [port_schema.encode_record(prt, r) for r in recs]
    jenc = [jax_schema.encode_record(jrt, r) for r in recs]
    assert penc == jenc
    assert [port_schema.decode_record(prt, b) for b in jenc] == [
        jax_schema.decode_record(jrt, b) for b in penc]
    pcols = port_schema.records_to_columns(prt, recs)
    jcols = jax_schema.records_to_columns(jrt, recs)
    assert sorted(pcols) == sorted(jcols)
    for k in pcols:
        assert pcols[k].dtype == jcols[k].dtype, k
        if pcols[k].dtype == object:
            assert list(pcols[k]) == list(jcols[k]), k
        else:
            np.testing.assert_array_equal(pcols[k], jcols[k], err_msg=k)
    assert port_schema.infer_record_type(recs[0]).to_json() == \
        jax_schema.infer_record_type(recs[0]).to_json()
    for bad in ([port_schema.Field("a", "float16")],):
        with pytest.raises(port_schema.SchemaError):
            port_schema.RecordType(bad)


# ---- groups -------------------------------------------------------------

def test_assign_partitions_and_offset_store_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    for _ in range(200):
        members = [f"c-{rng.bytes(4).hex()}" for _ in range(int(rng.integers(0, 9)))]
        count = int(rng.integers(0, 33))
        assert port_groups.assign_partitions(members, count) == \
            jax_groups.assign_partitions(members, count)
    for mod, d in ((port_groups, tmp_path / "p"), (jax_groups, tmp_path / "j")):
        os.makedirs(d)
        store = mod.OffsetStore(str(d))
        for g in range(5):
            store.commit(f"g{g}", g * 7)
        store.commit("g1", 99)
    files = sorted(os.listdir(tmp_path / "p"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert port_groups.OffsetStore(str(tmp_path / "j")).all() == \
        jax_groups.OffsetStore(str(tmp_path / "p")).all()


# ---- PartitionLog -------------------------------------------------------

@pytest.fixture()
def small_segments(monkeypatch):
    monkeypatch.setattr(port_ls, "SEGMENT_BYTES", 4096)
    monkeypatch.setattr(jax_ls, "SEGMENT_BYTES", 4096)


def _messages(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.bytes(int(rng.integers(0, 16))), rng.bytes(int(rng.integers(0, 700))),
             1_700_000_000_000_000_000 + i * 1000) for i in range(n)]


def _read_all(log, start):
    return [(m.offset, m.ts_ns, m.key, m.value) for m in log.read(start)]


def test_partition_log_matches_jax(small_segments, tmp_path):
    msgs = _messages(300, 1)
    logs = {}
    for name, mod in (("port", port_ls), ("jax", jax_ls)):
        log = mod.PartitionLog(str(tmp_path / name))
        assert [log.append_with_ts(k, v, ts) for k, v, ts in msgs] == [
            (i, ts) for i, (_k, _v, ts) in enumerate(msgs)]
        logs[name] = log
    segs = sorted(os.listdir(tmp_path / "port"))
    assert len(segs) > 10 and segs == sorted(os.listdir(tmp_path / "jax"))
    for f in segs:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    sealed = [logs[n].seal_to_columnar(keep_segments=2, upload=False) for n in logs]
    assert sealed[0] == sealed[1] > 200
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    archives = [f for f in files if f.endswith(".npz")]
    assert len(archives) == 1
    with np.load(tmp_path / "port" / archives[0]) as pz, \
            np.load(tmp_path / "jax" / archives[0]) as jz:
        assert sorted(pz.files) == sorted(jz.files)
        for k in pz.files:
            assert pz[k].dtype == jz[k].dtype
            np.testing.assert_array_equal(pz[k], jz[k], err_msg=k)
    for start in range(0, 302):
        assert _read_all(logs["port"], start) == _read_all(logs["jax"], start), start
    assert _read_all(logs["port"], 0) == [(i, ts, k, v) for i, (k, v, ts) in enumerate(msgs)]
    assert logs["port"].earliest_offset() == logs["jax"].earliest_offset() == 0
    # a log reopened by the other package recovers the same tail
    for name, mod in (("port", jax_ls), ("jax", port_ls)):
        logs[name].close()
        other = mod.PartitionLog(str(tmp_path / name))
        assert other.next_offset == 300
        assert other.append_external(300, 5, b"k", b"v") == "applied"
        assert other.append_external(300, 5, b"k", b"v") == "duplicate"
        assert other.append_external(302, 5, b"k", b"v") == "gap"
        other.close()


# ---- broker data-directory carry-over -----------------------------------

def _fill_broker(broker_cls, client_cls, d: str, seed: int):
    b = broker_cls(d, DEAD_MASTER, grpc_port=0, register_interval=60)
    b.start()
    try:
        c = client_cls(b.advertise)
        c.configure_topic("carry", partitions=4)
        c.configure_topic("typed", partitions=2,
                          record_type=_order_type(port_schema if client_cls is PortMqClient
                                                  else jax_schema))
        acks = [c.publish("carry", k, v) for k, v, _ts in _messages(400, seed)]
        for p in range(4):
            c.commit_offset("carry", "g1", p, 10 + p)
            c.commit_offset("carry", "g2", p, 3)
        b.seal_old_segments()
        return acks
    finally:
        b.stop()


def _observe_broker(broker_cls, client_cls, d: str):
    b = broker_cls(d, DEAD_MASTER, grpc_port=0, register_interval=60)
    b.start()
    try:
        c = client_cls(b.advertise)
        from seaweedfs_tpu_torch.pb import mq_pb2 as mq

        topics = [(t.topic.namespace, t.topic.name, t.partition_count, t.record_type_json,
                   t.replication)
                  for t in b.stub(b.advertise).ListTopics(mq.ListTopicsRequest()).topics]
        recs = {p: [(m.offset, m.ts_ns, m.key, m.value)
                    for m in c.subscribe_partition("carry", p, 0)] for p in range(4)}
        offs = {p: (c.fetch_offset("carry", "g1", p), c.fetch_offset("carry", "g2", p))
                for p in range(4)}
        po = b.stub(b.advertise).PartitionOffsets(
            mq.PartitionOffsetsRequest(topic=mq.Topic(namespace="default", name="carry"),
                                       partition=1))
        more = c.publish("carry", b"after", b"carry-over")
        return topics, recs, offs, (po.earliest, po.next, dict(po.group_offsets)), more
    finally:
        b.stop()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_broker_data_dir_carries_over(direction, small_segments, tmp_path):
    writer, reader = ((JaxMqBroker, JaxMqClient), (PortMqBroker, PortMqClient))
    if direction == "port-to-jax":
        writer, reader = reader, writer
    d = str(tmp_path / "mq")
    acks = _fill_broker(*writer, d, seed=4)
    copy = str(tmp_path / "mq-copy")
    shutil.copytree(d, copy)
    assert any(f.endswith(".npz") for _r, _d, fs in os.walk(d) for f in fs)
    assert os.path.exists(os.path.join(d, "topics.json"))
    got = _observe_broker(*reader, d)
    same = _observe_broker(*writer, copy)  # the writer's own package, same files
    assert got[:4] == same[:4]
    assert got[4] == same[4]
    topics, recs, offs, po, _more = got
    assert [t[1] for t in topics] == ["carry", "typed"]
    assert sum(len(v) for v in recs.values()) == 400
    assert sorted((p, o) for p, o in acks) == sorted(
        (p, r[0]) for p, rs in recs.items() for r in rs)
    assert offs == {p: (10 + p, 3) for p in range(4)}
    assert po[2] == {"g1": 11, "g2": 3}


# ---- wire compatibility -------------------------------------------------

@pytest.mark.parametrize("pair", ["jax-client-port-broker", "port-client-jax-broker"])
def test_clients_and_brokers_interoperate(pair, tmp_path):
    cross = ((PortMqBroker, JaxMqClient) if pair == "jax-client-port-broker"
             else (JaxMqBroker, PortMqClient))
    outs = []
    for i, (broker_cls, client_cls) in enumerate(
            (cross, (PortMqBroker, PortMqClient), (JaxMqBroker, JaxMqClient))):
        d = str(tmp_path / f"b{i}")
        b = broker_cls(d, DEAD_MASTER, grpc_port=0, register_interval=60)
        b.start()
        try:
            c = client_cls(b.advertise)
            c.configure_topic("wire", partitions=3)
            acks = [c.publish("wire", k, v) for k, v, _ts in _messages(150, 8)]
            for p in range(3):
                c.commit_offset("wire", "g", p, p + 1)
            recs = [(m.offset, m.key, m.value) for m in c.consume_all("wire")]
            look = c.lookup("wire", refresh=True)
            outs.append((acks, sorted(recs), [c.fetch_offset("wire", "g", p) for p in range(3)],
                         look.partition_count, [a.partition for a in look.assignments]))
        finally:
            b.stop()
    assert len(outs) == 3
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][2] == [1, 2, 3] and len(outs[0][1]) == 150
