"""The port's raft (seaweedfs_tpu_torch/cluster/raft.py) against the JAX
package's (seaweedfs_tpu/cluster/raft.py), on the CPU.

The scenarios of tests/test_raft.py (election, replication, partitions,
check-quorum, pre-vote, self-removal, passive joiners, snapshot install,
segment truncation and compaction) run over an in-memory switchboard in
three groups: port nodes only, two port nodes and one JAX node, and one
port node and two JAX nodes, so the two packages elect, commit, remove
members and install snapshots across each other.  The on-disk layout is
held both ways: a node of one package restarts on the other's data dir and
resumes its term, vote, log, members and snapshot; the segment files and
the master's ``master.meta.json`` are byte-identical for the same inputs.
Two liveness faults the port repairs (and the JAX module keeps) have a
test each: a self-removing leader's commit rule and the pre-vote's notion
of hearing from a leader.

Timers: heartbeat 0.05 s, election timeouts 0.3-0.6 s; every wait has a
deadline of 30 s.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from seaweedfs_tpu.cluster import raft as jax_raft
from seaweedfs_tpu_torch.cluster import raft as port_raft

PKG = {"port": port_raft, "jax": jax_raft}
# group name -> the package of n0, n1, n2 (larger groups repeat the pattern)
GROUPS = {
    "port": ("port", "port", "port"),
    "2port_1jax": ("port", "port", "jax"),
    "1port_2jax": ("port", "jax", "jax"),
}
FAST = dict(heartbeat=0.05, election_timeout=(0.3, 0.6))
DEADLINE = 30.0


def wait_for(pred, timeout=DEADLINE, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class Net:
    """In-memory transport: calls peers directly, honoring cut links, with
    every payload and answer serialized through JSON as the HTTP transport
    does."""

    def __init__(self):
        self.nodes: dict = {}
        self.cut: set[frozenset] = set()
        self.lock = threading.Lock()

    def isolate(self, nid):
        with self.lock:
            for other in self.nodes:
                if other != nid:
                    self.cut.add(frozenset((nid, other)))

    def heal(self):
        with self.lock:
            self.cut.clear()

    def transport(self, src):
        net = self

        class T:
            def call(self, peer, rpc, payload):
                with net.lock:
                    blocked = frozenset((src, peer)) in net.cut
                    node = net.nodes.get(peer)
                if blocked or node is None:
                    raise ConnectionError(f"{src}->{peer} cut")
                answer = node.handle_rpc(rpc, json.loads(json.dumps(payload)))
                return json.loads(json.dumps(answer))

        return T()


def kind_of(group: str, i: int) -> str:
    kinds = GROUPS[group]
    return kinds[i % len(kinds)]


def make_node(kind, nid, members, data_dir, net, applied=None, **kw):
    opts = dict(FAST, **kw)
    if applied is not None:
        opts.update(
            apply_fn=lambda cmd: applied[nid].append(cmd),
            snapshot_fn=lambda: {"count": len(applied[nid])},
            restore_fn=lambda state: applied[nid].extend(
                [{"_snap": True}] * (state["count"] - len(applied[nid]))),
        )
    node = PKG[kind].RaftNode(nid, members, data_dir, net.transport(nid), **opts)
    net.nodes[nid] = node
    return node


def make_cluster(tmp_path, net, group, n=3, applied=None, **kw):
    ids = [f"n{i}" for i in range(n)]
    nodes = [make_node(kind_of(group, i), nid, ids, str(tmp_path / nid), net, applied, **kw)
             for i, nid in enumerate(ids)]
    for node in nodes:
        node.start()
    return nodes


def leader_of(nodes):
    leaders = [n for n in nodes if n.is_leader]
    return leaders[0] if len(leaders) == 1 else None


def wait_leader(nodes, timeout=DEADLINE):
    """The one node that leads, waited for.  The lookup that ends the wait
    is the one returned: a second lookup can land mid-election (under load,
    a follower's timer fires between the two) and find none, or two."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ldr = leader_of(nodes)
        if ldr is not None:
            return ldr
        time.sleep(0.02)
    return None


def propose_as_leader(nodes, cmd, timeout=DEADLINE):
    """Propose against whoever leads, re-resolving only when the leader was
    deposed between the lookup and the propose (test_raft.py's helper)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ldr = leader_of(nodes)
        if ldr is None:
            time.sleep(0.02)
            continue
        if ldr.propose(cmd):
            return ldr
        if ldr.is_leader:
            return None  # a stable leader failed to commit: surface it
        time.sleep(0.02)
    return None


def remove_self_as_leader(nodes, timeout=DEADLINE):
    deadline = time.time() + timeout
    while time.time() < deadline:
        ldr = leader_of(nodes)
        if ldr is None:
            time.sleep(0.02)
            continue
        if ldr.remove_member(ldr.id):
            return ldr
        if ldr.is_leader:
            return None
        time.sleep(0.02)
    return None


def package_of(node) -> str:
    return "port" if isinstance(node, port_raft.RaftNode) else "jax"


def stop_all(net):
    for n in list(net.nodes.values()):
        n.stop()


group_params = pytest.mark.parametrize("group", list(GROUPS))


@group_params
def test_single_leader_elected_and_replicates(tmp_path, group):
    net = Net()
    applied = {f"n{i}": [] for i in range(3)}
    nodes = make_cluster(tmp_path, net, group, applied=applied)
    try:
        ldr = propose_as_leader(nodes, {"k": 0})
        assert ldr is not None
        for i in range(1, 5):
            assert propose_as_leader(nodes, {"k": i}) is not None
        assert wait_for(lambda: all(len(applied[n.id]) == 5 for n in nodes))
        assert [c["k"] for c in applied["n0"]] == list(range(5))
        for n in nodes:
            assert applied[n.id] == applied["n0"]
        follower = next(n for n in nodes if not n.is_leader)
        assert not follower.propose({"k": 99}, timeout=0.2)
    finally:
        stop_all(net)


@group_params
def test_leader_partition_failover_and_log_convergence(tmp_path, group):
    net = Net()
    applied = {f"n{i}": [] for i in range(3)}
    nodes = make_cluster(tmp_path, net, group, applied=applied)
    try:
        old = propose_as_leader(nodes, {"k": "committed"})
        assert old is not None
        net.isolate(old.id)
        # the old leader's write cannot commit (no majority)
        assert not old.propose({"k": "lost"}, timeout=0.5)
        rest = [n for n in nodes if n.id != old.id]
        assert propose_as_leader(rest, {"k": "after"}) is not None
        net.heal()
        assert wait_for(lambda: all([c.get("k") for c in applied[n.id]] == ["committed", "after"]
                                    for n in nodes)), {n.id: applied[n.id] for n in nodes}
    finally:
        stop_all(net)


@group_params
def test_restart_preserves_term_log_and_state(tmp_path, group):
    net = Net()
    applied = {f"n{i}": [] for i in range(3)}
    nodes = make_cluster(tmp_path, net, group, applied=applied)
    try:
        for i in range(4):
            assert propose_as_leader(nodes, {"k": i}) is not None
        victim = next(n for n in nodes if not n.is_leader)
        vid, kind = victim.id, package_of(victim)
        assert wait_for(lambda: len(applied[vid]) == 4)
        victim.stop()
        del net.nodes[vid]
        rest = [n for n in nodes if n.id != vid]
        assert propose_as_leader(rest, {"k": 4}) is not None
        applied[vid] = []
        reborn = PKG[kind].RaftNode(vid, [n.id for n in nodes], str(tmp_path / vid),
                                    net.transport(vid),
                                    apply_fn=lambda cmd: applied[vid].append(cmd), **FAST)
        assert reborn._last_index() >= 4  # the log survived the restart
        net.nodes[vid] = reborn
        reborn.start()
        assert wait_for(lambda: bool(applied[vid]) and applied[vid][-1].get("k") == 4)
    finally:
        stop_all(net)


@group_params
def test_snapshot_compaction_and_install_on_lagging_follower(tmp_path, group):
    net = Net()
    applied = {f"n{i}": [] for i in range(3)}
    nodes = make_cluster(tmp_path, net, group, applied=applied, snapshot_threshold=10)
    try:
        ldr = wait_leader(nodes)
        assert ldr is not None
        followers = [n for n in nodes if n is not ldr]
        # in a mixed group, lag a follower of the other package so the
        # snapshot crosses packages
        lagger = next((n for n in followers if package_of(n) != package_of(ldr)), followers[0])
        net.isolate(lagger.id)
        sent = 0
        while sent < 30:
            ldr = propose_as_leader([n for n in nodes if n is not lagger], {"k": sent})
            assert ldr is not None
            sent += 1
        assert wait_for(lambda: ldr.status()["snapshot_index"] > 0)
        net.heal()
        assert wait_for(lambda: lagger.commit_index == ldr.commit_index
                        and lagger.status()["snapshot_index"] > 0)
        # the state machine reflects all 30 commands (snapshot count + tail)
        assert wait_for(lambda: len(applied[lagger.id]) == 30), len(applied[lagger.id])
        with open(os.path.join(str(tmp_path / lagger.id), "raft.snap.json")) as f:
            snap = json.load(f)
        assert snap["members"] == ["n0", "n1", "n2"] and snap["state"]["count"] >= 10
    finally:
        stop_all(net)


@group_params
def test_membership_add_passive_joiner(tmp_path, group):
    net = Net()
    nodes = make_cluster(tmp_path, net, group)
    try:
        ldr = wait_leader(nodes)
        assert ldr is not None
        # the joiner is of the package the group has fewest of
        kinds = GROUPS[group]
        jkind = min(("port", "jax"), key=kinds.count) if "jax" in kinds else "port"
        joiner = make_node(jkind, "n3", [], str(tmp_path / "n3"), net)
        joiner.start()
        time.sleep(0.8)
        assert not joiner.is_leader  # stayed passive
        ldr = wait_leader(nodes)
        assert ldr is not None
        assert ldr.add_member("n3")
        assert wait_for(lambda: "n3" in joiner.members)
        assert propose_as_leader(nodes, {"k": "post-join"}) is not None
        assert wait_for(lambda: (cur := leader_of(nodes)) is not None
                        and joiner.commit_index >= cur.commit_index - 1)
        ldr = wait_leader(nodes)
        assert ldr.remove_member("n3")
        assert propose_as_leader(nodes, {"k": "post-remove"}) is not None
    finally:
        stop_all(net)


@group_params
def test_leader_self_removal_steps_down(tmp_path, group):
    net = Net()
    nodes = make_cluster(tmp_path, net, group)
    try:
        assert wait_for(lambda: leader_of(nodes) is not None)
        ldr = remove_self_as_leader(nodes)  # success, not a lost election
        assert ldr is not None
        assert wait_for(lambda: not ldr.is_leader)
        rest = [n for n in nodes if n is not ldr]
        assert wait_for(lambda: leader_of(rest) is not None)
        assert ldr.id not in leader_of(rest).members
        assert propose_as_leader(rest, {"k": "after-removal"}) is not None
        time.sleep(1.0)  # the removed node went passive: it never elects itself
        assert not ldr.is_leader
    finally:
        stop_all(net)


def test_self_removal_commits_only_on_a_majority_of_the_new_configuration(tmp_path):
    """A leader that removes itself must not count its own log toward the
    commit of the new configuration (Raft section 4.2.2): with one new
    member cut off, the entry stays uncommitted, and once it lands on both
    new members they elect among themselves.  The JAX module commits it on
    the leader and one follower, which can leave the cut-off member with
    the old configuration and no quorum to elect with."""
    net = Net()
    nodes = make_cluster(tmp_path, net, "port")
    try:
        ldr = wait_leader(nodes)
        assert ldr is not None
        a, b = [n for n in nodes if n is not ldr]
        with net.lock:
            net.cut.add(frozenset((ldr.id, b.id)))
        assert not ldr.remove_member(ldr.id, timeout=1.0)
        assert ldr.commit_index < ldr._last_index()
        assert ldr.is_leader and ldr.members == sorted([a.id, b.id])
        net.heal()
        assert wait_for(lambda: not ldr.is_leader)
        new = wait_leader([a, b])
        assert new is not None
        assert new.members == sorted([a.id, b.id])
        assert propose_as_leader([a, b], {"k": "after"}) is not None
    finally:
        stop_all(net)


def test_prevote_counts_leader_contact_not_the_own_election_timer(tmp_path):
    """A follower refuses a pre-vote only while it hears a leader: once the
    leader has been quiet for an election timeout it grants, even if its own
    election timer has just fired and restarted.  (The JAX module refuses
    then too, so two followers whose leader left can refuse each other's
    pre-votes round after round.)"""
    node = make_node("port", "n0", ["n0", "n1", "n2"], str(tmp_path / "n0"), Net())
    ok = node.handle_append_entries({"term": 1, "leader": "n2", "leader_meta": {},
                                     "prev_log_index": 0, "prev_log_term": 0, "entries": [],
                                     "leader_commit": 0})
    assert ok["success"]
    req = {"term": 2, "candidate": "n1", "last_log_index": 0, "last_log_term": 0,
           "pre_vote": True}
    assert not node.handle_pre_vote(req)["granted"]  # it hears its leader
    time.sleep(FAST["election_timeout"][0] + 0.05)  # the leader went quiet
    node._last_heard = time.monotonic()  # what the ticker does after its own attempt
    assert node.handle_pre_vote(req)["granted"]
    assert (node.term, node.voted_for) == (1, "")  # a pre-vote changes no state


@group_params
def test_partitioned_leader_steps_down_check_quorum(tmp_path, group):
    net = Net()
    nodes = make_cluster(tmp_path, net, group)
    try:
        old = wait_leader(nodes)
        assert old is not None
        net.isolate(old.id)
        # without quorum contact the leader demotes itself within about one
        # election timeout
        assert wait_for(lambda: not old.is_leader)
    finally:
        stop_all(net)


@group_params
def test_prevote_rejoining_follower_does_not_disrupt(tmp_path, group):
    net = Net()
    nodes = make_cluster(tmp_path, net, group)
    try:
        ldr = wait_leader(nodes)
        assert ldr is not None
        term_before = ldr.status()["term"]
        victim = next(n for n in nodes if not n.is_leader)
        net.isolate(victim.id)
        time.sleep(3.0)  # many election timeouts: pre-vote rounds fail, term stays
        assert victim.status()["term"] == term_before
        net.heal()
        time.sleep(1.0)
        assert ldr.is_leader
        assert ldr.status()["term"] == term_before
        assert wait_for(lambda: victim.commit_index == ldr.commit_index)
    finally:
        stop_all(net)


@group_params
def test_rejoined_minority_leader_discards_uncommitted(tmp_path, group):
    net = Net()
    applied = {f"n{i}": [] for i in range(5)}
    nodes = make_cluster(tmp_path, net, group, n=5, applied=applied)
    try:
        old = wait_leader(nodes)
        assert old is not None
        net.isolate(old.id)
        threading.Thread(target=lambda: old.propose({"k": "uncommitted"}, timeout=0.3),
                         daemon=True).start()
        rest = [n for n in nodes if n.id != old.id]
        assert propose_as_leader(rest, {"k": "winner"}) is not None
        net.heal()
        assert wait_for(lambda: all([c.get("k") for c in applied[n.id]] == ["winner"]
                                    for n in nodes)), {n.id: applied[n.id] for n in nodes}
    finally:
        stop_all(net)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_restart_replays_membership_from_log(tmp_path, writer, reader):
    """A restarted seed node comes back with the grown member set, whichever
    package wrote the log."""
    net = Net()
    solo = make_node(writer, "n0", ["n0"], str(tmp_path / "n0"), net)
    solo.start()
    for nid in ("n1", "n2"):  # passive joiners, reachable for replication
        make_node(writer, nid, [], str(tmp_path / nid), net).start()
    try:
        assert wait_for(lambda: solo.is_leader)
        assert solo.add_member("n1")
        assert solo.add_member("n2")
    finally:
        stop_all(net)
    time.sleep(0.05)
    reborn = PKG[reader].RaftNode("n0", ["n0"], str(tmp_path / "n0"), Net().transport("n0"),
                                  **FAST)
    assert reborn.members == ["n0", "n1", "n2"]
    reborn.stop()


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_torn_log_tail_truncated_on_load(tmp_path, writer, reader):
    net = Net()
    node = make_node(writer, "n0", ["n0"], str(tmp_path / "n0"), net)
    node.start()
    try:
        assert wait_for(lambda: node.is_leader)
        for i in range(3):
            assert node.propose({"k": i})
    finally:
        node.stop()
    time.sleep(0.05)
    # a crash mid-append: partial JSON on the tail of the active segment
    active = node._seglog._segments()[-1][1]
    with open(active, "a") as f:
        f.write('{"i": 99, "t"')
    reborn = PKG[reader].RaftNode("n0", ["n0"], str(tmp_path / "n0"), net.transport("n0"), **FAST)
    assert reborn._last_index() == 4  # no-op + 3 commands, the torn line dropped
    for _, path in reborn._seglog._segments():
        with open(path) as f:
            for line in f:
                json.loads(line)
    reborn.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_segmented_log_rolls_compacts_and_migrates(tmp_path, pkg):
    """Appends roll into bounded segments, compaction unlinks covered ones,
    truncation rewrites one boundary segment, a legacy single-file log
    migrates; and the port reads what ``pkg`` wrote at every step."""
    write, read = PKG[pkg].SegmentedLog, port_raft.SegmentedLog
    d = str(tmp_path / "segs")
    os.makedirs(d)
    log = write(d, segment_entries=10)
    log.append([{"i": i, "t": 1, "c": {"k": i}} for i in range(1, 36)])
    assert len(log._segments()) == 4  # 10 + 10 + 10 + 5
    assert [e["i"] for e in read(d, 10).load()] == list(range(1, 36))
    log.drop_through(25)
    remaining = log._segments()
    assert len(remaining) == 2 and remaining[0][0] == 21
    log.truncate_from(33)
    assert [e["i"] for e in read(d, 10).load()] == list(range(21, 33))
    log.append([{"i": 33, "t": 2, "c": {"k": "new"}}])
    assert [e["i"] for e in read(d, 10).load()][-1] == 33

    d2 = str(tmp_path / "legacy")
    os.makedirs(d2)
    with open(os.path.join(d2, "raft.log.jsonl"), "w") as f:
        for i in range(1, 6):
            f.write(json.dumps({"i": i, "t": 1, "c": {}}) + "\n")
    log2 = read(d2, 10)
    assert [e["i"] for e in log2.load()] == [1, 2, 3, 4, 5]
    assert not os.path.exists(os.path.join(d2, "raft.log.jsonl"))
    assert log2._segments()


def test_segment_files_byte_identical(tmp_path):
    """The same appends, truncation and compaction leave byte-identical
    segment files in both packages."""
    trees = {}
    for pkg, mod in PKG.items():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        log = mod.SegmentedLog(d, segment_entries=7)
        log.append([{"i": i, "t": 1 + i // 9, "c": {"seq": [i, i << 20]}} for i in range(1, 30)])
        log.truncate_from(24)
        log.append([{"i": 24, "t": 5, "c": {"_members": ["a:1", "b:2"]}}])
        log.drop_through(15)
        trees[pkg] = {name: open(os.path.join(d, name), "rb").read()
                      for name in sorted(os.listdir(d))}
    assert list(trees["port"]) == list(trees["jax"])
    assert trees["port"] == trees["jax"]
    assert all(name.startswith("raft.log.") and name.endswith(".jsonl") for name in trees["port"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_node_resumes_the_other_packages_data_dir(tmp_path, writer, reader):
    """A node of one package restarts on the other's data dir and resumes
    the same term, vote, log, members and snapshot, and keeps leading."""
    net = Net()
    applied = {"n0": []}
    state = {"count": 0}
    kw = dict(apply_fn=lambda cmd: applied["n0"].append(cmd),
              snapshot_fn=lambda: {"count": len(applied["n0"])},
              restore_fn=lambda st: state.update(st), snapshot_threshold=8, **FAST)
    node = PKG[writer].RaftNode("n0", ["n0"], str(tmp_path / "n0"), net.transport("n0"), **kw)
    node.start()
    try:
        assert wait_for(lambda: node.is_leader)
        for i in range(12):
            assert node.propose({"k": i})
        before = node.status()
        log_before = [dict(e) for e in node.log]
    finally:
        node.stop()
    time.sleep(0.05)
    with open(tmp_path / "n0" / "raft.state.json") as f:
        vote = json.load(f)
    assert vote == {"term": before["term"], "voted_for": "n0"}
    applied["n0"] = []
    reborn = PKG[reader].RaftNode("n0", ["n0"], str(tmp_path / "n0"), net.transport("n0"), **kw)
    assert (reborn.term, reborn.voted_for) == (before["term"], "n0")
    assert reborn.snap_index == before["snapshot_index"] > 0
    assert state["count"] == reborn.snap_index - 1  # commands only; the no-op is not applied
    assert reborn.log == log_before
    assert reborn._last_index() == before["last_index"]
    assert reborn.members == ["n0"]
    net.nodes["n0"] = reborn
    reborn.start()
    try:
        assert wait_for(lambda: reborn.is_leader)
        assert reborn.propose({"k": "resumed"})
        assert reborn.status()["term"] == before["term"] + 1
        assert applied["n0"][-1] == {"k": "resumed"}
    finally:
        reborn.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_master_meta_store_round_trip(tmp_path, writer, reader):
    """``master.meta.json`` and ``cluster.id``: either package's master
    reads what the other wrote, and both write the same bytes."""
    from seaweedfs_tpu.server import master_server as jax_ms
    from seaweedfs_tpu_torch.server import master_server as port_ms

    mods = {"jax": jax_ms, "port": port_ms}
    for pkg, mod in mods.items():
        mod.MasterMetaStore(str(tmp_path / pkg)).save(41, (1 << 40) + 7)
    assert ((tmp_path / "jax" / "master.meta.json").read_bytes()
            == (tmp_path / "port" / "master.meta.json").read_bytes())
    d = str(tmp_path / "shared")
    mods[writer].MasterMetaStore(d).save(17, 12345)
    assert mods[reader].MasterMetaStore(d).load() == {"max_volume_id": 17,
                                                      "file_key_ceiling": 12345}
    w = mods[writer].MasterServer(port=0, grpc_port=0, meta_dir=d)
    r = mods[reader].MasterServer(port=0, grpc_port=0, meta_dir=d)
    assert r.topology.sequence_watermarks()[0] == 17
    assert r.topology.next_volume_id() == 18
    assert w._durable_cluster_id() == r._durable_cluster_id() != ""
