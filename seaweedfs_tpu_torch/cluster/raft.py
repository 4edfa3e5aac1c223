"""Raft consensus for master HA: elections, replicated log, snapshots.

The port's copy of seaweedfs_tpu/cluster/raft.py, with the same on-disk
layout (``raft.state.json``, ``raft.log.<first_index>.jsonl``
segments of 256 entries, ``raft.snap.json``) and the same JSON bodies of
``/raft/<rpc>``, so a JAX master and a port master can share one raft
group and either can resume the other's data dir.  Two liveness faults of
the JAX module are repaired here (the wire and disk formats are
unchanged): a leader that removes itself counts only the new
configuration's members toward a commit (Raft §4.2.2; the JAX module
counts its own log, so a config entry could commit on a majority that
does not include a member and leave the remaining members without a
quorum), and a pre-vote is refused only for recent contact from a leader
(``_leader_contact``), not because the receiver's own election timer
fired (the JAX module conflates the two, so two followers whose leader
left can refuse each other's pre-votes round after round).

A compact, complete Raft (Ongaro & Ousterhout) replacing the reference's
embedded hashicorp/raft (weed/server/raft_hashicorp.go, raft_server.go;
Topology.RaftServer/HashicorpRaft seam at weed/topology/topology.go:51-53).
The master replicates its durable slice of state — sequence watermarks
(max volume id, file-key ceiling) and cluster membership — through the
log; everything else is rebuilt from volume-server heartbeats, exactly
as the reference's Raft snapshot does.

Design:
  * transport is injected (``call(peer_id, rpc, payload) -> dict``) —
    the master wires HTTP POST /raft/<rpc>; tests wire an in-memory
    switchboard with partitions.
  * persistent state per node in ``data_dir``: term/vote (JSON),
    append-only JSONL log, snapshot (state machine dict + membership).
  * membership changes are single-server config entries proposed through
    the log (cluster.raft.add / cluster.raft.remove shell commands).
  * nodes constructed without peers start passive (join mode): they
    answer RPCs but never start elections until a config entry or
    snapshot from a leader teaches them the member set — so a fresh
    joiner cannot disrupt an established leader with term inflation.
"""
# weedlint: disable-file=W010 — Raft correctness REQUIRES persistence under
# _mu: term/vote/log entries must be on disk before the node answers an RPC
# or counts its own vote (Ongaro §5.1 durability rules), so fsync under the
# state lock is the design, not contention debt; the RPC fan-out to peers
# (the actually-slow part) already happens outside _mu

from __future__ import annotations

import hashlib
import hmac
import http.client
import json
import os
import random
import threading
import time

from seaweedfs_tpu_torch.util import wlog

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

CONFIG_KEY = "_members"  # log command key carrying a membership change


class SegmentedLog:
    """Raft log persistence in bounded segments
    (``raft.log.<first_index>.jsonl``).

    The original single-JSONL layout rewrote the WHOLE log on conflict
    truncation and on every compaction — O(log size) each time, capping
    what the log could ever carry.  Segments bound every maintenance op:
    appends go to the active segment and roll at ``segment_entries``;
    truncation unlinks later segments and rewrites at most the one
    boundary segment; compaction just unlinks fully-covered segments
    (hashicorp/raft's LogStore segments serve the same role in the
    reference's master)."""

    def __init__(self, dir_path: str, segment_entries: int = 256):
        self.dir = dir_path
        self.segment_entries = segment_entries
        self._active: str | None = None
        self._active_count = 0

    # ---- naming ----------------------------------------------------------
    def _seg_path(self, first_index: int) -> str:
        return os.path.join(self.dir, f"raft.log.{first_index:020d}.jsonl")

    def _segments(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("raft.log.") and name.endswith(".jsonl"):
                mid = name[len("raft.log.") : -len(".jsonl")]
                if mid.isdigit():
                    out.append((int(mid), os.path.join(self.dir, name)))
        return sorted(out)

    @property
    def _legacy_path(self) -> str:
        return os.path.join(self.dir, "raft.log.jsonl")

    @staticmethod
    def _read_entries(path: str) -> tuple[list[dict], bool]:
        """(entries, torn): stop at the first undecodable line."""
        entries: list[dict] = []
        torn = False
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entries.append(json.loads(line))
                    except json.JSONDecodeError:
                        torn = True
                        break
        except FileNotFoundError:
            pass
        return entries, torn

    @staticmethod
    def _write_file(path: str, entries: list[dict]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    # ---- lifecycle -------------------------------------------------------
    def load(self) -> list[dict]:
        """All persisted entries in index order; repairs torn tails (a
        torn line in a segment drops its tail AND every later segment —
        those writes were never acknowledged)."""
        legacy, _ = self._read_entries(self._legacy_path)
        if legacy:
            # one-time migration from the single-file layout
            self.reset(legacy)
            os.unlink(self._legacy_path)
        out: list[dict] = []
        segs = self._segments()
        for n, (first, path) in enumerate(segs):
            entries, torn = self._read_entries(path)
            out.extend(entries)
            if torn:
                self._write_file(path, entries)
                for _, later in segs[n + 1 :]:
                    os.unlink(later)
                # the REPAIRED segment is the append target now — the
                # stale segs[-1] was just unlinked, and appending under
                # its name would mislabel (and later mis-truncate)
                # re-replicated entries
                self._active = path
                self._active_count = len(entries)
                return out
        if segs:
            last_first, last_path = segs[-1]
            self._active = last_path
            self._active_count = sum(
                1 for e in out if e["i"] >= last_first
            )
        return out

    # ---- mutation --------------------------------------------------------
    def append(self, entries: list[dict]) -> None:
        for e in entries:
            if (
                self._active is None
                or self._active_count >= self.segment_entries
            ):
                self._active = self._seg_path(e["i"])
                self._active_count = 0
                open(self._active, "a").close()
            with open(self._active, "a") as fh:
                fh.write(json.dumps(e) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            self._active_count += 1

    def truncate_from(self, index: int) -> None:
        """Drop every persisted entry with i >= index: whole segments
        unlink; at most ONE boundary segment rewrites."""
        for first, path in reversed(self._segments()):
            if first >= index:
                os.unlink(path)
                continue
            entries, _ = self._read_entries(path)
            kept = [e for e in entries if e["i"] < index]
            if len(kept) != len(entries):
                self._write_file(path, kept)
            self._active = path
            self._active_count = len(kept)
            break
        else:
            self._active = None
            self._active_count = 0

    def drop_through(self, index: int) -> None:
        """Compaction: unlink segments whose entries are ALL <= index.
        The boundary segment is kept untouched — the loader filters
        entries the snapshot covers, so partial segments cost nothing."""
        segs = self._segments()
        for n, (first, path) in enumerate(segs):
            nxt = segs[n + 1][0] if n + 1 < len(segs) else None
            if nxt is not None and nxt <= index + 1:
                os.unlink(path)
                if self._active == path:
                    self._active = None
                    self._active_count = 0

    def reset(self, entries: list[dict]) -> None:
        """Replace everything (snapshot install / legacy migration)."""
        for _, path in self._segments():
            os.unlink(path)
        self._active = None
        self._active_count = 0
        if entries:
            self._active = self._seg_path(entries[0]["i"])
            self._write_file(self._active, entries)
            self._active_count = len(entries)


class RaftNode:
    def __init__(
        self,
        node_id: str,
        members: list[str],
        data_dir: str,
        transport,
        apply_fn=None,
        snapshot_fn=None,
        restore_fn=None,
        meta: dict | None = None,
        heartbeat: float = 0.1,
        election_timeout: tuple[float, float] = (0.4, 0.8),
        snapshot_threshold: int = 512,
        on_leader=None,
    ):
        self.id = node_id
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.transport = transport
        self.apply_fn = apply_fn or (lambda cmd: None)
        self.snapshot_fn = snapshot_fn or (lambda: {})
        self.restore_fn = restore_fn or (lambda state: None)
        self.meta = meta or {}
        self.heartbeat = heartbeat
        self.election_timeout = election_timeout
        self.snapshot_threshold = snapshot_threshold
        self.on_leader = on_leader  # takeover hook, runs before is_leader flips

        self._mu = threading.RLock()
        self._commit_cv = threading.Condition(self._mu)
        self.role = FOLLOWER
        self.term = 0
        self.voted_for = ""
        # log[0] corresponds to index snap_index+1
        self.log: list[dict] = []
        self.snap_index = 0
        self.snap_term = 0
        self.commit_index = 0
        self.last_applied = 0
        self.members = sorted(set(members) | {node_id}) if members else [node_id]
        # join mode: a node told only about itself waits to be taught
        self._passive = not members
        self.leader_id = ""
        self.leader_meta: dict = {}
        self._last_heard = time.monotonic()  # election timer
        self._leader_contact = 0.0  # last AppendEntries/InstallSnapshot from a leader
        self._votes: set[str] = set()
        self._prevotes: set[str] = set()
        self._prevote_term = -1  # term a pre-vote round is running for
        # leader volatile state
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._peer_ack: dict[str, float] = {}  # check-quorum contact times
        self._stop = threading.Event()
        self._kick = threading.Event()  # wakes replicators on new entries
        self._threads: list[threading.Thread] = []
        self._seglog = SegmentedLog(data_dir)

        self._load()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    @property
    def _state_path(self):
        return os.path.join(self.data_dir, "raft.state.json")

    @property
    def _snap_path(self):
        return os.path.join(self.data_dir, "raft.snap.json")

    def _load(self):
        try:
            with open(self._state_path) as f:
                st = json.load(f)
            self.term = int(st.get("term", 0))
            self.voted_for = st.get("voted_for", "")
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        try:
            with open(self._snap_path) as f:
                snap = json.load(f)
            self.snap_index = int(snap["last_index"])
            self.snap_term = int(snap["last_term"])
            self.members = snap["members"]
            # a snapshot whose member list contains this node is committed
            # configuration — even a single-member list (cluster shrunk to
            # one, then compacted) must elect, not wait to be taught
            self._passive = self._passive and self.id not in self.members
            self.restore_fn(snap["state"])
            self.commit_index = self.last_applied = self.snap_index
        except (FileNotFoundError, KeyError, json.JSONDecodeError):
            pass
        # segmented log (torn tails repaired inside load)
        self.log = self._seglog.load()
        # drop any log prefix the snapshot already covers
        self.log = [e for e in self.log if e["i"] > self.snap_index]
        # replay config entries so membership survives restart; membership
        # takes effect when *appended* (not committed), so the latest one
        # in the log wins — without this a restarted seed node would run
        # with its constructor-time member set and could self-elect while
        # the real cluster keeps a different leader (split brain)
        for e in self.log:
            if CONFIG_KEY in e["c"]:
                self.members = e["c"][CONFIG_KEY]
                self._passive = False

    def _persist_state(self):
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)

    def _append_log_disk(self, entries: list[dict]):
        self._seglog.append(entries)

    def _write_snapshot(self, state: dict):
        tmp = self._snap_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "last_index": self.snap_index,
                    "last_term": self.snap_term,
                    "members": self.members,
                    "state": state,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)

    # ------------------------------------------------------------------
    # log helpers (1-based global indexes)
    # ------------------------------------------------------------------
    def _last_index(self) -> int:
        return self.log[-1]["i"] if self.log else self.snap_index

    def _term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self._last_index():
            return -1
        return self.log[index - self.snap_index - 1]["t"]

    def _entries_from(self, index: int) -> list[dict]:
        if index <= self.snap_index:
            return []
        return self.log[index - self.snap_index - 1 :]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        t = threading.Thread(target=self._ticker, daemon=True, name=f"raft-tick-{self.id}")
        t.start()
        self._threads.append(t)

    def stop(self):
        self._stop.set()
        self._kick.set()
        with self._mu:
            self._commit_cv.notify_all()

    # ------------------------------------------------------------------
    # public state
    # ------------------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        with self._mu:
            return self.role == LEADER

    def status(self) -> dict:
        with self._mu:
            return {
                "id": self.id,
                "role": self.role,
                "term": self.term,
                "leader": self.leader_id if self.role != LEADER else self.id,
                "members": list(self.members),
                "commit_index": self.commit_index,
                "last_index": self._last_index(),
                "snapshot_index": self.snap_index,
                "match_index": dict(self._match_index) if self.role == LEADER else {},
            }

    # ------------------------------------------------------------------
    # proposing
    # ------------------------------------------------------------------
    def propose(self, cmd: dict, timeout: float = 5.0) -> bool:
        """Append a command on the leader and wait until it commits."""
        with self._mu:
            if self.role != LEADER:
                return False
            term = self.term
            index = self._last_index() + 1
            entry = {"i": index, "t": term, "c": cmd}
            self.log.append(entry)
            self._append_log_disk([entry])
            if CONFIG_KEY in cmd:
                # membership takes effect as soon as it is appended
                self._set_members_locked(cmd[CONFIG_KEY])
        self._kick.set()
        if len(self.members) == 1:
            with self._mu:
                self._advance_commit_locked()
        deadline = time.monotonic() + timeout
        with self._mu:
            while (
                self.commit_index < index
                and self.term == term
                and self.role == LEADER
                and not self._stop.is_set()
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._commit_cv.wait(remaining)
            # committed while we stayed leader in the same term ⇒ our entry
            # (a config entry removing self steps the leader down on
            # commit — that is success, not a lost election)
            stepped_down_by_self_removal = (
                CONFIG_KEY in cmd and self.id not in self.members
            )
            return (
                self.commit_index >= index
                and self.term == term
                and (self.role == LEADER or stepped_down_by_self_removal)
            )

    def add_member(self, node_id: str, timeout: float = 5.0) -> bool:
        with self._mu:
            members = sorted(set(self.members) | {node_id})
        return self.propose({CONFIG_KEY: members}, timeout)

    def remove_member(self, node_id: str, timeout: float = 5.0) -> bool:
        with self._mu:
            members = [m for m in self.members if m != node_id]
        return self.propose({CONFIG_KEY: members}, timeout)

    def _set_members_locked(self, members: list[str]):
        departed = set(self.members) - set(members)
        self.members = list(members)
        self._passive = False
        if self.role == LEADER:
            for m in departed:
                # replicator loops exit when their peer leaves _next_index
                self._next_index.pop(m, None)
                self._match_index.pop(m, None)
            for m in self.members:
                if m != self.id and m not in self._next_index:
                    self._next_index[m] = self._last_index() + 1
                    self._match_index[m] = 0
                    # grace period: without this, check-quorum counts the
                    # fresh peer as unreachable-since-epoch and a 1→2-node
                    # grow steps the leader down before the first ack
                    self._peer_ack[m] = time.monotonic()
                    self._spawn_replicator(m)

    # ------------------------------------------------------------------
    # election
    # ------------------------------------------------------------------
    def _rand_timeout(self) -> float:
        lo, hi = self.election_timeout
        return random.uniform(lo, hi)

    def _ticker(self):
        timeout = self._rand_timeout()
        while not self._stop.is_set():
            time.sleep(self.heartbeat / 2)
            with self._mu:
                if self.role == LEADER:
                    self._check_quorum_locked()
                    self._last_heard = time.monotonic()
                    continue
                if self._passive or self.id not in self.members:
                    self._last_heard = time.monotonic()
                    continue
                if time.monotonic() - self._last_heard >= timeout:
                    self._start_election_locked()
                    self._last_heard = time.monotonic()
                    timeout = self._rand_timeout()

    def _check_quorum_locked(self):
        """Leader lease: a leader that cannot reach a majority within an
        election timeout steps down, so a partitioned master stops
        serving assigns instead of split-braining (hashicorp/raft
        CheckQuorum semantics)."""
        if len(self.members) <= 1 or self.id not in self.members:
            return
        horizon = time.monotonic() - self.election_timeout[1]
        reachable = 1 + sum(
            1
            for m in self.members
            if m != self.id and self._peer_ack.get(m, 0) >= horizon
        )
        if reachable * 2 <= len(self.members):
            self.role = FOLLOWER
            self._commit_cv.notify_all()

    def _start_election_locked(self):
        """Pre-vote first (Raft §9.6 / hashicorp PreVote): ask peers
        whether they WOULD vote before touching the term.  A node
        rejoining from a partition with a log behind the leader's cannot
        inflate terms and force a needless election — peers that heard a
        live leader recently refuse the pre-vote."""
        peers = [m for m in self.members if m != self.id]
        if not peers:
            self._real_election_locked()
            return
        payload = {
            "term": self.term + 1,  # the term it WOULD use
            "candidate": self.id,
            "last_log_index": self._last_index(),
            "last_log_term": self._term_at(self._last_index()),
            "pre_vote": True,
        }
        self._prevotes = {self.id}
        self._prevote_term = self.term
        for peer in peers:
            threading.Thread(
                target=self._solicit_prevote,
                args=(peer, self.term, payload),
                daemon=True,
            ).start()

    def _call_once(self, peer: str, rpc: str, payload: dict) -> dict | None:
        """One-shot RPC from a throwaway thread: returns None on failure
        and always releases the thread's pooled connection."""
        try:
            return self.transport.call(peer, rpc, payload)
        except Exception as e:
            if wlog.V(2):
                wlog.info("raft %s: %s to %s failed: %s", self.id, rpc, peer, e)
            return None
        finally:
            close = getattr(self.transport, "close_thread_local", None)
            if close is not None:
                close()

    def _solicit_prevote(self, peer: str, term: int, payload: dict):
        resp = self._call_once(peer, "pre_vote", payload)
        if resp is None:
            return
        with self._mu:
            # candidates retrying after a failed real election still run
            # pre-vote rounds; only a sitting leader ignores grants
            if (
                self.role == LEADER
                or self.term != term
                or self._prevote_term != term
            ):
                return
            if resp.get("granted"):
                self._prevotes.add(peer)
                if len(self._prevotes) * 2 > len(self.members):
                    self._prevote_term = -1  # consume: one election per round
                    self._real_election_locked()

    def _real_election_locked(self):
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._persist_state()
        self._votes = {self.id}
        term = self.term
        peers = [m for m in self.members if m != self.id]
        if not peers:
            self._become_leader_locked()  # majority of one
            return
        payload = {
            "term": term,
            "candidate": self.id,
            "last_log_index": self._last_index(),
            "last_log_term": self._term_at(self._last_index()),
        }
        for peer in peers:
            threading.Thread(
                target=self._solicit_vote, args=(peer, term, payload), daemon=True
            ).start()

    def _solicit_vote(self, peer: str, term: int, payload: dict):
        resp = self._call_once(peer, "request_vote", payload)
        if resp is None:
            return
        with self._mu:
            if self.role != CANDIDATE or self.term != term:
                return
            if resp.get("term", 0) > self.term:
                self._step_down_locked(resp["term"])
                return
            if resp.get("granted"):
                self._votes.add(peer)
                if len(self._votes) * 2 > len(self.members):
                    self._become_leader_locked()

    def _become_leader_locked(self):
        if self.on_leader is not None:
            # runs BEFORE the role flips: is_leader must never be true
            # until the takeover hook (e.g. sequence-watermark jump) has
            # completed, or a racing client could read pre-jump state
            try:
                self.on_leader()
            except Exception as e:
                wlog.error("raft %s: on_leader takeover hook failed: %s", self.id, e)
        self.role = LEADER
        self.leader_id = self.id
        last = self._last_index()
        now = time.monotonic()
        self._next_index = {m: last + 1 for m in self.members if m != self.id}
        self._match_index = {m: 0 for m in self.members if m != self.id}
        self._peer_ack = {m: now for m in self._next_index}
        # a no-op entry commits everything from prior terms (§5.4.2)
        entry = {"i": last + 1, "t": self.term, "c": {"_noop": True}}
        self.log.append(entry)
        self._append_log_disk([entry])
        for m in list(self._next_index):
            self._spawn_replicator(m)
        if len(self.members) == 1:
            self._advance_commit_locked()
        self._kick.set()

    def _step_down_locked(self, term: int):
        if term > self.term:
            self.term = term
            self.voted_for = ""
            self._persist_state()
        if self.role != FOLLOWER:
            self.role = FOLLOWER
        self._last_heard = time.monotonic()
        self._commit_cv.notify_all()

    # ------------------------------------------------------------------
    # leader replication
    # ------------------------------------------------------------------
    def _spawn_replicator(self, peer: str):
        t = threading.Thread(
            target=self._replicate_loop,
            args=(peer, self.term),
            daemon=True,
            name=f"raft-repl-{self.id}->{peer}",
        )
        t.start()

    def _replicate_loop(self, peer: str, term: int):
        while not self._stop.is_set():
            with self._mu:
                if self.role != LEADER or self.term != term or peer not in self._next_index:
                    return
                next_idx = self._next_index[peer]
                if next_idx <= self.snap_index:
                    payload = self._snapshot_payload_locked()
                    rpc = "install_snapshot"
                else:
                    prev = next_idx - 1
                    payload = {
                        "term": self.term,
                        "leader": self.id,
                        "leader_meta": self.meta,
                        "prev_log_index": prev,
                        "prev_log_term": self._term_at(prev),
                        "entries": self._entries_from(next_idx),
                        "leader_commit": self.commit_index,
                    }
                    rpc = "append_entries"
            try:
                resp = self.transport.call(peer, rpc, payload)
            except Exception as e:
                if wlog.V(2):
                    wlog.info("raft %s: replicate to %s failed: %s", self.id, peer, e)
                self._kick.wait(self.heartbeat)
                self._kick.clear()
                continue
            with self._mu:
                if self.role != LEADER or self.term != term:
                    return
                if peer not in self._next_index:
                    return  # removed by a config entry mid-RPC
                self._peer_ack[peer] = time.monotonic()
                if resp.get("term", 0) > self.term:
                    self._step_down_locked(resp["term"])
                    return
                if rpc == "install_snapshot":
                    self._next_index[peer] = payload["last_index"] + 1
                    self._match_index[peer] = payload["last_index"]
                    continue
                if resp.get("success"):
                    match = payload["prev_log_index"] + len(payload["entries"])
                    self._match_index[peer] = max(self._match_index.get(peer, 0), match)
                    self._next_index[peer] = self._match_index[peer] + 1
                    self._advance_commit_locked()
                    # committing a config entry (e.g. leader self-removal)
                    # can drop this peer's leader state mid-iteration
                    behind = (
                        peer in self._next_index
                        and self._next_index[peer] <= self._last_index()
                    )
                else:
                    # back off; follower may hint its last index
                    hint = resp.get("last_index")
                    self._next_index[peer] = max(
                        1, min(self._next_index[peer] - 1, (hint or 0) + 1)
                    )
                    behind = True
            if not behind:
                self._kick.wait(self.heartbeat)
                self._kick.clear()

    def _advance_commit_locked(self):
        """Commit = highest index replicated on a majority with an entry
        from the current term (Raft §5.4.2).  A leader outside the
        configuration (self-removal) does not count its own log (§4.2.2)."""
        indexes = sorted(
            ([self._last_index()] if self.id in self.members else [])
            + [self._match_index.get(m, 0) for m in self.members if m != self.id],
            reverse=True,
        )
        majority_idx = indexes[len(self.members) // 2]
        for n in range(majority_idx, self.commit_index, -1):
            if self._term_at(n) == self.term:
                self.commit_index = n
                self._apply_committed_locked()
                self._commit_cv.notify_all()
                break

    def _snapshot_payload_locked(self) -> dict:
        try:
            with open(self._snap_path) as f:
                snap = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            snap = {
                "last_index": self.snap_index,
                "last_term": self.snap_term,
                "members": self.members,
                "state": self.snapshot_fn(),
            }
        return {
            "term": self.term,
            "leader": self.id,
            "leader_meta": self.meta,
            "last_index": snap["last_index"],
            "last_term": snap["last_term"],
            "members": snap["members"],
            "state": snap["state"],
        }

    # ------------------------------------------------------------------
    # applying + compaction
    # ------------------------------------------------------------------
    def _apply_committed_locked(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self.log[self.last_applied - self.snap_index - 1]
            cmd = entry["c"]
            if CONFIG_KEY in cmd:
                self._set_members_locked(cmd[CONFIG_KEY])
            elif "_noop" not in cmd:
                try:
                    self.apply_fn(cmd)
                except Exception as e:
                    # the entry is committed; skipping it would diverge the
                    # state machine silently — make the failure loud
                    wlog.error(
                        "raft %s: apply_fn failed at index %d: %s",
                        self.id, self.last_applied, e,
                    )
        if self.role == LEADER and self.id not in self.members:
            # a leader that removed itself steps down once the config
            # entry commits (Raft §6); the remaining members elect among
            # themselves while this node goes passive
            self.role = FOLLOWER
            self._next_index.clear()
            self._match_index.clear()
            self._commit_cv.notify_all()
        if self.last_applied - self.snap_index >= self.snapshot_threshold:
            self._compact_locked()

    def _compact_locked(self):
        state = self.snapshot_fn()
        new_snap_term = self._term_at(self.last_applied)
        self.log = self._entries_from(self.last_applied + 1)
        self.snap_index = self.last_applied
        self.snap_term = new_snap_term
        self._write_snapshot(state)
        # drop fully-covered segments only: O(segments), not O(log)
        self._seglog.drop_through(self.snap_index)

    # ------------------------------------------------------------------
    # RPC handlers (invoked by the transport server side)
    # ------------------------------------------------------------------
    def handle_rpc(self, rpc: str, payload: dict) -> dict:
        handler = {
            "pre_vote": self.handle_pre_vote,
            "request_vote": self.handle_request_vote,
            "append_entries": self.handle_append_entries,
            "install_snapshot": self.handle_install_snapshot,
        }.get(rpc)
        if handler is None:
            return {"error": f"unknown rpc {rpc}"}
        return handler(payload)

    def handle_pre_vote(self, p: dict) -> dict:
        """Would-you-vote probe: grants change NO state (no term bump, no
        voted_for) — a granted pre-vote only licenses a real election."""
        with self._mu:
            if p["term"] < self.term:
                return {"term": self.term, "granted": False}
            # a node that heard a live leader recently refuses: the
            # candidate is likely a partition returnee, not a successor
            heard_recently = (
                time.monotonic() - self._leader_contact < self.election_timeout[0]
            ) and (self.leader_id not in ("", p["candidate"]))
            if self.role == LEADER or heard_recently:
                return {"term": self.term, "granted": False}
            up_to_date = (p["last_log_term"], p["last_log_index"]) >= (
                self._term_at(self._last_index()),
                self._last_index(),
            )
            return {"term": self.term, "granted": up_to_date}

    def handle_request_vote(self, p: dict) -> dict:
        with self._mu:
            if p["term"] > self.term:
                self._step_down_locked(p["term"])
            if p["term"] < self.term:
                return {"term": self.term, "granted": False}
            up_to_date = (p["last_log_term"], p["last_log_index"]) >= (
                self._term_at(self._last_index()),
                self._last_index(),
            )
            if self.voted_for in ("", p["candidate"]) and up_to_date:
                self.voted_for = p["candidate"]
                self._persist_state()
                self._last_heard = time.monotonic()
                return {"term": self.term, "granted": True}
            return {"term": self.term, "granted": False}

    def handle_append_entries(self, p: dict) -> dict:
        with self._mu:
            if p["term"] > self.term:
                self._step_down_locked(p["term"])
            if p["term"] < self.term:
                return {"term": self.term, "success": False}
            # valid leader for this term
            self.role = FOLLOWER
            self.leader_id = p["leader"]
            self.leader_meta = p.get("leader_meta", {})
            self._last_heard = self._leader_contact = time.monotonic()
            prev_i, prev_t = p["prev_log_index"], p["prev_log_term"]
            if prev_i > self._last_index() or (
                prev_i >= self.snap_index and self._term_at(prev_i) != prev_t
            ):
                return {
                    "term": self.term,
                    "success": False,
                    "last_index": self._last_index(),
                }
            for e in p["entries"]:
                if e["i"] <= self.snap_index:
                    continue
                existing_term = self._term_at(e["i"])
                if existing_term == e["t"]:
                    continue
                if existing_term != -1:
                    # conflict: truncate from here — unlinks later
                    # segments, rewrites at most the boundary one
                    self.log = self.log[: e["i"] - self.snap_index - 1]
                    self._seglog.truncate_from(e["i"])
                self.log.append(e)
                self._append_log_disk([e])
                if CONFIG_KEY in e["c"]:
                    self._set_members_locked(e["c"][CONFIG_KEY])
            if p["leader_commit"] > self.commit_index:
                self.commit_index = min(p["leader_commit"], self._last_index())
                self._apply_committed_locked()
                self._commit_cv.notify_all()
            return {
                "term": self.term,
                "success": True,
                "last_index": self._last_index(),
            }

    def handle_install_snapshot(self, p: dict) -> dict:
        with self._mu:
            if p["term"] > self.term:
                self._step_down_locked(p["term"])
            if p["term"] < self.term:
                return {"term": self.term}
            self.role = FOLLOWER
            self.leader_id = p["leader"]
            self.leader_meta = p.get("leader_meta", {})
            self._last_heard = self._leader_contact = time.monotonic()
            if p["last_index"] <= self.snap_index:
                return {"term": self.term}
            self.snap_index = p["last_index"]
            self.snap_term = p["last_term"]
            self.members = p["members"]
            self._passive = False
            self.log = [e for e in self.log if e["i"] > self.snap_index]
            self.commit_index = max(self.commit_index, self.snap_index)
            self.last_applied = self.snap_index
            self.restore_fn(p["state"])
            self._write_snapshot(p["state"])
            self._seglog.reset(self.log)
            return {"term": self.term}


def raft_token(secret: str) -> str:
    """Shared-secret bearer token for /raft/* RPCs.

    The raft endpoints ride the master's client-facing HTTP port; without
    this, anyone who can reach /dir/assign could POST install_snapshot
    with arbitrary state or inflate terms to depose the leader (the
    reference keeps raft on a dedicated peer-only transport)."""
    return hmac.new(
        secret.encode(), b"weedtpu-raft-rpc-v1", hashlib.sha256
    ).hexdigest()


class HttpRaftTransport:
    """Raft RPCs as HTTP POST /raft/<rpc> with JSON bodies — rides the
    master's existing HTTP server (the reference multiplexes hashicorp
    raft on its own TCP transport; one port total is the design win
    here).  When ``secret`` is set, every RPC carries an
    ``X-Raft-Token`` header the serving master verifies.

    Connections are keep-alive, pooled per (thread, peer): replicators
    send a heartbeat every ~100ms per peer, and a fresh TCP handshake
    per RPC triples the latency and churns ephemeral ports."""

    def __init__(self, timeout: float = 2.0, secret: str = ""):
        self.timeout = timeout
        self._token = raft_token(secret) if secret else ""
        self._local = threading.local()

    def _conn(self, peer: str):
        """Returns (connection, reused) — retry policy depends on whether
        the failure hit a possibly-stale pooled socket or a fresh one."""
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = self._local.pool = {}
        conn = pool.get(peer)
        if conn is not None:
            return conn, True
        host, port = peer.rsplit(":", 1)
        # raft keeps thread-local per-peer conns because its retry policy
        # depends on reused-vs-fresh (a stale pooled socket retries, a
        # fresh connect failure does not)
        # weedlint: disable=W008 — retry policy depends on reused-vs-fresh sockets
        conn = http.client.HTTPConnection(host, int(port), timeout=self.timeout)
        pool[peer] = conn
        return conn, False

    def _drop(self, peer: str):
        pool = getattr(self._local, "pool", {})
        conn = pool.pop(peer, None)
        if conn is not None:
            conn.close()

    def close_thread_local(self):
        """Close this thread's pooled connections (one-shot callers)."""
        pool = getattr(self._local, "pool", None)
        if pool:
            for conn in pool.values():
                conn.close()
            pool.clear()

    def call(self, peer: str, rpc: str, payload: dict) -> dict:
        body = json.dumps(payload)
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["X-Raft-Token"] = self._token
        while True:
            conn, reused = self._conn(peer)
            try:
                conn.request(
                    "POST",
                    f"/raft/{rpc}",
                    body=body,
                    headers=headers,
                )
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException):
                # transport failure: retry ONCE, and only when the dead
                # socket came from the pool (a server restart closes idle
                # keep-alives); a fresh connection failing means the peer
                # is actually down — do not double the blocking time
                self._drop(peer)
                if not reused:
                    raise
                continue
            if resp.status != 200:
                # a protocol-level error on a HEALTHY connection (e.g.
                # 404 while the peer's raft is still booting): keep the
                # socket pooled, surface the error, never re-send
                raise ConnectionError(f"raft rpc {rpc} -> {resp.status}")
            return json.loads(data)
