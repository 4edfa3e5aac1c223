"""The port's admin HTTP plane held against the JAX package's, request by
request: one script against a JAX ``AdminServer`` and a port
``AdminServer``, each over its own package's cluster (a master, two volume
servers, a filer) holding the same volumes, needles, shards and entries.
Every answer must carry the same status and the same JSON body, with the
addresses, times and random keys of each cluster replaced by placeholders.

The script covers the resource routes (volumes: lists, sort, page,
filter, detail, vacuum, unmount, mount, move; the EC view and rebuild;
collections; buckets with quotas), the file browser over the filer (a
paged listing, a view, 404 and 413, deletes), users and access keys
through the filer's credential store, the policy documents, the MQ pages
with no broker (and a registered broker, which neither package can reach:
502), a filer-less admin's 503s, and the 401 of every route without a
session.  Every wait polls a condition with a deadline."""

from __future__ import annotations

import http.client
import json
import shutil
import tempfile
import time

import numpy as np
import pytest

import seaweedfs_tpu.admin as jax_admin
from seaweedfs_tpu.server import filer_server as jax_fs
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu_torch import admin as port_admin
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.iam.credentials import FilerEtcCredentialStore
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import filer_server as port_fs
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server import volume_server as port_vs
from seaweedfs_tpu_torch.wdclient import MasterClient

WAIT_S = 60.0
PASSWORD = "s3cret"
COOKIE = 0x12345678
# vid -> (server index, collection, needles)
VOLUMES = {11: (0, "cola", 12), 12: (0, "cola", 6), 13: (1, "colb", 5), 14: (0, "cole", 20),
           15: (1, "", 4)}
DELETED = {11: (2, 5, 7)}  # needle keys deleted before the vacuum
VOLATILE = {"mtime", "created", "workers_seen_ago"}

MODS = {
    "port": dict(admin=port_admin, ms=port_ms, vs=port_vs, fs=port_fs, vs_kw={"device": "cpu"}),
    "jax": dict(admin=jax_admin, ms=jax_ms, vs=jax_vs, fs=jax_fs, vs_kw={}),
}


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _http(addr: str, method: str, path: str, body: bytes = b"", headers: dict | None = None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    hdrs = dict(resp.headers)
    conn.close()
    return resp.status, data, hdrs


def _payload(vid: int, key: int) -> bytes:
    rng = np.random.default_rng(vid * 1000 + key)
    return rng.bytes(int(rng.integers(500, 5000)))


def _fid(vid: int, key: int) -> str:
    return f"{vid},{key:x}{COOKIE:08x}"


class _Stack:
    """One package's cluster with an authenticated admin over its filer."""

    def __init__(self, pkg: str):
        mods = MODS[pkg]
        self.pkg = pkg
        self.master = mods["ms"].MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        self.master.start()
        self.dirs = [tempfile.mkdtemp(prefix=f"torch-admres-{pkg}{i}-") for i in range(2)]
        self.servers = []
        for i, d in enumerate(self.dirs):
            vs = mods["vs"].VolumeServer([d], self.master.grpc_address, port=0, grpc_port=0,
                                         rack=f"rack{i}", heartbeat_interval=0.2,
                                         **mods["vs_kw"])
            vs.start()
            self.servers.append(vs)
        _wait(lambda: len(self.master.topology.nodes) == 2, "both heartbeats")
        self.filer = mods["fs"].FilerServer(self.master.grpc_address, port=0, grpc_port=0)
        self.filer.start()
        self.admin = mods["admin"].AdminServer(self.master.grpc_address, port=0,
                                               password=PASSWORD,
                                               filer_address=self.filer.grpc_address)
        self.admin.start()
        self.bare = mods["admin"].AdminServer(self.master.grpc_address, port=0,
                                              password=PASSWORD)
        self.bare.start()
        status, _, hdrs = _http(self.admin.url, "POST", "/login",
                                json.dumps({"username": "admin", "password": PASSWORD}).encode())
        assert status == 200
        self.cookie = {"Cookie": hdrs["Set-Cookie"].split(";")[0]}
        self.names = {self.master.advertise: "MASTER", self.master.grpc_address: "MASTER_GRPC",
                      self.filer.url: "FILER", self.filer.grpc_address: "FILER_GRPC"}
        for i, vs in enumerate(self.servers):
            self.names[vs.url] = f"S{i}"
            self.names[f"{vs.ip}:{vs.grpc_port}"] = f"G{i}"
        self.remote = RemoteFiler(self.filer.grpc_address, MasterClient(self.master.grpc_address))

    def grpc(self, i: int) -> str:
        vs = self.servers[i]
        return f"{vs.ip}:{vs.grpc_port}"

    def stop(self) -> None:
        for srv in (self.bare, self.admin, self.filer, *self.servers, self.master):
            srv.stop()
        for d in self.dirs:
            shutil.rmtree(d, ignore_errors=True)

    def load(self) -> None:
        """The same volumes, needles, deletions and EC shards in both
        packages, placed by RPC (no growth, no balancing)."""
        for vid, (i, coll, n) in VOLUMES.items():
            rpc.volume_stub(self.grpc(i)).AllocateVolume(
                vs_pb.AllocateVolumeRequest(volume_id=vid, collection=coll), timeout=30)
        _wait(lambda: all(self.master.topology.lookup(v) for v in VOLUMES), "the volumes")
        for vid, (i, coll, n) in VOLUMES.items():
            for key in range(1, n + 1):
                status, body, _ = _http(self.servers[i].url, "POST", f"/{_fid(vid, key)}",
                                        _payload(vid, key))
                assert status == 201, body
        for vid, keys in DELETED.items():
            for key in keys:
                status, _, _ = _http(self.servers[VOLUMES[vid][0]].url, "DELETE",
                                     f"/{_fid(vid, key)}")
                assert status == 202
        stub = rpc.volume_stub(self.grpc(0))
        stub.VolumeMarkReadonly(vs_pb.VolumeMarkRequest(volume_id=14), timeout=30)
        stub.EcShardsGenerate(vs_pb.EcShardsGenerateRequest(volume_id=14, collection="cole"),
                              timeout=60)
        stub.EcShardsMount(vs_pb.EcShardsMountRequest(volume_id=14, collection="cole",
                                                      shard_ids=list(range(14))), timeout=30)
        stub.VolumeDelete(vs_pb.VolumeDeleteRequest(volume_id=14), timeout=30)
        self.settle()

    def view(self) -> str:
        topo = rpc.master_stub(self.master.grpc_address).VolumeList(
            m_pb.VolumeListRequest(), timeout=30).topology_info
        return str(topo)

    def settle(self) -> None:
        """Until the master's VolumeList has not changed for 2.5 s: every
        heartbeat delta and at least two full-state beats (every 5 beats of
        0.2 s) in, with room for a loaded host."""
        state = {"view": None, "since": time.monotonic()}

        def still() -> bool:
            now = self.view()
            if now != state["view"]:
                state["view"], state["since"] = now, time.monotonic()
            return time.monotonic() - state["since"] >= 2.5

        _wait(still, "a settled cluster view")

    def norm(self, text: str):
        for addr, name in self.names.items():
            text = text.replace(addr, name)
        try:
            doc = json.loads(text)
        except ValueError:
            return text
        return _scrub(doc)

    def req(self, method: str, path: str, payload=None, auth: bool = True, bare: bool = False):
        admin = self.bare if bare else self.admin
        body = b"" if payload is None else json.dumps(payload).encode()
        status, data, hdrs = _http(admin.url, method, path, body, self.cookie if auth else None)
        if hdrs.get("Content-Type") == "application/json":
            return status, self.norm(data.decode())
        return status, data, {k: hdrs.get(k) for k in ("Content-Type", "Content-Disposition",
                                                       "X-Content-Type-Options")}


def _scrub(doc):
    """Volatile fields out, random keys to placeholders."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in VOLATILE:
                continue
            if k in ("access_key", "secret_key"):
                v = f"<{k}>"
            elif k == "access_keys":
                v = ["<access_key>"] * len(v)
            out[k] = _scrub(v)
        return out
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


@pytest.fixture(scope="module")
def stacks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
        mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
        mp.setenv("WEED_SCRUB_INTERVAL", "0")
        made = {}
        try:
            for pkg in ("port", "jax"):
                made[pkg] = _Stack(pkg)
                made[pkg].load()
            yield made
        finally:
            for s in made.values():
                s.stop()


def _both(stacks, script) -> list:
    """Run ``script(stack)`` on both stacks; the transcripts must be equal."""
    got = {pkg: script(s) for pkg, s in stacks.items()}
    for i, (want, have) in enumerate(zip(got["jax"], got["port"])):
        assert have == want, f"step {i}"
    assert len(got["port"]) == len(got["jax"])
    return got["port"]


GET_ROUTES = ("/status", "/tasks", "/config", "/topology", "/files?path=/", "/files/view?path=/x",
              "/users", "/mq/topics", "/mq/topic?name=t", "/policies", "/volumes",
              "/volumes/detail?id=11", "/ec/shards", "/collections", "/buckets")
POST_ROUTES = ("/worker/claim", "/worker/report", "/scan", "/config", "/tasks/create",
               "/tasks/cancel", "/files/delete", "/users/create", "/users/delete",
               "/users/keys/create", "/users/keys/delete", "/policies/put", "/policies/delete",
               "/volumes/vacuum", "/volumes/mount", "/volumes/unmount", "/volumes/move",
               "/ec/rebuild", "/collections/delete", "/buckets/create", "/buckets/delete",
               "/buckets/quota")


def test_every_route_needs_a_session(stacks):
    def script(s):
        return ([("GET", p, s.req("GET", p, auth=False)) for p in GET_ROUTES]
                + [("POST", p, s.req("POST", p, {}, auth=False)) for p in POST_ROUTES])

    out = _both(stacks, script)
    assert {r[2][0] for r in out} == {401}
    # the UI routes serve the login page instead
    for s in stacks.values():
        status, body, _ = _http(s.admin.url, "GET", "/")
        assert status == 200 and b"Sign in" in body


def test_volume_pages_match_jax(stacks):
    def script(s):
        out = [s.req("GET", p) for p in (
            "/volumes?pageSize=500", "/volumes?sort=size&order=desc&page=1&pageSize=2",
            "/volumes?sort=file_count&page=2&pageSize=2", "/volumes?collection=cola",
            "/volumes?collection=", "/volumes?sort=garbage&order=desc", "/volumes?sort=bogus",
            "/volumes/detail?id=11", "/volumes/detail?id=999", "/topology", "/status",
            "/config")]
        out.append(s.req("POST", "/volumes/vacuum", {"volume_id": 11}))
        out.append(s.req("POST", "/volumes/vacuum", {"volume_id": 999}))
        out.append(s.req("POST", "/volumes/vacuum", {}))
        s.settle()
        out.append(s.req("GET", "/volumes?collection=cola"))
        out.append(s.req("POST", "/volumes/unmount", {"volume_id": 12, "server": "x:1"}))
        out.append(s.req("POST", "/volumes/unmount",
                         {"volume_id": 12, "server": s.servers[0].url}))
        s.settle()
        out.append(s.req("GET", "/volumes?collection=cola"))
        out.append(s.req("POST", "/volumes/mount",
                         {"volume_id": 12, "server": s.grpc(0), "collection": "cola"}))
        s.settle()
        out.append(s.req("GET", "/volumes?collection=cola"))
        out.append(s.req("POST", "/volumes/move", {"volume_id": 13, "source": s.servers[1].url,
                                                   "target": s.servers[0].url}))
        s.settle()
        out.append(s.req("POST", "/volumes/move", {"volume_id": 13, "source": s.servers[1].url,
                                                   "target": s.servers[0].url}))
        out.append(s.req("GET", "/volumes?collection=colb"))
        out.append(s.req("GET", "/volumes/detail?id=13"))
        return out

    out = _both(stacks, script)
    assert out[0][0] == 200 and out[0][1]["total"] == 4
    assert out[12][1]["reclaimed_bytes"]["S0"] > 0
    assert [v["server"] for v in out[-2][1]["volumes"]] == ["S0"]


def test_ec_pages_match_jax(stacks):
    def script(s):
        out = [s.req("GET", "/ec/shards")]
        stub = rpc.volume_stub(s.grpc(0))
        stub.EcShardsUnmount(vs_pb.EcShardsUnmountRequest(volume_id=14, shard_ids=[2, 3]),
                             timeout=30)
        stub.EcShardsDelete(vs_pb.EcShardsDeleteRequest(volume_id=14, collection="cole",
                                                        shard_ids=[2, 3]), timeout=30)
        s.settle()
        out.append(s.req("GET", "/ec/shards"))
        out.append(s.req("POST", "/ec/rebuild", {"volume_id": 14}))
        out.append(s.req("POST", "/ec/rebuild", {"volume_id": 999}))
        stub.EcShardsMount(vs_pb.EcShardsMountRequest(volume_id=14, collection="cole",
                                                      shard_ids=[2, 3]), timeout=30)
        s.settle()
        out.append(s.req("GET", "/ec/shards"))
        out.append(s.req("GET", "/topology"))
        return out

    out = _both(stacks, script)
    (ev,) = out[1][1]["ec_volumes"]
    assert ev["missing"] == [2, 3]
    assert sorted(out[2][1]["rebuilt_shard_ids"]) == [2, 3]
    assert out[4][1]["ec_volumes"][0]["missing"] == []


def test_collections_match_jax(stacks):
    def script(s):
        out = [s.req("GET", "/collections"),
               s.req("POST", "/collections/delete", {"name": ""}),
               s.req("POST", "/collections/delete", {"name": "colb"})]
        s.settle()
        out.append(s.req("GET", "/collections"))
        out.append(s.req("GET", "/volumes?collection=colb"))
        return out

    out = _both(stacks, script)
    assert out[2] == (200, {"deleted_volumes": 1, "deleted_ec_shards": 0})
    assert "colb" not in {c["name"] for c in out[3][1]["collections"]}


def test_buckets_match_jax(stacks):
    def script(s):
        out = [s.req("POST", "/buckets/create", {"name": "bk1"}),
               s.req("POST", "/buckets/create", {"name": "bk1"}),
               s.req("POST", "/buckets/create", {"name": "Bad/Name"}),
               s.req("POST", "/buckets/create", {"name": "cola"}),
               s.req("POST", "/buckets/create", {"name": "pa"}),
               s.req("GET", "/buckets"),
               s.req("POST", "/buckets/quota", {"name": "bk1", "quota_bytes": 1 << 20}),
               s.req("GET", "/buckets"),
               s.req("POST", "/buckets/quota", {"name": "bk1", "quota_bytes": 0}),
               s.req("POST", "/buckets/quota", {"name": "nope", "quota_bytes": 5}),
               s.req("GET", "/buckets"),
               s.req("POST", "/buckets/delete", {"name": "bk1"}),
               s.req("POST", "/buckets/delete", {"name": "bk1"}),
               s.req("GET", "/buckets")]
        return out

    out = _both(stacks, script)
    assert out[4][0] == 400  # too short a name
    assert out[7][1]["buckets"][0]["quota_bytes"] == 1 << 20
    buckets = {b["name"]: b for b in out[5][1]["buckets"]}
    assert sorted(buckets) == ["bk1", "cola"]
    assert buckets["cola"]["volumes"] == 2 and buckets["cola"]["size"] > 0


def test_browser_matches_jax(stacks):
    def script(s):
        for i in range(5):
            assert _http(s.filer.url, "POST", f"/br/f{i}.txt", b"doc %d " % i * 40)[0] == 201
        assert _http(s.filer.url, "POST", "/br/sub/nested.bin", b"nested" * 100)[0] == 201
        s.remote.create_entry(Entry("/br/huge.bin", attr=Attr.now(),
                                    content=b"x" * ((1 << 20) + 1)))
        out = [s.req("GET", p) for p in (
            "/files?path=/br", "/files?path=/br&limit=2", "/files?path=/br&limit=2&startFrom=f1.txt",
            "/files?path=br/sub/", "/files?path=/nope", "/files/view?path=/br/nope",
            "/files/view?path=/br/sub", "/files/view?path=/br/huge.bin",
            "/files/view?path=/br/f1.txt")]
        out.append(s.req("POST", "/files/delete", {"path": "/br/f0.txt"}))
        out.append(s.req("POST", "/files/delete", {"path": "/br/sub", "recursive": True}))
        out.append(s.req("POST", "/files/delete", {}))
        out.append(s.req("GET", "/files?path=/br"))
        return out

    out = _both(stacks, script)
    assert out[1][1]["truncated"] is True and out[1][1]["next_start_from"] == "f1.txt"
    assert out[7][0] == 413
    assert out[8][:2] == (200, b"doc 1 " * 40)
    assert out[8][2]["Content-Disposition"] == "attachment"
    for s in stacks.values():
        assert s.remote.find_entry("/br/f0.txt") is None
        assert s.remote.find_entry("/br/sub/nested.bin") is None


def test_users_and_policies_match_jax(stacks):
    def script(s):
        out = [s.req("POST", "/users/create", {"name": "alice", "actions": ["Read", "Write"]}),
               s.req("POST", "/users/create", {"name": "alice"}),
               s.req("POST", "/users/create", {})]
        status, key = s.req("POST", "/users/keys/create", {"name": "alice"})
        out.append((status, key))
        raw = _http(s.admin.url, "POST", "/users/keys/create",
                    json.dumps({"name": "alice"}).encode(), s.cookie)[1]
        ak = json.loads(raw)["access_key"]
        store = FilerEtcCredentialStore(s.remote)
        out.append(ak in store.identity_map())
        out.append(s.req("GET", "/users"))
        out.append(s.req("POST", "/users/keys/delete", {"name": "alice", "access_key": ak}))
        out.append(ak in store.identity_map())
        out.append(s.req("POST", "/users/keys/create", {"name": "bob"}))
        out.append(s.req("POST", "/users/delete", {"name": "alice"}))
        out.append(s.req("POST", "/users/delete", {"name": "alice"}))
        out.append(s.req("GET", "/users"))
        doc = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Principal": "*", "Action": ["s3:GetObject"],
             "Resource": ["arn:aws:s3:::b/*"]}]}
        out += [s.req("POST", "/policies/put", {"name": "readers", "document": doc}),
                s.req("POST", "/policies/put", {"name": "bad", "document": {"Statement": 5}}),
                s.req("POST", "/policies/put", {"name": "", "document": doc}),
                s.req("POST", "/policies/put", {"name": "x"}),
                s.req("GET", "/policies"),
                s.req("POST", "/policies/delete", {"name": "readers"}),
                s.req("POST", "/policies/delete", {"name": "readers"}),
                s.req("GET", "/policies")]
        return out

    out = _both(stacks, script)
    assert out[4] is True and out[7] is False
    assert out[5][1]["users"] == [{"name": "alice", "actions": ["Read", "Write"],
                                   "access_keys": ["<access_key>", "<access_key>"]}]
    assert out[12][0] == 200 and out[13][0] == 400


def test_mq_pages_without_a_broker_match_jax(stacks):
    def script(s):
        return [s.req("GET", "/mq/topics"), s.req("GET", "/mq/topic?namespace=n&name=t")]

    out = _both(stacks, script)
    assert out == [(200, {"brokers": [], "topics": []}), (404, {"error": "no live brokers"})]


def test_filerless_admin_answers_503_as_jax(stacks):
    def script(s):
        return [s.req("GET", p, bare=True) for p in (
            "/files?path=/", "/files/view?path=/a", "/users", "/policies", "/buckets")] + [
            s.req("POST", p, {"name": "nnn", "path": "/a", "document": {"Statement": []}}, bare=True)
            for p in ("/files/delete", "/users/create", "/policies/put", "/buckets/create")]

    out = _both(stacks, script)
    assert {r[0] for r in out} == {503}
    assert out[0][1] == {"error": "no filer configured (start the admin with -filer)"}


def test_mq_pages_with_a_broker_answer_502(stacks):
    """A broker registered at the master that nobody serves: each admin asks
    it over its own ``MqBroker`` stub, cannot reach it, and answers 502."""
    statuses = {}
    for pkg, s in stacks.items():
        assert _http(s.master.advertise, "GET",
                     "/cluster/register?type=broker&address=127.0.0.1:1")[0] == 200
        statuses[pkg] = [s.req("GET", "/mq/topics"), s.req("GET", "/mq/topic?namespace=n&name=t")]
    assert [r[0] for r in statuses["port"]] == [r[0] for r in statuses["jax"]] == [502, 502]
    for pkg in statuses:
        for _status, body in statuses[pkg]:
            assert "not ported" not in body["error"] and body["error"], pkg
