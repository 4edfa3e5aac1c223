"""IAM in the port (iam/credentials.py, iam/iam_api.py, ``cli iam``, the
gateway's credential store), held against the JAX package's.

- ``_encode`` writes the JAX package's identity-document bytes for seeded
  users, and ``_decode`` reads them back alike.
- The same store operations, with access keys drawn from one seeded source
  in both packages, leave the same document.
- ``FilerEtcCredentialStore``: each package reads the document the other
  wrote, through one filer and through a two-shard router.
- ``IamApiServer``: the same action script (bootstrap, then SigV4-signed)
  gives the same statuses and XML from both packages.
- ``cli iam`` as a subprocess over two filer shards: the document it
  writes is the JAX encoding of its users, byte for byte, and the JAX store
  reads it.
- A port gateway with ``credential_store=FilerEtcCredentialStore(...)``
  accepts a PUT signed with a key the store holds and refuses an unknown
  key with 403.

Every server binds port 0, every subprocess read has a deadline."""

from __future__ import annotations

import http.client
import os
import queue
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.filer.shard_ring import ShardedFilerClient as JaxSharded
from seaweedfs_tpu.iam import IamApiServer as JaxIamApiServer
from seaweedfs_tpu.iam import credentials as jax_cred
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.filer.shard_ring import ShardedFilerClient
from seaweedfs_tpu_torch.iam import IamApiServer
from seaweedfs_tpu_torch.iam import credentials as cred
from seaweedfs_tpu_torch.s3 import S3ApiServer, client_sign
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.wdclient import MasterClient

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
HTTP_TIMEOUT = 30


def _seeded_users(mod, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    users = {}
    for i in range(int(rng.integers(1, 6))):
        name = f"user{i}-{int(rng.integers(0, 1 << 20)):x}"
        actions = [a for a in ("Read", "Write", "List", "Tagging", "Admin")
                   if rng.random() < 0.5]
        keys = [(f"AKID{int(rng.integers(0, 1 << 48)):012X}",
                 rng.bytes(18).hex()) for _ in range(int(rng.integers(0, 4)))]
        users[name] = mod.User(name=name, actions=actions, keys=keys)
    return users


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_identity_document_is_the_jax_bytes(seed):
    port = cred._encode(_seeded_users(cred, seed))
    jax = jax_cred._encode(_seeded_users(jax_cred, seed))
    assert port == jax
    assert cred._decode(jax) == _seeded_users(cred, seed)
    assert cred._decode(b"") == {} and cred.IDENTITY_PATH == jax_cred.IDENTITY_PATH


def _seeded_keys(monkeypatch, seed: int) -> None:
    """One seeded access-key source, the same in both packages."""
    for mod in (cred, jax_cred):
        rng = np.random.default_rng(seed)

        def new_key(rng=rng):
            return (f"AKID{int(rng.integers(0, 1 << 60)):016X}"[:20],
                    rng.bytes(30).hex())

        monkeypatch.setattr(mod, "_new_access_key", new_key)


def _store_script(store) -> list:
    out = [store.create_user("alice").actions, store.create_access_key("alice")]
    store.create_user("bob", ["Read"])
    out.append(store.create_access_key("bob"))
    store.put_access_key("bob", "AKBOBFIXED", "s3cr3t")
    for bad in (lambda: store.create_user("alice"),
                lambda: store.put_access_key("alice", "AKBOBFIXED", "x"),
                lambda: store.create_access_key("nobody")):
        try:
            bad()
        except (ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    store.set_actions("alice", ["Read", "List"])
    store.delete_access_key("bob", out[2][0])
    out.append(sorted((ak, i.secret_key, i.name) for ak, i in store.identity_map().items()))
    store.delete_user("nobody-either")
    return out


def test_store_operations_match_jax(monkeypatch):
    _seeded_keys(monkeypatch, 1616)
    port, jax = cred.MemoryCredentialStore(), jax_cred.MemoryCredentialStore()
    assert _store_script(port) == _store_script(jax)
    assert port._blob == jax._blob
    assert port.name == jax.name == "memory"


def test_make_credential_store_refusals_match_jax():
    for mod in (cred, jax_cred):
        with pytest.raises(ValueError, match="needs a filer"):
            mod.make_credential_store("filer_etc")
        with pytest.raises(ValueError, match="unknown credential store"):
            mod.make_credential_store("ldap://x")
        # psycopg2 is absent here: both refuse with the same message
        with pytest.raises(RuntimeError, match="psycopg2"):
            mod.make_credential_store("postgres://u:p@h/db")


# ---------------------------------------------------------------------------
# over filer servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-iam-")
    started = []
    try:
        master = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        master.start()
        started.append(master)
        vs = VolumeServer([root], master.grpc_address, port=0, grpc_port=0,
                          heartbeat_interval=0.2, device="cpu")
        vs.start()
        started.append(vs)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not master.topology.nodes:
            time.sleep(0.05)
        filers = []
        for _ in range(3):
            fs = FilerServer(master.grpc_address, port=0, grpc_port=0)
            fs.start()
            started.append(fs)
            filers.append(fs)
        yield master, filers
    finally:
        for s in reversed(started):
            s.stop()
        shutil.rmtree(root, ignore_errors=True)
        mp.undo()


def _clients(master, addrs: list[str]):
    if len(addrs) == 1:
        return (RemoteFiler(addrs[0], MasterClient(master.grpc_address)),
                JaxRemoteFiler(addrs[0], JaxMasterClient(master.grpc_address)))
    return (ShardedFilerClient(addrs, MasterClient(master.grpc_address)),
            JaxSharded(addrs, JaxMasterClient(master.grpc_address)))


@pytest.mark.parametrize("shards", [1, 2], ids=["one-filer", "two-shards"])
def test_filer_etc_stores_read_each_other(cluster, shards, monkeypatch):
    master, filers = cluster
    addrs = [f.grpc_address for f in filers[:shards]] if shards == 1 else \
        [f.grpc_address for f in filers[1:3]]
    port_client, jax_client = _clients(master, addrs)
    _seeded_keys(monkeypatch, 1617 + shards)
    port, jax = cred.FilerEtcCredentialStore(port_client), \
        jax_cred.FilerEtcCredentialStore(jax_client)
    port.create_user(f"p{shards}")
    ak, sk = port.create_access_key(f"p{shards}")
    assert jax.load() == {f"p{shards}": jax_cred.User(f"p{shards}", ["Read", "Write"],
                                                      [(ak, sk)])}
    jax.create_user(f"j{shards}", ["Read"])
    jax.put_access_key(f"j{shards}", f"AKJ{shards}", "js")
    assert port.load() == cred._decode(jax_cred._encode(jax.load()))
    assert port.identity_map()[f"AKJ{shards}"].name == f"j{shards}"
    entry = port_client.find_entry(cred.IDENTITY_PATH)
    assert bytes(entry.content) == jax_cred._encode(jax.load())
    if shards == 2:
        owner = port_client.ring.shard_for(cred.IDENTITY_PATH)
        assert port_client._shards[owner].find_entry(cred.IDENTITY_PATH) is not None
    port_client.delete_entry(cred.IDENTITY_PATH)
    if shards == 2:
        port_client.close()
        jax_client.close()


def _iam_post(addr: str, body: str, key: tuple[str, str] | None):
    data = body.encode()
    headers = {"Content-Type": "application/x-www-form-urlencoded"}
    if key is not None:
        headers.update(client_sign.sign_headers("POST", "/", "", addr, data, key[0], key[1]))
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/", body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, re.sub(rb"<RequestId>[0-9a-f]+</RequestId>", b"<RequestId/>",
                                   resp.read())
    finally:
        conn.close()


def _iam_script(addr: str) -> list:
    out = [_iam_post(addr, "Action=CreateUser&UserName=admin", None),
           _iam_post(addr, "Action=CreateAccessKey&UserName=admin", None)]
    ak = re.search(rb"<AccessKeyId>([^<]+)<", out[-1][1]).group(1).decode()
    sk = re.search(rb"<SecretAccessKey>([^<]+)<", out[-1][1]).group(1).decode()
    key = (ak, sk)
    for body, signer in (
            ("Action=CreateUser&UserName=bob", None),  # identities exist: unsigned refused
            ("Action=CreateUser&UserName=bob", ("AKNOBODY", "x")),
            ("Action=CreateUser&UserName=bob", key),
            ("Action=CreateUser&UserName=bob", key),  # exists: 409
            ("Action=CreateUser", key),  # no name: 400
            ("Action=CreateAccessKey&UserName=bob", key),
            ("Action=ListUsers", key),
            ("Action=GetUser&UserName=bob", key),
            ("Action=GetUser&UserName=carol", key),  # 404
            ("Action=ListAccessKeys&UserName=bob", key),
            ("Action=Frobnicate", key),  # 400
            ("Action=DeleteAccessKey&UserName=bob&AccessKeyId=AKNONE", key),
            ("Action=DeleteUser&UserName=bob", key),
            ("Action=ListUsers", key)):
        out.append(_iam_post(addr, body, signer))
    return out


def test_iam_api_answers_like_jax(monkeypatch):
    _seeded_keys(monkeypatch, 1618)
    changed = {"port": 0, "jax": 0}
    servers = {"port": IamApiServer(cred.MemoryCredentialStore(),
                                    on_change=lambda: changed.__setitem__("port",
                                                                          changed["port"] + 1)),
               "jax": JaxIamApiServer(jax_cred.MemoryCredentialStore(),
                                      on_change=lambda: changed.__setitem__("jax",
                                                                            changed["jax"] + 1))}
    for s in servers.values():
        s.start()
    try:
        got = {pkg: _iam_script(s.url) for pkg, s in servers.items()}
    finally:
        for s in servers.values():
            s.stop()
    # signatures differ by host, answers do not
    assert got["port"] == got["jax"]
    statuses = [st for st, _ in got["port"]]
    assert statuses == [200, 200, 403, 403, 200, 409, 400, 200, 200, 200, 404, 200, 400,
                        200, 200, 200]
    assert b"<UserName>bob</UserName>" not in got["port"][-1][1]
    assert changed["port"] == changed["jax"] == 4


# ---------------------------------------------------------------------------
# cli iam, and the gateway's credential store
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_iam_writes_the_jax_document_over_shards(cluster):
    master, filers = cluster
    addrs = [f.grpc_address for f in filers]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "iam", "-filer", ",".join(addrs),
         "-master", master.grpc_address, "-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    port_client, jax_client = _clients(master, addrs)
    try:
        seen = []
        deadline = time.monotonic() + WAIT_S
        while not any("iam api on" in s for s in seen):
            assert time.monotonic() < deadline, seen
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                continue
            assert line is not None, f"cli iam exited: {seen}"
            seen.append(line)
        assert "(credential store: filer_etc)" in seen[-1]
        addr = f"127.0.0.1:{port}"
        assert _iam_post(addr, "Action=CreateUser&UserName=ops", None)[0] == 200
        st, body = _iam_post(addr, "Action=CreateAccessKey&UserName=ops", None)
        ak = re.search(rb"<AccessKeyId>([^<]+)<", body).group(1).decode()
        sk = re.search(rb"<SecretAccessKey>([^<]+)<", body).group(1).decode()
        st, body = _iam_post(addr, "Action=CreateAccessKey&UserName=ops", (ak, sk))
        assert st == 200
        doc = bytes(port_client.find_entry(cred.IDENTITY_PATH).content)
        assert doc == jax_cred._encode(jax_cred._decode(doc))
        users = jax_cred.FilerEtcCredentialStore(jax_client).load()
        assert list(users) == ["ops"] and len(users["ops"].keys) == 2
        assert users["ops"].keys[0] == (ak, sk)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        try:
            port_client.delete_entry(cred.IDENTITY_PATH)
        finally:
            port_client.close()
            jax_client.close()
    assert proc.returncode == 0


def _s3(addr: str, method: str, path: str, body: bytes, key: tuple[str, str]):
    headers = client_sign.sign_headers(method, path, "", addr, body, key[0], key[1])
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    try:
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_gateway_takes_its_identities_from_the_store(cluster, monkeypatch):
    master, filers = cluster
    addrs = [f.grpc_address for f in filers]
    _seeded_keys(monkeypatch, 1619)
    router = ShardedFilerClient(addrs, MasterClient(master.grpc_address))
    store = cred.FilerEtcCredentialStore(router)
    gw = S3ApiServer(master.grpc_address, port=0, filer=router, credential_store=store,
                     credential_refresh=0.2, lifecycle_sweep_interval=0, chunk_cache_mb=0)
    gw.start()
    try:
        assert gw.verifier.identities == {}
        # no identity yet: auth is still required
        assert _s3(gw.url, "PUT", "/iamb", b"", ("AKNOBODY", "x"))[0] == 403
        store.create_user("writer")
        key = store.create_access_key("writer")
        deadline = time.monotonic() + WAIT_S
        while key[0] not in gw.verifier.identities:  # the refresh thread adopts it
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert _s3(gw.url, "PUT", "/iamb", b"", key)[0] == 200
        assert _s3(gw.url, "PUT", "/iamb/o", b"payload", key)[0] == 200
        st, body = _s3(gw.url, "PUT", "/iamb/o2", b"x", ("AKNOBODY", "x"))
        assert st == 403 and b"AccessDenied" in body
        assert _s3(gw.url, "GET", "/iamb/o", b"", key) == (200, b"payload")
    finally:
        gw.stop()
        store.delete_user("writer")
        router.delete_entry(cred.IDENTITY_PATH)
        router.close()
