"""The port's fault injection (util/faults.py), resilience policy
(util/resilience.py) and the stub that runs them (rpc.py), held against
the JAX package's.

- ``parse_spec`` gives the same rules (every field and ``describe()``) for
  the same specs and refuses the same bad ones with the same message.
- One spec and one seed fire on the same calls in both packages: the
  sequence of picked rules and seeded draws is equal, ``inject_client``
  raises the same codes and details, ``inject_server`` aborts the same
  way, and the retry jitter draws the same backoffs.
- The ``disk:`` kinds on DiskFile and MmapDiskFile: torn, short, bitflip,
  eio and enospc leave the same bytes, raise the same errno and read the
  same flipped bits; a volume whose append was torn reopens recovered as
  the JAX volume does (same .dat size, same needles readable), a short
  write still lands whole and a flipped bit fails the needle's CRC once.
- The stub: default deadlines (none for ``NO_DEFAULT_DEADLINE``), the
  same idempotence rules, retries on injected UNAVAILABLE, and a peer's
  breaker going open -> half-open -> closed under injected UNAVAILABLE in
  the same steps as the JAX stub's against a JAX server; the shell's
  ``fault.inject`` and ``resilience.status`` print the same lines.

Comparison: equality of rules, sequences, bytes, errnos, states and
printed lines; no tolerance.
"""

from __future__ import annotations

import errno
import io
import os
import shutil
import tempfile
import time

import grpc
import pytest

from seaweedfs_tpu import rpc as jax_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.stats import events as jax_events
from seaweedfs_tpu.storage import backend as jax_backend
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu.util import resilience as jax_resilience
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.stats import events
from seaweedfs_tpu_torch.storage import backend, needle
from seaweedfs_tpu_torch.storage import volume as port_volume
from seaweedfs_tpu_torch.util import faults, resilience

WAIT_S = 30.0

SPECS = [
    "volume:Read:unavailable:0.5,master:*:delay:200ms",
    "disk:append:torn:0.3,disk:read_at:bitflip:0.01",
    "server/filer:*:delay:10ms:0.25:x40",
    "client/volume@127.0.0.1#8080:EcShard*:unavailable:x3",
    "*/master:Lookup*:deadline:0.1",
    "volume:*:hang:2s",
    "filer:CreateEntry:error:1.0",
    "disk@*.idx:append:eio,disk:write_at:enospc:x1,disk:*:short:0.5",
    " volume:Read:unavailable , ,master:Assign:error:0 ",
    "disk@*.dat:sync:eio:x2",
]

BAD_SPECS = [
    "volume:Read",
    "volume:Read:explode",
    "sideways/volume:Read:error",
    "volume:Read:error:1.5",
    "volume:Read:error:fast",
    "volume:Read:bitflip",
    "disk:append:unavailable",
    "disk@/d/*.dat:sync:eio",  # a "/" in the target is read as the side
]


def _rules(mod, spec: str) -> list:
    return [(r.side, r.service, r.addr_glob, r.method, r.kind, r.probability, r.duration_s,
             r.limit, r.describe()) for r in mod.parse_spec(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equal(spec):
    got = _rules(faults, spec)
    assert got == _rules(jax_faults, spec)
    # describe() re-parses to the same rule (the /debug/faults contract)
    for rule in got:
        (again,) = _rules(faults, rule[-1])
        assert again[4:] == rule[4:]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_refused_alike(spec):
    with pytest.raises(faults.FaultSpecError) as port:
        faults.parse_spec(spec)
    with pytest.raises(jax_faults.FaultSpecError) as jax:
        jax_faults.parse_spec(spec)
    assert str(port.value) == str(jax.value)


CALLS = [("client", "volume", "EcShardRead", "127.0.0.1:8080"),
         ("client", "master", "LookupVolume", "127.0.0.1:9333"),
         ("server", "filer", "CreateEntry", ""),
         ("client", "volume", "Read", "127.0.0.1:8081"),
         ("disk", "disk", "append", "/d/1.dat"),
         ("disk", "disk", "read_at", "/d/1.idx")]


def _fire_sequence(mod, spec: str, seed: int, n: int = 300) -> list:
    plan = mod.FaultPlan(mod.parse_spec(spec), seed=seed)
    out = []
    for i in range(n):
        side, service, method, address = CALLS[i % len(CALLS)]
        rule = plan.pick(side, service, method, address)
        out.append(None if rule is None else plan.rules.index(rule))
        if rule is not None and i % 3 == 0:
            out.append(plan.randint(0, 1 << 20))
    return out + [plan.injected, plan.snapshot()]


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("spec", SPECS[:4] + SPECS[7:])
def test_fire_sequence_equal(spec, seed):
    assert _fire_sequence(faults, spec, seed) == _fire_sequence(jax_faults, spec, seed)


@pytest.fixture
def plans():
    """Both packages' process plans and breakers, cleared after the test."""
    yield
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (resilience, jax_resilience):
        mod.breakers.reset()
        mod.reload_policy()


def _client_outcomes(mod, n: int = 60) -> list:
    out = []
    for i in range(n):
        _side, service, method, address = CALLS[i % 4]
        if i % 4 == 2:
            service, method = "volume", "EcShardRead"
        try:
            mod.inject_client(service, method, address, timeout=0.01)
            out.append("ok")
        except grpc.RpcError as e:
            out.append((e.code().name, e.details()))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_inject_client_equal(plans, seed):
    spec = ("client/volume@127.0.0.1#8080:EcShard*:unavailable:0.4,"
            "master:Lookup*:deadline:0.3,volume:Read:error:0.5:x5,volume:*:hang:1ms:0.2")
    got = []
    for mod in (faults, jax_faults):
        mod.configure(spec, seed=seed)
        got.append(_client_outcomes(mod) + [mod.snapshot()])
    assert got[0] == got[1]
    assert any(o != "ok" for o in got[0][:-1])


class _Aborted(Exception):
    pass


class _Context:
    def __init__(self):
        self.aborts = []

    def abort(self, code, details):
        self.aborts.append((code.name, details))
        raise _Aborted()


def test_inject_server_equal(plans):
    got = []
    for mod in (faults, jax_faults):
        mod.configure("server/filer:CreateEntry:unavailable:0.5,server/*:*:delay:1ms:0.3", seed=5)
        ctx, seen = _Context(), []
        for i in range(40):
            try:
                mod.inject_server("filer", "CreateEntry" if i % 2 else "ListEntries", ctx)
                seen.append("ok")
            except _Aborted:
                seen.append("abort")
        got.append((seen, ctx.aborts, mod.snapshot()))
    assert got[0] == got[1]


def test_backoff_draws_from_the_seeded_plan(plans):
    draws = []
    for mod, res in ((faults, resilience), (jax_faults, jax_resilience)):
        mod.configure("volume:Read:error:0.5", seed=99)
        draws.append([res.backoff_s(a) for a in range(1, 8)])
    assert draws[0] == draws[1] and len(set(draws[0])) == 7


# -- disk faults --------------------------------------------------------------------


def _disk_case(mod, faults_mod, kind: str, path: str, mmap: bool) -> dict:
    cls = mod.MmapDiskFile if mmap else mod.DiskFile
    f = cls(path)
    out: dict = {}
    try:
        f.append(bytes(range(256)) * 4)
        faults_mod.configure(f"disk:{'read_at' if kind == 'bitflip' else '*'}:{kind}:x1",
                             seed=11)
        data = bytes((i * 7 + 3) % 256 for i in range(768))
        try:
            out["append"] = f.append(data)
        except OSError as e:
            out["append_errno"] = e.errno
        try:
            out["read"] = f.read_at(100, 900)
        except OSError as e:
            out["read_errno"] = e.errno
        try:
            f.sync()
            out["sync"] = "ok"
        except OSError as e:
            out["sync_errno"] = e.errno
        out["fired"] = faults_mod.snapshot()["rules"][0]["fired"]
    finally:
        f.close()
        faults_mod.reset()
    with open(path, "rb") as fh:
        out["bytes"] = fh.read()
    return out


@pytest.mark.parametrize("mmap", [False, True], ids=["disk", "mmap"])
@pytest.mark.parametrize("kind", sorted(faults.DISK_KINDS))
def test_disk_kinds_equal(tmp_path, kind, mmap):
    port = _disk_case(backend, faults, kind, str(tmp_path / "p.dat"), mmap)
    jax = _disk_case(jax_backend, jax_faults, kind, str(tmp_path / "j.dat"), mmap)
    assert port == jax
    assert port["fired"] == 1
    if kind == "torn":
        assert 1024 < len(port["bytes"]) < 1024 + 768 and port["append_errno"] == errno.EIO
    if kind == "short":
        assert port["bytes"][1024:] == bytes((i * 7 + 3) % 256 for i in range(768))  # the loop finished it
    if kind == "bitflip":
        flipped = sum(bin(a ^ b).count("1") for a, b in zip(port["read"], port["bytes"][100:1000]))
        assert flipped == 1


def _payload(key: int) -> bytes:
    return bytes((key * 31 + i) % 251 for i in range(300 + key * 7))


def _torn_volume(vol_mod, needle_mod, faults_mod, directory: str, seed: int) -> dict:
    os.makedirs(directory)
    vol = vol_mod.Volume(directory, 3)
    for key in range(1, 6):
        vol.write_needle(needle_mod.new_needle(key, key, _payload(key), last_modified=1))
    intact = vol.dat_size()
    faults_mod.configure("disk@*.dat:append:torn:x1", seed=seed)
    try:
        with pytest.raises(OSError):
            vol.write_needle(needle_mod.new_needle(6, 6, _payload(6), last_modified=1))
        torn = vol.dat_size()
    finally:
        faults_mod.reset()
    vol.close()
    vol = vol_mod.Volume(directory, 3, create=False)
    try:
        readable = {}
        for key in range(1, 7):
            try:
                readable[key] = vol.read_needle(key).data == _payload(key)
            except Exception as e:  # noqa: BLE001 — a lost needle is the answer
                readable[key] = type(e).__name__
        vol.write_needle(needle_mod.new_needle(9, 9, b"after", last_modified=1))
        return dict(intact=intact, torn=torn, size=vol.dat_size(), readable=readable,
                    after=vol.read_needle(9).data)
    finally:
        vol.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torn_append_recovers_like_jax(tmp_path, seed):
    port = _torn_volume(port_volume, needle, faults, str(tmp_path / "p"), seed)
    jax = _torn_volume(jax_volume, jax_needle, jax_faults, str(tmp_path / "j"), seed)
    assert port == jax
    assert port["intact"] < port["torn"]  # a strict prefix landed
    assert all(port["readable"][k] is True for k in range(1, 6))
    assert port["readable"][6] != True  # noqa: E712 — the torn needle is gone
    assert port["after"] == b"after"


def _volume_kind(vol_mod, needle_mod, faults_mod, directory: str, kind: str) -> list:
    """One needle written under ``short`` or read under ``bitflip`` (x1):
    what the volume answers, then the clean retry."""
    os.makedirs(directory)
    vol = vol_mod.Volume(directory, 4)
    out = []
    try:
        vol.write_needle(needle_mod.new_needle(1, 1, _payload(1), last_modified=1))
        faults_mod.configure(f"disk@*.dat:{'append' if kind == 'short' else 'read_at'}:{kind}:x1",
                             seed=3)
        for key in (2, 1, 1):
            try:
                if kind == "short" and key == 2:
                    vol.write_needle(needle_mod.new_needle(2, 2, _payload(2), last_modified=1))
                    out.append(("written", vol.read_needle(2).data == _payload(2)))
                else:
                    out.append(("read", vol.read_needle(key).data == _payload(key)))
            except Exception as e:  # noqa: BLE001 — the answer under the fault
                out.append((type(e).__name__,))
        out.append(faults_mod.snapshot()["rules"][0]["fired"])
    finally:
        faults_mod.reset()
        vol.close()
    return out


@pytest.mark.parametrize("kind", ["short", "bitflip"])
def test_volume_under_disk_faults_like_jax(tmp_path, kind):
    port = _volume_kind(port_volume, needle, faults, str(tmp_path / "p"), kind)
    assert port == _volume_kind(jax_volume, jax_needle, jax_faults, str(tmp_path / "j"), kind)
    assert port[-1] == 1
    if kind == "short":  # the write loop finished the record: nothing lost
        assert port[:3] == [("written", True), ("read", True), ("read", True)]
    else:  # the flipped bit fails the CRC once; the next read is clean
        assert port[1:3] == [("CrcMismatch",), ("read", True)]


# -- the stub ---------------------------------------------------------------------


class _FakeChannel:
    """Records the timeout each multicallable is called with."""

    def __init__(self):
        self.timeouts = {}

    def _mc(self, path, **_kw):
        def call(request, timeout=None, metadata=None, **_kw2):
            self.timeouts[path.rsplit("/", 1)[1]] = timeout
            return None

        return call

    unary_unary = unary_stream = stream_unary = stream_stream = _mc


def test_default_deadlines_equal(plans, monkeypatch):
    got = []
    for mod, pb, res in ((rpc, vs_pb, resilience), (jax_rpc, jax_vs_pb, jax_resilience)):
        ch = _FakeChannel()
        monkeypatch.setattr(mod, "cached_channel", lambda _address, ch=ch: ch)
        stub = mod.Stub("fake:1", pb, "VolumeServer")
        for name in ("VolumeStatus", "EcShardsGenerate", "VolumeCopy", "EcShardsInfo"):
            getattr(stub, name)(getattr(pb, f"{name}Request")())
        stub.VolumeStatus(pb.VolumeStatusRequest(), timeout=3.0)  # explicit wins
        got.append((ch.timeouts, sorted(res.NO_DEFAULT_DEADLINE)))
    assert got[0] == got[1]
    assert got[0][0]["EcShardsGenerate"] is None and got[0][0]["VolumeStatus"] == 3.0


def test_idempotence_rules_equal():
    from seaweedfs_tpu.pb import filer_pb2 as jf, master_pb2 as jm
    from seaweedfs_tpu_torch.pb import filer_pb2, master_pb2

    names = {m.name for mod in (filer_pb2, master_pb2, vs_pb, jf, jm, jax_vs_pb)
             for svc in mod.DESCRIPTOR.services_by_name.values() for m in svc.methods}
    assert {n: resilience.is_idempotent(n) for n in names} == \
        {n: jax_resilience.is_idempotent(n) for n in names}


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


@pytest.fixture(scope="module")
def volume_servers():
    """One port (``device="cpu"``) and one JAX volume server, each with a
    master."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-faults-")
    made = []
    try:
        out = {}
        for name, ms_mod, vs_mod, kw in (("port", master_server, volume_server,
                                          {"device": "cpu"}), ("jax", jax_ms, jax_vs, {})):
            ms = ms_mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
            ms.start()
            made.append(ms)
            vs = vs_mod.VolumeServer([os.path.join(root, name)], ms.grpc_address, port=0,
                                     grpc_port=0, heartbeat_interval=0.2, **kw)
            vs.start()
            made.append(vs)
            out[name] = (ms, vs)
        for ms, _vs in out.values():
            _wait(lambda ms=ms: len(ms.topology.nodes) == 1, "a heartbeat")
        yield out
    finally:
        for s in reversed(made):
            s.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _breaker_walk(mod, res, fmod, ev_mod, pb, addr: str) -> list:
    """VolumeStatus three times under ``unavailable:x6`` with a 0 s
    cooldown: the states and failures after each call, and the breaker
    events recorded for the peer."""
    fmod.configure(f"client/volume@{addr.replace(':', '#')}:VolumeStatus:unavailable:x6",
                   seed=0)
    res.breakers.reset()
    seq0 = max([e["seq"] for e in ev_mod.default_ring.to_dicts()] or [0])
    walk = []
    for _ in range(3):
        try:
            mod.volume_stub(addr).VolumeStatus(pb.VolumeStatusRequest(volume_id=0))
            code = "OK"
        except grpc.RpcError as e:
            code = e.code().name
        br = res.breakers.get(addr).snapshot()
        walk.append((code, br["state"], br["failures"]))
    kinds = [e["kind"] for e in ev_mod.default_ring.to_dicts()
             if e["seq"] > seq0 and e.get("peer") == addr]
    return walk + [kinds, fmod.snapshot()["rules"][0]["fired"]]


def test_breaker_open_half_open_closed_under_injection(plans, volume_servers, monkeypatch):
    monkeypatch.setenv("WEED_RPC_BREAKER_COOLDOWN", "0")
    monkeypatch.setenv("WEED_RPC_BACKOFF_MS", "1")
    resilience.reload_policy()
    jax_resilience.reload_policy()
    port_addr = f"127.0.0.1:{volume_servers['port'][1].grpc_port}"
    jax_addr = f"127.0.0.1:{volume_servers['jax'][1].grpc_port}"
    port = _breaker_walk(rpc, resilience, faults, events, vs_pb, port_addr)
    jax = _breaker_walk(jax_rpc, jax_resilience, jax_faults, jax_events, jax_vs_pb, jax_addr)
    assert port == jax
    assert port[:3] == [("UNAVAILABLE", "closed", 3), ("UNAVAILABLE", "open", 6),
                        ("NOT_FOUND", "closed", 0)]
    assert port[3] == ["breaker.open", "breaker.half_open", "breaker.open",
                       "breaker.half_open", "breaker.close"]


def test_retries_absorb_transient_unavailable(plans, volume_servers):
    from seaweedfs_tpu_torch import stats

    addr = f"127.0.0.1:{volume_servers['port'][1].grpc_port}"
    before = stats.RPC_CLIENT_RETRIES.value(service="volume", method="VolumeStatus",
                                            code="UNAVAILABLE")
    faults.configure(f"client/volume@{addr.replace(':', '#')}:VolumeStatus:unavailable:x2")
    with pytest.raises(grpc.RpcError) as e:
        rpc.volume_stub(addr).VolumeStatus(vs_pb.VolumeStatusRequest(volume_id=0))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND  # the third attempt reached it
    assert stats.RPC_CLIENT_RETRIES.value(service="volume", method="VolumeStatus",
                                          code="UNAVAILABLE") - before == 2


def test_server_side_fault_aborts_the_call(plans, volume_servers):
    addr = f"127.0.0.1:{volume_servers['port'][1].grpc_port}"
    faults.configure("server/volume:EcShardsInfo:error:x1")
    with pytest.raises(grpc.RpcError) as e:
        rpc.volume_stub(addr).EcShardsInfo(vs_pb.EcShardsInfoRequest(volume_id=1))
    assert e.value.code() == grpc.StatusCode.INTERNAL
    assert "injected error (volume.EcShardsInfo)" in e.value.details()


def _shell_lines(mod_shell, env, commands: list[str]) -> list[str]:
    out = io.StringIO()
    for line in commands:
        mod_shell.run_command(env, line, out)
    return out.getvalue().splitlines()


def test_shell_fault_inject_and_status_equal(plans):
    from seaweedfs_tpu import shell as jax_shell
    from seaweedfs_tpu.shell.command_env import CommandEnv as JaxEnv
    from seaweedfs_tpu_torch import shell
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    cmds = ['fault.inject -spec "volume:Read:unavailable:0.5,disk:append:torn:x2" -seed 4',
            "resilience.status", "fault.inject -clear", "resilience.status"]
    port = _shell_lines(shell, CommandEnv("127.0.0.1:1"), cmds)
    jax = _shell_lines(jax_shell, JaxEnv("127.0.0.1:1"), cmds)
    assert port == jax
    assert "faults: no active plan" in port and any("seed=4" in ln for ln in port)
