"""The port's TLS layer (security/tls.py, ``cli tls.gen``, rpc.py's secure
ports and channels, the HTTPS listeners) held against the JAX package's.

- ``cli tls.gen`` mints the same files as the JAX command, with the
  hosts in the certificate's SANs and the keys private.
- A certificate minted by the port is accepted by the JAX package's gRPC
  credentials and the other way round: mutual TLS between a port server
  and a JAX client, and a JAX server and a port client, each under the
  other package's CA.
- The JAX shell drives a port cluster (master and ``device="cpu"`` volume
  server) over mutual TLS (``volume.list``, ``cluster.check``); a
  plaintext client, or one with a certificate the CA did not sign, fails
  the call (no fallback to plaintext).
- Some but not all of ``WEEDTPU_TLS_*`` set: the JAX package's
  TlsConfig runs plaintext without a word (a fault the port repairs),
  the port's raises, and a port server refuses to bind; all three or
  none agree between the packages.
- The port's S3 gateway and filer serve HTTPS: a multi-chunk object goes
  up and comes back whole and ranged over the TLS socket, and a client
  that does not trust the CA is refused.

Comparison: equality of file sets and shell lines, byte equality of
bodies; no tolerance.
"""

from __future__ import annotations

import http.client
import io
import os
import shutil
import ssl
import tempfile
import time
from concurrent import futures

import grpc
import pytest

pytest.importorskip("cryptography")

from seaweedfs_tpu import rpc as jax_rpc
from seaweedfs_tpu.commands import tls_cmd as jax_tls_cmd
from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb
from seaweedfs_tpu.security import tls as jax_tls
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu_torch import cli, rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.server import master_server, volume_server

WAIT_S = 30.0


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _sans(cert_path: str) -> list[str]:
    from cryptography import x509

    with open(cert_path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    ext = cert.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    return sorted(str(v) for v in ext.get_values_for_type(x509.IPAddress)) + \
        sorted(ext.get_values_for_type(x509.DNSName))


@pytest.mark.parametrize("hosts", ["127.0.0.1", "127.0.0.1,localhost,node1.example"])
def test_tls_gen_mints_what_jax_mints(tmp_path, hosts, capsys):
    import argparse

    assert cli.main(["tls.gen", "-dir", str(tmp_path / "p"), "-host", hosts]) == 0
    port_out = capsys.readouterr().out
    jax_tls_cmd.run_tls_gen(argparse.Namespace(dir=str(tmp_path / "j"), host=hosts,
                                               name="node"))
    jax_out = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == [
        "ca.crt", "ca.key", "node.crt", "node.key"]
    assert port_out.replace(str(tmp_path / "p"), "D") == jax_out.replace(str(tmp_path / "j"), "D")
    assert _sans(str(tmp_path / "p" / "node.crt")) == _sans(str(tmp_path / "j" / "node.crt"))
    for d in ("p", "j"):
        for key in ("ca.key", "node.key"):
            assert os.stat(tmp_path / d / key).st_mode & 0o777 == 0o600
    # a second run reuses the CA and issues another node certificate
    assert cli.main(["tls.gen", "-dir", str(tmp_path / "p"), "-host", hosts,
                     "-name", "client"]) == 0
    assert "reusing CA" in capsys.readouterr().out


@pytest.fixture(scope="module")
def pki():
    """A port-minted and a JAX-minted CA, each with a node certificate for
    127.0.0.1 and a client certificate."""
    root = tempfile.mkdtemp(prefix="torch-tls-")
    out = {}
    for name, mod in (("port", tls), ("jax", jax_tls)):
        d = os.path.join(root, name)
        ca, ca_key = mod.generate_ca(d)
        cert, key = mod.issue_cert(d, "node", ca, ca_key)
        ccert, ckey = mod.issue_cert(d, "client", ca, ca_key, cn="client")
        out[name] = dict(dir=d, ca=ca, cert=cert, key=key, client_cert=ccert, client_key=ckey)
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _secure_server(tls_mod, pb_mod, servicer_pb, creds_of: dict):
    """A bare gRPC server of the given package with one VolumeServer
    servicer (VolumeStatus answers NOT_FOUND)."""
    from concurrent import futures

    class Servicer:
        def volume_status(self, request, context):
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {request.volume_id} not found")

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    pb_mod.add_service(server, servicer_pb, "VolumeServer", Servicer())
    port = server.add_secure_port("127.0.0.1:0", tls_mod.grpc_server_credentials(
        creds_of["cert"], creds_of["key"], creds_of["ca"]))
    server.start()
    return server, port


def _call(tls_mod, pb_mod, port: int, creds: dict, cert="client_cert", key="client_key"):
    ch = grpc.secure_channel(f"127.0.0.1:{port}", tls_mod.grpc_channel_credentials(
        creds["ca"], creds[cert], creds[key]))
    try:
        stub = ch.unary_unary("/weedtpu.volume.VolumeServer/VolumeStatus",
                              request_serializer=pb_mod.VolumeStatusRequest.SerializeToString,
                              response_deserializer=pb_mod.VolumeStatusResponse.FromString)
        try:
            stub(pb_mod.VolumeStatusRequest(volume_id=3), timeout=10)
        except grpc.RpcError as e:
            return e.code().name
        return "OK"
    finally:
        ch.close()


@pytest.mark.parametrize("server_pkg, client_pkg, ca_pkg", [
    ("port", "jax", "port"), ("jax", "port", "port"), ("port", "jax", "jax"),
    ("jax", "port", "jax")])
def test_credentials_interoperate(pki, server_pkg, client_pkg, ca_pkg):
    mods = {"port": (tls, rpc, vs_pb), "jax": (jax_tls, jax_rpc, jax_vs_pb)}
    s_tls, s_rpc, s_pb = mods[server_pkg]
    c_tls, _c_rpc, c_pb = mods[client_pkg]
    server, port = _secure_server(s_tls, s_rpc, s_pb, pki[ca_pkg])
    try:
        # a NOT_FOUND answer means the handshake held both ways
        assert _call(c_tls, c_pb, port, pki[ca_pkg]) == "NOT_FOUND"
        other = pki["jax" if ca_pkg == "port" else "port"]
        # a client certificate of the other CA is refused by the server
        assert _call(c_tls, c_pb, port, dict(pki[ca_pkg], client_cert=other["client_cert"],
                                             client_key=other["client_key"])) == "UNAVAILABLE"
    finally:
        server.stop(0)


_TLS_ENV = ("WEEDTPU_TLS_CA", "WEEDTPU_TLS_CERT", "WEEDTPU_TLS_KEY")


@pytest.mark.parametrize("given", [(), ("CA",), ("CERT", "KEY"), ("CA", "CERT"),
                                   ("CA", "CERT", "KEY")])
def test_partial_tls_settings_refused(given, monkeypatch, tmp_path):
    env = {f"WEEDTPU_TLS_{v}": str(tmp_path / v.lower()) for v in given}
    assert jax_tls.TlsConfig(env).enabled == (len(given) == 3)
    if 0 < len(given) < 3:  # the JAX package silently serves plaintext
        with pytest.raises(ValueError, match="TLS half configured") as e:
            tls.TlsConfig(env)
        assert all(name in str(e.value) for name in _TLS_ENV if name not in env)
        for name in _TLS_ENV:
            monkeypatch.delenv(name, raising=False)
        for name, v in env.items():
            monkeypatch.setenv(name, v)
        monkeypatch.setattr(rpc, "_tls_config", None)
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
        with pytest.raises(ValueError, match="TLS half configured"):
            rpc.add_port(server, "127.0.0.1:0")  # no plaintext port behind the operator's back
        server.stop(0)
    else:
        assert tls.TlsConfig(env).enabled == jax_tls.TlsConfig(env).enabled


@pytest.fixture
def mtls_env(pki):
    """WEEDTPU_TLS_* set to the port-minted node certificate for both
    packages' rpc layers; restored (and the channel caches dropped) after."""
    mp = pytest.MonkeyPatch()
    creds = pki["port"]
    mp.setenv("WEEDTPU_TLS_CA", creds["ca"])
    mp.setenv("WEEDTPU_TLS_CERT", creds["cert"])
    mp.setenv("WEEDTPU_TLS_KEY", creds["key"])
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    for mod in (rpc, jax_rpc):
        mod._tls_config = None
    before = {id(mod): set(mod._channel_cache) for mod in (rpc, jax_rpc)}
    yield creds
    for mod in (rpc, jax_rpc):
        for addr in set(mod._channel_cache) - before[id(mod)]:
            mod._channel_cache.pop(addr, None)
        mod._tls_config = None
    mp.undo()


def test_jax_shell_drives_port_cluster_over_mtls(mtls_env, tmp_path):
    from seaweedfs_tpu import shell as jax_shell
    from seaweedfs_tpu.shell.command_env import CommandEnv as JaxEnv

    assert rpc.tls_config().enabled and jax_rpc.tls_config().enabled
    ms = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    ms.start()
    vs = volume_server.VolumeServer([str(tmp_path / "v")], ms.grpc_address, port=0,
                                    grpc_port=0, heartbeat_interval=0.2, device="cpu")
    vs.start()
    try:
        _wait(lambda: len(ms.topology.nodes) == 1, "the heartbeat over mutual TLS")
        out = io.StringIO()
        env = JaxEnv(ms.grpc_address)
        jax_shell.run_command(env, "volume.list", out)
        jax_shell.run_command(env, "cluster.check", out)
        assert "cluster is healthy" in out.getvalue()
        # plaintext against the TLS port: the handshake fails the call
        ch = grpc.insecure_channel(f"127.0.0.1:{vs.grpc_port}")
        stub = ch.unary_unary("/weedtpu.volume.VolumeServer/VolumeStatus",
                              request_serializer=vs_pb.VolumeStatusRequest.SerializeToString,
                              response_deserializer=vs_pb.VolumeStatusResponse.FromString)
        with pytest.raises(grpc.RpcError) as e:
            stub(vs_pb.VolumeStatusRequest(volume_id=1), timeout=5)
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        ch.close()
    finally:
        vs.stop()
        ms.stop()


def test_port_shell_drives_jax_cluster_over_mtls(mtls_env, tmp_path):
    from seaweedfs_tpu_torch import shell
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    ms = jax_ms.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    ms.start()
    vs = jax_vs.VolumeServer([str(tmp_path / "v")], ms.grpc_address, port=0, grpc_port=0,
                             heartbeat_interval=0.2)
    vs.start()
    try:
        _wait(lambda: len(ms.topology.nodes) == 1, "the heartbeat over mutual TLS")
        out = io.StringIO()
        shell.run_command(CommandEnv(ms.grpc_address), "cluster.check", out)
        assert "cluster is healthy" in out.getvalue()
    finally:
        vs.stop()
        ms.stop()


def _https(addr: str, ca: str | None):
    host, port = addr.split(":")
    ctx = ssl.create_default_context(cafile=ca) if ca else ssl.create_default_context()
    return http.client.HTTPSConnection(host, int(port), context=ctx, timeout=30)


def _roundtrip(conn, method: str, path: str, body: bytes = b"", headers=None):
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, resp.read(), resp.getheader("Content-Range")


def test_https_gateway_and_filer_stream_over_tls(pki, tmp_path):
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.server import filer_server

    creds = pki["port"]
    mp = pytest.MonkeyPatch()
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    ms = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    ms.start()
    vs = volume_server.VolumeServer([str(tmp_path / "v")], ms.grpc_address, port=0,
                                    grpc_port=0, heartbeat_interval=0.2, device="cpu")
    vs.start()
    fs = filer_server.FilerServer(ms.grpc_address, port=0, grpc_port=0, chunk_size=4096,
                                  tls_cert=creds["cert"], tls_key=creds["key"])
    fs.start()
    gw = S3ApiServer(ms.grpc_address, port=0, chunk_size=4096, lifecycle_sweep_interval=0,
                     credential_refresh=0, tls_cert=creds["cert"], tls_key=creds["key"])
    gw.start()
    body = os.urandom(5 * 4096 + 123)
    try:
        _wait(lambda: len(ms.topology.nodes) == 1, "the heartbeat")
        conn = _https(gw.url, creds["ca"])
        assert _roundtrip(conn, "PUT", "/tlsb")[0] == 200
        # a body streamed off the TLS socket in chunks
        assert _roundtrip(conn, "PUT", "/tlsb/o.bin", body)[0] == 200
        assert _roundtrip(conn, "GET", "/tlsb/o.bin")[:2] == (200, body)
        assert _roundtrip(conn, "GET", "/tlsb/o.bin", headers={"Range": "bytes=4000-9000"}) \
            == (206, body[4000:9001], f"bytes 4000-9000/{len(body)}")
        conn.close()
        conn = _https(fs.url, creds["ca"])
        assert _roundtrip(conn, "POST", "/d/f.bin", body)[0] == 201
        assert _roundtrip(conn, "GET", "/d/f.bin")[:2] == (200, body)
        assert _roundtrip(conn, "GET", "/d/f.bin", headers={"Range": "bytes=8190-8200"}) \
            == (206, body[8190:8201], f"bytes 8190-8200/{len(body)}")
        conn.close()
        for addr in (gw.url, fs.url):
            with pytest.raises(ssl.SSLError):
                _roundtrip(_https(addr, None), "GET", "/")
            plain = http.client.HTTPConnection(*addr.split(":"), timeout=10)
            with pytest.raises((ConnectionError, http.client.HTTPException, OSError)):
                _roundtrip(plain, "GET", "/tlsb/o.bin")
            plain.close()
    finally:
        gw.stop()
        fs.stop()
        vs.stop()
        ms.stop()
        mp.undo()
