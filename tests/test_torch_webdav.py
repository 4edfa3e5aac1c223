"""The port's WebDAV gateway (seaweedfs_tpu_torch/server/webdav_server.py)
and its commands held against the JAX package's.

- One HTTP script against the JAX ``WebDavServer`` and the port's, each
  over its own package's stack (a master, a volume server and a filer):
  OPTIONS, MKCOL (and MKCOL of an existing path), PUT of 1 KiB, 64 KiB and
  5 MiB bodies made from a seed, an overwrite, PROPFIND at depth 0 and 1,
  GET, HEAD, a Range GET, MOVE of a directory, COPY of a file, DELETE and
  the 404s after it.  Statuses, headers and bodies must be equal; the
  ``Date`` header, ``X-Request-ID`` (a fresh id per reply) and the
  ``getlastmodified`` property are masked.
- ``cli webdav`` and ``cli server -webdav -device cpu`` start, serve a
  PUT and a GET, and stop on SIGTERM.
- ``cli sftp`` refuses as the JAX package's does while paramiko is
  missing (rc 1, its three lines naming the package's import path)."""

from __future__ import annotations

import io
import os
import re
import signal
import subprocess
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from gateway_stacks import http_req, pkg, stacks_fixture, wait

REPO = Path(__file__).resolve().parent.parent
MASKED_HEADERS = ("Date", "X-Request-ID")


@pytest.fixture(scope="module")
def davs():
    gen = stacks_fixture("torch-webdav-")
    stacks = next(gen)
    servers = {}
    try:
        for name, s in stacks.items():
            dav = pkg(name, "server.webdav_server").WebDavServer(
                s.filer.grpc_address, s.master.grpc_address, port=0, root="/dav")
            dav.start()
            servers[name] = dav
        yield servers
    finally:
        for dav in servers.values():
            dav.stop()
        next(gen, None)


def _masked(status, body, headers):
    body = re.sub(rb"<(ns0|D):getlastmodified>[^<]*</", rb"<\1:getlastmodified>*</", body)
    return status, body, {k: v for k, v in headers.items() if k not in MASKED_HEADERS}


def _script(url: str) -> list:
    rng = np.random.default_rng(11)
    bodies = {"small.bin": rng.bytes(1024), "mid.bin": rng.bytes(64 * 1024),
              "large.bin": rng.bytes(5 * 1024 * 1024)}
    out = []

    def req(method, path, body=b"", headers=None):
        out.append((method, path, _masked(*http_req(url, method, path, body, headers))))
        return out[-1][2]

    req("OPTIONS", "/")
    req("MKCOL", "/proj")
    req("MKCOL", "/proj")
    req("MKCOL", "/proj/sub")
    for name, data in bodies.items():
        req("PUT", f"/proj/{name}", data, {"Content-Type": "application/octet-stream"})
    req("PUT", "/proj/sub/note.txt", b"a note", {"Content-Type": "text/plain"})
    req("PUT", "/proj/small.bin", bodies["small.bin"][::-1])  # overwrite: 204
    req("PROPFIND", "/proj", headers={"Depth": "0"})
    req("PROPFIND", "/proj", headers={"Depth": "1"})
    req("PROPFIND", "/proj/large.bin", headers={"Depth": "0"})
    req("PROPFIND", "/missing", headers={"Depth": "1"})
    for name in ("mid.bin", "large.bin"):
        status, body, _h = req("GET", f"/proj/{name}")
        assert status == 200 and body == bodies[name]
    req("HEAD", "/proj/large.bin")
    status, body, _h = req("GET", "/proj/large.bin",
                           headers={"Range": "bytes=1000000-3100000"})
    assert status == 206 and body == bodies["large.bin"][1000000:3100001]
    req("GET", "/proj/large.bin", headers={"Range": "bytes=99999999-"})
    req("GET", "/proj")
    req("MOVE", "/proj/sub", headers={"Destination": f"http://{url}/moved"})
    req("GET", "/moved/note.txt")
    req("GET", "/proj/sub/note.txt")
    req("MOVE", "/moved", headers={"Destination": f"http://{url}/moved"})
    req("MOVE", "/moved")
    req("COPY", "/proj/mid.bin", headers={"Destination": f"http://{url}/copy.bin"})
    status, body, _h = req("GET", "/copy.bin")
    assert body == bodies["mid.bin"]
    req("COPY", "/proj", headers={"Destination": f"http://{url}/copy-dir"})
    req("DELETE", "/copy.bin")
    req("GET", "/copy.bin")
    req("DELETE", "/copy.bin")
    req("DELETE", "/proj")
    req("GET", "/proj/large.bin")
    req("PROPFIND", "/", headers={"Depth": "1"})
    return out


def test_http_script_matches_jax(davs):
    outs = {name: _script(dav.url) for name, dav in davs.items()}
    for a, b in zip(outs["port"], outs["jax"]):
        assert a == b, a[:2]
    assert len(outs["port"]) == len(outs["jax"])
    statuses = [o[2][0] for o in outs["port"]]
    assert statuses[:4] == [200, 201, 405, 201] and 207 in statuses and 404 in statuses


def _start(argv, env, tmp_path, name):
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen([sys.executable, "-u", "-m", "seaweedfs_tpu_torch.cli", *argv],
                            stdout=subprocess.PIPE, stderr=log, text=True, env=env,
                            cwd=tmp_path)
    first = []
    t = threading.Thread(target=lambda: first.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(120)
    if not first or not first[0]:
        proc.kill()
        proc.wait(30)
        log.seek(0)
        raise AssertionError(f"{name} did not start: {log.read()[-2000:]}")
    return proc, first[0]


def _stop(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def test_cli_webdav_and_server_webdav_start(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), SEAWEEDFS_TPU_NATIVE_DP="0", SEAWEEDFS_TPU_NATIVE_PX="0",
               WEED_SCRUB_INTERVAL="0")
    os.makedirs(tmp_path / "d")
    server, line = _start(["server", "-webdav", "-device", "cpu", "-dir", str(tmp_path / "d"),
                           "-masterPort", "0", "-port", "0", "-filerPort", "0",
                           "-webdavPort", "0"], env, tmp_path, "server")
    try:
        m = re.search(r"master (\S+) \(gRPC (\S+)\).*filer \S+ \(gRPC (\S+)\), webdav (\S+)",
                      line)
        assert m, line
        _http_master, master_grpc, filer_grpc, dav_url = m.groups()
        wait(lambda: http_req(dav_url, "PUT", "/a.txt", b"via server")[0] == 201,
             "server -webdav to take a PUT")
        assert http_req(dav_url, "GET", "/a.txt")[1] == b"via server"
        dav, dline = _start(["webdav", "-filer", filer_grpc, "-master", master_grpc,
                             "-port", "0"], env, tmp_path, "webdav")
        try:
            m2 = re.match(r"webdav on (\S+) \(root /\)", dline)
            assert m2, dline
            assert http_req(m2.group(1), "GET", "/a.txt")[1] == b"via server"
            assert http_req(m2.group(1), "PUT", "/b.txt", b"via cli")[0] == 201
            assert http_req(dav_url, "GET", "/b.txt")[1] == b"via cli"
        finally:
            assert _stop(dav) == 0
    finally:
        assert _stop(server) == 0


def test_cli_sftp_refuses_as_jax():
    outs = []
    for name in ("port", "jax"):
        assert pkg(name, "sftpd").paramiko_available() is False
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = pkg(name, "cli").main(["sftp", "-port", "0"])
        outs.append((rc, buf.getvalue()))
    assert outs[0][0] == outs[1][0] == 1
    assert "from seaweedfs_tpu_torch.mount import WeedFS" in outs[0][1]
    assert outs[0][1].replace("seaweedfs_tpu_torch", "seaweedfs_tpu") == outs[1][1]
    with pytest.raises(RuntimeError) as port_err:
        pkg("port", "sftpd").serve_sftp(None, "k")
    with pytest.raises(RuntimeError) as jax_err:
        pkg("jax", "sftpd").serve_sftp(None, "k")
    assert str(port_err.value).replace("seaweedfs_tpu_torch", "seaweedfs_tpu") == str(
        jax_err.value)
