"""``cli admin`` and ``cli worker`` of the port as subprocesses: an admin
with a password and a config file, two workers with Basic auth, over a port
cluster (in process, ``device="cpu"``), EC-encode a filled volume with no
shell; every worker is seen and the admin's status counts one completed
encode; SIGTERM stops each with rc 0.  ``cli telemetry`` serves reports.
Every read of a subprocess's output and every wait has a
deadline."""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(addr: str, method: str, path: str, body: bytes = b"", headers: dict | None = None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=body or None, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


class _Proc:
    """``python -m seaweedfs_tpu_torch.cli <argv>`` with its stdout read
    by a thread, so that a wait for its first line has a deadline."""

    def __init__(self, argv: list[str], log: Path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(REPO)
        self.log = open(log, "w")
        self.proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.cli", *argv],
                                     cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=self.log, text=True)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self.lines.put(None)

    def first_line(self, timeout: float = WAIT_S) -> str:
        line = self.lines.get(timeout=timeout)
        assert line, f"exited {self.proc.poll()} with no line; see {self.log.name}"
        return line

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.log.close()
        return self.proc.returncode


def test_cli_admin_and_two_workers_encode_a_filled_volume(tmp_path):
    master = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=1)
    master.start()
    servers = []
    procs: list[_Proc] = []
    try:
        for i in range(2):
            vs = VolumeServer([str(tmp_path / f"v{i}")], master.grpc_address, port=0,
                              grpc_port=0, rack=f"rack{i}", heartbeat_interval=0.2, device="cpu")
            vs.start()
            servers.append(vs)
        _wait(lambda: len(master.topology.nodes) == 2, "both heartbeats")
        payloads, vid = {}, None
        while len(payloads) < 10:
            status, body = _http(master.advertise, "GET", "/dir/assign?collection=cliec")
            a = json.loads(body)
            v = int(a["fid"].split(",")[0])
            vid = vid or v
            if v != vid:
                continue
            payloads[a["fid"]] = (f"needle {len(payloads)} ".encode() * 6000)[:60_000]
            assert _http(a["url"], "POST", f"/{a['fid']}", payloads[a["fid"]])[0] == 201
        port = _free_port()
        cfg = tmp_path / "admin.json"
        admin = _Proc(["admin", "-port", str(port), "-master", master.grpc_address,
                       "-scanInterval", "0.5", "-ecFullPercent", "40", "-ecQuietSeconds", "0",
                       "-adminPassword", "pw", "-configFile", str(cfg)], tmp_path / "admin.log")
        procs.append(admin)
        assert admin.first_line() == (f"admin server on http://127.0.0.1:{port} "
                                      f"(master {master.grpc_address}, auth)")
        for i in range(2):
            w = _Proc(["worker", "-admin", f"127.0.0.1:{port}", "-master", master.grpc_address,
                       "-pollInterval", "0.2", "-adminPassword", "pw"], tmp_path / f"w{i}.log")
            procs.append(w)
            line = w.first_line()
            assert line.startswith("worker worker-") and line.endswith(f"polling admin 127.0.0.1:{port}")
        basic = {"Authorization": "Basic " + base64.b64encode(b"admin:pw").decode()}
        assert _http(f"127.0.0.1:{port}", "GET", "/status")[0] == 401

        def status() -> dict:
            code, body = _http(f"127.0.0.1:{port}", "GET", "/status", headers=basic)
            assert code == 200
            return json.loads(body)

        _wait(lambda: status()["tasks"] == {"completed": 1} and
              len(status()["workers_seen_ago"]) == 2, "one completed task, two workers seen")
        _wait(lambda: all(vs.store.find_volume(vid) is None for vs in servers), "the .dat gone")
        assert sum(len(ev.shard_ids()) for vs in servers
                   if (ev := vs.store.find_ec_volume(vid)) is not None) == 14
        for fid, data in payloads.items():
            got = [_http(vs.url, "GET", f"/{fid}") for vs in servers]
            assert (200, data) in got, fid
        code, body = _http(f"127.0.0.1:{port}", "GET", "/tasks", headers=basic)
        (task,) = json.loads(body)["tasks"]
        assert (task["kind"], task["volume_id"], task["state"]) == ("ec_encode", vid, "completed")
        assert task["worker_id"] in status()["workers_seen_ago"]
        assert [p.stop() for p in procs] == [0, 0, 0]
    finally:
        for p in procs:
            p.stop()
        for vs in servers:
            vs.stop()
        master.stop()


def test_cli_telemetry_is_not_ported(tmp_path):
    """``cli telemetry`` serves: started as a subprocess on a free port, it
    names its address on its first line, takes a report at POST
    /api/collect, counts it at GET /api/stats and stops on SIGTERM with rc
    0.  (The test keeps the name it had while the command still refused.)"""
    port = _free_port()
    proc = _Proc(["telemetry", "-port", str(port)], tmp_path / "telemetry.log")
    try:
        assert proc.first_line() == (f"telemetry collector on http://127.0.0.1:{port} "
                                     f"(POST /api/collect; /api/stats /api/instances /metrics)")
        status, body = _http(f"127.0.0.1:{port}", "GET", "/api/stats")
        assert status == 200 and json.loads(body) == {
            "clusters": 0, "reports_received": 0, "total_volume_servers": 0, "total_volumes": 0,
            "total_ec_shards": 0, "total_filers": 0, "total_brokers": 0}
        report = {"cluster_id": "c1", "version": "weed-tpu", "volume_servers": 4, "volumes": 9,
                  "ec_shards": 14}
        assert _http(f"127.0.0.1:{port}", "POST", "/api/collect",
                     json.dumps(report).encode())[0] == 200
        status, body = _http(f"127.0.0.1:{port}", "GET", "/api/stats")
        assert json.loads(body) == {
            "clusters": 1, "reports_received": 1, "total_volume_servers": 4, "total_volumes": 9,
            "total_ec_shards": 14, "total_filers": 0, "total_brokers": 0}
    finally:
        assert proc.stop() == 0
