"""Maintenance worker: claim tasks from the admin plane and execute them;
the port's copy of seaweedfs_tpu/admin/worker.py.

Counterpart of the reference's worker task executors
(weed/worker/tasks/{erasure_coding,vacuum}/): each task kind maps to a
handler driving the existing volume-server gRPC surface — EC encode runs
the same orchestration as the shell's ec.encode (and thus K1, the CUDA
GF(2^8) apply, in the volume server that generates the shards), vacuum
calls VolumeVacuum on every replica holder.  The worker itself runs no
kernel and never touches CUDA.  Unlike the reference's worker (which
re-implements a local 10+4-only encode path, ec_task.go:349-434), there
is exactly one encode path in this framework.

Workers talk to the admin server over its HTTP/JSON claim/report API, or
directly to an in-process TaskQueue (integration tests, single-process
deployments).
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
import uuid

from seaweedfs_tpu_torch.admin import tasks as T
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell.command_ec import do_ec_encode, rebuild_one_ec_volume
from seaweedfs_tpu_torch.shell.command_ec_balance import balance_ec_volume
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.ec_common import collect_ec_nodes, grpc_addr
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.http_pool import shared_pool


class _QueueClient:
    """Direct in-process access to a TaskQueue."""

    def __init__(self, queue: T.TaskQueue):
        self.queue = queue

    def claim(self, worker_id: str, kinds: list[str]) -> T.Task | None:
        return self.queue.claim(worker_id, kinds)

    def report(self, task: T.Task, worker_id: str, ok: bool, error: str) -> None:
        self.queue.report(task.id, worker_id, ok, error)


class _HttpClient:
    """Talk to a remote AdminServer's /worker/* JSON endpoints.

    When the admin plane has auth configured, workers present HTTP Basic
    credentials (username/password or the WEED_ADMIN_USER/PASSWORD env
    the admin itself reads)."""

    def __init__(
        self, admin_address: str, username: str = "", password: str = ""
    ):
        self.address = admin_address
        username = username or os.environ.get("WEED_ADMIN_USER", "admin")
        password = password or os.environ.get("WEED_ADMIN_PASSWORD", "")
        self._auth = (
            "Basic "
            + base64.b64encode(f"{username}:{password}".encode()).decode()
            if password
            else ""
        )

    def _post(self, path: str, payload: dict) -> dict:
        headers = {"Content-Type": "application/json"}
        if self._auth:
            headers["Authorization"] = self._auth
        # retries=False: a replayed /worker/claim would pop a second
        # task nobody works on until its lease expires — at-most-once
        status, body = shared_pool().request(
            self.address, "POST", path,
            body=json.dumps(payload).encode(), headers=headers, timeout=30,
            retries=False,
        )
        if status != 200:
            raise RuntimeError(f"admin {path}: {status} {body[:200]!r}")
        return json.loads(body)

    def claim(self, worker_id: str, kinds: list[str]) -> T.Task | None:
        out = self._post("/worker/claim", {"worker_id": worker_id, "kinds": kinds})
        if not out.get("task"):
            return None
        d = out["task"]
        return T.Task(
            id=d["id"],
            kind=d["kind"],
            volume_id=d["volume_id"],
            collection=d.get("collection", ""),
            params=d.get("params", {}),
        )

    def report(self, task: T.Task, worker_id: str, ok: bool, error: str) -> None:
        self._post(
            "/worker/report",
            {
                "worker_id": worker_id,
                "task_id": task.id,
                "ok": ok,
                "error": error,
            },
        )


class Worker:
    def __init__(
        self,
        master_grpc_address: str,
        *,
        queue: T.TaskQueue | None = None,
        admin_address: str | None = None,
        kinds: list[str] | None = None,
        poll_interval: float = 2.0,
        scheme: EcScheme = DEFAULT_SCHEME,
        worker_id: str | None = None,
        http_auth: tuple[str, str] | None = None,
    ):
        if (queue is None) == (admin_address is None):
            raise ValueError("exactly one of queue / admin_address required")
        user, pwd = http_auth or ("", "")
        self.client = (
            _QueueClient(queue)
            if queue
            else _HttpClient(admin_address, user, pwd)
        )
        self.env = CommandEnv(master_grpc_address, client_name="worker")
        self.kinds = kinds or [T.EC_ENCODE, T.EC_REBUILD, T.VACUUM, T.TTL_DELETE]
        self.poll_interval = poll_interval
        self.scheme = scheme
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.completed: list[int] = []

    # ---- execution ------------------------------------------------------
    # how long an encode or a rebuild waits for the master to see its shards
    CONFIRM_S = 60.0

    def execute(self, task: T.Task) -> None:
        if task.kind == T.EC_ENCODE:
            self._ec_encode(task)
        elif task.kind == T.EC_REBUILD:
            self._ec_rebuild(task)
        elif task.kind == T.VACUUM:
            self._vacuum(task)
        elif task.kind == T.TTL_DELETE:
            self._ttl_delete(task)
        else:
            raise ValueError(f"unknown task kind {task.kind}")

    def _ec_encode(self, task: T.Task) -> None:
        """The shell's ``ec.encode`` of one volume: generate and mount on
        a holder, drop the .dat replicas, then spread the new shards
        across racks and nodes (``balance_ec_volume``).  The JAX worker
        stops after the generate and leaves all shards on one server,
        where that server's loss loses the volume."""
        do_ec_encode(self.env, task.volume_id, task.collection, self.scheme)
        self._await_master(task.volume_id, self.scheme.total_shards, encoded=True)
        balance_ec_volume(self.env, task.volume_id)
        self._await_master(task.volume_id, self.scheme.total_shards, encoded=True)

    def _ec_rebuild(self, task: T.Task) -> None:
        """Repair a degraded EC volume: the shell's rebuild orchestration
        (copy survivors -> EcShardsRebuild -> mount) with the volume's
        own storage class read from the holders' heartbeats — an LRC
        volume's single-shard rebuild then reads only its local group,
        and the server-side rebuild paces itself under
        WEED_REPAIR_RATE_MB (the maintenance plane schedules, the data
        plane meters)."""
        nodes, collections, schemes = collect_ec_nodes(
            self.env.collect_topology().topology_info
        )
        scheme = schemes.get(task.volume_id) or self.scheme
        rebuild_one_ec_volume(
            self.env,
            task.volume_id,
            task.collection or collections.get(task.volume_id, ""),
            nodes,
            scheme,
        )
        self._await_master(task.volume_id, scheme.total_shards)

    def _await_master(self, vid: int, total: int, encoded: bool = False) -> None:
        """Report an encode or a rebuild done only once the master sees its
        result: all ``total`` shards of ``vid`` held, and after an encode
        no .dat replica left.  The servers' heartbeats carry the shard
        deltas a beat after the RPCs return; a report ahead of them lets
        the next scan see the volume still whole (and submit its encode
        again, which fails: "volume not found") or still degraded.  The
        JAX worker reports at once."""
        deadline = time.monotonic() + self.CONFIRM_S
        while True:
            topo = self.env.collect_topology().topology_info
            bits, plain = 0, False
            for dc in topo.data_center_infos:
                for rack in dc.rack_infos:
                    for dn in rack.data_node_infos:
                        for disk in dn.disk_infos.values():
                            bits |= sum(e.shard_bits for e in disk.ec_shard_infos
                                        if e.volume_id == vid)
                            plain |= any(v.id == vid for v in disk.volume_infos)
            if bits.bit_count() >= total and not (encoded and plain):
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"volume {vid}: the master sees {bits.bit_count()} of {total} shards"
                    + (" and a .dat replica" if encoded and plain else "")
                    + f" {self.CONFIRM_S:.0f}s after the RPCs returned")
            if self._stop.wait(0.1):
                raise RuntimeError(f"volume {vid}: worker stopped before the master saw it")

    def _ttl_delete(self, task: T.Task) -> None:
        """Drop a fully-expired TTL volume from every holder (reference
        master-side TTL vacuum).

        Freeze-then-reverify: writes may land between the scanner's
        verdict and this task running (the volume stays in the writable
        layout until holders drop it), so mark every replica readonly
        FIRST, re-check expiry, and roll the freeze back if data got in.
        """
        locations = self.env.lookup_volume(task.volume_id)
        if not locations:
            return  # already gone: idempotent
        ttl_seconds = int(task.params.get("ttl_seconds", 0))
        stubs = [
            self.env.volume(grpc_addr(loc.url, loc.grpc_port))
            for loc in locations
        ]
        for stub in stubs:
            stub.VolumeMarkReadonly(
                vs_pb.VolumeMarkRequest(volume_id=task.volume_id)
            )
        now_ns = time.time_ns()
        for stub in stubs:
            st = stub.VolumeStatus(
                vs_pb.VolumeStatusRequest(volume_id=task.volume_id)
            )
            if not st.last_modified_ns or (
                ttl_seconds
                and now_ns - st.last_modified_ns < ttl_seconds * 1_000_000_000
            ):
                # a write slipped in (or age is unknown): not expired
                # after all — unfreeze and walk away
                for s2 in stubs:
                    s2.VolumeMarkWritable(
                        vs_pb.VolumeMarkRequest(volume_id=task.volume_id)
                    )
                raise RuntimeError(
                    f"volume {task.volume_id} received writes after the "
                    "expiry scan; rescheduling"
                )
        for stub in stubs:
            stub.VolumeDelete(
                vs_pb.VolumeDeleteRequest(volume_id=task.volume_id)
            )

    def _vacuum(self, task: T.Task) -> None:
        threshold = float(task.params.get("garbage_threshold", 0.3))
        locations = self.env.lookup_volume(task.volume_id)
        if not locations:
            raise RuntimeError(f"volume {task.volume_id} not found")
        for loc in locations:
            self.env.volume(grpc_addr(loc.url, loc.grpc_port)).VolumeVacuum(
                vs_pb.VolumeVacuumRequest(
                    volume_id=task.volume_id, garbage_threshold=threshold
                )
            )

    def run_one(self) -> bool:
        """Claim and run a single task; returns whether one was found."""
        task = self.client.claim(self.worker_id, self.kinds)
        if task is None:
            return False
        try:
            self.execute(task)
        except Exception as e:  # noqa: BLE001 — report, don't die
            self.client.report(task, self.worker_id, False, str(e))
        else:
            self.client.report(task, self.worker_id, True, "")
            self.completed.append(task.id)
        return True

    # ---- loop -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=self.worker_id, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self.run_one()
            except Exception as e:
                if wlog.V(1):
                    wlog.info("worker: admin unreachable: %s", e)
                busy = False  # back off and retry
            if not busy:
                self._stop.wait(self.poll_interval)
