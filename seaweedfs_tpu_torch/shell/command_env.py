"""Shell command environment: master client + cluster-exclusive lock.

The port's copy of seaweedfs_tpu/shell/command_env.py (reference
`CommandEnv`, weed/shell/commands.go:33-50): every mutating shell command
first confirms it holds the master-leased admin lock; the lease is
renewed in the background while held
(wdclient/exclusive_locks/exclusive_locker.go).  The filer clients
(``filer``, ``remote_filer``) and the fs.* working directory are not
ported.
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb

from seaweedfs_tpu_torch.util import wlog

LOCK_NAME = "admin"
RENEW_INTERVAL = 3.0  # < AdminLock.TTL on the master


class NotLockedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "lock is lost, or this command must run under `lock` "
            "(see the reference's shell locking rule, shell/commands.go:33)"
        )


class CommandEnv:
    def __init__(self, master_grpc_address: str, client_name: str = "shell"):
        self.master_address = master_grpc_address
        self.client_name = client_name
        self.lock_token = 0
        self._renew_stop: threading.Event | None = None

    # -- clients -----------------------------------------------------------

    def master(self) -> rpc.Stub:
        return rpc.master_stub(self.master_address)

    def volume(self, grpc_address: str) -> rpc.Stub:
        return rpc.volume_stub(grpc_address)

    # -- cluster-exclusive lock --------------------------------------------

    def acquire_lock(self) -> None:
        if self._renew_stop is not None:  # re-lock: retire the old renewer
            self._renew_stop.set()
            self._renew_stop = None
        resp = self.master().LeaseAdminToken(
            m_pb.LeaseAdminTokenRequest(
                previous_token=self.lock_token,
                lock_name=LOCK_NAME,
                client_name=self.client_name,
            )
        )
        self.lock_token = resp.token
        self._renew_stop = threading.Event()
        threading.Thread(
            target=self._renew_loop, args=(self._renew_stop,), daemon=True
        ).start()

    def _renew_loop(self, stop: threading.Event) -> None:
        while not stop.wait(RENEW_INTERVAL):
            try:
                resp = self.master().LeaseAdminToken(
                    m_pb.LeaseAdminTokenRequest(
                        previous_token=self.lock_token,
                        lock_name=LOCK_NAME,
                        client_name=self.client_name,
                    )
                )
                if stop.is_set():  # retired mid-RPC: don't clobber
                    return
                self.lock_token = resp.token
            except Exception as e:  # noqa: BLE001 — lock lost; commands will fail
                wlog.warning("shell: exclusive-lock renew failed (lock lost): %s", e)
                self.lock_token = 0
                return

    def release_lock(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
            self._renew_stop = None
        if self.lock_token:
            try:
                self.master().ReleaseAdminToken(
                    m_pb.ReleaseAdminTokenRequest(
                        previous_token=self.lock_token, lock_name=LOCK_NAME
                    )
                )
            finally:
                self.lock_token = 0

    def confirm_is_locked(self) -> None:
        if not self.lock_token:
            raise NotLockedError()

    # -- topology helpers --------------------------------------------------

    def collect_topology(self) -> m_pb.VolumeListResponse:
        return self.master().VolumeList(m_pb.VolumeListRequest())

    def lookup_volume(self, vid: int) -> list[m_pb.Location]:
        resp = self.master().LookupVolume(
            m_pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
        )
        loc = resp.volume_id_locations[0]
        if loc.error:
            raise ValueError(loc.error)
        return list(loc.locations)

