"""Shell command environment: master client + cluster-exclusive lock.

The port's copy of seaweedfs_tpu/shell/command_env.py (reference
`CommandEnv`, weed/shell/commands.go:33-50): every mutating shell command
first confirms it holds the master-leased admin lock; the lease is
renewed in the background while held
(wdclient/exclusive_locks/exclusive_locker.go).  The master address may
be a comma-separated list (HA): ``master()`` then fails over across it
(wdclient.FailoverStub), where the JAX package's ``CommandEnv`` hands the
string to one stub; followers forward every RPC to the leader, so any
live master of the list serves the shell.  ``filer()`` and
``remote_filer()`` reach the filer of ``-filer`` for the fs.* commands and
``volume.fsck``; ``current_dir`` is fs.cd's working directory.  A
comma-separated filer list is the sharded metadata plane:
``remote_filer()`` is then the shard router (filer/shard_ring.py) and
``filer()`` the first shard's raw stub, as in the JAX package.
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.wdclient import FailoverStub

LOCK_NAME = "admin"
RENEW_INTERVAL = 3.0  # < AdminLock.TTL on the master


class NotLockedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "lock is lost, or this command must run under `lock` "
            "(see the reference's shell locking rule, shell/commands.go:33)"
        )


class CommandEnv:
    def __init__(self, master_grpc_address: str, client_name: str = "shell",
                 filer_grpc_address: str = ""):
        self.master_addresses = [a.strip() for a in master_grpc_address.split(",") if a.strip()]
        # the master tried first; with a list it follows the one that answered
        self.master_address = self.master_addresses[0]
        self.client_name = client_name
        self.lock_token = 0
        self._renew_stop: threading.Event | None = None
        # fs.* command state (reference: CommandEnv option.FilerAddress and
        # the shell's working directory, shell/command_fs_cd.go)
        self.filer_address = filer_grpc_address
        self.current_dir = "/"
        self._remote_filer = None
        self._remote_filer_key = ""

    # -- clients -----------------------------------------------------------

    def master(self):
        if len(self.master_addresses) > 1:
            return FailoverStub(self, self.master_addresses)
        return rpc.master_stub(self.master_address)

    def volume(self, grpc_address: str) -> rpc.Stub:
        return rpc.volume_stub(grpc_address)

    def filer(self) -> rpc.Stub:
        if not self.filer_address:
            raise RuntimeError(
                "no filer configured: start the shell with -filer "
                "host:grpc_port (or fs.cd host:port/path)"
            )
        # sharded plane (comma list): the raw stub speaks to the first
        # shard; path-routed commands go through remote_filer()
        return rpc.filer_stub(self.filer_address.split(",")[0].strip())

    def remote_filer(self):
        """Filer-API view of the configured filer (filer/remote.py, the
        client code the gateways share; a comma-separated address list
        rides the shard router, filer/shard_ring.py), cached per address
        spec."""
        from seaweedfs_tpu_torch.filer.shard_ring import filer_client
        from seaweedfs_tpu_torch.wdclient import MasterClient

        self.filer()  # raises when no filer is configured
        if self._remote_filer is None or self._remote_filer_key != self.filer_address:
            self._remote_filer = filer_client(
                self.filer_address, MasterClient(",".join(self.master_addresses)))
            self._remote_filer_key = self.filer_address
        return self._remote_filer

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

