"""filer.sync / filer.backup driver: tail a source filer's metadata
stream and pump it through a Replicator, with a durable checkpoint.

Counterpart of the reference's weed/command/filer_sync.go (doSubscribe
loop + offset persistence) and filer_backup.go.  The checkpoint is a
local file holding the last fully-applied event timestamp, written
atomically after each event, so a restarted syncer resumes where it
stopped instead of re-copying the tree.

A create or update whose source chunk answers 404 is skipped with a
warning and the checkpoint moves past it: a later event in the log
deleted or overwrote that entry (the reference's filersink warns and
moves on the same way, "the source chunk may have been deleted already").
The JAX package's syncer retries such an event forever, and the stream
never gets past it (ROADMAP Queue C item 18).  ``drain`` (the commands'
``-once``) runs passes until the backlog is applied (item 19).

The port's copy of seaweedfs_tpu/replication/sync.py.
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import MetaEvent
from seaweedfs_tpu_torch.filer.reader import ReplicaStatusError
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import ReplicationSink
from seaweedfs_tpu_torch.wdclient import MasterClient


class FilerSyncer:
    def __init__(
        self,
        source_filer_grpc: str,
        source_master_grpc: str,
        sink: ReplicationSink,
        *,
        source_dir: str = "/",
        exclude_dirs: tuple[str, ...] = (),
        checkpoint_path: str | None = None,
        client_name: str = "filer.sync",
        poll_timeout: float = 5.0,
    ):
        self.source_filer = source_filer_grpc
        self.master = MasterClient(source_master_grpc)
        self.checkpoint_path = checkpoint_path
        self.client_name = client_name
        self.poll_timeout = poll_timeout
        self.replicator = Replicator(
            sink,
            self._read_entry_data,
            source_dir=source_dir,
            exclude_dirs=exclude_dirs,
        )
        self.source_dir = source_dir
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._call = None
        self.errors: list[str] = []  # bounded ring of recent error texts
        self.error_count = 0  # monotonic, drives backoff decisions
        self.applied = 0
        self.skipped = 0  # events whose source data a later event superseded

    # ---- data plane -----------------------------------------------------
    def _read_entry_data(self, entry: Entry) -> bytes:
        from seaweedfs_tpu_torch.filer import reader

        return reader.read_entry(self.master, entry)

    # ---- checkpoint -----------------------------------------------------
    def load_checkpoint(self) -> int:
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            with open(self.checkpoint_path) as fh:
                return int(fh.read().strip() or 0)
        return 0

    def save_checkpoint(self, ts_ns: int) -> None:
        if not self.checkpoint_path:
            return
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(ts_ns))
        os.replace(tmp, self.checkpoint_path)

    # ---- subscribe loop -------------------------------------------------
    def run_once(self, since_ts_ns: int | None = None, max_events: int | None = None):
        """Apply pending events; returns the last applied ts (for tests /
        one-shot backup runs)."""
        since = self.load_checkpoint() if since_ts_ns is None else since_ts_ns
        stub = rpc.make_stub(self.source_filer, f_pb, "Filer")
        stream = stub.SubscribeMetadata(
            f_pb.SubscribeMetadataRequest(
                client_name=self.client_name,
                path_prefix=self.source_dir,
                since_ts_ns=since,
            ),
            timeout=self.poll_timeout,
        )
        self._call = stream
        n = 0
        try:
            for pb_ev in stream:
                if not self._apply(pb_ev):
                    # the checkpoint must not advance past a failed event —
                    # end the pass; the next pass resumes AT the failure
                    break
                since = pb_ev.ts_ns
                self.save_checkpoint(since)
                n += 1
                if max_events is not None and n >= max_events:
                    break
                if self._stop.is_set():
                    break
        except Exception as e:  # noqa: BLE001 — stream deadline/cancel ends a pass
            if "DEADLINE_EXCEEDED" not in str(e) and "CANCELLED" not in str(e):
                raise
        finally:
            stream.cancel()
        return since

    def drain(self, max_events: int | None = None) -> int:
        """Apply every pending event, pass after pass, until a pass applies
        none, records an error or ``max_events`` are applied; returns the
        last applied ts.  A pass ends at the stream's deadline
        (``poll_timeout``), so a backlog longer than one pass takes several:
        the JAX package's ``-once`` runs one pass and leaves the rest of
        the backlog unapplied (ROADMAP Queue C item 19)."""
        since = self.load_checkpoint()
        start = self.applied + self.skipped
        while True:
            done, errors = self.applied + self.skipped, self.error_count
            left = None if max_events is None else max_events - (done - start)
            if left is not None and left <= 0:
                return since
            since = self.run_once(since, max_events=left)
            if self.applied + self.skipped == done or self.error_count != errors:
                return since

    def _apply(self, pb_ev) -> bool:
        from seaweedfs_tpu_torch.filer.filer import _from_pb_event

        ev: MetaEvent = _from_pb_event(pb_ev)
        try:
            self.replicator.replicate(ev)
            self.applied += 1
            return True
        except ReplicaStatusError as e:
            if e.status != 404 or not e.definitive:
                self._record_error(f"{ev.directory}: {e}")
                return False
            # the needle is deleted at the source: a later event removed or
            # replaced this entry, and replaying it moves the sink there
            self.skipped += 1
            wlog.warning("filer.sync %s: %s: source data gone, superseded later: %s",
                         self.client_name, ev.directory, e)
            return True
        except Exception as e:  # noqa: BLE001 — recorded; pass retries later
            self._record_error(f"{ev.directory}: {e}")
            return False

    def _record_error(self, text: str) -> None:
        self.error_count += 1
        self.errors.append(text)
        del self.errors[:-100]  # a poisoned event must not grow this forever
        wlog.warning("filer.sync %s: %s", self.client_name, text)

    def start(self) -> None:
        """Continuous background sync until stop()."""

        def loop():
            since = self.load_checkpoint()
            while not self._stop.is_set():
                before = self.error_count
                try:
                    since = self.run_once(since)
                except Exception as e:  # noqa: BLE001
                    self._record_error(str(e))
                # back off when the pass hit errors (apply failure or
                # stream error) so a poisoned head event can't hot-loop
                if self.error_count != before:
                    self._stop.wait(1.0)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._call is not None:
            try:
                self._call.cancel()
            except Exception as e:  # noqa: BLE001 — cancel races completion
                if wlog.V(2):
                    wlog.info("sync: stream cancel raced: %s", e)
        if self._thread is not None:
            self._thread.join(timeout=5)
