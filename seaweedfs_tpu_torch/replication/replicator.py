"""Replicator: one metadata event → sink mutations.

Counterpart of the reference's weed/replication/replicator.go:38-90
(Replicate): path-prefix filtering, source-dir rebasing, and the
create/delete/update/rename decision table.

The port's copy of seaweedfs_tpu/replication/replicator.py.
"""

from __future__ import annotations

from typing import Callable

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.replication.sink import ReplicationSink

# read_entry_data(entry) -> bytes, provided by the syncer (reads from the
# source cluster); keeps the replicator free of transport concerns.
ReadEntryData = Callable[[Entry], bytes]


class Replicator:
    def __init__(
        self,
        sink: ReplicationSink,
        read_entry_data: ReadEntryData,
        *,
        source_dir: str = "/",
        exclude_dirs: tuple[str, ...] = (),
    ):
        self.sink = sink
        self.read_entry_data = read_entry_data
        self.source_dir = source_dir.rstrip("/")
        self.exclude_dirs = tuple(d.rstrip("/") for d in exclude_dirs)

    def _rebase(self, path: str) -> str | None:
        """Source path → sink-relative key; None = outside the synced dir.
        Excludes are source-absolute (reference replicator.go:44-49 checks
        the source key before rebasing onto the sink directory)."""
        for ex in self.exclude_dirs:
            if path == ex or path.startswith(ex + "/"):
                return None
        if self.source_dir:
            if not (
                path == self.source_dir or path.startswith(self.source_dir + "/")
            ):
                return None
            path = path[len(self.source_dir) :] or "/"
        return path

    def replicate(self, event) -> None:
        """Apply one MetaEvent (filer.filer.MetaEvent shape)."""
        from seaweedfs_tpu_torch.stats import plane

        # sink chunk fetches/uploads bill to the replication plane, not
        # serve — replication lag chasing foreground writes is exactly
        # the interference weedtpu_plane_bytes_total exists to expose
        with plane.tagged(plane.REPLICATION):
            self._replicate(event)

    def _replicate(self, event) -> None:
        old: Entry | None = event.old_entry
        new: Entry | None = event.new_entry

        if old is not None and new is None:
            key = self._rebase(old.full_path)
            if key is not None:
                self.sink.delete_entry(key, old.is_directory)
            return
        if new is None:
            return  # heartbeat/no-op event

        new_key = self._rebase(new.full_path)
        if old is not None and old.full_path != new.full_path:
            # rename: drop the old location, then create the new one
            old_key = self._rebase(old.full_path)
            if old_key is not None:
                self.sink.delete_entry(old_key, old.is_directory)
        if new_key is None:
            return
        self.sink.create_entry(
            new_key, new, lambda: self.read_entry_data(new)
        )
