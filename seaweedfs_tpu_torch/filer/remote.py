"""RemoteFiler: the in-process Filer API spoken over filer gRPC.  The
port's copy of seaweedfs_tpu/filer/remote.py; it drives the JAX package's
filer server as well as the port's (one contract, pb/filer_pb2.py).

Lets gateways (S3, WebDAV, ...) ride a *shared* filer server instead of
embedding their own metadata engine — the reference's deployment shape,
where `weed s3`/`weed webdav` are clients of `weed filer`
(weed/s3api/s3api_handlers.go WithFilerClient).  Implements the subset
of :class:`~seaweedfs_tpu_torch.filer.Filer` the gateways call:
find_entry / list_entries / create_entry / update_entry / delete_entry /
rename / mkdirs / _delete_chunks, plus ``master_client``.
"""

from __future__ import annotations

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.wdclient import MasterClient


def _norm(path: str) -> str:
    out = [p for p in path.split("/") if p not in ("", ".")]
    return "/" + "/".join(out)


class RemoteFiler:
    # duck-type marker: a filer client whose server-side mutators this
    # process cannot observe through ``listeners`` alone (gateways key
    # cache-coherence decisions on this, not on isinstance — the shard
    # router carries the same marker)
    remote = True

    def __init__(self, filer_grpc_address: str, master_client: MasterClient):
        self.address = filer_grpc_address
        self.master_client = master_client
        # in-process metadata listeners, the same seam Filer exposes:
        # called synchronously after every mutation THIS client performs.
        # A gateway entry cache rides it (plus filer/inval_bus.py to
        # reach sibling SO_REUSEPORT workers); mutations by OTHER
        # processes are bounded by the cache TTL, as before.
        self.listeners: list = []

    def _notify(self, old_entry, new_entry, new_parent_path: str = "") -> None:
        if not self.listeners:
            return
        import time as _time

        from seaweedfs_tpu_torch.filer.filer import MetaEvent

        ev = MetaEvent(
            ts_ns=_time.time_ns(),
            directory=(new_entry or old_entry).parent,
            old_entry=old_entry,
            new_entry=new_entry,
            new_parent_path=new_parent_path,
        )
        for listener in list(self.listeners):
            listener(ev)

    def _stub(self) -> rpc.Stub:
        return rpc.filer_stub(self.address)

    # ---- lookups ---------------------------------------------------------

    def find_entry(self, full_path: str) -> Entry | None:
        full_path = _norm(full_path)
        if full_path == "/":
            return Entry(full_path="/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        resp = self._stub().LookupDirectoryEntry(
            f_pb.LookupDirectoryEntryRequest(directory=parent or "/", name=name)
        )
        if resp.error or not resp.entry.name:
            return None
        return Entry.from_pb(parent or "/", resp.entry)

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        dir_path = _norm(dir_path)
        stream = self._stub().ListEntries(
            f_pb.ListEntriesRequest(
                directory=dir_path,
                prefix=prefix,
                start_from_file_name=start_file_name,
                inclusive_start_from=inclusive,
                limit=limit,
            )
        )
        return [Entry.from_pb(dir_path, r.entry) for r in stream]

    # ---- mutations -------------------------------------------------------

    def create_entry(self, entry: Entry, *, emit: bool = True) -> None:
        resp = self._stub().CreateEntry(
            f_pb.CreateEntryRequest(directory=entry.parent, entry=entry.to_pb())
        )
        if resp.error:
            raise FilerError(resp.error)
        if emit:
            self._notify(None, entry)

    def update_entry(self, entry: Entry) -> None:
        resp = self._stub().UpdateEntry(
            f_pb.UpdateEntryRequest(directory=entry.parent, entry=entry.to_pb())
        )
        if resp.error:
            raise FilerError(resp.error)
        self._notify(None, entry)

    def delete_entry(
        self,
        full_path: str,
        *,
        recursive: bool = False,
        delete_data: bool = True,
    ) -> None:
        full_path = _norm(full_path)
        parent, name = full_path.rsplit("/", 1)
        resp = self._stub().DeleteEntry(
            f_pb.DeleteEntryRequest(
                directory=parent or "/",
                name=name,
                is_delete_data=delete_data,
                is_recursive=recursive,
            )
        )
        if resp.error:
            if "not found" in resp.error.lower():
                raise FileNotFoundError(full_path)
            raise FilerError(resp.error)
        self._notify(Entry(full_path=full_path), None)

    def rename(self, old_path: str, new_path: str) -> None:
        old_path, new_path = _norm(old_path), _norm(new_path)
        op, on = old_path.rsplit("/", 1)
        np, nn = new_path.rsplit("/", 1)
        resp = self._stub().AtomicRenameEntry(
            f_pb.AtomicRenameEntryRequest(
                old_directory=op or "/",
                old_name=on,
                new_directory=np or "/",
                new_name=nn,
            )
        )
        if resp.error:
            raise FilerError(resp.error)
        self._notify(Entry(full_path=old_path), Entry(full_path=new_path))

    def mkdirs(self, full_path: str, mode: int = 0o755) -> None:
        from seaweedfs_tpu_torch.filer.entry import Attr

        full_path = _norm(full_path)
        if full_path == "/" or self.find_entry(full_path) is not None:
            return
        self.create_entry(
            Entry(full_path=full_path, is_directory=True, attr=Attr.now(mode))
        )

    # ---- chunk reclamation ----------------------------------------------

    def _delete_chunks(self, entry: Entry) -> None:
        """Superseded-object chunk reclamation (same best-effort contract
        as Filer._delete_chunks; the server side does this for
        delete_entry, this covers overwrite-in-place paths)."""
        from seaweedfs_tpu_torch.filer import reader

        reader.delete_entry_chunks(self.master_client, entry)
