"""Typed filer gRPC client used by the mount layer (and other tools).

The mount talks to a *remote* filer the way the reference's mount does
(filer_pb client in mount/weedfs.go), so one mounted tree can follow a
shared cluster — an in-process Filer object could not.

The port's copy of seaweedfs_tpu/mount/filer_client.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.wdclient import MasterClient

from seaweedfs_tpu_torch.util import wlog


class FilerError(RuntimeError):
    pass


class FilerClient:
    def __init__(self, filer_grpc: str, master_grpc: str):
        addrs = [a.strip() for a in filer_grpc.split(",") if a.strip()]
        self.address = addrs[0] if addrs else filer_grpc
        self.stub = rpc.make_stub(self.address, f_pb, "Filer")
        self.master = MasterClient(master_grpc)
        # a comma-separated filer list = the sharded metadata plane: the
        # same consistent-hash router the S3 gateway rides
        # (filer/shard_ring.py) routes every entry op; a single address
        # keeps the direct-stub behavior call-for-call.  With sharding,
        # ``subscribe`` tails only the FIRST shard (the mount cache's
        # TTL bounds the other shards' mutations, same as any
        # out-of-band change).
        self._router = None
        if len(addrs) > 1:
            from seaweedfs_tpu_torch.filer.shard_ring import ShardedFilerClient

            self._router = ShardedFilerClient(addrs, self.master)

    def lookup(self, path: str) -> Entry | None:
        if self._router is not None:
            e = self._routed(
                lambda: self._router.find_entry(path.rstrip("/") or "/")
            )
            if e is not None:
                e.full_path = path.rstrip("/") or "/"
            return e
        directory, _, name = path.rstrip("/").rpartition("/")
        resp = self.stub.LookupDirectoryEntry(
            f_pb.LookupDirectoryEntryRequest(
                directory=directory or "/", name=name or "/"
            )
        )
        if resp.error:
            return None
        e = Entry.from_pb(directory or "/", resp.entry)
        e.full_path = path.rstrip("/") or "/"
        return e

    def list(
        self, directory: str, limit: int = 10_000, start_from: str = ""
    ) -> list[Entry]:
        if self._router is not None:
            return self._routed(
                lambda: self._router.list_entries(
                    directory, start_file_name=start_from, limit=limit
                )
            )
        return [
            Entry.from_pb(directory, r.entry)
            for r in self.stub.ListEntries(
                f_pb.ListEntriesRequest(
                    directory=directory,
                    limit=limit,
                    start_from_file_name=start_from,
                )
            )
        ]

    def create(self, entry: Entry) -> None:
        if self._router is not None:
            self._routed(lambda: self._router.create_entry(entry))
            return
        resp = self.stub.CreateEntry(
            f_pb.CreateEntryRequest(directory=entry.parent, entry=entry.to_pb())
        )
        if resp.error:
            raise FilerError(resp.error)

    def update(self, entry: Entry) -> None:
        if self._router is not None:
            self._routed(lambda: self._router.update_entry(entry))
            return
        resp = self.stub.UpdateEntry(
            f_pb.UpdateEntryRequest(directory=entry.parent, entry=entry.to_pb())
        )
        if resp.error:
            raise FilerError(resp.error)

    def delete(self, path: str, recursive: bool = False) -> None:
        if self._router is not None:
            self._routed(
                lambda: self._router.delete_entry(path, recursive=recursive)
            )
            return
        directory, _, name = path.rstrip("/").rpartition("/")
        resp = self.stub.DeleteEntry(
            f_pb.DeleteEntryRequest(
                directory=directory or "/",
                name=name,
                is_delete_data=True,
                is_recursive=recursive,
            )
        )
        if resp.error:
            raise FilerError(resp.error)

    def rename(self, old: str, new: str) -> None:
        if self._router is not None:
            self._routed(lambda: self._router.rename(old, new))
            return
        od, _, on = old.rstrip("/").rpartition("/")
        nd, _, nn = new.rstrip("/").rpartition("/")
        resp = self.stub.AtomicRenameEntry(
            f_pb.AtomicRenameEntryRequest(
                old_directory=od or "/", old_name=on,
                new_directory=nd or "/", new_name=nn,
            )
        )
        if resp.error:
            raise FilerError(resp.error)

    @staticmethod
    def _routed(fn):
        """Run a router mutation, translating the filer package's error
        types into this client's FilerError contract."""
        from seaweedfs_tpu_torch.filer.filer import FilerError as CoreFilerError

        try:
            return fn()
        except FileNotFoundError as e:
            raise FilerError(f"{e} not found") from e
        except CoreFilerError as e:
            raise FilerError(str(e)) from e

    def reclaim_chunks(self, entry: Entry) -> None:
        """Best-effort delete of an entry's chunk data (incl. blobs behind
        manifest chunks) — the overwrite/truncate path must not leak the
        superseded object's storage."""
        from seaweedfs_tpu_torch.filer import manifest, reader

        chunks = entry.chunks
        if manifest.has_chunk_manifest(chunks):
            try:
                data, manis = manifest.resolve_chunk_manifest(
                    lambda fid: reader.fetch_chunk(self.master, fid), chunks
                )
                chunks = data + manis
            except Exception as e:  # noqa: BLE001 — unreadable manifest
                wlog.warning("mount delete: manifest unreadable, deleting listed chunks only: %s", e)
        for c in chunks:
            try:
                reader.delete_chunk(self.master, c.fid)
            except Exception as e:  # noqa: BLE001 — orphans get vacuumed
                if wlog.V(1):
                    wlog.info("mount delete: chunk %s not deleted (vacuum will): %s", c.fid, e)

    def subscribe(self, prefix: str, since_ts_ns: int, timeout: float = 2.0):
        """One bounded pass over the metadata stream (reconnect to tail)."""
        return self.stub.SubscribeMetadata(
            f_pb.SubscribeMetadataRequest(
                client_name="mount", path_prefix=prefix, since_ts_ns=since_ts_ns
            ),
            timeout=timeout,
        )
