"""LSM-backed filer stores: the port's copy of
seaweedfs_tpu/filer/leveldb_store.py, the counterpart of the reference's
leveldb filer backends (weed/filer/leveldb/leveldb_store.go: (dir,name)-keyed
ordered KV, prefix scans for listings), built on the port's own
:class:`~seaweedfs_tpu_torch.util.lsm.LsmStore`.  The directories and
``.btree`` files are byte-compatible with the JAX package's.  The port's
LSM scan ranks equal keys by table age (util/lsm.py), so a listing of
entries updated across two flushed memtables shows the newest version,
where the JAX package's can show a stale one.

Keys are ``directory + "\\x00" + name`` so one ordered scan yields a
directory's children in name order (``\\x00`` sorts before every path
byte, keeping each directory's block contiguous).
"""

from __future__ import annotations

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore
from seaweedfs_tpu_torch.util.lsm import LsmStore

_SEP = b"\x00"


def _key(directory: str, name: str) -> bytes:
    return directory.encode() + _SEP + name.encode()


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest byte string greater than every string with this prefix."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return b"\xff" * (len(prefix) + 1)
    p[-1] += 1
    return bytes(p)


class LevelDbStore(FilerStore):
    name = "leveldb"

    def __init__(self, dir_path: str, **lsm_kwargs):
        self.db = LsmStore(dir_path, **lsm_kwargs)

    def insert_entry(self, entry: Entry) -> None:
        self.db.put(_key(entry.parent, entry.name), entry.encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        blob = self.db.get(_key(parent or "/", name))
        return Entry.decode(full_path, blob) if blob is not None else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self.db.delete(_key(parent or "/", name))

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # direct children: keys "<base>\x00*"
        start = base.encode() + _SEP
        doomed = [k for k, _ in self.db.scan(start, _prefix_end(start))]
        # deeper levels: any key whose directory begins "<base>/"
        sub = (base.rstrip("/") + "/").encode()
        doomed += [k for k, _ in self.db.scan(sub, _prefix_end(sub))]
        for k in doomed:
            self.db.delete(k)

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or "/"
        lo = base.encode() + _SEP + start_file_name.encode()
        hi = _prefix_end(base.encode() + _SEP)
        out: list[Entry] = []
        parent = "" if base == "/" else base
        for key, blob in self.db.scan(lo, hi):
            name = key.split(_SEP, 1)[1].decode()
            if name == start_file_name and not inclusive:
                continue
            if prefix and not name.startswith(prefix):
                continue
            out.append(Entry.decode(f"{parent}/{name}", blob))
            if len(out) >= limit:
                break
        return out

    def count(self) -> tuple[int, int]:
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        files = dirs = 0
        for _, blob in self.db.scan():
            if f_pb.Entry.FromString(blob).is_directory:
                dirs += 1
            else:
                files += 1
        return files, dirs

    def close(self) -> None:
        self.db.close()


class LevelDb2Store(FilerStore):
    """Generational LSM store — counterpart of the reference's leveldb2
    backend (weed/filer/leveldb2/leveldb2_store.go): the keyspace splits
    across ``db_count`` independent LSM instances, partitioned by a hash
    of the DIRECTORY, and keys are ``md5(dir) + name`` — a fixed-width
    16-byte directory prefix, so one directory's children are one
    contiguous name-ordered range inside one partition regardless of how
    deep or long the path is.  Compactions/flushes shard with the
    partitions (the generational win over the single-LSM leveldb kind).

    Key design mirrors the reference (hashToBytes: md5 of the directory,
    last byte picks the partition)."""

    name = "leveldb2"

    def __init__(self, dir_path: str, db_count: int = 8, **lsm_kwargs):
        import os

        self.db_count = db_count
        self.dbs = [
            LsmStore(os.path.join(dir_path, f"{i:02d}"), **lsm_kwargs)
            for i in range(db_count)
        ]

    @staticmethod
    def _dir_hash(directory: str) -> bytes:
        import hashlib

        return hashlib.md5(
            (directory.rstrip("/") or "/").encode()
        ).digest()

    def _locate_dir(
        self, directory: str, create: bool = False
    ) -> tuple[bytes, LsmStore | None]:
        """Partition for a directory's children.  The LevelDb3 subclass
        overrides this to route /buckets/<b> subtrees to per-bucket
        instances; ``create`` distinguishes write paths (may materialize
        a bucket instance) from read paths (must not — a read of a
        deleted or never-created bucket returns nothing instead of
        resurrecting an empty instance on disk)."""
        h = self._dir_hash(directory)
        return h, self.dbs[h[-1] % self.db_count]

    def insert_entry(self, entry: Entry) -> None:
        h, db = self._locate_dir(entry.parent, create=True)
        db.put(h + entry.name.encode(), entry.encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        h, db = self._locate_dir(parent or "/")
        if db is None:
            return None
        blob = db.get(h + name.encode())
        return Entry.decode(full_path, blob) if blob is not None else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        h, db = self._locate_dir(parent or "/")
        if db is not None:
            db.delete(h + name.encode())

    def delete_folder_children(self, full_path: str) -> None:
        # one level only: md5 keys cannot prefix-scan a subtree, so the
        # Filer's recursive delete visits subdirectories itself (the
        # same per-level contract the etcd/tikv kinds rely on)
        h, db = self._locate_dir(full_path)
        if db is None:
            return
        doomed = [k for k, _ in db.scan(h, _prefix_end(h))]
        for k in doomed:
            db.delete(k)

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or "/"
        h, db = self._locate_dir(base)
        if db is None:
            return []
        floor = start_file_name
        if prefix and prefix > floor:
            floor = prefix  # names are ordered: jump to the prefix range
        lo = h + floor.encode()
        hi = _prefix_end(h)
        out: list[Entry] = []
        parent = "" if base == "/" else base
        for key, blob in db.scan(lo, hi):
            name = key[len(h):].decode()
            if name == start_file_name and not inclusive:
                continue
            if prefix and not name.startswith(prefix):
                break  # ordered scan past the prefix range
            out.append(Entry.decode(f"{parent}/{name}", blob))
            if len(out) >= limit:
                break
        return out

    def count(self) -> tuple[int, int]:
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        files = dirs = 0
        for db in self.dbs:
            for _, blob in db.scan():
                if f_pb.Entry.FromString(blob).is_directory:
                    dirs += 1
                else:
                    files += 1
        return files, dirs

    def close(self) -> None:
        for db in self.dbs:
            db.close()


class LevelDb3Store(LevelDb2Store):
    """Bucket-isolating generational store — counterpart of the
    reference's leveldb3 (weed/filer/leveldb3/leveldb3_store.go): every
    ``/buckets/<name>/...`` subtree lives in its OWN LSM instance
    (created on first write, opened on demand), with paths stored
    RELATIVE to the bucket root; everything else rides the leveldb2
    generational layout.  Deleting a bucket's children drops the whole
    instance — O(1) bucket deletion instead of a keyspace sweep."""

    name = "leveldb3"
    _BUCKETS_PREFIX = "/buckets/"

    def __init__(self, dir_path: str, db_count: int = 8, **lsm_kwargs):
        import os
        import threading

        super().__init__(
            os.path.join(dir_path, "_default"), db_count, **lsm_kwargs
        )
        self.root = dir_path
        self._lsm_kwargs = lsm_kwargs
        self._buckets: dict[str, LsmStore] = {}
        self._block = threading.Lock()

    # -- routing (reference findDB / findDBForChildren) -------------------

    def _split_bucket(self, path: str) -> tuple[str, str] | None:
        """('bucket', relative-path) for paths INSIDE a bucket; None for
        the default keyspace (including /buckets and the bucket dirs
        themselves, whose entries live beside their parent)."""
        if not path.startswith(self._BUCKETS_PREFIX):
            return None
        rest = path[len(self._BUCKETS_PREFIX):]
        bucket, sep, inner = rest.partition("/")
        if not bucket:
            return None
        return bucket, ("/" + inner if sep else "/")

    def _bucket_db(self, bucket: str, create: bool) -> LsmStore | None:
        import os

        with self._block:
            db = self._buckets.get(bucket)
            if db is None:
                path = os.path.join(self.root, "buckets", bucket)
                if not create and not os.path.isdir(path):
                    return None  # reads must not materialize instances
                db = LsmStore(path, **self._lsm_kwargs)
                self._buckets[bucket] = db
            return db

    def _locate_dir(
        self, directory: str, create: bool = False
    ) -> tuple[bytes, LsmStore | None]:
        at = self._split_bucket(directory.rstrip("/") or "/")
        if at is None:
            return super()._locate_dir(directory, create)
        bucket, rel = at
        return self._dir_hash(rel), self._bucket_db(bucket, create)

    def delete_folder_children(self, full_path: str) -> None:
        import os
        import shutil

        at = self._split_bucket(full_path.rstrip("/") or "/")
        if at is not None and at[1] == "/":
            # the bucket root: drop the whole instance (reference
            # leveldb3's O(1) bucket deletion)
            bucket = at[0]
            with self._block:
                db = self._buckets.pop(bucket, None)
            if db is not None:
                db.close()
            shutil.rmtree(
                os.path.join(self.root, "buckets", bucket),
                ignore_errors=True,
            )
            return
        super().delete_folder_children(full_path)

    def _open_disk_buckets(self) -> None:
        """Open every bucket instance present on disk (count() must see
        buckets this process hasn't touched yet)."""
        import os

        bdir = os.path.join(self.root, "buckets")
        if not os.path.isdir(bdir):
            return
        for name in os.listdir(bdir):
            if os.path.isdir(os.path.join(bdir, name)):
                self._bucket_db(name, create=True)  # dir exists: reopen

    def count(self) -> tuple[int, int]:
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        self._open_disk_buckets()
        files, dirs = super().count()
        with self._block:
            buckets = list(self._buckets.values())
        for db in buckets:
            for _, blob in db.scan():
                if f_pb.Entry.FromString(blob).is_directory:
                    dirs += 1
                else:
                    files += 1
        return files, dirs

    def close(self) -> None:
        super().close()
        with self._block:
            for db in self._buckets.values():
                db.close()
            self._buckets.clear()


class BTreeFilerStore(LevelDbStore):
    """Filer store on the append-only COW B+tree (util/btree.py) — a
    second fully in-image ordered-KV engine (the reference's bolt-family
    stores vs its leveldb family): same (dir \\x00 name) key scheme, so
    this class is only the engine swap.  Spec: ``-db btree:<path>`` or a
    path ending ``.btree``."""

    name = "btree"

    def __init__(self, path: str, **btree_kwargs):
        from seaweedfs_tpu_torch.util.btree import BTreeStore

        self.db = BTreeStore(path, **btree_kwargs)


class _RocksKv:
    """LsmStore-shaped facade over python-rocksdb (put/get/delete/scan),
    so RocksDbStore is only the engine swap under LevelDbStore."""

    def __init__(self, dir_path: str):
        import rocksdb  # type: ignore

        self.db = rocksdb.DB(
            dir_path, rocksdb.Options(create_if_missing=True)
        )

    def put(self, key: bytes, value: bytes) -> None:
        self.db.put(key, value)

    def get(self, key: bytes) -> bytes | None:
        return self.db.get(key)

    def delete(self, key: bytes) -> None:
        self.db.delete(key)

    def scan(self, start: bytes = b"", stop: bytes | None = None):
        it = self.db.iteritems()
        it.seek(start)
        for key, value in it:
            if stop is not None and key >= stop:
                return
            yield key, value

    def close(self) -> None:
        self.db = None  # python-rocksdb closes on GC; idempotent


class RocksDbStore(LevelDbStore):
    """RocksDB store (reference weed/filer/rocksdb/): the leveldb key
    scheme on a RocksDB engine.  Needs the ``rocksdb`` package
    (python-rocksdb) — import-gated."""

    name = "rocksdb"

    def __init__(self, dir_path: str):
        try:
            import rocksdb  # type: ignore  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "rocksdb store needs the rocksdb package "
                "(pip install python-rocksdb)"
            ) from e
        self.db = _RocksKv(dir_path)
