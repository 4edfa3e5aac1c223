"""Filer: path -> entry metadata over pluggable stores, chunked files.

The port's copy of seaweedfs_tpu/filer (reference weed/filer/: entry.go,
filechunks.go, filerstore.go, filer.go): directories and files live in a
key-value FilerStore; file bytes live as chunks on volume servers; reads
resolve the chunk list into non-overlapping visible intervals.  The
filer runs no kernel and takes no device.
"""

from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filechunks import (
    VisibleInterval,
    read_chunk_views,
    total_size,
    visible_intervals,
)
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import (
    AbstractSqlStore,
    FilerStore,
    MemoryStore,
    SqliteStore,
)
from seaweedfs_tpu_torch.filer.leveldb_store import (
    BTreeFilerStore,
    LevelDb2Store,
    LevelDb3Store,
    LevelDbStore,
    RocksDbStore,
)

# URL schemes of the JAX package's network stores (its redis_store.py,
# nosql_stores.py and sql_stores.py): refused by name until the port has them
_NOT_PORTED_SCHEMES = (
    "mysql", "mysql2", "postgres", "postgresql", "postgres2", "postgresql2", "redis",
    "valkey", "etcd", "mongodb", "mongodb+srv", "cassandra", "tikv", "hbase", "ydb",
    "arangodb", "elastic", "elastic7", "elasticsearch", "tarantool",
)


def make_store(spec: str) -> FilerStore:
    """Store factory for the ``-db`` flag (reference: the filer picks one of
    26 backends from filer.toml).  Specs:

    - ``""``                  -> in-memory
    - ``path/ending/.db``     -> sqlite
    - ``sqlite2:path.db``     -> sqlite, one table per /buckets/<b>
    - ``rocksdb:dir``         -> RocksDB (needs python-rocksdb; refused without it)
    - ``btree:path`` / ``*.btree`` -> append-only COW B+tree file
    - ``leveldb2:dir``        -> generational LSM (8 md5-partitioned dbs)
    - ``leveldb3:dir``        -> leveldb2 + one instance per /buckets/<b>
    - any other path          -> LSM store in that directory

    The SQL and NoSQL URLs of the JAX package (``mysql://``, ``postgres://``,
    ``redis://``, ``etcd://``, ``elastic://``, ...) raise: their stores are
    not ported yet (ROADMAP Queue A item 1)."""
    if not spec:
        return MemoryStore()
    scheme = spec.split("://", 1)[0] if "://" in spec else ""
    if scheme in _NOT_PORTED_SCHEMES:
        raise NotImplementedError(
            f"filer store {scheme}:// is not ported to seaweedfs_tpu_torch yet "
            "(ROADMAP Queue A item 1: the redis, nosql and sql stores)")
    if scheme == "rocksdb" or spec.startswith("rocksdb:"):
        path = spec.split("://", 1)[1] if "://" in spec else spec[8:]
        return RocksDbStore(path)
    for kind, cls in (("leveldb2", LevelDb2Store), ("leveldb3", LevelDb3Store)):
        if scheme == kind or spec.startswith(kind + ":"):
            path = spec.split("://", 1)[1] if "://" in spec else spec[len(kind) + 1:]
            return cls(path)
    if scheme == "btree":
        return BTreeFilerStore(spec.split("://", 1)[1])
    if spec.startswith("btree:"):
        return BTreeFilerStore(spec[len("btree:"):])
    if spec.endswith(".btree"):
        return BTreeFilerStore(spec)
    if scheme == "sqlite2" or spec.startswith("sqlite2:"):
        path = spec.split("://", 1)[1] if "://" in spec else spec[8:]
        return SqliteStore(path, support_bucket_table=True)
    if spec.endswith(".db"):
        return SqliteStore(spec)
    return LevelDbStore(spec)


__all__ = [
    "AbstractSqlStore",
    "BTreeFilerStore",
    "make_store",
    "Attr",
    "Entry",
    "FileChunk",
    "Filer",
    "FilerStore",
    "LevelDb2Store",
    "LevelDb3Store",
    "LevelDbStore",
    "MemoryStore",
    "SqliteStore",
    "VisibleInterval",
    "read_chunk_views",
    "total_size",
    "visible_intervals",
]
