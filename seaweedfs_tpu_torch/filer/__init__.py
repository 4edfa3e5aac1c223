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

def make_store(spec: str) -> FilerStore:
    """Store factory for the ``-db`` flag (reference: the filer picks one of
    26 backends from filer.toml).  Specs:

    - ``""``                  -> in-memory
    - ``path/ending/.db``     -> sqlite
    - ``sqlite2:path.db``     -> sqlite, one table per /buckets/<b>
    - ``mysql://u:p@h/db``    -> MySQL (needs pymysql)
    - ``mysql2://u:p@h/db``   -> MySQL, one table per /buckets/<b>
    - ``postgres://u:p@h/db`` -> Postgres (needs psycopg2)
    - ``postgres2://u:p@h/db``-> Postgres, one table per /buckets/<b>
    - ``redis://host:port/0`` -> Redis (stdlib RESP client)
    - ``etcd://host:2379``    -> etcd (stdlib v3 JSON-gateway client)
    - ``mongodb://h/db``      -> MongoDB (needs pymongo)
    - ``cassandra://h/ks``    -> Cassandra (needs cassandra-driver)
    - ``tikv://pd1,pd2``      -> TiKV (needs tikv_client)
    - ``hbase://h:9090/table``-> HBase (needs happybase)
    - ``ydb://h:2136/db``     -> YDB (needs ydb-dbapi)
    - ``arangodb://u:p@h/db`` -> ArangoDB (needs python-arango)
    - ``elastic://h:9200``    -> Elasticsearch (stdlib REST client)
    - ``tarantool://h:3301``  -> Tarantool (needs tarantool)
    - ``rocksdb:dir``         -> RocksDB (needs python-rocksdb)
    - ``btree:path`` / ``*.btree`` -> append-only COW B+tree file
    - ``leveldb2:dir``        -> generational LSM (8 md5-partitioned dbs)
    - ``leveldb3:dir``        -> leveldb2 + one instance per /buckets/<b>
    - any other path          -> LSM store in that directory

    A store whose driver is absent refuses with the JAX package's text."""
    if not spec:
        return MemoryStore()
    scheme = spec.split("://", 1)[0] if "://" in spec else ""
    if scheme == "mysql":
        from seaweedfs_tpu_torch.filer.sql_stores import MySqlStore

        return MySqlStore(spec)
    if scheme == "mysql2":
        from seaweedfs_tpu_torch.filer.sql_stores import Mysql2Store

        return Mysql2Store(spec.replace("mysql2://", "mysql://", 1))
    if scheme in ("postgres2", "postgresql2"):
        from seaweedfs_tpu_torch.filer.sql_stores import Postgres2Store

        return Postgres2Store(spec.replace(scheme + "://", "postgres://", 1))
    if scheme in ("postgres", "postgresql"):
        from seaweedfs_tpu_torch.filer.sql_stores import PostgresStore

        return PostgresStore(spec)
    if scheme in ("redis", "valkey"):
        from seaweedfs_tpu_torch.filer.redis_store import RedisStore

        return RedisStore(spec)
    if scheme == "ydb":
        from seaweedfs_tpu_torch.filer.sql_stores import YdbStore

        return YdbStore(spec)
    nosql = {
        "etcd": "EtcdStore", "mongodb": "MongoStore", "mongodb+srv": "MongoStore",
        "cassandra": "CassandraStore", "tikv": "TikvStore", "hbase": "HbaseStore",
        "arangodb": "ArangodbStore", "elastic": "ElasticStore",
        "elastic7": "ElasticStore", "elasticsearch": "ElasticStore",
        "tarantool": "TarantoolStore",
    }
    if scheme in nosql:
        from seaweedfs_tpu_torch.filer import nosql_stores

        return getattr(nosql_stores, nosql[scheme])(spec)
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
