"""NoSQL filer stores: etcd, MongoDB, Cassandra, TiKV, HBase, ArangoDB.

The long tail of the reference's 26 filer backends
(the reference's weed/filer/{etcd,mongodb,cassandra2,tikv,hbase,
arangodb}/).  Same convention as the SQL/redis stores: complete store
logic here, with the external dependency import-gated (the package
depends on no database driver) — except etcd, which is driven through its v3
HTTP/JSON gateway with the stdlib only, the way the redis store speaks
raw RESP.

Key designs mirror the reference backends:

- etcd:      one KV per entry, key = ``<dir>\\x00<name>`` so a directory's
             children are one contiguous, name-ordered range
             (weed/filer/etcd/etcd_store.go genKey).
- mongodb:   ``filemeta`` collection, unique index on (directory, name)
             (weed/filer/mongodb/mongodb_store.go).
- cassandra: ``filemeta`` table, partition per directory, clustered by
             name (weed/filer/cassandra2/cassandra_store.go).
- tikv:      raw KV, same key design as etcd
             (weed/filer/tikv/tikv_store.go).
- hbase:     one table, row key = ``<dir>\\x00<name>``, column f:meta
             (weed/filer/hbase/hbase_store_kv.go).
- arangodb:  ``filemeta`` collection, documents keyed by a digest of the
             full path with (directory, name) persisted for AQL range
             listings (weed/filer/arangodb/arangodb_store.go).

``delete_folder_children`` clears ONE directory level — the Filer's
``_delete_tree`` recursion (filer.py) visits subdirectories itself, so
per-partition deletes compose into recursive semantics.

The port's copy of seaweedfs_tpu/filer/nosql_stores.py.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
from urllib.parse import urlparse

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore


def _dir_key(dir_path: str) -> bytes:
    return dir_path.rstrip("/").encode() or b""


def _entry_key(dir_path: str, name: str) -> bytes:
    return _dir_key(dir_path) + b"\x00" + name.encode()


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest key greater than every key starting with ``prefix``."""
    out = bytearray(prefix)
    while out:
        if out[-1] != 0xFF:
            out[-1] += 1
            return bytes(out)
        out.pop()
    return b"\x00"  # etcd convention: from-key-to-end


class _KvFilerStore(FilerStore):
    """Shared path/list logic for ordered-KV backends (etcd, tikv):
    subclasses provide point put/get/delete and ordered range scans."""

    def _kv_put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def _kv_get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def _kv_delete(self, key: bytes) -> None:
        raise NotImplementedError

    def _kv_delete_range(self, start: bytes, end: bytes) -> None:
        raise NotImplementedError

    def _kv_scan(
        self, start: bytes, end: bytes, limit: int
    ) -> list[tuple[bytes, bytes]]:
        raise NotImplementedError

    # ---- FilerStore ------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        self._kv_put(_entry_key(entry.parent, entry.name), entry.encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        blob = self._kv_get(_entry_key(parent or "/", name))
        return Entry.decode(full_path, blob) if blob is not None else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self._kv_delete(_entry_key(parent or "/", name))

    def delete_folder_children(self, full_path: str) -> None:
        start = _dir_key(full_path) + b"\x00"
        self._kv_delete_range(start, _prefix_end(start))

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = _dir_key(dir_path) + b"\x00"
        start = base + (prefix or start_file_name).encode()
        if start_file_name and (not prefix or start_file_name > prefix):
            start = base + start_file_name.encode()
        end = _prefix_end(base)
        out: list[Entry] = []
        dirname = dir_path.rstrip("/")
        # over-fetch one so the exclusive-start skip cannot shorten a page
        for key, blob in self._kv_scan(start, end, limit + 1):
            name = key[len(base):].decode()
            if prefix and not name.startswith(prefix):
                break  # ordered scan: past the prefix range
            if start_file_name and name == start_file_name and not inclusive:
                continue
            out.append(Entry.decode(f"{dirname}/{name}", blob))
            if len(out) >= limit:
                break
        return out

    def count(self) -> tuple[int, int]:
        files = dirs = 0
        cursor = b"\x00"
        while True:
            batch = self._kv_scan(cursor, b"", 1024)
            if not batch:
                return files, dirs
            for key, blob in batch:
                parent, _, name = key.rpartition(b"\x00")
                e = Entry.decode(
                    (parent.decode() or "") + "/" + name.decode(), blob
                )
                if e.is_directory:
                    dirs += 1
                else:
                    files += 1
            cursor = batch[-1][0] + b"\x00"


class EtcdStore(_KvFilerStore):
    """etcd v3 over its HTTP/JSON gateway (stdlib only — no driver
    needed; anything serving the /v3/kv/* gateway works)."""

    name = "etcd"

    def __init__(self, spec: str):
        u = urlparse(spec)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 2379
        self._local = threading.local()
        self._conns: list[http.client.HTTPConnection] = []
        self._conns_lock = threading.Lock()
        try:  # fail fast with a clear message, like the driver gates
            self._call("/v3/kv/range", {"key": _b64(b"\x00"), "limit": 1})
        except OSError as e:
            raise RuntimeError(
                f"etcd store: cannot reach {self.host}:{self.port} "
                f"(etcd v3 JSON gateway): {e}"
            ) from e

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # store-owned keep-alive conns to an external etcd gateway,
            # closed by store.close()
            # weedlint: disable=W008 — store-owned keep-alive conn to external etcd
            conn = http.client.HTTPConnection(self.host, self.port, timeout=10)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def close(self) -> None:
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()

    def _call(self, path: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        for attempt in range(2):  # one reconnect for idled-out keep-alives
            conn = self._conn()
            try:
                conn.request(
                    "POST", path, body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(
                        f"etcd {path}: HTTP {resp.status} {data[:200]!r}"
                    )
                return json.loads(data)
            except (http.client.HTTPException, OSError):
                self._local.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _kv_put(self, key: bytes, value: bytes) -> None:
        self._call("/v3/kv/put", {"key": _b64(key), "value": _b64(value)})

    def _kv_get(self, key: bytes) -> bytes | None:
        doc = self._call("/v3/kv/range", {"key": _b64(key)})
        kvs = doc.get("kvs") or []
        return base64.b64decode(kvs[0]["value"]) if kvs else None

    def _kv_delete(self, key: bytes) -> None:
        self._call("/v3/kv/deleterange", {"key": _b64(key)})

    def _kv_delete_range(self, start: bytes, end: bytes) -> None:
        self._call(
            "/v3/kv/deleterange",
            {"key": _b64(start), "range_end": _b64(end)},
        )

    def _kv_scan(self, start, end, limit):
        doc = self._call(
            "/v3/kv/range",
            {
                "key": _b64(start),
                "range_end": _b64(end if end else b"\x00"),
                "limit": limit,
                "sort_order": "ASCEND",
                "sort_target": "KEY",
            },
        )
        return [
            (base64.b64decode(kv["key"]), base64.b64decode(kv["value"]))
            for kv in doc.get("kvs") or []
        ]


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


class TikvStore(_KvFilerStore):
    """TiKV raw-KV store (reference weed/filer/tikv/); needs the
    ``tikv_client`` package — import-gated."""

    name = "tikv"

    def __init__(self, spec: str):
        try:
            from tikv_client import RawClient  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "tikv store needs the tikv_client package "
                "(pip install tikv-client)"
            ) from e
        pd = spec.split("://", 1)[1] if "://" in spec else spec
        self.client = RawClient.connect(pd.split(","))

    def _kv_put(self, key, value):
        self.client.put(key, value)

    def _kv_get(self, key):
        return self.client.get(key)

    def _kv_delete(self, key):
        self.client.delete(key)

    def _kv_delete_range(self, start, end):
        self.client.delete_range(start, end)

    def _kv_scan(self, start, end, limit):
        return list(self.client.scan(start, end=end or None, limit=limit))


class MongoStore(FilerStore):
    """MongoDB store (reference weed/filer/mongodb/): ``filemeta``
    collection keyed (directory, name); needs pymongo — import-gated."""

    name = "mongodb"

    def __init__(self, spec: str, database: str = "seaweedfs"):
        try:
            import pymongo  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "mongodb store needs the pymongo package (pip install pymongo)"
            ) from e
        self.client = pymongo.MongoClient(spec)
        dbname = urlparse(spec).path.lstrip("/") or database
        self.col = self.client[dbname]["filemeta"]
        self.col.create_index(
            [("directory", 1), ("name", 1)], unique=True
        )

    def close(self) -> None:
        self.client.close()

    def insert_entry(self, entry: Entry) -> None:
        self.col.replace_one(
            {"directory": entry.parent, "name": entry.name},
            {
                "directory": entry.parent,
                "name": entry.name,
                "is_directory": entry.is_directory,
                "meta": entry.encode(),
            },
            upsert=True,
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        doc = self.col.find_one({"directory": parent or "/", "name": name})
        return (
            Entry.decode(full_path, bytes(doc["meta"])) if doc else None
        )

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self.col.delete_one({"directory": parent or "/", "name": name})

    def delete_folder_children(self, full_path: str) -> None:
        self.col.delete_many({"directory": full_path.rstrip("/") or "/"})

    def list_entries(
        self, dir_path: str, start_file_name: str = "",
        inclusive: bool = False, limit: int = 1024, prefix: str = "",
    ) -> list[Entry]:
        query: dict = {"directory": dir_path.rstrip("/") or "/"}
        name_cond: dict = {}
        if prefix:
            import re

            name_cond["$regex"] = "^" + re.escape(prefix)
        if start_file_name:
            name_cond["$gte" if inclusive else "$gt"] = start_file_name
        if name_cond:
            query["name"] = name_cond
        base = dir_path.rstrip("/")
        return [
            Entry.decode(f"{base}/{d['name']}", bytes(d["meta"]))
            for d in self.col.find(query).sort("name", 1).limit(limit)
        ]

    def count(self) -> tuple[int, int]:
        dirs = self.col.count_documents({"is_directory": True})
        return self.col.count_documents({}) - dirs, dirs


class CassandraStore(FilerStore):
    """Cassandra store (reference weed/filer/cassandra2/): one partition
    per directory, clustered by name; needs cassandra-driver —
    import-gated."""

    name = "cassandra"

    def __init__(self, spec: str, keyspace: str = "seaweedfs"):
        try:
            from cassandra.cluster import Cluster  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "cassandra store needs the cassandra-driver package "
                "(pip install cassandra-driver)"
            ) from e
        u = urlparse(spec)
        hosts = (u.netloc or spec).split(",")
        self.keyspace = u.path.lstrip("/") or keyspace
        self.session = Cluster(
            [h.split(":")[0] for h in hosts]
        ).connect()
        self.session.execute(
            f"CREATE KEYSPACE IF NOT EXISTS {self.keyspace} WITH replication"
            " = {'class': 'SimpleStrategy', 'replication_factor': 1}"
        )
        self.session.set_keyspace(self.keyspace)
        self.session.execute(
            "CREATE TABLE IF NOT EXISTS filemeta ("
            "directory text, name text, meta blob, "
            "PRIMARY KEY (directory, name))"
        )

    def insert_entry(self, entry: Entry) -> None:
        self.session.execute(
            "INSERT INTO filemeta (directory, name, meta) VALUES (%s, %s, %s)",
            (entry.parent, entry.name, entry.encode()),
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        rows = list(
            self.session.execute(
                "SELECT meta FROM filemeta WHERE directory = %s AND name = %s",
                (parent or "/", name),
            )
        )
        return Entry.decode(full_path, bytes(rows[0].meta)) if rows else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self.session.execute(
            "DELETE FROM filemeta WHERE directory = %s AND name = %s",
            (parent or "/", name),
        )

    def delete_folder_children(self, full_path: str) -> None:
        self.session.execute(
            "DELETE FROM filemeta WHERE directory = %s",
            (full_path.rstrip("/") or "/",),
        )

    def list_entries(
        self, dir_path: str, start_file_name: str = "",
        inclusive: bool = False, limit: int = 1024, prefix: str = "",
    ) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        # the prefix must bound the CLUSTERED scan, not post-filter a
        # LIMIT-ed page — filtering after LIMIT can return [] while
        # matches exist beyond the page, which ends pagination early
        floor, cmp_op = "", ">"
        if prefix and (not start_file_name or prefix > start_file_name):
            floor, cmp_op = prefix, ">="
        elif start_file_name:
            floor, cmp_op = start_file_name, (">=" if inclusive else ">")
        if floor:
            rows = self.session.execute(
                f"SELECT name, meta FROM filemeta WHERE directory = %s "
                f"AND name {cmp_op} %s LIMIT %s",
                (d, floor, limit),
            )
        else:
            rows = self.session.execute(
                "SELECT name, meta FROM filemeta WHERE directory = %s "
                "LIMIT %s",
                (d, limit),
            )
        base = dir_path.rstrip("/")
        out = []
        for row in rows:
            if prefix and not row.name.startswith(prefix):
                break  # clustered order, floor >= prefix: past the range
            out.append(Entry.decode(f"{base}/{row.name}", bytes(row.meta)))
        return out

    def close(self) -> None:
        self.session.cluster.shutdown()

    def count(self) -> tuple[int, int]:
        files = dirs = 0
        for row in self.session.execute("SELECT meta, directory, name FROM filemeta"):
            e = Entry.decode(f"{row.directory}/{row.name}", bytes(row.meta))
            if e.is_directory:
                dirs += 1
            else:
                files += 1
        return files, dirs


class HbaseStore(_KvFilerStore):
    """HBase store (reference weed/filer/hbase/): one table, row key =
    ``<dir>\\x00<name>``, single column ``f:meta`` holding the encoded
    entry — HBase's ordered row scans make it another _KvFilerStore.
    Needs the ``happybase`` Thrift client — import-gated."""

    name = "hbase"

    def __init__(self, spec: str, table: str = "seaweedfs"):
        try:
            import happybase  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "hbase store needs the happybase package "
                "(pip install happybase)"
            ) from e
        u = urlparse(spec if "://" in spec else f"hbase://{spec}")
        self.conn = happybase.Connection(
            u.hostname or "127.0.0.1", u.port or 9090
        )
        table = (u.path.lstrip("/") or table).encode()
        if table not in self.conn.tables():
            self.conn.create_table(table.decode(), {"f": {}})
        self.table = self.conn.table(table)

    def close(self) -> None:
        self.conn.close()

    def _kv_put(self, key: bytes, value: bytes) -> None:
        self.table.put(key, {b"f:meta": value})

    def _kv_get(self, key: bytes) -> bytes | None:
        return self.table.row(key, columns=[b"f:meta"]).get(b"f:meta")

    def _kv_delete(self, key: bytes) -> None:
        self.table.delete(key)

    def _kv_delete_range(self, start: bytes, end: bytes) -> None:
        # HBase has no range delete: scan the keys, delete each
        doomed = [
            k for k, _ in self.table.scan(
                row_start=start, row_stop=end or None, columns=[b"f:meta"]
            )
        ]
        for k in doomed:
            self.table.delete(k)

    def _kv_scan(self, start, end, limit):
        out = []
        for k, data in self.table.scan(
            row_start=start, row_stop=end or None, limit=limit,
            columns=[b"f:meta"],
        ):
            out.append((k, data[b"f:meta"]))
            if len(out) >= limit:
                break
        return out


class ArangodbStore(FilerStore):
    """ArangoDB store (reference weed/filer/arangodb/): documents in a
    ``filemeta`` collection keyed by a sha1 of the full path (Arango
    _keys forbid path characters), with ``directory``/``name`` fields
    persistently indexed so listings are ordered AQL range reads.
    Needs the ``python-arango`` driver — import-gated."""

    name = "arangodb"

    def __init__(self, spec: str, database: str = "seaweedfs"):
        try:
            from arango import ArangoClient  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "arangodb store needs the python-arango package "
                "(pip install python-arango)"
            ) from e
        u = urlparse(spec)
        host = f"http://{u.hostname or '127.0.0.1'}:{u.port or 8529}"
        dbname = u.path.lstrip("/") or database
        client = ArangoClient(hosts=host)
        self.db = client.db(
            dbname, username=u.username or "root",
            password=u.password or "",
        )
        if not self.db.has_collection("filemeta"):
            self.db.create_collection("filemeta")
        self.col = self.db.collection("filemeta")
        self.col.add_persistent_index(fields=["directory", "name"])

    @staticmethod
    def _doc_key(directory: str, name: str) -> str:
        import hashlib

        return hashlib.sha1(
            (directory + "\x00" + name).encode()
        ).hexdigest()

    def _doc(self, entry: Entry) -> dict:
        return {
            "_key": self._doc_key(entry.parent, entry.name),
            "directory": entry.parent,
            "name": entry.name,
            "is_directory": entry.is_directory,
            "meta": base64.b64encode(entry.encode()).decode(),
        }

    def insert_entry(self, entry: Entry) -> None:
        self.col.insert(self._doc(entry), overwrite=True)

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        doc = self.col.get(self._doc_key(parent or "/", name))
        if doc is None:
            return None
        return Entry.decode(full_path, base64.b64decode(doc["meta"]))

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self.col.delete(
            self._doc_key(parent or "/", name), ignore_missing=True
        )

    def delete_folder_children(self, full_path: str) -> None:
        self.db.aql.execute(
            "FOR d IN filemeta FILTER d.directory == @dir REMOVE d IN filemeta",
            bind_vars={"dir": full_path.rstrip("/") or "/"},
        )

    def list_entries(
        self, dir_path: str, start_file_name: str = "",
        inclusive: bool = False, limit: int = 1024, prefix: str = "",
    ) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        filters = ["d.directory == @dir"]
        bind: dict = {"dir": d, "limit": limit}
        if start_file_name:
            filters.append(
                "d.name >= @start" if inclusive else "d.name > @start"
            )
            bind["start"] = start_file_name
        if prefix:
            # bound the index range, not post-filter a LIMITed page
            filters.append("STARTS_WITH(d.name, @prefix)")
            bind["prefix"] = prefix
        cursor = self.db.aql.execute(
            "FOR d IN filemeta FILTER " + " AND ".join(filters)
            + " SORT d.name LIMIT @limit RETURN {name: d.name, meta: d.meta}",
            bind_vars=bind,
        )
        base = dir_path.rstrip("/")
        return [
            Entry.decode(
                f"{base}/{doc['name']}", base64.b64decode(doc["meta"])
            )
            for doc in cursor
        ]

    def count(self) -> tuple[int, int]:
        dirs = next(self.db.aql.execute(
            "RETURN LENGTH(FOR d IN filemeta "
            "FILTER d.is_directory == true RETURN 1)"
        ))
        return self.col.count() - dirs, dirs


class ElasticStore(FilerStore):
    """Elasticsearch store (reference weed/filer/elastic/v7/): one
    ``.seaweedfs_filemeta`` index, documents keyed by a urlsafe digest of
    the full path with ``directory``/``name`` keyword fields so listings
    are term-filtered, name-sorted range searches.  Driven through the
    REST API with the stdlib (the etcd-store convention) — anything
    serving the ES 7 JSON API works; construction fails fast when the
    cluster is unreachable."""

    name = "elastic"
    _INDEX = ".seaweedfs_filemeta"

    def __init__(self, spec: str):
        u = urlparse(spec)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 9200
        self._local = threading.local()
        try:
            self._call("GET", "/")
        except OSError as e:
            raise RuntimeError(
                f"elastic store: cannot reach {self.host}:{self.port} "
                f"(Elasticsearch REST API): {e}"
            ) from e
        # keyword mappings: range/sort on name must be lexicographic.
        # A swallowed creation failure would leave dynamic text mappings
        # whose analyzed fields silently break every term filter — only
        # the already-exists race is ignorable.
        if self._call("GET", f"/{self._INDEX}").get("_404"):
            try:
                self._call(
                    "PUT", f"/{self._INDEX}",
                    {
                        "mappings": {
                            "properties": {
                                "directory": {"type": "keyword"},
                                "name": {"type": "keyword"},
                                "is_directory": {"type": "boolean"},
                                "meta": {"type": "binary"},
                            }
                        }
                    },
                )
            except RuntimeError as e:
                if "resource_already_exists" not in str(e):
                    raise

    def _call(self, method: str, path: str, payload: dict | None = None,
              ok_statuses=(200, 201)) -> dict:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # store-owned keep-alive conn to an external Elasticsearch
            # endpoint, reconnect policy below
            # weedlint: disable=W008 — store-owned keep-alive conn to external Elasticsearch
            conn = http.client.HTTPConnection(self.host, self.port, timeout=10)
            self._local.conn = conn
        body = json.dumps(payload).encode() if payload is not None else None
        for attempt in range(2):
            try:
                conn.request(
                    method, path, body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status not in ok_statuses and resp.status != 404:
                    raise RuntimeError(
                        f"elastic {method} {path}: HTTP {resp.status} "
                        f"{data[:200]!r}"
                    )
                if resp.status == 404:
                    return {"_404": True}
                return json.loads(data) if data else {}
            except (http.client.HTTPException, OSError):
                # weedlint: disable=W008 — reconnect of the store-owned conn
                self._local.conn = conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=10
                )
                if attempt:
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _doc_id(full_path: str) -> str:
        return base64.urlsafe_b64encode(full_path.encode()).decode()

    def insert_entry(self, entry: Entry) -> None:
        self._call(
            "PUT",
            f"/{self._INDEX}/_doc/{self._doc_id(entry.full_path)}"
            "?refresh=true",
            {
                "directory": entry.parent,
                "name": entry.name,
                "is_directory": entry.is_directory,
                "meta": base64.b64encode(entry.encode()).decode(),
            },
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        doc = self._call(
            "GET", f"/{self._INDEX}/_doc/{self._doc_id(full_path)}"
        )
        if doc.get("_404") or not doc.get("found"):
            return None
        return Entry.decode(
            full_path, base64.b64decode(doc["_source"]["meta"])
        )

    def delete_entry(self, full_path: str) -> None:
        self._call(
            "DELETE",
            f"/{self._INDEX}/_doc/{self._doc_id(full_path)}?refresh=true",
            ok_statuses=(200,),
        )

    def delete_folder_children(self, full_path: str) -> None:
        self._call(
            "POST", f"/{self._INDEX}/_delete_by_query?refresh=true",
            {
                "query": {
                    "term": {"directory": full_path.rstrip("/") or "/"}
                }
            },
        )

    def list_entries(
        self, dir_path: str, start_file_name: str = "",
        inclusive: bool = False, limit: int = 1024, prefix: str = "",
    ) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        musts: list[dict] = [{"term": {"directory": d}}]
        if start_file_name:
            op = "gte" if inclusive else "gt"
            musts.append({"range": {"name": {op: start_file_name}}})
        if prefix:
            musts.append({"prefix": {"name": prefix}})
        doc = self._call(
            "POST", f"/{self._INDEX}/_search",
            {
                "size": limit,
                "sort": [{"name": "asc"}],
                "query": {"bool": {"filter": musts}},
            },
        )
        base = dir_path.rstrip("/")
        out: list[Entry] = []
        for hit in (doc.get("hits", {}).get("hits") or []):
            src = hit["_source"]
            out.append(
                Entry.decode(
                    f"{base}/{src['name']}", base64.b64decode(src["meta"])
                )
            )
        return out

    def count(self) -> tuple[int, int]:
        total = self._call(
            "GET", f"/{self._INDEX}/_count"
        ).get("count", 0)
        dirs = self._call(
            "POST", f"/{self._INDEX}/_count",
            {"query": {"term": {"is_directory": True}}},
        ).get("count", 0)
        return total - dirs, dirs


class TarantoolStore(FilerStore):
    """Tarantool store (reference weed/filer/tarantool/): a ``filemeta``
    space with a composite (directory, name) primary index; listings are
    GT/GE iterator selects.  Needs the ``tarantool`` connector —
    import-gated."""

    name = "tarantool"
    _SPACE = "filemeta"

    def __init__(self, spec: str):
        try:
            import tarantool  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "tarantool store needs the tarantool package "
                "(pip install tarantool)"
            ) from e
        u = urlparse(spec)
        self.conn = tarantool.connect(
            u.hostname or "127.0.0.1", u.port or 3301,
            user=u.username or None, password=u.password or None,
        )
        # space + composite primary key, idempotent (like CREATE IF NOT
        # EXISTS in the SQL stores)
        self.conn.eval(
            "local s = box.schema.space.create('" + self._SPACE + "', "
            "{if_not_exists = true, format = {"
            "{name='directory', type='string'},"
            "{name='name', type='string'},"
            "{name='is_directory', type='boolean'},"
            "{name='meta', type='varbinary'}}})\n"
            "s:create_index('primary', {if_not_exists = true, parts = "
            "{'directory', 'name'}})"
        )
        self.space = self.conn.space(self._SPACE)

    def close(self) -> None:
        self.conn.close()

    def insert_entry(self, entry: Entry) -> None:
        self.space.replace(
            (entry.parent, entry.name, entry.is_directory, entry.encode())
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        rows = self.space.select((parent or "/", name))
        if not rows:
            return None
        return Entry.decode(full_path, bytes(rows[0][3]))

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        self.space.delete((parent or "/", name))

    def delete_folder_children(self, full_path: str) -> None:
        d = full_path.rstrip("/") or "/"
        for row in self.space.select((d,), iterator="EQ"):
            self.space.delete((row[0], row[1]))

    def list_entries(
        self, dir_path: str, start_file_name: str = "",
        inclusive: bool = False, limit: int = 1024, prefix: str = "",
    ) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        floor = start_file_name
        if prefix and prefix > floor:
            floor = prefix
        it = "GE" if (inclusive or floor == prefix) else "GT"
        rows = self.space.select((d, floor), iterator=it, limit=limit + 1)
        base = dir_path.rstrip("/")
        out: list[Entry] = []
        for row in rows:
            if row[0] != d:
                break  # iterator ran past the directory partition
            name = row[1]
            if name == start_file_name and not inclusive:
                continue
            if prefix and not name.startswith(prefix):
                break
            out.append(Entry.decode(f"{base}/{name}", bytes(row[3])))
            if len(out) >= limit:
                break
        return out

    def count(self) -> tuple[int, int]:
        files = dirs = 0
        for row in self.space.select((), iterator="ALL"):
            if row[2]:
                dirs += 1
            else:
                files += 1
        return files, dirs
