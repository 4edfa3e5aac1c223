"""Pluggable filer metadata stores: the port's copy of
seaweedfs_tpu/filer/filerstore.py (reference weed/filer/filerstore.go).

The reference ships 26 backends behind one interface (leveldb, mysql,
redis, cassandra, sqlite, ...); here the same interface gets a
lock-protected in-memory tree for tests and ephemeral filers, and SQLite
(stdlib) as the durable (directory, name)-keyed SQL store, the same schema
shape as the reference's abstract_sql backend (weed/filer/abstract_sql/).
A sqlite ``.db`` written by either package opens in the other.
"""

from __future__ import annotations

import sqlite3
import threading
from abc import ABC, abstractmethod

from seaweedfs_tpu_torch.filer.entry import Entry

from seaweedfs_tpu_torch.util import wlog


class FilerStore(ABC):
    """CRUD + ordered listing over (directory, name) keys."""

    name = "abstract"

    @abstractmethod
    def insert_entry(self, entry: Entry) -> None: ...

    @abstractmethod
    def update_entry(self, entry: Entry) -> None: ...

    @abstractmethod
    def find_entry(self, full_path: str) -> Entry | None: ...

    @abstractmethod
    def delete_entry(self, full_path: str) -> None: ...

    @abstractmethod
    def delete_folder_children(self, full_path: str) -> None: ...

    @abstractmethod
    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]: ...

    def count(self) -> tuple[int, int]:
        """(file_count, directory_count) — best effort for Statistics."""
        return (0, 0)

    def close(self) -> None:
        pass


class MemoryStore(FilerStore):
    """Dict-of-dicts store: directory → {name: encoded entry}."""

    name = "memory"

    def __init__(self):
        self._dirs: dict[str, dict[str, bytes]] = {"/": {}}
        self._lock = threading.Lock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            d = self._dirs.setdefault(entry.parent, {})
            d[entry.name] = entry.encode()
            if entry.is_directory:
                self._dirs.setdefault(entry.full_path, {})

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        with self._lock:
            blob = self._dirs.get(parent or "/", {}).get(name)
        return Entry.decode(full_path, blob) if blob is not None else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        with self._lock:
            self._dirs.get(parent or "/", {}).pop(name, None)
            self._dirs.pop(full_path, None)

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            prefix = full_path.rstrip("/") + "/"
            for d in [k for k in self._dirs if k == full_path or k.startswith(prefix)]:
                if d != full_path:
                    self._dirs.pop(d, None)
            if full_path in self._dirs:
                self._dirs[full_path] = {}

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}).keys())
            blobs = {n: self._dirs.get(dir_path, {})[n] for n in names}
        out: list[Entry] = []
        base = dir_path.rstrip("/")
        for n in names:
            if prefix and not n.startswith(prefix):
                continue
            if start_file_name:
                if n < start_file_name or (n == start_file_name and not inclusive):
                    continue
            out.append(Entry.decode(f"{base}/{n}", blobs[n]))
            if len(out) >= limit:
                break
        return out

    def count(self) -> tuple[int, int]:
        from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

        with self._lock:
            blobs = [b for d in self._dirs.values() for b in d.values()]
        dirs = sum(1 for b in blobs if f_pb.Entry.FromString(b).is_directory)
        return len(blobs) - dirs, dirs


def _escape_like(text: str) -> str:
    # LIKE metacharacters in a path must be escaped or `_`/`%` in a
    # bucket/directory name silently match unrelated subtrees.
    return text.replace("\\", "\\\\").replace("%", r"\%").replace("_", r"\_")


class AbstractSqlStore(FilerStore):
    """(directory, name)-keyed SQL store, schema per the reference's
    abstract_sql backend (weed/filer/abstract_sql/abstract_sql_store.go:
    upsert on (directory, name), range scans for listing).

    Subclasses (sqlite / mysql / postgres — the reference's per-DB glue
    packages) provide a DB-API connection factory plus the dialect
    points that differ: the parameter placeholder, the upsert statement,
    the identifier quote, and the table-existence probe.  Connections
    are per-thread; writes commit immediately.

    ``support_bucket_table`` is the reference's SupportBucketTable mode
    (the mysql2/postgres2 backends, abstract_sql_store.go:42-62,99-140):
    every ``/buckets/<name>`` subtree lives in its OWN table named after
    the bucket (paths stored relative to the bucket root), created on
    first write and DROPped whole on bucket deletion — O(1) bucket drops
    and per-bucket table maintenance instead of one giant keyspace.
    """

    name = "abstract_sql"
    placeholder = "?"
    upsert_sql = "INSERT OR REPLACE INTO filemeta VALUES (?,?,?,?)"
    create_table_sql = """CREATE TABLE IF NOT EXISTS filemeta (
                              directory TEXT NOT NULL,
                              name TEXT NOT NULL,
                              is_directory INTEGER NOT NULL,
                              meta BLOB,
                              PRIMARY KEY (directory, name))"""
    like_escape_suffix = r" ESCAPE '\'"
    ident_quote = '"'  # ANSI; MySQL overrides with a backtick
    # probe for a table's existence (one ?-param: the table name)
    table_exists_sql = (
        "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?"
    )
    # every table in the database (bucket discovery for count())
    list_tables_sql = "SELECT name FROM sqlite_master WHERE type='table'"
    support_bucket_table = False
    _DEFAULT_TABLE = "filemeta"
    _BUCKETS_PREFIX = "/buckets/"

    def __init__(self):
        self._local = threading.local()
        self._tables_lock = threading.Lock()
        self._known_tables: set[str] = {self._DEFAULT_TABLE}
        self._init_schema()

    # -- dialect seam ------------------------------------------------------

    def connect(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self.connect()
            self._local.conn = conn
        return conn

    def _sql(self, text: str) -> str:
        return text if self.placeholder == "?" else text.replace("?", self.placeholder)

    def _ident(self, table: str) -> str:
        """Quoted identifier with the quote char doubled inside — a
        bucket named ``a"b`` must break nothing and inject nothing
        (paths reach here from mkdir, not just the S3 gateway's
        validated names)."""
        q = self.ident_quote
        return q + table.replace(q, q + q) + q

    def _tsql(self, text: str, table: str) -> str:
        """Dialect-rewritten SQL with the ``filemeta`` table placeholder
        swapped for a quoted table identifier (bucket names may contain
        ``.`` and ``-``, which are not bareword-legal)."""
        return self._sql(text).replace(
            self._DEFAULT_TABLE, self._ident(table)
        )

    def _execute(self, sql: str, args=(), *, commit: bool = False):
        conn = self._conn()
        cur = conn.cursor()
        cur.execute(self._sql(sql), args)
        if commit:
            conn.commit()
        return cur

    def _init_schema(self) -> None:
        self._execute(
            self._tsql(self.create_table_sql, self._DEFAULT_TABLE),
            commit=True,
        )

    # -- bucket-table routing (SupportBucketTable) -------------------------

    def _split_bucket(self, path: str) -> tuple[str, str] | None:
        """('bucket', relative-path) for paths INSIDE a bucket when the
        mode is on; None routes to the default table (including /buckets
        itself, the bucket dir entries beside it, and — guard — a bucket
        literally named like the default table)."""
        if not self.support_bucket_table:
            return None
        if not path.startswith(self._BUCKETS_PREFIX):
            return None
        rest = path[len(self._BUCKETS_PREFIX):]
        bucket, sep, inner = rest.partition("/")
        if not bucket or bucket == self._DEFAULT_TABLE:
            return None
        return bucket, ("/" + inner if sep else "/")

    def _ensure_table(self, table: str, create: bool) -> bool:
        """True when the bucket table exists (creating it if asked) —
        reads of a deleted/never-created bucket return nothing instead
        of materializing empty tables."""
        with self._tables_lock:
            if table in self._known_tables:
                return True
        exists = bool(
            self._execute(self.table_exists_sql, (table,)).fetchone()
        )
        if not exists:
            if not create:
                return False
            self._execute(self._tsql(self.create_table_sql, table), commit=True)
        with self._tables_lock:
            self._known_tables.add(table)
        return True

    def _route_dir(
        self, directory: str, create: bool = False
    ) -> tuple[str | None, str]:
        """(table, directory-as-stored) for a directory whose children
        we address; table None = bucket table absent (read path)."""
        at = self._split_bucket(directory.rstrip("/") or "/")
        if at is None:
            return self._DEFAULT_TABLE, directory
        bucket, rel = at
        if not self._ensure_table(bucket, create):
            return None, rel
        return bucket, rel

    # -- FilerStore --------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        table, stored_dir = self._route_dir(entry.parent, create=True)
        self._execute(
            self._tsql(self.upsert_sql, table),
            (stored_dir, entry.name, int(entry.is_directory), entry.encode()),
            commit=True,
        )

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        parent, name = full_path.rsplit("/", 1)
        table, stored_dir = self._route_dir(parent or "/")
        if table is None:
            return None
        row = self._execute(
            self._tsql(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?",
                table,
            ),
            (stored_dir or "/", name),
        ).fetchone()
        return Entry.decode(full_path, row[0]) if row else None

    def delete_entry(self, full_path: str) -> None:
        parent, name = full_path.rsplit("/", 1)
        table, stored_dir = self._route_dir(parent or "/")
        if table is None:
            return
        self._execute(
            self._tsql(
                "DELETE FROM filemeta WHERE directory=? AND name=?", table
            ),
            (stored_dir or "/", name),
            commit=True,
        )

    def delete_folder_children(self, full_path: str) -> None:
        at = self._split_bucket(full_path.rstrip("/") or "/")
        if at is not None and at[1] == "/":
            # the bucket root: DROP the whole table (reference
            # OnBucketDeletion — O(1) bucket deletion)
            bucket = at[0]
            if self._ensure_table(bucket, create=False):
                self._execute(
                    f"DROP TABLE {self._ident(bucket)}", commit=True
                )
            with self._tables_lock:
                self._known_tables.discard(bucket)
            return
        table, stored_dir = self._route_dir(full_path)
        if table is None:
            return
        base = stored_dir.rstrip("/")
        self._execute(
            self._tsql(
                "DELETE FROM filemeta WHERE directory=? OR directory LIKE ?",
                table,
            )
            + self.like_escape_suffix,
            (base or "/", _escape_like(base) + "/%"),
            commit=True,
        )

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or "/"
        table, stored_dir = self._route_dir(base)
        if table is None:
            return []
        op = ">=" if inclusive else ">"
        sql = f"SELECT name, meta FROM filemeta WHERE directory=? AND name {op} ?"
        args: list = [stored_dir.rstrip("/") or "/", start_file_name]
        if prefix:
            sql += " AND name LIKE ?" + self.like_escape_suffix
            args.append(_escape_like(prefix) + "%")
        sql += " ORDER BY name LIMIT ?"
        args.append(limit)
        rows = self._execute(self._tsql(sql, table), args).fetchall()
        parent = "" if base == "/" else base
        return [
            Entry.decode(
                f"{parent}/{n.decode() if isinstance(n, (bytes, bytearray)) else n}",
                blob,
            )
            for n, blob in rows
        ]

    def _all_tables(self) -> list[str]:
        if not self.support_bucket_table:
            return [self._DEFAULT_TABLE]
        rows = self._execute(self.list_tables_sql).fetchall()
        return [r[0] for r in rows] or [self._DEFAULT_TABLE]

    def count(self) -> tuple[int, int]:
        files = dirs = 0
        for table in self._all_tables():
            try:
                files += self._execute(
                    self._tsql(
                        "SELECT COUNT(*) FROM filemeta WHERE is_directory=0",
                        table,
                    )
                ).fetchone()[0]
                dirs += self._execute(
                    self._tsql(
                        "SELECT COUNT(*) FROM filemeta WHERE is_directory=1",
                        table,
                    )
                ).fetchone()[0]
            except Exception as e:  # noqa: BLE001 — a shared database may hold
                # non-filemeta tables (migrations etc.), and a listed
                # table can be DROPped by a concurrent bucket delete:
                # Statistics must skip, not crash.  The failed statement
                # may have poisoned an open transaction — reset it.
                if wlog.V(2):
                    wlog.info("filerstore: statistics skipped table %s: %s", table, e)
                try:
                    self._conn().rollback()
                except Exception as re_err:  # noqa: BLE001 — autocommit dialects
                    if wlog.V(2):
                        wlog.info("filerstore: rollback after failed stat: %s", re_err)
        return files, dirs

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class SqliteStore(AbstractSqlStore):
    """stdlib-sqlite concrete store (reference weed/filer/sqlite/).

    ``support_bucket_table=True`` turns on the per-bucket-table mode
    (the mysql2/postgres2 layout on sqlite) — also how the conformance
    suite exercises the bucketed engine without network databases."""

    name = "sqlite"

    def __init__(self, path: str, support_bucket_table: bool = False):
        self._path = path
        self.support_bucket_table = support_bucket_table
        super().__init__()

    def connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._path, timeout=30, isolation_level=None)
        conn.execute("PRAGMA journal_mode=WAL")
        return conn
