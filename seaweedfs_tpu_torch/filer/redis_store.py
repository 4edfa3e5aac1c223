"""Redis filer store over a stdlib RESP client.

Counterpart of the reference's weed/filer/redis2/ layout: one string key
per entry (``f:<path>`` → encoded entry) plus one sorted-set per
directory (``d:<dir>`` → member per child name, score 0) so listings are
ordered ZRANGEBYLEX scans — O(log n + limit) regardless of directory
size, the property the reference moved from redis(1) sets to redis2
sorted sets for.

The package depends on no redis driver, so the client speaks RESP
directly over a socket (the protocol is ~5 framing rules); anything that
serves RESP — redis, valkey, keydb, or the test suite's in-process
mini server — works.

The port's copy of seaweedfs_tpu/filer/redis_store.py.
"""

from __future__ import annotations

import socket
import threading
from urllib.parse import urlparse

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import FilerStore

ENTRY_PREFIX = b"f:"
DIR_PREFIX = b"d:"


class RespError(RuntimeError):
    pass


class RespClient:
    """Minimal RESP2 client: pipelined command → one reply (stdlib-only,
    like the reference vendors go-redis rather than shelling out)."""

    def __init__(self, host: str, port: int, db: int = 0, timeout: float = 10.0):
        self.host, self.port, self.db, self.timeout = host, port, db, timeout
        self._local = threading.local()

    def _sock(self):
        f = getattr(self._local, "f", None)
        if f is None:
            s = socket.create_connection((self.host, self.port), self.timeout)
            try:
                s.settimeout(self.timeout)
                f = s.makefile("rwb")
            except OSError:
                s.close()  # makefile failed: nothing owns the fd yet
                raise
            # the file object owns the fd now; closing the socket wrapper
            # only drops its reference (real close happens on f.close())
            s.close()
            self._local.f = f
            if self.db:
                self._roundtrip(f, [b"SELECT", str(self.db).encode()])
        return f

    @staticmethod
    def _encode(args: list[bytes]) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    @classmethod
    def _read_reply(cls, f):
        line = f.readline()
        if not line:
            raise ConnectionError("redis closed the connection")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            blob = f.read(n + 2)
            return blob[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [cls._read_reply(f) for _ in range(n)]
        raise RespError(f"unexpected reply type {kind!r}")

    def _roundtrip(self, f, args: list[bytes]):
        f.write(self._encode(args))
        f.flush()
        return self._read_reply(f)

    def cmd(self, *args: bytes | str | int):
        raw = [
            a if isinstance(a, bytes) else str(a).encode() for a in args
        ]
        try:
            return self._roundtrip(self._sock(), raw)
        except (OSError, ConnectionError):
            # one reconnect attempt: redis restarts drop idle connections
            self._local.f = None
            return self._roundtrip(self._sock(), raw)

    def close(self):
        f = getattr(self._local, "f", None)
        if f is not None:
            try:
                f.close()
            finally:
                self._local.f = None


class RedisStore(FilerStore):
    name = "redis"

    def __init__(self, dsn_or_client):
        if isinstance(dsn_or_client, str):
            u = urlparse(dsn_or_client)
            if not u.hostname:
                raise ValueError(f"bad redis DSN {dsn_or_client!r}")
            db = int((u.path or "/0").lstrip("/") or 0)
            self.client = RespClient(u.hostname, u.port or 6379, db)
        else:
            self.client = dsn_or_client  # anything with .cmd(*args)

    # -- keys --------------------------------------------------------------

    @staticmethod
    def _ekey(full_path: str) -> bytes:
        return ENTRY_PREFIX + full_path.encode()

    @staticmethod
    def _dkey(dir_path: str) -> bytes:
        return DIR_PREFIX + (dir_path.rstrip("/") or "/").encode()

    # -- FilerStore --------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        self.client.cmd(b"SET", self._ekey(entry.full_path), entry.encode())
        self.client.cmd(
            b"ZADD", self._dkey(entry.parent), b"0", entry.name.encode()
        )

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, full_path: str) -> Entry | None:
        if full_path == "/":
            return Entry("/", is_directory=True)
        blob = self.client.cmd(b"GET", self._ekey(full_path))
        return Entry.decode(full_path, blob) if blob is not None else None

    def delete_entry(self, full_path: str) -> None:
        self.client.cmd(b"DEL", self._ekey(full_path))
        parent, name = full_path.rsplit("/", 1)
        self.client.cmd(b"ZREM", self._dkey(parent or "/"), name.encode())

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        for name in self._child_names(base):
            child = ("" if base == "/" else base) + "/" + name
            entry = self.find_entry(child)
            if entry is not None and entry.is_directory:
                self.delete_folder_children(child)
            self.client.cmd(b"DEL", self._ekey(child))
        self.client.cmd(b"DEL", self._dkey(base))

    def _child_names(self, dir_path: str) -> list[str]:
        reply = self.client.cmd(
            b"ZRANGEBYLEX", self._dkey(dir_path), b"-", b"+"
        )
        return [m.decode() for m in (reply or [])]

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or "/"
        # scan floor: the later of the pagination cursor and the prefix
        # range start (members are name-sorted, so a prefix is a lex range)
        lo = b"-"
        if start_file_name:
            lo = (b"[" if inclusive else b"(") + start_file_name.encode()
        if prefix and (not start_file_name or prefix > start_file_name):
            lo = b"[" + prefix.encode()
        out: list[Entry] = []
        while len(out) < limit:
            batch = self.client.cmd(
                b"ZRANGEBYLEX", self._dkey(base), lo, b"+",
                b"LIMIT", b"0", str(min(limit, 4096)).encode(),
            ) or []
            if not batch:
                break
            for member in batch:
                name = member.decode()
                if prefix and not name.startswith(prefix):
                    return out  # sorted scan has left the prefix range
                child = ("" if base == "/" else base) + "/" + name
                entry = self.find_entry(child)
                if entry is not None:
                    out.append(entry)
                    if len(out) >= limit:
                        return out
            lo = b"(" + batch[-1]
        return out

    def count(self) -> tuple[int, int]:
        """Full keyspace walk — Statistics is a rare admin call, and the
        reference's redis stores cannot count cheaply either."""
        keys = self.client.cmd(b"KEYS", ENTRY_PREFIX + b"*") or []
        files = dirs = 0
        for k in keys:
            blob = self.client.cmd(b"GET", k)
            if blob is None:
                continue
            path = k[len(ENTRY_PREFIX) :].decode()
            if Entry.decode(path, blob).is_directory:
                dirs += 1
            else:
                files += 1
        return files, dirs

    def close(self) -> None:
        close = getattr(self.client, "close", None)
        if close:
            close()
