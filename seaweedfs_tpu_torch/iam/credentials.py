"""Credential stores: where IAM users and their access keys live.

Counterpart of the reference's weed/credential/ (credential_store.go
interface; memory/, filer_etc/ backends): users carry named access-key
pairs plus coarse action grants; the filer_etc store persists the whole
identity file as JSON at /etc/iam/identities.json inside the filer — the
same single-document model the reference uses — so every gateway
replica sees one source of truth.

The port's copy of seaweedfs_tpu/iam/credentials.py: ``_encode`` writes the
JAX package's bytes, so either package reads the other's document.  The
filer_etc store reaches its filer through filer/duck.py, and
``PostgresCredentialStore`` gates on ``psycopg2`` and parses its DSN with
filer/sql_stores.py's ``_parse_dsn``, as the JAX store does.
"""

from __future__ import annotations

import json
import secrets
import string
import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.s3.auth import Identity

IDENTITY_PATH = "/etc/iam/identities.json"


@dataclass
class User:
    name: str
    actions: list[str] = field(default_factory=lambda: ["Read", "Write"])
    keys: list[tuple[str, str]] = field(default_factory=list)  # (access, secret)


def _new_access_key() -> tuple[str, str]:
    alphabet = string.ascii_uppercase + string.digits
    ak = "AKID" + "".join(secrets.choice(alphabet) for _ in range(16))
    sk = secrets.token_urlsafe(30)
    return ak, sk


class CredentialStore(ABC):
    name = "abstract"

    def __init__(self):
        # every mutation is load-modify-save; concurrent IAM requests
        # must serialize the whole cycle or they overwrite each other
        self._op_lock = threading.Lock()

    @abstractmethod
    def load(self) -> dict[str, User]: ...

    @abstractmethod
    def save(self, users: dict[str, User]) -> None: ...

    # ---- shared operations ----------------------------------------------
    def create_user(self, name: str, actions: list[str] | None = None) -> User:
        with self._op_lock:
            users = self.load()
            if name in users:
                raise ValueError(f"user {name} exists")
            users[name] = User(name=name, actions=actions or ["Read", "Write"])
            self.save(users)
            return users[name]

    def delete_user(self, name: str) -> None:
        with self._op_lock:
            users = self.load()
            users.pop(name, None)
            self.save(users)

    def create_access_key(self, name: str) -> tuple[str, str]:
        with self._op_lock:
            users = self.load()
            user = users.get(name)
            if user is None:
                raise KeyError(name)
            ak, sk = _new_access_key()
            user.keys.append((ak, sk))
            self.save(users)
            return ak, sk

    def put_access_key(self, name: str, access_key: str, secret: str) -> None:
        """Install a SPECIFIC key pair (s3.configure parity: the operator
        supplies -access_key/-secret_key); replaces an existing pair with
        the same access key.  A key another user already holds is refused
        — the flattened ak->identity map would resolve nondeterministically
        and break the other user's signatures."""
        with self._op_lock:
            users = self.load()
            user = users.get(name)
            if user is None:
                raise KeyError(name)
            for other in users.values():
                if other.name != name and any(
                    a == access_key for a, _ in other.keys
                ):
                    raise ValueError(
                        f"access key {access_key} already belongs to "
                        f"user {other.name}"
                    )
            user.keys = [(a, s) for a, s in user.keys if a != access_key]
            user.keys.append((access_key, secret))
            self.save(users)

    def set_actions(self, name: str, actions: list[str]) -> None:
        with self._op_lock:
            users = self.load()
            user = users.get(name)
            if user is None:
                raise KeyError(name)
            user.actions = list(actions)
            self.save(users)

    def delete_access_key(self, name: str, access_key: str) -> None:
        with self._op_lock:
            users = self.load()
            user = users.get(name)
            if user is None:
                raise KeyError(name)
            user.keys = [(a, s) for a, s in user.keys if a != access_key]
            self.save(users)

    def identity_map(self) -> dict[str, Identity]:
        """The ak -> Identity view the S3 verifier consumes."""
        out: dict[str, Identity] = {}
        for user in self.load().values():
            for ak, sk in user.keys:
                out[ak] = Identity(access_key=ak, secret_key=sk, name=user.name)
        return out


def _encode(users: dict[str, User]) -> bytes:
    return json.dumps(
        {
            "identities": [
                {"name": u.name, "actions": u.actions,
                 "credentials": [{"accessKey": a, "secretKey": s} for a, s in u.keys]}
                for u in users.values()
            ]
        },
        indent=2,
    ).encode()


def _decode(blob: bytes) -> dict[str, User]:
    if not blob:
        return {}
    doc = json.loads(blob)
    out: dict[str, User] = {}
    for ident in doc.get("identities", []):
        out[ident["name"]] = User(
            name=ident["name"],
            actions=list(ident.get("actions", [])),
            keys=[
                (c["accessKey"], c["secretKey"])
                for c in ident.get("credentials", [])
            ],
        )
    return out


class MemoryCredentialStore(CredentialStore):
    name = "memory"

    def __init__(self):
        super().__init__()
        self._blob = b""
        self._lock = threading.Lock()

    def load(self) -> dict[str, User]:
        with self._lock:
            return _decode(self._blob)

    def save(self, users: dict[str, User]) -> None:
        with self._lock:
            self._blob = _encode(users)


class FilerEtcCredentialStore(CredentialStore):
    """Identities persisted inside the filer (reference credential/
    filer_etc): ``filer`` is an in-process Filer, a RemoteFiler or a
    ShardedFilerClient (find_entry/create_entry/master_client) or a
    mount.FilerClient (lookup/create/master), reached through
    filer/duck.py — every gateway sharing that filer shares one
    identity document."""

    name = "filer_etc"

    def __init__(self, filer):
        super().__init__()
        self.filer = filer
        self._lock = threading.Lock()

    def load(self) -> dict[str, User]:
        from seaweedfs_tpu_torch.filer import duck
        from seaweedfs_tpu_torch.filer import reader as chunk_reader

        entry = duck.find_entry(self.filer, IDENTITY_PATH)
        if entry is None:
            return {}
        if entry.content:
            return _decode(bytes(entry.content))
        return _decode(chunk_reader.read_entry(duck.master_of(self.filer), entry))

    def save(self, users: dict[str, User]) -> None:
        from seaweedfs_tpu_torch.filer import duck
        from seaweedfs_tpu_torch.filer.entry import Attr, Entry

        with self._lock:
            duck.put_entry(
                self.filer,
                Entry(
                    IDENTITY_PATH,
                    attr=Attr.now(mime="application/json"),
                    content=_encode(users),
                ),
            )


class PostgresCredentialStore(CredentialStore):
    """Postgres-backed credential store (reference weed/credential/
    postgres/): one row per identity in ``iam_identities`` (name + the
    identity's JSON doc); load reads all rows, save rewrites the table
    in one transaction.  Gated on psycopg2."""

    name = "postgres"

    def __init__(self, dsn: str):
        try:
            import psycopg2  # type: ignore  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "postgres credential store needs the 'psycopg2' driver "
                "(pip install psycopg2-binary)"
            ) from e
        from seaweedfs_tpu_torch.filer.sql_stores import _parse_dsn

        kw = _parse_dsn(dsn, 5432)
        kw["dbname"] = kw.pop("database")
        self._kw = kw
        super().__init__()
        with self._txn() as cur:
            cur.execute(
                "CREATE TABLE IF NOT EXISTS iam_identities ("
                "name TEXT PRIMARY KEY, doc TEXT NOT NULL)"
            )

    def _txn(self):
        """One closed-when-done connection wrapping one transaction —
        psycopg2's `with connection` only ends the transaction and
        would leak the socket per IAM op until max_connections."""
        import contextlib

        import psycopg2

        @contextlib.contextmanager
        def txn():
            conn = psycopg2.connect(**self._kw)
            try:
                with conn, conn.cursor() as cur:
                    yield cur
            finally:
                conn.close()

        return txn()

    def load(self) -> dict[str, User]:
        out: dict[str, User] = {}
        with self._txn() as cur:
            cur.execute("SELECT name, doc FROM iam_identities")
            for name, doc in cur.fetchall():
                ident = json.loads(doc)
                out[name] = User(
                    name=name,
                    actions=list(ident.get("actions", [])),
                    keys=[
                        (c["accessKey"], c["secretKey"])
                        for c in ident.get("credentials", [])
                    ],
                )
        return out

    def save(self, users: dict[str, User]) -> None:
        with self._txn() as cur:
            cur.execute("DELETE FROM iam_identities")
            for u in users.values():
                cur.execute(
                    "INSERT INTO iam_identities (name, doc) VALUES (%s, %s)",
                    (
                        u.name,
                        json.dumps(
                            {
                                "actions": u.actions,
                                "credentials": [
                                    {"accessKey": a, "secretKey": s}
                                    for a, s in u.keys
                                ],
                            }
                        ),
                    ),
                )


def make_credential_store(spec: str, filer_client_factory=None):
    """Credential-store factory (reference credential/credential_store.go
    registry): ``""`` / ``filer_etc`` → identities in the filer at
    /etc/iam (needs a filer client), ``memory`` → ephemeral,
    ``postgres://u:p@h/db`` → Postgres table (gated on psycopg2)."""
    if spec.startswith("postgres://") or spec.startswith("postgresql://"):
        return PostgresCredentialStore(spec)
    if spec == "memory":
        return MemoryCredentialStore()
    if spec in ("", "filer_etc"):
        if filer_client_factory is None:
            raise ValueError("filer_etc credential store needs a filer")
        return FilerEtcCredentialStore(filer_client_factory())
    raise ValueError(f"unknown credential store spec {spec!r}")
