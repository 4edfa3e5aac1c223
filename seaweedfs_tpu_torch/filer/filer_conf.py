"""Per-path filer configuration (fs.configure): the port's copy of
seaweedfs_tpu/filer/filer_conf.py.

Counterpart of the reference's filer conf
(weed/filer/filer_conf.go and
weed/shell/command_fs_configure.go:24-41): location-prefix rules that
pick the collection / replication / TTL / disk type / growth count for
uploads under a path, or freeze a subtree read-only.  The document lives
IN the filer at /etc/seaweedfs/filer.conf (same path as the reference),
so it survives restarts, replicates through the meta event log, and is
editable from the shell.

Longest-prefix match wins, like the reference's trie lookup.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field

from seaweedfs_tpu_torch.util import wlog

CONF_DIR = "/etc/seaweedfs"
CONF_PATH = CONF_DIR + "/filer.conf"


@dataclass
class PathConf:
    location_prefix: str
    collection: str = ""
    replication: str = ""
    ttl_seconds: int = 0
    disk_type: str = ""
    read_only: bool = False
    volume_growth_count: int = 0
    max_file_name_length: int = 0

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v}


@dataclass
class FilerConf:
    rules: list[PathConf] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, blob: bytes | None) -> "FilerConf":
        if not blob:
            return cls()
        try:
            doc = json.loads(blob)
            rules = [
                PathConf(
                    location_prefix=str(r.get("location_prefix", "")),
                    collection=str(r.get("collection", "")),
                    replication=str(r.get("replication", "")),
                    ttl_seconds=int(r.get("ttl_seconds", 0)),
                    disk_type=str(r.get("disk_type", "")),
                    read_only=bool(r.get("read_only", False)),
                    volume_growth_count=int(r.get("volume_growth_count", 0)),
                    max_file_name_length=int(
                        r.get("max_file_name_length", 0)
                    ),
                )
                for r in doc.get("locations", [])
                if r.get("location_prefix")
            ]
            return cls(rules)
        except (ValueError, TypeError, AttributeError):
            # an unreadable conf must not take the filer down — behave as
            # unconfigured and let the operator re-apply
            return cls()

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "locations": sorted(
                    (r.to_dict() for r in self.rules),
                    key=lambda d: d["location_prefix"],
                )
            },
            indent=2,
        ).encode()

    def match(self, path: str) -> PathConf | None:
        """The longest-prefix rule covering ``path`` (None if none)."""
        best: PathConf | None = None
        for r in self.rules:
            if path.startswith(r.location_prefix):
                if best is None or len(r.location_prefix) > len(
                    best.location_prefix
                ):
                    best = r
        return best

    def upsert(self, rule: PathConf) -> None:
        self.rules = [
            r for r in self.rules
            if r.location_prefix != rule.location_prefix
        ]
        self.rules.append(rule)

    def delete(self, location_prefix: str) -> bool:
        before = len(self.rules)
        self.rules = [
            r for r in self.rules if r.location_prefix != location_prefix
        ]
        return len(self.rules) != before


class ConfCache:
    """TTL-cached view of the conf entry for the upload hot path: one
    store lookup per second, not per request."""

    def __init__(self, filer, ttl: float = 1.0):
        self.filer = filer
        self.ttl = ttl
        self._conf = FilerConf()
        self._at = 0.0

    def get(self) -> FilerConf:
        now = time.monotonic()
        if now - self._at >= self.ttl:
            try:
                entry = self.filer.find_entry(CONF_PATH)
            except Exception as e:  # noqa: BLE001 — store blip: keep last view
                # a transient store error must NOT blank the conf: dropping
                # read_only/replication rules for a TTL window silently
                # changes write behavior.  Keep the last view, back off.
                if wlog.V(1):
                    wlog.info("filer_conf: refresh failed, keeping last view: %s", e)
                self._at = now
                return self._conf
            # entry=None here means the conf entry genuinely doesn't exist:
            # an empty conf is then the correct view
            blob = entry.content if entry is not None else None
            self._conf = FilerConf.from_bytes(blob)
            self._at = now
        return self._conf

    def invalidate(self) -> None:
        self._at = 0.0
