"""S3 gateway circuit breaker: concurrent request/byte limits.

Counterpart of the reference's s3api circuit breaker
(weed/s3api/s3api_circuit_breaker.go + shell/command_s3_circuitbreaker.go):
global and per-bucket ceilings on in-flight read/write request counts and
in-flight bytes.  A request that would cross a ceiling is rejected with
503 SlowDown instead of queueing — protecting the gateway from
convoy collapse under burst load.

Config is JSON (stored by the shell at /etc/s3/circuit_breaker.json in
the filer, polled by the gateway, or passed statically):

    {"global": {"enabled": true, "writeCount": 64, "readBytes": 268435456},
     "buckets": {"heavy": {"writeCount": 8}}}

Limit keys: readCount, writeCount, readBytes, writeBytes; 0/absent means
unlimited.

The port's copy of seaweedfs_tpu/s3/circuit_breaker.py.
"""

from __future__ import annotations

import json
import threading

CONFIG_PATH = "/etc/s3/circuit_breaker.json"

_LIMIT_KEYS = ("readCount", "writeCount", "readBytes", "writeBytes")


class TooManyRequests(Exception):
    def __init__(self, scope: str, key: str, bucket: str = ""):
        where = f"bucket {bucket}" if scope == "bucket" else scope
        super().__init__(f"{where} {key} limit reached")
        self.scope = scope  # "global" | "bucket" (enum-style, metric-safe)
        self.bucket = bucket
        self.key = key


class _Gauge:
    """One scope's in-flight counters vs its configured ceilings."""

    def __init__(self, limits: dict):
        self.limits = {k: int(limits.get(k, 0) or 0) for k in _LIMIT_KEYS}
        self.inflight = dict.fromkeys(_LIMIT_KEYS, 0)

    def try_add(self, deltas: dict, lenient: bool = False) -> str | None:
        for k, d in deltas.items():
            limit = self.limits.get(k, 0)
            if not limit:
                continue
            if self.inflight[k] + d > limit:
                # lenient (reads): a LONE request bigger than the byte
                # ceiling still admits — the ceiling bounds concurrency,
                # it must not make existing large objects unreadable.
                # (count keys are unaffected: d=1 over limit≥1 implies
                # inflight>0 anyway.)
                if not lenient or self.inflight[k] > 0:
                    return k
        for k, d in deltas.items():
            self.inflight[k] += d
        return None

    def sub(self, deltas: dict) -> None:
        for k, d in deltas.items():
            self.inflight[k] = max(0, self.inflight[k] - d)


class CircuitBreaker:
    def __init__(self, config: dict | None = None):
        self._lock = threading.Lock()
        self.enabled = False
        self._global = _Gauge({})
        self._buckets: dict[str, _Gauge] = {}
        self._bucket_limits: dict[str, dict] = {}
        if config:
            self.load(config)

    def load(self, config: dict | None) -> None:
        """Swap in new ceilings; in-flight counts carry over so a config
        reload cannot double-admit."""
        config = config or {}
        with self._lock:
            g = config.get("global", {})
            # any configured limits (global or per-bucket) enable the
            # breaker unless explicitly disabled — a bucket-only config
            # written by `s3.circuitbreaker -bucket ...` must not be inert
            default_enabled = bool(g) or bool(config.get("buckets"))
            self.enabled = bool(g.get("enabled", default_enabled))
            old = self._global
            self._global = _Gauge(g)
            self._global.inflight = old.inflight
            self._bucket_limits = dict(config.get("buckets", {}))
            for name, gauge in list(self._buckets.items()):
                limits = self._bucket_limits.get(name)
                if limits is None:
                    if not any(gauge.inflight.values()):
                        del self._buckets[name]
                    else:
                        gauge.limits = dict.fromkeys(_LIMIT_KEYS, 0)
                else:
                    gauge.limits = _Gauge(limits).limits

    def load_json(self, blob: bytes | str | None) -> None:
        if not blob:
            self.load({})
            return
        try:
            self.load(json.loads(blob))
        except (json.JSONDecodeError, TypeError, AttributeError):
            pass  # keep the last good config

    def wants_read_bytes(self, bucket: str) -> bool:
        """Whether a download's size matters for admission — callers skip
        the object-size lookup otherwise."""
        with self._lock:
            if not self.enabled:
                return False
            if self._global.limits.get("readBytes"):
                return True
            return bool((self._bucket_limits.get(bucket) or {}).get("readBytes"))

    def acquire(self, bucket: str, is_write: bool, nbytes: int):
        """Admit one request; returns a release() callable.
        Raises TooManyRequests when a ceiling would be crossed."""
        if not self.enabled:
            return lambda: None
        deltas = (
            {"writeCount": 1, "writeBytes": nbytes}
            if is_write
            else {"readCount": 1, "readBytes": nbytes}
        )
        lenient = not is_write  # an oversized upload is a policy reject
        with self._lock:
            hit = self._global.try_add(deltas, lenient)
            if hit is not None:
                raise TooManyRequests("global", hit)
            gauge = None
            if bucket and bucket in self._bucket_limits:
                gauge = self._buckets.get(bucket)
                if gauge is None:
                    gauge = _Gauge(self._bucket_limits[bucket])
                    self._buckets[bucket] = gauge
                hit = gauge.try_add(deltas, lenient)
                if hit is not None:
                    self._global.sub(deltas)
                    raise TooManyRequests("bucket", hit, bucket)

        released = threading.Event()

        def release():
            if released.is_set():
                return
            released.set()
            with self._lock:
                self._global.sub(deltas)
                if gauge is not None:
                    gauge.sub(deltas)

        return release

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "global": {
                    "limits": dict(self._global.limits),
                    "inflight": dict(self._global.inflight),
                },
                "buckets": {
                    b: {
                        "limits": dict(g.limits),
                        "inflight": dict(g.inflight),
                    }
                    for b, g in self._buckets.items()
                },
            }
