"""Filer tier for sealed MQ segments.

Counterpart of the reference's broker-side parquet offload: sealed
partition logs are written INTO the filer so broker disks stay bounded
and topic history survives the loss of every broker
(the reference's weed/mq/logstore/log_to_parquet.go:30 takes a
filer_pb.FilerClient for exactly this).  Here the broker talks to the
filer's HTTP API — uploads auto-chunk through the normal write path, so
archives live on volume servers like any other file — under
``/topics/<namespace>/<topic>/<partition>/<base>.npz``.

The port's copy of seaweedfs_tpu/mq/tier.py.
"""

from __future__ import annotations

import http.client
import json
import os
import tempfile


class TierError(OSError):
    """Any tier transport failure (wraps HTTPException too — callers
    guard with ``except OSError`` and must not be crashed by a
    BadStatusLine that is technically not an OSError)."""


class FilerSegmentTier:
    """Minimal put/get/list/delete against a filer HTTP address."""

    def __init__(self, filer_http: str, root: str = "/topics", timeout: float = 30.0):
        self.filer_http = filer_http
        self.root = root.rstrip("/")
        self.timeout = timeout

    def _conn(self) -> http.client.HTTPConnection:
        host, port = self.filer_http.rsplit(":", 1)
        # tier transfers stream file objects as request bodies and
        # responses to disk; the shared pool's buffered request/response
        # shape would materialize archives
        # weedlint: disable=W008 — streamed archive bodies cannot ride the buffered pool
        return http.client.HTTPConnection(host, int(port), timeout=self.timeout)

    def _path(self, rel: str) -> str:
        return f"{self.root}/{rel.lstrip('/')}"

    def put(self, rel: str, local_path: str) -> None:
        size = os.path.getsize(local_path)
        conn = self._conn()
        try:
            # file-object body + explicit Content-Length streams the
            # archive without materializing it in broker memory
            with open(local_path, "rb") as fh:
                conn.request(
                    "POST",
                    self._path(rel),
                    body=fh,
                    headers={"Content-Length": str(size)},
                )
                resp = conn.getresponse()
                resp.read()
            if resp.status >= 300:
                raise TierError(f"tier put {rel}: HTTP {resp.status}")
        except http.client.HTTPException as e:
            raise TierError(f"tier put {rel}: {e}") from e
        finally:
            conn.close()

    def get(self, rel: str, local_path: str) -> None:
        """Download to ``local_path`` (unique tmp + rename: concurrent
        read-throughs of the same archive must not interleave writes —
        whichever replace lands last, both files are complete)."""
        conn = self._conn()
        try:
            conn.request("GET", self._path(rel))
            resp = conn.getresponse()
            data = resp.read()
            if resp.status == 404:
                raise FileNotFoundError(self._path(rel))
            if resp.status >= 300:
                raise TierError(f"tier get {rel}: HTTP {resp.status}")
        except http.client.HTTPException as e:
            raise TierError(f"tier get {rel}: {e}") from e
        finally:
            conn.close()
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(local_path) + ".",
            suffix=".tiertmp",
            dir=os.path.dirname(local_path) or ".",
        )
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
            os.replace(tmp, local_path)
        except BaseException:
            try:
                os.remove(tmp)
            except FileNotFoundError:
                pass
            raise

    def list(self, rel_dir: str) -> dict[str, int]:
        """{name: size} of the files under one tier directory."""
        out: dict[str, int] = {}
        last = ""
        while True:
            conn = self._conn()
            try:
                conn.request(
                    "GET",
                    f"{self._path(rel_dir)}/?limit=1024&lastFileName={last}",
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 404:
                    return out
                if resp.status >= 300:
                    raise TierError(
                        f"tier list {rel_dir}: HTTP {resp.status}"
                    )
            except http.client.HTTPException as e:
                raise TierError(f"tier list {rel_dir}: {e}") from e
            finally:
                conn.close()
            try:
                doc = json.loads(data)
            except json.JSONDecodeError as e:
                raise TierError(f"tier list {rel_dir}: bad JSON: {e}") from e
            for e in doc.get("Entries") or []:
                if not e.get("IsDirectory"):
                    name = e["FullPath"].rsplit("/", 1)[-1]
                    out[name] = int(e.get("FileSize", 0))
            if not doc.get("ShouldDisplayLoadMore"):
                return out
            last = doc.get("LastFileName", "")
            if not last:
                return out

    def delete(self, rel: str) -> None:
        conn = self._conn()
        try:
            conn.request("DELETE", self._path(rel))
            resp = conn.getresponse()
            resp.read()
        except http.client.HTTPException as e:
            raise TierError(f"tier delete {rel}: {e}") from e
        finally:
            conn.close()
