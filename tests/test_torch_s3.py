"""The port's S3 gateway on the CPU, held against the JAX package's.

One cluster: a port master and two port volume servers (``device="cpu"``).
Two filer servers on LSM stores ride it, the port's and the JAX package's,
and each package's gateway rides its own filer over ``RemoteFiler`` (the
``cli s3 -filer`` shape), with SigV4 required and one ``LocalKms`` key file.

- A scripted request list, signed with fixed dates by ``client_sign``, runs
  against both gateways: statuses, ETags, lengths, ranges and XML bodies
  are equal once timestamps, version ids and upload ids are normalised.
  It covers buckets, plain, multi-chunk and aws-chunked PUTs, Range GETs,
  V1/V2/versions listings, CopyObject, multipart with ``upload_part_copy``,
  versioning, tagging, ACLs, policies, CORS, object lock, lifecycle, SSE-S3,
  SSE-C, presigned and SigV2 requests and refusals.
- Store interop: the filer stores are swapped (the port's filer server on
  the JAX store and the other way round) and each gateway serves every
  object, version and pending multipart upload the other wrote.
- SelectObjectContent and the browser form POST answer alike;
  ``credential_store`` and ``inval_bus`` are taken; a TLS pair that does
  not load fails the start.

The JAX side runs with ``SEAWEEDFS_TPU_NATIVE_PX=0`` (its Python path).
Every server binds port 0, every wait polls under a deadline and every
HTTP call has a timeout."""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import os
import re
import shutil
import tempfile
import time
import urllib.parse
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3
from seaweedfs_tpu.s3.auth import Identity as JaxIdentity
from seaweedfs_tpu.security.kms import LocalKms as JaxLocalKms
from seaweedfs_tpu.server import filer_server as jax_fs
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.s3 import S3ApiServer
from seaweedfs_tpu_torch.s3 import client_sign
from seaweedfs_tpu_torch.s3.auth import Identity
from seaweedfs_tpu_torch.security.kms import LocalKms
from seaweedfs_tpu_torch.server import filer_server, master_server, volume_server
from seaweedfs_tpu_torch.wdclient import MasterClient

WAIT_S = 60.0
HTTP_TIMEOUT = 30
CHUNK = 64 * 1024
AK, SK = "AKIDPORT", "secret-port-key"
FIXED_NOW = 1_767_225_600.0  # 2026-01-01T00:00:00Z: every header signature's date
NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _http(addr: str, method: str, path: str, body: bytes = b"", headers=None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()


def _env():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    return mp


class _Side:
    """One package's filer server and gateway over the shared cluster."""

    def __init__(self, pkg: str, master_addr: str, db: str, key_file: str):
        self.pkg, self.master_addr, self.db, self.key_file = pkg, master_addr, db, key_file
        self.filer = self.gw = None

    def start(self, db: str | None = None) -> None:
        fs_mod = filer_server if self.pkg == "port" else jax_fs
        self.filer = fs_mod.FilerServer(self.master_addr, port=0, grpc_port=0,
                                        store_path=db or self.db, chunk_size=CHUNK)
        self.filer.start()
        if self.pkg == "port":
            remote = RemoteFiler(self.filer.grpc_address, MasterClient(self.master_addr))
            self.gw = S3ApiServer(self.master_addr, port=0, filer=remote, chunk_size=CHUNK,
                                  identities={AK: Identity(AK, SK, "admin")},
                                  kms=LocalKms(self.key_file), chunk_cache_mb=8,
                                  lifecycle_sweep_interval=0, credential_refresh=0)
        else:
            remote = JaxRemoteFiler(self.filer.grpc_address, JaxMasterClient(self.master_addr))
            self.gw = JaxS3(self.master_addr, port=0, filer=remote, chunk_size=CHUNK,
                            identities={AK: JaxIdentity(AK, SK, "admin")},
                            kms=JaxLocalKms(self.key_file), chunk_cache_mb=8,
                            lifecycle_sweep_interval=0, credential_refresh=0)
        self.gw.start()

    def stop(self) -> None:
        if self.gw is not None:
            self.gw.stop()
            self.gw = None
        if self.filer is not None:
            self.filer.stop()
            self.filer = None


@pytest.fixture(scope="module")
def cluster():
    mp = _env()
    root = tempfile.mkdtemp(prefix="torch-s3-")
    master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.start()
    servers, sides = [], {}
    try:
        for i in range(2):
            d = os.path.join(root, f"v{i}")
            os.makedirs(d)
            vs = volume_server.VolumeServer([d], master.grpc_address, port=0, grpc_port=0,
                                            rack=f"rack{i}", heartbeat_interval=0.2,
                                            device="cpu")
            vs.start()
            servers.append(vs)
        _wait(lambda: len(master.topology.nodes) == 2, "both heartbeats")
        key_file = os.path.join(root, "kms.json")
        LocalKms(key_file).create_key("default")  # one master key, minted before both load it
        for pkg in ("port", "jax"):
            sides[pkg] = _Side(pkg, master.grpc_address, os.path.join(root, f"{pkg}-db"),
                               key_file)
            sides[pkg].start()
        yield dict(master=master, sides=sides, root=root)
    finally:
        for side in sides.values():
            side.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


# ---- the scripted session ---------------------------------------------------

_rng = np.random.default_rng(1301)
SMALL = _rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
MULTI = _rng.integers(0, 256, 5 * CHUNK + 1234, dtype=np.uint8).tobytes()
STREAMED = _rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
PART1 = _rng.integers(0, 256, 2 * CHUNK + 17, dtype=np.uint8).tobytes()
PART2 = _rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
SSE_BODY = _rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
CUSTOMER_KEY = bytes(range(32))
SSE_C = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key": base64.b64encode(CUSTOMER_KEY).decode(),
    "x-amz-server-side-encryption-customer-key-md5":
        base64.b64encode(hashlib.md5(CUSTOMER_KEY).digest()).decode(),
}
POLICY = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
                   "Resource": "arn:aws:s3:::pub/*"}],
}).encode()
CORS = (b"<CORSConfiguration><CORSRule><AllowedOrigin>https://app.example</AllowedOrigin>"
        b"<AllowedMethod>GET</AllowedMethod><AllowedMethod>PUT</AllowedMethod>"
        b"<AllowedHeader>*</AllowedHeader><ExposeHeader>ETag</ExposeHeader>"
        b"<MaxAgeSeconds>600</MaxAgeSeconds></CORSRule></CORSConfiguration>")
TAGGING = (b"<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value></Tag>"
           b"<Tag><Key>tier</Key><Value>hot</Value></Tag></TagSet></Tagging>")
LIFECYCLE = (b"<LifecycleConfiguration><Rule><ID>expire-logs</ID><Filter><Prefix>logs/"
             b"</Prefix></Filter><Status>Enabled</Status><Expiration><Days>30</Days>"
             b"</Expiration></Rule></LifecycleConfiguration>")
LEGAL_HOLD = b"<LegalHold><Status>ON</Status></LegalHold>"
LEGAL_HOLD_OFF = b"<LegalHold><Status>OFF</Status></LegalHold>"


def _versioning(state: str) -> bytes:
    return f"<VersioningConfiguration><Status>{state}</Status></VersioningConfiguration>".encode()


def _complete(etags: list[str]) -> bytes:
    parts = "".join(f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
                    for i, e in enumerate(etags))
    return f"<CompleteMultipartUpload>{parts}</CompleteMultipartUpload>".encode()


# (name, method, path, query, body, extra headers, mode).  ``{...}`` in path,
# query or body fill from values captured earlier in the same session (upload
# ids, version ids, part ETags).  mode: "v4" header-signed at FIXED_NOW,
# "stream" aws-chunked, "anon" unsigned, "presign", "v2", "badsig".
def _script() -> list[tuple]:
    return [
        ("create", "PUT", "/sb", "", b"", {}, "v4"),
        ("create-dup", "PUT", "/sb", "", b"", {}, "v4"),
        ("list-buckets", "GET", "/", "", b"", {}, "v4"),
        ("head-bucket", "HEAD", "/sb", "", b"", {}, "v4"),
        ("head-missing-bucket", "HEAD", "/nosuch", "", b"", {}, "v4"),
        ("put-small", "PUT", "/sb/a.txt", "", SMALL,
         {"Content-Type": "text/plain", "x-amz-meta-color": "blue"}, "v4"),
        ("put-multi", "PUT", "/sb/dir/b.bin", "", MULTI, {}, "v4"),
        ("put-streamed", "PUT", "/sb/dir/c.bin", "", STREAMED, {}, "stream"),
        ("put-dirkey", "PUT", "/sb/emptydir/", "", b"", {}, "v4"),
        ("get-small", "GET", "/sb/a.txt", "", b"", {}, "v4"),
        ("head-multi", "HEAD", "/sb/dir/b.bin", "", b"", {}, "v4"),
        ("get-multi", "GET", "/sb/dir/b.bin", "", b"", {}, "v4"),
        ("get-streamed", "GET", "/sb/dir/c.bin", "", b"", {}, "v4"),
        ("range-mid", "GET", "/sb/dir/b.bin", "", b"", {"Range": "bytes=65000-131100"}, "v4"),
        ("range-suffix", "GET", "/sb/dir/b.bin", "", b"", {"Range": "bytes=-500"}, "v4"),
        ("range-open", "GET", "/sb/a.txt", "", b"", {"Range": "bytes=2990-"}, "v4"),
        ("range-416", "GET", "/sb/a.txt", "", b"", {"Range": "bytes=5000-6000"}, "v4"),
        ("get-missing", "GET", "/sb/nope", "", b"", {}, "v4"),
        ("copy", "PUT", "/sb/copy.bin", "", b"", {"x-amz-copy-source": "/sb/dir/b.bin"}, "v4"),
        ("get-copy", "GET", "/sb/copy.bin", "", b"", {}, "v4"),
        ("list-v1", "GET", "/sb", "", b"", {}, "v4"),
        ("list-v2-delim", "GET", "/sb", "delimiter=%2F&list-type=2", b"", {}, "v4"),
        ("list-v2-prefix", "GET", "/sb", "list-type=2&prefix=dir%2F", b"", {}, "v4"),
        ("list-v2-page1", "GET", "/sb", "list-type=2&max-keys=2", b"", {}, "v4"),
        ("list-v2-page2", "GET", "/sb", "continuation-token={token}&list-type=2&max-keys=2",
         b"", {}, "v4"),
        ("list-v1-marker", "GET", "/sb", "marker=copy.bin", b"", {}, "v4"),
        ("mpu-create", "POST", "/sb/big.bin", "uploads=", b"", {"Content-Type": "video/mp4"},
         "v4"),
        ("mpu-part1", "PUT", "/sb/big.bin", "partNumber=1&uploadId={upload}", PART1, {}, "v4"),
        ("mpu-part2", "PUT", "/sb/big.bin", "partNumber=2&uploadId={upload}", PART2, {},
         "stream"),
        ("mpu-part3-copy", "PUT", "/sb/big.bin", "partNumber=3&uploadId={upload}", b"",
         {"x-amz-copy-source": "/sb/dir/b.bin", "x-amz-copy-source-range": "bytes=0-70000"},
         "v4"),
        ("mpu-list-parts", "GET", "/sb/big.bin", "uploadId={upload}", b"", {}, "v4"),
        ("mpu-list-uploads", "GET", "/sb", "uploads=", b"", {}, "v4"),
        ("mpu-complete", "POST", "/sb/big.bin", "uploadId={upload}", "{complete}", {}, "v4"),
        ("mpu-get", "GET", "/sb/big.bin", "", b"", {}, "v4"),
        ("mpu-range", "GET", "/sb/big.bin", "", b"", {"Range": "bytes=131000-200000"}, "v4"),
        ("mpu-pending", "POST", "/sb/pending.bin", "uploads=", b"", {}, "v4"),
        ("mpu-pending-part", "PUT", "/sb/pending.bin", "partNumber=1&uploadId={upload}",
         PART2, {}, "v4"),
        ("tag-put", "PUT", "/sb/a.txt", "tagging=", TAGGING, {}, "v4"),
        ("tag-get", "GET", "/sb/a.txt", "tagging=", b"", {}, "v4"),
        ("tag-delete", "DELETE", "/sb/a.txt", "tagging=", b"", {}, "v4"),
        ("tag-get-empty", "GET", "/sb/a.txt", "tagging=", b"", {}, "v4"),
        ("acl-put", "PUT", "/sb/a.txt", "acl=", b"", {"x-amz-acl": "public-read"}, "v4"),
        ("acl-get", "GET", "/sb/a.txt", "acl=", b"", {}, "v4"),
        ("bucket-acl-get", "GET", "/sb", "acl=", b"", {}, "v4"),
        ("anon-public-object", "GET", "/sb/a.txt", "", b"", {}, "anon"),
        ("anon-private-object", "GET", "/sb/dir/b.bin", "", b"", {}, "anon"),
        ("lifecycle-put", "PUT", "/sb", "lifecycle=", LIFECYCLE, {}, "v4"),
        ("lifecycle-get", "GET", "/sb", "lifecycle=", b"", {}, "v4"),
        ("cors-put", "PUT", "/sb", "cors=", CORS, {}, "v4"),
        ("cors-get", "GET", "/sb", "cors=", b"", {}, "v4"),
        ("cors-preflight", "OPTIONS", "/sb/a.txt", "", b"",
         {"Origin": "https://app.example", "Access-Control-Request-Method": "PUT"}, "anon"),
        ("cors-preflight-denied", "OPTIONS", "/sb/a.txt", "", b"",
         {"Origin": "https://evil.example", "Access-Control-Request-Method": "PUT"}, "anon"),
        ("cors-get-origin", "GET", "/sb/a.txt", "", b"", {"Origin": "https://app.example"},
         "v4"),
        ("pub-create", "PUT", "/pub", "", b"", {}, "v4"),
        ("pub-put", "PUT", "/pub/page.html", "", SMALL, {"Content-Type": "text/html"}, "v4"),
        ("pub-anon-before", "GET", "/pub/page.html", "", b"", {}, "anon"),
        ("policy-put", "PUT", "/pub", "policy=", POLICY, {}, "v4"),
        ("policy-get", "GET", "/pub", "policy=", b"", {}, "v4"),
        ("pub-anon-after", "GET", "/pub/page.html", "", b"", {}, "anon"),
        ("pub-anon-put", "PUT", "/pub/evil.html", "", b"x", {}, "anon"),
        ("ver-enable", "PUT", "/sb", "versioning=", _versioning("Enabled"), {}, "v4"),
        ("ver-get", "GET", "/sb", "versioning=", b"", {}, "v4"),
        ("ver-put1", "PUT", "/sb/v.txt", "", b"version one", {}, "v4"),
        ("ver-put2", "PUT", "/sb/v.txt", "", b"version two!", {}, "v4"),
        ("ver-put3", "PUT", "/sb/v.txt", "", b"version three", {}, "v4"),
        ("ver-list", "GET", "/sb", "prefix=v.txt&versions=", b"", {}, "v4"),
        ("ver-get-1", "GET", "/sb/v.txt", "versionId={v1}", b"", {}, "v4"),
        ("ver-get-2", "GET", "/sb/v.txt", "versionId={v2}", b"", {}, "v4"),
        ("ver-get-3", "GET", "/sb/v.txt", "versionId={v3}", b"", {}, "v4"),
        ("ver-get-latest", "GET", "/sb/v.txt", "", b"", {}, "v4"),
        ("ver-delete", "DELETE", "/sb/v.txt", "", b"", {}, "v4"),
        ("ver-get-deleted", "GET", "/sb/v.txt", "", b"", {}, "v4"),
        ("ver-list-after", "GET", "/sb", "prefix=v.txt&versions=", b"", {}, "v4"),
        ("ver-get-old", "GET", "/sb/v.txt", "versionId={v2}", b"", {}, "v4"),
        ("ver-delete-v1", "DELETE", "/sb/v.txt", "versionId={v1}", b"", {}, "v4"),
        ("legal-hold-put", "PUT", "/sb/v.txt", "legal-hold=&versionId={v3}", LEGAL_HOLD, {},
         "v4"),
        ("legal-hold-get", "GET", "/sb/v.txt", "legal-hold=&versionId={v3}", b"", {}, "v4"),
        ("legal-hold-delete", "DELETE", "/sb/v.txt", "versionId={v3}", b"", {}, "v4"),
        ("legal-hold-off", "PUT", "/sb/v.txt", "legal-hold=&versionId={v3}", LEGAL_HOLD_OFF,
         {}, "v4"),
        ("ver-suspend", "PUT", "/sb", "versioning=", _versioning("Suspended"), {}, "v4"),
        ("sse-s3-put", "PUT", "/sb/enc-s3.bin", "", SSE_BODY,
         {"x-amz-server-side-encryption": "AES256"}, "v4"),
        ("sse-s3-get", "GET", "/sb/enc-s3.bin", "", b"", {}, "v4"),
        ("sse-s3-range", "GET", "/sb/enc-s3.bin", "", b"", {"Range": "bytes=1000-1999"}, "v4"),
        ("sse-c-put", "PUT", "/sb/enc-c.bin", "", SSE_BODY, SSE_C, "v4"),
        ("sse-c-head", "HEAD", "/sb/enc-c.bin", "", b"", SSE_C, "v4"),
        ("sse-c-get", "GET", "/sb/enc-c.bin", "", b"", SSE_C, "v4"),
        ("sse-c-get-nokey", "GET", "/sb/enc-c.bin", "", b"", {}, "v4"),
        ("presigned-get", "GET", "/sb/dir/b.bin", "", b"", {}, "presign"),
        ("v2-get", "GET", "/sb/a.txt", "", b"", {}, "v2"),
        ("bad-signature", "GET", "/sb/dir/b.bin", "", b"", {}, "badsig"),
        ("multi-delete", "POST", "/sb", "delete=",
         b"<Delete><Object><Key>copy.bin</Key></Object><Object><Key>gone.txt</Key></Object>"
         b"</Delete>", {}, "v4"),
        ("list-after-delete", "GET", "/sb", "list-type=2", b"", {}, "v4"),
        ("delete-small", "DELETE", "/sb/a.txt", "", b"", {}, "v4"),
        ("bucket-not-empty", "DELETE", "/sb", "", b"", {}, "v4"),
        ("reserved-key", "PUT", "/sb/.uploads/x", "", b"x", {}, "v4"),
        ("unsupported-post", "POST", "/sb/a.txt", "", b"", {}, "v4"),
    ]


def _fill(template, ctx: dict):
    if isinstance(template, bytes):
        return template
    if template == "{complete}":
        return _complete(ctx["part_etags"])
    return re.sub(r"\{(\w+)\}", lambda m: urllib.parse.quote(ctx[m.group(1)], safe=""),
                  template)


def _send(addr: str, method: str, path: str, query: str, body: bytes, extra: dict,
          mode: str):
    target = path + (f"?{query}" if query else "")
    headers = dict(extra)
    if mode in ("v4", "badsig"):
        signed = client_sign.sign_headers(method, path, query, addr, body, AK, SK,
                                          now=FIXED_NOW, extra_headers=extra)
        if mode == "badsig":
            signed["Authorization"] = signed["Authorization"][:-4] + "0000"
        headers = {**extra, **signed}
    elif mode == "stream":
        signed, body = client_sign.sign_streaming(method, path, query, addr, body, AK, SK,
                                                  chunk_size=16 * 1024, now=FIXED_NOW)
        headers = {**extra, **signed}
    elif mode == "presign":
        qs = client_sign.presign_url(method, path, addr, AK, SK, expires=600)
        target = f"{path}?{qs}"
    elif mode == "v2":
        date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(FIXED_NOW))
        sts = f"{method}\n\n\n{date}\n{path}"
        sig = base64.b64encode(hmac.new(SK.encode(), sts.encode(), hashlib.sha1).digest())
        headers = {**extra, "Date": date, "Authorization": f"AWS {AK}:{sig.decode()}"}
    return _http(addr, method, target, body, headers)


_TIME_TAGS = {"LastModified", "CreationDate", "Initiated"}
_ID_TAGS = {"VersionId", "UploadId", "NextVersionIdMarker", "NextUploadIdMarker",
            "VersionIdMarker", "UploadIdMarker"}
_KEEP_HEADERS = ("etag", "content-length", "content-range", "content-type",
                 "x-amz-delete-marker", "x-amz-server-side-encryption",
                 "x-amz-server-side-encryption-customer-algorithm",
                 "x-amz-server-side-encryption-customer-key-md5",
                 "access-control-allow-origin", "access-control-allow-methods",
                 "access-control-expose-headers", "access-control-max-age",
                 "x-amz-meta-color", "retry-after")


class _Ids:
    """Maps each run's version and upload ids to their order of first
    appearance, which both gateways share, and the ETags of SSE objects
    (an MD5 of ciphertext under a random nonce) to their order of PUT."""

    def __init__(self):
        self.seen: dict[str, str] = {}
        self.etags: dict[str, str] = {}

    def __call__(self, value: str) -> str:
        if not value or value == "null":
            return value
        return self.seen.setdefault(value, f"id{len(self.seen)}")

    def sealed(self, etag: str) -> None:
        self.etags.setdefault(etag.strip('"'), f"sealed{len(self.etags)}")

    def etag(self, value: str) -> str:
        return self.etags.get(value.strip('"'), value)


def _norm_xml(body: bytes, ids: _Ids) -> str:
    root = ET.fromstring(body)
    for el in root.iter():
        tag = el.tag.split("}")[-1]
        if tag in _TIME_TAGS:
            el.text = "T"
        elif tag in _ID_TAGS and el.text:
            el.text = ids(el.text)
        elif tag == "ETag" and el.text:
            el.text = ids.etag(el.text)
        elif tag == "Message":
            el.text = re.sub(r"[0-9a-f]{28}", "ID", el.text or "")
    return ET.tostring(root).decode()


def _normalise(status: int, body: bytes, headers: dict, ids: _Ids) -> dict:
    out = {"status": status}
    for h in _KEEP_HEADERS:
        if h in headers:
            out[h] = headers[h]
    if "etag" in out:
        out["etag"] = ids.etag(out["etag"])
    if "x-amz-version-id" in headers:
        out["x-amz-version-id"] = ids(headers["x-amz-version-id"])
    ctype = headers.get("content-type", "")
    if body.startswith(b"<?xml") or (ctype == "application/xml" and body):
        out["xml"] = _norm_xml(body, ids)
    elif body:
        out["sha256"] = hashlib.sha256(body).hexdigest()
    return out


def _run_session(addr: str) -> tuple[dict, dict]:
    """Run the script against one gateway: (name -> normalised response,
    the captured ids and ETags)."""
    ctx: dict = {"part_etags": []}
    ids = _Ids()
    results = {}
    for name, method, path, query, body, extra, mode in _script():
        path, query, body = _fill(path, ctx), _fill(query, ctx), _fill(body, ctx)
        status, data, headers = _send(addr, method, path, query, body, extra, mode)
        if name.startswith("sse-") and name.endswith("-put"):
            ids.sealed(headers["etag"])
        results[name] = _normalise(status, data, headers, ids)
        if name in ("mpu-create", "mpu-pending"):
            ctx["upload"] = ET.fromstring(data).findtext(f"{NS}UploadId")
            ctx.setdefault("uploads", []).append(ctx["upload"])
        elif name.startswith("mpu-part") and status == 200:
            etag = headers.get("etag")
            if etag is None:
                etag = ET.fromstring(data).findtext(f"{NS}ETag")
            ctx["part_etags"].append(etag)
        elif name == "list-v2-page1":
            ctx["token"] = ET.fromstring(data).findtext(f"{NS}NextContinuationToken")
        elif name.startswith("ver-put"):
            ctx[f"v{name[-1]}"] = headers["x-amz-version-id"]
    return results, ctx


def test_scripted_session_matches_jax(cluster):
    """Every scripted request answers the same from both gateways."""
    port, port_ctx = _run_session(cluster["sides"]["port"].gw.url)
    jax, _ = _run_session(cluster["sides"]["jax"].gw.url)
    cluster["ctx"] = port_ctx
    assert port.keys() == jax.keys()
    # the JAX gateway serves a GET whose chunks the hot-chunk cache can
    # hold through its splice path, which writes its own response head
    # and drops the CORS headers (ROADMAP Queue C); the port sends them
    cors_keys = [k for k in port["cors-get-origin"] if k.startswith("access-control-")]
    assert port["cors-get-origin"]["access-control-allow-origin"] == "https://app.example"
    assert not [k for k in jax["cors-get-origin"] if k.startswith("access-control-")]
    for k in cors_keys:
        del port["cors-get-origin"][k]
    diffs = {k: (port[k], jax[k]) for k in port if port[k] != jax[k]}
    assert not diffs, json.dumps(diffs, indent=1)[:4000]
    # and the answers are the right ones, not merely equal
    assert port["create"]["status"] == 200 and port["create-dup"]["status"] == 409
    assert port["get-multi"]["sha256"] == hashlib.sha256(MULTI).hexdigest()
    assert port["get-streamed"]["sha256"] == hashlib.sha256(STREAMED).hexdigest()
    assert port["range-mid"]["status"] == 206
    assert port["range-mid"]["sha256"] == hashlib.sha256(MULTI[65000:131101]).hexdigest()
    assert port["range-416"]["status"] == 416
    assert port["mpu-get"]["sha256"] == hashlib.sha256(PART1 + PART2 + MULTI[:70001]).hexdigest()
    assert port["mpu-get"]["etag"].endswith('-3"')
    assert port["ver-get-2"]["sha256"] == hashlib.sha256(b"version two!").hexdigest()
    assert port["ver-get-deleted"]["status"] == 404
    assert port["legal-hold-delete"]["status"] == 403
    assert port["pub-anon-before"]["status"] == 403 and port["pub-anon-after"]["status"] == 200
    assert port["anon-public-object"]["status"] == 200
    assert port["anon-private-object"]["status"] == 403
    assert port["pub-anon-put"]["status"] == 403
    assert port["sse-s3-get"]["sha256"] == hashlib.sha256(SSE_BODY).hexdigest()
    assert port["sse-c-get"]["sha256"] == hashlib.sha256(SSE_BODY).hexdigest()
    assert port["sse-c-get-nokey"]["status"] == 400
    assert port["presigned-get"]["status"] == 200 and port["v2-get"]["status"] == 200
    assert port["bad-signature"]["status"] == 403
    assert port["bucket-not-empty"]["status"] == 409
    assert port["cors-preflight"]["status"] == 200
    assert port["cors-preflight"]["access-control-allow-origin"] == "https://app.example"


def _swap_stores(cluster) -> None:
    sides = cluster["sides"]
    for side in sides.values():
        side.stop()
    sides["port"].start(db=sides["jax"].db)
    sides["jax"].start(db=sides["port"].db)


def _serve_all(addr: str, ctx: dict) -> dict:
    """Every object, version and pending upload of the session's buckets."""
    out = {}
    for name, method, path, query in [
        ("list", "GET", "/sb", "list-type=2"),
        ("versions", "GET", "/sb", "versions="),
        ("uploads", "GET", "/sb", "uploads="),
        ("pending-parts", "GET", "/sb/pending.bin", "uploadId=" + ctx["uploads"][-1]),
        ("multi", "GET", "/sb/dir/b.bin", ""),
        ("streamed", "GET", "/sb/dir/c.bin", ""),
        ("big", "GET", "/sb/big.bin", ""),
        ("v2", "GET", "/sb/v.txt", "versionId=" + ctx["v2"]),
        ("v3", "GET", "/sb/v.txt", "versionId=" + ctx["v3"]),
        ("sse-s3", "GET", "/sb/enc-s3.bin", ""),
        ("sse-c", "GET", "/sb/enc-c.bin", ""),
        ("policy", "GET", "/pub", "policy="),
        ("page", "GET", "/pub/page.html", ""),
    ]:
        extra = SSE_C if name == "sse-c" else {}
        status, data, headers = _send(addr, method, path, query, b"", extra, "v4")
        out[name] = (status, headers.get("etag"), hashlib.sha256(data).hexdigest()
                     if not data.startswith(b"<?xml") else _norm_xml(data, _Ids()))
    return out


def test_store_interop(cluster):
    """Each gateway serves every object, version and pending multipart
    upload from the filer store the other package wrote."""
    if "ctx" not in cluster:
        test_scripted_session_matches_jax(cluster)
    ctx = cluster["ctx"]
    sides = cluster["sides"]
    before = {pkg: _serve_all(side.gw.url, ctx) for pkg, side in sides.items()}
    _swap_stores(cluster)
    after = {pkg: _serve_all(side.gw.url, ctx) for pkg, side in sides.items()}
    # the port's gateway now reads the JAX store, and the other way round;
    # the JAX store's upload and version ids differ from the port's, so
    # compare each store's answers through both packages
    assert after["port"]["multi"] == before["jax"]["multi"]
    for name in ("list", "multi", "streamed", "big", "sse-s3", "sse-c", "policy", "page",
                 "uploads"):
        assert after["port"][name] == before["jax"][name], name
        assert after["jax"][name] == before["port"][name], name
    for name in ("multi", "big", "sse-s3", "sse-c", "page"):
        assert after["port"][name][0] == 200, name
    # the JAX store holds the JAX session's ids: read them through the port
    jax_ctx = _ids_of(sides["port"].gw.url)
    for vid, body in zip(jax_ctx["versions"], (b"version two!", b"version three")):
        status, data, _ = _send(sides["port"].gw.url, "GET", "/sb/v.txt",
                                "versionId=" + urllib.parse.quote(vid, safe=""), b"", {}, "v4")
        assert (status, data) == (200, body)
    status, data, _ = _send(sides["port"].gw.url, "GET", "/sb/pending.bin",
                            "uploadId=" + jax_ctx["upload"], b"", {}, "v4")
    assert status == 200 and b"<PartNumber>1</PartNumber>" in data


def _ids_of(addr: str) -> dict:
    _, data, _ = _send(addr, "GET", "/sb", "prefix=v.txt&versions=", b"", {}, "v4")
    root = ET.fromstring(data)
    live = [v for v in root.iter(f"{NS}Version")]
    # newest first: v3, v2 (v1 was deleted by id)
    vids = [v.findtext(f"{NS}VersionId") for v in live]
    _, up, _ = _send(addr, "GET", "/sb", "uploads=", b"", {}, "v4")
    upload = ET.fromstring(up).find(f"{NS}Upload").findtext(f"{NS}UploadId")
    return {"versions": list(reversed(vids)), "upload": upload}


def test_deferred_features_answer_not_ported(cluster):
    """SelectObjectContent and the browser form POST are ported: each
    gateway answers the same request alike (tests/test_torch_s3_select_post.py
    holds them further); ``credential_store`` and ``inval_bus`` are taken."""
    select = (b"<SelectObjectContentRequest><Expression>SELECT * FROM S3Object</Expression>"
              b"<ExpressionType>SQL</ExpressionType></SelectObjectContentRequest>")
    form = (b"--XX\r\nContent-Disposition: form-data; name=\"key\"\r\n\r\nk\r\n--XX--\r\n")
    got = {}
    for pkg, side in cluster["sides"].items():
        addr = side.gw.url
        _send(addr, "PUT", "/dfr", "", b"", {}, "v4")
        _send(addr, "PUT", "/dfr/rows.json", "", b'{"a": 1}\n', {}, "v4")
        sel = _send(addr, "POST", "/dfr/rows.json", "select=&select-type=2", select, {}, "v4")
        post = _http(addr, "POST", "/dfr", form,
                     {"Content-Type": "multipart/form-data; boundary=XX"})
        got[pkg] = (sel[0], sel[1], post[0], re.sub(rb"<RequestId>[^<]*</RequestId>", b"",
                                                   post[1]))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (200, b'{"a":1}\n')
    assert got["port"][2] == 400 and b"InvalidPolicyDocument" in got["port"][3]
    master = cluster["master"].grpc_address
    from seaweedfs_tpu_torch.filer.inval_bus import InvalBus
    from seaweedfs_tpu_torch.iam import MemoryCredentialStore

    sock = InvalBus.bind()
    gw = S3ApiServer(master, port=0, credential_store=MemoryCredentialStore(),
                     inval_bus=InvalBus(sock, [sock.getsockname()[1]]),
                     lifecycle_sweep_interval=0, credential_refresh=0)
    try:
        assert gw.verifier.require_auth and gw.verifier.identities == {}
    finally:
        gw.stop()
    # TLS is ported: a pair that does not load fails before anything binds
    with pytest.raises(OSError):
        S3ApiServer(master, port=0, tls_cert="c.pem", tls_key="k.pem")


def test_jax_cached_get_drops_cors_headers(cluster):
    """A fault of the JAX gateway (ROADMAP Queue C): with the hot-chunk
    cache on, a GET whose chunks the cache can hold goes through its
    splice path, which writes its own response head and leaves out the
    CORS headers a matching rule grants; the port's gateway sends them,
    as both packages do for the same object without the cache."""
    body = np.random.default_rng(1313).bytes(3 * CHUNK + 7)
    got = {}
    for pkg, side in cluster["sides"].items():
        addr = side.gw.url
        _send(addr, "PUT", "/corsb", "", b"", {}, "v4")
        _send(addr, "PUT", "/corsb", "cors=", CORS, {}, "v4")
        status, _d, _h = _send(addr, "PUT", "/corsb/o.bin", "", body, {}, "v4")
        assert status == 200
        got[pkg] = [_send(addr, "GET", "/corsb/o.bin", "", b"",
                          {"Origin": "https://app.example"}, "v4") for _ in range(2)]
    for status, data, headers in got["port"] + got["jax"]:
        assert status == 200 and data == body
    assert all(h.get("access-control-allow-origin") == "https://app.example"
               for _s, _d, h in got["port"])
    assert not any("access-control-allow-origin" in h for _s, _d, h in got["jax"])
