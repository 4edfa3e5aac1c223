"""Minimal SigV4 request signer — the client half of auth.py, used by the
test suite and shell tooling to talk to the gateway the way boto3 would.

The port's copy of seaweedfs_tpu/s3/client_sign.py.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse

from seaweedfs_tpu_torch.s3.auth import (
    ALGORITHM,
    STREAMING_PAYLOAD,
    Identity,
    SigV4Context,
    _canonical_query,
    _canonical_uri,
    signing_key,
)


def _seed(
    method: str,
    url_path: str,
    query: str,
    headers: dict[str, str],
    payload_hash: str,
    secret_key: str,
    date: str,
    amz_date: str,
    region: str,
) -> tuple[str, str, bytes]:
    """Shared canonicalization: -> (signature, scope, signing key)."""
    signed = sorted(headers)
    canonical = "\n".join(
        [
            method,
            _canonical_uri(url_path),
            _canonical_query(query),
            "".join(f"{h}:{headers[h]}\n" for h in signed),
            ";".join(signed),
            payload_hash,
        ]
    )
    scope = f"{date}/{region}/s3/aws4_request"
    sts = "\n".join(
        [ALGORITHM, amz_date, scope, hashlib.sha256(canonical.encode()).hexdigest()]
    )
    key = signing_key(secret_key, date, region, "s3")
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest(), scope, key


def _authorization(access_key: str, scope: str, headers: dict, sig: str) -> str:
    return (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(sorted(headers))}, Signature={sig}"
    )


def _dates(now: float | None) -> tuple[str, str]:
    t = time.gmtime(now if now is not None else time.time())
    return time.strftime("%Y%m%d", t), time.strftime("%Y%m%dT%H%M%SZ", t)


def sign_headers(
    method: str,
    url_path: str,
    query: str,
    host: str,
    body: bytes,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    now: float | None = None,
    extra_headers: dict[str, str] | None = None,
) -> dict[str, str]:
    """Returns the headers to attach (Host excluded — http.client sets it).
    ``extra_headers`` (e.g. x-amz-acl) are signed and returned too."""
    date, amz_date = _dates(now)
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
        **{k.lower(): v for k, v in (extra_headers or {}).items()},
    }
    sig, scope, _ = _seed(
        method, url_path, query, headers, payload_hash, secret_key, date,
        amz_date, region,
    )
    out = {k: v for k, v in headers.items() if k != "host"}
    out["Authorization"] = _authorization(access_key, scope, headers, sig)
    return out


def presign_url(
    method: str,
    url_path: str,
    host: str,
    access_key: str,
    secret_key: str,
    *,
    expires: int = 3600,
    region: str = "us-east-1",
    extra_query: dict[str, str] | None = None,
    now: float | None = None,
) -> str:
    """Returns the full signed query string (without leading '?') for a
    presigned URL — the client half of SigV4Verifier.verify_presigned."""
    from seaweedfs_tpu_torch.s3.auth import UNSIGNED_PAYLOAD

    date, amz_date = _dates(now)
    scope = f"{date}/{region}/s3/aws4_request"
    params = {
        "X-Amz-Algorithm": ALGORITHM,
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
        **(extra_query or {}),
    }
    query = urllib.parse.urlencode(sorted(params.items()))
    headers = {"host": host}
    canonical = "\n".join(
        [
            method,
            _canonical_uri(url_path),
            _canonical_query(query),
            "".join(f"{h}:{headers[h]}\n" for h in sorted(headers)),
            ";".join(sorted(headers)),
            UNSIGNED_PAYLOAD,
        ]
    )
    sts = "\n".join(
        [ALGORITHM, amz_date, scope, hashlib.sha256(canonical.encode()).hexdigest()]
    )
    key = signing_key(secret_key, date, region, "s3")
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return query + "&X-Amz-Signature=" + sig


def sign_streaming(
    method: str,
    url_path: str,
    query: str,
    host: str,
    body: bytes,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    chunk_size: int = 64 * 1024,
    now: float | None = None,
) -> tuple[dict[str, str], bytes]:
    """SigV4 streaming upload: returns (headers, aws-chunked framed body)
    with a correct per-chunk signature chain (the wire format botocore
    emits for STREAMING-AWS4-HMAC-SHA256-PAYLOAD)."""
    date, amz_date = _dates(now)
    headers = {
        "host": host,
        "x-amz-content-sha256": STREAMING_PAYLOAD,
        "x-amz-date": amz_date,
        "x-amz-decoded-content-length": str(len(body)),
    }
    seed, scope, key = _seed(
        method, url_path, query, headers, STREAMING_PAYLOAD, secret_key, date,
        amz_date, region,
    )
    ctx = SigV4Context(
        identity=Identity(access_key, secret_key),
        signature=seed,
        signing_key=key,
        amz_date=amz_date,
        scope=scope,
    )
    framed = bytearray()
    prev = seed
    chunks = [body[i : i + chunk_size] for i in range(0, len(body), chunk_size)]
    for chunk in chunks + [b""]:
        sig = ctx.chunk_signature(prev, chunk)
        framed += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        framed += chunk + b"\r\n"
        prev = sig
    out = {k: v for k, v in headers.items() if k != "host"}
    out["Authorization"] = _authorization(access_key, scope, headers, seed)
    return out, bytes(framed)
