"""AWS Signature Version 2 verification (legacy clients).

Behavioral counterpart of the reference's weed/s3api/auth_signature_v2.go:
``Authorization: AWS <access>:<base64 hmac-sha1>`` headers and the
presigned query form (``AWSAccessKeyId``/``Expires``/``Signature``).
String to sign:

    VERB \n Content-MD5 \n Content-Type \n Date \n
    CanonicalizedAmzHeaders CanonicalizedResource

where the Date slot is empty when ``x-amz-date`` rides the amz headers,
and is the ``Expires`` timestamp for presigned URLs.  The subresource
whitelist matches the reference's ``resourceList`` (:37-60).

The port's copy of seaweedfs_tpu/s3/sigv2.py.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse

from seaweedfs_tpu_torch.s3.auth import AccessDenied, Identity

# reference auth_signature_v2.go:37-60
RESOURCE_LIST = frozenset(
    {
        "acl", "delete", "lifecycle", "location", "logging", "notification",
        "partNumber", "policy", "requestPayment", "response-cache-control",
        "response-content-disposition", "response-content-encoding",
        "response-content-language", "response-content-type",
        "response-expires", "torrent", "uploadId", "uploads", "versionId",
        "versioning", "versions", "website",
    }
)


def canonical_amz_headers(headers) -> str:
    amz: dict[str, list[str]] = {}
    # email.Message yields one key PER OCCURRENCE: dedupe first, or a
    # repeated header's values double ("1,2,1,2") and the signature
    # never matches
    seen: set[str] = set()
    for k in headers.keys():
        lk = k.lower().strip()
        if not lk.startswith("x-amz-") or lk in seen:
            continue
        seen.add(lk)
        vals = (
            headers.get_all(k)
            if hasattr(headers, "get_all")
            else [headers[k]]
        )
        amz[lk] = [" ".join(str(v).split()) for v in (vals or [])]
    return "".join(f"{k}:{','.join(amz[k])}\n" for k in sorted(amz))


def canonical_resource(path: str, query: str) -> str:
    # RAW (undecoded) parameter slices: v2 clients sign the query as
    # sent on the wire (reference canonicalizedResourceV2) — decoding
    # here would reject a correctly signed ?response-content-type=a%2Fb
    sub: list[tuple[str, str]] = []
    for part in (query or "").split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        if k in RESOURCE_LIST:
            sub.append((k, v))
    sub.sort()
    out = path or "/"
    if sub:
        out += "?" + "&".join(
            k if v == "" else f"{k}={v}" for k, v in sub
        )
    return out


def string_to_sign(
    method: str, path: str, query: str, headers, date_slot: str
) -> str:
    return "\n".join(
        [
            method,
            headers.get("Content-MD5", "") or "",
            headers.get("Content-Type", "") or "",
            date_slot,
            canonical_amz_headers(headers) + canonical_resource(path, query),
        ]
    )


def sign_v2(secret: str, sts: str) -> str:
    return base64.b64encode(
        hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()
    ).decode()


def verify_v2_header(
    identities: dict[str, Identity],
    method: str,
    path: str,
    query: str,
    headers,
) -> Identity:
    auth = headers.get("Authorization", "")
    try:
        access, want = auth[len("AWS ") :].split(":", 1)
    except ValueError as e:
        raise AccessDenied("malformed v2 Authorization header") from e
    ident = identities.get(access)
    if ident is None:
        raise AccessDenied(f"unknown access key {access!r}")
    date_slot = (
        "" if headers.get("x-amz-date") else (headers.get("Date", "") or "")
    )
    sts = string_to_sign(method, path, query, headers, date_slot)
    if not hmac.compare_digest(sign_v2(ident.secret_key, sts), want):
        raise AccessDenied("SignatureDoesNotMatch (v2)")
    return ident


def verify_v2_presigned(
    identities: dict[str, Identity],
    method: str,
    path: str,
    query: str,
    headers,
) -> Identity:
    q = dict(urllib.parse.parse_qsl(query or "", keep_blank_values=True))
    access = q.get("AWSAccessKeyId", "")
    want = q.get("Signature", "")
    expires = q.get("Expires", "")
    if not (access and want and expires):
        raise AccessDenied("incomplete v2 presigned query")
    try:
        if time.time() > int(expires):
            raise AccessDenied("v2 presigned URL has expired")
    except ValueError as e:
        raise AccessDenied(f"bad Expires {expires!r}") from e
    ident = identities.get(access)
    if ident is None:
        raise AccessDenied(f"unknown access key {access!r}")
    sts = string_to_sign(method, path, query, headers, expires)
    if not hmac.compare_digest(sign_v2(ident.secret_key, sts), want):
        raise AccessDenied("SignatureDoesNotMatch (v2 presigned)")
    return ident


def is_v2_header(headers) -> bool:
    auth = headers.get("Authorization", "")
    return auth.startswith("AWS ") and not auth.startswith("AWS4-")


def is_v2_presigned(query: str) -> bool:
    return (
        "Signature=" in (query or "")
        and "AWSAccessKeyId=" in query
        and "X-Amz-Signature=" not in query
    )


# ---- client side (tests, weed-tpu client tools) ---------------------------


def presign_v2(
    method: str,
    path: str,
    access: str,
    secret: str,
    expires_in: int = 600,
    query: str = "",
) -> str:
    """Presigned v2 query string for ``path`` (caller appends to URL)."""
    expires = str(int(time.time()) + expires_in)

    class _H(dict):
        def get(self, k, d=None):
            return super().get(k, d)

    sts = string_to_sign(method, path, query, _H(), expires)
    sig = sign_v2(secret, sts)
    extra = {
        "AWSAccessKeyId": access,
        "Expires": expires,
        "Signature": sig,
    }
    parts = ([query] if query else []) + [
        urllib.parse.urlencode(extra)
    ]
    return "&".join(parts)


def sign_v2_headers(
    method: str,
    path: str,
    query: str,
    headers: dict[str, str],
    access: str,
    secret: str,
) -> dict[str, str]:
    """Adds Date + Authorization (v2) to ``headers`` and returns them."""
    out = dict(headers)
    if "Date" not in out and "x-amz-date" not in {
        k.lower() for k in out
    }:
        out["Date"] = time.strftime(
            "%a, %d %b %Y %H:%M:%S GMT", time.gmtime()
        )

    class _H:
        def __init__(self, d):
            self.d = {k.lower(): v for k, v in d.items()}

        def get(self, k, default=None):
            return self.d.get(k.lower(), default)

        def keys(self):
            return self.d.keys()

        def __getitem__(self, k):
            return self.d[k.lower()]

    date_slot = "" if _H(out).get("x-amz-date") else out.get("Date", "")
    sts = string_to_sign(method, path, query, _H(out), date_slot)
    out["Authorization"] = f"AWS {access}:{sign_v2(secret, sts)}"
    return out
