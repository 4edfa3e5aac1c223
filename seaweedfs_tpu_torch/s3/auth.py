"""AWS Signature V4 verification (reference weed/s3api/auth_signature_v4.go).

Implements the standard HMAC chain over the canonical request for both
header-based authorization (the path boto3/mc use) and presigned query
authorization (X-Amz-Signature in the URL, reference
auth_signature_v4.go doesPresignedSignatureMatch).  Credentials are a
static access-key→secret map (the reference's s3.configure identities,
weed/s3api/auth_credentials.go); with no identities configured the
gateway runs open, like the reference without -s3.config.

The port's copy of seaweedfs_tpu/s3/auth.py.
"""

from __future__ import annotations

import calendar
import hashlib
import hmac
import time
import urllib.parse
from dataclasses import dataclass

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


class AccessDenied(Exception):
    pass


@dataclass
class Identity:
    access_key: str
    secret_key: str
    name: str = ""


@dataclass
class SigV4Context:
    """Everything a streaming-upload chunk chain needs from the header
    verification: the request signature seeds the per-chunk HMAC chain
    (reference weed/s3api/chunked_reader_v4.go)."""

    identity: Identity
    signature: str
    signing_key: bytes
    amz_date: str
    scope: str

    def chunk_signature(self, prev_signature: str, chunk_data: bytes) -> str:
        string_to_sign = "\n".join(
            [
                ALGORITHM + "-PAYLOAD",
                self.amz_date,
                self.scope,
                prev_signature,
                hashlib.sha256(b"").hexdigest(),
                hashlib.sha256(chunk_data).hexdigest(),
            ]
        )
        return hmac.new(
            self.signing_key, string_to_sign.encode(), hashlib.sha256
        ).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    enc = urllib.parse.quote
    return "&".join(
        f"{enc(k, safe='-_.~')}={enc(v, safe='-_.~')}" for k, v in sorted(pairs)
    )


def _canonical_uri(path: str) -> str:
    # S3-style: each path segment URI-encoded, '/' preserved
    return urllib.parse.quote(urllib.parse.unquote(path), safe="/-_.~")


class SigV4Verifier:
    def __init__(
        self,
        identities: dict[str, Identity] | None = None,
        require_auth: bool = False,
    ):
        self.identities = identities or {}
        # a gateway wired to a credential store stays closed even while
        # the store holds zero keys — revoking the last key must not
        # silently reopen the world
        self.require_auth = require_auth

    @property
    def open_access(self) -> bool:
        return not self.identities and not self.require_auth

    def verify(
        self,
        method: str,
        path: str,
        query: str,
        headers,
        payload_hash: str,
    ) -> Identity | None:
        """Validate the Authorization header; returns the identity.

        Raises :class:`AccessDenied` on any mismatch.  With no identities
        configured, always allows (returns None).
        """
        ctx = self.verify_context(method, path, query, headers, payload_hash)
        return ctx.identity if ctx else None

    def verify_context(
        self,
        method: str,
        path: str,
        query: str,
        headers,
        payload_hash: str,
    ) -> SigV4Context | None:
        """Like :meth:`verify` but returns the full signature context
        (needed to chain streaming-upload chunk signatures)."""
        if self.open_access:
            return None
        auth = headers.get("Authorization", "")
        if not auth.startswith(ALGORITHM):
            raise AccessDenied("missing or non-v4 Authorization header")
        fields = dict(
            part.strip().split("=", 1)
            for part in auth[len(ALGORITHM) :].strip().split(",")
        )
        try:
            cred_scope = fields["Credential"].split("/")
            access_key, date, region, service, _ = cred_scope
            signed_headers = fields["SignedHeaders"].split(";")
            claimed_sig = fields["Signature"]
        except (KeyError, ValueError) as e:
            raise AccessDenied(f"malformed Authorization header: {e}") from e
        ident = self.identities.get(access_key)
        if ident is None:
            raise AccessDenied(f"unknown access key {access_key}")

        canonical_headers = "".join(
            f"{h}:{' '.join((headers.get(h) or '').split())}\n"
            for h in signed_headers
        )
        canonical_request = "\n".join(
            [
                method,
                _canonical_uri(path),
                _canonical_query(query),
                canonical_headers,
                ";".join(signed_headers),
                payload_hash,
            ]
        )
        amz_date = headers.get("x-amz-date", "")
        scope = f"{date}/{region}/{service}/aws4_request"
        string_to_sign = "\n".join(
            [
                ALGORITHM,
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        key = signing_key(ident.secret_key, date, region, service)
        expect = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, claimed_sig):
            raise AccessDenied("signature mismatch")
        return SigV4Context(
            identity=ident,
            signature=claimed_sig,
            signing_key=key,
            amz_date=amz_date,
            scope=scope,
        )

    def verify_presigned(
        self,
        method: str,
        path: str,
        query: str,
        headers,
        now: float | None = None,
    ) -> Identity | None:
        """Query-string (presigned URL) authorization: the canonical
        request is built over every query param except X-Amz-Signature,
        with an UNSIGNED-PAYLOAD hash, and the URL carries its own expiry
        window."""
        if self.open_access:
            return None
        q = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
        if q.get("X-Amz-Algorithm") != ALGORITHM:
            raise AccessDenied("presigned URL missing X-Amz-Algorithm")
        try:
            credential = q["X-Amz-Credential"]
            amz_date = q["X-Amz-Date"]
            expires = int(q["X-Amz-Expires"])
            signed_headers = q["X-Amz-SignedHeaders"].split(";")
            claimed_sig = q["X-Amz-Signature"]
        except (KeyError, ValueError) as e:
            raise AccessDenied(f"malformed presigned query: {e}") from e
        try:
            access_key, date, region, service, _ = credential.split("/")
        except ValueError as e:
            raise AccessDenied("malformed X-Amz-Credential") from e
        ident = self.identities.get(access_key)
        if ident is None:
            raise AccessDenied(f"unknown access key {access_key}")
        if not 1 <= expires <= 7 * 24 * 3600:
            raise AccessDenied("X-Amz-Expires outside 1s..7d")
        try:
            issued = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError as e:
            raise AccessDenied("malformed X-Amz-Date") from e
        t = now if now is not None else time.time()
        if t > issued + expires:
            raise AccessDenied("presigned URL expired")
        if t < issued - 15 * 60:
            raise AccessDenied("presigned URL not yet valid")

        # canonicalize the RAW query minus only the signature pair: going
        # through dict() would collapse duplicate params, letting an
        # attacker prepend a duplicate the handlers read while the
        # signature still verifies against the original value
        unsigned_query = "&".join(
            p for p in query.split("&") if not p.startswith("X-Amz-Signature=")
        )
        canonical_headers = "".join(
            f"{h}:{' '.join((headers.get(h) or '').split())}\n"
            for h in signed_headers
        )
        canonical_request = "\n".join(
            [
                method,
                _canonical_uri(path),
                _canonical_query(unsigned_query),
                canonical_headers,
                ";".join(signed_headers),
                UNSIGNED_PAYLOAD,
            ]
        )
        scope = f"{date}/{region}/{service}/aws4_request"
        string_to_sign = "\n".join(
            [
                ALGORITHM,
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        key = signing_key(ident.secret_key, date, region, service)
        expect = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, claimed_sig):
            raise AccessDenied("presigned signature mismatch")
        return ident
