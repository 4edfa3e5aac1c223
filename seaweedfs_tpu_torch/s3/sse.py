"""Server-side encryption for the S3 gateway: SSE-C and SSE-S3.

Counterpart of the reference's weed/s3api/s3_sse_c.go and s3_sse_s3.go:
SSE-C encrypts with a customer-supplied 256-bit key validated by MD5;
SSE-S3 envelopes a per-object data key under the gateway's KMS master
key.  Objects are encrypted whole with AES-256-GCM before chunking, so
what lands on volume servers is ciphertext end to end; the per-object
metadata (algorithm, nonce, wrapped key / key MD5) rides in the entry's
extended attributes.

The port's copy of seaweedfs_tpu/s3/sse.py.
"""

from __future__ import annotations

import base64
import hashlib
import secrets

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated dep: the gateway runs without SSE support
    AESGCM = None

from seaweedfs_tpu_torch.security.kms import KmsProvider

HDR_CUSTOMER_ALGO = "x-amz-server-side-encryption-customer-algorithm"
HDR_CUSTOMER_KEY = "x-amz-server-side-encryption-customer-key"
HDR_CUSTOMER_KEY_MD5 = "x-amz-server-side-encryption-customer-key-md5"
HDR_SSE = "x-amz-server-side-encryption"
HDR_KMS_KEY_ID = "x-amz-server-side-encryption-aws-kms-key-id"

META_ALGO = "sse-algo"          # b"SSE-C" | b"AES256"
META_NONCE = "sse-nonce"
META_KEY_MD5 = "sse-key-md5"    # SSE-C: customer key fingerprint
META_WRAPPED = "sse-wrapped-key"  # SSE-S3: KMS-wrapped data key
META_KMS_ID = "sse-kms-id"
META_PLAIN_SIZE = "sse-plain-size"  # listings report this, not ciphertext len


def has_sse_headers(headers) -> bool:
    return bool(headers.get(HDR_CUSTOMER_ALGO) or headers.get(HDR_SSE))


def display_size(extended: dict[str, bytes], stored_size: int) -> int:
    """Plaintext size for listings (ciphertext carries a 16B GCM tag)."""
    raw = extended.get(META_PLAIN_SIZE)
    return int(raw) if raw else stored_size


class SseError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code


def _require_crypto() -> None:
    """SSE needs AES-GCM from the `cryptography` package; images without
    it keep the rest of the gateway (and every plaintext object) working
    and fail only the explicit-encryption requests, loudly."""
    if AESGCM is None:
        raise SseError(
            501, "NotImplemented",
            "server-side encryption needs the 'cryptography' package, "
            "which is not installed on this gateway",
        )


def _customer_key(headers) -> tuple[bytes, str] | None:
    algo = headers.get(HDR_CUSTOMER_ALGO)
    if not algo:
        return None
    if algo != "AES256":
        raise SseError(400, "InvalidArgument", f"unsupported SSE-C algo {algo}")
    try:
        key = base64.b64decode(headers.get(HDR_CUSTOMER_KEY, ""), validate=True)
    except Exception as e:  # noqa: BLE001
        raise SseError(400, "InvalidArgument", "bad SSE-C key encoding") from e
    if len(key) != 32:
        raise SseError(400, "InvalidArgument", "SSE-C key must be 256 bits")
    claimed_md5 = headers.get(HDR_CUSTOMER_KEY_MD5, "")
    actual_md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
    if claimed_md5 != actual_md5:
        raise SseError(400, "InvalidArgument", "SSE-C key MD5 mismatch")
    return key, actual_md5


def _resolve_kms_request(headers, kms: KmsProvider | None) -> tuple[str, str]:
    """Validate an SSE-S3/KMS request; returns (requested_type, key_id).
    Shared by single-PUT and multipart-create so their validation can
    never diverge."""
    requested = headers.get(HDR_SSE)
    if requested not in ("AES256", "aws:kms"):
        # a silent downgrade to plaintext would betray the client's
        # explicit encryption request
        raise SseError(
            501, "NotImplemented", f"unsupported SSE type {requested!r}"
        )
    if kms is None:
        raise SseError(
            501, "NotImplemented",
            f"SSE {requested} needs a KMS (-kmsKeyFile)",
        )
    # SSE-KMS: the caller names the master key; SSE-S3 uses "default"
    # (reference s3_sse_kms.go vs s3_sse_s3.go — same envelope, the
    # difference is who picks the key and what the headers echo)
    key_id = "default"
    if requested == "aws:kms":
        key_id = headers.get(HDR_KMS_KEY_ID) or "default"
        if key_id != "default" and not getattr(
            kms, "key_exists", lambda _k: True
        )(key_id):
            # AWS rejects unknown key ids; silently minting a key per
            # client-supplied id would let writers grow the key file
            # without bound and hide typos
            raise SseError(
                400, "KMS.NotFoundException",
                f"KMS key {key_id!r} does not exist "
                "(create it with the kms key tooling first)",
            )
    return requested, key_id


def encrypt_for_put(
    headers, body: bytes, kms: KmsProvider | None
) -> tuple[bytes, dict[str, bytes], dict[str, str]]:
    """Returns (stored_body, extended_meta, response_headers)."""
    customer = _customer_key(headers)
    if customer is None and not headers.get(HDR_SSE):
        return body, {}, {}  # plaintext path: no crypto involved
    _require_crypto()
    nonce = secrets.token_bytes(12)
    if customer is not None:
        key, key_md5 = customer
        sealed = AESGCM(key).encrypt(nonce, body, b"")
        return (
            sealed,
            {
                META_ALGO: b"SSE-C",
                META_NONCE: nonce,
                META_KEY_MD5: key_md5.encode(),
                META_PLAIN_SIZE: str(len(body)).encode(),
            },
            {HDR_CUSTOMER_ALGO: "AES256", HDR_CUSTOMER_KEY_MD5: key_md5},
        )
    requested = headers.get(HDR_SSE)
    if requested:
        requested, key_id = _resolve_kms_request(headers, kms)
        dk = kms.generate_data_key(key_id)
        sealed = AESGCM(dk.plaintext).encrypt(nonce, body, b"")
        resp = {HDR_SSE: requested}
        if requested == "aws:kms":
            resp[HDR_KMS_KEY_ID] = dk.key_id
        return (
            sealed,
            {
                META_ALGO: requested.encode(),
                META_NONCE: nonce,
                META_WRAPPED: dk.ciphertext,
                META_KMS_ID: dk.key_id.encode(),
                META_PLAIN_SIZE: str(len(body)).encode(),
            },
            resp,
        )
    return body, {}, {}


def decrypt_for_get(
    headers, extended: dict[str, bytes], body: bytes, kms: KmsProvider | None
) -> tuple[bytes, dict[str, str]]:
    """Returns (plaintext, response_headers); raises on key mismatch."""
    algo = extended.get(META_ALGO)
    if not algo:
        if headers.get(HDR_CUSTOMER_ALGO):
            raise SseError(400, "InvalidRequest", "object is not SSE-C encrypted")
        return body, {}  # plaintext object: no crypto involved
    _require_crypto()
    nonce = extended.get(META_NONCE, b"")
    if algo == b"SSE-C":
        customer = _customer_key(headers)
        if customer is None:
            raise SseError(
                400, "InvalidRequest", "object requires SSE-C key headers"
            )
        key, key_md5 = customer
        if key_md5.encode() != extended.get(META_KEY_MD5, b""):
            raise SseError(403, "AccessDenied", "SSE-C key does not match object")
        try:
            if extended.get(META_PARTS):  # multipart: ordered segments
                plain = _decrypt_segmented(key, extended, body)
            else:
                plain = AESGCM(key).decrypt(nonce, body, b"")
        except SseError:
            raise
        except Exception as e:  # noqa: BLE001
            raise SseError(403, "AccessDenied", "SSE-C decryption failed") from e
        return plain, {HDR_CUSTOMER_ALGO: "AES256", HDR_CUSTOMER_KEY_MD5: key_md5}
    if algo in (b"AES256", b"aws:kms"):
        if kms is None:
            raise SseError(501, "NotImplemented", "gateway has no KMS configured")
        kms_id = (extended.get(META_KMS_ID) or b"default").decode()
        try:
            dk = kms.decrypt_data_key(kms_id, extended.get(META_WRAPPED, b""))
            if extended.get(META_PARTS):
                plain = _decrypt_segmented(dk, extended, body)
            else:
                plain = AESGCM(dk).decrypt(nonce, body, b"")
        except SseError:
            raise
        except Exception as e:  # noqa: BLE001 — KmsError or cipher failure
            raise SseError(500, "InternalError", f"SSE decrypt: {e}") from e
        resp = {HDR_SSE: algo.decode()}
        if algo == b"aws:kms":
            resp[HDR_KMS_KEY_ID] = kms_id
        return plain, resp
    raise SseError(500, "InternalError", f"unknown SSE algo {algo!r}")


def is_encrypted(extended: dict[str, bytes]) -> bool:
    return bool(extended.get(META_ALGO))


# ---- multipart (reference s3_sse_c.go/s3_sse_kms.go multipart handling:
# every part is encrypted independently; the completed object is a
# sequence of sealed segments decrypted in order) ------------------------

META_PARTS = "sse-parts"  # JSON [[cipher_len, nonce_b64, plain_len], ...]

# copy-source SSE-C headers (CopyObject / UploadPartCopy read side)
HDR_COPY_CUSTOMER_ALGO = (
    "x-amz-copy-source-server-side-encryption-customer-algorithm"
)
HDR_COPY_CUSTOMER_KEY = (
    "x-amz-copy-source-server-side-encryption-customer-key"
)
HDR_COPY_CUSTOMER_KEY_MD5 = (
    "x-amz-copy-source-server-side-encryption-customer-key-md5"
)


class _CopySourceHeaders:
    """Adapter presenting x-amz-copy-source-sse-c-* under the normal
    header names so the decrypt path needs no second code path."""

    _MAP = {
        HDR_CUSTOMER_ALGO: HDR_COPY_CUSTOMER_ALGO,
        HDR_CUSTOMER_KEY: HDR_COPY_CUSTOMER_KEY,
        HDR_CUSTOMER_KEY_MD5: HDR_COPY_CUSTOMER_KEY_MD5,
    }

    def __init__(self, headers):
        self._h = headers

    def get(self, name, default=None):
        return self._h.get(self._MAP.get(name, name), default)


def copy_source_view(headers) -> _CopySourceHeaders:
    return _CopySourceHeaders(headers)


def upload_sse_meta(headers, kms: KmsProvider | None) -> dict[str, bytes]:
    """At CreateMultipartUpload: capture the upload's SSE parameters.
    SSE-C stores only the key fingerprint (the key arrives again with
    every part); SSE-S3/KMS mints ONE data key for the whole upload."""
    customer = _customer_key(headers)
    if customer is not None:
        _key, key_md5 = customer
        return {META_ALGO: b"SSE-C", META_KEY_MD5: key_md5.encode()}
    if not headers.get(HDR_SSE):
        return {}
    requested, key_id = _resolve_kms_request(headers, kms)
    dk = kms.generate_data_key(key_id)
    return {
        META_ALGO: requested.encode(),
        META_WRAPPED: dk.ciphertext,
        META_KMS_ID: dk.key_id.encode(),
    }


def _upload_data_key(
    up_extended: dict[str, bytes], headers, kms: KmsProvider | None
) -> bytes:
    """The AES key for one part of an SSE multipart upload."""
    algo = up_extended.get(META_ALGO)
    if algo == b"SSE-C":
        customer = _customer_key(headers)
        if customer is None:
            raise SseError(
                400, "InvalidRequest",
                "SSE-C upload: each part needs the customer key headers",
            )
        key, key_md5 = customer
        if key_md5.encode() != up_extended.get(META_KEY_MD5, b""):
            raise SseError(
                400, "InvalidRequest",
                "SSE-C key differs from the one the upload was created with",
            )
        return key
    if kms is None:
        raise SseError(501, "NotImplemented", "gateway has no KMS configured")
    kms_id = (up_extended.get(META_KMS_ID) or b"default").decode()
    try:
        return kms.decrypt_data_key(kms_id, up_extended.get(META_WRAPPED, b""))
    except Exception as e:  # noqa: BLE001
        raise SseError(500, "InternalError", f"unwrap data key: {e}") from e


def encrypt_part(
    up_extended: dict[str, bytes], headers, body: bytes,
    kms: KmsProvider | None,
) -> tuple[bytes, dict[str, bytes]]:
    """Seal one part under the upload's SSE parameters; returns
    (ciphertext, part_meta carrying the nonce + plaintext size)."""
    _require_crypto()
    key = _upload_data_key(up_extended, headers, kms)
    nonce = secrets.token_bytes(12)
    sealed = AESGCM(key).encrypt(nonce, body, b"")
    return sealed, {
        META_NONCE: nonce,
        META_PLAIN_SIZE: str(len(body)).encode(),
    }


def completed_sse_meta(
    up_extended: dict[str, bytes], part_metas: list[dict[str, bytes]],
    cipher_sizes: list[int],
) -> dict[str, bytes]:
    """Object-level SSE metadata for a completed multipart upload: the
    upload's key material plus the ordered segment table GET needs."""
    import json as _json

    algo = up_extended.get(META_ALGO)
    if not algo:
        return {}
    segs = []
    total_plain = 0
    for meta, clen in zip(part_metas, cipher_sizes):
        plain = int(meta.get(META_PLAIN_SIZE) or 0)
        total_plain += plain
        segs.append(
            [clen, base64.b64encode(meta.get(META_NONCE, b"")).decode(), plain]
        )
    out = {
        META_ALGO: algo,
        META_PARTS: _json.dumps(segs).encode(),
        META_PLAIN_SIZE: str(total_plain).encode(),
    }
    for k in (META_KEY_MD5, META_WRAPPED, META_KMS_ID):
        if up_extended.get(k):
            out[k] = up_extended[k]
    return out


def _decrypt_segmented(
    key: bytes, extended: dict[str, bytes], body: bytes
) -> bytes:
    _require_crypto()
    import json as _json

    try:
        segs = _json.loads(extended.get(META_PARTS, b"[]"))
    except ValueError as e:
        raise SseError(500, "InternalError", "corrupt SSE segment table") from e
    plain = bytearray()
    off = 0
    gcm = AESGCM(key)
    for clen, nonce_b64, _plain_len in segs:
        seg = body[off : off + int(clen)]
        off += int(clen)
        try:
            plain += gcm.decrypt(base64.b64decode(nonce_b64), bytes(seg), b"")
        except Exception as e:  # noqa: BLE001
            raise SseError(403, "AccessDenied", "SSE decryption failed") from e
    return bytes(plain)


def head_headers(headers, extended: dict[str, bytes]) -> dict[str, str]:
    """Key validation + response headers for HEAD without touching the
    payload (a HEAD must not download and decrypt the whole object)."""
    algo = extended.get(META_ALGO)
    if not algo:
        if headers.get(HDR_CUSTOMER_ALGO):
            raise SseError(400, "InvalidRequest", "object is not SSE-C encrypted")
        return {}
    if algo == b"SSE-C":
        customer = _customer_key(headers)
        if customer is None:
            raise SseError(400, "InvalidRequest", "object requires SSE-C key headers")
        _key, key_md5 = customer
        if key_md5.encode() != extended.get(META_KEY_MD5, b""):
            raise SseError(403, "AccessDenied", "SSE-C key does not match object")
        return {HDR_CUSTOMER_ALGO: "AES256", HDR_CUSTOMER_KEY_MD5: key_md5}
    if algo == b"aws:kms":
        return {
            HDR_SSE: "aws:kms",
            HDR_KMS_KEY_ID: (extended.get(META_KMS_ID) or b"default").decode(),
        }
    return {HDR_SSE: "AES256"}
