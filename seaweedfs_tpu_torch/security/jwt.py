"""Minimal HS256 JWT: enough for per-fid write tokens (the port's copy of
seaweedfs_tpu/security/jwt.py; tokens either package signs, the other
verifies).

The reference signs {exp, fid} claims with a shared key
(weed/security/jwt.go SeaweedFileIdClaims); tokens ride the
Authorization header (`BEARER <token>`) or a `jwt` query parameter.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64(data: str | bytes) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


def encode_jwt(claims: dict, key: str) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = header + b"." + payload
    sig = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64(sig)).decode()


def decode_jwt(token: str, key: str) -> dict:
    """Verify signature + expiry; returns the claims."""
    try:
        header, payload, sig = token.split(".")
        sig_bytes = _unb64(sig)
    except (ValueError, TypeError) as e:  # covers binascii.Error
        raise JwtError("malformed token") from e
    signing_input = f"{header}.{payload}".encode()
    expect = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(expect, sig_bytes):
        raise JwtError("bad signature")
    try:
        claims = json.loads(_unb64(payload))
    except (ValueError, UnicodeDecodeError) as e:
        raise JwtError("bad claims") from e
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise JwtError("token expired")
    return claims


DEFAULT_TTL_S = 10.0  # reference: 10-second fid tokens


def sign_fid(key: str, fid: str, ttl_s: float = DEFAULT_TTL_S) -> str:
    """Per-fid write token (reference GenJwtForVolumeServer)."""
    return encode_jwt({"fid": fid, "exp": int(time.time() + ttl_s)}, key)


def verify_fid(key: str, token: str, fid: str) -> None:
    """Raises JwtError unless `token` authorizes a write to `fid`."""
    if not token:
        raise JwtError("missing write token")
    claims = decode_jwt(token, key)
    claimed = claims.get("fid", "")
    # batch-assign: a token for the base fid covers fid_N derivatives
    base = fid.split("_")[0]
    if claimed not in (fid, base):
        raise JwtError(f"token fid {claimed!r} does not cover {fid!r}")
