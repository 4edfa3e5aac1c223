"""Security: per-fid write JWTs, the port of seaweedfs_tpu/security's
``sign_fid``, ``verify_fid`` and ``JwtError``.

When a signing key is configured, the master attaches a short-lived
HMAC-SHA256 JWT to every assignment, and volume servers refuse writes and
deletes that do not carry a token for that exact fid (reference
weed/security/jwt.go:16-30, guard.go).  The key is symmetric and shared by
masters and volume servers, so volume servers can also sign their
replication fan-out.  TLS lives in security/tls.py: certificate minting
(``cli tls.gen``), the HTTPS wrap of the filer's and gateway's listeners,
and the mutual-TLS credentials rpc.py uses on every gRPC hop when
``WEEDTPU_TLS_*`` are set.
"""

from seaweedfs_tpu_torch.security.jwt import JwtError, decode_jwt, encode_jwt, sign_fid, verify_fid

__all__ = ["JwtError", "decode_jwt", "encode_jwt", "sign_fid", "verify_fid"]
