"""Browser-based POST uploads: multipart/form-data + signed POST policy.

Counterpart of the reference's weed/s3api/s3api_object_handlers_postpolicy.go
+ policy condition checker: an HTML form POSTs to the bucket URL with a
base64 policy document, an AWS4-HMAC-SHA256 signature over it, metadata
fields, and the file — the one S3 write path whose credentials ride in
the form body instead of headers.

Implemented policy conditions: expiration, bucket, key (exact /
starts-with, with ``${filename}`` substitution), content-length-range,
and eq/starts-with on arbitrary submitted fields.  Unknown condition
forms are rejected (a condition the server ignores would silently widen
what the signer authorized).

The port's copy of seaweedfs_tpu/s3/post_policy.py: the same verdicts on
the same forms.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import email
import email.policy
import hashlib
import hmac
import json

from seaweedfs_tpu_torch.s3.auth import AccessDenied, Identity, signing_key


class PolicyError(Exception):
    """Invalid form/policy shape (HTTP 400)."""


def parse_form(content_type: str, body: bytes) -> tuple[dict[str, str], str, bytes]:
    """multipart/form-data → ({field: value}, filename, file_bytes).

    Fields after the ``file`` part are ignored, as S3 specifies."""
    if not content_type.lower().startswith("multipart/form-data"):
        raise PolicyError("POST upload requires multipart/form-data")
    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP,
    )
    if not msg.is_multipart():
        raise PolicyError("malformed multipart body (missing boundary?)")
    fields: dict[str, str] = {}
    filename, file_bytes = "", None
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        if name == "file":
            filename = (
                part.get_param("filename", header="content-disposition") or ""
            )
            file_bytes = payload
            break  # S3 ignores everything after the file part
        fields[name] = payload.decode("utf-8", "replace")
    if file_bytes is None:
        raise PolicyError("form has no 'file' part")
    return fields, filename, file_bytes


def resolve_key(fields: dict[str, str], filename: str) -> str:
    key = fields.get("key", "")
    if not key:
        raise PolicyError("form has no 'key' field")
    return key.replace("${filename}", filename)


def verify_signature(
    fields: dict[str, str], identities: dict[str, Identity]
) -> Identity:
    """SigV4 POST policy: signature = HMAC(signing_key, policy_b64)."""
    policy_b64 = fields.get("policy", "")
    credential = fields.get("x-amz-credential", "")
    signature = fields.get("x-amz-signature", "")
    algorithm = fields.get("x-amz-algorithm", "")
    if not (policy_b64 and credential and signature):
        raise AccessDenied("POST form is missing policy/credential/signature")
    if algorithm != "AWS4-HMAC-SHA256":
        raise AccessDenied(f"unsupported signing algorithm {algorithm!r}")
    parts = credential.split("/")
    if len(parts) != 5 or parts[3] != "s3":
        raise AccessDenied(f"malformed credential {credential!r}")
    access_key, date, region = parts[0], parts[1], parts[2]
    ident = identities.get(access_key)
    if ident is None:
        raise AccessDenied(f"unknown access key {access_key!r}")
    key = signing_key(ident.secret_key, date, region, "s3")
    expect = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        raise AccessDenied("POST policy signature mismatch")
    return ident


def check_policy(
    fields: dict[str, str], bucket: str, key: str, file_size: int
) -> None:
    """Validate the signed policy's expiration and every condition
    against what was actually submitted."""
    try:
        doc = json.loads(base64.b64decode(fields["policy"], validate=True))
    except (KeyError, binascii.Error, json.JSONDecodeError) as e:
        raise PolicyError(f"undecodable policy document: {e}") from e

    expiration = doc.get("expiration", "")
    try:
        exp = datetime.datetime.fromisoformat(expiration.replace("Z", "+00:00"))
    except ValueError as e:
        raise PolicyError(f"bad policy expiration {expiration!r}") from e
    now = datetime.datetime.now(datetime.timezone.utc)
    if exp.tzinfo is None:
        exp = exp.replace(tzinfo=datetime.timezone.utc)
    if now > exp:
        raise AccessDenied("POST policy has expired")

    # condition matching is case-insensitive on field names (AWS): fold
    # the submitted keys once so policy casing never causes a false 403
    submitted = {k.lower(): v for k, v in fields.items()}
    submitted["bucket"] = bucket
    submitted["key"] = key
    covered: set[str] = set()
    for cond in doc.get("conditions", []):
        try:
            if isinstance(cond, dict):
                # {"field": "value"} is shorthand for ["eq", "$field", "value"]
                ((name, want),) = cond.items()
                covered.add(name.lower())
                _check_eq(submitted, name, str(want))
            elif isinstance(cond, list) and len(cond) == 3:
                op, raw_name, want = cond[0], str(cond[1]), cond[2]
                name = raw_name.lstrip("$")
                covered.add(name.lower())
                if op == "eq":
                    _check_eq(submitted, name, str(want))
                elif op == "starts-with":
                    got = submitted.get(name.lower(), "")
                    if not got.startswith(str(want)):
                        raise AccessDenied(
                            f"policy condition failed: {name} must start "
                            f"with {want!r}"
                        )
                elif op == "content-length-range":
                    lo, hi = int(raw_name), int(want)  # [op, min, max]
                    if not lo <= file_size <= hi:
                        raise AccessDenied(
                            f"file size {file_size} outside policy range "
                            f"[{lo}, {hi}]"
                        )
                else:
                    raise PolicyError(f"unsupported policy condition {op!r}")
            else:
                raise PolicyError(f"malformed policy condition {cond!r}")
        except (ValueError, TypeError) as e:
            # a signed-but-malformed document (non-numeric length bounds,
            # multi-key shorthand dict) is the CALLER's 400, not our 500
            raise PolicyError(
                f"malformed policy condition {cond!r}: {e}"
            ) from e
    covered = {c.lower() for c in covered}
    # a policy constraining neither bucket nor key would be replayable to
    # ANY bucket/key until expiry — AWS requires conditions to cover the
    # fields the form submits; require at least these two
    missing = {"bucket", "key"} - covered
    if missing:
        raise AccessDenied(
            "policy document must constrain "
            + " and ".join(sorted(missing))
        )
    # ... and every OTHER submitted field must be authorized by a
    # condition too (AWS: "Extra input fields") — otherwise an uploader
    # can attach unsigned Content-Type / x-amz-meta-* the signer never
    # delegated (e.g. text/html for stored XSS)
    exempt = {
        "policy", "key", "bucket",
        "x-amz-signature", "x-amz-algorithm", "x-amz-credential",
        "x-amz-date", "x-amz-security-token",
    }
    extra = {
        k for k in submitted
        if k not in covered and k not in exempt
        and not k.startswith("x-ignore-")
    }
    if extra:
        raise AccessDenied(
            "extra input fields not covered by the policy: "
            + ", ".join(sorted(extra))
        )


def _check_eq(submitted: dict[str, str], name: str, want: str) -> None:
    got = submitted.get(name.lower(), "")
    if got != want:
        raise AccessDenied(
            f"policy condition failed: {name} == {want!r} (got {got!r})"
        )
