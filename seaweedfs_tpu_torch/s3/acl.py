"""Explicit S3 ACL grants: AccessControlPolicy XML and x-amz-grant-*.

Counterpart of the reference's ACL helper
(the reference's weed/s3api/s3api_acl_helper.go and the
Get/PutObjectAclHandler pair in s3api_object_handlers_acl.go:17): parse
and validate grant bodies, serialize them back, translate the
x-amz-grant-* header form, and fold grants into the access decision the
same way a bucket-policy Allow would be.  Canned ACLs
(private/public-read/public-read-write) remain the compact form
(s3_server.py); an explicit grant body replaces them.

Stored form: JSON list of {type, id|uri, permission} under the bucket
config key / object extended key ``acl_grants``.

The port's copy of seaweedfs_tpu/s3/acl.py.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from dataclasses import dataclass

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
XSI = "http://www.w3.org/2001/XMLSchema-instance"

PERMISSIONS = ("FULL_CONTROL", "READ", "WRITE", "READ_ACP", "WRITE_ACP")
GROUP_ALL_USERS = "http://acs.amazonaws.com/groups/global/AllUsers"
GROUP_AUTH_USERS = "http://acs.amazonaws.com/groups/global/AuthenticatedUsers"
_KNOWN_GROUPS = (GROUP_ALL_USERS, GROUP_AUTH_USERS)

# action families -> the grant permission that admits them (FULL_CONTROL
# admits everything); mirrors the reference's permission checks
_READ_ACTIONS = (
    "s3:GetObject", "s3:GetObjectVersion", "s3:ListBucket",
    "s3:GetBucketLocation", "s3:ListBucketVersions",
)
_WRITE_ACTIONS = ("s3:PutObject", "s3:DeleteObject", "s3:DeleteObjectVersion")
_READ_ACP_ACTIONS = ("s3:GetBucketAcl", "s3:GetObjectAcl")
_WRITE_ACP_ACTIONS = ("s3:PutBucketAcl", "s3:PutObjectAcl")


class AclError(ValueError):
    """Maps to HTTP 400 (MalformedACLError / InvalidArgument)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


@dataclass(frozen=True)
class Grant:
    grantee_type: str  # "CanonicalUser" | "Group"
    grantee: str       # canonical id, or group URI
    permission: str

    def to_dict(self) -> dict:
        return {
            "type": self.grantee_type,
            "grantee": self.grantee,
            "permission": self.permission,
        }


def _validate(g: Grant) -> Grant:
    if g.permission not in PERMISSIONS:
        raise AclError("InvalidArgument", f"invalid permission {g.permission!r}")
    if g.grantee_type == "Group":
        if g.grantee not in _KNOWN_GROUPS:
            raise AclError("InvalidArgument", f"unknown group {g.grantee!r}")
    elif g.grantee_type == "CanonicalUser":
        if not g.grantee:
            raise AclError("InvalidArgument", "grantee ID required")
    else:
        raise AclError(
            "InvalidArgument", f"unsupported grantee type {g.grantee_type!r}"
        )
    return g


def parse_acl_xml(body: bytes, owner_id: str) -> list[Grant]:
    """Parse an AccessControlPolicy body; validates owner and grants
    (reference PutBucketAclHandler -> ValidateAndTransferGrants)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise AclError("MalformedACLError", f"unparseable ACL XML: {e}") from e
    if root.tag.split("}")[-1] != "AccessControlPolicy":
        raise AclError("MalformedACLError", f"unexpected root {root.tag!r}")

    def find(el, name):
        got = el.find(f"{{{XMLNS}}}{name}")
        return got if got is not None else el.find(name)

    owner = find(root, "Owner")
    if owner is not None:
        oid = find(owner, "ID")
        if oid is not None and (oid.text or "").strip() not in ("", owner_id):
            # the reference rejects ACLs claiming a different owner
            raise AclError("InvalidArgument", "invalid owner in ACL")
    acl = find(root, "AccessControlList")
    if acl is None:
        raise AclError("MalformedACLError", "missing AccessControlList")
    grants: list[Grant] = []
    for g in list(acl):
        if g.tag.split("}")[-1] != "Grant":
            continue
        grantee = find(g, "Grantee")
        perm = find(g, "Permission")
        if grantee is None or perm is None:
            raise AclError("MalformedACLError", "Grant needs Grantee+Permission")
        gtype = (
            grantee.get(f"{{{XSI}}}type") or grantee.get("type") or ""
        )
        if gtype == "Group":
            uri = find(grantee, "URI")
            who = (uri.text or "").strip() if uri is not None else ""
        elif gtype in ("CanonicalUser", ""):
            gtype = "CanonicalUser"
            gid = find(grantee, "ID")
            who = (gid.text or "").strip() if gid is not None else ""
        elif gtype == "AmazonCustomerByEmail":
            raise AclError(
                "InvalidArgument", "email grantees are not supported"
            )
        else:
            who = ""
        grants.append(
            _validate(Grant(gtype, who, (perm.text or "").strip()))
        )
    if len(grants) > 100:  # AWS grant limit
        raise AclError("InvalidArgument", "too many grants (max 100)")
    return grants


_GRANT_HEADERS = (
    "x-amz-grant-read", "x-amz-grant-write", "x-amz-grant-read-acp",
    "x-amz-grant-write-acp", "x-amz-grant-full-control",
)


def has_grant_headers(headers) -> bool:
    return any(headers.get(h) for h in _GRANT_HEADERS)


def parse_grant_headers(headers, owner_id: str) -> list[Grant]:
    """x-amz-grant-{read,write,read-acp,write-acp,full-control} headers:
    comma-separated `id="..."` / `uri="..."` grantees."""
    out: list[Grant] = []
    for header, perm in (
        ("x-amz-grant-read", "READ"),
        ("x-amz-grant-write", "WRITE"),
        ("x-amz-grant-read-acp", "READ_ACP"),
        ("x-amz-grant-write-acp", "WRITE_ACP"),
        ("x-amz-grant-full-control", "FULL_CONTROL"),
    ):
        raw = headers.get(header, "")
        if not raw:
            continue
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, value = part.partition("=")
            value = value.strip().strip('"')
            kind = kind.strip().lower()
            if kind == "id":
                out.append(_validate(Grant("CanonicalUser", value, perm)))
            elif kind == "uri":
                out.append(_validate(Grant("Group", value, perm)))
            elif kind == "emailaddress":
                raise AclError(
                    "InvalidArgument", "email grantees are not supported"
                )
            else:
                raise AclError(
                    "InvalidArgument", f"bad grantee {part!r} in {header}"
                )
    return out


def grants_to_json(grants: list[Grant]) -> bytes:
    return json.dumps([g.to_dict() for g in grants]).encode()


def grants_from_json(blob: bytes | None) -> list[Grant] | None:
    if not blob:
        return None
    try:
        return [
            Grant(d["type"], d["grantee"], d["permission"])
            for d in json.loads(blob)
        ]
    except (ValueError, KeyError, TypeError):
        return None  # unreadable stored grants: fall back to canned/private


def grants_xml(owner_id: str, grants: list[Grant]) -> bytes:
    root = ET.Element("AccessControlPolicy", xmlns=XMLNS)
    root.set("xmlns:xsi", XSI)
    owner = ET.SubElement(root, "Owner")
    ET.SubElement(owner, "ID").text = owner_id
    acl = ET.SubElement(root, "AccessControlList")
    for g in grants:
        ge = ET.SubElement(acl, "Grant")
        grantee = ET.SubElement(ge, "Grantee")
        grantee.set("xsi:type", g.grantee_type)
        if g.grantee_type == "Group":
            ET.SubElement(grantee, "URI").text = g.grantee
        else:
            ET.SubElement(grantee, "ID").text = g.grantee
        ET.SubElement(ge, "Permission").text = g.permission
    return ET.tostring(root, xml_declaration=True, encoding="UTF-8")


def _permission_admits(permission: str, action: str) -> bool:
    if permission == "FULL_CONTROL":
        return True
    return (
        (permission == "READ" and action in _READ_ACTIONS)
        or (permission == "WRITE" and action in _WRITE_ACTIONS)
        or (permission == "READ_ACP" and action in _READ_ACP_ACTIONS)
        or (permission == "WRITE_ACP" and action in _WRITE_ACP_ACTIONS)
    )


def grants_allow(
    grants: list[Grant] | None, action: str, principal: str | None
) -> bool:
    """Does any grant admit ``action`` for ``principal`` (None =
    anonymous)?  Groups: AllUsers admits everyone, AuthenticatedUsers
    admits any signed identity; CanonicalUser matches the principal id."""
    if not grants:
        return False
    for g in grants:
        if not _permission_admits(g.permission, action):
            continue
        if g.grantee_type == "Group":
            if g.grantee == GROUP_ALL_USERS:
                return True
            if g.grantee == GROUP_AUTH_USERS and principal is not None:
                return True
        elif principal is not None and g.grantee == principal:
            return True
    return False
