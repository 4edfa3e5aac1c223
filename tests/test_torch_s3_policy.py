"""The port's S3 authorization documents held against the JAX package's:
ACL grant XML and x-amz-grant-* headers (parse, serialize, decide),
bucket-policy parsing and ``policy.evaluate``, and CORS parsing and
matching, over hypothesis-generated documents, requests and contexts.
Each package gives the same verdict, the same bytes or the same refusal."""

from __future__ import annotations

import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from seaweedfs_tpu.s3 import acl as jax_acl
from seaweedfs_tpu.s3 import cors as jax_cors
from seaweedfs_tpu.s3 import policy as jax_policy
from seaweedfs_tpu_torch.s3 import acl, cors, policy

OWNER = "weedtpu"
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome compared
        return type(e).__name__, str(e)


# ---- ACLs --------------------------------------------------------------------

_grantee = st.one_of(
    st.tuples(st.just("CanonicalUser"), st.sampled_from([OWNER, "alice", "bob", ""])),
    st.tuples(st.just("Group"), st.sampled_from([acl.GROUP_ALL_USERS, acl.GROUP_AUTH_USERS,
                                                 "http://example.com/groups/bogus"])),
)
_grant = st.tuples(_grantee, st.sampled_from(list(acl.PERMISSIONS) + ["READ_ONLY"]))


def _acl_xml(grants, owner=OWNER, namespaced=True) -> bytes:
    xmlns = ' xmlns="http://s3.amazonaws.com/doc/2006-03-01/"' if namespaced else ""
    xsi = ' xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"'
    body = "".join(
        f'<Grant><Grantee{xsi} xsi:type="{t}">'
        + (f"<ID>{g}</ID>" if t == "CanonicalUser" else f"<URI>{g}</URI>")
        + f"</Grantee><Permission>{p}</Permission></Grant>"
        for (t, g), p in grants)
    return (f"<AccessControlPolicy{xmlns}><Owner><ID>{owner}</ID></Owner>"
            f"<AccessControlList>{body}</AccessControlList></AccessControlPolicy>").encode()


_ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject", "s3:GetObjectAcl",
            "s3:PutObjectAcl", "s3:ListBucket", "s3:GetBucketAcl", "s3:PutBucketAcl",
            "s3:DeleteObjectVersion", "s3:GetObjectVersion", "s3:PutBucketPolicy"]


@SETTINGS
@given(grants=st.lists(_grant, max_size=6), owner=st.sampled_from([OWNER, "mallory"]),
       namespaced=st.booleans(), action=st.sampled_from(_ACTIONS),
       principal=st.sampled_from([None, "alice", OWNER, "bob"]))
def test_acl_grants_xml_and_decisions(grants, owner, namespaced, action, principal):
    body = _acl_xml(grants, owner, namespaced)
    got = {}
    for name, mod in (("port", acl), ("jax", jax_acl)):
        out = _outcome(lambda: mod.parse_acl_xml(body, OWNER))
        if out[0] == "ok":
            parsed = out[1]
            blob = mod.grants_to_json(parsed)
            got[name] = ("ok", [g.to_dict() for g in parsed], blob,
                         mod.grants_xml(OWNER, parsed),
                         mod.grants_allow(mod.grants_from_json(blob), action, principal))
        else:
            got[name] = out
    assert got["port"] == got["jax"]


_grant_value = st.lists(st.one_of(
    st.sampled_from(["alice", "bob", OWNER]).map(lambda v: f'id="{v}"'),
    st.sampled_from([acl.GROUP_ALL_USERS, acl.GROUP_AUTH_USERS, "http://bogus"])
    .map(lambda v: f'uri="{v}"'),
    st.just('emailAddress="x@example.com"'),
), min_size=1, max_size=3).map(", ".join)


@SETTINGS
@given(headers=st.dictionaries(
    st.sampled_from(["x-amz-grant-read", "x-amz-grant-write", "x-amz-grant-read-acp",
                     "x-amz-grant-write-acp", "x-amz-grant-full-control", "x-amz-acl"]),
    _grant_value, max_size=3))
def test_acl_grant_headers(headers):
    got = {}
    for name, mod in (("port", acl), ("jax", jax_acl)):
        out = _outcome(lambda: mod.parse_grant_headers(headers, OWNER))
        got[name] = (out[0], [g.to_dict() for g in out[1]] if out[0] == "ok" else out[1],
                     mod.has_grant_headers(headers))
    assert got["port"] == got["jax"]


# ---- bucket policies ---------------------------------------------------------

_keys = sorted(policy.SUPPORTED_CONDITION_KEYS) + ["aws:bogus", "s3:ExistingObjectTag/x"]
_ops = sorted(policy._OPERATORS) + ["Null", "StringEqualsIfExists", "ForAnyValue:StringLike",
                                    "ForAllValues:StringEquals", "NumericLessThanIfExists",
                                    "BogusOperator"]
_values = st.sampled_from(["10.0.0.0/8", "10.1.2.3", "192.168.0.0/16", "true", "false", "5",
                           "100", "2026-01-01T00:00:00Z", "2030-06-01T00:00:00Z", "alice",
                           "docs/*", "arn:aws:s3:::b/*", "Mozilla*", "AES256", "not-a-cidr"])
_condition = st.dictionaries(st.sampled_from(_ops), st.dictionaries(
    st.sampled_from(_keys), st.one_of(_values, st.lists(_values, min_size=1, max_size=3)),
    min_size=1, max_size=2), max_size=2)
_statement = st.fixed_dictionaries({
    "Effect": st.sampled_from(["Allow", "Deny", "Maybe"]),
    "Action": st.one_of(st.sampled_from(_ACTIONS + ["s3:*", "s3:Get*", "*"]),
                        st.lists(st.sampled_from(_ACTIONS), min_size=1, max_size=3)),
    "Resource": st.sampled_from(["arn:aws:s3:::b/*", "arn:aws:s3:::b", "arn:aws:s3:::b/docs/*",
                                 "*", "arn:aws:s3:::other/*", ["arn:aws:s3:::b",
                                                               "arn:aws:s3:::b/*"]]),
}, optional={
    "Principal": st.sampled_from(["*", {"AWS": "*"}, {"AWS": ["alice", "bob"]},
                                  {"AWS": "arn:aws:iam::123:user/alice"}, {"CanonicalUser": "x"}]),
    "NotPrincipal": st.sampled_from([{"AWS": "alice"}, {"AWS": ["bob"]}]),
    "NotAction": st.sampled_from(["s3:DeleteObject", ["s3:PutObject", "s3:GetObject"]]),
    "NotResource": st.sampled_from(["arn:aws:s3:::b/secret/*"]),
    "Condition": _condition,
    "Sid": st.sampled_from(["s1", "s2"]),
})
_doc = st.fixed_dictionaries({"Version": st.sampled_from(["2012-10-17", "2008-10-17"]),
                              "Statement": st.lists(_statement, min_size=1, max_size=4)})
_context = st.dictionaries(st.sampled_from(sorted(policy.SUPPORTED_CONDITION_KEYS)),
                           st.lists(_values, min_size=1, max_size=2), max_size=5)


@SETTINGS
@given(doc=_doc, action=st.sampled_from(_ACTIONS), who=st.sampled_from(["*", "alice", "bob"]),
       key=st.sampled_from(["", "docs/a.txt", "secret/k", "x"]), context=_context)
def test_policy_parse_and_evaluate(doc, action, who, key, context):
    blob = json.dumps(doc).encode()
    parsed = {name: _outcome(lambda: mod.parse_policy(blob))
              for name, mod in (("port", policy), ("jax", jax_policy))}
    assert parsed["port"] == parsed["jax"]
    arn = policy.resource_arn("b", key)
    assert arn == jax_policy.resource_arn("b", key)
    # the evaluator also meets stored documents that predate validation:
    # evaluate the raw document whether or not it parses
    verdicts = {name: _outcome(lambda: mod.evaluate(doc, action, arn, who, context))
                for name, mod in (("port", policy), ("jax", jax_policy))}
    assert verdicts["port"] == verdicts["jax"]


@pytest.mark.parametrize("blob", [b"", b"{", b"[]", b'{"Statement": "x"}',
                                  b'{"Version": "2012-10-17", "Statement": []}',
                                  b'{"Statement": [{"Effect": "Allow"}]}'])
def test_policy_malformed_documents(blob):
    got = {name: _outcome(lambda: mod.parse_policy(blob))
           for name, mod in (("port", policy), ("jax", jax_policy))}
    assert got["port"] == got["jax"]


# ---- CORS --------------------------------------------------------------------

_origins = ["https://app.example", "http://*.example.com", "*", "https://other.example"]
_methods = ["GET", "PUT", "POST", "DELETE", "HEAD", "PATCH"]
_rule = st.fixed_dictionaries({
    "origins": st.lists(st.sampled_from(_origins), min_size=0, max_size=2),
    "methods": st.lists(st.sampled_from(_methods), min_size=0, max_size=3),
    "headers": st.lists(st.sampled_from(["*", "x-amz-date", "Authorization", "content-type"]),
                        max_size=2),
    "expose": st.lists(st.sampled_from(["ETag", "x-amz-request-id"]), max_size=2),
    "max_age": st.one_of(st.none(), st.sampled_from(["0", "600", "-1", "abc"])),
})


def _cors_xml(rules) -> bytes:
    out = ["<CORSConfiguration>"]
    for r in rules:
        out.append("<CORSRule>")
        out += [f"<AllowedOrigin>{o}</AllowedOrigin>" for o in r["origins"]]
        out += [f"<AllowedMethod>{m}</AllowedMethod>" for m in r["methods"]]
        out += [f"<AllowedHeader>{h}</AllowedHeader>" for h in r["headers"]]
        out += [f"<ExposeHeader>{h}</ExposeHeader>" for h in r["expose"]]
        if r["max_age"] is not None:
            out.append(f"<MaxAgeSeconds>{r['max_age']}</MaxAgeSeconds>")
        out.append("</CORSRule>")
    out.append("</CORSConfiguration>")
    return "".join(out).encode()


@SETTINGS
@given(rules=st.lists(_rule, max_size=3),
       origin=st.sampled_from(["https://app.example", "http://a.example.com",
                               "https://evil.example", "null"]),
       method=st.sampled_from(_methods),
       req_headers=st.sampled_from(["", "x-amz-date", "x-amz-date, content-type", "x-other"]))
def test_cors_parse_and_match(rules, origin, method, req_headers):
    blob = _cors_xml(rules)
    got = {}
    for name, mod in (("port", cors), ("jax", jax_cors)):
        out = _outcome(lambda: mod.parse_cors(blob))
        if out[0] != "ok":
            got[name] = out
            continue
        parsed = out[1]
        got[name] = ("ok", mod.serialize_cors(parsed),
                     mod.response_headers(parsed, origin, method, req_headers),
                     mod.response_headers(parsed, origin, method))
    assert got["port"] == got["jax"]
