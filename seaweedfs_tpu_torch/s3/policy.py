"""Bucket policy engine.

Counterpart of the reference's weed/s3api/policy_engine/ — statement
evaluation with AWS semantics: Effect/Principal/Action/Resource matching
with wildcards, NotAction/NotResource/NotPrincipal, and the Condition
block (String*/Numeric*/Date*/Bool/IpAddress/Arn*/Null operators with
``...IfExists`` and ``ForAllValues:``/``ForAnyValue:`` modifiers —
reference conditions.go:657-700, types.go:76-92).  Explicit Deny
overrides any Allow.  Policies containing operators or structure this
engine cannot evaluate are REJECTED at PutBucketPolicy time rather than
silently ignored (a dropped IpAddress condition would make the statement
unconditionally effective).

The port's copy of seaweedfs_tpu/s3/policy.py.
"""

from __future__ import annotations

import datetime
import fnmatch
import ipaddress
import json

ALLOW = "allow"
DENY = "deny"


class PolicyError(ValueError):
    pass


def _aslist(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def parse_policy(blob: bytes | str) -> dict:
    """Validate structure at PutBucketPolicy time.

    Rejecting up front is load-bearing: anything accepted here MUST be
    fully evaluatable by ``evaluate`` — an unsupported field silently
    skipped at evaluation time would widen (or for Deny, narrow) the
    policy relative to what its author signed off on."""
    try:
        doc = json.loads(blob)
    except json.JSONDecodeError as e:
        raise PolicyError(f"policy is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("Statement"), list):
        raise PolicyError("policy must carry a Statement list")
    for st in doc["Statement"]:
        if not isinstance(st, dict):
            raise PolicyError("statement must be an object")
        if st.get("Effect") not in ("Allow", "Deny"):
            raise PolicyError("statement Effect must be Allow or Deny")
        has_action = bool(_aslist(st.get("Action")))
        has_not_action = bool(_aslist(st.get("NotAction")))
        if has_action == has_not_action:  # neither, or both
            raise PolicyError(
                "statement requires exactly one of Action / NotAction"
            )
        has_res = bool(_aslist(st.get("Resource")))
        has_not_res = bool(_aslist(st.get("NotResource")))
        if has_res == has_not_res:
            raise PolicyError(
                "statement requires exactly one of Resource / NotResource"
            )
        if ("Principal" in st) == ("NotPrincipal" in st):
            # both is ambiguous; NEITHER is silently inert (a resource
            # policy statement with no principal can never match anyone)
            raise PolicyError(
                "statement requires exactly one of Principal / NotPrincipal"
            )
        cond = st.get("Condition")
        if cond is not None:
            _validate_conditions(cond)
        unknown = set(st) - {
            "Sid", "Effect", "Principal", "NotPrincipal", "Action",
            "NotAction", "Resource", "NotResource", "Condition",
        }
        if unknown:
            raise PolicyError(f"unsupported statement fields {sorted(unknown)}")
    return doc


def _principal_matches(principal, who: str) -> bool:
    """``who`` is the caller's access key, or "*" for anonymous."""
    if principal is None:
        return False
    if principal == "*":
        return True
    if isinstance(principal, dict):
        aws = _aslist(principal.get("AWS"))
        return "*" in aws or who in aws
    return principal == who


# ---------------------------------------------------------------------------
# Condition block
# ---------------------------------------------------------------------------

_TRUE = ("true", "True", "TRUE", "1")


def _num(s):
    return float(s)


def _date(s: str) -> float:
    """Epoch seconds from ISO 8601 or raw epoch (AWS accepts both)."""
    s = s.strip()
    try:
        return float(s)
    except ValueError:
        pass
    return datetime.datetime.fromisoformat(s.replace("Z", "+00:00")).timestamp()


def _ip_in(value: str, cidr: str) -> bool:
    try:
        return ipaddress.ip_address(value) in ipaddress.ip_network(
            cidr, strict=False
        )
    except ValueError:
        return False


# Each evaluator: (context_value, wanted_values) -> bool, where the
# wanted list is OR'd per AWS ("any of the condition values matches").
_OPERATORS = {
    "StringEquals": lambda got, wants: got in wants,
    "StringNotEquals": lambda got, wants: got not in wants,
    "StringEqualsIgnoreCase": lambda got, wants: got.lower()
    in [w.lower() for w in wants],
    "StringNotEqualsIgnoreCase": lambda got, wants: got.lower()
    not in [w.lower() for w in wants],
    "StringLike": lambda got, wants: any(
        _pattern_match(got, w) for w in wants
    ),
    "StringNotLike": lambda got, wants: not any(
        _pattern_match(got, w) for w in wants
    ),
    "NumericEquals": lambda got, wants: any(
        _num(got) == _num(w) for w in wants
    ),
    "NumericNotEquals": lambda got, wants: all(
        _num(got) != _num(w) for w in wants
    ),
    "NumericLessThan": lambda got, wants: any(
        _num(got) < _num(w) for w in wants
    ),
    "NumericLessThanEquals": lambda got, wants: any(
        _num(got) <= _num(w) for w in wants
    ),
    "NumericGreaterThan": lambda got, wants: any(
        _num(got) > _num(w) for w in wants
    ),
    "NumericGreaterThanEquals": lambda got, wants: any(
        _num(got) >= _num(w) for w in wants
    ),
    "DateEquals": lambda got, wants: any(
        _date(got) == _date(w) for w in wants
    ),
    "DateNotEquals": lambda got, wants: all(
        _date(got) != _date(w) for w in wants
    ),
    "DateLessThan": lambda got, wants: any(
        _date(got) < _date(w) for w in wants
    ),
    "DateLessThanEquals": lambda got, wants: any(
        _date(got) <= _date(w) for w in wants
    ),
    "DateGreaterThan": lambda got, wants: any(
        _date(got) > _date(w) for w in wants
    ),
    "DateGreaterThanEquals": lambda got, wants: any(
        _date(got) >= _date(w) for w in wants
    ),
    "Bool": lambda got, wants: any(
        (got in _TRUE) == (w in _TRUE) for w in wants
    ),
    "IpAddress": lambda got, wants: any(_ip_in(got, w) for w in wants),
    "NotIpAddress": lambda got, wants: not any(
        _ip_in(got, w) for w in wants
    ),
    "ArnEquals": lambda got, wants: any(
        _pattern_match(got, w) for w in wants
    ),
    "ArnLike": lambda got, wants: any(_pattern_match(got, w) for w in wants),
    "ArnNotEquals": lambda got, wants: not any(
        _pattern_match(got, w) for w in wants
    ),
    "ArnNotLike": lambda got, wants: not any(
        _pattern_match(got, w) for w in wants
    ),
}

# AWS: a *negated* matching operator evaluates TRUE when the context key
# is absent ("the key is not equal to any of these" holds vacuously) —
# treating absence as non-match would silently disarm Deny statements.
_NEGATED = frozenset(
    op for op in _OPERATORS if "Not" in op and op != "Null"
)

# Condition keys the gateway actually populates (s3_server._policy_context).
# Parse-time validation rejects keys outside this set: a key the engine
# never supplies could make an Allow dead or a Deny silently inert.
SUPPORTED_CONDITION_KEYS = frozenset(
    {
        "aws:sourceip",
        "aws:securetransport",
        "aws:currenttime",
        "aws:epochtime",
        "aws:username",
        "aws:useragent",
        "aws:referer",
        "s3:x-amz-acl",
        "s3:x-amz-server-side-encryption",
        "s3:x-amz-storage-class",
        "s3:x-amz-copy-source",
        "s3:x-amz-metadata-directive",
        "s3:x-amz-content-sha256",
        "s3:prefix",
        "s3:delimiter",
        "s3:max-keys",
        "s3:versionid",
    }
)


def _split_operator(op: str) -> tuple[str, str, bool]:
    """'ForAllValues:StringLikeIfExists' -> ('StringLike', 'all', True)."""
    quantifier = ""
    if ":" in op:
        prefix, _, rest = op.partition(":")
        if prefix == "ForAllValues":
            quantifier, op = "all", rest
        elif prefix == "ForAnyValue":
            quantifier, op = "any", rest
        else:
            raise PolicyError(f"unsupported condition modifier {prefix!r}")
    if_exists = op.endswith("IfExists") and op != "Null"
    if if_exists:
        op = op[: -len("IfExists")]
    return op, quantifier, if_exists


def _validate_conditions(cond) -> None:
    if not isinstance(cond, dict):
        raise PolicyError("Condition must be an object")
    for op, keymap in cond.items():
        base, _, _ = _split_operator(op)
        if base != "Null" and base not in _OPERATORS:
            raise PolicyError(f"unsupported condition operator {op!r}")
        if not isinstance(keymap, dict) or not keymap:
            raise PolicyError(f"condition {op!r} must map keys to values")
        for key, want in keymap.items():
            if key.lower() not in SUPPORTED_CONDITION_KEYS:
                raise PolicyError(
                    f"unsupported condition key {key!r} (this gateway "
                    f"cannot supply it, so the condition could never be "
                    f"evaluated as written)"
                )
            vals = _aslist(want)
            if not vals or not all(
                isinstance(v, (str, int, float, bool)) for v in vals
            ):
                raise PolicyError(
                    f"condition {op}/{key} values must be scalars"
                )
            # numeric/date/ip operands must parse NOW, not at request time
            try:
                for v in vals:
                    if base.startswith("Numeric"):
                        _num(str(v))
                    elif base.startswith("Date"):
                        _date(str(v))
                    elif base in ("IpAddress", "NotIpAddress"):
                        ipaddress.ip_network(str(v), strict=False)
            except ValueError as e:
                raise PolicyError(
                    f"condition {op}/{key} operand {v!r}: {e}"
                ) from e


def _conditions_match(cond: dict | None, context: dict) -> bool:
    """AWS semantics: operators AND together, keys within an operator AND
    together, values within a key OR (Not* variants: none may match).
    A required context key that is absent fails the condition — except
    under ``...IfExists`` (vacuously true) and ``Null``."""
    if not cond:
        return True
    for op, keymap in cond.items():
        base, quantifier, if_exists = _split_operator(op)
        if base != "Null" and base not in _OPERATORS:
            # must be detected BEFORE any missing-key shortcut, so a
            # legacy stored statement surfaces as unevaluatable (the
            # caller fails closed) instead of quietly non-matching
            raise PolicyError(f"unsupported condition operator {op!r}")
        for key, want in keymap.items():
            wants = [str(v).lower() if isinstance(v, bool) else str(v)
                     for v in _aslist(want)]
            got_values = context.get(key.lower())
            if base == "Null":
                want_absent = wants[0] in _TRUE
                if (got_values is None) != want_absent:
                    return False
                continue
            if not got_values:
                # negated operators and ForAllValues hold vacuously on a
                # missing key (AWS); positive operators fail unless
                # ...IfExists
                if if_exists or base in _NEGATED or quantifier == "all":
                    continue
                return False
            fn = _OPERATORS[base]
            try:
                if quantifier == "all":
                    ok = all(fn(g, wants) for g in got_values)
                elif quantifier == "any":
                    ok = any(fn(g, wants) for g in got_values)
                else:
                    # single-valued default: evaluate the first value
                    ok = fn(got_values[0], wants)
            except ValueError:
                ok = False  # unparseable request value can never satisfy
            if not ok:
                return False
    return True


def _pattern_match(value: str, pattern: str) -> bool:
    # AWS wildcards: '*' any run, '?' single char — fnmatch semantics,
    # but case-sensitive and without [] character classes
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


def _action_matches(st, action: str) -> bool:
    if "NotAction" in st:
        return not any(
            _pattern_match(action, a) for a in _aslist(st["NotAction"])
        )
    return any(_pattern_match(action, a) for a in _aslist(st.get("Action")))


def _resource_matches(st, resource_arn: str) -> bool:
    if "NotResource" in st:
        return not any(
            _pattern_match(resource_arn, r) for r in _aslist(st["NotResource"])
        )
    return any(
        _pattern_match(resource_arn, r) for r in _aslist(st.get("Resource"))
    )


def evaluate(
    doc: dict | None,
    action: str,
    resource_arn: str,
    who: str,
    context: dict | None = None,
) -> str | None:
    """Returns ALLOW, DENY, or None (no statement matched).

    ``who`` = access key of the authenticated caller, or "*" when
    anonymous.  ``context`` maps lower-cased condition keys (e.g.
    ``aws:sourceip``) to lists of request values.  Explicit Deny wins
    over any Allow (AWS evaluation order)."""
    if not doc:
        return None
    context = context or {}
    verdict = None
    for st in doc.get("Statement", []):
        if not isinstance(st, dict):
            continue
        effect = st.get("Effect")
        if "NotPrincipal" in st:
            if _principal_matches(st["NotPrincipal"], who):
                continue
        elif not _principal_matches(st.get("Principal"), who):
            continue
        if not _action_matches(st, action):
            continue
        if not _resource_matches(st, resource_arn):
            continue
        try:
            cond_ok = _conditions_match(st.get("Condition"), context)
        except (PolicyError, KeyError, ValueError, TypeError):
            # legacy stored statement whose condition this engine cannot
            # judge (stored before strict PUT-time validation): fail
            # CLOSED — a Deny fires, an Allow never matches.  Dropping
            # the statement (or the whole doc) would fail open.
            if effect == "Deny":
                return DENY
            continue
        if not cond_ok:
            continue
        if effect == "Deny":
            return DENY
        if effect == "Allow":
            verdict = ALLOW
    return verdict


def resource_arn(bucket: str, key: str = "") -> str:
    return f"arn:aws:s3:::{bucket}/{key}" if key else f"arn:aws:s3:::{bucket}"
