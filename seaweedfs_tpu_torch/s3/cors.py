"""Bucket CORS configuration and matching.

Counterpart of the reference's weed/s3api/cors/ (rule model + middleware):
CORSConfiguration XML parsed into rules; each request's Origin /
Access-Control-Request-Method matched to produce the Access-Control-*
response headers, both for preflight OPTIONS and actual requests.

The port's copy of seaweedfs_tpu/s3/cors.py.
"""

from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


class CorsError(ValueError):
    pass


@dataclass
class CorsRule:
    origins: list[str] = field(default_factory=list)
    methods: list[str] = field(default_factory=list)
    headers: list[str] = field(default_factory=list)
    expose: list[str] = field(default_factory=list)
    max_age: int | None = None

    def match_origin(self, origin: str) -> bool:
        return any(
            fnmatch.fnmatchcase(origin, pat.replace("[", "[[]"))
            for pat in self.origins
        )

    def match(self, origin: str, method: str) -> bool:
        return self.match_origin(origin) and method in self.methods


def parse_cors(blob: bytes) -> list[CorsRule]:
    try:
        root = ET.fromstring(blob.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise CorsError(f"malformed CORS XML: {e}") from e
    ns = {"s3": S3_XMLNS} if root.tag.startswith("{") else {}

    def findall(el, tag):
        return el.findall(f"s3:{tag}", namespaces=ns) if ns else el.findall(tag)

    rules: list[CorsRule] = []
    for rule_el in findall(root, "CORSRule"):
        rule = CorsRule(
            origins=[e.text or "" for e in findall(rule_el, "AllowedOrigin")],
            methods=[e.text or "" for e in findall(rule_el, "AllowedMethod")],
            headers=[e.text or "" for e in findall(rule_el, "AllowedHeader")],
            expose=[e.text or "" for e in findall(rule_el, "ExposeHeader")],
        )
        age = rule_el.findtext("s3:MaxAgeSeconds", namespaces=ns) if ns else rule_el.findtext("MaxAgeSeconds")
        if age:
            rule.max_age = int(age)
        if not rule.origins or not rule.methods:
            raise CorsError("CORSRule needs AllowedOrigin and AllowedMethod")
        for m in rule.methods:
            if m not in ("GET", "PUT", "POST", "DELETE", "HEAD"):
                raise CorsError(f"invalid AllowedMethod {m}")
        rules.append(rule)
    if not rules:
        raise CorsError("CORSConfiguration carries no CORSRule")
    return rules


def serialize_cors(rules: list[CorsRule]) -> bytes:
    root = ET.Element("CORSConfiguration", xmlns=S3_XMLNS)
    for r in rules:
        rel = ET.SubElement(root, "CORSRule")
        for o in r.origins:
            ET.SubElement(rel, "AllowedOrigin").text = o
        for m in r.methods:
            ET.SubElement(rel, "AllowedMethod").text = m
        for h in r.headers:
            ET.SubElement(rel, "AllowedHeader").text = h
        for e in r.expose:
            ET.SubElement(rel, "ExposeHeader").text = e
        if r.max_age is not None:
            ET.SubElement(rel, "MaxAgeSeconds").text = str(r.max_age)
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def response_headers(
    rules: list[CorsRule], origin: str, method: str, request_headers: str = ""
) -> dict[str, str] | None:
    """Headers for a matched request, or None when no rule matches."""
    for rule in rules:
        if not rule.match(origin, method):
            continue
        allow_origin = "*" if "*" in rule.origins else origin
        out = {
            "Access-Control-Allow-Origin": allow_origin,
            "Access-Control-Allow-Methods": ", ".join(rule.methods),
        }
        if allow_origin != "*":
            out["Vary"] = "Origin"
        if rule.expose:
            out["Access-Control-Expose-Headers"] = ", ".join(rule.expose)
        if request_headers:
            wanted = [h.strip() for h in request_headers.split(",") if h.strip()]
            if "*" in rule.headers:
                allowed = wanted
            else:
                lower = {h.lower() for h in rule.headers}
                allowed = [h for h in wanted if h.lower() in lower]
                if len(allowed) != len(wanted):
                    continue  # a preflight asking for unallowed headers fails
            if allowed:
                out["Access-Control-Allow-Headers"] = ", ".join(allowed)
        if rule.max_age is not None:
            out["Access-Control-Max-Age"] = str(rule.max_age)
        return out
    return None
