"""The port's S3 authentication held against the JAX package's, on seeded
inputs: SigV4 signing keys, canonical URIs and queries, header signatures,
presigned URLs, aws-chunked chunk-signature chains and SigV2 (header and
presigned forms).  For every request each package's verifier gives the
same identity, or the same ``AccessDenied``, whichever package signed it;
and both signing clients emit the same bytes."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from seaweedfs_tpu.s3 import auth as jax_auth
from seaweedfs_tpu.s3 import client_sign as jax_sign
from seaweedfs_tpu.s3 import s3_server as jax_server
from seaweedfs_tpu.s3 import sigv2 as jax_v2
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.s3 import client_sign
from seaweedfs_tpu_torch.s3 import s3_server
from seaweedfs_tpu_torch.s3 import sigv2

NOW = 1_767_225_600.0  # 2026-01-01T00:00:00Z
HOST = "127.0.0.1:8333"
PKGS = {
    "port": (auth, client_sign, s3_server, sigv2),
    "jax": (jax_auth, jax_sign, jax_server, jax_v2),
}


class _Headers(dict):
    """Case-insensitive header map, as the gateway's request headers are."""

    def __init__(self, d):
        super().__init__({k.lower(): v for k, v in d.items()})

    def get(self, k, default=None):
        return super().get(k.lower(), default)

    def __getitem__(self, k):
        return super().__getitem__(k.lower())

    def __contains__(self, k):
        return super().__contains__(k.lower())


def _ids(pkg: str, secret: str = "s3cr3t"):
    mod = PKGS[pkg][0]
    return {"AKID": mod.Identity("AKID", secret, "admin"),
            "OTHER": mod.Identity("OTHER", "other-secret", "read")}


def _outcome(fn):
    try:
        ident = fn()
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome compared
        return type(e).__name__, str(e)
    return "ok", None if ident is None else (ident.access_key, ident.secret_key)


def _case(seed: int) -> dict:
    rng = np.random.default_rng([seed, 71])
    segs = ["".join(rng.choice(list("abcXYZ019-_.~ %+/é"), int(rng.integers(1, 8))))
            for _ in range(int(rng.integers(1, 4)))]
    path = "/bkt/" + "/".join(segs)
    params = [(f"k{int(rng.integers(0, 5))}", "".join(rng.choice(list("ab c=&/1"),
                                                                  int(rng.integers(0, 5)))))
              for _ in range(int(rng.integers(0, 4)))]
    import urllib.parse

    query = urllib.parse.urlencode(params)
    body = rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
    method = ["GET", "PUT", "POST", "DELETE", "HEAD"][int(rng.integers(0, 5))]
    extra = {"x-amz-meta-k": f"v{seed}"} if seed % 2 else {}
    return dict(path=urllib.parse.quote(path), query=query, body=body, method=method,
                extra=extra, now=NOW + int(rng.integers(0, 10 ** 6)))


@pytest.mark.parametrize("seed", range(12))
def test_signing_key_and_canonical_forms(seed):
    rng = np.random.default_rng([seed, 70])
    secret = rng.bytes(20).hex()
    date = f"2026{int(rng.integers(1, 13)):02d}{int(rng.integers(1, 29)):02d}"
    region = ["us-east-1", "eu-west-2", "ap-south-1"][seed % 3]
    assert auth.signing_key(secret, date, region, "s3") == \
        jax_auth.signing_key(secret, date, region, "s3")
    c = _case(seed)
    assert auth._canonical_uri(c["path"]) == jax_auth._canonical_uri(c["path"])
    assert auth._canonical_query(c["query"]) == jax_auth._canonical_query(c["query"])


@pytest.mark.parametrize("seed", range(16))
def test_header_signatures_verify_alike(seed):
    """Both clients sign to the same headers; each verifier accepts both,
    and a tampered body hash, secret, date or unknown key is refused by
    both with the same message."""
    c = _case(seed)
    signed = {}
    for pkg, (_a, sign, _s, _v) in PKGS.items():
        signed[pkg] = sign.sign_headers(c["method"], c["path"], c["query"], HOST, c["body"],
                                        "AKID", "s3cr3t", now=c["now"],
                                        extra_headers=c["extra"])
    assert signed["port"] == signed["jax"]
    payload = hashlib.sha256(c["body"]).hexdigest()
    variants = {
        "good": (signed["port"], payload, "AKID"),
        "tampered-payload": (signed["port"], hashlib.sha256(b"x" + c["body"]).hexdigest(),
                             "AKID"),
        "wrong-date": ({**signed["port"], "x-amz-date": "20200101T000000Z"}, payload, "AKID"),
        "unknown-key": ({**signed["port"], "Authorization": signed["port"]["Authorization"]
                         .replace("AKID/", "NOPE/")}, payload, "AKID"),
        "no-header": ({k: v for k, v in signed["port"].items() if k != "Authorization"},
                      payload, "AKID"),
    }
    for name, (hdrs, phash, _ak) in variants.items():
        got = {}
        for pkg, (mod, _c, _s, _v) in PKGS.items():
            verifier = mod.SigV4Verifier(_ids(pkg))
            headers = _Headers({"host": HOST, **c["extra"], **hdrs})
            got[pkg] = _outcome(lambda: verifier.verify(c["method"], c["path"], c["query"],
                                                        headers, phash))
        assert got["port"] == got["jax"], name
        assert (got["port"][0] == "ok") == (name == "good"), (name, got["port"])


@pytest.mark.parametrize("seed", range(8))
def test_presigned_urls_verify_alike(seed):
    c = _case(seed)
    urls = {pkg: sign.presign_url(c["method"], c["path"], HOST, "AKID", "s3cr3t",
                                  expires=600, now=NOW)
            for pkg, (_a, sign, _s, _v) in PKGS.items()}
    assert urls["port"] == urls["jax"]
    for name, query, now in (("fresh", urls["port"], NOW + 10),
                             ("expired", urls["port"], NOW + 601),
                             ("early", urls["port"], NOW - 3600),
                             ("tampered", urls["port"].replace("X-Amz-Expires=600",
                                                               "X-Amz-Expires=601"), NOW),
                             ("duplicate", "X-Amz-Expires=9&" + urls["port"], NOW)):
        got = {}
        for pkg, (mod, _c, _s, _v) in PKGS.items():
            verifier = mod.SigV4Verifier(_ids(pkg))
            got[pkg] = _outcome(lambda: verifier.verify_presigned(
                c["method"], c["path"], query, _Headers({"host": HOST}), now=now))
        assert got["port"] == got["jax"], name
        assert (got["port"][0] == "ok") == (name == "fresh"), (name, got["port"])


@pytest.mark.parametrize("seed", range(8))
def test_aws_chunked_chains_decode_alike(seed):
    """One aws-chunked body from both signers; each package's verifier and
    decoder take it, and a flipped byte, a dropped terminal chunk or a
    wrong decoded length is refused by both alike."""
    rng = np.random.default_rng([seed, 72])
    body = rng.integers(0, 256, int(rng.integers(0, 200_000)), dtype=np.uint8).tobytes()
    chunk = int(rng.choice([8 * 1024, 64 * 1024]))
    path = f"/bkt/obj{seed}.bin"
    framed = {}
    for pkg, (_a, sign, _s, _v) in PKGS.items():
        framed[pkg] = sign.sign_streaming("PUT", path, "", HOST, body, "AKID", "s3cr3t",
                                          chunk_size=chunk, now=NOW)
    assert framed["port"] == framed["jax"]
    headers, wire = framed["port"]
    flip = bytearray(wire)
    flip[len(flip) // 2] ^= 0x01
    terminal = wire.rindex(b"0;chunk-signature=")
    variants = {"good": (bytes(wire), len(body)), "flipped": (bytes(flip), len(body)),
                "no-terminal": (wire[:terminal], len(body)),
                "wrong-length": (bytes(wire), len(body) + 1)}
    for name, (raw, decoded) in variants.items():
        got = {}
        for pkg, (mod, _c, server, _v) in PKGS.items():
            verifier = mod.SigV4Verifier(_ids(pkg))

            def run():
                ctx = verifier.verify_context("PUT", path, "", _Headers({"host": HOST,
                                                                          **headers}),
                                              mod.STREAMING_PAYLOAD)
                out = server.decode_aws_chunked(raw, ctx, decoded)
                assert out == body
                return ctx.identity

            got[pkg] = _outcome(run)
        assert got["port"] == got["jax"], name
        assert (got["port"][0] == "ok") == (name == "good"), (name, got["port"])
    # open access only strips the framing
    assert s3_server.decode_aws_chunked(wire) == jax_server.decode_aws_chunked(wire) == body


@pytest.mark.parametrize("seed", range(8))
def test_sigv2_verifies_alike(seed):
    c = _case(seed)
    hdrs = {"Content-Type": "application/octet-stream", "x-amz-meta-a": "1",
            "Date": "Thu, 01 Jan 2026 00:00:00 GMT"}
    query = "acl=" if seed % 3 == 0 else ""
    signed = {pkg: v2.sign_v2_headers(c["method"], c["path"], query, hdrs, "AKID", "s3cr3t")
              for pkg, (_a, _c, _s, v2) in PKGS.items()}
    assert signed["port"] == signed["jax"]
    variants = {"good": (signed["port"], "AKID"),
                "wrong-secret": (sigv2.sign_v2_headers(c["method"], c["path"], query, hdrs, "AKID",
                                                       "bad"), "AKID"),
                "unknown": ({**signed["port"], "Authorization": signed["port"]["Authorization"]
                             .replace("AWS AKID:", "AWS NOPE:")}, "AKID"),
                "malformed": ({**signed["port"], "Authorization": "AWS nocolon"}, "AKID")}
    for name, (h, _ak) in variants.items():
        got = {pkg: _outcome(lambda: v2.verify_v2_header(_ids(pkg), c["method"], c["path"],
                                                         query, _Headers(h)))
               for pkg, (_a, _c, _s, v2) in PKGS.items()}
        assert got["port"] == got["jax"], name
        assert (got["port"][0] == "ok") == (name == "good"), (name, got["port"])
    q = sigv2.presign_v2(c["method"], c["path"], "AKID", "s3cr3t", expires_in=600)
    got = {pkg: _outcome(lambda: v2.verify_v2_presigned(_ids(pkg), c["method"], c["path"], q,
                                                        _Headers({})))
           for pkg, (_a, _c, _s, v2) in PKGS.items()}
    assert got["port"] == got["jax"] == ("ok", ("AKID", "s3cr3t"))
    assert sigv2.is_v2_presigned(q) and jax_v2.is_v2_presigned(q)
