"""SSE and the KMS, the port against the JAX package: under one
``LocalKms`` key file each package decrypts the other's SSE-S3, SSE-KMS
and SSE-C objects (single PUTs and multipart parts), both refuse a wrong
customer key or an unknown KMS key alike, an OpenBao transit server on
localhost serves both packages' ``OpenBaoKms``, ``make_kms`` gives the
same refusals, and without the ``cryptography`` package both answer the
same 501."""

from __future__ import annotations

import base64
import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from seaweedfs_tpu.s3 import sse as jax_sse
from seaweedfs_tpu.security import kms as jax_kms
from seaweedfs_tpu_torch.s3 import sse
from seaweedfs_tpu_torch.security import kms

PKGS = {"port": (sse, kms), "jax": (jax_sse, jax_kms)}


class _Headers(dict):
    def __init__(self, d):
        super().__init__({k.lower(): v for k, v in d.items()})

    def get(self, k, default=None):
        return super().get(k.lower(), default)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome compared
        return type(e).__name__, str(e), getattr(e, "status", None), getattr(e, "code", None)


def _customer(key: bytes) -> dict:
    return {sse.HDR_CUSTOMER_ALGO: "AES256",
            sse.HDR_CUSTOMER_KEY: base64.b64encode(key).decode(),
            sse.HDR_CUSTOMER_KEY_MD5: base64.b64encode(hashlib.md5(key).digest()).decode()}


@pytest.fixture
def key_file(tmp_path):
    path = str(tmp_path / "kms.json")
    k = kms.LocalKms(path)
    k.create_key("default")
    k.create_key("tenant-a")
    return path


def _kmses(path: str) -> dict:
    return {name: mods[1].LocalKms(path) for name, mods in PKGS.items()}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["sse-s3", "sse-kms", "sse-c"])
def test_single_put_objects_decrypt_across_packages(seed, mode, key_file):
    rng = np.random.default_rng([seed, 90])
    body = rng.integers(0, 256, int(rng.integers(0, 300_000)), dtype=np.uint8).tobytes()
    ckey = rng.bytes(32)
    put_hdrs = {"sse-s3": {sse.HDR_SSE: "AES256"},
                "sse-kms": {sse.HDR_SSE: "aws:kms", sse.HDR_KMS_KEY_ID: "tenant-a"},
                "sse-c": _customer(ckey)}[mode]
    get_hdrs = _customer(ckey) if mode == "sse-c" else {}
    kmses = _kmses(key_file)
    for writer in PKGS:
        smod = PKGS[writer][0]
        sealed, meta, resp = smod.encrypt_for_put(_Headers(put_hdrs), body, kmses[writer])
        assert sealed != body or not body
        for reader in PKGS:
            rmod = PKGS[reader][0]
            plain, hdrs = rmod.decrypt_for_get(_Headers(get_hdrs), meta, sealed, kmses[reader])
            assert plain == body, (writer, reader)
            assert rmod.is_encrypted(meta) and rmod.display_size(meta, len(sealed)) == len(body)
            assert rmod.head_headers(_Headers(get_hdrs), meta) == \
                PKGS["jax" if reader == "port" else "port"][0].head_headers(_Headers(get_hdrs),
                                                                            meta)
        other = {k: v for k, v in resp.items()}
        assert other == PKGS["jax" if writer == "port" else "port"][0].encrypt_for_put(
            _Headers(put_hdrs), body, kmses["jax" if writer == "port" else "port"])[2]
    # refusals: a wrong customer key, a missing one, a tampered body
    sealed, meta, _r = sse.encrypt_for_put(_Headers(put_hdrs), body, kmses["port"])
    bad_variants = {"wrong-key": (_customer(bytes(32)), sealed),
                    "no-key": ({}, sealed),
                    "tampered": (get_hdrs, sealed[:-1] + bytes([sealed[-1] ^ 1]))}
    for name, (hdrs, blob) in bad_variants.items():
        got = {r: _outcome(lambda: PKGS[r][0].decrypt_for_get(_Headers(hdrs), meta, blob,
                                                              kmses[r])[0] == body)
               for r in PKGS}
        assert got["port"] == got["jax"], name


@pytest.mark.parametrize("mode", ["sse-s3", "sse-c"])
def test_multipart_parts_decrypt_across_packages(mode, key_file):
    rng = np.random.default_rng(91)
    parts = [rng.bytes(int(n)) for n in (70_000, 5, 120_000)]
    ckey = rng.bytes(32)
    create = {sse.HDR_SSE: "AES256"} if mode == "sse-s3" else _customer(ckey)
    part_hdrs = {} if mode == "sse-s3" else _customer(ckey)
    kmses = _kmses(key_file)
    for writer in PKGS:
        smod = PKGS[writer][0]
        up = smod.upload_sse_meta(_Headers(create), kmses[writer])
        sealed, metas = zip(*(smod.encrypt_part(up, _Headers(part_hdrs), p, kmses[writer])
                              for p in parts))
        for reader in PKGS:
            rmod = PKGS[reader][0]
            meta = rmod.completed_sse_meta(up, list(metas), [len(s) for s in sealed])
            assert meta == PKGS[writer][0].completed_sse_meta(up, list(metas),
                                                              [len(s) for s in sealed])
            plain, _h = rmod.decrypt_for_get(_Headers(part_hdrs), meta, b"".join(sealed),
                                             kmses[reader])
            assert plain == b"".join(parts), (writer, reader)


def test_kms_request_refusals_alike(key_file):
    kmses = _kmses(key_file)
    for hdrs in ({sse.HDR_SSE: "aws:kms", sse.HDR_KMS_KEY_ID: "nope"},
                 {sse.HDR_SSE: "rot13"},
                 {sse.HDR_CUSTOMER_ALGO: "DES"},
                 {**_customer(bytes(32)), sse.HDR_CUSTOMER_KEY_MD5: "AAAA"},
                 {sse.HDR_CUSTOMER_ALGO: "AES256", sse.HDR_CUSTOMER_KEY: "short"}):
        got = {n: _outcome(lambda: PKGS[n][0].encrypt_for_put(_Headers(hdrs), b"x", kmses[n]))
               for n in PKGS}
        assert got["port"] == got["jax"] and got["port"][0] == "SseError", hdrs
    got = {n: _outcome(lambda: PKGS[n][0].encrypt_for_put(_Headers({sse.HDR_SSE: "AES256"}),
                                                          b"x", None)) for n in PKGS}
    assert got["port"] == got["jax"] and got["port"][2] == 501


def test_without_cryptography_both_answer_501(monkeypatch, key_file):
    for mod in (sse, jax_sse, kms, jax_kms):
        monkeypatch.setattr(mod, "AESGCM", None)
    for hdrs in ({sse.HDR_SSE: "AES256"}, _customer(bytes(range(32)))):
        got = {n: _outcome(lambda: PKGS[n][0].encrypt_for_put(_Headers(hdrs), b"x", None))
               for n in PKGS}
        assert got["port"] == got["jax"] and got["port"][2:] == (501, "NotImplemented")
    got = {n: _outcome(lambda: PKGS[n][1].LocalKms(key_file)) for n in PKGS}
    assert got["port"] == got["jax"] and got["port"][0] == "KmsError"
    # plaintext requests never touch the crypto
    assert sse.encrypt_for_put(_Headers({}), b"plain", None) == (b"plain", {}, {})


@pytest.mark.parametrize("spec", ["aws://us-east-1", "gcp://", "azure://v.vault.azure.net",
                                  "s3kms://x", "openbao://127.0.0.1:1/transit",
                                  "vault://127.0.0.1:1/transit?token=t0psecret"])
def test_make_kms_refusals_alike(spec, monkeypatch):
    for var in ("BAO_TOKEN", "VAULT_TOKEN", "BAO_TOKEN_FILE"):
        monkeypatch.delenv(var, raising=False)
    got = {n: _outcome(lambda: PKGS[n][1].make_kms(spec)) for n in PKGS}
    assert got["port"][:2] == got["jax"][:2] and got["port"][0] == "KmsError"
    assert "t0psecret" not in got["port"][1]


class _FakeTransit(BaseHTTPRequestHandler):
    """An OpenBao transit engine: datakey/plaintext wraps a fresh key as
    ``vault:v1:<b64>`` (XOR with a key-named pad), decrypt unwraps."""

    def log_message(self, *args):
        pass

    def _pad(self, name: str) -> bytes:
        return hashlib.sha256(name.encode()).digest()

    def _reply(self, code: int, doc: dict) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        ok = self.headers.get("X-Vault-Token") == "tok"
        self._reply(200 if ok else 403, {"data": {}})

    def do_POST(self):
        doc = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        parts = self.path.split("/")
        if self.headers.get("X-Vault-Token") != "tok":
            return self._reply(403, {"errors": ["permission denied"]})
        pad = self._pad(parts[-1])
        if "/datakey/plaintext/" in self.path:
            key = hashlib.sha256(self.path.encode() + str(id(doc)).encode()).digest()
            wrapped = bytes(a ^ b for a, b in zip(key, pad))
            return self._reply(200, {"data": {
                "plaintext": base64.b64encode(key).decode(),
                "ciphertext": "vault:v1:" + base64.b64encode(wrapped).decode()}})
        wrapped = base64.b64decode(doc["ciphertext"].split(":", 2)[2])
        return self._reply(200, {"data": {"plaintext": base64.b64encode(
            bytes(a ^ b for a, b in zip(wrapped, pad))).decode()}})


def test_openbao_kms_serves_both_packages(monkeypatch):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeTransit)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv("BAO_TOKEN", "tok")
        spec = f"openbao://127.0.0.1:{server.server_address[1]}/transit"
        kmses = {n: PKGS[n][1].make_kms(spec) for n in PKGS}
        assert all(type(k).__name__ == "OpenBaoKms" for k in kmses.values())
        body = np.random.default_rng(92).bytes(50_000)
        for writer in PKGS:
            sealed, meta, _r = PKGS[writer][0].encrypt_for_put(
                _Headers({sse.HDR_SSE: "AES256"}), body, kmses[writer])
            for reader in PKGS:
                plain, _h = PKGS[reader][0].decrypt_for_get(_Headers({}), meta, sealed,
                                                            kmses[reader])
                assert plain == body, (writer, reader)
        monkeypatch.setenv("BAO_TOKEN", "wrong")
        got = {n: _outcome(lambda: PKGS[n][1].make_kms(spec).generate_data_key("k"))
               for n in PKGS}
        assert got["port"] == got["jax"] and got["port"][0] == "KmsError"
    finally:
        server.shutdown()
        server.server_close()
