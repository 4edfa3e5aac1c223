"""SelectObjectContent (query/select.py) and the browser form POST
(s3/post_policy.py) in the port, held against the JAX package's.

- ``execute_select`` gives the JAX package's bytes (or its error) for a
  list of queries over seeded JSON-lines and CSV inputs, and its rows equal
  a plain Python filter of the same data.
- ``post_policy`` reaches the same verdict as the JAX module on seeded
  forms: valid, expired, wrong bucket, key outside its prefix, a file
  outside the length range, an extra field, a bad signature, an unknown
  key, a missing file, a malformed condition.
- Through the gateways (each package's over its own filer on one port
  cluster): a signed form POST stores the object (201 with the JAX XML)
  and one that breaks a condition is refused 403; Select over a CSV and a
  JSON-lines object answers the same bytes from both.

Every server binds port 0 and every HTTP call has a timeout."""

from __future__ import annotations

import base64
import csv
import hashlib
import hmac
import http.client
import io
import json
import re
import shutil
import tempfile
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.query import select as jax_select
from seaweedfs_tpu.s3 import S3ApiServer as JaxS3
from seaweedfs_tpu.s3 import post_policy as jax_pp
from seaweedfs_tpu.s3.auth import Identity as JaxIdentity
from seaweedfs_tpu.server import filer_server as jax_fs
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.query import select
from seaweedfs_tpu_torch.s3 import S3ApiServer, client_sign
from seaweedfs_tpu_torch.s3 import post_policy as pp
from seaweedfs_tpu_torch.s3.auth import Identity, signing_key
from seaweedfs_tpu_torch.server import filer_server, master_server, volume_server
from seaweedfs_tpu_torch.wdclient import MasterClient

AK, SK = "AKIDSELECT", "select-secret"
WAIT_S = 60.0
HTTP_TIMEOUT = 30


# ---------------------------------------------------------------------------
# execute_select
# ---------------------------------------------------------------------------


def _rows(seed: int, n: int = 60) -> list[dict]:
    rng = np.random.default_rng(seed)
    cities = ["Oslo", "Lima", "Pune", "Kyiv", "Rome"]
    return [{"id": i, "name": f"n{int(rng.integers(0, 1000)):03d}",
             "age": int(rng.integers(18, 80)),
             "score": round(float(rng.random()) * 100, 2),
             "city": cities[int(rng.integers(0, len(cities)))],
             "zip": f"{int(rng.integers(0, 99999)):05d}",
             "tags": {"vip": bool(rng.random() < 0.3), "tier": int(rng.integers(1, 4))}}
            for i in range(n)]


def _jsonl(rows) -> bytes:
    return "".join(json.dumps(r) + "\n" for r in rows).encode()


def _csv(rows) -> bytes:
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(["id", "name", "age", "score", "city", "zip"])
    for r in rows:
        w.writerow([r["id"], r["name"], r["age"], r["score"], r["city"], r["zip"]])
    return buf.getvalue().encode()


QUERIES = [
    ("json", "SELECT * FROM S3Object", {}),
    ("json", "SELECT s.name, s.age FROM S3Object s WHERE s.age > 40", {}),
    ("json", "select s.tags.tier from s3object[*] s where s.city = 'Oslo' limit 3", {}),
    ("json", "SELECT s.id FROM S3Object s WHERE s.tags.vip = true", {"output_format": "csv"}),
    ("json", "SELECT * FROM S3Object s WHERE s.score <= 12.5", {"output_format": "csv"}),
    ("json", "SELECT s.name FROM S3Object s WHERE s.nope != 1 LIMIT 4", {}),
    ("json", "SELECT name FROM S3Object WHERE age >= 70", {}),
    ("json", "DELETE FROM S3Object", {}),
    ("json", "SELECT s.a FROM S3Object s WHERE s.a ~ 3", {}),
    ("csv", "SELECT * FROM S3Object", {"file_header_info": "USE"}),
    ("csv", "SELECT s.name, s.zip FROM S3Object s WHERE s.age < 30",
     {"file_header_info": "USE"}),
    ("csv", "SELECT s.city FROM S3Object s WHERE s.city <> 'Rome' LIMIT 5",
     {"file_header_info": "USE", "output_format": "json"}),
    ("csv", "SELECT _1, _3 FROM S3Object WHERE _3 > 50", {"file_header_info": "IGNORE"}),
    ("csv", "SELECT * FROM S3Object LIMIT 2", {}),
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
@pytest.mark.parametrize("seed", [7, 8])
def test_execute_select_matches_jax(i, seed):
    fmt, sql, kw = QUERIES[i]
    rows = _rows(seed)
    body = _jsonl(rows) if fmt == "json" else _csv(rows)
    got = {}
    for name, mod in (("port", select), ("jax", jax_select)):
        try:
            got[name] = mod.execute_select(sql, body, input_format=fmt, **kw)
        except mod.SelectError as e:
            got[name] = ("SelectError", str(e))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [7, 8])
def test_select_rows_equal_a_plain_filter(seed):
    rows = _rows(seed)
    out = select.execute_select("SELECT s.id, s.city FROM S3Object s WHERE s.age > 40",
                                _jsonl(rows))
    want = [{"id": r["id"], "city": r["city"]} for r in rows if r["age"] > 40]
    assert [json.loads(line) for line in out.decode().splitlines()] == want
    out = select.execute_select("SELECT s.name, s.zip FROM S3Object s WHERE s.city = 'Oslo'",
                                _csv(rows), input_format="csv", file_header_info="USE")
    # CSV cells stay text unless they are canonical numbers ('00420' stays)
    assert out.decode().splitlines() == [
        f"{r['name']},{int(r['zip']) if not r['zip'].startswith('0') else r['zip']}"
        for r in rows if r["city"] == "Oslo"]


# ---------------------------------------------------------------------------
# post_policy verdicts
# ---------------------------------------------------------------------------

DATE = "20260101"
CRED = f"{AK}/{DATE}/us-east-1/s3/aws4_request"


def _policy(conditions, expiration="2099-01-01T00:00:00Z") -> str:
    return base64.b64encode(json.dumps({"expiration": expiration,
                                        "conditions": conditions}).encode()).decode()


def _sign(policy_b64: str, secret: str = SK) -> str:
    return hmac.new(signing_key(secret, DATE, "us-east-1", "s3"), policy_b64.encode(),
                    hashlib.sha256).hexdigest()


def _fields(bucket: str, key: str, conditions, **over) -> dict[str, str]:
    pol = over.pop("policy", None) or _policy(conditions, over.pop("expiration",
                                                                   "2099-01-01T00:00:00Z"))
    f = {"key": key, "x-amz-algorithm": "AWS4-HMAC-SHA256", "x-amz-credential": CRED,
         "x-amz-date": f"{DATE}T000000Z", "policy": pol,
         "x-amz-signature": _sign(pol, over.pop("secret", SK))}
    f.update(over)
    return f


def _form(fields: dict[str, str], filename: str | None, data: bytes) -> tuple[str, bytes]:
    boundary = "----weedtpu16"
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                     f"{v}\r\n".encode())
    if filename is not None:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                     f'filename="{filename}"\r\nContent-Type: application/octet-stream'
                     f"\r\n\r\n".encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


def _cases(seed: int):
    rng = np.random.default_rng(seed)
    data = rng.bytes(int(rng.integers(100, 5000)))
    ok = [{"bucket": "pb"}, ["starts-with", "$key", "up/"], ["content-length-range", 1, 8192]]
    return data, [
        ("valid", _fields("pb", "up/${filename}", ok), "f.bin"),
        ("expired", _fields("pb", "up/a", ok, expiration="2001-01-01T00:00:00Z"), "f.bin"),
        ("wrong-bucket", _fields("pb", "up/a", [{"bucket": "other"}, ok[1], ok[2]]), "f.bin"),
        ("key-prefix", _fields("pb", "down/a", ok), "f.bin"),
        ("too-big", _fields("pb", "up/a", [ok[0], ok[1], ["content-length-range", 1, 10]]),
         "f.bin"),
        ("extra-field", _fields("pb", "up/a", ok, **{"Content-Type": "text/html"}), "f.bin"),
        ("covered-field", _fields("pb", "up/a", ok + [["eq", "$Content-Type", "text/plain"]],
                                  **{"Content-Type": "text/plain"}), "f.bin"),
        ("bad-signature", _fields("pb", "up/a", ok, secret="wrong"), "f.bin"),
        ("unknown-key", {**_fields("pb", "up/a", ok),
                         "x-amz-credential": f"AKNOPE/{DATE}/us-east-1/s3/aws4_request"}, "f.bin"),
        ("no-file", _fields("pb", "up/a", ok), None),
        ("malformed", _fields("pb", "up/a", ok + [["content-length-range", "x", 5]]), "f.bin"),
        ("no-bucket-cond", _fields("pb", "up/a", ok[1:]), "f.bin"),
    ]


def _verdict(mod, identity_cls, ctype, body, bucket="pb") -> tuple:
    idents = {AK: identity_cls(AK, SK, "admin")}
    try:
        fields, filename, data = mod.parse_form(ctype, body)
        key = mod.resolve_key(fields, filename)
        ident = mod.verify_signature(fields, idents)
        mod.check_policy(fields, bucket, key, len(data))
        return ("ok", key, ident.access_key, hashlib.sha256(data).hexdigest())
    except Exception as e:  # noqa: BLE001 — the verdict is the result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [3, 4])
def test_post_policy_verdicts_match_jax(seed):
    from seaweedfs_tpu_torch.s3.auth import Identity as PortIdentity

    data, cases = _cases(seed)
    verdicts = {}
    for name, fields, filename in cases:
        ctype, body = _form(fields, filename, data)
        port = _verdict(pp, PortIdentity, ctype, body)
        jax = _verdict(jax_pp, JaxIdentity, ctype, body)
        assert port == jax, name
        verdicts[name] = port[0]
    assert verdicts["valid"] == verdicts["covered-field"] == "ok"
    assert verdicts["malformed"] == verdicts["no-file"] == "PolicyError"
    assert {verdicts[k] for k in ("expired", "wrong-bucket", "key-prefix", "too-big",
                                  "extra-field", "bad-signature", "unknown-key",
                                  "no-bucket-cond")} == {"AccessDenied"}
    assert _verdict(pp, PortIdentity, "text/plain", b"x") == \
        _verdict(jax_pp, JaxIdentity, "text/plain", b"x")


# ---------------------------------------------------------------------------
# through the gateways
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gateways():
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("SEAWEEDFS_TPU_NATIVE_PX", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-s3sp-")
    started = []
    try:
        master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        master.start()
        started.append(master)
        vs = volume_server.VolumeServer([root], master.grpc_address, port=0, grpc_port=0,
                                        heartbeat_interval=0.2, device="cpu")
        vs.start()
        started.append(vs)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not master.topology.nodes:
            time.sleep(0.05)
        gws = {}
        for pkg, fs_mod in (("port", filer_server), ("jax", jax_fs)):
            fs = fs_mod.FilerServer(master.grpc_address, port=0, grpc_port=0)
            fs.start()
            started.append(fs)
            if pkg == "port":
                gw = S3ApiServer(master.grpc_address, port=0,
                                 filer=RemoteFiler(fs.grpc_address, MasterClient(
                                     master.grpc_address)),
                                 identities={AK: Identity(AK, SK, "admin")},
                                 lifecycle_sweep_interval=0, credential_refresh=0,
                                 chunk_cache_mb=0)
            else:
                gw = JaxS3(master.grpc_address, port=0,
                           filer=JaxRemoteFiler(fs.grpc_address, JaxMasterClient(
                               master.grpc_address)),
                           identities={AK: JaxIdentity(AK, SK, "admin")},
                           lifecycle_sweep_interval=0, credential_refresh=0, chunk_cache_mb=0)
            gw.start()
            started.append(gw)
            gws[pkg] = gw
        yield gws
    finally:
        for s in reversed(started):
            s.stop()
        shutil.rmtree(root, ignore_errors=True)
        mp.undo()


def _req(addr, method, path, query="", body=b"", headers=None, signed=True):
    hdrs = dict(headers or {})
    if signed:
        hdrs.update(client_sign.sign_headers(method, path, query, addr, body, AK, SK))
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    try:
        conn.request(method, path + (f"?{query}" if query else ""), body=body or None,
                     headers=hdrs)
        resp = conn.getresponse()
        data = re.sub(rb"<RequestId>[^<]*</RequestId>", b"", resp.read())
        return resp.status, data, resp.getheader("Content-Type"), resp.getheader("ETag")
    finally:
        conn.close()


def _select_xml(expr: str, csv_in: bool, header: str = "USE", out: str = "JSON") -> bytes:
    inp = (f"<CSV><FileHeaderInfo>{header}</FileHeaderInfo></CSV>" if csv_in
           else "<JSON><Type>LINES</Type></JSON>")
    return (f'<SelectObjectContentRequest xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Expression>{expr}</Expression><ExpressionType>SQL</ExpressionType>"
            f"<InputSerialization>{inp}</InputSerialization>"
            f"<OutputSerialization><{out}/></OutputSerialization>"
            f"</SelectObjectContentRequest>").encode()


def test_gateway_post_and_select_match_jax(gateways):
    rows = _rows(11, 200)
    data, cases = _cases(5)
    got = {}
    for pkg, gw in gateways.items():
        addr = gw.url
        out = [_req(addr, "PUT", "/pb")[0]]
        for name, fields, filename in cases:
            if name == "valid":
                fields = {**fields, "success_action_status": "201"}
                fields["policy"] = _policy([{"bucket": "pb"}, ["starts-with", "$key", "up/"],
                                            ["content-length-range", 1, 8192],
                                            {"success_action_status": "201"}])
                fields["x-amz-signature"] = _sign(fields["policy"])
            ctype, body = _form(fields, filename, data)
            out.append((name,) + _req(addr, "POST", "/pb", body=body,
                                      headers={"Content-Type": ctype}, signed=False)[:3])
        out.append(_req(addr, "GET", "/pb/up/f.bin")[:2])
        out.append(_req(addr, "PUT", "/pb/rows.csv", body=_csv(rows))[0])
        out.append(_req(addr, "PUT", "/pb/rows.json", body=_jsonl(rows))[0])
        for key, xml in (
                ("rows.csv", _select_xml("SELECT s.name, s.age FROM S3Object s WHERE "
                                         "s.age &gt; 60", True)),
                ("rows.csv", _select_xml("SELECT * FROM S3Object LIMIT 3", True, "NONE",
                                         "CSV")),
                ("rows.json", _select_xml("SELECT s.city, s.tags.tier FROM S3Object s "
                                          "WHERE s.tags.vip = true", False)),
                ("rows.json", _select_xml("SELECT s.id FROM S3Object s WHERE s.age &lt; 25",
                                          False, out="CSV")),
                ("rows.json", _select_xml("UPDATE S3Object", False)),
                ("rows.json", b"<SelectObjectContentRequest/>")):
            out.append(_req(addr, "POST", f"/pb/{key}", "select=&select-type=2", xml)[:3])
        got[pkg] = out
    assert got["port"] == got["jax"]
    out = got["port"]
    verdicts = {row[0]: row[1] for row in out[1:1 + len(cases)]}
    assert verdicts["valid"] == 201 and verdicts["covered-field"] == 204
    assert verdicts["wrong-bucket"] == verdicts["bad-signature"] == 403
    assert verdicts["no-file"] == verdicts["malformed"] == 400
    assert b"<Key>up/f.bin</Key>" in out[1][2]
    assert out[1 + len(cases)] == (200, data)
    sel = out[-6:]
    want = [{"name": r["name"], "age": r["age"]} for r in rows if r["age"] > 60]
    assert sel[0][0] == 200 and [json.loads(x) for x in sel[0][1].splitlines()] == want
    assert sel[1][1].decode().splitlines()[0].startswith("id,name,age")
    assert [json.loads(x) for x in sel[2][1].splitlines()] == [
        {"city": r["city"], "tags": {"tier": r["tags"]["tier"]}} for r in rows
        if r["tags"]["vip"]]
    assert sel[3][1].decode().split() == [str(r["id"]) for r in rows if r["age"] < 25]
    assert sel[4][0] == 400 and b"InvalidTextRepresentation" in sel[4][1]
    assert sel[5][0] == 400 and b"MissingRequiredParameter" in sel[5][1]
