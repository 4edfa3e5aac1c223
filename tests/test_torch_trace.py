"""The port's tracing layer (stats/trace.py) held against the JAX package's.

- ``parse_traceparent`` gives the same context (or None) for the same
  header values, and ``to_traceparent``, ``inject_headers``,
  ``grpc_metadata`` and ``extract_headers`` the same forms.
- The same finished spans render the same ``/debug/tracez`` text and
  JSON rows; ``SEAWEEDFS_TPU_TRACE=0`` stops recording in both, and
  ``stream_span`` installs its context only while the iterator runs.
- Across packages, in one process: a JAX client's span context, sent as
  gRPC metadata by the JAX stub or as an HTTP ``traceparent`` header,
  becomes the parent of the port volume server's span (``VolumeStatus``,
  ``write``, ``read``), and a port client's context the parent of the JAX
  server's; the port gateway's request span, its chunk upload and the
  volume server's ``write`` span form one tree; the access log carries the
  trace id; ``cli shell -c`` under ``$TRACEPARENT`` roots the servers'
  spans in the shell's.

Comparison: equality of the parsed tuples, the header and metadata forms,
the rendered text and the span rows; no tolerance.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import tempfile
import time

import grpc
import pytest

from seaweedfs_tpu import rpc as jax_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.stats import trace as jax_trace
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.stats import trace

WAIT_S = 30.0
TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"

HEADERS = [
    f"00-{TID}-{SID}-01",
    f"00-{TID}-{SID}-00",
    f"00-{TID.upper()}-{SID}-01",
    f"  00-{TID}-{SID}-03  ",
    f"01-{TID}-{SID}-01",
    f"00-{'0' * 32}-{SID}-01",
    f"00-{TID}-{'0' * 16}-01",
    f"00-{TID}-{SID}",
    f"00-{TID[:-1]}-{SID}-01",
    f"00-{TID}-{SID}-0x",
    "",
    None,
    "garbage",
]


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _ctx_tuple(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled)


@pytest.mark.parametrize("value", HEADERS)
def test_parse_traceparent_equal(value):
    got = _ctx_tuple(trace.parse_traceparent(value))
    assert got == _ctx_tuple(jax_trace.parse_traceparent(value))
    if got is not None:
        assert trace.SpanContext(*got).to_traceparent() == \
            jax_trace.SpanContext(*got).to_traceparent()


@pytest.mark.parametrize("sampled", [True, False])
def test_header_and_metadata_forms_equal(sampled):
    ctx, jctx = trace.SpanContext(TID, SID, sampled), jax_trace.SpanContext(TID, SID, sampled)
    assert trace.inject_headers({"a": "b"}, ctx) == jax_trace.inject_headers({"a": "b"}, jctx)
    assert trace.grpc_metadata(ctx) == jax_trace.grpc_metadata(jctx)
    assert trace.grpc_metadata() == jax_trace.grpc_metadata() == []
    assert trace.inject_headers() == jax_trace.inject_headers() == {}
    for headers in ({"traceparent": ctx.to_traceparent()},
                    {"Traceparent": ctx.to_traceparent()}, {}, None):
        assert _ctx_tuple(trace.extract_headers(headers)) == \
            _ctx_tuple(jax_trace.extract_headers(headers))


def _same_spans(mod, n: int = 6):
    """A buffer of ``n`` spans in two traces with fixed ids and times."""
    buf = mod.TraceBuffer(capacity=4)
    for i in range(n):
        tid = TID if i % 2 else "a" * 32
        parent = "" if i < 2 else f"{i - 2:016x}"
        buf.record(mod.Span(trace_id=tid, span_id=f"{i:016x}", parent_id=parent,
                            name=f"op{i}", service="svc", start=1_700_000_000.0 + i * 0.25,
                            duration_s=0.001 * (i + 1), status="error" if i == 3 else "ok",
                            attrs={"i": i} if i % 3 else {}))
    return buf


@pytest.mark.parametrize("trace_id", [None, TID, "a" * 32, "f" * 32])
def test_buffer_render_equal(trace_id):
    port, jax = _same_spans(trace), _same_spans(jax_trace)
    assert len(port.spans()) == 4  # the ring kept the newest
    assert port.render_text(trace_id) == jax.render_text(trace_id)
    assert port.to_dicts(trace_id) == jax.to_dicts(trace_id)
    assert port.render_text(trace_id, limit=1) == jax.render_text(trace_id, limit=1)


def test_span_tree_and_disable(monkeypatch):
    for mod in (trace, jax_trace):
        buf = mod.TraceBuffer()
        with mod.span("outer", "svc", buffer=buf) as outer:
            assert mod.current().span_id == outer.span_id
            with mod.span("inner", "svc", buffer=buf) as inner:
                pass
            with pytest.raises(RuntimeError):
                with mod.span("bad", "svc", buffer=buf):
                    raise RuntimeError("boom")
        assert mod.current() is None
        rows = {r["name"]: r for r in buf.to_dicts()}
        assert inner.parent_id == outer.span_id and inner.trace_id == outer.trace_id
        assert rows["bad"]["status"] == "error" and rows["outer"]["parent_id"] == ""
        monkeypatch.setenv("SEAWEEDFS_TPU_TRACE", "0")
        with mod.span("off", "svc", buffer=buf):
            pass
        mod.record_foreign_span(TID, SID, "foreign", "svc", 0.0, 0.0, buffer=buf)
        assert "off" not in {r["name"] for r in buf.to_dicts()}
        assert "foreign" not in {r["name"] for r in buf.to_dicts()}
        monkeypatch.delenv("SEAWEEDFS_TPU_TRACE")


def test_stream_span_context_only_while_iterating():
    for mod in (trace, jax_trace):
        buf = mod.TraceBuffer()
        seen = []

        def gen():
            for i in range(3):
                seen.append(mod.current())
                yield i

        parent = mod.SpanContext(TID, SID)
        it = mod.stream_span(gen, "stream", "svc", parent=parent, buffer=buf)
        assert next(it) == 0
        assert mod.current() is None  # suspended: no leak onto this thread
        assert list(it) == [1, 2]
        assert {c.trace_id for c in seen} == {TID} and len({c.span_id for c in seen}) == 1
        (row,) = buf.to_dicts()
        assert row["parent_id"] == SID and row["name"] == "stream"


# -- across packages --------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """A port master and volume server (``device="cpu"``) and a JAX master
    and volume server, each pair a cluster of its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
    mp.setenv("WEED_SCRUB_INTERVAL", "0")
    root = tempfile.mkdtemp(prefix="torch-trace-")
    made = []
    try:
        pm = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        pm.start()
        made.append(pm)
        pv = volume_server.VolumeServer([os.path.join(root, "p")], pm.grpc_address, port=0,
                                        grpc_port=0, heartbeat_interval=0.2, device="cpu")
        os.makedirs(os.path.join(root, "p"), exist_ok=True)
        pv.start()
        made.append(pv)
        jm = jax_ms.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
        jm.start()
        made.append(jm)
        os.makedirs(os.path.join(root, "j"), exist_ok=True)
        jv = jax_vs.VolumeServer([os.path.join(root, "j")], jm.grpc_address, port=0,
                                 grpc_port=0, heartbeat_interval=0.2)
        jv.start()
        made.append(jv)
        _wait(lambda: len(pm.topology.nodes) == 1 and len(jm.topology.nodes) == 1,
              "both heartbeats")
        yield dict(port_master=pm, port_vs=pv, jax_master=jm, jax_vs=jv, root=root)
    finally:
        for s in reversed(made):
            s.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _spans(mod, trace_id: str) -> list[dict]:
    return mod.default_buffer.to_dicts(trace_id)


def test_jax_client_joins_port_grpc_span(servers):
    addr = f"127.0.0.1:{servers['port_vs'].grpc_port}"
    with jax_trace.span("client", "jax") as sp:
        try:
            jax_rpc.volume_stub(addr).VolumeStatus(jax_vs_pb.VolumeStatusRequest(volume_id=0))
        except Exception:  # noqa: BLE001 — the span is the point, not the answer
            pass
    rows = _spans(trace, sp.trace_id)
    assert [(r["name"], r["service"], r["parent_id"]) for r in rows] == \
        [("VolumeStatus", "volume", sp.span_id)]


def test_port_client_joins_jax_grpc_span(servers):
    addr = f"127.0.0.1:{servers['jax_vs'].grpc_port}"
    with trace.span("client", "port") as sp:
        try:
            rpc.volume_stub(addr).VolumeStatus(vs_pb.VolumeStatusRequest(volume_id=0))
        except Exception:  # noqa: BLE001
            pass
    rows = _spans(jax_trace, sp.trace_id)
    assert [(r["name"], r["service"], r["parent_id"]) for r in rows] == \
        [("VolumeStatus", "volume", sp.span_id)]


def test_untraced_grpc_call_records_no_server_span(servers):
    before = len(trace.default_buffer.spans())
    with pytest.raises(grpc.RpcError) as e:
        rpc.volume_stub(f"127.0.0.1:{servers['port_vs'].grpc_port}").VolumeStatus(
            vs_pb.VolumeStatusRequest(volume_id=0))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    assert len(trace.default_buffer.spans()) == before


def test_http_traceparent_joins_volume_write_and_read(servers):
    from seaweedfs_tpu_torch.wdclient import MasterClient

    mc = MasterClient(servers["port_master"].grpc_address)
    fid, url, _auth = mc.assign_batch(1)[0]
    with jax_trace.span("client", "jax") as sp:
        headers = jax_trace.inject_headers({"X-Request-ID": "req-1"})
        host, port = url.split(":")
        for method, body in (("POST", b"traced payload"), ("GET", b"")):
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            conn.request(method, f"/{fid}", body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            assert resp.status in (200, 201), data
            assert resp.getheader("X-Request-ID") == "req-1"
            conn.close()
    # a server span is recorded when its handler returns, just after the reply
    _wait(lambda: len(_spans(trace, sp.trace_id)) == 2, "both server spans")
    rows = _spans(trace, sp.trace_id)
    assert sorted((r["name"], r["service"], r["parent_id"]) for r in rows) == \
        [("read", "volume", sp.span_id), ("write", "volume", sp.span_id)]


def test_gateway_put_is_one_tree(servers, tmp_path):
    """The port gateway's PutObject span roots the chunk upload, whose
    traceparent the volume server's write span joins; the access log
    carries the trace id."""
    from seaweedfs_tpu_torch.s3 import S3ApiServer

    log = str(tmp_path / "access.log")
    gw = S3ApiServer(servers["port_master"].grpc_address, port=0, chunk_size=4096,
                     lifecycle_sweep_interval=0, credential_refresh=0, access_log=log)
    gw.start()
    try:
        host, port = gw.url.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request("PUT", "/tracebkt")
        conn.getresponse().read()
        parent = trace.SpanContext(TID, "1" * 16)
        conn.request("PUT", "/tracebkt/obj.bin", body=os.urandom(3000),
                     headers=trace.inject_headers({}, parent))
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        conn.close()
        _wait(lambda: {"PutObject", "put_chunk", "write"}
              <= {r["name"] for r in _spans(trace, TID)}, "the PUT's spans")
    finally:
        gw.stop()
    rows = {r["span_id"]: r for r in _spans(trace, TID)}
    (put,) = [r for r in rows.values() if r["name"] == "PutObject"]
    assert put["parent_id"] == "1" * 16 and put["service"] == "s3"
    (chunk,) = [r for r in rows.values() if r["name"] == "put_chunk"]
    assert chunk["parent_id"] == put["span_id"]
    (write,) = [r for r in rows.values() if r["name"] == "write"]
    assert write["parent_id"] == chunk["span_id"] and write["service"] == "volume"
    lines = open(log).read().splitlines()
    assert lines[-1].split()[-1] == TID and lines[0].split()[-1] != "-"


def test_tracez_pages_equal_shape(servers):
    from seaweedfs_tpu.util import debugz as jax_debugz
    from seaweedfs_tpu_torch.util import debugz

    for mod, dz in ((trace, debugz), (jax_trace, jax_debugz)):
        with mod.span("page", "svc"):
            pass
    code, body = debugz.handle(f"/debug/tracez?json=1&trace_id={'0' * 32}")
    jcode, jbody = jax_debugz.handle(f"/debug/tracez?json=1&trace_id={'0' * 32}")
    assert (code, json.loads(body)) == (jcode, json.loads(jbody)) == (200, [])
    code, body = debugz.handle("/debug/tracez?limit=1")
    assert code == 200 and body.startswith(b"trace ")


def test_shell_traceparent_joins_the_servers_spans(servers, monkeypatch):
    """``cli shell -c`` with ``$TRACEPARENT`` runs each command in a shell
    span of that trace: the volume server's VolumeStatus span (cluster.check
    probes every node) is its child."""
    from seaweedfs_tpu_torch import cli

    tid = "5" * 32
    monkeypatch.setenv("TRACEPARENT", f"00-{tid}-{'6' * 16}-01")
    assert cli.main(["shell", "-master", servers["port_master"].grpc_address,
                     "-c", "cluster.check"]) == 0
    rows = {r["span_id"]: r for r in _spans(trace, tid)}
    (shell_span,) = [r for r in rows.values() if r["service"] == "shell"]
    assert shell_span["name"] == "cluster.check" and shell_span["parent_id"] == "6" * 16
    assert [r["parent_id"] for r in rows.values() if r["name"] == "VolumeStatus"] == \
        [shell_span["span_id"]]
