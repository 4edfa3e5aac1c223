"""Native gateway splice: chunk bodies relayed volume<->client by dp.cpp's
px verbs with zero CPython copies.  The port's copy of
seaweedfs_tpu/filer/splice.py, with its semantics and ladders.

The gateway keeps everything that needs Python — auth, entry lookup,
range math, replica choice — and hands the native library a client
socket + volume address + fid + byte range.  ``splice_entry`` serves a
GET body view-by-view (sparse gaps zero-filled from Python, which costs
nothing: gaps have no bytes to copy), with each view trying the
hot-chunk cache tier first (util/chunk_cache: a segment-tier hit relays
cache-file -> client via ``sw_px_cache_send`` sendfile — no upstream
connection, no volume-server read, ``x-weed-cache: 1``; a cacheable
miss fills single-flight); ``try_put_splice`` streams a PUT body of ANY
size chunk by chunk: every chunk fans out to ALL replica holders at
once (``sw_px_put_fanout``: tee(2)-forked splice pipe, acks batched
into one native completion, chunk N's acks settling under chunk N+1's
stream), with the object-wide MD5 ETag carried across the chunk calls
as a native midstate.

GET failure ladder per view (the reader's resilience semantics, without
the copies):

* nothing sent yet -> try the sibling replicas, then fall back to the
  pure-Python path (which has its own failover + re-lookup);
* upstream died mid-body -> fetch the remaining byte range through
  :func:`reader.fetch_chunk` (replica failover + invalidate-and-relookup)
  and finish the response from Python;
* client went away -> abort, connection closed.

PUT failure ladder per chunk (zero acked-write loss by construction —
the body is retained natively as it streams, and nothing is acked
unless EVERY holder acked):

* no holder reachable before any client byte moved -> fully replayable
  (first chunk: pushback + the whole Python path; later chunks: read
  the chunk here and replay via :func:`_ladder_put`);
* a holder died or rejected mid-fan-out -> the retained body replays
  through :func:`_ladder_put` (primary POST -> the volume server's own
  write-all replication);
* client went away -> abort, nothing acked.

TLS connections never splice (the native loop writes raw fds); the
whole path is opt-out via ``SEAWEEDFS_TPU_NATIVE_PX=0``.  Each ladder step
that leaves the native path is counted (``dataplane.px_stats()``'s
``ladder_*`` keys).
"""

from __future__ import annotations

import ssl
import threading
import time

from seaweedfs_tpu_torch.native import dataplane
from seaweedfs_tpu_torch.util import wlog

# bodies below this ride the Python path: the per-view native call +
# lookup bookkeeping only pays for itself once real bytes move
MIN_SPLICE_BYTES = 16 * 1024

_ZERO_BLOCK = bytes(64 * 1024)

_REASONS = {200: "OK", 206: "Partial Content"}

_addr_lock = threading.Lock()
_addr_cache: dict[str, tuple[str, float]] = {}
_ADDR_TTL = 60.0
# volume holders number in the hundreds, but the hostnames arrive from
# lookups a client's key choice drives: bound the map anyway; past the cap, expired entries sweep first, then the map resets
_ADDR_CAP = 1024


def available() -> bool:
    """The native splice verbs are loadable and not disabled by env."""
    return dataplane.px_lib() is not None


def _numeric_addr(url: str) -> str | None:
    """dp.cpp's connector speaks inet_pton only: resolve ``host:port`` to
    ``ipv4:port`` (TTL-cached — a rescheduled holder must stop resolving
    stale within a minute, not until restart)."""
    host, _, port = url.rpartition(":")
    if not host or not port:
        return None
    now = time.monotonic()
    with _addr_lock:
        cached = _addr_cache.get(host)
    if cached is None or now >= cached[1]:
        import ipaddress
        import socket as _socket

        try:
            ipaddress.IPv4Address(host)
            ip = host
        except ValueError:
            try:
                ip = _socket.getaddrinfo(
                    host, None, _socket.AF_INET, _socket.SOCK_STREAM
                )[0][4][0]
            except OSError:
                return None
        cached = (ip, now + _ADDR_TTL)
        with _addr_lock:
            if len(_addr_cache) >= _ADDR_CAP:
                for stale in [
                    h for h, (_ip, exp) in _addr_cache.items() if now >= exp
                ]:
                    del _addr_cache[stale]
                if len(_addr_cache) >= _ADDR_CAP:
                    _addr_cache.clear()
            _addr_cache[host] = cached
    return f"{cached[0]}:{port}"


def _client_fd(handler) -> int | None:
    """The raw client socket fd, or None when the native loop cannot
    write to it directly (TLS)."""
    conn = getattr(handler, "connection", None)
    if conn is None or isinstance(conn, ssl.SSLSocket):
        return None
    try:
        return conn.fileno()
    except OSError:
        return None


def _build_head(handler, status: int, ctype: str, length: int,
                headers: dict | None, marker: str = "spliced") -> bytes:
    """The full response head the native relay sends before the body —
    mirrors QuietHandler._reply's framing (Content-Length keep-alive,
    validated X-Request-ID echo) plus an attribution ``marker`` for A/B
    and the parity tests: ``spliced`` (the upstream splice relay),
    ``cache`` (the leading view is a hot-chunk cache hit — those bytes
    never rode an upstream splice), or ``""`` (a cache fill served from
    gateway memory with the native plane disabled: neither claim would
    be honest)."""
    from seaweedfs_tpu_torch.util.httpd import response_request_id

    lines = [
        f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
        f"Content-Type: {ctype}",
        f"Content-Length: {length}",
        f"X-Request-ID: {response_request_id(handler.headers)}",
    ]
    if marker:
        lines.append(f"x-weed-{marker}: 1")
    # headers the gateway grants every reply of this request (the S3
    # gateway's CORS headers), which _reply would have added
    for k, v in {**(getattr(handler, "_splice_headers", None) or {}), **(headers or {})}.items():
        lines.append(f"{k}: {v}")
    if handler.close_connection:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _send_zeros(sock, n: int) -> None:
    while n > 0:
        piece = min(n, len(_ZERO_BLOCK))
        sock.sendall(_ZERO_BLOCK[:piece])
        n -= piece


def splice_entry(handler, master, entry, status: int, lo: int, hi: int,
                 ctype: str, headers: dict | None, cache=None) -> bool:
    """Serve [lo, hi] of ``entry`` through the native plane.  Each view
    tries the hot-chunk cache first (``cache``: util/chunk_cache — a hit
    relays segment-file -> client via ``sw_px_cache_send`` with zero
    CPython copies and no upstream connection; a cacheable miss fills
    single-flight and serves from the fill), then the upstream splice
    ladder.  Returns True when the response was fully handled (headers
    included — possibly with a Python-side failover tail), False when
    nothing was sent and the caller should use the Python streaming
    path.

    Without a cache the gate is: native library + raw client fd + a body
    worth at least MIN_SPLICE_BYTES.  With one,
    small bodies and TLS/no-native deployments still serve cache hits
    and fills from gateway memory — the whole point of the tier is that
    the 4–64 KiB Haystack regime stops paying per-GET upstream costs."""
    from seaweedfs_tpu_torch.filer import reader as chunk_reader
    from seaweedfs_tpu_torch.filer.filechunks import read_chunk_views, visible_intervals

    want = hi - lo + 1
    if entry.content:
        return False
    native_ok = available()
    fd = _client_fd(handler)
    splice_ok = native_ok and fd is not None and want >= MIN_SPLICE_BYTES
    if not splice_ok and cache is None:
        return False
    try:
        chunks = chunk_reader.resolve_chunks(master, entry, cache)
        views = read_chunk_views(visible_intervals(chunks), lo, want)
    except Exception as e:  # noqa: BLE001 — resolution failed: Python path decides
        if wlog.V(1):
            wlog.info("splice: %s resolve failed, python path: %s", entry.full_path, e)
        dataplane.count_ladder("get_python")
        return False
    if not views:
        return False  # fully sparse: nothing worth splicing
    if not splice_ok and not any(
        cache.cacheable(v.size) for v in views
    ):
        return False  # nothing here the cache tier could ever serve
    lead = views[0]
    if cache is not None and cache.contains(
        lead.fid, lead.offset_in_chunk,
        lead.offset_in_chunk + lead.size - 1,
    ):
        marker = "cache"  # a warm hit: no upstream bytes at all
    elif cache is not None and cache.cacheable(lead.size):
        marker = ""  # a fill will serve from gateway memory, not a splice
    elif splice_ok:
        marker = "spliced"
    else:
        marker = ""
    head = _build_head(handler, status, ctype, want, headers, marker=marker)
    sock = handler.connection
    head_sent = False
    pos = lo
    end = hi + 1
    # wire-truth accounting for the caller's metrics/access log: bytes
    # DELIVERED (a floor — an abort inside a view loses that view's
    # partial count) and whether the response was cut short of
    # Content-Length.  Without this the gateway logs every aborted
    # splice as a complete 200 at full size.
    handler._px_sent = 0
    handler._px_aborted = False

    def _mark() -> None:
        # the native relay bypasses _reply, so the handler's recording
        # wrapper never sees the status — without this every spliced GET
        # lands in the per-action counters as code="0" with 0 bytes
        handler._last_status = status
        handler._resp_bytes = handler._px_sent

    try:
        for v in views:
            if v.logical_offset > pos:  # sparse gap before this view
                if not head_sent:
                    sock.sendall(head)
                    head_sent = True
                _send_zeros(sock, v.logical_offset - pos)
                pos = v.logical_offset
            if not _serve_view(handler, master, v,
                               head if not head_sent else b"", fd, cache,
                               splice_ok):
                if head_sent:
                    # headers are out: cutting the connection short of
                    # Content-Length is the only honest failure signal
                    # left (same contract as _reply_streamed)
                    handler._px_sent = pos - lo
                    handler._px_aborted = True
                    handler.close_connection = True
                    _mark()
                    return True
                dataplane.count_ladder("get_python")
                return False
            head_sent = True
            pos = v.logical_offset + v.size
        if pos < end:
            _send_zeros(sock, end - pos)
            pos = end
    except OSError:
        handler._px_sent = pos - lo
        handler._px_aborted = True
        handler.close_connection = True  # client went away mid-body
        _mark()
        return True
    except Exception as e:  # noqa: BLE001 — e.g. grpc.RpcError from lookup_urls
        # non-OSError failures only fire at points where the current view
        # has sent nothing (partial-send states raise OSError above), so
        # head_sent is the wire truth: bytes out → cut the connection
        # short of Content-Length (a handler 500 here would land INSIDE
        # the framed body); nothing out → the Python path takes over
        wlog.warning("splice: %s failed mid-response: %s", entry.full_path, e)
        if head_sent:
            handler._px_sent = pos - lo
            handler._px_aborted = True
            handler.close_connection = True
            _mark()
            return True
        dataplane.count_ladder("get_python")
        return False
    handler._px_sent = want
    _mark()
    return True


def _serve_view(handler, master, v, head: bytes, fd, cache,
                splice_ok: bool) -> bool:
    """Serve one chunk view: hot-chunk cache first (hit or single-flight
    fill), then the native splice / Python failover ladder.  Returns
    False only when NOTHING of this view (or the head) was sent."""
    if cache is not None and _cache_view(handler, master, v, head, fd, cache):
        return True
    if not splice_ok and head:
        return False  # miss, not cache-serveable, no native: Python path
    return _splice_view(handler, master, v, head, fd, splice_ok)


def _cache_view(handler, master, v, head: bytes, fd, cache) -> bool:
    """Serve one view from the hot-chunk cache.  A hit on the segment
    tier relays file -> client natively (sendfile on the px loop); RAM
    hits and fresh fills send from gateway memory.  Returns False when
    the view is not cache-serveable (miss on a non-cacheable size, or a
    fill that failed) — nothing has been sent in that case."""
    from seaweedfs_tpu_torch.filer import reader as chunk_reader

    if not cache.cacheable(v.size):
        # never-storable sizes must not count as misses (or acquire the
        # serving lock) on every GET — insert() would always reject them
        return False
    range_lo = v.offset_in_chunk
    range_hi = range_lo + v.size - 1
    hit = cache.lookup(v.fid, range_lo, range_hi)
    data = None
    if hit is None:
        try:
            data = cache.fill(
                v.fid, range_lo, range_hi,
                lambda: chunk_reader.fetch_chunk(
                    master, v.fid, range_lo, v.size
                ),
            )
        except Exception as e:  # noqa: BLE001 — fill failed: the ladder decides
            if wlog.V(1):
                wlog.info("splice: cache fill for %s failed: %s", v.fid, e)
            return False
    else:
        try:
            if hit.fd >= 0 and fd is not None and available():
                rc, _detail = dataplane.px_cache_send(
                    hit.fd, hit.file_off, hit.size, head, fd
                )
                if rc != hit.size:
                    raise OSError("client went away mid-cache-send")
                if hit.size < v.size:  # short-stored chunk: pad to view
                    handler.connection.sendall(bytes(v.size - hit.size))
                return True
            data = hit.bytes_view()
        finally:
            hit.close()
    sock = handler.connection
    if head:
        sock.sendall(head)
    sock.sendall(data[: v.size])
    if len(data) < v.size:
        sock.sendall(bytes(v.size - len(data)))
    return True


def _splice_view(handler, master, v, head: bytes, fd,
                 splice_ok: bool = True) -> bool:
    """Relay one chunk view to the client: native splice across the
    replica holders, then the Python failover ladder.  Returns False only
    when NOTHING of this view (or the head) was sent."""
    from seaweedfs_tpu_torch.filer import reader as chunk_reader

    vid = int(v.fid.split(",")[0])
    range_lo = v.offset_in_chunk
    range_hi = v.offset_in_chunk + v.size - 1
    urls: list = []
    if splice_ok:
        try:
            urls = master.lookup_urls(v.fid)
        except KeyError:
            urls = []
    for url in urls:
        addr = _numeric_addr(url)
        if addr is None:
            continue
        rc, detail = dataplane.px_get(
            addr, f"/{v.fid}", range_lo, range_hi, head, fd, v.size
        )
        if rc == v.size:
            return True
        if rc == dataplane._PX_CLIENT_GONE:
            raise OSError("client went away mid-splice")
        if rc == dataplane._PX_MID_STREAM:
            # upstream died mid-body (head + detail bytes are out):
            # finish this view through the failover reader
            sent = detail
            dataplane.count_ladder("get_resume")
            # warning, not V(1): a mid-body upstream death is rare by
            # construction and each one costs a Python-path resume —
            # a stream of these is a sign something is wrong upstream
            wlog.warning(
                "splice: %s died %d/%d bytes into %s, resuming via failover",
                url, sent, v.size, v.fid,
            )
            master.forget_location(vid, url)
            try:
                data = chunk_reader.fetch_chunk(
                    master, v.fid, range_lo + sent, v.size - sent
                )
            except Exception as e:  # noqa: BLE001
                # head + partial body are out: returning False would make
                # the caller resend the head via the Python path, so the
                # only honest signal is splice_entry's OSError ladder
                # (close_connection short of Content-Length)
                raise OSError(f"mid-stream resume of {v.fid} failed: {e}") from e
            if len(data) < v.size - sent:  # short replica answer: pad
                data = data + bytes(v.size - sent - len(data))
            handler.connection.sendall(data[: v.size - sent])
            return True
        if rc == dataplane._PX_NO_SEND:
            # connection-class failure: dead holder — forget and move on
            master.forget_location(vid, url)
            continue
        # _PX_BAD_UPSTREAM: a live peer answered with the wrong shape
        # (error status, ignored Range, compressed pass-through).  404 /
        # redirects mean a stale location, like the Python reader's
        # volume-level 404; anything else just tries the siblings.
        if detail == 404 or detail in (301, 302, 307, 308):
            master.forget_location(vid, url)
    if head:
        return False  # nothing sent: the Python path takes the request over
    # mid-object with no native holder left: the failover reader is the
    # last resort (re-lookup included)
    dataplane.count_ladder("get_resume")
    try:
        data = chunk_reader.fetch_chunk(master, v.fid, range_lo, v.size)
    except Exception as e:  # noqa: BLE001 — headers are out; abort honestly
        wlog.warning("splice: view %s unrecoverable mid-response: %s", v.fid, e)
        return False
    if len(data) < v.size:
        data = data + bytes(v.size - len(data))
    handler.connection.sendall(data[: v.size])
    return True


def _read_exact(body, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        piece = body.read(n - len(out))
        if not piece:
            break
        out.extend(piece)
    return bytes(out)


def _ladder_put(master, url: str, fid: str, data: bytes, auth: str,
                mime: str) -> None:
    """The Python replication ladder for one chunk the fan-out could not
    complete: a plain POST to the primary, whose volume server runs the
    write-all replica fan-out itself.  Raises on failure — the write is
    never acked unless some path stored it on every holder."""
    from seaweedfs_tpu_torch.filer.upload import http_put_chunk

    dataplane.count_ladder("put_replay")
    http_put_chunk(url, fid, data, auth=auth, content_type=mime)


def try_put_splice(master, body, *, fid_pool, chunk_size: int,
                   mime: str = ""):
    """Stream a PUT body client->volume(s) through the native fan-out.

    Multi-chunk objects splice chunk by chunk with ONE object-wide MD5
    midstate carried natively across the calls (the S3 ETag is the md5
    of the whole body — chunk digests cannot be composed after the
    fact).  A replicated assignment fans every chunk out to all holders
    at once (``?type=replicate``, so no holder re-replicates) with the
    acks batched into a single native completion; a holder failing
    mid-fan-out degrades to :func:`_ladder_put` with the natively
    retained body — the write is acked only when every holder has it,
    so acked-write loss is zero by construction.

    Returns (chunks, inline_content, md5_etag) like upload_stream, or
    None when the body should take the Python path (in which case any
    bytes this function consumed are pushed back)."""
    from seaweedfs_tpu_torch.filer.entry import FileChunk
    from seaweedfs_tpu_torch.util.httpd import StreamingBody

    if not isinstance(body, StreamingBody) or body.connection is None:
        return None
    length = body.length
    if length < MIN_SPLICE_BYTES:
        return None
    if body.remaining != length:
        return None  # someone already consumed bytes: shape unknown
    if not available():
        return None
    if getattr(fid_pool, "take_located", None) is None:
        return None  # a bare pool stub: the fan-out needs the holder set
    state = dataplane.md5_state()
    chunks: list[FileChunk] = []
    offset = 0
    spliced_chunks = 0
    ack_ns_total = 0
    fd = body.connection.fileno()
    # one chunk's replica acks pipeline under the NEXT chunk's stream:
    # pending awaits px_fanout_collect with its body retained (buffer +
    # consumed count, sliced lazily) so an ack failure rides the ladder.
    # Two ping-ponged retention buffers: the pending chunk's bytes must
    # survive while the next chunk streams into the other slot, and
    # reusing them avoids an allocate+zero pass per chunk.
    pending: dict | None = None
    bufs: list = [None, None]
    # the handler's BufferedReader may hold body bytes past a chunk
    # boundary after a ladder read (_read_exact's final fill over-reads
    # into the Python buffer); the next chunk must drain them into
    # ``initial`` or the raw-fd fan-out would silently skip them
    drain_buffered = True  # chunk 0 always drains the read-ahead

    def settle(p: dict) -> None:
        nonlocal spliced_chunks, ack_ns_total
        rc2, statuses2, ack_ns2, _resp2 = dataplane.px_fanout_collect(
            p["addrs"], p["fds"]
        )
        if 200 <= rc2 < 300:
            spliced_chunks += 1
            ack_ns_total += ack_ns2
        elif rc2 == dataplane._PX_RETAINED:
            wlog.warning(
                "splice: deferred acks for %s degraded (statuses %s), "
                "replaying via the python ladder", p["fid"], statuses2,
            )
            # materialized only here: the happy path never copies the
            # retention buffer out of ctypes
            data = p["initial"] + p["buf"].raw[: p["consumed"]]
            _ladder_put(master, p["url"], p["fid"], data, p["auth"],
                        p["mime"])
        else:
            raise IOError(
                f"splice PUT {p['fid']}: deferred ack failed "
                f"({rc2} {statuses2})"
            )

    while offset < length:
        chunk_len = min(chunk_size, length - offset)
        new_pending: dict | None = None
        try:
            # everything from assign onward sits inside this try: a raise
            # anywhere here must drain the PREVIOUS chunk's deferred peer
            # sockets (the except below), never leak them
            try:
                fid, url, assign_auth, replicas = fid_pool.take_located(1)[0]
            except Exception as e:  # noqa: BLE001 — assign failed
                if offset == 0:
                    if wlog.V(1):
                        wlog.info("splice: assign failed, python path: %s", e)
                    dataplane.count_ladder("put_python")
                    return None  # nothing consumed: Python path reports it
                raise IOError(
                    f"splice PUT assign failed mid-object: {e}"
                ) from e
            addrs = [_numeric_addr(u) for u in (url, *replicas)]
            resolvable = None not in addrs
            auth = master.sign_write(fid) or assign_auth
            extra = ""
            if auth:
                extra += f"Authorization: Bearer {auth}\r\n"
            if mime:
                # the volume server's compress-on-write heuristic keys off
                # the Content-Type — the Python chunk uploader's header
                extra += f"Content-Type: {mime}\r\n"
            # client span + traceparent, exactly like http_put_chunk: the
            # volume's native loop records its POST span under this
            # parent, so a traced PUT keeps its gateway->chunk->native
            # lineage even with zero body bytes in CPython
            from seaweedfs_tpu_torch.stats import trace

            span_cm = trace.span(
                "put_chunk", service="filer_client",
                attrs={"fid": fid, "url": url, "fanout": len(addrs)},
            )
            # every holder appends locally without re-replicating; a
            # single-copy assignment keeps the plain path so the volume's
            # compress-on-write heuristic still applies
            path = f"/{fid}" + ("?type=replicate" if len(addrs) > 1 else "")
            # the reader's buffer (<=64KB) is far below chunk_size and a
            # short body is a single chunk: never crosses a boundary
            initial = body.take_buffered() if drain_buffered else b""
            drain_buffered = False
            sock_rem = chunk_len - len(initial)
            with span_cm:
                tp_headers: dict = {}
                trace.inject_headers(tp_headers)
                extra_tp = extra + "".join(
                    f"{k}: {v}\r\n" for k, v in tp_headers.items()
                )
                # the last chunk collects inline; earlier chunks defer
                # their acks under the next chunk's stream time
                defer = resolvable and offset + chunk_len < length
                if not resolvable:
                    rc, body_buf, statuses, ack_ns, consumed, dfds = (
                        dataplane._PX_NO_SEND, None, [], 0, 0, [],
                    )
                else:
                    slot = len(chunks) % 2
                    if bufs[slot] is None or len(bufs[slot]) < chunk_len:
                        bufs[slot] = dataplane.body_buffer(chunk_len)
                    (rc, _md5_hex, body_buf, statuses, ack_ns, _resp,
                     consumed, dfds) = dataplane.px_put_fanout(
                        addrs, path, extra_tp, initial, fd, sock_rem,
                        state, defer_acks=defer, body_buf=bufs[slot],
                    )
                    body.remaining -= consumed
                if rc == dataplane._PX_ACKS_DEFERRED:
                    new_pending = {
                        "fid": fid, "url": url, "auth": auth, "mime": mime,
                        "initial": initial, "buf": body_buf,
                        "consumed": consumed, "addrs": addrs, "fds": dfds,
                    }
                elif 200 <= rc < 300:
                    spliced_chunks += 1
                    ack_ns_total += ack_ns
                elif rc == dataplane._PX_CLIENT_GONE:
                    raise IOError(
                        f"splice PUT {fid}: client went away mid-body"
                    )
                elif rc == dataplane._PX_NO_SEND and consumed == 0:
                    if offset == 0:
                        body.pushback(initial)
                        dataplane.count_ladder("put_python")
                        return None  # whole object replays via Python
                    # mid-object, nothing of this chunk consumed
                    # natively: read it ourselves and replay via the
                    # ladder; the carried ETag state must cover it too
                    data = initial + _read_exact(body, sock_rem)
                    if len(data) < chunk_len:
                        raise IOError(f"splice PUT {fid}: client body short")
                    dataplane.px_md5_update(state, data)
                    drain_buffered = True  # the read may have over-read
                    wlog.warning(
                        "splice: fan-out for %s unreachable, chunk %d via "
                        "the python ladder", fid, len(chunks),
                    )
                    _ladder_put(master, url, fid, data, auth, mime)
                elif rc == dataplane._PX_RETAINED:
                    # a holder failed or rejected mid-fan-out; the body
                    # was fully consumed and retained natively — replay
                    # it, unacked so far
                    wlog.warning(
                        "splice: fan-out for %s degraded (statuses %s), "
                        "replaying via the python ladder", fid, statuses,
                    )
                    _ladder_put(
                        master, url, fid,
                        initial + body_buf.raw[:consumed], auth, mime,
                    )
                else:
                    raise IOError(
                        f"splice PUT {fid} to {url}: "
                        + (f"HTTP {rc}" if rc > 0
                           else f"px error {rc} {statuses}")
                    )
            # the previous chunk's acks have had this whole chunk's
            # stream time to arrive: settle them now (near-zero wait)
            if pending is not None:
                p, pending = pending, None
                settle(p)  # collect consumes every fd, success or not
        except BaseException:
            # never leak deferred peer sockets on the way out (settle
            # itself always consumes the fds it was given)
            for leak in (pending, new_pending):
                if leak is not None:
                    try:
                        dataplane.px_fanout_collect(
                            leak["addrs"], leak["fds"]
                        )
                    except Exception as drain_err:  # noqa: BLE001
                        wlog.warning(
                            "splice: draining deferred acks for %s during "
                            "abort failed: %s", leak["fid"], drain_err,
                        )
            pending = None
            raise
        pending = new_pending
        chunks.append(
            FileChunk(
                fid=fid, offset=offset, size=chunk_len,
                modified_ts_ns=time.time_ns(),
            )
        )
        offset += chunk_len
    if pending is not None:
        p, pending = pending, None
        settle(p)
    etag = dataplane.px_md5_digest(state)
    if len(chunks) == 1:
        # single-chunk objects: the cumulative digest IS the chunk md5
        # (the upload_stream convention); multi-chunk objects leave the
        # informational per-chunk e_tag empty rather than hash twice
        from dataclasses import replace as _replace

        chunks[0] = _replace(chunks[0], e_tag=etag)
    # wire-truth attribution for the gateway's response headers / bench
    body.px_spliced = spliced_chunks
    body.px_chunks = len(chunks)
    body.px_ack_ns = ack_ns_total
    return chunks, b"", etag
