"""ctypes binding and state-sync glue for the native HTTP data plane
(csrc/dp.cpp): the port's counterpart of seaweedfs_tpu/native/dataplane.py,
with its constants, verbs and semantics.

The native loop owns the needle GET/POST/DELETE hot path for registered
volumes (and the EC GET from local shards) and forwards everything else to
the Python volume server on an internal loopback port.  This module keeps
the two worlds consistent:

- registration: every mounted disk-backed v2/v3 volume is handed to the
  native map (bulk key load + .dat/.idx fds); Python-side appends then route
  through :meth:`NativeDataPlane.append` so there is exactly ONE appender per
  volume (the native library's per-volume mutex).
- events: needles written by the native HTTP loop surface here through a
  bounded event queue; a drainer thread folds them into the Python needle
  map, garbage accounting and append clock.  On queue overflow the volume's
  Python map is rebuilt from the .idx file (the native loop writes idx
  entries synchronously, so the file is always the source of truth).
- disk faults: native appends and preads bypass storage/backend.py, where
  the ``disk:`` rules of util/faults.py fire.  While any ``disk:`` rule is
  armed no volume is registered (every request forwards to Python, whose
  backend the rule covers); arming one unregisters the volumes at once and
  clearing the plan registers them again.

The px verbs (``px_*``) are the gateway half: S3 / filer chunk bodies
relayed volume <-> client without CPython copies (filer/splice.py).
``SEAWEEDFS_TPU_NATIVE_DP=0`` keeps the volume server on Python and
``SEAWEEDFS_TPU_NATIVE_PX=0`` the gateways; otherwise a library that cannot
be built or loaded raises when the server starts.

Counterpart of the reference's compiled data plane
(weed/server/volume_server_handlers_read.go:132,
volume_server_handlers_write.go:18): there the whole server is native; here
the hot loop is native and Python keeps the control plane.
"""

from __future__ import annotations

import collections
import ctypes
import os
import struct
import threading

from seaweedfs_tpu_torch.native import load
from seaweedfs_tpu_torch.stats import plane
from seaweedfs_tpu_torch.util import debugz, faults, wlog

_EVENT = struct.Struct("<IiQQQq")  # vid, size, key, offset, append_ns, old_size
_EVENT_BUF = 4096 * _EVENT.size

# dp.cpp TraceRec: trace_id hex, parent span hex, verb, status, pad, vid,
# start_unix_ns, dur_ns
_TRACE = struct.Struct("<32s16sBBHIQQ")
_TRACE_BUF = 512 * _TRACE.size
_VERBS = ("get", "post", "delete", "forward")

# px splice ABI: mirrors of dp.cpp's px-abi block (tests/test_torch_
# dataplane.py holds them against the `// py:` markers in the C++ source)
_PX_NO_SEND = -1        # nothing sent to the client; caller may fall back
_PX_BAD_UPSTREAM = -2   # upstream answered wrong status/length; nothing sent
_PX_CLIENT_GONE = -3    # client write/read failed; abort the request
_PX_MID_STREAM = -4     # upstream died mid-body; detail = bytes relayed
_PX_RETAINED = -5       # fan-out: body consumed AND retained; replay via
                        # the Python replication ladder (zero acked loss)
_PX_ACKS_DEFERRED = -6  # fan-out streamed; acks pipeline under the next
                        # chunk and settle via px_fanout_collect
_PX_STATS_SLOTS = 20
_PX_MAX_REPLICAS = 8
# px loop modes (sw_px_loop_mode): which readiness engine drives relays
_PX_LOOP_OFF = 0
_PX_LOOP_EPOLL = 1
_PX_LOOP_URING = 2
# dp.cpp Md5State: a, b, c, d, total, tail[64], tail_len (+4 pad) — the
# object-wide ETag digest carried across per-chunk fan-out calls
_MD5_STATE = struct.Struct("<IIIIQ64sI4x")
# dp.cpp kLatencyBoundsNs, rendered as Prometheus le-bounds in seconds
_LATENCY_BOUNDS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0,
)
_METRICS_PER_VERB = 2 + len(_LATENCY_BOUNDS_S) + 1


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_dp_bound", False):
        return
    lib.sw_dp_create.restype = ctypes.c_void_p
    lib.sw_dp_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.sw_dp_port.restype = ctypes.c_int
    lib.sw_dp_port.argtypes = [ctypes.c_void_p]
    lib.sw_dp_start.restype = ctypes.c_int
    lib.sw_dp_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sw_dp_stop.restype = None
    lib.sw_dp_stop.argtypes = [ctypes.c_void_p]
    lib.sw_dp_register_volume.restype = ctypes.c_int
    lib.sw_dp_register_volume.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.sw_dp_unregister_volume.restype = None
    lib.sw_dp_unregister_volume.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.sw_dp_activate_volume.restype = None
    lib.sw_dp_activate_volume.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.sw_dp_set_volume_flags.restype = None
    lib.sw_dp_set_volume_flags.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
    ]
    lib.sw_dp_set_replicas.restype = None
    lib.sw_dp_set_replicas.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
    ]
    lib.sw_dp_register_ec_volume.restype = ctypes.c_int
    lib.sw_dp_register_ec_volume.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.sw_dp_ec_set_shard.restype = ctypes.c_int
    lib.sw_dp_ec_set_shard.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_char_p,
    ]
    lib.sw_dp_unregister_ec_volume.restype = None
    lib.sw_dp_unregister_ec_volume.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.sw_dp_put_many.restype = ctypes.c_int
    lib.sw_dp_put_many.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.sw_dp_append.restype = ctypes.c_int64
    lib.sw_dp_append.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.sw_dp_drain_events.restype = ctypes.c_size_t
    lib.sw_dp_drain_events.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.sw_dp_events_lost.restype = ctypes.c_uint64
    lib.sw_dp_events_lost.argtypes = [ctypes.c_void_p]
    lib.sw_dp_stats.restype = None
    lib.sw_dp_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sw_dp_metrics.restype = None
    lib.sw_dp_metrics.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sw_dp_trace_drain.restype = ctypes.c_size_t
    lib.sw_dp_trace_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib._dp_bound = True


def enabled() -> bool:
    """Native plane is opt-out: SEAWEEDFS_TPU_NATIVE_DP=0 disables."""
    return os.environ.get("SEAWEEDFS_TPU_NATIVE_DP", "1") != "0"


# ---------------------------------------------------------------------------
# px: gateway splice verbs (dp.cpp's px section).  These run in the S3 /
# filer GATEWAY process, not the volume server: Python resolves the chunk
# (auth, entry lookup, range math), then the native library relays the
# body volume<->client with zero CPython copies over a process-global
# pool of keep-alive upstream connections.
# ---------------------------------------------------------------------------

_px_lock = threading.Lock()
_px_lib: ctypes.CDLL | None = None

# the per-request ladders of filer/splice.py, counted on the Python side
# (the native slots cannot see a request that never reached them):
# get_python: a GET served by the Python path after the splice sent
# nothing; get_resume: a view finished from Python after an upstream died
# mid-body; put_python: a PUT replayed whole through the Python path;
# put_replay: a chunk replayed through the Python replication ladder
_ladder: collections.Counter = collections.Counter()
_LADDER_KEYS = ("get_python", "get_resume", "put_python", "put_replay")


def count_ladder(step: str) -> None:
    _ladder[step] += 1


def _bind_px(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_px_bound", False):
        return
    lib.sw_px_get.restype = ctypes.c_int64
    lib.sw_px_get.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_px_cache_send.restype = ctypes.c_int64
    lib.sw_px_cache_send.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_px_stats.restype = None
    lib.sw_px_stats.argtypes = [ctypes.c_void_p]
    lib.sw_px_reset.restype = None
    lib.sw_px_reset.argtypes = []
    lib.sw_px_loop_mode.restype = ctypes.c_int
    lib.sw_px_loop_mode.argtypes = []
    lib.sw_px_loop_reset.restype = None
    lib.sw_px_loop_reset.argtypes = []
    lib.sw_px_md5_digest.restype = None
    lib.sw_px_md5_digest.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.sw_px_md5_update.restype = None
    lib.sw_px_md5_update.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.sw_px_put_fanout.restype = ctypes.c_int64
    lib.sw_px_put_fanout.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_px_fanout_collect.restype = ctypes.c_int64
    lib.sw_px_fanout_collect.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_px_stash_push.restype = ctypes.c_int
    lib.sw_px_stash_push.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.sw_px_stash_take.restype = ctypes.c_int
    lib.sw_px_stash_take.argtypes = [
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_px_stash_depth.restype = ctypes.c_int64
    lib.sw_px_stash_depth.argtypes = [ctypes.c_uint64]
    lib.sw_px_stash_clear.restype = None
    lib.sw_px_stash_clear.argtypes = []
    lib._px_bound = True


def px_enabled() -> bool:
    """The gateway splice is opt-out: SEAWEEDFS_TPU_NATIVE_PX=0 disables
    (checked per call so tests can flip the env var)."""
    return os.environ.get("SEAWEEDFS_TPU_NATIVE_PX", "1") != "0"


def px_lib() -> ctypes.CDLL | None:
    """The native library with the splice verbs bound, or None when
    SEAWEEDFS_TPU_NATIVE_PX=0.  Raises when the library cannot be built or
    loaded: a gateway checks this at start (``require_px``)."""
    if not px_enabled():
        return None
    global _px_lib
    with _px_lock:
        if _px_lib is None:
            lib = load()
            _bind_px(lib)
            _px_lib = lib
        return _px_lib


def require_px() -> None:
    """Gateway start: build and load the splice library now unless the
    splice is disabled, so a broken build fails the start instead of
    quietly serving every body from Python."""
    px_lib()


def px_get(
    addr: str, path: str, range_lo: int, range_hi: int, head: bytes,
    client_fd: int, want: int,
) -> tuple[int, int]:
    """Relay ``want`` body bytes of ``path`` [range_lo, range_hi] from the
    volume server at ``addr`` straight to ``client_fd``, prefixed by the
    ``head`` response bytes.  Returns (rc, detail) — rc == want on
    success, else one of the _PX_* codes (detail: HTTP status for
    _PX_BAD_UPSTREAM, body bytes already relayed for _PX_MID_STREAM /
    _PX_CLIENT_GONE)."""
    lib = px_lib()
    assert lib is not None, "px_get called without the native library"
    detail = ctypes.c_int64(0)
    # the calling thread parks inside the C relay for the whole body
    # transfer — name the frame or the profiler bills it to the caller
    with debugz.native_call("sw_px_get"):
        rc = lib.sw_px_get(
            addr.encode(), path.encode(), range_lo, range_hi, head, len(head),
            client_fd, want, ctypes.byref(detail),
        )
    if rc >= 0:
        # the native relay bypasses storage/backend.py, so plane bytes
        # are accounted at this seam (partial relays are not: detail is
        # only a byte count for a subset of the error codes)
        plane.account(rc, "read")
    return rc, detail.value


def px_cache_send(
    cache_fd: int, file_off: int, want: int, head: bytes, client_fd: int,
) -> tuple[int, int]:
    """Relay ``want`` bytes of the chunk-cache segment file at
    ``cache_fd`` [file_off, file_off+want) straight to ``client_fd`` via
    sendfile(2), prefixed by ``head`` — a warm GET served with zero
    CPython copies and zero upstream connections.  Returns (rc, detail):
    rc == want on success, else _PX_CLIENT_GONE with detail = body bytes
    already out."""
    lib = px_lib()
    assert lib is not None, "px_cache_send called without the native library"
    detail = ctypes.c_int64(0)
    with debugz.native_call("sw_px_cache_send"):
        rc = lib.sw_px_cache_send(
            cache_fd, file_off, want, head, len(head), client_fd,
            ctypes.byref(detail),
        )
    if rc >= 0:
        plane.account(rc, "read")
    return rc, detail.value


def md5_state() -> ctypes.Array:
    """A fresh (zeroed) MD5 midstate buffer for px_put_fanout to carry
    the object-wide ETag digest across per-chunk calls."""
    return ctypes.create_string_buffer(_MD5_STATE.size)


def px_md5_digest(state) -> str:
    """Finalize a carried midstate into the object's md5 hex (the state
    itself stays usable for further chunks)."""
    lib = px_lib()
    assert lib is not None, "px_md5_digest called without the native library"
    out = ctypes.create_string_buffer(16)
    lib.sw_px_md5_digest(state, out)
    return out.raw.hex()


def px_md5_update(state, data: bytes) -> None:
    """Fold ladder-replayed bytes into a carried midstate so the object
    ETag still covers chunks the native fan-out never consumed."""
    lib = px_lib()
    assert lib is not None, "px_md5_update called without the native library"
    lib.sw_px_md5_update(state, data, len(data))


def body_buffer(size: int) -> ctypes.Array:
    """A retention buffer for px_put_fanout — allocate once per object
    (ping-ponged across chunks) instead of paying an allocate+zero pass
    per chunk on the hot PUT path."""
    return ctypes.create_string_buffer(max(1, size))


def px_put_fanout(
    addrs: list[str], path: str, extra_headers: str, initial: bytes,
    client_fd: int, sock_rem: int, state, defer_acks: bool = False,
    body_buf=None,
) -> tuple[int, str, "ctypes.Array", list[int], int, bytes, int, list[int]]:
    """Stream ``initial`` + ``sock_rem`` client-socket bytes to EVERY
    holder in ``addrs`` (numeric ip:port, primary first) as one fan-out,
    batching the replica acks into this single call.  ``state`` is the
    md5_state() buffer carried across the object's chunks; ``body_buf``
    an optional reusable retention buffer (>= sock_rem).

    Returns (rc, md5_hex, body_buf, statuses, ack_wait_ns,
    primary_response_body, consumed, deferred_fds): rc is the primary's
    HTTP status when every peer acked 2xx, else a _PX_* code —
    _PX_RETAINED means ``body_buf.raw[:consumed]`` holds every consumed
    socket byte and the caller replays initial+retained through the
    Python replication ladder (sliced lazily: the happy path never
    copies the retention buffer); with ``defer_acks`` a fully-streamed
    body returns _PX_ACKS_DEFERRED and ``deferred_fds`` (settle them
    with :func:`px_fanout_collect` — the next chunk streams meanwhile,
    using a DIFFERENT buffer so the pending chunk's bytes survive)."""
    lib = px_lib()
    assert lib is not None, "px_put_fanout called without the native library"
    md5_out = ctypes.create_string_buffer(16)
    body = (
        body_buf
        if body_buf is not None and len(body_buf) >= max(1, sock_rem)
        else body_buffer(sock_rem)
    )
    resp = ctypes.create_string_buffer(4096)
    resp_len = ctypes.c_int64(0)
    statuses = (ctypes.c_int64 * _PX_MAX_REPLICAS)()
    ack_ns = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    fds = (ctypes.c_int64 * _PX_MAX_REPLICAS)(*([-1] * _PX_MAX_REPLICAS))
    with debugz.native_call("sw_px_put_fanout"):
        rc = lib.sw_px_put_fanout(
            ",".join(addrs).encode(), path.encode(), extra_headers.encode(),
            initial, len(initial), client_fd, sock_rem, state, md5_out, body,
            sock_rem, resp, 4096, ctypes.byref(resp_len), statuses,
            ctypes.byref(ack_ns), ctypes.byref(consumed),
            1 if defer_acks else 0, fds,
        )
    if consumed.value > 0:
        # body bytes streamed client -> holders through the native
        # fan-out (consumed is valid even on partial failures)
        plane.account(consumed.value, "write")
    return (
        rc, md5_out.raw.hex(), body,
        list(statuses)[: len(addrs)], ack_ns.value,
        resp.raw[: resp_len.value], consumed.value,
        list(fds)[: len(addrs)],
    )


def px_fanout_collect(
    addrs: list[str], fds: list[int],
) -> tuple[int, list[int], int, bytes]:
    """Settle a deferred fan-out's acks.  Returns (rc, statuses,
    ack_wait_ns, primary_response_body) — rc as in px_put_fanout; every
    fd is consumed (pooled or closed) exactly once."""
    lib = px_lib()
    assert lib is not None, "px_fanout_collect called without the library"
    resp = ctypes.create_string_buffer(4096)
    resp_len = ctypes.c_int64(0)
    statuses = (ctypes.c_int64 * _PX_MAX_REPLICAS)()
    ack_ns = ctypes.c_int64(0)
    cfds = (ctypes.c_int64 * _PX_MAX_REPLICAS)(
        *(list(fds) + [-1] * (_PX_MAX_REPLICAS - len(fds)))
    )
    with debugz.native_call("sw_px_fanout_collect"):
        rc = lib.sw_px_fanout_collect(
            ",".join(addrs).encode(), cfds, resp, 4096,
            ctypes.byref(resp_len), statuses, ctypes.byref(ack_ns),
        )
    return (
        rc, list(statuses)[: len(addrs)], ack_ns.value,
        resp.raw[: resp_len.value],
    )


def px_loop_mode() -> int:
    """Which readiness engine drives the px body relays (lazy-starts it):
    _PX_LOOP_URING, _PX_LOOP_EPOLL, or _PX_LOOP_OFF.  0 when the native
    library is unavailable."""
    lib = px_lib()
    if lib is None:
        return _PX_LOOP_OFF
    return lib.sw_px_loop_mode()


def px_loop_reset() -> None:
    """Stop the px loop and forget the cached env decision — the seam the
    uring-vs-epoll parity tests flip SEAWEEDFS_TPU_PX_URING through."""
    lib = px_lib()
    if lib is not None:
        lib.sw_px_loop_reset()


def px_stash_push(
    key: int, stripe: int, fid: str, addrs: list[str], auth: str,
    ttl_ms: int,
) -> bool:
    """Park one pre-assigned (fid, holder set, auth) in the native fid
    stash.  False = stripe full / unavailable (keep it Python-side)."""
    lib = px_lib()
    if lib is None:
        return False
    return lib.sw_px_stash_push(
        key, stripe, fid.encode(), ",".join(addrs).encode(), auth.encode(),
        ttl_ms,
    ) == 0


def px_stash_take(key: int) -> tuple[str, list[str], str, int] | None:
    """Draw one pre-assigned (fid, [primary, *replicas], auth, remaining)
    from the native stash, or None when empty (caller assigns anew).
    ``remaining`` is the bucket's approximate leftover depth — the
    low-water signal, free with the take instead of a second scan."""
    lib = px_lib()
    if lib is None:
        return None
    fid = ctypes.create_string_buffer(128)
    addrs = ctypes.create_string_buffer(600)
    auth = ctypes.create_string_buffer(1100)
    depth = ctypes.c_int64(0)
    if lib.sw_px_stash_take(
        key, fid, 128, addrs, 600, auth, 1100, ctypes.byref(depth)
    ) != 0:
        return None
    return (
        fid.value.decode(),
        addrs.value.decode().split(","),
        auth.value.decode(),
        depth.value,
    )


def px_stash_depth(key: int) -> int:
    lib = px_lib()
    return 0 if lib is None else lib.sw_px_stash_depth(key)


def px_stash_clear() -> None:
    lib = px_lib()
    if lib is not None:
        lib.sw_px_stash_clear()


def px_stats() -> dict:
    """Splice counters (native slots zero when the splice is disabled),
    with the Python-side ladder steps under ``ladder_*``."""
    lib = px_lib()
    if lib is None:
        out = [0] * _PX_STATS_SLOTS
    else:
        buf = (ctypes.c_uint64 * _PX_STATS_SLOTS)()
        lib.sw_px_stats(buf)
        out = list(buf)
    return {
        "get_spliced": out[0],
        "get_bytes": out[1],
        "get_midstream": out[2],
        "get_fallback": out[3],
        # slots 4-6: the retired single-upstream PUT verb — always 0
        # now; keys kept so historical records/dashboards still parse
        "put_spliced": out[4],
        "put_bytes": out[5],
        "put_fail": out[6],
        "conns_opened": out[7],
        "fanout_ok": out[8],
        "fanout_bytes": out[9],
        "fanout_fail": out[10],
        "fanout_replica_acks": out[11],
        "fanout_ack_wait_ns": out[12],
        "loop_get_jobs": out[13],
        "loop_put_jobs": out[14],
        "loop_arm_fail": out[15],
        "cache_send_ok": out[16],
        "cache_send_bytes": out[17],
        "cache_send_fail": out[18],
        "loop_cache_jobs": out[19],
        **{f"ladder_{k}": _ladder[k] for k in _LADDER_KEYS},
    }


def px_reset() -> None:
    """Drop every pooled upstream connection (tests, gateway shutdown)."""
    lib = px_lib()
    if lib is not None:
        lib.sw_px_reset()


class NativeDataPlane:
    """One native front-door listener + its volume registry, bound to one
    VolumeServer's Store."""

    def __init__(self, handle, lib, store):
        self._h = handle
        self._lib = lib
        self.store = store
        self.port = lib.sw_dp_port(handle)
        self._ev_buf = ctypes.create_string_buffer(_EVENT_BUF)
        self._ev_lock = threading.Lock()
        self._tr_buf = ctypes.create_string_buffer(_TRACE_BUF)
        self._tr_lock = threading.Lock()
        self._lost_seen = 0
        self._resync_pending = False
        self._stop = threading.Event()
        self._drainer: threading.Thread | None = None
        # vid -> [public urls] resolver for replicated volumes (set by the
        # volume server); the drainer pushes fresh results to the native
        # fan-out every _REPLICA_TTL seconds
        self.replica_resolver = None
        self._last_replica_push = 0.0
        self._addr_cache: dict[str, tuple[str, float]] = {}
        # vid -> the volume registered here: the event fold finds volumes
        # without the store's location locks, which a reader may hold
        # while it folds (AppendIndex.before_read)
        self._vols: dict[int, object] = {}
        # replicated volumes whose holders have not been resolved yet: the
        # drainer asks for them every pass, not every _REPLICA_TTL, so a
        # freshly grown volume's writes fan out natively within a second
        # or so of its holders registering at the master
        self._unresolved: set[int] = set()

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, ip: str, port: int, store, jwt_required: bool):
        """Bind the public listener.  Raises when the native library cannot
        be built or loaded, and OSError when the address cannot be bound:
        an enabled plane never falls back to the Python server."""
        lib = load()
        _bind(lib)
        h = lib.sw_dp_create(ip.encode(), port, 1 if jwt_required else 0)
        if not h:
            raise OSError(f"native data plane: cannot bind {ip}:{port}")
        return cls(h, lib, store)

    def start(self, upstream_port: int) -> None:
        self._lib.sw_dp_start(self._h, upstream_port)
        self._drainer = threading.Thread(
            target=self._drain_loop, daemon=True, name="dp-events"
        )
        self._drainer.start()
        faults.add_listener(self._on_faults)

    def stop(self) -> None:
        faults.remove_listener(self._on_faults)
        self._stop.set()
        self.flush_events()
        self.drain_trace_events()
        with self._ev_lock:
            pending, self._resync_pending = self._resync_pending, False
        if pending:
            self._resync()
        self._lib.sw_dp_stop(self._h)

    # -- volume registry ---------------------------------------------------

    def register_volume(self, vol) -> bool:
        """Hand a mounted volume to the native plane.  Only plain disk
        v2/v3 volumes qualify, and none while a ``disk:`` fault rule is
        armed; anything else keeps the Python path."""
        if (
            vol.tiered
            or vol.backend_kind != "disk"
            or int(vol.version) < 2
            or faults.disk_armed()
        ):
            return False
        rc = self._lib.sw_dp_register_volume(
            self._h,
            vol.id,
            (vol.base + ".dat").encode(),
            (vol.base + ".idx").encode(),
            int(vol.version),
            vol.super_block.replica_placement.copy_count,
            1 if vol.read_only else 0,
            vol.offset_width,
        )
        if rc != 0:
            return False
        entries = list(vol.nm.db.values())
        if entries:
            n = len(entries)
            keys = (ctypes.c_uint64 * n)(*[e.key for e in entries])
            offs = (ctypes.c_uint64 * n)(*[e.offset for e in entries])
            sizes = (ctypes.c_int32 * n)(*[e.size for e in entries])
            self._lib.sw_dp_put_many(self._h, vol.id, keys, offs, sizes, n)
        # routable only once the bulk load is complete — a half-loaded map
        # would 404 live needles (and could shadow a racing native write)
        self._vols[vol.id] = vol
        if vol.super_block.replica_placement.copy_count > 1:
            self._unresolved.add(vol.id)
        self._lib.sw_dp_activate_volume(self._h, vol.id)
        vol._dp = self
        vol.nm.before_read = self.flush_events
        return True

    def unregister_volume(self, vol_or_vid) -> None:
        vid = getattr(vol_or_vid, "id", vol_or_vid)
        if hasattr(vol_or_vid, "_dp"):
            vol_or_vid._dp = None
        # fence FIRST: sw_dp_unregister_volume sets closed under the native
        # append mutex, so once it returns no further native append (or its
        # event) can land; only then is a drain guaranteed complete
        self._lib.sw_dp_unregister_volume(self._h, vid)
        self.flush_events()
        vol = self._vols.pop(vid, None)
        if vol is not None:
            vol.nm.before_read = None

    # -- EC volumes (native local-shard reads) -----------------------------

    def register_ec_volume(self, ev) -> bool:
        """Hand a mounted EC volume to the native plane: .ecx bisect +
        striped local-shard reads serve GETs without the interpreter;
        anything needing a remote shard or reconstruction still
        forwards.  Shard attach/detach rides sync_ec_shards."""
        if faults.disk_armed():
            return False
        # the same geometry input EcVolume.locate_interval derives
        if ev.dat_file_size > 0:
            shard_size = ev.dat_file_size // ev.scheme.data_shards
        elif ev.shards:
            shard_size = ev.shard_size() - 1
        else:
            return False  # no .vif and no local shard: geometry unknown
        if self._lib.sw_dp_register_ec_volume(
            self._h,
            ev.vid,
            (ev.base + ".ecx").encode(),
            int(ev.version),
            ev.offset_width,
            ev.scheme.data_shards,
            ev.scheme.parity_shards,
            ev.scheme.large_block_size,
            ev.scheme.small_block_size,
            shard_size,
        ) != 0:
            return False
        self.sync_ec_shards(ev)
        ev._dp = self
        return True

    def sync_ec_shards(self, ev) -> None:
        """Mirror the EC volume's LOCAL shard set into the native plane
        (called after mount/unmount of shards)."""
        for sid in range(ev.scheme.total_shards):
            shard = ev.shards.get(sid)
            self._lib.sw_dp_ec_set_shard(
                self._h, ev.vid, sid,
                shard.path.encode() if shard is not None else b"",
            )

    def unregister_ec_volume(self, ev_or_vid) -> None:
        vid = getattr(ev_or_vid, "vid", ev_or_vid)
        if hasattr(ev_or_vid, "_dp"):
            ev_or_vid._dp = None
        self._lib.sw_dp_unregister_ec_volume(self._h, vid)

    def _on_faults(self, plan) -> None:
        """A fault plan was installed or cleared: keep the plane off every
        volume while a ``disk:`` rule is armed, and take them back after."""
        armed = faults.disk_armed(plan)
        for loc in self.store.locations:
            for vol in list(loc.volumes.values()):
                owned = getattr(vol, "_dp", None) is self
                if armed and owned:
                    self.unregister_volume(vol)
                elif not armed and not owned:
                    self.register_volume(vol)
            for ev in list(loc.ec_volumes.values()):
                owned = getattr(ev, "_dp", None) is self
                if armed and owned:
                    self.unregister_ec_volume(ev)
                elif not armed and not owned:
                    self.register_ec_volume(ev)

    def set_flags(self, vid: int, read_only: bool, copy_count: int) -> None:
        if copy_count > 1:
            self._unresolved.add(vid)
        self._lib.sw_dp_set_volume_flags(
            self._h, vid, 1 if read_only else 0, copy_count
        )

    def append(self, vid: int, key: int, map_size: int, record: bytes) -> int:
        """Serialized .dat+.idx append through the native appender.
        Returns the offset the record landed at; -1 when the volume is
        not registered here (nothing written — the caller may safely
        append through its own fd); -2 on a native IO failure or
        misaligned end (partial bytes may sit past the tracked end — the
        caller must NOT append through another fd, only the native
        end-tracking overwrites them correctly); -3 when a tombstone's
        key is already absent (concurrent delete won; nothing written)."""
        return self._lib.sw_dp_append(
            self._h, vid, key, map_size, record, len(record)
        )

    # -- event folding -----------------------------------------------------

    def flush_events(self) -> None:
        """Drain and apply all pending append events now.  May be called
        from writer threads holding a volume's _write_lock; the actual
        overflow resync is deferred to the drainer thread, which holds no
        volume locks (two writers each holding their own volume's lock and
        both resyncing would deadlock AB-BA)."""
        with self._ev_lock:
            while True:
                n = self._lib.sw_dp_drain_events(
                    self._h, self._ev_buf, _EVENT_BUF
                )
                for i in range(n):
                    self._apply(_EVENT.unpack_from(self._ev_buf, i * _EVENT.size))
                if n < _EVENT_BUF // _EVENT.size:
                    break
            lost = self._lib.sw_dp_events_lost(self._h)
            if lost > self._lost_seen:
                self._lost_seen = lost
                self._resync_pending = True

    def _apply(self, ev) -> None:
        from seaweedfs_tpu_torch.storage.types import get_actual_size, size_is_valid

        vid, size, key, off, ns, old_size = ev
        vol = self._vols.get(vid)
        if vol is None:
            return
        if size >= 0:  # put (size-0 = empty-data needle, indexed not served)
            vol.nm.apply_put(key, off, size)
        else:  # tombstone
            vol.nm.apply_delete(key)
        # _acct_lock, not _write_lock: a writer holding _write_lock may be
        # waiting on this drainer's event lock (flush-on-miss)
        with vol._acct_lock:
            if old_size >= 0 and size_is_valid(old_size):
                vol._deleted_bytes += get_actual_size(old_size, vol.version)
            if size < 0:
                # the tombstone record itself is garbage the moment it lands
                vol._deleted_bytes += get_actual_size(0, vol.version)
            if ns > vol.last_append_at_ns:
                vol.last_append_at_ns = ns

    def _resync(self) -> None:
        """Event queue overflowed: rebuild Python maps from the .idx files
        (which the native loop writes synchronously).  Drainer-thread only —
        it takes every volume's write lock in turn."""
        from seaweedfs_tpu_torch.storage.needle_map import (
            AppendIndex,
            reset_persistent_map,
        )

        for loc in self.store.locations:
            for vol in list(loc.volumes.values()):
                if getattr(vol, "_dp", None) is not self:
                    continue
                with vol._write_lock:
                    vol._swap_seq += 1  # lock-free readers retry across the swap
                    vol.nm.close()
                    # leveldb-kind maps: close() just advanced the durable
                    # high-water mark past the .idx tail whose events were
                    # dropped — a tail replay would skip exactly those
                    # entries, so force a full rebuild
                    reset_persistent_map(vol.base + ".idx")
                    vol.nm = AppendIndex(
                        vol.base + ".idx",
                        kind=vol.needle_map_kind,
                        offset_width=vol.offset_width,
                    )
                    vol.nm.before_read = self.flush_events
                    vol._deleted_bytes = vol._compute_deleted_bytes()
                    vol._swap_seq += 1

    _REPLICA_TTL = 5.0
    _UNRESOLVED_RETRY = 0.25  # seconds between asks for a volume not yet resolved
    _last_unresolved_try = 0.0

    _ADDR_TTL = 60.0

    def _numeric_addr(self, url: str) -> str | None:
        """The native connector speaks inet_pton only: resolve a
        ``host:port`` holder address to ``ipv4:port``.  TTL-cached, never
        forever: a holder rescheduled onto a new IP must stop poisoning
        the fan-out within a minute, not until process restart."""
        import time as _time

        host, _, port = url.rpartition(":")
        if not host or not port:
            return None
        now = _time.monotonic()
        cached = self._addr_cache.get(host)
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
            cached = (ip, now + self._ADDR_TTL)
            self._addr_cache[host] = cached
        return f"{cached[0]}:{port}"

    def _push_replicas(self, force: bool = False) -> None:
        """Refresh the native fan-out's replica addresses for every
        registered replicated volume (holders move; a stale list degrades
        to forwarding, never to wrong fan-out — the peer validates)."""
        resolve = self.replica_resolver
        if resolve is None:
            return
        import time as _time

        now = _time.monotonic()
        due = force or now - self._last_replica_push >= self._REPLICA_TTL
        if due:
            self._last_replica_push = now
        elif not self._unresolved or now - self._last_unresolved_try < self._UNRESOLVED_RETRY:
            return
        self._last_unresolved_try = now
        for loc in self.store.locations:
            for vol in list(loc.volumes.values()):
                if getattr(vol, "_dp", None) is not self:
                    continue
                if vol.super_block.replica_placement.copy_count <= 1:
                    continue
                if not due and vol.id not in self._unresolved:
                    continue
                try:
                    urls = resolve(vol.id)
                except Exception as e:  # noqa: BLE001 — master blip: keep old
                    if wlog.V(2):
                        wlog.info("dp: replica lookup vid=%d failed: %s", vol.id, e)
                    continue
                if not urls:
                    # master blip surfaces as [] too (lookup swallows
                    # RpcError): keep the old list — a stale peer fails
                    # loudly at fan-out, an emptied list would 500 every
                    # replicated write for the whole master outage
                    continue
                if len(urls) < vol.super_block.replica_placement.copy_count - 1:
                    # the master knows too few holders yet: a short set
                    # would make the plane refuse every write ("replication
                    # short") until the next push; ask again next pass
                    continue
                numeric = [self._numeric_addr(u) for u in urls]
                if None in numeric:
                    continue  # unresolvable holder: keep forwarding
                self._lib.sw_dp_set_replicas(
                    self._h, vol.id, ",".join(numeric).encode()
                )
                self._unresolved.discard(vol.id)

    def _drain_loop(self) -> None:
        while not self._stop.wait(0.05):
            try:
                self.flush_events()
                with self._ev_lock:
                    pending, self._resync_pending = self._resync_pending, False
                if pending:
                    self._resync()
                self._push_replicas()
                self.drain_trace_events()
            except Exception as e:  # noqa: BLE001 — drainer must not die
                wlog.error("dp: event drain failed: %s", e)

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 9)()
        self._lib.sw_dp_stats(self._h, out)
        return {
            "native_reads": out[0],
            "native_writes": out[1],
            "forwarded": out[2],
            "read_bytes": out[3],
            "write_bytes": out[4],
            "not_found": out[5],
            "errors": out[6],
            "connections": out[7],
            # spans shed on trace-ring overflow: an incomplete trace in
            # /debug/tracez should be attributable to drops, not to a hop
            # that went dark
            "trace_spans_dropped": out[8],
        }

    def metrics_snapshot(self) -> dict:
        """Per-verb request counters + latency histograms in the shape
        stats.SnapshotFamily renders (polled-snapshot seam: the C++ loop
        only bumps atomics; /metrics scrapes pay for the copy)."""
        out = (ctypes.c_uint64 * (len(_VERBS) * _METRICS_PER_VERB))()
        self._lib.sw_dp_metrics(self._h, out)
        snap = {}
        for i, verb in enumerate(_VERBS):
            at = i * _METRICS_PER_VERB
            count, sum_ns = out[at], out[at + 1]
            cum = 0
            buckets = []
            for b, bound in enumerate(_LATENCY_BOUNDS_S):
                cum += out[at + 2 + b]
                buckets.append((f"{bound:g}", cum))
            snap[verb] = {
                "count": count,
                "sum_seconds": sum_ns / 1e9,
                "buckets": buckets,
            }
        return snap

    def drain_trace_events(self) -> int:
        """Fold native span records (requests the C++ loop served that
        carried a traceparent) into the process trace ring as
        native-plane child spans.  Returns the record count."""
        from seaweedfs_tpu_torch.stats import trace

        total = 0
        with self._tr_lock:
            while True:
                n = self._lib.sw_dp_trace_drain(
                    self._h, self._tr_buf, _TRACE_BUF
                )
                for i in range(n):
                    (
                        trace_id, parent_id, verb, _status, _pad, vid,
                        start_ns, dur_ns,
                    ) = _TRACE.unpack_from(self._tr_buf, i * _TRACE.size)
                    # lower(): the C++ parser accepts uppercase hex but
                    # Python normalizes traceparent ids to lowercase — a
                    # verbatim uppercase id would detach the native span
                    # from its trace
                    trace.record_foreign_span(
                        trace_id.decode("ascii", "replace").lower(),
                        parent_id.decode("ascii", "replace").lower(),
                        name=_VERBS[verb] if verb < len(_VERBS) else "?",
                        service="native_dp",
                        start=start_ns / 1e9,
                        duration_s=dur_ns / 1e9,
                        attrs={"vid": vid},
                    )
                total += n
                if n < _TRACE_BUF // _TRACE.size:
                    break
        return total
