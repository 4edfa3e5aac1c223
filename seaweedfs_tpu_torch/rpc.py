"""Generic gRPC plumbing: stubs and service registration from descriptors.

The port's counterpart of seaweedfs_tpu/rpc.py.  There are no generated
``*_pb2_grpc.py`` stubs: this module reflects the service descriptors
embedded in the generated ``*_pb2`` modules and wires grpcio's generic
handler API, one code path for every service, streaming included.

Server side: implement a class with snake_case methods named after the RPC
(``def ec_shards_generate(self, request, context)``) and register it with
:func:`add_service`; every handler runs the server-side fault hook and,
when the call carries a ``traceparent``, a span joined to the caller's
trace.  Client side: :func:`make_stub` (or the typed helpers below)
returns an object with the CamelCase method names the proto declares,
and every call runs through the resilience layer (util/resilience.py)
and the fault-injection harness (util/faults.py):

* trace context rides as ``traceparent`` metadata (stats/trace.py),
* unary calls get a default deadline (not the heavyweight admin RPCs of
  ``resilience.NO_DEFAULT_DEADLINE``), bounded full-jitter retries on
  UNAVAILABLE (and DEADLINE_EXCEEDED for idempotent methods), and a
  per-peer circuit breaker,
* streaming calls are breaker-gated and observed, but never replayed:
  a consumed request or response stream is not safely retriable,
* a peer answering UNAVAILABLE has its cached channel evicted, so a
  server restarted on the same address reconnects,
* ``WEED_FAULTS`` injects deterministic failures on both the client and
  the server side of this seam.

With ``WEEDTPU_TLS_CA/CERT/KEY`` set, every server port and every client
channel is mutual TLS (:func:`tls_config`); without them, plaintext.
"""

from __future__ import annotations

import re
import threading
from concurrent import futures

import grpc
from google.protobuf import message_factory

_MAX_MSG = 256 * 1024 * 1024
_GRPC_OPTIONS = [
    ("grpc.max_send_message_length", _MAX_MSG),
    ("grpc.max_receive_message_length", _MAX_MSG),
]

_SERVICE_SHORT = {"volumeserver": "volume", "mqbroker": "mq"}


def service_label(service_name: str) -> str:
    """Short label shared by traces, metrics, and WEED_FAULTS targets."""
    low = service_name.lower()
    return _SERVICE_SHORT.get(low, low)


def snake_case(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def _msg_class(descriptor):
    return message_factory.GetMessageClass(descriptor)


def _method_kind(method) -> str:
    cs, ss = method.client_streaming, method.server_streaming
    return {
        (False, False): "unary_unary",
        (False, True): "unary_stream",
        (True, False): "stream_unary",
        (True, True): "stream_stream",
    }[(cs, ss)]


def _note_peer_error(address: str, e: Exception) -> None:
    """A real UNAVAILABLE from a peer poisons its cached channel: evict it
    so the next attempt re-dials instead of riding subchannel backoff."""
    from seaweedfs_tpu_torch.util import resilience

    if address and resilience.error_code(e) is grpc.StatusCode.UNAVAILABLE:
        evict_channel(address)


class _ObservedStream:
    """Iterates a streaming call, feeding its outcome to the peer's
    breaker; everything else (cancel(), code(), ...) passes through.

    Only UNAVAILABLE counts as a breaker failure here: DEADLINE_EXCEEDED
    is how deliberately short-deadline polling streams (SubscribeMetadata
    and friends) end every healthy pass, so it proves nothing about the
    peer — a pass that yielded items even counts as a success."""

    def __init__(self, inner, breaker, address: str):
        self._inner = inner
        self._breaker = breaker
        self._address = address
        self._yielded = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = next(self._inner)
        except StopIteration:
            if self._breaker is not None:
                self._breaker.record_success()
            raise
        except grpc.RpcError as e:
            from seaweedfs_tpu_torch.util import resilience

            _note_peer_error(self._address, e)
            # a stream that yielded proved liveness even on DEADLINE
            # (polling streams end every healthy pass that way); one
            # that yielded nothing gives no verdict but must return a
            # held half-open probe slot
            resilience.note_rpc_outcome(
                self._breaker,
                resilience.error_code(e),
                on_deadline="success" if self._yielded else "release",
            )
            raise
        if not self._yielded:
            self._yielded = True
            if self._breaker is not None:
                # first item proves the peer lives NOW — a long-lived
                # healthy stream consumed as the half-open probe must not
                # hold the probe slot (blocking every other RPC to this
                # peer) until it someday ends
                self._breaker.record_success()
        return item

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _resilient_call(stub, path, kind, req_ser, resp_des, service, method):
    """One stub method: trace metadata + fault injection + the policy.

    Reserved kwarg ``wd_max_attempts`` overrides the retry budget for
    this call (failover layers pass 1 so peer rotation stays snappy)."""

    def call(request, timeout=None, metadata=None, **kwargs):
        from seaweedfs_tpu_torch.stats import trace
        from seaweedfs_tpu_torch.util import faults, resilience

        address = stub._address
        max_attempts = kwargs.pop("wd_max_attempts", None)
        extra = trace.grpc_metadata()
        if extra:
            metadata = list(metadata or []) + extra
        if (
            timeout is None
            and kind == "unary_unary"
            and method not in resilience.NO_DEFAULT_DEADLINE
        ):
            timeout = resilience.policy().deadline_s

        def invoke():
            faults.inject_client(service, method, address, timeout=timeout)
            ch = stub._channel_now()
            mc = stub._mc_cache.get(path)
            if mc is None or mc[0] is not ch:
                # (re)build only when the channel changed (post-eviction);
                # hot-path calls reuse the multicallable
                mc = (
                    ch,
                    getattr(ch, kind)(
                        path,
                        request_serializer=req_ser,
                        response_deserializer=resp_des,
                    ),
                )
                stub._mc_cache[path] = mc
            try:
                return mc[1](request, timeout=timeout, metadata=metadata, **kwargs)
            except grpc.RpcError as e:
                _note_peer_error(address, e)
                raise

        if kind == "unary_unary":
            return resilience.call_unary(
                invoke,
                service=service,
                method=method,
                address=address,
                max_attempts=max_attempts,
            )
        # streaming: a partly-consumed stream is not replayable, so no
        # transparent retry — just the breaker gate and outcome tracking
        br = resilience.breakers.get(address)
        if br is not None and not br.allow():
            raise resilience.CircuitOpenError(address)
        try:
            result = invoke()
        except grpc.RpcError as e:
            resilience.note_rpc_outcome(
                br, resilience.error_code(e), on_deadline="release"
            )
            raise
        except BaseException:
            if br is not None:
                br.release_probe()  # died client-side: no verdict
            raise
        if kind in ("unary_stream", "stream_stream"):
            if br is not None:
                # an open stream holds no half-open probe slot: an idle
                # polling stream (SubscribeMetadata) that took the slot
                # every pass would shed every unary call to a recovered
                # peer as "circuit open"; its outcome still reaches the
                # breaker as it yields or ends
                br.release_probe()
            return _ObservedStream(result, br, address)
        if br is not None:
            br.record_success()
        return result

    return call


class Stub:
    """Dynamic client stub for one service descriptor at one address:
    the address keys the peer's breaker, its cached channel (evicted after
    an UNAVAILABLE) and the address-targeted fault rules."""

    def __init__(self, address: str, pb2_module, service_name: str):
        self._address = address
        # path -> (channel, multicallable); rebuilt only after an eviction
        self._mc_cache: dict[str, tuple] = {}
        service = pb2_module.DESCRIPTOR.services_by_name[service_name]
        label = service_label(service_name)
        for method in service.methods:
            setattr(
                self,
                method.name,
                _resilient_call(
                    self,
                    f"/{service.full_name}/{method.name}",
                    _method_kind(method),
                    _msg_class(method.input_type).SerializeToString,
                    _msg_class(method.output_type).FromString,
                    label,
                    method.name,
                ),
            )

    def _channel_now(self) -> grpc.Channel:
        """Resolve the channel per call: after an eviction the next
        attempt dials fresh instead of reusing a dead subchannel."""
        return cached_channel(self._address)


def make_stub(address: str, pb2_module, service_name: str) -> Stub:
    """Address-keyed stub over the shared channel cache."""
    return Stub(address, pb2_module, service_name)


def _traced_impl(impl, rpc_name: str, service: str, server_streaming: bool):
    """Wrap a servicer method in the server-side fault hook and a span
    seeded from the call's ``traceparent`` metadata.  Calls with no
    inbound context run the impl untraced (heartbeat/lookup chatter must
    not flood the trace ring); traced calls join the caller's trace.
    Response-streaming impls return generators, so the span covers the
    (lazy) consumption — via trace.stream_span, which installs the
    context only while the iterator actually executes (a suspended
    long-lived stream must not leak its context onto a shared gRPC
    worker thread)."""

    def unary(request, context):
        from seaweedfs_tpu_torch.stats import trace
        from seaweedfs_tpu_torch.util import faults

        faults.inject_server(service, rpc_name, context)
        parent = trace.extract_grpc(context)
        if parent is None:
            return impl(request, context)
        with trace.span(rpc_name, service=service, parent=parent):
            return impl(request, context)

    def streaming(request, context):
        from seaweedfs_tpu_torch.stats import trace
        from seaweedfs_tpu_torch.util import faults

        faults.inject_server(service, rpc_name, context)
        parent = trace.extract_grpc(context)
        if parent is None:
            yield from impl(request, context)
            return
        yield from trace.stream_span(
            lambda: impl(request, context),
            rpc_name,
            service=service,
            parent=parent,
        )

    return streaming if server_streaming else unary


def add_service(server: grpc.Server, pb2_module, service_name: str, servicer) -> None:
    """Register ``servicer`` (snake_case method impls) for a proto service."""
    service = pb2_module.DESCRIPTOR.services_by_name[service_name]
    label = service_label(service_name)
    handlers = {}
    for method in service.methods:
        impl = getattr(servicer, snake_case(method.name), None)
        if impl is None:
            continue
        kind = _method_kind(method)
        handler_factory = getattr(grpc, f"{kind}_rpc_method_handler")
        handlers[method.name] = handler_factory(
            _traced_impl(impl, method.name, label, method.server_streaming),
            request_deserializer=_msg_class(method.input_type).FromString,
            response_serializer=_msg_class(method.output_type).SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service.full_name, handlers),)
    )


def make_server(max_workers: int = 16) -> grpc.Server:
    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers), options=_GRPC_OPTIONS
    )


_tls_config = None


def tls_config():
    """Cluster gRPC TLS settings (reference security.toml grpc section):
    resolved once from WEEDTPU_TLS_CA/CERT/KEY.  With a CA configured,
    every server bind and client dial below is mutually authenticated."""
    global _tls_config
    if _tls_config is None:
        from seaweedfs_tpu_torch.security.tls import TlsConfig

        _tls_config = TlsConfig()
    return _tls_config


def add_port(server: grpc.Server, address: str) -> int:
    """Bind a server port, secure when the cluster runs TLS."""
    tls = tls_config()
    if tls.enabled:
        return server.add_secure_port(address, tls.server_credentials())
    return server.add_insecure_port(address)


_channel_cache: dict[str, grpc.Channel] = {}
_channel_lock = threading.Lock()


def cached_channel(address: str) -> grpc.Channel:
    """Connection cache, one channel per target (grpc_client_be.go analogue)."""
    with _channel_lock:
        ch = _channel_cache.get(address)
        if ch is None:
            tls = tls_config()
            if tls.enabled:
                # the peer's cert must carry the address it is dialed by
                # in its SANs (tls.gen -host takes care of that)
                ch = grpc.secure_channel(
                    address, tls.channel_credentials(), options=_GRPC_OPTIONS
                )
            else:
                ch = grpc.insecure_channel(address, options=_GRPC_OPTIONS)
            _channel_cache[address] = ch
        return ch


def evict_channel(address: str) -> None:
    """Drop a dead peer's cached channel, so the next call re-dials instead
    of riding the old channel's reconnect backoff (a restarted server).
    The channel is not closed here: calls of other threads may still ride
    it, and closing would turn their answers into CANCELLED; it closes when
    the last stub holding it goes."""
    with _channel_lock:
        ch = _channel_cache.pop(address, None)
    if ch is None:
        return
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.util import wlog

    stats.RPC_CHANNEL_EVICTIONS.inc(peer=address)
    if wlog.V(1):
        wlog.info("rpc: evicted cached channel to %s", address)


def master_stub(address: str) -> Stub:
    from seaweedfs_tpu_torch.pb import master_pb2

    return Stub(address, master_pb2, "Master")


def volume_stub(address: str) -> Stub:
    from seaweedfs_tpu_torch.pb import volume_server_pb2

    return Stub(address, volume_server_pb2, "VolumeServer")


def filer_stub(address: str) -> Stub:
    from seaweedfs_tpu_torch.pb import filer_pb2

    return Stub(address, filer_pb2, "Filer")
