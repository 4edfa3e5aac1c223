"""Generic gRPC plumbing: stubs and service registration from descriptors.

The port's counterpart of seaweedfs_tpu/rpc.py.  There are no generated
``*_pb2_grpc.py`` stubs: this module reflects the service descriptors
embedded in the generated ``*_pb2`` modules and wires grpcio's generic
handler API, one code path for every service, streaming included.

Server side: implement a class with snake_case methods named after the RPC
(``def ec_shards_generate(self, request, context)``) and register it with
:func:`add_service`.  Client side: :func:`volume_stub` returns an object
with the CamelCase method names the proto declares.

Calls here are plain grpcio calls over insecure channels: the JAX
package's resilience layer (default deadlines, retries, breakers) rides
only the callers that ask for it (util/resilience.call_unary, as
wdclient's failover stub does), and those evict a peer's cached channel
when it answers UNAVAILABLE (``evict_channel``).  Trace propagation, fault
injection and TLS are not ported.
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


class Stub:
    """Client stub for one service descriptor over a cached channel: one
    attribute per RPC, named as in the proto."""

    def __init__(self, address: str, pb2_module, service_name: str):
        self._address = address
        channel = cached_channel(address)
        service = pb2_module.DESCRIPTOR.services_by_name[service_name]
        for method in service.methods:
            setattr(self, method.name, getattr(channel, _method_kind(method))(
                f"/{service.full_name}/{method.name}",
                request_serializer=_msg_class(method.input_type).SerializeToString,
                response_deserializer=_msg_class(method.output_type).FromString,
            ))


def add_service(server: grpc.Server, pb2_module, service_name: str, servicer) -> None:
    """Register ``servicer`` (snake_case method impls) for a proto service;
    RPCs it does not implement answer UNIMPLEMENTED."""
    service = pb2_module.DESCRIPTOR.services_by_name[service_name]
    handlers = {}
    for method in service.methods:
        impl = getattr(servicer, snake_case(method.name), None)
        if impl is None:
            continue
        handler_factory = getattr(grpc, f"{_method_kind(method)}_rpc_method_handler")
        handlers[method.name] = handler_factory(
            impl,
            request_deserializer=_msg_class(method.input_type).FromString,
            response_serializer=_msg_class(method.output_type).SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service.full_name, handlers),)
    )


def make_server(max_workers: int = 16) -> grpc.Server:
    return grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers), options=_GRPC_OPTIONS)


def add_port(server: grpc.Server, address: str) -> int:
    """Bind an insecure server port; returns the bound port (0 picks one)."""
    return server.add_insecure_port(address)


_channel_cache: dict[str, grpc.Channel] = {}
_channel_lock = threading.Lock()


def cached_channel(address: str) -> grpc.Channel:
    """Connection cache, one channel per target (grpc_client_be.go analogue)."""
    with _channel_lock:
        ch = _channel_cache.get(address)
        if ch is None:
            ch = grpc.insecure_channel(address, options=_GRPC_OPTIONS)
            _channel_cache[address] = ch
        return ch


def evict_channel(address: str) -> None:
    """Drop a dead peer's cached channel, so the next call re-dials instead
    of riding the old channel's reconnect backoff (a restarted master).
    The channel is not closed here: calls of other threads may still ride
    it, and closing would turn their answers into CANCELLED; it closes when
    the last stub holding it goes."""
    with _channel_lock:
        _channel_cache.pop(address, None)


def volume_stub(address: str) -> Stub:
    from seaweedfs_tpu_torch.pb import volume_server_pb2

    return Stub(address, volume_server_pb2, "VolumeServer")


def master_stub(address: str) -> Stub:
    from seaweedfs_tpu_torch.pb import master_pb2

    return Stub(address, master_pb2, "Master")
