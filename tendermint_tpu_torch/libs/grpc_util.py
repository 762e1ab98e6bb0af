"""Shared plumbing for the no-codegen gRPC services (abci/grpc.py,
rpc/grpc_api.py): raw-bytes generic handlers over the in-tree proto
codec, so grpcio is the only dependency and the byte layout stays under
the wire codecs' golden tests."""
from __future__ import annotations

from concurrent import futures

try:
    import grpc
except ImportError:  # optional dep: the node runs without the gRPC
    grpc = None      # transports; construction raises a clear error


def require_grpc():
    """Raise an actionable error when the optional grpcio dependency is
    absent; every server/channel constructor calls this first."""
    if grpc is None:
        raise RuntimeError(
            "grpcio is not installed: the gRPC transports "
            "(abci/grpc.py, rpc/grpc_api.py) are unavailable — install "
            "grpcio or use the socket transport")
    return grpc


def raw_unary_handler(fn):
    """Wrap a bytes->bytes unary handler (no message classes)."""
    require_grpc()
    return grpc.unary_unary_rpc_method_handler(
        fn,
        request_deserializer=lambda b: b,
        response_serializer=lambda b: b)


def serve_generic(service: str, handlers: dict, addr: str,
                  max_workers: int, thread_prefix: str):
    """Bind + start a generic-handler server.  Returns
    (server, bound_addr) — addr may use port 0 for an ephemeral port."""
    require_grpc()
    server = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=thread_prefix))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service, handlers),))
    port = server.add_insecure_port(addr)
    if port == 0:
        raise OSError(f"cannot bind gRPC server ({service}) at {addr}")
    bound = f"{addr.rsplit(':', 1)[0]}:{port}"
    server.start()
    return server, bound


def connect_channel(addr: str, timeout: float, what: str):
    """Open an insecure channel and wait for readiness; raises
    ConnectionError (channel closed) on timeout."""
    require_grpc()
    channel = grpc.insecure_channel(addr)
    try:
        grpc.channel_ready_future(channel).result(timeout=timeout)
    except grpc.FutureTimeoutError:
        channel.close()
        raise ConnectionError(
            f"cannot connect to {what} at {addr} within {timeout}s")
    return channel


def raw_stub(channel, service: str, method: str):
    return channel.unary_unary(
        f"/{service}/{method}",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b)
