"""ABCI gRPC transport (reference abci/client/grpc_client.go:1-435 +
abci/server/grpc_server.go) — the third transport of the reference's
matrix (builtin / socket / grpc).

Built on grpcio's generic handler API with the SAME byte-exact codec
the socket transport uses (abci/wire.py): a gRPC method's payload is
the bare Request*/Response* message, which is exactly the socket
oneof envelope's embedded body — so both transports share every
encoder/decoder and the reference-generated golden fixtures
(tests/test_abci_golden.py) cover this transport too.  No codegen:
the service is declared by (method, payload codec) pairs against
`tendermint.abci.ABCIApplication` (proto/tendermint/abci/types.proto:425).
"""
from __future__ import annotations

try:
    import grpc
except ImportError:  # optional dep: grpc_util.require_grpc() raises a
    grpc = None      # clear error before any use can be reached

from tendermint_tpu_torch.libs import grpc_util
from tendermint_tpu_torch.libs import log as tmlog
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs.service import BaseService

from . import types as abci
from . import wire

_logger = tmlog.logger("abci.grpc")

SERVICE = "tendermint.abci.ABCIApplication"

# gRPC method name -> the wire codec's snake_case oneof name
_METHODS = (
    ("Echo", "echo"), ("Flush", "flush"), ("Info", "info"),
    ("DeliverTx", "deliver_tx"), ("CheckTx", "check_tx"),
    ("Query", "query"), ("Commit", "commit"),
    ("InitChain", "init_chain"), ("BeginBlock", "begin_block"),
    ("EndBlock", "end_block"), ("ListSnapshots", "list_snapshots"),
    ("OfferSnapshot", "offer_snapshot"),
    ("LoadSnapshotChunk", "load_snapshot_chunk"),
    ("ApplySnapshotChunk", "apply_snapshot_chunk"),
    ("PrepareProposal", "prepare_proposal"),
    ("ProcessProposal", "process_proposal"),
)


def _strip(envelope: bytes) -> bytes:
    """Oneof envelope (one embedded field) -> bare sub-message bytes."""
    f = pd.parse(envelope)
    bodies = [v for vals in f.values() for wt, v in vals
              if wt == pd.WT_BYTES]
    if len(bodies) != 1:
        raise pd.ProtoError("oneof envelope: want exactly one field")
    return bodies[0]


def encode_request_bare(method: str, req) -> bytes:
    """Internal request -> bare Request<Method> message bytes."""
    return _strip(wire.encode_request(method, req))


def decode_request_bare(method: str, data: bytes):
    """Bare Request<Method> bytes -> internal request object."""
    from tendermint_tpu_torch.libs import protoenc as pe

    envelope = pe.message_field_always(wire._REQ[method], data)
    got, req = wire.decode_request(envelope)
    assert got == method
    return req


def encode_response_bare(method: str, resp) -> bytes:
    """Internal response -> bare Response<Method> message bytes."""
    return _strip(wire.encode_response(method, resp))


def decode_response_bare(method: str, data: bytes):
    """Bare Response<Method> bytes -> internal response object."""
    from tendermint_tpu_torch.libs import protoenc as pe

    envelope = pe.message_field_always(wire._RSP[method], data)
    got, resp = wire.decode_response(envelope)
    assert got == method
    return resp


class GRPCServer(BaseService):
    """Serve an in-process Application over gRPC (reference
    abci/server/grpc_server.go).  Unlike the socket transport there is
    no per-connection ordering guarantee at this layer; the reference
    documents the same caveat — consensus callers serialize through the
    proxy's lock (and this server's app lock), and gRPC is primarily the
    query/mempool-facing transport in the reference's e2e matrix."""

    def __init__(self, app: abci.Application, addr: str,
                 max_workers: int = 4):
        super().__init__("abci-grpc-server")
        self.app = app
        self._addr = addr
        self._server = None
        self._max_workers = max_workers
        # same cross-connection discipline as the socket server: the
        # in-process apps are not assumed re-entrant
        import threading
        self._app_lock = threading.Lock()

    @property
    def addr(self) -> str:
        return self._addr

    def _handler(self, oneof: str):
        from .server import dispatch_request

        def unary(req_bytes, ctx):
            try:
                req = decode_request_bare(oneof, req_bytes)
            except Exception as e:  # noqa: BLE001 - bad client bytes
                ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"undecodable {oneof} request: {e}")
            try:
                with self._app_lock:
                    resp = dispatch_request(self.app, oneof, req)
                return encode_response_bare(oneof, resp)
            except Exception as e:  # noqa: BLE001 - app bug -> status
                _logger.error("app raised", method=oneof, err=str(e))
                ctx.abort(grpc.StatusCode.INTERNAL, str(e))

        return grpc_util.raw_unary_handler(unary)

    def on_start(self):
        handlers = {m: self._handler(o) for m, o in _METHODS}
        self._server, self._addr = grpc_util.serve_generic(
            SERVICE, handlers, self._addr, self._max_workers, "abci-grpc")
        _logger.info("ABCI gRPC server up", addr=self._addr)

    def on_stop(self):
        if self._server is not None:
            self._server.stop(grace=1.0).wait()


class GRPCClient(abci.Application):
    """Present a remote gRPC ABCI application through the in-process
    `Application` interface (reference abci/client/grpc_client.go) —
    drop-in alternative to client.SocketClient."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self.addr = addr
        try:
            self._channel = grpc_util.connect_channel(
                addr, connect_timeout, "gRPC ABCI app")
        except ConnectionError as e:
            from .client import ABCIClientError
            raise ABCIClientError(str(e))
        self._stubs = {oneof: grpc_util.raw_stub(self._channel, SERVICE, m)
                       for m, oneof in _METHODS}

    def close(self):
        self._channel.close()

    def _call(self, method: str, req):
        data = encode_request_bare(method, req)
        try:
            out = self._stubs[method](data, timeout=60.0)
        except grpc.RpcError as e:
            from .client import ABCIClientError
            raise ABCIClientError(f"gRPC ABCI call {method}: {e}")
        return decode_response_bare(method, out)

    def echo(self, msg: str) -> str:
        return self._call("echo", msg)

    def flush(self) -> None:
        self._call("flush", None)

    # -- Application interface --------------------------------------------

    def info(self, req): return self._call("info", req)

    def init_chain(self, req): return self._call("init_chain", req)

    def query(self, req): return self._call("query", req)

    def check_tx(self, req): return self._call("check_tx", req)

    def begin_block(self, req): return self._call("begin_block", req)

    def deliver_tx(self, tx: bytes): return self._call("deliver_tx", tx)

    def end_block(self, height: int): return self._call("end_block", height)

    def commit(self): return self._call("commit", None)

    def list_snapshots(self):
        return self._call("list_snapshots", None)

    def offer_snapshot(self, snapshot, app_hash):
        return self._call("offer_snapshot", (snapshot, app_hash))

    def load_snapshot_chunk(self, height, format_, index):
        return self._call("load_snapshot_chunk", (height, format_, index))

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call("apply_snapshot_chunk", (index, chunk, sender))

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)
