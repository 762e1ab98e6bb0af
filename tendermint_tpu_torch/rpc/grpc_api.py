"""gRPC broadcast API (reference rpc/grpc/types.proto BroadcastAPI +
rpc/grpc/api.go): the two-method legacy convenience service —
Ping(RequestPing) and BroadcastTx(RequestBroadcastTx{tx=1}) returning
ResponseBroadcastTx{check_tx=1, deliver_tx=2} with the abci response
sub-messages.  BroadcastTx has broadcast_tx_commit semantics (reference
api.go:19 routes through core.BroadcastTxCommit).

Same no-codegen approach as the ABCI gRPC transport (abci/grpc.py):
grpcio generic handlers with the in-tree proto codec; the abci
sub-messages reuse the socket codec byte-for-byte.  Gated by
`[rpc] grpc_laddr` (reference config/config.go GRPCListenAddress).
"""
from __future__ import annotations

try:
    import grpc
except ImportError:  # optional dep: grpc_util.require_grpc() raises a
    grpc = None      # clear error before any use can be reached

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.grpc import (decode_response_bare,
                                      encode_response_bare)
from tendermint_tpu_torch.libs import grpc_util
from tendermint_tpu_torch.libs import log as tmlog
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.libs.service import BaseService

_logger = tmlog.logger("rpc.grpc")

SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


def _enc_broadcast_response(check_tx: abci.ResponseCheckTx,
                            deliver_tx: abci.ResponseDeliverTx) -> bytes:
    return (pe.message_field_always(
                1, encode_response_bare("check_tx", check_tx)) +
            pe.message_field_always(
                2, encode_response_bare("deliver_tx", deliver_tx)))


def _dec_broadcast_response(data: bytes):
    f = pd.parse(data)
    ct = decode_response_bare("check_tx", pd.get_bytes(f, 1))
    dt = decode_response_bare("deliver_tx", pd.get_bytes(f, 2))
    return ct, dt


class GRPCBroadcastServer(BaseService):
    """Serve BroadcastAPI next to (not on) the JSON-RPC listener,
    routing BroadcastTx through the node's broadcast_tx_commit handler
    (reference rpc/grpc/client_server.go StartGRPCServer)."""

    def __init__(self, rpc_handlers, addr: str):
        super().__init__("rpc-grpc")
        self._rpc = rpc_handlers  # rpc/server.RPCServer (handler methods)
        self._addr = addr
        self._server = None

    @property
    def addr(self) -> str:
        return self._addr

    def on_start(self):
        def ping(_req_bytes, _ctx):
            return b""  # ResponsePing {}

        def broadcast_tx(req_bytes, ctx):
            try:
                f = pd.parse(req_bytes)
                tx = pd.get_bytes(f, 1)
                # full abci response objects — data/gas/events/codespace
                # survive onto the wire (reference BroadcastAPI returns
                # the complete ResponseCheckTx/ResponseDeliverTx)
                ct, dt, _h = self._rpc.broadcast_tx_commit_raw(tx)
                return _enc_broadcast_response(
                    ct, dt if dt is not None else abci.ResponseDeliverTx())
            except Exception as e:  # noqa: BLE001 - surface as status
                _logger.error("BroadcastTx failed", err=str(e))
                ctx.abort(grpc.StatusCode.INTERNAL, str(e))

        handlers = {
            "Ping": grpc_util.raw_unary_handler(ping),
            "BroadcastTx": grpc_util.raw_unary_handler(broadcast_tx),
        }
        # BroadcastTx blocks up to ~30s waiting for commit, so keep
        # enough workers that in-flight broadcasts never starve Ping
        self._server, self._addr = grpc_util.serve_generic(
            SERVICE, handlers, self._addr, 8, "rpc-grpc")
        _logger.info("gRPC broadcast API up", laddr=self._addr)

    def on_stop(self):
        if self._server is not None:
            self._server.stop(grace=1.0).wait()


class GRPCBroadcastClient:
    """Reference rpc/grpc/client_server.go StartGRPCClient."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self.addr = addr
        self._channel = grpc_util.connect_channel(
            addr, connect_timeout, "gRPC broadcast API")
        self._ping = grpc_util.raw_stub(self._channel, SERVICE, "Ping")
        self._btx = grpc_util.raw_stub(self._channel, SERVICE,
                                       "BroadcastTx")

    def close(self):
        self._channel.close()

    def ping(self) -> None:
        self._ping(b"", timeout=10.0)

    def broadcast_tx(self, tx: bytes, timeout: float = 60.0):
        """Returns (ResponseCheckTx, ResponseDeliverTx)."""
        out = self._btx(pe.bytes_field(1, tx), timeout=timeout)
        return _dec_broadcast_response(out)
