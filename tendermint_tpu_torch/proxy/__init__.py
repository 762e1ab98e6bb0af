"""Proxy AppConns (reference proxy/app_conn.go:16-57 + multi_app_conn.go):
the node's four logical connections to one application — consensus,
mempool, query, snapshot — each its own ordered channel so a slow query
never blocks block execution.

ClientCreator mirrors proxy/client.go: local (in-process, shared instance)
or remote (one socket per connection)."""
from __future__ import annotations

from typing import Callable

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import SocketClient


class ClientCreator:
    """proxy/client.go NewLocalClientCreator / NewRemoteClientCreator."""

    def __init__(self, factory: Callable[[], abci.Application]):
        self._factory = factory

    @classmethod
    def local(cls, app: abci.Application) -> "ClientCreator":
        return cls(lambda: app)

    @classmethod
    def remote(cls, addr: str) -> "ClientCreator":
        """unix:///tcp:// the proto-framed socket transport.  grpc://
        selects the gRPC transport in the reference (proxy/client.go
        NewRemoteClientCreator transport arg); this package has no gRPC
        transport yet (abci/grpc.py and libs/grpc_util.py come with the
        P2P, state sync and RPC modules, ROADMAP Queue 1 item 8), so a
        grpc:// address raises RuntimeError here."""
        if addr.startswith("grpc://"):
            raise RuntimeError(
                f"ABCI address {addr!r}: the gRPC transport (abci/grpc.py) "
                "is not ported to tendermint_tpu_torch yet (ROADMAP Queue 1 "
                "item 8); use unix:// or tcp://")
        return cls(lambda: SocketClient(addr))

    def new_client(self) -> abci.Application:
        return self._factory()


class AppConns:
    """Reference proxy/multi_app_conn.go: four connections, one app."""

    def __init__(self, creator: ClientCreator):
        self.consensus = creator.new_client()
        self.mempool = creator.new_client()
        self.query = creator.new_client()
        self.snapshot = creator.new_client()

    def stop(self):
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            close = getattr(c, "close", None)
            if close is not None:
                close()
