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
        """grpc://host:port selects the gRPC transport (reference
        proxy/client.go NewRemoteClientCreator transport arg);
        unix:///tcp:// the proto-framed socket transport."""
        if addr.startswith("grpc://"):
            target = addr[len("grpc://"):]

            def make():
                from tendermint_tpu_torch.abci.grpc import GRPCClient
                return GRPCClient(target)
            return cls(make)
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
