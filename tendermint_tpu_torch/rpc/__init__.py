"""RPC surface (reference rpc/): JSON-RPC server over HTTP + client.
Routes mirror rpc/core/routes.go:10-49."""
from .client import HTTPClient, RPCClientError
from .server import RPCError, RPCServer

__all__ = ["RPCServer", "RPCError", "HTTPClient", "RPCClientError"]
