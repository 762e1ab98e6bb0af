"""RPC surface (reference rpc/): for now the JSON-RPC client alone.

The JAX package's rpc/__init__.py also exports its server (RPCServer,
RPCError); the port's server comes with the node, and this package stays
reduced to the client until then."""
from .client import HTTPClient, RPCClientError

__all__ = ["HTTPClient", "RPCClientError"]
