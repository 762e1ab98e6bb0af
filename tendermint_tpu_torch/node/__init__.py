"""Node assembly (reference node/)."""
from .node import Node, NodeError, handshake

__all__ = ["Node", "NodeError", "handshake"]
