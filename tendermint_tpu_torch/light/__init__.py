"""Light client (reference light/): stateless verification, bisection
client, witness fork detection, providers + trusted store (BASELINE
config 3: skipping verification over huge validator sets rides the
card's batch plane), the LightServe serving plane (light.service) and
the RPC proxy (light.proxy)."""
from . import verifier
from .client import Client, LightClientError, TrustOptions
from .detector import Divergence, detect_divergence
from .provider import (DictProvider, NodeBackedProvider, Provider,
                       ProviderError)
from .store import LightStore

__all__ = [
    "verifier", "Client", "TrustOptions", "LightClientError", "LightStore",
    "Provider", "DictProvider", "NodeBackedProvider", "ProviderError",
    "Divergence", "detect_divergence",
]
