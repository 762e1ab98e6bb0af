"""Node identity (reference p2p/key.go): an ed25519 key whose address (20
bytes) in hex is the node ID."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519 as edkeys


@dataclass
class NodeKey:
    priv_key: edkeys.PrivKey

    @property
    def node_id(self) -> str:
        return self.priv_key.pub_key().address().hex()

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(edkeys.PrivKey.generate())

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            return cls(edkeys.PrivKey(bytes.fromhex(d["priv_key"])))
        nk = cls.generate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"id": nk.node_id,
                       "priv_key": nk.priv_key.bytes().hex()}, f, indent=2)
        return nk
