"""Trusted light-block store (reference light/store/db/db.go) over kvdb."""
from __future__ import annotations

import struct
from typing import List, Optional

from tendermint_tpu_torch.libs import safe_codec
from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.types.light_block import LightBlock

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">q", height)


class LightStore:
    def __init__(self, db: KVDB):
        self.db = db

    def save(self, lb: LightBlock) -> None:
        self.db.set(_key(lb.height), safe_codec.dumps(lb))

    def get(self, height: int) -> Optional[LightBlock]:
        raw = self.db.get(_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    def heights(self) -> List[int]:
        out = []
        for k, _ in self.db.iterate_prefix(_PREFIX):
            out.append(struct.unpack(">q", k[len(_PREFIX):])[0])
        return sorted(out)

    def latest(self) -> Optional[LightBlock]:
        hs = self.heights()
        return self.get(hs[-1]) if hs else None

    def first(self) -> Optional[LightBlock]:
        hs = self.heights()
        return self.get(hs[0]) if hs else None

    def latest_before(self, height: int) -> Optional[LightBlock]:
        hs = [h for h in self.heights() if h <= height]
        return self.get(hs[-1]) if hs else None

    def delete(self, height: int) -> None:
        self.db.delete(_key(height))

    def prune(self, keep: int) -> None:
        """Drop oldest blocks beyond `keep` (reference db.go Prune)."""
        hs = self.heights()
        for h in hs[:-keep] if keep else hs:
            self.delete(h)
