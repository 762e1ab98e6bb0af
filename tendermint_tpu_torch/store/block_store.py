"""Block store (reference store/store.go): blocks stored as parts + meta +
commits keyed by height/hash.

SaveBlock persists the block's parts, meta, and the commits atomically in
one batch (reference store/store.go:331); LoadBlock reassembles from parts
(reference store/store.go:93).
"""
from __future__ import annotations

from tendermint_tpu_torch.libs import safe_codec
import threading
from typing import Optional

from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.block import Block, BlockMeta
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.part_set import PartSet


def _meta_key(height: int) -> bytes:
    return b"H:%d" % height

def _part_key(height: int, index: int) -> bytes:
    return b"P:%d:%d" % (height, index)

def _commit_key(height: int) -> bytes:
    return b"C:%d" % height

def _seen_commit_key(height: int) -> bytes:
    return b"SC:%d" % height

def _hash_key(block_hash: bytes) -> bytes:
    return b"BH:" + block_hash

_STORE_STATE_KEY = b"blockStore"


class BlockStore:
    def __init__(self, db: KVDB):
        self.db = db
        self._lock = threading.RLock()
        raw = db.get(_STORE_STATE_KEY)
        if raw is not None:
            self._base, self._height = safe_codec.loads(raw)
        else:
            self._base, self._height = 0, 0

    def base(self) -> int:
        with self._lock:
            return self._base

    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return 0 if self._height == 0 else self._height - self._base + 1

    # -- save (reference store/store.go:331) -------------------------------

    def save_block(self, block: Block, part_set: PartSet,
                   seen_commit: Commit):
        if not part_set.is_complete():
            raise ValueError("cannot save block with incomplete part set")
        height = block.header.height
        with self._lock:
            if self._height > 0 and height != self._height + 1:
                raise ValueError(
                    f"cannot save block at height {height}, expected "
                    f"{self._height + 1}")
            block_id = BlockID(block.hash(), part_set.header())
            meta = BlockMeta(block_id=block_id,
                             block_size=part_set.byte_size,
                             header=block.header,
                             num_txs=len(block.data.txs))
            sets = [(_meta_key(height), safe_codec.dumps(meta)),
                    (_hash_key(block.hash()), b"%d" % height),
                    (_seen_commit_key(height), safe_codec.dumps(seen_commit))]
            for i in range(part_set.header().total):
                sets.append((_part_key(height, i),
                             safe_codec.dumps(part_set.get_part(i))))
            if block.last_commit is not None:
                sets.append((_commit_key(height - 1),
                             safe_codec.dumps(block.last_commit)))
            new_base = self._base or height
            sets.append((_STORE_STATE_KEY, safe_codec.dumps((new_base, height))))
            self.db.write_batch(sets)
            self._base, self._height = new_base, height

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        """Persist a certifying commit without its block — the statesync
        bootstrap anchor (reference store/store.go:415 SaveSeenCommit).
        Routed through write_batch so it commits immediately like every
        other block-store write instead of riding the deferred
        single-op window (ADR-017): the anchor must be durable before
        the statesync handoff reports success."""
        self.db.write_batch(
            [(_seen_commit_key(height), safe_codec.dumps(commit))])

    # -- load (reference store/store.go:93-246) ----------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self.db.get(_meta_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        ps = PartSet(meta.block_id.part_set_header)
        for i in range(meta.block_id.part_set_header.total):
            raw = self.db.get(_part_key(height, i))
            if raw is None:
                return None
            ps.add_part(safe_codec.loads(raw))
        # parts carry the canonical proto Block encoding (the same bytes
        # that were gossiped and hash-bound by the part-set root)
        return Block.from_proto(ps.assemble())

    def load_block_by_hash(self, block_hash: bytes) -> Optional[Block]:
        h = self.height_by_hash(block_hash)
        return self.load_block(h) if h is not None else None

    def height_by_hash(self, block_hash: bytes) -> Optional[int]:
        raw = self.db.get(_hash_key(block_hash))
        return int(raw) if raw is not None else None

    def load_block_part(self, height: int, index: int):
        raw = self.db.get(_part_key(height, index))
        return safe_codec.loads(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        raw = self.db.get(_commit_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self.db.get(_seen_commit_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    # -- prune (reference store/store.go:248) ------------------------------

    def prune_blocks(self, retain_height: int) -> int:
        with self._lock:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise ValueError("cannot prune beyond store height")
            pruned = 0
            deletes = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_meta_key(h))
                deletes.append(_hash_key(meta.block_id.hash))
                deletes.append(_seen_commit_key(h))
                deletes.append(_commit_key(h - 1))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_part_key(h, i))
                pruned += 1
            deletes_sets = [(_STORE_STATE_KEY,
                             safe_codec.dumps((retain_height, self._height)))]
            self.db.write_batch(deletes_sets, deletes)
            self._base = retain_height
            return pruned
