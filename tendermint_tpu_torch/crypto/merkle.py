"""RFC-6962-style merkle tree (reference crypto/merkle/tree.go, hash.go).

Domain separation: leaf = SHA-256(0x00 || data), inner = SHA-256(0x01 || L
|| R); empty tree hashes to SHA-256("").  Split point is the largest power
of two strictly less than n (reference crypto/merkle/tree.go:92).

Host-side (hashlib) implementation; the batched TPU tree-hash kernel for
large leaf sets plugs in behind the same functions later (SURVEY.md §7
native-component ledger item 4).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(data: bytes) -> bytes:
    return _sha256(_LEAF_PREFIX + data)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(_INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two < n."""
    b = 1 << (n - 1).bit_length() - 1 if n > 1 else 0
    if b == n:
        b >>= 1
    return b


def _hash_level(level: List[bytes]) -> List[bytes]:
    """One reduction level: adjacent pairs inner-hashed, an odd last
    node promoted unchanged."""
    nxt = [_sha256(_INNER_PREFIX + level[i] + level[i + 1])
           for i in range(0, len(level) - 1, 2)]
    if len(level) % 2:
        nxt.append(level[-1])
    return nxt


def _leaf_chunk(items: List[bytes]) -> List[bytes]:
    """Serial leaf layer over one contiguous chunk — row-wise pure, so
    lanepool.map_sharded chunk boundaries cannot change any digest."""
    return [_sha256(_LEAF_PREFIX + it) for it in items]


# rows smaller than this make the leaf layer handoff-bound (one SHA-256
# of a ~100-byte tx costs well under a microsecond against ~50 us of
# thread handoff), so small-row lists shard only in big slabs; 64KB
# block parts amortize the handoff at the lanepool floor of 8
_BULK_BIG_ROW = 4096
_BULK_SMALL_ROW_CHUNK = 512


def bulk_leaf_hashes(items: List[bytes]) -> List[bytes]:
    """Leaf layer (SHA-256(0x00 || item) per row) for the whole list,
    sharded across the crypto/lanepool host pool when the shape
    justifies it.  Order-stable by construction (chunk i owns rows
    [lo_i, hi_i)), and any pool-path fault — an injected fault at site
    ``merkle.bulk_hash``, a chunk exception, a short chunk — recomputes
    the whole layer serially in the caller: byte-identical output
    either way."""
    n = len(items)
    if n >= 2 * 8:  # below two lanepool.MIN_CHUNKs nothing can shard
        min_chunk = (8 if len(items[n // 2]) >= _BULK_BIG_ROW
                     else _BULK_SMALL_ROW_CHUNK)
        try:
            from tendermint_tpu_torch.libs import fail
            fail.inject("merkle.bulk_hash")
            from tendermint_tpu_torch.crypto import lanepool
            out = lanepool.map_sharded(_leaf_chunk, items,
                                       min_chunk=min_chunk)
            if out is not None:
                return out
        except Exception:  # noqa: BLE001 - any pool fault degrades to
            pass           # the serial in-caller layer below
    return _leaf_chunk(items)


def hash_from_byte_slices(items: List[bytes]) -> bytes:
    """Root hash of a list of byte slices (reference crypto/merkle/tree.go:9).

    Iterative level-by-level reduction: because the reference split
    point is the largest power of two strictly below n, its recursive
    tree is identical to pairwise reduction with the odd node promoted
    (pinned against the recursive oracle in tests/test_pipeline.py).
    The leaf layer — the dominant cost, all the input bytes — rides
    the lanepool sharded path; reduction levels stay serial (32-byte
    rows shrink geometrically).
    """
    n = len(items)
    if n == 0:
        return _sha256(b"")
    level = bulk_leaf_hashes(items)
    while len(level) > 1:
        level = _hash_level(level)
    return level[0]


def levels_from_byte_slices(items: List[bytes]) -> List[List[bytes]]:
    """Every reduction level bottom-up for a NON-EMPTY item list:
    levels[0] is the (bulk-hashed) leaf row, levels[-1] the one-row
    root.  The streaming part set (types/part_set.py, ADR-024) keeps
    these to extract per-part proofs lazily."""
    if not items:
        raise ValueError("levels need at least one item")
    levels = [bulk_leaf_hashes(items)]
    while len(levels[-1]) > 1:
        levels.append(_hash_level(levels[-1]))
    return levels


@dataclass
class Proof:
    """Merkle inclusion proof (reference crypto/merkle/proof.go)."""
    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes]

    def compute_root(self) -> bytes:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash,
                                   self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = self.compute_root()
        return computed is not None and computed == root


def _compute_from_aunts(index: int, total: int, leaf: bytes,
                        aunts: List[bytes]) -> Optional[bytes]:
    if total == 0 or index >= total:
        return None
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        return None if left is None else inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return None if right is None else inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: List[bytes]):
    """(root, [Proof]) for every item (reference crypto/merkle/proof.go:52).

    Iterative sibling of hash_from_byte_slices: build every reduction
    level once, then read each leaf's aunts straight off the levels
    (the sibling at each level, bottom-up; a promoted odd node has no
    aunt at that level).  Identical trees — and therefore identical
    aunt lists — to the reference's recursive trail construction; the
    part-set split on the pipeline stage thread is the hot caller.
    """
    n = len(items)
    if n == 0:
        return _sha256(b""), []
    levels = levels_from_byte_slices(items)
    root = levels[-1][0]
    return root, [proof_at(levels, i) for i in range(n)]


def proof_at(levels: List[List[bytes]], i: int) -> Proof:
    """The one leaf's inclusion proof read straight off prebuilt
    reduction levels (the sibling at each level, bottom-up; a promoted
    odd node has no aunt at that level) — identical aunt lists to the
    reference's recursive trail construction."""
    aunts = []
    idx = i
    for level in levels[:-1]:
        sib = idx ^ 1
        if sib < len(level):
            aunts.append(level[sib])
        idx >>= 1
    return Proof(total=len(levels[0]), index=i, leaf_hash=levels[0][i],
                 aunts=aunts)


# ---------------------------------------------------------------------------
# multi-op proofs: chained merkle trees (reference crypto/merkle/proof_op.go,
# proof_value.go, proof_key_path.go) — e.g. IAVL value -> store root ->
# app hash, verified by the light client RPC proxy
# ---------------------------------------------------------------------------

class ProofError(Exception):
    pass


@dataclass
class ProofOp:
    """Wire form of one operator (reference proto tendermint/crypto
    ProofOp)."""
    type: str
    key: bytes
    data: bytes


def key_path_to_keys(path: str) -> List[bytes]:
    """Reference proof_key_path.go:87 — '/' separated, 'x:' hex parts,
    URL-escaped raw parts."""
    import binascii
    from urllib.parse import unquote_to_bytes

    if not path or path[0] != "/":
        raise ProofError("key path must start with '/'")
    keys = []
    for i, part in enumerate(path[1:].split("/")):
        if part.startswith("x:"):
            try:
                keys.append(binascii.unhexlify(part[2:]))
            except (binascii.Error, ValueError) as e:
                raise ProofError(f"bad hex part #{i}: {part}") from e
        else:
            keys.append(unquote_to_bytes(part))
    return keys


def key_path_append(path: str, key: bytes, hex_encode: bool = False) -> str:
    from urllib.parse import quote_from_bytes
    part = f"x:{key.hex()}" if hex_encode else quote_from_bytes(key)
    return path + "/" + part


class ValueOp:
    """Leaf operator: proves value under key in a simple merkle tree of
    length-prefixed KV pairs (reference proof_value.go)."""

    TYPE = "simple:v"

    def __init__(self, key: bytes, proof: Proof):
        self.key = key
        self.proof = proof

    def get_key(self) -> bytes:
        return self.key

    def run(self, args: List[bytes]) -> List[bytes]:
        if len(args) != 1:
            raise ProofError(f"ValueOp expects 1 arg, got {len(args)}")
        from tendermint_tpu_torch.libs.protoenc import uvarint

        vhash = _sha256(args[0])
        kv = (uvarint(len(self.key)) + self.key
              + uvarint(len(vhash)) + vhash)
        if leaf_hash(kv) != self.proof.leaf_hash:
            raise ProofError("leaf hash mismatch")
        root = self.proof.compute_root()
        if root is None:
            raise ProofError("invalid proof structure")
        return [root]

    def proof_op(self) -> ProofOp:
        from tendermint_tpu_torch.libs import protoenc as pe
        body = (pe.varint_field(1, self.proof.total)
                + pe.varint_field(2, self.proof.index)
                + pe.bytes_field(3, self.proof.leaf_hash)
                + pe.repeated_bytes_field(4, self.proof.aunts))
        return ProofOp(self.TYPE, self.key, pe.message_field_always(1, body))

    @classmethod
    def decode(cls, pop: ProofOp) -> "ValueOp":
        from tendermint_tpu_torch.libs import protodec as pd
        f = pd.parse(pop.data)
        body = pd.get_message(f, 1)
        if body is None:
            raise ProofError("ValueOp missing proof")
        pf = pd.parse(body)
        proof = Proof(total=pd.get_int(pf, 1, 0), index=pd.get_int(pf, 2, 0),
                      leaf_hash=pd.get_bytes(pf, 3),
                      aunts=pd.get_messages(pf, 4))
        return cls(pop.key, proof)


class ProofOperators(list):
    """Reference proof_op.go:30-69: apply operators in sequence, consuming
    the keypath last-to-first, and match the final root."""

    def verify(self, root: bytes, keypath: str, args: List[bytes]) -> None:
        keys = key_path_to_keys(keypath)
        for i, op in enumerate(self):
            key = op.get_key()
            if key:
                if not keys:
                    raise ProofError(
                        f"key path exhausted at op #{i} (key {key!r})")
                if keys[-1] != key:
                    raise ProofError(
                        f"key mismatch at op #{i}: {keys[-1]!r} != {key!r}")
                keys = keys[:-1]
            args = op.run(args)
        if args[0] != root:
            raise ProofError(
                f"root mismatch: {args[0].hex()} != {root.hex()}")
        if keys:
            raise ProofError("keypath not fully consumed")

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(root, keypath, [value])


class ProofRuntime:
    """Registry of op decoders (reference proof.go:180 ProofRuntime);
    default knows ValueOp."""

    def __init__(self):
        self._decoders = {}

    def register(self, type_: str, decoder):
        self._decoders[type_] = decoder

    def decode(self, pops: List[ProofOp]) -> ProofOperators:
        out = ProofOperators()
        for pop in pops:
            dec = self._decoders.get(pop.type)
            if dec is None:
                raise ProofError(f"unknown proof op type {pop.type!r}")
            out.append(dec(pop))
        return out

    def verify_value(self, pops: List[ProofOp], root: bytes, keypath: str,
                     value: bytes) -> None:
        self.decode(pops).verify_value(root, keypath, value)


def default_proof_runtime() -> ProofRuntime:
    rt = ProofRuntime()
    rt.register(ValueOp.TYPE, ValueOp.decode)
    return rt


def proofs_from_kv_map(kvs: dict):
    """(root, {key: ValueOp}) over a map of key -> value, with KV leaves
    hashed as <len-prefixed key, len-prefixed sha256(value)> in sorted-key
    order (reference proof.go ProofsFromMap + kvpair semantics)."""
    from tendermint_tpu_torch.libs.protoenc import uvarint

    keys = sorted(kvs)
    leaves = [uvarint(len(k)) + k + uvarint(32) + _sha256(kvs[k])
              for k in keys]
    root, proofs = proofs_from_byte_slices(leaves)
    return root, {k: ValueOp(k, proofs[i]) for i, k in enumerate(keys)}
