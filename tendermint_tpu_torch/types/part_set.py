"""PartSet — block split into 64KB merkle-proved parts for gossip
(reference types/part_set.go).

This is the reference's mechanism for moving one large logical item in
verifiable chunks; the part-set root is what proposals commit to.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe
from tendermint_tpu_torch.libs.bits import BitArray

from .basic import PartSetHeader

BLOCK_PART_SIZE_BYTES = 65536  # reference types/params.go:19


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self):
        if self.index < 0:
            raise ValueError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError("part too big")
        if (self.proof.total < 0 or self.proof.index < 0
                or len(self.proof.leaf_hash) != 32):
            raise ValueError("invalid part proof")

    def proto(self) -> bytes:
        proof_body = (
            pe.varint_field(1, self.proof.total)
            + pe.varint_field(2, self.proof.index)
            + pe.bytes_field(3, self.proof.leaf_hash)
            + pe.repeated_bytes_field(4, self.proof.aunts))
        return (pe.varint_field(1, self.index)
                + pe.bytes_field(2, self.bytes_)
                + pe.message_field_always(3, proof_body))

    @classmethod
    def from_proto(cls, body: bytes) -> "Part":
        f = pd.parse(body)
        proof_body = pd.get_message(f, 3)
        if proof_body is None:
            raise pd.ProtoError("part missing proof")
        pf = pd.parse(proof_body)
        proof = merkle.Proof(
            total=pd.get_int(pf, 1, 0),
            index=pd.get_int(pf, 2, 0),
            leaf_hash=pd.get_bytes(pf, 3),
            aunts=pd.get_messages(pf, 4))
        return cls(index=pd.get_int(f, 1, 0), bytes_=pd.get_bytes(f, 2),
                   proof=proof)


class PartSet:
    def __init__(self, header: PartSetHeader):
        self.header_ = header
        self.parts: List[Optional[Part]] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes,
                  part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split data into parts with merkle proofs (reference
        types/part_set.go NewPartSetFromData)."""
        chunks = [data[i:i + part_size]
                  for i in range(0, max(len(data), 1), part_size)]
        if not chunks:
            chunks = [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps.add_part(Part(i, chunk, proof))
        return ps

    @classmethod
    def from_data_streaming(cls, regions,
                            part_size: int = BLOCK_PART_SIZE_BYTES) \
            -> "StreamingPartSet":
        """Incremental construction (ADR-024): consume serialized byte
        regions (or one bytes object) and defer per-part proof
        extraction to first use — `iter_parts()` hands part 0 to gossip
        while later parts' proofs are still unextracted.  Root- and
        byte-identical to `from_data` on the same data."""
        return StreamingPartSet(regions, part_size=part_size)

    def header(self) -> PartSetHeader:
        return self.header_

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header_ == header

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against the header and add it; returns
        False if already present (reference types/part_set.go AddPart)."""
        if part.index >= self.header_.total:
            raise ValueError("unexpected part index")
        if self.parts[part.index] is not None:
            return False
        part.validate_basic()
        if not part.proof.verify(self.header_.hash, part.bytes_):
            raise ValueError("wrong part proof")
        if part.proof.total != self.header_.total:
            raise ValueError("wrong proof total")
        if part.proof.index != part.index:
            raise ValueError("wrong proof index")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < len(self.parts):
            return self.parts[index]
        return None

    def is_complete(self) -> bool:
        return self.count == self.header_.total

    def bit_array(self) -> BitArray:
        return self.parts_bit_array.copy()

    def assemble(self) -> bytes:
        """Reassemble the original data; requires completeness."""
        if not self.is_complete():
            raise ValueError("part set incomplete")
        return b"".join(p.bytes_ for p in self.parts)

    def iter_parts(self):
        """Parts in index order (None for absent indices) — the shape
        the proposer's send loop shares with StreamingPartSet."""
        for i in range(self.header_.total):
            yield self.parts[i]


class StreamingPartSet:
    """Proposer/blocksync-side complete part set with LAZY proofs
    (ADR-024).

    Construction consumes the block's serialized byte regions
    (types/block.py proto_regions), chunks them to `part_size`, and
    bulk-hashes the leaf layer across the lanepool host pool
    (crypto/merkle.levels_from_byte_slices); the reduction levels are
    kept so each part's inclusion proof is extracted only when that
    part is first requested.  `iter_parts()` therefore yields a
    proof-complete part 0 while parts 1..N-1 are still proof-less, and
    a consumer that only needs the root (blocksync's crash-resume
    identity check, a store-less replay) never pays for proofs at all.

    Exposes the read-only surface of a COMPLETE PartSet — header /
    is_complete / get_part / iter_parts / byte_size / count / assemble
    — so store.save_block and the block pipeline take it unchanged.
    Byte- and root-identical to PartSet.from_data on the same data
    (pinned in tests/test_propose_fastpath.py).  Not internally locked:
    single consumer at a time (the constructing thread, or whoever it
    hands the set to), matching how decide_proposal and the pipeline
    stage->writer handoff use it.
    """

    def __init__(self, regions, part_size: int = BLOCK_PART_SIZE_BYTES):
        if isinstance(regions, (bytes, bytearray, memoryview)):
            regions = (bytes(regions),)
        buf = bytearray()
        chunks: List[bytes] = []
        for region in regions:
            buf += region
            while len(buf) >= part_size:
                chunks.append(bytes(buf[:part_size]))
                del buf[:part_size]
        if buf or not chunks:
            chunks.append(bytes(buf))
        self._chunks = chunks
        self._levels = merkle.levels_from_byte_slices(chunks)
        self.header_ = PartSetHeader(total=len(chunks),
                                     hash=self._levels[-1][0])
        self._parts: List[Optional[Part]] = [None] * len(chunks)
        self.count = len(chunks)
        self.byte_size = sum(len(c) for c in chunks)

    def header(self) -> PartSetHeader:
        return self.header_

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header_ == header

    def is_complete(self) -> bool:
        return True

    def get_part(self, index: int) -> Optional[Part]:
        if not 0 <= index < len(self._chunks):
            return None
        part = self._parts[index]
        if part is None:
            part = Part(index, self._chunks[index],
                        merkle.proof_at(self._levels, index))
            self._parts[index] = part
        return part

    def iter_parts(self):
        for i in range(len(self._chunks)):
            yield self.get_part(i)

    def assemble(self) -> bytes:
        return b"".join(self._chunks)

    def part_set(self) -> PartSet:
        """Materialize the concrete PartSet (every proof built AND
        verified against the header via add_part)."""
        ps = PartSet(self.header_)
        for part in self.iter_parts():
            ps.add_part(part)
        return ps


def make_block_parts(block) -> "StreamingPartSet | PartSet":
    """The ONE block->parts path the proposer (consensus/state.py
    decide_proposal) and blocksync (blocksync/replay.py block_id_of)
    share: streaming construction over the block's serialized regions,
    degrading to the serial PartSet.from_data on any fault — chaos site
    ``propose.parts`` (raise = serial fallback with byte-identical
    parts; latency = a slow split, absorbed)."""
    from tendermint_tpu_torch.libs import fail
    try:
        fail.inject("propose.parts")
        return PartSet.from_data_streaming(block.proto_regions())
    except Exception:  # noqa: BLE001 - any streaming fault degrades to
        return PartSet.from_data(block.proto())  # the seed-era path
