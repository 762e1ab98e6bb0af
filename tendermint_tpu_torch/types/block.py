"""Block, Header, Data (reference types/block.go).

Header.hash() merkle-izes the 14 header fields exactly as the reference
(types/block.go:440-475): each leaf is the field's protobuf encoding, with
scalars wrapped in gogotypes *Value messages (encoding_helper.go cdcEncode).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle, tmhash
from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe

from .basic import BlockID, Timestamp
from .commit import Commit

MAX_HEADER_BYTES = 626  # reference types/block.go:32


@dataclass(frozen=True)
class Consensus:
    """Version info (proto/tendermint/version/types.proto Consensus)."""
    block: int = 11  # BlockProtocol (reference version/version.go:22)
    app: int = 0

    def proto(self) -> bytes:
        return pe.varint_field(1, self.block) + pe.varint_field(2, self.app)

    @classmethod
    def from_proto(cls, body: bytes) -> "Consensus":
        f = pd.parse(body)
        return cls(block=pd.get_int(f, 1, 0), app=pd.get_int(f, 2, 0))


def _wrap_string(s: str) -> bytes:
    return pe.string_field(1, s)


def _wrap_int64(v: int) -> bytes:
    return pe.varint_field(1, v)


def _wrap_bytes(b: bytes) -> bytes:
    return pe.bytes_field(1, b)


@dataclass
class Header:
    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> Optional[bytes]:
        """Merkle root of the proto-encoded fields (reference
        types/block.go:440); None until validators_hash is populated."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices([
            self.version.proto(),
            _wrap_string(self.chain_id),
            _wrap_int64(self.height),
            self.time.proto(),
            self.last_block_id.proto(),
            _wrap_bytes(self.last_commit_hash),
            _wrap_bytes(self.data_hash),
            _wrap_bytes(self.validators_hash),
            _wrap_bytes(self.next_validators_hash),
            _wrap_bytes(self.consensus_hash),
            _wrap_bytes(self.app_hash),
            _wrap_bytes(self.last_results_hash),
            _wrap_bytes(self.evidence_hash),
            _wrap_bytes(self.proposer_address),
        ])

    def proto(self) -> bytes:
        return (
            pe.message_field_always(1, self.version.proto())
            + pe.string_field(2, self.chain_id)
            + pe.varint_field(3, self.height)
            + pe.message_field_always(4, self.time.proto())
            + pe.message_field_always(5, self.last_block_id.proto())
            + pe.bytes_field(6, self.last_commit_hash)
            + pe.bytes_field(7, self.data_hash)
            + pe.bytes_field(8, self.validators_hash)
            + pe.bytes_field(9, self.next_validators_hash)
            + pe.bytes_field(10, self.consensus_hash)
            + pe.bytes_field(11, self.app_hash)
            + pe.bytes_field(12, self.last_results_hash)
            + pe.bytes_field(13, self.evidence_hash)
            + pe.bytes_field(14, self.proposer_address)
        )

    @classmethod
    def from_proto(cls, body: bytes) -> "Header":
        f = pd.parse(body)
        ver = pd.get_message(f, 1)
        ts = pd.get_message(f, 4)
        bid = pd.get_message(f, 5)
        return cls(
            version=(Consensus.from_proto(ver) if ver is not None
                     else Consensus(0, 0)),
            chain_id=pd.get_string(f, 2),
            height=pd.get_int(f, 3, 0),
            time=(Timestamp.from_proto(ts) if ts is not None
                  else Timestamp.zero()),
            last_block_id=(BlockID.from_proto(bid) if bid is not None
                           else BlockID()),
            last_commit_hash=pd.get_bytes(f, 6),
            data_hash=pd.get_bytes(f, 7),
            validators_hash=pd.get_bytes(f, 8),
            next_validators_hash=pd.get_bytes(f, 9),
            consensus_hash=pd.get_bytes(f, 10),
            app_hash=pd.get_bytes(f, 11),
            last_results_hash=pd.get_bytes(f, 12),
            evidence_hash=pd.get_bytes(f, 13),
            proposer_address=pd.get_bytes(f, 14))

    def validate_basic(self):
        if len(self.chain_id) > 50:
            raise ValueError("chain_id too long")
        if self.height < 0:
            raise ValueError("negative height")
        self.last_block_id.validate_basic()
        for name in ("last_commit_hash", "data_hash", "validators_hash",
                     "next_validators_hash", "consensus_hash",
                     "last_results_hash", "evidence_hash"):
            h = getattr(self, name)
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"wrong {name} size")
        if (self.proposer_address
                and len(self.proposer_address) != 20):
            raise ValueError("invalid proposer address size")


@dataclass
class Data:
    """Transactions in the block (reference types/block.go Data)."""
    txs: List[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(list(self.txs))

    def proto(self) -> bytes:
        return pe.repeated_bytes_field(1, self.txs)

    @classmethod
    def from_proto(cls, body: bytes) -> "Data":
        return cls(txs=pd.get_messages(pd.parse(body), 1))


def tx_hash(tx: bytes) -> bytes:
    """Tx key for mempool/index (reference types/tx.go Hash = SHA-256)."""
    return tmhash.sum(tx)


@dataclass
class Block:
    header: Header
    data: Data
    evidence: List = field(default_factory=list)
    last_commit: Optional[Commit] = None

    def hash(self) -> Optional[bytes]:
        return self.header.hash()

    def proto(self) -> bytes:
        ev_body = b"".join(
            pe.message_field_always(1, e.proto()) for e in self.evidence)
        out = (pe.message_field_always(1, self.header.proto())
               + pe.message_field_always(2, self.data.proto())
               + pe.message_field_always(3, ev_body))
        if self.last_commit is not None:
            out += pe.message_field_always(4, self.last_commit.proto())
        return out

    def proto_regions(self):
        """The serialized block as an ordered sequence of byte regions:
        ``b"".join(proto_regions())`` is byte-identical to ``proto()``
        (pinned in tests/test_propose_fastpath.py).  The data region —
        the bulk of a full block — is emitted per-tx after a precomputed
        length prefix, so the streaming part-set builder (ADR-024) can
        chunk and leaf-hash without ever materializing one contiguous
        copy of the whole block."""
        yield pe.message_field_always(1, self.header.proto())
        # per-tx entries encoded ONCE: their lengths give the field-2
        # body length, then they flow out coalesced into ~part-size
        # regions, so the streaming chunker's per-region cost scales
        # with part count, not tx count, and no single contiguous copy
        # of the whole data section ever exists
        entries = [pe.message_field_always(1, tx)
                   for tx in self.data.txs]
        yield pe.tag(2, pe.WT_BYTES) + pe.uvarint(
            sum(map(len, entries)))
        acc, acc_len = [], 0
        for e in entries:
            acc.append(e)
            acc_len += len(e)
            if acc_len >= 1 << 16:
                yield b"".join(acc)
                acc, acc_len = [], 0
        if acc:
            yield b"".join(acc)
        ev_body = b"".join(
            pe.message_field_always(1, e.proto()) for e in self.evidence)
        yield pe.message_field_always(3, ev_body)
        if self.last_commit is not None:
            yield pe.message_field_always(4, self.last_commit.proto())

    @classmethod
    def from_proto(cls, data: bytes) -> "Block":
        """Decode a wire/storage Block (inverse of proto()).  Raises
        protodec.ProtoError on malformed bytes — safe on Byzantine input."""
        f = pd.parse(data)
        hdr = pd.get_message(f, 1)
        dat = pd.get_message(f, 2)
        if hdr is None or dat is None:
            raise pd.ProtoError("block missing header or data")
        evidence = []
        ev_body = pd.get_message(f, 3)
        if ev_body:
            try:
                from tendermint_tpu_torch.types import evidence as ev_mod
            except ImportError as e:
                raise pd.ProtoError("evidence decoding unavailable") from e
            evidence = [ev_mod.evidence_from_proto(e)
                        for e in pd.get_messages(pd.parse(ev_body), 1)]
        lc = pd.get_message(f, 4)
        return cls(
            header=Header.from_proto(hdr),
            data=Data.from_proto(dat),
            evidence=evidence,
            last_commit=Commit.from_proto(lc) if lc is not None else None)

    def fill_header(self):
        """Populate derived header hashes (reference types/block.go
        fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = merkle.hash_from_byte_slices(
                [e.bytes() for e in self.evidence])

    def validate_basic(self):
        """Reference types/block.go:62-101 — the header-to-content binding
        checks are UNCONDITIONAL: an empty hash field never exempts a block
        from committing to its own contents (a Byzantine proposer could
        otherwise ship arbitrary txs under an empty data_hash)."""
        self.header.validate_basic()
        if self.last_commit is None:
            raise ValueError("nil LastCommit")
        self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
        ev_hash = merkle.hash_from_byte_slices(
            [e.bytes() for e in self.evidence])
        if self.header.evidence_hash != ev_hash:
            raise ValueError("wrong EvidenceHash")


@dataclass
class BlockMeta:
    """Stored per-height block metadata (reference types/block_meta.go)."""
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int
