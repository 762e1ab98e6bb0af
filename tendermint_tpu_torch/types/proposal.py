"""Proposal (reference types/proposal.go)."""
from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe

from .basic import BlockID, SignedMsgType, Timestamp
from .canonical import canonical_proposal_bytes


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int  # -1 when there is no POL round
    block_id: BlockID
    timestamp: Timestamp = field(default_factory=Timestamp.now)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_proposal_bytes(
            chain_id, self.height, self.round, self.pol_round,
            self.block_id, self.timestamp)

    def proto(self) -> bytes:
        return (
            pe.varint_field(1, int(SignedMsgType.PROPOSAL))
            + pe.varint_field(2, self.height)
            + pe.varint_field(3, self.round)
            + pe.varint_field(4, self.pol_round)
            + pe.message_field_always(5, self.block_id.proto())
            + pe.message_field_always(6, self.timestamp.proto())
            + pe.bytes_field(7, self.signature)
        )

    @classmethod
    def from_proto(cls, body: bytes) -> "Proposal":
        f = pd.parse(body)
        if pd.get_int(f, 1, 0) != int(SignedMsgType.PROPOSAL):
            raise pd.ProtoError("not a proposal message")
        bid = pd.get_message(f, 5)
        ts = pd.get_message(f, 6)
        return cls(
            height=pd.get_int(f, 2, 0),
            round=pd.get_int(f, 3, 0),
            pol_round=pd.get_int(f, 4, 0),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
            timestamp=(Timestamp.from_proto(ts) if ts is not None
                       else Timestamp.zero()),
            signature=pd.get_bytes(f, 7))

    def validate_basic(self):
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError(
                "polRound must be -1 or in [0, round)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("expected a complete, non-empty BlockID")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")
