"""Vote (reference types/vote.go).

The sign bytes (`sign_bytes`) are the canonical, length-delimited
CanonicalVote encoding — the msg half of the (pubkey, msg, sig) triples the
card's batch verifier consumes (reference types/vote.go:93, SURVEY.md §3.6).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.libs import protodec as pd
from tendermint_tpu_torch.libs import protoenc as pe

from .basic import BlockID, BlockIDFlag, SignedMsgType, Timestamp
from .canonical import canonical_vote_bytes

MAX_VOTE_BYTES = 209  # reference types/vote.go:35


@dataclass
class Vote:
    type: SignedMsgType
    height: int
    round: int
    block_id: BlockID
    timestamp: Timestamp
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_bytes(chain_id, self.type, self.height,
                                    self.round, self.block_id, self.timestamp)

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def proto(self) -> bytes:
        """tendermint.types.Vote message body (wire/WAL/gossip encoding)."""
        return (
            pe.varint_field(1, int(self.type))
            + pe.varint_field(2, self.height)
            + pe.varint_field(3, self.round)
            + pe.message_field_always(4, self.block_id.proto())
            + pe.message_field_always(5, self.timestamp.proto())
            + pe.bytes_field(6, self.validator_address)
            + pe.varint_field(7, self.validator_index)
            + pe.bytes_field(8, self.signature)
        )

    @classmethod
    def from_proto(cls, body: bytes) -> "Vote":
        f = pd.parse(body)
        bid = pd.get_message(f, 4)
        ts = pd.get_message(f, 5)
        try:
            vtype = SignedMsgType(pd.get_int(f, 1, 0))
        except ValueError as e:
            raise pd.ProtoError(f"bad vote type: {e}") from e
        return cls(
            type=vtype,
            height=pd.get_int(f, 2, 0),
            round=pd.get_int(f, 3, 0),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
            timestamp=(Timestamp.from_proto(ts) if ts is not None
                       else Timestamp.zero()),
            validator_address=pd.get_bytes(f, 6),
            validator_index=pd.get_int(f, 7, 0),
            signature=pd.get_bytes(f, 8))

    def verify(self, chain_id: str, pub_key) -> bool:
        """Single-vote verification (reference types/vote.go:147).  Checks
        the verified-signature cache first: when the consensus receive loop
        has already batch-verified this vote in a coalesced launch, this is
        a hash lookup, not a signature check."""
        from tendermint_tpu_torch.crypto.batch import verified_sigs
        msg = self.sign_bytes(chain_id)
        if verified_sigs.hit(pub_key.bytes(), msg, self.signature):
            return True
        return pub_key.verify_signature(msg, self.signature)

    def validate_basic(self):
        if self.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError("invalid vote type")
        if self.height < 0:
            raise ValueError("negative height")
        if self.round < 0:
            raise ValueError("negative round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError("blockID must be either empty or complete")
        if len(self.validator_address) != 20:
            raise ValueError("wrong validator address size")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature too big")

    def commit_sig(self) -> "CommitSig":
        from .commit import CommitSig
        return CommitSig(
            block_id_flag=(BlockIDFlag.NIL if self.is_nil()
                           else BlockIDFlag.COMMIT),
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )
