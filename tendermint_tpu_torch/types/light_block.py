"""SignedHeader + LightBlock — the light client's unit of trust
(reference types/light.go)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.libs.safe_codec import register

from .block import Header
from .commit import Commit
from .validator_set import ValidatorSet


class LightValidationError(Exception):
    pass


@register
@dataclass
class SignedHeader:
    """Header + the commit that certifies it (reference types/block.go:579)."""
    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def time(self):
        return self.header.time

    def hash(self) -> bytes:
        return self.header.hash()

    def proto(self) -> bytes:
        from tendermint_tpu_torch.libs import protoenc as pe
        return (pe.message_field_always(1, self.header.proto())
                + pe.message_field_always(2, self.commit.proto()))

    @classmethod
    def from_proto(cls, body: bytes) -> "SignedHeader":
        from tendermint_tpu_torch.libs import protodec as pd
        f = pd.parse(body)
        hdr, com = pd.get_message(f, 1), pd.get_message(f, 2)
        if hdr is None or com is None:
            raise pd.ProtoError("SignedHeader: missing header or commit")
        return cls(Header.from_proto(hdr), Commit.from_proto(com))

    def validate_basic(self, chain_id: str):
        """Reference types/block.go:598-636: internal consistency — the
        commit must be for this header at this height."""
        if self.header is None:
            raise LightValidationError("missing header")
        if self.commit is None:
            raise LightValidationError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise LightValidationError(
                f"header belongs to another chain {self.header.chain_id!r}, "
                f"not {chain_id!r}")
        if self.commit.height != self.header.height:
            raise LightValidationError(
                f"header and commit height mismatch: "
                f"{self.header.height} vs {self.commit.height}")
        if self.commit.block_id.hash != self.header.hash():
            raise LightValidationError(
                "commit signs block "
                f"{self.commit.block_id.hash.hex()}, header is "
                f"{self.header.hash().hex()}")


@register
@dataclass
class LightBlock:
    """SignedHeader + the validator set that (claims to have) produced it
    (reference types/light.go:12-17)."""
    signed_header: SignedHeader
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def time(self):
        return self.signed_header.time

    def hash(self) -> bytes:
        return self.signed_header.hash()

    def proto(self) -> bytes:
        from tendermint_tpu_torch.libs import protoenc as pe
        return (pe.message_field_always(1, self.signed_header.proto())
                + pe.message_field_always(2, self.validators.proto()))

    @classmethod
    def from_proto(cls, body: bytes) -> "LightBlock":
        from tendermint_tpu_torch.libs import protodec as pd
        f = pd.parse(body)
        sh, vs = pd.get_message(f, 1), pd.get_message(f, 2)
        if sh is None or vs is None:
            raise pd.ProtoError("LightBlock: missing field")
        return cls(SignedHeader.from_proto(sh), ValidatorSet.from_proto(vs))

    def validate_basic(self, chain_id: str):
        """Reference types/light.go:57-80."""
        if self.signed_header is None:
            raise LightValidationError("missing signed header")
        if self.validators is None:
            raise LightValidationError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validators.validate_basic()
        if self.signed_header.header.validators_hash != self.validators.hash():
            raise LightValidationError(
                "light block's validator set hash "
                f"{self.validators.hash().hex()} does not match header's "
                f"{self.signed_header.header.validators_hash.hex()}")
