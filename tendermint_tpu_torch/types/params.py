"""ConsensusParams (reference types/params.go)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import protoenc as pe

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB (reference types/params.go:14)
ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_SR25519 = "sr25519"


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB default (reference types/params.go:66)
    max_gas: int = -1
    # minimum ms between the last block time and a vote time (reference
    # types/params.go DefaultBlockParams TimeIotaMs; used at
    # consensus/state.go voteTime)
    time_iota_ms: int = 1000


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_seconds: int = 48 * 3600
    max_bytes: int = 1048576


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(
        default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519])


@dataclass
class VersionParams:
    app_version: int = 0


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)

    def hash(self) -> bytes:
        """SHA-256 of HashedParams{max_bytes=1, max_gas=2} (reference
        types/params.go:173-191)."""
        body = (pe.varint_field(1, self.block.max_bytes)
                + pe.varint_field(2, self.block.max_gas))
        return tmhash.sum(body)

    def validate_basic(self):
        if self.block.max_bytes <= 0:
            raise ValueError("block.MaxBytes must be greater than 0")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.MaxBytes too big")
        if self.block.max_gas < -1:
            raise ValueError("block.MaxGas must be >= -1")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be positive")
        if not self.validator.pub_key_types:
            raise ValueError("validator.PubKeyTypes must not be empty")

    def update(self, updates) -> "ConsensusParams":
        """Apply an ABCI ConsensusParamsUpdate (reference params.go:193)."""
        out = ConsensusParams(
            block=replace(self.block), evidence=replace(self.evidence),
            validator=ValidatorParams(list(self.validator.pub_key_types)),
            version=replace(self.version))
        if updates is None:
            return out
        if updates.block_max_bytes:
            out.block.max_bytes = updates.block_max_bytes
        if updates.block_max_gas:
            out.block.max_gas = updates.block_max_gas
        return out
