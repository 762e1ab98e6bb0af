"""GenesisDoc (reference types/genesis.go:38)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from tendermint_tpu_torch.crypto import ed25519 as edkeys
from tendermint_tpu_torch.crypto import tmhash

from .basic import Timestamp
from .params import ConsensusParams
from .validator import Validator

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    address: bytes
    pub_key_type: str
    pub_key_bytes: bytes
    power: int
    name: str = ""

    def to_validator(self) -> Validator:
        from tendermint_tpu_torch.crypto import pubkey_from_type_name
        return Validator.new(
            pubkey_from_type_name(self.pub_key_type, self.pub_key_bytes),
            self.power)


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp.now)
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self):
        """Reference types/genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long "
                             f"(max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(
                    f"genesis file cannot contain validators with no voting "
                    f"power: {v.name or i}")
            addr = tmhash.sum(v.pub_key_bytes)[:20]
            if v.address and v.address != addr:
                raise ValueError(
                    f"genesis validator {i} address does not match its key")
            if not v.address:
                v.address = addr

    # -- JSON persistence --------------------------------------------------

    def to_json(self) -> str:
        from tendermint_tpu_torch.libs import amino_json as aj
        return json.dumps({
            "genesis_time": aj.ts_rfc3339(self.genesis_time),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": {
                "block": {
                    "max_bytes": str(self.consensus_params.block.max_bytes),
                    "max_gas": str(self.consensus_params.block.max_gas),
                    "time_iota_ms":
                        str(self.consensus_params.block.time_iota_ms),
                },
                "evidence": {
                    "max_age_num_blocks": str(
                        self.consensus_params.evidence.max_age_num_blocks),
                    "max_age_duration_seconds": str(
                        self.consensus_params.evidence
                        .max_age_duration_seconds),
                    "max_bytes": str(self.consensus_params.evidence.max_bytes),
                },
                "validator": {
                    "pub_key_types":
                        self.consensus_params.validator.pub_key_types,
                },
            },
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": aj.pub_key_json(v.pub_key_type,
                                               v.pub_key_bytes),
                    "power": str(v.power),
                    "name": v.name,
                } for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
            "app_state": self.app_state.decode("utf-8"),
        }, indent=2)

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        d = json.loads(data)
        from .params import (BlockParams, EvidenceParams, ValidatorParams)
        cp = ConsensusParams()
        if "consensus_params" in d:
            dcp = d["consensus_params"]
            cp.block = BlockParams(
                max_bytes=int(dcp["block"]["max_bytes"]),
                max_gas=int(dcp["block"]["max_gas"]),
                time_iota_ms=int(dcp["block"].get("time_iota_ms", 1000)))
            cp.evidence = EvidenceParams(
                max_age_num_blocks=int(dcp["evidence"]["max_age_num_blocks"]),
                max_age_duration_seconds=int(
                    dcp["evidence"]["max_age_duration_seconds"]),
                max_bytes=int(dcp["evidence"]["max_bytes"]))
            cp.validator = ValidatorParams(
                pub_key_types=list(dcp["validator"]["pub_key_types"]))
        from tendermint_tpu_torch.libs import amino_json as aj
        gt = d.get("genesis_time", {})
        if isinstance(gt, str):
            # amino dialect: RFC3339 (reference genesis.json)
            genesis_time = aj.parse_rfc3339(gt)
        else:
            # legacy {seconds, nanos} docs keep loading
            genesis_time = Timestamp(int(gt.get("seconds", 0)),
                                     int(gt.get("nanos", 0)))

        def _val(v):
            ktype, kbytes = aj.pub_key_from_json(v["pub_key"])
            return GenesisValidator(
                address=bytes.fromhex(v.get("address", "")),
                pub_key_type=ktype, pub_key_bytes=kbytes,
                power=int(v["power"]), name=v.get("name", ""))

        doc = cls(
            chain_id=d["chain_id"],
            genesis_time=genesis_time,
            initial_height=int(d.get("initial_height", 1)),
            consensus_params=cp,
            validators=[_val(v) for v in d.get("validators", [])],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=json.dumps(d.get("app_state", {})).encode(),
        )
        doc.validate_and_complete()
        return doc

    def save_as(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())

    def validator_set(self):
        from .validator_set import ValidatorSet
        return ValidatorSet([v.to_validator() for v in self.validators])
