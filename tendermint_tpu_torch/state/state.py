"""Replicated-state summary (reference state/state.go:47-80).

State is the deterministic digest of the chain at a height: validator sets
(last/current/next), consensus params, app hash, last results.  Blocks are
constructed from it (make_block) and it advances via
execution.update_state after each ABCI round.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.types.basic import BlockID, Timestamp
from tendermint_tpu_torch.types.block import Block, Consensus, Data, Header
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import ValidatorSet

# reference version/version.go:22
BLOCK_PROTOCOL = 11


@dataclass
class State:
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time: Timestamp
    next_validators: ValidatorSet
    validators: ValidatorSet
    last_validators: Optional[ValidatorSet]
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_height_consensus_params_changed: int
    last_results_hash: bytes
    app_hash: bytes
    app_version: int = 0

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.copy(),
            validators=self.validators.copy(),
            last_validators=(self.last_validators.copy()
                             if self.last_validators else None),
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=
                self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            app_version=self.app_version,
        )

    def is_empty(self) -> bool:
        return self.validators is None or self.validators.size() == 0

    # -- block construction (reference state/state.go:249-282) -------------

    def make_block(self, height: int, txs: List[bytes],
                   last_commit: Commit, evidence: List,
                   proposer_address: bytes,
                   block_time: Optional[Timestamp] = None) -> Block:
        header = Header(
            version=Consensus(block=BLOCK_PROTOCOL, app=self.app_version),
            chain_id=self.chain_id,
            height=height,
            time=block_time or self._median_time(last_commit),
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            proposer_address=proposer_address,
        )
        block = Block(header=header, data=Data(txs=list(txs)),
                      evidence=list(evidence), last_commit=last_commit)
        block.fill_header()
        return block

    def _median_time(self, commit: Commit) -> Timestamp:
        """BFT time: weighted median of commit vote timestamps (reference
        state/state.go MedianTime, spec/consensus/bft-time.md)."""
        if (commit is None or self.last_validators is None
                or self.last_validators.size() == 0
                or self.last_block_height == 0):
            return Timestamp.now()
        weighted: List[Tuple[Timestamp, int]] = []
        for i, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            _, val = self.last_validators.get_by_index(i)
            if val is not None:
                weighted.append((cs.timestamp, val.voting_power))
        if not weighted:
            return Timestamp.now()
        weighted.sort(key=lambda wt: (wt[0].seconds, wt[0].nanos))
        total = sum(p for _, p in weighted)
        half = total // 2
        acc = 0
        for ts, p in weighted:
            acc += p
            if acc > half:
                return ts
        return weighted[-1][0]


def state_from_genesis(gdoc: GenesisDoc) -> State:
    """Reference state/state.go MakeGenesisState."""
    gdoc.validate_and_complete()
    val_set = gdoc.validator_set()
    next_vals = val_set.copy_increment_proposer_priority(1)
    return State(
        chain_id=gdoc.chain_id,
        initial_height=gdoc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=gdoc.genesis_time,
        next_validators=next_vals,
        validators=val_set,
        last_validators=None,
        last_height_validators_changed=gdoc.initial_height,
        consensus_params=gdoc.consensus_params,
        last_height_consensus_params_changed=gdoc.initial_height,
        last_results_hash=merkle.hash_from_byte_slices([]),
        app_hash=gdoc.app_hash,
    )
