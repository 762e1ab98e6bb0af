"""Consensus timing/behavior config (reference config/config.go:900-1011).

Durations in float seconds; per-round escalation mirrors the reference's
Propose(round) etc. accessors.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ConsensusConfig:
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    double_sign_check_height: int = 0
    # proposer fast-path budgets (ADR-024), all 0 = unlimited (the
    # reference behavior): wall-clock caps on the mempool reap scan and
    # the PrepareProposal round trip, plus a byte cap below the
    # consensus-params block limit — a huge mempool or a slow app
    # degrades the BLOCK (fewer/raw txs), never the round
    propose_reap_budget_ms: float = 0.0
    propose_prepare_budget_ms: float = 0.0
    propose_max_bytes: int = 0

    def validate_basic(self):
        """Reference config/config.go:939-956 ConsensusConfig.ValidateBasic:
        every timeout must be non-negative (deltas included)."""
        for name in ("timeout_propose", "timeout_propose_delta",
                     "timeout_prevote", "timeout_prevote_delta",
                     "timeout_precommit", "timeout_precommit_delta",
                     "timeout_commit", "create_empty_blocks_interval",
                     "propose_reap_budget_ms",
                     "propose_prepare_budget_ms", "propose_max_bytes"):
            if getattr(self, name) < 0:
                raise ValueError(f"consensus.{name} cannot be negative")
        if self.double_sign_check_height < 0:
            raise ValueError(
                "consensus.double_sign_check_height cannot be negative")

    def propose(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit(self) -> float:
        return self.timeout_commit

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks \
            or self.create_empty_blocks_interval > 0


def test_config() -> ConsensusConfig:
    """Scaled-down timeouts for in-process tests (reference
    config/config.go TestConsensusConfig)."""
    return ConsensusConfig(
        timeout_propose=0.4, timeout_propose_delta=0.2,
        timeout_prevote=0.2, timeout_prevote_delta=0.1,
        timeout_precommit=0.2, timeout_precommit_delta=0.1,
        timeout_commit=0.05, skip_timeout_commit=True)
