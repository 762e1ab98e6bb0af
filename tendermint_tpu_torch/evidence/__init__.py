"""Evidence subsystem (reference evidence/): pool of verified Byzantine
evidence + verification + gossip reactor.  The evidence TYPES live in
types/evidence.py (wire-stable proto encoding, usable by blocks)."""
from tendermint_tpu_torch.types.evidence import (DuplicateVoteEvidence, Evidence,
                                           EvidenceError,
                                           LightClientAttackEvidence,
                                           evidence_from_proto,
                                           evidence_list_hash,
                                           evidence_proto)
from .pool import EvidencePool
from .reactor import EvidenceReactor, EVIDENCE_CHANNEL
from .verify import verify_duplicate_vote, verify_light_client_attack

__all__ = [
    "Evidence", "EvidenceError", "DuplicateVoteEvidence",
    "LightClientAttackEvidence", "EvidencePool", "EvidenceReactor",
    "EVIDENCE_CHANNEL", "evidence_from_proto", "evidence_proto",
    "evidence_list_hash", "verify_duplicate_vote",
    "verify_light_client_attack",
]
