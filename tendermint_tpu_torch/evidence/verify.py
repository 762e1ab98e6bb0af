"""Evidence verification against a full node's state
(reference evidence/verify.go).

The port's departure from the JAX package's module: both entry points take
`device` (None: the package default, "cuda") and pass it to the
verifications they make, vsched.verify_items and
ValidatorSet.verify_commit_light*.  verify_duplicate_vote's two lanes are
below the 32-signature device threshold, as in the JAX package: a
VerifyScheduler running on that device coalesces them into its window,
otherwise they take the host lanes.  That is the reference's routing, not a
fallback.  A launch that failed on the card (degrade.DeviceLaneError) is
not an EvidenceError: it leaves these functions as it is."""
from __future__ import annotations

from fractions import Fraction

from tendermint_tpu_torch.crypto import scheduler as vsched
from tendermint_tpu_torch.types.evidence import (DuplicateVoteEvidence,
                                           EvidenceError,
                                           LightClientAttackEvidence)
from tendermint_tpu_torch.types.validator_set import (CommitVerifyError,
                                                ValidatorSet)

TRUST_LEVEL = Fraction(1, 3)


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str,
                          val_set: ValidatorSet, device=None) -> None:
    """Reference evidence/verify.go:161-214: H/R/S and address match,
    different block IDs, power fields match the set, both signatures valid
    (one 2-lane batch)."""
    _, val = val_set.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise EvidenceError(
            f"address {ev.vote_a.validator_address.hex()} was not a "
            f"validator at height {ev.height()}")
    a, b = ev.vote_a, ev.vote_b
    if (a.height, a.round, a.type) != (b.height, b.round, b.type):
        raise EvidenceError(
            f"h/r/s does not match: {a.height}/{a.round}/{a.type} vs "
            f"{b.height}/{b.round}/{b.type}")
    if a.validator_address != b.validator_address:
        raise EvidenceError(
            f"validator addresses do not match: "
            f"{a.validator_address.hex()} vs {b.validator_address.hex()}")
    if a.block_id == b.block_id:
        raise EvidenceError(
            f"block IDs are the same ({a.block_id}) - not a real duplicate")
    if val.pub_key.address() != a.validator_address:
        raise EvidenceError("address doesn't match pubkey")
    if val.voting_power != ev.validator_power:
        raise EvidenceError(
            f"validator power from evidence and our set mismatch "
            f"({ev.validator_power} != {val.voting_power})")
    if val_set.total_voting_power() != ev.total_voting_power:
        raise EvidenceError(
            f"total voting power from evidence and our set mismatch "
            f"({ev.total_voting_power} != {val_set.total_voting_power()})")
    # both signatures ride the process-global VerifyScheduler at COMMIT
    # priority (one 2-lane submission coalesced with whatever else is in
    # flight); verify_items falls back to a direct BatchVerifier with
    # the exact same (all_ok, bitmap) contract whenever the scheduler
    # is absent, shedding, or stopping — bitmap-exact either way
    ok, bits = vsched.verify_items(
        [(val.pub_key, a.sign_bytes(chain_id), a.signature),
         (val.pub_key, b.sign_bytes(chain_id), b.signature)],
        vsched.Priority.COMMIT, device=device)
    if not ok:
        which = "VoteA" if not bits[0] else "VoteB"
        raise EvidenceError(f"verifying {which}: invalid signature")


def verify_light_client_attack(ev: LightClientAttackEvidence,
                               common_header, trusted_header,
                               common_vals: ValidatorSet,
                               device=None) -> None:
    """Reference evidence/verify.go:102-156 (time/expiry checks live in the
    pool, which has the state)."""
    if common_header.height != ev.conflicting_block.height:
        # lunatic attack: single skipping hop from the common header
        try:
            common_vals.verify_commit_light_trusting(
                trusted_header.header.chain_id,
                ev.conflicting_block.signed_header.commit, TRUST_LEVEL,
                device=device)
        except CommitVerifyError as e:
            raise EvidenceError(
                f"skipping verification of conflicting block failed: {e}")
    elif ev.conflicting_header_is_invalid(trusted_header.header):
        raise EvidenceError(
            "common height is the same as conflicting block height so "
            "expected the conflicting block to be correctly derived yet "
            "it wasn't")
    try:
        ev.conflicting_block.validators.verify_commit_light(
            trusted_header.header.chain_id,
            ev.conflicting_block.signed_header.commit.block_id,
            ev.conflicting_block.height,
            ev.conflicting_block.signed_header.commit, device=device)
    except CommitVerifyError as e:
        raise EvidenceError(f"invalid commit from conflicting block: {e}")
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceError(
            f"total voting power from the evidence and our validator set "
            f"does not match ({ev.total_voting_power} != "
            f"{common_vals.total_voting_power()})")
    trusted_ts = (trusted_header.time.seconds, trusted_header.time.nanos)
    conflict_ts = (ev.conflicting_block.time.seconds,
                   ev.conflicting_block.time.nanos)
    if (ev.conflicting_block.height > trusted_header.height
            and conflict_ts > trusted_ts):
        raise EvidenceError(
            "conflicting block doesn't violate monotonically increasing "
            "time")
    elif trusted_header.hash() == ev.conflicting_block.hash():
        raise EvidenceError(
            f"trusted header hash matches the evidence's conflicting "
            f"header hash: {trusted_header.hash().hex()}")
