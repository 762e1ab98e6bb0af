"""Witness cross-checking (reference light/detector.go).

After the primary's header verifies, each witness is asked for the same
height; a hash mismatch means a fork/light-client attack on one side.  The
divergence carries both conflicting blocks so the caller can form
LightClientAttackEvidence (evidence/ package) and submit it to full nodes
(reference detector.go:48-112 detectDivergence + examineConflictingHeader).
"""
from __future__ import annotations

from typing import List, Optional

from tendermint_tpu_torch.types.basic import Timestamp
from tendermint_tpu_torch.types.light_block import LightBlock

from .provider import ProviderError


class LightClientError(Exception):
    """Base class for light-client failures (client.py re-exports this;
    defined here so detector errors can subclass it without an import
    cycle)."""


class NoCommonBlock(Exception):
    """The witness disputes the entire verified chain — no height exists
    at which verifiable attack evidence can be anchored."""


class CrossReferenceError(LightClientError):
    """No witness returned a header that could actually be compared
    against the primary's (reference detector.go:99-104
    ErrFailedHeaderCrossReferencing).  Trusting the primary with zero
    successful cross-checks would let a malicious primary ride out a
    window where every witness is eclipsed or unresponsive."""


class Divergence(Exception):
    """A witness disagrees with the primary about a verified header."""

    def __init__(self, primary_block: LightBlock, witness_block: LightBlock,
                 witness):
        super().__init__(
            f"witness has conflicting header at height "
            f"{primary_block.height}: primary {primary_block.hash().hex()} "
            f"vs witness {witness_block.hash().hex()}")
        self.primary_block = primary_block
        self.witness_block = witness_block
        # the provider OBJECT: the witness list mutates during the scan
        # (strike removals), so an index would go stale or shift onto an
        # honest witness
        self.witness = witness

    def make_evidence(self, common_height: int):
        """Minimal unattributed evidence at a caller-supplied common
        height; full attribution (byzantine set, both directions) comes
        from examine_divergence."""
        from tendermint_tpu_torch.evidence import LightClientAttackEvidence
        wb = self.witness_block
        return LightClientAttackEvidence(
            conflicting_block=wb, common_height=common_height,
            byzantine_validators=[],
            total_voting_power=wb.validators.total_voting_power(),
            timestamp=wb.time)


def detect_divergence(client, trace: List[LightBlock],
                      now: Timestamp,
                      already_matched: Optional[set] = None
                      ) -> Optional[Divergence]:
    """Compare the newly verified header against every witness
    (reference detector.go:48).  Returns the first Divergence found (the
    caller raises it after examining it), None when all witnesses agree.
    Unresponsive witnesses accrue strikes and are removed by the client
    after repeated failures (reference removes them on error).

    Raises CrossReferenceError when witnesses were configured but not a
    single one produced a comparable header (reference detector.go:99-104:
    headersMatched must be true or the whole verify fails) — the caller
    must NOT persist the trace in that case."""
    if not trace or not client.witnesses:
        return None
    target = trace[-1]
    compared = False
    for w in list(client.witnesses):
        if already_matched is not None and id(w) in already_matched:
            # this witness already agreed during this verify; don't
            # re-poll it after a bad witness was dropped and detection
            # re-runs (each poll is a network round trip)
            compared = True
            continue
        try:
            wb = w.light_block(target.height)
        except ProviderError as e:
            client.note_witness_failure(w, e)
            continue
        if wb is None:
            client.note_witness_failure(w, "no block")
            continue
        client.note_witness_ok(w)
        if wb.hash() != target.hash():
            return Divergence(target, wb, w)
        compared = True
        if already_matched is not None:
            already_matched.add(id(w))
    if not compared:
        raise CrossReferenceError(
            f"no witness could cross-reference header at height "
            f"{target.height}: all {len(client.witnesses)} witnesses "
            f"errored or lacked the block")
    return None


def _signers(commit) -> set:
    return {cs.validator_address for cs in commit.signatures
            if cs.for_block()}


def _attack_evidence(common: LightBlock, conflicting: LightBlock,
                     trusted: LightBlock):
    """LightClientAttackEvidence with the byzantine set attributed per
    reference types/evidence.go GetByzantineValidators:

      * lunatic attack (the conflicting header does not derive the
        trusted header's non-vote fields — ConflictingHeaderIsInvalid,
        all five fields): the byzantine validators are the COMMON-height
        validators who signed the conflicting commit — they signed a
        header that cannot descend from the common block;
      * equivocation (same derived header, same commit round): the
        validators that signed BOTH conflicting commits;
      * amnesia (same derived header, different rounds): attribution is
        impossible from the light client's view — empty byzantine set.
    """
    from tendermint_tpu_torch.evidence import LightClientAttackEvidence

    th = trusted.signed_header.header
    csigners = _signers(conflicting.signed_header.commit)
    ev = LightClientAttackEvidence(
        conflicting_block=conflicting,
        common_height=common.height,
        byzantine_validators=[],
        total_voting_power=common.validators.total_voting_power(),
        timestamp=common.time,
    )
    ccommit = conflicting.signed_header.commit
    tcommit = trusted.signed_header.commit
    if ev.conflicting_header_is_invalid(th):
        ev.byzantine_validators = [v for v in common.validators.validators
                                   if v.address in csigners]
    elif ccommit.round == tcommit.round:
        tsigners = _signers(tcommit)
        ev.byzantine_validators = [
            v for v in conflicting.validators.validators
            if v.address in csigners and v.address in tsigners]
    return ev


def examine_divergence(client, chain: List[LightBlock], div: Divergence):
    """Reference detector.go:120-180 examineConflictingHeaderAgainstTrace:
    locate the latest verified block the witness still agrees with (the
    common block), then build attributed evidence BOTH ways — against the
    witness's chain (conflicting block = witness header) and against the
    primary's (conflicting block = primary header).  The light client
    cannot know which side is honest; it reports each side to the other
    (reference detector.go:90-112).

    Returns (common_block, ev_against_witness, ev_against_primary).
    Raises NoCommonBlock when the witness disputes every verified block
    including the anchor — evidence anchored at a disputed height would
    be rejected by any full node (reference detector.go errors there).
    """
    w = div.witness
    common = None
    for b in reversed([b for b in chain if b.height
                       < div.primary_block.height]):
        try:
            wb = w.light_block(b.height)
        except ProviderError:
            continue
        if wb is not None and wb.hash() == b.hash():
            common = b
            break
    if common is None:
        raise NoCommonBlock(
            f"witness disputes every verified block up to "
            f"{div.primary_block.height}")
    ev_w = _attack_evidence(common, div.witness_block, div.primary_block)
    ev_p = _attack_evidence(common, div.primary_block, div.witness_block)
    return common, ev_w, ev_p
