"""Stateless light-client verification (reference light/verifier.go:32-214).

The skipping (non-adjacent) check is BASELINE config 3's workload: one
verify_commit_light_trusting over a 10k-validator set rides the batched card
verify plane (types/validator_set.py -> crypto/batch.py) instead of the
reference's serial loop.

The port's departure from the JAX package's verifier: verify_adjacent,
verify_non_adjacent and verify take `device` (None: the package default,
"cuda") and pass it to ValidatorSet.verify_commit_light*.  With no CUDA and
no device="cpu", a certificate of 32 signatures or more raises
RuntimeError.  A launch that failed on the card (degrade.DeviceLaneError)
is not a LightError: it leaves these functions as it is.
"""
from __future__ import annotations

from fractions import Fraction

from tendermint_tpu_torch.crypto import scheduler as vsched
from tendermint_tpu_torch.types.basic import Timestamp
from tendermint_tpu_torch.types.light_block import LightValidationError, SignedHeader
from tendermint_tpu_torch.types.validator_set import (CommitVerifyError,
                                                NotEnoughVotingPowerError,
                                                ValidatorSet)

# At least one correct validator signed (reference verifier.go:16)
DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class LightError(Exception):
    pass


class OldHeaderExpiredError(LightError):
    pass


class InvalidHeaderError(LightError):
    pass


class NewValSetCantBeTrustedError(LightError):
    """< trustLevel of the trusted set signed the new header
    (reference errors.go ErrNewValSetCantBeTrusted)."""


def _ts_le(a: Timestamp, b: Timestamp) -> bool:
    return (a.seconds, a.nanos) <= (b.seconds, b.nanos)


def _ts_lt(a: Timestamp, b: Timestamp) -> bool:
    return (a.seconds, a.nanos) < (b.seconds, b.nanos)


def _ts_add(a: Timestamp, seconds: float) -> Timestamp:
    total = a.seconds * 10**9 + a.nanos + int(seconds * 10**9)
    return Timestamp(total // 10**9, total % 10**9)


def header_expired(h: SignedHeader, trusting_period_s: float,
                   now: Timestamp) -> bool:
    """Reference verifier.go:208."""
    return _ts_le(_ts_add(h.time, trusting_period_s), now)


def validate_trust_level(lvl: Fraction):
    """trustLevel must be in [1/3, 1] (reference verifier.go:196)."""
    if (lvl.numerator * 3 < lvl.denominator or
            lvl.numerator > lvl.denominator or lvl.denominator == 0):
        raise LightError(f"trustLevel must be within [1/3, 1], given {lvl}")


def _verify_new_header_and_vals(untrusted: SignedHeader,
                                untrusted_vals: ValidatorSet,
                                trusted: SignedHeader, now: Timestamp,
                                max_clock_drift_s: float):
    """Reference verifier.go:154-192."""
    try:
        untrusted.validate_basic(trusted.header.chain_id)
    except LightValidationError as e:
        raise InvalidHeaderError(f"untrusted.validate_basic failed: {e}")
    if untrusted.height <= trusted.height:
        raise InvalidHeaderError(
            f"expected new header height {untrusted.height} to be greater "
            f"than one of old header {trusted.height}")
    if not _ts_lt(trusted.time, untrusted.time):
        raise InvalidHeaderError(
            f"expected new header time {untrusted.time} to be after old "
            f"header time {trusted.time}")
    if not _ts_lt(untrusted.time, _ts_add(now, max_clock_drift_s)):
        raise InvalidHeaderError(
            f"new header has a time from the future {untrusted.time} "
            f"(now: {now}; drift {max_clock_drift_s}s)")
    if untrusted.header.validators_hash != untrusted_vals.hash():
        raise InvalidHeaderError(
            f"expected new header validators "
            f"({untrusted.header.validators_hash.hex()}) to match those "
            f"supplied ({untrusted_vals.hash().hex()}) "
            f"at height {untrusted.height}")


def verify_adjacent(trusted: SignedHeader, untrusted: SignedHeader,
                    untrusted_vals: ValidatorSet, trusting_period_s: float,
                    now: Timestamp, max_clock_drift_s: float, device=None):
    """Reference verifier.go:96-135: height X -> X+1 requires
    untrusted.ValidatorsHash == trusted.NextValidatorsHash + >2/3 of the new
    set signing."""
    if untrusted.height != trusted.height + 1:
        raise LightError("headers must be adjacent in height")
    if header_expired(trusted, trusting_period_s, now):
        raise OldHeaderExpiredError(
            f"old header expired at {_ts_add(trusted.time, trusting_period_s)}")
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now,
                                max_clock_drift_s)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise LightError(
            f"expected old header next validators "
            f"({trusted.header.next_validators_hash.hex()}) to match those "
            f"from new header ({untrusted.header.validators_hash.hex()})")
    try:
        # commit/light class on the shared verify scheduler: the batched
        # check (validator_set -> crypto/batch.verify_sigs_bulk) rides
        # the cross-consumer coalescing window at COMMIT priority
        with vsched.priority_context(vsched.Priority.COMMIT):
            untrusted_vals.verify_commit_light(
                trusted.header.chain_id, untrusted.commit.block_id,
                untrusted.height, untrusted.commit, device=device)
    except CommitVerifyError as e:
        raise InvalidHeaderError(str(e))


def verify_non_adjacent(trusted: SignedHeader, trusted_vals: ValidatorSet,
                        untrusted: SignedHeader,
                        untrusted_vals: ValidatorSet,
                        trusting_period_s: float, now: Timestamp,
                        max_clock_drift_s: float,
                        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                        device=None):
    """Reference verifier.go:32-81: skipping verification — trustLevel of
    the TRUSTED set must have signed the new header, plus >2/3 of the new
    set.  Both checks are batched verifies on the card."""
    if untrusted.height == trusted.height + 1:
        raise LightError("headers must be non adjacent in height")
    if header_expired(trusted, trusting_period_s, now):
        raise OldHeaderExpiredError(
            f"old header expired at {_ts_add(trusted.time, trusting_period_s)}")
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now,
                                max_clock_drift_s)
    try:
        with vsched.priority_context(vsched.Priority.COMMIT):
            trusted_vals.verify_commit_light_trusting(
                trusted.header.chain_id, untrusted.commit, trust_level,
                device=device)
    except NotEnoughVotingPowerError as e:
        raise NewValSetCantBeTrustedError(str(e))
    except CommitVerifyError as e:
        raise LightError(str(e))
    # last check on purpose: untrusted_vals can be made large to DoS
    try:
        with vsched.priority_context(vsched.Priority.COMMIT):
            untrusted_vals.verify_commit_light(
                trusted.header.chain_id, untrusted.commit.block_id,
                untrusted.height, untrusted.commit, device=device)
    except CommitVerifyError as e:
        raise InvalidHeaderError(str(e))


def verify(trusted: SignedHeader, trusted_vals: ValidatorSet,
           untrusted: SignedHeader, untrusted_vals: ValidatorSet,
           trusting_period_s: float, now: Timestamp,
           max_clock_drift_s: float,
           trust_level: Fraction = DEFAULT_TRUST_LEVEL, device=None):
    """Reference verifier.go:138-152."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(trusted, trusted_vals, untrusted, untrusted_vals,
                            trusting_period_s, now, max_clock_drift_s,
                            trust_level, device=device)
    else:
        verify_adjacent(trusted, untrusted, untrusted_vals,
                        trusting_period_s, now, max_clock_drift_s,
                        device=device)


def verify_backwards(untrusted: SignedHeader, trusted: SignedHeader):
    """Reference verifier.go:214-236: walk the LastBlockID hash link one
    height back."""
    try:
        untrusted.validate_basic(trusted.header.chain_id)
    except LightValidationError as e:
        raise InvalidHeaderError(str(e))
    if untrusted.height != trusted.height - 1:
        raise InvalidHeaderError(
            f"expected height {trusted.height - 1}, got {untrusted.height}")
    if not _ts_lt(untrusted.time, trusted.time):
        raise InvalidHeaderError(
            f"expected older header time {untrusted.time} to be before new "
            f"header time {trusted.time}")
    if trusted.header.last_block_id.hash != untrusted.hash():
        raise InvalidHeaderError(
            f"older header hash {untrusted.hash().hex()} does not match "
            f"trusted header's last block "
            f"{trusted.header.last_block_id.hash.hex()}")
