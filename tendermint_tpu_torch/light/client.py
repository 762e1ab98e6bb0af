"""Light client with sequential + skipping (bisection) verification
(reference light/client.go).

The client tracks a primary provider and witnesses; verified headers land in
a LightStore.  Skipping verification repeatedly bisects toward the target,
each hop doing one batched trust-level verify on the card — a
10k-validator hop is ~3.3k signatures in one launch (BASELINE config 3).

The port's departures from the JAX package's client: Client takes `device`
(None: the package default, "cuda"), the device of every certificate it
verifies (the trust anchor's, each hop's, a witness chain's).  A launch that
failed on the card (degrade.card_fault) is not a bad header or a bad
witness: it leaves verify_light_block and its callers as it is, with the
primary, the witnesses and the trusted store unchanged.  In a chaos drill
the JAX package's behaviour holds.
"""
from __future__ import annotations

import threading
from fractions import Fraction
from typing import List, Optional

from tendermint_tpu_torch.crypto.degrade import card_fault
from tendermint_tpu_torch.types.basic import Timestamp
from tendermint_tpu_torch.types.light_block import LightBlock

from . import verifier
from .detector import (Divergence, LightClientError, detect_divergence,
                       examine_divergence)
from .provider import (BadLightBlockError, HeightTooHigh, LightBlockNotFound,
                       Provider, ProviderError)
from .store import LightStore

# pivot = trusted + (target - trusted) * 1/2 (reference client.go:52-56)
_SKIP_NUM, _SKIP_DEN = 1, 2

DEFAULT_TRUSTING_PERIOD_S = 14 * 24 * 3600.0  # reference light/client.go
DEFAULT_MAX_CLOCK_DRIFT_S = 10.0
MAX_WITNESS_STRIKES = 3  # consecutive failures before a witness is dropped


class TrustOptions:
    """Trust anchor: (height, hash) obtained out of band + trusting period
    (reference light/client.go:63-91)."""

    def __init__(self, height: int, header_hash: bytes,
                 period_s: float = DEFAULT_TRUSTING_PERIOD_S):
        self.height = height
        self.hash = header_hash
        self.period_s = period_s


class Client:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: List[Provider],
                 store: LightStore,
                 trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
                 max_clock_drift_s: float = DEFAULT_MAX_CLOCK_DRIFT_S,
                 sequential: bool = False, device=None):
        verifier.validate_trust_level(trust_level)
        self.device = device
        self.chain_id = chain_id
        self.trusting_period_s = trust_options.period_s
        self.trust_level = trust_level
        self.max_clock_drift_s = max_clock_drift_s
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.sequential = sequential
        self._witness_strikes: dict = {}  # id(provider) -> count
        # fail-safe flag: a client CONFIGURED with witnesses must never
        # silently continue without any (reference errNoWitnesses) — a
        # drained pool means divergence detection is gone and a malicious
        # primary would be unchallenged.  Clients deliberately built with
        # zero witnesses (statesync bootstrap) are exempt.
        self._had_witnesses = bool(self.witnesses)
        # serializes the trusted-store read -> verify -> advance path:
        # concurrent verifiers (LightServe requests sharing one client,
        # ADR-026) must not interleave store.get/latest_before with the
        # trace's store.save, or two racers could each verify from a
        # stale anchor and persist overlapping traces out of order.
        # Reentrant: verify_light_block_at_height -> verify_light_block
        # nests.  Rank 8 in devtools/lockorder.py — held across the
        # verifier (scheduler _cond 20) and the store (kvdb 65-69)
        self._lock = threading.RLock()
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("light")
        self._initialize(trust_options)

    # -- initialization (reference client.go:362-401) ----------------------

    def _initialize(self, opts: TrustOptions):
        existing = self.store.latest()
        if existing is not None:
            return
        lb = self._from_primary(opts.height)
        if lb.hash() != opts.hash:
            raise LightClientError(
                f"expected header's hash {opts.hash.hex()}, got "
                f"{lb.hash().hex()}")
        lb.validate_basic(self.chain_id)
        # self-consistency: the set that produced it signed it
        lb.validators.verify_commit_light(
            self.chain_id, lb.signed_header.commit.block_id, lb.height,
            lb.signed_header.commit, device=self.device)
        self.store.save(lb)

    # -- public API --------------------------------------------------------

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.get(height)

    def last_trusted_height(self) -> int:
        lb = self.store.latest()
        return lb.height if lb else 0

    def update(self, now: Timestamp) -> Optional[LightBlock]:
        """Fetch + verify the primary's latest (reference client.go:436)."""
        with self._lock:
            latest = self._from_primary(0)
            if latest.height <= self.last_trusted_height():
                return None
            self.verify_light_block(latest, now)
            return latest

    def verify_light_block_at_height(self, height: int,
                                     now: Timestamp) -> LightBlock:
        """Reference client.go:474."""
        with self._lock:
            got = self.store.get(height)
            if got is not None:
                return got
            lb = self._from_primary(height)
            self.verify_light_block(lb, now)
            return lb

    def verify_light_block(self, lb: LightBlock, now: Timestamp):
        """Reference client.go:558-611: pick sequential vs skipping from the
        nearest trusted anchor; on success cross-check witnesses."""
        with self._lock:
            self._verify_light_block_locked(lb, now)

    def _verify_light_block_locked(self, lb: LightBlock, now: Timestamp):
        lb.validate_basic(self.chain_id)
        if self.store.get(lb.height) is not None:
            return
        anchor = self.store.latest_before(lb.height)
        if anchor is not None and anchor.height == lb.height:
            return
        if anchor is None:
            # target below the earliest trusted header: walk hash links back
            first = self.store.first()
            if first is None:
                raise LightClientError("store is empty")
            self._backwards(first, lb)
            trace = [lb]
        elif self.sequential:
            trace = self._verify_sequential(anchor, lb, now)
        else:
            trace = self._verify_skipping(anchor, lb, now)
        # detect BEFORE persisting: on a divergence nothing from the
        # disputed trace may enter the trusted store (a primary-side
        # attack would otherwise be served as trusted forever after the
        # dissenting witness is removed).  A witness whose conflicting
        # chain fails verification is dropped (reference errBadWitness)
        # and detection re-runs over the remaining pool — one garbage
        # witness must not abort an otherwise-valid verify.
        matched: set = set()   # witnesses already polled + agreeing
        while True:
            if self._had_witnesses and not self.witnesses:
                raise LightClientError(
                    "no witnesses left to cross-check the primary "
                    "(reference errNoWitnesses): refusing to trust "
                    "unchallenged headers")
            div = detect_divergence(self, trace, now, matched)
            if div is None:
                break
            self._handle_divergence(anchor, trace, div, now)
        for b in trace:
            self.store.save(b)

    # -- verification strategies ------------------------------------------

    def _verify_sequential(self, trusted: LightBlock, target: LightBlock,
                           now: Timestamp) -> List[LightBlock]:
        """Reference client.go:613-704: verify every height in order."""
        trace = []
        cur = trusted
        for h in range(trusted.height + 1, target.height + 1):
            lb = target if h == target.height else self._from_primary(h)
            verifier.verify_adjacent(
                cur.signed_header, lb.signed_header, lb.validators,
                self.trusting_period_s, now, self.max_clock_drift_s,
                device=self.device)
            cur = lb
            trace.append(lb)
        return trace

    def _bisect(self, trusted: LightBlock, target: LightBlock,
                now: Timestamp, fetch_pivot) -> List[LightBlock]:
        """Core skipping-verification state machine (reference
        client.go:706-775): bisection with a block cache.  Shared by the
        primary path (_verify_skipping) and the witness-conflict path
        (_verify_witness_chain); fetch_pivot(height) supplies bisection
        pivots from the respective source.  Returns the verified trace
        (excluding `trusted`)."""
        cache = [target]
        depth = 0
        verified = trusted
        trace: List[LightBlock] = []
        while True:
            try:
                verifier.verify(
                    verified.signed_header, verified.validators,
                    cache[depth].signed_header, cache[depth].validators,
                    self.trusting_period_s, now, self.max_clock_drift_s,
                    self.trust_level, device=self.device)
            except verifier.NewValSetCantBeTrustedError:
                # can't skip that far: bisect
                if depth == len(cache) - 1:
                    pivot = (verified.height
                             + (cache[depth].height - verified.height)
                             * _SKIP_NUM // _SKIP_DEN)
                    cache.append(fetch_pivot(pivot))
                depth += 1
            except verifier.LightError as e:
                raise LightClientError(
                    f"verification failed {verified.height}->"
                    f"{cache[depth].height}: {e}")
            else:
                if depth == 0:
                    trace.append(target)
                    return trace
                verified = cache[depth]
                cache = cache[:depth]
                depth = 0
                trace.append(verified)

    def _verify_skipping(self, trusted: LightBlock, target: LightBlock,
                         now: Timestamp) -> List[LightBlock]:
        """Skipping verification against the primary."""
        def fetch(pivot: int) -> LightBlock:
            try:
                return self._from_primary(pivot)
            except (LightBlockNotFound, HeightTooHigh) as e:
                raise LightClientError(
                    f"bisection pivot {pivot} unavailable: {e}")
        return self._bisect(trusted, target, now, fetch)

    def _backwards(self, trusted: LightBlock, target: LightBlock):
        """Reference client.go:933-988: follow LastBlockID links down."""
        cur = trusted
        for h in range(trusted.height - 1, target.height - 1, -1):
            lb = target if h == target.height else self._from_primary(h)
            verifier.verify_backwards(lb.signed_header, cur.signed_header)
            cur = lb

    # -- divergence handling (reference detector.go:90-180) ----------------

    def _handle_divergence(self, anchor: Optional[LightBlock],
                           trace: List[LightBlock], div: Divergence,
                           now: Timestamp):
        """Verify the witness's conflicting chain from the common block
        (reference detector.go examineConflictingHeaderAgainstTrace);
        only a VERIFIED conflict is an attack.  On verification failure
        the witness is bad (garbage or buggy) — drop it and return so
        detection continues over the remaining pool, instead of firing
        unfounded evidence at the primary (reference errBadWitness).
        On a verified conflict: attribute the attack, submit evidence
        both ways, drop the diverging witness, and raise the Divergence
        — the client cannot know which side is honest, so each side's
        evidence goes to the other plus every remaining provider
        (reference detector.go sendEvidence to primary and witnesses)."""
        chain = ([anchor] if anchor is not None else []) + list(trace)
        witness = div.witness
        try:
            common, ev_w, ev_p = examine_divergence(self, chain, div)
            self._verify_witness_chain(common, div.witness_block,
                                       witness, now)
        except Exception as e:  # noqa: BLE001 - unverifiable conflict
            if card_fault(e):
                raise   # the card failed, not the witness
            self.log.error(
                "witness's conflicting header could not be verified; "
                "dropping witness", err=str(e),
                height=div.primary_block.height)
            self._remove_witness(witness)
            return
        self.log.error(
            "light client attack detected",
            height=div.primary_block.height,
            common_height=ev_w.common_height,
            byzantine=len(ev_w.byzantine_validators))
        # evidence against the witness's chain -> primary + other
        # witnesses; evidence against the primary's chain -> the witness
        targets_w = [self.primary] + [w for w in self.witnesses
                                      if w is not witness]
        for prov, ev in ([(p, ev_w) for p in targets_w]
                         + [(witness, ev_p)]):
            try:
                prov.report_evidence(ev)
            except ProviderError as e:
                self.log.error("evidence submission failed", err=str(e))
        self._remove_witness(witness)
        raise div

    def _verify_witness_chain(self, trusted: LightBlock,
                              target: LightBlock, witness: Provider,
                              now: Timestamp) -> None:
        """Skipping-verify the witness's conflicting header from the
        common block, fetching bisection pivots FROM THE WITNESS
        (reference detector.go:120-180: the witness trace must verify
        before its conflict counts as an attack).  Raises on any
        verification or fetch failure — the caller treats that as a bad
        witness."""
        def fetch(pivot: int) -> LightBlock:
            wb = witness.light_block(pivot)  # ProviderError -> bad witness
            if wb is None:
                raise LightClientError(
                    f"witness lacks its own bisection pivot {pivot}")
            return wb
        self._bisect(trusted, target, now, fetch)

    # -- provider management (reference client.go findNewPrimary) ----------

    def note_witness_failure(self, witness: Provider, reason):
        """Strike an unresponsive witness; drop it after
        MAX_WITNESS_STRIKES consecutive failures (a bad block drops it
        immediately)."""
        if isinstance(reason, BadLightBlockError):
            self._remove_witness(witness)
            return
        k = id(witness)
        self._witness_strikes[k] = self._witness_strikes.get(k, 0) + 1
        if self._witness_strikes[k] >= MAX_WITNESS_STRIKES:
            self._remove_witness(witness)

    def note_witness_ok(self, witness: Provider):
        self._witness_strikes.pop(id(witness), None)

    def _remove_witness(self, witness: Provider):
        self._witness_strikes.pop(id(witness), None)
        try:
            self.witnesses.remove(witness)
            self.log.info("removed witness",
                          remaining=len(self.witnesses))
        except ValueError:
            pass

    def _replace_primary(self, err) -> None:
        """Promote the first responsive witness to primary (reference
        client.go:613+ findNewPrimary); the failed primary is dropped
        entirely.  Witnesses failing the probe BENIGNLY (momentarily
        behind, timeout) keep their place in the pool — only a bad block
        discards one, consistent with the strike policy."""
        for cand in list(self.witnesses):
            try:
                ok = cand.light_block(0) is not None
            except BadLightBlockError:
                self._remove_witness(cand)
                continue
            except ProviderError:
                continue  # transient: keep as witness
            if ok:
                self._remove_witness(cand)
                self.log.info("replaced primary after failure",
                              err=str(err),
                              witnesses_left=len(self.witnesses))
                self.primary = cand
                return
        raise LightClientError(
            f"primary failed ({err}) and no witness can take over")

    # -- providers ---------------------------------------------------------

    def _from_primary(self, height: int) -> LightBlock:
        """Fetch from the primary; on failure rotate a witness in and
        retry once per remaining provider (reference client.go
        lightBlockFromPrimary + findNewPrimary)."""
        while True:
            try:
                lb = self.primary.light_block(height)
            except (LightBlockNotFound, HeightTooHigh):
                # benign: the primary simply doesn't have it (yet);
                # switching primaries would not conjure the block
                raise
            except ProviderError as e:
                self._replace_primary(e)
                continue
            if lb is None:
                raise LightBlockNotFound(f"no light block at {height}")
            return lb
