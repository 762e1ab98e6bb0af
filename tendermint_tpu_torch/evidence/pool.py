"""Evidence pool (reference evidence/pool.go): holds verified, uncommitted
evidence for proposal inclusion and gossip; prunes committed/expired.

The port's departure from the JAX package's pool: EvidencePool takes
`device` (None: the package default, "cuda"), the device its evidence
verifies on.  A launch that failed on the card (degrade.DeviceLaneError)
leaves add_evidence, check_evidence and update as it is: it is not an
EvidenceError, and update keeps the consensus buffer for the next call."""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from tendermint_tpu_torch.libs import safe_codec
from tendermint_tpu_torch.types.evidence import (DuplicateVoteEvidence, Evidence,
                                           EvidenceError,
                                           LightClientAttackEvidence)
from tendermint_tpu_torch.types.light_block import SignedHeader
from tendermint_tpu_torch.types.vote import Vote

from .verify import verify_duplicate_vote, verify_light_client_attack

_PENDING = b"evp/"
_COMMITTED = b"evc/"


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + ev.height().to_bytes(8, "big") + ev.hash()


class EvidencePool:
    def __init__(self, db, state_store, block_store, device=None):
        self.db = db
        self.device = device
        self.state_store = state_store
        self.block_store = block_store
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("evidence")
        self._mtx = threading.Lock()
        self.state = state_store.load() if state_store is not None else None
        # votes reported by consensus before the evidence could be formed
        # (reference pool.go:459 processConsensusBuffer)
        self._consensus_buffer: List[Tuple[Vote, Vote]] = []
        # fired (outside the lock) when NEW evidence becomes pending — the
        # reactor subscribes to push it to peers immediately instead of
        # waiting for its rebroadcast tick (reference evidence/reactor.go
        # broadcastEvidenceRoutine wakes on the clist)
        self.on_new_evidence: List = []

    # -- ingress -----------------------------------------------------------

    def add_evidence(self, ev: Evidence) -> None:
        """Reference pool.go:134: validate, verify, persist as pending."""
        with self._mtx:
            if self._is_pending(ev) or self._is_committed(ev):
                return
            ev.validate_basic()
            self._verify(ev)
            self.db.set(_key(_PENDING, ev), safe_codec.dumps(ev))
        self.log.info("verified new evidence of byzantine behavior",
                      evidence=type(ev).__name__, height=ev.height())
        for cb in list(self.on_new_evidence):
            try:
                cb(ev)
            except Exception:  # noqa: BLE001 - notify must not poison add
                pass

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """Consensus reports a double sign (reference pool.go:179); turned
        into DuplicateVoteEvidence when the enclosing block commits (the
        pool then knows the block time + validator set)."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, evs: List[Evidence]) -> None:
        """Verify a block's evidence list (reference pool.go:192)."""
        seen = set()
        for ev in evs:
            with self._mtx:
                if not self._is_pending(ev):
                    ev.validate_basic()
                    self._verify(ev)
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in list")
            seen.add(h)

    # -- egress ------------------------------------------------------------

    def pending_evidence(self, max_bytes: int = -1) -> List[Evidence]:
        """Reference pool.go:87: pending evidence up to max_bytes."""
        out, total = [], 0
        for _, raw in self.db.iterate_prefix(_PENDING):
            ev = safe_codec.loads(raw)
            size = len(ev.bytes())
            if max_bytes >= 0 and total + size > max_bytes:
                break
            out.append(ev)
            total += size
        return out

    def size(self) -> int:
        return sum(1 for _ in self.db.iterate_prefix(_PENDING))

    # -- lifecycle ---------------------------------------------------------

    def update(self, state, committed: List[Evidence]) -> None:
        """Called by BlockExecutor after apply (reference pool.go:105):
        mark committed, drain the consensus buffer, prune expired."""
        with self._mtx:
            self.state = state
            for ev in committed:
                self.db.set(_key(_COMMITTED, ev), b"\x01")
                self.db.delete(_key(_PENDING, ev))
            self._process_consensus_buffer(state)
            self._prune_expired(state)

    # -- internals ---------------------------------------------------------

    def _verify(self, ev: Evidence) -> None:
        """Reference evidence/verify.go:19-99: time binding, expiry, then
        type-specific checks."""
        state = self.state
        if state is None:
            raise EvidenceError("pool has no state")
        height = state.last_block_height
        meta = (self.block_store.load_block_meta(ev.height())
                if self.block_store is not None else None)
        if meta is None:
            raise EvidenceError(f"don't have header #{ev.height()}")
        ev_time = meta.header.time
        if (ev.time().seconds, ev.time().nanos) != (ev_time.seconds,
                                                    ev_time.nanos):
            raise EvidenceError(
                f"evidence time ({ev.time()}) differs from block time "
                f"({ev_time})")
        if self._expired(state, ev.height(), ev_time):
            raise EvidenceError(
                f"evidence from height {ev.height()} is too old")
        if isinstance(ev, DuplicateVoteEvidence):
            vals = self.state_store.load_validators(ev.height())
            if vals is None:
                raise EvidenceError(f"no validators at {ev.height()}")
            verify_duplicate_vote(ev, state.chain_id, vals,
                                  device=self.device)
        elif isinstance(ev, LightClientAttackEvidence):
            common = self._signed_header(ev.height())
            if common is None:
                raise EvidenceError(f"no header at {ev.height()}")
            trusted = self._signed_header(ev.conflicting_block.height)
            if trusted is None:
                # forward lunatic attack: the conflicting block is above our
                # head — verify against the latest header we do have
                # (reference evidence/verify.go:69-85)
                trusted = self._signed_header(self.block_store.height())
            if trusted is None:
                raise EvidenceError(
                    f"no header at {ev.conflicting_block.height}")
            common_vals = self.state_store.load_validators(ev.height())
            if common_vals is None:
                raise EvidenceError(f"no validators at {ev.height()}")
            verify_light_client_attack(ev, common, trusted, common_vals,
                                       device=self.device)
        else:
            raise EvidenceError(f"unknown evidence type {type(ev).__name__}")

    def _signed_header(self, height: int) -> Optional[SignedHeader]:
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            return None
        commit = (self.block_store.load_seen_commit(height)
                  if height == self.block_store.height()
                  else self.block_store.load_block_commit(height))
        if commit is None:
            return None
        return SignedHeader(meta.header, commit)

    def _expired(self, state, height: int, ev_time) -> bool:
        """Reference pool.go:265: expired only when BOTH limits pass."""
        p = state.consensus_params.evidence
        age_blocks = state.last_block_height - height
        age_s = ((state.last_block_time.seconds - ev_time.seconds)
                 + (state.last_block_time.nanos - ev_time.nanos) / 1e9)
        return (age_blocks > p.max_age_num_blocks
                and age_s > p.max_age_duration_seconds)

    def _is_pending(self, ev: Evidence) -> bool:
        return self.db.get(_key(_PENDING, ev)) is not None

    def _is_committed(self, ev: Evidence) -> bool:
        return self.db.get(_key(_COMMITTED, ev)) is not None

    def _process_consensus_buffer(self, state) -> None:
        for vote_a, vote_b in self._consensus_buffer:
            try:
                vals = self.state_store.load_validators(vote_a.height)
                meta = self.block_store.load_block_meta(vote_a.height)
                if vals is None or meta is None:
                    continue
                ev = DuplicateVoteEvidence.from_votes(
                    vote_a, vote_b, meta.header.time, vals)
                if not (self._is_pending(ev) or self._is_committed(ev)):
                    ev.validate_basic()
                    self._verify(ev)
                    self.db.set(_key(_PENDING, ev), safe_codec.dumps(ev))
            except EvidenceError:
                continue
        self._consensus_buffer.clear()

    def _prune_expired(self, state) -> None:
        for k, raw in list(self.db.iterate_prefix(_PENDING)):
            ev = safe_codec.loads(raw)
            if self._expired(state, ev.height(), ev.time()):
                self.db.delete(k)
