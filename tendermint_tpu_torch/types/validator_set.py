"""ValidatorSet (reference types/validator_set.go).

Determinism-critical control plane: proposer rotation (priority
accumulation with clipping, rescaling and centering) must match the
reference bit-for-bit or consensus forks (SURVEY.md §7 hard part 4) — Go's
truncating integer division and int64 clipping are reproduced explicitly.

The three commit-verification entry points (the north-star hot loops,
reference types/validator_set.go:662-821) stage one batch through
crypto.batch.verify_sigs_bulk (the GPU kernels, or their plain versions on
device="cpu") and reduce the validity bitmap, preserving the reference's
exact accept/reject semantics:

  * verify_commit checks ALL non-absent signatures (incentive semantics —
    no early exit, reference comment at :655-661);
  * verify_commit_light / _light_trusting only verify the minimal prefix
    of for-block signatures whose power crosses the threshold, so a bad
    signature *after* the 2/3 point must not reject (the reference's serial
    loop returns early and never sees it).

Failure identity: on a bad signature, the error names the lowest failing
commit index, same as the serial loop's first failure.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.batch import _use_device, verify_sigs_bulk
from tendermint_tpu_torch.libs.safemath import (
    INT64_MAX, INT64_MIN, safe_add_clip, safe_mul, safe_sub_clip, trunc_div)

from .basic import BlockID
from .commit import Commit
from .validator import Validator

MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


class CommitVerifyError(Exception):
    pass


class NotEnoughVotingPowerError(CommitVerifyError):
    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}")
        self.got = got
        self.needed = needed


def _sort_by_voting_power(vals: List[Validator]):
    vals.sort(key=lambda v: (-v.voting_power, v.address))


class ValidatorSet:
    def __init__(self, validators: Optional[List[Validator]] = None):
        """NewValidatorSet semantics (reference :71-86): copies, validates,
        sorts, and advances proposer priority once."""
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power = 0
        if validators:
            self._update_with_change_set(
                [v.copy() for v in validators], allow_deletes=False)
            self.increment_proposer_priority(1)

    # -- basic accessors ---------------------------------------------------

    def __getstate__(self):
        # the pub-matrix cache is derived state (and holds numpy arrays
        # the safe codec rightly refuses); never persist it
        d = dict(self.__dict__)
        d.pop("_pubmat_cache", None)
        return d

    def size(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def has_address(self, address: bytes) -> bool:
        return any(v.address == address for v in self.validators)

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i, v.copy()
        return -1, None

    def get_by_index(self, index: int):
        if index < 0 or index >= len(self.validators):
            return None, None
        v = self.validators[index]
        return v.address, v.copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self):
        s = 0
        for v in self.validators:
            s = safe_add_clip(s, v.voting_power)
            if s > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        self._total_voting_power = s

    def copy(self) -> "ValidatorSet":
        new = ValidatorSet()
        new.validators = [v.copy() for v in self.validators]
        new.proposer = self.proposer
        new._total_voting_power = self._total_voting_power
        return new

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [v.bytes() for v in self.validators])

    def validate_basic(self):
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for i, v in enumerate(self.validators):
            v.validate_basic()
        if self.proposer is None:
            raise ValueError("proposer is not set")
        self.proposer.validate_basic()

    # -- proposer rotation (reference :116-234) ----------------------------

    def increment_proposer_priority(self, times: int):
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    def rescale_priorities(self, diff_max: int):
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max  # operands >= 0: floor==trunc
        if diff > diff_max:
            for v in self.validators:
                v.proposer_priority = trunc_div(v.proposer_priority, ratio)

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = safe_add_clip(v.proposer_priority,
                                                v.voting_power)
        mostest = self._val_with_most_priority()
        mostest.proposer_priority = safe_sub_clip(
            mostest.proposer_priority, self.total_voting_power())
        return mostest

    def _compute_avg_proposer_priority(self) -> int:
        n = len(self.validators)
        s = sum(v.proposer_priority for v in self.validators)
        # Go: big.Int Div (Euclidean: rounds toward -inf for positive
        # divisor) == Python floor division.
        return s // n

    def _max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return abs(max(prios) - min(prios))

    def _val_with_most_priority(self) -> Validator:
        res = None
        for v in self.validators:
            res = v.compare_proposer_priority(res) if res is None else \
                res.compare_proposer_priority(v)
        return res

    def _shift_by_avg_proposer_priority(self):
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = safe_sub_clip(v.proposer_priority, avg)

    def get_proposer(self) -> Optional[Validator]:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        proposer = None
        for v in self.validators:
            if proposer is None or v.address != proposer.address:
                proposer = v.compare_proposer_priority(proposer)
        return proposer

    # -- updates (reference :364-651) --------------------------------------

    def update_with_change_set(self, changes: List[Validator]):
        self._update_with_change_set([c.copy() for c in changes],
                                     allow_deletes=True)

    def _update_with_change_set(self, changes: List[Validator],
                                allow_deletes: bool):
        if not changes:
            return
        updates, deletes = _process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError("cannot process validators with voting power 0")
        num_new = sum(1 for u in updates if not self.has_address(u.address))
        if num_new == 0 and len(self.validators) == len(deletes):
            raise ValueError("applying the changes would leave an empty set")
        removed_power = self._verify_removals(deletes)
        tvp_after_updates_before_removals = self._verify_updates(
            updates, removed_power)
        _compute_new_priorities(updates, self,
                                tvp_after_updates_before_removals)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._update_total_voting_power()
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        _sort_by_voting_power(self.validators)

    def _verify_removals(self, deletes: List[Validator]) -> int:
        removed = 0
        for d in deletes:
            _, val = self.get_by_address(d.address)
            if val is None:
                raise ValueError(
                    f"failed to find validator {d.address.hex()} to remove")
            removed += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValueError("more deletes than validators")
        return removed

    def _verify_updates(self, updates: List[Validator],
                        removed_power: int) -> int:
        def delta(u: Validator) -> int:
            _, val = self.get_by_address(u.address)
            return (u.voting_power - val.voting_power) if val is not None \
                else u.voting_power

        tvp_after_removals = self.total_voting_power() - removed_power
        for u in sorted(updates, key=delta):
            tvp_after_removals += delta(u)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise OverflowError("total voting power overflow")
        return tvp_after_removals + removed_power

    def _apply_updates(self, updates: List[Validator]):
        # sort a COPY: the current list object may be the key of a
        # device-resident pubkey-matrix cache entry, and reordering it
        # in place would silently misalign cached rows (the cache
        # invalidates by retained object reference, not content)
        existing = sorted(self.validators, key=lambda v: v.address)
        merged: List[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i]); i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged

    def _apply_removals(self, deletes: List[Validator]):
        if not deletes:
            return
        daddrs = {d.address for d in deletes}
        self.validators = [v for v in self.validators
                           if v.address not in daddrs]

    # -- proto codec (tendermint.types.ValidatorSet) -----------------------

    def proto(self) -> bytes:
        from tendermint_tpu_torch.libs import protoenc as pe
        body = b"".join(pe.message_field_always(1, v.proto())
                        for v in self.validators)
        prop = self.get_proposer()
        if prop is not None:
            body += pe.message_field_always(2, prop.proto())
        body += pe.varint_field(3, self.total_voting_power())
        return body

    @classmethod
    def from_proto(cls, body: bytes) -> "ValidatorSet":
        from tendermint_tpu_torch.libs import protodec as pd
        f = pd.parse(body)
        vals = [Validator.from_proto(m) for m in pd.get_messages(f, 1)]
        vs = cls.__new__(cls)
        vs.validators = vals
        vs._total_voting_power = 0
        vs.proposer = None
        prop = pd.get_message(f, 2)
        if prop is not None:
            p = Validator.from_proto(prop)
            for v in vals:
                if v.address == p.address:
                    vs.proposer = v
                    break
        return vs

    # -- commit verification (the north-star hot loops) --------------------

    def verify_commit(self, chain_id: str, block_id: BlockID, height: int,
                      commit: Commit, device=None):
        """Reference :662-709 — checks ALL non-absent signatures in one
        batch; tallies for-block power; raises on any bad signature or
        insufficient power."""
        self._check_commit_header(chain_id, block_id, height, commit)
        batch_idx = [idx for idx, cs in enumerate(commit.signatures)
                     if not cs.is_absent()]
        self._verify_sigs_batch(chain_id, commit, batch_idx,
                                [self.validators[i] for i in batch_idx],
                                device)
        tallied = sum(self.validators[i].voting_power
                      for i in batch_idx if commit.signatures[i].for_block())
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise NotEnoughVotingPowerError(tallied, needed)

    def verify_commit_light(self, chain_id: str, block_id: BlockID,
                            height: int, commit: Commit, device=None):
        """Reference :717-760 — verify only the minimal prefix of for-block
        signatures that crosses 2/3, in one batch."""
        prefix = self.collect_commit_light(chain_id, block_id, height, commit)
        self._verify_sigs_batch(chain_id, commit, prefix,
                                [self.validators[i] for i in prefix], device)

    def collect_commit_light(self, chain_id: str, block_id: BlockID,
                             height: int, commit: Commit) -> List[int]:
        """Header/power checks of verify_commit_light WITHOUT signature
        verification; returns the minimal >2/3 prefix of signature indices.

        This is the coalescing seam: blocksync collects prefixes from many
        consecutive blocks and verifies them in ONE batched kernel launch
        (vs the reference's per-block serial loop, blocksync/reactor.go:375).
        """
        self._check_commit_header(chain_id, block_id, height, commit)
        needed = self.total_voting_power() * 2 // 3
        prefix = []
        tallied = 0
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            prefix.append(idx)
            tallied += self.validators[idx].voting_power
            if tallied > needed:
                break
        else:
            raise NotEnoughVotingPowerError(tallied, needed)
        return prefix

    def verify_commit_light_trusting(self, chain_id: str, commit: Commit,
                                     trust_level: Fraction, device=None):
        """Reference :770-821 — votes are matched by address (the commit may
        belong to a *different* validator set); verify the minimal prefix
        crossing trust_level of OUR total power."""
        if trust_level.denominator == 0:
            raise ValueError("trustLevel has zero Denominator")
        total_mul, overflow = safe_mul(self.total_voting_power(),
                                       trust_level.numerator)
        if overflow:
            raise OverflowError("int64 overflow computing voting power needed")
        needed = total_mul // trust_level.denominator
        seen_vals = {}
        prefix = []
        vals = []
        tallied = 0
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val_idx, val = self.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise CommitVerifyError(
                    f"double vote from validator {val_idx} "
                    f"({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
            prefix.append(idx)
            vals.append(val)
            tallied += val.voting_power
            if tallied > needed:
                break
        else:
            raise NotEnoughVotingPowerError(tallied, needed)
        self._verify_sigs_batch(chain_id, commit, prefix, vals, device)

    def check_commit_no_sigs(self, chain_id: str, block_id: BlockID,
                             height: int, commit: Commit):
        """verify_commit minus signature verification: header linkage plus
        the >2/3 for-block power tally.  Used when every signature in
        `commit` was already verified in a coalesced batch (blocksync's
        pre-verified cache, state/execution.py)."""
        self._check_commit_header(chain_id, block_id, height, commit)
        tallied = sum(self.validators[i].voting_power
                      for i, cs in enumerate(commit.signatures)
                      if cs.for_block())
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise NotEnoughVotingPowerError(tallied, needed)

    def _check_commit_header(self, chain_id: str, block_id: BlockID,
                             height: int, commit: Commit):
        if self.size() != len(commit.signatures):
            raise CommitVerifyError(
                f"invalid commit -- wrong set size: {self.size()} vs "
                f"{len(commit.signatures)}")
        if height != commit.height:
            raise CommitVerifyError(
                f"invalid commit -- wrong height: {height} vs {commit.height}")
        if block_id != commit.block_id:
            raise CommitVerifyError(
                f"invalid commit -- wrong block ID: want {block_id}, "
                f"got {commit.block_id}")

    def _pub_matrix(self):
        """Cached (n, 32) uint8 pubkey-byte matrix + all-ed25519 flag for
        the bulk-verify fast path (100k pub_key.bytes() calls + join cost
        ~0.15 s per VerifyCommit otherwise).  Keyed on the validators
        list object: every set mutation (_apply_updates/_apply_removals/
        from_proto) assigns a fresh list; priority bookkeeping mutates
        validators in place but never their keys."""
        cached = getattr(self, "_pubmat_cache", None)
        # identity-compare against a RETAINED reference (not id(): the
        # cache holding the list keeps it alive, so CPython can never
        # reuse its id for a successor list of the same length)
        if cached is not None and cached[0] is self.validators:
            return cached[1], cached[2]
        from tendermint_tpu_torch.crypto import ed25519 as edkeys

        all_ed = all(v.pub_key.type_name == edkeys.KEY_TYPE
                     for v in self.validators)
        mat = None
        if all_ed and self.validators:
            mat = np.frombuffer(
                b"".join(v.pub_key.bytes() for v in self.validators),
                dtype=np.uint8).reshape(-1, 32)
        self._pubmat_cache = (self.validators, mat, all_ed)
        return mat, all_ed

    def _verify_sigs_batch(self, chain_id: str, commit: Commit,
                           idxs: List[int], vals: List[Validator],
                           device=None):
        """Exact check-all verification of the signatures at `idxs`
        (belonging to `vals`, same order) in one batch: sign bytes come
        from the shared-prefix batch assembler (types/canonical.py
        commit_sign_bytes_batch) and verification from the bulk routing
        path (crypto/batch.verify_sigs_bulk) — no per-signature Python
        objects on the 100k-validator path."""
        from .canonical import commit_sign_bytes_batch

        msgs = commit_sign_bytes_batch(chain_id, commit, idxs)
        # the raw-pubkey matrix only helps the device route (batches of
        # at least verify_sigs_bulk's threshold); the host lanes verify
        # through the validators' existing PubKey objects, and a list
        # input reaches a running VerifyScheduler, which a matrix skips
        mat, all_ed = (self._pub_matrix()
                       if len(idxs) >= 32 and _use_device(device)
                       else (None, False))
        # the matrix rows are index-aligned with self.validators; that
        # matches idxs only on the check-all/light paths.  The trusting
        # path matches validators BY ADDRESS across different sets, so
        # vals[j] need not be validators[idxs[j]] — verify alignment by
        # identity (pointer compares, ~10 ms at 100k) before using rows
        nvals = len(self.validators)
        aligned = mat is not None and all(
            idxs[j] < nvals and self.validators[idxs[j]] is vals[j]
            for j in range(len(vals)))
        if aligned:
            pubs = mat if len(idxs) == mat.shape[0] else \
                mat[np.asarray(idxs, dtype=np.int64)]
        else:
            pubs = [v.pub_key for v in vals]
        bits = verify_sigs_bulk(pubs, msgs,
                                [commit.signatures[i].signature
                                 for i in idxs], device=device)
        if not bits.all():
            bad = idxs[int(np.argmin(bits))]
            raise CommitVerifyError(
                f"wrong signature (#{bad}): "
                f"{commit.signatures[bad].signature.hex()}")


def _process_changes(changes: List[Validator]):
    changes = sorted((c for c in changes), key=lambda v: v.address)
    updates, removals = [], []
    prev_addr = None
    for c in changes:
        if c.address == prev_addr:
            raise ValueError(f"duplicate entry {c.address.hex()}")
        if c.voting_power < 0:
            raise ValueError("voting power can't be negative")
        if c.voting_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError(
                f"voting power can't exceed {MAX_TOTAL_VOTING_POWER}")
        (removals if c.voting_power == 0 else updates).append(c)
        prev_addr = c.address
    return updates, removals


def _compute_new_priorities(updates: List[Validator], vals: "ValidatorSet",
                            updated_total_voting_power: int):
    for u in updates:
        _, val = vals.get_by_address(u.address)
        if val is None:
            u.proposer_priority = -(updated_total_voting_power
                                    + (updated_total_voting_power >> 3))
        else:
            u.proposer_priority = val.proposer_priority
