"""Coalesced block replay — the core of blocksync that feeds the card.

The reference syncs one block per loop iteration: VerifyCommitLight on the
certifying commit, then ApplyBlock (which fully re-verifies the block's own
LastCommit) — two serial signature loops per block
(reference blocksync/reactor.go:352-429, state/validation.go:92).

Here the unit of work is a *window* of consecutive blocks.  While the
validator set is stable (the common case — epochs of thousands of blocks),
every signature the window needs — the >2/3 light prefixes certifying each
block AND the full LastCommit sets required by validate_block — is collected
into ONE coalesced verify — the shared VerifyScheduler (crypto/scheduler.py,
BLOCKSYNC class) when it is running, a private BatchVerifier otherwise: W
blocks x ~1.7N sigs ride a single kernel launch on the card instead of 2W
host loops.  Verified commits are recorded in the executor's pre-verified
cache so apply_block does not re-verify.

When a BlockPipeline (state/pipeline.py, ADR-017) is installed and running,
the stable prefix routes through it instead: block N+1 stages (decode,
part-set, signature submission) and storage group-commits while block N
applies — same verification semantics, overlapped in time.

Correctness does not rest on the optimistic batch: any batch failure (or a
window where the stable-set condition does not hold) falls back to the
reference's strict sequential path, which identifies the offending height
for RedoRequest.

The port's departures from the JAX package's replay:

  * the executor's device (BlockExecutor.device) is the device of every
    signature the window verifies: the coalesced batch's verify_items and
    the strict path's verify_commit_light take device=executor.device;
  * a launch that failed on the card outside a chaos drill
    (degrade.DeviceLaneError with no failpoint armed) is not a fault of
    the peer's data: it leaves replay_window as WindowDeviceError, a
    DeviceLaneError that carries the state and the count of the blocks
    that did apply, never wrapped in WindowSyncError and never retried on
    the strict path, on the lockstep branch as on the local one.  In a
    chaos drill the JAX package's behaviour holds.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import scheduler as vsched
from tendermint_tpu_torch.crypto.degrade import DeviceLaneError, card_fault
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.part_set import (
    PartSet, BLOCK_PART_SIZE_BYTES, make_block_parts)
from tendermint_tpu_torch.types.validator_set import CommitVerifyError


def block_id_of(block: Block) -> Tuple[BlockID, PartSet]:
    """BlockID as gossiped/signed: block hash + part-set header
    (reference blocksync/reactor.go:365-369).

    The part set rides the proposer's streaming path (ADR-024): the
    header needs only the chunking + bulk-hashed leaf layer, and
    per-part proofs are extracted lazily — a consumer that never reads
    the parts (the crash-resume identity check in _apply_one, a
    store-less replay, a header-only verification failure) never pays
    for proof construction at all; store.save_block materializes each
    part's proof on first access at save time."""
    parts = make_block_parts(block)
    return BlockID(hash=block.hash(), part_set_header=parts.header()), parts


class WindowSyncError(Exception):
    """Raised when a window cannot be applied; carries the offending height
    (for RedoRequest) plus the state/count after the blocks that DID apply."""

    def __init__(self, height: int, reason: str, state=None, applied: int = 0):
        super().__init__(f"blocksync: height {height}: {reason}")
        self.height = height
        self.state = state
        self.applied = applied


class WindowDeviceError(DeviceLaneError):
    """A launch failed on the card while a window replayed: the card's
    fault, not the peer's.  Carries the height being verified or applied
    and, as WindowSyncError does, the state/count after the blocks that
    DID apply, so a caller keeps them without asking a peer for a redo."""

    def __init__(self, height: int, cause: BaseException, state=None,
                 applied: int = 0):
        super().__init__(f"blocksync: height {height}: card fault: {cause}")
        self.height = height
        self.state = state
        self.applied = applied


def window_error(height: int, e: BaseException, state, applied: int,
                 reason: Optional[str] = None) -> Exception:
    """The error a window raises for `e` at `height`: WindowDeviceError
    for a card fault (kept as it is if it is one already), else
    WindowSyncError with `reason` (default str(e))."""
    if isinstance(e, WindowDeviceError):
        return e
    if card_fault(e):
        return WindowDeviceError(height, e, state, applied)
    return WindowSyncError(height, str(e) if reason is None else reason,
                           state, applied)


def _stable_window(state, blocks: List[Block]) -> int:
    """Largest prefix of `blocks` verifiable against the CURRENT validator
    set without applying intermediate blocks: requires no pending set change
    (validators == next_validators) and each header claiming the same sets.
    Header claims are re-checked authoritatively by validate_block before
    apply, so a lying header can only shrink the fast path, never corrupt it.
    """
    vh = state.validators.hash()
    if state.next_validators.hash() != vh:
        return 1 if blocks else 0
    k = 0
    for b in blocks:
        if (b.header.validators_hash != vh
                or b.header.next_validators_hash != vh):
            break
        k += 1
    return max(k, 1 if blocks else 0)


def _collect_block_items(state, chain_id: str, block: Block, cert,
                         height: int, first: bool):
    """Structural checks + signature-item collection for one block of a
    stable window: the >2/3 light prefix certifying it plus the full
    LastCommit set validate_block needs.  `first` selects
    state.last_validators for the LastCommit indices of the window's
    first block.  Raises on any malformed peer data.

    Returns (bid, parts, prefix_items, lc_items)."""
    bid, parts = block_id_of(block)
    prefix = state.validators.collect_commit_light(chain_id, bid, height,
                                                   cert)
    prefix_items = [
        (state.validators.validators[idx].pub_key,
         cert.vote_sign_bytes(chain_id, idx),
         cert.signatures[idx].signature)
        for idx in prefix]
    lvals = state.last_validators if first else state.validators
    lc = block.last_commit
    lc_items = []
    if height > state.initial_height and lc is not None:
        if len(lc.signatures) != lvals.size():
            raise CommitVerifyError("LastCommit size mismatch")
        for idx, cs in enumerate(lc.signatures):
            if cs.is_absent():
                continue
            lc_items.append(
                (lvals.validators[idx].pub_key,
                 lc.vote_sign_bytes(chain_id, idx),
                 cs.signature))
    return bid, parts, prefix_items, lc_items


def _strict_sequential(executor, store, state, blocks: List[Block],
                       certifiers: List, chain_id: str, applied0: int = 0):
    """The reference's strict sequential path: per-height
    VerifyCommitLight + apply, attributing the first bad height.
    `applied0` offsets WindowSyncError.applied when a pipelined prefix
    of the same window already applied (ADR-017 fallback ladder)."""
    applied = applied0
    base_h = state.last_block_height + 1
    for i in range(len(blocks)):
        b, cert = blocks[i], certifiers[i]
        h = base_h + i
        try:
            bid, parts = block_id_of(b)
            state.validators.verify_commit_light(chain_id, bid, h, cert,
                                                 device=executor.device)
        except Exception as e:
            raise window_error(h, e, state, applied,
                               f"bad block/certifying commit: {e}") from e
        try:
            state = _apply_one(executor, store, state, b, bid, parts, cert)
        except Exception as e:
            raise window_error(h, e, state, applied) from e
        applied += 1
    return state, applied


def replay_window(executor, store, state, blocks: List[Block],
                  certifiers: List, max_window: int = 64):
    """Verify + apply up to max_window consecutive blocks.

    blocks[i] is at height state.last_block_height + 1 + i; certifiers[i] is
    the Commit certifying blocks[i] (normally blocks[i+1].last_commit; for
    the final block of a completed sync, the seen commit).

    Returns (new_state, n_applied).  Raises WindowSyncError(height) when a
    block fails verification/validation, and WindowDeviceError when a
    launch failed on the card.
    """
    if not blocks:
        return state, 0
    assert len(certifiers) == len(blocks)
    blocks = blocks[:max_window]
    certifiers = certifiers[:len(blocks)]

    # ---- pipelined path (state/pipeline.py, ADR-017) ---------------------
    # stage/verify block N+1 and group-commit storage while N applies;
    # declines (None) when not running, the window is trivial, or the
    # stable prefix is < 2 — every decline lands on the paths below
    from tendermint_tpu_torch.state import pipeline as _pipeline
    pipe = _pipeline.running()
    if pipe is not None:
        res = pipe.replay_window(executor, store, state, blocks, certifiers,
                                 max_window=max_window)
        if res is not None:
            return res

    k = _stable_window(state, blocks)
    chain_id = state.chain_id
    base_h = state.last_block_height + 1

    # ---- optimistic coalesced batch over the stable prefix ---------------
    applied = 0
    if k >= 2:
        # phase 1: structural checks + item collection per block
        plan = []  # (bid, parts, prefix_items, lc_items)
        for i in range(k):
            b, cert = blocks[i], certifiers[i]
            h = base_h + i
            try:
                bid, parts, prefix_items, lc_items = _collect_block_items(
                    state, chain_id, b, cert, h, first=(i == 0))
            except Exception:
                # any malformed peer data truncates the window here; if this
                # is block 0 the strict path below raises with attribution
                break
            plan.append((bid, parts, prefix_items, lc_items))
        collected = len(plan)
        # phase 2: one batch.  When cert_i IS block i+1's LastCommit (the
        # reactor flow) and block i+1 is in the window, its full set
        # already covers the prefix — skip the duplicate ~2N/3 lanes.
        items = []
        ids = []
        for i, (bid, parts, prefix_items, lc_items) in enumerate(plan):
            covered = (i + 1 < collected
                       and certifiers[i] is blocks[i + 1].last_commit)
            if not covered:
                items.extend(prefix_items)
            items.extend(lc_items)
            ids.append((bid, parts))
        if collected >= 1:
            # replay class on the shared verify scheduler (coalesces
            # with whatever consensus/light work is in flight, below
            # their priority) when it runs on the executor's device;
            # exact BatchVerifier semantics either way.  On a
            # multi-process runtime (torch.distributed initialised) this
            # is a lockstep-safe site: every process replays the same
            # window in the same order, so the batch may enter the
            # global plane's collective (ADR-027) — coordinated=True
            # skips the scheduler, whose coalescing with process-local
            # traffic would break the cross-process shape agreement
            from tendermint_tpu_torch.parallel import sharding
            try:
                if sharding.global_mesh_ready():
                    with sharding.lockstep():
                        all_ok, _bits = vsched.verify_items(
                            items, vsched.Priority.BLOCKSYNC,
                            device=executor.device, coordinated=True)
                else:
                    all_ok, _bits = vsched.verify_items(
                        items, vsched.Priority.BLOCKSYNC,
                        device=executor.device)
            except Exception as e:
                if card_fault(e):
                    raise window_error(base_h, e, state, 0) from e
                raise
            if all_ok:
                for i in range(collected):
                    b, cert = blocks[i], certifiers[i]
                    h = base_h + i
                    bid, parts = ids[i]
                    # only the FULL LastCommit sets were batch-verified;
                    # cert's non-prefix signatures were not, so cert is
                    # never marked (validate_block re-verifies it in full
                    # when its enclosing block applies)
                    if b.last_commit is not None:
                        executor.mark_commit_verified(h - 1, b.last_commit)
                    try:
                        state = _apply_one(executor, store, state, b, bid,
                                           parts, cert)
                    except Exception as e:
                        raise window_error(h, e, state, applied) from e
                    applied += 1
                return state, applied
        else:
            k = 1  # block 0 failed structural checks: strict path attributes
            # else: fall through to strict sequential to attribute failure

    # ---- strict sequential path (reference semantics) --------------------
    n = min(len(blocks), max(k, 1))
    return _strict_sequential(executor, store, state, blocks[:n],
                              certifiers[:n], chain_id)


def _apply_one(executor, store, state, block, bid, parts, cert):
    from tendermint_tpu_torch.consensus import observatory as obsv

    if store is not None:
        h = block.header.height
        if store.height() >= h:
            # crash-recovery resume (ADR-017): a previous run's group
            # commit already made this block durable (the state store
            # can trail the block store by up to one commit group).
            # Re-saving would violate store-height monotonicity; verify
            # identity instead and skip the save.
            meta = store.load_block_meta(h)
            if meta is None or meta.block_id.hash != block.hash():
                raise ValueError(
                    f"stored block {h} does not match replayed block")
        else:
            store.save_block(block, parts, cert)
    new_state, _resp = executor.apply_block(state, bid, block)
    # drain the observatory's deferred publication per applied height:
    # during catch-up the consensus receive loop (the usual drainer)
    # isn't running yet, and apply_block just completed this height's
    # record (ADR-020)
    obsv.publish_pending()
    return new_state
