"""Roll the replicated state back one height (reference state/rollback.go).

Used after an app-hash mismatch or a botched upgrade: the state store's
latest state (height n) is overwritten with a state rebuilt from block
n-1's header, so the node re-executes block n against the (fixed) app.
Application state is NOT touched — the operator rolls the app back by its
own means (or relies on handshake replay for in-process apps).
"""
from __future__ import annotations

from typing import Tuple

from tendermint_tpu_torch.state.state import State


class RollbackError(Exception):
    pass


def rollback(block_store, state_store) -> Tuple[int, bytes]:
    """Returns (new_height, app_hash).  Mirrors reference
    state/rollback.go:15-112 including the crash-window early return."""
    invalid = state_store.load()
    if invalid is None:
        raise RollbackError("no state found")

    height = block_store.height()

    # state and block persistence are not atomic: a crash can leave the
    # block store one ahead with the state not yet updated — nothing to
    # roll back (rollback.go:27-31)
    if height == invalid.last_block_height + 1:
        return invalid.last_block_height, invalid.app_hash

    if height != invalid.last_block_height:
        raise RollbackError(
            f"statestore height ({invalid.last_block_height}) is not one "
            f"below or equal to blockstore height ({height})")

    rollback_height = invalid.last_block_height - 1
    rb_meta = block_store.load_block_meta(rollback_height)
    if rb_meta is None:
        raise RollbackError(f"block at height {rollback_height} not found")
    # app hash / last results hash for height n-1 are only agreed in
    # block n's header (rollback.go:46-50)
    latest_meta = block_store.load_block_meta(invalid.last_block_height)
    if latest_meta is None:
        raise RollbackError(
            f"block at height {invalid.last_block_height} not found")

    prev_last_validators = state_store.load_validators(rollback_height)
    if prev_last_validators is None:
        raise RollbackError(f"no validators at height {rollback_height}")
    prev_params = state_store.load_consensus_params(rollback_height + 1)
    if prev_params is None:
        prev_params = invalid.consensus_params

    val_change = invalid.last_height_validators_changed
    if val_change > rollback_height:
        val_change = rollback_height + 1
    params_change = invalid.last_height_consensus_params_changed
    if params_change > rollback_height:
        params_change = rollback_height + 1

    rolled = State(
        chain_id=invalid.chain_id,
        initial_height=invalid.initial_height,
        last_block_height=rb_meta.header.height,
        last_block_id=rb_meta.block_id,
        last_block_time=rb_meta.header.time,
        next_validators=invalid.validators.copy(),
        validators=invalid.last_validators.copy(),
        last_validators=prev_last_validators.copy(),
        last_height_validators_changed=val_change,
        consensus_params=prev_params,
        last_height_consensus_params_changed=params_change,
        last_results_hash=latest_meta.header.last_results_hash,
        app_hash=latest_meta.header.app_hash,
        app_version=invalid.app_version,
    )
    state_store.save(rolled)
    return rolled.last_block_height, rolled.app_hash
