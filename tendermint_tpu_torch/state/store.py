"""State store (reference state/store.go): persists State, per-height
validator sets, consensus params, and ABCI responses.

Serialization is safe_codec (allowlisted pickle) over our own dataclasses;
the wire formats in types/ stay protobuf-exact).  Keys mirror the
reference's layout (state/store.go:25-40).
"""
from __future__ import annotations

from tendermint_tpu_torch.libs import safe_codec
from typing import List, Optional

from tendermint_tpu_torch.libs.kvdb import KVDB

from .state import State

_STATE_KEY = b"stateKey"


def _vals_key(height: int) -> bytes:
    return b"validatorsKey:%d" % height


def _params_key(height: int) -> bytes:
    return b"consensusParamsKey:%d" % height


def _abci_key(height: int) -> bytes:
    return b"abciResponsesKey:%d" % height


class StateStore:
    def __init__(self, db: KVDB):
        self.db = db

    # -- State -------------------------------------------------------------

    def save(self, state: State):
        """Persist State + the validator/params lookups for its next height
        (reference state/store.go:171-236)."""
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:
            # genesis bootstrap: save base validator sets too
            base = state.initial_height
            self._save_validators(base, state.validators)
            self.db.set(_params_key(base), safe_codec.dumps(state.consensus_params))
        self._save_validators(next_height + 1, state.next_validators)
        self.db.set(_params_key(next_height),
                    safe_codec.dumps(state.consensus_params))
        self.db.set(_STATE_KEY, safe_codec.dumps(state))

    def bootstrap(self, state: State):
        """Persist a statesync-restored state INCLUDING the validator sets
        for its own height and height+1 (reference state/store.go:155
        Bootstrap).  A plain save() only writes height+2, which would
        leave load_validators(H)/H+1 empty forever on a restored node."""
        h = state.last_block_height
        if h > 0 and state.last_validators is not None:
            self._save_validators(h, state.last_validators)
        self._save_validators(h + 1, state.validators)
        self._save_validators(h + 2, state.next_validators)
        self.db.set(_params_key(h + 1),
                    safe_codec.dumps(state.consensus_params))
        self.db.set(_STATE_KEY, safe_codec.dumps(state))

    def load(self) -> Optional[State]:
        raw = self.db.get(_STATE_KEY)
        return safe_codec.loads(raw) if raw is not None else None

    # -- validators (reference state/store.go:481) -------------------------

    def _save_validators(self, height: int, val_set):
        self.db.set(_vals_key(height), safe_codec.dumps(val_set))

    def load_validators(self, height: int):
        raw = self.db.get(_vals_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    def load_consensus_params(self, height: int):
        raw = self.db.get(_params_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    # -- ABCI responses (reference state/store.go:378) ---------------------

    def save_abci_responses(self, height: int, responses):
        self.db.set(_abci_key(height), safe_codec.dumps(responses))

    def load_abci_responses(self, height: int):
        raw = self.db.get(_abci_key(height))
        return safe_codec.loads(raw) if raw is not None else None

    # -- pruning (reference state/store.go:240) ----------------------------

    def prune_states(self, from_height: int, to_height: int):
        deletes = []
        for h in range(from_height, to_height):
            deletes.extend([_vals_key(h), _params_key(h), _abci_key(h)])
        self.db.write_batch([], deletes)
