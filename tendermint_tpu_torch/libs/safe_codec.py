"""Restricted (de)serialization for wire/storage use.

Pickle is convenient for our dataclass graph but unpickling attacker bytes
is code execution; this wraps it with a class whitelist: only types
registered here (framework dataclasses + harmless builtins) deserialize.
The p2p layer, WAL and stores use these instead of raw pickle.
"""
from __future__ import annotations

import io
import pickle
from typing import Set, Tuple

_ALLOWED: Set[Tuple[str, str]] = set()
_defaults_done = False


def register(cls) -> type:
    """Allow a class for deserialization (usable as a decorator)."""
    _ALLOWED.add((cls.__module__, cls.__qualname__))
    return cls


def _register_defaults():
    """The JAX package's allow-list, with the package path mapped."""
    global _defaults_done
    _defaults_done = True
    import tendermint_tpu_torch.abci.types as abci_types
    from tendermint_tpu_torch.types import (
        basic, block, commit, params, part_set, proposal, validator,
        validator_set, vote)
    # imported for their @register side effects (evidence in stored
    # blocks, light blocks in the light store)
    from tendermint_tpu_torch.types import evidence, light_block  # noqa: F401
    from tendermint_tpu_torch.crypto import ed25519, merkle
    from tendermint_tpu_torch.consensus import round_types, wal
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state import state as sm_state

    for cls in (
        basic.Timestamp, basic.BlockID, basic.PartSetHeader,
        basic.SignedMsgType, basic.BlockIDFlag,
        block.Header, block.Block, block.Data, block.Consensus,
        block.BlockMeta,
        commit.Commit, commit.CommitSig,
        part_set.Part, merkle.Proof,
        proposal.Proposal, vote.Vote,
        round_types.ProposalMessage, round_types.BlockPartMessage,
        round_types.VoteMessage, round_types.TimeoutInfo, round_types.Step,
        wal.EndHeightMessage,
        # storage-side graph (state/validators/params/ABCI responses)
        validator.Validator, validator_set.ValidatorSet,
        ed25519.PubKey, ed25519.PrivKey,
        params.ConsensusParams, params.BlockParams, params.EvidenceParams,
        params.ValidatorParams, params.VersionParams,
        sm_state.State, execution.ABCIResponses,
    ):
        register(cls)
    # every ABCI request/response dataclass (stored in SaveABCIResponses)
    import dataclasses
    for name in dir(abci_types):
        obj = getattr(abci_types, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            register(obj)


_BUILTINS = {
    ("builtins", "bytes"), ("builtins", "bytearray"), ("builtins", "int"),
    ("builtins", "str"), ("builtins", "list"), ("builtins", "dict"),
    ("builtins", "tuple"), ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "bool"), ("builtins", "float"), ("builtins", "complex"),
    ("builtins", "NoneType"),
}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if not _defaults_done:
            _register_defaults()
        if (module, name) in _ALLOWED or (module, name) in _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"deserialization of {module}.{name} is not allowed")


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=4)


def loads(data: bytes):
    return _SafeUnpickler(io.BytesIO(data)).load()
