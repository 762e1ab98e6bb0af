"""State provider (reference statesync/stateprovider.go): reconstruct
consensus State at a snapshot height from light-client-verified headers.

Header offsets (spec): header(H+1).app_hash is the app state AFTER block H;
header(H+1).last_results_hash covers block H's results; validators for H+1
come from light block H+1 and NextValidators from header(H+1)'s
next_validators_hash — obtained via light block H+2 or the provider.

The provider takes no device of its own: its certificates run on its
light client's (light.Client(device=)).
"""
from __future__ import annotations

from typing import Optional

from tendermint_tpu_torch.light.client import Client as LightClient
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types.basic import BlockID, Timestamp


class StateProvider:
    def __init__(self, light_client: LightClient,
                 now: Timestamp | None = None, params_fn=None):
        """params_fn(height) -> ConsensusParams fetches the chain's params
        (the reference's RPC provider queries /consensus_params); defaults
        are used when unavailable.  `now` pins verification time for
        deterministic tests; None means wall clock per call (a live chain
        keeps minting headers after construction)."""
        self.lc = light_client
        self.now = now
        self.params_fn = params_fn

    def _lb(self, height: int):
        return self.lc.verify_light_block_at_height(
            height, self.now if self.now is not None else Timestamp.now())

    def app_hash(self, height: int) -> bytes:
        """Trusted app hash of the state AFTER block `height`
        (reference stateprovider.go:94 AppHash -> header H+1)."""
        return self._lb(height + 1).signed_header.header.app_hash

    def commit(self, height: int):
        """The commit certifying block `height` (from light block H+1's
        last commit... the light block's own commit IS for H)."""
        return self._lb(height).signed_header.commit

    def state(self, height: int) -> State:
        """Reference stateprovider.go:108 State: builds sm.State for
        consensus to resume at height+1."""
        h = self._lb(height)          # header H + commit for H
        h1 = self._lb(height + 1)     # carries post-H app hash / results
        h2 = self._lb(height + 2)     # validators for H+2 = next for H+1
        header1 = h1.signed_header.header
        return State(
            chain_id=header1.chain_id,
            initial_height=1,
            last_block_height=height,
            last_block_id=h1.signed_header.header.last_block_id,
            last_block_time=h.signed_header.header.time,
            next_validators=h2.validators,
            validators=h1.validators,
            last_validators=h.validators,
            last_height_validators_changed=0,
            consensus_params=self._params(height),
            last_height_consensus_params_changed=0,
            last_results_hash=header1.last_results_hash,
            app_hash=header1.app_hash,
            app_version=header1.version.app,
        )

    def _params(self, height: int):
        from tendermint_tpu_torch.types.params import ConsensusParams
        if self.params_fn is not None:
            p = self.params_fn(height)
            if p is not None:
                return p
        return ConsensusParams()
