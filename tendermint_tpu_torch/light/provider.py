"""Light block providers (reference light/provider/provider.go).

A provider serves LightBlocks by height.  The framework ships a local
store/chain-backed provider (tests, in-process full node) — the RPC-backed
provider lives in rpc/ and plugs in via the same interface.

The port's departure from the JAX package's providers: a launch that failed
on the card while a full node's pool verified reported evidence
(degrade.card_fault) leaves NodeBackedProvider.report_evidence as it is,
not as a ProviderError: the card failed, not the evidence or the provider.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from tendermint_tpu_torch.crypto.degrade import card_fault
from tendermint_tpu_torch.types.light_block import LightBlock


class ProviderError(Exception):
    pass


class LightBlockNotFound(ProviderError):
    """Benign: the provider has no block at that height
    (reference provider/errors.go ErrLightBlockNotFound)."""


class HeightTooHigh(ProviderError):
    """Benign: requested above the provider's head."""


class BadLightBlockError(ProviderError):
    """Malevolent: provider returned an invalid block; drop the provider."""


class Provider:
    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """height=0 means latest.  Raises ProviderError subclasses."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        """Submit evidence of misbehavior to the full node behind this
        provider (reference light/provider/provider.go ReportEvidence).
        Raises ProviderError on failure."""
        raise ProviderError("provider cannot accept evidence")


class DictProvider(Provider):
    """In-memory provider over a prebuilt {height: LightBlock} map — the
    test double (reference light/provider/mock)."""

    def __init__(self, chain_id: str,
                 blocks: Optional[Dict[int, LightBlock]] = None):
        self._chain_id = chain_id
        self.blocks: Dict[int, LightBlock] = dict(blocks or {})
        self.evidence: List = []  # report_evidence sink (test assertions)

    def report_evidence(self, ev) -> None:
        self.evidence.append(ev)

    def chain_id(self) -> str:
        return self._chain_id

    def add(self, lb: LightBlock):
        self.blocks[lb.height] = lb

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            if not self.blocks:
                raise LightBlockNotFound("provider is empty")
            return self.blocks[max(self.blocks)]
        if height > max(self.blocks, default=0):
            raise HeightTooHigh(f"{height} above head")
        lb = self.blocks.get(height)
        if lb is None:
            raise LightBlockNotFound(f"no light block at {height}")
        return lb


class NodeBackedProvider(Provider):
    """Serves light blocks straight from a full node's block + state stores
    (reference light/provider/http does this over RPC; in-process here)."""

    def __init__(self, chain_id: str, block_store, state_store,
                 evidence_pool=None):
        self._chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.evidence_pool = evidence_pool

    def report_evidence(self, ev) -> None:
        if self.evidence_pool is None:
            raise ProviderError("no evidence pool attached")
        try:
            self.evidence_pool.add_evidence(ev)
        except Exception as e:  # noqa: BLE001
            if card_fault(e):
                raise
            raise ProviderError(f"evidence rejected: {e}") from e

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        from tendermint_tpu_torch.types.light_block import LightBlock, SignedHeader
        if height == 0:
            height = self.block_store.height()
        if height > self.block_store.height():
            raise HeightTooHigh(f"{height} above {self.block_store.height()}")
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_seen_commit(height) \
            if height == self.block_store.height() \
            else self.block_store.load_block_commit(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise LightBlockNotFound(f"no light block at {height}")
        return LightBlock(SignedHeader(meta.header, commit), vals)


class HTTPProvider(Provider):
    """Light-block provider over a full node's JSON-RPC (reference
    light/provider/http/http.go): fetches the `light_block` route's
    canonical-proto SignedHeader + ValidatorSet and validates internal
    consistency before handing it to the light client."""

    def __init__(self, chain_id: str, addr: str, timeout: float = 10.0):
        from tendermint_tpu_torch.rpc.client import HTTPClient

        self._chain_id = chain_id
        self.client = HTTPClient(addr, timeout=timeout)

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        import base64

        from tendermint_tpu_torch.rpc.client import RPCClientError
        from tendermint_tpu_torch.types.light_block import LightBlock, SignedHeader
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        try:
            r = self.client.call("light_block",
                                 **({"height": height} if height else {}))
        except RPCClientError as e:
            if "above" in str(e) or "no light block" in str(e) \
                    or "no commit" in str(e):
                raise LightBlockNotFound(str(e)) from e
            raise ProviderError(str(e)) from e
        try:
            sh = SignedHeader.from_proto(
                base64.b64decode(r["signed_header"]))
            vals = ValidatorSet.from_proto(
                base64.b64decode(r["validator_set"]))
        except Exception as e:
            raise BadLightBlockError(f"undecodable light block: {e}") from e
        lb = LightBlock(sh, vals)
        try:
            lb.validate_basic(self._chain_id)
        except Exception as e:
            raise BadLightBlockError(f"invalid light block: {e}") from e
        if height and sh.height != height:
            raise BadLightBlockError(
                f"asked height {height}, got {sh.height}")
        return lb

    def report_evidence(self, ev) -> None:
        import base64

        from tendermint_tpu_torch.rpc.client import RPCClientError
        from tendermint_tpu_torch.types.evidence import evidence_proto

        try:
            self.client.call(
                "broadcast_evidence",
                evidence=base64.b64encode(evidence_proto(ev)).decode())
        except RPCClientError as e:
            raise ProviderError(f"evidence submission failed: {e}") from e
