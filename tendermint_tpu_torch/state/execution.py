"""BlockExecutor (reference state/execution.go).

ApplyBlock: validate -> BeginBlock/DeliverTx*/EndBlock -> save ABCI
responses -> update State -> Commit app + update mempool -> prune -> fire
events (reference state/execution.go:189-266).  Commit verification inside
validate_block routes through the card's batch plane
(ValidatorSet.verify_commit, reference state/validation.go:92).

The one departure from the JAX package's BlockExecutor: it takes
`device`, which it passes to that verify_commit call.  None means the
package default ("cuda"; see tendermint_tpu_torch/__init__.py): on a
machine without CUDA, a last commit that reaches the device lane raises
RuntimeError unless the executor was made with device="cpu".
"""
from __future__ import annotations

import time

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto import merkle, tmhash
from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs.fail import fail_point
from tendermint_tpu_torch.types.basic import BlockID, Timestamp
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import CommitVerifyError

from .state import State


@dataclass
class ABCIResponses:
    """Responses from executing a block (reference state/store.go
    ABCIResponses)."""
    deliver_txs: List[abci.ResponseDeliverTx] = field(default_factory=list)
    end_block: Optional[abci.ResponseEndBlock] = None
    begin_block: Optional[abci.ResponseBeginBlock] = None

    def results_hash(self) -> bytes:
        """Merkle root of deterministic tx results (reference
        types/results.go ABCIResults.Hash)."""
        return merkle.hash_from_byte_slices(
            [r.proto_deterministic() for r in self.deliver_txs])


class BlockExecutionError(Exception):
    pass


def validator_updates_to_validators(updates) -> List[Validator]:
    from tendermint_tpu_torch.crypto import ed25519 as edkeys
    out = []
    for vu in updates:
        if vu.pub_key_type != "ed25519":
            raise BlockExecutionError(
                f"unsupported validator pubkey type {vu.pub_key_type}")
        out.append(Validator.new(edkeys.PubKey(vu.pub_key_bytes), vu.power))
    return out


class BlockExecutor:
    # node name the consensus observatory keys this executor's apply
    # stamps under (node.py sets the moniker; bare test executors
    # record under "" — harmless, the ring is bounded)
    obs_node = ""

    def __init__(self, state_store, app: abci.Application, mempool=None,
                 evidence_pool=None, event_bus=None, block_store=None,
                 metrics_registry=None, device=None):
        from tendermint_tpu_torch.libs.metrics import StateMetrics
        self.state_store = state_store
        self.metrics = StateMetrics(metrics_registry)
        self.app = app
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.block_store = block_store
        # the device the last commit's signatures verify on (None: the
        # package default); check_commit_no_sigs verifies none
        self.device = device
        self._verified_commits: dict = {}

    # -- proposal creation (reference state/execution.go:95-145) -----------

    # stage walls of the most recent create_proposal_block, written by
    # the proposing thread and read back by decide_proposal for the
    # observatory's proposal_signed sub-attrs (ADR-024); single
    # consumer — the consensus receive thread drives both sides
    last_propose_timings: dict = {}

    def create_proposal_block(self, height: int, state: State,
                              commit: Commit, proposer_address: bytes, *,
                              reap_budget_s: Optional[float] = None,
                              prepare_budget_s: Optional[float] = None,
                              max_bytes_cap: Optional[int] = None) -> Block:
        """Budgeted proposal creation (ADR-024): wall-clock budgets for
        the reap and PrepareProposal stages plus an optional byte cap
        degrade the BLOCK (fewer/raw txs) instead of the round when the
        mempool is huge or the app is slow.  No budgets (the default)
        keeps the unbounded reference behavior, except that an app
        exception in PrepareProposal now also degrades to the raw
        reaped txs — a broken app must not stall the proposer."""
        max_bytes = state.consensus_params.block.max_bytes
        if max_bytes_cap and (max_bytes < 0 or max_bytes_cap < max_bytes):
            max_bytes = max_bytes_cap
        max_gas = state.consensus_params.block.max_gas
        evidence = (self.evidence_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes)
            if self.evidence_pool else [])
        max_data = max_data_bytes(max_bytes, len(evidence),
                                  state.validators.size())

        t0 = time.perf_counter()
        # the deadline is fixed BEFORE the chaos seam so an injected
        # latency consumes the budget exactly like a slow lock queue
        deadline = (time.monotonic() + reap_budget_s
                    if reap_budget_s else None)
        txs: List[bytes] = []
        reap_degraded = False
        with trace.span("propose.reap", height=height) as sp:
            try:
                fail.inject("propose.reap")
                if self.mempool is not None:
                    txs = self._reap(max_data, max_gas, deadline)
            except Exception as e:  # noqa: BLE001 - a mempool fault
                # degrades to an empty block, never a stalled round
                txs, reap_degraded = [], True
                if trace.is_enabled():
                    sp.add(degraded=type(e).__name__)
            if trace.is_enabled():
                sp.add(txs=len(txs))
        t1 = time.perf_counter()

        # PrepareProposal: the app may reorder/replace txs.  With a
        # budget the call runs on a bounded-join daemon thread (the
        # bench.py backend-probe discipline): a slow or wedged app
        # yields the raw reaped txs at the deadline.
        prepare_degraded = False
        with trace.span("propose.prepare", height=height) as sp:
            req = abci.RequestPrepareProposal(
                block_data=list(txs), block_data_size=max_data)
            block_data, why = self._prepare(req, prepare_budget_s)
            if why is not None:
                block_data, prepare_degraded = list(txs), True
                if trace.is_enabled():
                    sp.add(degraded=why)
        t2 = time.perf_counter()

        with trace.span("propose.assemble", height=height):
            block = state.make_block(height, block_data, commit,
                                     evidence, proposer_address)
        t3 = time.perf_counter()

        self.metrics.proposal_create_seconds.observe(t1 - t0, stage="reap")
        self.metrics.proposal_create_seconds.observe(
            t2 - t1, stage="prepare")
        self.metrics.proposal_create_seconds.observe(
            t3 - t2, stage="assemble")
        self.last_propose_timings = {
            "reap_s": round(t1 - t0, 6), "prepare_s": round(t2 - t1, 6),
            "assemble_s": round(t3 - t2, 6),
            "reap_degraded": reap_degraded,
            "prepare_degraded": prepare_degraded}
        return block

    def _reap(self, max_data: int, max_gas: int,
              deadline: Optional[float]) -> List[bytes]:
        """Reap with the deadline when the mempool understands it; the
        in-tree mempools do, duck-typed test/harness stand-ins keep
        the two-argument call."""
        reap = self.mempool.reap_max_bytes_max_gas
        if deadline is not None:
            try:
                import inspect
                takes_deadline = "deadline" in \
                    inspect.signature(reap).parameters
            except (TypeError, ValueError):
                takes_deadline = False
            if takes_deadline:
                return reap(max_data, max_gas, deadline=deadline)
        return reap(max_data, max_gas)

    def _prepare(self, req, budget_s: Optional[float]):
        """(block_data, None) from the app, or (None, reason) when the
        call must degrade: app exception either way, deadline overrun
        when budgeted (the abandoned daemon thread finishes or wedges
        harmlessly — its result is simply unused)."""
        if not budget_s:
            try:
                return list(self.app.prepare_proposal(req).block_data), None
            except Exception as e:  # noqa: BLE001 - degrade, don't stall
                return None, type(e).__name__
        import threading
        box: dict = {}

        def call():
            try:
                box["data"] = list(self.app.prepare_proposal(req).block_data)
            except BaseException as e:  # noqa: BLE001 - carried to joiner
                box["err"] = e

        t = threading.Thread(target=call, daemon=True,
                             name="propose-prepare")
        t.start()
        t.join(budget_s)
        if t.is_alive():
            return None, "deadline"
        if "err" in box:
            return None, type(box["err"]).__name__
        return box["data"], None

    def process_proposal(self, block: Block, state: State) -> bool:
        """ProcessProposal ABCI gate (reference state/execution.go:147)."""
        resp = self.app.process_proposal(abci.RequestProcessProposal(
            txs=list(block.data.txs), header_proto=block.header.proto()))
        return resp.accept

    # -- pre-verified commit cache (blocksync coalescing seam) -------------

    def mark_commit_verified(self, height: int, commit) -> None:
        """Record that EVERY non-absent signature of `commit` (certifying
        `height`) was verified in a coalesced batch (blocksync/replay.py),
        so validate_block skips the redundant re-verification.  Keyed by the
        full canonical encoding — any content difference (round, block ID,
        timestamps, signatures) misses the cache and re-verifies."""
        self._verified_commits[(height, tmhash.sum(commit.proto()))] = True
        # bounded: drop entries far below the verified frontier
        if len(self._verified_commits) > 4096:
            cutoff = height - 2048
            self._verified_commits = {
                k: v for k, v in self._verified_commits.items()
                if k[0] >= cutoff}

    def _commit_preverified(self, height: int, commit) -> bool:
        return (height, tmhash.sum(commit.proto())) in self._verified_commits

    # -- validation (reference state/validation.go) ------------------------

    def validate_block(self, state: State, block: Block):
        block.validate_basic()
        header = block.header
        if header.version.block != 11 or header.version.app != state.app_version:
            raise BlockExecutionError("wrong Block.Header.Version")
        if header.chain_id != state.chain_id:
            raise BlockExecutionError("wrong Block.Header.ChainID")
        if header.height != state.last_block_height + 1 and not (
                state.last_block_height == 0
                and header.height == state.initial_height):
            raise BlockExecutionError(
                f"wrong Block.Header.Height: got {header.height}")
        if header.last_block_id != state.last_block_id:
            raise BlockExecutionError("wrong Block.Header.LastBlockID")
        if header.app_hash != state.app_hash:
            raise BlockExecutionError("wrong Block.Header.AppHash")
        if header.validators_hash != state.validators.hash():
            raise BlockExecutionError("wrong Block.Header.ValidatorsHash")
        if header.next_validators_hash != state.next_validators.hash():
            raise BlockExecutionError("wrong Block.Header.NextValidatorsHash")
        if header.consensus_hash != state.consensus_params.hash():
            raise BlockExecutionError("wrong Block.Header.ConsensusHash")
        if header.last_results_hash != state.last_results_hash:
            raise BlockExecutionError("wrong Block.Header.LastResultsHash")

        # LastCommit (reference state/validation.go:92: the hot full-set
        # verification -> the card's batch plane)
        if block.header.height == state.initial_height:
            if block.last_commit is not None and block.last_commit.signatures:
                raise BlockExecutionError(
                    "initial block can't have LastCommit signatures")
        else:
            if block.last_commit is None:
                raise BlockExecutionError("nil LastCommit")
            if len(block.last_commit.signatures) != state.last_validators.size():
                raise BlockExecutionError("invalid LastCommit signature count")
            if self._commit_preverified(block.header.height - 1,
                                        block.last_commit):
                # signatures already batched (blocksync window); still check
                # header linkage + >2/3 power, skipping only re-verification
                state.last_validators.check_commit_no_sigs(
                    state.chain_id, state.last_block_id,
                    block.header.height - 1, block.last_commit)
            else:
                state.last_validators.verify_commit(
                    state.chain_id, state.last_block_id,
                    block.header.height - 1, block.last_commit,
                    device=self.device)

        if not state.validators.has_address(header.proposer_address):
            raise BlockExecutionError(
                "block proposer is not in the validator set")

        # evidence verification (reference state/validation.go:139)
        if self.evidence_pool is not None and block.evidence:
            self.evidence_pool.check_evidence(block.evidence)

    # -- apply (reference state/execution.go:189-266) ----------------------

    def apply_block(self, state: State, block_id: BlockID,
                    block: Block) -> Tuple[State, ABCIResponses]:
        # observatory apply stamps bracket the same region as the
        # trace span (the acceptance test pins them against each
        # other); apply_done on clean exit only, like
        # block_processing_time
        from tendermint_tpu_torch.consensus import observatory as obsv
        h = block.header.height
        obsv.stamp(self.obs_node, h, "apply_start")
        with trace.span("state.apply_block", height=h,
                        txs=len(block.data.txs)):
            out = self._apply_block(state, block_id, block)
        obsv.stamp(self.obs_node, h, "apply_done")
        return out

    def _apply_block(self, state: State, block_id: BlockID,
                     block: Block) -> Tuple[State, ABCIResponses]:
        # Histogram.time observes on clean exit only — identical to the
        # old hand-rolled perf_counter delta, which sat after the last
        # raise site and so never recorded a failed apply either
        block_timer = self.metrics.block_processing_time.time(
            clock=time.perf_counter)
        with trace.span("state.validate_block",
                        height=block.header.height):
            self.validate_block(state, block)

        responses = self._exec_block_on_app(state, block)
        fail_point(1)

        if self.state_store is not None:
            self.state_store.save_abci_responses(block.header.height,
                                                 responses)
        fail_point(2)

        validator_updates = validator_updates_to_validators(
            responses.end_block.validator_updates
            if responses.end_block else [])

        new_state = update_state(state, block_id, block, responses,
                                 validator_updates)

        # Commit app state; lock+flush mempool against the new height
        app_hash = self._commit(new_state, block)
        new_state.app_hash = app_hash
        fail_point(3)

        if self.state_store is not None:
            self.state_store.save(new_state)
        fail_point(4)

        if self.evidence_pool is not None:
            self.evidence_pool.update(new_state, block.evidence)

        if self.event_bus is not None:
            self._fire_events(block, block_id, responses, validator_updates)
        block_timer.observe()
        return new_state, responses

    def _exec_block_on_app(self, state: State, block: Block) -> ABCIResponses:
        last_commit_votes = []
        if block.last_commit is not None and state.last_validators is not None:
            for i, cs in enumerate(block.last_commit.signatures):
                _, val = state.last_validators.get_by_index(i)
                if val is not None:
                    last_commit_votes.append((val, not cs.is_absent()))
        rbb = self.app.begin_block(abci.RequestBeginBlock(
            hash=block.hash() or b"",
            header_proto=block.header.proto(),
            last_commit_votes=last_commit_votes,
            byzantine_validators=[
                m for ev in block.evidence for m in ev.abci()]))
        dtxs = [self.app.deliver_tx(tx) for tx in block.data.txs]
        reb = self.app.end_block(block.header.height)
        return ABCIResponses(deliver_txs=dtxs, end_block=reb,
                             begin_block=rbb)

    def _commit(self, state: State, block: Block) -> bytes:
        if self.mempool is not None:
            self.mempool.lock()
        try:
            rc = self.app.commit()
            if self.mempool is not None:
                self.mempool.update(block.header.height, block.data.txs)
        finally:
            if self.mempool is not None:
                self.mempool.unlock()
        return rc.data

    def _fire_events(self, block, block_id, responses, validator_updates):
        self.event_bus.publish_new_block(block, block_id, responses)
        if validator_updates:
            self.event_bus.publish_validator_set_updates(validator_updates)


def update_state(state: State, block_id: BlockID, block: Block,
                 responses: ABCIResponses,
                 validator_updates: List[Validator]) -> State:
    """Reference state/execution.go updateState."""
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        last_height_vals_changed = block.header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    if responses.end_block is not None and \
            responses.end_block.consensus_param_updates is not None:
        next_params = state.consensus_params.update(
            responses.end_block.consensus_param_updates)
        next_params.validate_basic()
        last_height_params_changed = block.header.height + 1

    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=block.header.height,
        last_block_id=block_id,
        last_block_time=block.header.time,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=responses.results_hash(),
        app_hash=b"",  # set by caller after app Commit
        app_version=state.app_version,
    )


def max_data_bytes(max_bytes: int, evidence_count: int, vals_count: int) -> int:
    """Approximate tx-byte budget (reference types/block.go MaxDataBytes)."""
    overhead = 1024 + 121 * vals_count + 500 * evidence_count
    return max(max_bytes - overhead, 1024)
