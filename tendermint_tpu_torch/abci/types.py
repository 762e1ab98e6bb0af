"""ABCI application interface (reference abci/types/application.go:13-35).

The 14-method surface of ABCI 0.18 including PrepareProposal /
ProcessProposal (this fork's addition over vanilla 0.34, SURVEY.md intro).
Requests/responses are plain dataclasses — the app boundary here is an
in-process Python interface (the reference's socket/gRPC transports are a
separate layer, abci/server/ in the reference; ours lives in abci/server.py
once networked apps land).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

CODE_TYPE_OK = 0


@dataclass
class Event:
    type: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass
class ConsensusParamsUpdate:
    block_max_bytes: int = 0
    block_max_gas: int = 0


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestInitChain:
    time_seconds: int = 0
    chain_id: str = ""
    consensus_params: Optional[ConsensusParamsUpdate] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class ResponseInitChain:
    consensus_params: Optional[ConsensusParamsUpdate] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    codespace: str = ""
    # merkle proof of (key, value) under the app hash, as (type, key, data)
    # operator tuples (reference abci/types ResponseQuery.ProofOps;
    # verified by crypto/merkle.ProofOperators in the light rpc proxy)
    proof_ops: list = field(default_factory=list)


@dataclass
class ValidatorInfo:
    """The slice of a validator ABCI apps consume (reference abci
    Validator{address, power}); duck-type compatible with types.Validator
    (.address / .voting_power), which the in-process path passes."""
    address: bytes = b""
    voting_power: int = 0


@dataclass
class Misbehavior:
    """Evidence as ABCI apps see it over the socket (reference abci
    Misbehavior; types/evidence.go ABCI() conversion).  type: 1 =
    duplicate vote, 2 = light-client attack."""
    type: int = 0
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    time_seconds: int = 0
    time_nanos: int = 0
    total_voting_power: int = 0


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header_proto: bytes = b""
    last_commit_votes: List = field(default_factory=list)  # (validator, signed_last_block)
    byzantine_validators: List = field(default_factory=list)


@dataclass
class ResponseBeginBlock:
    events: List[Event] = field(default_factory=list)


class CheckTxType:
    NEW = 0
    RECHECK = 1


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CheckTxType.NEW


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    priority: int = 0
    sender: str = ""
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def proto_deterministic(self) -> bytes:
        """Deterministic subset encoding used for LastResultsHash
        (reference types/results.go: ABCIResults from code/data only)."""
        from tendermint_tpu_torch.libs import protoenc as pe
        return (pe.varint_field(1, self.code)
                + pe.bytes_field(2, self.data))


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[ConsensusParamsUpdate] = None
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class RequestPrepareProposal:
    block_data: List[bytes] = field(default_factory=list)
    block_data_size: int = 0


@dataclass
class ResponsePrepareProposal:
    block_data: List[bytes] = field(default_factory=list)


@dataclass
class RequestProcessProposal:
    txs: List[bytes] = field(default_factory=list)
    header_proto: bytes = b""
    # filled from the wire fields when the request crosses the socket
    # (the header itself does not; reference RequestProcessProposal
    # carries hash/height/time/... instead of a Header)
    hash: bytes = b""
    height: int = 0
    time_seconds: int = 0
    time_nanos: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ResponseProcessProposal:
    accept: bool = True


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class ResponseOfferSnapshot:
    ACCEPT, ABORT, REJECT, REJECT_FORMAT, REJECT_SENDER = range(5)
    result: int = ACCEPT


@dataclass
class ResponseApplySnapshotChunk:
    ACCEPT, ABORT, RETRY, RETRY_SNAPSHOT, REJECT_SNAPSHOT = range(5)
    result: int = ACCEPT
    refetch_chunks: List[int] = field(default_factory=list)
    reject_senders: List[str] = field(default_factory=list)


class Application:
    """Base no-op application (reference abci/types/application.go:41)."""

    # info/query connection
    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    # mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    # consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) \
            -> ResponsePrepareProposal:
        return ResponsePrepareProposal(block_data=req.block_data)

    def process_proposal(self, req: RequestProcessProposal) \
            -> ResponseProcessProposal:
        return ResponseProcessProposal(accept=True)

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, height: int) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    # state-sync connection
    def list_snapshots(self) -> List[Snapshot]:
        return []

    def offer_snapshot(self, snapshot: Snapshot,
                       app_hash: bytes) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot(result=ResponseOfferSnapshot.ABORT)

    def load_snapshot_chunk(self, height: int, format_: int,
                            chunk: int) -> bytes:
        return b""

    def apply_snapshot_chunk(self, index: int, chunk: bytes,
                             sender: str) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk(
            result=ResponseApplySnapshotChunk.ABORT)
