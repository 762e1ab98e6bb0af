"""Node assembly (reference node/node.go:704-1001): wire config -> stores
-> handshake -> mempool/evidence -> executor -> consensus -> p2p reactors
-> RPC, with the same startup order as NewNode + OnStart.

Departures from the JAX package's node/node.py:

- The node's device.  `Node(..., device=None)` resolves its device in
  the constructor (None: the package default, "cuda"; with no CUDA and no
  device="cpu" it raises RuntimeError, so no node carries on on the CPU
  when it finds no card) and passes it to every owner that verifies: the
  BlockExecutor, the EvidencePool, LightServe, the IngressGate, the
  ConsensusState and the state-sync light client.  `on_start` installs
  the VerifyScheduler from [verify_scheduler] on that device.  The
  config has no device key: the `start` command's `--device` sets it.
- The state-sync routine's card-fault rule.  A card fault
  (degrade.card_fault: a DeviceLaneError outside a chaos drill) leaves
  `Syncer.sync_any` as itself.  `_statesync_routine` keeps it on
  `node.device_error`, logs it by name and ends: no blocksync fallback,
  nothing bootstrapped.  `resume_statesync()`, or a fresh Node over the
  same home, restores again from the RestoreLedger's chunks.
- The handshake after a card fault in `apply_block`.  A launch that
  fails inside the state machine's `_finalize_commit_locked` ends
  consensus after the block and its #ENDHEIGHT are on disk; the
  handshake's "app behind store" tail (`_replay_tail_block`) applies that
  block to the app and the state, and consensus goes on from the WAL.
  The handshake runs no signature check (the reference's replay trusts
  the stored blocks), so this needs no device; `Node.device_error`
  reports the state machine's fault too.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.abci.types import (RequestInfo, RequestInitChain,
                                       ValidatorUpdate)
from tendermint_tpu_torch.blocksync import BlocksyncReactor
from tendermint_tpu_torch.config.config import Config
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.evidence import EvidencePool, EvidenceReactor
from tendermint_tpu_torch.libs.kvdb import GroupCommitDB, MemDB, SQLiteDB
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state import State, state_from_genesis
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.types.event_bus import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc


class NodeError(Exception):
    pass


def handshake(app, state: State, state_store: StateStore,
              block_store: BlockStore, gdoc: GenesisDoc) -> State:
    """Handshaker (reference consensus/replay.go:197-310): sync the app
    with the stores.  Decision table on (store height, app height):
    fresh chain -> InitChain; app behind store -> replay stored blocks
    into the app; app equal -> nothing."""
    info = app.info(RequestInfo())
    app_height = getattr(info, "last_block_height", 0) or 0
    store_height = block_store.height()

    if state.last_block_height == 0 and app_height == 0:
        # InitChain with genesis validators (replay.go:250-287)
        req = RequestInitChain(
            time_seconds=gdoc.genesis_time.seconds,
            chain_id=gdoc.chain_id,
            validators=[ValidatorUpdate(v.pub_key_type, v.pub_key_bytes,
                                        v.power)
                        for v in gdoc.validators],
            app_state_bytes=gdoc.app_state or b"",
            initial_height=gdoc.initial_height)
        resp = app.init_chain(req)
        if resp.app_hash:
            state.app_hash = resp.app_hash
        if resp.validators:
            # the app replaced the genesis validator set
            from tendermint_tpu_torch.state.execution import (
                validator_updates_to_validators)
            from tendermint_tpu_torch.types.validator_set import ValidatorSet
            vals = validator_updates_to_validators(resp.validators)
            state.validators = ValidatorSet(vals)
            state.next_validators = state.validators.copy()
        state_store.save(state)
    elif app_height > store_height:
        # reference replay.go errors: the app cannot be ahead of the store
        # (happens after unsafe-reset-all with a persistent external app)
        raise NodeError(
            f"handshake: app block height {app_height} is higher than "
            f"store height {store_height}; reset the app or restore data")
    elif app_height < store_height:
        # replay stored blocks the app missed (replay.go:420-516); the
        # in-process apps here persist nothing, so this is the restart
        # path.  Heights the state store has not saved yet are handled
        # below (they also need the STATE reconstructed), so replay the
        # app only up to the state height here.
        import copy
        executor = BlockExecutor(None, app)
        app_tail = min(store_height, state.last_block_height)
        for h in range(app_height + 1, app_tail + 1):
            block = block_store.load_block(h)
            if block is None:
                raise NodeError(f"handshake: missing block {h}")
            # last_commit signature indices resolve against the validator
            # set of h-1, which may differ from the latest state's
            replay_state = copy.copy(state)
            lvals = state_store.load_validators(h - 1) if h > 1 else None
            if lvals is not None:
                replay_state.last_validators = lvals
            executor._exec_block_on_app(replay_state, block)
            app.commit()

    # Tail state reconstruction (replay.go:284 decision table): a crash
    # between the WAL EndHeight fsync and the state save leaves the
    # state store one block behind the block store — and with ADR-017's
    # group-committed storage, a crash between the block-store group
    # commit and the state-store group commit can leave it up to one
    # commit group behind (the block store is always flushed first, so
    # the gap is never in the other direction).  Rebuild state height
    # by height from the stored blocks so consensus/blocksync resume at
    # tip+1 — otherwise catchupReplay correctly refuses with "WAL
    # should not contain EndHeight" (reference replay.go:472-516).
    store_height = block_store.height()
    while state.last_block_height < store_height:
        state = _replay_tail_block(app, state, state_store, block_store,
                                   state.last_block_height + 1)
    return state


def _replay_tail_block(app, state: State, state_store: StateStore,
                       block_store: BlockStore, h: int) -> State:
    """Apply stored block h to the state (and to the app if it has not
    committed it yet).  If the app already committed h, re-executing would
    double-apply the txs, so the saved ABCI responses are used instead —
    the reference's mock-proxy replay (replay.go:501-516)."""
    import copy

    from tendermint_tpu_torch.state.execution import (
        update_state, validator_updates_to_validators)
    from tendermint_tpu_torch.types.block import BlockID

    block = block_store.load_block(h)
    meta = block_store.load_block_meta(h)
    if block is None or meta is None:
        raise NodeError(f"handshake: missing tail block {h}")
    info = app.info(RequestInfo())
    app_height = getattr(info, "last_block_height", 0) or 0

    replay_state = copy.copy(state)
    lvals = state_store.load_validators(h - 1) if h > 1 else None
    if lvals is not None:
        replay_state.last_validators = lvals

    executor = BlockExecutor(None, app)
    if app_height >= h:
        # the app already committed h (>: it is ahead inside a lost
        # commit group) — re-executing would double-apply its txs, so
        # only the saved ABCI responses can reconstruct state; refuse
        # loudly when they were lost with the same crashed group
        responses = state_store.load_abci_responses(h)
        if responses is None:
            raise NodeError(
                f"handshake: app committed block {h} but its ABCI "
                f"responses were not persisted; cannot reconstruct state")
        if app_height == h:
            app_hash = getattr(info, "last_block_app_hash", b"") or b""
        else:
            # app is past h: its info hash belongs to app_height, but
            # block h+1's header carries the app hash AFTER h
            nxt = block_store.load_block_meta(h + 1)
            if nxt is None:
                raise NodeError(
                    f"handshake: cannot recover app hash for block {h}")
            app_hash = nxt.header.app_hash
    else:
        responses = executor._exec_block_on_app(replay_state, block)
        state_store.save_abci_responses(h, responses)
        app_hash = app.commit().data

    validator_updates = validator_updates_to_validators(
        responses.end_block.validator_updates if responses.end_block else [])
    block_id = BlockID(block.hash(), meta.block_id.part_set_header)
    new_state = update_state(state, block_id, block, responses,
                             validator_updates)
    new_state.app_hash = app_hash
    state_store.save(new_state)
    return new_state


class Node(BaseService):
    """A full node (reference node/node.go:704 NewNode + :938 OnStart;
    a BaseService like the reference's node)."""

    def __init__(self, config: Config, app, genesis: Optional[GenesisDoc]
                 = None, in_memory: bool = False, transport=None,
                 light_provider=None, device=None):
        """``light_provider`` (light/provider.Provider) overrides the
        statesync light client's HTTP provider — the in-process path
        the NetHarness fresh-join scenario uses (rpc off, no sockets);
        production nodes keep [state_sync] rpc_servers.  ``device``: the
        device every verifier of this node runs on (None: the package
        default, "cuda"); resolved here, so with no CUDA and no
        device="cpu" the node is not made."""
        super().__init__("node")
        self.device = resolve_device(device)
        # a card fault that ended the state-sync routine (see the module
        # docstring); the state machine keeps its own (device_error below)
        self._statesync_device_error = None
        from tendermint_tpu_torch.libs import log as tmlog
        from tendermint_tpu_torch.proxy import AppConns, ClientCreator
        self.config = config
        config.validate_basic()
        self.log = tmlog.logger("node").with_(moniker=config.moniker)
        # four logical app connections (reference proxy/multi_app_conn.go);
        # a plain in-process Application shares one instance across all
        self.app_conns = app if isinstance(app, AppConns) \
            else AppConns(ClientCreator.local(app))
        self.app = self.app_conns.query
        cfg = config

        # -- keys / genesis (node.go:755-780) --------------------------
        self.node_key = NodeKey.load_or_generate(cfg.node_key_file())
        self.genesis = genesis or GenesisDoc.from_json(
            open(cfg.genesis_file()).read())
        self.genesis.validate_and_complete()

        # -- stores (node.go:723-733) ----------------------------------
        if in_memory:
            block_db, state_db, ev_db = MemDB(), MemDB(), MemDB()
        else:
            os.makedirs(cfg.data_dir(), exist_ok=True)
            block_db = SQLiteDB(cfg.block_db_file())
            # the state store opts into the deferred single-op commit
            # window (ADR-017): its hot path issues 4 sets per height,
            # handshake can rebuild a rolled-back window from stored
            # blocks, and block saves are write_batch (committed per
            # call) so the state store can only ever TRAIL the block
            # store.  Evidence/index DBs have no such backfill and
            # keep per-call commits (the default).
            state_db = SQLiteDB(cfg.state_db_file(), commit_every=64)
            ev_db = SQLiteDB(os.path.join(cfg.data_dir(), "evidence.db"))
        if cfg.block_pipeline.enable:
            # group-commit seam (ADR-017): pass-through until blocksync
            # replay turns group mode on for a pipelined window, so the
            # consensus path's per-height durability is untouched
            block_db = GroupCommitDB(block_db)
            state_db = GroupCommitDB(state_db)
        self.block_store = BlockStore(block_db)
        self.state_store = StateStore(state_db)

        # -- state + handshake (node.go:783-802) -----------------------
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(self.genesis)
        self.state = handshake(self.app_conns.consensus, state,
                               self.state_store,
                               self.block_store, self.genesis)

        # -- privval (node.go:808-826; remote signer node.go:591) ------
        self.priv_validator = None
        if cfg.priv_validator_laddr:
            from tendermint_tpu_torch.privval.signer import SignerClient
            self.priv_validator = SignerClient(cfg.priv_validator_laddr)
        elif os.path.exists(cfg.priv_validator_key_file()):
            self.priv_validator = FilePV.load_or_generate(
                cfg.priv_validator_key_file(),
                cfg.priv_validator_state_file())
        self._pv_addr_cache: Optional[bytes] = None

        # -- event bus / mempool / evidence / indexers (node.go:832-860) --
        self.event_bus = EventBus()
        from tendermint_tpu_torch.state.indexer import (BlockIndexer,
                                                  IndexerService, TxIndexer)
        from tendermint_tpu_torch.state.sinks import (NullBlockIndexer,
                                                NullTxIndexer, SQLEventSink)
        if cfg.tx_index.indexer == "null":
            self.tx_indexer = NullTxIndexer()
            self.block_indexer = NullBlockIndexer()
        elif cfg.tx_index.indexer == "kv":
            ix_db = MemDB() if in_memory else SQLiteDB(
                os.path.join(cfg.data_dir(), "tx_index.db"))
            self.tx_indexer = TxIndexer(ix_db)
            self.block_indexer = BlockIndexer(ix_db)
        else:
            raise NodeError(
                f"unknown indexer {cfg.tx_index.indexer!r} "
                "(expected 'kv' or 'null')")
        sinks = []
        if cfg.tx_index.sink_dsn:
            sinks.append(SQLEventSink(cfg.tx_index.sink_dsn,
                                      self.genesis.chain_id))
        self.indexer_service = IndexerService(
            self.tx_indexer, self.block_indexer, self.event_bus,
            sinks=sinks)
        if cfg.mempool.version not in ("v0", "v1"):
            raise NodeError(
                f"unknown mempool version {cfg.mempool.version!r} "
                "(expected 'v0' or 'v1')")
        if cfg.mempool.version == "v1":
            from tendermint_tpu_torch.mempool.priority_mempool import \
                PriorityMempool
            self.mempool = PriorityMempool(
                self.app_conns.mempool,
                max_tx_bytes=cfg.mempool.max_tx_bytes,
                size_limit=cfg.mempool.size,
                max_total_bytes=cfg.mempool.max_txs_bytes,
                keep_invalid_txs_in_cache=cfg.mempool
                .keep_invalid_txs_in_cache,
                cache_size=cfg.mempool.cache_size)
        else:
            self.mempool = Mempool(self.app_conns.mempool,
                                   max_tx_bytes=cfg.mempool.max_tx_bytes,
                                   size_limit=cfg.mempool.size,
                                   max_txs_bytes=cfg.mempool.max_txs_bytes,
                                   keep_invalid_txs_in_cache=cfg.mempool
                                   .keep_invalid_txs_in_cache,
                                   cache_size=cfg.mempool.cache_size)
        # -- ingress gate (mempool/ingress.py, ADR-018) ----------------
        # config wins over a stale TM_TPU_INGRESS env in BOTH
        # directions; disabled, every CheckTx caller keeps the
        # synchronous in-caller admission byte-identically
        from tendermint_tpu_torch.mempool import ingress as _ingress
        _ingress.set_enabled(cfg.mempool.ingress_enable)
        self.ingress_gate = None
        if _ingress.enabled():
            mc = cfg.mempool
            self.ingress_gate = _ingress.IngressGate(
                self.mempool, queue_size=mc.ingress_queue,
                batch=mc.ingress_batch, workers=mc.ingress_workers,
                rate_per_s=mc.ingress_rate_per_s, burst=mc.ingress_burst,
                recheck_slice=mc.ingress_recheck_slice, device=self.device)
        # -- light serving plane (light/service.py, ADR-026) -----------
        # config wins over a stale TM_TPU_LIGHT_SERVE env in BOTH
        # directions; disabled, the light RPC routes answer
        # service-disabled and the node's own verify paths are
        # untouched
        from tendermint_tpu_torch.light import service as _lightsvc
        _lightsvc.set_enabled(cfg.light_serve.enable)
        self.light_serve = None
        if _lightsvc.enabled():
            lc = cfg.light_serve
            self.light_serve = _lightsvc.LightServe(
                self.block_store, self.state_store,
                self.genesis.chain_id, queue_size=lc.queue,
                batch=lc.batch, workers=lc.workers,
                rate_per_s=lc.rate_per_s, burst=lc.burst,
                max_cursors_per_client=lc.max_cursors_per_client,
                max_cursors=lc.max_cursors,
                cursor_batch=lc.cursor_batch, prewarm=lc.prewarm,
                event_bus=self.event_bus, device=self.device)
            _lightsvc.install(self.light_serve)
        self.evidence_pool = EvidencePool(ev_db, self.state_store,
                                          self.block_store,
                                          device=self.device)

        # -- executor + consensus (node.go:862-906) --------------------
        self.executor = BlockExecutor(
            self.state_store, self.app_conns.consensus,
            mempool=self.mempool,
            evidence_pool=self.evidence_pool, event_bus=self.event_bus,
            block_store=self.block_store, device=self.device)
        self.consensus = ConsensusState(
            cfg.consensus, self.state, self.executor, self.block_store,
            mempool=self.mempool, priv_validator=self.priv_validator,
            wal_path=cfg.wal_file(), event_bus=self.event_bus,
            name=cfg.moniker, evidence_pool=self.evidence_pool,
            device=self.device)
        self.mempool.on_new_tx(self.consensus.notify_txs_available)

        # -- p2p switch + reactors (node.go:908-936) -------------------
        self.switch = Switch(self.node_key, cfg.p2p.laddr,
                             network=self.genesis.chain_id,
                             moniker=cfg.moniker, p2p_config=cfg.p2p,
                             transport=transport)
        self.consensus_reactor = ConsensusReactor(self.consensus)
        self.mempool_reactor = MempoolReactor(self.mempool,
                                              gate=self.ingress_gate)
        self.evidence_reactor = EvidenceReactor(self.evidence_pool)
        # fastSync := config.FastSyncMode && !onlyValidatorIsUs, and held
        # back entirely while statesync restores — the reactor is built
        # dormant and activated by the statesync handoff (reference
        # node/node.go:712-722 + createBlockchainReactor's
        # blockSync && !stateSync: syncing blocks from height 1 while a
        # snapshot restore rewrites the state would corrupt both)
        self._statesync_active = bool(
            cfg.state_sync.enable and self.state.last_block_height == 0
            and self.block_store.height() == 0)
        fast_sync = (cfg.block_sync.enable
                     and not self._only_validator_is_us()
                     and not self._statesync_active)
        self.blocksync_reactor = BlocksyncReactor(
            self.executor, self.block_store, self.state,
            fast_sync=fast_sync, on_caught_up=self._on_caught_up)
        self.switch.add_reactor("MEMPOOL", self.mempool_reactor)
        self.switch.add_reactor("BLOCKSYNC", self.blocksync_reactor)
        self.switch.add_reactor("CONSENSUS", self.consensus_reactor)
        self.switch.add_reactor("EVIDENCE", self.evidence_reactor)

        # -- statesync (node.go:837 statesync.NewReactor + :993) -------
        # every node serves its app's snapshots; a fresh node with
        # state_sync enabled also restores from peers before blocksync
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
        state_provider = None
        restore_ledger = None
        if self._statesync_active:
            servers = [a.strip() for a in
                       cfg.state_sync.rpc_servers.split(",") if a.strip()]
            if not (cfg.state_sync.trust_height and
                    cfg.state_sync.trust_hash and
                    (servers or light_provider is not None)):
                raise NodeError(
                    "state_sync requires rpc_servers, trust_height and "
                    "trust_hash (reference config/config.go StateSync)")
            from tendermint_tpu_torch.light.client import (Client as LightClient,
                                                     TrustOptions)
            from tendermint_tpu_torch.light.store import LightStore
            from tendermint_tpu_torch.statesync.stateprovider import StateProvider
            if light_provider is not None:
                primary, witnesses = light_provider, []
            else:
                from tendermint_tpu_torch.light.provider import HTTPProvider
                primary = HTTPProvider(self.genesis.chain_id, servers[0])
                witnesses = [HTTPProvider(self.genesis.chain_id, a)
                             for a in servers[1:]]
            lc = LightClient(
                self.genesis.chain_id,
                TrustOptions(cfg.state_sync.trust_height,
                             bytes.fromhex(cfg.state_sync.trust_hash),
                             period_s=cfg.state_sync.trust_period),
                primary, witnesses=witnesses,
                store=LightStore(MemDB()), device=self.device)
            state_provider = StateProvider(lc)
            # crash-resume restore ledger (ADR-022): a kill mid-restore
            # reopens this DB, re-verifies the stored chunk prefix and
            # resumes from the frontier instead of refetching from zero
            from tendermint_tpu_torch.statesync.ledger import RestoreLedger
            restore_ledger = RestoreLedger(
                MemDB() if in_memory else SQLiteDB(
                    os.path.join(cfg.data_dir(), "statesync.db")))
        ssc = cfg.state_sync
        self.statesync_reactor = StateSyncReactor(
            self.app_conns.snapshot, state_provider=state_provider,
            ledger=restore_ledger,
            fetchers=ssc.fetchers,
            chunk_timeout_s=ssc.chunk_timeout_ms / 1000.0,
            retries=ssc.retries,
            serve_rate_per_s=ssc.serve_rate_per_s,
            serve_burst=ssc.serve_burst)
        self._statesync_ledger = restore_ledger
        self.switch.add_reactor("STATESYNC", self.statesync_reactor)
        # PEX + addr book (node.go:908 createPEXReactorAndAddToSwitch)
        self.pex_reactor = None
        if cfg.p2p.pex:
            from tendermint_tpu_torch.p2p.pex import AddrBook, PexReactor
            book = AddrBook(None if in_memory else cfg.addr_book_file(),
                            our_ids=(self.node_key.node_id,))
            self.pex_reactor = PexReactor(
                book, target_out_peers=max(2, cfg.p2p.max_num_peers // 5),
                seeds=cfg.p2p.seeds)
            self.switch.add_reactor("PEX", self.pex_reactor)

        # -- RPC (node.go:996 StartRPC) --------------------------------
        self.rpc_server = None
        if cfg.rpc.enabled:
            from tendermint_tpu_torch.rpc.server import RPCServer
            self.rpc_server = RPCServer(
                self, cfg.rpc.laddr,
                max_body_bytes=cfg.rpc.max_body_bytes)

        # -- pprof debug endpoint (reference config.go:427 pprof_laddr) --
        self.pprof_server = None
        if cfg.rpc.pprof_laddr:
            from tendermint_tpu_torch.libs.pprof import PprofServer
            self.pprof_server = PprofServer(cfg.rpc.pprof_laddr)

        # -- gRPC broadcast API (reference config.go grpc_laddr) ---------
        self.grpc_server = None
        if cfg.rpc.grpc_laddr and self.rpc_server is not None:
            from tendermint_tpu_torch.rpc.grpc_api import GRPCBroadcastServer
            self.grpc_server = GRPCBroadcastServer(self.rpc_server,
                                                   cfg.rpc.grpc_laddr)

        self._consensus_started = threading.Event()

    def _pv_address(self) -> Optional[bytes]:
        """Our validator address, cached after the first successful fetch.
        With a remote signer get_pub_key is a blocking socket round trip;
        the key is fixed for the node's lifetime, so RPC handlers (/status)
        must not re-fetch it per request."""
        if self.priv_validator is None:
            return None
        if self._pv_addr_cache is None:
            self._pv_addr_cache = self.priv_validator.get_pub_key().address()
        return self._pv_addr_cache

    def _only_validator_is_us(self) -> bool:
        """Reference node/node.go:640-652."""
        if self.priv_validator is None:
            return False
        if self.state.validators.size() != 1:
            return False
        addr, _ = self.state.validators.get_by_index(0)
        return addr == self._pv_address()

    # -- lifecycle (node.go:938-1001) --------------------------------------

    def start(self, wait_for_sync: bool = False):
        """BaseService.start (errors on double start / start after stop)
        plus the reference's optional wait for consensus."""
        BaseService.start(self)
        if wait_for_sync:
            self._consensus_started.wait()

    def on_start(self):
        """Reference node.go:938 OnStart order: indexer, switch (which
        starts every reactor, switch.go:226), persistent-peer dials,
        statesync/blocksync/consensus decision, RPC."""
        self.log.info("starting node",
                      node_id=self.node_key.node_id,
                      chain_id=self.genesis.chain_id,
                      height=self.state.last_block_height)
        # device-lane degradation runtime (crypto/degrade.py): surface
        # breaker transitions in the node log so an operator sees the
        # moment the verify hot path degrades to (or recovers from) host
        # verification; the consensus receive loop registers its own
        # listener for the coalescer's view
        from tendermint_tpu_torch.crypto import degrade
        self._breaker_unsub = degrade.runtime().breaker.add_listener(
            self._on_breaker_transition)
        # process-global verify scheduler (crypto/scheduler.py): the
        # first node in the process installs + starts it; every verify
        # consumer then coalesces through it.  A later node (multi-node
        # tests) shares the installed one; when the owning node stops,
        # the others' call sites fall back to their direct paths.
        self._verify_sched = None
        from tendermint_tpu_torch.crypto import scheduler as vsched
        vs = self.config.verify_scheduler
        if vs.enable and vsched.installed() is None:
            self._verify_sched = vsched.install(vsched.VerifyScheduler(
                window_s=vs.window_ms / 1000.0,
                max_batch=vs.max_batch, max_pending=vs.max_pending,
                tpu_threshold=self.config.batch_verifier.tpu_threshold,
                device=self.device))
            self._verify_sched.start()
            self.log.info("verify scheduler started",
                          window_ms=vs.window_ms, max_batch=vs.max_batch,
                          max_pending=vs.max_pending)
        # the node's config decides the cofactored RLC fast path in BOTH
        # directions: a stale TM_TPU_RLC=1 env must not override an
        # operator's rlc=false (the env remains the knob only for
        # node-less tooling: benches, tests)
        from tendermint_tpu_torch.ops import msm
        msm.set_enabled(self.config.batch_verifier.rlc)
        # same pattern for the secp256k1 device lane: the operator's
        # config wins over any stale env in BOTH directions
        from tendermint_tpu_torch.ops import secp as secp_ops
        secp_ops.set_lane_enabled(self.config.batch_verifier.secp_lane)
        # host-lane verify pool size (crypto/lanepool.py, ADR-015):
        # config wins over env, both ways (0 = auto from cpu_count,
        # 1 = serial)
        from tendermint_tpu_torch.crypto import lanepool
        lanepool.set_workers(self.config.batch_verifier.host_pool_workers)
        # fixed-base comb path + its HBM budget (ops/ed25519, ADR-013):
        # config wins over env, either way
        from tendermint_tpu_torch.ops import ed25519 as edops
        edops.set_comb_config(
            enabled=self.config.batch_verifier.comb,
            table_cache_mb=self.config.batch_verifier.table_cache_mb)
        # block application pipeline (state/pipeline.py, ADR-017): like
        # the verify scheduler, the first node in the process installs
        # it; config wins over a stale TM_TPU_BLOCK_PIPELINE env both
        # ways (enable=False leaves another node's pipeline alone — the
        # stores of THIS node are then plain DBs and replay declines)
        self._block_pipeline = None
        from tendermint_tpu_torch.state import pipeline as blockpipe
        bp = self.config.block_pipeline
        if bp.enable and blockpipe.installed() is None:
            self._block_pipeline = blockpipe.set_config(
                enable=True, depth=bp.depth,
                group_commit_heights=bp.group_commit_heights)
            # the writer's group-commit durable acks must land on the
            # same consensus-observatory node key the state machine
            # stamps under (ADR-020 persist stage)
            self._block_pipeline.obs_node = self.consensus.name
            self.log.info("block pipeline started", depth=bp.depth,
                          group_commit_heights=bp.group_commit_heights)
        # latency SLO estimator (libs/slo.py, ADR-016): window +
        # per-priority p99 targets from [slo]; config wins over a stale
        # TM_TPU_SLO env both ways
        from tendermint_tpu_torch.libs import slo
        slo.set_config(enabled=self.config.slo.enable,
                       window=self.config.slo.window,
                       targets=self.config.slo.targets_s(),
                       budgets=self.config.slo.budgets())
        # device observatory (crypto/devobs.py, ADR-021): per-launch
        # transfer/compute/compile decomposition + HBM ledger; config
        # wins over a stale TM_TPU_DEVOBS env both ways
        from tendermint_tpu_torch.crypto import devobs
        devobs.set_config(enabled=self.config.devobs.enable,
                          capacity=self.config.devobs.capacity)
        # register the flight-recorder bundle up front so
        # trace_dropped_spans_total renders 0 on /metrics from boot —
        # the tracer itself only touches it lazily on the first ring
        # wraparound, and "no such series" must not be confusable with
        # "no drops" (ADR-020 satellite)
        from tendermint_tpu_torch.libs.metrics import TraceMetrics
        TraceMetrics()
        # adaptive control plane (libs/control.py, ADR-023): the first
        # node in the process installs the controller; config wins over
        # a stale TM_TPU_CONTROL env both ways.  Wired after every knob
        # owner above exists, and each knob registers only when ITS
        # seam does — a node without a pipeline governs the rest
        self._controller = None
        from tendermint_tpu_torch.libs import control
        cc = self.config.control
        control.set_config(enable=cc.enable)
        if cc.enable and control.installed() is None:
            self._controller = control.install(
                control.Controller(period_ms=cc.period_ms,
                                   recover_after=cc.recover_after))
            self._register_knobs(self._controller, cc)
            self._controller.start()
            self.log.info("adaptive control plane started",
                          period_ms=cc.period_ms,
                          knobs=",".join(self._controller.knobs()))
        # mempool ingress gate (ADR-018): start AFTER the verify
        # scheduler so the worker's MEMPOOL-class pre-verification can
        # route through it from the first batch
        if self.ingress_gate is not None:
            self.ingress_gate.attach().start()
            self.log.info("mempool ingress gate started",
                          queue=self.ingress_gate.queue_size,
                          workers=self.ingress_gate.workers,
                          batch=self.ingress_gate.batch)
        # light serving plane (ADR-026): start AFTER the verify
        # scheduler too — its COMMIT-class certificate checks route
        # through the same coalescing windows from the first request,
        # and its on_start prewarms the comb tables for the CURRENT
        # validator set
        if self.light_serve is not None:
            self.light_serve.start()
            self.log.info("light serving plane started",
                          queue=self.light_serve.queue_size,
                          workers=self.light_serve.workers,
                          batch=self.light_serve.batch)
        self.indexer_service.start()
        self.switch.start()
        for addr in filter(None,
                           self.config.p2p.persistent_peers.split(",")):
            self.switch.dial_peer(addr.strip(), persistent=True)
        if self._statesync_active:
            # restore from a snapshot first; blocksync/consensus start
            # from the restored state once it lands (node.go:993
            # startStateSync -> bcReactor.SwitchToBlockSync)
            self.spawn(self._statesync_routine, name="statesync")
        elif not self.blocksync_reactor.fast_sync:
            self._on_caught_up(self.state)
        # (fast_sync case: the switch already activated the reactor's
        # sync routines via its on_start)
        if self.rpc_server is not None:
            self.rpc_server.start()
        # SIGUSR1 stack dump works regardless of pprof_laddr (a hung node
        # must be inspectable without prior config — libs/pprof.py)
        from tendermint_tpu_torch.libs.pprof import install_sigusr1
        install_sigusr1()
        if self.pprof_server is not None:
            self.pprof_server.start()
        if self.grpc_server is not None:
            self.grpc_server.start()

    def _register_knobs(self, controller, cc):
        """Bind every declared knob whose seam this node owns to the
        controller (ADR-023).  Getters/setters are the same live
        `set_config`-style seams the wiring above used, so "static
        config" stays the single source of truth for reverts."""
        from tendermint_tpu_torch.crypto import lanepool
        from tendermint_tpu_torch.libs.control import SPEC_BY_NAME
        from tendermint_tpu_torch.ops import ed25519 as edops
        from tendermint_tpu_torch.statesync import syncer as ss_syncer

        def reg(name, getter, setter):
            # a fractional step (sched_window_ms moves in 0.5 ms) means
            # the knob itself is fractional — integer coercion would
            # round every half-step move away
            step = cc.step_of(name)
            controller.register(SPEC_BY_NAME[name], getter, setter,
                                safe_range=cc.range_of(name),
                                step=step,
                                integral=float(step).is_integer())

        sched = self._verify_sched
        if sched is not None:
            reg("sched_window_ms",
                lambda: sched.window_s * 1000.0,
                lambda v: sched.set_window(v / 1000.0))
        reg("host_pool_workers",
            lambda: float(lanepool.workers()),
            lambda v: lanepool.set_workers(int(v)))
        gate = self.ingress_gate
        if gate is not None:
            reg("ingress_rate_per_s",
                lambda: gate.rate_per_s,
                lambda v: gate.set_rate(rate_per_s=v))
            reg("ingress_burst",
                lambda: gate.burst,
                lambda v: gate.set_rate(burst=v))
        pipe = self._block_pipeline
        if pipe is not None:
            reg("pipeline_depth",
                lambda: float(pipe.depth),
                lambda v: pipe.set_depth(int(v)))
        reg("statesync_fetchers",
            lambda: float(ss_syncer.default_fetchers()),
            lambda v: ss_syncer.set_config(fetchers=int(v)))
        reg("comb_min_batch",
            lambda: float(edops.comb_min_batch()),
            lambda v: edops.set_comb_config(min_batch=int(v)))
        from tendermint_tpu_torch.parallel import sharding
        reg("mesh_chunk_lanes",
            lambda: float(sharding.mesh_chunk_raw()),
            lambda v: sharding.set_mesh_chunk(int(v)))

    def _on_breaker_transition(self, old: str, new: str, reason: str):
        self.log.info("device verify lane breaker transition",
                      **{"from": old}, to=new, reason=reason)

    def _statesync_routine(self):
        """Run the syncer, persist the restored state, then hand off to
        blocksync (reference node/node.go startStateSync +
        blocksync/reactor.go SwitchToBlockSync)."""
        import time as _time

        from tendermint_tpu_torch.crypto.degrade import (DeviceLaneError,
                                                         card_fault)
        from tendermint_tpu_torch.statesync.syncer import StateSyncError

        deadline = _time.monotonic() + 300.0
        state = commit = None
        attempts = 0
        while _time.monotonic() < deadline and not self.quitting.is_set():
            try:
                state, commit = self.statesync_reactor.syncer.sync_any()
                break
            except StateSyncError as e:
                attempts += 1
                if attempts % 10 == 1:
                    self.log.info("statesync attempt failed",
                                  attempt=attempts, err=str(e))
                # no (verifiable) snapshots yet; re-poll the peers — the
                # serving side may take its first snapshot after connect
                self.statesync_reactor.request_snapshots()
                _time.sleep(1.0)
            except DeviceLaneError as e:
                if not card_fault(e):
                    raise
                # the card failed, not the snapshot: keep the error, fall
                # back to nothing, and leave the ledger's chunks for a
                # resume (module docstring)
                self._statesync_device_error = e
                self.log.error("statesync stopped by a card fault",
                               err=type(e).__name__, detail=str(e))
                return
        if state is None:
            if not self.quitting.is_set():
                self.log.info(
                    "statesync found no usable snapshot; "
                    "falling back to blocksync")
            self.blocksync_reactor.activate()
            return
        self.state_store.bootstrap(state)
        self.block_store.save_seen_commit(state.last_block_height, commit)
        self.state = state
        self.blocksync_reactor.switch_to_blocksync(state)
        self.log.info("statesync restored state",
                      height=state.last_block_height)
        self.blocksync_reactor.activate()

    @property
    def device_error(self):
        """The card fault that stopped this node's state sync or its state
        machine (None while neither has met one)."""
        return self._statesync_device_error or self.consensus.device_error

    def resume_statesync(self):
        """Run the state-sync routine again after a card fault: the
        syncer restores from its RestoreLedger's chunks."""
        if self._statesync_device_error is None:
            raise NodeError("no state-sync card fault to resume from")
        self._statesync_device_error = None
        self.spawn(self._statesync_routine, name="statesync")

    def _on_caught_up(self, state):
        """SwitchToConsensus (reference blocksync/reactor.go:316)."""
        self.state = state
        if state.last_block_height > \
                (self.consensus.state.last_block_height
                 if self.consensus.state else 0):
            self.consensus.switch_to_consensus(state)
        self.consensus.start()
        self._consensus_started.set()

    def on_stop(self):
        """Reference node.go:1003 OnStop: indexer, RPC, consensus, then
        the switch (which stops every reactor), then the app conns."""
        self.log.info("stopping node",
                      height=self.block_store.height())
        if getattr(self, "_breaker_unsub", None) is not None:
            self._breaker_unsub()
            self._breaker_unsub = None
        if getattr(self, "_controller", None) is not None:
            # FIRST: stopping the controller reverts every governed
            # knob to its static configured value while the knob
            # owners below are still alive to accept the revert
            from tendermint_tpu_torch.libs import control
            self._controller.stop()
            if control.installed() is self._controller:
                control.uninstall()
            self._controller = None
        if getattr(self, "_verify_sched", None) is not None:
            from tendermint_tpu_torch.crypto import scheduler as vsched
            self._verify_sched.stop()
            vsched.uninstall(self._verify_sched)
            self._verify_sched = None
        if getattr(self, "_block_pipeline", None) is not None:
            from tendermint_tpu_torch.state import pipeline as blockpipe
            self._block_pipeline.stop()   # drains + flushes buffers
            if blockpipe.installed() is self._block_pipeline:
                blockpipe.install(None)
            self._block_pipeline = None
        self.indexer_service.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.pprof_server is not None:
            self.pprof_server.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        if getattr(self, "ingress_gate", None) is not None:
            # before consensus/app stop: pending admissions settle (as
            # busy) instead of racing a dying app connection
            self.ingress_gate.stop()
        if getattr(self, "light_serve", None) is not None:
            # same ordering contract: pending light verifications
            # settle (as busy) before the stores go away
            self.light_serve.stop()
        if self._consensus_started.is_set():
            self.consensus.stop()
        if hasattr(self.priv_validator, "close"):
            self.priv_validator.close()
        self.switch.stop()  # stops all reactors (switch.go:234 OnStop)
        self.app_conns.stop()  # last: consensus/mempool use these
        # make every accepted store write durable before the process
        # may exit: SQLiteDB defers single-op commits into a bounded
        # window (ADR-017), so a clean stop must flush what a crash is
        # allowed to lose
        for db in (self.block_store.db, self.state_store.db,
                   getattr(self.evidence_pool, "db", None),
                   getattr(self.tx_indexer, "db", None)):
            if db is not None:
                try:
                    db.flush()
                except Exception:  # noqa: BLE001 - best-effort shutdown
                    pass
        if getattr(self, "_statesync_ledger", None) is not None:
            try:
                # flush, don't clear: an interrupted restore must stay
                # resumable across a clean restart too (ADR-022)
                self._statesync_ledger.flush()
                self._statesync_ledger.close()
            except Exception:  # noqa: BLE001 - best-effort shutdown
                pass

    # -- info for RPC -------------------------------------------------------

    def status(self) -> dict:
        """Reference rpc/core/status.go ResultStatus, amino-JSON dialect
        (int64 heights as strings, RFC3339 times, tagged pub keys)."""
        from tendermint_tpu_torch.libs import amino_json as aj
        latest = self.block_store.height()
        meta = self.block_store.load_block_meta(latest) if latest else None
        pv_pub = (self.priv_validator.get_pub_key()
                  if self.priv_validator is not None else None)
        return {
            "node_info": {
                "id": self.node_key.node_id,
                "listen_addr": self.switch.actual_listen_addr(),
                "network": self.genesis.chain_id,
                "moniker": self.config.moniker,
            },
            "sync_info": {
                "latest_block_height": str(latest),
                "latest_block_hash":
                    meta.block_id.hash.hex().upper() if meta else "",
                "latest_app_hash": self.state.app_hash.hex().upper(),
                "latest_block_time":
                    aj.ts_rfc3339(meta.header.time) if meta else "",
                "catching_up": not self._consensus_started.is_set(),
            },
            "validator_info": {
                "address": (self._pv_address() or b"").hex().upper(),
                "pub_key": (aj.pub_key_json(pv_pub.type_name,
                                            pv_pub.bytes())
                            if pv_pub is not None else None),
                "voting_power": str(self._voting_power()),
            },
        }

    def _voting_power(self) -> int:
        addr = self._pv_address()
        if addr is None:
            return 0
        _, val = self.state.validators.get_by_address(addr)
        return val.voting_power if val is not None else 0
