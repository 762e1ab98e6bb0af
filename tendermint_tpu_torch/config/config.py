"""Node configuration (reference config/config.go), TOML-backed.

Layout under $TMHOME mirrors the reference: config/config.toml,
config/genesis.json, config/node_key.json, config/priv_validator_key.json,
data/ (stores + WAL).
"""
from __future__ import annotations

import math
import os
try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is the same parser/API
    import tomli as tomllib
from dataclasses import dataclass, field

from tendermint_tpu_torch.consensus.config import ConsensusConfig


@dataclass
class P2PConfig:
    laddr: str = "127.0.0.1:26656"
    persistent_peers: str = ""  # comma-separated id@host:port
    max_num_peers: int = 50
    pex: bool = True            # run the PEX reactor / addr book
    seeds: str = ""             # comma-separated id@host:port to crawl
    # per-connection byte-rate caps + dial/handshake deadlines
    # (reference config/config.go:604-607 SendRate/RecvRate and
    # :598 HandshakeTimeout/DialTimeout)
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    handshake_timeout_s: float = 20.0
    dial_timeout_s: float = 3.0

    def validate_basic(self):
        """Reference config/config.go:668-688 P2PConfig.ValidateBasic."""
        if self.max_num_peers <= 0:
            raise ValueError("p2p.max_num_peers must be positive")
        if self.send_rate <= 0 or self.recv_rate <= 0:
            raise ValueError("p2p.send_rate/recv_rate must be positive")
        if self.handshake_timeout_s <= 0 or self.dial_timeout_s <= 0:
            raise ValueError("p2p timeouts must be positive")


@dataclass
class MempoolConfig:
    version: str = "v0"         # "v0" FIFO or "v1" priority mempool
    size: int = 5000
    cache_size: int = 10000
    max_tx_bytes: int = 1048576
    # total byte budget across all pending txs (reference
    # config/config.go:731 MaxTxsBytes, default 1GB)
    max_txs_bytes: int = 1 << 30
    keep_invalid_txs_in_cache: bool = False
    # IngressGate admission pipeline (mempool/ingress.py, ADR-018).
    # Disabled, every CheckTx caller runs the synchronous in-caller
    # admission exactly as before the gate existed.
    ingress_enable: bool = True
    ingress_queue: int = 8192       # bounded admission queue (txs);
    #                                 full = immediate busy rejection
    ingress_workers: int = 1        # queue-draining worker threads
    ingress_batch: int = 256        # max txs drained per worker wakeup
    # per-source token bucket (rpc / p2p:<peer> / internal), admissions
    # per second; 0 = unlimited.  Burst 0 = auto (max(1, rate)).
    ingress_rate_per_s: float = 0.0
    ingress_burst: int = 0
    ingress_recheck_slice: int = 256  # post-block rechecks per wakeup

    def validate_basic(self):
        """Reference config/config.go:772-787 MempoolConfig.ValidateBasic."""
        if self.version not in ("v0", "v1"):
            raise ValueError(f"mempool.version must be v0|v1, "
                             f"got {self.version!r}")
        if self.size <= 0:
            raise ValueError("mempool.size must be positive")
        if self.cache_size <= 0:
            raise ValueError("mempool.cache_size must be positive")
        if self.max_tx_bytes <= 0:
            raise ValueError("mempool.max_tx_bytes must be positive")
        if self.max_txs_bytes <= 0:
            raise ValueError("mempool.max_txs_bytes must be positive")
        for k in ("ingress_queue", "ingress_workers", "ingress_batch",
                  "ingress_recheck_slice"):
            if getattr(self, k) <= 0:
                raise ValueError(f"mempool.{k} must be positive")
        # 0 = unlimited rate / auto burst; only negatives are nonsense
        if self.ingress_rate_per_s < 0:
            raise ValueError("mempool.ingress_rate_per_s must be >= 0")
        if self.ingress_burst < 0:
            raise ValueError("mempool.ingress_burst must be >= 0")


@dataclass
class RPCConfig:
    laddr: str = "127.0.0.1:26657"
    enabled: bool = True
    unsafe: bool = False  # expose dial_seeds/dial_peers (ref --rpc.unsafe)
    # request body cap (reference config/config.go:468 MaxBodyBytes)
    max_body_bytes: int = 1_000_000
    # debug/profiling endpoint (reference config/config.go:427
    # pprof_laddr); empty = disabled.  Serves /debug/stacks, /debug/
    # threads, /debug/profile, /debug/gc via libs/pprof.py
    pprof_laddr: str = ""
    # gRPC broadcast API (reference config/config.go GRPCListenAddress
    # "grpc_laddr"); empty = disabled.  rpc/grpc_api.py BroadcastAPI
    grpc_laddr: str = ""

    def validate_basic(self):
        if self.max_body_bytes <= 0:
            raise ValueError("rpc.max_body_bytes must be positive")
        if self.grpc_laddr and not self.enabled:
            raise ValueError(
                "rpc.grpc_laddr requires the RPC server (rpc.enabled): "
                "BroadcastTx routes through broadcast_tx_commit")


@dataclass
class BlockSyncConfig:
    enable: bool = True


@dataclass
class TxIndexConfig:
    """Reference config/config.go TxIndexConfig + the psql event sink
    selection (state/indexer/sink)."""
    indexer: str = "kv"        # "kv" | "null"
    sink_dsn: str = ""         # optional write-only SQL event sink


@dataclass
class StateSyncConfig:
    """Reference config/config.go StateSyncConfig: bootstrap a fresh node
    from an app snapshot verified through the light client.  The
    fast-join knobs (ADR-022) replace the old hardcoded
    CHUNK_FETCHERS/CHUNK_RETRIES module constants; the serve_* pair
    bounds the snapshot-serving side (per-peer token buckets on the
    chunk server — every node serves snapshots, so these apply even
    with enable=false)."""
    enable: bool = False
    rpc_servers: str = ""      # comma-separated full-node RPC addrs
    trust_height: int = 0
    trust_hash: str = ""       # hex header hash at trust_height
    trust_period: float = 86400.0 * 7
    fetchers: int = 4          # concurrent chunk fetcher threads
    chunk_timeout_ms: float = 15000.0  # per-chunk fetch deadline; a
    #                            slower peer is quarantined
    retries: int = 3           # PER-PEER consecutive-failure budget
    #                            before a provider is banned
    serve_rate_per_s: float = 100.0  # per-peer chunk-serve rate; 0 =
    #                            unlimited
    serve_burst: int = 32      # per-peer token-bucket burst

    def validate_basic(self):
        if self.fetchers <= 0:
            raise ValueError("state_sync.fetchers must be positive")
        if self.chunk_timeout_ms <= 0:
            raise ValueError(
                "state_sync.chunk_timeout_ms must be positive")
        if self.retries <= 0:
            raise ValueError("state_sync.retries must be positive")
        # 0 = unlimited serve rate; only negatives are nonsense
        if self.serve_rate_per_s < 0:
            raise ValueError(
                "state_sync.serve_rate_per_s must be >= 0")
        if self.serve_burst <= 0:
            raise ValueError("state_sync.serve_burst must be positive")


@dataclass
class BatchVerifierConfig:
    """Device data-plane routing (no reference analog — the new component)."""
    tpu_threshold: int = 32
    enable: bool = True
    # opt-in to the cofactored RLC batch fast path (ops/msm.py).  OFF by
    # default for wire-compat: RLC uses ZIP-215/cofactored semantics, the
    # reference Go verifier is cofactorless, and a mixed fleet could be
    # chain-split by an adversarial small-order-component signature.
    rlc: bool = False
    # secp256k1 device lane (ops/secp.py).  ON by default since ADR-015:
    # verdicts are exact either way, the lane only engages when an
    # accelerator is attached, and it runs under the full degradation
    # runtime (breaker/timeout/host-C-fallback, chaos parity at site
    # ops.secp.verify_batch).  `secp_lane = false` is the rollback
    # switch to the host C lane.
    secp_lane: bool = True
    # host-lane verify pool (crypto/lanepool.py, ADR-015): worker count
    # for the multi-core native C lanes of a mixed batch.  0 = auto
    # (os.cpu_count()); 1 = serial in-caller (pool disabled).
    host_pool_workers: int = 0
    # fixed-base comb verify path (ops/ed25519, ADR-013): per-validator
    # window tables kept device-resident so known-set batches verify
    # with zero doublings.  ON by default — the verdict is the exact
    # cofactorless check either way; `comb = false` forces the ladder.
    comb: bool = True
    # HBM budget for the comb table cache, MB (LRU by validator-set
    # content hash; one padded key costs ~198 KB, so 256 MB holds ~1.3k
    # validator keys).  0 disables table builds entirely.
    table_cache_mb: int = 256

    def validate_basic(self):
        # 0 is meaningful (every batch routes to the device lane); only
        # negatives are nonsense
        if self.tpu_threshold < 0:
            raise ValueError("batch_verifier.tpu_threshold must be "
                             ">= 0")
        if self.table_cache_mb < 0:
            raise ValueError("batch_verifier.table_cache_mb must be "
                             ">= 0")
        # 0 = auto-size, 1 = serial; only negatives are nonsense
        if self.host_pool_workers < 0:
            raise ValueError("batch_verifier.host_pool_workers must be "
                             ">= 0")


@dataclass
class VerifySchedulerConfig:
    """Process-global cross-consumer verification scheduler
    (crypto/scheduler.py, docs/adr/adr-012-verify-scheduler.md).  When
    enabled the node installs + starts one VerifyScheduler and every
    verify consumer (vote preverify, commit/light checks, blocksync
    replay, bulk) coalesces through it; disabled, all call sites keep
    their direct BatchVerifier paths."""
    enable: bool = True
    window_ms: float = 2.0      # coalescing window (deadlines shorten it)
    max_batch: int = 8192       # lanes per coalesced launch / direct-path
    #                             cutover for verify_sigs_bulk
    max_pending: int = 65536    # bounded queue: beyond this the mempool
    #                             class is shed

    def validate_basic(self):
        if self.window_ms < 0:
            raise ValueError("verify_scheduler.window_ms must be >= 0")
        if self.max_batch <= 0 or self.max_pending <= 0:
            raise ValueError(
                "verify_scheduler.max_batch/max_pending must be positive")


@dataclass
class BlockPipelineConfig:
    """Prefetched, group-committed block application
    (state/pipeline.py, docs/adr/adr-017-block-pipeline.md).  When
    enabled the node wraps the block/state DBs in kvdb.GroupCommitDB,
    installs one BlockPipeline and blocksync replay routes stable
    windows through it: block N+1 stages and verifies while N applies,
    and storage commits land as one transaction per
    `group_commit_heights` heights instead of one per height.  `depth`
    bounds how many blocks the stage worker may run ahead of apply.
    Disabled, replay keeps the coalesced/strict paths and every store
    write commits per height exactly as before."""
    enable: bool = True
    depth: int = 4
    group_commit_heights: int = 8

    def validate_basic(self):
        if self.depth <= 0:
            raise ValueError("block_pipeline.depth must be positive")
        if self.group_commit_heights <= 0:
            raise ValueError(
                "block_pipeline.group_commit_heights must be positive")


@dataclass
class DevObsConfig:
    """Device observatory (crypto/devobs.py, ADR-021): per-launch
    transfer/compute/compile decomposition, the compile-cache
    inventory, and the HBM residency ledger.  ON by default — a few
    dict stores per launch is noise against a millisecond-scale launch
    wall; `enable = false` (or TM_TPU_DEVOBS=0 for node-less tooling)
    makes every record a guaranteed sub-microsecond no-op and removes
    the explicit H2D/compute brackets from the monolithic launch
    paths.  `capacity` bounds the launch-record ring."""
    enable: bool = True
    capacity: int = 256

    def validate_basic(self):
        if self.capacity <= 0:
            raise ValueError("devobs.capacity must be positive")


@dataclass
class SLOConfig:
    """Per-priority latency SLOs for the verify path (libs/slo.py,
    docs/adr/adr-016-latency-observatory.md).  When enabled the node
    arms the sliding-window quantile estimator: each priority stream
    keeps its last `window` end-to-end latencies and publishes
    windowed p50/p99 and (when a target is set) the error-budget burn
    rate.  Targets are p99 objectives in MILLISECONDS; 0 = track the
    quantiles but no target (no burn-rate gauge)."""
    # the per-priority verify streams (ADR-016) plus the consensus
    # observatory's height-lifecycle streams (ADR-020), the device
    # observatory's per-launch wall stream (ADR-021), the statesync
    # per-chunk fetch-to-applied stream (ADR-022), and the gossip
    # observatory's proposal -> useful-part receipt latency (ADR-025)
    STREAMS = ("consensus", "commit", "blocksync", "mempool",
               "block_interval", "propose", "quorum_prevote", "apply",
               "device_launch", "statesync", "gossip", "light")

    enable: bool = False
    window: int = 1024
    consensus_p99_ms: float = 0.0
    commit_p99_ms: float = 0.0
    blocksync_p99_ms: float = 0.0
    mempool_p99_ms: float = 0.0
    block_interval_p99_ms: float = 0.0
    propose_p99_ms: float = 0.0
    quorum_prevote_p99_ms: float = 0.0
    apply_p99_ms: float = 0.0
    device_launch_p99_ms: float = 0.0
    statesync_p99_ms: float = 0.0
    gossip_p99_ms: float = 0.0
    light_p99_ms: float = 0.0
    # per-stream error budgets in PERCENT of windowed requests allowed
    # over the p99 target (the burn-rate denominator; 1.0 = the p99
    # convention).  Replaces the old hardcoded _P99_BUDGET constant
    consensus_budget_pct: float = 1.0
    commit_budget_pct: float = 1.0
    blocksync_budget_pct: float = 1.0
    mempool_budget_pct: float = 1.0
    block_interval_budget_pct: float = 1.0
    propose_budget_pct: float = 1.0
    quorum_prevote_budget_pct: float = 1.0
    apply_budget_pct: float = 1.0
    device_launch_budget_pct: float = 1.0
    statesync_budget_pct: float = 1.0
    gossip_budget_pct: float = 1.0
    light_budget_pct: float = 1.0

    def targets_s(self) -> dict:
        """Stream -> p99 target in seconds (only the set ones)."""
        out = {}
        for stream in self.STREAMS:
            ms = getattr(self, f"{stream}_p99_ms")
            if ms > 0:
                out[stream] = ms / 1000.0
        return out

    def budgets(self) -> dict:
        """Stream -> error-budget FRACTION (percent / 100), every
        stream (the estimator falls back to its own default for
        missing ones, so emitting all keeps config the single source
        of truth)."""
        return {stream: getattr(self, f"{stream}_budget_pct") / 100.0
                for stream in self.STREAMS}

    def validate_basic(self):
        if self.window <= 0:
            raise ValueError("slo.window must be positive")
        for stream in self.STREAMS:
            if getattr(self, f"{stream}_p99_ms") < 0:
                raise ValueError(f"slo.{stream}_p99_ms must be >= 0")
            pct = getattr(self, f"{stream}_budget_pct")
            if not (0 < pct <= 100):
                raise ValueError(
                    f"slo.{stream}_budget_pct must be in (0, 100]")


@dataclass
class LightServeConfig:
    """Light-client serving plane (light/service.py, ADR-026): one
    process-global LightServe front door for many concurrent
    header-verifying clients.  `enable = false` (or TM_TPU_LIGHT_SERVE=0
    for node-less tooling) is the kill switch: the node never constructs
    the service and every light RPC route answers service-disabled —
    the full node's own paths are untouched either way."""
    enable: bool = True
    queue: int = 4096           # bounded admission queue (requests);
    #                             full = immediate busy + retry_after
    workers: int = 1            # queue-draining worker threads
    batch: int = 256            # max requests drained per worker wakeup
    # per-client token bucket, requests per second; 0 = unlimited.
    # Burst 0 = auto (max(1, rate)).
    rate_per_s: float = 0.0
    burst: int = 0
    # header-range follow cursors (the subscription surface): bounded
    # per client and globally; past the global bound the least-recently
    # polled cursor is evicted (newest-first survival under pressure)
    max_cursors_per_client: int = 4
    max_cursors: int = 1024
    cursor_batch: int = 64      # max headers returned per poll
    prewarm: bool = True        # comb-table prewarm on valset change

    def validate_basic(self):
        for k in ("queue", "workers", "batch", "max_cursors_per_client",
                  "max_cursors", "cursor_batch"):
            if getattr(self, k) <= 0:
                raise ValueError(f"light_serve.{k} must be positive")
        # 0 = unlimited rate / auto burst; only negatives are nonsense
        if self.rate_per_s < 0:
            raise ValueError("light_serve.rate_per_s must be >= 0")
        if self.burst < 0:
            raise ValueError("light_serve.burst must be >= 0")


@dataclass
class ControlConfig:
    """Adaptive control plane (libs/control.py, ADR-023): the
    SLO-burn-driven knob governor.  OFF by default — enabling it hands
    the declared knobs (verify-scheduler window, host-lane pool width,
    ingress admission rate/burst, block-pipeline depth, statesync
    fetchers, comb min-batch) to a bounded AIMD decision loop that
    steers them inside the per-knob [min, max] safe ranges below and
    reverts every knob to its static configured value on kill
    (`control.kill()` / TM_TPU_CONTROL=0) within one period.  Ranges
    here TIGHTEN the literal KNOB_SPECS declarations; they never widen
    what the code declared safe."""
    # one row per governed knob (libs/control.KNOB_SPECS)
    KNOBS = ("sched_window_ms", "host_pool_workers",
             "ingress_rate_per_s", "ingress_burst", "pipeline_depth",
             "statesync_fetchers", "comb_min_batch",
             "mesh_chunk_lanes")

    enable: bool = False
    period_ms: float = 1000.0   # decision-loop period
    recover_after: int = 3      # clean periods before additive recovery
    sched_window_ms_min: float = 0.5
    sched_window_ms_max: float = 20.0
    sched_window_ms_step: float = 0.5
    host_pool_workers_min: float = 1.0
    host_pool_workers_max: float = 16.0
    host_pool_workers_step: float = 1.0
    ingress_rate_per_s_min: float = 32.0
    ingress_rate_per_s_max: float = 100000.0
    ingress_rate_per_s_step: float = 64.0
    ingress_burst_min: float = 16.0
    ingress_burst_max: float = 65536.0
    ingress_burst_step: float = 64.0
    pipeline_depth_min: float = 2.0
    pipeline_depth_max: float = 32.0
    pipeline_depth_step: float = 1.0
    statesync_fetchers_min: float = 1.0
    statesync_fetchers_max: float = 32.0
    statesync_fetchers_step: float = 1.0
    comb_min_batch_min: float = 16.0
    comb_min_batch_max: float = 4096.0
    comb_min_batch_step: float = 16.0
    mesh_chunk_lanes_min: float = 1024.0
    mesh_chunk_lanes_max: float = 65536.0
    mesh_chunk_lanes_step: float = 1024.0

    def range_of(self, knob: str) -> tuple:
        return (getattr(self, f"{knob}_min"),
                getattr(self, f"{knob}_max"))

    def step_of(self, knob: str) -> float:
        return getattr(self, f"{knob}_step")

    def validate_basic(self):
        if self.period_ms <= 0:
            raise ValueError("control.period_ms must be positive")
        if self.recover_after <= 0:
            raise ValueError("control.recover_after must be positive")
        for knob in self.KNOBS:
            lo, hi = self.range_of(knob)
            step = self.step_of(knob)
            if not (math.isfinite(lo) and math.isfinite(hi)
                    and math.isfinite(step)):
                raise ValueError(
                    f"control.{knob} min/max/step must be finite")
            if lo > hi:
                raise ValueError(
                    f"control.{knob}_min must be <= {knob}_max")
            if step <= 0:
                raise ValueError(
                    f"control.{knob}_step must be positive")


@dataclass
class Config:
    home: str = ""
    moniker: str = "node"
    # reference config.go LogLevel: default level, with optional
    # per-module overrides "consensus:debug,p2p:error" in log_module_levels
    log_level: str = "info"
    log_module_levels: str = ""
    # if set ("unix:///..." or "tcp://host:port"), the node listens here
    # and uses the remote signer that dials in instead of the file PV
    # (reference config.go PrivValidatorListenAddr)
    priv_validator_laddr: str = ""
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    block_sync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    state_sync: StateSyncConfig = field(default_factory=StateSyncConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    batch_verifier: BatchVerifierConfig = field(
        default_factory=BatchVerifierConfig)
    verify_scheduler: VerifySchedulerConfig = field(
        default_factory=VerifySchedulerConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    block_pipeline: BlockPipelineConfig = field(
        default_factory=BlockPipelineConfig)
    devobs: DevObsConfig = field(default_factory=DevObsConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    light_serve: LightServeConfig = field(
        default_factory=LightServeConfig)

    def validate_basic(self):
        """Reference config/config.go:107-133 Config.ValidateBasic:
        every section validates, errors carry the section name."""
        for name in ("p2p", "mempool", "rpc", "consensus",
                     "batch_verifier", "verify_scheduler", "slo",
                     "block_pipeline", "devobs", "state_sync",
                     "control", "light_serve"):
            section = getattr(self, name)
            vb = getattr(section, "validate_basic", None)
            if vb is None:
                continue
            try:
                vb()
            except ValueError as e:
                raise ValueError(f"error in [{name}] section: {e}")

    # -- paths -------------------------------------------------------------

    def config_dir(self) -> str:
        return os.path.join(self.home, "config")

    def data_dir(self) -> str:
        return os.path.join(self.home, "data")

    def genesis_file(self) -> str:
        return os.path.join(self.config_dir(), "genesis.json")

    def node_key_file(self) -> str:
        return os.path.join(self.config_dir(), "node_key.json")

    def priv_validator_key_file(self) -> str:
        return os.path.join(self.config_dir(), "priv_validator_key.json")

    def priv_validator_state_file(self) -> str:
        return os.path.join(self.data_dir(), "priv_validator_state.json")

    def wal_file(self) -> str:
        return os.path.join(self.data_dir(), "cs.wal")

    def addr_book_file(self) -> str:
        return os.path.join(self.config_dir(), "addrbook.json")

    def block_db_file(self) -> str:
        return os.path.join(self.data_dir(), "blockstore.db")

    def state_db_file(self) -> str:
        return os.path.join(self.data_dir(), "state.db")

    def ensure_dirs(self):
        os.makedirs(self.config_dir(), exist_ok=True)
        os.makedirs(self.data_dir(), exist_ok=True)

    # -- TOML --------------------------------------------------------------

    @staticmethod
    def _q(v: str) -> str:
        """TOML basic-string escape for template interpolation."""
        return v.replace("\\", "\\\\").replace('"', '\\"')

    def save(self):
        self.ensure_dirs()
        c = self.consensus
        text = f"""# tendermint_tpu_torch node configuration
moniker = "{self._q(self.moniker)}"
priv_validator_laddr = "{self._q(self.priv_validator_laddr)}"
log_level = "{self._q(self.log_level)}"
log_module_levels = "{self._q(self.log_module_levels)}"

[p2p]
laddr = "{self._q(self.p2p.laddr)}"
persistent_peers = "{self._q(self.p2p.persistent_peers)}"
max_num_peers = {self.p2p.max_num_peers}
pex = {str(self.p2p.pex).lower()}
seeds = "{self._q(self.p2p.seeds)}"
send_rate = {self.p2p.send_rate}
recv_rate = {self.p2p.recv_rate}
handshake_timeout_s = {self.p2p.handshake_timeout_s}
dial_timeout_s = {self.p2p.dial_timeout_s}

[mempool]
version = "{self._q(self.mempool.version)}"
size = {self.mempool.size}
cache_size = {self.mempool.cache_size}
max_tx_bytes = {self.mempool.max_tx_bytes}
max_txs_bytes = {self.mempool.max_txs_bytes}
keep_invalid_txs_in_cache = {str(self.mempool.keep_invalid_txs_in_cache).lower()}
ingress_enable = {str(self.mempool.ingress_enable).lower()}
ingress_queue = {self.mempool.ingress_queue}
ingress_workers = {self.mempool.ingress_workers}
ingress_batch = {self.mempool.ingress_batch}
ingress_rate_per_s = {self.mempool.ingress_rate_per_s}
ingress_burst = {self.mempool.ingress_burst}
ingress_recheck_slice = {self.mempool.ingress_recheck_slice}

[rpc]
laddr = "{self._q(self.rpc.laddr)}"
enabled = {str(self.rpc.enabled).lower()}
unsafe = {str(self.rpc.unsafe).lower()}
max_body_bytes = {self.rpc.max_body_bytes}
pprof_laddr = "{self._q(self.rpc.pprof_laddr)}"
grpc_laddr = "{self._q(self.rpc.grpc_laddr)}"

[block_sync]
enable = {str(self.block_sync.enable).lower()}

[tx_index]
indexer = "{self._q(self.tx_index.indexer)}"
sink_dsn = "{self._q(self.tx_index.sink_dsn)}"

[state_sync]
enable = {str(self.state_sync.enable).lower()}
rpc_servers = "{self._q(self.state_sync.rpc_servers)}"
trust_height = {self.state_sync.trust_height}
trust_hash = "{self._q(self.state_sync.trust_hash)}"
trust_period = {self.state_sync.trust_period}
fetchers = {self.state_sync.fetchers}
chunk_timeout_ms = {self.state_sync.chunk_timeout_ms}
retries = {self.state_sync.retries}
serve_rate_per_s = {self.state_sync.serve_rate_per_s}
serve_burst = {self.state_sync.serve_burst}

[batch_verifier]
tpu_threshold = {self.batch_verifier.tpu_threshold}
enable = {str(self.batch_verifier.enable).lower()}
rlc = {str(self.batch_verifier.rlc).lower()}
secp_lane = {str(self.batch_verifier.secp_lane).lower()}
comb = {str(self.batch_verifier.comb).lower()}
table_cache_mb = {self.batch_verifier.table_cache_mb}
host_pool_workers = {self.batch_verifier.host_pool_workers}

[verify_scheduler]
enable = {str(self.verify_scheduler.enable).lower()}
window_ms = {self.verify_scheduler.window_ms}
max_batch = {self.verify_scheduler.max_batch}
max_pending = {self.verify_scheduler.max_pending}

[block_pipeline]
enable = {str(self.block_pipeline.enable).lower()}
depth = {self.block_pipeline.depth}
group_commit_heights = {self.block_pipeline.group_commit_heights}

[devobs]
enable = {str(self.devobs.enable).lower()}
capacity = {self.devobs.capacity}

[slo]
enable = {str(self.slo.enable).lower()}
window = {self.slo.window}
consensus_p99_ms = {self.slo.consensus_p99_ms}
commit_p99_ms = {self.slo.commit_p99_ms}
blocksync_p99_ms = {self.slo.blocksync_p99_ms}
mempool_p99_ms = {self.slo.mempool_p99_ms}
block_interval_p99_ms = {self.slo.block_interval_p99_ms}
propose_p99_ms = {self.slo.propose_p99_ms}
quorum_prevote_p99_ms = {self.slo.quorum_prevote_p99_ms}
apply_p99_ms = {self.slo.apply_p99_ms}
device_launch_p99_ms = {self.slo.device_launch_p99_ms}
statesync_p99_ms = {self.slo.statesync_p99_ms}
gossip_p99_ms = {self.slo.gossip_p99_ms}
light_p99_ms = {self.slo.light_p99_ms}
consensus_budget_pct = {self.slo.consensus_budget_pct}
commit_budget_pct = {self.slo.commit_budget_pct}
blocksync_budget_pct = {self.slo.blocksync_budget_pct}
mempool_budget_pct = {self.slo.mempool_budget_pct}
block_interval_budget_pct = {self.slo.block_interval_budget_pct}
propose_budget_pct = {self.slo.propose_budget_pct}
quorum_prevote_budget_pct = {self.slo.quorum_prevote_budget_pct}
apply_budget_pct = {self.slo.apply_budget_pct}
device_launch_budget_pct = {self.slo.device_launch_budget_pct}
statesync_budget_pct = {self.slo.statesync_budget_pct}
gossip_budget_pct = {self.slo.gossip_budget_pct}
light_budget_pct = {self.slo.light_budget_pct}

[control]
enable = {str(self.control.enable).lower()}
period_ms = {self.control.period_ms}
recover_after = {self.control.recover_after}
sched_window_ms_min = {self.control.sched_window_ms_min}
sched_window_ms_max = {self.control.sched_window_ms_max}
sched_window_ms_step = {self.control.sched_window_ms_step}
host_pool_workers_min = {self.control.host_pool_workers_min}
host_pool_workers_max = {self.control.host_pool_workers_max}
host_pool_workers_step = {self.control.host_pool_workers_step}
ingress_rate_per_s_min = {self.control.ingress_rate_per_s_min}
ingress_rate_per_s_max = {self.control.ingress_rate_per_s_max}
ingress_rate_per_s_step = {self.control.ingress_rate_per_s_step}
ingress_burst_min = {self.control.ingress_burst_min}
ingress_burst_max = {self.control.ingress_burst_max}
ingress_burst_step = {self.control.ingress_burst_step}
pipeline_depth_min = {self.control.pipeline_depth_min}
pipeline_depth_max = {self.control.pipeline_depth_max}
pipeline_depth_step = {self.control.pipeline_depth_step}
statesync_fetchers_min = {self.control.statesync_fetchers_min}
statesync_fetchers_max = {self.control.statesync_fetchers_max}
statesync_fetchers_step = {self.control.statesync_fetchers_step}
comb_min_batch_min = {self.control.comb_min_batch_min}
comb_min_batch_max = {self.control.comb_min_batch_max}
comb_min_batch_step = {self.control.comb_min_batch_step}
mesh_chunk_lanes_min = {self.control.mesh_chunk_lanes_min}
mesh_chunk_lanes_max = {self.control.mesh_chunk_lanes_max}
mesh_chunk_lanes_step = {self.control.mesh_chunk_lanes_step}

[light_serve]
enable = {str(self.light_serve.enable).lower()}
queue = {self.light_serve.queue}
workers = {self.light_serve.workers}
batch = {self.light_serve.batch}
rate_per_s = {self.light_serve.rate_per_s}
burst = {self.light_serve.burst}
max_cursors_per_client = {self.light_serve.max_cursors_per_client}
max_cursors = {self.light_serve.max_cursors}
cursor_batch = {self.light_serve.cursor_batch}
prewarm = {str(self.light_serve.prewarm).lower()}

[consensus]
timeout_propose = {c.timeout_propose}
timeout_propose_delta = {c.timeout_propose_delta}
timeout_prevote = {c.timeout_prevote}
timeout_prevote_delta = {c.timeout_prevote_delta}
timeout_precommit = {c.timeout_precommit}
timeout_precommit_delta = {c.timeout_precommit_delta}
timeout_commit = {c.timeout_commit}
skip_timeout_commit = {str(c.skip_timeout_commit).lower()}
create_empty_blocks = {str(c.create_empty_blocks).lower()}
create_empty_blocks_interval = {c.create_empty_blocks_interval}
propose_reap_budget_ms = {c.propose_reap_budget_ms}
propose_prepare_budget_ms = {c.propose_prepare_budget_ms}
propose_max_bytes = {c.propose_max_bytes}
"""
        with open(os.path.join(self.config_dir(), "config.toml"), "w") as f:
            f.write(text)

    @classmethod
    def load(cls, home: str) -> "Config":
        cfg = cls(home=home)
        path = os.path.join(home, "config", "config.toml")
        if not os.path.exists(path):
            return cfg
        with open(path, "rb") as f:
            d = tomllib.load(f)
        cfg.moniker = d.get("moniker", cfg.moniker)
        cfg.priv_validator_laddr = d.get("priv_validator_laddr", "")
        cfg.log_level = d.get("log_level", cfg.log_level)
        cfg.log_module_levels = d.get("log_module_levels", "")
        p = d.get("p2p", {})
        cfg.p2p = P2PConfig(
            laddr=p.get("laddr", cfg.p2p.laddr),
            persistent_peers=p.get("persistent_peers", ""),
            max_num_peers=p.get("max_num_peers", 50),
            pex=p.get("pex", True),
            seeds=p.get("seeds", ""),
            send_rate=int(p.get("send_rate", 5_120_000)),
            recv_rate=int(p.get("recv_rate", 5_120_000)),
            handshake_timeout_s=float(p.get("handshake_timeout_s", 20.0)),
            dial_timeout_s=float(p.get("dial_timeout_s", 3.0)))
        m = d.get("mempool", {})
        cfg.mempool = MempoolConfig(
            version=m.get("version", "v0"),
            size=m.get("size", 5000), cache_size=m.get("cache_size", 10000),
            max_tx_bytes=m.get("max_tx_bytes", 1048576),
            max_txs_bytes=int(m.get("max_txs_bytes", 1 << 30)),
            keep_invalid_txs_in_cache=bool(
                m.get("keep_invalid_txs_in_cache", False)),
            ingress_enable=bool(m.get("ingress_enable", True)),
            ingress_queue=int(m.get("ingress_queue", 8192)),
            ingress_workers=int(m.get("ingress_workers", 1)),
            ingress_batch=int(m.get("ingress_batch", 256)),
            ingress_rate_per_s=float(m.get("ingress_rate_per_s", 0.0)),
            ingress_burst=int(m.get("ingress_burst", 0)),
            ingress_recheck_slice=int(
                m.get("ingress_recheck_slice", 256)))
        r = d.get("rpc", {})
        cfg.rpc = RPCConfig(laddr=r.get("laddr", cfg.rpc.laddr),
                            enabled=r.get("enabled", True),
                            unsafe=r.get("unsafe", False),
                            max_body_bytes=int(
                                r.get("max_body_bytes", 1_000_000)),
                            pprof_laddr=r.get("pprof_laddr", ""),
                            grpc_laddr=r.get("grpc_laddr", ""))
        bs = d.get("block_sync", {})
        cfg.block_sync = BlockSyncConfig(enable=bs.get("enable", True))
        ti = d.get("tx_index", {})
        cfg.tx_index = TxIndexConfig(
            indexer=ti.get("indexer", "kv"),
            sink_dsn=ti.get("sink_dsn", ""))
        ss = d.get("state_sync", {})
        cfg.state_sync = StateSyncConfig(
            enable=ss.get("enable", False),
            rpc_servers=ss.get("rpc_servers", ""),
            trust_height=ss.get("trust_height", 0),
            trust_hash=ss.get("trust_hash", ""),
            trust_period=float(ss.get("trust_period", 86400.0 * 7)),
            fetchers=int(ss.get("fetchers", 4)),
            chunk_timeout_ms=float(ss.get("chunk_timeout_ms", 15000.0)),
            retries=int(ss.get("retries", 3)),
            serve_rate_per_s=float(ss.get("serve_rate_per_s", 100.0)),
            serve_burst=int(ss.get("serve_burst", 32)))
        bv = d.get("batch_verifier", {})
        cfg.batch_verifier = BatchVerifierConfig(
            tpu_threshold=bv.get("tpu_threshold", 32),
            enable=bv.get("enable", True),
            rlc=bool(bv.get("rlc", False)),
            secp_lane=bool(bv.get("secp_lane", True)),
            comb=bool(bv.get("comb", True)),
            table_cache_mb=int(bv.get("table_cache_mb", 256)),
            host_pool_workers=int(bv.get("host_pool_workers", 0)))
        vs = d.get("verify_scheduler", {})
        cfg.verify_scheduler = VerifySchedulerConfig(
            enable=bool(vs.get("enable", True)),
            window_ms=float(vs.get("window_ms", 2.0)),
            max_batch=int(vs.get("max_batch", 8192)),
            max_pending=int(vs.get("max_pending", 65536)))
        bp = d.get("block_pipeline", {})
        cfg.block_pipeline = BlockPipelineConfig(
            enable=bool(bp.get("enable", True)),
            depth=int(bp.get("depth", 4)),
            group_commit_heights=int(bp.get("group_commit_heights", 8)))
        do = d.get("devobs", {})
        cfg.devobs = DevObsConfig(
            enable=bool(do.get("enable", True)),
            capacity=int(do.get("capacity", 256)))
        sl = d.get("slo", {})
        cfg.slo = SLOConfig(
            enable=bool(sl.get("enable", False)),
            window=int(sl.get("window", 1024)),
            **{f"{s}_p99_ms": float(sl.get(f"{s}_p99_ms", 0.0))
               for s in SLOConfig.STREAMS},
            **{f"{s}_budget_pct": float(sl.get(f"{s}_budget_pct", 1.0))
               for s in SLOConfig.STREAMS})
        ct = d.get("control", {})
        defaults = ControlConfig()
        cfg.control = ControlConfig(
            enable=bool(ct.get("enable", False)),
            period_ms=float(ct.get("period_ms", 1000.0)),
            recover_after=int(ct.get("recover_after", 3)),
            **{f: float(ct.get(f, getattr(defaults, f)))
               for knob in ControlConfig.KNOBS
               for f in (f"{knob}_min", f"{knob}_max", f"{knob}_step")})
        ls = d.get("light_serve", {})
        cfg.light_serve = LightServeConfig(
            enable=bool(ls.get("enable", True)),
            queue=int(ls.get("queue", 4096)),
            workers=int(ls.get("workers", 1)),
            batch=int(ls.get("batch", 256)),
            rate_per_s=float(ls.get("rate_per_s", 0.0)),
            burst=int(ls.get("burst", 0)),
            max_cursors_per_client=int(
                ls.get("max_cursors_per_client", 4)),
            max_cursors=int(ls.get("max_cursors", 1024)),
            cursor_batch=int(ls.get("cursor_batch", 64)),
            prewarm=bool(ls.get("prewarm", True)))
        c = d.get("consensus", {})
        cc = ConsensusConfig()
        for k in ("timeout_propose", "timeout_propose_delta",
                  "timeout_prevote", "timeout_prevote_delta",
                  "timeout_precommit", "timeout_precommit_delta",
                  "timeout_commit", "create_empty_blocks_interval",
                  "propose_reap_budget_ms", "propose_prepare_budget_ms"):
            if k in c:
                setattr(cc, k, float(c[k]))
        for k in ("skip_timeout_commit", "create_empty_blocks"):
            if k in c:
                setattr(cc, k, bool(c[k]))
        if "propose_max_bytes" in c:
            cc.propose_max_bytes = int(c["propose_max_bytes"])
        cfg.consensus = cc
        return cfg
