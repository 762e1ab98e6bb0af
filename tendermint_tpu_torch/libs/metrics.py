"""Metrics registry with Prometheus text exposition.

The counterpart of tendermint_tpu/libs/metrics.py for the families the
port publishes: counters, gauges and histograms with optional label
dimensions, a process-global default registry (tests may build private
registries), rendered in the Prometheus text format.  The bundles here
are ConsensusMetrics (the consensus observatory's stage histograms and
shed counter, and the consensus gauges), StateMetrics (the
BlockExecutor's), BlockSyncMetrics (the block pipeline's), CryptoMetrics
(the device-lane degradation runtime, routes, the VerifyScheduler,
request latency, SLO gauges), DevObsMetrics (the device observatory of
crypto/devobs.py), P2PMetrics (the transport's byte counters and the
gossip observatory's), TraceMetrics (the flight recorder's own drop
counter), LightMetrics (the light serving plane), MempoolMetrics (the
mempool and its IngressGate), StateSyncMetrics (the state-sync fetch
plane and its chunk server) and NetMetrics (the in-process virtual
network and scenario harness); the node's other families are not ported
yet.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped or a value like `ch="0x20"` (or a
    reason string carrying a traceback line) corrupts the whole
    exposition for every scraper."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """# HELP lines escape backslash and newline (not quotes)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        assert set(labels) == set(self.label_names), (
            f"{self.name}: labels {set(labels)} != {set(self.label_names)}")
        return tuple(labels[k] for k in self.label_names)

    def _fmt_labels(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [f'{n}="{_escape_label_value(v)}"'
                 for n, v in zip(self.label_names, key)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_="", labels=()):
        super().__init__(name, help_, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, n: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._fmt_labels(k)} {v:g}"
                for k, v in items] or [f"{self.name} 0"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_="", labels=()):
        super().__init__(name, help_, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, v: float, **labels):
        with self._lock:
            self._values[self._key(labels)] = float(v)

    def add(self, n: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._fmt_labels(k)} {v:g}"
                for k, v in items] or [f"{self.name} 0"]


def exp_buckets(start: float, factor: float, count: int) -> List[float]:
    """Exponential-range buckets (reference consensus/metrics.go:33
    0.1..100s exprange)."""
    out, v = [], start
    for _ in range(count):
        out.append(v)
        v *= factor
    return out


class _HistTimer:
    """One timed bracket against a histogram (Histogram.time()).

    Two shapes: the context-manager form observes the wall clock on a
    CLEAN exit (an exception means the bracket never completed — same
    policy every existing hand-rolled site applied by observing at the
    end of the happy path), and the manual form calls ``observe()``
    exactly at the point the caller declares success (the degradation
    runtime observes launch seconds only when the launch did not
    degrade)."""

    __slots__ = ("_h", "_clock", "_labels", "_t0")

    def __init__(self, h: "Histogram", clock, labels):
        self._h = h
        self._clock = clock
        self._labels = labels
        self._t0 = clock()

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, etype, evalue, tb):
        if etype is None:
            self.observe()
        return False

    def observe(self):
        self._h.observe(self._clock() - self._t0, **self._labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_="", labels=(), buckets=None):
        super().__init__(name, help_, labels)
        self.buckets = sorted(buckets or
                              [.005, .01, .025, .05, .1, .25, .5,
                               1, 2.5, 5, 10])
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._n: Dict[Tuple[str, ...], int] = {}

    def time(self, clock=time.monotonic, **labels) -> _HistTimer:
        """Timed-bracket helper: ``with hist.time(site=...):`` observes
        the wall clock of the block, replacing the hand-rolled
        ``t0 = monotonic() ... observe(monotonic() - t0)`` pattern.
        `clock` is injectable (the degradation runtime times against
        its deterministic test clock)."""
        return _HistTimer(self, clock, labels)

    def count(self, **labels) -> int:
        """Observation count for a label set (test/report accessor)."""
        with self._lock:
            return self._n.get(self._key(labels), 0)

    def total(self, **labels) -> float:
        """Sum of observed values for a label set."""
        with self._lock:
            return self._sum.get(self._key(labels), 0.0)

    def observe(self, v: float, **labels):
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key,
                                             [0] * (len(self.buckets) + 1))
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sum[key] = self._sum.get(key, 0.0) + v
            self._n[key] = self._n.get(key, 0) + 1

    def render(self) -> List[str]:
        out = []
        with self._lock:
            keys = sorted(self._counts)
            for key in keys:
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += self._counts[key][i]
                    le = 'le="{:g}"'.format(ub)
                    out.append(f"{self.name}_bucket"
                               f"{self._fmt_labels(key, le)}"
                               f" {cum}")
                cum += self._counts[key][-1]
                inf = 'le="+Inf"'
                out.append(f"{self.name}_bucket"
                           f"{self._fmt_labels(key, inf)} {cum}")
                out.append(f"{self.name}_sum{self._fmt_labels(key)}"
                           f" {self._sum[key]:g}")
                out.append(f"{self.name}_count{self._fmt_labels(key)}"
                           f" {self._n[key]}")
        return out


class Registry:
    def __init__(self, namespace: str = "tendermint"):
        self.namespace = namespace
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, subsystem, name, help_, **kw):
        full = f"{self.namespace}_{subsystem}_{name}" if subsystem else \
            f"{self.namespace}_{name}"
        with self._lock:
            if full in self._metrics:
                m = self._metrics[full]
                assert isinstance(m, cls), full
                return m
            m = cls(full, help_, **kw)
            self._metrics[full] = m
            return m

    def counter(self, subsystem, name, help_="", labels=()) -> Counter:
        return self._register(Counter, subsystem, name, help_,
                              labels=labels)

    def gauge(self, subsystem, name, help_="", labels=()) -> Gauge:
        return self._register(Gauge, subsystem, name, help_, labels=labels)

    def histogram(self, subsystem, name, help_="", labels=(),
                  buckets=None) -> Histogram:
        return self._register(Histogram, subsystem, name, help_,
                              labels=labels, buckets=buckets)

    def render_text(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


DEFAULT = Registry()


class ConsensusMetrics:
    """Reference consensus/metrics.go:22-40."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.height = reg.gauge("consensus", "height",
                                "Height of the chain.")
        self.rounds = reg.gauge("consensus", "rounds",
                                "Round of the current height.")
        self.round_duration = reg.histogram(
            "consensus", "round_duration_seconds",
            "Time spent in a round.",
            buckets=exp_buckets(0.1, (100 / 0.1) ** (1 / 8), 9))
        self.validators = reg.gauge("consensus", "validators",
                                    "Number of validators.")
        self.validators_power = reg.gauge(
            "consensus", "validators_power", "Total voting power.")
        self.num_txs = reg.gauge("consensus", "num_txs",
                                 "Transactions in the latest block.")
        self.total_txs = reg.counter("consensus", "total_txs",
                                     "Total committed transactions.")
        self.block_interval = reg.histogram(
            "consensus", "block_interval_seconds",
            "Time between this and the last block.")
        self.block_size_bytes = reg.gauge(
            "consensus", "block_size_bytes", "Size of the latest block.")
        self.commit_round = reg.gauge(
            "consensus", "commit_round", "Round at which the last block "
            "committed.")
        self.block_parts = reg.counter(
            "consensus", "block_parts",
            "Block parts transmitted per peer.", labels=("peer_id",))
        self.quorum_prevote_delay = reg.gauge(
            "consensus", "quorum_prevote_delay",
            "Seconds from proposal time to 2/3 prevotes.")
        # consensus observatory (consensus/observatory.py, ADR-020):
        # where the block interval goes, per lifecycle stage
        self.height_stage = reg.histogram(
            "consensus", "height_stage_seconds",
            "Per-height block-lifecycle stage durations (propose / "
            "gossip / prevote_wait / precommit_wait / commit / apply / "
            "persist / interval), from the consensus observatory.",
            labels=("stage",),
            buckets=exp_buckets(0.001, 10 ** 0.5, 10))
        self.observatory_shed = reg.counter(
            "consensus", "observatory_shed_total",
            "Observatory records shed (reason=chaos: a recording fault "
            "was swallowed; reason=evict: ring overflow).",
            labels=("reason",))


class StateMetrics:
    """Reference state/execution.go:202 + state/metrics.go."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.block_processing_time = reg.histogram(
            "state", "block_processing_time",
            "Time to process a block (ApplyBlock), seconds.")
        self.batch_verify_size = reg.histogram(
            "state", "batch_verify_size",
            "Signatures per batched verify call (the card's data plane).",
            buckets=[1, 4, 16, 64, 256, 1024, 4096, 16384, 65536])
        self.proposal_create_seconds = reg.histogram(
            "state", "proposal_create_seconds",
            "Proposer fast-path stage walls (ADR-024): reap (budgeted "
            "mempool scan), prepare (PrepareProposal round trip), "
            "assemble (make_block incl. data hash), split (part-set "
            "construction + send), seconds.",
            labels=("stage",), buckets=exp_buckets(0.0005, 4, 10))
        self.parts_streamed_total = reg.counter(
            "state", "parts_streamed_total",
            "Block parts handed to gossip by the proposer's streaming "
            "part-set path (ADR-024), by construction path (streaming "
            "= lazy proofs, serial = PartSet.from_data fallback).",
            labels=("path",))


class BlockSyncMetrics:
    """Block application pipeline (state/pipeline.py, ADR-017): is
    catch-up running pipelined or degraded to the strict sequential
    path, how far ahead the stage worker runs, what one group-committed
    storage flush costs, and how much stage/apply/commit time the
    pipeline actually overlaps."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.pipeline_depth = reg.gauge(
            "blocksync", "pipeline_depth",
            "Blocks staged ahead of apply in the block pipeline "
            "(sampled each apply; bounded by [block_pipeline] depth).")
        self.blocks_applied = reg.counter(
            "blocksync", "blocks_applied_total",
            "Blocks applied during fast sync, by path (pipelined = "
            "ADR-017 pipeline, strict = reference sequential "
            "fallback).", labels=("path",))
        self.group_commit_seconds = reg.histogram(
            "block", "group_commit_seconds",
            "Wall time of one group-committed storage flush (block "
            "store batch + state store batch), seconds.",
            buckets=exp_buckets(0.0005, 4, 10))
        self.apply_overlap_ratio = reg.gauge(
            "block", "apply_overlap_ratio",
            "1 - window wall / (stage + apply + commit lane seconds) "
            "for the last pipelined window; 0 = fully serial.")


class StateSyncMetrics:
    """Statesync fast-join + serving plane (statesync/, ADR-022): is
    the fetch pipeline moving or retrying, did per-chunk integrity
    catch anything before the app saw it, how hard is the bounded
    chunk server refusing, and what did the join cost end to end."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.chunks_fetched = reg.counter(
            "statesync", "chunks_fetched_total",
            "Chunk fetch attempts by outcome: ok (fetched + "
            "verified), error (transport fault, charged to the "
            "peer's per-peer budget), busy (serving peer refused "
            "with Retry-After — backoff, no strike).",
            labels=("outcome",))
        self.chunks_verified = reg.counter(
            "statesync", "chunks_verified_total",
            "Fetch-thread chunk integrity checks against the "
            "snapshot's digest metadata, BEFORE the app call: ok, or "
            "corrupt (sender banned, chunk refetched elsewhere; also "
            "counted for ledger chunks that rot on disk).",
            labels=("outcome",))
        self.chunks_served = reg.counter(
            "statesync", "chunks_served_total",
            "Chunks this node's bounded chunk server sent to "
            "joining peers.")
        self.serve_refused = reg.counter(
            "statesync", "serve_refused_total",
            "Chunk requests the serving side turned away: busy "
            "(bounded queue full), ratelimit (per-peer token "
            "bucket), backpressure (response channel full, dropped), "
            "error (app/chaos fault while serving — answered busy).",
            labels=("reason",))
        self.serve_queue_depth = reg.gauge(
            "statesync", "serve_queue_depth",
            "Chunk requests waiting in the bounded serve queue "
            "(at the bound new requests are refused busy).")
        self.restore_bytes = reg.counter(
            "statesync", "restore_bytes_total",
            "Snapshot bytes applied to the app during restore.")
        self.restore_bytes_per_s = reg.gauge(
            "statesync", "restore_bytes_per_s",
            "Restore throughput of the last completed statesync "
            "(applied bytes / time-to-synced).")
        self.time_to_synced = reg.gauge(
            "statesync", "time_to_synced_seconds",
            "Wall time of the last successful snapshot restore, "
            "light verification through restored-app-hash check.")
        self.peers_banned = reg.counter(
            "statesync", "peers_banned_total",
            "Peers banned by the statesync fetch plane (corrupt "
            "chunk, app rejection, or an exhausted per-peer retry "
            "budget).")


class CryptoMetrics:
    """Device-lane degradation runtime (crypto/degrade.py): launches,
    failure classes, host fallbacks, breaker lifecycle and backend
    probing — the operator's view of whether the accelerator is serving
    the verify hot path or the node has degraded to host verification
    (docs/adr/adr-010-device-lane-degradation.md)."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.registry = reg   # for the port's own families (scheduler)
        self.device_launches = reg.counter(
            "crypto", "device_launch_total",
            "Device verify launches dispatched.", labels=("site",))
        self.device_failures = reg.counter(
            "crypto", "device_failure_total",
            "Device launches that failed, by failure class.",
            labels=("site", "reason"))
        self.host_fallbacks = reg.counter(
            "crypto", "host_fallback_total",
            "Batches re-verified on the host OpenSSL path.",
            labels=("site", "reason"))
        self.breaker_state = reg.gauge(
            "crypto", "breaker_state",
            "Device-lane circuit breaker: 0 closed, 0.5 half-open, "
            "1 open.")
        self.breaker_transitions = reg.counter(
            "crypto", "breaker_transitions_total",
            "Breaker state transitions.", labels=("to",))
        self.backend_probes = reg.counter(
            "crypto", "backend_probe_total",
            "Accelerator backend probes, by outcome.", labels=("result",))
        self.device_launch_seconds = reg.histogram(
            "crypto", "device_launch_seconds",
            "Wall-clock of successful device verify launches.",
            labels=("site",), buckets=exp_buckets(0.001, 4, 10))
        # promoted from ad-hoc module globals (ops/msm.last_route and
        # friends) so /metrics alone answers "did the sharded RLC path
        # actually engage in production" without polling test hooks
        self.msm_route = reg.counter(
            "crypto", "msm_route_total",
            "Verify dispatch routes taken, by path "
            "(rlc-sharded/rlc-single/mesh-sharded/mesh-xla/global-mesh/"
            "pallas/xla/...) and "
            "outcome — only outcome=\"vouched\" means an RLC route "
            "actually stood in for per-signature verification; "
            "overflow/decode-failed/rejected bounced to the per-sig "
            "ladder, and plain kernel launches count as "
            "outcome=\"executed\".",
            labels=("path", "outcome"))
        self.batch_occupancy = reg.gauge(
            "crypto", "batch_occupancy_ratio",
            "Real rows / padded device lanes of the most recent "
            "device batch (pad lanes are pure overhead).")
        self.device_compile_seconds = reg.histogram(
            "crypto", "device_compile_seconds",
            "Wall-clock of FIRST launches per (path, lane bucket) — "
            "dominated by jit compile; steady-state launches land in "
            "crypto_device_launch_seconds instead.",
            labels=("site",), buckets=exp_buckets(0.01, 4, 10))
        # fixed-base comb table cache (ops/ed25519): is the zero-doubling
        # path engaging (crypto_msm_route_total path="comb" counts the
        # launches), what the tables cost on the device, and whether sets
        # are thrashing in and out
        self.table_cache_bytes = reg.gauge(
            "crypto", "table_cache_bytes",
            "Device-resident comb window tables currently cached, "
            "bytes (bounded by [batch_verifier] table_cache_mb; one "
            "padded validator key costs ~198 KB).")
        self.table_hits = reg.counter(
            "crypto", "table_hits_total",
            "Verify batches that resolved to an already-built comb "
            "table set (the zero-doubling fixed-base path engaged "
            "with no table build).")
        self.table_evictions = reg.counter(
            "crypto", "table_evictions_total",
            "Comb table sets evicted from the device cache (LRU by "
            "validator-set content hash when over the byte budget).")
        # VerifyScheduler (crypto/scheduler.py): the cross-consumer
        # coalescing service — is the queue backing up, how full are the
        # coalesced launches, is the shed class actually being shed, and
        # is host staging hiding under device execution
        self.sched_queue_depth = reg.gauge(
            "crypto", "sched_queue_depth",
            "Triples pending in the VerifyScheduler queue, all "
            "priority classes.")
        self.sched_batch_size = reg.histogram(
            "crypto", "sched_batch_size",
            "Deduped lanes per coalesced VerifyScheduler launch.",
            buckets=[1, 4, 16, 64, 256, 1024, 4096, 16384, 65536])
        self.sched_shed_total = reg.counter(
            "crypto", "sched_shed_total",
            "Submissions load-shed by the VerifyScheduler (bounded "
            "queue: lowest class rejected when full, queued lowest-"
            "class work evicted for higher classes).",
            labels=("priority",))
        self.sched_overlap_ratio = reg.gauge(
            "crypto", "sched_overlap_ratio",
            "Fraction of VerifyScheduler host-staging time that "
            "overlapped an in-flight device launch (the double-"
            "buffered pipeline's effectiveness; 0 when idle).")
        # are a mixed batch's per-scheme lanes running side by side
        # (wall = max over lanes) or serially (wall = sum over lanes),
        # and the host-lane pool (crypto/lanepool.py) that runs them
        self.lane_overlap = reg.gauge(
            "crypto", "lane_overlap_ratio",
            "Lane concurrency of the most recent multi-lane verify "
            "batch: 1 - wall/sum(per-lane wall times).  0 means the "
            "lanes ran serially; (k-1)/k means k lanes fully "
            "overlapped.")
        self.host_pool_depth = reg.gauge(
            "crypto", "host_pool_depth",
            "Tasks currently admitted to the host-lane verify pool "
            "(queued or running on a pool worker).")
        self.host_pool_tasks = reg.counter(
            "crypto", "host_pool_tasks_total",
            "Host-lane pool work items, by kind (whole 'lane' thunks "
            "vs C-call 'chunk' shards) and placement outcome ('pooled' "
            "on a worker, 'inline' in the caller when the pool was "
            "full or disabled, 'fallback' when a pool fault forced the "
            "serial re-verify).",
            labels=("kind", "outcome"))
        # per-request latency observatory (ADR-016): the lifecycle of a
        # verify request — time in the scheduler queue, end-to-end
        # submit-to-settle latency by priority and the path that
        # settled it, and whether deadlines were actually met
        self.sched_queue_wait = reg.histogram(
            "crypto", "sched_queue_wait_seconds",
            "Time a VerifyScheduler submission waited from submit() to "
            "its coalescing window closing, by priority class.",
            labels=("priority",), buckets=exp_buckets(0.0002, 4, 10))
        self.verify_e2e_latency = reg.histogram(
            "crypto", "verify_e2e_latency_seconds",
            "End-to-end verify latency, submit to settle, by priority "
            "class and settling path: sched-device / sched-host / "
            "sched-fallback (degrade host re-verify inside a scheduler "
            "window) / sched-cache (resolved from SigCache without "
            "lanes) / direct (the BatchVerifier path when the "
            "scheduler is not running).",
            labels=("priority", "path"),
            buckets=exp_buckets(0.0002, 4, 12))
        self.sched_deadline_miss = reg.counter(
            "crypto", "sched_deadline_miss_total",
            "Submissions that settled AFTER their requested deadline "
            "(the window closes early to chase a deadline; this counts "
            "the ones the launch still failed to meet).",
            labels=("priority",))
        # sliding-window SLO estimator (libs/slo.py): windowed
        # quantiles and error-budget burn, refreshed after each
        # scheduler launch when [slo] / TM_TPU_SLO=1 is enabled
        self.slo_p50 = reg.gauge(
            "crypto", "slo_p50_seconds",
            "Median verify e2e latency over the sliding SLO window, "
            "per stream (priority class).  Absent until [slo] enables "
            "the estimator.", labels=("stream",))
        self.slo_p99 = reg.gauge(
            "crypto", "slo_p99_seconds",
            "p99 verify e2e latency over the sliding SLO window, per "
            "stream.", labels=("stream",))
        self.slo_burn_rate = reg.gauge(
            "crypto", "slo_burn_rate",
            "Error-budget burn rate against the stream's p99 target "
            "([slo] config): windowed fraction of requests over "
            "target / the stream's [slo] budget (budget_pct/100, "
            "default 0.01).  1.0 = spending the budget exactly as "
            "fast as the SLO allows.", labels=("stream",))
        self.slo_target = reg.gauge(
            "crypto", "slo_target_seconds",
            "Configured p99 target per stream ([slo] <stream>_p99_ms, "
            "seconds).  Published so SLO consumers — the adaptive "
            "control plane (ADR-023), dashboards — read targets from "
            "metrics instead of magic constants.  Absent for streams "
            "with no configured target.", labels=("stream",))


class DevObsMetrics:
    """Device observatory (crypto/devobs.py, ADR-021): where a device
    launch's wall clock goes (host staging / H2D transfer / compute /
    D2H collect), whether the double-buffered chunk paths actually hide
    transfer behind compute, what is resident in device memory per pool,
    and how many (kernel, bucket shape) entries the process has built."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.device_stage = reg.histogram(
            "crypto", "device_stage_seconds",
            "Host staging share of a device launch (pack / pad / "
            "challenge hashing), seconds, by dispatch path.",
            labels=("path",), buckets=exp_buckets(0.0002, 4, 10))
        self.device_transfer = reg.histogram(
            "crypto", "device_transfer_seconds",
            "Host->device transfer share of a device launch, seconds, "
            "by dispatch path (monolithic paths bracket the device_put "
            "with block_until_ready; pipelined paths record the summed "
            "device_put walls).", labels=("path",),
            buckets=exp_buckets(0.0002, 4, 10))
        self.device_compute = reg.histogram(
            "crypto", "device_compute_seconds",
            "Kernel compute share of a device launch (dispatch -> "
            "block_until_ready on the results), seconds, by path.",
            labels=("path",), buckets=exp_buckets(0.0005, 4, 10))
        self.device_collect = reg.histogram(
            "crypto", "device_collect_seconds",
            "Device->host bitmap readback share of a launch, seconds, "
            "by path.", labels=("path",),
            buckets=exp_buckets(0.0002, 4, 10))
        self.device_drain = reg.histogram(
            "crypto", "device_drain_seconds",
            "Final blocking wait of a double-buffered launch (residual "
            "un-hidden compute + D2H readback, merged — these paths "
            "cannot split compute from collect without serializing the "
            "pipeline they exist to overlap), seconds, by path.",
            labels=("path",), buckets=exp_buckets(0.0005, 4, 10))
        self.chunk_overlap = reg.gauge(
            "crypto", "device_chunk_overlap_ratio",
            "Fraction of the most recent double-buffered launch's "
            "host->device DMA wall issued while a previous chunk's "
            "kernel was in flight (1 = transfer fully hidden behind "
            "compute, 0 = serial).")
        self.chunk_overlap_seq = reg.gauge(
            "crypto", "device_chunk_overlap_seq",
            "Observatory sequence number of the launch that last set "
            "crypto_device_chunk_overlap_ratio — the control plane's "
            "overlap mode compares it across periods so a busy path "
            "repeatedly publishing the same stable ratio still reads "
            "as fresh (a frozen ratio AND a frozen seq = idle).")
        self.shard_imbalance = reg.gauge(
            "crypto", "device_shard_imbalance",
            "max/mean real rows per shard of the most recent mesh "
            "launch (1 = balanced; pad-only shards drag the mean "
            "down).")
        self.shard_h2d_imbalance = reg.gauge(
            "crypto", "device_shard_h2d_imbalance",
            "max/mean per-shard host->device put wall of the most "
            "recent overlapped mesh staging launch (ADR-027; 1 = every "
            "shard position staged equally fast — a slow link or "
            "oversubscribed shard shows up here first).")
        self.hbm_resident = reg.gauge(
            "crypto", "hbm_resident_bytes",
            "Device-resident bytes per pool (table_cache = comb window "
            "tables, pub_cache = pubkey rows, base_comb = the static "
            "basepoint comb, mesh_tables = the data plane's extra "
            "per-device comb copies or sharded slices (ADR-027), "
            "staging = launch staging buffers — "
            "charged as the double-buffered in-flight window for the "
            "duration of the launch call; a caller that keeps results "
            "in flight after a non-blocking launch returns is not "
            "charged past the call).", labels=("pool",))
        self.hbm_peak = reg.gauge(
            "crypto", "hbm_resident_peak_bytes",
            "High-water mark of crypto_hbm_resident_bytes per pool "
            "since process start (or the last devobs reset).",
            labels=("pool",))
        self.compile_cache_entries = reg.gauge(
            "crypto", "compile_cache_entries",
            "Distinct (kernel path, lane bucket, shards) entries in "
            "the device observatory's compile-cache inventory — the "
            "shapes this process has paid an XLA/Mosaic compile for.")
        self.devobs_shed = reg.counter(
            "crypto", "devobs_shed_total",
            "Device-observatory records shed (reason=chaos: a "
            "recording fault was swallowed, the launch proceeded; "
            "reason=evict: ring/queue overflow).", labels=("reason",))


class P2PMetrics:
    """Reference p2p/metrics.go, extended by the gossip observatory
    (p2p/netobs.py, ADR-025).  The byte counters and everything below
    them are fed by netobs.publish_pending() — the per-frame recorders
    never touch the registry (deferred-drain discipline); peer label
    cardinality is bounded by the observatory's 128-peer cap."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.peers = reg.gauge("p2p", "peers", "Connected peers.")
        self.bytes_sent = reg.counter("p2p", "message_send_bytes_total",
                                      "Bytes sent.", labels=("ch_id",))
        self.bytes_recv = reg.counter("p2p", "message_receive_bytes_total",
                                      "Bytes received.", labels=("ch_id",))
        self.queue_wait = reg.histogram(
            "p2p", "channel_queue_wait_seconds",
            "Send-queue wait per frame (enqueue -> wire) by channel — "
            "how long a frame sat behind its channel's priority before "
            "the send routine picked it.",
            labels=("ch_id",),
            buckets=[.0001, .0005, .001, .005, .01, .05, .1, .5, 1, 5])
        self.queue_depth = reg.gauge(
            "p2p", "channel_queue_depth",
            "Last observed send-queue depth by channel (max across "
            "peers at the most recent netobs drain).", labels=("ch_id",))
        self.peer_flow = reg.gauge(
            "p2p", "peer_flow_bytes_per_s",
            "Per-peer goodput over the last netobs drain interval "
            "(byte-ledger delta / elapsed).",
            labels=("peer", "direction"))
        self.flow_rate = reg.gauge(
            "p2p", "flow_rate_bytes_per_s",
            "Flowrate Monitor EMA rate per peer (the token-bucket "
            "limiter's own view; reference flowrate.Status.CurRate).",
            labels=("peer", "direction"))
        self.peer_rtt = reg.gauge(
            "p2p", "peer_rtt_seconds",
            "Most recent ping->pong round-trip per peer.",
            labels=("peer",))
        self.throttle_stall = reg.counter(
            "p2p", "throttle_stall_seconds_total",
            "Seconds the send/recv routines slept in the flowrate "
            "token bucket — a bandwidth-capped link shows up here "
            "instead of as unexplained queue wait.",
            labels=("direction",))
        self.gossip_receipts = reg.counter(
            "p2p", "gossip_receipts_total",
            "Consensus gossip receipts by the state machine's verdict "
            "(outcome=useful advanced the height; outcome=duplicate "
            "was redundant gossip — pure wasted bytes).",
            labels=("kind", "outcome"))
        self.netobs_shed = reg.counter(
            "p2p", "netobs_shed_total",
            "Gossip-observatory samples shed (reason=chaos: a "
            "recording fault was swallowed, delivery proceeded; "
            "reason=evict: peer/channel/sample-queue cap overflow).",
            labels=("reason",))




class NetMetrics:
    """The in-process virtual network and scenario harness
    (networks/vnet.py, networks/harness.py): what the fault schedule is
    doing to the wire, and whether scenarios pass their always-on
    invariant gates."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.partitions_active = reg.gauge(
            "net", "partitions_active",
            "Partition groups currently enforced by the virtual "
            "network (0 = healed).")
        self.msgs_dropped = reg.counter(
            "net", "msgs_dropped_total",
            "Frames the virtual network refused to deliver, by "
            "reason: partition (cross-group or link down), loss (iid "
            "drop policy), backpressure (per-channel in-flight cap on "
            "a try_send), chaos (injected fault at vnet.deliver/"
            "vnet.reorder).", labels=("reason",))
        self.scenario_failures = reg.counter(
            "harness", "scenario_failures_total",
            "Scenario runs that failed an invariant gate or step (a "
            "stitched cross-node trace artifact is dumped for each).")


class TraceMetrics:
    """Flight recorder self-observability (libs/trace.py): a wrapped
    ring silently overwrites its oldest spans by design, but the
    OVERWRITE must be visible — a trace consumer reading a quiet buffer
    needs to know whether the system was quiet or the ring lapped it."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.dropped_spans = reg.counter(
            "trace", "dropped_spans_total",
            "Finished spans overwritten by flight-recorder ring "
            "wraparound since process start (the ring keeps the newest "
            "window; this counts what it forgot).")


class ControlMetrics:
    """Adaptive control plane (libs/control.py, ADR-023): what the
    knob governor decided, where every governed knob sits right now,
    how often moves hit a declared safe-range bound, and whether the
    kill switch is flipped.  The decision RING (the why behind each
    move) is served at GET /debug/control; these are the aggregates."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.decisions = reg.counter(
            "control", "decisions_total",
            "Knob moves by the decision loop, by knob and direction "
            "(grow / shrink / revert / held: the seam refused this "
            "period's move / error: the knob's seam raised / skipped: "
            "a whole period skipped at the control.decide chaos "
            "seam, knob=period).", labels=("knob", "direction"))
        self.knob_value = reg.gauge(
            "control", "knob_value",
            "Current value of each governed knob as last applied or "
            "observed by the controller (registration publishes the "
            "static configured value).", labels=("knob",))
        self.clamped = reg.counter(
            "control", "clamped_total",
            "Decisions whose target was clamped onto a declared "
            "safe-range bound — persistent clamping means the range "
            "(or the workload) needs operator attention.",
            labels=("knob",))
        self.killed = reg.gauge(
            "control", "killed",
            "1 while the kill switch is flipped (control.kill() / "
            "chaos at control.decide): every knob is reverted to its "
            "static configured value and the loop refuses further "
            "decisions.")


class LightMetrics:
    """Light serving plane (light/service.py, ADR-026): admission
    outcomes and overload refusals at the front door, cross-client
    certificate coalescing effectiveness, follow-cursor pressure, and
    end-to-end request latency.  Per-client p99 latency and the
    coalesce ratio are served at GET /debug/light; these are the
    aggregates."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.requests = reg.counter(
            "light", "requests_total",
            "Verify requests settled by the serving plane, by outcome "
            "(ok: verified / refused: header or certificate check "
            "failed — overload refusals count under light_shed_total "
            "instead).", labels=("outcome",))
        self.shed = reg.counter(
            "light", "shed_total",
            "Requests refused busy-with-retry-after at the front door "
            "(busy: admission queue full / ratelimit: the client's "
            "token bucket was empty).", labels=("reason",))
        self.coalesce = reg.counter(
            "light", "coalesce_total",
            "Certificate verifications by coalescing class (lead: one "
            "shared execution / hit: a verification settled by another "
            "request's lead, within a batch or across in-flight "
            "workers / direct: per-request execution because the "
            "coalesce plane degraded at the light.coalesce chaos "
            "seam).", labels=("result",))
        self.queue_depth = reg.gauge(
            "light", "serve_queue_depth",
            "Verify requests waiting in the admission queue right "
            "now.")
        self.cursors = reg.gauge(
            "light", "follow_cursors",
            "Open header-follow cursors across all clients right now.")
        self.cursors_evicted = reg.counter(
            "light", "cursors_evicted_total",
            "Follow cursors evicted under pressure (per-client or "
            "global bound): the least-recently-polled cursor is "
            "dropped so live followers survive; the evicted client "
            "re-subscribes.")
        self.request_latency = reg.histogram(
            "light", "request_latency_seconds",
            "End-to-end verify latency of plane-processed requests, "
            "submit to settled verdict (queue wait + header checks + "
            "coalesced certificate verification).",
            buckets=exp_buckets(0.0002, 4, 10))


class MempoolMetrics:
    """Reference mempool/metrics.go, plus the IngressGate admission
    pipeline (mempool/ingress.py, ADR-018): why txs are being turned
    away, how deep the bounded admission queue is running, and what
    admission costs end to end — the operator's view of whether a tx
    flood is degrading gracefully (busy/ratelimit rejections) or the
    pool is merely full."""

    def __init__(self, reg: Optional[Registry] = None):
        reg = reg or DEFAULT
        self.size = reg.gauge("mempool", "size",
                              "Transactions in the mempool.")
        self.tx_size_bytes = reg.histogram(
            "mempool", "tx_size_bytes", "Tx sizes.",
            buckets=exp_buckets(1, 3, 17))
        self.failed_txs = reg.counter("mempool", "failed_txs",
                                      "Rejected CheckTx.")
        self.recheck_times = reg.counter("mempool", "recheck_times",
                                         "Tx recheck invocations.")
        self.rejected_txs = reg.counter(
            "mempool", "rejected_txs_total",
            "Txs rejected at admission, by reason: full (pool at "
            "size/byte limit), busy (ingress queue full or MEMPOOL-"
            "class verify shed — retryable overload), cache (dedup "
            "cache hit), ratelimit (per-source token bucket), sig "
            "(batched pre-verification refuted the signature), "
            "app_err (the app rejected or raised), toolarge "
            "(max_tx_bytes).", labels=("reason",))
        self.ingress_queue_depth = reg.gauge(
            "mempool", "ingress_queue_depth",
            "Txs waiting in the IngressGate admission queue (bounded "
            "by [mempool] ingress_queue; at the bound new submissions "
            "are rejected busy).")
        self.admission_latency = reg.histogram(
            "mempool", "admission_latency_seconds",
            "End-to-end admission latency of gate-processed txs, "
            "submit to settled ResponseCheckTx (queue wait + batched "
            "pre-verify + app CheckTx + insert).",
            buckets=exp_buckets(0.0002, 4, 10))
