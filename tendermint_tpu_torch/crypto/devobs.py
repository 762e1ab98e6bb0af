"""Device observatory: per-launch transfer/compute/compile
decomposition, device-memory residency ledger, and compile inventory.

The counterpart of tendermint_tpu/crypto/devobs.py (ADR-021).  A bounded
ring of per-launch records with a phase decomposition, fed by every
dispatch that funnels through ops/ed25519._set_last_launch: the K1/K2
routes and the comb route (C2) via _record_launch, verify_batch_staged
(K3), and the RLC route mirror from ops/msm._set_route (K4, K5, A1).

Per-launch phases (seconds; a path records the ones it measures — on a
CUDA device the transfer and kernel times are CUDA-event times, see
ops/ed25519._ChunkFeed):

  stage_s     host staging: pack / pad / challenge hashing
  h2d_s       host->device transfer (summed copies of a chunked launch)
  compute_s   kernel time (summed over the chunks of a chunked launch)
  collect_s   device->host readback of the bitmap (one-chunk launches)
  drain_s     the final blocking wait of a multi-chunk launch (residual
              un-hidden compute + readback, merged)

plus, for the double-buffered chunk paths, `chunk_overlap`: the share of
the host->device copy time hidden behind kernels.

Three persistent side tables, all under the one leaf lock:

  * compile inventory: (path, nb, shards) -> first-launch wall,
    first-seen monotonic time + observatory seq, and hit count.  The
    keys are ops/ed25519._seen_buckets' without its device (shards is
    always 1 on one device).  The kernels are built before a launch
    starts (crypto/batch._load_kernels), so on the card the first-launch
    wall holds the CUDA module load and the first run, not the nvcc build.
  * device-memory residency ledger: per-pool resident bytes + high-water
    mark (ledger_set for caches that know their totals, ledger_add for
    in-flight deltas).
  * shed counters (chaos / evict), flushed with publication.

Design constraints:

  1. Disabled is a no-op (TM_TPU_DEVOBS=0): the module functions check
     the enabled flag FIRST and then neither store nor take a lock.  ON
     by default: a handful of dict stores per launch.
  2. Bounded memory: one deque ring (default 256 launches, oldest
     evicted first), a bounded deferred-publication queue, and side
     tables that grow only with distinct bucket shapes / pools.
  3. Recording never publishes.  record()/ledger_* take ONE leaf lock,
     store, and return — metrics/SLO publication is deferred to
     publish_pending(), which the launch seam calls AFTER releasing ops'
     _launch_lock (holding nothing).  The chaos seam `devobs.record`
     proves a recording fault sheds the record while the launch
     proceeds untouched (latency injections are absorbed into the
     recording, never the launch).

Read it back via report() / device_block() / records().  (The
`/debug/device` endpoint, the `debug-device` CLI and the [devobs] config
section wait for the node's ports.)
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs import fail

_DEFAULT_CAPACITY = 256

# bound on the deferred-publication queue: the launch seam drains right
# after each record, but if every drainer is somehow absent the queue
# must still be bounded — oldest entries drop (counted as evict)
_MAX_PENDING = 4096

# phase vocabulary: the decomposition keys publish_pending() feeds into
# the crypto_device_*_seconds histograms (an unknown phase key in a
# record is simply not observed — same tolerance as HeightRecord.info).
# drain_s is the double-buffered paths' final blocking wait (residual
# un-hidden compute + D2H readback): those paths cannot split compute
# from collect without serializing the pipeline, so they record the
# merged wait under its own name instead of mislabeling it collect_s
PHASES = ("stage_s", "h2d_s", "compute_s", "collect_s", "drain_s")

# ledger pools of the node, in the report's stable order; ledger_set/add
# accept any pool name (the gauge is labeled).  The port feeds table_cache
# (ops/ed25519's comb table cache, the bytes it charges), pub_cache (its
# DeviceLRU of pubkey rows), base_comb (B's static comb of the route's
# device), staging (the chunk feed's pinned and device buffers, the
# comb route's per-launch rows, the data plane's in-flight chunks) and
# mesh_tables (the data plane's comb table copies beyond the build copy,
# parallel/sharding)
KNOWN_POOLS = ("table_cache", "pub_cache", "base_comb", "staging",
               "mesh_tables")


def shard_fields(n: int, nb: int, shards: int) -> dict:
    """Per-shard real-row counts + max/mean imbalance for a mesh launch
    record: nb padded lanes split contiguously over `shards`, the first
    ceil(n/per) shards holding real rows.  Exact for single-chunk
    launches; chunked mesh launches reuse it as an approximation of the
    total per-position load.  Shared by ops/ed25519._comb_try and the
    parallel/sharding mesh routes so the model can't drift between
    them."""
    if shards <= 1 or nb < shards:
        return {}
    per = nb // shards
    if per <= 0:
        return {}
    rows = [max(0, min(n - i * per, per)) for i in range(shards)]
    out = {"shard_rows": rows}
    mean = n / shards
    if mean > 0:
        out["shard_imbalance"] = max(rows) / mean
    return out


class DevObs:
    """See the module docstring.  One process-global instance (the
    module-level functions); tests may build private instances."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("TM_TPU_DEVOBS", "") != "0"
        if capacity is None:
            # malformed env falls back: this module is reachable from
            # the verify hot path, a bad env var must never stop a node
            try:
                capacity = int(os.environ.get("TM_TPU_DEVOBS_CAPACITY",
                                              _DEFAULT_CAPACITY))
            except (ValueError, TypeError):
                capacity = _DEFAULT_CAPACITY
        self._enabled = bool(enabled)
        self._lock = threading.Lock()  # the leaf: nothing taken under it
        self._ring: "collections.deque" = collections.deque(
            maxlen=max(1, int(capacity)))
        self._seq = 0
        # (path, nb, shards) -> {compile_s, first_seen_t,
        #                        first_seen_seq, hits}
        self._inventory: Dict[tuple, dict] = {}
        # pool -> [resident bytes, high-water bytes]
        self._ledger: Dict[str, List[float]] = {}
        self._pending: List[dict] = []
        # ring rotation is benign history turnover, NOT loss — counted
        # separately from the shed metric so devobs_shed_total stays a
        # real loss signal (only chaos faults and pending-queue drops)
        self._rotated = 0
        # _shed is the unpublished delta (flushed into the counter by
        # publish_pending); _shed_total is the cumulative view the read
        # surfaces report — without it a reader that flushes before
        # reading (device_block) would always see zeros
        self._shed = {"chaos": 0, "evict": 0}
        self._shed_total = {"chaos": 0, "evict": 0}
        # process-lifetime totals, independent of ring rotation: a long
        # bench run must not lose its first-launch compile walls to the
        # ring bound (device_block's compile_frac reads these)
        self._totals = {"launches": 0, "wall_s": 0.0, "compile_s": 0.0}
        self._metrics = None  # lazy DevObsMetrics

    # -- state -------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def set_config(self, enabled: Optional[bool] = None,
                   capacity: Optional[int] = None):
        """Node wiring ([devobs] config section): the operator's config
        wins over a stale env var in BOTH directions; None leaves a
        dimension untouched (the slo.set_config contract)."""
        with self._lock:
            if capacity is not None and \
                    int(capacity) != (self._ring.maxlen or 0):
                self._ring = collections.deque(self._ring,
                                               maxlen=max(1, int(capacity)))
        if enabled is not None:
            self._enabled = bool(enabled)

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._inventory.clear()
            self._ledger.clear()
            self._pending.clear()
            self._rotated = 0
            self._shed = {"chaos": 0, "evict": 0}
            self._shed_total = {"chaos": 0, "evict": 0}
            self._totals = {"launches": 0, "wall_s": 0.0,
                            "compile_s": 0.0}

    def shed_counts(self) -> dict:
        """Cumulative shed counts since construction/reset (NOT the
        unpublished delta — publish_pending drains that on every
        launch, so a delta read would always be zeros)."""
        with self._lock:
            return dict(self._shed_total)

    def rotated(self) -> int:
        """Records displaced by normal ring turnover (stored, published,
        then aged out) — benign, deliberately NOT in shed_counts()."""
        with self._lock:
            return self._rotated

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    # -- the hot path ------------------------------------------------------

    def record(self, rec: dict) -> bool:
        """Record one device-launch record (the dict shape
        ops/ed25519._set_last_launch publishes: path/n/nb/shards/
        first_launch/wall_s plus any phase keys the site measured).
        Stores under the leaf lock and returns — never publishes.  A
        chaos fault at `devobs.record` (or any internal error) sheds
        the record; launch telemetry must never take down the verify
        path it observes."""
        if not self._enabled:
            return False
        try:
            fail.inject("devobs.record")
            t = time.monotonic()
            with self._lock:
                self._seq += 1
                r = dict(rec)
                r["obs_seq"] = self._seq
                r["t_mono"] = t
                key = (r.get("path"), r.get("nb"), r.get("shards", 1))
                inv = self._inventory.get(key)
                if inv is None:
                    self._inventory[key] = {
                        "compile_s": r.get("wall_s")
                        if r.get("first_launch") else None,
                        "first_seen_t": t,
                        "first_seen_seq": self._seq,
                        "hits": 0,
                    }
                else:
                    inv["hits"] += 1
                    # a record may claim first_launch for a key the
                    # inventory saw without a wall (an RLC route
                    # mirror): attribute the compile wall once
                    if r.get("first_launch") and \
                            inv.get("compile_s") is None:
                        inv["compile_s"] = r.get("wall_s")
                wall = r.get("wall_s")
                self._totals["launches"] += 1
                if wall is not None:
                    self._totals["wall_s"] += wall
                    if r.get("first_launch"):
                        self._totals["compile_s"] += wall
                if len(self._ring) == self._ring.maxlen:
                    self._rotated += 1
                self._ring.append(r)
                if len(self._pending) >= _MAX_PENDING:
                    # a REAL loss: this record was never published
                    self._pending.pop(0)
                    self._shed["evict"] += 1
                    self._shed_total["evict"] += 1
                self._pending.append(r)
            return True
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1
                self._shed_total["chaos"] += 1
            return False

    def ledger_set(self, pool: str, nbytes) -> None:
        """Set a pool's resident-byte level (caches that know their
        totals — the DeviceLRUs, the static comb)."""
        if not self._enabled:
            return
        try:
            with self._lock:
                ent = self._ledger.setdefault(pool, [0.0, 0.0])
                ent[0] = max(0.0, float(nbytes))
                if ent[0] > ent[1]:
                    ent[1] = ent[0]
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1
                self._shed_total["chaos"] += 1

    def ledger_add(self, pool: str, delta) -> None:
        """Adjust a pool by a delta (in-flight staging buffers:
        +bytes before the puts, -bytes when the launch retires)."""
        if not self._enabled:
            return
        try:
            with self._lock:
                ent = self._ledger.setdefault(pool, [0.0, 0.0])
                ent[0] = max(0.0, ent[0] + float(delta))
                if ent[0] > ent[1]:
                    ent[1] = ent[0]
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1
                self._shed_total["chaos"] += 1

    # -- deferred publication (callers hold NO lock) -----------------------

    def _bundle(self):
        if self._metrics is None:
            from tendermint_tpu_torch.libs.metrics import DevObsMetrics
            self._metrics = DevObsMetrics()
        return self._metrics

    def publish_pending(self):
        """Publish the decomposition histograms, overlap/imbalance and
        ledger gauges, the compile-cache entry count, and the [slo]
        `device_launch` stream for records since the last call.  The
        launch seam calls this holding nothing (after ops' _launch_lock
        is released); the read surfaces flush before reporting."""
        if not self._enabled:
            return
        try:
            self._publish_pending()
        except Exception:  # noqa: BLE001 - a publication fault sheds;
            # it must never escalate into the dispatch path
            try:
                with self._lock:
                    self._shed["chaos"] += 1
                self._shed_total["chaos"] += 1
            except Exception:  # noqa: BLE001
                pass

    def _publish_pending(self):
        with self._lock:
            pending, self._pending = self._pending, []
            shed, self._shed = self._shed, {"chaos": 0, "evict": 0}
            ledger = {p: (v[0], v[1]) for p, v in self._ledger.items()}
            n_entries = len(self._inventory)
        if not pending and not any(shed.values()):
            return
        from tendermint_tpu_torch.libs import slo
        m = self._bundle()
        for reason, n in shed.items():
            if n:
                m.devobs_shed.inc(n, reason=reason)
        for pool, (cur, peak) in ledger.items():
            m.hbm_resident.set(cur, pool=pool)
            m.hbm_peak.set(peak, pool=pool)
        m.compile_cache_entries.set(n_entries)
        for r in pending:
            path = str(r.get("path"))
            if r.get("stage_s") is not None:
                m.device_stage.observe(r["stage_s"], path=path)
            if r.get("h2d_s") is not None:
                m.device_transfer.observe(r["h2d_s"], path=path)
            if r.get("compute_s") is not None:
                m.device_compute.observe(r["compute_s"], path=path)
            if r.get("collect_s") is not None:
                m.device_collect.observe(r["collect_s"], path=path)
            if r.get("drain_s") is not None:
                m.device_drain.observe(r["drain_s"], path=path)
            if r.get("chunk_overlap") is not None:
                m.chunk_overlap.set(r["chunk_overlap"])
                # the companion launch-sequence gauge the control
                # plane's overlap mode reads for freshness: a stable
                # ratio republished by a busy path still advances it
                m.chunk_overlap_seq.set(r.get("obs_seq", 0))
            if r.get("shard_imbalance") is not None:
                m.shard_imbalance.set(r["shard_imbalance"])
            sh = r.get("shard_h2d_s")
            if sh:
                # per-position put walls of the mesh staging (ADR-027):
                # publish the max/mean imbalance — a slow link or one
                # oversubscribed position shows up here before it shows
                # up as a widening drain_s
                mean = sum(sh) / len(sh)
                if mean > 0:
                    m.shard_h2d_imbalance.set(max(sh) / mean)
            wall = r.get("wall_s")
            if wall is not None:
                slo.observe("device_launch", wall)

    # -- read side ---------------------------------------------------------

    def records(self, last: int = 0, since_seq: int = 0) -> List[dict]:
        """The newest `last` launch records (0 = all), oldest first,
        optionally restricted to obs_seq > since_seq.  Copies — the
        ring keeps mutating."""
        with self._lock:
            recs = [dict(r) for r in self._ring
                    if r.get("obs_seq", 0) > since_seq]
        if last > 0:
            recs = recs[-last:]
        return recs

    def compile_inventory(self) -> List[dict]:
        """The compile-cache inventory as a list of entries, first-seen
        order: which (kernel path, bucket shape) compiled in this
        process, what the first launch cost, and how often the cached
        executable has been hit since."""
        with self._lock:
            items = sorted(self._inventory.items(),
                           key=lambda kv: kv[1]["first_seen_seq"])
        return [{"path": k[0], "nb": k[1], "shards": k[2], **v}
                for k, v in items]

    def ledger_report(self) -> Dict[str, dict]:
        with self._lock:
            snap = {p: (v[0], v[1]) for p, v in self._ledger.items()}
        out = {}
        for pool in list(KNOWN_POOLS) + sorted(set(snap) -
                                               set(KNOWN_POOLS)):
            if pool in snap:
                cur, peak = snap[pool]
                out[pool] = {"bytes": int(cur), "peak_bytes": int(peak)}
        return out

    def report(self, last: int = 16) -> dict:
        return {
            "enabled": self._enabled,
            "capacity": self.capacity,
            "shed": self.shed_counts(),
            "rotated": self.rotated(),
            "launches": self.records(last=last),
            "compile_cache": self.compile_inventory(),
            "hbm": self.ledger_report(),
        }

    def cursor(self) -> dict:
        """Snapshot for interval-exact device_block diffs: the current
        obs seq plus the lifetime totals.  A caller takes one per
        interval (chip_smoke.py, per phase); diffing totals (instead of summing ring records) keeps
        an interval's first-launch walls in its compile_frac even
        after the record rotated out of the ring."""
        with self._lock:
            return {"seq": self._seq, **self._totals}

    def device_block(self, since: Optional[dict] = None) -> dict:
        """Aggregate decomposition block for a bench JSON line.  The
        headline totals (launches / wall_s / compile_s / compile_frac)
        are interval-exact:
        lifetime totals, diffed against a cursor() snapshot when one is
        given — immune to ring rotation either way.  The phase sums,
        chunk-overlap ratio and path counts are ring-scoped and live in
        a nested `window` dict with its own launch count, so a reader
        can see they decompose the window, not necessarily the whole
        wall.  Flushes deferred publication so the metrics agree with
        the emitted block."""
        if not self._enabled:
            return {}
        self.publish_pending()
        with self._lock:
            n_launches = self._totals["launches"]
            wall = self._totals["wall_s"]
            compile_s = self._totals["compile_s"]
        seq0 = 0
        if since is not None:
            seq0 = since.get("seq", 0)
            n_launches -= since.get("launches", 0)
            wall -= since.get("wall_s", 0.0)
            compile_s -= since.get("compile_s", 0.0)
        recs = self.records(since_seq=seq0)
        blk = {
            "launches": n_launches,
            "wall_s": round(wall, 4),
            "compile_s": round(compile_s, 4),
            "compile_frac": round(compile_s / wall, 4)
            if wall > 0 else 0.0,
            "compile_cache_entries": len(self.compile_inventory()),
        }
        window: Dict[str, object] = {"launches": len(recs)}
        for phase in PHASES:
            vals = [r[phase] for r in recs if r.get(phase) is not None]
            if vals:
                window[phase] = round(sum(vals), 4)
        overlaps = [r["chunk_overlap"] for r in recs
                    if r.get("chunk_overlap") is not None]
        if overlaps:
            window["chunk_overlap"] = round(overlaps[-1], 4)
        paths: Dict[str, int] = {}
        for r in recs:
            p = str(r.get("path"))
            paths[p] = paths.get(p, 0) + 1
        if paths:
            window["paths"] = paths
        blk["window"] = window
        hbm = self.ledger_report()
        if hbm:
            blk["hbm"] = {p: v["bytes"] for p, v in hbm.items()}
        return blk


# ---------------------------------------------------------------------------
# the process-global observatory (same convention as trace.TRACER,
# slo.EST, consensus/observatory.OBS)
# ---------------------------------------------------------------------------

OBS = DevObs()


def record(rec: dict) -> bool:
    o = OBS
    if not o._enabled:  # the sub-microsecond disabled path
        return False
    return o.record(rec)


def ledger_set(pool: str, nbytes) -> None:
    o = OBS
    if not o._enabled:
        return
    o.ledger_set(pool, nbytes)


def ledger_add(pool: str, delta) -> None:
    o = OBS
    if not o._enabled:
        return
    o.ledger_add(pool, delta)


def publish_pending():
    o = OBS
    if not o._enabled:
        return
    o.publish_pending()


def is_enabled() -> bool:
    return OBS._enabled


def enable():
    OBS.enable()


def disable():
    OBS.disable()


def reset():
    OBS.reset()


def set_config(enabled: Optional[bool] = None,
               capacity: Optional[int] = None):
    OBS.set_config(enabled=enabled, capacity=capacity)


def last_seq() -> int:
    return OBS.last_seq()


def records(last: int = 0, since_seq: int = 0) -> List[dict]:
    return OBS.records(last=last, since_seq=since_seq)


def compile_inventory() -> List[dict]:
    return OBS.compile_inventory()


def ledger_report() -> Dict[str, dict]:
    return OBS.ledger_report()


def report(last: int = 16) -> dict:
    return OBS.report(last=last)


def cursor() -> dict:
    return OBS.cursor()


def device_block(since: Optional[dict] = None) -> dict:
    return OBS.device_block(since=since)
