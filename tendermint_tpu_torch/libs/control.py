"""Adaptive control plane: an SLO-burn-driven knob governor
(docs/adr/adr-023-adaptive-control-plane.md).

Every tuning knob the stack has grown — the VerifyScheduler coalescing
window, the host-lane pool width, IngressGate admission rate/burst,
BlockPipeline depth, statesync fetch parallelism, the comb min-batch
demotion threshold — is frozen at config-load time, while the SLO
estimator (libs/slo.py, ADR-016) and the observatories (ADR-016/020/21)
already publish exactly the burn-rate and queue-depth signals a
feedback loop needs.  This module closes the loop in the SEDA/AIMD
tradition of admission-controlled staged services: degrade gracefully
under overload instead of burning the consensus SLO, recover
automatically when the weather clears.

Design rules, in the order they were fought for:

  1. Published signals only.  The decision loop reads process-global
     metric gauges/counters (libs/metrics.DEFAULT) and the SLO burn
     gauges the scheduler publishes — never a subsystem's private
     state.  If a signal is worth steering on, it is worth publishing;
     the controller is a metrics consumer like any dashboard.
  2. Declared safe ranges.  A knob is registered from a literal
     ``KnobSpec`` row in KNOB_SPECS — name, finite (lo, hi) range,
     step, direction, policy mode and the metric attr it steers on —
     and tmlint TM308 checks those literals at AST level.  The
     ``[control]`` config section can tighten a range; the controller
     clamps every move into it and counts hits on the bounds.
  3. Bounded moves, bounded memory.  One decision per knob per period
     (default 1 s), each move at most one step (AIMD: multiplicative
     clamp on overload for admission knobs, additive everything else).
     Decisions land in a bounded ring served at ``GET /debug/control``
     and the ``debug-control`` CLI.
  4. The kill switch wins.  ``control.kill()``, ``TM_TPU_CONTROL=0``
     or a chaos ``raise`` at the ``control.decide`` seam reverts EVERY
     knob to its static configured value within one period — the
     setters are the same ``set_config``-style seams the node wiring
     uses, so static config stays the single source of truth.

Lock discipline (TM201): ``Controller._lock`` is a leaf — it guards
the knob registry, per-knob bookkeeping and the decision ring, and is
NEVER held across a setter call, a metrics publication or a trace
emission.  Each tick snapshots the registry under the lock, then
decides/actuates/publishes outside it.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs.service import BaseService

_DEFAULT_PERIOD_MS = 1000.0
_DEFAULT_RECOVER_AFTER = 3
_RING_CAP = 256

# the multiplicative-decrease factor for admission-mode knobs (the
# "MD" in AIMD: halve on overload, recover additively)
_MD_FACTOR = 0.5

# a backlog/pressure signal counts as "pinned" against its bound above
# this fraction of the observed peak
_PIN_FRAC = 0.95

# overlap-mode knobs shrink while the measured transfer/compute overlap
# ratio of fresh mesh launches sits below this target (1 = transfer
# fully hidden; 0.4 keeps the knob from chasing noise near full hiding)
_OVERLAP_TARGET = 0.4


class KnobSpec:
    """The literal declaration of one governed knob: its name, finite
    safe range, step, grow direction, policy mode and the PUBLISHED
    metric attr it steers on.  tmlint TM308 checks every KnobSpec call
    in the tree carries a literal finite 2-tuple ``safe_range`` and a
    literal ``signal`` naming a registered metric attr — an undeclared
    range or a typo'd signal is a lint error, not a runtime surprise."""

    __slots__ = ("name", "safe_range", "step", "direction", "signal",
                 "mode", "labels")

    def __init__(self, name: str, safe_range: Tuple[float, float],
                 step: float, direction: int, signal: str, mode: str,
                 labels: Optional[Dict[str, str]] = None):
        lo, hi = float(safe_range[0]), float(safe_range[1])
        if not (math.isfinite(lo) and math.isfinite(hi)) or lo > hi:
            raise ValueError(
                f"knob {name!r}: safe_range must be a finite (lo, hi) "
                f"with lo <= hi, got {safe_range!r}")
        if not (math.isfinite(float(step)) and float(step) > 0):
            raise ValueError(f"knob {name!r}: step must be finite > 0")
        if mode not in ("throughput", "admission", "backlog", "pressure",
                        "overlap"):
            raise ValueError(f"knob {name!r}: unknown mode {mode!r}")
        self.name = name
        self.safe_range = (lo, hi)
        self.step = float(step)
        self.direction = 1 if direction >= 0 else -1
        self.signal = signal
        self.mode = mode
        self.labels = dict(labels or {})


# ---------------------------------------------------------------------------
# the declared knob table (ADR-023).  One literal row per governed
# knob; [control] config can tighten ranges/steps but every knob the
# node registers starts from a row here.  Policy modes:
#
#   throughput  grow one step while consensus+commit burn is cold and
#               the signal (a queue/occupancy gauge) is climbing; step
#               back toward static when burn goes hot or the signal
#               idles for `recover_after` periods.
#   admission   multiplicative clamp (halve toward lo) the moment
#               block_interval or consensus burn exceeds 1.0; additive
#               recovery toward static after `recover_after` clean
#               periods.  A static value of 0 means "unlimited": the
#               clamp engages from the range's hi, and full recovery
#               restores the unlimited 0.
#   backlog     grow one step while the signal gauge sits pinned
#               against the current knob value; shrink toward static
#               after `recover_after` calm periods.
#   pressure    grow one step (demote work) while the signal gauge is
#               pinned at >= 95% of its published peak; recover toward
#               static after `recover_after` clean periods.
#   overlap     move one step in the declared direction while FRESH
#               launches publish the signal (a ratio gauge) below the
#               overlap target — freshness tracks the companion
#               "<signal>_seq" launch-sequence gauge when one is
#               published (a busy path repeatedly reporting the SAME
#               stable ratio still counts), falling back to a changed
#               gauge value otherwise, so an idle path never walks its
#               knob to the bound; recover toward static once the
#               ratio is healthy or the path idles for
#               `recover_after` periods.
# ---------------------------------------------------------------------------

KNOB_SPECS: Tuple[KnobSpec, ...] = (
    KnobSpec("sched_window_ms", safe_range=(0.5, 20.0), step=0.5,
             direction=1, signal="sched_queue_depth",
             mode="throughput"),
    KnobSpec("host_pool_workers", safe_range=(1.0, 16.0), step=1.0,
             direction=1, signal="host_pool_depth",
             mode="throughput"),
    KnobSpec("ingress_rate_per_s", safe_range=(32.0, 100000.0),
             step=64.0, direction=-1, signal="ingress_queue_depth",
             mode="admission"),
    KnobSpec("ingress_burst", safe_range=(16.0, 65536.0), step=64.0,
             direction=-1, signal="ingress_queue_depth",
             mode="admission"),
    KnobSpec("pipeline_depth", safe_range=(2.0, 32.0), step=1.0,
             direction=1, signal="pipeline_depth", mode="backlog"),
    KnobSpec("statesync_fetchers", safe_range=(1.0, 32.0), step=1.0,
             direction=1, signal="chunks_fetched", mode="throughput",
             labels={"outcome": "ok"}),
    KnobSpec("comb_min_batch", safe_range=(16.0, 4096.0), step=16.0,
             direction=1, signal="hbm_resident", mode="pressure",
             labels={"pool": "table_cache"}),
    KnobSpec("mesh_chunk_lanes", safe_range=(1024.0, 65536.0),
             step=1024.0, direction=-1, signal="chunk_overlap",
             mode="overlap"),
)

SPEC_BY_NAME: Dict[str, KnobSpec] = {s.name: s for s in KNOB_SPECS}


class Knob:
    """One registered knob: a spec row bound to its live getter/setter
    seams, with the static (configured) value captured at registration
    — the value every revert restores."""

    __slots__ = ("spec", "getter", "setter", "safe_range", "step",
                 "static", "integral",
                 # per-knob controller bookkeeping (mutated only from
                 # the decision loop / under Controller._lock)
                 "last_signal", "last_seq", "clean_periods",
                 "idle_periods", "engaged")

    def __init__(self, spec: KnobSpec, getter: Callable[[], float],
                 setter: Callable[[float], object],
                 safe_range: Optional[Tuple[float, float]] = None,
                 step: Optional[float] = None,
                 integral: bool = True):
        lo, hi = safe_range if safe_range is not None else spec.safe_range
        lo, hi = float(lo), float(hi)
        if not (math.isfinite(lo) and math.isfinite(hi)) or lo > hi:
            raise ValueError(
                f"knob {spec.name!r}: configured range ({lo}, {hi}) "
                f"is not a finite lo <= hi pair")
        st = float(step if step is not None else spec.step)
        if not (math.isfinite(st) and st > 0):
            raise ValueError(f"knob {spec.name!r}: step must be > 0")
        self.spec = spec
        self.getter = getter
        self.setter = setter
        self.safe_range = (lo, hi)
        self.step = st
        self.integral = bool(integral)
        self.static = float(getter())
        self.last_signal: Optional[float] = None
        self.last_seq: Optional[float] = None
        self.clean_periods = 0
        self.idle_periods = 0
        # admission knobs with static == 0 (unlimited) only cap once
        # overload engages them; `engaged` remembers that state so
        # recovery knows to eventually restore the unlimited 0
        self.engaged = False

    def clamp(self, v: float) -> Tuple[float, bool]:
        """Clamp v into the safe range; returns (value, hit_bound)."""
        lo, hi = self.safe_range
        c = min(hi, max(lo, v))
        return c, (c != v)

    def coerce(self, v: float) -> float:
        return float(int(round(v))) if self.integral else float(v)


class Decision:
    """One ring entry: what the loop did to one knob and why."""

    __slots__ = ("ts", "knob", "direction", "prev", "value", "reason")

    def __init__(self, ts: float, knob: str, direction: str,
                 prev: float, value: float, reason: str):
        self.ts = ts
        self.knob = knob
        self.direction = direction
        self.prev = prev
        self.value = value
        self.reason = reason

    def to_dict(self) -> dict:
        return {"ts": round(self.ts, 3), "knob": self.knob,
                "direction": self.direction, "prev": self.prev,
                "value": self.value, "reason": self.reason}


class Controller(BaseService):
    """The process-global decision loop.  See the module docstring."""

    def __init__(self, period_ms: float = _DEFAULT_PERIOD_MS,
                 recover_after: int = _DEFAULT_RECOVER_AFTER):
        super().__init__("Controller")
        self.period_s = max(0.01, float(period_ms) / 1000.0)
        self.recover_after = max(1, int(recover_after))
        # _lock is a LEAF (devtools/lockorder.py): registry + ring +
        # bookkeeping only; setters/metrics/trace run outside it
        self._lock = threading.Lock()
        self._knobs: Dict[str, Knob] = {}
        self._ring: deque = deque(maxlen=_RING_CAP)
        self._killed: Optional[str] = None
        self._reverted = False
        self._skipped_periods = 0
        self._periods = 0

    # -- registration ------------------------------------------------------

    def register(self, spec: KnobSpec, getter: Callable[[], float],
                 setter: Callable[[float], object],
                 safe_range: Optional[Tuple[float, float]] = None,
                 step: Optional[float] = None,
                 integral: bool = True) -> Knob:
        """Bind a declared spec row to its live seams.  Registering a
        name twice replaces the binding (a restarted node re-wires)."""
        k = Knob(spec, getter, setter, safe_range=safe_range,
                 step=step, integral=integral)
        with self._lock:
            self._knobs[spec.name] = k
        self._publish_value(k, float(getter()))
        return k

    def knobs(self) -> List[str]:
        with self._lock:
            return sorted(self._knobs)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        self._metrics().killed.set(0.0)
        self.spawn(self._loop, name="control-loop")

    def on_stop(self):
        # stopping the controller abandons governance: hand every knob
        # back to its static configured value so a node shutdown (or a
        # test teardown) never leaks a steered value into the next boot
        self.revert_all("stop")

    def _loop(self):
        while not self.quitting.wait(self.period_s):
            self._tick()

    # -- the kill switch ---------------------------------------------------

    def kill(self, reason: str = "operator"):
        """Flip the kill switch: revert every knob to static NOW and
        refuse further decisions until reset (the static config is the
        single source of truth again)."""
        with self._lock:
            self._killed = reason
        self.revert_all(f"kill:{reason}")
        self._metrics().killed.set(1.0)

    def killed(self) -> Optional[str]:
        with self._lock:
            return self._killed

    def revert_all(self, reason: str):
        """Set every knob back to its registration-time static value.
        Idempotent; every revert is a ring entry so tests (and the
        diurnal_weather scenario) can assert the exact restore."""
        with self._lock:
            knobs = list(self._knobs.values())
        now = time.time()
        decs: List[Decision] = []
        for k in knobs:
            prev = float(k.getter())
            if prev != k.static:
                k.setter(k.coerce(k.static))
            # EVERY knob rings on a revert event — a knob already at
            # static records prev == value, so the diurnal_weather
            # gate can demand one entry per knob without guessing
            # which knobs happened to be steered at flip time
            decs.append(Decision(now, k.spec.name, "revert", prev,
                                 k.static, reason))
            k.clean_periods = 0
            k.idle_periods = 0
            k.engaged = False
            k.last_signal = None
            k.last_seq = None
        with self._lock:
            self._ring.extend(decs)
            self._reverted = True
        m = self._metrics()
        for d in decs:
            m.decisions.inc(knob=d.knob, direction="revert")
            m.knob_value.set(d.value, knob=d.knob)

    # -- signals (published metrics only) ----------------------------------

    def _metrics(self):
        from tendermint_tpu_torch.libs.metrics import ControlMetrics
        return ControlMetrics()

    def _signal_sources(self) -> dict:
        """attr name -> metric object, resolved from the PUBLISHED
        process-global bundles (bundle construction dedupes on the
        registry, so this is a cheap lookup, not a re-registration)."""
        from tendermint_tpu_torch.libs.metrics import (BlockSyncMetrics,
                                                 CryptoMetrics,
                                                 DevObsMetrics,
                                                 MempoolMetrics,
                                                 StateSyncMetrics)
        out = {}
        for bundle in (CryptoMetrics(), BlockSyncMetrics(),
                       MempoolMetrics(), StateSyncMetrics(),
                       DevObsMetrics()):
            for attr, metric in vars(bundle).items():
                out.setdefault(attr, metric)
        return out

    def _signal(self, sources: dict, k: Knob) -> Optional[float]:
        m = sources.get(k.spec.signal)
        if m is None:
            return None
        try:
            return float(m.value(**k.spec.labels))
        except Exception:  # noqa: BLE001 - a label mismatch reads as
            return None    # "no signal", never a crashed loop

    def _burns(self, sources: dict) -> Dict[str, float]:
        """Current burn rate per steering stream.  The scheduler only
        refreshes the slo_burn_rate gauge for the verify streams a
        settled window touched, so the controller refreshes the gauge
        for ITS streams each period (flushing the observatory's
        pending height records first — block_interval observations are
        deferred until a publish, exactly like /debug/latency): the
        gauge stays the published interface, with one writer per
        period."""
        try:
            from tendermint_tpu_torch.consensus import observatory as obsv
            obsv.publish_pending()
        except Exception:  # noqa: BLE001 - telemetry must not stall
            pass            # the decision loop
        from tendermint_tpu_torch.libs import slo
        gauge = sources.get("slo_burn_rate")
        out = {}
        for stream in ("consensus", "commit", "block_interval"):
            burn = 0.0
            try:
                rep = slo.stream_report(stream)
                if rep is not None and "burn_rate" in rep:
                    burn = float(rep["burn_rate"])
                    if gauge is not None:
                        gauge.set(burn, stream=stream)
                elif gauge is not None:
                    burn = float(gauge.value(stream=stream))
            except Exception:  # noqa: BLE001 - unpublished = cold
                burn = 0.0
            out[stream] = burn
        return out

    # -- the decision loop -------------------------------------------------

    def _tick(self):
        """One period: chaos seam first (a raise skips the WHOLE
        period's decisions and counts it — the loop survives), then
        the kill/disable gate, then one bounded decision per knob."""
        try:
            fail.inject("control.decide")
        except fail.InjectedFault:
            with self._lock:
                self._skipped_periods += 1
            m = self._metrics()
            m.decisions.inc(knob="period", direction="skipped")
            # a chaos fault at the decision seam is a controller
            # malfunction: hand the knobs back to static, exactly like
            # the kill switch (ADR-023's fail-static contract)
            self.revert_all("chaos")
            return
        with self._lock:
            self._periods += 1
            killed = self._killed is not None
        if killed or not enabled():
            # the kill switch / env disable wins within one period
            with self._lock:
                reverted = self._reverted
            if not reverted:
                self.revert_all("disabled" if not killed else "killed")
            return
        with self._lock:
            self._reverted = False
            knobs = list(self._knobs.values())
        sources = self._signal_sources()
        burns = self._burns(sources)
        now = time.time()
        decs: List[Decision] = []
        clamped: List[str] = []
        with trace.span("control.decide", period=self._periods,
                        knobs=len(knobs)):
            for k in knobs:
                d = self._decide(k, sources, burns, now)
                if d is not None:
                    decs.append(d)
                    if d.reason.endswith("@bound"):
                        clamped.append(d.knob)
        with self._lock:
            self._ring.extend(decs)
        m = self._metrics()
        for d in decs:
            m.decisions.inc(knob=d.knob, direction=d.direction)
            m.knob_value.set(d.value, knob=d.knob)
        for name in clamped:
            m.clamped.inc(knob=name)

    def _decide(self, k: Knob, sources: dict, burns: Dict[str, float],
                now: float) -> Optional[Decision]:
        """One bounded move for one knob.  Any exception from a getter
        or setter is contained to this knob's decision: the loop keeps
        governing the others."""
        try:
            prev = float(k.getter())
            sig = self._signal(sources, k)
            mode = k.spec.mode
            if mode == "throughput":
                target, why = self._throughput(k, prev, sig, burns)
            elif mode == "admission":
                target, why = self._admission(k, prev, burns)
            elif mode == "backlog":
                target, why = self._backlog(k, prev, sig)
            elif mode == "overlap":
                target, why = self._overlap(k, prev, sig, sources)
            else:  # pressure
                target, why = self._pressure(k, prev, sources)
            k.last_signal = sig
            if target is None:
                return None
            if target == k.static:
                # the static configured value is the revert point and
                # may legitimately sit outside the declared range (an
                # admission knob's "unlimited" 0) — restoring it is
                # exempt from the clamp, exactly like revert_all
                value, hit = k.coerce(k.static), False
            else:
                value, hit = k.clamp(target)
                value = k.coerce(value)
            if hit:
                why += "@bound"
            if value == prev:
                return None
            applied = k.setter(value)
            if applied is False:
                # the seam refused (e.g. a pipeline window in flight):
                # skip this period's move, try again next period
                return Decision(now, k.spec.name, "held", prev, prev,
                                why + ";seam-busy")
            direction = "grow" if value > prev else "shrink"
            return Decision(now, k.spec.name, direction, prev, value,
                            why)
        except Exception as e:  # noqa: BLE001 - one knob's fault must
            return Decision(now, k.spec.name, "error",  # not stall the
                            0.0, 0.0, f"{type(e).__name__}: {e}")  # loop

    # -- policy modes ------------------------------------------------------

    def _throughput(self, k: Knob, prev: float, sig: Optional[float],
                    burns: Dict[str, float]):
        """Grow while the verify path is cold but backlogged; back off
        toward static when burn goes hot or the signal idles."""
        hot = burns["consensus"] > 1.0 or burns["commit"] > 1.0
        if hot:
            k.idle_periods = 0
            return self._toward(prev, k.static, k.step), "burn-hot"
        rising = (sig is not None and k.last_signal is not None
                  and sig > k.last_signal)
        busy = sig is not None and sig > 0 and (
            rising or k.last_signal is None)
        if busy:
            k.idle_periods = 0
            return prev + k.spec.direction * k.step, "backlog-cold"
        k.idle_periods += 1
        if k.idle_periods >= self.recover_after and prev != k.static:
            return self._toward(prev, k.static, k.step), "idle-recover"
        return None, ""

    def _admission(self, k: Knob, prev: float,
                   burns: Dict[str, float]):
        """AIMD: halve toward lo while block_interval/consensus burn
        exceeds 1.0; additive recovery toward static after
        `recover_after` clean periods."""
        hot = (burns["block_interval"] > 1.0 or burns["consensus"] > 1.0)
        lo, hi = k.safe_range
        if hot:
            k.clean_periods = 0
            if k.static == 0 and not k.engaged:
                # static "unlimited": engage the cap from the top of
                # the declared range, then halve from there
                k.engaged = True
                return hi, "overload-engage"
            base = prev if prev > 0 else hi
            target = max(lo, base * _MD_FACTOR)
            if target >= base:
                return None, ""  # already at (or under) the floor
            return target, "overload-md"
        k.clean_periods += 1
        if k.clean_periods < self.recover_after:
            return None, ""
        if k.static == 0:
            if not k.engaged:
                return None, ""
            if prev >= hi:
                # fully recovered: restore the unlimited static 0
                k.engaged = False
                return k.static, "recovered-static"
            return min(hi, prev + k.step), "recover-ai"
        if prev == k.static:
            return None, ""
        return self._toward(prev, k.static, k.step), "recover-ai"

    def _backlog(self, k: Knob, prev: float, sig: Optional[float]):
        """Grow while the stage queue sits pinned against the current
        depth; shrink toward static after calm periods."""
        pinned = sig is not None and prev > 0 and sig >= _PIN_FRAC * prev
        if pinned:
            k.clean_periods = 0
            return prev + k.spec.direction * k.step, "queue-pinned"
        k.clean_periods += 1
        if k.clean_periods >= self.recover_after and prev != k.static:
            return self._toward(prev, k.static, k.step), "calm-recover"
        return None, ""

    def _overlap(self, k: Knob, prev: float, sig: Optional[float],
                 sources: dict):
        """Shrink the staging chunk (the declared direction) while
        fresh overlapped mesh launches report the transfer/compute
        overlap ratio below target — more, smaller chunks give the
        double buffer more compute to hide H2D behind; recover toward
        static once the ratio is healthy or the path goes idle.
        Freshness tracks the companion "<signal>_seq" launch-sequence
        gauge when the bundle publishes one: the ratio gauge holds its
        last value between launches, so steering on a stale reading
        would walk the knob to the bound on an idle mesh — but a busy
        path repeatedly publishing the SAME (quantized/stable) low
        ratio must still register as fresh, which only a monotonic
        launch counter can distinguish.  Without a seq gauge (older
        bundles, tests with bare sources) a changed value is the
        fallback freshness test."""
        seq = None
        m = sources.get(k.spec.signal + "_seq")
        if m is not None:
            try:
                seq = float(m.value(**k.spec.labels))
            except Exception:  # noqa: BLE001 - unpublished seq gauge
                seq = None
        if seq is not None:
            fresh = (sig is not None and k.last_seq is not None
                     and seq != k.last_seq)
        else:
            fresh = (sig is not None and k.last_signal is not None
                     and sig != k.last_signal)
        k.last_seq = seq
        if fresh and sig < _OVERLAP_TARGET:
            k.clean_periods = 0
            k.idle_periods = 0
            return prev + k.spec.direction * k.step, "overlap-low"
        if fresh:
            k.clean_periods += 1
            k.idle_periods = 0
        else:
            k.idle_periods += 1
        recovered = (k.clean_periods >= self.recover_after
                     or k.idle_periods >= self.recover_after)
        if recovered and prev != k.static:
            k.clean_periods = 0
            k.idle_periods = 0
            return self._toward(prev, k.static, k.step), \
                "overlap-recover"
        return None, ""

    def _pressure(self, k: Knob, prev: float, sources: dict):
        """Demote work (grow the knob) while the HBM pool the signal
        names is pinned at high-water; recover toward static after
        clean periods."""
        resident = self._signal(sources, k)
        peak = None
        m = sources.get("hbm_peak")
        if m is not None:
            try:
                peak = float(m.value(**k.spec.labels))
            except Exception:  # noqa: BLE001 - unpublished pool
                peak = None
        pinned = (resident is not None and peak is not None
                  and peak > 0 and resident >= _PIN_FRAC * peak)
        if pinned:
            k.clean_periods = 0
            return prev + k.spec.direction * k.step, "hbm-pinned"
        k.clean_periods += 1
        if k.clean_periods >= self.recover_after and prev != k.static:
            return self._toward(prev, k.static, k.step), "calm-recover"
        return None, ""

    @staticmethod
    def _toward(v: float, target: float, step: float) -> float:
        if abs(target - v) <= step:
            return target
        return v + step if target > v else v - step

    # -- read side ---------------------------------------------------------

    def _publish_value(self, k: Knob, v: float):
        self._metrics().knob_value.set(v, knob=k.spec.name)

    def report(self) -> dict:
        with self._lock:
            ring = [d.to_dict() for d in self._ring]
            knobs = dict(self._knobs)
            killed = self._killed
            periods = self._periods
            skipped = self._skipped_periods
        values = {}
        for name, k in sorted(knobs.items()):
            try:
                cur = float(k.getter())
            except Exception:  # noqa: BLE001 - a stopped subsystem
                cur = float("nan")
            values[name] = {
                "value": cur, "static": k.static,
                "safe_range": list(k.safe_range), "step": k.step,
                "mode": k.spec.mode, "signal": k.spec.signal,
            }
        return {
            "enabled": enabled(), "running": self.is_running(),
            "killed": killed, "period_s": self.period_s,
            "periods": periods, "skipped_periods": skipped,
            "recover_after": self.recover_after,
            "knobs": values, "decisions": ring,
        }


# ---------------------------------------------------------------------------
# process-global install surface (same convention as crypto/scheduler
# and state/pipeline: the node wires one controller per process)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_controller: Optional[Controller] = None

# the [control] config override: config wins over TM_TPU_CONTROL in
# BOTH directions (mirrors slo.set_config / edops.set_comb_config)
_cfg_enable: Optional[bool] = None


def install(controller: Controller) -> Controller:
    global _controller
    with _global_lock:
        if _controller is not None and _controller.is_running():
            raise RuntimeError("a Controller is already installed and "
                               "running; uninstall it first")
        _controller = controller
    return controller


def installed() -> Optional[Controller]:
    with _global_lock:
        return _controller


def uninstall():
    global _controller
    with _global_lock:
        c, _controller = _controller, None
    if c is not None and c.is_running():
        c.stop()


def running() -> Optional[Controller]:
    c = installed()
    return c if c is not None and c.is_running() else None


def set_config(enable: Optional[bool] = None):
    """Node wiring ([control] section): the operator's config wins over
    a stale TM_TPU_CONTROL env var in BOTH directions.  None clears the
    override (env/default rules apply again)."""
    global _cfg_enable
    _cfg_enable = None if enable is None else bool(enable)


def enabled() -> bool:
    if _cfg_enable is not None:
        return _cfg_enable
    return os.environ.get("TM_TPU_CONTROL", "") == "1"


def kill(reason: str = "operator"):
    """The process-global kill switch: revert every governed knob to
    its static configured value now."""
    c = installed()
    if c is not None:
        c.kill(reason)


def report() -> dict:
    """The /debug/control + debug-control payload."""
    c = installed()
    if c is None:
        return {"enabled": enabled(), "running": False, "killed": None,
                "knobs": {}, "decisions": []}
    return c.report()
