"""Consensus observatory: per-height block-lifecycle decomposition
(docs/adr/adr-020-consensus-observatory.md).

The verify scheduler gives every request a submit->settle decomposition; the
block lifecycle stayed a black box — the only height-level signals
were the cumulative `consensus_block_interval_seconds` /
`round_duration_seconds` histograms, and the NetHarness had to poll
store heights to stitch its per-node timelines.  This module is the
height-level twin of libs/slo.py + the scheduler's latency report: a
bounded ring of per-height lifecycle records, stamped at every stage
of a block's journey from propose to durable, with a computed stage
decomposition answering "where did this block interval go".

Stamps (monotonic seconds, first write wins per stage — a height that
takes multiple rounds keeps its FIRST occurrence of each stage and
`final_round` records that the path wasn't clean):

  new_height        entered NEW_HEIGHT for this height
  propose_start     entered PROPOSE (round recorded; proposer id too)
  proposal_signed   we ARE the proposer: proposal signed + broadcast
  proposal          a valid proposal accepted (ours or a peer's)
  first_part_out    we ARE the proposer: first part handed to gossip
                    (ADR-024 streaming split — availability of part 0,
                    not completion of the split; proposal_signed's
                    reap/prepare/assemble/split info attrs carry the
                    full propose decomposition)
  first_part        first block part landed in the part set
  parts_complete    the proposal block fully assembled
  prevote_any       2/3-any prevote power seen this round
  prevote_quorum    2/3-block prevote quorum (the polka)
  precommit_quorum  2/3-block precommit quorum
  commit            entered COMMIT
  apply_start       ABCI apply began (state/execution.py)
  apply_done        ABCI apply returned
  durable           group-commit ack (state/pipeline.py writer; only
                    stamped on the pipelined catch-up path — the
                    consensus path's block save is synchronous inside
                    the commit stage)

Derived stages (publish_pending() feeds them to the
`consensus_height_stage_seconds{stage}` histogram and the [slo]
streams block_interval / propose / quorum_prevote / apply):

  propose        new_height      -> proposal
  gossip         proposal        -> parts_complete
  prevote_wait   parts_complete  -> prevote_quorum
  precommit_wait prevote_quorum  -> precommit_quorum
  commit         precommit_quorum-> apply_start   (incl. block save)
  apply          apply_start     -> apply_done
  persist        apply_done      -> durable       (pipelined path)
  interval       previous height's commit -> this height's commit

Design constraints, in trace.py's order:

  1. Disabled is a guaranteed no-op (TM_TPU_OBSERVATORY=0; the module
     functions check the enabled flag FIRST — tests timeit-gate the
     disabled call below a microsecond).  Unlike trace/slo it is ON by
     default: a handful of dict stores per height is noise against a
     block interval, and the ROADMAP wants block-interval p99 to be a
     tracked number, not an opt-in.
  2. Bounded memory: one OrderedDict ring per node name (multi-node
     in-process harnesses share the module global, keyed by moniker),
     default 128 heights, oldest evicted first; per-peer receipt maps
     are capped.  Evictions and chaos sheds count in
     `consensus_observatory_shed_total{reason}`.
  3. Recording never publishes.  stamp()/receipt() take ONE leaf lock
     (lockorder rank 74), store, and return — metrics/SLO publication
     for completed heights is deferred to publish_pending(), which the
     consensus receive routine calls AFTER releasing its state lock
     and the pipeline writer calls holding nothing (the discipline
     the scheduler keeps too).  The chaos seam
     `observatory.record` proves a recording fault sheds the record
     while consensus proceeds untouched.

Read it back via report() / skew_report(), GET /debug/consensus on the
pprof listener, or the `debug-consensus` CLI.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs import fail

_DEFAULT_CAPACITY = 128

# per-record bound on the per-peer receipt maps: peers are bounded by
# the validator set in practice, but peer ids are remote-controlled
# strings, so the map must have a hard cap
_MAX_PEERS = 128

# bound on the deferred-publication queue: a serial blocksync catch-up
# stamps apply_done per height and drains per height too (_apply_one),
# but if every drainer is somehow absent the queue must still be
# bounded — oldest entries drop (counted as evict) rather than grow
_MAX_PENDING = 4096

# stage vocabulary: every stamp() stage must be one of these (a typo'd
# stage would silently record nothing anyone reads; same reasoning as
# trace.KNOWN_SPANS / fail.REGISTERED_SITES)
KNOWN_STAMPS = frozenset({
    "new_height", "propose_start", "proposal_signed", "proposal",
    "first_part", "first_part_out", "parts_complete", "prevote_any",
    "prevote_quorum", "precommit_quorum", "commit", "apply_start",
    "apply_done", "durable",
})

# (stage, start stamp, end stamp) — the decomposition table, in
# lifecycle order.  A stage whose endpoints are missing is None in the
# report and simply not observed into the histogram.
STAGES = (
    ("propose", "new_height", "proposal"),
    ("gossip", "proposal", "parts_complete"),
    ("prevote_wait", "parts_complete", "prevote_quorum"),
    ("precommit_wait", "prevote_quorum", "precommit_quorum"),
    ("commit", "precommit_quorum", "apply_start"),
    ("apply", "apply_start", "apply_done"),
    ("persist", "apply_done", "durable"),
)

# stage -> [slo] stream for the streams the config can set targets on
_SLO_STREAMS = {
    "propose": "propose",
    "prevote_wait": "quorum_prevote",
    "apply": "apply",
}


class HeightRecord:
    """One height's lifecycle on one node.  Mutated only under the
    observatory lock; reader methods take copies."""

    __slots__ = ("height", "wall0", "stamps", "final_round", "proposer",
                 "parts_from", "votes_from", "useful_from",
                 "first_useful", "info", "published",
                 "persist_published")

    def __init__(self, height: int):
        self.height = height
        self.wall0 = time.time()      # wall anchor for cross-host reads
        self.stamps: Dict[str, float] = {}
        self.final_round = 0
        self.proposer: Optional[str] = None
        self.parts_from: Dict[str, int] = {}
        self.votes_from: Dict[str, int] = {}
        # the gossip observatory's join (ADR-025): receipts the state
        # machine judged USEFUL, per peer — parts_from/votes_from above
        # count every delivery, so useful/total is this height's
        # duplicate-waste split per peer
        self.useful_from: Dict[str, Dict[str, int]] = {}
        # kind -> the peer whose delivery was useful FIRST this height
        self.first_useful: Dict[str, str] = {}
        self.info: Dict[str, float] = {}
        self.published = False
        self.persist_published = False

    def stage_seconds(self) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {}
        st = self.stamps
        for stage, a, b in STAGES:
            t0, t1 = st.get(a), st.get(b)
            out[stage] = max(t1 - t0, 0.0) \
                if t0 is not None and t1 is not None else None
        return out

    def as_dict(self) -> dict:
        return {
            "height": self.height,
            "final_round": self.final_round,
            "proposer": self.proposer,
            "wall0": self.wall0,
            "stamps": dict(self.stamps),
            "stages": self.stage_seconds(),
            "parts_from": dict(self.parts_from),
            "votes_from": dict(self.votes_from),
            "useful_from": {k: dict(v)
                            for k, v in self.useful_from.items()},
            "first_useful": dict(self.first_useful),
            "info": dict(self.info),
        }


class Observatory:
    """See the module docstring.  One process-global instance (the
    module-level functions); tests may build private instances."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("TM_TPU_OBSERVATORY", "") != "0"
        if capacity is None:
            # malformed env falls back: this module is imported by the
            # consensus hot path, a bad env var must never stop a node
            try:
                capacity = int(os.environ.get("TM_TPU_OBS_CAPACITY",
                                              _DEFAULT_CAPACITY))
            except (ValueError, TypeError):
                capacity = _DEFAULT_CAPACITY
        self.capacity = max(1, int(capacity))
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        # node name -> height -> record (insertion order ~ height order)
        self._nodes: Dict[str, "collections.OrderedDict[int, HeightRecord]"] \
            = {}
        self._last_commit_t: Dict[str, float] = {}
        self._pending: List[tuple] = []    # (node, height, kind)
        self._shed = {"chaos": 0, "evict": 0}
        self._metrics = None               # lazy ConsensusMetrics

    # -- state -------------------------------------------------------------

    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def reset(self):
        with self._lock:
            self._nodes.clear()
            self._last_commit_t.clear()
            self._pending.clear()
            self._shed = {"chaos": 0, "evict": 0}

    def shed_counts(self) -> dict:
        with self._lock:
            return dict(self._shed)

    # -- the hot path ------------------------------------------------------

    def _record_locked(self, node: str, height: int,
                       create: bool) -> Optional[HeightRecord]:
        ring = self._nodes.get(node)
        if ring is None:
            if not create:
                return None
            ring = self._nodes[node] = collections.OrderedDict()
        rec = ring.get(height)
        if rec is None:
            if not create:
                return None
            rec = ring[height] = HeightRecord(height)
            while len(ring) > self.capacity:
                ring.popitem(last=False)
                self._shed["evict"] += 1
        return rec

    def stamp(self, node: str, height: int, stage: str,
              round_: Optional[int] = None, t: Optional[float] = None,
              **info) -> bool:
        """Record one lifecycle stamp.  First write per stage wins;
        returns True only when the stage was NEWLY recorded (callers
        gate one-shot side effects like trace markers on it).
        Guaranteed no-op when disabled; a chaos fault at
        `observatory.record` (or any internal error) sheds the stamp —
        recording must never take down consensus."""
        if not self._enabled:
            return False
        assert stage in KNOWN_STAMPS, stage
        try:
            fail.inject("observatory.record")
            if t is None:
                t = time.monotonic()
            fresh = False
            with self._lock:
                rec = self._record_locked(node, height, create=True)
                if round_ is not None and round_ > rec.final_round:
                    rec.final_round = round_
                if stage not in rec.stamps:
                    fresh = True
                    rec.stamps[stage] = t
                    if stage == "commit":
                        prev = self._last_commit_t.get(node)
                        self._last_commit_t[node] = t
                        if prev is not None:
                            rec.info["interval_s"] = max(t - prev, 0.0)
                    if stage in ("apply_done", "durable"):
                        if len(self._pending) >= _MAX_PENDING:
                            self._pending.pop(0)
                            self._shed["evict"] += 1
                        self._pending.append((node, height, stage))
                for k, v in info.items():
                    if k in ("proposer", "proposal_ts",
                             "proposal_round"):
                        # latest round's proposer/proposal win: the
                        # quorum-delay origin is the proposal of the
                        # round that actually polka'd (reference
                        # QuorumPrevoteDelay), and proposal_round lets
                        # publication refuse a cross-round pairing
                        if k == "proposer":
                            rec.proposer = v
                        else:
                            rec.info[k] = v
                    elif k not in rec.info:
                        rec.info[k] = v
            return fresh
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1
            return False

    def receipt(self, node: str, height: int, kind: str, peer: str):
        """Per-peer block-part/vote receipt accounting (the reactor's
        receive seam).  Updates EXISTING records only: heights are
        peer-controlled here, and letting a peer mint records would let
        it wash the ring (the node's own new_height stamp is the only
        record creator on the gossip path)."""
        if not self._enabled:
            return
        try:
            fail.inject("observatory.record")
            with self._lock:
                rec = self._record_locked(node, height, create=False)
                if rec is None:
                    return
                m = rec.parts_from if kind == "part" else rec.votes_from
                if peer in m:
                    m[peer] += 1
                elif len(m) < _MAX_PEERS:
                    m[peer] = 1
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    def useful_receipt(self, node: str, height: int, kind: str,
                       peer: str):
        """The consensus state machine's verdict side of the gossip
        observatory join (ADR-025): a part/vote receipt that actually
        ADVANCED this height, per peer — against receipt()'s
        every-delivery totals this is the per-height duplicate-waste
        split, and the first useful peer per kind is the
        first-useful-delivery attribution.  Same update-existing-only
        and peer-cap rules as receipt()."""
        if not self._enabled:
            return
        try:
            fail.inject("observatory.record")
            with self._lock:
                rec = self._record_locked(node, height, create=False)
                if rec is None:
                    return
                rec.first_useful.setdefault(kind, peer)
                m = rec.useful_from.setdefault(kind, {})
                if peer in m:
                    m[peer] += 1
                elif len(m) < _MAX_PEERS:
                    m[peer] = 1
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    # -- deferred publication (never called under a consensus lock) --------

    def _bundle(self):
        if self._metrics is None:
            from tendermint_tpu_torch.libs.metrics import ConsensusMetrics
            self._metrics = ConsensusMetrics()
        return self._metrics

    def publish_pending(self):
        """Publish stage histograms, [slo] streams and the
        quorum-prevote gauge for heights completed since the last call.
        Callers hold NO consensus-critical lock (the receive routine
        calls after releasing its state mutex; the pipeline writer
        holds nothing) — this is the hoist the scheduler's fix
        established."""
        if not self._enabled:
            return
        try:
            self._publish_pending()
        except Exception:  # noqa: BLE001 - same contract as stamp():
            # a publication fault sheds; it must never escalate to
            # CONSENSUS FAILURE in the receive loop, kill a catch-up
            # apply, or wedge the pipeline writer
            try:
                with self._lock:
                    self._shed["chaos"] += 1
            except Exception:  # noqa: BLE001
                pass

    def _publish_pending(self):
        with self._lock:
            pending, self._pending = self._pending, []
            shed, self._shed = self._shed, {"chaos": 0, "evict": 0}
            work = []
            for node, height, kind in pending:
                rec = self._record_locked(node, height, create=False)
                if rec is None:
                    continue
                if kind == "apply_done" and not rec.published:
                    rec.published = True
                    work.append(("full", rec.as_dict()))
                elif kind == "durable" and not rec.persist_published:
                    rec.persist_published = True
                    work.append(("persist", rec.as_dict()))
        # shed counts flush even when no height completed: chaos on a
        # stalled node must not park the counter at zero forever
        if not work and not any(shed.values()):
            return
        from tendermint_tpu_torch.libs import slo
        m = self._bundle()
        for reason, n in shed.items():
            if n:
                m.observatory_shed.inc(n, reason=reason)
        for kind, rd in work:
            stages = rd["stages"]
            if kind == "persist":
                if stages.get("persist") is not None:
                    m.height_stage.observe(stages["persist"],
                                           stage="persist")
                continue
            for stage, secs in stages.items():
                if secs is None or stage == "persist":
                    continue
                m.height_stage.observe(secs, stage=stage)
                stream = _SLO_STREAMS.get(stage)
                if stream is not None:
                    slo.observe(stream, secs)
            interval = rd["info"].get("interval_s")
            if interval is not None:
                m.height_stage.observe(interval, stage="interval")
                slo.observe("block_interval", interval)
            # satellite 1 (reference parity): QuorumPrevoteDelay =
            # proposal timestamp -> the timestamp of the prevote that
            # completed the 2/3 quorum, both wall-clock from the votes
            # themselves (not our monotonic stamps).  Only published
            # when both sides belong to the SAME round: the quorum
            # stamp is first-write-wins while the proposal origin
            # follows the latest round, and pairing a round-0 polka
            # with a round-1 proposal would report a bogus (clamped)
            # delay for exactly the slow heights that matter
            pts = rd["info"].get("proposal_ts")
            qts = rd["info"].get("prevote_quorum_ts")
            if pts is not None and qts is not None and \
                    rd["info"].get("proposal_round") == \
                    rd["info"].get("prevote_quorum_round"):
                m.quorum_prevote_delay.set(max(qts - pts, 0.0))

    # -- read side ---------------------------------------------------------

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def records(self, node: str, last: int = 0) -> List[dict]:
        """The node's newest `last` records (0 = all), oldest first.
        Dicts are copied under the lock — the ring keeps mutating."""
        with self._lock:
            ring = self._nodes.get(node)
            recs = list(ring.values()) if ring else []
            if last > 0:
                recs = recs[-last:]
            return [r.as_dict() for r in recs]

    def report(self, node: Optional[str] = None, last: int = 16) -> dict:
        names = [node] if node is not None else self.nodes()
        return {
            "enabled": self._enabled,
            "capacity": self.capacity,
            "shed": self.shed_counts(),
            "nodes": {n: self.records(n, last=last) for n in names},
        }

    def skew_report(self, stages=("proposal", "parts_complete",
                                  "prevote_quorum", "commit")) -> dict:
        """Cross-node skew: for every height at least two nodes
        recorded, the spread (max-min, seconds) of each stage's stamp
        across nodes plus each node's offset from the earliest.  Only
        meaningful for nodes sharing a clock (the in-process harness;
        all stamps are one time.monotonic())."""
        with self._lock:
            by_height: Dict[int, Dict[str, HeightRecord]] = {}
            for name, ring in self._nodes.items():
                for h, rec in ring.items():
                    by_height.setdefault(h, {})[name] = rec
            snapshot = {
                h: {n: dict(r.stamps) for n, r in nodes.items()}
                for h, nodes in by_height.items() if len(nodes) >= 2}
        heights = {}
        for h in sorted(snapshot):
            row = {}
            for stage in stages:
                ts = {n: st[stage] for n, st in snapshot[h].items()
                      if stage in st}
                if len(ts) < 2:
                    continue
                t0 = min(ts.values())
                row[stage] = {
                    "spread_s": round(max(ts.values()) - t0, 6),
                    "offsets_s": {n: round(t - t0, 6)
                                  for n, t in sorted(ts.items())},
                }
            if row:
                heights[h] = row
        out = {"heights": heights}
        if heights:
            for stage in stages:
                spreads = [row[stage]["spread_s"]
                           for row in heights.values() if stage in row]
                if spreads:
                    out.setdefault("max_spread_s", {})[stage] = \
                        max(spreads)
        return out


# ---------------------------------------------------------------------------
# the process-global observatory (same convention as trace.TRACER,
# slo.EST, metrics.DEFAULT); multi-node in-process harnesses share it,
# keyed by node moniker
# ---------------------------------------------------------------------------

OBS = Observatory()


def stamp(node: str, height: int, stage: str,
          round_: Optional[int] = None, t: Optional[float] = None,
          **info) -> bool:
    o = OBS
    if not o._enabled:  # the sub-microsecond disabled path
        return False
    return o.stamp(node, height, stage, round_=round_, t=t, **info)


def receipt(node: str, height: int, kind: str, peer: str):
    o = OBS
    if not o._enabled:
        return
    o.receipt(node, height, kind, peer)


def useful_receipt(node: str, height: int, kind: str, peer: str):
    o = OBS
    if not o._enabled:
        return
    o.useful_receipt(node, height, kind, peer)


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


def report(node: Optional[str] = None, last: int = 16) -> dict:
    return OBS.report(node=node, last=last)


def records(node: str, last: int = 0) -> List[dict]:
    return OBS.records(node, last=last)


def skew_report(**kw) -> dict:
    return OBS.skew_report(**kw)
