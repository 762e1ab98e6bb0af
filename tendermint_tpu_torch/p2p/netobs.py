"""Gossip observatory: per-(node, peer, channel) flow telemetry
(docs/adr/adr-025-gossip-observatory.md).

PR 12's consensus observatory decomposes each height into stages and
PR 13's device observatory decomposes each launch, but the gossip
stage itself stayed one opaque number — nobody could say WHICH peer,
WHICH channel, or WHICH link is why the block-interval SLO burns, and
the WAN LinkPolicy profiles have no per-link telemetry to pin against.
This module is the p2p-plane twin of consensus/observatory.py: a
process-global, bounded table of per-(node, peer, channel) flow
records, fed at BOTH transport seams —

  p2p/connection.py  MConnection send/recv/ping routines (TCP path)
  networks/vnet.py   VirtualNetwork submit/dispatch (harness path)

— decomposing each peer's flow into queue-wait (enqueue -> wire, per
channel priority), serialize/send wall, flowrate-limiter stall time
(the Monitor sleep was silent before this PR), recv dispatch wall, and
per-peer RTT from the ping/pong exchange.  On top of the byte ledger
sits duplicate-waste accounting for consensus gossip: useful vs
duplicate block-part/vote receipts per peer (the consensus state's
add_part/add_vote verdicts), which joins consensus/observatory.py's
per-height receipt() maps so first-useful-delivery attribution per
height falls out.

Design constraints, in trace.py's order (the house discipline):

  1. Disabled is a guaranteed no-op (TM_TPU_NETOBS=0; the module
     functions check the enabled flag FIRST — tests timeit-gate the
     disabled call below a microsecond).  Like the consensus
     observatory it is ON by default: a handful of slot stores per
     frame is noise against a frame's serialization, and the ROADMAP's
     WAN thrust needs per-link numbers by default, not opt-in.
  2. Bounded memory: one OrderedDict of peers per node name
     (multi-node in-process harnesses share the module global, keyed
     by moniker/vnet address), capped at the consensus observatory's
     128-peer bound, oldest peer evicted first; per-peer channel maps
     and the deferred sample queues are capped too.  Evictions and
     chaos sheds count in `p2p_netobs_shed_total{reason}`.
  3. Recording never publishes.  Every recorder takes ONE leaf lock
     (lockorder rank 73), stores, and returns — metrics/SLO
     publication is deferred to publish_pending(), which the consensus
     receive routine calls AFTER releasing its state mutex and the
     debug endpoints call holding nothing.  The chaos seam
     `netobs.record` proves a recording fault sheds the sample while
     delivery proceeds untouched.

Read it back via report()/flow_table(), GET /debug/net on the pprof
listener, or the `debug-net` CLI; the NetHarness failure artifact
JOINs flow_table() with the vnet LinkPolicy matrix and the skew report
into a per-link gossip table (the WAN-attribution deliverable).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs import fail

# per-node bound on the peer table: peer ids are remote-controlled
# strings, so the map must have a hard cap (consensus observatory
# parity — the same 128 bound keeps metric label cardinality sane)
_MAX_PEERS = 128

# per-peer bound on the channel map: channel ids come from the local
# reactor set in practice, but the vnet FIN/ping control ids and any
# future descriptor growth must not let the map creep
_MAX_CHANNELS = 32

# bound on the deferred sample queues (queue-wait histogram samples,
# gossip SLO latencies): if every drainer is somehow absent the queues
# must still be bounded — oldest entries drop (counted as evict)
_MAX_SAMPLES = 4096

_GOSSIP_KINDS = ("part", "vote")


class ChanFlow:
    """One channel's ledger on one (node, peer) link.  Mutated only
    under the observatory lock."""

    __slots__ = ("sent_bytes", "sent_msgs", "recv_bytes", "recv_msgs",
                 "queue_wait_s", "queue_wait_max_s", "send_wall_s",
                 "recv_wall_s", "depth", "pub_sent", "pub_recv")

    def __init__(self):
        self.sent_bytes = 0
        self.sent_msgs = 0
        self.recv_bytes = 0
        self.recv_msgs = 0
        self.queue_wait_s = 0.0
        self.queue_wait_max_s = 0.0
        self.send_wall_s = 0.0
        self.recv_wall_s = 0.0
        self.depth = 0           # last observed send-queue depth
        self.pub_sent = 0        # byte watermarks for counter deltas
        self.pub_recv = 0

    def as_dict(self) -> dict:
        return {
            "sent_bytes": self.sent_bytes,
            "sent_msgs": self.sent_msgs,
            "recv_bytes": self.recv_bytes,
            "recv_msgs": self.recv_msgs,
            "queue_wait_s": round(self.queue_wait_s, 6),
            "queue_wait_max_s": round(self.queue_wait_max_s, 6),
            "send_wall_s": round(self.send_wall_s, 6),
            "recv_wall_s": round(self.recv_wall_s, 6),
            "depth": self.depth,
        }


class PeerFlow:
    """One peer's ledger on one node: per-channel flows plus the
    peer-level decomposition (stall, rate, rtt, duplicate waste)."""

    __slots__ = ("chans", "stall_send_s", "stall_recv_s",
                 "rate_send_bps", "rate_recv_bps",
                 "rtt_last_s", "rtt_sum_s", "rtt_min_s", "rtt_max_s",
                 "rtt_n", "useful_parts", "dup_parts", "useful_votes",
                 "dup_votes", "pub_sent", "pub_recv", "pub_stall_send",
                 "pub_stall_recv", "pub_gossip")

    def __init__(self):
        self.chans: Dict[int, ChanFlow] = {}
        self.stall_send_s = 0.0
        self.stall_recv_s = 0.0
        self.rate_send_bps = 0.0
        self.rate_recv_bps = 0.0
        self.rtt_last_s: Optional[float] = None
        self.rtt_sum_s = 0.0
        self.rtt_min_s: Optional[float] = None
        self.rtt_max_s: Optional[float] = None
        self.rtt_n = 0
        self.useful_parts = 0
        self.dup_parts = 0
        self.useful_votes = 0
        self.dup_votes = 0
        self.pub_sent = 0
        self.pub_recv = 0
        self.pub_stall_send = 0.0
        self.pub_stall_recv = 0.0
        self.pub_gossip = (0, 0, 0, 0)  # useful/dup parts, useful/dup votes

    def totals(self) -> tuple:
        sent = recv = 0
        for cf in self.chans.values():
            sent += cf.sent_bytes
            recv += cf.recv_bytes
        return sent, recv

    def as_dict(self) -> dict:
        sent, recv = self.totals()
        return {
            "sent_bytes": sent,
            "recv_bytes": recv,
            "channels": {cid: cf.as_dict()
                         for cid, cf in sorted(self.chans.items())},
            "stall_send_s": round(self.stall_send_s, 6),
            "stall_recv_s": round(self.stall_recv_s, 6),
            "rate_send_bps": round(self.rate_send_bps, 1),
            "rate_recv_bps": round(self.rate_recv_bps, 1),
            "rtt": None if self.rtt_n == 0 else {
                "last_s": round(self.rtt_last_s, 6),
                "mean_s": round(self.rtt_sum_s / self.rtt_n, 6),
                "min_s": round(self.rtt_min_s, 6),
                "max_s": round(self.rtt_max_s, 6),
                "n": self.rtt_n,
            },
            "useful_parts": self.useful_parts,
            "dup_parts": self.dup_parts,
            "useful_votes": self.useful_votes,
            "dup_votes": self.dup_votes,
        }


class NetObs:
    """See the module docstring.  One process-global instance (the
    module-level functions); tests may build private instances."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("TM_TPU_NETOBS", "") != "0"
        self._enabled = bool(enabled)
        self._lock = threading.Lock()   # leaf, lockorder rank 73
        # node name -> peer -> flow (insertion order ~ first-seen)
        self._nodes: Dict[str, "collections.OrderedDict[str, PeerFlow]"] \
            = {}
        self._qw_samples: List[tuple] = []      # (ch_id, seconds)
        self._gossip_lat: List[float] = []      # useful-part latencies
        self._shed = {"chaos": 0, "evict": 0}
        self._metrics = None                    # lazy P2PMetrics
        self._last_pub = 0.0

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
            self._qw_samples.clear()
            self._gossip_lat.clear()
            self._shed = {"chaos": 0, "evict": 0}
            self._last_pub = 0.0

    def shed_counts(self) -> dict:
        with self._lock:
            return dict(self._shed)

    # -- the hot path ------------------------------------------------------

    def _peer_locked(self, node: str, peer: str) -> PeerFlow:
        ring = self._nodes.get(node)
        if ring is None:
            ring = self._nodes[node] = collections.OrderedDict()
        pf = ring.get(peer)
        if pf is None:
            pf = ring[peer] = PeerFlow()
            while len(ring) > _MAX_PEERS:
                ring.popitem(last=False)
                self._shed["evict"] += 1
        return pf

    def _chan_locked(self, pf: PeerFlow, ch_id: int) -> Optional[ChanFlow]:
        cf = pf.chans.get(ch_id)
        if cf is None:
            if len(pf.chans) >= _MAX_CHANNELS:
                self._shed["evict"] += 1
                return None
            cf = pf.chans[ch_id] = ChanFlow()
        return cf

    def _sample_locked(self, buf: List, item):
        if len(buf) >= _MAX_SAMPLES:
            buf.pop(0)
            self._shed["evict"] += 1
        buf.append(item)

    def sent(self, node: str, peer: str, ch_id: int, nbytes: int,
             queue_wait_s: Optional[float] = None,
             wall_s: Optional[float] = None,
             stall_s: Optional[float] = None,
             depth: Optional[int] = None):
        """Record one frame handed to the wire (or swallowed by a
        faulty link — the sender's ledger counts what it PUT on the
        link, which is exactly what a TCP sender believes).  Guaranteed
        no-op when disabled; a chaos fault at `netobs.record` (or any
        internal error) sheds the sample — recording must never take
        down delivery."""
        if not self._enabled:
            return
        try:
            fail.inject("netobs.record")
            with self._lock:
                pf = self._peer_locked(node, peer)
                cf = self._chan_locked(pf, ch_id)
                if cf is None:
                    return
                cf.sent_bytes += nbytes
                cf.sent_msgs += 1
                if queue_wait_s is not None:
                    qw = max(queue_wait_s, 0.0)
                    cf.queue_wait_s += qw
                    if qw > cf.queue_wait_max_s:
                        cf.queue_wait_max_s = qw
                    self._sample_locked(self._qw_samples, (ch_id, qw))
                if wall_s is not None:
                    cf.send_wall_s += max(wall_s, 0.0)
                if stall_s:
                    pf.stall_send_s += max(stall_s, 0.0)
                if depth is not None:
                    cf.depth = depth
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    def recv(self, node: str, peer: str, ch_id: int, nbytes: int,
             wall_s: Optional[float] = None,
             stall_s: Optional[float] = None):
        """Record one frame dispatched to the node's on_receive."""
        if not self._enabled:
            return
        try:
            fail.inject("netobs.record")
            with self._lock:
                pf = self._peer_locked(node, peer)
                cf = self._chan_locked(pf, ch_id)
                if cf is None:
                    return
                cf.recv_bytes += nbytes
                cf.recv_msgs += 1
                if wall_s is not None:
                    cf.recv_wall_s += max(wall_s, 0.0)
                if stall_s:
                    pf.stall_recv_s += max(stall_s, 0.0)
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    def rtt(self, node: str, peer: str, rtt_s: float):
        """Record one round-trip sample (MConnection ping->pong, or the
        vnet's control-plane pinger)."""
        if not self._enabled:
            return
        try:
            fail.inject("netobs.record")
            rtt_s = max(float(rtt_s), 0.0)
            with self._lock:
                pf = self._peer_locked(node, peer)
                pf.rtt_last_s = rtt_s
                pf.rtt_sum_s += rtt_s
                pf.rtt_n += 1
                if pf.rtt_min_s is None or rtt_s < pf.rtt_min_s:
                    pf.rtt_min_s = rtt_s
                if pf.rtt_max_s is None or rtt_s > pf.rtt_max_s:
                    pf.rtt_max_s = rtt_s
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    def flow_rate(self, node: str, peer: str,
                  send_bps: Optional[float] = None,
                  recv_bps: Optional[float] = None):
        """Record the flowrate Monitor's EMA rates (satellite: a
        bandwidth-capped link becomes visible instead of inferred)."""
        if not self._enabled:
            return
        try:
            fail.inject("netobs.record")
            with self._lock:
                pf = self._peer_locked(node, peer)
                if send_bps is not None:
                    pf.rate_send_bps = float(send_bps)
                if recv_bps is not None:
                    pf.rate_recv_bps = float(recv_bps)
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    def gossip_receipt(self, node: str, peer: str, kind: str,
                       useful: bool, latency_s: Optional[float] = None):
        """Duplicate-waste accounting at the consensus add_part /
        add_vote verdicts: `useful` is the state machine's "this
        receipt advanced the height" bit; latency (useful block parts
        only) feeds the [slo] gossip stream."""
        if not self._enabled:
            return
        assert kind in _GOSSIP_KINDS, kind
        try:
            fail.inject("netobs.record")
            with self._lock:
                pf = self._peer_locked(node, peer)
                if kind == "part":
                    if useful:
                        pf.useful_parts += 1
                    else:
                        pf.dup_parts += 1
                else:
                    if useful:
                        pf.useful_votes += 1
                    else:
                        pf.dup_votes += 1
                if useful and latency_s is not None and latency_s >= 0:
                    self._sample_locked(self._gossip_lat, latency_s)
        except Exception:  # noqa: BLE001 - shed, never propagate
            with self._lock:
                self._shed["chaos"] += 1

    # -- deferred publication (never called under a consensus lock) --------

    def _bundle(self):
        if self._metrics is None:
            from tendermint_tpu_torch.libs.metrics import P2PMetrics
            self._metrics = P2PMetrics()
        return self._metrics

    def publish_pending(self, min_interval_s: float = 0.0):
        """Drain byte/stall/gossip deltas into the P2PMetrics bundle
        and the [slo] gossip stream.  Callers hold NO delivery-critical
        lock (the consensus receive routine calls after releasing its
        state mutex, with a min interval so the drain amortizes; debug
        endpoints call with 0).  Same shed contract as recording: a
        publication fault must never escalate."""
        if not self._enabled:
            return
        if min_interval_s > 0.0 and \
                time.monotonic() - self._last_pub < min_interval_s:
            return
        try:
            self._publish_pending()
        except Exception:  # noqa: BLE001 - shed, never propagate
            try:
                with self._lock:
                    self._shed["chaos"] += 1
            except Exception:  # noqa: BLE001
                pass

    def _publish_pending(self):
        now = time.monotonic()
        with self._lock:
            shed, self._shed = self._shed, {"chaos": 0, "evict": 0}
            qw, self._qw_samples = self._qw_samples, []
            lats, self._gossip_lat = self._gossip_lat, []
            elapsed = now - self._last_pub if self._last_pub else 0.0
            self._last_pub = now
            ch_sent: Dict[int, int] = {}
            ch_recv: Dict[int, int] = {}
            ch_depth: Dict[int, int] = {}
            rows = []
            gossip_delta = {("part", "useful"): 0, ("part", "duplicate"): 0,
                            ("vote", "useful"): 0, ("vote", "duplicate"): 0}
            for ring in self._nodes.values():
                for peer, pf in ring.items():
                    sent, recv = pf.totals()
                    d_sent, d_recv = sent - pf.pub_sent, recv - pf.pub_recv
                    pf.pub_sent, pf.pub_recv = sent, recv
                    for cid, cf in pf.chans.items():
                        ch_sent[cid] = ch_sent.get(cid, 0) \
                            + cf.sent_bytes - cf.pub_sent
                        ch_recv[cid] = ch_recv.get(cid, 0) \
                            + cf.recv_bytes - cf.pub_recv
                        cf.pub_sent, cf.pub_recv = \
                            cf.sent_bytes, cf.recv_bytes
                        if cf.depth > ch_depth.get(cid, 0):
                            ch_depth[cid] = cf.depth
                    d_stall_s = pf.stall_send_s - pf.pub_stall_send
                    d_stall_r = pf.stall_recv_s - pf.pub_stall_recv
                    pf.pub_stall_send = pf.stall_send_s
                    pf.pub_stall_recv = pf.stall_recv_s
                    g = (pf.useful_parts, pf.dup_parts,
                         pf.useful_votes, pf.dup_votes)
                    g0 = pf.pub_gossip
                    pf.pub_gossip = g
                    gossip_delta[("part", "useful")] += g[0] - g0[0]
                    gossip_delta[("part", "duplicate")] += g[1] - g0[1]
                    gossip_delta[("vote", "useful")] += g[2] - g0[2]
                    gossip_delta[("vote", "duplicate")] += g[3] - g0[3]
                    rows.append((peer, d_sent, d_recv, d_stall_s,
                                 d_stall_r, pf.rate_send_bps,
                                 pf.rate_recv_bps, pf.rtt_last_s))
        from tendermint_tpu_torch.libs import slo, trace
        m = self._bundle()
        with trace.span("netobs.drain", peers=len(rows),
                        samples=len(qw) + len(lats)):
            for reason, n in shed.items():
                if n:
                    m.netobs_shed.inc(n, reason=reason)
            for cid, n in sorted(ch_sent.items()):
                if n:
                    m.bytes_sent.inc(n, ch_id=f"{cid:#x}")
            for cid, n in sorted(ch_recv.items()):
                if n:
                    m.bytes_recv.inc(n, ch_id=f"{cid:#x}")
            for cid, d in sorted(ch_depth.items()):
                m.queue_depth.set(d, ch_id=f"{cid:#x}")
            for cid, secs in qw:
                m.queue_wait.observe(secs, ch_id=f"{cid:#x}")
            for (peer, d_sent, d_recv, d_stall_s, d_stall_r,
                 rate_s, rate_r, rtt_last) in rows:
                if elapsed > 0.0:
                    m.peer_flow.set(d_sent / elapsed, peer=peer,
                                    direction="send")
                    m.peer_flow.set(d_recv / elapsed, peer=peer,
                                    direction="recv")
                if d_stall_s:
                    m.throttle_stall.inc(d_stall_s, direction="send")
                if d_stall_r:
                    m.throttle_stall.inc(d_stall_r, direction="recv")
                m.flow_rate.set(rate_s, peer=peer, direction="send")
                m.flow_rate.set(rate_r, peer=peer, direction="recv")
                if rtt_last is not None:
                    m.peer_rtt.set(rtt_last, peer=peer)
            for (kind, outcome), n in gossip_delta.items():
                if n:
                    m.gossip_receipts.inc(n, kind=kind, outcome=outcome)
            for secs in lats:
                slo.observe("gossip", secs)

    # -- read side ---------------------------------------------------------

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def flow_table(self, node: Optional[str] = None) -> dict:
        """{node: {peer: flow dict}} — the JOIN surface for /debug/net,
        the harness artifact and the tests.  Copied under the lock; the
        table keeps mutating."""
        with self._lock:
            names = [node] if node is not None else sorted(self._nodes)
            return {n: {p: pf.as_dict()
                        for p, pf in self._nodes.get(n, {}).items()}
                    for n in names}

    def report(self, node: Optional[str] = None) -> dict:
        table = self.flow_table(node)
        total_sent = total_recv = dup = useful = 0
        for peers in table.values():
            for row in peers.values():
                total_sent += row["sent_bytes"]
                total_recv += row["recv_bytes"]
                useful += row["useful_parts"] + row["useful_votes"]
                dup += row["dup_parts"] + row["dup_votes"]
        return {
            "enabled": self._enabled,
            "shed": self.shed_counts(),
            "totals": {
                "sent_bytes": total_sent,
                "recv_bytes": total_recv,
                "useful_receipts": useful,
                "duplicate_receipts": dup,
                "duplicate_ratio": round(dup / (useful + dup), 4)
                if useful + dup else 0.0,
            },
            "nodes": table,
        }


# ---------------------------------------------------------------------------
# the process-global observatory (same convention as observatory.OBS,
# trace.TRACER, slo.EST); multi-node in-process harnesses share it,
# keyed by node moniker (TCP path) or vnet address (vnet path)
# ---------------------------------------------------------------------------

NOBS = NetObs()


def sent(node: str, peer: str, ch_id: int, nbytes: int,
         queue_wait_s: Optional[float] = None,
         wall_s: Optional[float] = None,
         stall_s: Optional[float] = None,
         depth: Optional[int] = None):
    o = NOBS
    if not o._enabled:  # the sub-microsecond disabled path
        return
    o.sent(node, peer, ch_id, nbytes, queue_wait_s=queue_wait_s,
           wall_s=wall_s, stall_s=stall_s, depth=depth)


def recv(node: str, peer: str, ch_id: int, nbytes: int,
         wall_s: Optional[float] = None,
         stall_s: Optional[float] = None):
    o = NOBS
    if not o._enabled:
        return
    o.recv(node, peer, ch_id, nbytes, wall_s=wall_s, stall_s=stall_s)


def rtt(node: str, peer: str, rtt_s: float):
    o = NOBS
    if not o._enabled:
        return
    o.rtt(node, peer, rtt_s)


def flow_rate(node: str, peer: str, send_bps: Optional[float] = None,
              recv_bps: Optional[float] = None):
    o = NOBS
    if not o._enabled:
        return
    o.flow_rate(node, peer, send_bps=send_bps, recv_bps=recv_bps)


def gossip_receipt(node: str, peer: str, kind: str, useful: bool,
                   latency_s: Optional[float] = None):
    o = NOBS
    if not o._enabled:
        return
    o.gossip_receipt(node, peer, kind, useful, latency_s=latency_s)


def publish_pending(min_interval_s: float = 0.0):
    o = NOBS
    if not o._enabled:
        return
    o.publish_pending(min_interval_s=min_interval_s)


def is_enabled() -> bool:
    return NOBS._enabled


def enable():
    NOBS.enable()


def disable():
    NOBS.disable()


def reset():
    NOBS.reset()


def flow_table(node: Optional[str] = None) -> dict:
    return NOBS.flow_table(node)


def report(node: Optional[str] = None) -> dict:
    return NOBS.report(node)
