"""Multiplexed connection (reference p2p/conn/connection.go MConnection).

N logical channels over one SecretConnection; per-channel priority send
queues drained by one send thread (most-behind-by-priority scheduling, the
reference's recently-sent EMA policy in spirit); one recv thread dispatches
to the owner's on_receive.  Ping/pong keepalive with timeout.

Timekeeping is an injectable MONOTONIC clock: the pong deadline and the
RTT sample must not move when NTP steps the wall clock — a backward step
under the old time.time() arithmetic could suppress the 45 s pong
timeout indefinitely, a forward step could fire it spuriously
(ADR-025 satellite).

When the gossip observatory (p2p/netobs.py) is enabled and the Switch
threaded identity labels through (obs_node/obs_peer), the routines feed
it: per-channel queue wait (enqueue -> wire), serialize/send wall,
flowrate stall, recv dispatch wall, ping RTT and the Monitor EMA rates.
Recording is fire-and-forget — netobs sheds internally and never raises
into the send/recv path.
"""
from __future__ import annotations

import queue
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.libs.flowrate import Monitor

from . import netobs
from .secret_connection import SecretConnection

_MSG = 0x01
_PING = 0x02
_PONG = 0x03

PING_INTERVAL = 10.0
PONG_TIMEOUT = 45.0
MAX_MSG_SIZE = 32 * 1024 * 1024
# Per-connection send/recv byte-rate caps (reference
# p2p/conn/connection.go:43-44 defaults 500 KB/s; raised 10x here — the
# batch-verifying data plane sustains much higher replay throughput and
# the cap exists for fairness, not protection).
DEFAULT_SEND_RATE = 5_120_000
DEFAULT_RECV_RATE = 5_120_000


@dataclass
class ChannelDescriptor:
    id: int
    priority: int = 1
    send_queue_capacity: int = 100


class MConnection:
    def __init__(self, conn: SecretConnection,
                 channels: List[ChannelDescriptor],
                 on_receive: Callable[[int, bytes], None],
                 on_error: Callable[[Exception], None],
                 send_rate: int = DEFAULT_SEND_RATE,
                 recv_rate: int = DEFAULT_RECV_RATE,
                 obs_node: str = "",
                 obs_peer: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.conn = conn
        self.send_monitor = Monitor(send_rate)
        self.recv_monitor = Monitor(recv_rate)
        self.on_receive = on_receive
        self.on_error = on_error
        self._chans: Dict[int, ChannelDescriptor] = {c.id: c for c in channels}
        # queue items are (enqueue_t, msg): the send routine charges the
        # gossip observatory with the enqueue -> wire wait per channel
        self._queues: Dict[int, "queue.Queue[tuple]"] = {
            c.id: queue.Queue(maxsize=c.send_queue_capacity) for c in channels}
        self._send_event = threading.Event()
        self._stop = threading.Event()
        self._clock = clock
        self._last_pong = clock()
        self._ping_sent_t: Optional[float] = None
        self._obs_node = obs_node
        self._obs_peer = obs_peer
        self._threads: List[threading.Thread] = []

    def start(self):
        for target, name in ((self._send_routine, "send"),
                             (self._recv_routine, "recv"),
                             (self._ping_routine, "ping")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"mconn-{name}")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        self._send_event.set()
        self.conn.close()

    def send(self, ch_id: int, msg: bytes, block: bool = True) -> bool:
        """Queue msg on channel; False if the queue is full (try_send) or
        the connection is stopped."""
        if self._stop.is_set():
            return False
        q = self._queues.get(ch_id)
        if q is None:
            raise ValueError(f"unknown channel {ch_id:#x}")
        try:
            q.put((self._clock(), msg),
                  block=block, timeout=10 if block else None)
        except queue.Full:
            return False
        self._send_event.set()
        return True

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        return self.send(ch_id, msg, block=False)

    # -- routines ----------------------------------------------------------

    def _next_msg(self) -> Optional[tuple]:
        """Pick from the highest-priority non-empty queue."""
        best = None
        for cid, q in self._queues.items():
            if not q.empty():
                pr = self._chans[cid].priority
                if best is None or pr > best[0]:
                    best = (pr, cid, q)
        if best is None:
            return None
        try:
            enq_t, msg = best[2].get_nowait()
            return best[1], enq_t, msg, best[2].qsize()
        except queue.Empty:
            return None

    def _send_routine(self):
        try:
            while not self._stop.is_set():
                item = self._next_msg()
                if item is None:
                    self._send_event.wait(timeout=0.1)
                    self._send_event.clear()
                    continue
                cid, enq_t, msg, depth = item
                t0 = self._clock()
                self.conn.send_frame(bytes([_MSG, cid]) + msg)
                wall = self._clock() - t0
                stall = self.send_monitor.update(len(msg) + 2)
                if self._obs_node:
                    netobs.sent(self._obs_node, self._obs_peer, cid,
                                len(msg) + 2, queue_wait_s=t0 - enq_t,
                                wall_s=wall, stall_s=stall, depth=depth)
        except Exception as e:  # noqa: BLE001
            self._fail(e)

    def _recv_routine(self):
        try:
            while not self._stop.is_set():
                frame = self.conn.recv_frame()
                if not frame:
                    continue
                stall = self.recv_monitor.update(len(frame))
                kind = frame[0]
                if kind == _PING:
                    self.conn.send_frame(bytes([_PONG]))
                elif kind == _PONG:
                    now = self._clock()
                    self._last_pong = now
                    sent_t, self._ping_sent_t = self._ping_sent_t, None
                    if sent_t is not None and self._obs_node:
                        netobs.rtt(self._obs_node, self._obs_peer,
                                   now - sent_t)
                elif kind == _MSG:
                    if len(frame) < 2 or len(frame) > MAX_MSG_SIZE:
                        raise ValueError("bad mconn frame")
                    t0 = self._clock()
                    self.on_receive(frame[1], frame[2:])
                    if self._obs_node:
                        netobs.recv(self._obs_node, self._obs_peer,
                                    frame[1], len(frame),
                                    wall_s=self._clock() - t0,
                                    stall_s=stall)
                else:
                    raise ValueError(f"unknown frame kind {kind}")
        except Exception as e:  # noqa: BLE001
            self._fail(e)

    def _ping_routine(self):
        try:
            while not self._stop.is_set():
                time.sleep(PING_INTERVAL)
                if self._stop.is_set():
                    return
                self._ping_sent_t = self._clock()
                self.conn.send_frame(bytes([_PING]))
                if self._obs_node:
                    netobs.flow_rate(self._obs_node, self._obs_peer,
                                     send_bps=self.send_monitor.rate(),
                                     recv_bps=self.recv_monitor.rate())
                if self._clock() - self._last_pong > PONG_TIMEOUT:
                    raise TimeoutError("pong timeout")
        except Exception as e:  # noqa: BLE001
            self._fail(e)

    def _fail(self, e: Exception):
        if not self._stop.is_set():
            self._stop.set()
            self.conn.close()
            self.on_error(e)
