"""Event bus (reference types/event_bus.go + libs/pubsub).

Typed publish wrappers over a subscription hub.  Subscriptions match on
event type + key=value attributes (the subset of the reference's pubsub
query language that its own RPC clients actually use; the full query parser
lands with the RPC layer).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from queue import Queue
from typing import Callable, Dict, List, Optional

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"


@dataclass
class Event:
    type: str
    data: object = None
    attributes: Dict[str, str] = field(default_factory=dict)


class Subscription:
    def __init__(self, event_type: Optional[str],
                 attrs: Optional[Dict[str, str]] = None, maxlen: int = 1000):
        self.event_type = event_type
        self.attrs = attrs or {}
        self.queue: "Queue[Event]" = Queue(maxsize=maxlen)

    def matches(self, ev: Event) -> bool:
        if self.event_type is not None and ev.type != self.event_type:
            return False
        for k, v in self.attrs.items():
            if ev.attributes.get(k) != v:
                return False
        return True

    def deliver(self, ev: Event):
        try:
            self.queue.put_nowait(ev)
        except Exception:
            pass  # slow subscriber: drop (reference pubsub buffered behavior)


class EventBus:
    def __init__(self):
        self._subs: List[Subscription] = []
        self._lock = threading.Lock()

    def subscribe(self, event_type: Optional[str] = None,
                  attrs: Optional[Dict[str, str]] = None) -> Subscription:
        sub = Subscription(event_type, attrs)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription):
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, ev: Event):
        with self._lock:
            subs = list(self._subs)
        for s in subs:
            if s.matches(ev):
                s.deliver(ev)

    # -- typed publishers (reference types/event_bus.go:134+) --------------

    def publish_new_block(self, block, block_id, responses):
        self.publish(Event(EVENT_NEW_BLOCK,
                           data={"block": block, "block_id": block_id,
                                 "responses": responses},
                           attributes={"height": str(block.header.height)}))
        for i, tx in enumerate(block.data.txs):
            res = (responses.deliver_txs[i]
                   if i < len(responses.deliver_txs) else None)
            self.publish(Event(EVENT_TX,
                               data={"height": block.header.height,
                                     "index": i, "tx": tx, "result": res},
                               attributes={"height": str(block.header.height)}))

    def publish_validator_set_updates(self, updates):
        self.publish(Event(EVENT_VALIDATOR_SET_UPDATES,
                           data={"validator_updates": updates}))

    def publish_new_round_step(self, height: int, round_: int, step: str):
        self.publish(Event(EVENT_NEW_ROUND_STEP,
                           data={"height": height, "round": round_,
                                 "step": step}))

    def publish_vote(self, vote):
        self.publish(Event(EVENT_VOTE, data={"vote": vote}))

    def publish_complete_proposal(self, height, round_, block_id):
        self.publish(Event(EVENT_COMPLETE_PROPOSAL,
                           data={"height": height, "round": round_,
                                 "block_id": block_id}))
