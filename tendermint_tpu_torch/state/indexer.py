"""Tx + block indexers (reference state/txindex/kv/kv.go and
state/indexer/block/kv/kv.go): index committed tx results and block events
by hash/height/event attributes; serve `tx`, `tx_search`, `block_search`.

Composite event keys are 'type.attr' (e.g. 'transfer.sender'); the
implicit keys tx.hash / tx.height / block.height are always indexed.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.libs import safe_codec
from tendermint_tpu_torch.libs.pubsub_query import Query
from tendermint_tpu_torch.types.block import tx_hash as hash_tx

_TX = b"txi/"        # hash -> TxRecord
_TXEV = b"txe/"      # key \x00 value \x00 height(8) index(4) -> hash
_BLKEV = b"bke/"     # key \x00 value \x00 height(8) -> b"1"


@safe_codec.register
@dataclass
class TxRecord:
    height: int
    index: int
    tx: bytes
    code: int
    log: str
    events: Dict[str, List[str]] = field(default_factory=dict)


def _events_map(events) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for ev in events or []:
        for k, v in (ev.attributes or {}).items():
            out.setdefault(f"{ev.type}.{k}", []).append(str(v))
    return out


class TxIndexer:
    """Reference state/txindex/kv/kv.go."""

    def __init__(self, db):
        self.db = db

    def index_block_txs(self, height: int, txs, results) -> None:
        for i, tx in enumerate(txs):
            res = results[i] if i < len(results) else None
            events = _events_map(getattr(res, "events", []))
            th = hash_tx(tx)
            events.setdefault("tx.hash", []).append(th.hex().upper())
            events.setdefault("tx.height", []).append(str(height))
            rec = TxRecord(height=height, index=i, tx=tx,
                           code=getattr(res, "code", 0),
                           log=getattr(res, "log", ""), events=events)
            self.db.set(_TX + th, safe_codec.dumps(rec))
            for key, values in events.items():
                for v in values:
                    self.db.set(
                        _TXEV + key.encode() + b"\x00" + v.encode()[:128]
                        + b"\x00" + struct.pack(">qI", height, i), th)

    def get(self, th: bytes) -> Optional[dict]:
        raw = self.db.get(_TX + th)
        if raw is None:
            return None
        rec: TxRecord = safe_codec.loads(raw)
        return self._to_json(th, rec)

    def search(self, query: str, page: int = 1, per_page: int = 30) -> dict:
        q = Query(query)
        hashes = self._candidates(q)
        results = []
        for th in hashes:
            raw = self.db.get(_TX + th)
            if raw is None:
                continue
            rec: TxRecord = safe_codec.loads(raw)
            if q.matches(rec.events):
                results.append((rec.height, rec.index, th, rec))
        results.sort(key=lambda r: (r[0], r[1]))
        total = len(results)
        chunk = results[(page - 1) * per_page: page * per_page]
        return {"txs": [self._to_json(th, rec)
                        for _, _, th, rec in chunk],
                "total_count": total}

    def _candidates(self, q: Query) -> List[bytes]:
        # hash equality: direct lookup
        c = q.condition_for("tx.hash")
        if c is not None and c.op == "=":
            return [bytes.fromhex(str(c.operand))]
        # narrow by the first equality condition's index, else scan all
        for cond in q.conditions:
            if cond.op == "=" and isinstance(cond.operand, str):
                prefix = (_TXEV + cond.key.encode() + b"\x00"
                          + cond.operand.encode()[:128] + b"\x00")
                seen, out = set(), []
                for _, th in self.db.iterate_prefix(prefix):
                    if th not in seen:
                        seen.add(th)
                        out.append(th)
                return out
        seen, out = set(), []
        for k, _ in self.db.iterate_prefix(_TX):
            th = k[len(_TX):]
            if th not in seen:
                seen.add(th)
                out.append(th)
        return out

    def _to_json(self, th: bytes, rec: TxRecord) -> dict:
        import base64
        return {"hash": th.hex().upper(), "height": rec.height,
                "index": rec.index,
                "tx_result": {"code": rec.code, "log": rec.log},
                "tx": base64.b64encode(rec.tx).decode()}


from tendermint_tpu_torch.libs.service import BaseService


class IndexerService(BaseService):
    """Reference state/txindex/indexer_service.go (a BaseService there
    too): subscribes to NewBlock on the event bus and feeds both
    indexers."""

    def __init__(self, tx_indexer: "TxIndexer", block_indexer: "BlockIndexer",
                 event_bus, sinks=None):
        super().__init__("indexer")
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.sinks = list(sinks or [])  # SQLEventSink etc (state/sinks.py)
        self._sub = event_bus.subscribe("NewBlock")
        self._bus = event_bus

    def on_start(self):
        self.spawn(self._run, name="indexer")

    def on_stop(self):
        self._bus.unsubscribe(self._sub)

    def _run(self):
        import queue
        while not self.quitting.is_set():
            try:
                ev = self._sub.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                data = ev.data or {}
                block = data["block"]
                responses = data["responses"]
                h = block.header.height
                self.block_indexer.index(
                    h,
                    getattr(responses.begin_block, "events", []) if
                    responses.begin_block else [],
                    getattr(responses.end_block, "events", []) if
                    responses.end_block else [])
                self.tx_indexer.index_block_txs(
                    h, block.data.txs, responses.deliver_txs or [])
                for sink in self.sinks:
                    t = block.header.time
                    sink.index_block(
                        h, f"{t.seconds}.{t.nanos:09d}",
                        getattr(responses.begin_block, "events", []) if
                        responses.begin_block else [],
                        getattr(responses.end_block, "events", []) if
                        responses.end_block else [])
                    sink.index_txs(h, block.data.txs,
                                   responses.deliver_txs or [])
            except Exception:
                continue


class BlockIndexer:
    """Reference state/indexer/block/kv/kv.go: BeginBlock/EndBlock events
    by height."""

    def __init__(self, db):
        self.db = db

    def index(self, height: int, begin_events, end_events) -> None:
        events = _events_map(list(begin_events or [])
                             + list(end_events or []))
        events.setdefault("block.height", []).append(str(height))
        self.db.set(_BLKEV + b"@rec\x00" + struct.pack(">q", height),
                    safe_codec.dumps(events))

    def search(self, query: str, page: int = 1, per_page: int = 30) -> dict:
        q = Query(query)
        heights = []
        for k, raw in self.db.iterate_prefix(_BLKEV + b"@rec\x00"):
            (height,) = struct.unpack(">q", k[-8:])
            events = safe_codec.loads(raw)
            if q.matches(events):
                heights.append(height)
        heights.sort()
        total = len(heights)
        chunk = heights[(page - 1) * per_page: page * per_page]
        return {"blocks": chunk, "total_count": total}
