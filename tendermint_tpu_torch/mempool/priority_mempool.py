"""v1 priority mempool (reference mempool/v1/mempool.go).

Transactions carry an application-assigned priority (from the CheckTx
response, reference mempool/v1/mempool.go:482).  Reaping returns
transactions in nonincreasing priority order with ties broken by arrival
order (:295-309); when the pool is full, an incoming transaction may evict
strictly-lower-priority residents whose combined size frees enough room
(:173-174, :506-541) — otherwise it is rejected.

Same external surface as the v0 Mempool (mempool/mempool.py) so the
reactor, BlockExecutor, and Node can take either; selected via
config.mempool.version (reference config/config.go mempool section).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.types.block import tx_hash

from .mempool import CODE_APP_EXCEPTION, TxCache


class _WrappedTx:
    __slots__ = ("tx", "key", "height", "gas_wanted", "priority", "sender",
                 "order")

    def __init__(self, tx, key, height, gas_wanted, priority, sender, order):
        self.tx = tx
        self.key = key
        self.height = height
        self.gas_wanted = gas_wanted
        self.priority = priority
        self.sender = sender
        self.order = order


class PriorityMempool:
    """Reference mempool/v1/TxMempool."""

    def __init__(self, app: abci.Application, max_tx_bytes: int = 1048576,
                 size_limit: int = 5000, max_total_bytes: int = 64 << 20,
                 keep_invalid_txs_in_cache: bool = False, registry=None,
                 cache_size: int = 10000):
        from tendermint_tpu_torch.libs.metrics import MempoolMetrics
        self.metrics = MempoolMetrics(registry)
        self.app = app
        self.max_tx_bytes = max_tx_bytes
        self.size_limit = size_limit
        self.max_total_bytes = max_total_bytes
        self.keep_invalid_txs_in_cache = keep_invalid_txs_in_cache
        self.cache = TxCache(cache_size)
        self._txs: Dict[bytes, _WrappedTx] = {}
        self._by_sender: Dict[str, bytes] = {}
        self._bytes = 0
        self._order = itertools.count()
        self._lock = threading.RLock()
        # serializes ABCI CheckTx only (see mempool.Mempool._app_lock)
        self._app_lock = threading.Lock()
        self._height = 0
        self._notify: List[Callable[[], None]] = []
        # post-block recheck offload (ADR-018; see mempool.Mempool)
        self.recheck_offload: Optional[Callable[[int], bool]] = None

    # -- views -------------------------------------------------------------

    def size(self) -> int:
        with self._lock:
            return len(self._txs)

    def is_empty(self) -> bool:
        return self.size() == 0

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def on_new_tx(self, fn: Callable[[], None]):
        self._notify.append(fn)

    # -- admission (reference mempool/v1/mempool.go:441-545) ---------------

    def precheck(self, tx: bytes) -> Optional[abci.ResponseCheckTx]:
        """Static gates before the app call (staged admission, ADR-018;
        see mempool.Mempool.precheck).  None = proceed, cache claimed.
        The v1 pool has no fixed full pre-check: fullness is decided at
        insert time by the priority eviction policy (_make_room)."""
        if len(tx) > self.max_tx_bytes:
            self.metrics.rejected_txs.inc(reason="toolarge")
            self.metrics.failed_txs.inc()
            return abci.ResponseCheckTx(code=1, log="tx too large")
        if not self.cache.push(tx):
            # routine gossip duplicate — not a failure (v0 parity)
            self.metrics.rejected_txs.inc(reason="cache")
            return abci.ResponseCheckTx(code=1, log="tx already in cache")
        return None

    def app_check(self, tx: bytes) -> abci.ResponseCheckTx:
        """The ABCI CheckTx round trip, with NO mempool lock held (the
        reference ran it under updateMtx).  An app exception drops the
        cache claim instead of poisoning it (see Mempool.app_check)."""
        try:
            with self._app_lock:
                return self.app.check_tx(abci.RequestCheckTx(tx=tx))
        except Exception as e:  # noqa: BLE001 - app fault must not poison
            self.cache.remove(tx)
            self.metrics.rejected_txs.inc(reason="app_err")
            return abci.ResponseCheckTx(
                code=CODE_APP_EXCEPTION, codespace="mempool",
                log=f"check_tx failed: {type(e).__name__}: {e}")

    def finish_check(self, tx: bytes,
                     res: abci.ResponseCheckTx) -> abci.ResponseCheckTx:
        """Insert under the lock (sender exclusivity + priority
        eviction re-decided there), notify/metrics outside it."""
        def reject(r):
            self.metrics.failed_txs.inc()
            return r

        if not res.is_ok():
            # app_check already released the cache claim on a real
            # exception (its coded response carries codespace
            # "mempool"); an app legitimately RETURNING code 2 must
            # still get the normal-rejection release, or a retry is
            # poisoned with "already in cache" forever
            app_raised = (res.code == CODE_APP_EXCEPTION
                          and res.codespace == "mempool")
            if not app_raised:
                self.metrics.rejected_txs.inc(reason="app_err")
            if not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)  # idempotent after app_check
            return reject(res)
        with self._lock:
            key = tx_hash(tx)
            if key in self._txs:
                return res
            # sender exclusivity (reference :469-477): one in-flight tx
            # per declared sender
            if res.sender and res.sender in self._by_sender:
                self.cache.remove(tx)
                self.metrics.rejected_txs.inc(reason="app_err")
                return reject(abci.ResponseCheckTx(
                    code=1, log=f"sender {res.sender} has tx in mempool"))
            if not self._make_room(len(tx), res.priority):
                self.cache.remove(tx)
                self.metrics.rejected_txs.inc(reason="full")
                return reject(abci.ResponseCheckTx(
                    code=1, log="mempool is full and tx priority too low"))
            wtx = _WrappedTx(tx, key, self._height, res.gas_wanted,
                             res.priority, res.sender, next(self._order))
            self._txs[key] = wtx
            if res.sender:
                self._by_sender[res.sender] = key
            self._bytes += len(tx)
        self.metrics.size.set(self.size())
        self.metrics.tx_size_bytes.observe(len(tx))
        for fn in self._notify:
            fn()
        return res

    def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        rej = self.precheck(tx)
        if rej is not None:
            return rej
        return self.finish_check(tx, self.app_check(tx))

    def _make_room(self, need_bytes: int, priority: int) -> bool:
        """Evict strictly-lower-priority txs until the pool has room, or
        report False (reference :506-541).  Caller holds the lock."""
        def full():
            return (len(self._txs) >= self.size_limit
                    or self._bytes + need_bytes > self.max_total_bytes)

        if not full():
            return True
        victims = sorted(
            (w for w in self._txs.values() if w.priority < priority),
            key=lambda w: (w.priority, -w.order))
        freed_count, freed_bytes, chosen = 0, 0, []
        for w in victims:
            chosen.append(w)
            freed_count += 1
            freed_bytes += len(w.tx)
            if (len(self._txs) - freed_count < self.size_limit
                    and self._bytes - freed_bytes + need_bytes
                    <= self.max_total_bytes):
                for v in chosen:
                    self._remove(v.key, remove_from_cache=True)
                return True
        return False

    # -- reap (reference :295-347) -----------------------------------------

    def _sorted(self) -> List[_WrappedTx]:
        return sorted(self._txs.values(),
                      key=lambda w: (-w.priority, w.order))

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int,
                               deadline: Optional[float] = None) \
            -> List[bytes]:
        """Priority-order reap under byte/gas caps.  `deadline`
        (time.monotonic-based, ADR-024) bounds the lock-held scan: the
        skip-and-continue search for smaller txs is O(n) even once the
        block is nearly full, so past the deadline the reap returns
        what it has — highest-priority txs first by construction."""
        with self._lock:
            out, total_b, total_g = [], 0, 0
            for i, w in enumerate(self._sorted()):
                if (deadline is not None and not i & 63
                        and time.monotonic() >= deadline):
                    break
                nb = total_b + len(w.tx) + 20
                ng = total_g + w.gas_wanted
                if max_bytes > -1 and nb > max_bytes:
                    continue  # reference :331: skip, try next (smaller) tx
                if max_gas > -1 and ng > max_gas:
                    continue
                out.append(w.tx)
                total_b, total_g = nb, ng
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._lock:
            txs = [w.tx for w in self._sorted()]
            return txs if n < 0 else txs[:n]

    def txs_after(self, n: int) -> List[bytes]:
        """Reactor iteration view: arrival (order) sequence, matching the
        v0 semantics the gossip reactor assumes."""
        with self._lock:
            byorder = sorted(self._txs.values(), key=lambda w: w.order)
            return [w.tx for w in byorder[n:]]

    # -- update (reference :584-648) ---------------------------------------

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    def _remove(self, key: bytes, remove_from_cache: bool):
        w = self._txs.pop(key, None)
        if w is None:
            return
        self._bytes -= len(w.tx)
        if w.sender and self._by_sender.get(w.sender) == key:
            del self._by_sender[w.sender]
        if remove_from_cache:
            self.cache.remove(w.tx)

    def update(self, height: int, committed_txs: List[bytes]):
        """Caller must hold lock() (BlockExecutor commit path).  With
        the IngressGate attached the recheck is offloaded to the gate
        worker (bounded slices) so this returns in O(committed txs)."""
        self._height = height
        for tx in committed_txs:
            self.cache.push(tx)  # committed: never re-admit
            self._remove(tx_hash(tx), remove_from_cache=False)
        hook = self.recheck_offload
        if hook is not None:
            try:
                if hook(height):
                    self.metrics.size.set(len(self._txs))
                    return
            except Exception:  # noqa: BLE001 - degrade to sync recheck
                pass
        self._recheck()

    def _recheck(self):
        dead = []
        for key, w in self._txs.items():
            self.metrics.recheck_times.inc()
            with self._app_lock:
                res = self.app.check_tx(abci.RequestCheckTx(
                    tx=w.tx, type=abci.CheckTxType.RECHECK))
            if not res.is_ok():
                dead.append(key)
            else:
                w.priority = res.priority  # reference :713: re-prioritize
        for key in dead:
            self._remove(key, remove_from_cache=not
                         self.keep_invalid_txs_in_cache)
        self.metrics.size.set(len(self._txs))

    # -- async recheck slices (IngressGate worker, ADR-018) ----------------

    def recheck_keys(self) -> List[bytes]:
        """Snapshot of resident tx keys for an offloaded recheck."""
        with self._lock:
            return list(self._txs.keys())

    def recheck_one(self, key: bytes):
        """Recheck one resident tx off the commit path: app call with
        no lock held, removal (or re-prioritization, reference :713)
        re-validated under it."""
        with self._lock:
            w = self._txs.get(key)
        if w is None:
            return
        self.metrics.recheck_times.inc()
        try:
            with self._app_lock:
                res = self.app.check_tx(abci.RequestCheckTx(
                    tx=w.tx, type=abci.CheckTxType.RECHECK))
        except Exception:  # noqa: BLE001 - keep the tx, retry next block
            return
        with self._lock:
            cur = self._txs.get(key)
            if cur is not w:
                return
            if res.is_ok():
                cur.priority = res.priority
                return
            self._remove(key, remove_from_cache=not
                         self.keep_invalid_txs_in_cache)
        self.metrics.size.set(self.size())

    def flush(self):
        with self._lock:
            self._txs.clear()
            self._by_sender.clear()
            self._bytes = 0
            self.cache.reset()
