"""Mempool (reference mempool/v0/clist_mempool.go).

FIFO mempool with CheckTx admission through the app, LRU dedup cache,
reap-by-bytes/gas for proposals, and post-block update + recheck
(reference mempool/v0/clist_mempool.go:201,519,577).

Admission is STAGED (ADR-018): ``check_tx`` composes three pieces —
``precheck`` (size cap, dedup cache, full pre-check), ``app_check``
(the ABCI CheckTx call, made with NO mempool lock held), and
``finish_check`` (limits re-validated under the lock, which now
brackets only map mutation).  The synchronous path and the IngressGate
worker (mempool/ingress.py) call the SAME stages, so their
ResponseCheckTx results are identical by construction.  The reference
ran the app call while holding the mempool lock (clist_mempool.go:201
callers hold updateMtx), which under a tx flood serialized every RPC
handler, every p2p receive, and the committing consensus thread on one
lock around a blocking app round trip.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.types.block import tx_hash

DEFAULT_CACHE_SIZE = 10000

# CheckTx rejection code for an app that RAISED instead of answering
# (distinct from the app's own rejection codes so callers can tell "the
# app said no" from "the app fell over"; the tx is dropped from the
# dedup cache either way so a retry reaches the app again)
CODE_APP_EXCEPTION = 2


class TxCache:
    """LRU cache of seen tx hashes (reference mempool/cache.go)."""

    def __init__(self, size: int = DEFAULT_CACHE_SIZE):
        self.size = size
        self._map: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()

    def push(self, tx: bytes) -> bool:
        """Returns False if already present."""
        key = tx_hash(tx)
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self.size:
                self._map.popitem(last=False)
            return True

    def remove(self, tx: bytes):
        with self._lock:
            self._map.pop(tx_hash(tx), None)

    def reset(self):
        with self._lock:
            self._map.clear()


@dataclass
class MempoolTx:
    tx: bytes
    height: int      # height when validated
    gas_wanted: int


class Mempool:
    def __init__(self, app: abci.Application, max_tx_bytes: int = 1048576,
                 size_limit: int = 5000, keep_invalid_txs_in_cache=False,
                 registry=None, max_txs_bytes: int = 1 << 30,
                 cache_size: int = DEFAULT_CACHE_SIZE):
        self.app = app
        self.max_tx_bytes = max_tx_bytes
        self.size_limit = size_limit
        self.max_txs_bytes = max_txs_bytes
        self.keep_invalid_txs_in_cache = keep_invalid_txs_in_cache
        from tendermint_tpu_torch.libs import log as tmlog
        self.log = tmlog.logger("mempool")
        from tendermint_tpu_torch.libs.metrics import MempoolMetrics
        self.metrics = MempoolMetrics(registry)
        self.cache = TxCache(cache_size)
        self._total_bytes = 0
        self._txs: "OrderedDict[bytes, MempoolTx]" = OrderedDict()
        self._lock = threading.RLock()
        # serializes ABCI CheckTx calls only (the reference's local
        # ABCI client holds a global mutex, local_client.go — an
        # in-process Application shared across connections is not
        # assumed thread-safe).  Distinct from _lock: an in-flight app
        # call must never block mempool reads, inserts, or the commit
        # path.  Ordering: _lock may be held when taking _app_lock
        # (the sync _recheck); never the reverse.
        self._app_lock = threading.Lock()
        self._height = 0
        self._notify: List[Callable[[], None]] = []
        # post-block recheck offload (ADR-018): when the IngressGate is
        # attached it sets this hook and update() hands the recheck to
        # the gate's worker (bounded slices per wakeup) instead of
        # walking every resident tx on the consensus commit path.  A
        # hook that raises or returns False falls back to the
        # synchronous in-caller recheck, identical to today.
        self.recheck_offload: Optional[Callable[[int], bool]] = None

    def size(self) -> int:
        with self._lock:
            return len(self._txs)

    def is_empty(self) -> bool:
        return self.size() == 0

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def on_new_tx(self, fn: Callable[[], None]):
        """Register a callback fired when a tx is admitted (reactor
        broadcast hook)."""
        self._notify.append(fn)

    # -- CheckTx admission (reference clist_mempool.go:201) ----------------
    #
    # Three stages so the IngressGate worker can run the app call in a
    # drained batch with the exact same per-tx results as this
    # synchronous composition.

    def precheck(self, tx: bytes) -> Optional[abci.ResponseCheckTx]:
        """Static admission gates BEFORE the app call: size cap, dedup
        cache, full pre-check.  Returns the rejection, or None to
        proceed — in which case the tx hash HAS been claimed in the
        cache (the sync path's claim-first discipline; a later
        rejection must release it)."""
        if len(tx) > self.max_tx_bytes:
            self.metrics.rejected_txs.inc(reason="toolarge")
            return abci.ResponseCheckTx(code=1, log="tx too large")
        if not self.cache.push(tx):
            self.metrics.rejected_txs.inc(reason="cache")
            return abci.ResponseCheckTx(code=1, log="tx already in cache")
        with self._lock:
            full = (len(self._txs) >= self.size_limit or
                    self._total_bytes + len(tx) > self.max_txs_bytes)
            size, nbytes = len(self._txs), self._total_bytes
        if full:
            self.cache.remove(tx)
            self.log.debug("mempool full, rejecting tx",
                           size=size, bytes=nbytes)
            self.metrics.rejected_txs.inc(reason="full")
            return abci.ResponseCheckTx(code=1, log="mempool is full")
        return None

    def app_check(self, tx: bytes) -> abci.ResponseCheckTx:
        """The ABCI CheckTx round trip, made with NO mempool lock held.
        An app exception used to propagate out of check_tx AFTER the
        cache claim, poisoning the dedup cache: every retry of that tx
        was rejected as "already in cache" forever.  Now it maps to a
        coded error and the cache entry is dropped so a retry reaches
        the app again."""
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
        """Post-CheckTx bookkeeping: insert (limits RE-validated under
        the lock — precheck's answer may have gone stale while the app
        ran unlocked) or release the cache claim on rejection.  Notify
        + metrics run OUTSIDE the lock: listeners (consensus
        notify_txs_available) take the consensus mutex, and the
        consensus thread takes the mempool lock during commit — calling
        out while holding _lock would be an ABBA deadlock."""
        admitted = False
        became_full = False
        if res.is_ok():
            key = tx_hash(tx)
            with self._lock:
                if key in self._txs:
                    admitted = True  # concurrent duplicate: same as held
                elif (len(self._txs) >= self.size_limit or
                        self._total_bytes + len(tx) > self.max_txs_bytes):
                    became_full = True
                else:
                    self._txs[key] = MempoolTx(tx, self._height,
                                               res.gas_wanted)
                    self._total_bytes += len(tx)
                    admitted = True
        if became_full:
            self.cache.remove(tx)
            self.metrics.rejected_txs.inc(reason="full")
            return abci.ResponseCheckTx(code=1, log="mempool is full")
        if admitted:
            self.metrics.size.set(self.size())
            self.metrics.tx_size_bytes.observe(len(tx))
            for fn in self._notify:
                fn()
        else:
            # app_check counted + released on a real exception (its
            # coded response carries codespace "mempool"); an app
            # legitimately returning code 2 is a normal rejection
            if not (res.code == CODE_APP_EXCEPTION
                    and res.codespace == "mempool"):
                self.metrics.rejected_txs.inc(reason="app_err")
            if not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            self.metrics.failed_txs.inc()
        return res

    def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        rej = self.precheck(tx)
        if rej is not None:
            return rej
        return self.finish_check(tx, self.app_check(tx))

    # -- reap (reference clist_mempool.go:519) -----------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int,
                               deadline: Optional[float] = None) \
            -> List[bytes]:
        """Reap txs in arrival order under byte/gas caps.  `deadline`
        (time.monotonic-based, ADR-024) bounds how long the scan may
        hold the mempool lock: past it the reap returns what it has —
        a huge mempool degrades the BLOCK, not the round.  Checked
        every 64 txs so the common small reap never pays a clock read."""
        with self._lock:
            out, total_b, total_g = [], 0, 0
            for i, mt in enumerate(self._txs.values()):
                if (deadline is not None and not i & 63
                        and time.monotonic() >= deadline):
                    break
                nb = total_b + len(mt.tx) + 20  # amino/proto overhead bound
                ng = total_g + mt.gas_wanted
                if max_bytes > -1 and nb > max_bytes:
                    break
                if max_gas > -1 and ng > max_gas:
                    break
                out.append(mt.tx)
                total_b, total_g = nb, ng
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._lock:
            txs = [mt.tx for mt in self._txs.values()]
            return txs if n < 0 else txs[:n]

    def txs_after(self, n: int) -> List[bytes]:
        """Txs from position n onward (reactor iteration)."""
        with self._lock:
            return [mt.tx for mt in list(self._txs.values())[n:]]

    # -- update after block commit (reference clist_mempool.go:577) --------

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    def update(self, height: int, committed_txs: List[bytes]):
        """Caller must hold lock() (BlockExecutor._commit does).

        With the IngressGate attached the post-block recheck is
        scheduled onto the gate's worker instead of walking every
        resident tx here, so this returns in O(committed txs) and the
        consensus commit path is never held hostage by a slow app."""
        self._height = height
        for tx in committed_txs:
            self.cache.push(tx)  # committed: never re-admit
            mt = self._txs.pop(tx_hash(tx), None)
            if mt is not None:
                self._total_bytes -= len(mt.tx)
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
        for key, mt in self._txs.items():
            self.metrics.recheck_times.inc()
            with self._app_lock:
                res = self.app.check_tx(abci.RequestCheckTx(
                    tx=mt.tx, type=abci.CheckTxType.RECHECK))
            if not res.is_ok():
                dead.append(key)
        for key in dead:
            mt = self._txs.pop(key)
            self._total_bytes -= len(mt.tx)
            if not self.keep_invalid_txs_in_cache:
                self.cache.remove(mt.tx)
        self.metrics.size.set(len(self._txs))

    # -- async recheck slices (IngressGate worker, ADR-018) ----------------

    def recheck_keys(self) -> List[bytes]:
        """Snapshot of resident tx keys for an offloaded recheck."""
        with self._lock:
            return list(self._txs.keys())

    def recheck_one(self, key: bytes):
        """Recheck one resident tx: app call OUTSIDE the lock, removal
        (if it went invalid) re-validated under it.  A tx that was
        reaped/committed between snapshot and slice is skipped; an app
        exception keeps the tx (the next block's recheck retries)."""
        with self._lock:
            mt = self._txs.get(key)
        if mt is None:
            return
        self.metrics.recheck_times.inc()
        try:
            with self._app_lock:
                res = self.app.check_tx(abci.RequestCheckTx(
                    tx=mt.tx, type=abci.CheckTxType.RECHECK))
        except Exception:  # noqa: BLE001 - keep the tx, retry next block
            return
        if res.is_ok():
            return
        with self._lock:
            cur = self._txs.get(key)
            if cur is not mt:
                return
            del self._txs[key]
            self._total_bytes -= len(cur.tx)
        if not self.keep_invalid_txs_in_cache:
            self.cache.remove(mt.tx)
        self.metrics.size.set(self.size())

    def flush(self):
        with self._lock:
            self._txs.clear()
            self._total_bytes = 0
            self.cache.reset()
