"""Host-lane verify pool: multi-core execution for the native C lanes.

The counterpart of tendermint_tpu/crypto/lanepool.py.  A mixed
ed25519 + secp256k1 + sr25519 batch whose secp256k1 and sr25519 lanes
stay on the host (a CPU lane, a chaos drill, or the secp256k1 rollback
switch) would cost the sum of those lanes if BatchVerifier walked them
in a serial loop, each native C verifier (native/ecverify.c) running its
whole miss list on the calling thread.  The C lanes release the GIL
through ctypes, so plain daemon threads give real core-parallelism —
this module is that pool, shared process-wide like the degradation
runtime it sits beside.

Entry points:

  * ``run_lanes(thunks)`` — run whole host lanes concurrently (one
    thunk per scheme).  Every thunk the pool can admit runs on a pool
    worker; the rest run serially in the caller, so a disabled or
    saturated pool degrades to exactly the serial loop.
  * ``verify_sharded(tname, pubs, msgs, sigs)`` — one scheme's C-lane
    call, sharded into per-core chunks and merged back in index order
    (chunk i owns rows [lo_i, hi_i)).  Returns None when no native
    library exists, the contract of calling libs/native directly, so
    the caller's per-item pure-Python fallback is untouched.
  * ``map_sharded(fn, items)`` — any row-wise pure chunk function
    (the Merkle leaf layer, crypto/merkle.py).

Safety properties the callers rely on:

  * exact bitmaps: chunk boundaries never change per-index verdicts,
    and any pool-path fault (injected or real) re-verifies the whole
    list serially in the caller — byte-identical output.
  * no deadlock by construction: work is only handed to a worker that
    is idle RIGHT NOW (try_submit), so a lane thunk running ON the
    pool that shards its C call can never wait on a queue slot behind
    itself; unadmitted work runs in the submitting thread.
  * integrity: the merged pool bitmap is spot-checked on one random
    index against a direct single-row verify (chaos mode
    "corrupt-bitmap" at site ``lanepool.verify``), and a mismatch
    discards the pool result for the serial path.
  * daemon workers: the pool never blocks interpreter shutdown.

The pool size comes from set_workers() or TM_TPU_HOST_POOL_WORKERS;
the node's `[batch_verifier] host_pool_workers` key attaches to
set_workers() with node wiring.
"""
from __future__ import annotations

import concurrent.futures as _cf
import os
import queue as _queue
import random
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs import trace
from . import degrade

# below this many rows per chunk the thread handoff costs more than the
# C verify itself (~0.05-0.2 ms/sig): small lists run in one piece
MIN_CHUNK = 8


class PoolIntegrityError(RuntimeError):
    """The pool's merged bitmap disagreed with a direct re-verify."""


class HostLanePool:
    """Fixed-size daemon-thread pool with *try* semantics: submit only
    admits work when a worker is idle, so callers always have a
    run-it-yourself fallback and nested use cannot deadlock."""

    def __init__(self, workers: int, name: str = "host-lane-pool"):
        self.workers = max(1, int(workers))
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._lock = threading.Lock()
        self._avail = self.workers
        self._depth = 0
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}",
                             daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def try_submit(self, fn: Callable, *args) -> Optional[_cf.Future]:
        """Admit `fn(*args)` iff a worker is idle; None means "run it
        yourself".  The admission counter is decremented under the pool
        lock but the queue put happens outside it (tmlint TM202): the
        reserved worker is guaranteed to drain the queue."""
        with self._lock:
            if self._closed or self._avail <= 0:
                return None
            self._avail -= 1
            self._depth += 1
        f: _cf.Future = _cf.Future()
        self._q.put((fn, args, f))
        # close() may have raced between the locked check and the put,
        # parking this task BEHIND the worker-exit sentinels where no
        # worker will ever read it — a result() on that future would
        # hang the verifying thread forever.  Re-check and reclaim: a
        # successful cancel proves no worker picked it up, so the
        # caller must run the work itself (same contract as a full
        # pool); a failed cancel means a worker beat the shutdown to
        # it and will settle it normally.
        with self._lock:
            stranded = self._closed
        if stranded and f.cancel():
            with self._lock:  # no worker will run the task's finally:
                self._avail += 1   # give the admission back so depth()
                self._depth -= 1   # never reads a phantom task
            return None
        return f

    def depth(self) -> int:
        """Tasks currently admitted (queued or running)."""
        with self._lock:
            return self._depth

    def idle(self) -> int:
        with self._lock:
            return self._avail

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, f = item
            try:
                if f.set_running_or_notify_cancel():
                    try:
                        f.set_result(fn(*args))
                    except BaseException as e:  # noqa: BLE001 - future
                        f.set_exception(e)      # carries it to the caller
            finally:
                with self._lock:
                    self._avail += 1
                    self._depth -= 1

    def close(self, wait: bool = True):
        with self._lock:
            self._closed = True
        for _ in self._threads:
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout=2.0)


# ---------------------------------------------------------------------------
# process-global pool (one set of host cores per process); node assembly
# sizes it from config, tests resize/disable via set_workers
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()
_pool: Optional[HostLanePool] = None
_pool_size = 0                       # workers the installed pool has
_workers_override: Optional[int] = None


def set_workers(n: Optional[int]):
    """Config-driven pool size ([batch_verifier] host_pool_workers,
    wins over the env both directions — mirrors secp.set_lane_enabled).
    0 = auto-size from os.cpu_count(); 1 = serial (pool disabled);
    None clears the override so TM_TPU_HOST_POOL_WORKERS governs.
    An installed pool of the wrong size is closed and lazily rebuilt."""
    global _workers_override, _pool, _pool_size
    _workers_override = None if n is None else int(n)
    with _install_lock:
        if _pool is not None and _pool_size != _resolved_workers():
            old, _pool = _pool, None
            _pool_size = 0
        else:
            old = None
    if old is not None:
        old.close(wait=False)


def _resolved_workers() -> int:
    n = _workers_override
    if n is None:
        try:
            n = int(os.environ.get("TM_TPU_HOST_POOL_WORKERS", "0"))
        except ValueError:
            n = 0
    if n <= 0:
        n = os.cpu_count() or 1
    return n


def workers() -> int:
    """The resolved pool size WITHOUT constructing the pool (benches
    and reports read this; < 2 means host verification is serial)."""
    return _resolved_workers()


def pool() -> Optional[HostLanePool]:
    """The process-global pool, or None when host verification is
    serial (resolved size < 2: a one-worker pool could only move the
    same serial work onto another thread).  A stale-sized pool is
    closed OUTSIDE the install lock (its shutdown queue put must not
    run under a ranked lock — tmlint TM202)."""
    global _pool, _pool_size
    n = _resolved_workers()
    if n < 2:
        return None
    old = None
    with _install_lock:
        if _pool is None or _pool_size != n:
            old, _pool = _pool, HostLanePool(n)
            _pool_size = n
        p = _pool
    if old is not None:
        old.close(wait=False)
    return p


def close():
    """Tear down the global pool (tests); next use rebuilds lazily."""
    global _pool, _pool_size
    with _install_lock:
        old, _pool = _pool, None
        _pool_size = 0
    if old is not None:
        old.close()


# ---------------------------------------------------------------------------
# lane-level concurrency: one thunk per (scheme) host lane
# ---------------------------------------------------------------------------

def run_lanes(thunks: Sequence[Callable]) -> List:
    """Run the lane thunks concurrently where the pool admits them and
    serially in the caller otherwise; returns results in input order.
    Every admitted future is settled even when an inline thunk raises
    (no abandoned lane work), then the first exception propagates —
    same observable contract as the old serial for-loop."""
    p = pool()
    results: List = [None] * len(thunks)
    futs = {}
    if p is not None:
        for i, t in enumerate(thunks):
            f = p.try_submit(t)
            if f is not None:
                futs[i] = f
        degrade.publish_host_pool(depth=p.depth())
    err: Optional[BaseException] = None
    for i, t in enumerate(thunks):
        if i in futs:
            continue
        try:
            results[i] = t()
        except Exception as e:  # noqa: BLE001 - settle futures first
            if err is None:
                err = e
    for i, f in futs.items():
        try:
            results[i] = f.result()
        except Exception as e:  # noqa: BLE001 - keep settling the rest
            if err is None:
                err = e
    if p is not None:
        degrade.publish_host_pool(
            depth=p.depth(), tasks=(("lane", "pooled", len(futs)),
                                    ("lane", "inline",
                                     len(thunks) - len(futs))))
    if err is not None:
        raise err
    return results


# ---------------------------------------------------------------------------
# generic chunk-level map: one pure per-chunk function sharded across
# cores (the bulk SHA-256 leaf layer, ADR-024, is the first consumer)
# ---------------------------------------------------------------------------

def map_sharded(fn: Callable[[Sequence], List], items: Sequence,
                min_chunk: int = MIN_CHUNK) -> Optional[List]:
    """Apply a chunk function across `items` on idle pool workers and
    merge the results back in index order.  `fn` takes a contiguous
    slice of `items` and returns one result per row; chunk boundaries
    must not change per-row results (pure row-wise functions only).

    Returns the merged list, or None when the pool declines (disabled,
    resolved size < 2, or the list is too small to shard) — the caller
    runs its own serial loop, exactly the verify_sharded contract.
    Chunk 0 always runs in the submitting thread, every admitted
    future is settled even when another chunk raises, and the first
    exception (including a chunk returning the wrong row count)
    propagates so the caller can fall back serially."""
    n = len(items)
    if n < 2 * min_chunk:  # size-check FIRST: a tiny list must not
        return None        # even construct the pool
    p = pool()
    if p is None:
        return None
    k = min(p.workers, n // min_chunk)
    if k < 2:
        return None
    bounds = [(i * n) // k for i in range(k + 1)]

    def chunk(lo, hi):
        return fn(items[lo:hi])

    futs = []
    for i in range(1, k):
        lo, hi = bounds[i], bounds[i + 1]
        futs.append((lo, hi, p.try_submit(chunk, lo, hi)))
    degrade.publish_host_pool(depth=p.depth())
    out: List = [None] * n
    pooled = 0
    first_err: Optional[BaseException] = None

    def settle(lo, hi, sub):
        nonlocal first_err
        if len(sub) != hi - lo:
            raise RuntimeError(
                f"map_sharded chunk returned {len(sub)} rows for "
                f"[{lo}, {hi})")
        out[lo:hi] = sub

    try:
        settle(bounds[0], bounds[1], chunk(bounds[0], bounds[1]))
    except Exception as e:  # noqa: BLE001 - settle the futures first
        first_err = e
    for lo, hi, f in futs:
        pooled += f is not None
        try:
            settle(lo, hi, f.result() if f is not None else chunk(lo, hi))
        except Exception as e:  # noqa: BLE001 - keep settling the rest
            if first_err is None:
                first_err = e
            continue
    degrade.publish_host_pool(
        depth=p.depth(), tasks=(("chunk", "pooled", pooled),
                                ("chunk", "inline", k - pooled)))
    if first_err is not None:
        raise first_err  # -> the caller's serial fallback
    return out


# ---------------------------------------------------------------------------
# chunk-level concurrency: one native C call sharded across cores
# ---------------------------------------------------------------------------

_NATIVE_FN = {"secp256k1": ("secp_verify", 33),
              "sr25519": ("sr25519_verify", 32)}


def native_verifier(tname: str):
    """The batched native C verifier for a key scheme, or None (no
    native lane for the scheme, or no C toolchain on this host)."""
    from tendermint_tpu_torch.libs import native

    entry = _NATIVE_FN.get(tname)
    if entry is None or native.get_lib() is None:
        return None
    return getattr(native, entry[0])


def verify_sharded(tname: str, pubs, msgs, sigs,
                   t_submit: Optional[float] = None) \
        -> Optional[np.ndarray]:
    """One scheme's miss list through the native C lane, sharded into
    per-core chunks.  Exact per-index bool bitmap, or None when no
    native lane exists / the inputs are irregular (caller falls back to
    its per-item path, exactly as with a direct libs/native call).

    `t_submit` threads the request's lifecycle origin (ADR-016) down
    to this layer: the lanepool.verify span records how old the
    request already was when the C lane started, so a slow request's
    trace shows WHERE the time went even across the pool boundary.

    Degradation: any pool-path fault — an injected fault at site
    ``lanepool.verify``, a chunk exception, or the merged bitmap
    failing the one-row integrity spot check — re-verifies the whole
    list serially in the caller with the same C function."""
    fn = native_verifier(tname)
    if fn is None:
        return None
    n = len(pubs)
    if n == 0:
        return np.zeros(0, dtype=bool)
    # per-row length pre-screen BEFORE any chunking: libs/native
    # rejects irregular input lists wholesale, so one truncated
    # signature in a big miss list would otherwise let every regular
    # chunk run a full C verify only to be discarded — wasted multi-
    # core work an adversary could trigger with a single malformed row
    keysize = _NATIVE_FN[tname][1]
    if any(len(pubs[i]) != keysize or len(sigs[i]) != 64
           for i in range(n)):
        return None
    with trace.span("lanepool.verify", scheme=tname, n=n) as sp:
        try:
            if t_submit is not None and trace.is_enabled():
                sp.add(since_submit_s=round(
                    time.monotonic() - t_submit, 6))
            fail.inject("lanepool.verify")
            bits = _pooled_chunks(fn, pubs, msgs, sigs, sp)
            if bits is None:
                # serial in-caller path: pool disabled/saturated or the
                # list is too small to shard (this is ALSO the
                # single-miss fast path — one cache miss still takes
                # the C lane instead of ~5 ms of pure Python)
                sub = fn(pubs, msgs, sigs)
                if trace.is_enabled():
                    sp.add(chunks=1, pooled=0)
                return None if sub is None else np.asarray(sub, dtype=bool)
            bits = np.asarray(
                fail.corrupt_bitmap("lanepool.verify", bits), dtype=bool)
            j = random.randrange(n)
            single = fn([pubs[j]], [msgs[j]], [sigs[j]])
            if single is not None and bool(bits[j]) != bool(single[0]):
                raise PoolIntegrityError(
                    f"lanepool {tname}: merged bitmap disagrees with "
                    f"direct re-verify at row {j}")
            return bits
        except Exception as e:  # noqa: BLE001 - any pool fault degrades
            degrade.publish_host_pool(tasks=(("chunk", "fallback", 1),))
            if trace.is_enabled():
                sp.add(fallback=type(e).__name__)
            sub = fn(pubs, msgs, sigs)
            return None if sub is None else np.asarray(sub, dtype=bool)


def _pooled_chunks(fn, pubs, msgs, sigs, sp) -> Optional[np.ndarray]:
    """Shard one C call across idle workers; None = run serially (pool
    off, list too small, or an irregular chunk — libs/native returns
    None on malformed lengths and the WHOLE list must then take the
    caller's per-item path, matching the unsharded contract)."""
    n = len(pubs)
    if n < 2 * MIN_CHUNK:  # size-check FIRST: a tiny list must not
        return None        # even construct the pool
    p = pool()
    if p is None:
        return None
    k = min(p.workers, n // MIN_CHUNK)
    if k < 2:
        return None
    bounds = [(i * n) // k for i in range(k + 1)]

    def chunk(lo, hi):
        return fn(pubs[lo:hi], msgs[lo:hi], sigs[lo:hi])

    futs = []
    for i in range(1, k):
        lo, hi = bounds[i], bounds[i + 1]
        futs.append((lo, hi, p.try_submit(chunk, lo, hi)))
    degrade.publish_host_pool(depth=p.depth())
    out = np.zeros(n, dtype=bool)
    irregular = False
    pooled = 0
    first_err: Optional[BaseException] = None
    # the caller always works too (chunk 0) — and EVERY admitted future
    # is settled even when another chunk raises: abandoning in-flight
    # chunks would duplicate their C work against the serial fallback
    # and pin pool slots until the orphans drained
    try:
        sub0 = chunk(bounds[0], bounds[1])
        irregular = irregular or sub0 is None
        if sub0 is not None:
            out[bounds[0]:bounds[1]] = sub0
    except Exception as e:  # noqa: BLE001 - settle the futures first
        first_err = e
    for lo, hi, f in futs:
        pooled += f is not None  # placement, not success: a pooled
        #                          chunk that raises still ran pooled
        try:
            sub = f.result() if f is not None else chunk(lo, hi)
        except Exception as e:  # noqa: BLE001 - keep settling the rest
            if first_err is None:
                first_err = e
            continue
        irregular = irregular or sub is None
        if sub is not None:
            out[lo:hi] = sub
    degrade.publish_host_pool(
        depth=p.depth(), tasks=(("chunk", "pooled", pooled),
                                ("chunk", "inline", k - pooled)))
    if first_err is not None:
        raise first_err  # -> verify_sharded's serial in-caller fallback
    if trace.is_enabled():
        sp.add(chunks=k, pooled=pooled)
    if irregular:
        return None
    return out
