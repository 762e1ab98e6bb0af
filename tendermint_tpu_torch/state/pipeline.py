"""BlockPipeline — prefetched, group-committed block application
(ADR-017).

Once the signatures of a window verify in one coalesced batch, catch-up
is bounded by serial block application plus per-height storage commits —
the reference's
`BlockExecutor.ApplyBlock` / `BlockStore.SaveBlock` seam.  This module
turns `replay_window`'s verify-then-apply-serially loop into a bounded
three-stage pipeline:

  stage   a worker thread decodes block N+1 into its part set
          (merkle-heavy, hashlib releases the GIL), structurally
          validates it, and submits its signatures to the
          VerifyScheduler (BLOCKSYNC class, coalesced with whatever
          else is in flight) while ...
  apply   ... block N runs ABCI apply on the caller thread, its
          storage writes buffering in the stores' GroupCommitDB
          wrappers instead of committing per height, and ...
  commit  ... an async storage writer lands whole groups of heights
          as single `KVDB.write_batch` transactions — on SQLite one
          transaction + one fsync per `group_commit_heights` heights —
          behind a persistence frontier, block store strictly before
          state store so a crash can never leave state ahead of its
          block.

Fallback ladder (every rung keeps exact replay semantics):

  L0  pipelined: stage || apply || group commit.
  L1  stage/verify fault at block i -> blocks 0..i-1 stay applied, the
      rest of the stable prefix runs the strict sequential path with
      per-height WindowSyncError attribution.
  L2  group-commit fault (chaos at kvdb.group_commit, writer error)
      -> buffered groups flush synchronously through the recovery
      path (oldest first, block store before state store), then L1.
  L3  pipeline disabled / not running / busy -> replay_window's
      pre-existing coalesced + strict paths, untouched.

Crash consistency: a kill between group commits loses only the
un-committed tail; each group is one atomic write_batch, groups land
in order, and the state group of a height window lands after its
block group — so on reopen the block store height is monotonic and
the state store trails it by at most one group.  node.handshake
replays the gap (tests/test_pipeline.py kill-and-reopen matrix).

The port's departures from the JAX package's pipeline: the window's
signatures verify on the executor's device (BlockExecutor.device) — the
stage worker submits to the scheduler only when it runs on that device
(scheduler.running_on) and verifies directly on it otherwise; and a
launch that failed on the card outside a chaos drill is not a failed
verify: it is never re-verified and never degrades the window to the
strict path, but leaves replay_window as blocksync.replay's
WindowDeviceError with the state and count of the blocks that applied.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.libs import fail, trace
from tendermint_tpu_torch.libs.kvdb import GroupCommitDB
from tendermint_tpu_torch.libs.metrics import BlockSyncMetrics
from tendermint_tpu_torch.libs.service import BaseService

_STAGE_TIMEOUT_S = 30.0     # stage handoff starvation = pipeline fault
_WRITE_ENQ_TIMEOUT_S = 30.0  # writer backpressure bound
# backstop for VerifyFuture.result when the scheduler has no
# sync_timeout to offer (it settles/fails futures promptly on stop;
# this only bounds a wedged resolution)
_VERIFY_RESULT_TIMEOUT_S = 10.0


class PipelineFault(Exception):
    """Internal: a pipeline stage failed; the window degrades to the
    strict sequential path (never escapes replay_window)."""


class _StageTask:
    __slots__ = ("gen", "index", "height", "block", "cert", "state0",
                 "first", "device")

    def __init__(self, gen, index, height, block, cert, state0, first,
                 device):
        self.gen = gen
        self.index = index
        self.height = height
        self.block = block
        self.cert = cert
        self.state0 = state0
        self.first = first
        self.device = device      # the executor's, resolved


class _Staged:
    __slots__ = ("gen", "index", "height", "bid", "parts", "items",
                 "future", "ok", "bits", "error", "stage_s")

    def __init__(self, gen, index, height):
        self.gen = gen
        self.index = index
        self.height = height
        self.bid = None
        self.parts = None
        self.items = None
        self.future = None   # VerifyFuture when the scheduler is running
        self.ok = None       # resolved verdict when verified in-stage
        self.bits = None
        self.error = None
        self.stage_s = 0.0


class _WriteJob:
    __slots__ = ("gen", "height", "groups", "base")

    def __init__(self, gen, height, groups, base=None):
        self.gen = gen
        self.height = height          # last height covered by the job
        self.groups = groups          # ordered [(GroupCommitDB, group)]
        # first height covered (durable-stamp attribution; defaults to
        # the last height for callers that don't track a window base)
        self.base = height if base is None else base


class BlockPipeline(BaseService):
    """The block application pipeline service.  One instance is
    installed process-globally by the node ([block_pipeline] config);
    `blocksync.replay.replay_window` routes stable windows through it
    whenever it is running.  The service owns two daemon routines (the
    stage worker and the storage writer); the apply stage runs on the
    caller's thread so replay keeps its synchronous contract."""

    def __init__(self, depth: Optional[int] = None,
                 group_commit_heights: Optional[int] = None,
                 enabled: Optional[bool] = None):
        super().__init__("BlockPipeline")
        if depth is None:
            depth = int(os.environ.get("TM_TPU_PIPELINE_DEPTH", "4"))
        if group_commit_heights is None:
            group_commit_heights = int(
                os.environ.get("TM_TPU_GROUP_COMMIT_HEIGHTS", "8"))
        if enabled is None:
            enabled = os.environ.get("TM_TPU_BLOCK_PIPELINE", "1") != "0"
        if depth <= 0 or group_commit_heights <= 0:
            raise ValueError(
                "block pipeline depth/group_commit_heights must be "
                "positive")
        self.enabled = bool(enabled)
        self.depth = int(depth)
        self.group_commit_heights = int(group_commit_heights)
        self._metrics = BlockSyncMetrics()
        # stage handoff: unbounded task feed, depth-bounded output (the
        # stage worker can run at most `depth` blocks ahead of apply)
        self._stage_q: "queue.Queue[_StageTask]" = queue.Queue()
        self._staged_q: "queue.Queue[_Staged]" = queue.Queue(
            maxsize=self.depth)
        self._write_q: "queue.Queue[_WriteJob]" = queue.Queue(maxsize=4)
        # _cond guards gen/writer bookkeeping; metrics/trace publish
        # outside it (the PR 6 lockorder lesson)
        self._cond = threading.Condition()
        self._gen = 0
        self._jobs_enqueued = 0
        self._jobs_done = 0
        self._write_fault: Optional[BaseException] = None
        self._durable_height = 0
        self._commit_s = 0.0
        # one window in flight at a time; a second caller declines to
        # the non-pipelined path instead of queueing behind the first
        self._busy = threading.Lock()
        self._stage_timeout_s = _STAGE_TIMEOUT_S
        self.windows_pipelined = 0
        self.windows_degraded = 0
        # node name the consensus observatory keys the writer's
        # group-commit durable stamps under (node.py sets the moniker;
        # bare test pipelines record under "" — harmless)
        self.obs_node = ""

    # -- lifecycle ---------------------------------------------------------

    def on_start(self):
        self.spawn(self._stage_main, name="block-pipeline-stage")
        self.spawn(self._writer_main, name="block-pipeline-writer")

    def on_stop(self):
        # wake blocked queue waiters promptly; replay holds _busy while
        # in flight, so no new window can start once quitting is set
        with self._cond:
            self._gen += 1
            self._cond.notify_all()

    def durable_height(self) -> int:
        with self._cond:
            return self._durable_height

    # -- live reconfiguration (ADR-023) ------------------------------------

    def set_depth(self, depth: int) -> bool:
        """Thread-safe live depth change (the adaptive control plane's
        seam).  Only between windows: the staged queue is rebuilt, and
        that is safe exactly when no replay holds _busy (the stage
        worker blocks on puts and _next_staged drops stale-gen items,
        so a swapped queue with a bumped gen strands nothing).  Returns
        False without touching anything if a window is in flight — the
        caller skips this period's move and retries next period."""
        depth = int(depth)
        if depth <= 0:
            return False
        if not self._busy.acquire(blocking=False):
            return False
        try:
            if depth == self.depth:
                return True
            self.depth = depth
            with self._cond:
                # invalidate any stale staged items so the old queue's
                # leftovers can never reach the new one's consumers
                self._gen += 1
                self._staged_q = queue.Queue(maxsize=depth)
                self._cond.notify_all()
            return True
        finally:
            self._busy.release()

    # -- the replay entry (called from blocksync.replay) -------------------

    def replay_window(self, executor, store, state, blocks, certifiers,
                      max_window: int = 64):
        """Pipelined verify+apply of the window's stable prefix.
        Returns (new_state, n_applied), raises WindowSyncError (and
        WindowDeviceError for a card fault) exactly like the serial path,
        or returns None to decline (caller falls back to the
        coalesced/strict paths)."""
        if not blocks or not self.enabled or not self.is_running():
            return None
        if not self._busy.acquire(blocking=False):
            return None
        try:
            return self._replay_locked(executor, store, state,
                                       blocks[:max_window],
                                       certifiers[:max_window])
        finally:
            self._busy.release()

    def _replay_locked(self, executor, store, state, blocks, certifiers):
        from tendermint_tpu_torch.blocksync import replay as _replay

        k = _replay._stable_window(state, blocks)
        if k < 2:
            return None
        chain_id = state.chain_id
        base_h = state.last_block_height + 1
        dev = resolve_device(executor.device)
        gdbs = self._group_dbs(executor, store)
        gen = self._begin_window()
        wall0 = time.perf_counter()
        stage_s = apply_s = 0.0
        applied = 0
        faulted = False  # the first unapplied index is always `applied`
        try:
            for gdb in gdbs:
                gdb.begin_group_mode()
            for i in range(k):
                self._stage_q.put(_StageTask(
                    gen, i, base_h + i, blocks[i], certifiers[i], state,
                    first=(i == 0), device=dev))
            since_commit = 0
            try:
                for i in range(k):
                    staged = self._next_staged(gen)
                    self._metrics.pipeline_depth.set(
                        self._staged_q.qsize())
                    if staged.error is not None:
                        if _replay.card_fault(staged.error):
                            raise _replay.window_error(
                                base_h + i, staged.error, state, applied)
                        faulted = True
                        break
                    try:
                        ok = self._resolve_verify(staged, dev)
                    except Exception as e:   # a card fault only
                        raise _replay.window_error(
                            base_h + i, e, state, applied) from e
                    stage_s += staged.stage_s
                    if not ok:
                        faulted = True
                        break
                    b = blocks[i]
                    h = base_h + i
                    if b.last_commit is not None:
                        # the full LastCommit set rode this block's batch
                        executor.mark_commit_verified(h - 1, b.last_commit)
                    t0 = time.perf_counter()
                    with trace.span("pipeline.apply", height=h):
                        try:
                            state = _replay._apply_one(
                                executor, store, state, b, staged.bid,
                                staged.parts, certifiers[i])
                        except Exception as e:
                            raise _replay.window_error(
                                h, e, state, applied) from e
                    apply_s += time.perf_counter() - t0
                    applied += 1
                    since_commit += 1
                    if gdbs and since_commit >= self.group_commit_heights:
                        self._enqueue_group(gen, gdbs, h,
                                            base=h - since_commit + 1)
                        since_commit = 0
                if not faulted:
                    last_h = base_h + applied - 1
                    self._finish_window(gen, gdbs, last_h,
                                        base=last_h - since_commit + 1)
            except PipelineFault:
                faulted = True
            if not faulted:
                self._metrics.blocks_applied.inc(applied, path="pipelined")
                wall = time.perf_counter() - wall0
                with self._cond:
                    commit_s = self._commit_s
                    self.windows_pipelined += 1
                lane_sum = stage_s + apply_s + commit_s
                if lane_sum > 0:
                    self._metrics.apply_overlap_ratio.set(
                        max(0.0, 1.0 - wall / lane_sum))
                return state, applied
        except (_replay.WindowSyncError, _replay.WindowDeviceError):
            # apply failed, or the card did: authoritative attribution,
            # no strict retry
            self._metrics.blocks_applied.inc(applied, path="pipelined")
            raise
        finally:
            self._drain(gen, gdbs)
        # ---- fallback ladder L1/L2: strict sequential tail ----------------
        # blocks[:applied] stay applied and durable (the drain flushed
        # them); the rest of the stable prefix re-runs the reference
        # path with per-height WindowSyncError attribution
        with self._cond:
            self.windows_degraded += 1
        self._metrics.blocks_applied.inc(applied, path="pipelined")
        state, total = _replay._strict_sequential(
            executor, store, state, blocks[applied:k],
            certifiers[applied:k], chain_id, applied0=applied)
        self._metrics.blocks_applied.inc(total - applied, path="strict")
        return state, total

    # -- window bookkeeping ------------------------------------------------

    def _begin_window(self) -> int:
        with self._cond:
            self._gen += 1
            self._write_fault = None
            self._commit_s = 0.0
            return self._gen

    def _group_dbs(self, executor, store) -> List[GroupCommitDB]:
        """The stores' group-commit wrappers, in durability order:
        block store FIRST, state store second — a crash between the two
        leaves the block store ahead, never the state store."""
        out = []
        bdb = getattr(store, "db", None)
        if isinstance(bdb, GroupCommitDB):
            out.append(bdb)
        sdb = getattr(getattr(executor, "state_store", None), "db", None)
        if isinstance(sdb, GroupCommitDB) and sdb is not bdb:
            out.append(sdb)
        return out

    def _next_staged(self, gen: int) -> _Staged:
        deadline = time.monotonic() + self._stage_timeout_s
        while not self.quitting.is_set():
            try:
                staged = self._staged_q.get(timeout=0.1)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise PipelineFault("stage handoff starved")
                continue
            if staged.gen == gen:
                return staged
            # stale item from an aborted window: drop
        raise PipelineFault("pipeline stopping")

    def _resolve_verify(self, staged: _Staged, dev) -> bool:
        """All-valid verdict for the staged block's signature batch,
        with verify_items' exact fallback semantics when the scheduler
        sheds/stops/times out mid-flight.  A card fault is raised as it
        is: nothing is re-verified for it."""
        from tendermint_tpu_torch.blocksync import replay as _replay
        from tendermint_tpu_torch.crypto import scheduler as vsched

        if staged.ok is not None:
            return staged.ok
        try:
            s = vsched.running_on(dev)
            timeout = s.sync_timeout() if s is not None \
                else _VERIFY_RESULT_TIMEOUT_S
            bits = staged.future.result(timeout=timeout)
            staged.bits = bits
            staged.ok = bool(bits.all())
        except Exception as e:  # noqa: BLE001 - scheduler shed/stop/timeout
            if _replay.card_fault(e):
                raise
            try:
                ok, bits = vsched.verify_items(staged.items,
                                               vsched.Priority.BLOCKSYNC,
                                               device=dev)
                staged.bits = bits
                staged.ok = bool(ok)
            except Exception as e2:  # noqa: BLE001 - malformed item class
                if _replay.card_fault(e2):
                    raise
                # treat as a verify failure: the strict tail re-checks
                # this block and attributes the height properly
                staged.ok = False
        return staged.ok

    def _enqueue_group(self, gen: int, gdbs, height: int,
                       base: Optional[int] = None):
        """Hand the current buffered generation of every store to the
        async writer as one ordered job.  Writer fault or backpressure
        timeout degrades the window (caller drains synchronously)."""
        with self._cond:
            fault = self._write_fault
        if fault is not None:
            raise PipelineFault(f"storage writer fault: {fault}")
        groups = []
        for gdb in gdbs:
            g = gdb.take_group()
            if g is not None:
                groups.append((gdb, g))
        if not groups:
            return
        job = _WriteJob(gen, height, groups, base=base)
        try:
            self._write_q.put(job, timeout=_WRITE_ENQ_TIMEOUT_S)
        except queue.Full:
            raise PipelineFault("storage writer backlogged") from None
        with self._cond:
            self._jobs_enqueued += 1

    def _finish_window(self, gen: int, gdbs, last_height: int,
                       base: Optional[int] = None):
        """End-of-window barrier: enqueue the tail group, wait for the
        writer to drain, surface any writer fault as a PipelineFault
        (the finally-drain then recovers synchronously)."""
        if not gdbs:
            return
        self._enqueue_group(gen, gdbs, last_height, base=base)
        deadline = time.monotonic() + _WRITE_ENQ_TIMEOUT_S
        with self._cond:
            while (self._jobs_done < self._jobs_enqueued
                   and self._write_fault is None):
                if not self._cond.wait(timeout=0.2) and \
                        time.monotonic() > deadline:
                    raise PipelineFault("storage writer stalled")
            if self._write_fault is not None:
                raise PipelineFault(
                    f"storage writer fault: {self._write_fault}")

    def _drain(self, gen: int, gdbs):
        """Leave the window: invalidate outstanding stage work and make
        every buffered write durable synchronously (recovery path).
        Always runs — success, fault, and error exits all converge
        here, so group mode never leaks past a window."""
        with self._cond:
            self._gen += 1
            self._cond.notify_all()
        # wait for the writer to finish/skip in-flight jobs so the
        # synchronous flush below cannot interleave with an async
        # commit of the same groups (commit order is the invariant)
        deadline = time.monotonic() + _WRITE_ENQ_TIMEOUT_S
        with self._cond:
            while self._jobs_done < self._jobs_enqueued:
                if not self._cond.wait(timeout=0.2) and \
                        time.monotonic() > deadline:
                    break
        for gdb in gdbs:
            gdb.end_group_mode()   # flushes leftovers oldest-first

    def flush(self):
        """Public persistence barrier: everything accepted so far is
        durable when this returns.  Group mode is scoped to a window
        (every exit path drains), so outside replay this is a no-op."""
        with self._cond:
            while (self._jobs_done < self._jobs_enqueued
                   and not self.quitting.is_set()):
                self._cond.wait(timeout=0.2)

    # -- stage worker --------------------------------------------------

    def _stage_main(self):
        from tendermint_tpu_torch.blocksync import replay as _replay
        from tendermint_tpu_torch.crypto import scheduler as vsched

        while not self.quitting.is_set():
            try:
                task = self._stage_q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._cond:
                live = task.gen == self._gen
            if not live:
                continue
            staged = _Staged(task.gen, task.index, task.height)
            t0 = time.perf_counter()
            try:
                with trace.span("pipeline.stage", height=task.height,
                                index=task.index):
                    fail.inject("pipeline.stage")
                    bid, parts, prefix_items, lc_items = \
                        _replay._collect_block_items(
                            task.state0, task.state0.chain_id,
                            task.block, task.cert, task.height,
                            task.first)
                    staged.bid = bid
                    staged.parts = parts
                    # prefix always rides this block's batch (no
                    # covered-dedupe: a block may never apply before
                    # its OWN certifier verified; the SigCache and the
                    # scheduler's dedupe absorb the overlap with the
                    # next block's LastCommit lanes)
                    staged.items = prefix_items + lc_items
                    s = vsched.running_on(task.device)
                    if s is not None:
                        try:
                            staged.future = s.submit(
                                staged.items, vsched.Priority.BLOCKSYNC)
                        except Exception:  # noqa: BLE001 - submit is
                            # documented raise-free; insurance so an
                            # unexpected scheduler error costs one
                            # sync verify, not the window's tail
                            s = None
                    if s is None:
                        ok, bits = vsched.verify_items(
                            staged.items, vsched.Priority.BLOCKSYNC,
                            device=task.device)
                        staged.ok = bool(ok)
                        staged.bits = bits
            except Exception as e:  # noqa: BLE001 - surfaced to apply loop
                staged.error = e
            staged.stage_s = time.perf_counter() - t0
            while not self.quitting.is_set():
                with self._cond:
                    if task.gen != self._gen:
                        break   # window aborted while we staged
                try:
                    self._staged_q.put(staged, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- async storage writer -------------------------------------------

    def _writer_main(self):
        while not self.quitting.is_set():
            try:
                job = self._write_q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._cond:
                faulted = self._write_fault is not None
            err = None
            dt = 0.0
            if not faulted:
                t0 = time.perf_counter()
                try:
                    with trace.span("pipeline.commit", height=job.height,
                                    groups=len(job.groups)):
                        fail.inject("pipeline.commit")
                        for gdb, group in job.groups:
                            gdb.commit_group(group)
                except Exception as e:  # noqa: BLE001 - degrade, not die
                    err = e
                dt = time.perf_counter() - t0
            with self._cond:
                self._jobs_done += 1
                if err is not None and self._write_fault is None:
                    self._write_fault = err
                prev_durable = self._durable_height
                if err is None and not faulted:
                    self._durable_height = max(self._durable_height,
                                               job.height)
                    self._commit_s += dt
                self._cond.notify_all()
            if err is None and not faulted:
                self._metrics.group_commit_seconds.observe(dt)
                # group-commit durable ack for every height this job
                # newly made durable (the observatory's `persist`
                # stage, ADR-020) — stamped and published holding
                # nothing.  job.base bounds attribution to the heights
                # the group actually covered: prev_durable alone would
                # mint junk records below the first group of a run
                from tendermint_tpu_torch.consensus import observatory as obsv
                if obsv.is_enabled():
                    t_ack = time.monotonic()
                    for h in range(max(prev_durable + 1, job.base),
                                   job.height + 1):
                        obsv.stamp(self.obs_node, h, "durable", t=t_ack)
                    obsv.publish_pending()
        # shutdown: surrender queued jobs without committing — their
        # groups stay tracked in the gdbs and the window's drain/flush
        # owns them now; marking them done unblocks the drain barrier
        # (committing here instead could interleave with that flush
        # and land groups out of order)
        while True:
            try:
                job = self._write_q.get_nowait()
            except queue.Empty:
                break
            with self._cond:
                self._jobs_done += 1
                self._cond.notify_all()


# ---------------------------------------------------------------------------
# process-global install (node-wired; config wins over env both ways)
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()
_installed: Optional[BlockPipeline] = None


def install(p: Optional[BlockPipeline]) -> Optional[BlockPipeline]:
    """Install (or with None, uninstall) the process-global pipeline.
    Returns the previous one (caller stops it if still running)."""
    global _installed
    with _install_lock:
        old = _installed
        _installed = p
    return old


def installed() -> Optional[BlockPipeline]:
    with _install_lock:
        return _installed


def running() -> Optional[BlockPipeline]:
    """The installed pipeline iff it is enabled and running."""
    p = installed()
    if p is not None and p.enabled and p.is_running():
        return p
    return None


def set_config(enable: Optional[bool] = None, depth: Optional[int] = None,
               group_commit_heights: Optional[int] = None
               ) -> Optional[BlockPipeline]:
    """Node wiring seam: explicit arguments win over the TM_TPU_* env
    knobs in both directions (None = fall back to env/default).  With
    enable resolving False, any installed pipeline is stopped and
    uninstalled; otherwise one is created/updated, installed and
    started."""
    if enable is None:
        enable = os.environ.get("TM_TPU_BLOCK_PIPELINE", "1") != "0"
    if depth is None:
        depth = int(os.environ.get("TM_TPU_PIPELINE_DEPTH", "4"))
    if group_commit_heights is None:
        group_commit_heights = int(
            os.environ.get("TM_TPU_GROUP_COMMIT_HEIGHTS", "8"))
    if not enable:
        old = install(None)
        if old is not None and old.is_running():
            old.stop()
        return None
    p = installed()
    if p is not None and p.is_running() and int(depth) == p.depth:
        # live reconfiguration: the stage handoff bound (depth) is
        # baked into the queue, so only same-depth updates apply in
        # place; a depth change below rebuilds the service
        p.group_commit_heights = int(group_commit_heights)
        p.enabled = True
        return p
    if p is not None and p.is_running():
        p.stop()
    p = BlockPipeline(depth=depth,
                      group_commit_heights=group_commit_heights,
                      enabled=True)
    install(p)
    p.start()
    return p
