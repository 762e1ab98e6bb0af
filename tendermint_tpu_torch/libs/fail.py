"""Fault injection: indexed crash points + named chaos modes.

The counterpart of tendermint_tpu/libs/fail.py.  Two mechanisms share
this module:

1. Indexed fail points (reference libs/fail/fail.go:28-39): call sites
   are numbered in execution order by a process-global counter; when the
   counter reaches $FAIL_TEST_INDEX the process dies immediately.

2. Named, mode-keyed injection for the device-lane chaos matrix
   (crypto/degrade.py, tests/test_torch_chaos.py).  A site like
   "ops.ed25519.verify_batch" calls inject(site) on entry; an armed mode
   forces one failure class deterministically:

       raise          raise InjectedFault at the site
       latency:<ms>   sleep <ms> before proceeding (drives the launch
                      deadline in the degradation runtime)
       corrupt-bitmap invert the device result bitmap (exercises the
                      runtime's host spot-check integrity guard)
       exit           os._exit(77), the crash-matrix convention

   Armed programmatically (set_mode / clear) for in-process tests, or
   via $TM_TPU_FAILPOINTS="site=mode;site2=mode" for subprocess tests;
   site "*" matches every site.  fired() exposes hit counts so tests
   can assert the injection actually triggered.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

_counter = 0
_lock = threading.Lock()

_modes: Dict[str, str] = {}
_fired: Dict[Tuple[str, str], int] = {}

# ---------------------------------------------------------------------------
# the chaos-site registry.  Every fail.inject/corrupt_bitmap call site of
# the package appears here; set_mode() refuses to arm an unregistered
# site, so a typo'd chaos test fails loudly instead of silently never
# injecting.  Tests register throwaway sites with register().
# ---------------------------------------------------------------------------

REGISTERED_SITES = frozenset({
    # the device-kernel entry seams: ops/ed25519.verify_batch (the
    # per-signature, split and RLC routes all start behind it), and the
    # sr25519 and secp256k1 lanes' (ops/sr25519.py, ops/secp.py); each
    # fires before any staging or launch
    "ops.ed25519.verify_batch",
    "ops.sr25519.verify_batch",
    "ops.secp.verify_batch",
    # the fixed-base comb route inside ops/ed25519.verify_batch, after its
    # table lookup and before its staging and launches
    "ops.ed25519.comb",
    # the data planes (parallel/sharding.py): sharding.mesh_stage at the
    # top of a local plane's per-signature launch and sharding.mesh_comb
    # after its comb budget decision (raise = the batch degrades to the
    # single-device routes, exact bitmap), sharding.global_plane at the
    # top of the global plane's launch, before any collective (raise =
    # the local routes of this process)
    "sharding.mesh_stage",
    "sharding.mesh_comb",
    "sharding.global_plane",
    # degradation-runtime lane sites (crypto/degrade.py submit/run):
    # one per (consumer, scheme) lane — BatchVerifier's, the
    # VerifyScheduler's coalesced lanes and the whole-commit bulk path
    "batch.ed25519", "batch.sr25519", "batch.secp256k1",
    "sched.ed25519", "sched.sr25519", "sched.secp256k1",
    "bulk.ed25519",
    # host-lane pool (crypto/lanepool.py): the sharded native C verify
    # (raise/latency/corrupt-bitmap degrade to the serial in-caller
    # path with exact bitmaps) and the sharded Merkle leaf layer
    # (crypto/merkle.py: a raise recomputes the layer serially)
    "lanepool.verify",
    "merkle.bulk_hash",
    # the streaming part-set construction of types/part_set.py
    # make_block_parts (raise = the serial PartSet.from_data, with
    # byte-identical parts; latency = a slow split, absorbed)
    "propose.parts",
    # the mempool reap of state/execution.py create_proposal_block
    # (raise = an empty block, never a stalled round)
    "propose.reap",
    # the GroupCommitDB write seam of libs/kvdb.py commit_group (raise =
    # the taken group stays in flight, visible to readers, and the
    # synchronous flush() lands it)
    "kvdb.group_commit",
    # consensus observatory (consensus/observatory.py): fires on every
    # stamp/receipt.  raise = the recording sheds (counted in
    # consensus_observatory_shed_total{reason=chaos}) while the state
    # machine it observes proceeds untouched
    "observatory.record",
    # device observatory (crypto/devobs.py): fires on every launch-record
    # store.  raise = the record sheds (counted in
    # crypto_devobs_shed_total{reason=chaos}) while the device launch and
    # its bitmap proceed untouched; latency is absorbed into the recording
    "devobs.record",
    # block application pipeline (state/pipeline.py): the stage worker's
    # per-block entry and the async storage writer's group-commit entry.
    # raise at either drains the pipeline and degrades the window to the
    # strict sequential path; latency exercises handoff backpressure
    "pipeline.stage",
    "pipeline.commit",
    # gossip observatory (p2p/netobs.py): fires on every flow/rtt/receipt
    # recording.  raise = the sample sheds (counted in
    # p2p_netobs_shed_total{reason=chaos}) while the frame's delivery
    # proceeds untouched
    "netobs.record",
    # light serving plane (light/service.py, ADR-026): light.serve
    # fires at the top of LightServe.submit (raise = the request
    # degrades to the synchronous in-caller direct path — the exact
    # verification the caller would run without the service, identical
    # verdicts); light.coalesce fires before the worker groups a
    # batch's certificate verifications (raise = the batch degrades to
    # per-request direct certificate checks with no dedupe, identical
    # verdicts)
    "light.serve",
    "light.coalesce",
    # mempool ingress gate (mempool/ingress.py, ADR-018): the submit
    # seam (raise = fall back to synchronous in-caller admission with
    # identical ResponseCheckTx results; latency = queue-wait), the
    # worker's batched CheckTx stage (raise = per-tx synchronous
    # fallback inside the worker), and the post-block recheck
    # scheduling seam (raise = recheck runs synchronously in update()
    # on the commit path, exactly the pre-gate behavior)
    "ingress.admit",
    "ingress.checktx",
    "ingress.recheck",
    # statesync (statesync/syncer.py, reactor.py): statesync.fetch fires
    # per chunk-fetch attempt on a fetcher thread (raise = a transport
    # fault charged to the picked peer's budget; latency = a slow fetch
    # against the per-chunk deadline; corrupt-chunk = the fetched bytes
    # flipped, so the pre-app digest check bans the sender and refetches
    # elsewhere), statesync.verify at the fetch thread's integrity check
    # (raise = a machinery fault, retried like a transport error; the
    # app never sees the chunk), statesync.apply before each
    # apply_snapshot_chunk (raise = the snapshot is rejected) and
    # statesync.serve in the serving side's worker (raise = the request
    # is answered busy with a Retry-After, the server stays up)
    "statesync.fetch",
    "statesync.verify",
    "statesync.apply",
    "statesync.serve",
    # adaptive control plane (libs/control.py): fires at the top of
    # every decision period.  raise = the whole period's decisions are
    # skipped (counted under knob=period, direction=skipped) and every
    # knob reverts to its static configured value: a malfunctioning
    # controller fails static, never steering; latency is absorbed into
    # the period
    "control.decide",
    # in-process virtual network + scenario harness (networks/):
    # vnet.deliver fires on every submitted frame (raise = the frame is
    # dropped as chaos loss, counted under reason=chaos), vnet.reorder
    # fires whenever a reorder decision triggers, vnet.partition fires on
    # every partition/heal transition, and harness.step fires at each
    # scenario-step boundary (raise = the scenario fails and dumps its
    # stitched trace artifact)
    "vnet.deliver",
    "vnet.partition",
    "vnet.reorder",
    "harness.step",
})

_extra_sites: set = set()


def register(site: str) -> str:
    """Register an ad-hoc site (tests, experiments).  Returns it."""
    with _lock:
        _extra_sites.add(site)
    return site


def is_registered(site: str) -> bool:
    if site == "*" or site in REGISTERED_SITES:
        return True
    with _lock:
        return site in _extra_sites


class InjectedFault(RuntimeError):
    """A chaos-injected device fault (mode "raise")."""


def _target() -> int:
    v = os.environ.get("FAIL_TEST_INDEX")
    return int(v) if v else -1


def fail_point(_site_id: int = 0):
    """Die (os._exit) if this is the $FAIL_TEST_INDEX-th fail point hit."""
    global _counter
    t = _target()
    if t < 0:
        return
    with _lock:
        current = _counter
        _counter += 1
    if current == t:
        os._exit(77)


def reset():
    """Back to a pristine state: counter, modes, hit counts, ad-hoc site
    registrations and the env-validation cache (a site one test
    registered must not let a later test's typo of the same name arm
    silently)."""
    global _counter, _env_validated
    with _lock:
        _counter = 0
        _modes.clear()
        _fired.clear()
        _extra_sites.clear()
    _env_validated = None


# ---------------------------------------------------------------------------
# named chaos modes
# ---------------------------------------------------------------------------

def set_mode(site: str, mode: Optional[str]):
    """Arm (or with mode=None disarm) an injection mode at a named site.
    The mode stays armed until cleared.  Arming an UNREGISTERED site
    raises (register ad-hoc test sites with register())."""
    if mode is not None and not is_registered(site):
        raise ValueError(
            f"fail site {site!r} is not registered (REGISTERED_SITES in "
            f"libs/fail.py, or fail.register)")
    with _lock:
        if mode is None:
            _modes.pop(site, None)
        else:
            _modes[site] = mode


def clear(site: Optional[str] = None):
    with _lock:
        if site is None:
            _modes.clear()
        else:
            _modes.pop(site, None)


def fired(site: str, mode: str) -> int:
    with _lock:
        return _fired.get((site, mode), 0)


def armed() -> bool:
    """Whether a chaos drill is on: a named mode is armed at some site,
    by set_mode or by $TM_TPU_FAILPOINTS.  On the card the degradation
    runtime re-verifies a failed launch on the host only then."""
    with _lock:
        if _modes:
            return True
    return any(v.strip() for _, _, v in
               (e.partition("=") for e in
                os.environ.get("TM_TPU_FAILPOINTS", "").split(";")))


_env_validated: Optional[str] = None


def _validate_env(env: str):
    """Every TM_TPU_FAILPOINTS key must be a registered site, checked
    once per distinct env value at the first inject() that reads it, so
    a typo surfaces loudly inside the armed process."""
    global _env_validated
    if env == _env_validated:
        return
    for entry in env.split(";"):
        k, _, v = entry.partition("=")
        k = k.strip()
        if v and k and k != "*" and not is_registered(k):
            raise ValueError(
                f"TM_TPU_FAILPOINTS site {k!r} is not registered "
                f"(REGISTERED_SITES in libs/fail.py)")
    _env_validated = env


def _mode_for(site: str) -> Optional[str]:
    with _lock:
        m = _modes.get(site) or _modes.get("*")
    if m is not None:
        return m
    env = os.environ.get("TM_TPU_FAILPOINTS", "")
    if not env:
        return None
    _validate_env(env)
    for entry in env.split(";"):
        k, _, v = entry.partition("=")
        if v and k.strip() in (site, "*"):
            return v.strip()
    return None


def _count(site: str, mode: str):
    with _lock:
        _fired[(site, mode)] = _fired.get((site, mode), 0) + 1


# result-transform modes: no-ops at the entry hook, applied by their
# dedicated result helpers (corrupt_bitmap / corrupt_bytes)
_RESULT_MODES = frozenset({"corrupt-bitmap", "corrupt-chunk"})


def inject(site: str):
    """Entry hook of a named fail-point site: raise / stall / die per the
    armed mode.  Result-transform modes are no-ops here."""
    mode = _mode_for(site)
    if mode is None or mode in _RESULT_MODES:
        return
    if mode == "raise":
        _count(site, mode)
        raise InjectedFault(f"injected fault at {site}")
    if mode.startswith("latency:"):
        _count(site, mode)
        time.sleep(float(mode.split(":", 1)[1]) / 1000.0)
        return
    if mode == "exit":
        _count(site, mode)
        os._exit(77)
    raise ValueError(f"unknown fail mode {mode!r} at {site}")


def corrupt_bitmap(site: str, bits):
    """Result hook of a device-lane site: under "corrupt-bitmap" return
    the inverted bitmap (a device replying with garbage), which the
    degradation runtime's host spot check must catch."""
    if _mode_for(site) == "corrupt-bitmap":
        import numpy as np
        _count(site, "corrupt-bitmap")
        return ~np.asarray(bits, dtype=bool)
    return bits


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Result hook of a byte-stream site: under "corrupt-chunk" flip the
    first byte (a peer serving garbage)."""
    if _mode_for(site) == "corrupt-chunk":
        _count(site, "corrupt-chunk")
        if not data:
            return b"\xff"
        return bytes([data[0] ^ 0xFF]) + bytes(data[1:])
    return data
