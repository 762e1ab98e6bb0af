"""The port's IngressGate (mempool/ingress.py) against the JAX package's,
on the CPU.

tests/test_ingress.py's cases (all but the RPC's busy mapping and the
node's wiring, which wait for the port's RPC server and node) run through
both packages as `case_*` functions; each returns its outcome as a
package-free value (ResponseCheckTx fields through `plain`, the gate's
stats without the port's own `device_error` key, the mempool metrics, the
app's call counts) and the outcomes are compared across the packages
exactly.  Counts that hang on thread timing (how many of a flood bounced)
are asserted in each package and left out of the outcome.  Every
scheduler is on host lanes (tpu_threshold high), as the JAX tests run it.
Then the port's departures: `device=` resolved when the gate is made (no
CUDA and no device="cpu" raises RuntimeError), the pre-verify only through
a scheduler running on the gate's device, and a pre-verify launch that
failed on the card (degrade.DeviceLaneError) at the gate's worker, at its
check_tx and under the reactor: the SIGTX futures raise it, the cache
claims are released, no `sig` rejection is counted, the plain txs of the
batch are admitted and the worker survives; in a chaos drill the runtime
re-verifies on the host and the gate's verdicts are the JAX package's.  And
a tx bounced by a verify shed keeps its Retry-After hint, which the JAX
package's settlement clears.
"""
from __future__ import annotations

import functools
import importlib
import threading
import time
import types

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "abci": "abci.types", "kvstore": "abci.kvstore", "ed": "crypto.ed25519",
    "sched": "crypto.scheduler", "degrade": "crypto.degrade",
    "fail": "libs.fail", "slo": "libs.slo", "metrics": "libs.metrics",
    "ing": "mempool.ingress", "mempool": "mempool.mempool",
    "pmempool": "mempool.priority_mempool", "reactor": "mempool.reactor",
}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)
BY_NAME = {p.name: p for p in PKGS}


def _reset():
    for p in PKGS:
        p.fail.reset()
        p.ing.set_enabled(None)
        s = p.sched.installed()
        if s is not None:
            if s.is_running():
                s.stop()
            p.sched.uninstall(s)


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


class EchoApp:
    """tests/test_ingress.py's EchoApp for package `p`: CheckTx accepts
    everything except txs starting with b'bad'; counts calls; optional
    per-call delay / raise."""

    def __init__(self, p, delay_s: float = 0.0):
        self.abci = p.abci
        self.delay_s = delay_s
        self.calls = 0
        self.raise_on = None
        self._lock = threading.Lock()

    def check_tx(self, req):
        with self._lock:
            self.calls += 1
        if self.raise_on is not None and req.tx.startswith(self.raise_on):
            raise RuntimeError("app exploded")
        if self.delay_s:
            time.sleep(self.delay_s)
        if req.tx.startswith(b"bad") or b"\x00bad" in req.tx[:110]:
            return self.abci.ResponseCheckTx(code=10, log="app says no")
        return self.abci.ResponseCheckTx(code=self.abci.CODE_TYPE_OK,
                                         gas_wanted=1)


class Gates:
    """tests/test_ingress.py's gate_factory and sched_factory for package
    `p`: gates on private mempools, schedulers on host lanes; all stopped
    by close()."""

    def __init__(self, p):
        self.p = p
        self.gates = []
        self.scheds = []

    def gate(self, app=None, mempool=None, start=True, **kw):
        p = self.p
        mp = mempool if mempool is not None else p.mempool.Mempool(
            app or EchoApp(p), registry=p.metrics.Registry())
        g = p.ing.IngressGate(mp, **kw).attach()
        self.gates.append(g)
        if start:
            g.start()
        return g, mp

    def sched(self, **kw):
        kw.setdefault("tpu_threshold", 10 ** 9)
        s = self.p.sched.VerifyScheduler(**kw)
        self.scheds.append(s)
        self.p.sched.install(s)
        s.start()
        return s

    def close(self):
        for g in self.gates:
            g.stop()
        for s in self.scheds:
            s.stop()
        self.p.sched.uninstall()


def _privs(p):
    return [p.ed.PrivKey(bytes([(i * 11 + 5) % 255 + 1]) * 32)
            for i in range(8)]


def _sigtx(p, i: int, tag: bytes = b"flood") -> bytes:
    privs = _privs(p)
    return p.ing.make_signed_tx(privs[i % len(privs)],
                                tag + b" payload %06d" % i)


def _consensus_triples(p, n: int, tag: bytes = b"vote"):
    privs = _privs(p)
    msgs = [tag + b" sign bytes %06d" % i for i in range(n)]
    return [(privs[i % len(privs)].pub_key(), msgs[i],
             privs[i % len(privs)].sign(msgs[i])) for i in range(n)]


def _stats(g) -> dict:
    """The gate's stats without the port's own key (0 on these paths)."""
    st = dict(g.stats())
    assert st.pop("device_error", 0) == 0
    return st


_REASONS = ("full", "busy", "cache", "ratelimit", "sig", "app_err",
            "toolarge")


def _mp_metrics(mp) -> dict:
    m = mp.metrics
    return {"rejected": {r: m.rejected_txs.value(reason=r)
                         for r in _REASONS},
            "failed": m.failed_txs.value(),
            "recheck": m.recheck_times.value()}


# ---------------------------------------------------------------------------
# tests/test_ingress.py's cases
# ---------------------------------------------------------------------------

def case_gate_results_identical_to_synchronous_path(p):
    gs = Gates(p)
    try:
        mp = p.mempool.Mempool(EchoApp(p), registry=p.metrics.Registry(),
                               size_limit=3)
        g, _mp = gs.gate(mempool=mp)
        twin = p.mempool.Mempool(EchoApp(p), registry=p.metrics.Registry(),
                                 size_limit=3)
        txs = ([b"ok-0", b"ok-0"] + [b"bad-app"]
               + [b"x" * (g.mempool.max_tx_bytes + 1)]
               + [b"ok-1", b"ok-2"] + [b"ok-late"])
        got = [g.check_tx(t, timeout=10.0) for t in txs]
        want = [twin.check_tx(t) for t in txs]
        assert got == want
        assert [r.log for r in want] == ["", "tx already in cache",
                                         "app says no", "tx too large",
                                         "", "", "mempool is full"]
        st = _stats(g)
    finally:
        gs.close()
    return {"got": got, "stats": st, "metrics": _mp_metrics(mp),
            "twin": _mp_metrics(twin)}


def case_checktx_cache_poisoning_regression(p):
    app = EchoApp(p)
    app.raise_on = b"boom"
    mp = p.mempool.Mempool(app, registry=p.metrics.Registry())
    res = mp.check_tx(b"boom-tx")
    assert res.code == p.mempool.CODE_APP_EXCEPTION
    assert "check_tx failed" in res.log and app.calls == 1
    app.raise_on = None
    res2 = mp.check_tx(b"boom-tx")
    assert res2.is_ok() and app.calls == 2
    assert mp.size() == 1
    return {"res": [res, res2], "metrics": _mp_metrics(mp)}


def case_priority_mempool_cache_poisoning_regression(p):
    abci = p.abci

    class PrioBoom:
        def __init__(self):
            self.calls = 0
            self.armed = True

        def check_tx(self, req):
            self.calls += 1
            if self.armed:
                raise RuntimeError("v1 app exploded")
            return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, priority=1)
    app = PrioBoom()
    mp = p.pmempool.PriorityMempool(app, registry=p.metrics.Registry())
    res = mp.check_tx(b"\x05\x00v1-boom")
    assert res.code == p.mempool.CODE_APP_EXCEPTION
    app.armed = False
    res2 = mp.check_tx(b"\x05\x00v1-boom")
    assert res2.is_ok() and app.calls == 2
    return {"res": [res, res2], "metrics": _mp_metrics(mp)}


def case_app_code_2_rejection_is_not_poisoned(p):
    abci = p.abci

    class Code2App:
        def __init__(self):
            self.calls = 0
            self.accept = False

        def check_tx(self, req):
            self.calls += 1
            if self.accept:
                return abci.ResponseCheckTx(code=0, priority=1)
            return abci.ResponseCheckTx(code=2, log="app code 2")

    out = []
    for mk in (lambda a: p.mempool.Mempool(a, registry=p.metrics.Registry()),
               lambda a: p.pmempool.PriorityMempool(
                   a, registry=p.metrics.Registry())):
        app = Code2App()
        mp = mk(app)
        res = mp.check_tx(b"code2-tx")
        assert res.code == 2 and res.log == "app code 2"
        app.accept = True
        res2 = mp.check_tx(b"code2-tx")
        assert res2.is_ok() and app.calls == 2
        out.append({"res": [res, res2], "metrics": _mp_metrics(mp)})
    return out


def case_app_call_runs_outside_the_mempool_lock(p):
    app = EchoApp(p, delay_s=0.4)
    mp = p.mempool.Mempool(app, registry=p.metrics.Registry())
    t = threading.Thread(target=mp.check_tx, args=(b"slow-tx",),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 2.0
    while app.calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert app.calls == 1
    t0 = time.monotonic()
    mp.size(), mp.reap_max_txs(-1), mp.txs_after(0)
    assert time.monotonic() - t0 < 0.2
    t.join(timeout=2.0)
    assert not t.is_alive() and mp.size() == 1
    return {"size": mp.size(), "calls": app.calls,
            "reaped": mp.reap_max_txs(-1)}


def case_queue_full_rejects_busy_with_retry_hint(p):
    gs = Gates(p)
    try:
        p.fail.set_mode("ingress.checktx", "latency:150")
        g, mp = gs.gate(queue_size=4, batch=2)
        futs = [g.submit(b"q-%d" % i) for i in range(12)]
        busy = [f for f in futs if f.done() and f.retry_after_s is not None]
        assert busy
        busy_res = set()
        for f in busy:
            r = f.result(timeout=0)
            assert r.code == 1 and r.codespace == "ingress"
            assert r.log == "mempool is busy" and f.retry_after_s > 0
            busy_res.add((r.code, r.codespace, r.log))
        deadline = time.monotonic() + 5.0
        while not p.fail.fired("ingress.checktx", "latency:150") and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert p.fail.fired("ingress.checktx", "latency:150") >= 1
        assert mp.metrics.rejected_txs.value(reason="busy") >= len(busy)
        p.fail.clear()
        settled = [f.result(timeout=10.0) is not None for f in futs]
    finally:
        gs.close()
    return {"busy": sorted(busy_res), "settled": settled}


def case_per_source_rate_limit_fairness(p):
    gs = Gates(p)
    try:
        g, mp = gs.gate(queue_size=4096, rate_per_s=25.0, burst=5)
        flood_rejected = []
        nice_results = []

        def flood(k):
            for i in range(60):
                f = g.submit(b"fl-%d-%d" % (k, i), source="p2p:flooder")
                if f.done() and f.retry_after_s is not None:
                    flood_rejected.append(f)

        def nice(k):
            f = g.submit(b"ni-%d" % k, source=f"p2p:nice{k}")
            nice_results.append(f.result(timeout=10.0))

        threads = [threading.Thread(target=flood, args=(k,))
                   for k in range(6)]
        threads += [threading.Thread(target=nice, args=(k,))
                    for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(flood_rejected) >= 300
        for r in nice_results:
            assert r.is_ok(), r
        assert mp.metrics.rejected_txs.value(reason="ratelimit") \
            >= len(flood_rejected)
        assert g.stats()["ratelimited"] == len(flood_rejected)
        logs = sorted({(f.result(0).code, f.result(0).codespace,
                        f.result(0).log) for f in flood_rejected})
    finally:
        gs.close()
    return {"nice": nice_results, "flood_logs": logs}


def _twin_case(p, site, mode, prefix):
    gs = Gates(p)
    try:
        p.fail.set_mode(site, mode)
        g, mp = gs.gate(app=EchoApp(p))
        twin = p.mempool.Mempool(EchoApp(p), registry=p.metrics.Registry())
        txs = [prefix + b"-%d" % i for i in range(3)] + [
            prefix + b"-0", b"bad-" + prefix]
        got = [g.check_tx(t, timeout=10.0) for t in txs]
        want = [twin.check_tx(t) for t in txs]
        assert got == want
        fired = p.fail.fired(site, mode)
        st = _stats(g)
    finally:
        gs.close()
    return got, fired, st, mp, g


def case_chaos_ingress_admit_raise(p):
    got, fired, st, _, g = _twin_case(p, "ingress.admit", "raise", b"adm")
    assert fired >= 5 and st["submitted"] == 5 and g.depth() == 0
    return {"got": got, "stats": st}


def case_chaos_ingress_admit_latency(p):
    got, fired, st, _, _ = _twin_case(p, "ingress.admit", "latency:60",
                                      b"adm")
    assert fired >= 5
    return {"got": got, "submitted": st["submitted"]}


def case_chaos_ingress_checktx_raise(p):
    got, fired, st, mp, _ = _twin_case(p, "ingress.checktx", "raise",
                                       b"ctx")
    assert fired >= 1 and st["fallback_batches"] >= 1 and mp.size() == 3
    return {"got": got, "size": mp.size()}


def case_chaos_ingress_checktx_latency(p):
    got, fired, _, mp, _ = _twin_case(p, "ingress.checktx", "latency:60",
                                      b"ctx")
    assert fired >= 1 and mp.size() == 3
    return {"got": got, "size": mp.size()}


def _chaos_recheck(p, mode):
    abci = p.abci

    class StaleApp(EchoApp):
        def __init__(self):
            super().__init__(p)
            self.stale = False

        def check_tx(self, req):
            if self.stale and req.type == abci.CheckTxType.RECHECK:
                return abci.ResponseCheckTx(code=1, log="stale")
            return super().check_tx(req)

    gs = Gates(p)
    try:
        app = StaleApp()
        g, mp = gs.gate(app=app, recheck_slice=4)
        for i in range(5):
            assert g.check_tx(b"rc-%d" % i, timeout=10.0).is_ok()
        assert mp.size() == 5
        app.stale = True
        p.fail.set_mode("ingress.recheck", mode)
        mp.lock()
        try:
            mp.update(2, [])
        finally:
            mp.unlock()
        assert p.fail.fired("ingress.recheck", mode) == 1
        size_after_update = mp.size()
        if mode == "raise":
            assert size_after_update == 0
        else:
            deadline = time.monotonic() + 10.0
            while mp.size() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert mp.size() == 0
    finally:
        gs.close()
    return {"size": mp.size(), "metrics": _mp_metrics(mp),
            "after_update": size_after_update if mode == "raise" else None}


def case_chaos_ingress_recheck_raise(p):
    return _chaos_recheck(p, "raise")


def case_chaos_ingress_recheck_latency(p):
    return _chaos_recheck(p, "latency:60")


def case_update_returns_in_o_committed_with_gate_attached(p):
    gs = Gates(p)
    try:
        app = EchoApp(p, delay_s=0.02)
        g, mp = gs.gate(app=app, recheck_slice=8)
        app.delay_s = 0.0
        for i in range(30):
            assert g.check_tx(b"res-%d" % i, timeout=10.0).is_ok()
        app.delay_s = 0.02
        mp.lock()
        try:
            t0 = time.monotonic()
            mp.update(3, [])
            dt = time.monotonic() - t0
        finally:
            mp.unlock()
        assert dt < 0.2, f"update() held the commit path {dt:.3f}s"
        deadline = time.monotonic() + 20.0
        while g.stats()["rechecked"] < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g.stats()["rechecked"] >= 30
        st = _stats(g)
    finally:
        gs.close()
    return {"rechecked": st["rechecked"], "size": mp.size(),
            "metrics": _mp_metrics(mp)}


def case_preverify_rejects_refuted_signature_before_the_app(p):
    gs = Gates(p)
    try:
        gs.sched()
        app = EchoApp(p)
        g, mp = gs.gate(app=app)
        good = _sigtx(p, 1, tag=b"pv-good")
        bad = bytearray(_sigtx(p, 2, tag=b"pv-bad"))
        bad[len(p.ing.SIGTX_MAGIC) + 32] ^= 0x01
        bad = bytes(bad)
        r_good = g.check_tx(good, timeout=30.0)
        r_bad = g.check_tx(bad, timeout=30.0)
        assert r_good.is_ok()
        assert r_bad.code == 1 and r_bad.log == "invalid signature"
        assert mp.metrics.rejected_txs.value(reason="sig") == 1
        assert app.calls == 1
        again = g.check_tx(good, timeout=30.0)
        assert again.log == "tx already in cache"
        st = _stats(g)
    finally:
        gs.close()
    return {"res": [r_good, r_bad, again], "stats": st,
            "metrics": _mp_metrics(mp), "calls": app.calls}


def case_preverify_skipped_when_scheduler_absent(p):
    gs = Gates(p)
    try:
        app = EchoApp(p)
        g, _ = gs.gate(app=app)
        res = g.check_tx(_sigtx(p, 3, tag=b"nosched"), timeout=10.0)
        assert res.is_ok() and app.calls == 1
    finally:
        gs.close()
    return {"res": res, "calls": app.calls}


def case_flood_cannot_starve_consensus_verifies(p):
    gs = Gates(p)
    s = gs.sched(window_s=0.001, max_pending=4)
    app = EchoApp(p)
    g, mp = gs.gate(app=app, queue_size=48, batch=8, workers=2)
    metrics = p.degrade.runtime().metrics
    shed_before = metrics.sched_shed_total.value(priority="mempool")
    cons_shed_before = metrics.sched_shed_total.value(priority="consensus")
    p.slo.set_config(enabled=True, window=256, targets={"mempool": 0.25})
    stop = threading.Event()
    depth_samples = []
    cons = {"rounds": 0, "err": [], "commit_dt": []}
    flood_txs = [[_sigtx(p, k * 1000 + i, tag=b"fl%d" % k)
                  for i in range(60)] for k in range(4)]
    raw_txs = [b"raw-flood-%04d" % i for i in range(120)]
    triples = _consensus_triples(p, 12)

    def flooder(k):
        while not stop.is_set():
            for tx in flood_txs[k]:
                g.submit(tx, source=f"p2p:peer{k}")
            depth_samples.append(g.depth())
            for tx in raw_txs[k * 30:(k + 1) * 30]:
                g.submit(tx, source="rpc")

    def consensus_loop():
        while cons["rounds"] < 6:
            ok, bits = p.sched.verify_items(
                triples, p.sched.Priority.CONSENSUS,
                deadline=time.monotonic() + 0.005)
            if not (ok and bits.all()):
                cons["err"].append(bits)
                return
            cons["rounds"] += 1
            mp.lock()
            try:
                t0 = time.monotonic()
                mp.update(cons["rounds"], [])
                cons["commit_dt"].append(time.monotonic() - t0)
            finally:
                mp.unlock()

    threads = [threading.Thread(target=flooder, args=(k,), daemon=True)
               for k in range(4)]
    ct = threading.Thread(target=consensus_loop)
    try:
        for t in threads:
            t.start()
        ct.start()
        ct.join(timeout=60.0)
        assert not ct.is_alive(), \
            "consensus preverify starved by the mempool flood"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        p.slo.set_config(enabled=False)
        gs.close()
    assert s is not None and not cons["err"] and cons["rounds"] == 6
    assert max(cons["commit_dt"]) < 0.5, cons["commit_dt"]
    assert metrics.sched_shed_total.value(priority="consensus") \
        == cons_shed_before
    assert metrics.sched_shed_total.value(priority="mempool") > shed_before
    assert g.stats()["preverify_shed"] > 0
    assert g.stats()["device_error"] == 0 if p is PORT else True
    assert mp.metrics.rejected_txs.value(reason="busy") > 0
    assert depth_samples and max(depth_samples) <= g.queue_size
    assert mp.metrics.admission_latency.count() > 0
    rep = p.slo.stream_report("mempool")
    assert rep is not None and rep["n"] > 0
    return {"rounds": cons["rounds"], "consensus_shed": 0,
            "mempool_shed": True, "queue_bound": g.queue_size}


def case_reactor_routes_through_gate_and_throttles(p):
    class FakePeer:
        id = "peer-a"

    gs = Gates(p)
    try:
        p.fail.set_mode("ingress.checktx", "latency:100")
        g, mp = gs.gate(queue_size=2, batch=1)
        reactor = p.reactor.MempoolReactor(mp, gate=g)
        reactor.THROTTLE_S = 0.05
        msg = p.reactor.encode_msg(
            p.reactor.TxsMessage([b"gs-%d" % i for i in range(6)]))
        t0 = time.monotonic()
        reactor.receive(0x30, FakePeer(), msg)
        dt = time.monotonic() - t0
        assert dt >= reactor.THROTTLE_S
        p.fail.clear()
        deadline = time.monotonic() + 10.0
        while mp.size() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mp.size() >= 2
    finally:
        gs.close()
    return {"msg": msg, "landed": mp.size() >= 2}


def case_sigtx_envelope_roundtrip_and_hostile_bytes(p):
    priv = _privs(p)[0]
    tx = p.ing.make_signed_tx(priv, b"payload")
    pub, msg, sig = p.ing.parse_signed_tx(tx)
    assert pub == priv.pub_key().bytes()
    assert priv.pub_key().verify_signature(msg, sig)
    assert p.ing.parse_signed_tx(b"not an envelope") is None
    assert p.ing.parse_signed_tx(p.ing.SIGTX_MAGIC) is None
    assert p.ing.parse_signed_tx(b"") is None
    return {"tx": tx, "parsed": (pub, msg, sig)}


def case_gate_stop_settles_pending_as_busy(p):
    gs = Gates(p)
    try:
        p.fail.set_mode("ingress.checktx", "latency:300")
        g, _ = gs.gate(queue_size=16, batch=1)
        futs = [g.submit(b"st-%d" % i) for i in range(8)]
        g.stop()
        p.fail.clear()
        res = [f.result(timeout=5.0) for f in futs]
    finally:
        gs.close()
    for r in res:
        assert r.code == 0 or r.codespace == "ingress"
    stopping = [r for r in res if r.codespace == "ingress"]
    assert stopping
    return {"stopping": sorted({(r.code, r.log) for r in stopping})}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_gate_results_identical_to_synchronous_path,
    case_checktx_cache_poisoning_regression,
    case_priority_mempool_cache_poisoning_regression,
    case_app_code_2_rejection_is_not_poisoned,
    case_app_call_runs_outside_the_mempool_lock,
    case_queue_full_rejects_busy_with_retry_hint,
    case_per_source_rate_limit_fairness,
    case_chaos_ingress_admit_raise,
    case_chaos_ingress_admit_latency,
    case_chaos_ingress_checktx_raise,
    case_chaos_ingress_checktx_latency,
    case_chaos_ingress_recheck_raise,
    case_chaos_ingress_recheck_latency,
    case_update_returns_in_o_committed_with_gate_attached,
    case_preverify_rejects_refuted_signature_before_the_app,
    case_preverify_skipped_when_scheduler_absent,
    case_flood_cannot_starve_consensus_verifies,
    case_reactor_routes_through_gate_and_throttles,
    case_sigtx_envelope_roundtrip_and_hostile_bytes,
    case_gate_stop_settles_pending_as_busy)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    _reset()
    try:
        return plain(CASES[case](BY_NAME[name]))
    finally:
        _reset()


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_ingress_case(case, pkg):
    """tests/test_ingress.py's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_ingress_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


def test_envelope_crosses_packages():
    """A SIGTX envelope made by either package parses to the same triple
    in the other, and the same key signs the same bytes."""
    a = JAX.ing.make_signed_tx(_privs(JAX)[3], b"k1=v1")
    b = PORT.ing.make_signed_tx(_privs(PORT)[3], b"k1=v1")
    assert a == b
    assert JAX.ing.parse_signed_tx(b) == PORT.ing.parse_signed_tx(a)


def test_enable_switch_in_both_packages(monkeypatch):
    """set_enabled/enabled: config wins over TM_TPU_INGRESS both ways, in
    each package over the one environment variable."""
    got = {}
    for p in PKGS:
        obs = []
        monkeypatch.setenv("TM_TPU_INGRESS", "0")
        obs.append(p.ing.enabled())
        p.ing.set_enabled(True)
        obs.append(p.ing.enabled())
        monkeypatch.setenv("TM_TPU_INGRESS", "1")
        p.ing.set_enabled(False)
        obs.append(p.ing.enabled())
        p.ing.set_enabled(None)
        obs.append(p.ing.enabled())
        monkeypatch.delenv("TM_TPU_INGRESS")
        obs.append(p.ing.enabled())
        got[p.name] = obs
    assert got["jax"] == got["port"] == [False, True, False, True, True]


def test_priority_gate_reap_order_equal():
    """A gate over each package's PriorityMempool admits the same txs and
    reaps them in the same priority order."""
    got = {}
    for p in PKGS:
        abci = p.abci

        class Prio:
            def check_tx(self, req):
                return abci.ResponseCheckTx(code=0, priority=req.tx[0],
                                            gas_wanted=1)
        gs = Gates(p)
        try:
            mp = p.pmempool.PriorityMempool(Prio(),
                                            registry=p.metrics.Registry())
            g, _ = gs.gate(mempool=mp, batch=4)
            futs = [g.submit(bytes([(i * 37) % 11]) + b"tx%d" % i)
                    for i in range(40)]
            res = [f.result(timeout=10.0) for f in futs]
        finally:
            gs.close()
        got[p.name] = (plain(res), mp.reap_max_bytes_max_gas(-1, -1),
                       _stats(g))
    assert got["jax"] == got["port"]


# ---------------------------------------------------------------------------
# the departures: device=, no CUDA, card faults
# ---------------------------------------------------------------------------

def test_device_routes_the_preverify_through_running_on(monkeypatch):
    """The gate's device is resolved when it is made, and its pre-verify
    submits only to a scheduler running on that device: a scheduler on
    another device is not used (the app sees the bad signature's tx, as
    with no scheduler at all)."""
    gs = Gates(PORT)
    try:
        app = EchoApp(PORT)
        g, mp = gs.gate(app=app)
        assert g.device == torch.device("cpu")
        s = gs.sched()
        seen = []
        monkeypatch.setattr(PORT.sched, "running_on", lambda dev: (
            seen.append(dev), s if dev == torch.device("cpu") else None)[1])
        bad = bytearray(_sigtx(PORT, 5, tag=b"dev"))
        bad[len(PORT.ing.SIGTX_MAGIC) + 32] ^= 1
        assert g.check_tx(bytes(bad), timeout=10.0).log == \
            "invalid signature"
        assert seen == [torch.device("cpu")] and app.calls == 0
        # the same scheduler, seen as running on another device
        g.device = torch.device("cuda", 0)
        bad2 = bytearray(_sigtx(PORT, 6, tag=b"dev"))
        bad2[len(PORT.ing.SIGTX_MAGIC) + 32] ^= 1
        assert g.check_tx(bytes(bad2), timeout=10.0).is_ok()
        assert app.calls == 1
    finally:
        gs.close()


def test_gate_not_made_without_cuda(monkeypatch):
    """With no CUDA and no device="cpu" the constructor raises
    RuntimeError, as VerifyScheduler's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    mp = PORT.mempool.Mempool(EchoApp(PORT),
                              registry=PORT.metrics.Registry())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.ing.IngressGate(mp)
    assert PORT.ing.IngressGate(mp, device="cpu").device == \
        torch.device("cpu")


@pytest.fixture
def card_kernel(monkeypatch):
    """The scheduler's ed25519 lane on the runtime (TM_TPU_FORCE_BATCH,
    tpu_threshold 1), the runtime treating its lane as on the card, and
    K1's plain version raising as a failed launch does."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck

    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    real = PORT.degrade.DeviceLaneRuntime.allow_fallback
    monkeypatch.setattr(
        PORT.degrade.DeviceLaneRuntime, "allow_fallback",
        lambda self, site, reason, on_card, cause=None: real(
            self, site, reason, True, cause))

    def launch_failed(*a, **k):
        raise RuntimeError("cudaErrorLaunchFailure (test)")
    real_plain = ck.verify_packed_plain
    monkeypatch.setattr(ck, "verify_packed_plain", launch_failed)
    PORT.degrade.configure(PORT.degrade.DegradeConfig(),
                           registry=PORT.metrics.Registry("card_t"))
    # restores K1's plain version: the card is back
    yield lambda: monkeypatch.setattr(ck, "verify_packed_plain", real_plain)
    PORT.degrade.configure(PORT.degrade.DegradeConfig(),
                           registry=PORT.metrics.Registry("card_t2"))


def _fault_batch(drill: bool):
    """A gate batch of two signed txs (one with a bad signature) and two
    plain txs, queued behind a plug so the worker drains them as one
    batch."""
    gs = Gates(PORT)
    app = EchoApp(PORT)
    gs.sched(tpu_threshold=1, window_s=0.001)
    # the plain K1 on the CPU takes seconds: a wait longer than the
    # default 2 s
    g, mp = gs.gate(app=app, batch=8, preverify_deadline_s=1.0)
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
    good = _sigtx(PORT, 1, tag=b"card-good")
    bad = bytearray(_sigtx(PORT, 2, tag=b"card-bad"))
    bad[len(PORT.ing.SIGTX_MAGIC) + 32] ^= 1
    txs = [good, b"plain-1", bytes(bad), b"plain-2"]
    with g._cond:
        futs = [g.submit(t) for t in txs]
    return gs, g, mp, app, txs, futs


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_at_the_gate_worker(card_kernel, drill):
    """Outside a drill the SIGTX futures raise DeviceLaneError, no `sig`
    rejection or failed tx is counted, the plain txs are admitted, the
    cache claims are released (each tx is admitted or refuted when
    resubmitted with the card back) and the worker survives; in a drill
    the runtime re-verifies on the host and the gate's verdicts are the
    JAX package's."""
    gs, g, mp, app, txs, futs = _fault_batch(drill)
    try:
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=30.0))
            except Exception as e:  # noqa: BLE001 - checked below
                out.append(e)
        if drill:
            assert [r.log for r in out] == ["", "", "invalid signature", ""]
            assert mp.metrics.rejected_txs.value(reason="sig") == 1
            assert g.device_error is None and g.stats()["device_error"] == 0
            return
        assert [type(r).__name__ for r in out] == [
            "DeviceLaneError", "ResponseCheckTx", "DeviceLaneError",
            "ResponseCheckTx"]
        assert out[1].is_ok() and out[3].is_ok()
        assert isinstance(g.device_error, PORT.degrade.DeviceLaneError)
        st = g.stats()
        assert st["device_error"] == 2 and st["sig_rejected"] == 0
        assert st["admitted"] == 2 and st["rejected"] == 0
        assert mp.metrics.rejected_txs.value(reason="sig") == 0
        assert mp.metrics.failed_txs.value() == 0
        assert app.calls == 2 and mp.size() == 2
        # the worker lives, and the claims were released: with the card
        # back the same txs are admitted or refuted, not "already in cache"
        card_kernel()
        assert all(th.is_alive() for th in g._threads)
        again = [g.check_tx(t, timeout=30.0) for t in txs]
        assert [r.log for r in again] == ["", "tx already in cache",
                                          "invalid signature",
                                          "tx already in cache"]
    finally:
        gs.close()


def test_card_fault_at_check_tx(card_kernel):
    """IngressGate.check_tx lets the DeviceLaneError out: it is not
    mapped to busy."""
    gs = Gates(PORT)
    try:
        gs.sched(tpu_threshold=1, window_s=0.001)
        g, mp = gs.gate(app=EchoApp(PORT))
        with pytest.raises(PORT.degrade.DeviceLaneError):
            g.check_tx(_sigtx(PORT, 4, tag=b"ctx-card"), timeout=30.0)
        assert g.stats()["busy"] == 0 and mp.size() == 0
        assert g.check_tx(b"plain", timeout=30.0).is_ok()
    finally:
        gs.close()


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_under_the_reactor(card_kernel, drill):
    """A batch gossiped to the reactor: no peer is stopped; outside a
    drill the error is on gate.device_error and the signed txs are not in
    the pool, in a drill the good one is admitted and the bad one
    refuted."""
    class Switch:
        peers = {}
        stopped = []

        def stop_peer_for_error(self, peer, reason):
            self.stopped.append(reason)

    class FakePeer:
        id = "peer-card"

    gs = Gates(PORT)
    try:
        gs.sched(tpu_threshold=1, window_s=0.001)
        g, mp = gs.gate(app=EchoApp(PORT), batch=8,
                        preverify_deadline_s=1.0)
        reactor = PORT.reactor.MempoolReactor(mp, gate=g)
        reactor.switch = sw = Switch()
        if drill:
            PORT.fail.set_mode("pipeline.commit", "latency:1")
        bad = bytearray(_sigtx(PORT, 2, tag=b"gossip-bad"))
        bad[len(PORT.ing.SIGTX_MAGIC) + 32] ^= 1
        txs = [_sigtx(PORT, 1, tag=b"gossip-good"), bytes(bad), b"plain-g"]
        with g._cond:
            reactor.receive(PORT.reactor.MEMPOOL_CHANNEL, FakePeer(),
                            PORT.reactor.encode_msg(
                                PORT.reactor.TxsMessage(txs)))
        deadline = time.monotonic() + 30.0
        while g.stats()["admitted"] + g.stats()["rejected"] \
                + g.stats()["device_error"] < 3 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sw.stopped == []
        st = g.stats()
        if drill:
            assert g.device_error is None
            assert (st["admitted"], st["sig_rejected"]) == (2, 1)
            assert sorted(mp.reap_max_txs(-1)) == sorted([txs[0], txs[2]])
        else:
            assert isinstance(g.device_error, PORT.degrade.DeviceLaneError)
            assert (st["admitted"], st["device_error"],
                    st["sig_rejected"]) == (1, 2, 0)
            assert mp.reap_max_txs(-1) == [txs[2]]
    finally:
        gs.close()



def test_verify_shed_keeps_its_retry_after_hint():
    """A tx bounced because the scheduler shed its pre-verify (max_pending
    below one batch, as the JAX package's flood test sets it) answers the
    same busy response in both packages; the port's future keeps the
    Retry-After hint, which the JAX package's settlement clears."""
    got = {}
    for p in PKGS:
        gs = Gates(p)
        try:
            gs.sched(max_pending=4)
            g, mp = gs.gate(batch=8)
            txs = [_sigtx(p, 40 + i, tag=b"shed") for i in range(8)]
            with g._cond:
                futs = [g.submit(tx) for tx in txs]
            res = [f.result(timeout=30.0) for f in futs]
            got[p.name] = ([view for view in {(r.code, r.codespace, r.log)
                                              for r in res}],
                           [f.retry_after_s for f in futs],
                           _stats(g)["preverify_shed"],
                           mp.metrics.rejected_txs.value(reason="busy"))
        finally:
            gs.close()
    assert got["jax"][0] == got["port"][0] == [
        (1, "ingress", "mempool is busy (verify shed)")]
    assert got["jax"][2:] == got["port"][2:] == (8, 8)
    assert got["jax"][1] == [None] * 8
    assert all(h is not None and h > 0 for h in got["port"][1])
