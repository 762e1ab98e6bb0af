"""The port's libs/fail, libs/metrics, libs/slo and libs/trace against the
JAX package's: the same calls through both give the same results — mode
parsing, hit counts and corrupted bitmaps; the Registry's exposition text
(CryptoMetrics included); quantiles and reports of a seeded latency
stream; span names, parents and attributes of a traced call tree."""
from __future__ import annotations

import random
import threading

import numpy as np
import pytest

from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import slo as jslo
from tendermint_tpu.libs import trace as jtrace

from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs import metrics as tmetrics
from tendermint_tpu_torch.libs import slo as tslo
from tendermint_tpu_torch.libs import trace as ttrace


def _both(fn, *pairs):
    """fn(*modules) for the JAX modules and for the port's; the results
    must be equal.  Returns the port's."""
    want = fn(*(j for j, _ in pairs))
    got = fn(*(t for _, t in pairs))
    assert got == want
    return got


# -- fail -------------------------------------------------------------------

@pytest.fixture
def fails():
    for f in (jfail, tfail):
        f.reset()
    yield jfail, tfail
    for f in (jfail, tfail):
        f.reset()


def test_fail_sites_of_the_port_are_registered_in_both(fails):
    assert tfail.REGISTERED_SITES == {
        "ops.ed25519.verify_batch", "ops.sr25519.verify_batch",
        "ops.secp.verify_batch", "ops.ed25519.comb", "batch.ed25519",
        "batch.sr25519",
        "batch.secp256k1", "sched.ed25519", "sched.sr25519",
        "sched.secp256k1", "bulk.ed25519", "lanepool.verify",
        "merkle.bulk_hash", "devobs.record", "propose.parts",
        "propose.reap", "kvdb.group_commit", "observatory.record",
        "pipeline.stage", "pipeline.commit", "netobs.record",
        "light.serve", "light.coalesce", "ingress.admit", "ingress.checktx",
        "ingress.recheck", "statesync.fetch", "statesync.verify",
        "statesync.apply", "statesync.serve", "control.decide",
        "vnet.deliver", "vnet.partition", "vnet.reorder", "harness.step",
        "sharding.mesh_stage", "sharding.mesh_comb",
        "sharding.global_plane"}
    assert all(jfail.is_registered(s) for s in tfail.REGISTERED_SITES)


def _modes(f, monkeypatch):
    obs = []
    for site in ("x.one", "x.two"):
        f.register(site)
    monkeypatch.setenv("TM_TPU_FAILPOINTS",
                       " x.one = raise ;x.two=latency:0;junk")
    for site in ("x.one", "x.two", "x.three"):
        try:
            f.inject(site)
            obs.append((site, "ok"))
        except f.InjectedFault as e:
            obs.append((site, "fault", str(e)))
    monkeypatch.delenv("TM_TPU_FAILPOINTS")
    f.set_mode("x.two", "corrupt-bitmap")
    f.inject("x.two")          # a result mode is a no-op at entry
    bits = np.array([True, False, True])
    obs.append(f.corrupt_bitmap("x.two", bits).tolist())
    obs.append(f.corrupt_bitmap("x.one", bits).tolist())
    f.set_mode("x.one", "bogus")
    with pytest.raises(ValueError, match="unknown fail mode"):
        f.inject("x.one")
    f.set_mode("x.one", None)
    obs.append(f.corrupt_bytes("x.one", b"\x01\x02"))
    f.set_mode("x.one", "corrupt-chunk")
    obs.append((f.corrupt_bytes("x.one", b"\x01\x02"),
                f.corrupt_bytes("x.one", b"")))
    obs.append([f.fired(s, m) for s, m in (
        ("x.one", "raise"), ("x.two", "latency:0"),
        ("x.two", "corrupt-bitmap"), ("x.one", "corrupt-chunk"))])
    f.clear("x.one")
    obs.append(f.fired("x.one", "corrupt-chunk"))
    f.reset()
    obs.append((f.fired("x.one", "raise"), f.is_registered("x.one")))
    with pytest.raises(ValueError, match="not registered"):
        f.set_mode("x.one", "raise")
    return obs


def test_fail_modes_counts_and_corruption_match(fails, monkeypatch):
    obs = _both(lambda f: _modes(f, monkeypatch), fails)
    assert obs[0][:2] == ("x.one", "fault")
    assert obs[3] == [False, True, False]


def test_fail_point_counter_matches(fails, monkeypatch):
    """FAIL_TEST_INDEX unset: fail points are counted no-ops; set to a
    later index, the counter advances without firing."""
    monkeypatch.setenv("FAIL_TEST_INDEX", "5")

    def play(f):
        for _ in range(3):
            f.fail_point()
        return f._counter
    assert _both(play, fails) == 3


# -- metrics ----------------------------------------------------------------

def _updates(m):
    reg = m.Registry("tm")
    c = reg.counter("crypto", "hits_total", 'say "hi"\nback\\slash',
                    labels=("site", "reason"))
    c.inc(site="a", reason='q"uote')
    c.inc(2.5, site="b\\n", reason="line\nbreak")
    g = reg.gauge("crypto", "level", "a gauge")
    g.set(0.5)
    g.add(1.25)
    h = reg.histogram("crypto", "wait_seconds", "a histogram",
                      labels=("site",), buckets=m.exp_buckets(0.001, 4, 6))
    for v in (0.0005, 0.002, 0.03, 0.5, 99.0):
        h.observe(v, site="s")
    clock = iter([0.0, 1.0, 1.75]).__next__   # init, enter, exit
    with h.time(clock=clock, site="t"):
        pass
    reg.counter("", "bare_total")
    cm = m.CryptoMetrics(reg)
    cm.device_failures.inc(site="bulk.ed25519", reason="timeout")
    cm.breaker_state.set(1.0)
    cm.device_launch_seconds.observe(0.2, site="batch.ed25519")
    cm.slo_target.set(0.05, stream="commit")
    tr = m.TraceMetrics(reg)
    tr.dropped_spans.inc()
    return (reg.render_text(), h.count(site="s"),
            h.total(site="t"), c.value(site="a", reason='q"uote'))


def test_metrics_exposition_matches():
    text, n, total, v = _both(_updates, (jmetrics, tmetrics))
    assert n == 5 and total == 0.75 and v == 1.0
    assert 'reason="line\\nbreak"' in text


def test_crypto_metrics_families_match():
    """CryptoMetrics registers the same families, with the same help,
    labels and buckets, as the JAX package's (the comb table cache's
    three included)."""
    def families(m):
        reg = m.Registry("x")
        m.CryptoMetrics(reg)
        return [(k, type(v).__name__, v.help, v.label_names,
                 getattr(v, "buckets", None))
                for k, v in sorted(reg._metrics.items())]
    ported = _both(families, (jmetrics, tmetrics))
    assert len(ported) == 27
    assert sum("crypto_table_" in f[0] for f in ported) == 3


# -- slo --------------------------------------------------------------------

def _stream(s):
    rng = random.Random(1234)
    est = s.SloEstimator(window=64, targets={"commit": 0.02},
                         budgets={"commit": 0.05}, enabled=True)
    off = s.SloEstimator(window=8, enabled=False)
    for i in range(200):
        v = rng.expovariate(100.0)
        est.observe("commit" if i % 3 else "consensus", v)
        off.observe("commit", v)
    est.set_config(window=64, targets={"commit": 0.02, "mempool": 1.0})
    out = [est.quantile("commit", q) for q in (0.5, 0.9, 0.99, 1.0)]
    out.append(est.quantile("nothing", 0.5))
    out.append(est.report())
    out.append(off.report())
    est.enable(window=16)
    out.append(est.report())
    return out


def test_slo_quantiles_and_reports_match():
    out = _both(_stream, (jslo, tslo))
    assert out[-3]["streams"]["commit"]["n"] == 64
    assert out[-3]["streams"]["commit"]["burn_rate"] > 0


# -- trace ------------------------------------------------------------------

def _tree(t):
    tr = t.Tracer(capacity=16, enabled=True)
    with tr.span("batch.verify", n=3) as root:
        tr.instant("msm.route", path="rlc-single", outcome="vouched")
        with tr.span("device.collect", site="batch.ed25519") as sp:
            sp.add(outcome="ok")
        parent = tr.current_id()
        box = []

        def worker():
            with tr.span("device.launch", parent=parent, site="x"):
                tr.current().add(path="cuda", nb=256)
            box.append(tr.current() is t._NOOP)
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        root.add(valid=2)
    try:
        with tr.span("batch.verdict"):
            raise KeyError("boom")
    except KeyError:
        pass
    with tr.span("ops.ed25519.verify_batch", parent=None):
        pass
    tr.disable()
    with tr.span("batch.host_lane") as off:
        off.add(ignored=True)
    ids = {}

    def rid(x):
        return ids.setdefault(x, len(ids)) if x is not None else None
    snap = tr.snapshot()
    recs = [(r["name"], r["ph"], rid(r["id"]), rid(r["parent"]),
             r["attrs"], r["seq"]) for r in snap]
    chrome = tr.chrome_trace(since=2)
    events = [(e["name"], e["ph"], sorted(e["args"]))
              for e in chrome["traceEvents"]]
    small = t.Tracer(capacity=2, enabled=True)
    for _ in range(5):
        small.instant("msm.route")
    return (recs, box, events, chrome["last_seq"], small.dropped(),
            [r["seq"] for r in small.snapshot()], tr.is_enabled())


def test_trace_tree_matches():
    recs, box, *_ = _both(_tree, (jtrace, ttrace))
    names = [r[0] for r in recs]
    assert names == ["msm.route", "device.collect", "device.launch",
                     "batch.verify", "batch.verdict",
                     "ops.ed25519.verify_batch"]
    by_name = {r[0]: r for r in recs}
    root = by_name["batch.verify"][2]
    assert by_name["device.launch"][3] == root     # across threads
    assert by_name["batch.verdict"][4] == {"error": "KeyError"}
    assert box == [True]


def test_trace_known_spans_are_the_references():
    assert ttrace.KNOWN_SPANS <= jtrace.KNOWN_SPANS


def test_trace_module_functions_match(tmp_path):
    def play(t):
        t.disable()
        t.reset()
        base = t.last_seq()
        out = [t.span("batch.verify") is t._NOOP, t.current_id()]
        t.enable()
        try:
            with t.span("batch.verify", n=1):
                out.append(t.current_id() is not None)
                t.instant("breaker.transition", to="open")
                t.current().add(route="cuda")
            snap = t.snapshot(since=base)
            out.append([(r["name"], r["attrs"]) for r in snap])
            out.append(t.last_seq() - base)
            path = t.export_file(str(tmp_path / f"{t.__name__}.json"),
                                 since=base)
            out.append(len(open(path).read()) > 0)
        finally:
            t.disable()
            t.reset()
        return out
    out = _both(play, (jtrace, ttrace))
    assert out[0] is True and out[-2] == 2
