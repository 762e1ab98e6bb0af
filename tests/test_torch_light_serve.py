"""The port's LightServe serving plane (light/service.py) against the JAX
package's, on the CPU.

tests/test_light_serve.py's cases run through both packages (all but
test_config_light_serve_roundtrip, which needs the node's config); each case
returns its outcome as a package-free value (verdicts with their errors and
Retry-After hints, how many times each certificate really ran, the stats,
the coalescing counts, the follow cursors' heights, the light metrics) and
the outcomes are compared across the packages exactly.  The countable stub
certificates take the port's `device` keyword.  The prewarm cases stub the
comb kernels in both packages (test_torch_comb's stubs); the acceptance wave
runs the port's real plain C1 and C2 on the CPU and the JAX package's comb
as bignum verdicts on its staged operands.  Then the port's departures:
`device=` reaches every certificate and the prewarm, the service is not made
without CUDA unless device="cpu", and a launch that failed on the card
(degrade.DeviceLaneError) makes the future of every request coalesced on the
certificate raise it, with no refused verdict counted, on the queued and the
direct paths alike; in a chaos drill the JAX package's behaviour holds.
"""
from __future__ import annotations

import functools
import importlib
import threading
import time

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_blocksync import (BY_NAME, JAX, PKGS, PORT, _clean,  # noqa: F401
                                  build_chain, make_genesis)
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_EXTRA = {
    "svc": "light.service", "lverifier": "light.verifier",
    "light_block": "types.light_block", "trace": "libs.trace",
    "event_bus": "types.event_bus", "ops_ed": "ops.ed25519",
    "registry": "libs.metrics",
}
for _p in PKGS:
    for _attr, _mod in _EXTRA.items():
        setattr(_p, _attr, importlib.import_module(f"{_p.root}.{_mod}"))

PERIOD = 3600.0 * 24 * 14
CHAIN = "light-serve-chain"


def NOW(p):
    return p.basic.Timestamp(1700005000, 0)


def dev(p) -> dict:
    return {"device": "cpu"} if p is PORT else {}


@pytest.fixture(autouse=True)
def _clean_world():
    for p in PKGS:
        p.svc.set_enabled(None)
        p.svc.install(None)
    yield
    for p in PKGS:
        p.svc.set_enabled(None)
        p.svc.install(None)


# ---------------------------------------------------------------------------
# countable stub certificates (tests/test_light_serve.py's), for either
# package; the port's service hands them its device
# ---------------------------------------------------------------------------


class _StubBlockID:
    def __init__(self, h):
        self.hash = b"blk-%027d" % h


class _StubCommit:
    def __init__(self, h):
        self.height = h
        self.round = 0
        self.block_id = _StubBlockID(h)


class _StubHeader:
    def __init__(self, h):
        self.commit = _StubCommit(h)


class _StubVals:
    """`calls` records every real execution, `devices` the device each
    one was handed."""

    def __init__(self, tag: bytes, fail_with=None, block_on=None,
                 started=None):
        self.tag = tag
        self.calls = []
        self.devices = []
        self.fail_with = fail_with
        self.block_on = block_on
        self.started = started

    def hash(self):
        return b"vals-" + self.tag

    def verify_commit_light_trusting(self, chain_id, commit, trust_level,
                                     device="(none)"):
        if self.started is not None:
            self.started.set()
        if self.block_on is not None:
            assert self.block_on.wait(30.0), "plug never released"
        self.calls.append((chain_id, commit.height))
        self.devices.append(str(device))
        if self.fail_with is not None:
            raise self.fail_with


class _Hdr:
    def __init__(self, sh):
        self.commit = sh.commit
        self.height = sh.commit.height


def _req(p, vals, h=5):
    return p.svc.LightRequest("trusting", CHAIN, trusted_vals=vals,
                              untrusted=_StubHeader(h))


def _svc(p, **kw):
    kw.setdefault("prewarm", False)
    return p.svc.LightServe(p.bstore.BlockStore(p.kvdb.MemDB()),
                            p.sstore.StateStore(p.kvdb.MemDB()), CHAIN,
                            **dev(p), **kw)


def _plug(p, svc):
    release, started = threading.Event(), threading.Event()
    vals = _StubVals(b"plug", block_on=release, started=started)
    fut = svc.submit(_req(p, vals, h=999), client="plug")
    assert started.wait(10.0), "worker never picked up the plug"
    return release, fut


def _verdict(v):
    return (v.ok, v.error, v.retry_after_s)


def _light_metrics(svc):
    m = svc.metrics
    return {"ok": m.requests.value(outcome="ok"),
            "refused": m.requests.value(outcome="refused"),
            "lead": m.coalesce.value(result="lead"),
            "hit": m.coalesce.value(result="hit"),
            "direct": m.coalesce.value(result="direct"),
            "busy": m.shed.value(reason="busy"),
            "ratelimit": m.shed.value(reason="ratelimit")}


def _private_metrics(p, svc):
    """A registry of the test's own, so counts start at 0."""
    svc.metrics = p.registry.LightMetrics(p.registry.Registry("light_t"))
    return svc


# ---------------------------------------------------------------------------
# tests/test_light_serve.py's cases
# ---------------------------------------------------------------------------

def case_same_certificate_coalesces_to_one_execution(p):
    svc = _private_metrics(p, _svc(p, workers=1, batch=256))
    svc.start()
    try:
        release, plug_fut = _plug(p, svc)
        vals = _StubVals(b"shared")
        futs = [svc.submit(_req(p, vals), client=f"client-{i}")
                for i in range(24)]
        assert svc.depth() == 24
        release.set()
        assert plug_fut.result(timeout=30.0).ok
        verdicts = [_verdict(f.result(timeout=30.0)) for f in futs]
        assert len(vals.calls) == 1
        st = svc.stats()
        assert st["coalesce_lead"] == 2 and st["coalesce_hit"] == 23
        assert st["verified"] == 25
        assert len(svc._per_client_p99_ms()) == 25
    finally:
        svc.stop()
    return {"verdicts": verdicts, "calls": vals.calls, "stats": st,
            "metrics": _light_metrics(svc)}


def case_distinct_certificates_and_shared_failure_verdicts(p):
    svc = _svc(p, workers=1, batch=256)
    svc.start()
    try:
        release, plug_fut = _plug(p, svc)
        good = _StubVals(b"good")
        bad = _StubVals(b"bad", fail_with=p.lverifier.LightError(
            "insufficient power"))
        good_futs = [svc.submit(_req(p, good), client=f"g{i}")
                     for i in range(4)]
        bad_futs = [svc.submit(_req(p, bad, h=7), client=f"b{i}")
                    for i in range(4)]
        release.set()
        assert plug_fut.result(timeout=30.0).ok
        out = [_verdict(f.result(timeout=30.0))
               for f in good_futs + bad_futs]
        assert all(v == (True, None, None) for v in out[:4])
        assert all(v == (False, "insufficient power", None)
                   for v in out[4:])
        assert len(good.calls) == 1 and len(bad.calls) == 1
        solo_ok = svc._verify_direct(_req(p, _StubVals(b"good2")))
        solo_bad = svc._verify_direct(_req(p, _StubVals(
            b"bad2", fail_with=p.lverifier.LightError(
                "insufficient power"))))
        assert solo_ok.ok and solo_bad.error == "insufficient power"
        st = svc.stats()
        assert st["refuted"] == 4
    finally:
        svc.stop()
    return {"verdicts": out, "solo": [_verdict(solo_ok), _verdict(solo_bad)],
            "stats": st}


def case_invalid_request_refused_at_header_stage(p):
    svc = _svc(p)
    svc.start()
    try:
        v = svc.verify(p.svc.LightRequest("trusting", CHAIN,
                                          untrusted=_StubHeader(5)),
                       client="broken", timeout=10.0)
        assert not v.ok and "trusting request needs" in v.error
        out = [_verdict(v)]
        st = svc.stats()
        assert st["invalid"] == 1 and st["coalesce_lead"] == 0
        sh3, sh4, sh9 = _StubHeader(3), _StubHeader(4), _StubHeader(9)
        for t, u, kind, msg in (
                (sh3, sh9, "adjacent", "must be adjacent"),
                (sh3, sh4, "non_adjacent", "must be non adjacent")):
            v = svc.verify(p.svc.LightRequest(
                kind, CHAIN, trusted=_Hdr(t), untrusted=_Hdr(u),
                untrusted_vals=_StubVals(b"x"), now=NOW(p)), timeout=10.0)
            assert not v.ok and msg in v.error
            out.append(_verdict(v))
    finally:
        svc.stop()
    return {"verdicts": out, "stats": svc.stats()}


def case_unknown_kind_rejected(p):
    with pytest.raises(ValueError, match="unknown light request kind") as ei:
        p.svc.LightRequest("sideways", CHAIN)
    return str(ei.value)


def case_cross_worker_inflight_dedupe(p):
    svc = _svc(p)
    release, started = threading.Event(), threading.Event()
    vals = _StubVals(b"inflight", block_on=release, started=started)
    key, run = svc._cert_tasks(_req(p, vals))[0]
    out = {}

    def lead():
        out["lead"] = svc._cert_verify(key, run, 1)

    def follow():
        assert started.wait(10.0)
        out["follow"] = svc._cert_verify(key, run, 1)

    t1 = threading.Thread(target=lead)
    t2 = threading.Thread(target=follow)
    t1.start()
    t2.start()
    time.sleep(0.05)
    release.set()
    t1.join(10.0)
    t2.join(10.0)
    assert out["lead"] is None and out["follow"] is None
    assert len(vals.calls) == 1
    st = svc.stats()
    assert st["coalesce_lead"] == 1 and st["coalesce_hit"] == 1
    assert not svc._inflight
    return {"key": key, "calls": vals.calls, "stats": st}


def case_chaos_light_serve_degrades_to_in_caller_direct(p):
    svc = _svc(p)
    svc.start()
    try:
        p.fail.set_mode("light.serve", "raise")
        good, bad = _StubVals(b"cg"), _StubVals(
            b"cb", fail_with=p.lverifier.LightError("no quorum"))
        f1 = svc.submit(_req(p, good), client="c")
        f2 = svc.submit(_req(p, bad), client="c")
        assert f1.done() and f2.done()
        out = [_verdict(f1.result(0)), _verdict(f2.result(0))]
        assert out == [(True, None, None), (False, "no quorum", None)]
        fired = p.fail.fired("light.serve", "raise")
        assert fired >= 2
        st = svc.stats()
        assert st["direct_path"] == 2 and st["coalesce_lead"] == 0
        assert svc.depth() == 0
    finally:
        svc.stop()
    return {"verdicts": out, "fired": fired, "stats": st}


def case_chaos_light_coalesce_degrades_to_per_request_direct(p):
    svc = _private_metrics(p, _svc(p, workers=1, batch=256))
    svc.start()
    try:
        p.fail.set_mode("light.coalesce", "raise")
        release, started = threading.Event(), threading.Event()
        plug_vals = _StubVals(b"plug2", block_on=release, started=started)
        plug_fut = svc.submit(_req(p, plug_vals, h=999), client="plug")
        assert started.wait(10.0)
        vals = _StubVals(b"chaos")
        futs = [svc.submit(_req(p, vals), client=f"c{i}") for i in range(6)]
        release.set()
        assert plug_fut.result(timeout=30.0).ok
        assert all(f.result(timeout=30.0).ok for f in futs)
        assert len(vals.calls) == 6
        assert p.fail.fired("light.coalesce", "raise") >= 2
        st = svc.stats()
        assert st["coalesce_direct"] == 7
        assert st["coalesce_lead"] == 0 and st["coalesce_hit"] == 0
        assert st["verified"] == 7
    finally:
        svc.stop()
    return {"calls": len(vals.calls), "stats": st,
            "metrics": _light_metrics(svc)}


def case_ratelimit_refusal_immediate_with_retry_after(p):
    svc = _private_metrics(p, _svc(p, rate_per_s=2.0, burst=1))
    svc.start()
    try:
        vals = _StubVals(b"rl")
        out = [_verdict(svc.verify(_req(p, vals), client="flooder",
                                   timeout=10.0))]
        f = svc.submit(_req(p, vals), client="flooder")
        assert f.done()
        v = f.result(0)
        assert not v.ok and "rate limited" in v.error
        assert v.retry_after_s == pytest.approx(0.5)
        out.append(_verdict(v))
        out.append(_verdict(svc.verify(_req(p, vals), client="other",
                                       timeout=10.0)))
        st = svc.stats()
        assert st["ratelimited"] == 1 and st["verified"] == 2
    finally:
        svc.stop()
    return {"verdicts": out, "stats": st, "metrics": _light_metrics(svc)}


def case_set_rate_reclamps_live_buckets(p):
    svc = _svc(p, rate_per_s=100.0, burst=50)
    svc.start()
    try:
        vals = _StubVals(b"clamp")
        out = [_verdict(svc.verify(_req(p, vals), client="c", timeout=10.0))]
        svc.set_rate(rate_per_s=0.001, burst=1)
        out.append(_verdict(svc.verify(_req(p, vals), client="c",
                                       timeout=10.0)))
        v = svc.submit(_req(p, vals), client="c").result(0)
        assert not v.ok and v.retry_after_s is not None
        out.append((v.ok, v.error))
        assert out[:2] == [(True, None, None)] * 2
    finally:
        svc.stop()
    return {"verdicts": out, "stats": svc.stats()}


def case_queue_overflow_busy_verdict(p):
    svc = _svc(p, queue_size=4, batch=1, workers=1)
    svc.start()
    try:
        release, plug_fut = _plug(p, svc)
        vals = _StubVals(b"flood")
        queued = [svc.submit(_req(p, vals), client=f"q{i}")
                  for i in range(4)]
        assert svc.depth() == 4
        spill = svc.submit(_req(p, vals), client="spill")
        assert spill.done()
        v = spill.result(0)
        assert not v.ok and v.error == "light serve is busy"
        assert 0.1 <= v.retry_after_s <= 5.0
        release.set()
        assert plug_fut.result(timeout=30.0).ok
        assert all(f.result(timeout=30.0).ok for f in queued)
        st = svc.stats()
        assert st["busy"] == 1 and st["verified"] == 5
    finally:
        svc.stop()
    return {"spill": _verdict(v), "stats": st}


def case_verify_timeout_maps_to_busy(p):
    svc = _svc(p, workers=1)
    svc.start()
    try:
        release, plug_fut = _plug(p, svc)
        v = svc.verify(_req(p, _StubVals(b"slowpoke")), client="w",
                       timeout=0.05)
        assert not v.ok and v.retry_after_s is not None
        assert "timed out" in v.error
        release.set()
        assert plug_fut.result(timeout=30.0).ok
    finally:
        svc.stop()
    return (v.ok, v.error)


def case_stop_settles_stranded_and_post_stop_goes_direct(p):
    svc = _svc(p, queue_size=16, batch=1, workers=1)
    svc.start()
    release, plug_fut = _plug(p, svc)
    vals = _StubVals(b"stranded")
    stranded = [svc.submit(_req(p, vals), client=f"s{i}") for i in range(3)]
    threading.Timer(0.2, release.set).start()
    svc.stop()
    out = []
    for f in stranded:
        v = f.result(timeout=10.0)
        assert not v.ok and v.error == "light serve stopping"
        assert v.retry_after_s is not None
        out.append(_verdict(v))
    assert plug_fut.result(timeout=10.0).ok
    post = _StubVals(b"post")
    f = svc.submit(_req(p, post), client="late")
    assert f.done() and f.result(0).ok and len(post.calls) == 1
    return {"stranded": out, "post": _verdict(f.result(0)),
            "stats": svc.stats()}


def chain_stores(p, n_heights=6, n_vals=4):
    gdoc, privs = make_genesis(p, n_vals)
    blocks, commits, states = build_chain(p, gdoc, privs, n_heights)
    block_store = p.bstore.BlockStore(p.kvdb.MemDB())
    state_store = p.sstore.StateStore(p.kvdb.MemDB())
    for b, c in zip(blocks, commits):
        _bid, parts = p.replay.block_id_of(b)
        block_store.save_block(b, parts, c)
    state_store.save(p.state.state_from_genesis(gdoc))
    for st in states:
        state_store.save(st)
    return gdoc, blocks, block_store, state_store, states


def _lb_view(lb):
    return (lb.height, lb.signed_header.header.hash(),
            lb.signed_header.commit.hash(), lb.validators.hash())


def case_follow_cursor_subscribe_poll_advance(p):
    gdoc, blocks, block_store, state_store, _ = chain_stores(p, 6)
    svc = p.svc.LightServe(block_store, state_store, gdoc.chain_id,
                           cursor_batch=4, prewarm=False, **dev(p))
    cid = svc.subscribe("alice")
    polls = [svc.poll(cid)]
    assert [lb.height for lb in polls[0]] == [1, 2, 3, 4]
    for lb in polls[0]:
        assert lb.signed_header.header.hash() == \
            blocks[lb.height - 1].header.hash()
        assert lb.signed_header.commit.height == lb.height
        assert not lb.validators.is_nil_or_empty()
    polls.append(svc.poll(cid))
    assert [lb.height for lb in polls[1]] == [5, 6]
    assert svc.poll(cid) == []
    cid2 = svc.subscribe("bob", from_height=4)
    polls.append(svc.poll(cid2, max_items=2))
    assert [lb.height for lb in polls[2]] == [4, 5]
    svc.unsubscribe(cid2)
    assert svc.poll(cid2) is None
    assert svc.stats()["polled"] == 8
    return {"cursors": [cid, cid2],
            "polls": [[_lb_view(lb) for lb in run] for run in polls]}


def case_follow_cursor_eviction_per_client_and_global(p):
    gdoc, _b, block_store, state_store, _ = chain_stores(p, 3)
    svc = p.svc.LightServe(block_store, state_store, gdoc.chain_id,
                           max_cursors_per_client=2, max_cursors=3,
                           prewarm=False, **dev(p))
    a1 = svc.subscribe("alice")
    a2 = svc.subscribe("alice")
    svc.poll(a1)
    a3 = svc.subscribe("alice")
    assert svc.poll(a2) is None and svc.poll(a1) is not None
    b1 = svc.subscribe("bob")
    c1 = svc.subscribe("carol")
    assert svc.poll(c1) is not None and svc.poll(b1) is not None
    rep = svc.report()
    assert rep["cursors"]["total"] <= 3
    assert svc.stats()["cursors_evicted"] >= 2
    assert a3 is not None
    return {"cursors": rep["cursors"], "stats": svc.stats()}


def case_report_shape_and_coalesce_ratio(p):
    svc = _svc(p)
    svc.start()
    try:
        vals = _StubVals(b"rep")
        assert svc.verify(_req(p, vals), client="r", timeout=10.0).ok
        rep = svc.report()
        assert rep["running"] and rep["chain_id"] == CHAIN
        assert rep["stats"]["verified"] == 1
        assert 0.0 <= rep["coalesce_ratio"] <= 1.0
        assert rep["config"]["queue"] == svc.queue_size
        assert "per_client_p99_ms" in rep and "r" in rep["per_client_p99_ms"]
        p.svc.install(svc)
        try:
            assert p.svc.report()["running"]
        finally:
            p.svc.install(None)
        assert p.svc.report() == {"enabled": p.svc.enabled(),
                                  "running": False}
    finally:
        svc.stop()
    return {k: v for k, v in rep.items()
            if k not in ("per_client_p99_ms", "slo")}


def case_enable_config_wins_over_env(p, mp):
    mp.setenv("TM_TPU_LIGHT_SERVE", "0")
    p.svc.set_enabled(None)
    out = []
    try:
        out.append(p.svc.enabled())
        p.svc.set_enabled(True)
        out.append(p.svc.enabled())
        mp.setenv("TM_TPU_LIGHT_SERVE", "1")
        p.svc.set_enabled(False)
        out.append(p.svc.enabled())
    finally:
        p.svc.set_enabled(None)
    assert out == [False, True, False]
    return out


CASES = {f.__name__[len("case_"):]: f for f in (
    case_same_certificate_coalesces_to_one_execution,
    case_distinct_certificates_and_shared_failure_verdicts,
    case_invalid_request_refused_at_header_stage,
    case_unknown_kind_rejected, case_cross_worker_inflight_dedupe,
    case_chaos_light_serve_degrades_to_in_caller_direct,
    case_chaos_light_coalesce_degrades_to_per_request_direct,
    case_ratelimit_refusal_immediate_with_retry_after,
    case_set_rate_reclamps_live_buckets, case_queue_overflow_busy_verdict,
    case_verify_timeout_maps_to_busy,
    case_stop_settles_stranded_and_post_stop_goes_direct,
    case_follow_cursor_subscribe_poll_advance,
    case_follow_cursor_eviction_per_client_and_global,
    case_report_shape_and_coalesce_ratio)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return plain(CASES[case](BY_NAME[name]))


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_light_serve_case(case, pkg):
    """tests/test_light_serve.py's case, its assertions, in each
    package."""
    for p in PKGS:
        p.fail.reset()
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_light_serve_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


def test_enable_config_wins_over_env(monkeypatch):
    """tests/test_light_serve.py's enable switch, in both packages (each
    its own switch over the one environment variable)."""
    got = {p.name: case_enable_config_wins_over_env(p, monkeypatch)
           for p in PKGS}
    assert got["jax"] == got["port"]


# -- the prewarm cases (test_torch_comb's stubbed comb kernels)

def _comb_pkg(p):
    from test_torch_comb import JAX as CJ, PORT as CP
    return CJ if p is JAX else CP


def test_prewarm_pins_comb_path_first_launch_false(monkeypatch):
    """After a prewarm the first request finds the tables resident and the
    launch bucket seen (path comb, first_launch False, no build); prewarm
    is idempotent; the same in both packages."""
    from test_torch_comb import _batch, _stub

    def play(p):
        c = _comb_pkg(p)
        c.deg.configure(registry=c.Registry("light_prewarm"))
        c.ed.table_cache_clear()
        rec = {}
        _stub(c, monkeypatch, rec)
        monkeypatch.setattr(c.ed, "_comb_min_override", 1)
        try:
            pubs, msgs, sigs = _batch(12, pool=6, tag=b"warmset")
            assert c.ed.prewarm(pubs, **dev(p))
            out = [list(rec["builds"])]
            assert c.ed.verify_batch(pubs, msgs, sigs, **dev(p)).all()
            ll = c.ed.last_launch()
            out.append((ll["path"], ll["first_launch"], ll["table_build"],
                        list(rec["builds"])))
            assert out[1] == ("comb", False, False, [8])
            assert c.ed.prewarm(pubs, warm_kernel=False, **dev(p))
            out.append(list(rec["builds"]))
            return out
        finally:
            c.ed.table_cache_clear()
            c.deg.reset()
    got = {p.name: play(p) for p in PKGS}
    assert got["jax"] == got["port"] == [[8], ("comb", False, False, [8]),
                                         [8]]


def test_prewarm_async_lands_off_thread(monkeypatch):
    """prewarm_async builds the tables on another thread, in both
    packages; the port's resolves its device on the caller's thread and
    hands it over."""
    from test_torch_comb import _batch, _stub

    def play(p):
        c = _comb_pkg(p)
        c.deg.configure(registry=c.Registry("light_prewarm_async"))
        c.ed.table_cache_clear()
        rec = {}
        _stub(c, monkeypatch, rec)
        monkeypatch.setattr(c.ed, "_comb_min_override", 1)
        try:
            pubs, _m, _s = _batch(12, pool=6, tag=b"asyncset")
            done = threading.Event()
            orig = c.ed.prewarm
            seen = {}

            def _tracked(keys, warm_kernel=True, **kw):
                seen["thread"] = threading.current_thread() is not \
                    threading.main_thread()
                seen["device"] = str(kw.get("device"))
                try:
                    return orig(keys, warm_kernel=warm_kernel, **kw)
                finally:
                    done.set()
            monkeypatch.setattr(c.ed, "prewarm", _tracked)
            c.ed.prewarm_async(pubs, **dev(p))
            assert done.wait(10.0)
            return [rec.get("builds"), seen["thread"]], seen["device"]
        finally:
            c.ed.table_cache_clear()
            c.deg.reset()
    got = {p.name: play(p) for p in PKGS}
    assert got["jax"][0] == got["port"][0] == [[8], True]
    assert got["port"][1] == "cpu"


def test_service_prewarms_current_set_on_start(monkeypatch):
    """on_start warms the current set, and the valset watcher again on
    the update event, in both packages; the port's hands its device to
    prewarm_async."""
    got = {}
    for p in PKGS:
        gdoc, _b, block_store, state_store, _ = chain_stores(p, 3)
        bus = p.event_bus.EventBus()
        calls = []
        svc = p.svc.LightServe(block_store, state_store, gdoc.chain_id,
                               prewarm=True, event_bus=bus, **dev(p))
        monkeypatch.setattr(p.ops_ed, "prewarm_async",
                            lambda keys, **kw: calls.append(
                                (len(list(keys)), str(kw.get("device")))))
        try:
            svc.start()
            assert calls and calls[0][0] == 4
            bus.publish_validator_set_updates([])
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and len(calls) < 2:
                time.sleep(0.01)
            assert len(calls) >= 2 and svc.stats()["prewarms"] >= 2
        finally:
            svc.stop()
        got[p.name] = [c[0] for c in calls[:2]]
        if p is PORT:
            assert {c[1] for c in calls} == {"cpu"}
    assert got["jax"] == got["port"] == [4, 4]


# -- locksan: the plane's locks under concurrent clients

def _hammer(p, san=None):
    gdoc, _b, block_store, state_store, _ = chain_stores(p, 3)
    svc = p.svc.LightServe(block_store, state_store, gdoc.chain_id,
                           workers=2, rate_per_s=10_000.0, burst=10_000,
                           prewarm=False, **dev(p))
    if san is not None:
        # the port's locks are wrapped, with the JAX package's ranks
        assert [(type(lk).__name__, lk.rank) for lk in (
            svc._rl_lock, svc._cur_lock, svc._stats_lock)] == [
            ("_SanLock", 23), ("_SanLock", 25), ("_SanLock", 37)]
    svc.start()
    stop = threading.Event()
    bad = []

    def submitter(k):
        vals = _StubVals(b"hammer-%d" % (k % 2))
        for _ in range(200):
            v = svc.verify(_req(p, vals), client=f"h{k}", timeout=30.0)
            if not (v.ok or v.retry_after_s is not None):
                bad.append(v.error)

    def follower(k):
        while not stop.is_set():
            cid = svc.subscribe(f"f{k}")
            svc.poll(cid)
            svc.unsubscribe(cid)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(4)] + \
        [threading.Thread(target=follower, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(30):
            svc.report()
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        svc.stop()
    assert not bad, bad
    st = svc.stats()
    assert st["verified"] == 800 and st["refuted"] == 0
    assert st["coalesce_lead"] + st["coalesce_hit"] == 800
    return [st["verified"], st["refuted"],
            st["coalesce_lead"] + st["coalesce_hit"]]


@pytest.mark.locksan
def test_locksan_concurrent_serve_hammer():
    """tests/test_light_serve.py's hammer in both packages, each service
    made under a lockset monitor (the JAX package's under the conftest's,
    the port's under one that wraps the port's locks with the JAX
    package's ranks from devtools/lockorder.py): the declared order holds
    and every verdict is right."""
    from tendermint_tpu.devtools import lockorder
    from tendermint_tpu.devtools.tmlint.runtime import LockSanitizer

    got = {"jax": _hammer(JAX)}
    ranks = {"tendermint_tpu_torch/" + k[len("tendermint_tpu/"):]: v
             for k, v in lockorder.LOCK_ORDER.items()
             if k.startswith("tendermint_tpu/")}
    san = LockSanitizer(include_paths=("tendermint_tpu_torch/",),
                        rank_overrides=ranks)
    san.install()
    try:
        got["port"] = _hammer(PORT, san)
    finally:
        san.uninstall()
    assert not san.violations, san.violations
    assert got["jax"] == got["port"] == [800, 0, 800]


# -- the acceptance wave: one coalesced comb launch for twelve clients

def test_acceptance_wave_one_coalesced_comb_launch(monkeypatch):
    """tests/test_light_serve.py's acceptance wave in both packages: a
    48-validator set prewarmed, twelve clients' adjacent requests over one
    certificate (the 33-signature prefix, past the 32-lane device
    threshold) cost one light.coalesce execution with twelve waiters and
    one device launch on the comb, first_launch False; every verdict the
    solo direct path's.  The port runs its real plain C1 and C2; the JAX
    package's comb is the bignum verdict on its staged operands."""
    from test_torch_light import _jax_comb_as_bignum

    def play(p, mp):
        mp.setenv("TM_TPU_FORCE_BATCH", "1")
        E = p.ops_ed
        p.degrade.configure(registry=p.registry.Registry("light_accept"))
        E.table_cache_clear()
        if p is JAX:
            mp.setenv("TM_TPU_NO_MESH", "1")
            _jax_comb_as_bignum(mp)
        mp.setattr(E, "_comb_min_override", 1)
        gdoc, privs = make_genesis(p, 48)
        blocks, commits, states = build_chain(p, gdoc, privs, 2)
        SH = p.light_block.SignedHeader
        trusted = SH(blocks[0].header, commits[0])
        untrusted = SH(blocks[1].header, commits[1])
        vals = states[1].validators

        def req():
            return p.svc.LightRequest(
                "adjacent", gdoc.chain_id, trusted=trusted,
                untrusted=untrusted, untrusted_vals=vals, now=NOW(p),
                trusting_period_s=PERIOD)

        svc = _svc(p, workers=1, batch=256)
        svc.start()
        try:
            assert E.prewarm([v.pub_key.bytes() for v in vals.validators],
                             **dev(p))
            solo = svc._verify_direct(req())
            assert solo.ok, solo.error
            p.trace.enable(capacity=1 << 14)
            since = p.trace.last_seq()
            release, plug_fut = _plug(p, svc)
            futs = [svc.submit(req(), client=f"client-{i}")
                    for i in range(12)]
            release.set()
            assert plug_fut.result(timeout=60.0).ok
            verdicts = [_verdict(f.result(timeout=120.0)) for f in futs]
            assert all(v == _verdict(solo) for v in verdicts)
            spans = p.trace.snapshot(since)
            coal = [r for r in spans if r["name"] == "light.coalesce"
                    and r["attrs"].get("cls") == "light"]
            assert len(coal) == 1 and coal[0]["attrs"]["waiters"] == 12
            launches = [r for r in spans if r["name"] == "device.launch"]
            assert len(launches) == 1, launches
            ll = E.last_launch()
            assert ll["path"] == "comb" and ll["first_launch"] is False
            st = svc.stats()
            assert st["coalesce_hit"] >= 11
            return {"verdicts": verdicts, "waiters": 12,
                    "launches": len(launches),
                    "launch": (ll["path"], ll["n"], ll["first_launch"]),
                    "stats": {k: st[k] for k in ("verified", "refuted",
                                                 "coalesce_lead",
                                                 "coalesce_hit")}}
        finally:
            svc.stop()
            p.trace.disable()
            E.table_cache_clear()
            p.degrade.reset()

    got = {}
    for p in PKGS:
        with monkeypatch.context() as mp:
            got[p.name] = play(p, mp)
    assert got["jax"] == got["port"]


# ---------------------------------------------------------------------------
# the departures: device=, no CUDA, card faults
# ---------------------------------------------------------------------------

def test_device_reaches_certificates_and_the_direct_path():
    """LightServe(device=) hands its device to every certificate, on the
    coalesced and the direct path; the device is resolved when the
    service is made."""
    svc = _svc(PORT)
    assert svc.device == torch.device("cpu")
    vals = _StubVals(b"dev")
    assert svc._verify_direct(_req(PORT, vals)).ok
    svc.start()
    try:
        assert svc.verify(_req(PORT, vals, h=6), timeout=10.0).ok
    finally:
        svc.stop()
    assert vals.devices == ["cpu", "cpu"]


def test_service_not_made_without_cuda(monkeypatch):
    """With no CUDA and no device="cpu" the constructor raises RuntimeError
    (as VerifyScheduler's does), instead of a service whose every
    certificate would be refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.svc.LightServe(PORT.bstore.BlockStore(PORT.kvdb.MemDB()),
                            PORT.sstore.StateStore(PORT.kvdb.MemDB()), CHAIN)
    svc = _svc(PORT)
    assert svc.device == torch.device("cpu")


def _card_error():
    return PORT.degrade.DeviceLaneError("launch failed on the card")


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_on_the_coalesced_path(drill):
    """A certificate whose launch failed on the card: outside a drill the
    lead's future and every coalesced waiter's raise the DeviceLaneError,
    nothing is counted refuted or settled (light_requests_total unmoved),
    and a later request over another certificate is served; in a drill
    each gets the refused verdict with the error's message, as in the JAX
    package."""
    svc = _private_metrics(PORT, _svc(PORT, workers=1, batch=256))
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
    svc.start()
    try:
        release, plug_fut = _plug(PORT, svc)
        broken = _StubVals(b"card", fail_with=_card_error())
        futs = [svc.submit(_req(PORT, broken), client=f"c{i}")
                for i in range(5)]
        release.set()
        assert plug_fut.result(timeout=30.0).ok
        if drill:
            got = [_verdict(f.result(timeout=30.0)) for f in futs]
            assert got == [(False, "launch failed on the card", None)] * 5
        else:
            for f in futs:
                with pytest.raises(PORT.degrade.DeviceLaneError):
                    f.result(timeout=30.0)
        assert len(broken.calls) == 1
        after = svc.verify(_req(PORT, _StubVals(b"next"), h=6),
                           timeout=10.0)
        assert after.ok
        st = svc.stats()
    finally:
        svc.stop()
    m = _light_metrics(svc)
    assert (st["refuted"], m["refused"]) == ((5, 5) if drill else (0, 0))
    assert (st["verified"], m["ok"]) == (2, 2)
    assert (st["coalesce_lead"], st["coalesce_hit"]) == (3, 4)


def test_card_fault_on_the_direct_path():
    """The direct path (a stopped service; the light.serve drill) raises a
    card fault through the future outside a drill; in the light.serve
    drill itself the JAX package's refused verdict holds."""
    svc = _svc(PORT)
    broken = _StubVals(b"card", fail_with=_card_error())
    f = svc.submit(_req(PORT, broken), client="late")
    assert f.done()
    with pytest.raises(PORT.degrade.DeviceLaneError):
        f.result(0)
    with pytest.raises(PORT.degrade.DeviceLaneError):
        svc.verify(_req(PORT, broken), timeout=1.0)
    assert svc.stats()["refuted"] == 0
    PORT.fail.set_mode("light.serve", "raise")
    svc.start()
    try:
        v = svc.submit(_req(PORT, broken), client="drill").result(0)
    finally:
        svc.stop()
    assert _verdict(v) == (False, "launch failed on the card", None)


def test_real_chain_verdicts_equal_the_direct_path():
    """Adjacent and skipping requests over a real 5-validator chain (one
    with its header tampered) through the queue: each verdict equals the
    direct path's, and both packages give the same verdicts."""
    got = {}
    for p in PKGS:
        gdoc, blocks, block_store, state_store, states = chain_stores(
            p, 8, n_vals=5)
        svc = p.svc.LightServe(block_store, state_store, gdoc.chain_id,
                               prewarm=False, **dev(p))
        lbs = {lb.height: lb for lb in svc.poll(svc.subscribe("x"))}
        reqs = [p.svc.LightRequest(
            "adjacent", gdoc.chain_id, trusted=lbs[h].signed_header,
            untrusted=lbs[h + 1].signed_header,
            untrusted_vals=lbs[h + 1].validators, now=NOW(p),
            trusting_period_s=PERIOD) for h in range(1, 8)]
        reqs.append(p.svc.LightRequest(
            "non_adjacent", gdoc.chain_id, trusted=lbs[1].signed_header,
            trusted_vals=lbs[1].validators,
            untrusted=lbs[8].signed_header, untrusted_vals=lbs[8].validators,
            now=NOW(p), trusting_period_s=PERIOD))
        import copy
        bad = copy.deepcopy(lbs[5].signed_header)
        bad.header.app_hash = b"\x01" * 32
        reqs.append(p.svc.LightRequest(
            "adjacent", gdoc.chain_id, trusted=lbs[4].signed_header,
            untrusted=bad, untrusted_vals=lbs[5].validators, now=NOW(p),
            trusting_period_s=PERIOD))
        direct = [_verdict(svc._verify_direct(r)) for r in reqs]
        svc.start()
        try:
            futs = [svc.submit(r, client=f"c{i}") for i, r in enumerate(reqs)]
            queued = [_verdict(f.result(timeout=30.0)) for f in futs]
        finally:
            svc.stop()
        assert queued == direct
        got[p.name] = queued
    assert got["jax"] == got["port"]
    assert [v[0] for v in got["port"]] == [True] * 8 + [False]
