"""The port's consensus observatory (consensus/observatory.py) against the
JAX package's, on the CPU.

The standalone cases of tests/test_observatory.py (the record mechanics,
the chaos shed at observatory.record, the quorum-prevote delay, the
publication into the stage histograms and the [slo] streams) run through
both packages (the `pkg` parameter), and the same stamps give the same
records and reports in both.  No timing gate: where the JAX test times
the disabled path, this one holds its behaviour (nothing is recorded).
The observatory is process-global (its rings and pending queue), so every
test resets both packages' before and after.
"""
from __future__ import annotations

import importlib
import types

import pytest

_MODS = {"obsv": "consensus.observatory", "fail": "libs.fail",
         "slo": "libs.slo", "metrics": "libs.metrics"}


def _pkg(root: str, name: str):
    ns = types.SimpleNamespace(name=name, root=root)
    for attr, mod in _MODS.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _pkg("tendermint_tpu", "jax")
PORT = _pkg("tendermint_tpu_torch", "port")
PKGS = (JAX, PORT)


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        p.obsv.reset()
        p.obsv.enable()
        p.fail.reset()
    yield
    for p in PKGS:
        p.fail.reset()
        p.obsv.reset()
        p.obsv.enable()


ORDER = ("new_height", "propose_start", "proposal", "first_part",
         "parts_complete", "prevote_any", "prevote_quorum",
         "precommit_quorum", "commit", "apply_start", "apply_done")


def _full_lifecycle(o, node="n", height=1, t0=100.0):
    """Stamp one clean height: every stage 10 ms apart."""
    for i, stage in enumerate(ORDER):
        o.stamp(node, height, stage, t=t0 + 0.01 * i)
    return t0


def test_stage_decomposition_and_interval(pkg):
    o = pkg.obsv.Observatory(capacity=8, enabled=True)
    _full_lifecycle(o, height=1, t0=100.0)
    _full_lifecycle(o, height=2, t0=101.0)
    recs = o.records("n")
    assert [r["height"] for r in recs] == [1, 2]
    st = recs[0]["stages"]
    assert st["propose"] == pytest.approx(0.02)
    assert st["gossip"] == pytest.approx(0.02)
    assert st["prevote_wait"] == pytest.approx(0.02)
    assert st["precommit_wait"] == pytest.approx(0.01)
    assert st["commit"] == pytest.approx(0.02)
    assert st["apply"] == pytest.approx(0.01)
    assert st["persist"] is None
    assert recs[1]["info"]["interval_s"] == pytest.approx(1.0)
    assert recs[0].get("info", {}).get("interval_s") is None


def test_first_write_wins_and_final_round(pkg):
    o = pkg.obsv.Observatory(capacity=8, enabled=True)
    assert o.stamp("n", 5, "proposal", round_=0, t=1.0,
                   proposal_ts=10.0) is True
    assert o.stamp("n", 5, "proposal", round_=1, t=2.0,
                   proposal_ts=11.5) is False
    r = o.records("n")[0]
    assert r["stamps"]["proposal"] == 1.0
    assert r["final_round"] == 1
    assert r["info"]["proposal_ts"] == 11.5


def test_ring_bounds_hold_and_evictions_counted(pkg):
    o = pkg.obsv.Observatory(capacity=4, enabled=True)
    for h in range(1, 11):
        o.stamp("n", h, "new_height", t=float(h))
    recs = o.records("n")
    assert [r["height"] for r in recs] == [7, 8, 9, 10]
    assert o.shed_counts()["evict"] == 6
    o.stamp("m", 1, "new_height", t=1.0)
    assert len(o.records("n")) == 4 and len(o.records("m")) == 1


def test_receipt_updates_existing_records_only(pkg):
    o = pkg.obsv.Observatory(capacity=4, enabled=True)
    o.receipt("n", 999999, "part", "peer-a")
    assert o.records("n") == []
    o.stamp("n", 7, "new_height", t=1.0)
    o.receipt("n", 7, "part", "peer-a")
    o.receipt("n", 7, "part", "peer-a")
    o.receipt("n", 7, "vote", "peer-b")
    r = o.records("n")[0]
    assert r["parts_from"] == {"peer-a": 2}
    assert r["votes_from"] == {"peer-b": 1}
    for i in range(500):
        o.receipt("n", 7, "vote", f"peer-{i}")
    assert len(o.records("n")[0]["votes_from"]) <= 128


def test_pending_publication_queue_is_bounded(pkg):
    o = pkg.obsv.Observatory(capacity=8, enabled=True)
    for h in range(1, 6001):
        o.stamp("n", h, "apply_done", t=float(h))
    assert len(o._pending) <= 4096
    assert o.shed_counts()["evict"] >= 6000 - 4096


def test_disabled_records_nothing(pkg):
    """Disabled, stamps and receipts record nothing and publish nothing
    (the JAX test also times this path; no timing is gated here)."""
    obsv = pkg.obsv
    obsv.disable()
    try:
        assert obsv.stamp("n", 1, "new_height") in (None, False)
        obsv.stamp("n", 1, "commit", round_=0)
        obsv.receipt("n", 1, "part", "p")
        obsv.useful_receipt("n", 1, "part", "p")
        obsv.publish_pending()
        assert obsv.records("n") == [] and not obsv.is_enabled()
        assert obsv.OBS._pending == []
    finally:
        obsv.enable()


def test_chaos_record_raise_sheds_without_propagating(pkg):
    obsv, fail = pkg.obsv, pkg.fail
    CM = pkg.metrics.ConsensusMetrics
    before = CM().observatory_shed.value(reason="chaos")
    fail.set_mode("observatory.record", "raise")
    try:
        assert obsv.stamp("n", 1, "new_height") is False
        obsv.stamp("n", 1, "commit")
        obsv.receipt("n", 1, "part", "p")
        assert fail.fired("observatory.record", "raise") == 3
        assert obsv.records("n") == []
        assert obsv.OBS.shed_counts()["chaos"] == 3
        obsv.publish_pending()
        assert CM().observatory_shed.value(reason="chaos") == before + 3
        assert obsv.OBS.shed_counts()["chaos"] == 0
    finally:
        fail.clear()
    obsv.stamp("n", 2, "new_height")
    obsv.stamp("n", 2, "apply_done")
    obsv.publish_pending()
    assert CM().observatory_shed.value(reason="chaos") == before + 3
    assert [r["height"] for r in obsv.records("n")] == [2]


def test_chaos_latency_mode_also_swallowed(pkg):
    """latency:5 at observatory.record is absorbed into the recording:
    the stamp lands (its delay is not timed here)."""
    obsv, fail = pkg.obsv, pkg.fail
    fail.set_mode("observatory.record", "latency:5")
    try:
        obsv.stamp("n", 1, "new_height")
        assert fail.fired("observatory.record", "latency:5") == 1
        assert [r["height"] for r in obsv.records("n")] == [1]
    finally:
        fail.clear()


def test_quorum_prevote_delay_published_from_proposal_origin(pkg):
    obsv = pkg.obsv
    m = pkg.metrics.ConsensusMetrics()
    obsv.stamp("n", 3, "proposal", t=1.0, proposal_ts=500.0)
    obsv.stamp("n", 3, "prevote_quorum", t=1.1, prevote_quorum_ts=500.35)
    obsv.stamp("n", 3, "commit", t=1.2)
    obsv.stamp("n", 3, "apply_start", t=1.3)
    obsv.stamp("n", 3, "apply_done", t=1.4)
    obsv.publish_pending()
    assert m.quorum_prevote_delay.value() == pytest.approx(0.35)
    obsv.stamp("n", 4, "proposal", t=2.0, proposal_ts=600.0)
    obsv.stamp("n", 4, "prevote_quorum", t=2.1, prevote_quorum_ts=599.0)
    obsv.stamp("n", 4, "apply_done", t=2.2)
    obsv.publish_pending()
    assert m.quorum_prevote_delay.value() == 0.0
    m.quorum_prevote_delay.set(-1.0)
    obsv.stamp("n", 5, "proposal", t=3.0, proposal_ts=700.0,
               proposal_round=0)
    obsv.stamp("n", 5, "prevote_quorum", t=3.1, prevote_quorum_ts=700.2,
               prevote_quorum_round=0)
    obsv.stamp("n", 5, "proposal", t=3.2, proposal_ts=705.0,
               proposal_round=1)
    obsv.stamp("n", 5, "apply_done", t=3.3)
    obsv.publish_pending()
    assert m.quorum_prevote_delay.value() == -1.0
    obsv.stamp("n", 6, "proposal", t=4.0, proposal_ts=800.0,
               proposal_round=2)
    obsv.stamp("n", 6, "prevote_quorum", t=4.1, prevote_quorum_ts=800.25,
               prevote_quorum_round=2)
    obsv.stamp("n", 6, "apply_done", t=4.2)
    obsv.publish_pending()
    assert m.quorum_prevote_delay.value() == pytest.approx(0.25)


def test_publication_feeds_histogram_and_slo_streams(pkg):
    obsv, slo = pkg.obsv, pkg.slo
    slo.set_config(enabled=True, window=64)
    reg = pkg.metrics.ConsensusMetrics()
    base = {s: reg.height_stage.count(stage=s)
            for s in ("propose", "apply", "interval")}
    try:
        _full_lifecycle(obsv.OBS, node="n", height=1, t0=100.0)
        _full_lifecycle(obsv.OBS, node="n", height=2, t0=101.0)
        obsv.publish_pending()
        assert reg.height_stage.count(stage="propose") == \
            base["propose"] + 2
        assert reg.height_stage.count(stage="apply") == base["apply"] + 2
        assert reg.height_stage.count(stage="interval") == \
            base["interval"] + 1
        for stream in ("propose", "quorum_prevote", "apply",
                       "block_interval"):
            assert slo.stream_report(stream) is not None, stream
        assert slo.stream_report("block_interval")["n"] == 1
        obsv.publish_pending()
        assert reg.height_stage.count(stage="apply") == base["apply"] + 2
    finally:
        slo.set_config(enabled=False)
        slo.reset()


def _script(o):
    """One stamp stream: two nodes, a dirty round, receipts, evictions,
    a durable stamp."""
    for node in ("a", "b"):
        for h in range(1, 8):
            t0 = 10.0 * h + (0.5 if node == "b" else 0.0)
            for i, stage in enumerate(ORDER):
                o.stamp(node, h, stage, t=t0 + 0.013 * i * h,
                        round_=1 if (h == 3 and stage == "commit") else 0)
            o.receipt(node, h, "part", f"peer-{h % 3}")
            o.receipt(node, h, "vote", "peer-x")
            o.useful_receipt(node, h, "vote", "peer-x")
        o.stamp(node, 6, "durable", t=70.0)


def _no_wall(x):
    """x without the records' wall-clock creation time (wall0)."""
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall0"}
    if isinstance(x, (list, tuple)):
        return [_no_wall(v) for v in x]
    return x


def test_reports_equal_across_packages():
    """The same stamps give the same records, report, skew report and
    shed counts in both packages (all but each record's wall-clock
    creation time)."""
    got = {}
    for p in PKGS:
        o = p.obsv.Observatory(capacity=5, enabled=True)
        _script(o)
        got[p.name] = _no_wall((o.records("a"), o.records("b", last=2),
                                o.report(last=3), o.shed_counts(), o.nodes(),
                                o.skew_report()))
    assert got["jax"] == got["port"]
    assert [r["height"] for r in got["port"][0]] == [3, 4, 5, 6, 7]


def test_metric_names_and_buckets_equal():
    """ConsensusMetrics and StateMetrics register the same families with
    the same kinds, labels and buckets in both packages."""
    got = {}
    for p in PKGS:
        reg = p.metrics.Registry("obs")
        bundles = (p.metrics.ConsensusMetrics(reg),
                   p.metrics.StateMetrics(reg))
        fams = []
        for b in bundles:
            for attr, m in sorted(vars(b).items()):
                fams.append((type(b).__name__, attr, m.name, m.kind,
                             m.label_names,
                             tuple(getattr(m, "buckets", ()) or ())))
        got[p.name] = fams
    assert got["jax"] == got["port"]
    assert len(got["port"]) == 18
