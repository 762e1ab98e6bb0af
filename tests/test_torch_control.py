"""The port's adaptive control plane (libs/control.py, ControlMetrics, the
control.decide chaos site) against the JAX package's, on the CPU.

Each of tests/test_control.py's 23 cases runs unchanged through both
packages: the JAX side is the test file itself, the port side the same
file with every path into the JAX package mapped to the port
(test_torch_config.port_twin).  The decision table runs on the tests'
injected signals and clock (`Controller._decide(k, sources, burns, now)`);
the locksan hammer runs the port's controller, scheduler, gate and
pipeline under a lockset monitor that wraps the port's locks with the JAX
package's ranks, on test_torch_blocksync's chain.  Beside those: both
packages' controllers fed the same decision sequence give the same ring,
and the control.decide drill on a port Node with [control] enable reverts
every knob the node registered.  Tolerance: exact equality.
"""
from __future__ import annotations

import time

import pytest

import test_control as J
from test_torch_blocksync import BY_NAME as CHAIN_PKG
from test_torch_blocksync import PORT as CHAIN_PORT
from test_torch_blocksync import build_chain, make_genesis
from test_torch_config import PKGS, call_case, case_names, port_twin
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

from tendermint_tpu.libs import control as jcontrol
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu_torch.libs import control as tcontrol
from tendermint_tpu_torch.libs import fail as tfail

P = port_twin("test_control", replace=[(
    "    from helpers import build_chain, make_genesis\n",
    "    from test_torch_control import port_build_chain as build_chain\n"
    "    from test_torch_control import port_make_genesis as make_genesis\n"
)])
CASES = case_names(J)


def port_make_genesis(n):
    return make_genesis(CHAIN_PORT, n)


def port_build_chain(gdoc, privs, n):
    return build_chain(CHAIN_PORT, gdoc, privs, n)


@pytest.fixture(autouse=True)
def _clean_control():
    """Both packages' control surfaces as the JAX test's autouse fixture
    leaves them: no controller, no config override, no armed chaos."""
    yield
    for c, f in ((jcontrol, jfail), (tcontrol, tfail)):
        c.uninstall()
        c.set_config(enable=None)
        f.clear("control.decide")


def _port_locksan():
    """A lockset monitor over the port's locks with the JAX package's
    ranks (devtools/lockorder.py)."""
    from tendermint_tpu.devtools import lockorder
    from tendermint_tpu.devtools.tmlint.runtime import LockSanitizer

    ranks = {"tendermint_tpu_torch/" + k[len("tendermint_tpu/"):]: v
             for k, v in lockorder.LOCK_ORDER.items()
             if k.startswith("tendermint_tpu/")}
    return LockSanitizer(include_paths=("tendermint_tpu_torch/",),
                         rank_overrides=ranks)


def _params():
    out = []
    for case in CASES:
        marks = [pytest.mark.locksan] if case.startswith("test_locksan") \
            else []
        for side in ("jax", "port"):
            out.append(pytest.param(side, case, marks=marks,
                                    id=f"{case}[{side}]"))
    return out


def test_the_cases_are_the_reference_23():
    assert len(CASES) == 23 and case_names(P) == CASES


@pytest.mark.parametrize("side,case", _params())
def test_control_case(side, case, tmp_path, monkeypatch):
    """One case of tests/test_control.py through one package."""
    fn = getattr(J if side == "jax" else P, case)
    if side == "port" and case.startswith("test_locksan"):
        san = _port_locksan()
        san.install()
        try:
            call_case(fn, tmp_path=tmp_path, monkeypatch=monkeypatch)
        finally:
            san.uninstall()
        assert not san.violations, san.violations
        return
    call_case(fn, tmp_path=tmp_path, monkeypatch=monkeypatch)


def test_same_signals_give_the_same_ring():
    """Both packages' controllers, one knob each on a holder, fed the same
    sequence of burn rates and signal readings at the same injected
    times: the same decisions (direction, value, reason) and the same
    final value."""
    seq = [J.HOT] * 5 + [J.COLD] * 12 + [J.HOT] * 2 + [J.COLD] * 30
    out = {}
    for p, mod in (("jax", J), ("port", P)):
        ctl = mod.Controller(period_ms=10, recover_after=2)
        h = mod.Holder(96.0)
        k = ctl.register(mod._spec(), h.get, h.set)
        ring = []
        for i, burns in enumerate(seq):
            d = ctl._decide(k, {}, burns, 1_700_000_000.0 + i)
            ring.append(None if d is None
                        else (d.direction, d.value, d.reason))
        out[p] = (ring, h.v, ctl.report()["knobs"]["t_knob"]["static"])
    assert out["jax"] == out["port"]
    assert out["port"][1] == 96.0


def test_decide_drill_on_a_port_node(tmp_path):
    """The control.decide=raise drill on a port Node (device="cpu") with
    [control] enable: every knob the node registered, moved off its
    static value, is back at it after two skipped periods; the loop
    survives the drill.  The JAX package's node registers the same
    knobs."""
    knobs = {}
    for p in PKGS:
        cfg = p.Config(home=str(tmp_path / p.name), moniker="ctl")
        cfg.ensure_dirs()
        cfg.control.enable = True
        cfg.control.period_ms = 10.0
        cfg.rpc.enabled = False
        cfg.p2p.laddr = "127.0.0.1:0"
        gdoc, _ = make_genesis(CHAIN_PKG[p.name], 1)
        kw = {"device": "cpu"} if p.name == "port" else {}
        node = p.node.Node(cfg, p.kvstore.KVStoreApplication(),
                           genesis=gdoc, in_memory=True, **kw)
        node.start()
        try:
            c = tcontrol if p.name == "port" else jcontrol
            f = tfail if p.name == "port" else jfail
            ctl = c.installed()
            assert ctl is not None and ctl.is_running()
            knobs[p.name] = ctl.knobs()
            if p.name != "port":
                continue
            f.set_mode("control.decide", "raise")
            deadline = time.monotonic() + 10
            while f.fired("control.decide", "raise") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            for k in ctl._knobs.values():
                lo, hi = k.safe_range
                k.setter(hi if k.static != hi else lo)
            fired0 = f.fired("control.decide", "raise")
            while f.fired("control.decide", "raise") < fired0 + 2:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            rep = ctl.report()
            assert all(v["value"] == v["static"]
                       for v in rep["knobs"].values()), rep["knobs"]
            assert rep["skipped_periods"] >= 2
            f.clear("control.decide")
            p0 = ctl.report()["periods"]
            while ctl.report()["periods"] <= p0:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            node.stop()
        c = tcontrol if p.name == "port" else jcontrol
        assert c.installed() is None
    assert knobs["jax"] == knobs["port"]
    assert "mesh_chunk_lanes" in knobs["port"]
