"""The port's debug server (libs/pprof.py) against the JAX package's, on
the CPU.

tests/test_pprof.py's two cases run unchanged through both packages (the
port side through test_torch_config.port_twin).  Beside them: both
packages' PprofServers, in one process, answer every registered route
(DEBUG_ENDPOINTS) with the same status, content type and, for the JSON
routes, the same keys; the index pages are equal; a port Node's own pprof
listener serves /debug/device, /debug/light, /debug/control and the rest
over its observatories.  Tolerance: exact equality.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

import test_pprof as J
from test_torch_blocksync import BY_NAME as CHAIN_PKG
from test_torch_blocksync import make_genesis
from test_torch_config import PKGS, call_case, case_names, port_twin
from test_torch_statesync import run_limited
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

from tendermint_tpu.libs import pprof as jpprof
from tendermint_tpu_torch.libs import pprof as tpprof

P = port_twin("test_pprof")
CASES = case_names(J)
# the routes as an operator asks for them (query strings kept short: a
# profile of 0.2 s, the newest 4 records)
ROUTES = ("/debug", "/debug/stacks", "/debug/threads",
          "/debug/profile?seconds=0.2", "/debug/gc", "/debug/trace?since=0",
          "/debug/latency", "/debug/consensus?last=4",
          "/debug/device?last=4", "/debug/control", "/debug/net",
          "/debug/light", "/debug/nope")


def _get(laddr, path):
    try:
        with urllib.request.urlopen(f"http://{laddr}{path}",
                                    timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_pprof_case(case, side):
    """One case of tests/test_pprof.py through one package."""
    run_limited(lambda: call_case(getattr(J if side == "jax" else P,
                                          case)), 60)


def test_the_route_tables_are_the_reference():
    assert tpprof.DEBUG_ENDPOINTS == jpprof.DEBUG_ENDPOINTS
    assert tpprof.debug_index_text() == jpprof.debug_index_text()
    assert {r.split("?")[0] for r in ROUTES} - {"/debug/nope"} \
        == {p.split("?")[0] for p, _ in tpprof.DEBUG_ENDPOINTS}


def _shape(status, ctype, body):
    """What must agree between the packages: the status, the content
    type and, for JSON, the keys (the values are each process-global
    observatory's own)."""
    if ctype and ctype.startswith("application/json"):
        doc = json.loads(body)
        return status, ctype, sorted(doc) if isinstance(doc, dict) \
            else type(doc).__name__
    return status, ctype


@pytest.mark.parametrize("route", ROUTES)
def test_every_route_answers_alike(route):
    """Both packages' servers, started side by side, answer the route with
    the same status, content type and JSON keys."""
    def run():
        servers = [m.PprofServer("127.0.0.1:0") for m in (jpprof, tpprof)]
        for s in servers:
            s.start()
        try:
            return [_get(s.laddr, route) for s in servers]
        finally:
            for s in servers:
                s.stop()
    (j_st, j_ct, j_body), (t_st, t_ct, t_body) = run_limited(run, 60)
    assert _shape(j_st, j_ct, j_body) == _shape(t_st, t_ct, t_body)
    if route == "/debug/gc":
        assert [ln.split(":")[0] for ln in j_body.splitlines()] == \
            [ln.split(":")[0] for ln in t_body.splitlines()]
    if route == "/debug":
        assert j_body == t_body


def test_a_port_nodes_own_debug_server(tmp_path):
    """A port Node on device="cpu" with [rpc] pprof_laddr serves every
    route over its own observatories; /debug/light reports its running
    LightServe, /debug/control its controller's knobs."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.config.config import Config
    from tendermint_tpu_torch.node import Node

    def run():
        cfg = Config(home=str(tmp_path), moniker="dbg")
        cfg.ensure_dirs()
        cfg.p2p.laddr = "127.0.0.1:0"
        cfg.rpc.laddr = "127.0.0.1:0"
        cfg.rpc.pprof_laddr = "127.0.0.1:0"
        cfg.control.enable = True
        gdoc, _ = make_genesis(CHAIN_PKG["port"], 1)
        node = Node(cfg, KVStoreApplication(), genesis=gdoc,
                    in_memory=True, device="cpu")
        node.start()
        try:
            laddr = node.pprof_server.laddr
            return {r: _get(laddr, r) for r in ROUTES}
        finally:
            node.stop()
    got = run_limited(run, 90)
    for route, (st, ct, body) in got.items():
        assert st == (404 if route == "/debug/nope" else 200), route
    light = json.loads(got["/debug/light"][2])
    ctl = json.loads(got["/debug/control"][2])
    assert light["running"] is True
    assert ctl["running"] is True and "mesh_chunk_lanes" in ctl["knobs"]
    assert "launches" in json.loads(got["/debug/device?last=4"][2])
