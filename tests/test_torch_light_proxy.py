"""The port's light proxy (light/proxy.py) against the JAX package's, on
the CPU.

tests/test_light_proxy.py's seven cases run unchanged through both
packages (the port side through test_torch_config.port_twin), each over a
live single-validator node of its own package made as the JAX test's
fixture makes it (the port's Node and light client on device="cpu").
Beside them: the port's proxy in front of the JAX package's node answers
headers, commits and validator sets equal to the JAX proxy's, verified by
the port's light client.  Tolerance: exact equality.
"""
from __future__ import annotations

import base64
import importlib
import time

import pytest

import test_light_proxy as J
from test_torch_config import call_case, case_names, port_twin
from test_torch_statesync import run_limited
from test_torch_types import _one_torch_thread  # noqa: F401

P = port_twin("test_light_proxy")
CASES = case_names(J)
MODS = {"jax": J, "port": P}


def _dev(side):
    return {"device": "cpu"} if side == "port" else {}


def _make_node(side, home):
    """tests/test_light_proxy.py's `node` fixture through one package."""
    m = MODS[side]
    root = "tendermint_tpu_torch" if side == "port" else "tendermint_tpu"
    params_mod = importlib.import_module(f"{root}.types.params")
    cfg = m.Config(home=home)
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "127.0.0.1:0"
    c = cfg.consensus
    c.timeout_propose = c.timeout_prevote = c.timeout_precommit = 0.2
    c.timeout_propose_delta = c.timeout_prevote_delta = \
        c.timeout_precommit_delta = 0.1
    c.timeout_commit = 0.05
    cfg.ensure_dirs()
    pv = m.FilePV.load_or_generate(cfg.priv_validator_key_file(),
                                   cfg.priv_validator_state_file())
    m.NodeKey.load_or_generate(cfg.node_key_file())
    pub = pv.get_pub_key()
    params = params_mod.ConsensusParams()
    params.block.time_iota_ms = 1
    gdoc = m.GenesisDoc(chain_id="light-proxy-chain",
                        genesis_time=m.Timestamp(1700000000, 0),
                        consensus_params=params,
                        validators=[m.GenesisValidator(
                            address=pub.address(),
                            pub_key_type=pub.type_name,
                            pub_key_bytes=pub.bytes(), power=10)])
    with open(cfg.genesis_file(), "w") as f:
        f.write(gdoc.to_json())
    n = m.Node(cfg, m.ProvableKVStoreApplication(), **_dev(side))
    n.start()
    deadline = time.time() + 60
    while n.block_store.height() < 3 and time.time() < deadline:
        time.sleep(0.05)
    assert n.block_store.height() >= 3, "node made no progress"
    return n


def _make_proxy(side, node):
    """tests/test_light_proxy.py's `proxy` fixture through one package."""
    m = MODS[side]
    addr = node.rpc_server.laddr
    chain_id = node.state.chain_id
    provider = m.HTTPProvider(chain_id, addr)
    anchor = provider.light_block(1)
    client = m.Client(chain_id, m.TrustOptions(1, anchor.hash()),
                      provider, witnesses=[], store=m.LightStore(m.MemDB()),
                      **_dev(side))
    p = m.LightProxy(client, addr, "127.0.0.1:0")
    p.start()
    return p


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A live node and a proxy in front of it, for each package."""
    out = {}
    for side in ("jax", "port"):
        home = str(tmp_path_factory.mktemp(f"lightproxy-{side}"))
        node = run_limited(lambda: _make_node(side, home), 90)
        out[side] = (node, run_limited(lambda: _make_proxy(side, node), 60))
    yield out
    for node, proxy in out.values():
        proxy.stop()
        node.stop()


def test_the_cases_are_the_reference_seven():
    assert len(CASES) == 7 and case_names(P) == CASES


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_light_proxy_case(case, side, served):
    """One case of tests/test_light_proxy.py through one package, in the
    JAX file's order (the abci_query cases read the key the first one
    committed)."""
    node, proxy = served[side]
    run_limited(lambda: call_case(getattr(MODS[side], case), node=node,
                                  proxy=proxy), 90)


def test_port_proxy_in_front_of_a_jax_node(served):
    """The port's light client and proxy over the JAX package's node RPC:
    every header, commit and validator set it serves equals the JAX
    proxy's for the same height, and is marked verified."""
    jnode, jproxy = served["jax"]

    def run():
        tproxy = _make_proxy("port", jnode)
        try:
            out = []
            for h in (1, 2, 3):
                a = [J._call(px, "header", height=h)
                     for px in (jproxy, tproxy)]
                b = [J._call(px, "commit", height=h)
                     for px in (jproxy, tproxy)]
                c = [J._call(px, "validators", height=h)
                     for px in (jproxy, tproxy)]
                out.append((a[0] == a[1], b[0] == b[1], c[0] == c[1],
                            b[1]["verified"], c[1]["verified"]))
            sh = P.SignedHeader.from_proto(
                base64.b64decode(J._call(tproxy, "commit",
                                         height=2)["signed_header"]))
            return out, sh.height
        finally:
            tproxy.stop()
    out, h = run_limited(run, 90)
    assert out == [(True,) * 5] * 3 and h == 2
