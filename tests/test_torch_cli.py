"""The port's command line (cmd/__main__.py) against the JAX package's, on
the CPU.

tests/test_cli_tools.py's six cases run unchanged through both packages
(the port side through test_torch_config.port_twin, so `python -m
tendermint_tpu_torch.cmd`), each over a home whose node of its own
package committed a few blocks.  Beside them: homes made by either
package's `init` or `testnet` (config.toml, genesis.json,
priv_validator_key.json, node_key.json) start under the other's `start`
and commit, with the node id and validator address the home's; a
two-process localnet from the port's `testnet` homes started by the port's
CLI (`start --device cpu`), as tests/test_node_e2e.py does, commits a tx
on both nodes; `start` with no CUDA and no `--device cpu` exits with the
entry points' RuntimeError; `e2e` fails with its not-ported message and no
JAX import.  Socket tests bind free ports and run under `run_limited`.
"""
from __future__ import annotations

import base64
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import test_cli_tools as J
from test_torch_config import call_case, case_names, port_twin
from test_torch_statesync import run_limited

P = port_twin("test_cli_tools")
CASES = case_names(J)
MODS = {"jax": J, "port": P}
ROOTS = {"jax": "tendermint_tpu", "port": "tendermint_tpu_torch"}
REPO = J.REPO

CHILD = r"""
import sys, time
sys.path.insert(0, %(repo)r)
%(setup)s
from %(root)s.abci.kvstore import KVStoreApplication
from %(root)s.config.config import Config
from %(root)s.node import Node
cfg = Config.load(%(home)r); cfg.home = %(home)r
cfg.p2p.laddr = "127.0.0.1:0"; cfg.rpc.laddr = "127.0.0.1:0"
c = cfg.consensus
c.timeout_propose = c.timeout_prevote = c.timeout_precommit = 0.2
c.timeout_commit = 0.05
node = Node(cfg, KVStoreApplication())
node.start()
node.mempool.check_tx(b"cli=tools")
deadline = time.time() + 60
while node.block_store.height() < 4 and time.time() < deadline:
    time.sleep(0.05)
node.stop()
sys.exit(0 if node.block_store.height() >= 4 else 3)
"""
SETUP = {"jax": "import jax\njax.config.update('jax_platforms', 'cpu')",
         "port": "import tendermint_tpu_torch as T\n"
                 "T.set_default_device('cpu')"}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("TMHOME", None)
    env.pop("TM_TPU_FORCE_BATCH", None)
    return env


def cli(side, *argv, timeout=120):
    return subprocess.run([sys.executable, "-m", f"{ROOTS[side]}.cmd",
                           *argv], capture_output=True, cwd=REPO,
                          env=_env(), timeout=timeout, text=True)


def free_ports(n):
    """The first of n consecutive free ports on 127.0.0.1 (the testnet
    command numbers its nodes' ports up from a base)."""
    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(500):
        base = rng.randrange(20_000, 60_000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no range of free ports")


@pytest.fixture(scope="module")
def ran_homes(tmp_path_factory):
    """tests/test_cli_tools.py's `ran_home` through each package: a home
    made by the package's `init` whose node committed a few blocks and a
    tx, then stopped."""
    out = {}
    for side in ("jax", "port"):
        home = str(tmp_path_factory.mktemp(f"cli-{side}") / "node")
        r = cli(side, "--home", home, "init")
        assert r.returncode == 0, r.stderr
        child = CHILD % {"repo": REPO, "setup": SETUP[side],
                         "root": ROOTS[side], "home": home}
        r = subprocess.run([sys.executable, "-c", child], env=_env(),
                           capture_output=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        out[side] = home
    return out


def test_the_cases_are_the_reference_six():
    assert len(CASES) == 6 and case_names(P) == CASES


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_cli_case(case, side, ran_homes, tmp_path):
    """One case of tests/test_cli_tools.py through one package, in the
    JAX file's order (rollback, then reindex, then compact, then the
    dump, on one home)."""
    run_limited(lambda: call_case(getattr(MODS[side], case),
                                  ran_home=ran_homes[side],
                                  tmp_path=tmp_path), 240)


def _rpc(port, method, **params):
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                       "params": params}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as r:
        payload = json.loads(r.read())
    if "error" in payload:
        raise RuntimeError(payload["error"])
    return payload["result"]


def _start(side, home, *extra):
    argv = ["--home", home, "start", "--log-level", "error", *extra]
    if side == "port":
        argv += ["--device", "cpu"]
    return subprocess.Popen([sys.executable, "-m", f"{ROOTS[side]}.cmd",
                             *argv], cwd=REPO, env=_env(),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _height(port):
    try:
        return int(_rpc(port, "status")["sync_info"]["latest_block_height"])
    except Exception:  # noqa: BLE001 - not up yet
        return -1


def _wait_heights(procs, ports, h, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for p in procs:
            assert p.poll() is None, p.stderr.read().decode()[-2000:]
        if min(_height(port) for port in ports) >= h:
            return
        time.sleep(0.3)
    raise AssertionError(f"stalled at {[_height(p) for p in ports]}")


@pytest.mark.parametrize("maker,runner", [("jax", "port"), ("port", "jax")])
def test_init_home_starts_under_the_other(tmp_path, maker, runner):
    """A home made by one package's `init` (its config.toml, genesis.json,
    priv_validator_key.json and node_key.json) starts under the other
    package's `start` and commits blocks as that validator, with the
    home's node id."""
    home = str(tmp_path / "home")
    r = cli(maker, "--home", home, "init", "--chain-id", "across-chain")
    assert r.returncode == 0, r.stderr
    nid = cli(maker, "--home", home, "show-node-id").stdout.strip()
    key = json.load(open(os.path.join(home, "config",
                                      "priv_validator_key.json")))
    base = free_ports(2)

    def run():
        p = _start(runner, home, "--p2p-laddr", f"127.0.0.1:{base}",
                   "--rpc-laddr", f"127.0.0.1:{base + 1}")
        try:
            _wait_heights([p], [base + 1], 2, timeout=90)
            return _rpc(base + 1, "status")
        finally:
            _stop([p])
    st = run_limited(run, 150)
    assert st["node_info"]["id"] == nid
    assert st["node_info"]["network"] == "across-chain"
    assert st["validator_info"]["address"] == key["address"]
    assert int(st["validator_info"]["voting_power"]) == 10


def _testnet(side, out, n, base):
    r = cli(side, "testnet", "--v", str(n), "--o", out, "--chain-id",
            "e2e-chain", "--starting-p2p-port", str(base),
            "--starting-rpc-port", str(base + n))
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_two_process_localnet_on_the_ports_cli(tmp_path, maker):
    """tests/test_node_e2e.py's two-process localnet with the port's CLI:
    the homes of either package's `testnet`, both nodes started by the
    port's `start --device cpu`; the chain advances on both, the RPC
    surface answers, and a tx sent to node 1 commits and is queried back
    from node 0."""
    out = str(tmp_path / "net")
    base = free_ports(4)
    _testnet(maker, out, 2, base)
    g0 = json.load(open(os.path.join(out, "node0/config/genesis.json")))
    g1 = json.load(open(os.path.join(out, "node1/config/genesis.json")))
    assert g0 == g1 and len(g0["validators"]) == 2
    rpc0, rpc1 = base + 2, base + 3

    def run():
        procs = [_start("port", os.path.join(out, f"node{i}"))
                 for i in (0, 1)]
        try:
            _wait_heights(procs, [rpc0, rpc1], 3)
            st = _rpc(rpc0, "status")
            b = _rpc(rpc0, "block", height=2)
            c = _rpc(rpc0, "commit", height=2)
            v = _rpc(rpc0, "validators")
            ni = _rpc(rpc0, "net_info")
            res = _rpc(rpc1, "broadcast_tx_sync", tx=base64.b64encode(
                b"e2ekey=e2eval").decode())
            deadline = time.time() + 60
            found = False
            while time.time() < deadline and not found:
                time.sleep(0.5)
                q = _rpc(rpc0, "abci_query", path="/store",
                         data=b"e2ekey".hex())
                found = base64.b64decode(
                    q["response"]["value"] or "") == b"e2eval"
            return st, b, c, v, ni, res, found
        finally:
            _stop(procs)
    st, b, c, v, ni, res, found = run_limited(run, 180)
    assert st["node_info"]["network"] == "e2e-chain"
    assert b["block"]["header"]["height"] == "2"
    assert c["signed_header"]["commit"]["height"] == "2"
    assert v["total"] == "2" and ni["n_peers"] >= 1
    assert res["code"] == 0 and found


def test_start_without_cuda_refuses(tmp_path):
    """`start` with no CUDA and no `--device cpu` exits non-zero with the
    entry points' RuntimeError: the node does not carry on on the CPU."""
    home = str(tmp_path / "home")
    assert cli("port", "--home", home, "init").returncode == 0
    r = cli("port", "--home", home, "start", "--p2p-laddr", "127.0.0.1:0",
            "--rpc-laddr", "127.0.0.1:0", timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_e2e_is_not_ported_yet(tmp_path):
    """The `e2e` command stays registered; its runner (ROADMAP item 10)
    is not ported, so it fails with that message, importing no JAX."""
    m = tmp_path / "m.toml"
    m.write_text('chain_id = "x"\n')
    code = ("import sys, runpy\n"
            "sys.argv = ['cmd', 'e2e', %r]\n"
            "try:\n"
            "    runpy.run_module('tendermint_tpu_torch.cmd', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('EXIT', e.code)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'tendermint_tpu')]\n"
            "print('BAD', bad)\n") % str(m)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert "not ported yet (ROADMAP item 10)" in r.stdout
    assert "BAD []" in r.stdout


def test_every_reference_command_is_registered():
    """The port's parser registers every command of the JAX package's."""
    outs = {}
    for side in ("jax", "port"):
        r = cli(side, "--help")
        assert r.returncode == 0, r.stderr
        line = next(ln for ln in r.stdout.splitlines() if "{" in ln)
        outs[side] = line[line.index("{") + 1:line.index("}")].split(",")
    assert outs["jax"] == outs["port"]
    assert "e2e" in outs["port"] and "debug-device" in outs["port"]
