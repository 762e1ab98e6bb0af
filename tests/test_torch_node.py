"""The port's node (node/node.py) against the JAX package's, on the CPU.

- The handshake's decision table (fresh chain, app behind the store, app
  level, app ahead, the state store behind the block store) on each
  package's own seeded chain (tests/test_torch_blocksync.py's
  `build_chain`): stores do not cross packages, so the heights, app hashes
  and the app's calls are compared.
- `Node.status()` from both packages over one home's keys and genesis.
- The entry-point rule: with no CUDA and no device="cpu" a Node is not
  made.
- An in-process 4-node localnet of port Nodes on device="cpu", and a
  mixed localnet of two JAX and two port Nodes over TCP committing one
  chain.
- The port's two card-fault departures: the state-sync routine keeps a
  card fault on `node.device_error` (no blocksync fallback, nothing
  offered, rejected or banned) and resumes from its RestoreLedger, by
  `resume_statesync()` or a fresh Node over the same home; a card fault in
  the state machine's apply_block ends consensus with the block and its
  #ENDHEIGHT on disk, and a fresh Node over the same home resumes through
  the handshake's "app behind store" replay and the WAL.
- Every item 9 case of ROADMAP's "JAX tests still waiting" list,
  tests/test_node_statesync.py's joiner among them, each JAX test
  function run through the port (test_torch_config.port_twin).

Socket tests bind port 0 (or free ports) and run under `run_limited`.
Tolerance: exact equality.
"""
from __future__ import annotations

import importlib
import inspect
import json
import os
import shutil
import time

import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_blocksync import BY_NAME as CHAIN_PKG
from test_torch_blocksync import PORT as CHAIN_PORT
from test_torch_blocksync import build_chain as bs_build_chain
from test_torch_blocksync import make_genesis as bs_make_genesis
from test_torch_config import BY_NAME, PKGS, port_twin
from test_torch_statesync import run_limited
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

_MODS = {"abci": "abci.types", "kvstore": "abci.kvstore",
         "node_mod": "node.node", "kvdb": "libs.kvdb",
         "sstore": "state.store", "bstore": "store.block_store",
         "state": "state.state", "execution": "state.execution",
         "degrade": "crypto.degrade", "cconfig": "consensus.config",
         "fpv": "privval.file_pv", "key": "p2p.key",
         "genesis": "types.genesis", "basic": "types.basic",
         "params": "types.params", "provider": "light.provider",
         "ledger": "statesync.ledger", "syncer": "statesync.syncer",
         "wal": "consensus.wal", "metrics": "libs.metrics"}
for _p in PKGS:
    for _a, _m in _MODS.items():
        setattr(_p, _a, importlib.import_module(f"{_p.root}.{_m}"))
JAX, PORT = BY_NAME["jax"], BY_NAME["port"]


def make_genesis(n, power=10):
    """tests/helpers.py make_genesis through the port."""
    return bs_make_genesis(CHAIN_PORT, n, power)


def build_chain(gdoc, privs, n, **kw):
    """tests/helpers.py build_chain through the port."""
    return bs_build_chain(CHAIN_PORT, gdoc, privs, n, **kw)


# the replacement for `from helpers import ...` in a JAX test run through
# the port (its child processes too): the port's chain builders
HELPERS = ("from helpers import build_chain, make_genesis\n",
           "import tendermint_tpu_torch as _T\n"
           "_T.set_default_device('cpu')\n"
           "from test_torch_blocksync import PORT as _PB\n"
           "from test_torch_blocksync import build_chain as _bc\n"
           "from test_torch_blocksync import make_genesis as _mg\n"
           "def make_genesis(n, power=10):\n"
           "    return _mg(_PB, n, power)\n"
           "def build_chain(gdoc, privs, n, **kw):\n"
           "    return _bc(_PB, gdoc, privs, n, **kw)\n")


def _dev(p):
    return {"device": "cpu"} if p is PORT else {}


def wait_for(cond, timeout, what="condition"):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"{what} timed out"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# the handshake's decision table
# ---------------------------------------------------------------------------

class Recording:
    """A kvstore recording every ABCI call it gets: (method, height)."""

    def __init__(self, p):
        self.app = p.kvstore.KVStoreApplication()
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self.app, name)
        if name not in ("info", "init_chain", "begin_block", "deliver_tx",
                        "end_block", "commit"):
            return fn

        def rec(*a, **k):
            out = fn(*a, **k)
            self.calls.append((name, getattr(self.app, "height", None)))
            return out
        return rec


def _chain(p, heights=6):
    b = CHAIN_PKG[p.name]
    gdoc, privs = bs_make_genesis(b, 4)
    blocks, commits, states = bs_build_chain(
        b, gdoc, privs, heights, txs_fn=lambda h: [b"k%d=v%d" % (h, h)])
    return gdoc, blocks, commits, states


def _stores(p, gdoc, blocks, commits, upto, state_upto):
    """Block store holding blocks 1..upto, state store at state_upto (the
    chain applied by a BlockExecutor up to there)."""
    ss = p.sstore.StateStore(p.kvdb.MemDB())
    bs = p.bstore.BlockStore(p.kvdb.MemDB())
    ex = p.execution.BlockExecutor(ss, p.kvstore.KVStoreApplication(),
                                   **_dev(p))
    st = p.state.state_from_genesis(gdoc)
    ss.save(st)
    for h in range(1, upto + 1):
        blk = blocks[h - 1]
        if h <= state_upto:
            if h > 1:
                ex.mark_commit_verified(h - 1, commits[h - 2])
            st, _ = ex.apply_block(st, commits[h - 1].block_id, blk)
        bs.save_block(blk, _parts(p, blk), commits[h - 1])
    return ss, bs, st


def _parts(p, blk):
    ps = importlib.import_module(f"{p.root}.types.part_set")
    return ps.make_block_parts(blk)


def _case(p, case):
    gdoc, blocks, commits, states = _chain(p)
    app = Recording(p)
    if case == "fresh":
        ss = p.sstore.StateStore(p.kvdb.MemDB())
        bs = p.bstore.BlockStore(p.kvdb.MemDB())
        st = p.state.state_from_genesis(gdoc)
    elif case == "app_behind":
        ss, bs, st = _stores(p, gdoc, blocks, commits, 6, 6)
    elif case == "state_behind":
        ss, bs, st = _stores(p, gdoc, blocks, commits, 6, 3)
    elif case == "app_level":
        ss, bs, st = _stores(p, gdoc, blocks, commits, 2, 2)
        # an app at the stores' height: replay the two blocks into it first
        p.node_mod.handshake(app, st, ss, bs, gdoc)
        app.calls.clear()
    elif case == "app_ahead":
        ss, bs, st = _stores(p, gdoc, blocks, commits, 2, 2)
        p.node_mod.handshake(app, st, ss, bs, gdoc)
        bs = p.bstore.BlockStore(p.kvdb.MemDB())
        app.calls.clear()
    try:
        out = p.node_mod.handshake(app, st, ss, bs, gdoc)
    except p.node_mod.NodeError as e:
        return ("NodeError", str(e), app.calls)
    info = app.app.info(p.abci.RequestInfo())
    return (out.last_block_height, out.app_hash.hex(),
            info.last_block_height, (info.last_block_app_hash or b"").hex(),
            ss.load().last_block_height, app.calls,
            out.app_hash == (states[out.last_block_height - 1].app_hash
                             if out.last_block_height else out.app_hash))


@pytest.mark.parametrize("case", ["fresh", "app_behind", "state_behind",
                                  "app_level", "app_ahead"])
def test_handshake_decision_table(case):
    """Each package's handshake on its own seeded chain: the same heights,
    app hashes and ABCI calls (the chains are byte-identical, so the
    hashes are too)."""
    got = {p.name: _case(p, case) for p in PKGS}
    assert got["jax"] == got["port"]
    if case == "app_ahead":
        assert got["port"][0] == "NodeError"
    else:
        assert got["port"][-1] is True
    if case == "app_behind":
        assert got["port"][0] == 6 and got["port"][2] == 6
    if case == "state_behind":
        assert got["port"][0] == 6 and got["port"][4] == 6


# ---------------------------------------------------------------------------
# nodes from config homes
# ---------------------------------------------------------------------------

def _home(p, base, name, gdoc=None, pv_from=None, fast=True):
    """A node home of package p: config on port 0 (or given), genesis, a
    FilePV copied from pv_from (or none: a non-validator), a node key."""
    home = os.path.join(str(base), name)
    cfg = p.Config(home=home, moniker=name)
    cfg.ensure_dirs()
    if fast:
        cfg.consensus = p.cconfig.test_config()
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.rpc.laddr = "127.0.0.1:0"
    if pv_from is not None:
        for f in (cfg.priv_validator_key_file(),
                  cfg.priv_validator_state_file()):
            src = os.path.join(pv_from, "config" if f.endswith("key.json")
                               else "data", os.path.basename(f))
            if os.path.exists(src):
                shutil.copy(src, f)
    if gdoc is not None:
        with open(cfg.genesis_file(), "w") as f:
            f.write(gdoc.to_json())
    return cfg


def _validators(base, n, p=PORT, chain_id="node-chain"):
    """n FilePV homes' keys (made by package p) and a genesis naming them,
    its time now (the light client's trust period holds it)."""
    keys = []
    for i in range(n):
        d = os.path.join(str(base), f"keys{i}")
        os.makedirs(os.path.join(d, "config"), exist_ok=True)
        os.makedirs(os.path.join(d, "data"), exist_ok=True)
        pv = p.fpv.FilePV.load_or_generate(
            os.path.join(d, "config", "priv_validator_key.json"),
            os.path.join(d, "data", "priv_validator_state.json"))
        keys.append((d, pv.get_pub_key()))
    params = p.params.ConsensusParams()
    params.block.time_iota_ms = 1
    gdoc = p.genesis.GenesisDoc(
        chain_id=chain_id, genesis_time=p.basic.Timestamp(
            int(time.time()) - 60, 0), consensus_params=params,
        validators=[p.genesis.GenesisValidator(
            address=pub.address(), pub_key_type=pub.type_name,
            pub_key_bytes=pub.bytes(), power=10) for _, pub in keys])
    return [d for d, _ in keys], gdoc


def _gdoc_in(p, gdoc):
    return p.genesis.GenesisDoc.from_json(gdoc.to_json())


def _node(p, cfg, app=None, **kw):
    return p.node_mod.Node(cfg, app or p.kvstore.KVStoreApplication(),
                           **_dev(p), **kw)


def test_status_json_is_the_references(tmp_path):
    """Node.status() of a JAX and a port Node over the same validator key,
    node key and genesis: the same JSON but the listen address and the
    chain's tip (each node makes its own blocks)."""
    dirs, gdoc = _validators(tmp_path, 1)
    node_key = os.path.join(dirs[0], "config", "node_key.json")
    PORT.key.NodeKey.load_or_generate(node_key)

    def run():
        out = {}
        for p in PKGS:
            cfg = _home(p, tmp_path / p.name, "n", _gdoc_in(p, gdoc),
                        pv_from=dirs[0])
            shutil.copy(node_key, cfg.node_key_file())
            n = _node(p, cfg)
            n.start()
            try:
                wait_for(lambda: n.block_store.height() >= 1, 30)
                st = n.status()
            finally:
                n.stop()
            st["node_info"].pop("listen_addr")
            for k in ("latest_block_height", "latest_block_hash",
                      "latest_app_hash", "latest_block_time"):
                st["sync_info"].pop(k)
            out[p.name] = st
        return out
    got = run_limited(run, 90)
    assert got["jax"] == got["port"]
    assert got["port"]["validator_info"]["voting_power"] == "10"


def test_node_cuda_missing_raises(tmp_path, monkeypatch):
    """With no CUDA and no device="cpu" a port Node is not made (the
    package default "cuda"); device="cpu" makes it."""
    dirs, gdoc = _validators(tmp_path, 1)
    cfg = _home(PORT, tmp_path, "n", gdoc, pv_from=dirs[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.node_mod.Node(cfg, PORT.kvstore.KVStoreApplication(),
                           in_memory=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.node_mod.Node(cfg, PORT.kvstore.KVStoreApplication(),
                           in_memory=True, device="cuda")
    n = PORT.node_mod.Node(cfg, PORT.kvstore.KVStoreApplication(),
                           in_memory=True, device="cpu")
    assert n.device == torch.device("cpu")
    for owner in (n.executor, n.consensus, n.evidence_pool):
        assert torch.device(owner.device) == torch.device("cpu")
    assert n.ingress_gate.device == torch.device("cpu")
    assert n.light_serve.device == torch.device("cpu")


def _localnet(base, makers):
    """A localnet of len(makers) validators, node i made by package
    makers[i], wired full mesh by persistent peers after each switch
    listens (ports known only once started)."""
    dirs, gdoc = _validators(base, len(makers))
    nodes = []
    for i, p in enumerate(makers):
        cfg = _home(p, base, f"v{i}", _gdoc_in(p, gdoc), pv_from=dirs[i])
        nodes.append(_node(p, cfg))
    for n in nodes:
        n.start()
    for i, n in enumerate(nodes):
        for m in nodes[i + 1:]:
            n.switch.dial_peer(f"{m.node_key.node_id}@"
                               f"{m.switch.actual_listen_addr()}",
                               persistent=True)
    return nodes


def _same_chain(nodes, upto):
    hashes = {tuple(n.block_store.load_block_meta(h).block_id.hash
                    for h in range(1, upto + 1)) for n in nodes}
    return len(hashes) == 1


@pytest.mark.parametrize("mix", ["port", "mixed"])
def test_localnet_commits_one_chain(tmp_path, mix):
    """Four in-process Nodes over TCP on 127.0.0.1: all port Nodes
    (device="cpu"), or two JAX and two port Nodes; every node commits the
    same blocks through height 5, and a tx sent to a port node lands in
    every app."""
    makers = [PORT] * 4 if mix == "port" else [JAX, PORT, JAX, PORT]

    def run():
        nodes = _localnet(tmp_path, makers)
        try:
            wait_for(lambda: min(n.block_store.height() for n in nodes)
                     >= 3, 90, "the localnet's first heights")
            r = nodes[1].mempool.check_tx(b"mixed=1")
            assert r.is_ok()
            wait_for(lambda: all(_query(n, b"mixed") == b"1"
                                 for n in nodes), 60, "the tx in every app")
            wait_for(lambda: min(n.block_store.height() for n in nodes)
                     >= 5, 90, "height 5")
            return _same_chain(nodes, 5)
        finally:
            for n in nodes:
                n.stop()
    assert run_limited(run, 180)


def _query(node, key):
    pkg = JAX if type(node).__module__.startswith("tendermint_tpu.") \
        else PORT
    r = node.app_conns.query.query(pkg.abci.RequestQuery(data=key))
    return r.value


# ---------------------------------------------------------------------------
# the state-sync routine's card-fault rule
# ---------------------------------------------------------------------------

@pytest.fixture
def card_k1(monkeypatch):
    """Yields (arm, back).  arm(): the port's device lane on the CPU
    treated as the card (no spot check, TM_TPU_FORCE_BATCH=1, the
    runtime's lane on-card) with K1's plain version raising as a failed
    launch does.  back(): K1 and the host lanes restored (the card is
    back)."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck

    D = PORT.degrade
    real = D.DeviceLaneRuntime.allow_fallback
    real_plain = ck.verify_packed_plain

    def launch_failed(*a, **k):
        raise RuntimeError("cudaErrorLaunchFailure (test)")

    def arm():
        monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
        monkeypatch.setattr(
            D.DeviceLaneRuntime, "allow_fallback",
            lambda self, site, reason, on_card, cause=None: real(
                self, site, reason, True, cause))
        monkeypatch.setattr(ck, "verify_packed_plain", launch_failed)
        D.configure(D.DegradeConfig(spot_check=False),
                    registry=PORT.metrics.Registry("node_card"))

    def back():
        monkeypatch.setattr(ck, "verify_packed_plain", real_plain)
        monkeypatch.delenv("TM_TPU_FORCE_BATCH")
        monkeypatch.setattr(D.DeviceLaneRuntime, "allow_fallback", real)
        D.configure(D.DegradeConfig(),
                    registry=PORT.metrics.Registry("node_card_back"))
    yield arm, back
    D.configure(D.DegradeConfig())


class Offers:
    """A kvstore whose offer_snapshot calls are counted."""

    def __init__(self):
        self.app = PORT.kvstore.KVStoreApplication()
        self.offers = 0

    def __getattr__(self, name):
        return getattr(self.app, name)

    def offer_snapshot(self, snapshot, app_hash):
        self.offers += 1
        return self.app.offer_snapshot(snapshot, app_hash)


def _serving(base, heights=9):
    """A serving port Node (a non-validator with block sync off: its
    consensus starts and commits nothing new) over a chain of 64
    validators built into its SQLite home (a certificate's 2/3 prefix, 43 signatures, is past the 32-lane
    floor, so it launches K1), its kvstore taking a snapshot every 4
    heights."""
    gdoc, privs = make_genesis(64)
    blocks, commits, states = build_chain(gdoc, privs, heights,
                                          txs_fn=lambda h: [
                                              b"s%d_%d=%d" % (h, i, i)
                                              for i in range(20)])
    cfg = _home(PORT, base, "serve", gdoc)
    cfg.block_sync.enable = False
    cfg.light_serve.prewarm = False
    app = PORT.kvstore.KVStoreApplication()
    app.snapshot_interval = 4
    ss = PORT.sstore.StateStore(PORT.kvdb.SQLiteDB(cfg.state_db_file()))
    bs = PORT.bstore.BlockStore(PORT.kvdb.SQLiteDB(cfg.block_db_file()))
    ex = PORT.execution.BlockExecutor(ss, app, device="cpu")
    st = PORT.state.state_from_genesis(gdoc)
    ss.save(st)
    # the kvstore past InitChain, as the handshake would leave it
    app.init_chain(PORT.abci.RequestInitChain(
        chain_id=gdoc.chain_id, validators=[
            PORT.abci.ValidatorUpdate("ed25519", v.pub_key_bytes, v.power)
            for v in gdoc.validators]))
    for h in range(1, heights + 1):
        if h > 1:
            ex.mark_commit_verified(h - 1, commits[h - 2])
        st, _ = ex.apply_block(st, commits[h - 1].block_id, blocks[h - 1])
        bs.save_block(blocks[h - 1], _parts(PORT, blocks[h - 1]),
                      commits[h - 1])
    for s in (ss, bs):
        s.db.flush()
        s.db.close()
    node = _node(PORT, cfg, app)
    assert node.state.last_block_height == heights
    return node, gdoc, blocks, states


def _joiner_cfg(base, name, serve, gdoc, anchor):
    """A fresh node's home with [state_sync] enable, trusting the serving
    node's height 1; the trust period covers the seeded chain's 2023
    header times."""
    cfg = _home(PORT, base, name, gdoc)
    cfg.light_serve.prewarm = False
    cfg.state_sync.trust_period = 20 * 365 * 86400.0
    cfg.p2p.persistent_peers = (f"{serve.node_key.node_id}@"
                                f"{serve.switch.actual_listen_addr()}")
    cfg.state_sync.enable = True
    cfg.state_sync.rpc_servers = serve.rpc_server.laddr
    cfg.state_sync.trust_height = 1
    cfg.state_sync.trust_hash = anchor.hex()
    return cfg


def _synced(j, app, states):
    info = app.info(PORT.abci.RequestInfo())
    return (j._consensus_started.is_set()
            and info.last_block_height == len(states)
            and info.last_block_app_hash == states[-1].app_hash)


def _prefill(cfg, app, snap, n):
    """The joiner's RestoreLedger holding the first n chunks of the
    snapshot (a restore a crash cut short)."""
    led = PORT.ledger.RestoreLedger(PORT.kvdb.SQLiteDB(
        os.path.join(cfg.data_dir(), "statesync.db")))
    led.begin(snap)
    for i in range(n):
        led.put_chunk(i, app.load_snapshot_chunk(snap.height, snap.format,
                                                 i))
    led.flush()
    led.close()


@pytest.mark.parametrize("resume", ["routine", "fresh_node"])
def test_statesync_routine_keeps_a_card_fault(tmp_path, card_k1, resume):
    """A joiner whose light certificate's K1 launch fails on the card:
    the routine ends with the DeviceLaneError on node.device_error, no
    blocksync fallback, consensus not started, nothing offered, rejected
    or banned, nothing bootstrapped, the ledger's chunks kept.  With the
    card back, `resume_statesync()` (or a fresh Node over the same home)
    restores from the ledger and follows the chain to its tip."""
    arm, back = card_k1

    def run():
        serve, gdoc, blocks, states = _serving(tmp_path)
        serve.start()
        nodes = [serve]
        try:
            snap = max(serve.app_conns.snapshot.list_snapshots(),
                       key=lambda s: s.height)
            cfg = _joiner_cfg(tmp_path, "join", serve, gdoc,
                              blocks[0].hash())
            prefix = snap.chunks - 1 if snap.chunks > 1 else 0
            _prefill(cfg, serve.app_conns.snapshot, snap, prefix)
            app = Offers()
            banned0 = PORT.syncer.metrics().peers_banned.value()
            # made with the card up (its light client checks its anchor
            # here), then the card fails before the routine runs
            j = _node(PORT, cfg, app)
            nodes.append(j)
            arm()
            j.start()
            wait_for(lambda: j.device_error is not None, 60,
                     "the card fault")
            time.sleep(0.3)
            row = {"error": j.device_error,
                   "card": PORT.degrade.card_fault(j.device_error),
                   "offers": app.offers,
                   "rejected": len(j.statesync_reactor.syncer._rejected),
                   "banned": PORT.syncer.metrics().peers_banned.value()
                   - banned0,
                   "blocksync": j.blocksync_reactor._active,
                   "consensus": j._consensus_started.is_set(),
                   "state": j.state_store.load().last_block_height,
                   "consensus_error": j.consensus.device_error}
            back()
            if resume == "routine":
                j.resume_statesync()
                jj, jj_app = j, app
            else:
                j.stop()
                nodes.remove(j)
                # the serving node drops the old connection before the
                # fresh node (the same node id) dials in
                wait_for(lambda: j.node_key.node_id not in serve.switch.peers,
                         30, "the old connection's close")
                jj_app = Offers()
                jj = _node(PORT, cfg, jj_app)
                nodes.append(jj)
                jj.start()
            wait_for(lambda: _synced(jj, jj_app, states), 90, "the resume")
            return row, dict(jj.statesync_reactor.syncer.last_restore), \
                prefix, jj.device_error
        finally:
            for n in nodes:
                n.stop()
    row, restore, prefix, err_after = run_limited(run, 240)
    assert isinstance(row["error"], PORT.degrade.DeviceLaneError)
    assert row["card"] and row["consensus_error"] is None
    assert (row["offers"], row["rejected"], row["banned"]) == (0, 0, 0)
    assert not row["blocksync"] and not row["consensus"]
    assert row["state"] == 0
    assert restore["resumed"] == prefix and err_after is None


# ---------------------------------------------------------------------------
# the handshake's resume after a card fault in apply_block
# ---------------------------------------------------------------------------

def test_handshake_resumes_after_a_card_fault_in_apply_block(tmp_path):
    """A single-validator port Node whose apply_block of height 3 fails on
    the card: the state machine ends with device_error (the node reports
    it), the block and its #ENDHEIGHT on disk, the state at 2.  A fresh
    Node over the same home (a fresh app) replays the stored blocks
    through the handshake, its state at 3, and consensus goes on from the
    WAL to height 6.  Every stored header's app hash is an independent
    replay's of the blocks below it."""
    dirs, gdoc = _validators(tmp_path, 1)
    cfg = _home(PORT, tmp_path, "v", gdoc, pv_from=dirs[0])

    def run():
        n = _node(PORT, cfg)
        real = n.executor.apply_block

        def apply_block(state, bid, block, *a, **k):
            if block.header.height == 3:
                raise PORT.degrade.DeviceLaneError(
                    "launch failed on the card")
            return real(state, bid, block, *a, **k)
        n.executor.apply_block = apply_block
        n.start()
        try:
            wait_for(lambda: n.consensus.device_error is not None, 60,
                     "the card fault")
            row = (type(n.device_error).__name__, n.block_store.height(),
                   n.state_store.load().last_block_height,
                   n.consensus.is_running())
        finally:
            n.stop()
        ended = PORT.wal.WAL.search_for_end_height(cfg.wal_file(), 3)
        n2 = _node(PORT, cfg)
        after_handshake = n2.state.last_block_height
        n2.start()
        try:
            wait_for(lambda: n2.block_store.height() >= 6, 60, "height 6")
        finally:
            n2.stop()
        return row, ended, after_handshake

    row, ended, after = run_limited(run, 150)
    assert row == ("DeviceLaneError", 3, 2, False)
    assert ended and after == 3
    # an independent replay of the stored blocks into a fresh kvstore
    bs = PORT.bstore.BlockStore(PORT.kvdb.SQLiteDB(cfg.block_db_file()))
    app = PORT.kvstore.KVStoreApplication()
    ss = PORT.sstore.StateStore(PORT.kvdb.MemDB())
    st = PORT.node_mod.handshake(app, PORT.state.state_from_genesis(gdoc),
                                 ss, PORT.bstore.BlockStore(
                                     PORT.kvdb.MemDB()), gdoc)
    top = bs.height()
    assert top >= 6
    for h in range(1, top):
        st = PORT.node_mod._replay_tail_block(app, st, ss, bs, h)
        assert bs.load_block(h + 1).header.app_hash == st.app_hash, h
    bs.db.close()


# ---------------------------------------------------------------------------
# ROADMAP's item 9 cases, each JAX test function through the port
# ---------------------------------------------------------------------------

WAITING = [
    ("test_abci_socket", "test_external_kvstore_process_backs_a_chain"),
    ("test_sinks", "test_sql_event_sink_collects_node_events"),
    ("test_pipeline", "test_handshake_recovers_multi_height_gap"),
    ("test_pipeline", "test_node_wires_pipeline_and_group_dbs"),
    ("test_priority_mempool", "test_node_uses_v1_when_configured"),
    ("test_ingress", "test_node_wires_gate_and_config_disable"),
    ("test_remote_signer", "test_node_with_remote_signer_commits_blocks"),
    ("test_rpc_grpc", "test_node_serves_grpc_broadcast_api"),
    ("test_statesync", "test_statesync_config_roundtrip_env_and_wiring"),
    ("test_ws_subscribe", "test_ws_subscribe_new_block_and_tx"),
    ("test_ws_subscribe", "test_production_ws_client_and_new_rpc_routes"),
    ("test_service", "test_node_is_a_service_with_lifecycle_errors"),
    ("test_node_statesync", "test_fresh_node_statesyncs_then_follows"),
]


@pytest.mark.parametrize("mod,fn", WAITING, ids=[f for _, f in WAITING])
def test_waiting_case_through_the_port(mod, fn, tmp_path):
    """The JAX test function, unchanged but for the package path (and
    tests/helpers.py's chain builders, the port's), on the port's Nodes
    (the package default device "cpu" here)."""
    if mod in ("test_rpc_grpc",):
        pytest.importorskip("grpc")
    case = getattr(port_twin(mod, fn, replace=[HELPERS]
                             if mod == "test_pipeline" else ()), fn)
    kw = {"tmp_path": tmp_path} \
        if "tmp_path" in inspect.signature(case).parameters else {}
    run_limited(lambda: case(**kw), 240)


@pytest.mark.parametrize("kill_at,want_store,want_state",
                         [(3, 4, 4), (4, 8, 4)])
def test_kill_matrix_handshake_through_the_port(tmp_path, kill_at,
                                                want_store, want_state):
    """tests/test_pipeline.py:365: a child process dies between group
    commits of a pipelined replay; the port's handshake rebuilds the gap
    and the replay resumes to the chain's app hash."""
    case = port_twin("test_pipeline",
                     "test_kill_between_group_commits_reopen_resume",
                     replace=[HELPERS]
                     ).test_kill_between_group_commits_reopen_resume
    run_limited(lambda: case(tmp_path, kill_at, want_store, want_state),
                240)


def test_external_grpc_kvstore_backs_a_chain_through_the_port(tmp_path):
    """tests/test_abci_grpc.py:110 through the port: a node over a
    grpc:// kvstore process (needs grpcio, as the JAX test)."""
    pytest.importorskip("grpc")
    case = port_twin("test_abci_grpc",
                     "test_external_grpc_kvstore_backs_a_chain"
                     ).test_external_grpc_kvstore_backs_a_chain
    run_limited(lambda: case(tmp_path), 240)


def test_debug_consensus_surfaces_through_the_port():
    """tests/test_observatory.py:381 through the port, on a fresh
    observatory (the JAX file's autouse fixture)."""
    m = port_twin("test_observatory",
                  "test_debug_consensus_endpoint_and_cli_agree_with_report")
    m.obsv.reset()
    m.obsv.enable()
    try:
        run_limited(m.test_debug_consensus_endpoint_and_cli_agree_with_report,
                    120)
    finally:
        m.obsv.reset()


def test_debug_device_surfaces_through_the_port(tmp_path, capsys):
    """tests/test_devobs.py:412 through the port: GET /debug and
    /debug/device, and the debug-index and debug-device commands."""
    m = port_twin("test_devobs",
                  "test_debug_index_and_device_endpoint_and_clis")
    run_limited(lambda: m.test_debug_index_and_device_endpoint_and_clis(
        tmp_path, capsys), 120)


def _signed(p, n, tag):
    privs = [p.ed.PrivKey(bytes([(i * 11 + 5) % 255 + 1]) * 32)
             for i in range(n)]
    msgs = [tag + b" item %d" % i for i in range(n)]
    return [(k.pub_key(), m, k.sign(m)) for k, m in zip(privs, msgs)]


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_trace_surfaces(p, tmp_path):
    """tests/test_trace.py:234's export surface through each package: a
    traced BatchVerifier run, then GET /debug/trace?since= on the pprof
    listener and the debug-trace command: Chrome-trace JSON (the JAX
    test's schema check) holding every span the tracer recorded."""
    from test_trace import _assert_chrome_schema

    trace = importlib.import_module(f"{p.root}.libs.trace")
    pprof = importlib.import_module(f"{p.root}.libs.pprof")
    batch = importlib.import_module(f"{p.root}.crypto.batch")
    cmd = importlib.import_module(f"{p.root}.cmd.__main__")
    p.ed = importlib.import_module(f"{p.root}.crypto.ed25519")

    def run():
        trace.disable()
        trace.reset()
        before = trace.last_seq()
        trace.enable()
        try:
            bv = batch.BatchVerifier()
            for pub, m, sig in _signed(p, 8, b"trace"):
                bv.add(pub, m, sig)
            ok, _ = bv.verify()
        finally:
            trace.disable()
        want = {e["name"] for e in trace.chrome_trace(before)["traceEvents"]}
        srv = pprof.PprofServer("127.0.0.1:0")
        srv.start()
        try:
            st, ct, body = _http(srv.laddr, f"/debug/trace?since={before}")
            out = str(tmp_path / f"trace-{p.name}.json")
            cmd.main(["debug-trace", "--pprof-laddr", srv.laddr,
                      "--since", str(before), "--output-file", out])
            with open(out) as f:
                cli_doc = json.load(f)
        finally:
            srv.stop()
            trace.reset()
        return ok, want, st, ct, json.loads(body), cli_doc
    ok, want, st, ct, doc, cli_doc = run_limited(run, 60)
    assert ok and want and st == 200 and ct == "application/json"
    for d in (doc, cli_doc):
        _assert_chrome_schema(d)
        assert {e["name"] for e in d["traceEvents"]} >= want
    assert "batch.verify" in want


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_latency_surfaces(p, tmp_path):
    """tests/test_latency_observatory.py:173 and :192's surfaces through
    each package: a VerifyScheduler window on the host lanes with the SLO
    estimator on, then GET /debug/latency and the debug-latency command
    answer the scheduler's last_latency_report and the SLO report."""
    vs = importlib.import_module(f"{p.root}.crypto.scheduler")
    slo = importlib.import_module(f"{p.root}.libs.slo")
    pprof = importlib.import_module(f"{p.root}.libs.pprof")
    cmd = importlib.import_module(f"{p.root}.cmd.__main__")
    p.ed = importlib.import_module(f"{p.root}.crypto.ed25519")

    def run():
        slo.set_config(enabled=True, window=64,
                       targets={"blocksync": 0.010})
        s = vs.install(vs.VerifyScheduler(window_s=0.01, **_dev(p)))
        s.start()
        srv = pprof.PprofServer("127.0.0.1:0")
        try:
            bits = s.submit(_signed(p, 12, b"latency"),
                            vs.Priority.BLOCKSYNC).result(timeout=60)
            rep = vs.last_latency_report()
            srv.start()
            st, ct, body = _http(srv.laddr, "/debug/latency")
            out = str(tmp_path / f"latency-{p.name}.json")
            cmd.main(["debug-latency", "--pprof-laddr", srv.laddr,
                      "--output-file", out])
            with open(out) as f:
                cli_doc = json.load(f)
            return bits, rep, st, ct, json.loads(body), cli_doc, \
                slo.report()
        finally:
            srv.stop()
            s.stop()
            vs.uninstall(s)
            slo.set_config(enabled=False, targets={}, budgets={})
            slo.reset()
    bits, rep, st, ct, doc, cli_doc, slo_rep = run_limited(run, 60)
    assert bits.all() and st == 200 and ct == "application/json"
    for d in (doc, cli_doc):
        assert sorted(d) == ["last_lane_report", "last_latency_report",
                             "slo"]
        assert d["last_latency_report"]["e2e_max_s"] == rep["e2e_max_s"]
        assert d["last_latency_report"]["items"] == 12
        assert d["slo"]["streams"]["blocksync"]["n"] == \
            slo_rep["streams"]["blocksync"]["n"] == 1


def _http(laddr, path):
    import urllib.request
    with urllib.request.urlopen(f"http://{laddr}{path}", timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()
