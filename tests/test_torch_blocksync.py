"""The port's blocksync (BlockPool, replay_window, BlocksyncReactor)
against the JAX package's, on the CPU.

tests/test_blocksync.py's eight cases run through both packages, and each
case's outcome (states, block and app hashes, WindowSyncError heights and
applied counts) is compared across them exactly.  The same seeded keys
build the same chain in both packages through `build_chain`, a copy of
tests/helpers.py's that takes the package (and can carry a bad signature
inside a block's LastCommit).  Then: a 40-validator chain replayed on
device="cpu" through the port's plain K1, each window's lanes counted in
both packages and its launches in the port; a validator-set change
truncating the windows alike; a garbage signature in a non-prefix lane
attributed to the same height; and the port's one departure here, a card
fault (degrade.DeviceLaneError), which leaves replay_window as
WindowDeviceError with the applied state and makes the reactor ask no
peer for a redo.  Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import functools
import importlib
import time
import types

import pytest

from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_MODS = {
    "kvstore": "abci.kvstore", "kvdb": "libs.kvdb", "fail": "libs.fail",
    "codec": "libs.safe_codec", "sstore": "state.store",
    "bstore": "store.block_store", "execution": "state.execution",
    "state": "state.state", "obsv": "consensus.observatory",
    "basic": "types.basic", "commit": "types.commit",
    "canonical": "types.canonical", "genesis": "types.genesis",
    "validator_set": "types.validator_set", "ed": "crypto.ed25519",
    "scheduler": "crypto.scheduler", "degrade": "crypto.degrade",
    "pool": "blocksync.pool", "replay": "blocksync.replay",
    "reactor": "blocksync.reactor", "wire": "p2p.wire",
    "pipeline": "state.pipeline", "metrics": "libs.metrics",
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
CHAIN_ID = "test-chain-tpu"


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    """No pipeline, scheduler, observatory record or failpoint crosses a
    test, in either package."""
    for p in PKGS:
        p.obsv.reset()
    yield
    for p in PKGS:
        p.fail.reset()
        old = p.pipeline.install(None)
        if old is not None and old.is_running():
            old.stop()
        s = p.scheduler.installed()
        if s is not None:
            if s.is_running():
                s.stop()
            p.scheduler.uninstall(s)
        p.obsv.reset()


# ---------------------------------------------------------------------------
# the chain builder (tests/helpers.py's make_genesis / build_chain, for
# either package)
# ---------------------------------------------------------------------------

def make_genesis(p, n_validators: int, power: int = 10):
    privs = [p.ed.PrivKey((0xBEE + i).to_bytes(32, "big"))
             for i in range(n_validators)]
    G = p.genesis
    gdoc = G.GenesisDoc(
        chain_id=CHAIN_ID, genesis_time=p.basic.Timestamp(1700000000, 0),
        validators=[G.GenesisValidator(
            address=k.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=power) for k in privs])
    return gdoc, privs


def executor(p, state_store, app, **kw):
    """A BlockExecutor; the port's on device="cpu"."""
    if p is PORT:
        kw.setdefault("device", "cpu")
    return p.execution.BlockExecutor(state_store, app, **kw)


def flip(p, cs):
    """`cs` with the first byte of its signature flipped."""
    return p.commit.CommitSig(cs.block_id_flag, cs.validator_address,
                              cs.timestamp,
                              bytes([cs.signature[0] ^ 1]) + cs.signature[1:])


def build_chain(p, gdoc, privs, n_heights: int, txs_fn=None,
                tamper_height: int = 0, absent_fn=None, bad_lc=None):
    """tests/helpers.py build_chain through package `p`: (blocks, commits,
    states), commits[i] certifying blocks[i] (the same object as
    blocks[i + 1].last_commit).  bad_lc=(h, idx) makes block h carry its
    LastCommit with signature idx flipped (a proposer that included a bad
    signature; the chain stays linked, block h is signed as built)."""
    B = p.basic
    ex = executor(p, p.sstore.StateStore(p.kvdb.MemDB()),
                  p.kvstore.KVStoreApplication())
    state = p.state.state_from_genesis(gdoc)
    by_addr = {k.pub_key().address(): k for k in privs}
    blocks, commits, states = [], [], []
    last_commit = p.commit.Commit(0, 0, B.BlockID(), [])
    for h in range(1, n_heights + 1):
        txs = txs_fn(h) if txs_fn is not None else []
        lc = last_commit
        if bad_lc is not None and h == bad_lc[0]:
            sigs = list(lc.signatures)
            sigs[bad_lc[1]] = flip(p, sigs[bad_lc[1]])
            lc = p.commit.Commit(lc.height, lc.round, lc.block_id, sigs)
            ex.mark_commit_verified(h - 1, lc)
        proposer = state.validators.get_proposer()
        block = state.make_block(h, txs, lc, [], proposer.address,
                                 block_time=B.Timestamp(1700000000 + h, 0))
        bid, _parts = p.replay.block_id_of(block)
        sigs = []
        for vi, val in enumerate(state.validators.validators):
            if absent_fn is not None and absent_fn(h, vi):
                sigs.append(p.commit.CommitSig.absent())
                continue
            ts = B.Timestamp(1700000000 + h, 500)
            sb = p.canonical.canonical_vote_bytes(
                gdoc.chain_id, B.SignedMsgType.PRECOMMIT, h, 0, bid, ts)
            sigs.append(p.commit.CommitSig(B.BlockIDFlag.COMMIT,
                                           val.address, ts,
                                           by_addr[val.address].sign(sb)))
        commit = p.commit.Commit(h, 0, bid, sigs)
        blocks.append(block)
        if h == tamper_height:
            # corrupt only the CERTIFIER copy handed to the consumer
            commits.append(p.commit.Commit(h, 0, bid,
                                           [flip(p, sigs[0])] + sigs[1:]))
        else:
            commits.append(commit)
        state, _ = ex.apply_block(state, bid, block)
        states.append(state)
        last_commit = commit
    return blocks, commits, states


def fresh_node(p, gdoc):
    ex = executor(p, p.sstore.StateStore(p.kvdb.MemDB()),
                  p.kvstore.KVStoreApplication())
    store = p.bstore.BlockStore(p.kvdb.MemDB())
    return ex, store, p.state.state_from_genesis(gdoc)


def stored_hashes(store):
    return [store.load_block(h).hash() for h in range(1, store.height() + 1)]


def sync_error(e):
    """A WindowSyncError as a package-free value."""
    return {"height": e.height, "applied": e.applied,
            "state": None if e.state is None else plain(e.state)}


# ---------------------------------------------------------------------------
# tests/test_blocksync.py's cases, each returning its package-free outcome
# ---------------------------------------------------------------------------

def case_coalesced_applies_all(p):
    gdoc, privs = make_genesis(p, 6)
    blocks, commits, states = build_chain(p, gdoc, privs, 20)
    ex, store, state = fresh_node(p, gdoc)
    state, n1 = p.replay.replay_window(ex, store, state, blocks[:12],
                                       commits[:12], max_window=16)
    assert n1 == 12
    state, n2 = p.replay.replay_window(ex, store, state, blocks[12:],
                                       commits[12:], max_window=16)
    assert n2 == 8
    assert state.last_block_height == 20
    assert store.height() == 20
    assert state.app_hash == states[-1].app_hash
    assert store.load_block(7).hash() == blocks[6].hash()
    return {"applied": [n1, n2], "state": plain(state),
            "hashes": stored_hashes(store)}


def case_detects_bad_commit(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 10, tamper_height=6)
    ex, store, state = fresh_node(p, gdoc)
    with pytest.raises(p.replay.WindowSyncError) as ei:
        p.replay.replay_window(ex, store, state, blocks, commits,
                               max_window=16)
    assert ei.value.height == 6
    assert ei.value.applied == 5
    assert ei.value.state.last_block_height == 5
    good_blocks, good_commits, _ = build_chain(p, gdoc, privs, 10)
    state, n = p.replay.replay_window(ex, store, ei.value.state,
                                      good_blocks[5:], good_commits[5:],
                                      max_window=16)
    assert n == 5 and state.last_block_height == 10
    return {"error": sync_error(ei.value), "state": plain(state),
            "hashes": stored_hashes(store)}


def case_bad_app_hash_rejected(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 5)
    ex, store, state = fresh_node(p, gdoc)
    blocks[2].header.app_hash = b"\xEE" * 32
    state, n = p.replay.replay_window(ex, store, state, blocks, commits,
                                      max_window=8)
    assert n == 2 and state.last_block_height == 2
    with pytest.raises(p.replay.WindowSyncError) as ei:
        p.replay.replay_window(ex, store, state, blocks[2:], commits[2:],
                               max_window=8)
    assert ei.value.height == 3
    assert ei.value.applied == 0
    return {"applied": n, "error": sync_error(ei.value)}


def case_nonprefix_garbage_signature_rejected(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    lc = blocks[4].last_commit
    lc.signatures[3] = flip(p, lc.signatures[3])
    blocks[4].header.last_commit_hash = lc.hash()
    blocks[4].fill_header()
    ex, store, state = fresh_node(p, gdoc)
    applied_total = 0
    applied = []
    with pytest.raises(p.replay.WindowSyncError) as ei:
        state, n = p.replay.replay_window(ex, store, state, blocks, commits,
                                          max_window=16)
        applied_total += n
        applied.append(n)
        while True:
            state, n = p.replay.replay_window(
                ex, store, state, blocks[applied_total:],
                commits[applied_total:], max_window=16)
            if n == 0:
                break
            applied_total += n
            applied.append(n)
    assert ei.value.height <= 5
    assert ei.value.state is None or ei.value.state.last_block_height < 5
    return {"applied": applied, "error": sync_error(ei.value),
            "hashes": stored_hashes(store)}


def case_pool_schedules_and_serves_window(p):
    sent, errs = [], []
    pool = p.pool.BlockPool(1, lambda pid, h: sent.append((pid, h)),
                            lambda pid, r: errs.append((pid, r)))
    gdoc, privs = make_genesis(p, 4)
    blocks, _, _ = build_chain(p, gdoc, privs, 8)
    pool.set_peer_range("p1", 1, 8)
    pool._schedule_once()
    assert sent, "requests must go out"
    for pid, h in list(sent):
        assert pid == "p1"
        assert pool.add_block("p1", blocks[h - 1])
    win = pool.peek_window(10)
    assert [b.header.height for b in win] == list(range(1, len(win) + 1))
    pool.pop_requests(len(win) - 1)
    assert pool.height == len(win)
    assert not errs
    return {"sent": sent, "window": [b.hash() for b in win],
            "height": pool.height}


def case_pool_rejects_wrong_peer_and_redoes(p):
    sent = []
    pool = p.pool.BlockPool(1, lambda pid, h: sent.append((pid, h)),
                            lambda pid, r: None)
    gdoc, privs = make_genesis(p, 4)
    blocks, _, _ = build_chain(p, gdoc, privs, 4)
    pool.set_peer_range("p1", 1, 4)
    pool.set_peer_range("p2", 1, 4)
    pool._schedule_once()
    (pid1, h1) = sent[0]
    other = "p2" if pid1 == "p1" else "p1"
    assert not pool.add_block(other, blocks[h1 - 1])
    assert pool.add_block(pid1, blocks[h1 - 1])
    assert pool.redo_request(h1) == pid1
    assert pool.num_peers() == 1
    assert pool.peek_window(4) == []
    return {"sent": sent, "peers": pool.num_peers()}


def case_pool_caught_up(p):
    pool = p.pool.BlockPool(5, lambda *a: None, lambda *a: None)
    got = [pool.is_caught_up()]
    pool.set_peer_range("p1", 1, 5)
    pool._start_time -= 10
    got.append(pool.is_caught_up())
    pool.set_peer_range("p2", 1, 50)
    got.append(pool.is_caught_up())
    assert got == [False, True, False]
    return got


class _MemPeer:
    """Duck-typed Peer delivering messages directly to a target reactor."""

    def __init__(self, p, pid, deliver):
        self.p = p
        self.id = pid
        self._deliver = deliver

    def send(self, ch_id, msg):
        self._deliver(ch_id, self, self.p.wire.encode(ch_id, msg))
        return True

    try_send = send


class _OneSwitch:
    def __init__(self, peer):
        self.peers = {peer.id: peer}
        self.peer_errors = []

    def broadcast(self, ch_id, msg):
        for peer in self.peers.values():
            peer.send(ch_id, msg)

    def stop_peer_for_error(self, peer, reason):
        self.peer_errors.append(reason)


def mem_pair(p, gdoc, blocks, commits, window=8, on_caught_up=None):
    """A serving reactor holding the chain and an empty client, wired by
    in-memory peers (tests/test_blocksync.py's end-to-end setup)."""
    ex_s, store_s, state_s = fresh_node(p, gdoc)
    for b, c in zip(blocks, commits):
        _bid, parts = p.replay.block_id_of(b)
        store_s.save_block(b, parts, c)
    server = p.reactor.BlocksyncReactor(ex_s, store_s, state_s,
                                        fast_sync=False)
    ex_c, store_c, state_c = fresh_node(p, gdoc)
    client = p.reactor.BlocksyncReactor(ex_c, store_c, state_c,
                                        window=window,
                                        on_caught_up=on_caught_up)
    handles = {}
    server_peer = _MemPeer(p, "server", lambda ch, _p, mb: server.receive(
        ch, handles["client"], mb))
    client_peer = _MemPeer(p, "client", lambda ch, _p, mb: client.receive(
        ch, handles["server"], mb))
    handles.update(server=server_peer, client=client_peer)
    client.switch = _OneSwitch(server_peer)
    server.switch = _OneSwitch(client_peer)
    return server, client, server_peer, client_peer, store_s, store_c


def wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


def case_reactor_end_to_end(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 25)
    server, client, server_peer, client_peer, store_s, store_c = \
        mem_pair(p, gdoc, blocks, commits)
    client.start()
    try:
        client.add_peer(server_peer)
        server.add_peer(client_peer)
        client.pool.set_peer_range("server", store_s.base(),
                                   store_s.height())
        wait_for(lambda: client.state.last_block_height >= 24)
    finally:
        client.stop()
    assert client.state.last_block_height >= 24
    assert store_c.load_block(24).hash() == blocks[23].hash()
    assert client.blocks_synced >= 24
    assert client.switch.peer_errors == []
    return {"hashes": stored_hashes(store_c)[:24],
            "app_hash": client.state.app_hash
            if client.state.last_block_height == 24 else None}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_coalesced_applies_all, case_detects_bad_commit,
    case_bad_app_hash_rejected, case_nonprefix_garbage_signature_rejected,
    case_pool_schedules_and_serves_window,
    case_pool_rejects_wrong_peer_and_redoes, case_pool_caught_up,
    case_reactor_end_to_end)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return CASES[case](BY_NAME[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocksync_case(case, pkg):
    """tests/test_blocksync.py's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocksync_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


# ---------------------------------------------------------------------------
# windows: lanes and launches, truncation at a set change, attribution
# ---------------------------------------------------------------------------

def _count_windows(monkeypatch, p, log):
    """Record each coalesced verify_items call's lane count."""
    real = p.scheduler.verify_items

    def counted(items, *a, **kw):
        log.append(len(items))
        return real(items, *a, **kw)
    monkeypatch.setattr(p.scheduler, "verify_items", counted)


def test_40_validators_through_the_plain_k1(monkeypatch):
    """A 40-validator chain of 5 heights replayed in two windows (3 blocks,
    then 2).  Each window's lanes: the full LastCommit sets (40 a block
    past the first) and the prefix of the window's last certifier (27 of
    40 equal powers), the same in both packages.  The port, on
    device="cpu" with TM_TPU_FORCE_BATCH=1, launches its plain K1 once a
    window and nothing more: validate_block re-verifies no pre-verified
    LastCommit.  The states and stored blocks are equal."""
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck

    got = {}
    launched = []
    for p in PKGS:
        gdoc, privs = make_genesis(p, 40)
        blocks, commits, states = build_chain(p, gdoc, privs, 5)
        if p is PORT:
            monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
            real = ck.verify_packed_plain
            monkeypatch.setattr(ck, "verify_packed_plain", lambda packed: (
                launched.append(packed.shape[1]), real(packed))[1])
        lanes = []
        _count_windows(monkeypatch, p, lanes)
        ex, store, state = fresh_node(p, gdoc)
        state, n1 = p.replay.replay_window(ex, store, state, blocks[:3],
                                           commits[:3], max_window=3)
        state, n2 = p.replay.replay_window(ex, store, state, blocks[3:],
                                           commits[3:], max_window=3)
        assert (n1, n2) == (3, 2)
        assert state.app_hash == states[-1].app_hash
        got[p.name] = {"lanes": lanes, "state": plain(state),
                       "hashes": stored_hashes(store)}
    assert got["jax"] == got["port"]
    assert got["port"]["lanes"] == [2 * 40 + 27, 2 * 40 + 27]
    # one plain K1 a window, each at least the window's lanes
    assert len(launched) == 2 and all(n >= 107 for n in launched)


def _val_tx(pub: bytes, power: int) -> bytes:
    import base64
    return b"val:" + base64.b64encode(pub) + b"!%d" % power


def test_set_change_truncates_windows_alike(monkeypatch):
    """A power change at height 4 (effective at 6): the windows stop at
    the change and the blocks around it replay on the strict path, the
    same sequence of window sizes and lanes in both packages."""
    got = {}
    for p in PKGS:
        gdoc, privs = make_genesis(p, 5)
        pub = privs[1].pub_key().bytes()
        blocks, commits, states = build_chain(
            p, gdoc, privs, 12,
            txs_fn=lambda h: [_val_tx(pub, 30)] if h == 4 else
            [b"k%d=%d" % (h, h)])
        assert states[-1].validators.hash() != states[0].validators.hash()
        lanes = []
        _count_windows(monkeypatch, p, lanes)
        ex, store, state = fresh_node(p, gdoc)
        sizes = []
        while state.last_block_height < 12:
            h0 = state.last_block_height
            state, n = p.replay.replay_window(ex, store, state,
                                              blocks[h0:], commits[h0:],
                                              max_window=8)
            assert n > 0
            sizes.append(n)
        assert state.app_hash == states[-1].app_hash
        got[p.name] = {"sizes": sizes, "lanes": lanes,
                       "state": plain(state)}
    assert got["jax"] == got["port"]
    assert max(got["port"]["sizes"]) < 8 and 1 in got["port"]["sizes"]


@pytest.mark.parametrize("idx", [0, 4], ids=["prefix", "non-prefix"])
def test_bad_lastcommit_signature_attributed_alike(idx):
    """Block 6 carries its LastCommit (the commit for height 5) with one
    signature flipped; the chain is otherwise sound.  Lane 0 is in the
    >2/3 prefix that certifies height 5, so the certifier fails and
    height 5 is attributed; lane 4 (of 5) is outside it, so height 5
    applies and block 6's full LastCommit check attributes height 6.  The
    same error, state and stored blocks in both packages."""
    got = {}
    for p in PKGS:
        gdoc, privs = make_genesis(p, 5)
        blocks, commits, _ = build_chain(p, gdoc, privs, 10,
                                         bad_lc=(6, idx))
        certs = [blocks[i + 1].last_commit for i in range(9)] + [commits[9]]
        ex, store, state = fresh_node(p, gdoc)
        with pytest.raises(p.replay.WindowSyncError) as ei:
            p.replay.replay_window(ex, store, state, blocks, certs,
                                   max_window=16)
        got[p.name] = {"error": sync_error(ei.value),
                       "hashes": stored_hashes(store)}
    assert got["jax"] == got["port"]
    want = 5 if idx == 0 else 6
    assert got["port"]["error"]["height"] == want
    assert got["port"]["error"]["applied"] == want - 1
    # block 6 was saved before its apply failed; block 5 never was
    assert len(got["port"]["hashes"]) == want - 1 if idx == 0 else want


# ---------------------------------------------------------------------------
# the departure: a card fault is not a peer fault
# ---------------------------------------------------------------------------

def _card_error():
    return PORT.degrade.DeviceLaneError("launch failed on the card")


def _fail_at(height, real):
    """apply_block that raises a card fault at `height`, else `real`."""
    def apply_block(st, bid, block):
        if block.header.height == height:
            raise _card_error()
        return real(st, bid, block)
    return apply_block


def test_card_fault_in_the_coalesced_batch_leaves_unwrapped(monkeypatch):
    """The window's one verify_items raises DeviceLaneError: replay_window
    raises WindowDeviceError (a DeviceLaneError, not a WindowSyncError)
    with the state it was given, and does not retry on the strict
    path."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, _ = build_chain(PORT, gdoc, privs, 6)
    calls = []

    def broken(items, *a, **kw):
        calls.append(len(items))
        raise _card_error()
    monkeypatch.setattr(PORT.scheduler, "verify_items", broken)
    strict = []
    real_light = PORT.validator_set.ValidatorSet.verify_commit_light
    monkeypatch.setattr(PORT.validator_set.ValidatorSet,
                        "verify_commit_light",
                        lambda self, *a, **kw: (strict.append(a[2]),
                                                real_light(self, *a,
                                                           **kw))[1])
    ex, store, state = fresh_node(PORT, gdoc)
    with pytest.raises(PORT.degrade.DeviceLaneError) as ei:
        PORT.replay.replay_window(ex, store, state, blocks, commits)
    e = ei.value
    assert isinstance(e, PORT.replay.WindowDeviceError)
    assert not isinstance(e, PORT.replay.WindowSyncError)
    assert (e.height, e.applied, e.state) == (1, 0, state)
    assert len(calls) == 1 and strict == [] and store.height() == 0


def test_card_fault_in_apply_keeps_the_applied_state(monkeypatch):
    """A launch fails on the card while block 4 applies (validate_block's
    verify): the error carries heights 1-3's state and count, on the
    coalesced path; and on the strict path (a one-block window) the
    light verify's card fault carries the state before it."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, states = build_chain(PORT, gdoc, privs, 6)
    ex, store, state = fresh_node(PORT, gdoc)
    monkeypatch.setattr(ex, "apply_block", _fail_at(4, ex.apply_block))
    with pytest.raises(PORT.replay.WindowDeviceError) as ei:
        PORT.replay.replay_window(ex, store, state, blocks, commits)
    e = ei.value
    assert (e.height, e.applied) == (4, 3)
    assert e.state.app_hash == states[2].app_hash
    assert store.height() == 4    # block 4 was saved before it applied

    # the strict path: one block at a time, the light verify on the card
    ex, store, state = fresh_node(PORT, gdoc)

    def light(self, chain_id, bid, h, commit, device=None):
        if h == 2:
            raise _card_error()
    monkeypatch.setattr(PORT.validator_set.ValidatorSet,
                        "verify_commit_light", light)
    state, n = PORT.replay.replay_window(ex, store, state, blocks[:1],
                                         commits[:1])
    assert n == 1
    with pytest.raises(PORT.replay.WindowDeviceError) as ei:
        PORT.replay.replay_window(ex, store, state, blocks[1:2],
                                  commits[1:2])
    assert (ei.value.height, ei.value.applied) == (2, 0)
    assert ei.value.state.last_block_height == 1


def test_card_fault_in_a_chaos_drill_takes_the_reference_path(monkeypatch):
    """With a failpoint armed the DeviceLaneError is the JAX package's
    case: the apply error becomes WindowSyncError, as there."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, _ = build_chain(PORT, gdoc, privs, 6)
    ex, store, state = fresh_node(PORT, gdoc)
    monkeypatch.setattr(ex, "apply_block", _fail_at(4, ex.apply_block))
    PORT.fail.set_mode("pipeline.commit", "latency:1")
    with pytest.raises(PORT.replay.WindowSyncError) as ei:
        PORT.replay.replay_window(ex, store, state, blocks, commits)
    assert (ei.value.height, ei.value.applied) == (4, 3)


def test_card_fault_stops_the_reactor_without_a_redo(monkeypatch):
    """The client's replay hits a card fault after its first window: the
    reactor keeps the applied state, makes no redo_request, stops no
    peer and ends its sync routine with the error kept; resume_sync then
    finishes the sync."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, _ = build_chain(PORT, gdoc, privs, 25)
    server, client, server_peer, client_peer, store_s, store_c = \
        mem_pair(PORT, gdoc, blocks, commits, window=8)
    redos = []
    real_redo = client.pool.redo_request
    monkeypatch.setattr(client.pool, "redo_request",
                        lambda h: (redos.append(h), real_redo(h))[1])
    real_apply = client.executor.apply_block
    broken = {"on": True}

    def apply_block(st, bid, block):
        if broken["on"] and block.header.height == 11:
            raise _card_error()
        return real_apply(st, bid, block)
    monkeypatch.setattr(client.executor, "apply_block", apply_block)
    client.start()
    try:
        client.add_peer(server_peer)
        server.add_peer(client_peer)
        client.pool.set_peer_range("server", store_s.base(),
                                   store_s.height())
        assert wait_for(lambda: client.device_error is not None)
        e = client.device_error
        assert isinstance(e, PORT.replay.WindowDeviceError)
        assert e.height == 11
        assert client.state.last_block_height == 10
        assert client.blocks_synced == 10
        assert redos == [] and client.switch.peer_errors == []
        broken["on"] = False
        client.resume_sync()
        assert wait_for(lambda: client.state.last_block_height >= 24)
    finally:
        client.stop()
    assert client.device_error is None and redos == []
    assert stored_hashes(store_c)[:24] == [b.hash() for b in blocks[:24]]
