"""The port's BlockPipeline (state/pipeline.py) against the JAX
package's, on the CPU.

tests/test_pipeline.py's cases run through both packages: within each
package the pipelined replay must leave the same final State and
byte-identical store contents as the serial replay (its
`_run_both_ways`); across the packages the states are compared through
`plain` and the stores by key set (byte for byte) and decoded values (the
stored pickles carry each package's module path, so raw bytes never
cross).  Covered: equivalence (stable window, set change, absent votes),
the malformed-block attribution, declines, chaos at pipeline.stage,
pipeline.commit and kvdb.group_commit, stage starvation, spans and
metrics, set_config, the kill-and-reopen resume in its standalone form
(a child process dies between group commits; the parent reopens the
SQLite stores and replays from genesis through _apply_one's resume
check), the scheduler on the executor's device, and the port's departure:
a card fault leaves the pipelined window as WindowDeviceError with the
applied state, never re-verified and never degraded to the strict path.

Held back: test_pipeline.py's handshake cases (the kill matrix's
node.handshake step and test_handshake_recovers_multi_height_gap) and
test_node_wires_pipeline_and_group_dbs need the port's node.
Tolerance: exact equality everywhere.
"""
from __future__ import annotations

import functools
import importlib
import os
import pickle
import subprocess
import sys
import time

import pytest

from test_torch_blocksync import (BY_NAME, PKGS, PORT, _clean,  # noqa
                                  build_chain, executor, make_genesis, pkg,
                                  plain, stored_hashes)
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in PKGS:
    _p.trace = importlib.import_module(f"{_p.root}.libs.trace")


def fresh(p, gdoc, grouped=True, bdb=None, sdb=None):
    kv = p.kvdb
    bdb = bdb if bdb is not None else (
        kv.GroupCommitDB(kv.MemDB()) if grouped else kv.MemDB())
    sdb = sdb if sdb is not None else (
        kv.GroupCommitDB(kv.MemDB()) if grouped else kv.MemDB())
    ex = executor(p, p.sstore.StateStore(sdb),
                  p.kvstore.KVStoreApplication())
    store = p.bstore.BlockStore(bdb)
    return ex, store, p.state.state_from_genesis(gdoc), bdb, sdb


def raw(p, db):
    """The underlying MemDB dict regardless of wrapping."""
    inner = db.inner if isinstance(db, p.kvdb.GroupCommitDB) else db
    return dict(inner._data)


def decoded(p, db):
    """Key -> decoded value (plain) of a store, for the cross-package
    comparison."""
    return decode_all(p, raw(p, db))


def decode_all(p, data):
    out = {}
    for k, v in sorted(data.items()):
        try:
            out[k] = plain(p.codec.loads(v))
        except Exception:  # noqa: BLE001 - raw values (the hash index)
            out[k] = v
    return out


def replay_all(p, ex, store, state, blocks, commits, window=16):
    applied = 0
    while applied < len(blocks):
        state, n = p.replay.replay_window(ex, store, state,
                                          blocks[applied:],
                                          commits[applied:],
                                          max_window=window)
        assert n > 0, f"no progress at {applied}"
        applied += n
    return state


def run_both_ways(p, gdoc, blocks, commits, window=16, depth=3, group=4):
    """Replay the chain serially and pipelined in package p; assert the
    same final state and byte-identical stores; return the package-free
    outcome."""
    ex1, store1, st1, b1, s1 = fresh(p, gdoc, grouped=False)
    st1 = replay_all(p, ex1, store1, st1, blocks, commits, window)
    pipe = p.pipeline.set_config(enable=True, depth=depth,
                                 group_commit_heights=group)
    try:
        ex2, store2, st2, b2, s2 = fresh(p, gdoc, grouped=True)
        st2 = replay_all(p, ex2, store2, st2, blocks, commits, window)
    finally:
        p.pipeline.set_config(enable=False)
    assert p.codec.dumps(st1) == p.codec.dumps(st2)
    assert raw(p, b1) == raw(p, b2), "block store contents differ"
    assert raw(p, s1) == raw(p, s2), "state store contents differ"
    assert b2.pending_ops() == 0 and s2.pending_ops() == 0
    assert pipe.windows_pipelined > 0
    return {"state": plain(st1), "blocks": decoded(p, b1),
            "states": decoded(p, s1)}


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's cases, each returning its package-free outcome
# ---------------------------------------------------------------------------

def case_equivalence_stable_window(p):
    gdoc, privs = make_genesis(p, 5)
    blocks, commits, states = build_chain(p, gdoc, privs, 20)
    out = run_both_ways(p, gdoc, blocks, commits)
    assert out["state"][1]["last_block_height"] == 20
    assert out["state"][1]["app_hash"] == states[-1].app_hash
    return out


def case_equivalence_validator_set_change(p):
    import base64
    gdoc, privs = make_genesis(p, 4)
    pub_b64 = base64.b64encode(privs[0].pub_key().bytes())

    def txs(h):
        if h == 7:
            return [b"val:" + pub_b64 + b"!25"]
        return [b"k%d=%d" % (h, h)]
    blocks, commits, states = build_chain(p, gdoc, privs, 16, txs_fn=txs)
    assert states[-1].validators.hash() != states[0].validators.hash()
    out = run_both_ways(p, gdoc, blocks, commits, window=10)
    assert out["state"][1]["app_hash"] == states[-1].app_hash
    return out


def case_equivalence_absent_votes(p):
    gdoc, privs = make_genesis(p, 5)
    blocks, commits, states = build_chain(
        p, gdoc, privs, 14, absent_fn=lambda h, vi: vi == (h % 5))
    out = run_both_ways(p, gdoc, blocks, commits, window=14)
    assert out["state"][1]["app_hash"] == states[-1].app_hash
    return out


def case_malformed_block_attribution(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 10, tamper_height=6)

    def attempt(pipelined):
        if pipelined:
            p.pipeline.set_config(enable=True, depth=3,
                                  group_commit_heights=3)
        ex, store, st, bdb, sdb = fresh(p, gdoc, grouped=pipelined)
        try:
            with pytest.raises(p.replay.WindowSyncError) as ei:
                p.replay.replay_window(ex, store, st, blocks, commits,
                                       max_window=16)
        finally:
            if pipelined:
                p.pipeline.set_config(enable=False)
        e = ei.value
        return ((e.height, e.applied, e.state.last_block_height,
                 store.height()), raw(p, bdb), raw(p, sdb))

    a1, braw1, sraw1 = attempt(False)
    a2, braw2, sraw2 = attempt(True)
    assert a1 == a2 == (6, 5, 5, 5)
    assert braw1 == braw2 and sraw1 == sraw2
    return {"attempt": a1, "blocks": decode_all(p, braw1),
            "states": decode_all(p, sraw1)}


def case_declines_trivial_and_busy_windows(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 3)
    pipe = p.pipeline.set_config(enable=True, depth=2,
                                 group_commit_heights=2)
    try:
        assert pipe.replay_window(None, None,
                                  p.state.state_from_genesis(gdoc),
                                  [], [], 8) is None
        ex, store, st, *_ = fresh(p, gdoc)
        st, n = p.replay.replay_window(ex, store, st, blocks[:1],
                                       commits[:1], max_window=8)
        assert n == 1
    finally:
        p.pipeline.set_config(enable=False)
    assert pipe.windows_pipelined == 0
    ex, store, st, *_ = fresh(p, gdoc, grouped=False)
    st = replay_all(p, ex, store, st, blocks, commits)
    assert st.last_block_height == 3
    return plain(st)


def _chaos_case(site, mode):
    def case(p):
        gdoc, privs = make_genesis(p, 4)
        blocks, commits, _ = build_chain(p, gdoc, privs, 12)
        ex1, store1, st1, b1, s1 = fresh(p, gdoc, grouped=False)
        st1 = replay_all(p, ex1, store1, st1, blocks, commits, window=12)
        p.pipeline.set_config(enable=True, depth=3, group_commit_heights=4)
        p.fail.set_mode(site, mode)
        try:
            ex2, store2, st2, b2, s2 = fresh(p, gdoc, grouped=True)
            st2 = replay_all(p, ex2, store2, st2, blocks, commits,
                             window=12)
        finally:
            fired = p.fail.fired(site, mode)
            p.fail.clear()
            p.pipeline.set_config(enable=False)
        assert fired >= 1, "chaos never injected"
        assert p.codec.dumps(st1) == p.codec.dumps(st2)
        assert raw(p, b1) == raw(p, b2) and raw(p, s1) == raw(p, s2)
        assert b2.pending_ops() == 0 and s2.pending_ops() == 0
        return {"state": plain(st2), "blocks": decoded(p, b2),
                "states": decoded(p, s2)}
    return case


def case_raise_chaos_counts_strict_path_blocks(p):
    m = p.metrics.BlockSyncMetrics()
    before = m.blocks_applied.value(path="strict")
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 8)
    pipe = p.pipeline.set_config(enable=True, depth=2,
                                 group_commit_heights=4)
    p.fail.set_mode("pipeline.stage", "raise")
    try:
        ex, store, st, *_ = fresh(p, gdoc)
        st = replay_all(p, ex, store, st, blocks, commits, window=8)
    finally:
        p.fail.clear()
        p.pipeline.set_config(enable=False)
    assert st.last_block_height == 8
    strict = m.blocks_applied.value(path="strict") - before
    assert strict >= 8
    assert pipe.windows_degraded >= 1
    return {"state": plain(st), "strict": strict,
            "degraded": pipe.windows_degraded}


def case_stage_starvation_degrades(p):
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 6)
    pipe = p.pipeline.set_config(enable=True, depth=2,
                                 group_commit_heights=4)
    pipe._stage_timeout_s = 0.05
    p.fail.set_mode("pipeline.stage", "latency:400")
    try:
        ex, store, st, *_ = fresh(p, gdoc)
        t0 = time.monotonic()
        st = replay_all(p, ex, store, st, blocks, commits, window=6)
        assert time.monotonic() - t0 < 10.0
    finally:
        p.fail.clear()
        p.pipeline.set_config(enable=False)
    assert st.last_block_height == 6
    assert pipe.windows_degraded >= 1
    return {"state": plain(st), "hashes": stored_hashes(store)}


def case_spans_and_metrics_published(p):
    m = p.metrics.BlockSyncMetrics()
    base_pipelined = m.blocks_applied.value(path="pipelined")
    commits_before = m.group_commit_seconds.count()
    gdoc, privs = make_genesis(p, 4)
    blocks, commits, _ = build_chain(p, gdoc, privs, 12)
    since = p.trace.last_seq()
    p.trace.enable(capacity=4096)
    p.pipeline.set_config(enable=True, depth=3, group_commit_heights=4)
    try:
        ex, store, st, bdb, sdb = fresh(p, gdoc)
        st = replay_all(p, ex, store, st, blocks, commits, window=12)
    finally:
        p.pipeline.set_config(enable=False)
        spans = p.trace.snapshot(since=since)
        p.trace.disable()
    assert st.last_block_height == 12
    assert m.blocks_applied.value(path="pipelined") - base_pipelined >= 12
    assert m.group_commit_seconds.count() - commits_before >= 1
    got = {s["name"] for s in spans}
    for name in ("pipeline.stage", "pipeline.apply", "pipeline.commit"):
        assert name in got, (name, sorted(got)[:20])
    stages = {s["attrs"].get("height"): s for s in spans
              if s["name"] == "pipeline.stage"}
    applies = {s["attrs"].get("height"): s for s in spans
               if s["name"] == "pipeline.apply"}
    overlapped = any(
        h + 1 in stages
        and stages[h + 1]["ts_ns"] < a["ts_ns"] + a["dur_ns"]
        for h, a in applies.items() if isinstance(h, int))
    assert overlapped, "no stage/apply overlap observed"
    return {"state": plain(st), "applied": sorted(applies),
            "staged": sorted(stages)}


CASES = {f.__name__[len("case_"):]: f for f in (
    case_equivalence_stable_window, case_equivalence_validator_set_change,
    case_equivalence_absent_votes, case_malformed_block_attribution,
    case_declines_trivial_and_busy_windows,
    case_raise_chaos_counts_strict_path_blocks,
    case_stage_starvation_degrades, case_spans_and_metrics_published)}
for _site, _mode in [("pipeline.stage", "raise"),
                     ("pipeline.stage", "latency:30"),
                     ("pipeline.commit", "raise"),
                     ("pipeline.commit", "latency:20"),
                     ("kvdb.group_commit", "raise"),
                     ("kvdb.group_commit", "latency:20")]:
    CASES[f"chaos-{_site}-{_mode}"] = _chaos_case(_site, _mode)


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return CASES[case](BY_NAME[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_case(case, pkg):
    """tests/test_pipeline.py's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_case_equal(case):
    """The case's outcome is the same in both packages: states, store key
    sets and decoded values."""
    assert _outcome(case, "jax") == _outcome(case, "port")


def test_set_config_wins_over_env_both_ways(monkeypatch, pkg):
    pipeline = pkg.pipeline
    monkeypatch.setenv("TM_TPU_BLOCK_PIPELINE", "0")
    p = pipeline.set_config(enable=True, depth=2, group_commit_heights=3)
    assert p is not None and p.is_running() and p.depth == 2
    assert pipeline.running() is p
    monkeypatch.setenv("TM_TPU_BLOCK_PIPELINE", "1")
    assert pipeline.set_config(enable=False) is None
    assert pipeline.installed() is None and not p.is_running()
    monkeypatch.setenv("TM_TPU_BLOCK_PIPELINE", "0")
    assert pipeline.set_config(enable=None) is None
    monkeypatch.delenv("TM_TPU_BLOCK_PIPELINE")
    monkeypatch.setenv("TM_TPU_PIPELINE_DEPTH", "5")
    monkeypatch.setenv("TM_TPU_GROUP_COMMIT_HEIGHTS", "11")
    p = pipeline.set_config(enable=None)
    assert p is not None and p.depth == 5 and p.group_commit_heights == 11
    monkeypatch.setenv("TM_TPU_GROUP_COMMIT_HEIGHTS", "13")
    p2 = pipeline.set_config(enable=None)
    assert p2 is p and p2.group_commit_heights == 13
    monkeypatch.setenv("TM_TPU_PIPELINE_DEPTH", "6")
    p3 = pipeline.set_config(enable=None)
    assert p3 is not p and p3.depth == 6 and p3.is_running()
    assert not p.is_running()
    pipeline.set_config(enable=False)
    # the defaults, with no knob set
    for k in ("TM_TPU_PIPELINE_DEPTH", "TM_TPU_GROUP_COMMIT_HEIGHTS"):
        monkeypatch.delenv(k)
    d = pipeline.BlockPipeline()
    assert (d.enabled, d.depth, d.group_commit_heights) == (True, 4, 8)


# ---------------------------------------------------------------------------
# crash consistency: kill between group commits -> reopen -> resume
# ---------------------------------------------------------------------------

_KILL_CHILD = r"""
import importlib, os, pickle, sys
sys.path.insert(0, @@REPO@@)
root, home, kill_at, chain = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
M = lambda m: importlib.import_module(f"{root}.{m}")
if root == "tendermint_tpu_torch":
    importlib.import_module(root).set_default_device("cpu")
kv = M("libs.kvdb")
Block, Commit = M("types.block").Block, M("types.commit").Commit
with open(chain, "rb") as f:
    bp, cp = pickle.load(f)
blocks = [Block.from_proto(b) for b in bp]
commits = [Commit.from_proto(c) for c in cp]
G, B, ed = M("types.genesis"), M("types.basic"), M("crypto.ed25519")
privs = [ed.PrivKey((0xBEE + i).to_bytes(32, "big")) for i in range(4)]
gdoc = G.GenesisDoc(
    chain_id="test-chain-tpu", genesis_time=B.Timestamp(1700000000, 0),
    validators=[G.GenesisValidator(
        address=k.pub_key().address(), pub_key_type="ed25519",
        pub_key_bytes=k.pub_key().bytes(), power=10) for k in privs])

# die IMMEDIATELY before the kill_at-th group-commit write lands
calls = {"n": 0}
orig = kv.GroupCommitDB._commit_one
def dying(self, group):
    calls["n"] += 1
    if calls["n"] == kill_at:
        os._exit(77)
    return orig(self, group)
kv.GroupCommitDB._commit_one = dying

bdb = kv.GroupCommitDB(kv.SQLiteDB(os.path.join(home, "blocks.db")))
sdb = kv.GroupCommitDB(kv.SQLiteDB(os.path.join(home, "state.db")))
kw = {"device": "cpu"} if root == "tendermint_tpu_torch" else {}
ex = M("state.execution").BlockExecutor(
    M("state.store").StateStore(sdb), M("abci.kvstore").KVStoreApplication(),
    **kw)
store = M("store.block_store").BlockStore(bdb)
state = M("state.state").state_from_genesis(gdoc)
M("state.pipeline").set_config(enable=True, depth=3, group_commit_heights=4)
M("blocksync.replay").replay_window(ex, store, state, blocks, commits,
                                    max_window=24)
sys.exit(3)  # the kill should have fired mid-window
"""


@functools.lru_cache(maxsize=None)
def _chain24(name):
    p = BY_NAME[name]
    gdoc, privs = make_genesis(p, 4)
    return gdoc, build_chain(p, gdoc, privs, 24)


@pytest.mark.parametrize("kill_at,want_store,want_state", [
    (3, 4, 4),
    (4, 8, 4),
])
def test_kill_between_group_commits_reopen_resume(tmp_path, pkg, kill_at,
                                                  want_store, want_state):
    """The child really dies (os._exit) before its kill_at-th group
    commit (a group of 4 heights commits its block batch, then its state
    batch); the parent reopens the SQLite files: the block store height
    is monotonic, the state store never ahead of it, every stored block
    intact.  Standalone resume (no node handshake): a fresh app replays
    from genesis through the pipeline over the reopened stores; blocks
    already stored pass _apply_one's identity check instead of a re-save,
    and the replay lands on the chain's app hash."""
    p = pkg
    gdoc, (blocks, commits, states) = _chain24(p.name)
    chain = tmp_path / "chain.pickle"
    with open(chain, "wb") as f:
        pickle.dump(([b.proto() for b in blocks],
                     [c.proto() for c in commits]), f)
    home = tmp_path / "home"
    home.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", TM_TPU_DISABLE_BATCH="1")
    r = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD.replace("@@REPO@@", repr(REPO)),
         p.root, str(home), str(kill_at), str(chain)],
        env=env, capture_output=True, timeout=120)
    assert r.returncode == 77, (
        f"child rc={r.returncode}\n"
        f"stderr: {r.stderr[-2000:].decode(errors='replace')}")

    bdb = p.kvdb.SQLiteDB(str(home / "blocks.db"))
    sdb = p.kvdb.SQLiteDB(str(home / "state.db"))
    try:
        store, sstore = p.bstore.BlockStore(bdb), p.sstore.StateStore(sdb)
        st = sstore.load()
        state_h = st.last_block_height if st is not None else 0
        assert store.height() == want_store
        assert state_h == want_state
        for h in range(1, store.height() + 1):
            assert store.load_block(h).hash() == blocks[h - 1].hash()
        saved = []
        real_save = store.save_block
        store.save_block = lambda b, *a: (saved.append(b.header.height),
                                          real_save(b, *a))[1]
        ex = executor(p, sstore, p.kvstore.KVStoreApplication())
        p.pipeline.set_config(enable=True, depth=3, group_commit_heights=4)
        try:
            st = replay_all(p, ex, store, p.state.state_from_genesis(gdoc),
                            blocks, commits, window=16)
        finally:
            p.pipeline.set_config(enable=False)
        assert st.last_block_height == 24
        assert st.app_hash == states[-1].app_hash
        assert saved == list(range(want_store + 1, 25))
        assert sstore.load().last_block_height == 24
    finally:
        bdb.close()
        sdb.close()


# ---------------------------------------------------------------------------
# the port's departures: the executor's device, a card fault
# ---------------------------------------------------------------------------

def test_pipeline_submits_to_the_scheduler_on_the_executors_device():
    """A VerifyScheduler running on the CPU takes every staged block's
    batch of a CPU executor (BLOCKSYNC class); the window's result is the
    serial path's."""
    gdoc, privs = make_genesis(PORT, 5)
    blocks, commits, states = build_chain(PORT, gdoc, privs, 10)
    s = PORT.scheduler.install(PORT.scheduler.VerifyScheduler(device="cpu"))
    s.start()
    prios = []
    real = s.submit
    s.submit = lambda items, prio=None, **kw: (prios.append(prio),
                                               real(items, prio, **kw))[1]
    pipe = PORT.pipeline.set_config(enable=True, depth=3,
                                    group_commit_heights=4)
    try:
        ex, store, st, *_ = fresh(PORT, gdoc)
        st = replay_all(PORT, ex, store, st, blocks, commits, window=10)
    finally:
        PORT.pipeline.set_config(enable=False)
        s.stop()
        PORT.scheduler.uninstall(s)
    assert st.app_hash == states[-1].app_hash
    assert pipe.windows_pipelined == 1
    assert len(prios) == 10
    assert set(prios) == {PORT.scheduler.Priority.BLOCKSYNC}
    assert s.stats()["submissions"] >= 10


def _card_error():
    return PORT.degrade.DeviceLaneError("launch failed on the card")


@pytest.mark.parametrize("where", ["stage", "future"])
def test_card_fault_leaves_the_pipelined_window(monkeypatch, where):
    """Block 4's signatures fail on the card: in the stage worker's direct
    verify ("stage", no scheduler), or as the scheduler's failed future
    ("future").  replay_window raises WindowDeviceError with heights 1-3
    applied and durable; block 4's batch is verified once and never
    again (no direct or host re-verify), and the window does not degrade
    to the strict path."""
    gdoc, privs = make_genesis(PORT, 4)
    blocks, commits, states = build_chain(PORT, gdoc, privs, 8)
    verifies = []
    real_verify = PORT.scheduler.verify_items

    def verify_items(items, *a, **kw):
        verifies.append(items[0][2])       # the batch's first signature
        if where == "stage" and len(verifies) == 4:
            raise _card_error()
        return real_verify(items, *a, **kw)
    monkeypatch.setattr(PORT.scheduler, "verify_items", verify_items)
    strict = []
    real_light = PORT.validator_set.ValidatorSet.verify_commit_light
    monkeypatch.setattr(PORT.validator_set.ValidatorSet,
                        "verify_commit_light",
                        lambda self, *a, **kw: (strict.append(a[2]),
                                                real_light(self, *a,
                                                           **kw))[1])
    s = None
    if where == "future":
        s = PORT.scheduler.install(
            PORT.scheduler.VerifyScheduler(device="cpu"))
        s.start()
        real_submit = s.submit
        heights = iter(range(1, 9))

        def submit(items, prio=None, **kw):
            fut = real_submit(items, prio, **kw)
            if next(heights) == 4:
                fut = PORT.scheduler.VerifyFuture(len(items))
                fut._set_exception(_card_error())
            return fut
        s.submit = submit
    pipe = PORT.pipeline.set_config(enable=True, depth=2,
                                    group_commit_heights=2)
    try:
        ex, store, st, bdb, sdb = fresh(PORT, gdoc)
        with pytest.raises(PORT.degrade.DeviceLaneError) as ei:
            PORT.replay.replay_window(ex, store, st, blocks, commits,
                                      max_window=8)
    finally:
        PORT.pipeline.set_config(enable=False)
        if s is not None:
            s.stop()
            PORT.scheduler.uninstall(s)
    e = ei.value
    assert isinstance(e, PORT.replay.WindowDeviceError)
    assert not isinstance(e, PORT.replay.WindowSyncError)
    assert (e.height, e.applied) == (4, 3)
    assert e.state.app_hash == states[2].app_hash
    assert pipe.windows_degraded == 0 and pipe.windows_pipelined == 0
    assert strict == []
    if where == "stage":           # one verify a staged block, none again
        assert len(verifies) >= 4 and len(set(verifies)) == len(verifies)
    else:                          # the scheduler's, and no direct one
        assert verifies == []
    assert bdb.pending_ops() == 0 and sdb.pending_ops() == 0
    assert store.height() == 3
    assert ex.state_store.load().last_block_height == 3
