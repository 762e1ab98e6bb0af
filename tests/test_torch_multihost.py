"""The port's global data plane across two processes (parallel/sharding
_GlobalDataPlane over torch.distributed with gloo, on the CPU), against
the JAX package's tests/test_multihost_replay.py.

Two OS processes form one process group (gloo, a TCP store on a free
port of 127.0.0.1, retried when the port races away as the JAX test
retries its coordinator's) and verify the SAME batch in lockstep.  The
worker is this file run as a script (`__main__` below): each rank owns
`--positions` CPU positions (sharding._local_devices), the analog of the
JAX workers' 4 virtual CPU devices, and writes what it saw as JSON.

  * tier-1: one pair of processes with one position a rank runs, in
    order, the coordinated bulk verify of 8 triples with one bad
    signature (verify_sigs_bulk(coordinated=True)), the poison latch
    (rank 1 latches, rank 0's global_plane() reads None within
    2 x _POISON_CHECK_EVERY_S, the next coordinated call on both ranks
    takes the local route with the same bitmap), and the port's two
    departures: a card fault inside the global plane reaches the caller
    as DeviceLaneError with the plane latched and the poison published,
    and a torch.distributed fault latches the plane and verifies the
    batch on the local route with the exact bitmap; then one lockstep
    blocksync replay_window of a seeded 8-validator chain (route
    global-mesh, the chain's app hash) and the same window with K3
    failing on the card (WindowDeviceError, nothing applied, the plane
    latched).
  * slow, the JAX tests' twins: test_two_process_mesh_bitmap_agrees (the
    sharded verifier over the 8 global positions, per-rank shards
    stitched) and test_two_process_production_verify_global_mesh
    (ops/ed25519.verify_batch inside lockstep(): route global-mesh over 8
    positions, the all-valid bit reduced over both ranks).

Tolerance: exact (bitmaps, routes, the all-valid bit).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BIND_ERRORS = ("Address already in use", "address already in use",
                "EADDRINUSE", "Failed to bind")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, npz, mode, positions, attempts=3, timeout=240):
    """Both ranks of `mode`, retried on a fresh port when rank 0's store
    could not bind the one probed (another process took it between the
    probe and the bind).  Returns the two ranks' JSON results."""
    last = ""
    for attempt in range(attempts):
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("TM_TPU_NO_MESH", None)
        env.pop("TM_TPU_NO_GLOBAL_MESH", None)
        env.pop("TM_TPU_FAILPOINTS", None)
        procs, outs, logs = [], [], []
        for rank in range(2):
            out = tmp_path / f"rank{rank}.{mode}.{attempt}.json"
            log = tmp_path / f"rank{rank}.{mode}.{attempt}.log"
            outs.append(out)
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), "2",
                 str(port), str(npz), str(out), mode, str(positions)],
                cwd=REPO, env=env, stdout=open(log, "wb"),
                stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            raise AssertionError("worker timeout; logs:\n" + "\n".join(
                lg.read_text()[-3000:] for lg in logs))
        if all(p.returncode == 0 for p in procs):
            return [json.load(open(o)) for o in outs]
        last = "\n".join(lg.read_text()[-3000:] for lg in logs)
        if not any(e in last for e in _BIND_ERRORS):
            raise AssertionError(last)
    raise AssertionError(f"the store's port kept racing ({attempts} "
                         f"attempts):\n{last}")


def _signed_batch(path, n, bad, seed, tag, extra):
    """n triples from seeded keys, lanes `bad` corrupted, saved to an npz;
    returns the expected bitmap."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    rng = np.random.default_rng(seed)
    pubs, sigs, msgs, want = [], [], [], []
    for i in range(n):
        k = ed.PrivKey(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        m = tag + b"-%03d" % i + bytes(rng.integers(0, 256, extra,
                                                    dtype=np.uint8))
        sig = bytearray(k.sign(m))
        if i in bad:
            sig[i % 64] ^= 1
        pubs.append(np.frombuffer(k.pub_key().bytes(), dtype=np.uint8))
        sigs.append(np.frombuffer(bytes(sig), dtype=np.uint8))
        msgs.append(np.frombuffer(m, dtype=np.uint8))
        want.append(i not in bad)
    np.savez(path, pubs=np.stack(pubs), sigs=np.stack(sigs),
             msgs=np.stack(msgs))
    return want


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """One tier-1 pair of ranks, one CPU position each, over the 8-triple
    batch: every phase's results."""
    tmp = tmp_path_factory.mktemp("gmesh")
    npz = tmp / "small.npz"
    want = _signed_batch(npz, 8, {5}, 3, b"gmesh-small", 24)
    t0 = time.monotonic()
    res = _run_pair(tmp, npz, "small", 1)
    return want, res, time.monotonic() - t0


def test_coordinated_bulk_verify_takes_the_global_plane(small_pair):
    """verify_sigs_bulk(coordinated=True) on both ranks: route
    global-mesh over the 2 positions, each rank's bitmap the expected one
    and equal to the other's, the all-valid bit reduced to False on both,
    each rank's K3 run on its own position only."""
    want, res, wall = small_pair
    for r in res:
        c = r["coordinated"]
        assert c["path"] == "global-mesh" and c["shards"] == 2, c
        assert c["bitmap"] == [int(w) for w in want]
        assert c["all_valid"] is False
        assert c["staged_calls"] == 1, c
    assert res[0]["coordinated"]["bitmap"] == res[1]["coordinated"]["bitmap"]
    assert wall < 120, wall


def test_poison_latch_converges_and_the_next_call_runs_locally(small_pair):
    """Rank 1 latches the global plane off; rank 0's global_plane() reads
    None within 2 x _POISON_CHECK_EVERY_S; the next coordinated call on
    both ranks takes the local route, with the same bitmap."""
    want, res, _ = small_pair
    r0, r1 = res
    assert r1["latch"]["self_latched"] is True
    assert r0["latch"]["peer_saw_poison"] is True
    assert r0["latch"]["seen_after_s"] <= 2 * r0["latch"]["check_every_s"]
    for r in res:
        after = r["after_latch"]
        assert after["path"] != "global-mesh" and after["shards"] == 1
        assert after["bitmap"] == [int(w) for w in want]


def test_card_fault_in_the_global_plane_is_raised_and_latched(small_pair):
    """A card fault (DeviceLaneError outside a drill) inside
    gplane.verify_batch reaches the caller of ops/ed25519.verify_batch as
    DeviceLaneError: the plane is latched, the poison key of the rank is
    in the store, and no local route verified the batch."""
    _, res, _ = small_pair
    for r in res:
        cf = r["card_fault"]
        assert cf["raised"] == "DeviceLaneError", cf
        assert cf["latched"] is True and cf["poison_published"] is True
        assert cf["local_k1_calls"] == 0, cf


def test_collective_fault_latches_and_verifies_locally(small_pair):
    """A torch.distributed fault inside the global plane latches it off
    and the batch is verified on the local route, exact bitmap."""
    want, res, _ = small_pair
    for r in res:
        df = r["dist_fault"]
        assert df["latched"] is True
        assert df["path"] != "global-mesh" and df["shards"] == 1
        assert df["bitmap"] == [int(w) for w in want]


def test_lockstep_replay_window_takes_the_global_plane(small_pair):
    """blocksync.replay_window on both ranks of the process group runs its
    coalesced batch inside lockstep() (verify_items(coordinated=True)):
    route global-mesh over the 2 positions, every block applied, the
    chain's app hash, the plane not latched."""
    _, res, _ = small_pair
    for r in res:
        rp = r["replay"]
        assert rp["path"] == "global-mesh" and rp["shards"] == 2, rp
        assert rp["applied"] == 5 and rp["app_hash_equal"] is True
        assert rp["latched"] is False


def test_card_fault_on_the_lockstep_replay_is_a_window_device_error(
        small_pair):
    """A card fault under the lockstep branch leaves replay_window as
    WindowDeviceError (a DeviceLaneError, never a WindowSyncError) with
    nothing applied, and latches the global plane."""
    _, res, _ = small_pair
    for r in res:
        rf = r["replay_fault"]
        assert rf["error"] == "WindowDeviceError", rf
        assert rf["device_lane_error"] and not rf["window_sync_error"]
        assert rf["applied"] == 0 and rf["store_height"] == 0
        assert rf["latched"] is True


@pytest.mark.slow
def test_two_process_mesh_bitmap_agrees(tmp_path):
    """tests/test_multihost_replay.py's test through the port: the
    sharded verifier over 8 global positions (4 a rank); each rank's own
    positions' bits stitched together cover the padded batch once, equal
    the expected bitmap, and the all-valid bit agrees (False)."""
    n = 96
    want = _signed_batch(tmp_path / "batch.npz", n, {5, 37, 70}, 7,
                         b"replay-vote", 80)
    results = _run_pair(tmp_path, tmp_path / "batch.npz", "raw", 4)
    assert results[0]["all_valid"] == results[1]["all_valid"] is False
    nb = -(-n // 8) * 8
    got = np.full(nb, -1, dtype=int)
    for r in results:
        for sh in r["shards"]:
            st, bits = sh["start"], sh["bits"]
            assert np.all(got[st:st + len(bits)] == -1), "shard overlap"
            got[st:st + len(bits)] = bits
    assert np.all(got >= 0), "shard gap"
    assert got[:n].astype(bool).tolist() == want
    assert not got[n:].any()


@pytest.mark.slow
def test_two_process_production_verify_global_mesh(tmp_path):
    """tests/test_multihost_replay.py's production test through the port:
    ops/ed25519.verify_batch inside lockstep() on both ranks takes route
    global-mesh over 8 positions with the reduced all-valid bit, and both
    return the same full bitmap, the expected one."""
    n = 96
    want = _signed_batch(tmp_path / "prod.npz", n, {5, 37, 70}, 11,
                         b"gmesh-vote", 40)
    results = _run_pair(tmp_path, tmp_path / "prod.npz", "prod", 4)
    for r in results:
        assert r["path"] == "global-mesh" and r["shards"] == 8, r
        assert r["all_valid"] is False
        assert r["bitmap"] == [int(w) for w in want]
    assert results[0]["bitmap"] == results[1]["bitmap"]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _launch_rec(edops):
    ll = edops.last_launch()
    return {"path": ll.get("path"), "shards": ll.get("shards"),
            "all_valid": ll.get("all_valid")}


def _worker_small(rank, pubs, msgs, sigs, out):
    import torch
    import torch.distributed as dist

    from tendermint_tpu_torch.crypto import batch as cbatch
    from tendermint_tpu_torch.crypto import degrade
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck
    from tendermint_tpu_torch.ops import ed25519 as edops
    from tendermint_tpu_torch.parallel import sharding as shd

    from tendermint_tpu_torch.crypto import ed25519 as ed

    keys = [ed.PubKey(p) for p in pubs]
    res = {}
    # (1) the coordinated bulk verify
    calls = {"n": 0}
    real_k3 = ck.verify_staged

    def counted(*a):
        calls["n"] += 1
        return real_k3(*a)

    ck.verify_staged = counted
    bits = cbatch.verify_sigs_bulk(keys, msgs, sigs, tpu_threshold=1,
                                   device="cpu", coordinated=True)
    ck.verify_staged = real_k3
    res["coordinated"] = dict(_launch_rec(edops),
                              bitmap=np.asarray(bits).astype(int).tolist(),
                              staged_calls=calls["n"])

    # (2) the poison latch: rank 1 latches, rank 0 polls
    dist.barrier()
    latch = {"check_every_s": shd._POISON_CHECK_EVERY_S}
    if rank == 1:
        shd.disable_global_plane()
        latch["self_latched"] = shd._GLOBAL_PLANE is False
    dist.barrier()
    if rank == 0:
        t0 = time.monotonic()
        seen = False
        while time.monotonic() - t0 < 3 * shd._POISON_CHECK_EVERY_S:
            with shd.lockstep():
                if shd.global_plane() is None:
                    seen = True
                    break
            time.sleep(0.05)
        latch["peer_saw_poison"] = seen
        latch["seen_after_s"] = time.monotonic() - t0
    res["latch"] = latch
    dist.barrier()
    bits = cbatch.verify_sigs_bulk(keys, msgs, sigs, tpu_threshold=1,
                                   device="cpu", coordinated=True)
    res["after_latch"] = dict(_launch_rec(edops),
                              bitmap=np.asarray(bits).astype(int).tolist())

    def reset_plane():
        dist.barrier()
        if rank == 0:
            shd._clear_poison()
        dist.barrier()
        with shd._PLANE_LOCK:
            shd._GLOBAL_PLANE = None
        shd._poison_seen = False
        shd._poison_next_check = 0.0
        dist.barrier()

    # (3) a card fault inside the global plane (both ranks, so that
    # neither waits in a collective the other never enters)
    reset_plane()

    def card_fault(*a):
        raise degrade.DeviceLaneError("K3 failed on the card")

    local = {"n": 0}
    real_k1 = ck.verify_packed

    def k1_counted(*a):
        local["n"] += 1
        return real_k1(*a)

    ck.verify_staged = card_fault
    ck.verify_packed = k1_counted
    cf = {"raised": None}
    with shd.lockstep():
        assert shd.global_plane() is not None
        try:
            edops.verify_batch(pubs, msgs, sigs, device="cpu")
        except Exception as e:  # noqa: BLE001 - recorded
            cf["raised"] = type(e).__name__
    ck.verify_staged = real_k3
    ck.verify_packed = real_k1
    cf["latched"] = shd._GLOBAL_PLANE is False
    store = shd._coord_client()
    cf["poison_published"] = bool(store.check(
        [f"{shd._GMESH_POISON_DIR}/{rank}"]))
    cf["local_k1_calls"] = local["n"]
    res["card_fault"] = cf

    # (4) a torch.distributed fault inside the global plane
    reset_plane()
    real_gather = dist.all_gather

    def broken_gather(*a, **kw):
        raise RuntimeError("gloo: connection closed by peer")

    dist.all_gather = broken_gather
    with shd.lockstep():
        bits = edops.verify_batch(pubs, msgs, sigs, device="cpu")
    dist.all_gather = real_gather
    res["dist_fault"] = dict(_launch_rec(edops),
                             bitmap=np.asarray(bits).astype(int).tolist(),
                             latched=shd._GLOBAL_PLANE is False)

    # (5) one lockstep replay_window of a seeded chain on both ranks
    from tendermint_tpu_torch.blocksync import replay as breplay

    reset_plane()
    gdoc, blocks, commits, want_hash = _chain(8, 5)
    ex, store, state = _fresh_node(gdoc)
    state, applied = breplay.replay_window(ex, store, state, blocks,
                                           commits, max_window=5)
    res["replay"] = dict(_launch_rec(edops), applied=applied,
                         app_hash_equal=bytes(state.app_hash) == want_hash,
                         latched=shd._GLOBAL_PLANE is False)

    # (6) a card fault on the lockstep branch: the runtime's lane held
    # on the card (as on a CUDA device), K3 failing on both ranks
    reset_plane()
    real_collect = degrade.DeviceLaneRuntime.collect

    def on_card(self, *a, **kw):
        kw["on_card"] = True
        return real_collect(self, *a, **kw)

    degrade.DeviceLaneRuntime.collect = on_card
    ck.verify_staged = card_fault
    ex, store, state = _fresh_node(gdoc)
    err = None
    try:
        breplay.replay_window(ex, store, state, blocks, commits,
                              max_window=5)
    except Exception as e:  # noqa: BLE001 - recorded
        err = e
    ck.verify_staged = real_k3
    degrade.DeviceLaneRuntime.collect = real_collect
    res["replay_fault"] = {
        "error": type(err).__name__,
        "device_lane_error": isinstance(err, degrade.DeviceLaneError),
        "window_sync_error": isinstance(err, breplay.WindowSyncError),
        "height": getattr(err, "height", None),
        "applied": getattr(err, "applied", None),
        "store_height": store.height(),
        "latched": shd._GLOBAL_PLANE is False}
    dist.barrier()
    with open(out, "w") as f:
        json.dump(res, f)
    del torch


def _chain(n_validators, n_heights):
    """A seeded kvstore chain of the port (tests/helpers.py build_chain's
    shape): genesis, blocks, their certifying commits (each the next
    block's LastCommit object) and the last app hash.  Every rank builds
    the same chain."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.blocksync import replay as breplay
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.types import basic as B
    from tendermint_tpu_torch.types import canonical, genesis
    from tendermint_tpu_torch.types.commit import Commit, CommitSig

    privs = [ed.PrivKey((0xBEE + i).to_bytes(32, "big"))
             for i in range(n_validators)]
    gdoc = genesis.GenesisDoc(
        chain_id="gmesh-chain", genesis_time=B.Timestamp(1700000000, 0),
        validators=[genesis.GenesisValidator(
            address=k.pub_key().address(), pub_key_type="ed25519",
            pub_key_bytes=k.pub_key().bytes(), power=10) for k in privs])
    ex = execution.BlockExecutor(StateStore(MemDB()), KVStoreApplication(),
                                 device="cpu")
    state = state_from_genesis(gdoc)
    by_addr = {k.pub_key().address(): k for k in privs}
    blocks, commits = [], []
    last = Commit(0, 0, B.BlockID(), [])
    for h in range(1, n_heights + 1):
        block = state.make_block(h, [b"k%d=v" % h], last, [],
                                 state.validators.get_proposer().address,
                                 block_time=B.Timestamp(1700000000 + h, 0))
        bid, _ = breplay.block_id_of(block)
        ts = B.Timestamp(1700000000 + h, 500)
        sigs = [CommitSig(B.BlockIDFlag.COMMIT, v.address, ts,
                          by_addr[v.address].sign(
                              canonical.canonical_vote_bytes(
                                  gdoc.chain_id, B.SignedMsgType.PRECOMMIT,
                                  h, 0, bid, ts)))
                for v in state.validators.validators]
        last = Commit(h, 0, bid, sigs)
        blocks.append(block)
        commits.append(last)
        state, _ = ex.apply_block(state, bid, block)
    return gdoc, blocks, commits, bytes(state.app_hash)


def _fresh_node(gdoc):
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.libs.kvdb import MemDB
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore

    ex = execution.BlockExecutor(StateStore(MemDB()), KVStoreApplication(),
                                 device="cpu")
    return ex, BlockStore(MemDB()), state_from_genesis(gdoc)


def _worker_raw(rank, pubs, msgs, sigs, out):
    from tendermint_tpu_torch.ops import ed25519 as edops
    from tendermint_tpu_torch.parallel import sharding as shd

    staged, host_ok = edops.prepare_batch_compact(pubs, sigs, msgs)
    with shd.lockstep():
        gp = shd.global_plane()
        assert gp is not None and gp.nshard == 8, gp
        n = host_ok.shape[0]
        rows = shd._compact_rows(staged, -(-n // 8) * 8)
        gp._sealed(rows.shape[1])
        args = gp._put_sharded((rows,), axis=1)
        outs = [(pos, dev, shd._k3_rows(args[pos][0]))
                for pos, dev in gp._local_positions()]
        live = np.zeros(rows.shape[1], dtype=bool)
        live[:n] = True
        bm, all_valid = gp._gather(outs, live)
    per = rows.shape[1] // gp.nshard
    shards = [{"start": pos * per,
               "bits": bm[pos * per:(pos + 1) * per].astype(int).tolist()}
              for pos, _ in gp._local_positions()]
    with open(out, "w") as f:
        json.dump({"rank": rank, "all_valid": all_valid, "shards": shards},
                  f)


def _worker_prod(rank, pubs, msgs, sigs, out):
    from tendermint_tpu_torch.ops import ed25519 as edops
    from tendermint_tpu_torch.parallel import sharding as shd

    assert shd.global_mesh_ready(), "the process group is not up"
    with shd.lockstep():
        bitmap = edops.verify_batch(pubs, msgs, sigs, device="cpu")
    with open(out, "w") as f:
        json.dump(dict(_launch_rec(edops), rank=rank,
                       bitmap=np.asarray(bitmap).astype(int).tolist()), f)


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    npz_path, out_path, mode = sys.argv[4], sys.argv[5], sys.argv[6]
    positions = int(sys.argv[7])
    os.environ["TM_TPU_FORCE_BATCH"] = "1"

    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import tendermint_tpu_torch as T
    from tendermint_tpu_torch.parallel import sharding as shd

    T.set_default_device("cpu")
    cpu = torch.device("cpu")
    shd._local_devices = lambda: [cpu] * positions
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        data = np.load(npz_path)
        pubs = [bytes(p) for p in data["pubs"]]
        sigs = [bytes(s) for s in data["sigs"]]
        msgs = [bytes(m) for m in data["msgs"]]
        {"small": _worker_small, "raw": _worker_raw,
         "prod": _worker_prod}[mode](rank, pubs, msgs, sigs, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
