"""The port's light client (the verifier, the trusted store, the providers,
the detector, the bisection client) against the JAX package's, on the CPU.

tests/test_light.py's seventeen cases run through both packages on chains
that test_torch_blocksync's `build_chain` makes from the same seeded keys in
each; each case returns its outcome as a package-free value (verdicts,
exception classes with their messages, trusted heights, the hashes and
attributions of the evidence the detector submits, which witnesses and
primary remain) and the outcomes are compared across the packages exactly.
The comb case (tests/test_light.py:373, a trusting certificate through a
comb subset that survives eviction) runs the port's real plain C1, C2 and
K1 on the CPU, and the JAX package's comb and ladder as bignum verdicts on
their staged operands (no XLA compile).  Then the port's departures:
`device=` reaches every certificate, with no CUDA and no device="cpu" the
client raises RuntimeError, and a launch that failed on the card
(degrade.DeviceLaneError) leaves verify_light_block with the primary, the
witnesses and the store unchanged, and NodeBackedProvider.report_evidence
not as a ProviderError; in a chaos drill the JAX package's behaviour holds.
"""
from __future__ import annotations

import copy
import functools
import importlib
import threading
from fractions import Fraction

import numpy as np
import pytest
import torch

import tendermint_tpu_torch as T
from test_torch_blocksync import (BY_NAME, JAX, PKGS, PORT, _clean,  # noqa: F401
                                  build_chain, make_genesis)
from test_torch_types import _cpu, _one_torch_thread  # noqa: F401
from test_torch_types import plain

_EXTRA = {
    "light": "light", "lverifier": "light.verifier",
    "lprovider": "light.provider", "ldetector": "light.detector",
    "lclient": "light.client", "lstore": "light.store",
    "ev_pool": "evidence.pool", "ev_types": "types.evidence",
    "light_block": "types.light_block", "vote": "types.vote",
    "registry": "libs.metrics", "ops_ed": "ops.ed25519",
}
for _p in PKGS:
    for _attr, _mod in _EXTRA.items():
        setattr(_p, _attr, importlib.import_module(f"{_p.root}.{_mod}"))

PERIOD = 3600.0 * 24 * 14
DRIFT = 10.0


def NOW(p):
    return p.basic.Timestamp(1700005000, 0)


def dev(p) -> dict:
    """The port's device argument (the CPU), none for the JAX package."""
    return {"device": "cpu"} if p is PORT else {}


def raised(fn):
    """(class name, message) of what fn() raises, or ("ok", result)."""
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return (type(e).__name__, str(e))


def light_chain(p, n_heights=20, n_vals=5):
    """tests/test_light.py's _light_chain: {height: LightBlock}."""
    gdoc, privs = make_genesis(p, n_vals)
    blocks, commits, states = build_chain(p, gdoc, privs, n_heights)
    lbs = {b.header.height: p.light_block.LightBlock(
        p.light_block.SignedHeader(b.header, commits[i]),
        states[i].validators) for i, b in enumerate(blocks)}
    return gdoc, lbs


def make_client(p, lbs, chain_id, trusted_height=1, witnesses=None,
                sequential=False):
    primary = p.lprovider.DictProvider(chain_id, lbs)
    return p.lclient.Client(
        chain_id, p.lclient.TrustOptions(trusted_height,
                                         lbs[trusted_height].hash(), PERIOD),
        primary, witnesses if witnesses is not None else [],
        p.lstore.LightStore(p.kvdb.MemDB()), sequential=sequential,
        **dev(p))


def garbage_fork(lbs, height=12):
    forked = dict(lbs)
    evil = copy.deepcopy(lbs[height])
    evil.signed_header.header.app_hash = b"\xBA\xD0" * 16
    forked[height] = evil
    return forked


def signed_fork(p, gdoc, privs, lbs, height, mutate):
    """tests/test_light.py's _signed_fork: the header at `height` mutated
    and re-signed by the real keys."""
    B = p.basic
    lb = copy.deepcopy(lbs[height])
    mutate(lb.signed_header.header)
    hdr = lb.signed_header.header
    bid = B.BlockID(hdr.hash(), B.PartSetHeader(1, b"\x99" * 32))
    old = lb.signed_header.commit
    by_addr = {k.pub_key().address(): k for k in privs}
    sigs = []
    for i, v in enumerate(lb.validators.validators):
        ts = old.signatures[i].timestamp
        vote = p.vote.Vote(type=B.SignedMsgType.PRECOMMIT, height=height,
                           round=old.round, block_id=bid, timestamp=ts,
                           validator_address=v.address, validator_index=i)
        sigs.append(p.commit.CommitSig(
            B.BlockIDFlag.COMMIT, v.address, ts,
            by_addr[v.address].sign(vote.sign_bytes(gdoc.chain_id))))
    lb.signed_header.commit = p.commit.Commit(height, old.round, bid, sigs)
    forked = dict(lbs)
    forked[height] = lb
    return forked


def forked_light_chain(p, height=12, n=12):
    gdoc, privs = make_genesis(p, 5)
    blocks, commits, states = build_chain(p, gdoc, privs, n)
    lbs = {b.header.height: p.light_block.LightBlock(
        p.light_block.SignedHeader(b.header, commits[i]),
        states[i].validators) for i, b in enumerate(blocks)}
    forked = signed_fork(p, gdoc, privs, lbs, height,
                         lambda h: setattr(h, "app_hash", b"\xBA\xD0" * 16))
    return gdoc, privs, blocks, commits, states, lbs, forked


def node_stores(p, gdoc, blocks, commits, states):
    """A full node's block and state stores holding the chain."""
    block_store = p.bstore.BlockStore(p.kvdb.MemDB())
    state_store = p.sstore.StateStore(p.kvdb.MemDB())
    for b, c in zip(blocks, commits):
        _bid, parts = p.replay.block_id_of(b)
        block_store.save_block(b, parts, c)
    state_store.save(p.state.state_from_genesis(gdoc))
    for st in states:
        state_store.save(st)
    return block_store, state_store


def ev_view(ev):
    """LightClientAttackEvidence's attribution, package-free."""
    return {"hash": ev.hash(), "conflicting": ev.conflicting_block.hash(),
            "common_height": ev.common_height,
            "byzantine": [v.address for v in ev.byzantine_validators],
            "total": ev.total_voting_power}


# ---------------------------------------------------------------------------
# tests/test_light.py's cases, each returning its package-free outcome
# ---------------------------------------------------------------------------

def case_verify_adjacent_and_non_adjacent(p):
    gdoc, lbs = light_chain(p)
    V = p.lverifier
    V.verify_adjacent(lbs[3].signed_header, lbs[4].signed_header,
                      lbs[4].validators, PERIOD, NOW(p), DRIFT, **dev(p))
    V.verify_non_adjacent(lbs[3].signed_header, lbs[3].validators,
                          lbs[17].signed_header, lbs[17].validators, PERIOD,
                          NOW(p), DRIFT, **dev(p))
    out = []
    with pytest.raises(V.LightError):
        V.verify_non_adjacent(lbs[3].signed_header, lbs[3].validators,
                              lbs[4].signed_header, lbs[4].validators,
                              PERIOD, NOW(p), DRIFT, **dev(p))
    out.append(raised(lambda: V.verify_non_adjacent(
        lbs[3].signed_header, lbs[3].validators, lbs[4].signed_header,
        lbs[4].validators, PERIOD, NOW(p), DRIFT, **dev(p))))
    with pytest.raises(V.LightError):
        V.verify_adjacent(lbs[3].signed_header, lbs[7].signed_header,
                          lbs[7].validators, PERIOD, NOW(p), DRIFT, **dev(p))
    out.append(raised(lambda: V.verify_adjacent(
        lbs[3].signed_header, lbs[7].signed_header, lbs[7].validators,
        PERIOD, NOW(p), DRIFT, **dev(p))))
    return out


def case_verify_rejects_expired_and_tampered(p):
    gdoc, lbs = light_chain(p)
    V = p.lverifier
    out = []
    with pytest.raises(V.OldHeaderExpiredError):
        V.verify_adjacent(lbs[3].signed_header, lbs[4].signed_header,
                          lbs[4].validators, 1.0, NOW(p), DRIFT, **dev(p))
    out.append(raised(lambda: V.verify_adjacent(
        lbs[3].signed_header, lbs[4].signed_header, lbs[4].validators, 1.0,
        NOW(p), DRIFT, **dev(p))))
    bad = lbs[9].signed_header
    orig = bad.header.app_hash
    bad.header.app_hash = b"\x01" * 32
    with pytest.raises(V.LightError):
        V.verify_adjacent(lbs[8].signed_header, bad, lbs[9].validators,
                          PERIOD, NOW(p), DRIFT, **dev(p))
    out.append(raised(lambda: V.verify_adjacent(
        lbs[8].signed_header, bad, lbs[9].validators, PERIOD, NOW(p), DRIFT,
        **dev(p))))
    bad.header.app_hash = orig
    return out


def case_verify_backwards(p):
    gdoc, lbs = light_chain(p)
    V = p.lverifier
    V.verify_backwards(lbs[6].signed_header, lbs[7].signed_header)
    with pytest.raises(V.InvalidHeaderError):
        V.verify_backwards(lbs[5].signed_header, lbs[7].signed_header)
    return raised(lambda: V.verify_backwards(lbs[5].signed_header,
                                             lbs[7].signed_header))


def case_trust_level_validation(p):
    V = p.lverifier
    V.validate_trust_level(Fraction(1, 3))
    V.validate_trust_level(Fraction(1, 1))
    out = []
    for bad in (Fraction(1, 4), Fraction(3, 2)):
        with pytest.raises(V.LightError):
            V.validate_trust_level(bad)
        out.append(raised(lambda bad=bad: V.validate_trust_level(bad)))
    return out


def case_client_bisection_reaches_target(p):
    gdoc, lbs = light_chain(p, 30)
    c = make_client(p, lbs, gdoc.chain_id)
    lb = c.verify_light_block_at_height(30, NOW(p))
    assert lb.height == 30 and c.store.get(30) is not None
    assert c.last_trusted_height() == 30
    return c.store.heights()


def case_client_sequential_matches(p):
    gdoc, lbs = light_chain(p, 10)
    c = make_client(p, lbs, gdoc.chain_id, sequential=True)
    lb = c.verify_light_block_at_height(10, NOW(p))
    assert lb.height == 10
    assert c.store.heights() == list(range(1, 11))
    return [c.store.get(h).hash() for h in c.store.heights()]


def case_client_update_and_backwards(p):
    gdoc, lbs = light_chain(p, 15)
    c = make_client(p, lbs, gdoc.chain_id, trusted_height=10)
    got = c.update(NOW(p))
    assert got is not None and got.height == 15
    lb = c.verify_light_block_at_height(4, NOW(p))
    assert lb.height == 4
    return [got.hash(), lb.hash(), c.store.heights()]


def case_client_drops_unverifiable_witness_conflict(p):
    gdoc, lbs = light_chain(p, 12)
    garbage = p.lprovider.DictProvider(gdoc.chain_id, garbage_fork(lbs))
    honest = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    c = make_client(p, lbs, gdoc.chain_id, witnesses=[garbage, honest])
    lb = c.verify_light_block_at_height(12, NOW(p))
    assert lb.height == 12 and c.store.get(12) is not None
    assert garbage not in c.witnesses and honest in c.witnesses
    return [c.store.heights(), len(c.witnesses), garbage.evidence,
            honest.evidence]


def case_client_refuses_when_only_witness_is_garbage(p):
    gdoc, lbs = light_chain(p, 12)
    garbage = p.lprovider.DictProvider(gdoc.chain_id, garbage_fork(lbs))
    c = make_client(p, lbs, gdoc.chain_id, witnesses=[garbage])
    with pytest.raises(p.lclient.LightClientError) as ei:
        c.verify_light_block_at_height(12, NOW(p))
    assert c.store.get(12) is None
    return [type(ei.value).__name__, str(ei.value), c.store.heights()]


def case_client_requires_one_successful_cross_reference(p):
    class DeadProvider(p.lprovider.DictProvider):
        def light_block(self, height):
            raise p.lprovider.ProviderError("unreachable")

    gdoc, lbs = light_chain(p, 12)
    dead = DeadProvider(gdoc.chain_id, {})
    c = make_client(p, lbs, gdoc.chain_id, witnesses=[dead])
    with pytest.raises((p.ldetector.CrossReferenceError,
                        p.lclient.LightClientError)) as ei:
        c.verify_light_block_at_height(12, NOW(p))
    assert c.store.get(12) is None
    return [type(ei.value).__name__, str(ei.value), c.store.heights()]


def case_client_rejects_wrong_trust_anchor(p):
    gdoc, lbs = light_chain(p, 5)
    primary = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    with pytest.raises(p.lclient.LightClientError) as ei:
        p.lclient.Client(gdoc.chain_id,
                         p.lclient.TrustOptions(1, b"\x00" * 32, PERIOD),
                         primary, [], p.lstore.LightStore(p.kvdb.MemDB()),
                         **dev(p))
    return str(ei.value)


def case_divergence_attributes_and_submits_evidence_both_ways(p):
    gdoc, privs, blocks, commits, states, lbs, forked = forked_light_chain(p)
    primary = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    witness = p.lprovider.DictProvider(gdoc.chain_id, forked)
    c = p.lclient.Client(gdoc.chain_id,
                         p.lclient.TrustOptions(1, lbs[1].hash(), PERIOD),
                         primary, [witness],
                         p.lstore.LightStore(p.kvdb.MemDB()), **dev(p))
    with pytest.raises(p.light.Divergence) as ei:
        c.verify_light_block_at_height(12, NOW(p))
    assert len(primary.evidence) == 1
    ev = primary.evidence[0]
    assert ev.conflicting_block.hash() == forked[12].hash()
    assert len(ev.byzantine_validators) == 5 and ev.common_height == 1
    assert len(witness.evidence) == 1
    assert witness.evidence[0].conflicting_block.hash() == lbs[12].hash()
    assert witness not in c.witnesses
    return {"error": str(ei.value), "to_primary": ev_view(ev),
            "to_witness": ev_view(witness.evidence[0]),
            "trusted": c.store.heights()}


def case_divergent_witness_evidence_lands_in_full_node_pool(p):
    gdoc, privs, blocks, commits, states, lbs, forked = forked_light_chain(p)
    block_store, state_store = node_stores(p, gdoc, blocks, commits, states)
    pool = p.ev_pool.EvidencePool(p.kvdb.MemDB(), state_store, block_store,
                                  **dev(p))
    primary = p.lprovider.NodeBackedProvider(gdoc.chain_id, block_store,
                                             state_store, evidence_pool=pool)
    witness = p.lprovider.DictProvider(gdoc.chain_id, forked)
    c = p.lclient.Client(gdoc.chain_id,
                         p.lclient.TrustOptions(1, lbs[1].hash(), PERIOD),
                         primary, [witness],
                         p.lstore.LightStore(p.kvdb.MemDB()), **dev(p))
    with pytest.raises(p.light.Divergence):
        c.verify_light_block_at_height(12, NOW(p))
    pend = pool.pending_evidence()
    assert len(pend) == 1 and isinstance(
        pend[0], p.ev_types.LightClientAttackEvidence)
    assert pend[0].conflicting_block.hash() == forked[12].hash()
    assert len(pend[0].byzantine_validators) == 5
    return ev_view(pend[0])


def case_primary_replacement_on_failure(p):
    gdoc, lbs = light_chain(p, 12)

    class DeadProvider(p.lprovider.DictProvider):
        def light_block(self, height):
            raise p.lprovider.ProviderError("connection refused")

    w1 = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    w2 = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    c = p.lclient.Client(gdoc.chain_id,
                         p.lclient.TrustOptions(1, lbs[1].hash(), PERIOD),
                         p.lprovider.DictProvider(gdoc.chain_id, lbs),
                         [w1, w2], p.lstore.LightStore(p.kvdb.MemDB()),
                         **dev(p))
    c.primary = DeadProvider(gdoc.chain_id, {})
    lb = c.verify_light_block_at_height(10, NOW(p))
    assert lb.height == 10
    assert c.primary is w1 and c.witnesses == [w2]
    c.witnesses.clear()
    with pytest.raises(p.lclient.LightClientError, match="no witnesses"):
        c.verify_light_block_at_height(11, NOW(p))
    return [c.store.heights(),
            raised(lambda: c.verify_light_block_at_height(11, NOW(p)))]


def case_unresponsive_witness_removed_after_strikes(p):
    gdoc, lbs = light_chain(p, 12)

    class FlakyWitness(p.lprovider.DictProvider):
        def light_block(self, height):
            raise p.lprovider.ProviderError("timeout")

    good = p.lprovider.DictProvider(gdoc.chain_id, lbs)
    w = FlakyWitness(gdoc.chain_id, {})
    c = make_client(p, lbs, gdoc.chain_id, witnesses=[w, good])
    strikes = []
    for h in (4, 7, 10):
        c.verify_light_block_at_height(h, NOW(p))
        strikes.append(sorted(c._witness_strikes.values()))
    assert w not in c.witnesses and good in c.witnesses
    return [strikes, c.store.heights()]


def case_client_racing_verifiers_thread_safe(p):
    gdoc, lbs = light_chain(p, 30)
    c = make_client(p, lbs, gdoc.chain_id)
    errs = []

    def worker(h):
        try:
            lb = c.verify_light_block_at_height(h, NOW(p))
            assert lb.height == h
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errs.append(repr(e))

    threads = [threading.Thread(target=worker, args=(h,))
               for h in (30, 17, 25, 9, 30, 17, 22, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not errs, errs
    assert c.last_trusted_height() == 30
    for h in c.store.heights():
        assert c.store.get(h).hash() == lbs[h].hash()
    assert c.update(NOW(p)) is None
    # the heights stored depend on the threads' interleaving; the
    # anchors every interleaving stores are compared
    return [c.last_trusted_height(), 30 in c.store.heights(),
            1 in c.store.heights()]


# -- the comb case: the JAX package's comb and ladder kernels as bignum
# verdicts on their staged operands, the port's real plain kernels


def _jax_comb_as_bignum(monkeypatch):
    from test_torch_comb import JAX as CJ, _bignum, _digits_value, _stub
    from tendermint_tpu.ops import curve as JC
    import jax.numpy as jnp
    _stub(CJ, monkeypatch, {})     # the ladder as the bignum verdict

    def build(pub):
        pub = np.asarray(pub)
        # the keys ride the table's first field to the kernel below
        return JC.Cached(pub, None, None, None), \
            jnp.ones(pub.shape[0], dtype=bool)

    def kernel(r, sd, kd, vidx, ypx, ymx, z, t2d, dok, by, bm, bt):
        r, sd, kd, vidx = (np.asarray(r), np.asarray(sd), np.asarray(kd),
                           np.asarray(vidx))
        return jnp.asarray(np.array([_bignum(
            ypx[vidx[i]].tobytes(), r[i].tobytes(), _digits_value(sd[i]),
            _digits_value(kd[i])) for i in range(r.shape[0])]))
    monkeypatch.setattr(CJ.ed, "comb_build_kernel", build)
    monkeypatch.setattr(CJ.ed, "comb_kernel", kernel)


def case_trusting_cert_through_comb_subset_survives_eviction(p, mp):
    from test_torch_comb import _batch
    mp.setenv("TM_TPU_FORCE_BATCH", "1")
    E = p.ops_ed
    rt = p.degrade.configure(registry=p.registry.Registry(
        "light_trusting_comb"))
    E.table_cache_clear()
    if p is JAX:
        mp.setenv("TM_TPU_NO_MESH", "1")
        _jax_comb_as_bignum(mp)
    mp.setattr(E, "_comb_min_override", 1)
    E.set_comb_config(enabled=True, table_cache_mb=64)
    ladder = "xla" if p is JAX else "cuda"

    gdoc, privs = make_genesis(p, 48)
    blocks, commits, states = build_chain(p, gdoc, privs, 2)
    vals, commit = states[1].validators, commits[1]
    level = Fraction(2, 3)

    def reject_msg():
        orig = commit.signatures[0].signature
        commit.signatures[0].signature = bytes([orig[0] ^ 1]) + orig[1:]
        try:
            with pytest.raises(p.validator_set.CommitVerifyError) as ei:
                vals.verify_commit_light_trusting(gdoc.chain_id, commit,
                                                  level, **dev(p))
            return str(ei.value)
        finally:
            commit.signatures[0].signature = orig

    def launch():
        ll = E.last_launch()
        return ("ladder" if ll["path"] == ladder else ll["path"], ll["n"],
                ll.get("table_build"))

    try:
        assert E.prewarm([v.pub_key.bytes() for v in vals.validators],
                         warm_kernel=False, **dev(p))
        vals.verify_commit_light_trusting(gdoc.chain_id, commit, level,
                                          **dev(p))
        out = [launch()]
        assert out[0] == ("comb", 33, False)
        comb_reject = reject_msg()
        assert "#0" in comb_reject
        E.set_comb_config(table_cache_mb=2)
        pb, mb, sb = _batch(12, pool=6, tag=b"evictor")
        assert E.verify_batch(pb, mb, sb, cache_pubs=True, **dev(p)).all()
        assert rt.metrics.table_evictions.value() >= 1
        vals.verify_commit_light_trusting(gdoc.chain_id, commit, level,
                                          **dev(p))
        out.append(launch())
        assert out[1][0] == "ladder"
        assert reject_msg() == comb_reject
        return out + [comb_reject, rt.metrics.table_evictions.value()]
    finally:
        E.table_cache_clear()
        E._comb_enabled_override = None
        E._table_budget_override = None
        p.degrade.reset()


CASES = {f.__name__[len("case_"):]: f for f in (
    case_verify_adjacent_and_non_adjacent,
    case_verify_rejects_expired_and_tampered, case_verify_backwards,
    case_trust_level_validation, case_client_bisection_reaches_target,
    case_client_sequential_matches, case_client_update_and_backwards,
    case_client_drops_unverifiable_witness_conflict,
    case_client_refuses_when_only_witness_is_garbage,
    case_client_requires_one_successful_cross_reference,
    case_client_rejects_wrong_trust_anchor,
    case_divergence_attributes_and_submits_evidence_both_ways,
    case_divergent_witness_evidence_lands_in_full_node_pool,
    case_primary_replacement_on_failure,
    case_unresponsive_witness_removed_after_strikes,
    case_client_racing_verifiers_thread_safe)}


@functools.lru_cache(maxsize=None)
def _outcome(case: str, name: str):
    return plain(CASES[case](BY_NAME[name]))


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_light_case(case, pkg):
    """tests/test_light.py's case, its assertions, in each package."""
    assert _outcome(case, pkg.name) is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_light_case_equal(case):
    """The case's outcome is the same in both packages."""
    assert _outcome(case, "jax") == _outcome(case, "port")


def test_trusting_cert_through_comb_subset_survives_eviction(monkeypatch):
    """tests/test_light.py:373 in both packages: the 33-signature prefix of
    a 48-validator commit on the prewarmed tables (path comb, no build),
    after an eviction on the ladder; accept and reject verdicts, the
    lowest failing index's message and the launch records equal."""
    got = {}
    for p in PKGS:
        with monkeypatch.context() as mp:
            got[p.name] = case_trusting_cert_through_comb_subset_survives_eviction(p, mp)
    assert got["jax"] == got["port"]


# ---------------------------------------------------------------------------
# the departures: device=, no CUDA, card faults
# ---------------------------------------------------------------------------

def test_device_reaches_every_certificate(monkeypatch):
    """Client(device=) and the verifier's device= reach every
    verify_commit_light* the client makes: the anchor's, the skipping
    hop's two and a sequential walk's."""
    seen = []
    VS = PORT.validator_set.ValidatorSet
    real_l, real_t = VS.verify_commit_light, VS.verify_commit_light_trusting

    def light(self, *a, device=None, **kw):
        seen.append(("light", device))
        return real_l(self, *a, device=device, **kw)

    def trusting(self, *a, device=None, **kw):
        seen.append(("trusting", device))
        return real_t(self, *a, device=device, **kw)
    monkeypatch.setattr(VS, "verify_commit_light", light)
    monkeypatch.setattr(VS, "verify_commit_light_trusting", trusting)
    gdoc, lbs = light_chain(PORT, 6)
    c = make_client(PORT, lbs, gdoc.chain_id)
    c.verify_light_block_at_height(6, NOW(PORT))
    s = make_client(PORT, lbs, gdoc.chain_id, sequential=True)
    s.verify_light_block_at_height(3, NOW(PORT))
    assert seen == [("light", "cpu"), ("trusting", "cpu"), ("light", "cpu"),
                    ("light", "cpu"), ("light", "cpu"), ("light", "cpu")]


def test_client_raises_without_cuda(monkeypatch):
    """With no CUDA and no device="cpu", a client over a 40-validator
    chain raises RuntimeError at its trust anchor's certificate, and the
    verifier at a skipping hop's, instead of verifying on the CPU; with
    device="cpu" the client verifies."""
    gdoc, lbs = light_chain(PORT, 4, n_vals=40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    primary = PORT.lprovider.DictProvider(gdoc.chain_id, lbs)
    opts = PORT.lclient.TrustOptions(1, lbs[1].hash(), PERIOD)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.lclient.Client(gdoc.chain_id, opts, primary, [],
                            PORT.lstore.LightStore(PORT.kvdb.MemDB()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT.lverifier.verify_non_adjacent(
            lbs[1].signed_header, lbs[1].validators, lbs[4].signed_header,
            lbs[4].validators, PERIOD, NOW(PORT), DRIFT)
    c = PORT.lclient.Client(gdoc.chain_id, opts, primary, [],
                            PORT.lstore.LightStore(PORT.kvdb.MemDB()),
                            device="cpu")
    assert c.verify_light_block_at_height(4, NOW(PORT)).height == 4


def _card_error():
    return PORT.degrade.DeviceLaneError("launch failed on the card")


def _break_certificates(monkeypatch, after=0):
    """verify_commit_light* raise a card fault from their (after+1)-th
    call on; returns the call log."""
    calls = []
    VS = PORT.validator_set.ValidatorSet
    real = {n: getattr(VS, n) for n in ("verify_commit_light",
                                        "verify_commit_light_trusting")}

    def make(n):
        def broken(self, *a, **kw):
            calls.append(n)
            if len(calls) > after:
                raise _card_error()
            return real[n](self, *a, **kw)
        return broken
    for n in real:
        monkeypatch.setattr(VS, n, make(n))
    return calls, lambda: [monkeypatch.setattr(VS, n, f)
                           for n, f in real.items()]


def test_card_fault_in_a_client_verify(monkeypatch):
    """A card fault in a hop: verify_light_block raises DeviceLaneError;
    the primary, the witnesses and the trusted store are unchanged, and
    the same verify succeeds once the card works."""
    gdoc, lbs = light_chain(PORT, 12)
    w = PORT.lprovider.DictProvider(gdoc.chain_id, lbs)
    c = make_client(PORT, lbs, gdoc.chain_id, witnesses=[w])
    primary = c.primary
    calls, restore = _break_certificates(monkeypatch)
    with pytest.raises(PORT.degrade.DeviceLaneError):
        c.verify_light_block_at_height(12, NOW(PORT))
    assert c.primary is primary and c.witnesses == [w]
    assert c.store.heights() == [1] and calls == ["verify_commit_light_trusting"]
    restore()
    assert c.verify_light_block_at_height(12, NOW(PORT)).height == 12
    assert c.store.heights() == [1, 12]


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_while_a_witness_chain_verifies(monkeypatch, drill):
    """The forked witness's chain verifies while the card fails
    (client.py's catch of the conflicting chain): outside a drill the
    DeviceLaneError leaves verify_light_block, the witness stays, no
    evidence is sent and nothing is trusted; in a drill the JAX package's
    path holds: the witness is dropped as unverifiable and the client
    refuses for want of witnesses."""
    gdoc, privs, blocks, commits, states, lbs, forked = \
        forked_light_chain(PORT)
    primary = PORT.lprovider.DictProvider(gdoc.chain_id, lbs)
    witness = PORT.lprovider.DictProvider(gdoc.chain_id, forked)
    c = PORT.lclient.Client(gdoc.chain_id,
                            PORT.lclient.TrustOptions(1, lbs[1].hash(),
                                                      PERIOD),
                            primary, [witness],
                            PORT.lstore.LightStore(PORT.kvdb.MemDB()),
                            device="cpu")
    # the primary's hop (two certificates) verifies; the witness chain's
    # first certificate fails on the card
    calls, _restore = _break_certificates(monkeypatch, after=2)
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
        with pytest.raises(PORT.lclient.LightClientError,
                           match="no witnesses"):
            c.verify_light_block_at_height(12, NOW(PORT))
        assert witness not in c.witnesses
    else:
        with pytest.raises(PORT.degrade.DeviceLaneError):
            c.verify_light_block_at_height(12, NOW(PORT))
        assert c.witnesses == [witness]
    assert primary.evidence == [] and witness.evidence == []
    assert c.primary is primary and c.store.heights() == [1]


@pytest.mark.parametrize("drill", [False, True], ids=["card", "drill"])
def test_card_fault_while_a_full_node_verifies_evidence(monkeypatch, drill):
    """NodeBackedProvider.report_evidence while the full node's pool meets
    a card fault: outside a drill the DeviceLaneError itself (not a
    ProviderError) leaves report_evidence and the client's
    verify_light_block, the witness stays; in a drill it is a
    ProviderError, as in the JAX package, and the divergence is
    raised."""
    gdoc, privs, blocks, commits, states, lbs, forked = \
        forked_light_chain(PORT)
    block_store, state_store = node_stores(PORT, gdoc, blocks, commits,
                                           states)
    pool = PORT.ev_pool.EvidencePool(PORT.kvdb.MemDB(), state_store,
                                     block_store, device="cpu")
    primary = PORT.lprovider.NodeBackedProvider(
        gdoc.chain_id, block_store, state_store, evidence_pool=pool)
    witness = PORT.lprovider.DictProvider(gdoc.chain_id, forked)
    c = PORT.lclient.Client(gdoc.chain_id,
                            PORT.lclient.TrustOptions(1, lbs[1].hash(),
                                                      PERIOD),
                            primary, [witness],
                            PORT.lstore.LightStore(PORT.kvdb.MemDB()),
                            device="cpu")
    # the hop (2) and the witness chain (2) verify; the pool's first
    # certificate fails on the card
    calls, _restore = _break_certificates(monkeypatch, after=4)
    if drill:
        PORT.fail.set_mode("pipeline.commit", "latency:1")
        with pytest.raises(PORT.light.Divergence):
            c.verify_light_block_at_height(12, NOW(PORT))
        assert witness not in c.witnesses
    else:
        with pytest.raises(PORT.degrade.DeviceLaneError):
            c.verify_light_block_at_height(12, NOW(PORT))
        assert c.witnesses == [witness]
        ev = PORT.ldetector._attack_evidence(lbs[1], forked[12], lbs[12])
        with pytest.raises(PORT.degrade.DeviceLaneError):
            primary.report_evidence(ev)
    assert pool.size() == 0 and c.store.heights() == [1]
