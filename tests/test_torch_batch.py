"""BatchVerifier and verify_sigs_bulk of the port give the JAX package's
bitmaps: list, (n, 32) matrix and RaggedBytes inputs, below and above
tpu_threshold (the JAX side forced onto its device lane with
TM_TPU_FORCE_BATCH=1; on the CPU that lane is its XLA route)."""
import random

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jkeys
from tendermint_tpu.libs.ragged import RaggedBytes as JRagged

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.libs.ragged import RaggedBytes as TRagged
from tendermint_tpu_torch.ops import ed25519 as ted


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    T.set_default_device("cpu")
    yield
    T.set_default_device("cuda")


@pytest.fixture(scope="module")
def triples():
    """48 triples, every fourth corrupted (sig, msg or key), variable
    message lengths."""
    rng = random.Random(7)
    n = 48
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    msgs = [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 120)))
            for _ in range(n)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    for i in range(0, n, 4):
        kind = (i // 4) % 3
        if kind == 0:
            sigs[i] = sigs[i][:10] + bytes([sigs[i][10] ^ 4]) + sigs[i][11:]
        elif kind == 1:
            msgs[i] = msgs[i] + b"!"
        else:
            pubs[i] = bytes([pubs[i][0] ^ 2]) + pubs[i][1:]
    return pubs, msgs, sigs


def _bv(mod, keys, pubs, msgs, sigs, n):
    bv = mod.BatchVerifier()
    for i in range(n):
        bv.add(keys.PubKey(pubs[i]), msgs[i], sigs[i])
    return bv.verify()


@pytest.mark.parametrize("n", [8, 48], ids=["host", "device"])
def test_batch_verifier(triples, n):
    pubs, msgs, sigs = triples
    j_ok, j_bits = _bv(jbatch, jkeys, pubs, msgs, sigs, n)
    before = ted.last_launch()["seq"]
    t_ok, t_bits = _bv(tbatch, tkeys, pubs, msgs, sigs, n)
    np.testing.assert_array_equal(j_bits, t_bits)
    assert j_ok == t_ok is False
    # the device lane ran only above the threshold
    assert (ted.last_launch()["seq"] > before) == (n >= 32)
    # valid triples were remembered
    i = int(np.flatnonzero(t_bits)[0])
    assert tbatch.verified_sigs.hit(pubs[i], msgs[i], sigs[i])


@pytest.mark.parametrize("form", ["list", "matrix", "ragged"])
@pytest.mark.parametrize("n", [8, 48], ids=["host", "device"])
def test_verify_sigs_bulk(triples, form, n):
    pubs, msgs, sigs = triples
    pubs, msgs, sigs = pubs[:n], msgs[:n], sigs[:n]
    if form == "list":
        jp = [jkeys.PubKey(p) for p in pubs]
        tp = [tkeys.PubKey(p) for p in pubs]
        jm = tm = msgs
    else:
        jp = tp = np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32)
        jm = tm = msgs
        if form == "ragged":
            jm, tm = JRagged.from_list(msgs), TRagged.from_list(msgs)
    want = jbatch.verify_sigs_bulk(jp, jm, sigs)
    got = tbatch.verify_sigs_bulk(tp, tm, sigs)
    np.testing.assert_array_equal(want, got)
    if n >= 32:
        rec = ted.last_launch()
        assert rec["path"] == "cuda" and rec["n"] == n


def test_malformed_lengths(triples):
    """Short keys and signatures are invalid without poisoning the rest
    of the batch, as in the JAX package."""
    pubs, msgs, sigs = triples
    pubs, msgs, sigs = list(pubs[:40]), msgs[:40], list(sigs[:40])
    pubs[1] = pubs[1][:31]
    sigs[2] = sigs[2][:63]
    want = jbatch.verify_ed25519_batch(pubs, msgs, sigs)
    got = tbatch.verify_ed25519_batch(pubs, msgs, sigs)
    np.testing.assert_array_equal(want, got)
    assert not got[1] and not got[2] and got[3]
    np.testing.assert_array_equal(
        tbatch._host_bulk_ed25519(pubs, msgs, sigs), got)


def test_bulk_below_threshold_fills_the_sig_cache(triples, monkeypatch):
    """An (n, 32) matrix below tpu_threshold goes through BatchVerifier in
    both packages, so the valid triple lands in the SigCache and a short
    signature is simply invalid."""
    pubs, msgs, sigs = triples
    mat = np.frombuffer(pubs[1] + pubs[2], np.uint8).reshape(2, 32)
    two = [msgs[1], msgs[2]]
    short = [sigs[1], sigs[2][:63]]
    got = {}
    for name, mod in (("jax", jbatch), ("port", tbatch)):
        monkeypatch.setattr(mod, "verified_sigs", mod.SigCache())
        bits = mod.verify_sigs_bulk(mat, two, short)
        got[name] = (bits.tolist(), len(mod.verified_sigs))
    assert got["port"] == got["jax"] == ([True, False], 1)
    assert tbatch.verified_sigs.hit(pubs[1], msgs[1], sigs[1])


def test_host_bulk_never_raises(triples):
    """The host fallback of the whole-commit path returns False for any
    malformed triple (a short key, a message or key that is not bytes),
    as the JAX package's does: it is the runtime's host_fn, and a
    fallback must not raise where the reference answers."""
    pubs, msgs, sigs = triples
    p = [pubs[1], pubs[2][:31], object(), pubs[5]]
    m = [msgs[1], msgs[2], msgs[3], None]
    s = [sigs[1], sigs[2], sigs[3], sigs[5]]
    want = jbatch._host_bulk_ed25519(p, m, s)
    got = tbatch._host_bulk_ed25519(p, m, s)
    np.testing.assert_array_equal(want, got)
    assert got.tolist() == [True, False, False, False]


def test_context_priority_name_reads_the_context():
    """The direct path's e2e latency label is the caller's scheduler
    priority context, COMMIT outside one, restored on exit."""
    from tendermint_tpu.crypto import scheduler as jvs
    from tendermint_tpu_torch.crypto import scheduler as tvs

    for b, vs in ((jbatch, jvs), (tbatch, tvs)):
        got = [b._context_priority_name()]
        with vs.priority_context(vs.Priority.BLOCKSYNC):
            got.append(b._context_priority_name())
            with vs.priority_context(vs.Priority.CONSENSUS, deadline=1.0):
                got.append(b._context_priority_name())
                got.append(vs.context_priority(vs.Priority.MEMPOOL))
            got.append(b._context_priority_name())
        got.append(b._context_priority_name())
        got[3] = (got[3][0].name, got[3][1])
        assert got == ["commit", "blocksync", "consensus",
                       ("CONSENSUS", 1.0), "blocksync", "commit"]


def test_host_verify_items_takes_the_reference_signature(triples,
                                                         monkeypatch):
    """_host_verify_items(tname, items, assume_miss=, t_submit=) as the
    JAX package's: the same bitmap with and without the cache pre-pass,
    and assume_miss never consults the SigCache."""
    import inspect

    assert list(inspect.signature(tbatch._host_verify_items).parameters) \
        == list(inspect.signature(jbatch._host_verify_items).parameters)
    pubs, msgs, sigs = triples
    out = {}
    for name, b, keys in (("jax", jbatch, jkeys), ("port", tbatch, tkeys)):
        cache = b.SigCache()
        monkeypatch.setattr(b, "verified_sigs", cache)
        items = [b._Item(keys.PubKey(p), m, s)
                 for p, m, s in zip(pubs, msgs, sigs)]
        cache.add(pubs[1], msgs[1], sigs[1])
        a = b._host_verify_items("ed25519", items)
        hits = (cache.hits, cache.misses)
        c = b._host_verify_items("ed25519", items, assume_miss=True,
                                 t_submit=0.0)
        out[name] = (a.tolist(), c.tolist(), hits,
                     (cache.hits, cache.misses))
    assert out["jax"] == out["port"]
    a, c, hits, after = out["port"]
    assert a == c == [_edref.verify(p, m, s)
                      for p, m, s in zip(pubs, msgs, sigs)]
    assert hits == (1, 47) and after == hits


@pytest.fixture(scope="module")
def mixed():
    """Eight triples of each scheme, one bad in each, interleaved:
    (scheme, pub bytes, msg, sig) rows."""
    from tendermint_tpu_torch.crypto import secp256k1 as tsecp
    from tendermint_tpu_torch.crypto import sr25519 as tsr
    rows = []
    for i in range(8):
        seed = bytes([0x40 + i]) * 32
        m = b"mixed ed %d" % i
        s = _edref.sign(seed, m)
        rows.append(("ed25519", _edref.pubkey_from_seed(seed), m,
                     s if i != 2 else bytes([s[0] ^ 1]) + s[1:]))
        k = tsecp.PrivKey.gen_from_secret(b"mixed secp %d" % i)
        m = b"mixed secp %d" % i
        s = k.sign(m)
        rows.append(("secp256k1", k.pub_key().bytes(), m,
                     s if i != 5 else s[:40] + bytes([s[40] ^ 2]) + s[41:]))
        mini = (0x3A0 + i).to_bytes(32, "little")
        m = b"mixed sr %d" % i
        s = tsr.sign(mini, m)
        rows.append(("sr25519", tsr.PrivKey(mini).pub_key().bytes(),
                     m if i != 7 else m + b"!", s))
    return rows


def _mixed_verify(root, rows, **kw):
    from importlib import import_module
    cb = import_module(f"{root}.crypto.batch")
    bv = cb.BatchVerifier(tpu_threshold=4, **kw)
    for scheme, p, m, s in rows:
        bv.add(import_module(f"{root}.crypto.{scheme}").PubKey(p), m, s)
    ok, bits = bv.verify()
    return ok, bits, cb.last_lane_report()


def _lanes(report):
    return sorted((r["scheme"], r["kind"]) for r in report["lanes"])


def test_mixed_batch_on_the_device_lanes(mixed, monkeypatch):
    """A mixed ed25519 + secp256k1 + sr25519 batch on device="cpu" with
    the device lanes forced: K1, S1 and S2 run their plain versions
    (each lane's launch counted at batch.<scheme>), and the bitmap equals
    the JAX package's (its host lanes: the native C lanes through its
    pool) and the oracle's; the lane report names three device lanes."""
    from tendermint_tpu_torch.crypto import degrade as tdeg
    monkeypatch.delenv("TM_TPU_FORCE_BATCH")
    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    _, jbits, jrep = _mixed_verify("tendermint_tpu", mixed)
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH")
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    m = tdeg.runtime().metrics
    # the counters live in the process's default registry
    before = {s: m.device_launches.value(site=f"batch.{s}")
              for s in ("ed25519", "secp256k1", "sr25519")}
    ok, bits, rep = _mixed_verify("tendermint_tpu_torch", mixed)
    want = [not (s == "ed25519" and m.endswith(b" 2")
                 or s == "secp256k1" and m.endswith(b" 5")
                 or s == "sr25519" and m.endswith(b"!"))
            for s, _, m, _ in mixed]
    assert bits.tolist() == jbits.tolist() == want and not ok
    assert _lanes(rep) == [("ed25519", "device"), ("secp256k1", "device"),
                           ("sr25519", "device")]
    assert _lanes(jrep) == [("ed25519", "host"), ("secp256k1", "host"),
                            ("sr25519", "host")]
    assert set(rep) == set(jrep) and 0.0 <= rep["overlap_ratio"] < 1.0
    for scheme in ("ed25519", "secp256k1", "sr25519"):
        assert m.device_launches.value(site=f"batch.{scheme}") - \
            before[scheme] == 1


def test_mixed_batch_on_the_host_lanes_and_the_rollback(mixed, monkeypatch):
    """device="cpu" without the force takes the host lanes in both
    packages (run concurrently through the pool: the native C lanes for
    secp256k1 and sr25519); with the device lanes forced and the
    secp256k1 rollback switch thrown, secp256k1 alone stays on the host
    lane, in both packages.  Same bitmaps and lane kinds."""
    from tendermint_tpu.ops import secp as jsecp_ops
    from tendermint_tpu.ops import sr25519 as jsr_ops
    from tendermint_tpu_torch.ops import secp as tsecp_ops
    monkeypatch.delenv("TM_TPU_FORCE_BATCH")
    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    _, jbits, jrep = _mixed_verify("tendermint_tpu", mixed)
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH")
    _, bits, rep = _mixed_verify("tendermint_tpu_torch", mixed,
                                 device="cpu")
    assert bits.tolist() == jbits.tolist()
    assert _lanes(rep) == _lanes(jrep)
    # the rollback: secp256k1 on the host lane; the other lanes stubbed
    # by the oracle in both packages (their kernels are held elsewhere)
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    from tendermint_tpu.crypto import sr25519 as jsr
    from tendermint_tpu_torch.crypto import sr25519 as tsr

    def oracle(mod):
        return lambda pubs, msgs, sigs, **kw: np.array([
            mod.PubKey(bytes(p)).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)])
    monkeypatch.setattr(jsr_ops, "verify_batch_device", oracle(jsr))
    monkeypatch.setattr(jbatch, "ed_ops_verify",
                        lambda p, m, s, **kw: oracle(jkeys)(p, m, s))
    monkeypatch.setattr(tbatch, "_verify_sr25519", oracle(tsr))
    monkeypatch.setattr(tbatch, "ed_ops_verify",
                        lambda p, m, s, **kw: oracle(tkeys)(p, m, s))
    for mod in (jsecp_ops, tsecp_ops):
        monkeypatch.setattr(mod, "_lane_override", False)
    assert tbatch._device_verifier("secp256k1") is None
    _, jbits2, jrep2 = _mixed_verify("tendermint_tpu", mixed)
    _, bits2, rep2 = _mixed_verify("tendermint_tpu_torch", mixed)
    assert bits2.tolist() == jbits2.tolist() == bits.tolist()
    assert _lanes(rep2) == _lanes(jrep2) == [
        ("ed25519", "device"), ("secp256k1", "host"), ("sr25519", "device")]
    monkeypatch.setenv("TM_TPU_SECP_LANE", "1")
    for mod in (jsecp_ops, tsecp_ops):
        monkeypatch.setattr(mod, "_lane_override", None)
    assert tsecp_ops.use_lane() and jsecp_ops.use_lane()
    monkeypatch.setenv("TM_TPU_SECP_LANE", "off")
    assert not tsecp_ops.use_lane() and not jsecp_ops.use_lane()


def test_load_kernels_takes_the_schemes():
    """On the CPU _load_kernels builds nothing and returns the device; the
    lane verifiers are the ones the JAX package's _device_verifier
    names."""
    assert tbatch._load_kernels("cpu", 64, ("secp256k1", "sr25519")) == \
        torch.device("cpu")
    for scheme in ("ed25519", "secp256k1", "sr25519"):
        assert (tbatch._device_verifier(scheme) is None) == \
            (jbatch._device_verifier(scheme) is None)
    assert tbatch._device_verifier("other") is None
