"""The chaos matrix of tests/test_chaos_matrix.py (its ed25519 cases) over
the port's BatchVerifier and verify_sigs_bulk, beside the JAX package's
under the same armed mode: device="cpu" with TM_TPU_FORCE_BATCH=1, so
the port's device lane runs through its degradation runtime onto the
kernels' plain PyTorch versions.

For each (site, mode) the port's bitmap equals the JAX package's and the
pure-host bitmap, and the failure class, the fallback count and every
other counter of the two runtimes' registries agree (but for the route
counter, whose path names differ between the packages' kernels).

The JAX package's device lane is its ops/ed25519.verify_batch with the
kernel stubbed by the host oracle behind the same chaos seam: its XLA
ladder costs about 30 s to compile on the CPU, and its own chaos tests
stub a kernel for the same reason — the plumbing under test sits
strictly above the kernel.  The port runs its real plain path in the
cases where the kernel's verdict is what is checked (control, raise at
the seam, corrupt-bitmap); the stalled, breaker and bulk cases stub it
in the same way (a plain launch takes about 4 s on one CPU thread).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import degrade as jdeg
from tendermint_tpu.crypto import ed25519 as jkeys
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.libs.metrics import Registry as JRegistry

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import degrade as tdeg
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs import trace as ttrace
from tendermint_tpu_torch.libs.metrics import Registry as TRegistry
from tendermint_tpu_torch.ops import ed25519 as ted

PKGS = {"jax": (jbatch, jdeg, jkeys, jfail, JRegistry),
        "port": (tbatch, tdeg, tkeys, tfail, TRegistry)}
TRACERS = {"jax": jtrace.TRACER, "port": ttrace.TRACER}
# published by the route seam of each package's kernels, not the runtime
ROUTE_FAMILIES = ("crypto_msm_route_total", "crypto_batch_occupancy_ratio",
                  "crypto_device_compile_seconds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _force_device(monkeypatch):
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    T.set_default_device("cpu")
    for b, d, k, f, r in PKGS.values():
        f.reset()
        monkeypatch.setattr(b, "verified_sigs", b.SigCache())
    yield
    for b, d, k, f, r in PKGS.values():
        f.reset()
        d.reset()
    for tracer in TRACERS.values():
        tracer.disable()
        tracer.reset()
    T.set_default_device("cuda")


def _stub(pkg: str):
    """The device lane's kernel as the host oracle, behind the package's
    own ops.ed25519.verify_batch chaos seam (the port's stub also checks
    that the lane got the torch.device resolved by its caller)."""
    b, d, keys, f, r = PKGS[pkg]

    def ed_ops_verify(pubkeys, msgs, sigs, cache_pubs=False, device=None):
        if pkg == "port":
            assert device == torch.device("cpu")
        f.inject("ops.ed25519.verify_batch")
        return np.array([keys.PubKey(bytes(p)).verify_signature(
            bytes(m), bytes(s)) for p, m, s in zip(pubkeys, msgs, sigs)])
    return ed_ops_verify


@pytest.fixture
def stub_jax(monkeypatch):
    monkeypatch.setattr(jbatch, "ed_ops_verify", _stub("jax"))


@pytest.fixture
def stub_port(monkeypatch):
    monkeypatch.setattr(tbatch, "ed_ops_verify", _stub("port"))


def _mixed_batch(n=24, bad=(3, 11, 17)):
    """n ed25519 triples, `bad` lanes invalid (flipped sig byte, one
    truncated) — the bitmap must attribute failures exactly."""
    privs = [tkeys.PrivKey(bytes([i + 1]) * 32) for i in range(n)]
    msgs = [b"chaos vote %d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in bad:
        sigs[i] = (sigs[i][:50] if i == bad[-1]
                   else bytes([sigs[i][0] ^ 1]) + sigs[i][1:])
    return [p.pub_key().bytes() for p in privs], msgs, sigs


def _verify(pkg, pubs, msgs, sigs, threshold=4):
    b, d, keys, f, r = PKGS[pkg]
    bv = b.BatchVerifier(tpu_threshold=threshold)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(keys.PubKey(p), m, s)
    return bv.verify()


def _host_baseline(pubs, msgs, sigs, monkeypatch):
    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    try:
        out = {pkg: _verify(pkg, pubs, msgs, sigs)[1] for pkg in PKGS}
    finally:
        monkeypatch.delenv("TM_TPU_DISABLE_BATCH")
    np.testing.assert_array_equal(out["jax"], out["port"])
    return out["port"]


_REG: dict = {}


def _configure(pkg, clk=None, **kw):
    b, d, k, f, Registry = PKGS[pkg]
    reg = Registry("chaos")
    cfg = d.DegradeConfig(
        failure_threshold=kw.pop("failure_threshold", 3),
        launch_timeout_s=kw.pop("launch_timeout_s", 120.0),
        backoff_base_s=10.0, backoff_max_s=100.0, backoff_jitter=0.0)
    _REG[pkg] = reg
    return d.configure(cfg, clock=clk or (lambda: 0.0), registry=reg)


def _metrics(pkg) -> dict:
    """Every counter and gauge sample and every histogram count of the
    package's runtime registry, the route-seam families excepted."""
    out = {}
    for line in _REG[pkg].render_text().splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        base = name.split("{", 1)[0]
        if base.endswith(("_bucket", "_sum")) or any(
                fam in base for fam in ROUTE_FAMILIES):
            continue
        out[name] = float(value)
    return out


# (site, mode, failure class the case must count, port kernel real)
CASES = [
    (None, None, None, True),                                 # control
    ("ops.ed25519.verify_batch", "raise", "raise", True),     # raises
    ("ops.ed25519.verify_batch", "latency:25", None, False),  # in budget
    ("batch.ed25519", "corrupt-bitmap", "integrity", True),   # garbage
]


@pytest.mark.parametrize("site,mode,reason,real", CASES,
                         ids=["control", "raise", "latency", "corrupt"])
def test_bitmap_identical_to_reference_and_host(monkeypatch, stub_jax, site,
                                               mode, reason, real):
    pubs, msgs, sigs = _mixed_batch()
    base = _host_baseline(pubs, msgs, sigs, monkeypatch)
    assert not base.all() and base.sum() == len(pubs) - 3
    if not real:
        monkeypatch.setattr(tbatch, "ed_ops_verify", _stub("port"))
    got, spans = {}, {}
    for pkg in PKGS:
        rt = _configure(pkg)
        f = PKGS[pkg][3]
        if site:
            f.set_mode(site, mode)
        seq = ted.last_launch()["seq"]
        tracer = TRACERS[pkg]
        tracer.enable()
        since = tracer.last_seq()
        try:
            ok, bits = _verify(pkg, pubs, msgs, sigs)
        finally:
            tracer.disable()
        spans[pkg] = tracer.snapshot(since)
        np.testing.assert_array_equal(bits, base)
        assert ok == bool(base.all())
        if mode:
            assert f.fired(site, mode) >= 1, "injection never triggered"
        if reason:
            assert rt.metrics.device_failures.value(
                site="batch.ed25519", reason=reason) == 1
            assert rt.metrics.host_fallbacks.value(
                site="batch.ed25519", reason=reason) == 1
        if pkg == "port":
            # the plain kernel ran exactly where the lane reached it
            assert (ted.last_launch()["seq"] > seq) == \
                (real and mode != "raise")
        got[pkg] = _metrics(pkg)
    assert got["port"] == got["jax"]
    _same_span_tree(spans, real and mode != "raise")


def _same_span_tree(spans, kernel_ran: bool):
    """The flight recorder's tree of the batch: the same spans, parents
    and outcomes in both packages (the lane worker's device.launch linked
    under the caller's batch.verify across the thread boundary), and in
    the port, where its kernel ran, the ops.ed25519.verify_batch span
    under device.launch carrying the route of the launch record."""
    trees = {}
    for pkg, recs in spans.items():
        by_id = {r["id"]: r for r in recs}
        port_ops = [r for r in recs if r["name"] == "ops.ed25519.verify_batch"]
        if pkg == "port":
            assert len(port_ops) == int(kernel_ran)
            for r in port_ops:
                assert by_id[r["parent"]]["name"] == "device.launch"
                assert r["attrs"]["path"] == "cuda"
                # the truncated signature is rejected before the kernel
                assert r["attrs"]["nb"] == 256 and r["attrs"]["n"] == 23
        trees[pkg] = sorted(
            (r["name"], by_id[r["parent"]]["name"] if r["parent"] in by_id
             else None, r["attrs"].get("outcome"), r["attrs"].get("site"))
            for r in recs if r["name"] != "ops.ed25519.verify_batch")
    assert trees["port"] == trees["jax"]
    names = [t[0] for t in trees["port"]]
    assert names.count("batch.verify") == 1 and "batch.verdict" in names
    assert ("device.launch", "batch.verify", None, "batch.ed25519") in \
        trees["port"]


def test_latency_past_deadline_times_out_bitmap_exact(monkeypatch, stub_jax,
                                                      stub_port):
    """The timeout class: a launch stalled past its deadline is abandoned
    on its quarantined worker and the batch re-verifies on the host —
    the same bitmap, no hang; the next launch runs on a fresh worker."""
    pubs, msgs, sigs = _mixed_batch()
    base = _host_baseline(pubs, msgs, sigs, monkeypatch)
    got = {}
    for pkg in PKGS:
        rt = _configure(pkg)
        f = PKGS[pkg][3]
        _, bits = _verify(pkg, pubs, msgs, sigs)   # a launch in budget
        np.testing.assert_array_equal(bits, base)
        assert rt.breaker.state == PKGS[pkg][1].CLOSED
        rt.cfg.launch_timeout_s = 0.05
        f.set_mode("ops.ed25519.verify_batch", "latency:400")
        _, bits = _verify(pkg, pubs, msgs, sigs)
        np.testing.assert_array_equal(bits, base)
        assert rt.metrics.device_failures.value(
            site="batch.ed25519", reason="timeout") == 1
        # the quarantined worker must not poison the next launch
        rt.cfg.launch_timeout_s = 120.0
        f.clear()
        _, bits = _verify(pkg, pubs, msgs, sigs)
        np.testing.assert_array_equal(bits, base)
        got[pkg] = _metrics(pkg)
    assert got["port"] == got["jax"]


def test_breaker_opens_backs_off_and_recloses(monkeypatch, stub_jax,
                                              stub_port):
    """Consecutive device faults open the breaker (everything on the
    host, no launches), the open interval backs off, a probe after the
    deadline re-closes it, and the bitmap is host-exact at every step —
    with the same transitions and counters in both packages."""
    pubs, msgs, sigs = _mixed_batch()
    base = _host_baseline(pubs, msgs, sigs, monkeypatch)
    seen = {}
    for pkg in PKGS:
        d, f = PKGS[pkg][1], PKGS[pkg][3]
        clk_t = [0.0]
        rt = _configure(pkg, clk=lambda: clk_t[0], failure_threshold=2)
        trans = []
        rt.breaker.add_listener(lambda o, n, r: trans.append((o, n)))
        launches = lambda: rt.metrics.device_launches.value(  # noqa: E731
            site="batch.ed25519")
        steps = []
        f.set_mode("ops.ed25519.verify_batch", "raise")
        for _ in range(2):
            np.testing.assert_array_equal(
                _verify(pkg, pubs, msgs, sigs)[1], base)
        steps.append((rt.breaker.state, launches()))
        # open: host-routed, no new device launch
        np.testing.assert_array_equal(_verify(pkg, pubs, msgs, sigs)[1],
                                      base)
        steps.append((rt.breaker.state, launches()))
        clk_t[0] = 9.9      # before the backoff deadline
        _verify(pkg, pubs, msgs, sigs)
        steps.append((rt.breaker.state, launches()))
        f.clear()
        clk_t[0] = 10.1     # healthy again, deadline passed: the probe
        np.testing.assert_array_equal(_verify(pkg, pubs, msgs, sigs)[1],
                                      base)
        steps.append((rt.breaker.state, launches()))
        np.testing.assert_array_equal(_verify(pkg, pubs, msgs, sigs)[1],
                                      base)
        steps.append((rt.breaker.state, launches()))
        seen[pkg] = (steps, trans, _metrics(pkg))
        assert steps == [(d.OPEN, 2), (d.OPEN, 2), (d.OPEN, 2),
                         (d.CLOSED, 3), (d.CLOSED, 4)]
        assert rt.metrics.host_fallbacks.value(
            site="batch.ed25519", reason="breaker_open") == 2
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("form", ["matrix", "list"])
def test_chaos_sweep_bulk_seam(monkeypatch, stub_jax, stub_port, form):
    """The same sweep through verify_sigs_bulk (the whole-commit path,
    as the raw pubkey matrix and as PubKeys): every injected class
    yields the host-exact bitmap, with the same failure class and
    fallback in both packages."""
    pubs, msgs, sigs = _mixed_batch(n=16, bad=(2, 9))
    mat = np.stack([np.frombuffer(p, np.uint8) for p in pubs])

    def bulk(pkg):
        keys = PKGS[pkg][2]
        p = mat if form == "matrix" else [keys.PubKey(x) for x in pubs]
        return PKGS[pkg][0].verify_sigs_bulk(p, msgs, sigs, tpu_threshold=4)

    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    base = {pkg: bulk(pkg) for pkg in PKGS}
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH")
    np.testing.assert_array_equal(base["jax"], base["port"])
    assert base["port"].sum() == 14
    for site, mode, reason in (
            (None, None, None),
            ("ops.ed25519.verify_batch", "raise", "raise"),
            ("bulk.ed25519", "raise", "raise"),
            ("bulk.ed25519", "corrupt-bitmap", "integrity")):
        got = {}
        for pkg in PKGS:
            f = PKGS[pkg][3]
            f.reset()
            rt = _configure(pkg)
            if site:
                f.set_mode(site, mode)
            bits = bulk(pkg)
            np.testing.assert_array_equal(bits, base["port"])
            if site:
                assert f.fired(site, mode) >= 1
            if reason:
                assert rt.metrics.host_fallbacks.value(
                    site="bulk.ed25519", reason=reason) == 1
            got[pkg] = _metrics(pkg)
        assert got["port"] == got["jax"], (site, mode)


def test_concurrent_callers_share_the_lane(stub_port):
    """Twelve threads verify through the one lane worker at once (with a
    short thread switch interval): every bitmap is exact, and the
    runtime counts every launch once and no failure."""
    import sys
    import threading

    pubs, msgs, sigs = _mixed_batch(n=16, bad=(2, 9))
    keys = [tkeys.PubKey(p) for p in pubs]
    want = np.array([i not in (2, 9) for i in range(16)])
    rt = _configure("port")
    results, errors = [], []

    def caller():
        try:
            for _ in range(5):
                results.append(tbatch.verify_sigs_bulk(keys, msgs, sigs,
                                                       tpu_threshold=4))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller) for _ in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(results) == 60
    assert all(np.array_equal(r, want) for r in results)
    m = rt.metrics
    assert m.device_launches.value(site="bulk.ed25519") == 60
    assert m.device_launch_seconds.count(site="bulk.ed25519") == 60
    assert m.device_failures.render() == [f"{m.device_failures.name} 0"]
    assert rt.breaker.state == tdeg.CLOSED


def _lane_batch():
    """Eight secp256k1 and eight sr25519 triples (a bad one in each),
    interleaved, as (PubKey-class, pub, msg, sig) rows per package."""
    from tendermint_tpu_torch.crypto import secp256k1 as tsecp
    from tendermint_tpu_torch.crypto import sr25519 as tsr
    rows = []
    for i in range(8):
        k = tsecp.PrivKey.gen_from_secret(b"chaos secp %d" % i)
        m = b"chaos secp msg %d" % i
        s = k.sign(m)
        if i == 5:
            s = bytes([s[0] ^ 1]) + s[1:]
        rows.append(("secp256k1", k.pub_key().bytes(), m, s))
        mini = (0xC0 + i).to_bytes(32, "little")
        m = b"chaos sr msg %d" % i
        s = tsr.sign(mini, m)
        if i == 2:
            s = s[:40] + bytes([s[40] ^ 1]) + s[41:]
        rows.append(("sr25519", tsr.PrivKey(mini).pub_key().bytes(), m, s))
    return rows


def _verify_lanes(pkg, rows):
    from importlib import import_module
    b = PKGS[pkg][0]
    root = "tendermint_tpu" if pkg == "jax" else "tendermint_tpu_torch"
    bv = b.BatchVerifier(tpu_threshold=4)
    for scheme, p, m, s in rows:
        bv.add(import_module(f"{root}.crypto.{scheme}").PubKey(p), m, s)
    return bv.verify()


@pytest.mark.parametrize("sites", [
    ("ops.secp.verify_batch", "ops.sr25519.verify_batch"),
    ("batch.secp256k1", "batch.sr25519")], ids=["ops-seams", "lane-sites"])
def test_chaos_at_the_secp256k1_and_sr25519_sites(monkeypatch, sites):
    """A raise at the new lanes' seams (ops.secp/ops.sr25519.verify_batch,
    before any staging or launch) or at their runtime sites
    (batch.secp256k1, batch.sr25519) in a drill: both packages re-verify
    on the host with the host lanes' exact bitmap, and count the same
    failures, fallbacks and launches per site."""
    rows = _lane_batch()
    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    try:
        base = {pkg: _verify_lanes(pkg, rows)[1] for pkg in PKGS}
    finally:
        monkeypatch.delenv("TM_TPU_DISABLE_BATCH")
    np.testing.assert_array_equal(base["jax"], base["port"])
    assert base["port"].sum() == len(rows) - 2
    got = {}
    for pkg in PKGS:
        rt = _configure(pkg)
        f = PKGS[pkg][3]
        for site in sites:
            f.set_mode(site, "raise")
        ok, bits = _verify_lanes(pkg, rows)
        np.testing.assert_array_equal(bits, base["port"])
        assert not ok
        for site, scheme in zip(sites, ("secp256k1", "sr25519")):
            assert f.fired(site, "raise") == 1
            assert rt.metrics.host_fallbacks.value(
                site=f"batch.{scheme}", reason="raise") == 1
        got[pkg] = _metrics(pkg)
        # a wall-clock ratio of the lanes, not a count
        got[pkg].pop("chaos_crypto_lane_overlap_ratio")
    assert got["port"] == got["jax"]
