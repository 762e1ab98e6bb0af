"""The port's degradation runtime (tendermint_tpu_torch/crypto/degrade.py)
against the JAX package's: each scenario of tests/test_degrade.py is
played through both packages' degrade and fail modules with the same
injected clock, DegradeConfig (zero jitter) and a private metrics
registry each, and the outcomes are compared exactly — the returned
bitmaps and breaker states, the breaker transitions seen by a listener,
the injection hit counts and the whole Prometheus exposition of the
runtime's CryptoMetrics.

The backend probe is the port's own rule (it probes torch, and CUDA
missing without a request for the CPU raises), and a kernel build
failure raises to the caller without being counted as a device fault.
"""
from __future__ import annotations

import sys
import threading
import types

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import degrade as jdeg
from tendermint_tpu.libs import fail as jfail
from tendermint_tpu.libs.metrics import Registry as JRegistry

import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import degrade as tdeg
from tendermint_tpu_torch.crypto import ed25519 as tkeys
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs.metrics import Registry as TRegistry
from tendermint_tpu_torch.ops import cuda_comb as ccomb
from tendermint_tpu_torch.ops import cuda_ed25519 as ck

JAX = types.SimpleNamespace(name="jax", degrade=jdeg, fail=jfail,
                            Registry=JRegistry)
PORT = types.SimpleNamespace(name="port", degrade=tdeg, fail=tfail,
                             Registry=TRegistry)


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (JAX, PORT):
        pkg.fail.reset()
    yield
    for pkg in (JAX, PORT):
        pkg.fail.reset()
        pkg.degrade.reset()


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cfg(pkg, **kw):
    base = dict(failure_threshold=3, launch_timeout_s=5.0,
                backoff_base_s=10.0, backoff_max_s=100.0,
                backoff_jitter=0.0)
    base.update(kw)
    return pkg.degrade.DegradeConfig(**base)


def _runtime(pkg, clk=None, **kw):
    return pkg.degrade.DeviceLaneRuntime(
        _cfg(pkg, **kw), clock=clk or Clock(),
        registry=pkg.Registry("t"))


def _both(scenario):
    """Play `scenario(pkg)` through both packages; the observations must
    be equal.  Returns the port's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


# -- the breaker ------------------------------------------------------------

def _breaker_consecutive(pkg):
    clk = Clock()
    br = pkg.degrade.CircuitBreaker(_cfg(pkg), clock=clk)
    obs = []
    for _ in range(2):
        obs.append(br.try_acquire())
        br.record_failure("x")
    obs.append(br.state)
    obs.append(br.try_acquire())
    br.record_success()    # a success resets the consecutive count
    for _ in range(3):
        obs.append(br.try_acquire())
        br.record_failure("x")
        obs.append(br.state)
    obs.append(br.try_acquire())
    return obs


def _breaker_backoff(pkg):
    clk = Clock()
    trans = []
    br = pkg.degrade.CircuitBreaker(_cfg(pkg, failure_threshold=1),
                                    clock=clk)
    br.add_listener(lambda o, n, r: trans.append((o, n, r)))
    obs = [br.try_acquire()]
    br.record_failure("boom")
    for t, then_fail in ((9.9, None), (10.1, "still down"),
                         (10.1 + 19.9, None), (10.1 + 20.1, False)):
        clk.t = t
        obs.append((t, br.try_acquire(), br.state, br.try_acquire()))
        if then_fail:
            br.record_failure(then_fail)
        elif then_fail is False:
            br.record_success()
        obs.append(br.state)
    # the backoff resets after the re-close: the next open waits base_s
    obs.append(br.try_acquire())
    br.record_failure("y")
    t_open = clk.t
    clk.t = t_open + 9.9
    obs.append(br.try_acquire())
    clk.t = t_open + 10.1
    obs.append(br.try_acquire())
    return obs, trans, br.opened_total


def _breaker_cap(pkg):
    clk = Clock()
    br = pkg.degrade.CircuitBreaker(
        _cfg(pkg, failure_threshold=1, backoff_base_s=40.0,
             backoff_max_s=60.0), clock=clk)
    obs = [br.try_acquire()]
    br.record_failure("a")
    clk.t += 40.1
    obs.append(br.try_acquire())   # probe
    br.record_failure("b")          # doubles to min(80, 60) = 60
    t0 = clk.t
    for dt in (59.9, 60.1):
        clk.t = t0 + dt
        obs.append(br.try_acquire())
    return obs


def _listener(pkg):
    br = pkg.degrade.CircuitBreaker(_cfg(pkg, failure_threshold=1),
                                    clock=Clock())
    got = []
    unsub = br.add_listener(lambda o, n, r: got.append(n))
    br.try_acquire()
    br.record_failure("x")
    seen = list(got)
    unsub()
    br.record_success()
    return seen, got, br.state


@pytest.mark.parametrize("scenario", [
    _breaker_consecutive, _breaker_backoff, _breaker_cap, _listener],
    ids=["consecutive", "backoff-reclose", "backoff-cap", "listener"])
def test_breaker_matches_reference(scenario):
    _both(scenario)


def test_breaker_transitions_of_the_backoff_scenario():
    """The transition sequence itself, beside its equality with the JAX
    package's: open, half-open, re-open, half-open, close, open."""
    _, trans, opened = _both(_breaker_backoff)
    c, h, o = tdeg.CLOSED, tdeg.HALF_OPEN, tdeg.OPEN
    assert [(a, b) for a, b, _ in trans] == [
        (c, o), (o, h), (h, o), (o, h), (h, c), (c, o), (o, h)]
    assert opened == 3


# -- the runtime ------------------------------------------------------------

def _run_outcomes(pkg):
    rt = _runtime(pkg, failure_threshold=2)
    obs = [rt.run("site", lambda: np.array([True, True]),
                  host_fn=lambda: np.array([False, False])).tolist()]
    host = np.array([True, False])
    for _ in range(2):
        obs.append(rt.run("site", lambda: 1 / 0,
                          host_fn=lambda: host).tolist())
    obs.append(rt.breaker.state)
    # breaker open: host_fn without a device attempt
    obs.append(rt.run("site", lambda: np.array([True, True]),
                      host_fn=lambda: host).tolist())
    return obs, rt.metrics.device_launches.value(site="site"), \
        rt.metrics.host_fallbacks.value(site="site",
                                        reason="breaker_open")


def _submit_collect(pkg):
    """The overlapped shape BatchVerifier uses: submit two launches,
    collect both (one ok, one integrity failure)."""
    rt = _runtime(pkg, failure_threshold=10)
    f1 = rt.submit("site", lambda: np.array([True, False]))
    f2 = rt.submit("site", lambda n: np.zeros(n, dtype=bool), 3)
    a = rt.collect("site", f1, host_fn=lambda: np.array([False, False]),
                   spot_check=lambda bits: not bits[1])
    b = rt.collect("site", f2, host_fn=lambda: np.ones(3, dtype=bool),
                   spot_check=lambda bits: bool(bits[0]))
    return a.tolist(), b.tolist(), rt.breaker.state


def _timeout(pkg):
    rt = _runtime(pkg, failure_threshold=10, launch_timeout_s=0.05)
    release = threading.Event()

    def wedged():
        release.wait(0.5)
        return np.array([True])

    obs = [rt.run("site", wedged, host_fn=lambda: np.array([True]))
           .tolist()]
    release.set()
    # the wedged worker was quarantined: a fresh launch must NOT queue
    # behind it and must succeed promptly
    rt.cfg.launch_timeout_s = 5.0
    obs.append(rt.run("site", lambda: np.array([False]),
                      host_fn=lambda: np.array([True])).tolist())
    obs.append(rt.breaker.state)
    return obs


def _task_timeouterror(pkg):
    """A TimeoutError raised BY the device fn is a device raise; only an
    expired result-wait is the timeout class."""
    rt = _runtime(pkg, failure_threshold=10)

    def sock_timeout():
        raise TimeoutError("read timed out")

    return rt.run("site", sock_timeout,
                  host_fn=lambda: np.array([True])).tolist()


def _spot_check(pkg):
    rt = _runtime(pkg, failure_threshold=10)
    return rt.run("site", lambda: np.array([False, False]),
                  host_fn=lambda: np.array([True, True]),
                  spot_check=lambda bits: bool(bits[0])).tolist()


def _injection_sites(pkg):
    rt = _runtime(pkg, failure_threshold=10)
    host = np.array([True])
    with pytest.raises(ValueError, match="not registered"):
        pkg.fail.set_mode("site", "raise")
    pkg.fail.register("site")
    pkg.fail.set_mode("site", "raise")
    obs = [rt.run("site", lambda: np.array([False]),
                  host_fn=lambda: host).tolist(),
           pkg.fail.fired("site", "raise")]
    pkg.fail.set_mode("site", "corrupt-bitmap")
    # the device said False, the corruption flips it to True, the spot
    # check expects False: an integrity failure, and the host's result
    obs.append(rt.run("site", lambda: np.array([False]),
                      host_fn=lambda: host,
                      spot_check=lambda bits: not bits[0]).tolist())
    obs.append(pkg.fail.fired("site", "corrupt-bitmap"))
    return obs


def _spot_check_off(pkg):
    """TM_TPU_SPOT_CHECK=0 (spot_check=False): a wrong bitmap is
    trusted."""
    rt = _runtime(pkg, failure_threshold=10, spot_check=False)
    return rt.run("site", lambda: np.array([False, False]),
                  host_fn=lambda: np.array([True, True]),
                  spot_check=lambda bits: bool(bits[0])).tolist()


@pytest.mark.parametrize("scenario", [
    _run_outcomes, _submit_collect, _timeout, _task_timeouterror,
    _spot_check, _injection_sites, _spot_check_off],
    ids=["run", "submit-collect", "timeout-quarantine",
         "task-timeouterror", "spot-check", "injection-sites",
         "spot-check-off"])
def test_runtime_matches_reference(scenario):
    """Bitmaps, breaker state and injection counts, then every metric of
    the runtime's registry (failure classes, fallbacks, launches, breaker
    gauge and transitions, launch-seconds histogram on the injected
    clock), as exposition text."""
    texts = {}

    def play(pkg):
        reg = {}
        orig = pkg.Registry

        def registry(ns):
            reg["r"] = orig(ns)
            return reg["r"]
        saved, pkg.Registry = pkg.Registry, registry
        try:
            out = scenario(pkg)
        finally:
            pkg.Registry = saved
        texts[pkg.name] = reg["r"].render_text()
        return out
    _both(play)
    assert texts["port"] == texts["jax"]
    assert "crypto_device_launch_total" in texts["port"]


def test_timeout_counts_the_timeout_class():
    rt = _runtime(PORT, failure_threshold=10, launch_timeout_s=0.05)
    release = threading.Event()
    rt.run("site", lambda: release.wait(0.5),
           host_fn=lambda: np.array([True]))
    release.set()
    assert rt.metrics.device_failures.value(site="site",
                                            reason="timeout") == 1
    assert rt.metrics.host_fallbacks.value(site="site",
                                           reason="timeout") == 1


# -- env knobs --------------------------------------------------------------

def _env_failpoints(pkg, monkeypatch):
    obs = []
    monkeypatch.setenv("TM_TPU_FAILPOINTS", "a.typo=raise")
    with pytest.raises(ValueError, match="not registered"):
        pkg.fail.inject("anything.at.all")
    pkg.fail.register("a.site")
    pkg.fail.register("b.site")
    monkeypatch.setenv("TM_TPU_FAILPOINTS",
                       "a.site=raise; b.site=latency:1")
    with pytest.raises(pkg.fail.InjectedFault):
        pkg.fail.inject("a.site")
    pkg.fail.inject("b.site")
    pkg.fail.inject("c.site")  # unarmed: no-op
    obs.append([pkg.fail.fired(s, m) for s, m in (
        ("a.site", "raise"), ("b.site", "latency:1"),
        ("c.site", "raise"))])
    # programmatic arming wins and the wildcard matches
    pkg.fail.set_mode("*", "raise")
    with pytest.raises(pkg.fail.InjectedFault):
        pkg.fail.inject("c.site")
    obs.append(pkg.fail.fired("c.site", "raise"))
    pkg.fail.clear()
    monkeypatch.delenv("TM_TPU_FAILPOINTS")
    return obs


def test_env_failpoints_match_reference(monkeypatch):
    _both(lambda pkg: _env_failpoints(pkg, monkeypatch))


def test_degrade_config_from_env_matches_reference(monkeypatch):
    for k, v in (("TM_TPU_BREAKER_THRESHOLD", "5"),
                 ("TM_TPU_DEVICE_TIMEOUT_S", "0.75"),
                 ("TM_TPU_BREAKER_BACKOFF_S", "2.5"),
                 ("TM_TPU_BREAKER_BACKOFF_MAX_S", "40"),
                 ("TM_TPU_SPOT_CHECK", "0")):
        monkeypatch.setenv(k, v)
    cfg = _both(lambda pkg: vars(pkg.degrade.DegradeConfig.from_env()))
    assert cfg == dict(failure_threshold=5, launch_timeout_s=0.75,
                       backoff_base_s=2.5, backoff_max_s=40.0,
                       backoff_jitter=0.2, spot_check=False)


def test_configure_reset_and_runtime_if_installed():
    def play(pkg):
        d = pkg.degrade
        d.reset()
        obs = [d.runtime_if_installed() is None]
        rt = d.configure(_cfg(pkg), clock=Clock(),
                         registry=pkg.Registry("c"))
        obs += [d.runtime() is rt, d.runtime_if_installed() is rt]
        d.reset()
        obs.append(d.runtime_if_installed() is None)
        return obs
    assert _both(play) == [True, True, True, True]


# -- the backend probe: the port's own rule ---------------------------------

def test_backend_probe_backoff_matches_reference(monkeypatch):
    """An init failure is re-probed after backoff (10 s, then 20 s), a
    live backend is probed once: the port probes torch.cuda where the
    JAX package probes jax.default_backend()."""
    def play(pkg):
        clk = Clock()
        rt = pkg.degrade.DeviceLaneRuntime(_cfg(pkg), clock=clk,
                                           registry=pkg.Registry("b"))
        calls = []

        def probe():
            calls.append(clk.t)
            if len(calls) < 3:
                raise RuntimeError("Unable to initialize backend")
            return True
        with monkeypatch.context() as m:
            if pkg is JAX:
                m.setitem(sys.modules, "jax", types.SimpleNamespace(
                    default_backend=lambda: probe() and "tpu"))
            else:
                m.setattr(torch.cuda, "is_available", probe)
                m.setattr(torch.cuda, "init", lambda: None)
            obs = [rt.backend_available(), rt.backend_available(),
                   len(calls)]
            clk.t = 10.1
            obs += [rt.backend_available(), len(calls)]
            clk.t = 10.1 + 20.1
            obs += [rt.backend_available(), len(calls)]
            clk.t += 1000
            obs += [rt.backend_available(), len(calls)]
        return obs, [rt.metrics.backend_probes.value(result=r)
                     for r in ("error", "accelerator", "cpu")]
    obs, probes = _both(play)
    assert obs == [False, False, 1, False, 2, True, 3, True, 3]
    assert probes == [2, 1, 0]


def _pairs(n=40):
    privs = [tkeys.PrivKey(bytes([i + 1]) * 32) for i in range(n)]
    msgs = [b"degrade %d" % i for i in range(n)]
    return privs, msgs, [p.sign(m) for p, m in zip(privs, msgs)]


def test_cuda_missing_raises_not_host(monkeypatch):
    """No CUDA and no request for the CPU: BatchVerifier and
    verify_sigs_bulk raise — also under TM_TPU_FORCE_BATCH — instead of
    re-verifying on the host, and nothing reaches the runtime's
    counters.  Asking for the CPU, or TM_TPU_DISABLE_BATCH=1, takes the
    host lanes."""
    rt = tdeg.configure(_cfg(PORT), clock=Clock(),
                        registry=TRegistry("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(T, "_default_device", "cuda")
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    privs, msgs, sigs = _pairs()
    mat = np.stack([np.frombuffer(p.pub_key().bytes(), np.uint8)
                    for p in privs])
    for force in ("0", "1"):
        monkeypatch.setenv("TM_TPU_FORCE_BATCH", force)
        bv = tbatch.BatchVerifier()
        for p, m, s in zip(privs, msgs, sigs):
            bv.add(p.pub_key(), m, s)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bv.verify()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbatch.verify_sigs_bulk(mat, msgs, sigs)
    text = rt.metrics.host_fallbacks.render() + \
        rt.metrics.device_launches.render()
    assert all(line.endswith(" 0") for line in text), text
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "0")
    assert tbatch.verify_sigs_bulk(mat, msgs, sigs, device="cpu").all()
    monkeypatch.setenv("TM_TPU_DISABLE_BATCH", "1")
    assert tbatch.verify_sigs_bulk(mat, msgs, sigs).all()
    assert rt.metrics.device_launches.value(site="bulk.ed25519") == 0


def test_failed_cuda_init_raises(monkeypatch):
    """CUDA reported, but its initialisation raises: the probe counts an
    error and the batch raises instead of taking the host lanes."""
    rt = tdeg.configure(_cfg(PORT), clock=Clock(),
                        registry=TRegistry("init"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def broken():
        raise RuntimeError("cudaErrorInitializationError")
    monkeypatch.setattr(torch.cuda, "init", broken)
    monkeypatch.delenv("TM_TPU_FORCE_BATCH", raising=False)
    monkeypatch.delenv("TM_TPU_DISABLE_BATCH", raising=False)
    privs, msgs, sigs = _pairs()
    with pytest.raises(RuntimeError, match="failed to initialise"):
        tbatch.verify_sigs_bulk([p.pub_key() for p in privs], msgs, sigs,
                                device="cuda")
    assert rt.metrics.backend_probes.value(result="error") == 1
    assert rt.metrics.host_fallbacks.value(site="bulk.ed25519",
                                           reason="raise") == 0


@pytest.mark.parametrize("entry", ["batch", "bulk"])
def test_kernel_build_failure_raises_to_caller(monkeypatch, entry):
    """The kernels are built on the caller's thread before the breaker is
    asked: an nvcc failure raises out of the entry point, the runtime
    counts no launch, no failure and no host fallback, and the breaker
    stays closed."""
    rt = tdeg.configure(_cfg(PORT), clock=Clock(),
                        registry=TRegistry("build"))
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    monkeypatch.setattr(tbatch, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))

    def nvcc_failed():
        raise RuntimeError("nvcc: ed25519_verify.cu did not build")
    monkeypatch.setattr(ck, "kernels", nvcc_failed)
    privs, msgs, sigs = _pairs()
    with pytest.raises(RuntimeError, match="did not build"):
        if entry == "batch":
            bv = tbatch.BatchVerifier()
            for p, m, s in zip(privs, msgs, sigs):
                bv.add(p.pub_key(), m, s)
            bv.verify()
        else:
            tbatch.verify_sigs_bulk([p.pub_key() for p in privs], msgs,
                                    sigs)
    for metric in (rt.metrics.device_launches, rt.metrics.device_failures,
                   rt.metrics.host_fallbacks):
        assert metric.render() == [f"{metric.name} 0"]
    assert rt.breaker.state == tdeg.CLOSED


# -- the card: no host re-verify outside a chaos drill ---------------------

def _card_failure(rt, reason):
    """One settled launch on a card lane (on_card=True) that fails with
    `reason`; returns what run() returned and how often host_fn ran."""
    hosted = []

    def host_fn():
        hosted.append(1)
        return np.array([True, False])
    ok = np.array([True, False])
    if reason == "raise":
        def device_fn():
            raise RuntimeError("cudaErrorLaunchFailure")
    elif reason == "timeout":
        ev = threading.Event()

        def device_fn():
            ev.wait(0.5)
            return ok
    else:
        def device_fn():
            return ok
    if reason == "breaker_open":
        rt.breaker.record_failure("opened for the test")
    out = rt.run("bulk.ed25519", device_fn, host_fn,
                 spot_check=(lambda bits: False) if reason == "integrity"
                 else None, on_card=True)
    return out, len(hosted)


@pytest.mark.parametrize("reason",
                         ["raise", "timeout", "integrity", "breaker_open"])
def test_card_lane_raises_outside_a_drill(reason):
    """On the card a failed launch, a missed deadline, a refuted bitmap
    and an open breaker raise DeviceLaneError to the caller; the failure
    is counted, no host fallback is, and host_fn never runs."""
    rt = _runtime(PORT, failure_threshold=1, launch_timeout_s=0.05)
    with pytest.raises(tdeg.DeviceLaneError, match=reason):
        _card_failure(rt, reason)
    counted = 0 if reason == "breaker_open" else 1
    assert rt.metrics.device_failures.value(site="bulk.ed25519",
                                            reason=reason) == counted
    assert rt.metrics.host_fallbacks.render() == \
        [f"{rt.metrics.host_fallbacks.name} 0"]
    assert rt.breaker.state == tdeg.OPEN


@pytest.mark.parametrize("reason",
                         ["raise", "timeout", "integrity", "breaker_open"])
def test_card_lane_falls_back_in_a_drill(reason):
    """With a failpoint armed (a chaos drill), the card lane degrades as
    the JAX package does: the host's bitmap, one fallback counted."""
    rt = _runtime(PORT, failure_threshold=1, launch_timeout_s=0.05)
    tfail.register("drill.elsewhere")
    tfail.set_mode("drill.elsewhere", "raise")
    out, hosted = _card_failure(rt, reason)
    assert out.tolist() == [True, False] and hosted == 1
    assert rt.metrics.host_fallbacks.value(site="bulk.ed25519",
                                           reason=reason) == 1


def test_armed_reads_modes_and_env(monkeypatch):
    monkeypatch.delenv("TM_TPU_FAILPOINTS", raising=False)
    assert not tfail.armed()
    tfail.set_mode("bulk.ed25519", "latency:1")
    assert tfail.armed()
    tfail.clear()
    monkeypatch.setenv("TM_TPU_FAILPOINTS", " ; bulk.ed25519= ")
    assert not tfail.armed()
    monkeypatch.setenv("TM_TPU_FAILPOINTS", "bulk.ed25519=raise")
    assert tfail.armed()


@pytest.mark.parametrize("entry", ["batch", "bulk"])
def test_card_entry_points_raise_a_launch_fault(monkeypatch, entry):
    """Through the entry points: a launch fault on a CUDA lane raises out
    of BatchVerifier.verify / verify_sigs_bulk with no host fallback;
    in a drill the same fault returns the host's exact bitmap."""
    rt = tdeg.configure(_cfg(PORT), clock=Clock(),
                        registry=TRegistry("card"))
    monkeypatch.setenv("TM_TPU_FORCE_BATCH", "1")
    monkeypatch.setattr(tbatch, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    for mod in (ck, ccomb):
        monkeypatch.setattr(mod, "kernels", lambda: None)

    def launch_failed(*args, **kwargs):
        assert kwargs["device"] == torch.device("cuda", 0)
        raise RuntimeError("cudaErrorLaunchFailure")
    monkeypatch.setattr(tbatch, "verify_ed25519_batch", launch_failed)
    privs, msgs, sigs = _pairs()
    sigs[7] = sigs[7][:-1] + bytes([sigs[7][-1] ^ 1])

    def call():
        if entry == "batch":
            bv = tbatch.BatchVerifier()
            for p, m, s in zip(privs, msgs, sigs):
                bv.add(p.pub_key(), m, s)
            return bv.verify()[1]
        return tbatch.verify_sigs_bulk([p.pub_key() for p in privs], msgs,
                                       sigs)
    site = f"{entry}.ed25519"
    with pytest.raises(tdeg.DeviceLaneError, match="cudaErrorLaunch|raise"):
        call()
    assert rt.metrics.device_failures.value(site=site, reason="raise") == 1
    assert rt.metrics.host_fallbacks.value(site=site, reason="raise") == 0
    tfail.register("drill.elsewhere")
    tfail.set_mode("drill.elsewhere", "raise")
    bits = call()
    assert bits.tolist() == [i != 7 for i in range(len(privs))]
    assert rt.metrics.host_fallbacks.value(site=site, reason="raise") == 1


def test_spot_check_prepared_before_the_wait():
    """collect() takes the spot check's host verdict (prepare) before it
    waits for the launch: a launch that can only finish once prepare has
    run still meets its deadline, and the bitmap call compares the one
    prepared lane without verifying again."""
    rt = _runtime(PORT, launch_timeout_s=2.0)
    ev = threading.Event()
    order = []

    class Spot:
        def prepare(self):
            order.append("prepare")
            ev.set()

        def __call__(self, bits):
            order.append("check")
            return True

    def device_fn():
        assert ev.wait(1.0), "prepare did not run before the wait"
        return np.ones(3, dtype=bool)
    out = rt.run("bulk.ed25519", device_fn, lambda: np.zeros(3, bool),
                 spot_check=Spot(), on_card=True)
    assert out.tolist() == [True] * 3 and order == ["prepare", "check"]


def test_spot_check_verifies_one_lane():
    """The spot check re-verifies one random lane on the host, once
    (prepare is idempotent), and compares its bit; a bitmap of the wrong
    length never passes."""
    privs, msgs, sigs = _pairs(4)
    pubs = [p.pub_key() for p in privs]
    calls = []
    real = tkeys.PubKey.verify_signature

    def counted(self, m, s):
        calls.append(1)
        return real(self, m, s)
    tkeys.PubKey.verify_signature = counted
    try:
        sc = tbatch._spot_check_bulk(pubs, msgs, sigs)
        sc.prepare()
        sc.prepare()
        assert sc(np.ones(4, dtype=bool)) and len(calls) == 1
        assert not sc(np.zeros(4, dtype=bool)) and len(calls) == 1
        assert not sc(np.ones(3, dtype=bool))
        assert not tbatch._spot_check_bulk(pubs, msgs, sigs)(
            np.zeros(4, dtype=bool)) and len(calls) == 2
    finally:
        tkeys.PubKey.verify_signature = real
    assert tbatch._spot_check_bulk([], [], [])(np.zeros(0, dtype=bool))
