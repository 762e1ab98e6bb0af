"""The port's local data plane (parallel/sharding.py: the sharded
verifier, the sharded RLC, the comb and the per-signature routes over the
plane) against the JAX package's, on the CPU.

Each test function of tests/test_multichip.py runs through the port
(test_torch_config.port_twin), and so do the mesh cases of
tests/test_comb.py:712 (test_comb_mesh_identity_8dev, slow),
tests/test_devobs.py:263 (the mesh launch's decomposition and spans) and
tests/test_msm.py:93 (the RLC seam with the plane stubbed out).  The port
runs on a CPU plane of 8 positions (test_torch_mesh_sweep.cpu_plane:
`sharding._local_devices` is 8 CPU devices, as tests/conftest.py gives the
JAX package 8 virtual CPU devices), on the kernels' plain versions; the
JAX side is each test file itself.

What is mapped besides the package path: the compact staging the sharded
verifier takes is the port's (lane-major prepare_batch_compact rows, so
a byte of lane 3 is row 0, column 3; `_example_batch` below), the JAX
device list is the port's positions, and the window-sum comparison of the
sharded RLC runs the port's one-device pipeline (msm._msm_pipeline).
tests/test_multichip.py's test_dryrun_multichip_subprocess_hermetic
drives the JAX package's driver entry (__graft_entry__) and has no twin:
the port's counterpart is chip_smoke.py phase 25.  The compile sentinel of
the devobs case is the JAX package's tool and is left out.  Tolerance:
exact (bitmaps, routes, ledger bytes, window sums as affine points).
"""
from __future__ import annotations

import pytest
import torch

import test_multichip as J
from test_torch_config import call_case, case_names, port_twin
from test_torch_mesh_sweep import _one_torch_thread, cpu_plane  # noqa: F401

from tendermint_tpu_torch.crypto import devobs as tdevobs
from tendermint_tpu_torch.crypto import _edref
from tendermint_tpu_torch.ops import ed25519 as tedops

_WINDOW_SUMS_JAX = '''    from tendermint_tpu.ops import curve as C
    from tendermint_tpu.ops import ed25519 as edops
    from tendermint_tpu.ops import field as F
    import jax.numpy as jnp

    pub_m = edops._to_u8_matrix(pubs, 32)
    r_bytes, zk, z2, zs = msm._stage_rlc(pub_m, msgs, sigs, z=z)
    nb = plane.msm_bucket(n)
    r_p, pub_p, zk_p, z_p = msm._pad_rows(r_bytes, pub_m, zk, z2, nb)
    c = msm._pick_c(nb)
    ws1, ok1, ov1 = msm._msm_core(
        jnp.asarray(r_p), jnp.asarray(pub_p), jnp.asarray(zk_p),
        jnp.asarray(z_p), jnp.asarray(zs), c)
    ws8, ok8, ov8 = plane.msm_window_sums(r_p, pub_p, zk_p, z_p, zs, c)
    assert bool(ok1) and bool(ok8) and not bool(ov1) and not bool(ov8)
    w1, w8 = np.asarray(ws1), np.asarray(ws8)

    def aff(ws, w):
        X = F.limbs_to_int(ws[0, :, w]) % C.P
        Y = F.limbs_to_int(ws[1, :, w]) % C.P
        Z = F.limbs_to_int(ws[2, :, w]) % C.P
        zi = pow(Z, C.P - 2, C.P)
        return (X * zi % C.P, Y * zi % C.P)

    for w in range(w1.shape[2]):
        assert aff(w1, w) == aff(w8, w), w
'''

# the port's window sums are (4, W, 32) canonical bytes of X, Y, Z, T
_WINDOW_SUMS_PORT = '''    from tendermint_tpu.ops import curve as C
    from tendermint_tpu.ops import ed25519 as edops
    import torch

    pub_m = edops._to_u8_matrix(pubs, 32)
    r_bytes, zk, z2, zs = msm._stage_rlc(pub_m, msgs, sigs, z=z)
    nb = plane.msm_bucket(n)
    r_p, pub_p, zk_p, z_p = msm._pad_rows(r_bytes, pub_m, zk, z2, nb)
    c = msm._pick_c(nb)
    ws1, ok1, ov1 = msm._msm_pipeline(*(
        torch.from_numpy(np.array(a, dtype=np.uint8))
        for a in (r_p, pub_p, zk_p, z_p, zs)), c)
    ws8, ok8, ov8 = plane.msm_window_sums(r_p, pub_p, zk_p, z_p, zs, c)
    assert bool(ok1) and bool(ok8) and not bool(ov1) and not bool(ov8)
    w1, w8 = ws1.numpy(), np.asarray(ws8)

    def aff(ws, w):
        X, Y, Z = (int.from_bytes(ws[j, w].tobytes(), "little") % C.P
                   for j in range(3))
        zi = pow(Z, C.P - 2, C.P)
        return (X * zi % C.P, Y * zi % C.P)

    for w in range(w1.shape[1]):
        assert aff(w1, w) == aff(w8, w), w
'''

P = port_twin("test_multichip", replace=[
    ("    import __graft_entry__ as g\n",
     "    import test_torch_multichip as g\n"),
    ("r[3, 0] ^= 1", "r[0, 3] ^= 1"),
    ('jax.devices("cpu")', "sharding._local_devices()"),
    (_WINDOW_SUMS_JAX, _WINDOW_SUMS_PORT),
])
NO_TWIN = ("test_dryrun_multichip_subprocess_hermetic",)
CASES = [c for c in case_names(J) if c not in NO_TWIN]


def _example_batch(n: int):
    """__graft_entry__._example_batch's batch (the same seeds and
    messages) staged for the port's sharded verifier:
    ops/ed25519.prepare_batch_compact's lane-major rows."""
    seeds = [i.to_bytes(32, "little") for i in range(1, n + 1)]
    msgs = [b"graft-entry message %d" % i for i in range(n)]
    pubs = [_edref.pubkey_from_seed(s) for s in seeds]
    sigs = [_edref.sign(s, m) for s, m in zip(seeds, msgs)]
    dev, host_ok = tedops.prepare_batch_compact(pubs, sigs, msgs)
    assert host_ok.all()
    return {k: v.copy() for k, v in dev.items()}


def _marks(fn):
    return [m.name for m in getattr(fn, "pytestmark", [])]


def test_the_cases_are_the_reference_ones():
    assert len(CASES) == 6
    assert [c for c in case_names(P) if c not in NO_TWIN] == CASES


@pytest.mark.parametrize("case", CASES)
def test_multichip_case(case, monkeypatch):
    """One case of tests/test_multichip.py through the port."""
    assert "slow" not in _marks(getattr(J, case))
    call_case(getattr(P, case), monkeypatch=monkeypatch)


@pytest.mark.slow
def test_comb_mesh_identity_8dev(monkeypatch):
    """tests/test_comb.py:712 through the port: the comb on the 8-position
    plane (tables copied to every position), bitmap identical to the
    single-device comb and the ladder, unaligned batch size included."""
    m = port_twin("test_comb", "test_comb_mesh_identity_8dev", replace=[(
        'for n in ("dbl", "dbl_no_t", "add_cached", "madd_niels")}',
        'for n in ("dbl", "add_cached", "madd_niels")}')])
    it = m._comb_state()
    next(it)
    try:
        m.test_comb_mesh_identity_8dev()
    finally:
        for _ in it:
            pass


def test_mesh_decomposition_sums_to_wall_and_agrees_with_spans():
    """tests/test_devobs.py:263 through the port: the mesh-xla launch
    record of the 8-position plane under the degradation runtime (stage,
    put and drain walls bounded by the wall, chunk_overlap, the all-valid
    bit, one put wall a position, the per-shard rows [8] * 6 + [0, 0],
    nb 64), inside the device.launch and device.collect spans."""
    m = port_twin(
        "test_devobs",
        "test_mesh_decomposition_sums_to_wall_and_agrees_with_spans",
        replace=[
            ("    from tendermint_tpu.devtools.tmlint.runtime import "
             "CompileSentinel\n", ""),
            ("    sentinel = CompileSentinel(max_new_compiles=0).start()\n",
             ""),
            ("        sentinel.check()  # no foreign bucket, no new compile\n",
             ""),
        ])
    it = m._clean()
    next(it)
    try:
        m.test_mesh_decomposition_sums_to_wall_and_agrees_with_spans()
    finally:
        for _ in it:
            pass
    tdevobs.reset()
    tdevobs.enable()


def test_rlc_seam_with_the_plane_stubbed_out(monkeypatch):
    """tests/test_msm.py:93 through the port: with data_plane() stubbed to
    None beside the 8-position plane, an all-valid batch takes the
    single-device RLC route (one vouched call), an invalid one falls back
    to the per-signature route with the exact bitmap."""
    m = port_twin("test_msm", "test_verify_batch_seam_fast_path_and_fallback")
    m.test_verify_batch_seam_fast_path_and_fallback(monkeypatch)
    from tendermint_tpu_torch.ops import msm
    assert msm.last_route()["path"] == "rlc-single"


def test_sharded_window_sums_equal_the_single_device_sums():
    """The window sums of the 8-position MSM against one device's on the
    same staged rows of a 64-row batch, as affine points (c = 4 on both),
    and each position's partial sums added by hand in the same order."""
    import numpy as np

    from tendermint_tpu_torch.ops import curve as C
    from tendermint_tpu_torch.ops import msm
    from tendermint_tpu_torch.parallel import sharding

    plane = sharding.data_plane()
    assert plane is not None and plane.nshard == 8
    pubs, msgs, sigs = J._rlc_batch(60, tag=b"sums")
    z = J._fixed_z(60)
    pub_m = tedops._to_u8_matrix(pubs, 32)
    r_bytes, zk, z2, zs = msm._stage_rlc(pub_m, msgs, sigs, z=z)
    r_p, pub_p, zk_p, z_p = msm._pad_rows(r_bytes, pub_m, zk, z2, 64)
    one, ok1, ov1 = msm._msm_pipeline(*(
        torch.from_numpy(np.array(a, dtype=np.uint8))
        for a in (r_p, pub_p, zk_p, z_p, zs)), 4)
    ws8, ok8, ov8 = plane.msm_window_sums(r_p, pub_p, zk_p, z_p, zs, 4)
    assert bool(ok1) and ok8 and not bool(ov1) and not ov8

    def aff(p):
        zi = pow(p[2], C.P - 2, C.P)
        return (p[0] * zi % C.P, p[1] * zi % C.P)

    a = [aff(p) for p in sharding._window_points(one.numpy())]
    b = [aff(p) for p in sharding._window_points(ws8)]
    assert a == b
