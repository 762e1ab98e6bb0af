"""The port's overlapped data plane (parallel/sharding.py) against the JAX
package's, on the CPU: every case of tests/test_mesh_sweep.py run through
the port (test_torch_config.port_twin), on a CPU plane of 8 positions
(`make_mesh([cpu] * 8)`, the plain versions of the kernels), plus the
host-side arithmetic and the latch transitions of both packages compared
value for value.

The package path is mapped, and the JAX runtime's seams are the port's:
jax.process_count -> sharding._world_size, jax.local_devices() ->
sharding._local_devices() (the fixture below makes it 8 CPU positions, as
tests/conftest.py makes JAX 8 virtual CPU devices), the coordination
client's key-value calls -> the c10d store's set / check / delete_key /
wait, the single-device XLA ladder stub -> a stub of K1's wrapper
(whose launches pad to TILE lanes), and comb table operands built as the
port's plain Cached tables.  The JAX tests that are slow are slow here.
Tolerance: exact everywhere (bitmaps, routes, ledger bytes, chunk
arithmetic, latch transitions).
"""
from __future__ import annotations

import pytest
import torch

import test_mesh_sweep as J
from test_torch_config import case_names, call_case, port_twin

from tendermint_tpu.crypto import devobs as jdevobs
from tendermint_tpu.ops import ed25519 as jedops
from tendermint_tpu.parallel import sharding as jsharding
import tendermint_tpu_torch as T
from tendermint_tpu_torch.crypto import degrade as tdegrade
from tendermint_tpu_torch.crypto import devobs as tdevobs
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.ops import ed25519 as tedops
from tendermint_tpu_torch.parallel import sharding as tsharding

CPU = torch.device("cpu")

_FAKE_COORD_JAX = '''    def key_value_set(self, key, val):
        self.kv[key] = val

    def key_value_dir_get(self, d):
        return [(k, v) for k, v in sorted(self.kv.items())
                if k.startswith(d)]

    def key_value_delete(self, key):
        pref = key.rstrip("/")
        for k in [k for k in self.kv if k.startswith(pref)]:
            del self.kv[k]

    def wait_at_barrier(self, name, timeout_ms):
        if self.barrier_error is not None:
            raise self.barrier_error
        self.barriers.append(name)
'''

_FAKE_COORD_PORT = '''    def set(self, key, val):
        self.kv[key] = val

    def check(self, keys):
        return all(k in self.kv for k in keys)

    def delete_key(self, key):
        return self.kv.pop(key, None) is not None

    def wait(self, keys, timeout):
        if self.barrier_error is not None:
            raise self.barrier_error
        self.barriers.append(keys[0].rsplit("/", 2)[0])
'''

_LADDER_STUB_JAX = '''    def _ladder_stub(**arrs):
        hit["nb"] = int(next(iter(arrs.values())).shape[0])
        return edops.jnp.asarray(
            np.pad(truth, (0, hit["nb"] - len(truth))))

    monkeypatch.setattr(edops, "verify_kernel", _ladder_stub)'''

_LADDER_STUB_PORT = '''    def _ladder_stub(packed):
        hit["nb"] = int(packed.shape[1])
        return edops.torch.from_numpy(
            np.pad(truth, (0, hit["nb"] - len(truth))))

    monkeypatch.setattr(edops.ck, "verify_packed", _ladder_stub)'''

REPLACE = [
    ('mock.patch.object(sharding.jax, "process_count",',
     'mock.patch.object(sharding, "_world_size",'),
    ('monkeypatch.setattr(sharding.jax, "process_count", lambda: 2)',
     'monkeypatch.setattr(sharding, "_world_size", lambda: 2)'),
    ("sharding.jax.local_devices()", "sharding._local_devices()"),
    (_FAKE_COORD_JAX, _FAKE_COORD_PORT),
    (_LADDER_STUB_JAX, _LADDER_STUB_PORT),
    ("assert hit[\"nb\"] == edops.bucket_size(13)",
     "assert hit[\"nb\"] == max(edops.TILE, edops.bucket_size(13))"),
    # the port's plain comb tables: Cached int32 fields (64, 9, NLIMB, K)
    ('''    tables = type("T", (), {})()
    for name in ("ypx", "ymx", "z", "t2d"):
        setattr(tables, name, np.zeros((1, 1, 1, k_pad), np.uint32))''',
     '''    tables = edops.C.Cached(*(
        edops.torch.zeros((1, 1, 1, k_pad), dtype=edops.torch.int32)
        for _ in range(4)))'''),
    ("entry.dec_ok = np.ones(k_pad, dtype=bool)",
     "entry.dec_ok = edops.torch.ones(k_pad, dtype=edops.torch.bool)"),
    ("outs.append(plane._comb_repl_operands(entry, base))",
     "outs.append(plane._comb_repl_operands(entry))"),
    # the compile-bucket check is the JAX package's own tool
    ("from tendermint_tpu.devtools.tmlint.runtime import CompileSentinel",
     "CompileSentinel = __import__('importlib').import_module("
     "'tendermint_tpu' + '.devtools.tmlint.runtime').CompileSentinel"),
]

P = port_twin("test_mesh_sweep", replace=REPLACE)
CASES = case_names(J)


def _marks(fn):
    return [m.name for m in getattr(fn, "pytestmark", [])]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_plane(monkeypatch):
    """The port on the CPU with 8 local CPU positions, from a clean mesh
    world: the plane latches, the poison state and the chunk override
    saved and put back, no armed chaos, no comb overrides (process-global
    state leaks across the test files one xdist worker runs)."""
    T.set_default_device("cpu")
    monkeypatch.delenv("TM_TPU_NO_MESH", raising=False)
    monkeypatch.delenv("TM_TPU_NO_GLOBAL_MESH", raising=False)
    monkeypatch.delenv("TM_TPU_FORCE_BATCH", raising=False)
    monkeypatch.setattr(tsharding, "_local_devices", lambda: [CPU] * 8)
    with tsharding._PLANE_LOCK:
        saved = (tsharding._PLANE, tsharding._PLANE_KEY,
                 tsharding._GLOBAL_PLANE)
        tsharding._PLANE = None
        tsharding._PLANE_KEY = None
        tsharding._GLOBAL_PLANE = None
    poison = (tsharding._poison_seen, tsharding._poison_next_check)
    chunk = tsharding._mesh_chunk_override

    def clean():
        tsharding.set_mesh_chunk(None)
        tsharding._poison_seen = False
        tsharding._poison_next_check = 0.0
        tfail.reset()
        tedops._comb_enabled_override = None
        tedops._comb_min_override = None
        tedops._table_budget_override = None

    clean()
    yield
    clean()
    tedops.table_cache_clear()
    with tsharding._PLANE_LOCK:
        (tsharding._PLANE, tsharding._PLANE_KEY,
         tsharding._GLOBAL_PLANE) = saved
    tsharding._poison_seen, tsharding._poison_next_check = poison
    tsharding._mesh_chunk_override = chunk
    tdegrade.reset()
    T.set_default_device("cuda")


def _params():
    out = []
    for case in CASES:
        marks = [pytest.mark.slow] if "slow" in _marks(getattr(J, case)) \
            else []
        out.append(pytest.param(case, marks=marks, id=case))
    return out


def test_the_cases_are_the_reference_ones():
    assert len(CASES) == 16 and case_names(P) == CASES


@pytest.mark.parametrize("case", _params())
def test_mesh_sweep_case(case, monkeypatch):
    """One case of tests/test_mesh_sweep.py through the port."""
    call_case(getattr(P, case), monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# both packages, value for value
# ---------------------------------------------------------------------------

def _planes(k):
    import jax
    return (jsharding._DataPlane(jsharding.make_mesh(jax.devices()[:k])),
            tsharding._DataPlane(tsharding.make_mesh([CPU] * k)))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharding_policies_match_the_jax_package(k):
    """worth_sharding (the JAX package's non-Pallas rule against a CPU
    plane's), worth_sharding_msm and msm_bucket at 2, 4 and 8 positions,
    over sizes around every bucket edge and the MSM floor."""
    jp, tp = _planes(k)
    sizes = sorted({1, 2, 7, 8, 9, 31, 32, 33, 63, 64, 65, 255, 256, 257,
                    k * 32 - k, k * 32, k * 32 + 1, 1000, 1024, 4095,
                    4096, 8192, 16384, 65536, 100_000, 1 << 18})
    for n in sizes:
        assert tp.worth_sharding(n) == jp.worth_sharding(n), (k, n)
        assert tp.worth_sharding_msm(n) == jp.worth_sharding_msm(n), (k, n)
        assert tp.msm_bucket(n) == jp.msm_bucket(n), (k, n)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_comb_placement_matches_the_jax_package(k):
    """comb_mesh_mode over validator buckets and budgets at each edge of
    the ladder (repl, shard, None) in both packages."""
    jp, tp = _planes(k)
    tb = tedops._TABLE_BYTES_PER_KEY
    assert tb == jedops._TABLE_BYTES_PER_KEY
    try:
        for k_pad in (8, 64, 256, 1024, k * 8 + 1):
            e = J._FakeEntry(k_pad=k_pad)
            t = k_pad * tb
            for budget in (1, t, t + t // k - 1, t + t // k, 2 * t - 1,
                           2 * t, 10 ** 12):
                jedops._table_budget_override = budget
                tedops._table_budget_override = budget
                assert tp.comb_mesh_mode(e) == jp.comb_mesh_mode(e), \
                    (k, k_pad, budget)
    finally:
        jedops._table_budget_override = None
        tedops._table_budget_override = None


def test_chunk_knob_matches_the_jax_package(monkeypatch):
    """The raw and effective chunk of both packages for the same knob
    settings, env included, and the static chunk of the global plane."""
    monkeypatch.delenv("TM_TPU_MESH_CHUNK", raising=False)
    try:
        for raw in (None, 7, 255, 256, 600, 3000, 5120, 16384, 40000,
                    10 ** 9):
            for s in (jsharding, tsharding):
                s.set_mesh_chunk(raw)
            assert tsharding.mesh_chunk_raw() == jsharding.mesh_chunk_raw()
            assert tsharding.mesh_chunk_lanes() == \
                jsharding.mesh_chunk_lanes(), raw
        for s in (jsharding, tsharding):
            s.set_mesh_chunk(None)
        for env in ("600", "junk", "70000"):
            monkeypatch.setenv("TM_TPU_MESH_CHUNK", env)
            assert tsharding.mesh_chunk_lanes() == \
                jsharding.mesh_chunk_lanes(), env
        assert tsharding._static_chunk_lanes() == \
            jsharding._static_chunk_lanes()
    finally:
        jsharding.set_mesh_chunk(None)


def test_shard_fields_match_the_jax_package():
    """The per-shard real-row model of a mesh launch record."""
    for n, nb, shards in ((48, 64, 8), (13, 16, 8), (700, 1024, 2),
                          (1, 64, 4), (100_000, 131072, 4), (5, 4, 8),
                          (64, 64, 1)):
        assert tdevobs.shard_fields(n, nb, shards) == \
            jdevobs.shard_fields(n, nb, shards), (n, nb, shards)


def _latch_script(s, set_world, coord):
    """One sequence of global-plane observations: gating, the latch, the
    poison seen by a healthy peer, the clear on a topology re-probe."""
    obs = [s.global_mesh_ready()]
    with s.lockstep():
        obs.append(s.global_plane() is None)
    set_world(2)
    obs.append(s.global_mesh_ready())
    obs.append(s.global_plane() is None)       # not in lockstep
    with s.lockstep():
        obs.append(s.global_plane() is not None)
        s.disable_global_plane()
        obs.append(s.global_plane() is None)
        obs.append(len(coord.kv))
    with s._PLANE_LOCK:
        s._GLOBAL_PLANE = None
    s._poison_seen = False
    s._poison_next_check = 0.0
    with s.lockstep():
        obs.append(s.global_plane() is None)   # the peer's poison
    obs.append(s._GLOBAL_PLANE is False)
    return obs


def test_latch_transitions_match_the_jax_package(monkeypatch):
    """The same script of gating, latching, poisoning and clearing,
    through each package on its own runtime seams (a fake coordination
    client for JAX, a fake c10d store for the port): the same
    observations."""
    import types

    def fake(api):
        c = types.SimpleNamespace(kv={})
        if api == "jax":
            c.key_value_set = lambda k, v: c.kv.__setitem__(k, v)
            c.key_value_dir_get = lambda d: [
                (k, v) for k, v in c.kv.items() if k.startswith(d)]
        else:
            c.set = lambda k, v: c.kv.__setitem__(k, v)
            c.check = lambda keys: all(k in c.kv for k in keys)
        return c

    out = {}
    for api, s in (("jax", jsharding), ("port", tsharding)):
        coord = fake(api)
        with s._PLANE_LOCK:
            saved = (s._PLANE, s._PLANE_KEY, s._GLOBAL_PLANE)
            s._GLOBAL_PLANE = None
        monkeypatch.setattr(s, "_coord_client", lambda c=coord: c)
        world = {"n": 1}
        if api == "jax":
            monkeypatch.setattr(s.jax, "process_count",
                                lambda: world["n"])
        else:
            monkeypatch.setattr(s, "_world_size", lambda: world["n"])
        try:
            out[api] = _latch_script(
                s, lambda v: world.__setitem__("n", v), coord)
        finally:
            with s._PLANE_LOCK:
                s._PLANE, s._PLANE_KEY, s._GLOBAL_PLANE = saved
            s._poison_seen = False
            s._poison_next_check = 0.0
    assert out["port"] == out["jax"], out
