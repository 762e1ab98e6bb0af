"""K4's per-thread chain (csrc/decompress.cuh) on the CPU.

The body of k_decompress_niels (one point a thread) compiled with the
host's C++ compiler and run for every point of a lane-major batch:
(a) on adversarial encodings (y = 0, 1, 2, p - 1, p, p + 1, p + 18,
    2^255 - 1 and a non-square, each with both sign bits; the R edge
    encodings of chip_smoke.py's phase 3) and seeded ones: the ok flags
    equal `_edref._decode`'s verdict, and the niels rows, as canonical
    bytes, equal the JAX package's `msm._build_table` rows and the port's
    `decompress_niels_plain`;
(b) the stored rows are carried (1-bounded, as K5 needs);
(c) fe_sq2 and fe_mul2 at the limb extremes of their contract (the
    folded operand 1.68-bounded, F G = 16) and on carried limbs give the
    right value mod p within the bounds the header note states.
Skipped only when no C++ compiler is found.
"""
import os
import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import _edref as jref
from tendermint_tpu.ops import msm as jmsm

from tendermint_tpu_torch.ops import cuda_msm as cm

P = jref.P
L = jref.L
U = [1 << (26 - (k & 1)) for k in range(10)]
W10 = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    cm.__file__))), "csrc")

# stdin, whitespace-separated:
#   G <m> <m encodings as 64 hex digits>
#       -> m lines "<ok> <30 limbs of the niels row>"
#   S <10 limbs>          -> the 10 limbs of fe_sq2
#   M <10 limbs> <10 limbs> -> the 10 limbs of fe_mul2
HARNESS = r"""
#include <iostream>
#include <string>
#include <vector>

#include "decompress.cuh"

// k_decompress_niels, thread i for every i < m
static void batch(long long m) {
  std::vector<uint8_t> b((size_t)32 * m);
  for (long long i = 0; i < m; i++) {
    std::string h;
    std::cin >> h;
    for (int q = 0; q < 32; q++)
      b[(size_t)q * m + i] = (uint8_t)std::stoul(h.substr(2 * q, 2),
                                                 nullptr, 16);
  }
  std::vector<int32_t> niels((size_t)30 * m);
  for (long long i = 0; i < m; i++) {
    uint32_t w[8];
    load_lane32(w, b.data(), m, i);
    bool ok = decompress_niels_row(niels.data() + i * 30, w);
    std::cout << (int)ok;
    for (int q = 0; q < 30; q++) std::cout << " " << niels[i * 30 + q];
    std::cout << "\n";
  }
}

int main() {
  std::string op;
  while (std::cin >> op) {
    if (op == "G") {
      long long m;
      std::cin >> m;
      batch(m);
      continue;
    }
    fe f, g, h;
    for (int i = 0; i < 10; i++) std::cin >> f[i];
    if (op == "M") {
      for (int i = 0; i < 10; i++) std::cin >> g[i];
      fe_mul2(h, f, g);
    } else {
      fe_sq2(h, f);
    }
    for (int i = 0; i < 10; i++) std::cout << h[i] << (i < 9 ? " " : "\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    d = tmp_path_factory.mktemp("k4")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-I", CSRC, "-o", str(exe),
                        str(src)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr

    def run(text):
        r = subprocess.run([str(exe)], input=text, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr
        return [[int(v) for v in ln.split()]
                for ln in r.stdout.splitlines()]
    return run


def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _encodings():
    """The adversarial encodings (each y with both sign bits, then the R
    edge encodings), seeded valid points and seeded random bytes."""
    y_ns = 2
    while jref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    ys = [0, 1, 2, P - 1, P, P + 1, P + 18, (1 << 255) - 1, y_ns]
    encs = [_enc(y | sign << 255) for y in ys for sign in (0, 1)]
    encs += [_enc(y_ns), _enc(1 | 1 << 255), _enc(P - 1),
             _enc(P - 1 | 1 << 255), _enc(P), _enc(0), _enc((1 << 255) - 1),
             _enc((1 << 256) - 1)]
    rng = random.Random(5)
    for _ in range(12):
        encs.append(jref._encode(jref._mul(rng.randrange(1, L), jref.BASE)))
        encs.append(bytes(rng.randrange(256) for _ in range(32)))
    return encs


@pytest.fixture(scope="module")
def reference():
    """(encodings, the oracle's verdicts, the JAX package's table rows as
    (3, N, 32) canonical bytes, the port's plain rows and ok)."""
    encs = _encodings()
    assert len(encs) % 2 == 0
    h = len(encs) // 2
    m = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)
    table, _ = jax.jit(jmsm._build_table)(jnp.asarray(m[:h]),
                                          jnp.asarray(m[h:]))
    jrows = cm.to_bytes22(torch.from_numpy(np.stack(
        [np.asarray(t) for t in table]).astype(np.int64)))[:, 1:-1]
    oracle = np.array([jref._decode(e) is not None for e in encs])
    b_rows = torch.from_numpy(np.ascontiguousarray(m.T))
    plain, plain_ok = cm.decompress_niels_plain(b_rows)
    return encs, oracle, jrows, cm.to_bytes22(plain), plain_ok.numpy()


@pytest.fixture(scope="module")
def chain(harness, reference):
    """The kernel body's (ok flags, (N, 3, 10) niels rows) on the
    encodings of `reference`."""
    encs = reference[0]
    out = harness(f"G {len(encs)} " + " ".join(e.hex() for e in encs)
                  + "\n")
    assert len(out) == len(encs)
    ok = np.array([o[0] for o in out])
    rows = torch.tensor([o[1:] for o in out], dtype=torch.int32)
    return ok, rows.reshape(-1, 3, 10)


def test_chain_ok_equals_oracle(reference, chain):
    """(a): the verdicts, rejections included."""
    _, oracle, _, _, plain_ok = reference
    ok, _ = chain
    assert set(ok.tolist()) == {0, 1}
    np.testing.assert_array_equal(ok.astype(bool), oracle)
    np.testing.assert_array_equal(plain_ok, oracle)


def test_chain_rows_equal_build_table(reference, chain):
    """(a): the rows as canonical bytes = the JAX package's table rows."""
    _, _, jrows, _, _ = reference
    assert torch.equal(cm.to_bytes10(chain[1]), jrows)


def test_chain_rows_equal_plain(reference, chain):
    """(a): the rows as canonical bytes = the port's plain version (what
    chip_smoke.py holds the kernel against on the card)."""
    _, _, _, plain_rows, _ = reference
    assert torch.equal(cm.to_bytes10(chain[1]), plain_rows)


def test_chain_rows_carried(chain):
    """(b): every stored limb within 0.501 U_k, the carried bound that
    K5's ge_madd_niels relies on."""
    bound = torch.tensor([0.501 * u for u in U])
    assert bool((chain[1].abs() <= bound).all())


def _value(limbs) -> int:
    return sum(v << w for v, w in zip(limbs, W10))


def _bounded(limbs, frac: float) -> bool:
    return all(abs(v) <= frac * u for v, u in zip(limbs, U))


def _extreme(bound: float, signs):
    """Limbs at the largest magnitude a `bound`-bounded element may have,
    with the given signs; a 19-folded operand at 32/19 keeps 19 f_k (38 f_k
    for an odd limb of a square) inside an int32."""
    return [s * int(bound * u) for s, u in zip(signs, U)]


def _contract_extremes():
    """Operands at the limits of the contract: the folded operand
    32/19-bounded, the other 16 / (32/19), with several sign patterns."""
    g_max = 32 / 19
    rng = random.Random(9)
    sign_sets = [[1] * 10, [-1] * 10, [(-1) ** k for k in range(10)],
                 [rng.choice((-1, 1)) for _ in range(10)]]
    cases = []
    for signs in sign_sets:
        f = _extreme(g_max, signs)
        assert all(abs(38 * v) < 2 ** 31 for v in f[1::2])
        assert all(abs(19 * v) < 2 ** 31 for v in f)
        cases.append(("S", f, None))
        cases.append(("M", _extreme(16 / g_max, signs),
                      _extreme(g_max, signs[::-1])))
        cases.append(("M", _extreme(g_max, signs[::-1]),
                      _extreme(g_max, signs)))
    return cases


def _chain_operands():
    """Seeded operands as the chain feeds them: 0.5005-bounded."""
    rng = random.Random(10)
    cases = []
    for _ in range(40):
        f = [rng.randint(-int(0.5005 * u), int(0.5005 * u)) for u in U]
        g = [rng.randint(-int(0.5005 * u), int(0.5005 * u)) for u in U]
        cases += [("S", f, None), ("M", f, g)]
    return cases


@pytest.mark.parametrize("cases,bound", [(_contract_extremes, 0.503),
                                         (_chain_operands, 0.5001)],
                         ids=["contract-extremes", "chain-operands"])
def test_sq2_mul2_bounds_and_values(harness, cases, bound):
    """(c): the value mod p, and the output bound of the header note:
    0.503-bounded for any operands of the contract, 0.5001-bounded on the
    chain's operands."""
    cases = [c + (bound,) for c in cases()]
    text = "".join(f"{op} " + " ".join(map(str, f + (g or []))) + "\n"
                   for op, f, g, _ in cases)
    out = harness(text)
    assert len(out) == len(cases)
    for (op, f, g, bound), h in zip(cases, out):
        want = _value(f) * _value(g if op == "M" else f) % P
        assert _value(h) % P == want, (op, f, g)
        assert _bounded(h, bound), (op, f, g, h)
