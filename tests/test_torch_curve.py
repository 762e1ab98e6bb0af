"""The port's plain edwards25519 ops equal the JAX package's limb for
limb (ops/curve.py): decompression verdicts and coordinates, cached and
niels forms, doubling, both additions, the window table and encoding."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tendermint_tpu.crypto import _edref
from tendermint_tpu.ops import curve as JC
from tendermint_tpu.ops import field as JF

from tendermint_tpu_torch.ops import curve as TC
from tendermint_tpu_torch.ops import field as TF

P = JF.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is thousands of small tensor ops: with one intra-op
    thread per test process they do not contend with parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _points():
    """Encodings: valid keys, edge encodings (identity, order 2 and 4,
    x = 0 with the sign bit, non-canonical y, a non-square)."""
    keys = [_edref.pubkey_from_seed(bytes([i]) * 32) for i in range(10)]
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    edge = [1, P - 1, 0, 1 | (1 << 255), P + 1, y_ns, (1 << 255) - 1]
    return keys + [v.to_bytes(32, "little") for v in edge]


def test_curve_ops():
    enc = np.frombuffer(b"".join(_points()), np.uint8).reshape(-1, 32)
    jy = JF.bytes32_to_limbs_np(enc)
    sign = jy[21] >> 3
    jy[21] &= 7
    ja, jok = JC.decompress(jnp.asarray(jy), jnp.asarray(sign))
    ty, ts = TF.bytes_to_limbs(torch.from_numpy(enc.T.copy()))
    ta, tok = TC.decompress(ty, ts)
    _eq(jok, tok)
    assert list(tok.numpy()) == [_edref._decode(bytes(e)) is not None
                                 for e in enc]
    for f in range(4):
        _eq(ja[f], ta[f])
    jc, tc = JC.to_cached(ja), TC.to_cached(ta)
    for f in range(4):
        _eq(jc[f], tc[f])
    j2, t2 = JC.dbl(ja), TC.dbl(ta)
    for f in range(4):
        _eq(j2[f], t2[f])
    jn, tn = JC.dbl_no_t(ja), TC.dbl(ta, with_t=False)
    for f in range(3):
        _eq(jn[f], tn[f])
    j3, t3 = JC.add_cached(j2, jc), TC.add_cached(t2, tc)
    for f in range(4):
        _eq(j3[f], t3[f])
    niels_j = JC.Niels(jc.ypx, jc.ymx, jc.t2d)
    niels_t = TC.Niels(tc.ypx, tc.ymx, tc.t2d)
    j4, t4 = JC.madd_niels(j3, niels_j), TC.madd_niels(t3, niels_t)
    for f in range(4):
        _eq(j4[f], t4[f])
    neg = np.arange(enc.shape[0]) % 2 == 0
    jcn = JC.cond_neg_cached(jc, jnp.asarray(neg))
    tcn = TC.cond_neg_cached(tc, torch.from_numpy(neg))
    for f in range(4):
        _eq(jcn[f], tcn[f])
    jtab, _ = JC.cached_window(j2)
    ttab, _ = TC.cached_window(t2)
    for f in range(4):
        _eq(jtab[f], ttab[f])
    jbits = np.asarray(JC.encode_bits(j4))
    jbytes = np.packbits(jbits.astype(np.uint8), axis=0, bitorder="little")
    np.testing.assert_array_equal(jbytes, TC.encode(t4).numpy())
