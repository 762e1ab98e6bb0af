"""Kernels K1, K2 and K3: batched ed25519 verification on an NVIDIA Hopper
GPU.

The counterparts of tendermint_tpu/ops/pallas_ed25519.py:

  K1  verify_packed_pallas       -> verify_packed(packed)
  K2  verify_packed_split_pallas -> verify_packed_split(pub_rows, rsk)
  K3  verify_staged_pallas       -> verify_staged(pub, r, s, digest)

Each wrapper takes lane-major uint8 tensors (the staging layouts of
ops/ed25519.prepare_batch_packed / prepare_batch_split /
prepare_batch_compact) and returns a (B,) bool verdict tensor on the
input's device.  For a CUDA tensor it launches the hand-written kernel of
csrc/ed25519_verify.cu (one signature per group of four lanes, the body in
csrc/verify4.cuh; built with nvcc for sm_90a on first use, cached by
source hash under the package's _build/ directory, loaded with ctypes) or
raises; for a CPU tensor it runs the kernel's plain PyTorch version
(verify_packed_plain / verify_packed_split_plain / verify_staged_plain),
built on ops/field.py and ops/curve.py.

`launches` counts kernel launches per wrapper; `fe_selftest` runs the CUDA
field arithmetic on given elements so that it can be held against the
plain field (ops/field.py) whatever limb layout the kernel uses.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import _nvcc
from . import curve as C
from . import field as F

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe25519.cuh", "launch.cuh", "verify4.cuh", "ed25519_verify.cu"))

# ---------------------------------------------------------------------------
# work per signature, for the bound: the reference's count (the one-lane
# verify of the JAX package and of this port's first kernels), kept
# unchanged so that every design's time is read against one yardstick
# ---------------------------------------------------------------------------
# decompression 255 sq + 20 mul; table of -A 16 sq + 51 mul; ladder
# 64 x (16 sq + 30 mul); inversion and encode 254 sq + 13 mul.
FE_MULS_PER_SIG = 2004
FE_SQS_PER_SIG = 1549
PRODUCTS_PER_SIG = 100 * FE_MULS_PER_SIG + 55 * FE_SQS_PER_SIG
# a 32x32 -> 64-bit product is two 32-bit multiply-adds (low, high half)
IMADS_PER_SIG = 2 * PRODUCTS_PER_SIG
# The four-lane design (csrc/verify4.cuh) does, on EACH of a signature's
# four lanes: decode 256 sq + 20 mul (lanes 2 and 3 repeat A's decode)
# and -A's T 1 mul; table 8 + 2 x 7 = 22 mul; ladder 64 x (4 sq + 8
# mul); check 1 mul.  That is 512 sq + 556 mul a lane (the chain: ~1,070
# rounds), 2,048 sq + 2,224 mul a signature (20% more than the
# reference), and 2,367 exchanges of a 10-limb value a lane (ladder
# 64 x 36, table 58, decode 4, check 1), i.e. 23,672 32-bit shuffles a
# lane, 94,688 a signature.
# H100 SXM: 132 SMs x 64 int32 multiply-adds per clock x 1.98 GHz boost
H100_IMAD_PER_S = 132 * 64 * 1.98e9
BYTES_PER_SIG = 128 + 1  # staged rows in, verdict out
# K3: the digest's reduction mod L (3 folds of 6 x 14 int64 products, each
# counted as 4 32-bit multiply-add halves) and 32 more bytes in
IMADS_MOD_L = 3 * 6 * 14 * 4
BYTES_PER_STAGED_SIG = 160 + 1
MEM_BYTES_PER_S = 3.35e12

launches = {"verify_packed": 0, "verify_packed_split": 0,
            "verify_staged": 0, "fe_selftest": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def bound_ms(lanes: int, staged: bool = False) -> float:
    """Least time the card could take for `lanes` verifications (K1/K2,
    or K3 with `staged`): the larger of the multiply-add time and the
    byte time (3.35 TB/s)."""
    imads = IMADS_PER_SIG + (IMADS_MOD_L if staged else 0)
    nbytes = BYTES_PER_STAGED_SIG if staged else BYTES_PER_SIG
    ops_s = lanes * imads / H100_IMAD_PER_S
    bytes_s = lanes * nbytes / MEM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
build_info: dict = {}


def build() -> str:
    """Compile csrc/ed25519_verify.cu into a shared library (once per
    source hash); returns its path.  `build_info` receives the build
    seconds and nvcc's -Xptxas -v report (registers, spills)."""
    info = _nvcc.build("ed25519_verify", SOURCES)
    build_info.update(info)
    return info["path"]


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.tm_verify_packed.argtypes = [vp, vp, vp, ll, i, vp]
            lib.tm_verify_packed_split.argtypes = [vp, vp, vp, vp, ll, i, vp]
            lib.tm_verify_staged.argtypes = [vp, vp, vp, vp, vp, vp, ll, i,
                                             vp]
            lib.tm_fe_selftest.argtypes = [vp, vp, vp, ll, i, vp]
            ip = ctypes.POINTER(ctypes.c_int)
            lib.tm_verify_occupancy.argtypes = [i, ip, ip]
            for fn in (lib.tm_verify_packed, lib.tm_verify_packed_split,
                       lib.tm_verify_staged, lib.tm_fe_selftest,
                       lib.tm_verify_occupancy):
                fn.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def occupancy() -> dict:
    """Blocks of how many threads fit on one SM, per verify kernel (the
    CUDA runtime's occupancy calculator): {kernel: (blocks, threads)}."""
    lib = kernels()
    out = {}
    for which, name in enumerate(("verify_packed", "verify_packed_split",
                                  "verify_staged")):
        blocks, threads = ctypes.c_int(), ctypes.c_int()
        _nvcc.check_rc(lib, lib.tm_verify_occupancy(
            which, ctypes.byref(blocks), ctypes.byref(threads)), name)
        out[name] = (blocks.value, threads.value)
    return out


def _check_rows(t: torch.Tensor, rows: int, name: str) -> None:
    if t.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"{name}: expected uint8/int8, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected ({rows}, B), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# constants: the JAX kernel's packed constant columns, and the base table
# in the CUDA kernel's 10-limb layout
# ---------------------------------------------------------------------------

# Constant-column layout of the (NLIMB, 128) constant array, as
# pallas_ed25519._make_consts: 0 d, 1 d2, 2 sqrt_m1, 3 two_p,
# 4..12 base_ypx[j], 13..21 base_ymx[j], 22..30 base_t2d[j], 31 one.
_COL_D, _COL_D2, _COL_SQRT_M1, _COL_TWO_P = 0, 1, 2, 3
_COL_BYPX, _COL_BYMX, _COL_BT2D = 4, 13, 22
_COL_ONE = 31


def _make_consts() -> np.ndarray:
    from . import ed25519 as edops
    cols = np.zeros((F.NLIMB, 128), dtype=np.int64)
    cols[:, _COL_D] = F.int_to_limbs(C.D_INT)
    cols[:, _COL_D2] = F.int_to_limbs(C.D2_INT)
    cols[:, _COL_SQRT_M1] = F.int_to_limbs(C.SQRT_M1_INT)
    cols[:, _COL_TWO_P] = F._TWO_P
    ypx, ymx, t2d = edops._base_table_np()
    cols[:, _COL_BYPX:_COL_BYPX + 9] = ypx.T
    cols[:, _COL_BYMX:_COL_BYMX + 9] = ymx.T
    cols[:, _COL_BT2D:_COL_BT2D + 9] = t2d.T
    cols[0, _COL_ONE] = 1
    return cols


_consts_cache = None
_base10_cache: dict = {}
_const_lock = threading.Lock()


def consts_packed() -> np.ndarray:
    global _consts_cache
    with _const_lock:
        if _consts_cache is None:
            _consts_cache = _make_consts()
        return _consts_cache


_W10 = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)


def fe10_limbs(x: int) -> list:
    """Canonical limbs of x mod p in the CUDA kernel's radix-2^25.5
    layout (csrc/fe25519.cuh)."""
    x %= F.P
    return [(x >> _W10[i]) & ((1 << (_W10[i + 1] - _W10[i])) - 1)
            for i in range(10)]


def base_table10() -> np.ndarray:
    """The 9 niels entries j*B, j = 0..8, as (9, 3, 10) int32 in the
    kernel's limb layout, from the base table's columns."""
    cols = consts_packed()
    out = np.zeros((9, 3, 10), dtype=np.int32)
    for j in range(9):
        for f, c0 in enumerate((_COL_BYPX, _COL_BYMX, _COL_BT2D)):
            out[j, f] = fe10_limbs(F.limbs_to_int(cols[:, c0 + j]))
    return out


def _base_table_dev(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    with _const_lock:
        t = _base10_cache.get(key)
    if t is None:
        t = torch.from_numpy(base_table10().reshape(-1)).to(dev)
        with _const_lock:
            t = _base10_cache.setdefault(key, t)
    return t


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """K1: (128, B) uint8/int8 lane-major rows (A | R | s | k) -> (B,)
    bool.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check_rows(packed, 128, "packed")
    if packed.device.type == "cpu":
        return verify_packed_plain(packed)
    dev = packed.device
    B = packed.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_verify_packed(packed.data_ptr(),
                              _base_table_dev(dev).data_ptr(),
                              out.data_ptr(), B, dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "verify_packed")
    _count("verify_packed")
    return out.view(torch.bool)


def verify_packed_split(pub_rows: torch.Tensor,
                        rsk: torch.Tensor) -> torch.Tensor:
    """K2: resident (32, B) pubkey rows + (96, B) rows (R | s | k) ->
    (B,) bool."""
    _check_rows(pub_rows, 32, "pub_rows")
    _check_rows(rsk, 96, "rsk")
    if pub_rows.shape[1] != rsk.shape[1] or pub_rows.device != rsk.device:
        raise ValueError("pub_rows and rsk must have the same lanes/device")
    if rsk.device.type == "cpu":
        return verify_packed_split_plain(pub_rows, rsk)
    dev = rsk.device
    B = rsk.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_verify_packed_split(pub_rows.data_ptr(), rsk.data_ptr(),
                                    _base_table_dev(dev).data_ptr(),
                                    out.data_ptr(), B, dev.index,
                                    _stream(dev))
    _nvcc.check_rc(lib, rc, "verify_packed_split")
    _count("verify_packed_split")
    return out.view(torch.bool)


def verify_staged(pub: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                  digest: torch.Tensor) -> torch.Tensor:
    """K3: (32, B) rows of A, R and s plus the (64, B) raw SHA-512
    digests of R || A || M (ops/ed25519.prepare_batch_compact) -> (B,)
    bool; k = digest mod L and the digits are computed on the device."""
    rows = (("pub", pub, 32), ("r", r, 32), ("s", s, 32),
            ("digest", digest, 64))
    for name, t, n in rows:
        _check_rows(t, n, name)
    B = pub.shape[1]
    if any(t.shape[1] != B or t.device != pub.device for _, t, _ in rows):
        raise ValueError("pub, r, s and digest must have the same "
                         "lanes/device")
    if pub.device.type == "cpu":
        return verify_staged_plain(pub, r, s, digest)
    dev = pub.device
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_verify_staged(pub.data_ptr(), r.data_ptr(), s.data_ptr(),
                              digest.data_ptr(),
                              _base_table_dev(dev).data_ptr(),
                              out.data_ptr(), B, dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "verify_staged")
    _count("verify_staged")
    return out.view(torch.bool)


def fe_selftest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CUDA field self-test: a, b (n, 32) uint8 little-endian elements
    (bit 255 ignored) -> (4, n, 32) uint8 canonical encodings of
    freeze(a), a*b, a^2, a^(p-2).  CPU tensors run fe_selftest_plain."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (n, 32) uint8")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must match in shape and device")
    if a.device.type == "cpu":
        return fe_selftest_plain(a, b)
    dev = a.device
    n = a.shape[0]
    out = torch.empty((4, n, 32), dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_fe_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                            dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "fe_selftest")
    _count("fe_selftest")
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (the arithmetic of _verify_tile, on ops/field and
# ops/curve)
# ---------------------------------------------------------------------------

def fe_selftest_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fa, _ = F.bytes_to_limbs(a.t())
    fb, _ = F.bytes_to_limbs(b.t())
    outs = [F.to_bytes(fa), F.to_bytes(F.mul(fa, fb)), F.to_bytes(F.sqr(fa)),
            F.to_bytes(F.invert(fa))]
    return torch.stack([o.t() for o in outs]).to(torch.uint8)


def _bytes_to_limbs12(b: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """(NB, B) byte rows (0..255) -> (nlimbs, B) radix-2^12 limbs of the
    full value, no sign masking (pallas_ed25519._bytes_to_limbs12)."""
    nbytes = b.shape[0]
    rows = []
    for i in range(nlimbs):
        if i % 2 == 0:
            b0 = (3 * i) // 2
            v = b[b0]
            if b0 + 1 < nbytes:
                v = v | ((b[b0 + 1] & 0x0F) << 8)
        else:
            b0 = (3 * i - 1) // 2
            v = b[b0] >> 4
            if b0 + 1 < nbytes:
                v = v | (b[b0 + 1] << 4)
        rows.append(v)
    return torch.stack(rows)


def _scalar_carry(rows):
    """Exact carry over a list of limb rows -> limbs in [0, 2^12); the
    carry out of the last row is dropped (pallas_ed25519._scalar_carry)."""
    out = []
    carry = None
    for r in rows:
        v = r if carry is None else r + carry
        out.append(v & F.MASK)
        carry = v >> F.RADIX
    return out


# mod L constants of pallas_ed25519: 2^252 = -C (mod L), positive fold
# offsets M_k >= C * max(hi_k) (hi_1 <= 2^260, hi_2 <= 2^134, hi_3 <= 2^8)
_L_INT = (1 << 252) + 27742317777372353535851937790883648493
_C_INT = _L_INT - (1 << 252)
_C_L12 = [(_C_INT >> (12 * i)) & 0xFFF for i in range(11)]
_L_L12 = [(_L_INT >> (12 * i)) & 0xFFF for i in range(F.NLIMB)]
_M_OFFS = [-(-(_C_INT << k) // _L_INT) * _L_INT for k in (260, 134, 8)]
_SROWS = 33  # 33 * 12 = 396 bits >= the 2^386 fold-1 bound


def _mod_l(dig_limbs: torch.Tensor) -> torch.Tensor:
    """(43, B) radix-2^12 limbs of a 512-bit value -> (NLIMB, B) canonical
    limbs mod L (pallas_ed25519._mod_l): three positive-offset folds at bit
    252, then 4 conditional subtracts of L."""
    rows = list(dig_limbs.unbind(0))
    for m in _M_OFFS:
        lo, hi = rows[:21], rows[21:]
        acc = []
        for j in range(_SROWS):
            mj = (m >> (12 * j)) & 0xFFF
            acc.append(lo[j] + mj if j < 21 else torch.full_like(rows[0], mj))
        for i in range(11):
            if _C_L12[i] == 0:
                continue
            for j, h in enumerate(hi):
                if i + j < _SROWS:
                    acc[i + j] = acc[i + j] - _C_L12[i] * h
        rows = _scalar_carry(acc)
    rows = rows[:F.NLIMB]
    for _ in range(4):   # value < M_3 + 2^252 < 5L
        ge = decided = None
        for i in range(F.NLIMB - 1, -1, -1):
            gt = rows[i] > _L_L12[i]
            lt = rows[i] < _L_L12[i]
            if ge is None:
                ge, decided = gt, gt | lt
            else:
                ge = ge | (~decided & gt)
                decided = decided | gt | lt
        ge = (ge | ~decided).to(F.DTYPE)   # equal -> subtract
        rows = _scalar_carry([rows[i] - ge * _L_L12[i]
                              for i in range(F.NLIMB)])
    return torch.stack(rows)


def _digits_from_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(NLIMB, B) radix-2^12 limbs of a scalar < 2^253 -> (64, B) signed
    radix-16 digits in [-8, 7], least significant first: t = s + 0x88..8,
    digit j = nibble j of t - 8 (pallas_ed25519._digits_from_limbs)."""
    rows = _scalar_carry([limbs[i] + 0x888 for i in range(F.NLIMB)])
    digs = []
    for j in range(64):
        limb, sh = divmod(4 * j, F.RADIX)
        digs.append(((rows[limb] >> sh) & 0xF) - 8)
    return torch.stack(digs)


def _digits(b32: torch.Tensor) -> torch.Tensor:
    """(32, B) scalar bytes -> (64, B) signed radix-16 digits in [-8, 7]."""
    return _digits_from_limbs(_bytes_to_limbs12(b32.to(F.DTYPE) & 0xFF,
                                                F.NLIMB))


def _verify_digits(pub_b, r_b, sd, kd) -> torch.Tensor:
    """(32, B) byte rows of A and R, (64, B) digits of s and k -> (B,)
    bool; _verify_tile's verdict."""
    from .ed25519 import straus_ladder
    y_l, a_sign = F.bytes_to_limbs(pub_b)
    a, decode_ok = C.decompress(y_l, a_sign)
    neg_a = C.Ext(F.carry_lazy(-a.x), a.y, a.z, F.carry_lazy(-a.t))
    enc = C.encode(straus_ladder(neg_a, sd, kd))
    return decode_ok & (enc == (r_b.to(F.DTYPE) & 0xFF)).all(0)


def _verify_plain(pub_b, r_b, s_b, k_b) -> torch.Tensor:
    """(32, B) byte rows each -> (B,) bool."""
    return _verify_digits(pub_b, r_b, _digits(s_b), _digits(k_b))


def verify_packed_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1 on any device: (128, B) -> (B,) bool."""
    b = packed.to(F.DTYPE) & 0xFF
    return _verify_plain(b[0:32], b[32:64], b[64:96], b[96:128])


def verify_packed_split_plain(pub_rows: torch.Tensor,
                              rsk: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 on any device: (32, B) + (96, B) -> (B,) bool."""
    p = pub_rows.to(F.DTYPE) & 0xFF
    b = rsk.to(F.DTYPE) & 0xFF
    return _verify_plain(p, b[0:32], b[32:64], b[64:96])


def verify_staged_plain(pub: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                        digest: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3 on any device: the digest reduced mod L and split
    into digits as _kernel does, then the K1 verify."""
    kd = _digits_from_limbs(_mod_l(_bytes_to_limbs12(
        digest.to(F.DTYPE) & 0xFF, 43)))
    return _verify_digits(pub.to(F.DTYPE) & 0xFF, r.to(F.DTYPE) & 0xFF,
                          _digits(s), kd)
