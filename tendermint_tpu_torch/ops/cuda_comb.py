"""Kernels C1 and C2: the fixed-base comb of ed25519 verification on an
NVIDIA Hopper GPU.

The counterparts of two XLA functions of tendermint_tpu/ops/ed25519.py
(the JAX package has no Pallas kernel for them):

  C1  comb_build_kernel_impl (:495)  -> comb_build(pub)
  C2  comb_verify_staged (:542)      -> comb_verify(r, s_digits, k_digits,
                                                    vidx, tables, dec_ok)

comb_build takes a (K, 32) uint8 pubkey matrix and returns (tables,
dec_ok): for a CUDA tensor it launches the hand-written kernel of
csrc/comb.cu and the tables are one (64, 9, K, 4, 10) int32 tensor, entry
[i][j] = [j 16^i](-A) in cached form in the kernel's 10-limb layout
(ops/cuda_ed25519.fe10_limbs); for a CPU tensor it runs the plain version
(ops/ed25519.comb_build_kernel_impl) and the tables are its Cached fields
(64, 9, NLIMB, K).  comb_verify takes R (B, 32) uint8, the signed
radix-16 digits of s and k (B, 64) int8 (ops/ed25519.scalars_to_digits),
each signature's table row (B,) int32 and comb_build's output on the same
device, and returns the (B,) bool verdicts; B's static comb comes from
base_comb_dev (CUDA) or ops/ed25519._base_comb (CPU).  Both kernels run
one key or one signature on a group of four lanes (csrc/comb4.cuh on
K1's group law, csrc/verify4.cuh); the library is built with nvcc for
sm_90a on first use, cached by source hash under the package's _build/
directory, and loaded with ctypes.  A CUDA tensor launches or raises.

`launches` counts kernel launches per wrapper; bound_ms_build and
bound_ms_verify give the least time the card could take for the same
work; tables_mismatch holds C1's table against the plain version's as
field values.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import _nvcc
from . import cuda_ed25519 as ck
from . import field as F

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe25519.cuh", "launch.cuh", "verify4.cuh", "comb4.cuh", "comb.cu"))

WINDOWS = 64
DIGITS = 9
# C1's table on the card: 64 windows x 9 entries x 4 coordinates x 10 int32
TABLE_BYTES_PER_KEY = WINDOWS * DIGITS * 4 * 10 * 4     # 92,160
ENTRY_BYTES = 4 * 10 * 4                                 # one cached entry
BASE_ENTRY_BYTES = 3 * 10 * 4                            # one niels entry

# ---------------------------------------------------------------------------
# work, for the bounds, counted one lane at a time as K1's reference count
# is (ops/cuda_ed25519.py): a doubling 4 squares + 4 multiplies, a cached
# addition 8 multiplies, a niels addition 7, a cached conversion 1
# ---------------------------------------------------------------------------
# C1 per key: the decode (255 sq + 20 mul), -A's T (1 mul), 64 windows of
# 5 doublings, 3 cached additions and 8 cached conversions
C1_MULS_PER_KEY = 20 + 1 + WINDOWS * (5 * 4 + 3 * 8 + 8)
C1_SQS_PER_KEY = 255 + WINDOWS * 5 * 4
C1_BYTES_PER_KEY = 32 + TABLE_BYTES_PER_KEY + 1
# C2 per signature: the inversion of Z (254 sq + 11 mul) and x, y (2 mul),
# then 7 multiplies a niels addition of B and 8 a cached addition of -A,
# one for each nonzero digit of s and of k (a zero digit adds the
# identity)
C2_MULS_FIXED = 11 + 2
C2_SQS_FIXED = 254
C2_BYTES_PER_SIG = 32 + 64 + 64 + 4 + 1

launches = {"comb_build": 0, "comb_verify": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _imads(muls: int, sqs: int) -> int:
    # a product is 100 (square 55) 32x32 -> 64-bit products, two
    # multiply-add halves each
    return 2 * (100 * muls + 55 * sqs)


def _build_s(keys: int) -> tuple:
    """C1's (operation time, byte time) in seconds for `keys` keys."""
    return (keys * _imads(C1_MULS_PER_KEY, C1_SQS_PER_KEY)
            / ck.H100_IMAD_PER_S, keys * C1_BYTES_PER_KEY / ck.MEM_BYTES_PER_S)


def bound_ms_build(keys: int) -> float:
    """Least time the card could take for C1 over `keys` keys: the larger
    of the multiply-add time and the byte time (3.35 TB/s)."""
    return 1e3 * max(_build_s(keys))


def bound_by_build(keys: int) -> str:
    ops_s, bytes_s = _build_s(keys)
    return "operations" if ops_s >= bytes_s else "bytes"


def verify_work(s_digits, k_digits, vidx) -> dict:
    """What C2 must do on this data: the nonzero digits of s and of k
    (its additions) and the distinct table entries it must read (each
    (window, |k digit|, row) of -A's tables, each (window, |s digit|) of
    B's comb), from the (B, 64) digit arrays and the (B,) rows."""
    sd = np.asarray(s_digits).astype(np.int64)
    kd = np.asarray(k_digits).astype(np.int64)
    v = np.asarray(vidx).astype(np.int64).reshape(-1, 1)
    win = np.arange(WINDOWS, dtype=np.int64).reshape(1, -1)
    a_keys = np.unique((v * WINDOWS + win) * DIGITS + np.abs(kd))
    b_keys = np.unique(win * DIGITS + np.abs(sd))
    return {"lanes": sd.shape[0], "b_adds": int((sd != 0).sum()),
            "a_adds": int((kd != 0).sum()), "a_entries": int(a_keys.size),
            "b_entries": int(b_keys.size)}


def _verify_s(work: dict) -> tuple:
    """C2's (operation time, byte time) in seconds on `work`."""
    muls = work["lanes"] * C2_MULS_FIXED + 7 * work["b_adds"] + \
        8 * work["a_adds"]
    nbytes = work["lanes"] * C2_BYTES_PER_SIG + \
        work["a_entries"] * ENTRY_BYTES + work["b_entries"] * BASE_ENTRY_BYTES
    return (_imads(muls, work["lanes"] * C2_SQS_FIXED) / ck.H100_IMAD_PER_S,
            nbytes / ck.MEM_BYTES_PER_S)


def bound_ms_verify(work: dict) -> float:
    """Least time the card could take for C2 on the data `work`
    (verify_work) describes."""
    return 1e3 * max(_verify_s(work))


def bound_by_verify(work: dict) -> str:
    ops_s, bytes_s = _verify_s(work)
    return "operations" if ops_s >= bytes_s else "bytes"


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
build_info: dict = {}


def build() -> str:
    """Compile csrc/comb.cu into a shared library (once per source hash);
    returns its path.  `build_info` receives the build seconds and nvcc's
    -Xptxas -v report."""
    info = _nvcc.build("comb", SOURCES)
    build_info.update(info)
    return info["path"]


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.tm_comb_build.argtypes = [vp, ll, vp, vp, i, vp]
            lib.tm_comb_verify.argtypes = [vp, vp, vp, vp, ll, vp, vp, ll,
                                           vp, vp, i, vp]
            ip = ctypes.POINTER(ctypes.c_int)
            lib.tm_comb_occupancy.argtypes = [i, ip, ip]
            for fn in (lib.tm_comb_build, lib.tm_comb_verify,
                       lib.tm_comb_occupancy):
                fn.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def occupancy() -> dict:
    """{kernel: (blocks, threads)} that fit on one SM (the CUDA runtime's
    occupancy calculator)."""
    lib = kernels()
    out = {}
    for which, name in enumerate(("comb_build", "comb_verify")):
        blocks, threads = ctypes.c_int(), ctypes.c_int()
        _nvcc.check_rc(lib, lib.tm_comb_occupancy(
            which, ctypes.byref(blocks), ctypes.byref(threads)), name)
        out[name] = (blocks.value, threads.value)
    return out


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# B's comb in the kernel's layout
# ---------------------------------------------------------------------------

_base_lock = threading.Lock()
_base_np = None
_base_dev: dict = {}


def base_comb10() -> np.ndarray:
    """B's comb, [j 16^i] B for i < 64, j <= 8, as (64, 9, 3, 10) int32
    niels entries (y+x, y-x, 2dxy) in the kernel's limb layout, from the
    plain version's rows (ops/ed25519._base_comb_np)."""
    global _base_np
    with _base_lock:
        if _base_np is not None:
            return _base_np
    from . import ed25519 as edops
    rows = edops._base_comb_np()
    out = np.zeros((WINDOWS, DIGITS, 3, 10), dtype=np.int32)
    for i in range(WINDOWS):
        for j in range(DIGITS):
            for f in range(3):
                out[i, j, f] = ck.fe10_limbs(F.limbs_to_int(rows[f][i, j]))
    with _base_lock:
        if _base_np is None:
            _base_np = out
        return _base_np


def base_comb_dev(dev: torch.device) -> torch.Tensor:
    """base_comb10() on `dev` (uploaded once a device); the device
    observatory's base_comb pool holds its bytes."""
    key = str(dev)
    with _base_lock:
        t = _base_dev.get(key)
    if t is None:
        t = torch.from_numpy(base_comb10()).to(dev)
        with _base_lock:
            t = _base_dev.setdefault(key, t)
    from tendermint_tpu_torch.crypto import devobs
    devobs.ledger_set("base_comb", t.numel() * t.element_size())
    return t


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: must start on a 4-byte boundary")


def comb_build(pub: torch.Tensor):
    """C1: (K, 32) uint8 pubkeys -> (tables, dec_ok (K,) bool).  CUDA
    tensors launch the kernel (tables (64, 9, K, 4, 10) int32); CPU
    tensors run the plain version (tables: Cached fields
    (64, 9, NLIMB, K))."""
    if pub.dim() != 2:
        raise ValueError(f"pub: expected (K, 32), got {tuple(pub.shape)}")
    K = pub.shape[0]
    _check(pub, torch.uint8, (K, 32), "pub")
    if pub.device.type == "cpu":
        return comb_build_plain(pub)
    dev = pub.device
    tab = torch.empty((WINDOWS, DIGITS, K, 4, 10), dtype=torch.int32,
                      device=dev)
    dec_ok = torch.empty(K, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_comb_build(pub.data_ptr(), K, tab.data_ptr(),
                           dec_ok.data_ptr(), dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "comb_build")
    _count("comb_build")
    return tab, dec_ok.view(torch.bool)


def comb_verify(r: torch.Tensor, s_digits: torch.Tensor,
                k_digits: torch.Tensor, vidx: torch.Tensor, tables,
                dec_ok: torch.Tensor) -> torch.Tensor:
    """C2: R (B, 32) uint8, digits of s and k (B, 64) int8 in [-8, 7],
    table rows (B,) int32, and comb_build's (tables, dec_ok) on the same
    device -> (B,) bool.  A row outside [0, K) fails its lane."""
    if r.dim() != 2:
        raise ValueError(f"r: expected (B, 32), got {tuple(r.shape)}")
    B = r.shape[0]
    _check(r, torch.uint8, (B, 32), "r")
    _check(s_digits, torch.int8, (B, 64), "s_digits")
    _check(k_digits, torch.int8, (B, 64), "k_digits")
    _check(vidx, torch.int32, (B,), "vidx")
    K = dec_ok.shape[0]
    dev = r.device
    if any(t.device != dev for t in (s_digits, k_digits, vidx, dec_ok)):
        raise ValueError("comb_verify: every input must be on one device")
    if dev.type == "cpu":
        return comb_verify_plain(r, s_digits, k_digits, vidx, tables, dec_ok)
    if not isinstance(tables, torch.Tensor) or tables.device != dev:
        raise ValueError("comb_verify: tables must be C1's tensor on "
                         f"{dev}")
    _check(tables, torch.int32, (WINDOWS, DIGITS, K, 4, 10), "tables")
    _check(dec_ok, torch.bool, (K,), "dec_ok")
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_comb_verify(r.data_ptr(), s_digits.data_ptr(),
                            k_digits.data_ptr(), vidx.data_ptr(), B,
                            tables.data_ptr(), dec_ok.data_ptr(), K,
                            base_comb_dev(dev).data_ptr(), out.data_ptr(),
                            dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "comb_verify")
    _count("comb_verify")
    return out.view(torch.bool)


# ---------------------------------------------------------------------------
# plain PyTorch versions (ops/ed25519.py's, on any device)
# ---------------------------------------------------------------------------

def comb_build_plain(pub: torch.Tensor):
    """Plain C1 on any device: (K, 32) uint8 -> (Cached tables, dec_ok)."""
    from . import ed25519 as edops
    return edops.comb_build_kernel_impl(pub)


def comb_verify_plain(r, s_digits, k_digits, vidx, tables,
                      dec_ok) -> torch.Tensor:
    """Plain C2 on any device, on comb_build_plain's Cached tables."""
    from . import ed25519 as edops
    return edops.comb_verify_staged(
        r, s_digits, k_digits, vidx, *tables, dec_ok,
        *edops._base_comb(r.device))


# ---------------------------------------------------------------------------
# holding C1's table against the plain version's
# ---------------------------------------------------------------------------

def fe10_to_canonical(t10: torch.Tensor) -> torch.Tensor:
    """(..., 10) limbs in the kernel's layout (signed, any value the
    kernel writes) -> (NLIMB, N) canonical radix-2^12 limbs of the same
    field elements."""
    v = t10.reshape(-1, 10).to(torch.int64)
    rows = torch.zeros((F.NLIMB + 1, v.shape[0]), dtype=torch.int64,
                       device=v.device)
    for i in range(10):
        q, sh = divmod(ck._W10[i], F.RADIX)
        rows[q] += v[:, i] << sh
    # exact chain over 276 bits; 2^264 = FOLD (mod p) folds the top limb
    # and the sign carry back into limb 0
    limbs, carry = F._carry_chain(rows, F.NLIMB + 1)
    low = limbs[:F.NLIMB].clone()
    low[0] += F.FOLD * (limbs[F.NLIMB] + (carry << F.RADIX))
    return F.freeze(low)


def tables_mismatch(tab10: torch.Tensor, plain) -> int:
    """Entries [window, digit, key] where C1's (64, 9, K, 4, 10) table
    and the plain version's Cached fields (64, 9, NLIMB, K) hold
    different field values in any coordinate."""
    W, D, K = tab10.shape[:3]
    got = fe10_to_canonical(tab10)                    # (NLIMB, W*D*K*4)
    got = got.reshape(F.NLIMB, W, D, K, 4)
    bad = torch.zeros((W, D, K), dtype=torch.bool, device=tab10.device)
    for c, field in enumerate(plain):
        want = F.freeze(field.to(tab10.device).permute(2, 0, 1, 3)
                        .reshape(F.NLIMB, -1)).reshape(F.NLIMB, W, D, K)
        bad |= (got[..., c] != want).any(0)
    return int(bad.sum())
