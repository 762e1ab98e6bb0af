"""Kernels C1 and C2: the fixed-base comb of ed25519 verification on an
NVIDIA Hopper GPU.

The counterparts of two XLA functions of tendermint_tpu/ops/ed25519.py
(the JAX package has no Pallas kernel for them):

  C1  comb_build_kernel_impl (:495)  -> comb_build(pub)
  C2  comb_verify_staged (:542)      -> comb_verify(rows, tables, dec_ok)

comb_build takes a (K, 32) uint8 pubkey matrix and returns (tables,
dec_ok): for a CUDA tensor it launches the hand-written kernel of
csrc/comb.cu and the tables are one (64, 9, K, 4, 10) int32 tensor, entry
[i][j] = [j 16^i](-A) in cached form in the kernel's 10-limb layout
(ops/cuda_ed25519.fe10_limbs); for a CPU tensor it runs the plain version
(ops/ed25519.comb_build_kernel_impl) and the tables are its Cached fields
(64, 9, NLIMB, K).  comb_verify takes one (B, ROW_BYTES) uint8 row a
signature (pack_rows: R | s | k | its table row as a little-endian int32)
and comb_build's output on the same device, and returns the (B,) bool
verdicts; B's static comb comes from base_comb_dev (CUDA) or
ops/ed25519._base_comb (CPU).  The kernel forms the signed radix-16
digits of s and k itself; the plain version takes them from
ops/ed25519.scalars_to_digits.  C1 runs a block's 8 keys over four
warps of four-lane groups (csrc/comb4.cuh: a warp of doublings, three of
the other multiples and the entries), C2 one signature on groups_for(B)
groups of four lanes, both on S2's steps (csrc/ristretto4.cuh); the
library is built with nvcc for sm_90a on first use, cached by source
hash under the package's _build/ directory, and loaded with ctypes.  A
CUDA tensor launches or raises.

`launches` counts kernel launches per wrapper; bound_ms_build and
bound_ms_verify give the least time the card could take for the same
work, design_ms_verify the multiply-add time of C2's own layout beside
it; tables_mismatch holds C1's table against the plain version's as
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
    "fe25519.cuh", "fe25519_2.cuh", "launch.cuh", "verify4.cuh",
    "ristretto4.cuh", "comb4.cuh", "comb.cu"))

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
# C2 per signature: 7 multiplies a niels addition of B and 8 a cached
# addition of -A, one for each nonzero digit of s and of k (a zero digit
# adds the identity); the affine point at the function's least, one
# inversion of Z a launch shared by Montgomery's trick (3 (B - 1)
# multiplies) and x and y (2 multiplies a signature).  None of it depends
# on how the kernel lays a signature out.  The design's own work beside it
# (design_ms_verify): with G groups a signature, G - 1 additions of the
# butterfly (a cached conversion and a cached addition, 9 multiplies), and
# a block's inversion (254 squares, 11 multiplies) on each of its first
# warp's 32 lanes, whether or not the lane holds a signature's Z
C2_BATCH_INV_MULS = 3
C2_AFFINE_MULS = 2
C2_INV_MULS = 11
C2_INV_SQS = 254
C2_TREE_MULS = 1 + 8
# a signature's row: R | s | k | its table row (little-endian int32)
ROW_BYTES = 32 + 32 + 32 + 4
C2_BYTES_PER_SIG = ROW_BYTES + 1
C2_THREADS = 128                 # csrc/comb.cu THREADS
GROUPS = (1, 2, 4, 8)
# G by the launch's lanes: (most lanes, G), then G = 1.  From C2's times
# at each G on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 15):
# G = 8 is fastest up to 1,024 lanes, 4 at 2,048, 2 at 4,096, 1 from
# 16,384
GROUPS_BY_LANES = ((1024, 8), (2048, 4), (4096, 2))

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


def groups_for(lanes: int) -> int:
    """The groups of four lanes C2 gives a signature in a launch of
    `lanes` lanes: many where one group's chain would leave the card
    idle, one where the card is full (GROUPS_BY_LANES)."""
    for most, g in GROUPS_BY_LANES:
        if lanes <= most:
            return g
    return 1


def verify_blocks(lanes: int, groups: int) -> int:
    """Blocks of a C2 launch: C2_THREADS / (4 groups) signatures each."""
    per_block = C2_THREADS // (4 * groups)
    return -(-lanes // per_block)


def verify_work(s_digits, k_digits, vidx) -> dict:
    """What C2 must do on this data: the nonzero digits of s and of k (its
    additions) and the distinct table entries it must read (each (window,
    |k digit|, row) of -A's tables, each (window, |s digit|) of B's comb),
    from the (B, 64) digit arrays and the (B,) rows (unpack_rows)."""
    sd = np.asarray(s_digits).astype(np.int64)
    kd = np.asarray(k_digits).astype(np.int64)
    v = np.asarray(vidx).astype(np.int64).reshape(-1, 1)
    win = np.arange(WINDOWS, dtype=np.int64).reshape(1, -1)
    a_keys = np.unique((v * WINDOWS + win) * DIGITS + np.abs(kd))
    b_keys = np.unique(win * DIGITS + np.abs(sd))
    return {"lanes": sd.shape[0], "b_adds": int((sd != 0).sum()),
            "a_adds": int((kd != 0).sum()), "a_entries": int(a_keys.size),
            "b_entries": int(b_keys.size)}


def _digit_muls(work: dict) -> int:
    return 7 * work["b_adds"] + 8 * work["a_adds"]


def _verify_s(work: dict) -> tuple:
    """C2's (operation time, byte time) in seconds on `work`."""
    lanes = work["lanes"]
    muls = C2_INV_MULS + C2_BATCH_INV_MULS * max(lanes - 1, 0) \
        + C2_AFFINE_MULS * lanes + _digit_muls(work)
    nbytes = lanes * C2_BYTES_PER_SIG + \
        work["a_entries"] * ENTRY_BYTES + work["b_entries"] * BASE_ENTRY_BYTES
    return (_imads(muls, C2_INV_SQS) / ck.H100_IMAD_PER_S,
            nbytes / ck.MEM_BYTES_PER_S)


def bound_ms_verify(work: dict) -> float:
    """Least time the card could take for C2 on the data `work`
    (verify_work) describes, whatever its layout."""
    return 1e3 * max(_verify_s(work))


def design_ms_verify(work: dict, groups: int) -> float:
    """The multiply-add time of what this design does on `work` at
    `groups` groups a signature: the digits' additions, the butterfly's
    G - 1 additions and x and y a signature, and a block's inversion on
    the 32 lanes of its first warp.  Not a bound: reported beside it, it
    shows what the layout costs."""
    lanes = work["lanes"]
    inversions = 32 * verify_blocks(lanes, groups)
    muls = inversions * C2_INV_MULS + lanes * (
        C2_AFFINE_MULS + (groups - 1) * C2_TREE_MULS) + _digit_muls(work)
    return 1e3 * _imads(muls, inversions * C2_INV_SQS) / ck.H100_IMAD_PER_S


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
            lib.tm_comb_verify.argtypes = [vp, ll, i, vp, vp, ll, vp, vp,
                                           i, vp]
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


def comb_verify(rows: torch.Tensor, tables, dec_ok: torch.Tensor,
                groups: int = None) -> torch.Tensor:
    """C2: (B, ROW_BYTES) uint8 rows (pack_rows) and comb_build's
    (tables, dec_ok) on the same device -> (B,) bool.  groups: the
    groups of four lanes a signature (1, 2, 4 or 8; default
    groups_for(B)).  A row outside [0, K) fails its lane."""
    if rows.dim() != 2:
        raise ValueError(f"rows: expected (B, {ROW_BYTES}), got "
                         f"{tuple(rows.shape)}")
    B = rows.shape[0]
    _check(rows, torch.uint8, (B, ROW_BYTES), "rows")
    K = dec_ok.shape[0]
    dev = rows.device
    if dec_ok.device != dev:
        raise ValueError("comb_verify: every input must be on one device")
    G = groups_for(B) if groups is None else groups
    if G not in GROUPS:
        raise ValueError(f"groups: expected one of {GROUPS}, got {G}")
    if dev.type == "cpu":
        return comb_verify_plain(rows, tables, dec_ok)
    if not isinstance(tables, torch.Tensor) or tables.device != dev:
        raise ValueError("comb_verify: tables must be C1's tensor on "
                         f"{dev}")
    _check(tables, torch.int32, (WINDOWS, DIGITS, K, 4, 10), "tables")
    _check(dec_ok, torch.bool, (K,), "dec_ok")
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_comb_verify(rows.data_ptr(), B, G.bit_length() - 1,
                            tables.data_ptr(), dec_ok.data_ptr(), K,
                            base_comb_dev(dev).data_ptr(), out.data_ptr(),
                            dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "comb_verify")
    _count("comb_verify")
    return out.view(torch.bool)


# ---------------------------------------------------------------------------
# C2's rows
# ---------------------------------------------------------------------------

def pack_rows(r, s, k, vidx, lanes: int = None) -> np.ndarray:
    """(lanes, ROW_BYTES) uint8 rows R | s | k | table row (little-endian
    int32) from (B, 32) uint8 R, s and k and (B,) table rows; the rows
    past B (lanes >= B, default B) are zero."""
    B = len(vidx)
    rows = np.zeros((B if lanes is None else lanes, ROW_BYTES),
                    dtype=np.uint8)
    rows[:B, 0:32] = r
    rows[:B, 32:64] = s
    rows[:B, 64:96] = k
    rows[:B, 96:100] = np.asarray(vidx, dtype="<i4").reshape(B, 1) \
        .view(np.uint8)
    return rows


def unpack_rows(rows: np.ndarray) -> tuple:
    """pack_rows's rows -> (R (B, 32) uint8, the signed radix-16 digits of
    s and of k (B, 64) int8, the table rows (B,) int32)."""
    from . import ed25519 as edops
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    return (rows[:, 0:32].copy(), edops.scalars_to_digits(rows[:, 32:64]),
            edops.scalars_to_digits(rows[:, 64:96]),
            rows[:, 96:100].copy().view("<i4").reshape(-1).astype(np.int32))


# ---------------------------------------------------------------------------
# plain PyTorch versions (ops/ed25519.py's, on any device)
# ---------------------------------------------------------------------------

def comb_build_plain(pub: torch.Tensor):
    """Plain C1 on any device: (K, 32) uint8 -> (Cached tables, dec_ok)."""
    from . import ed25519 as edops
    return edops.comb_build_kernel_impl(pub)


def comb_verify_plain(rows, tables, dec_ok) -> torch.Tensor:
    """Plain C2 on any device, on comb_build_plain's Cached tables: the
    digits formed on the host (unpack_rows), then
    ops/ed25519.comb_verify_staged on the rows' device."""
    from . import ed25519 as edops
    dev = rows.device
    r, sd, kd, vidx = (torch.from_numpy(a).to(dev)
                       for a in unpack_rows(rows.cpu().numpy()))
    return edops.comb_verify_staged(r, sd, kd, vidx, *tables, dec_ok,
                                    *edops._base_comb(dev))


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
