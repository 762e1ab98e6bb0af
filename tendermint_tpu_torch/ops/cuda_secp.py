"""Kernel S1: batched secp256k1 BIP-340 verification on an NVIDIA Hopper
GPU.

The counterpart of the XLA function tendermint_tpu/ops/secp.py:201
_verify_core (the JAX package has no Pallas kernel for this lane).  The
wrapper verify_rows takes lane-major (128, B) uint8 rows px | rx | s | e,
each 32 bytes big-endian (ops/secp.stage, transposed), and returns a (B,)
bool verdict tensor on the input's device.  For a CUDA tensor it launches
the hand-written kernel of csrc/secp256k1_verify.cu (one signature per
group of four lanes, the body secp_verify4 in csrc/secp4.cuh over the
field of csrc/fe_secp.cuh; built with nvcc for sm_90a on first use,
cached by source hash under the package's _build/ directory, loaded with
ctypes) or raises; for a CPU tensor it runs the
plain PyTorch version (verify_rows_plain: ops/secp._verify_core over
ops/field_secp.py, the JAX package's formulas).

The kernel keeps its field in eight 32-bit limbs, canonical; the plain
field in 22 limbs of 12 bits.  So the kernel is held against the plain
version as verdict bitmaps, and its field as canonical values through
fe_secp_selftest.  `launches` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import _nvcc
from . import field_secp as FS

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe_secp.cuh", "group4.cuh", "launch.cuh", "secp4.cuh",
    "secp256k1_verify.cu"))

# ---------------------------------------------------------------------------
# work per signature, for the bound (the kernel's own formulas, see the
# header of csrc/secp256k1_verify.cu): 689 field multiplies and 1,861
# squarings, plus a mixed add (7 M + 4 S) per nonzero digit of s and a
# complete add (11 M + 5 S) per nonzero digit of e.  A multiply is 64 + 8
# 32x32->64-bit products (the schoolbook product and the fold), a square
# 36 + 8 (the 8 diagonal and 28 cross products a dedicated square needs),
# each product two multiply-add halves
# ---------------------------------------------------------------------------
FE_MULS_FIXED = 689
FE_SQS_FIXED = 1861
FE_MULS_G_ADD, FE_SQS_G_ADD = 7, 4
FE_MULS_P_ADD, FE_SQS_P_ADD = 11, 5
IMADS_PER_MUL = 2 * (64 + 8)
IMADS_PER_SQR = 2 * (36 + 8)
H100_IMAD_PER_S = 132 * 64 * 1.98e9
MEM_BYTES_PER_S = 3.35e12
BYTES_PER_SIG = 128 + 1

launches = {"verify_rows": 0, "fe_secp_selftest": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def digit_adds(rows) -> tuple:
    """(nonzero nibbles of s, of e) summed over the lanes of (128, B)
    rows: the additions the ladder performs on this data."""
    b = torch.as_tensor(rows).to("cpu", torch.int64) & 0xFF

    def nonzero(r):
        return int(((r >> 4) != 0).sum() + ((r & 15) != 0).sum())
    return nonzero(b[64:96]), nonzero(b[96:128])


def bound_ms(lanes: int, g_adds: "int | None" = None,
             p_adds: "int | None" = None) -> float:
    """Least time the card could take for `lanes` verifications: the larger
    of the multiply-add time and the byte time (3.35 TB/s).  g_adds and
    p_adds are the ladder's additions of this run's data (digit_adds);
    by default 60 a lane each (15 of 16 digits nonzero)."""
    g_adds = lanes * 60 if g_adds is None else g_adds
    p_adds = lanes * 60 if p_adds is None else p_adds
    muls = lanes * FE_MULS_FIXED + FE_MULS_G_ADD * g_adds \
        + FE_MULS_P_ADD * p_adds
    sqs = lanes * FE_SQS_FIXED + FE_SQS_G_ADD * g_adds \
        + FE_SQS_P_ADD * p_adds
    ops_s = (muls * IMADS_PER_MUL + sqs * IMADS_PER_SQR) / H100_IMAD_PER_S
    bytes_s = lanes * BYTES_PER_SIG / MEM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
build_info: dict = {}


def build() -> str:
    """Compile csrc/secp256k1_verify.cu (once per source hash); returns the
    library's path.  `build_info` receives the build seconds and nvcc's
    -Xptxas -v report."""
    info = _nvcc.build("secp256k1_verify", SOURCES)
    build_info.update(info)
    return info["path"]


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.tm_secp_verify.argtypes = [vp, vp, vp, ll, i, vp]
            lib.tm_fe_secp_selftest.argtypes = [vp, vp, vp, ll, i, vp]
            lib.tm_secp_occupancy.argtypes = [ip, ip]
            for fn in (lib.tm_secp_verify, lib.tm_fe_secp_selftest,
                       lib.tm_secp_occupancy):
                fn.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def occupancy() -> dict:
    """{"secp_verify": (blocks, threads)}: blocks that fit on one SM."""
    lib = kernels()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _nvcc.check_rc(lib, lib.tm_secp_occupancy(ctypes.byref(blocks),
                                              ctypes.byref(threads)),
                   "secp_verify")
    return {"secp_verify": (blocks.value, threads.value)}


def g_table8() -> np.ndarray:
    """jG, j = 0..15, affine, as (16, 2, 8) uint32 little-endian words (the
    kernel's layout; entry 0, infinity, is zeros and never read)."""
    from . import secp
    out = np.zeros((16, 2, 8), dtype=np.uint32)
    for j, pt in enumerate(secp.g_multiples()):
        if pt is None:
            continue
        for c in range(2):
            out[j, c] = [(pt[c] >> (32 * w)) & 0xFFFFFFFF for w in range(8)]
    return out


_g_cache: dict = {}
_g_lock = threading.Lock()


def _g_table_dev(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    with _g_lock:
        t = _g_cache.get(key)
    if t is None:
        t = torch.from_numpy(g_table8().view(np.int32).reshape(-1)).to(dev)
        with _g_lock:
            t = _g_cache.setdefault(key, t)
    return t


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def verify_rows(rows: torch.Tensor) -> torch.Tensor:
    """S1: (128, B) uint8 lane-major rows px | rx | s | e (big-endian) ->
    (B,) bool.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[0] != 128:
        raise ValueError(f"rows: expected (128, B) uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows: must be contiguous")
    if rows.device.type == "cpu":
        return verify_rows_plain(rows)
    dev = rows.device
    B = rows.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_secp_verify(rows.data_ptr(), _g_table_dev(dev).data_ptr(),
                            out.data_ptr(), B, dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "secp_verify")
    _count("verify_rows")
    return out.view(torch.bool)


def fe_secp_selftest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S1's field on given elements: a, b (n, 32) uint8 little-endian
    values below 2^256 -> (7, n, 32) uint8 canonical little-endian
    encodings of a mod p, a b, a^2, a + b, a - b, a^(p-2), a^((p+1)/4).
    CPU tensors run fe_secp_selftest_plain."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (n, 32) uint8")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must match in shape and device")
    if a.device.type == "cpu":
        return fe_secp_selftest_plain(a, b)
    dev = a.device
    n = a.shape[0]
    out = torch.empty((7, n, 32), dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_fe_secp_selftest(a.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), n, dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "fe_secp_selftest")
    _count("fe_secp_selftest")
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _limbs_le(b: torch.Tensor) -> torch.Tensor:
    """(32, B) little-endian bytes -> (NLIMB, B) radix-2^12 limbs of the
    full 256-bit value."""
    from .cuda_ed25519 import _bytes_to_limbs12
    return _bytes_to_limbs12(b, FS.NLIMB)


def _nibbles(b: torch.Tensor) -> torch.Tensor:
    """(32, B) big-endian bytes -> (64, B) nibbles, most significant
    first."""
    return torch.stack([b >> 4, b & 15], 1).reshape(64, -1)


def verify_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch S1 on any device: (128, B) -> (B,) bool."""
    from . import secp
    b = rows.to(FS.DTYPE) & 0xFF
    return secp._verify_core(_limbs_le(b[0:32].flip(0)),
                             _limbs_le(b[32:64].flip(0)),
                             _nibbles(b[64:96]), _nibbles(b[96:128]))


def _to_bytes_le(limbs: torch.Tensor) -> torch.Tensor:
    """(NLIMB, n) limbs -> (n, 32) canonical little-endian bytes."""
    f = FS.freeze(limbs)
    out = []
    for j in range(32):
        limb, sh = divmod(8 * j, FS.RADIX)
        v = f[limb] >> sh
        if sh > FS.RADIX - 8 and limb + 1 < FS.NLIMB:
            v = v | (f[limb + 1] << (FS.RADIX - sh))
        out.append(v & 0xFF)
    return torch.stack(out, 1).to(torch.uint8)


def fe_secp_selftest_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fa = _limbs_le(a.t().to(FS.DTYPE))
    fb = _limbs_le(b.t().to(FS.DTYPE))
    outs = (fa, FS.mul(fa, fb), FS.sqr(fa), FS.carry(fa + fb),
            FS.carry(fa - fb), FS.invert(fa), FS.sqrt(fa))
    return torch.stack([_to_bytes_le(o) for o in outs])
