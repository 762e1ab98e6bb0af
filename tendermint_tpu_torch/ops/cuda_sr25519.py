"""Kernel S2: batched sr25519 (schnorrkel) verification on an NVIDIA Hopper
GPU.

The counterpart of the XLA function tendermint_tpu/ops/sr25519.py:44
_verify_core with ops/ristretto.py:46 decode and :72 eq (the JAX package
has no Pallas kernel for this lane).  The wrapper verify_packed takes K1's
lane-major (128, B) uint8 row layout, rows A | R | s | k little-endian
(ops/sr25519.stage, transposed), and returns a (B,) bool verdict tensor
on the input's device.  For a CUDA tensor it launches the hand-written
kernel of csrc/sr25519_verify.cu (one signature per group of four lanes,
the body verify_sr4 in csrc/ristretto4.cuh on S2's own group steps and
the two-round-carry field of csrc/fe25519_2.cuh, s in signed radix-256
digits against base_table_b; built with nvcc for sm_90a on first use,
cached by source hash under the package's _build/ directory, loaded with
ctypes) or raises; for a CPU tensor it runs the plain PyTorch version
(verify_packed_plain:
ops/sr25519._verify_core over ops/ristretto.py and the shared
ops/ed25519.straus_ladder).  `launches` counts kernel launches per
wrapper; fe2_selftest runs S2's field on given elements so that it can be
held against the plain field (ops/field.py).
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
from .curve import D_INT

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe25519.cuh", "fe25519_2.cuh", "group4.cuh", "launch.cuh",
    "verify4.cuh", "ristretto4.cuh", "sr25519_verify.cu"))

# ---------------------------------------------------------------------------
# work per signature, for the bound, counted one lane at a time as K1's
# reference count is (ops/cuda_ed25519.py): two ristretto decodes (257
# squarings and 24 multiplies each), the table entry -A's T, K1's table
# of -A (16 sq + 51 mul, below the 64 multiplies of the kernel's own), the
# ladder's 256 doublings (4 sq + 4 mul each) and the four products of the
# ristretto equality; then 7 multiplies an addition (a niels addition of
# B; the kernel's cached addition of -A takes 8), one for each nonzero
# signed digit: s in radix 256 (at most 32), k in radix 16 (at most 64)
# ---------------------------------------------------------------------------
FE_MULS_FIXED = 2 * 24 + 1 + 51 + 256 * 4 + 4
FE_SQS_FIXED = 2 * 257 + 16 + 256 * 4
FE_MULS_PER_ADD = 7
BYTES_PER_SIG = 128 + 1
# the niels table of B (129 entries x 3 x 10 int32 limbs), read once a launch
BYTES_BASE_TABLE = 129 * 3 * 10 * 4

launches = {"verify_packed": 0, "fe2_selftest": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def digit_adds(rows) -> tuple:
    """(nonzero signed radix-256 digits of s, nonzero signed radix-16
    digits of k) summed over the lanes of (128, B) rows: the additions of
    B and of -A that the ladder performs on this data (the kernel recodes
    s + 0x80..80 by bytes and k + 0x88..8 by nibbles)."""
    b = torch.as_tensor(rows).to("cpu", torch.int64) & 0xFF

    def recode(x, add):
        carry, out = torch.zeros_like(x[0]), []
        for j in range(x.shape[0]):
            v = x[j] + add + carry
            out.append(v & 0xFF)
            carry = v >> 8
        return torch.stack(out)
    ts, tk = recode(b[64:96], 0x80), recode(b[96:128], 0x88)
    return (int((ts != 0x80).sum()),
            int(((tk & 15) != 8).sum() + ((tk >> 4) != 8).sum()))


def bound_ms(lanes: int, b_adds: "int | None" = None,
             a_adds: "int | None" = None) -> float:
    """Least time the card could take for `lanes` verifications: the larger
    of the multiply-add time and the byte time (3.35 TB/s).  b_adds and
    a_adds are the ladder's additions of B and of -A on this run's data
    (digit_adds); by default 32 and 60 a lane."""
    b_adds = lanes * 32 if b_adds is None else b_adds
    a_adds = lanes * 60 if a_adds is None else a_adds
    muls = lanes * FE_MULS_FIXED + FE_MULS_PER_ADD * (b_adds + a_adds)
    sqs = lanes * FE_SQS_FIXED
    ops_s = 2 * (100 * muls + 55 * sqs) / ck.H100_IMAD_PER_S
    bytes_s = (lanes * BYTES_PER_SIG + BYTES_BASE_TABLE) / ck.MEM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
build_info: dict = {}


def build() -> str:
    """Compile csrc/sr25519_verify.cu (once per source hash); returns the
    library's path.  `build_info` receives the build seconds and nvcc's
    -Xptxas -v report."""
    info = _nvcc.build("sr25519_verify", SOURCES)
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
            lib.tm_sr25519_verify.argtypes = [vp, vp, vp, ll, i, vp]
            lib.tm_sr25519_occupancy.argtypes = [ip, ip]
            lib.tm_fe2_selftest.argtypes = [vp, vp, vp, ll, i, vp]
            for fn in (lib.tm_sr25519_verify, lib.tm_sr25519_occupancy,
                       lib.tm_fe2_selftest):
                fn.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def occupancy() -> dict:
    """{"sr25519_verify": (blocks, threads)}: blocks that fit on one SM."""
    lib = kernels()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _nvcc.check_rc(lib, lib.tm_sr25519_occupancy(ctypes.byref(blocks),
                                                 ctypes.byref(threads)),
                   "sr25519_verify")
    return {"sr25519_verify": (blocks.value, threads.value)}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """S2: (128, B) uint8 lane-major rows (A | R | s | k) -> (B,) bool.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 \
            or packed.shape[0] != 128:
        raise ValueError(f"packed: expected (128, B) uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("packed: must be contiguous")
    if packed.device.type == "cpu":
        return verify_packed_plain(packed)
    dev = packed.device
    B = packed.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_sr25519_verify(packed.data_ptr(),
                               _base_b_dev(dev).data_ptr(),
                               out.data_ptr(), B, dev.index,
                               torch.cuda.current_stream(dev).cuda_stream)
    _nvcc.check_rc(lib, rc, "sr25519_verify")
    _count("verify_packed")
    return out.view(torch.bool)


def base_table_b() -> np.ndarray:
    """The 129 niels entries j*B, j = 0..128, as (129, 3, 10) int32 in the
    kernel's limb layout (canonical limbs): the table of s's signed
    radix-256 digits, built with the host reference (crypto/_edref)."""
    from ..crypto import _edref as R
    out = np.zeros((129, 3, 10), dtype=np.int32)
    pt = (0, 1, 1, 0)
    for j in range(129):
        x, y, z, _ = pt
        zi = pow(z, R.P - 2, R.P)
        ax, ay = x * zi % R.P, y * zi % R.P
        for f, v in enumerate(((ay + ax), (ay - ax),
                               2 * D_INT * ax * ay)):
            out[j, f] = ck.fe10_limbs(v)
        pt = R._add(pt, R.BASE)
    return out


_base_b_cache: dict = {}
_base_b_lock = threading.Lock()


def _base_b_dev(dev: torch.device) -> torch.Tensor:
    key = str(dev)
    with _base_b_lock:
        t = _base_b_cache.get(key)
    if t is None:
        t = torch.from_numpy(base_table_b().reshape(-1)).to(dev)
        with _base_b_lock:
            t = _base_b_cache.setdefault(key, t)
    return t


def fe2_selftest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S2's field on given elements: a, b (n, 32) uint8 little-endian (bit
    255 ignored) -> (5, n, 32) uint8 canonical encodings of a mod p,
    fe_mul2(a, b), fe_mul2(b, a), fe_sq2(a) and a^((p-5)/8) by the power
    chain on that field.  CPU tensors run fe2_selftest_plain."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (n, 32) uint8")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must match in shape and device")
    if a.device.type == "cpu":
        return fe2_selftest_plain(a, b)
    dev = a.device
    n = a.shape[0]
    out = torch.empty((5, n, 32), dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_fe2_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                             dev.index,
                             torch.cuda.current_stream(dev).cuda_stream)
    _nvcc.check_rc(lib, rc, "fe2_selftest")
    _count("fe2_selftest")
    return out


def fe2_selftest_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fe2_selftest on the plain field (ops/field.py)."""
    fa, _ = F.bytes_to_limbs(a.t())
    fb, _ = F.bytes_to_limbs(b.t())
    ab = F.to_bytes(F.mul(fa, fb))
    outs = [F.to_bytes(fa), ab, ab, F.to_bytes(F.sqr(fa)),
            F.to_bytes(F.pow_p58(fa))]
    return torch.stack([o.t() for o in outs]).to(torch.uint8)


def verify_packed_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch S2 on any device: (128, B) -> (B,) bool."""
    from . import sr25519
    b = packed.to(F.DTYPE) & 0xFF
    return sr25519._verify_core(b[0:32].t(), b[32:64].t(),
                                ck._digits(b[64:96]).t(),
                                ck._digits(b[96:128]).t())
