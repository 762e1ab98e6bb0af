"""Kernel S2: batched sr25519 (schnorrkel) verification on an NVIDIA Hopper
GPU.

The counterpart of the XLA function tendermint_tpu/ops/sr25519.py:44
_verify_core with ops/ristretto.py:46 decode and :72 eq (the JAX package
has no Pallas kernel for this lane).  The wrapper verify_packed takes K1's
lane-major (128, B) uint8 row layout, rows A | R | s | k little-endian
(ops/sr25519.stage, transposed), and returns a (B,) bool verdict tensor
on the input's device.  For a CUDA tensor it launches the hand-written
kernel of csrc/sr25519_verify.cu (one signature per group of four lanes,
the body verify_sr4 in csrc/ristretto4.cuh over verify4.cuh's primitives;
built with nvcc for sm_90a on first use, cached by source hash under the
package's _build/ directory, loaded with ctypes) or raises; for a CPU
tensor it runs the plain PyTorch version (verify_packed_plain:
ops/sr25519._verify_core over ops/ristretto.py and the shared
ops/ed25519.straus_ladder).  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _nvcc
from . import cuda_ed25519 as ck
from . import field as F

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe25519.cuh", "group4.cuh", "launch.cuh", "verify4.cuh",
    "ristretto4.cuh", "sr25519_verify.cu"))

# ---------------------------------------------------------------------------
# work per signature, for the bound, counted one lane at a time as K1's
# reference count is (ops/cuda_ed25519.py): two ristretto decodes (257
# squarings and 24 multiplies each), K1's table (16 sq + 51 mul) and
# ladder (64 x (16 sq + 30 mul)), the table entry -A's T and the four
# products of the ristretto equality
# ---------------------------------------------------------------------------
FE_MULS_PER_SIG = 2 * 24 + 1 + 51 + 64 * 30 + 4
FE_SQS_PER_SIG = 2 * 257 + 16 + 64 * 16
IMADS_PER_SIG = 2 * (100 * FE_MULS_PER_SIG + 55 * FE_SQS_PER_SIG)
BYTES_PER_SIG = 128 + 1

launches = {"verify_packed": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def bound_ms(lanes: int) -> float:
    """Least time the card could take for `lanes` verifications: the larger
    of the multiply-add time and the byte time (3.35 TB/s)."""
    ops_s = lanes * IMADS_PER_SIG / ck.H100_IMAD_PER_S
    bytes_s = lanes * BYTES_PER_SIG / ck.MEM_BYTES_PER_S
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
            for fn in (lib.tm_sr25519_verify, lib.tm_sr25519_occupancy):
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
                               ck._base_table_dev(dev).data_ptr(),
                               out.data_ptr(), B, dev.index,
                               torch.cuda.current_stream(dev).cuda_stream)
    _nvcc.check_rc(lib, rc, "sr25519_verify")
    _count("verify_packed")
    return out.view(torch.bool)


def verify_packed_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch S2 on any device: (128, B) -> (B,) bool."""
    from . import sr25519
    b = packed.to(F.DTYPE) & 0xFF
    return sr25519._verify_core(b[0:32].t(), b[32:64].t(),
                                ck._digits(b[64:96]).t(),
                                ck._digits(b[96:128]).t())
