"""Kernels K4, K5 and A1 of the RLC multi-scalar multiplication
(ops/msm.py) on an NVIDIA Hopper GPU.

  K4  pallas_msm.decompress_niels_pallas -> decompress_niels(b_rows)
  K5  pallas_msm._bucket_scan_call       -> bucket_scan(table, layer_rows,
                                                        seg_len)
  A1  msm._aggregate (XLA in the JAX package, not a Pallas kernel)
                                         -> aggregate(buckets, W, c)

For a CUDA tensor each wrapper launches the hand-written kernel of
csrc/msm.cu (built with nvcc for sm_90a on first use, loaded with ctypes)
or raises; for a CPU tensor it runs the kernel's plain PyTorch version.

Two limb layouts.  The kernels keep a field element as ten 25.5-bit
int32 limbs (csrc/fe25519.cuh) with the coordinate axis next to last:
niels rows (m, 3, 10), bucket sums (K, 4, 10).  The plain versions keep
the JAX package's 22 x 12-bit limbs (ops/field.py) with the coordinate
axis first: (3, NLIMB, m), (4, NLIMB, K).  `to_bytes10` and `to_bytes22`
freeze and encode either layout on its device into (coords, N, 32)
canonical bytes; `limbs22_from_bytes` turns such bytes back into the
plain layout, so a plain version can run on a kernel's output.  A1
returns bytes in both cases.

K4 computes what its plain version computes in the same order, so the
two are compared as bytes.  K5 and A1 add the same points in another
order than their plain versions (the JAX package's), so they give the
same points in other projective coordinates: `points_mismatch` compares
them as points.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _nvcc
from . import curve as C
from . import field as F
from .cuda_ed25519 import H100_IMAD_PER_S, MEM_BYTES_PER_S, fe10_limbs

SOURCES = tuple(os.path.join(_nvcc.CSRC_DIR, f) for f in (
    "fe25519.cuh", "fe25519_2.cuh", "decompress.cuh", "launch.cuh",
    "msm_steps.cuh", "msm.cu"))

# ---------------------------------------------------------------------------
# work per call (csrc/msm.cu header note), for the bounds: a field multiply
# is 100 products 32x32 -> 64, a square 55, each two 32-bit multiply-adds
# ---------------------------------------------------------------------------
DECOMPRESS_SQS = 255   # y^2, v^2, v3^2, x^2 and the 251 of (p-5)/8
DECOMPRESS_MULS = 21   # 22 when the root needs the sqrt(-1) factor
DECOMPRESS_BYTES = 32 + 3 * 40 + 1
MADD_MULS = 7
AGG_MULS_PER_DIGIT = 2 * (1 + 8)   # twice to_cached + add_cached
NIELS_BYTES, EXT_BYTES = 3 * 40, 4 * 40


def _bound(imads: float, nbytes: float) -> float:
    return 1e3 * max(imads / H100_IMAD_PER_S, nbytes / MEM_BYTES_PER_S)


def bound_ms_decompress(m: int) -> float:
    """K4 on m points."""
    products = 100 * DECOMPRESS_MULS + 55 * DECOMPRESS_SQS
    return _bound(2 * m * products, m * DECOMPRESS_BYTES)


def bound_ms_bucket_scan(items: int, table_rows: int, T: int,
                         K: int) -> float:
    """K5 for `items` bucket members (the madds the bucket sums need; the
    layered scan itself runs K x T), reading the table and the (T, K)
    row indices once and writing K bucket sums."""
    nbytes = table_rows * NIELS_BYTES + 4 * T * K + K * EXT_BYTES
    return _bound(2 * items * 100 * MADD_MULS, nbytes)


def bound_ms_aggregate(W: int, c: int) -> float:
    """A1 over W windows of 2^c buckets."""
    imads = 2 * W * ((1 << c) - 1) * AGG_MULS_PER_DIGIT * 100
    return _bound(imads, (W << c) * EXT_BYTES + 4 * W * 32)


launches = {"decompress_niels": 0, "bucket_scan": 0, "aggregate": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
build_info: dict = {}


def build() -> str:
    """Compile csrc/msm.cu (once per source hash); returns its path and
    fills `build_info` (seconds, nvcc's -Xptxas -v report)."""
    info = _nvcc.build("msm", SOURCES)
    build_info.update(info)
    return info["path"]


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.tm_decompress_niels.argtypes = [vp, vp, vp, ll, i, vp]
            lib.tm_bucket_scan.argtypes = [vp, vp, vp, vp, i, ll, i, i, vp]
            lib.tm_aggregate.argtypes = [vp, vp, i, i, i, vp]
            for fn in (lib.tm_decompress_niels, lib.tm_bucket_scan,
                       lib.tm_aggregate):
                fn.restype = ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.tm_msm_occupancy.argtypes = [i, ip, ip]
            lib.tm_msm_occupancy.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def occupancy() -> dict:
    """Blocks of how many threads fit on one SM, per kernel (the CUDA
    runtime's occupancy calculator; A1 at c = 8): {kernel: (blocks,
    threads)}."""
    lib = kernels()
    out = {}
    for which, name in enumerate(("decompress_niels", "bucket_scan",
                                  "aggregate")):
        blocks, threads = ctypes.c_int(), ctypes.c_int()
        _nvcc.check_rc(lib, lib.tm_msm_occupancy(
            which, ctypes.byref(blocks), ctypes.byref(threads)), name)
        out[name] = (blocks.value, threads.value)
    return out


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(t: torch.Tensor, dtypes, shape, name: str) -> None:
    """dtype in `dtypes`, contiguous, and each dimension equal to `shape`
    where that entry is not None."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# layouts: canonical bytes of either limb layout, and back
# ---------------------------------------------------------------------------

_W10 = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)


def _round_carry(h: list, i: int) -> None:
    s = _W10[i + 1] - _W10[i]
    c = (h[i] + (1 << (s - 1))) >> s
    h[i + 1] = h[i + 1] + c
    h[i] = h[i] - (c << s)


def _floor_chain(h: list) -> torch.Tensor:
    for i in range(9):
        s = _W10[i + 1] - _W10[i]
        c = h[i] >> s
        h[i + 1] = h[i + 1] + c
        h[i] = h[i] - (c << s)
    c9 = h[9] >> 25
    h[9] = h[9] - (c9 << 25)
    return c9


def to_bytes10(x: torch.Tensor) -> torch.Tensor:
    """(N, coords, 10) limbs of the kernels' layout, each 16-bounded
    (fe25519.cuh) -> (coords, N, 32) uint8 canonical encodings: the
    rounding carry chain of fe_carry_wide, then fe_freeze's floor chains
    (a carried value is below 2^254.01 in magnitude, so one + p makes a
    negative one canonical)."""
    h = list(x.to(torch.int64).permute(2, 1, 0).unbind(0))  # 10 x (C, N)
    for i in (0, 4, 1, 5, 2, 6, 3, 7, 4, 8):
        _round_carry(h, i)
    c = (h[9] + (1 << 24)) >> 25
    h[0] = h[0] + 19 * c
    h[9] = h[9] - (c << 25)
    _round_carry(h, 0)
    c9 = _floor_chain(h)        # -1 or 0
    h[0] = h[0] + 19 * c9
    _floor_chain(h)
    out = []
    for j in range(32):
        lo = 8 * j
        i = max(k for k in range(10) if _W10[k] <= lo)
        v = h[i] >> (lo - _W10[i])
        if i < 9 and lo + 8 > _W10[i + 1]:
            v = v | (h[i + 1] << (_W10[i + 1] - lo))
        out.append(v & 0xFF)
    return torch.stack(out, -1).to(torch.uint8)


def to_bytes22(x: torch.Tensor) -> torch.Tensor:
    """(coords, NLIMB, N) limbs of the plain layout -> (coords, N, 32)
    uint8 canonical encodings."""
    return F.to_bytes(x.transpose(0, 1)).permute(1, 2, 0).to(torch.uint8)


def limbs22_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(coords, N, 32) canonical encodings -> (coords, NLIMB, N) limbs of
    the plain layout."""
    limbs, _ = F.bytes_to_limbs(b.permute(2, 0, 1))
    return limbs.transpose(0, 1).contiguous()


def niels10_const(vals) -> torch.Tensor:
    """(1, 3, 10) int32 niels row of three field constants in the kernels'
    layout."""
    return torch.tensor([[fe10_limbs(v) for v in vals]], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def decompress_niels(b_rows: torch.Tensor):
    """K4: (32, m) uint8 lane-major compressed points -> (niels rows of
    the negated points, ok (m,) bool).  Niels rows are (m, 3, 10) int32
    from the kernel, (3, NLIMB, m) int64 from the plain version."""
    _check(b_rows, (torch.uint8,), (32, None), "b_rows")
    if b_rows.device.type == "cpu":
        return decompress_niels_plain(b_rows)
    dev = b_rows.device
    m = b_rows.shape[1]
    niels = torch.empty((m, 3, 10), dtype=torch.int32, device=dev)
    ok = torch.empty(m, dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_decompress_niels(b_rows.data_ptr(), niels.data_ptr(),
                                 ok.data_ptr(), m, dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "decompress_niels")
    _count("decompress_niels")
    return niels, ok.view(torch.bool)


def scan_segments(K: int) -> int:
    """K5's segments a bucket lane (csrc/msm.cu): the power of two that
    makes K x S about 65,536 threads (one wave of 256-thread blocks at two
    an SM), at most 64, so that a block holds at least four lanes."""
    s = max(1, 65536 // max(K, 1))
    return min(64, 1 << (s.bit_length() - 1))


def bucket_scan(table: torch.Tensor, layer_rows: torch.Tensor,
                seg_len: "torch.Tensor | None" = None):
    """K5: for every bucket lane k, the sum of the table rows
    layer_rows[:, k] (T, K) int32, starting from the identity.
    seg_len (K,) int32: lane k's members are its first seg_len[k] rows;
    the kernel reads no row past them (the layered layout fills them with
    row 0, the identity), the plain version adds all T.  None: T for
    every lane.  The kernel cuts a lane into `scan_segments(K)` segments.
    Kernel layout: table (R, 3, 10) int32 -> (K, 4, 10) int32; plain
    layout: (3, NLIMB, R) -> (4, NLIMB, K)."""
    _check(layer_rows, (torch.int32,), (None, None), "layer_rows")
    T, K = layer_rows.shape
    if seg_len is not None:
        _check(seg_len, (torch.int32,), (K,), "seg_len")
        if seg_len.device != layer_rows.device:
            raise ValueError("seg_len and layer_rows must be on one device")
    if layer_rows.device.type == "cpu":
        _check(table, (torch.int64,), (3, F.NLIMB, None), "table")
        return bucket_scan_plain(table, layer_rows)
    _check(table, (torch.int32,), (None, 3, 10), "table")
    if table.device != layer_rows.device:
        raise ValueError("table and layer_rows must be on one device")
    lo, hi = torch.aminmax(layer_rows)
    if int(lo) < 0 or int(hi) >= table.shape[0]:
        raise ValueError("layer_rows index outside the table")
    dev = table.device
    if seg_len is None:
        seg_len = torch.full((K,), T, dtype=torch.int32, device=dev)
    out = torch.empty((K, 4, 10), dtype=torch.int32, device=dev)
    lib = kernels()
    rc = lib.tm_bucket_scan(table.data_ptr(), layer_rows.data_ptr(),
                            seg_len.data_ptr(), out.data_ptr(), T, K,
                            scan_segments(K), dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "bucket_scan")
    _count("bucket_scan")
    return out


def aggregate(buckets: torch.Tensor, W: int, c: int) -> torch.Tensor:
    """A1: bucket sums of W windows x 2^c digits -> (4, W, 32) uint8
    canonical encodings of X, Y, Z, T of sum_b b * S_{w,b}.  Kernel
    layout (W * 2^c, 4, 10) int32, 1 <= c <= 8; plain layout
    (4, NLIMB, W * 2^c)."""
    if buckets.device.type == "cpu":
        return aggregate_plain(buckets, W, c)
    if not 1 <= c <= 8:
        raise ValueError(f"aggregate: c must be in 1..8, got {c}")
    _check(buckets, (torch.int32,), (W << c, 4, 10), "buckets")
    dev = buckets.device
    out = torch.empty((4, W, 32), dtype=torch.uint8, device=dev)
    lib = kernels()
    rc = lib.tm_aggregate(buckets.data_ptr(), out.data_ptr(), W, c,
                          dev.index, _stream(dev))
    _nvcc.check_rc(lib, rc, "aggregate")
    _count("aggregate")
    return out


def points_mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """a, b: (4, N, 32) uint8 canonical encodings of X, Y, Z, T on one
    device -> the number of positions i where a_i and b_i are not the
    same point (X1 Z2 != X2 Z1 or Y1 Z2 != Y2 Z1 mod p) or a_i is not a
    valid extended point (Z = 0, T Z != X Y, or -X^2 + Y^2 != Z^2 + d T^2).
    b is the reference; its validity is not checked."""
    a, b = a.contiguous(), b.contiguous()
    _check(a, (torch.uint8,), (4, None, 32), "a")
    _check(b, (torch.uint8,), tuple(a.shape), "b")
    x1, y1, z1, t1 = (F.bytes_to_limbs(v.t())[0] for v in a)
    x2, y2, z2, t2 = (F.bytes_to_limbs(v.t())[0] for v in b)
    xz, zx, yz, zy, tz, xy, xx, yy, zz, tt = F.mul_many([
        (x1, z2), (x2, z1), (y1, z2), (y2, z1), (t1, z1), (x1, y1),
        (x1, x1), (y1, y1), (z1, z1), (t1, t1)])
    dtt = F.mul(tt, F.const(C.D_INT, tt))
    bad = (~F.eq(xz, zx) | ~F.eq(yz, zy) | F.is_zero(z1) | ~F.eq(tz, xy)
           | ~F.eq(yy, xx + zz + dtt))
    return int(bad.sum())


# ---------------------------------------------------------------------------
# plain PyTorch versions (ops/field and ops/curve, the JAX package's limbs)
# ---------------------------------------------------------------------------

def decompress_niels_plain(b_rows: torch.Tensor):
    """curve.decompress, then the negation of msm._build_table: niels(-P)
    = (y - x, y + x, -2dxy).  -> ((3, NLIMB, m) int64, (m,) bool)."""
    y, sign = F.bytes_to_limbs(b_rows)
    pt, ok = C.decompress(y, sign)
    ypx = F.carry_lazy(pt.y - pt.x)
    ymx = F.carry_lazy(pt.y + pt.x)
    t2d = F.mul(F.carry_lazy(-pt.t), F.const(C.D2_INT, pt.t))
    return torch.stack([ypx, ymx, t2d]), ok


def bucket_scan_plain(table: torch.Tensor,
                      layer_rows: torch.Tensor) -> torch.Tensor:
    """msm._bucket_scan_xla, gathering one layer per step from the
    (3, NLIMB, R) table instead of taking (T, NLIMB, K) layers."""
    T, K = layer_rows.shape
    acc = C.identity((K,), table.device)
    rows = layer_rows.to(torch.int64)
    for t in range(T):
        layer = table[:, :, rows[t]]
        acc = C.madd_niels(acc, C.Niels(*layer.unbind(0)))
    return torch.stack(list(acc))


def aggregate_plain(buckets: torch.Tensor, W: int, c: int) -> torch.Tensor:
    """msm._aggregate on (4, NLIMB, W * 2^c) bucket sums: from the top
    digit down, suffix += S_b and total += suffix, each by to_cached +
    add_cached -> (4, W, 32) canonical encodings."""
    e = buckets.reshape(4, F.NLIMB, W, 1 << c)
    suffix = total = C.identity((W,), buckets.device)
    for b in range((1 << c) - 1, 0, -1):
        suffix = C.add_cached(suffix, C.to_cached(C.Ext(*e[..., b])))
        total = C.add_cached(total, C.to_cached(suffix))
    return to_bytes22(torch.stack(list(total)))
