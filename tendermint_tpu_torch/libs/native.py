"""ctypes loader for the native host library (native/staging.c and
native/ecverify.c).

The staging C code (batched SHA-512, mod-L reduction, s < L screening and
the commit sign-bytes assembler) and the host verification lanes of the
non-ed25519 schemes (BIP-340 secp256k1 and schnorrkel sr25519 batch
verify, and the sr25519 merlin stager of the device lane) are compiled
together to one shared object at first use, cached in the package's
`_build/` directory under a source hash, and called through ctypes with
numpy buffers.  Every entry point returns None when no C toolchain
exists, and the callers fall back to hashlib/numpy/pure Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "staging.c")
_SRC_EC = os.path.join(_PKG_DIR, "native", "ecverify.c")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """Compile staging.c + ecverify.c -> cached .so; returns path or None
    on failure."""
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        with open(_SRC_EC, "rb") as f:
            src += f.read()
    except OSError:
        return None
    import platform

    # Baseline ISA only (no -march=native): the kernels are scalar 64-bit
    # integer code that gains nothing from vector extensions, and a cached
    # .so shared across hosts of the same platform.machine() must never
    # SIGILL on the weakest of them.  The flags are part of the cache tag
    # so a flag change invalidates stale artifacts.
    flags = ("-O3", "-fPIC", "-shared")
    tag = hashlib.sha256(
        src + platform.machine().encode()
        + " ".join(flags).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"_staging_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process tmp name: concurrent first-use builders (test workers)
    # must not interleave writes before the atomic publish
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run([cc, *flags, "-o", tmp, _SRC, _SRC_EC],
                                   capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                os.replace(tmp, so)
                return so
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def get_lib():
    """The loaded CDLL, or None if unavailable (no toolchain / failed)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        so = _build()
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                u64p = ctypes.POINTER(ctypes.c_uint64)
                i64p = ctypes.POINTER(ctypes.c_int64)
                u64 = ctypes.c_uint64
                lib.tm_sha512_prefixed.argtypes = [u8p, u8p, u64, u8p, u64]
                lib.tm_sha512_batch.argtypes = [u8p, u8p, u64p, u8p, u64]
                lib.tm_scalar_canonical.argtypes = [u8p, u8p, u64]
                lib.tm_mod_l.argtypes = [u8p, u8p, u64]
                lib.tm_challenge_prefixed.argtypes = [u8p, u8p, u64, u8p, u64]
                lib.tm_challenge_batch.argtypes = [u8p, u8p, u64p, u8p, u64]
                lib.tm_rlc_scalars.argtypes = [u8p, u8p, u8p, u8p, u8p, u64]
                lib.tm_vote_sign_bytes.argtypes = [
                    i64p, i64p, u8p, u8p, u64, u8p, u64, u8p, u64,
                    u8p, u64p, u64]
                lib.tm_secp_verify_batch.argtypes = [u8p, u8p, u64p, u8p,
                                                     u8p, u8p, u64]
                lib.tm_sr25519_verify_batch.argtypes = [u8p, u8p, u64p,
                                                        u8p, u8p, u8p, u64]
                lib.tm_sr25519_stage.argtypes = [u8p, u8p, u64p, u8p,
                                                 u8p, u8p, u8p, u64]
                for fn in (lib.tm_secp_verify_batch,
                           lib.tm_sr25519_verify_batch,
                           lib.tm_sr25519_stage):
                    fn.restype = None
                for fn in (lib.tm_sha512_prefixed, lib.tm_sha512_batch,
                           lib.tm_scalar_canonical, lib.tm_mod_l,
                           lib.tm_challenge_prefixed,
                           lib.tm_challenge_batch, lib.tm_rlc_scalars,
                           lib.tm_vote_sign_bytes):
                    fn.restype = None
                _lib = lib
            except OSError:
                _lib = None
        _tried = True
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def sha512_prefixed(prefix: np.ndarray, msgs, out: np.ndarray | None = None
                    ) -> np.ndarray | None:
    """digest[i] = SHA-512(prefix[i] || msg[i]) for a whole batch.

    prefix: (B, 64) uint8 contiguous.  msgs: (B, mlen) uint8 array
    (fixed-width fast path) or a list of bytes (variable width).
    Returns (B, 64) uint8, or None when the native library is missing
    (caller falls back to hashlib).
    """
    lib = get_lib()
    if lib is None:
        return None
    B = prefix.shape[0]
    assert prefix.dtype == np.uint8 and prefix.shape == (B, 64) \
        and prefix.flags.c_contiguous
    if out is None:
        out = np.empty((B, 64), dtype=np.uint8)
    if isinstance(msgs, np.ndarray):
        msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
        assert msgs.shape[0] == B
        lib.tm_sha512_prefixed(_u8p(prefix), _u8p(msgs),
                               ctypes.c_uint64(msgs.shape[1]), _u8p(out),
                               ctypes.c_uint64(B))
        return out
    buf, offsets = _ragged(msgs, B)
    lib.tm_sha512_batch(_u8p(prefix), _u8p(buf), _u64p(offsets), _u8p(out),
                        ctypes.c_uint64(B))
    return out


def _ragged(msgs, B):
    """(buf, offsets) for a list of bytes or a RaggedBytes (zero-copy)."""
    from tendermint_tpu_torch.libs.ragged import RaggedBytes

    if isinstance(msgs, RaggedBytes):
        assert len(msgs) == B
        buf = np.ascontiguousarray(msgs.buf)
        if buf.size == 0:
            buf = np.zeros(1, dtype=np.uint8)
        return buf, np.ascontiguousarray(msgs.offsets, dtype=np.uint64)
    lens = np.fromiter((len(m) for m in msgs), dtype=np.uint64, count=B)
    offsets = np.zeros(B + 1, dtype=np.uint64)
    np.cumsum(lens, out=offsets[1:])
    buf = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    return buf, offsets


def mod_l(digests: np.ndarray) -> np.ndarray | None:
    """(B, 64) uint8 LE 512-bit values -> (B, 32) canonical mod-L scalars."""
    lib = get_lib()
    if lib is None:
        return None
    digests = np.ascontiguousarray(digests, dtype=np.uint8)
    B = digests.shape[0]
    out = np.empty((B, 32), dtype=np.uint8)
    lib.tm_mod_l(_u8p(digests), _u8p(out), ctypes.c_uint64(B))
    return out


def challenge_scalars(prefix: np.ndarray, msgs) -> np.ndarray | None:
    """k[i] = SHA-512(prefix[i] || msg[i]) mod L for a whole batch (fused
    in C: digest never round-trips through Python).  Returns (B, 32)."""
    lib = get_lib()
    if lib is None:
        return None
    B = prefix.shape[0]
    assert prefix.dtype == np.uint8 and prefix.shape == (B, 64) \
        and prefix.flags.c_contiguous
    out = np.empty((B, 32), dtype=np.uint8)
    if isinstance(msgs, np.ndarray):
        msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
        assert msgs.shape[0] == B
        lib.tm_challenge_prefixed(_u8p(prefix), _u8p(msgs),
                                  ctypes.c_uint64(msgs.shape[1]), _u8p(out),
                                  ctypes.c_uint64(B))
        return out
    buf, offsets = _ragged(msgs, B)
    lib.tm_challenge_batch(_u8p(prefix), _u8p(buf), _u64p(offsets),
                           _u8p(out), ctypes.c_uint64(B))
    return out


def rlc_scalars(z: np.ndarray, k: np.ndarray, s: np.ndarray):
    """RLC batch staging: zk[i] = z[i]*k[i] mod L and zs = sum z[i]*s[i]
    mod L (native/staging.c tm_rlc_scalars).  z: (B, 16), k/s: (B, 32)
    LE uint8.  Returns (zk (B, 32) uint8, zs (32,) uint8) or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.ascontiguousarray(z, dtype=np.uint8)
    k = np.ascontiguousarray(k, dtype=np.uint8)
    s = np.ascontiguousarray(s, dtype=np.uint8)
    B = z.shape[0]
    if z.shape != (B, 16) or k.shape != (B, 32) or s.shape != (B, 32):
        raise ValueError("z (B, 16), k and s (B, 32) expected")
    zk = np.empty((B, 32), dtype=np.uint8)
    zs = np.empty(32, dtype=np.uint8)
    lib.tm_rlc_scalars(_u8p(z), _u8p(k), _u8p(s), _u8p(zk), _u8p(zs),
                       ctypes.c_uint64(B))
    return zk, zs


def vote_sign_bytes(seconds: np.ndarray, nanos: np.ndarray,
                    variant: np.ndarray, prefix0: bytes, prefix1: bytes,
                    suffix: bytes):
    """Batch-assemble CanonicalVote sign bytes that differ only in the
    Timestamp field and BlockID variant (types/canonical.py
    commit_sign_bytes_batch).  Returns (buf, offsets) — message i is
    buf[offsets[i]:offsets[i+1]] — or None when the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = seconds.shape[0]
    seconds = np.ascontiguousarray(seconds, dtype=np.int64)
    nanos = np.ascontiguousarray(nanos, dtype=np.int64)
    variant = np.ascontiguousarray(variant, dtype=np.uint8)
    p0 = np.frombuffer(prefix0, dtype=np.uint8) if prefix0 else \
        np.zeros(1, dtype=np.uint8)
    p1 = np.frombuffer(prefix1, dtype=np.uint8) if prefix1 else \
        np.zeros(1, dtype=np.uint8)
    sf = np.frombuffer(suffix, dtype=np.uint8) if suffix else \
        np.zeros(1, dtype=np.uint8)
    worst = 10 + 2 + 22 + max(len(prefix0), len(prefix1)) + len(suffix)
    buf = np.empty(n * worst, dtype=np.uint8)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tm_vote_sign_bytes(
        seconds.ctypes.data_as(i64p), nanos.ctypes.data_as(i64p),
        _u8p(variant), _u8p(p0), ctypes.c_uint64(len(prefix0)),
        _u8p(p1), ctypes.c_uint64(len(prefix1)),
        _u8p(sf), ctypes.c_uint64(len(suffix)),
        _u8p(buf), _u64p(offsets), ctypes.c_uint64(n))
    return buf, offsets


def scalar_canonical(s_bytes: np.ndarray) -> np.ndarray | None:
    """Vectorized s < L over (B, 32) uint8 scalars; bool (B,) or None."""
    lib = get_lib()
    if lib is None:
        return None
    s_bytes = np.ascontiguousarray(s_bytes, dtype=np.uint8)
    B = s_bytes.shape[0]
    out = np.empty(B, dtype=np.uint8)
    lib.tm_scalar_canonical(_u8p(s_bytes), _u8p(out), ctypes.c_uint64(B))
    return out.astype(bool)


def _ec_verify(fn_name: str, keysize: int, pubs, msgs, sigs):
    lib = get_lib()
    if lib is None:
        return None
    n = len(pubs)
    pub_arr = np.frombuffer(b"".join(bytes(p) for p in pubs),
                            dtype=np.uint8)
    if pub_arr.size != n * keysize:
        return None  # malformed key length: caller's per-item path decides
    sig_arr = np.frombuffer(b"".join(bytes(s) for s in sigs),
                            dtype=np.uint8)
    if sig_arr.size != n * 64:
        return None
    buf, offsets = _ragged(msgs, n)
    out = np.empty(n, dtype=np.uint8)
    # random-linear-combination batch verify (Pippenger MSM + bisection
    # on failure; per-sig verdicts exactly match single verification).
    # The seed must be unpredictable to whoever chose the signatures.
    seed = np.frombuffer(os.urandom(32), dtype=np.uint8)
    getattr(lib, fn_name)(_u8p(pub_arr), _u8p(buf), _u64p(offsets),
                          _u8p(sig_arr), _u8p(seed), _u8p(out),
                          ctypes.c_uint64(n))
    return out.astype(bool)


def sr25519_stage(pubs, msgs, sigs):
    """Host staging for the device sr25519 lane: merlin challenge k (mod
    L) and unmasked s per signature, host screens (marker bit, s < L) as
    an ok bitmap.  Returns (k (n,32), s (n,32), ok (n,)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(pubs)
    pub_arr = np.frombuffer(b"".join(bytes(p) for p in pubs),
                            dtype=np.uint8)
    sig_arr = np.frombuffer(b"".join(bytes(s) for s in sigs),
                            dtype=np.uint8)
    if pub_arr.size != n * 32 or sig_arr.size != n * 64:
        return None
    buf, offsets = _ragged(msgs, n)
    out_k = np.empty((n, 32), dtype=np.uint8)
    out_s = np.empty((n, 32), dtype=np.uint8)
    ok = np.empty(n, dtype=np.uint8)
    lib.tm_sr25519_stage(_u8p(pub_arr), _u8p(buf), _u64p(offsets),
                         _u8p(sig_arr), _u8p(out_k), _u8p(out_s),
                         _u8p(ok), ctypes.c_uint64(n))
    return out_k, out_s, ok.astype(bool)


def secp_verify(pubs, msgs, sigs) -> np.ndarray | None:
    """Batch BIP-340 verify (33B compressed pubs, raw msgs, 64B sigs);
    None when the C library is missing or inputs are irregular."""
    return _ec_verify("tm_secp_verify_batch", 33, pubs, msgs, sigs)


def sr25519_verify(pubs, msgs, sigs) -> np.ndarray | None:
    """Batch schnorrkel verify (32B ristretto pubs, raw msgs, 64B sigs —
    merlin transcript, ristretto MSM all in C)."""
    return _ec_verify("tm_sr25519_verify_batch", 32, pubs, msgs, sigs)
