"""nvcc builds of the port's CUDA sources (csrc/) into shared libraries
with a plain C interface, loaded with ctypes.

Each library is built for sm_90a on first use and cached under the
package's `_build/` directory by a hash of its sources and flags, so a
source change rebuilds it.  nvcc's `-Xptxas -v` report (registers,
spills) is kept beside the library.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str, sources) -> dict:
    """Compile the translation unit sources[-1] (the other sources are the
    headers it includes) into `_build/<name>_<hash>.so`, once per source
    hash.  Returns {path, seconds, cached, ptxas}."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    log = so + ".ptxas.txt"
    if os.path.exists(so):
        ptxas = ""
        if os.path.exists(log):
            with open(log) as f:
                ptxas = f.read()
        return {"path": so, "seconds": 0.0, "cached": True, "ptxas": ptxas}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, sources[-1]],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    with open(log, "w") as f:
        f.write(r.stderr)
    return {"path": so, "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": r.stderr}


def check_rc(lib, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.tm_error_string(rc).decode()})")


def _short(mangled: str) -> str:
    """_Z15k_verify_packedPKhlPKiPh -> k_verify_packed."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    return mangled[m.end():m.end() + int(m.group(1))]


def parse_ptxas(text: str) -> dict:
    """A build's `ptxas` report -> {kernel: {registers, stack,
    spill_stores, spill_loads, smem}} (mangled names shortened)."""
    out: dict = {}
    cur = None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", ln)
        if m:
            cur = out.setdefault(_short(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m2.group(1)) if m2 else 0
    return out
