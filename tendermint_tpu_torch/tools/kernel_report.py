"""SASS report of the port's kernels as built for the card: opcode counts
per kernel of the verify kernels (K1, K2, K3), of the MSM kernels (K4,
K5, A1), of the secp256k1 and sr25519 kernels (S1, S2) and of the comb's
(C1, C2, where the checkout has csrc/comb.cu), with the
instructions of each loop body (each backward branch's span, longest
first: K5's are a tree round and a madd step, K4's one square of its
power chain) and the SHFL.IDX in each, from cuobjdump -sass of the built
libraries; and the instructions of one field multiply and one square (a
probe kernel built from the same csrc/fe25519.cuh), of the two-round-carry
pair that K4 and S2 use (fe_mul2, fe_sq2 of csrc/fe25519_2.cuh), of S1's
(fs_mul, fs_sqr of csrc/fe_secp.cuh and its four-lane mixed add
jac_madd4 of csrc/secp4.cuh) and of one four-lane doubling and addition
of S2 (sr_dbl, sr_add of csrc/ristretto4.cuh).  A checkout read with
--root or --compare is one from PR 10 on (7fee949: these headers; C1 and
C2 where it has csrc/comb.cu).

    python3 tendermint_tpu_torch/tools/kernel_report.py [--root DIR]
        [--compare DIR]

--root names the checkout whose kernels are built and read (default:
this one), so that an earlier tree, unpacked with `git archive`, can be
read in the same run.  Each kernel's `sass_sha256` hashes its whole
cuobjdump -sass text, every instruction with its encoding, with only the
address comments taken out.  --compare DIR reads DIR the same way (in a
child process) and adds, per kernel, whether the two hashes are equal:
the same machine code.  Prints one JSON line.  Needs nvcc and
cuobjdump; registers, spills, blocks per SM and times are
chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# One field multiply and one square between a load and a store, and the
# same load and store alone: their SASS differences are the instructions
# of one fe_mul / fe_sq.
_PROBE = r"""
#include "fe25519.cuh"
__global__ void k_probe_copy(const int32_t *a, const int32_t *b, int32_t *o) {
  fe f; for (int i = 0; i < 10; i++) f[i] = a[10 * threadIdx.x + i] + b[i];
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = f[i];
}
__global__ void k_probe_mul(const int32_t *a, const int32_t *b, int32_t *o) {
  fe f, g, h;
  for (int i = 0; i < 10; i++) f[i] = a[10 * threadIdx.x + i], g[i] = b[i];
  fe_mul(h, f, g);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = h[i];
}
__global__ void k_probe_sq(const int32_t *a, const int32_t *b, int32_t *o) {
  fe f, h;
  for (int i = 0; i < 10; i++) f[i] = a[10 * threadIdx.x + i] + b[i];
  fe_sq(h, f);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = h[i];
}
"""
# the two-round-carry multiply and square (K4's and S2's), the same way
_PROBE2 = r"""
#include "fe25519_2.cuh"
__global__ void k_probe_mul2(const int32_t *a, const int32_t *b, int32_t *o) {
  fe f, g, h;
  for (int i = 0; i < 10; i++) f[i] = a[10 * threadIdx.x + i], g[i] = b[i];
  fe_mul2(h, f, g);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = h[i];
}
__global__ void k_probe_sq2(const int32_t *a, const int32_t *b, int32_t *o) {
  fe f, h;
  for (int i = 0; i < 10; i++) f[i] = a[10 * threadIdx.x + i] + b[i];
  fe_sq2(h, f);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = h[i];
}
"""

# S1's multiply, square and four-lane mixed add (csrc/fe_secp.cuh,
# csrc/secp4.cuh), the same way; the madd's exchange is the kernel's
# (group4.cuh's GroupXch over dynamic shared memory)
_PROBE3 = r"""
#include "fe_secp.cuh"
__global__ void k_probe_s_copy(const uint32_t *a, const uint32_t *b, uint32_t *o) {
  fs f; for (int i = 0; i < 8; i++) f[i] = a[8 * threadIdx.x + i] + b[i];
  for (int i = 0; i < 8; i++) o[8 * threadIdx.x + i] = f[i];
}
__global__ void k_probe_s_mul(const uint32_t *a, const uint32_t *b, uint32_t *o) {
  fs f, g, h;
  for (int i = 0; i < 8; i++) f[i] = a[8 * threadIdx.x + i], g[i] = b[i];
  fs_mul(h, f, g);
  for (int i = 0; i < 8; i++) o[8 * threadIdx.x + i] = h[i];
}
__global__ void k_probe_s_sqr(const uint32_t *a, const uint32_t *b, uint32_t *o) {
  fs f, h;
  for (int i = 0; i < 8; i++) f[i] = a[8 * threadIdx.x + i] + b[i];
  fs_sqr(h, f);
  for (int i = 0; i < 8; i++) o[8 * threadIdx.x + i] = h[i];
}
"""
_PROBE4 = r"""
#include "group4.cuh"
#include "secp4.cuh"
__global__ void k_probe_p_copy(const uint32_t *a, const uint32_t *b, uint32_t *o) {
  jpt p;
  for (int i = 0; i < 8; i++) p.X[i] = a[24 * threadIdx.x + i],
      p.Y[i] = a[24 * threadIdx.x + 8 + i], p.Z[i] = a[24 * threadIdx.x + 16 + i];
  GroupXch<16, 24> x(threadIdx.x);
  for (int i = 0; i < 8; i++) o[24 * threadIdx.x + i] = p.X[i] + x.lane(),
      o[24 * threadIdx.x + 8 + i] = p.Y[i], o[24 * threadIdx.x + 16 + i] = p.Z[i];
}
__global__ void k_probe_p_madd(const uint32_t *a, const uint32_t *b, uint32_t *o) {
  jpt p;
  for (int i = 0; i < 8; i++) p.X[i] = a[24 * threadIdx.x + i],
      p.Y[i] = a[24 * threadIdx.x + 8 + i], p.Z[i] = a[24 * threadIdx.x + 16 + i];
  GroupXch<16, 24> x(threadIdx.x);
  jac_madd4(x, p, b);
  for (int i = 0; i < 8; i++) o[24 * threadIdx.x + i] = p.X[i] + x.lane(),
      o[24 * threadIdx.x + 8 + i] = p.Y[i], o[24 * threadIdx.x + 16 + i] = p.Z[i];
}
"""

# one four-lane doubling and one addition of S2 on the kernel's exchange
# (group4.cuh's ShflXch over dynamic shared memory), and the same load
# and store alone
_PROBE5 = r"""
#include "group4.cuh"
#include "ristretto4.cuh"
typedef ShflXch<9 * 3 * 10, V4_SIG_WORDS, 10> PX;
__global__ void k_probe_g_copy(const int32_t *a, const int32_t *b, int32_t *o) {
  PX x(threadIdx.x);
  fe p;
  for (int i = 0; i < 10; i++) p[i] = a[10 * threadIdx.x + i] + b[i];
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = p[i] + x.lane();
}
__global__ void k_probe_g_dbl(const int32_t *a, const int32_t *b, int32_t *o) {
  PX x(threadIdx.x);
  fe p;
  for (int i = 0; i < 10; i++) p[i] = a[10 * threadIdx.x + i] + b[i];
  sr_dbl(x, p);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = p[i] + x.lane();
}
__global__ void k_probe_g_add(const int32_t *a, const int32_t *b, int32_t *o) {
  PX x(threadIdx.x);
  fe p, q;
  for (int i = 0; i < 10; i++) p[i] = a[10 * threadIdx.x + i] + b[i],
      q[i] = b[10 + 10 * threadIdx.x + i];
  sr_add(x, p, q);
  for (int i = 0; i < 10; i++) o[10 * threadIdx.x + i] = p[i] + x.lane();
}
"""

_SASS_LINE = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_SELECTED = ("IMAD.WIDE", "IMAD.WIDE.U32", "IMAD", "IMAD.HI", "IMAD.X",
             "IADD3", "IADD3.X", "SHF.R.S64.HI", "SHF.R.U64", "SHF.L.U64.HI",
             "LEA", "SEL", "SHFL.IDX", "LDS", "STS", "LDL", "STL", "LDL.64",
             "STL.64", "LDL.128", "STL.128")


def _run(cmd: list) -> str:
    tool = shutil.which(cmd[0]) or f"/usr/local/cuda/bin/{cmd[0]}"
    r = subprocess.run([tool, *cmd[1:]], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        sys.exit(f"kernel_report: {cmd[0]} failed: {r.stderr[-2000:]}")
    return r.stdout


def _short(mangled: str) -> str:
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


_BACK_BRA = re.compile(r"/\*([0-9a-f]{4,})\*/.*\bBRA\s+(?:`\()?0x([0-9a-f]+)")


_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def sass_counts(path: str) -> tuple:
    """cuobjdump -sass of a library or cubin -> ({kernel: Counter(opcode)},
    {kernel: [(instructions, SHFL.IDX) of each backward-branch body],
    longest first}, {kernel: sha256 of its instruction and encoding lines
    without the address comments})."""
    out: dict = {}
    ops: dict = {}
    loops: dict = {}
    text: dict = {}
    cur = None
    for ln in _run(["cuobjdump", "-sass", path]).splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            cur = _short(m.group(1))
            out.setdefault(cur, collections.Counter())
            ops.setdefault(cur, [])
            loops.setdefault(cur, [])
            text.setdefault(cur, hashlib.sha256())
            continue
        if cur is not None and ln.lstrip().startswith("/*"):
            # an instruction line or its encoding's second word
            text[cur].update((" ".join(_ADDR.sub("", ln).split()) + "\n")
                             .encode())
        if cur is not None and (m := _SASS_LINE.search(ln)):
            out[cur][m.group(1)] += 1
            addr = int(re.search(r"/\*([0-9a-f]{4,})\*/", ln).group(1), 16)
            ops[cur].append((addr, m.group(1)))
            b = _BACK_BRA.search(ln)
            if b and int(b.group(2), 16) < int(b.group(1), 16):
                lo, hi = int(b.group(2), 16), int(b.group(1), 16)
                shfl = sum(1 for a, op in ops[cur]
                           if lo <= a <= hi and op == "SHFL.IDX")
                loops[cur].append(((hi - lo) // 16 + 1, shfl))
    return (out, {k: sorted(v, reverse=True) for k, v in loops.items()},
            {k: h.hexdigest() for k, h in text.items()})


def _summary(c: collections.Counter) -> dict:
    fam = collections.Counter()
    for op, n in c.items():
        fam[op.split(".")[0]] += n
    return {"total": sum(c.values()), "by_family": dict(fam.most_common()),
            "selected": {k: c[k] for k in _SELECTED if c.get(k)}}


def _probe(csrc: str, build_dir: str, tag: str, text: str) -> dict:
    """Build a probe source for the card; the SASS counts of its kernels."""
    src = os.path.join(build_dir, f"probe_{tag}.cu")
    cubin = os.path.join(build_dir, f"probe_{tag}.cubin")
    with open(src, "w") as f:
        f.write(text)
    _run(["nvcc", "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
          "-O3", "-std=c++17", "-I", csrc, "-o", cubin, src])
    return sass_counts(cubin)[0]


def probe_counts(csrc: str, build_dir: str) -> dict:
    """{op: SASS summary} of each probed operation: its probe kernel less
    the probe kernel that only loads and stores."""
    # (source, {reported name: (probe kernel, its load-and-store kernel)})
    probes = [
        ("fe", _PROBE + _PROBE2, {
            "fe_mul": ("mul", "copy"), "fe_sq": ("sq", "copy"),
            "fe_mul2": ("mul2", "copy"), "fe_sq2": ("sq2", "copy")}),
        ("g", _PROBE5, {"s2_dbl": ("g_dbl", "g_copy"),
                        "s2_add": ("g_add", "g_copy")}),
        ("fs", _PROBE3 + _PROBE4, {
            "fs_mul": ("s_mul", "s_copy"), "fs_sqr": ("s_sqr", "s_copy"),
            "jac_madd4": ("p_madd", "p_copy")})]
    out = {}
    for tag, text, ops in probes:
        c = _probe(csrc, build_dir, tag, text)
        for name, (kernel, copy) in ops.items():
            d = collections.Counter(c[f"k_probe_{kernel}"])
            d.subtract(c[f"k_probe_{copy}"])
            out[name] = _summary(+d)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_ROOT)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    other = None
    if args.compare:
        other = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--root",
             os.path.abspath(args.compare)], stdout=subprocess.PIPE,
            text=True)
    sys.path.insert(0, root)
    from tendermint_tpu_torch.ops import cuda_ed25519 as ck
    from tendermint_tpu_torch.ops import cuda_msm as cm
    from tendermint_tpu_torch.ops import cuda_secp as cs1
    from tendermint_tpu_torch.ops import cuda_sr25519 as cs2
    if not ck.__file__.startswith(root + os.sep):
        sys.exit(f"kernel_report: imported {ck.__file__}, not from {root}")
    kernels = {}
    mods = [(ck, ("k_verify_packed", "k_verify_packed_split",
                  "k_verify_staged")),
            (cm, ("k_decompress_niels", "k_bucket_scan", "k_aggregate")),
            (cs1, ("k_secp_verify",)),
            (cs2, ("k_sr25519_verify",))]
    if os.path.exists(os.path.join(root, "tendermint_tpu_torch", "csrc",
                                   "comb.cu")):
        from tendermint_tpu_torch.ops import cuda_comb as cc
        mods.append((cc, ("k_comb_build", "k_comb_verify")))
    # one nvcc a source, side by side
    pool = [threading.Thread(target=mod.build) for mod, _ in mods]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    for mod, names in mods:
        so = mod.build()
        sass, loops, sha = sass_counts(so)
        for name in names:
            lp = loops.get(name, [])
            kernels[name] = dict(
                _summary(sass.get(name, collections.Counter())),
                loop_instructions=[n for n, _ in lp],
                loop_shfl=[k for _, k in lp], sass_sha256=sha.get(name))
    rep = {"root": root, "kernels": kernels,
           "probe": probe_counts(os.path.join(root, "tendermint_tpu_torch",
                                              "csrc"), os.path.dirname(so))}
    if other is not None:
        out, _ = other.communicate()
        if other.returncode != 0:
            sys.exit(f"kernel_report: --compare {args.compare} failed")
        theirs = json.loads(out.strip().splitlines()[-1])
        rep["compare"] = {"root": theirs["root"], "kernels": theirs["kernels"],
                          "probe": theirs["probe"],
                          "identical": {
                              k: v["sass_sha256"] is not None and
                              v["sass_sha256"] == theirs["kernels"][k].get(
                                  "sass_sha256")
                              for k, v in kernels.items()
                              if k in theirs["kernels"]}}
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
