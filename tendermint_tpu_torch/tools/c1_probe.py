"""Kernel C1 (the comb table build) alone on the card: its table held
against the plain version as field values (cuda_comb.tables_mismatch) and
its decode verdicts, on adversarial encodings, a ragged 1,027-key set and
1,024 and 4,096 keys, then its time (CUDA events, three runs of 10
launches) at 256, 1,024 and 4,096 keys beside its bound.

    python3 tendermint_tpu_torch/tools/c1_probe.py [--root DIR] [--tag T]

--root names the checkout whose package is imported and built (default:
this one), so that an earlier tree or a variant of C1, unpacked into an
ignored directory, can be timed in the same call as this one.  Prints the
card's name and power limit, then one JSON line a step; exits non-zero
when a comparison differs.  Needs a card; chip_smoke.py phase 15 runs the
same checks on the main path.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_ROOT)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from tendermint_tpu_torch.crypto import _edref
    from tendermint_tpu_torch.ops import _nvcc
    from tendermint_tpu_torch.ops import cuda_comb as cc
    if not cc.__file__.startswith(root + os.sep):
        sys.exit(f"c1_probe: imported {cc.__file__}, not from {root}")
    if not torch.cuda.is_available():
        sys.exit("c1_probe: no CUDA device")
    dev = torch.device("cuda", 0)

    def log(**kw):
        print(json.dumps(dict(tag=args.tag, **kw), default=str), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    cc.kernels()
    log(root=root, build_s=cc.build_info["seconds"],
        ptxas=_nvcc.parse_ptxas(cc.build_info["ptxas"]).get("k_comb_build"),
        blocks_threads=cc.occupancy()["comb_build"])

    P, L = _edref.P, _edref.L
    enc = lambda v: v.to_bytes(32, "little")  # noqa: E731
    y_ns = 2
    while _edref._recover_x(y_ns, 0) is not None:
        y_ns += 1
    y8 = 2
    while True:
        q = _edref._decode(enc(y8))
        if q is not None:
            t8 = _edref._mul(L, q)
            if _edref._encode(_edref._mul(4, t8)) != enc(1):
                break
        y8 += 1
    adv = [_edref.pubkey_from_seed((0x5100 + i).to_bytes(32, "little"))
           for i in range(3)] + [enc(P), enc(P + 1), enc(1 | 1 << 255),
                                 enc(y_ns), _edref._encode(t8), bytes(32),
                                 enc(1)]
    rng = random.Random(7)
    p = _edref._mul(rng.randrange(1, L), _edref.BASE)
    keys = []
    for _ in range(1024):               # A_i = A_0 + i B
        keys.append(_edref._encode(p))
        p = _edref._add(p, _edref.BASE)
    ragged = keys[:1000] + [rng.randbytes(32) for _ in range(27)]

    def u8(ks):
        return torch.from_numpy(np.frombuffer(b"".join(ks), np.uint8)
                                .reshape(-1, 32).copy()).to(dev)
    bad = 0
    for label, ks in (("adversarial", adv), ("ragged", ragged),
                      ("1024", keys), ("4096", keys * 4)):
        pub = u8(ks)
        tab, ok = cc.comb_build(pub)
        ptab, pok = cc.comb_build_plain(pub)
        row = dict(keys=len(ks), table_mismatches=cc.tables_mismatch(
            tab, ptab), verdict_mismatches=int((ok != pok).sum()),
            decoded=int(ok.sum()))
        bad += row["table_mismatches"] + row["verdict_mismatches"]
        log(compare=label, **row)

    def ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters
    for n, ks in ((256, keys[:150] + [bytes(32)] * 106), (1024, keys),
                  (4096, keys * 4)):
        pub = u8(ks)
        log(c1_keys=n, ms=[ms(lambda: cc.comb_build(pub)) for _ in range(3)],
            bound_ms=cc.bound_ms_build(n))
    if bad:
        sys.exit(f"c1_probe: {bad} mismatches")


if __name__ == "__main__":
    main()
