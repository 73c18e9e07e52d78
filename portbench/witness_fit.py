"""The fit cell that is not in BENCHMARK.json, and why: three steps of
``parallel.train_step`` and Adam from a start perturbed by the seed,
through the program's sweep kernel (``accel="cuda"``) and through its
flat sweep (``accel="flat"``), each against the plain reference's three
steps.  It prints each step's loss on the three sides and, per table,
the gap of the first gradient's norm and of the change's norm after
three steps, each over the larger of the reference's norm of that table
and the median table's.

    python3 portbench/witness_fit.py --seeds 1 2 3 [--size 910x512] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from harness import bench
from harness import fit as HF
from reference import fit as RF

STEPS = 3


def program_steps(T, data, start, seed, device, accel):
    f = HF.Fit(T, data, start, seed, 1, device, accel=accel)
    p0 = f.params()
    losses, first = [], None
    for _ in range(STEPS):
        losses.append(float(f.step()))
        first = f.first_gradient() if first is None else first
    p3 = f.params()
    f.close()
    return losses, first, p0, p3


def gaps(prog, ref):
    """Per table: (first gradient's gap, change's gap), by the worst-leaf
    rule of the benchmark's training check."""
    (_, g, p0, p3), (_, rg, rp0, rp3) = prog, ref
    gn = {k: float(v.norm()) for k, v in rg.items()}
    cn = {k: float((rp3[k] - rp0[k]).norm()) for k in rg}
    gmed, cmed = statistics.median(gn.values()), statistics.median(cn.values())
    return {k: (abs(float(g[k].norm()) - gn[k]) / max(gn[k], gmed),
                abs(float((p3[k] - p0[k]).norm()) - cn[k]) / max(cn[k], cmed)) for k in rg}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--size", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, bench.ROOT)
    import portrayer_tpu_torch as T

    data = bench.Spec().config("glossy-reflection")
    if args.size:
        data["size"] = [int(x) for x in args.size.split("x")]
    dev = torch.device(args.device)
    for seed in args.seeds:
        start = HF.perturb(data, seed)
        ref = RF.follow(data, start, dev, seed, 1, STEPS)
        out = {"seed": seed, "reference_loss": ref[0]}
        for accel in ("cuda", "flat"):
            prog = program_steps(T, data, start, seed, dev, accel)
            out[f"{accel}_loss"] = prog[0]
            out[f"{accel}_gaps"] = gaps(prog, ref)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
