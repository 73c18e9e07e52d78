"""The control of `correct` for the render cells, at a cell's own size:
the plain reference of the configuration's scene family
(``harness/family.py``) put in the program's place and computed in
bfloat16, the precision below the configuration's float32, judged by the
same numbers against the float32 reference.  Its readings set the upper
end of each limit in ``portbench/limits/<cell>.json``; the benchmark's
own runs do not run it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from harness import bench, check


def control_readings(data: dict, traffic: dict, seeds, device) -> list:
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        exact = check.reference_frame(data, traffic, seed, device)
        t1 = time.perf_counter()
        low = check.reference_frame(data, traffic, seed, device, torch.bfloat16)
        t2 = time.perf_counter()
        out.append(dict(check.compare_frames(low, exact), seed=seed, reference_s=t1 - t0,
                        control_s=t2 - t1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = bench.Spec()
    cell = spec.cell(args.workload)
    for r in control_readings(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                              args.seeds, torch.device(args.device)):
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
