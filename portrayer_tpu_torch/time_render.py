"""Wall time of full-frame renders through ``Image.render`` on one CUDA
device, to compare two checkouts of the port on the same card.

    python3 portrayer_tpu_torch/time_render.py [--scene big-scene] [--repeats 2]
        [--accel cuda|beam|flat]
    python3 portrayer_tpu_torch/time_render.py --against DIR [--turns 2]

The first form renders the scene at its published size and 16 spp with
131,072 rays per launch and the scene's queue caps (the settings of
``chip_smoke.py``'s main path), on tables flattened once: once to build
the kernel, warm up and capture the chunk program, then ``--repeats``
times replaying it, and prints one JSON line with each render's seconds,
the sweep launches per mode of the last render (the kernel's, and the
flat and beam sweeps' calls and beam steps), its host syncs a chunk, the
chunk program's graphs, conditional bodies and loops, and a hash of its
pixels.  ``--accel beam`` or ``flat`` times the render through that sweep,
captured as the kernel's is.  ``--root DIR`` imports the package from the checkout at DIR
instead of this one.

The second form times this checkout against the one at DIR: ``--turns``
times the order DIR, this, this, DIR, each run in a process of its own,
and prints every run's line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPP = 16
LAUNCH_RAYS = 131072


def _time(root: str, scene: str, repeats: int, accel: str = "cuda") -> dict:
    # Run as a file, sys.path[0] is this package's directory: replace it by
    # the checkout whose package is timed.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch
    from portrayer_tpu_torch import Image, RenderConfig, flatten_scene, scenes
    from portrayer_tpu_torch.ops import cuda_intersect

    dev = torch.device("cuda", 0)
    spec = scenes.load(scene)
    w, h = spec.size
    cfg = RenderConfig(device=dev, samples=SPP, max_rays_per_launch=LAUNCH_RAYS,
                       queue_caps=spec.queue_caps, accel=accel)
    st = flatten_scene(spec.scene, dev)
    img = Image(None, w, h)
    secs, stats = [], []
    for i in range(repeats + 1):
        torch.cuda.synchronize()
        cuda_intersect.reset_counts()
        stats.clear()
        t0 = time.perf_counter()
        img.render(st, spec.camera, spec.background, cfg, stats=stats)
        torch.cuda.synchronize()
        if i:  # the first render builds the kernel and captures
            secs.append(time.perf_counter() - t0)
    # A checkout from before conditional graphs counts every launch in
    # COUNTS, and its graphs have no bodies.
    counts = getattr(cuda_intersect, "counts", lambda: dict(cuda_intersect.COUNTS))
    graphs = [g for p in st.chunk_programs.values() for g in p.graphs.values()]
    return {"root": root, "scene": scene, "accel": accel, "size": [w, h], "spp": SPP,
            "seconds": secs, "launches": counts(),
            "host_syncs_per_chunk": sum(s.syncs for s in stats) / len(stats),
            "graphs": len(graphs), "bodies": sum(getattr(g, "bodies", 0) for g in graphs),
            "loops": sum(getattr(g, "loops", 0) for g in graphs),
            "pixels_sha1": hashlib.sha1(img.buffer.tobytes()).hexdigest()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--scene", default="big-scene")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--against")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--accel", default="cuda", choices=("cuda", "beam", "flat"))
    args = ap.parse_args(argv)
    if args.against is None:
        print(json.dumps(_time(os.path.abspath(args.root), args.scene, args.repeats,
                               args.accel)), flush=True)
        return 0
    for _ in range(args.turns):
        for root in (args.against, ROOT, ROOT, args.against):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                            "--scene", args.scene, "--repeats", str(args.repeats),
                            "--accel", args.accel], check=True, timeout=1800)
    return 0


if __name__ == "__main__":
    sys.exit(main())
