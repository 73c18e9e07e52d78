#!/usr/bin/env python3
"""Render every example scene through the port (counterpart of
``run_all_examples.py``, the reference's run-all-examples.sh and CI loop):
smoke renders at a low sample count, one PNG per scene and
``timings.json``.

    python3 -m portrayer_tpu_torch.run_all_examples [--samples N] [--scale F]
        [--out DIR] [--only name1,name2] [--accel cuda|beam|flat] [--tile T]
        [--device cuda|cpu]

Each scene renders at `scale` x its published size (at least 16 pixels a
side) on the card unless ``--device cpu``; SAMPLES sets the default
sample count, 2 as in CI.  On the card every ``--accel`` replays the
captured chunk program (the beam sweep's ordered walks WHILE nodes in
it); each scene's line shows its graphs, conditional bodies, loops and
host syncs (0 captured).  Scenes that load meshes or images read them
from PORTRAYER_ASSETS (``scenes.common.asset``); a missing file raises
FileNotFoundError naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: import the package of this checkout
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portrayer_tpu_torch import Image, RenderConfig, RenderProgress, flatten_scene, scenes
from portrayer_tpu_torch.ops import cuda_intersect


def render_all(names, out, samples=2, scale=1.0, accel="cuda", tile=128, device="cuda",
               on_scene=None) -> dict:
    """Render each scene of `names` into `out`/<name>.png and write
    `out`/timings.json.  Returns {name: {"secs", "Mrays/s", "size",
    "launches" (sweep kernel launches per mode, flat and beam sweep calls
    and beam steps), "graphs", "bodies",
    "loops", "replays" (captured chunk graphs, their conditional bodies,
    their loops and their replays), "syncs" (host reads of the chunks),
    "dropped_w"}}; "secs"
    counts building, lowering, rendering and saving the scene, as the JAX
    package's runner does (which rounds it; this one does not).
    `on_scene(name, spec, tables, cfg, result)`, if given, is called after
    each scene."""
    os.makedirs(out, exist_ok=True)
    results = {}
    for name in names:
        t0 = time.perf_counter()
        spec = scenes.load(name)
        w = max(16, int(spec.size[0] * scale))
        h = max(16, int(spec.size[1] * scale))
        cfg = RenderConfig(samples=samples, tile=(tile, tile), accel=accel,
                           queue_caps=spec.queue_caps, device=device)
        st = flatten_scene(spec.scene, cfg.device)
        before = cuda_intersect.counts()
        stats = []
        img = Image(os.path.join(out, f"{name}.png"), w, h)
        img.render(st, spec.camera, spec.background, cfg, stats=stats,
                   reporter=RenderProgress())
        img.save()
        dt = time.perf_counter() - t0
        after = cuda_intersect.counts()
        progs = st.chunk_programs.values()
        rays = w * h * samples
        results[name] = {
            "secs": dt, "Mrays/s": rays / dt / 1e6, "size": [w, h],
            "launches": {k: after[k] - before[k] for k in cuda_intersect.SWEEP_MODES},
            "graphs": sum(len(p.graphs) for p in progs),
            "bodies": sum(g.bodies for p in progs for g in p.graphs.values()),
            "loops": sum(g.loops for p in progs for g in p.graphs.values()),
            "replays": sum(g.replays for p in progs for g in p.graphs.values()),
            "syncs": sum(s.syncs for s in stats),
            "dropped_w": sum(s.dropped_w for s in stats) / max(len(stats), 1),
        }
        r = results[name]
        print(f"{name:34s} {w}x{h}  {dt:8.2f}s  {rays / dt / 1e6:7.3f} Mrays/s  "
              f"graphs {r['graphs']} bodies {r['bodies']} loops {r['loops']} host syncs "
              f"{r['syncs']}", flush=True)
        if on_scene is not None:
            on_scene(name, spec, st, cfg, results[name])

    with open(os.path.join(out, "timings.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=int(os.environ.get("SAMPLES", 2)))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="render_out")
    ap.add_argument("--only", default=None)
    ap.add_argument("--accel", default="cuda", choices=("cuda", "beam", "flat"))
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else scenes.names()
    return render_all(names, args.out, args.samples, args.scale, args.accel, args.tile,
                      args.device)


if __name__ == "__main__":
    main()
