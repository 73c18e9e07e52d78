"""Device time of the sweep kernel at the launch shapes of ``chip_smoke.py``
phase 2, to compare two checkouts of the port on the same card.

    python3 portrayer_tpu_torch/time_sweep.py [--root DIR]
    python3 portrayer_tpu_torch/time_sweep.py --against DIR [--turns 2]

The first form builds the kernel of the checkout at ``--root`` (default:
this one) and, for each scene that phase 2 times, on its two ray sets
(uniform camera rays and the render's order) and in both modes, holds the
kernel against the plain version (nearest: t, node and tri equal; any-hit:
hit equal) and reads the kernel's device time per launch with
``torch.profiler`` over 20 launches.  It prints one JSON line.  The ray
sets and launch shapes come from this checkout's ``chip_smoke.py``, so
every checkout sees the same rays.

The second form times this checkout against the one at DIR: ``--turns``
times the order DIR, this, this, DIR, each run in a process of its own,
and prints every run's line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time(root: str) -> dict:
    # Run as a file, sys.path[0] is this package's directory: replace it by
    # the checkout whose package is timed.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root, os.path.join(ROOT, "tests")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops.cuda_intersect import (
        intersect_scene_cuda, intersect_scene_sweep_ref)

    dev = torch.device("cuda", 0)
    cfg = RenderConfig(device=dev)
    inf = float("inf")
    out = {"root": root, "device_ms": {}}
    for name, n_rays, scene, camset, size, packing in cs._scene_cases():
        if name not in cs.TIMED or packing != "sah":
            continue
        w, h = size
        st = flatten_scene(scene, dev)
        cam = Camera(camset, size, dev)
        u = rng.uniform(rng.PRNGKey(7), (n_rays, 2), dev)
        sets = {"uniform": cam.rays_at(u[:, 0] * w, u[:, 1] * h),
                "render order": cs._render_order_rays(cam, size, cfg)}
        for order, (o, d) in sets.items():
            near = intersect_scene_sweep_ref(o, d, cfg.epsilon, inf, st, cfg)
            for mode, (args, kw, any_hit) in cs._launch_shapes(o, d, near, st, cfg).items():
                kern = lambda: intersect_scene_cuda(*args, st, cfg, any_hit=any_hit, **kw)
                k = kern()
                p = intersect_scene_sweep_ref(*args, st, cfg, any_hit=any_hit, **kw)
                fields = ("hit",) if any_hit else ("hit", "t", "node", "tri")
                for f in fields:
                    if not torch.equal(getattr(k, f), getattr(p, f)):
                        raise AssertionError(f"{root}: {name} {mode} ({order}): {f} differs")
                out["device_ms"][f"{name} {mode} {order}"] = cs._device_ms(kern, 20)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--against")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if args.against is None:
        print(json.dumps(_time(os.path.abspath(args.root))), flush=True)
        return 0
    for _ in range(args.turns):
        for root in (args.against, ROOT, ROOT, args.against):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                           check=True, timeout=1800)
    return 0


if __name__ == "__main__":
    sys.exit(main())
