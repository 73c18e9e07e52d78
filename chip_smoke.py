#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``portrayer_tpu_torch/csrc`` and runs four
phases, each printing its own line; any failure raises and exits non-zero:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, kernel
   build seconds and the ptxas resource report;
2. each sweep kernel (nearest, any-hit) against its plain PyTorch version
   on the card, on big-scene and simple camera rays and their shadow rays,
   under the gates of the JAX package's kernel tests, then both versions'
   times at the render path's launch shapes (CUDA events);
3. renders of simple (64x64) and big-scene (160x82) against the committed
   self-goldens (fewer than 0.1% of pixels off by more than 2/255);
4. the full 1980x1020 big-scene frame through ``Image.render``, with the
   kernel launch counts of that run and its primary-ray rate; then simple
   at its 256x256 through ``render_linear``, held against the flat
   oracle's render on the card.

The last two lines are a JSON object of per-kernel numbers and the
``{"ok": true, ...}`` line.  Without a CUDA device it exits 1 at once.
Nothing here imports JAX.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "out")
GOLDEN_DIR = os.path.join(ROOT, "tests", "self_golden")
KERNEL_SOURCE = "portrayer_tpu_torch/csrc/sweep.cu"
TPU_KERNEL = "portrayer_tpu/ops/pallas_intersect.py:159"
FULL_FRAME_SPP = 16
SIMPLE_SPP = 4


def _gate_nearest(k, p, label):
    """The JAX package's kernel gates (tests/test_pallas.py): .hit equal;
    node mismatches on <= 0.2% of hits, only within 2*2^-16 relative t;
    elsewhere t within rtol 1e-4 / atol 1e-5.  Returns max |dt|."""
    import torch

    if not torch.equal(k.hit, p.hit):
        raise AssertionError(f"{label}: hit differs on {(k.hit != p.hit).sum().item()} rays")
    both = p.hit
    kt, pt = k.t[both], p.t[both]
    mism = k.node[both] != p.node[both]
    frac = mism.float().mean().item() if both.any() else 0.0
    if frac > 0.002:
        raise AssertionError(f"{label}: node mismatch on {frac:.4%} of hits")
    if mism.any():
        quantum = 2.0 ** -16 * torch.maximum(kt[mism].abs(), pt[mism].abs())
        if not ((kt[mism] - pt[mism]).abs() <= 2.0 * quantum + 1e-5).all():
            raise AssertionError(f"{label}: node mismatch outside the tie quantum")
    same = ~mism
    if not torch.equal(k.tri[both][same], p.tri[both][same]):
        raise AssertionError(f"{label}: tri differs")
    torch.testing.assert_close(kt[same], pt[same], rtol=1e-4, atol=1e-5)
    return (kt[same] - pt[same]).abs().max().item() if same.any() else 0.0


def _shadow_rays(o, d, hit, st, cfg):
    """Rays from each nearest hit toward every light ([L*R] rays), as the
    render's shadow batch builds them: t_min = max(eps, eps_rel*|p|),
    src_node/src_tri = the hit, active = hit."""
    import torch
    from portrayer_tpu_torch import math3d as m3

    t = torch.where(hit.hit, hit.t, 0.0)
    p = o + t[:, None] * d
    t_eps = torch.clamp(cfg.eps_rel * m3.norm(p, eps=1e-20), min=cfg.epsilon)
    dirs = [m3.normalize(st.light_pos[li] - p, eps=1e-30) for li in range(st.n_lights)]
    L = st.n_lights
    return (p.repeat(L, 1), torch.cat(dirs), t_eps.repeat(L), hit.hit.repeat(L),
            hit.node.repeat(L), hit.tri.repeat(L))


def _time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card(dev):
    import torch
    from portrayer_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]
    print(smi, flush=True)
    _build.load()
    regs = [ln.strip() for ln in _build.build_info["ptxas"].splitlines() if "registers" in ln]
    print(f"[1 card] {torch.cuda.get_device_name(dev)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernel build {_build.build_info['seconds']:.2f} s | "
          f"ptxas: {' ; '.join(regs)}", flush=True)
    return smi


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns per-mode numbers."""
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops.cuda_intersect import (
        intersect_scene_cuda, intersect_scene_sweep_ref)

    cfg = RenderConfig(device=dev)
    inf = float("inf")
    err = {"nearest": 0.0, "any_hit": 0.0}
    timing = {}
    for name, n_rays in (("big-scene", 262144), ("simple", 65536)):
        spec = scenes.load(name)
        w, h = spec.size
        st = flatten_scene(spec.scene, dev)
        cam = Camera(spec.camera, spec.size, dev)
        u = rng.uniform(rng.PRNGKey(7), (n_rays, 2), dev)
        o, d = cam.rays_at(u[:, 0] * w, u[:, 1] * h)
        src = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
        near = {}
        for label, kw in (("nearest", {}), ("nearest+src", {"src_node": src, "src_tri": src})):
            k = intersect_scene_cuda(o, d, cfg.epsilon, inf, st, cfg, **kw)
            p = intersect_scene_sweep_ref(o, d, cfg.epsilon, inf, st, cfg, **kw)
            torch.cuda.synchronize()
            err["nearest"] = max(err["nearest"], _gate_nearest(k, p, f"{name} {label}"))
            near = k
        so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
        ka = intersect_scene_cuda(so, sd, st_min, inf, st, cfg, active=sact,
                                  src_node=snode, src_tri=stri, any_hit=True)
        pa = intersect_scene_sweep_ref(so, sd, st_min, inf, st, cfg, active=sact,
                                       src_node=snode, src_tri=stri, any_hit=True)
        if not torch.equal(ka.hit, pa.hit):
            raise AssertionError(f"{name} any-hit: hit differs on "
                                 f"{(ka.hit != pa.hit).sum().item()} rays")
        err["any_hit"] = max(err["any_hit"],
                             (ka.hit.float() - pa.hit.float()).abs().max().item())
        ks = intersect_scene_cuda(so, sd, st_min, inf, st, cfg, active=sact,
                                  src_node=snode, src_tri=stri)
        ps = intersect_scene_sweep_ref(so, sd, st_min, inf, st, cfg, active=sact,
                                       src_node=snode, src_tri=stri)
        err["nearest"] = max(err["nearest"], _gate_nearest(ks, ps, f"{name} shadow nearest"))
        print(f"[2 kernels] {name}: {n_rays} camera rays, {near.hit.float().mean():.3f} hit; "
              f"{int(sact.sum())} shadow rays, {ka.hit.float().mean():.3f} occluded; "
              f"nearest and any-hit agree with the plain version", flush=True)

        if name == "big-scene":
            # Launch shapes of the render path: 131072 primary rays (tile
            # 128x128 x 8 spp) and one any-hit launch over 3 x 131072.
            R = 131072
            a = (o[:R].contiguous(), d[:R].contiguous(), cfg.epsilon, inf, st, cfg)
            skw = dict(src_node=src[:R], src_tri=src[:R])
            sel = torch.cat([torch.arange(R, device=dev) + li * n_rays
                             for li in range(st.n_lights)])
            b = (so[sel].contiguous(), sd[sel].contiguous(), st_min[sel].contiguous(), inf,
                 st, cfg)
            bkw = dict(active=sact[sel], src_node=snode[sel], src_tri=stri[sel], any_hit=True)
            runs = {
                "nearest": (lambda: intersect_scene_cuda(*a, **skw),
                            lambda: intersect_scene_sweep_ref(*a, **skw)),
                "any_hit": (lambda: intersect_scene_cuda(*b, **bkw),
                            lambda: intersect_scene_sweep_ref(*b, **bkw)),
            }
            _gate_nearest(runs["nearest"][0](), runs["nearest"][1](), "nearest at 131072")
            if not torch.equal(runs["any_hit"][0]().hit, runs["any_hit"][1]().hit):
                raise AssertionError("any-hit at 3x131072: hit differs")
            for mode, (kern, plain) in runs.items():
                # plain, kernel, kernel, plain: both versions in turns.
                p1 = _time_ms(plain, 3)
                k1 = _time_ms(kern, 20)
                k2 = _time_ms(kern, 20)
                p2 = _time_ms(plain, 3)
                timing[mode] = ((k1 + k2) / 2, (p1 + p2) / 2)
                print(f"[2 timing] {mode} ({'3x' if mode == 'any_hit' else ''}{R} rays): "
                      f"kernel {timing[mode][0]:.3f} ms, plain {timing[mode][1]:.3f} ms",
                      flush=True)
    return err, timing


def phase_goldens(dev):
    import numpy as np
    from portrayer_tpu_torch import RenderConfig, render_u8, scenes
    from portrayer_tpu_torch.image_io import read_png

    for name, size in (("simple", (64, 64)), ("big-scene", (160, 82))):
        spec = scenes.load(name)
        cfg = RenderConfig(device=dev, samples=4, tile=(64, 64), seed=0)
        ours = render_u8(spec.scene, spec.camera, size, spec.background, cfg).astype(np.int16)
        gold = read_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(np.int16)
        if ours.shape != gold.shape:
            raise AssertionError(f"{name}: shape {ours.shape} vs golden {gold.shape}")
        diff = np.abs(ours - gold)
        frac = (diff > 2).any(axis=-1).mean()
        if not frac < 1e-3:
            raise AssertionError(f"{name}: {frac:.2%} pixels differ (max {diff.max()})")
        print(f"[3 golden] {name} {size[0]}x{size[1]}: {frac:.4%} pixels off by >2/255 "
              f"(max {diff.max()})", flush=True)


def phase_full_frame(dev):
    import numpy as np
    import torch
    from portrayer_tpu_torch import Image, RenderConfig, scenes
    from portrayer_tpu_torch.image_io import read_png
    from portrayer_tpu_torch.ops import cuda_intersect

    spec = scenes.load("big-scene")
    w, h = spec.size
    cfg = RenderConfig(device=dev, samples=FULL_FRAME_SPP, max_rays_per_launch=131072)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "big-scene.png")
    img = Image(None, w, h)
    torch.cuda.synchronize()
    cuda_intersect.reset_counts()
    t0 = time.perf_counter()
    img.render(spec.scene, spec.camera, spec.background, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_intersect.COUNTS)
    img.save_as(path)
    if not np.array_equal(read_png(path), img.buffer):
        raise AssertionError("saved PNG does not decode to the rendered bytes")
    if img.buffer.shape != (h, w, 3) or img.buffer.max() == 0:
        raise AssertionError("full frame is empty or misshapen")
    if counts["nearest"] == 0 or counts["any_hit"] == 0:
        raise AssertionError(f"main path did not launch both kernel modes: {counts}")
    if counts["plain_on_cuda"] != 0:
        raise AssertionError(f"plain version ran on CUDA tensors: {counts}")
    mrays = w * h * FULL_FRAME_SPP / secs / 1e6
    print(f"[4 full frame] big-scene {w}x{h} x {FULL_FRAME_SPP} spp, tile {cfg.tile}, "
          f"{cfg.max_rays_per_launch} rays/launch: {secs:.3f} s, {mrays:.3f} Mrays/s primary; "
          f"launches nearest {counts['nearest']} any-hit {counts['any_hit']}, plain on CUDA "
          f"{counts['plain_on_cuda']}; PNG {os.path.relpath(path, ROOT)} round-trips",
          flush=True)
    return counts


def phase_simple_frame(dev):
    """simple at its 256x256 through render_linear and the kernel, held
    against the flat oracle's render on the card: fewer than 0.1% of pixels
    may differ by more than 1e-4 (a silhouette sample that one sweep hits
    and the other misses moves its pixel by up to a quarter of a color)."""
    import numpy as np
    import torch
    from portrayer_tpu_torch import RenderConfig, render_linear, scenes
    from portrayer_tpu_torch.ops import cuda_intersect

    spec = scenes.load("simple")
    w, h = spec.size
    args = (spec.scene, spec.camera, spec.size, spec.background)
    torch.cuda.synchronize()
    cuda_intersect.reset_counts()
    t0 = time.perf_counter()
    ours = render_linear(*args, RenderConfig(device=dev, samples=SIMPLE_SPP))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_intersect.COUNTS)
    if counts["nearest"] == 0 or counts["any_hit"] == 0 or counts["plain_on_cuda"] != 0:
        raise AssertionError(f"simple did not run through the kernels alone: {counts}")
    flat = render_linear(*args, RenderConfig(device=dev, samples=SIMPLE_SPP, accel="flat"))
    if ours.shape != (h, w, 3) or not np.isfinite(ours).all() or ours.max() <= 0.0:
        raise AssertionError("simple frame is empty, misshapen or not finite")
    diff = np.abs(ours - flat).max(axis=-1)
    frac = (diff > 1e-4).mean()
    if not frac < 1e-3:
        raise AssertionError(f"simple: {frac:.3%} pixels differ from the flat oracle")
    print(f"[4 simple] {w}x{h} x {SIMPLE_SPP} spp via render_linear: {secs:.3f} s, "
          f"{w * h * SIMPLE_SPP / secs / 1e6:.3f} Mrays/s primary; launches nearest "
          f"{counts['nearest']} any-hit {counts['any_hit']}; {frac:.4%} pixels differ from "
          f"the flat oracle by >1e-4 (max {diff.max():.3g})", flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import portrayer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_card(dev)
    err, timing = phase_kernels(dev)
    phase_goldens(dev)
    counts = phase_full_frame(dev)
    phase_simple_frame(dev)

    kernels = [
        {"name": f"sweep_{mode}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": TPU_KERNEL, "launches": counts[mode], "max_abs_err": err[mode],
         "ms": timing[mode][0], "plain_ms": timing[mode][1]}
        for mode in ("nearest", "any_hit")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
