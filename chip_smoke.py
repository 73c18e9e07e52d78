#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``portrayer_tpu_torch/csrc`` and runs seven
phases, each printing its own lines; any failure raises and exits non-zero:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, kernel
   build seconds and, per kernel instantiation, ptxas registers and spills;
2. each sweep kernel (nearest, any-hit) against its plain PyTorch version
   on the card: camera rays of big-scene, simple, torus-showcase,
   glossy-reflection, primitives-simple, single-triangle, four-shapes and
   the inline scenes of ``tests/_torch_jax.py``: ellipsoids, procedural
   meshes (73,729 triangles), normal-mapping-numpy (image and procedural
   textures, normal maps) and soft-shadows-icosphere (an area light); their
   shadow rays (towards a point of each area light drawn per ray, as the
   shading draws it), and the child rays of a real bounce round 0 (with
   their source surfaces) and those rays' shadow rays.  Gates: the JAX package's kernel gates, and on torus chunks its
   torus gate; every difference is counted.  Then both versions' times at
   the render's launch shapes of big-scene, torus-showcase,
   glossy-reflection, procedural-meshes and single-triangle (a call by
   CUDA events), beside the bound of each launch, on the uniform camera
   rays; the kernel's times on a second set in the render's ray order (the
   middle tile of the middle tile row, as ``render._tile_rays`` builds it)
   and its shadow rays, held against the plain version too;
3. renders of simple (64x64), big-scene (160x82), torus-showcase (64x64),
   single-triangle (160x120) and four-shapes (256x68) against the
   committed self-goldens (on torus-showcase, the pixels of
   TORUS_JIT_PIXELS aside);
4. the main paths through ``Image.render``, each with the kernel launch
   counts of its run: big-scene's full 1980x1020 frame, torus-showcase at
   256x256, glossy-reflection at 910x512, procedural-meshes at 960x540,
   single-triangle at 640x480, normal-mapping-numpy and
   soft-shadows-icosphere at 910x512 and four-shapes at 1920x512, all at
   16 spp, with live rays per bounce round, host syncs and dropped
   throughput (from the render's TraceStats, which cost one host sync per
   chunk more); then simple at 256x256, glossy-reflection,
   procedural-meshes and normal-mapping-numpy (240x136) at 4 spp through
   ``render_linear``, held against the flat oracle's render on the card;
5. gradients through ``trace``: of sum(acc^2) on a 64x64 tile of big-scene
   and of torus-showcase with respect to mat_diffuse, light_pos and inv,
   through the kernel and through its plain version on the card, held
   together; then a fit at full width, big-scene at 1980x1020 and 1 spp:
   three gradient steps on mat_diffuse (started at 0.7 of the true one)
   against the true render, backward per chunk of 131,072 rays, with the
   loss falling at every step, each step's seconds and the peak memory;
6. multi-device (``portrayer_tpu_torch.parallel``): world size 1 under
   NCCL in this process, then two gloo ranks sharing the card (started by
   torch.multiprocessing), each through render_frame_distributed on
   big-scene's full 1980x1020 frame at 4 spp (one trace per rank: 8,078,400
   rays at world size 1), trace_sharded's per-rank partials and train_step
   at 1 spp with respect to mat_diffuse; every rank's image, partials,
   loss and gradients against the single-process oracle on the card (the
   shards traced one after the other, keys fold_in(key, r), summed) within
   1e-5; wall seconds, Mrays/s, peak memory, kernel launches and the
   all-reduce's own time of each rank; the kernel at the one-shard
   frame's launch sizes (its 8,078,400 camera rays and their 24,235,200
   shadow rays, one launch of each mode) against its plain version under
   phase 2's gates; and beside the one-shard render Image.render's tiled
   path at the same size and spp.  Then the beam sweep on big-scene's
   uniform camera rays and their shadow rays, against the flat sweep
   (tests/test_beam.py's gates) and the kernel (the kernel gates by
   category, every ray apart printed with its branches and cleared by a
   float64 witness), with its time and loop steps;
   checked_trace on simple's 16x16 tile, clean; the float64 check mode
   (accel="flat") against the float32 kernel render of simple at 48x36 x
   2 spp;
7. the sweep kernel alone on the device (torch.profiler) at each launch
   shape of phase 2; last, so that the profiler cannot weigh on the wall
   times of phases 4 to 6.

The last two lines are a JSON object of per-kernel numbers and the
``{"ok": true, ...}`` line.  Without a CUDA device it exits 1 at once.
Nothing here imports JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "out")
GOLDEN_DIR = os.path.join(ROOT, "tests", "self_golden")
KERNEL_SOURCE = "portrayer_tpu_torch/csrc/sweep.cu"
TPU_KERNEL = "portrayer_tpu/ops/pallas_intersect.py:159"
FULL_FRAME_SPP = 16
SIMPLE_SPP = 4
GLOSSY_LINEAR_SPP = 4
# procedural-meshes through render_linear against the flat oracle: a cut
# frame, as the oracle's [rays x 512 pairs] f32 temporaries are 134 MB each
# at a 65,536-ray launch.
MESH_LINEAR_SIZE = (240, 136)
MESH_LINEAR_SPP = 4
# Gradient phase: the tiles held kernel against plain version, and the fit.
GRAD_TILE = 64
GRAD_TILE_SPP = 4
GRAD_FIELDS = ("mat_diffuse", "light_pos", "inv")
# Kernel and plain version select the same winners; their gradients differ
# only by the order of the float atomics that sum a gather's backward
# (index_add on the card): this much of the largest gradient entry.
GRAD_RTOL = 1e-4
FIT_STEPS = 3
FIT_START = 0.7
# Step of the fit: the largest gradient entry moves this far (a small step
# along the gradient of the quadratic loss lowers it).
FIT_STEP = 0.05
FIT_TILE = (256, 512)  # 131,072 rays a chunk at 1 spp
LAUNCH_RAYS = 131072
# Timed launches of the plain version per turn (it loops over the chunks in
# Python: 577 of them on procedural-meshes).
PLAIN_ITERS = 3
TORUS_TOL = 1e-3  # the JAX package's torus gate (tests/test_torus.py)
# Pixels (row-major) of the torus-showcase self-golden (64x64, 4 spp, seed
# 0) that the JAX package's own render, run op by op without jit, has off
# by more than 2/255: the golden was rendered jitted, and XLA's FMAs move
# the f32 torus roots.  tests/test_torch_trace.py finds them with JAX.
TORUS_JIT_PIXELS = (535, 678, 743, 985, 1199, 1239, 1816, 1993, 2029, 2055, 2180, 2243,
                    2306, 2368)

# H100 SXM peaks at 700 W (NVIDIA data sheet): f32 outside the tensor cores
# and HBM bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per (ray, primitive) of each branch, counted in sweep.cu
# for a ray without a source surface: add, sub, mul, div, sqrt,
# min/max/clamp and expf/logf/cosf count one each; negation, fabs, compares
# and selects none.  The chunk cull costs CULL_FLOPS per (ray, chunk).
BRANCH_FLOPS = {"sphere_g": 66, "plane_g": 43, "cube_g": 86, "cylinder_g": 82,
                "cone_g": 91, "torus_g": 429, "sphere_w": 26, "aabox": 22, "tri_w": 39}
CULL_FLOPS = 28
# Multi-device phase: big-scene's full frame through render_frame_distributed
# in one trace per rank, at MD_SPP; train_step at MD_TRAIN_SPP with respect to
# MD_FIELDS, from mat_diffuse at MD_START of the truth; ranks and oracle
# agree within MD_TOL (absolute on the image, relative on the loss, of the
# largest entry on the gradients).
MD_SIZE = (1980, 1020)
MD_SPP = 4
MD_TRAIN_SPP = 1
MD_TRAIN_KEY = 21
MD_FIELDS = ("mat_diffuse",)
MD_START = 0.7
MD_TOL = 1e-5
MD_GLOO_RANKS = 2
MD_ALLREDUCE_ITERS = 5
# The plain version takes the one-shard frame's launches this many rays
# at a time.
PLAIN_ROWS = 1 << 20
# The beam sweep on big-scene's uniform camera rays and their shadow rays;
# the float64 check mode on simple (tests/test_render.py's size and spp).
BEAM_RAYS = 131072
# Rays apart from the kernel printed per category (sweeps_apart counts and
# clears them all).
BEAM_RAYS_SHOWN = 4
F64_SIZE = (48, 36)
F64_SPP = 2


def _torus_ids(st):
    import torch
    from portrayer_tpu_torch.scene.flatten import TORUS

    ids = [i for kind, start, count in st.groups if kind == TORUS
           for i in range(start, start + count)]
    return torch.tensor(ids, dtype=torch.int32, device=st.device)


def _gate_nearest(k, p, label, torus=None):
    """The JAX package's kernel gates (tests/test_pallas.py): .hit equal;
    node mismatches on <= 0.2% of hits, only within 2*2^-16 relative t;
    elsewhere t within rtol 1e-4 / atol 1e-5, and on hits of the node ids
    in `torus` the torus gate, rtol 1e-3 / atol 1e-3.  Returns (max |dt|,
    number of rays whose (hit, node, tri, t) differ at all)."""
    import torch

    if not torch.equal(k.hit, p.hit):
        raise AssertionError(f"{label}: hit differs on {(k.hit != p.hit).sum().item()} rays")
    both = p.hit
    kt, pt = k.t[both], p.t[both]
    mism = k.node[both] != p.node[both]
    frac = mism.float().mean().item() if both.any() else 0.0
    if frac > 0.002:
        raise AssertionError(f"{label}: node mismatch on {frac:.4%} of hits")
    on_torus = torch.zeros_like(mism)
    if torus is not None and torus.numel():
        on_torus = torch.isin(p.node[both], torus)
    if mism.any():
        quantum = 2.0 ** -16 * torch.maximum(kt[mism].abs(), pt[mism].abs())
        quantum = torch.where(on_torus[mism], TORUS_TOL * pt[mism].abs(), quantum)
        if not ((kt[mism] - pt[mism]).abs() <= 2.0 * quantum + 1e-5).all():
            raise AssertionError(f"{label}: node mismatch outside the tie quantum")
    same = ~mism
    if not torch.equal(k.tri[both][same], p.tri[both][same]):
        raise AssertionError(f"{label}: tri differs")
    plain, tor = same & ~on_torus, same & on_torus
    torch.testing.assert_close(kt[plain], pt[plain], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kt[tor], pt[tor], rtol=TORUS_TOL, atol=TORUS_TOL)
    n_diff = int(mism.sum()) + int((kt[same] != pt[same]).sum())
    return ((kt[same] - pt[same]).abs().max().item() if same.any() else 0.0), n_diff


def _plain(o, d, t_min, st, cfg, kw, any_hit=False, rows=None):
    """The plain version on rays o, d; with `rows`, that many rays at a
    time (each ray's answer is its own), the blocks joined."""
    import torch
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_sweep_ref

    R = o.shape[0]
    rows = rows or R
    per_ray = lambda x, s: x[s] if isinstance(x, torch.Tensor) and x.dim() else x
    parts = [intersect_scene_sweep_ref(o[s], d[s], per_ray(t_min, s), float("inf"), st, cfg,
                                       any_hit=any_hit, **{k: v[s] for k, v in kw.items()})
             for s in (slice(lo, lo + rows) for lo in range(0, R, rows))]
    return parts[0] if len(parts) == 1 else type(parts[0])(*map(torch.cat, zip(*parts)))


def _hold(label, o, d, t_min, st, cfg, kw, torus, err, diffs, rows=None):
    """Nearest and any-hit, the kernel (one launch each) against the plain
    version (`rows` rays at a time): _gate_nearest, and .hit equal in
    any-hit mode.  Adds the error and difference counts to err and diffs;
    returns the kernel's nearest hits."""
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_cuda

    inf = float("inf")
    k = intersect_scene_cuda(o, d, t_min, inf, st, cfg, **kw)
    e, n = _gate_nearest(k, _plain(o, d, t_min, st, cfg, kw, rows=rows), f"{label} nearest",
                         torus)
    err["nearest"] = max(err["nearest"], e)
    diffs["nearest"] += n
    ka = intersect_scene_cuda(o, d, t_min, inf, st, cfg, any_hit=True, **kw)
    pa = _plain(o, d, t_min, st, cfg, kw, any_hit=True, rows=rows)
    n_any = int((ka.hit != pa.hit).sum())
    if n_any:
        raise AssertionError(f"{label} any-hit: hit differs on {n_any} rays")
    return k


def _shadow_rays(o, d, hit, st, cfg, t_min=None, src_node=None, src_tri=None):
    """Rays from each nearest hit toward every light ([L*R] rays), as the
    render's shadow batch builds them: from the hit detail's point along
    shade_pre's directions (towards an area light, to a point of its
    parallelogram drawn per ray), t_min = shade_pre's offset, src_node /
    src_tri = the hit, active = hit.  `t_min` and the sources are those of
    the rays o, d (default: cfg.epsilon, none)."""
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.ops.intersect import hit_detail
    from portrayer_tpu_torch.ops.shade import shade_pre

    det = hit_detail(o, d, hit, st, cfg, cfg.epsilon if t_min is None else t_min,
                     src_node=src_node, src_tri=src_tri)
    pre, _ = shade_pre(d, hit, det, st, cfg, rng.PRNGKey(5), hit.hit)
    L = st.n_lights
    return (det.point.repeat(L, 1), pre.shadow_dir.reshape(-1, 3), pre.t_eps.repeat(L),
            hit.hit.repeat(L), hit.node.repeat(L), hit.tri.repeat(L))


def _bounce_rays(o, d, st, cfg):
    """The live child rays of a real round 0 of the trace loop on camera
    rays o, d: (o, d, t_min, src_node, src_tri)."""
    import torch
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.ops import trace as tr

    R = o.shape[0]
    dev = o.device
    q = tr._Queue(o=o, d=d, w=torch.ones(R, device=dev),
                  pix=torch.arange(R, dtype=torch.int32, device=dev),
                  t_min=torch.full((R,), cfg.epsilon, device=dev),
                  src_node=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  src_tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  sid=torch.arange(R, dtype=torch.int32, device=dev))
    bg = torch.zeros((R, 3), device=dev)
    hit = tr._nearest(q, st, cfg)
    acc, child, _ = tr._round_shade(q, hit, bg, bg, st, cfg, rng.PRNGKey(3), is_last=False)
    q1 = tr._compact(child, 2 * R, acc, bg)[0]
    return q1.o, q1.d, q1.t_min, q1.src_node, q1.src_tri


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


def _device_ms(fn, iters):
    """Device time per launch of the sweep kernel launched by `fn`: the
    mean of its kernel events under torch.profiler over `iters` calls (the
    wrapper's own small kernels and its host time left out; a mean over the
    events recorded, as the profiler may drop some); None where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "sweep_kernel" in e.key]
    us, n = sum(e.device_time_total for e in events), sum(e.count for e in events)
    return us / n / 1e3 if us > 0 else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def _bound_ms(args, kw, st, cfg, any_hit):
    """Least time of one sweep launch on these inputs: the larger of its
    f32 operations over PEAK_F32 and its bytes (rays, the packed table
    with its group boxes and real lanes, and the outputs, each once) over
    PEAK_BYTES.  Operations are those this run's data needs for the
    kernel's work, as the plain version counts it (``work=``): CULL_FLOPS
    per group or chunk slab test of the two-level cull and BRANCH_FLOPS per
    (ray, primitive) of the chunks it sweeps, padding lanes left out; in
    nearest mode without the groups and chunks that lie beyond the ray's
    best t, in any-hit mode up to a ray's first hit.
    Returns (ms, "operations" or "bytes", one-level ms, {"group_cull",
    "chunk_cull", "candidates": the kernel's work; "cull",
    "candidates_one_level": a one-level cull's}).  The one-level figure
    counts a slab test per (ray, chunk) and every chunk that cull passes,
    the work of the thread-per-ray kernel, so that its rows compare."""
    from portrayer_tpu_torch.scene.flatten import PACKED_KIND_NAMES, PACK_CHUNK
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_sweep_ref

    R = args[0].shape[0]
    pk = st.packed
    work = {}
    intersect_scene_sweep_ref(*args, st, cfg, any_hit=any_hit, work=work, **kw)
    counts = {k: work.pop(k) for k in ("cull", "group_cull", "chunk_cull")}
    swept = work.pop("swept")
    counts["candidates"] = sum(swept.values())
    counts["candidates_one_level"] = sum(work.values())

    def flops(cull, lanes):
        return CULL_FLOPS * cull + sum(BRANCH_FLOPS[PACKED_KIND_NAMES[k]] * n
                                       for k, n in lanes.items())

    ray_bytes = 4 * (3 + 3 + 1 + 1) + 1 + (8 if kw.get("src_node") is not None else 0)
    ncol = pk.n_chunks * PACK_CHUNK
    out_bytes = 4 if any_hit else 12
    one_level_bytes = (R * (ray_bytes + out_bytes) + ncol * (21 * 4 + 2 * 4)
                       + pk.n_chunks * (4 + 6 * 4))
    # Beside those: the real lanes and the group boxes.
    t_bytes = (one_level_bytes + pk.n_chunks * 4 + pk.groups.n_groups * 6 * 4) / PEAK_BYTES * 1e3
    t_ops = flops(counts["group_cull"] + counts["chunk_cull"], swept) / PEAK_F32 * 1e3
    one_level = max(flops(counts["cull"], work) / PEAK_F32 * 1e3,
                    one_level_bytes / PEAK_BYTES * 1e3)
    if t_ops >= t_bytes:
        return t_ops, "operations", one_level, counts
    return t_bytes, "bytes", one_level, counts


def phase_card(dev):
    import torch
    from portrayer_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]
    print(smi, flush=True)
    _build.load()
    print(f"[1 card] {torch.cuda.get_device_name(dev)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernel build {_build.build_info['seconds']:.2f} s",
          flush=True)
    for name, regs, st_bytes, ld_bytes in _build.ptxas_kernels(_build.build_info["ptxas"]):
        # Mangled sweep_kernel<ANY_HIT, HAS_TORUS>: ...ILb<0|1>ELb<0|1>EE...
        flags = name[name.index("sweep_kernel") + len("sweep_kernel"):][:12]
        mode = "any_hit" if flags.startswith("ILb1") else "nearest"
        torus = "with torus" if "ELb1E" in flags else "no torus"
        print(f"[1 ptxas] sweep_kernel {mode}, {torus}: {regs} registers, spill stores "
              f"{st_bytes} B, spill loads {ld_bytes} B", flush=True)
    return smi


def _inline(name):
    """An inline scene of ``tests/_torch_jax.py`` at full size as a
    SceneSpec: procedural-meshes (73,729 triangle pairs in 577 tri_w
    chunks), normal-mapping-numpy (1024x1024 and 1024x768 textures and
    normal maps) or soft-shadows-icosphere (two 5,120-triangle icospheres,
    an area light)."""
    import portrayer_tpu_torch as T
    from portrayer_tpu_torch import scenes
    import _torch_jax  # tests/ is on sys.path (main)

    build = {"procedural-meshes": _torch_jax.procedural_meshes,
             "normal-mapping-numpy": _torch_jax.normal_mapping_numpy,
             "soft-shadows-icosphere": _torch_jax.soft_shadows_icosphere}[name]
    scene, cam, size = build(T)
    return scenes.SceneSpec(scene=scene, camera=cam, size=size,
                            background=scenes.sky_background, name=name)


# Scenes whose launches phase 2 times.
TIMED = ("big-scene", "torus-showcase", "glossy-reflection", "procedural-meshes",
         "single-triangle")


def _scene_cases():
    """(name, camera rays, scene, camera settings, size); the inline scenes
    come from ``tests/_torch_jax.py``."""
    import portrayer_tpu_torch as T
    from portrayer_tpu_torch import scenes
    from _torch_jax import ellipsoids

    cases = []
    # The timed scenes draw at least LAUNCH_RAYS camera rays.
    for name, n_rays in (("big-scene", 262144), ("simple", 65536), ("torus-showcase", 131072),
                         ("glossy-reflection", 131072), ("primitives-simple", 65536),
                         ("single-triangle", 131072), ("four-shapes", 131072)):
        spec = scenes.load(name)
        cases.append((name, n_rays, spec.scene, spec.camera, spec.size))
    cases.append(("ellipsoids", 65536) + ellipsoids(T))
    for name in ("procedural-meshes", "normal-mapping-numpy", "soft-shadows-icosphere"):
        spec = _inline(name)
        cases.append((name, 131072, spec.scene, spec.camera, spec.size))
    return cases


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns (errors and difference
    counts per mode, timings per scene, branches seen)."""
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.scene.flatten import PACKED_KIND_NAMES

    cfg = RenderConfig(device=dev)
    err = {"nearest": 0.0, "any_hit": 0.0}
    diffs = {"nearest": 0, "any_hit": 0}
    branches = set()
    timing = {}

    def check(label, o, d, t_min, st, kw, torus):
        return _hold(label, o, d, t_min, st, cfg, kw, torus, err, diffs)

    for name, n_rays, scene, camset, size in _scene_cases():
        w, h = size
        st = flatten_scene(scene, dev)
        torus = _torus_ids(st)
        branches.update(PACKED_KIND_NAMES[k] for k, _, _ in st.packed.kind_ranges)
        cam = Camera(camset, size, dev)
        u = rng.uniform(rng.PRNGKey(7), (n_rays, 2), dev)
        o, d = cam.rays_at(u[:, 0] * w, u[:, 1] * h)
        src = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
        check(f"{name} camera", o, d, cfg.epsilon, st, {}, torus)
        near = check(f"{name} camera+src", o, d, cfg.epsilon, st,
                     {"src_node": src, "src_tri": src}, torus)
        so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
        skw = dict(active=sact, src_node=snode, src_tri=stri)
        check(f"{name} shadow", so, sd, st_min, st, skw, torus)
        line = (f"[2 kernels] {name} {st.packed.kind_ranges}: {n_rays} camera rays, "
                f"{near.hit.float().mean():.3f} hit; {int(sact.sum())} shadow rays")
        if st.any_reflective:
            bo, bd, bt, bn, btri = _bounce_rays(o, d, st, cfg)
            bhit = check(f"{name} bounce", bo, bd, bt, st,
                         {"src_node": bn, "src_tri": btri}, torus)
            so, sd, st_min, sact, snode, stri = _shadow_rays(bo, bd, bhit, st, cfg, bt, bn, btri)
            check(f"{name} bounce shadow", so, sd, st_min, st,
                  dict(active=sact, src_node=snode, src_tri=stri), torus)
            line += (f"; {bo.shape[0]} round-0 child rays, {bhit.hit.float().mean():.3f} hit, "
                     f"{int(sact.sum())} of their shadow rays")
        print(line + "; kernel and plain version agree", flush=True)

        if name in TIMED:
            ro, rd = _render_order_rays(cam, size, cfg)
            rsrc = src[:LAUNCH_RAYS]
            rnear = check(f"{name} render-order camera", ro, rd, cfg.epsilon, st,
                          {"src_node": rsrc, "src_tri": rsrc}, torus)
            so, sd, st_min, sact, snode, stri = _shadow_rays(ro, rd, rnear, st, cfg)
            check(f"{name} render-order shadow", so, sd, st_min, st,
                  dict(active=sact, src_node=snode, src_tri=stri), torus)
            print(f"[2 kernels] {name}: {LAUNCH_RAYS} camera rays in render order, "
                  f"{rnear.hit.float().mean():.3f} hit; {int(sact.sum())} shadow rays; "
                  f"kernel and plain version agree", flush=True)
            sets = {"uniform": _launch_shapes(o, d, near, st, cfg),
                    "render order": _launch_shapes(ro, rd, rnear, st, cfg)}
            timing[name] = _time_launches(name, sets, st, cfg)
            timing[name]["launch_sets"] = (sets, st)
    return err, diffs, timing, sorted(branches)


def phase_device_times(timing, cfg):
    """The sweep kernel's device time (_device_ms) on each launch shape of
    phase 2.  Run last: after the profiler had run in phase 2, the
    host-bound main paths of phase 4 read slower than in separate
    processes (PERF.md, section 6).  Adds "device_ms" per mode, and per
    mode of "render_order", to `timing`."""
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_cuda

    for name, t in timing.items():
        sets, st = t.pop("launch_sets")
        for order, shapes in sets.items():
            for mode, (args, kw, any_hit) in shapes.items():
                ms = _device_ms(lambda: intersect_scene_cuda(*args, st, cfg, any_hit=any_hit,
                                                             **kw), 20)
                (t if order == "uniform" else t["render_order"])[mode] += (ms,)
                print(f"[7 device] {name} {mode}, {order}: sweep kernel {_fmt(ms)} on the "
                      f"device", flush=True)


def _render_order_rays(cam, size, cfg):
    """LAUNCH_RAYS primary rays in the render's order: the middle tile of
    the middle tile row at the spp of one launch, pixel-major with a
    pixel's samples contiguous, as ``render._tile_rays`` builds them.  (The
    row's first tile sees only background on big-scene and
    single-triangle.)"""
    from portrayer_tpu_torch import render, rng

    th, tw = cfg.tile
    x0 = (-(-size[0] // tw) - 1) // 2 * tw
    y0 = (-(-size[1] // th) - 1) // 2 * th
    o, d, *_ = render._tile_rays(rng.PRNGKey(5), cam, x0, y0, 0, cfg=cfg,
                                 background=render.default_background, tile_h=th, tile_w=tw,
                                 spp=LAUNCH_RAYS // (th * tw), samples=FULL_FRAME_SPP)
    return o, d


def _launch_shapes(o, d, near, st, cfg):
    """The render path's launch shapes on camera rays o, d whose nearest
    hits are `near`: LAUNCH_RAYS primary rays (a 128x128 tile x 8 spp) and
    one any-hit launch over their L x LAUNCH_RAYS shadow rays.  Returns
    {mode: (args, kwargs, any_hit)}."""
    import torch

    dev = o.device
    inf = float("inf")
    R, n_rays = LAUNCH_RAYS, o.shape[0]
    src = torch.full((R,), -1, dtype=torch.int32, device=dev)
    so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
    sel = torch.cat([torch.arange(R, device=dev) + li * n_rays for li in range(st.n_lights)])
    return {
        "nearest": ((o[:R].contiguous(), d[:R].contiguous(), cfg.epsilon, inf),
                    dict(src_node=src, src_tri=src), False),
        "any_hit": ((so[sel].contiguous(), sd[sel].contiguous(), st_min[sel].contiguous(), inf),
                    dict(active=sact[sel], src_node=snode[sel], src_tri=stri[sel]), True),
    }


def _time_launches(name, ray_sets, st, cfg):
    """Both modes at the launch shapes of each ray set ({"uniform": ...,
    "render order": ...}, from _launch_shapes).  On the uniform set the
    plain version (PLAIN_ITERS launches) and the kernel (20) in turns:
    plain, kernel, kernel, plain; on the render-order set the kernel alone,
    twice.  Then the cull alone: the nearest kernel on LAUNCH_RAYS rays,
    drawn from the uniform camera rays that cross no chunk AABB, which
    evaluate no candidate.  Returns {mode: (kernel ms, plain ms, bound ms,
    bound_by, one-level bound ms), "render_order": {mode: (kernel ms, bound
    ms, bound_by, one-level bound ms)}, "cull_only_ms": ms or None}; kernel
    ms is a call of the wrapper by CUDA events (phase_device_times adds the
    kernel's device ms)."""
    import torch
    from portrayer_tpu_torch.ops import cuda_intersect as ci
    from portrayer_tpu_torch.ops.cuda_intersect import (
        intersect_scene_cuda, intersect_scene_sweep_ref)

    inf = float("inf")
    R = LAUNCH_RAYS
    out = {"render_order": {}}
    for order, shapes in ray_sets.items():
        for mode, (args, kw, any_hit) in shapes.items():
            kern = lambda: intersect_scene_cuda(*args, st, cfg, any_hit=any_hit, **kw)
            plain = lambda: intersect_scene_sweep_ref(*args, st, cfg, any_hit=any_hit, **kw)
            if not torch.equal(kern().hit, plain().hit):
                raise AssertionError(f"{name} {mode} at the launch shape ({order}): hit differs")
            uniform = order == "uniform"
            p1 = _time_ms(plain, PLAIN_ITERS) if uniform else None
            k1 = _time_ms(kern, 20)
            k2 = _time_ms(kern, 20)
            p2 = _time_ms(plain, PLAIN_ITERS) if uniform else None
            bound, bound_by, one_level, work = _bound_ms(args, kw, st, cfg, any_hit)
            ms = (k1 + k2) / 2
            if uniform:
                out[mode] = (ms, (p1 + p2) / 2, bound, bound_by, one_level)
                plain_note = f"plain {out[mode][1]:.3f} ms ({PLAIN_ITERS} launches a turn), "
            else:
                out["render_order"][mode] = (ms, bound, bound_by, one_level)
                plain_note = ""
            n = args[0].shape[0]
            live = max(int(kw["active"].sum()) if "active" in kw else n, 1)
            print(f"[2 timing] {name} {mode}, {order} ({n} rays): kernel {ms:.3f} ms a call "
                  f"({k1:.3f}, {k2:.3f}), {plain_note}bound {bound:.4f} ms ({bound_by}; a "
                  f"one-level cull's {one_level:.4f} ms); per active ray "
                  f"{work['group_cull'] / live:.1f} group and {work['chunk_cull'] / live:.1f} "
                  f"chunk slab tests, {work['candidates'] / live:.1f} candidates (a one-level "
                  f"cull: {work['cull'] / live:.1f} and "
                  f"{work['candidates_one_level'] / live:.1f})", flush=True)
    (oc, dc, *_), _, _ = ray_sets["uniform"]["nearest"]
    t_min, t_max, active = ci._rays(oc, cfg.epsilon, inf, None)
    none = torch.nonzero(~ci._cull(oc, ci._safe_rcp(dc), t_min, t_max, active,
                                   st.packed.chunk_min, st.packed.chunk_max).any(dim=1))
    none = none.squeeze(1)
    out["cull_only_ms"] = None
    if none.numel():
        rep = none[torch.arange(R, device=oc.device) % none.numel()]
        oc, dc = oc[rep].contiguous(), dc[rep].contiguous()
        if intersect_scene_cuda(oc, dc, cfg.epsilon, inf, st, cfg).hit.any():
            raise AssertionError(f"{name}: a ray that crosses no chunk hit")
        out["cull_only_ms"] = _time_ms(lambda: intersect_scene_cuda(oc, dc, cfg.epsilon, inf,
                                                                    st, cfg), 20)
        print(f"[2 timing] {name} nearest, the cull alone ({R} rays that cross none of the "
              f"{st.packed.n_chunks} chunks): kernel {out['cull_only_ms']:.3f} ms", flush=True)
    return out


def phase_goldens(dev):
    import numpy as np
    from portrayer_tpu_torch import RenderConfig, render_u8, scenes
    from portrayer_tpu_torch.image_io import read_png

    for name, size in (("simple", (64, 64)), ("big-scene", (160, 82)),
                       ("torus-showcase", (64, 64)), ("single-triangle", (160, 120)),
                       ("four-shapes", (256, 68))):
        spec = scenes.load(name)
        cfg = RenderConfig(device=dev, samples=4, tile=(64, 64), seed=0)
        ours = render_u8(spec.scene, spec.camera, size, spec.background, cfg).astype(np.int16)
        gold = read_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(np.int16)
        if ours.shape != gold.shape:
            raise AssertionError(f"{name}: shape {ours.shape} vs golden {gold.shape}")
        diff = np.abs(ours - gold)
        off = (diff > 2).any(axis=-1).reshape(-1)
        frac = off.mean()
        note = ""
        if name == "torus-showcase":
            # The rule holds on the pixels where the JAX package's own
            # op-by-op render agrees with its jitted golden.
            jit = np.zeros_like(off)
            jit[list(TORUS_JIT_PIXELS)] = True
            note = (f"; {int((off & jit).sum())} of them among the {jit.sum()} pixels "
                    f"the JAX package's op-by-op render has off")
            off = off & ~jit
        if not off.mean() < 1e-3:
            raise AssertionError(f"{name}: {frac:.2%} pixels differ (max {diff.max()}){note}")
        print(f"[3 golden] {name} {size[0]}x{size[1]}: {frac:.4%} pixels off by >2/255 "
              f"(max {diff.max()}){note}", flush=True)


def _main_path(dev, spec, path_counts):
    """One main path: `spec` (a SceneSpec or a registry name) at its size
    and FULL_FRAME_SPP through Image.render, with the counts of that run
    alone."""
    import numpy as np
    import torch
    from portrayer_tpu_torch import Image, RenderConfig, scenes
    from portrayer_tpu_torch.image_io import read_png
    from portrayer_tpu_torch.ops import cuda_intersect

    if isinstance(spec, str):
        spec = scenes.load(spec)
    name = spec.name
    w, h = spec.size
    cfg = RenderConfig(device=dev, samples=FULL_FRAME_SPP, max_rays_per_launch=LAUNCH_RAYS,
                       queue_caps=spec.queue_caps)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.png")
    img = Image(None, w, h)
    stats = []
    torch.cuda.synchronize()
    cuda_intersect.reset_counts()
    t0 = time.perf_counter()
    img.render(spec.scene, spec.camera, spec.background, cfg, stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_intersect.COUNTS)
    path_counts[name] = counts
    img.save_as(path)
    if not np.array_equal(read_png(path), img.buffer):
        raise AssertionError(f"{name}: saved PNG does not decode to the rendered bytes")
    if img.buffer.shape != (h, w, 3) or img.buffer.max() == 0:
        raise AssertionError(f"{name}: frame is empty or misshapen")
    if counts["nearest"] == 0 or counts["any_hit"] == 0:
        raise AssertionError(f"{name}: main path did not launch both kernel modes: {counts}")
    if counts["plain_on_cuda"] != 0:
        raise AssertionError(f"{name}: plain version ran on CUDA tensors: {counts}")
    chunks = len(stats)  # every chunk traces the same number of rays
    live = sum(st.live for st in stats).tolist()
    rounds = sum(n > 0 for st in stats for n in st.live.tolist())
    syncs = sum(st.syncs for st in stats)
    dropped_w = sum(st.dropped_w for st in stats) / chunks
    if dropped_w > 1e-3:
        raise AssertionError(f"{name}: queue overflow dropped {dropped_w:.4%} of the throughput")
    mrays = w * h * FULL_FRAME_SPP / secs / 1e6
    print(f"[4 main path] {name} {w}x{h} x {FULL_FRAME_SPP} spp, tile {cfg.tile}, "
          f"{LAUNCH_RAYS} rays/launch: {secs:.3f} s, {mrays:.3f} Mrays/s primary; {chunks} chunks, "
          f"launches nearest {counts['nearest']} any-hit {counts['any_hit']} "
          f"({counts['nearest'] / chunks:.2f} and {counts['any_hit'] / chunks:.2f} per chunk), "
          f"plain on CUDA {counts['plain_on_cuda']}; rounds {rounds}, host syncs of the "
          f"live counts {syncs} ({syncs / chunks:.2f} per chunk); live rays per round "
          f"{live}; dropped_w {dropped_w:.3g}; PNG {os.path.relpath(path, ROOT)} round-trips",
          flush=True)


def _linear_vs_flat(dev, spec, spp, size=None):
    """`spec` (a SceneSpec or a registry name) through render_linear and
    the kernels, held against the flat oracle's render on the card: fewer
    than 0.1% of pixels may differ by more than 1e-4 (a silhouette sample
    that one sweep hits and the other misses moves its pixel by a large
    step; on a mesh, a ray leaving a triangle meets a neighbour that the
    kernel, which excludes the source pair, and the oracle, which raises
    its t-range start, may decide apart)."""
    import numpy as np
    import torch
    from portrayer_tpu_torch import RenderConfig, render_linear, scenes
    from portrayer_tpu_torch.ops import cuda_intersect

    if isinstance(spec, str):
        spec = scenes.load(spec)
    name = spec.name
    w, h = size or spec.size
    args = (spec.scene, spec.camera, (w, h), spec.background)
    torch.cuda.synchronize()
    cuda_intersect.reset_counts()
    t0 = time.perf_counter()
    ours = render_linear(*args, RenderConfig(device=dev, samples=spp))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda_intersect.COUNTS)
    if counts["nearest"] == 0 or counts["any_hit"] == 0 or counts["plain_on_cuda"] != 0:
        raise AssertionError(f"{name} did not run through the kernels alone: {counts}")
    t0 = time.perf_counter()
    flat = render_linear(*args, RenderConfig(device=dev, samples=spp, accel="flat"))
    flat_secs = time.perf_counter() - t0
    if ours.shape != (h, w, 3) or not np.isfinite(ours).all() or ours.max() <= 0.0:
        raise AssertionError(f"{name} frame is empty, misshapen or not finite")
    diff = np.abs(ours - flat).max(axis=-1)
    frac = (diff > 1e-4).mean()
    print(f"[4 linear] {name} {w}x{h} x {spp} spp via render_linear: {secs:.3f} s, "
          f"{w * h * spp / secs / 1e6:.3f} Mrays/s primary; launches nearest "
          f"{counts['nearest']} any-hit {counts['any_hit']}; flat oracle {flat_secs:.3f} s; "
          f"{frac:.4%} pixels differ from the flat oracle by >1e-4 (max {diff.max():.3g})",
          flush=True)
    if not frac < 1e-3:
        raise AssertionError(f"{name}: {frac:.3%} pixels differ from the flat oracle")


class _PlainSweep:
    """Within the block, the render's sweeps run the kernel's plain version
    on the card's tensors (counted as plain_on_cuda), not the kernel."""

    def __enter__(self):
        from portrayer_tpu_torch.ops import cuda_intersect as ci

        self.kernel = ci.intersect_scene_cuda
        ci.intersect_scene_cuda = ci.intersect_scene_sweep_ref
        return self

    def __exit__(self, *exc):
        from portrayer_tpu_torch.ops import cuda_intersect as ci

        ci.intersect_scene_cuda = self.kernel


def _tile_grads(dev, name, plain):
    """Gradients of sum(acc^2) over the middle 64x64 tile of `name` at
    GRAD_TILE_SPP with respect to GRAD_FIELDS, through the kernel or (with
    `plain`) its plain version; returns ({field: gradient}, loss)."""
    import contextlib
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops.trace import trace

    spec = scenes.load(name)
    w, h = spec.size
    cfg = RenderConfig(device=dev)
    st = flatten_scene(spec.scene, dev)
    x0 = (w // 2) // GRAD_TILE * GRAD_TILE
    y0 = (h // 2) // GRAD_TILE * GRAD_TILE
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(9), Camera(spec.camera, spec.size, dev), x0, y0, 0, cfg=cfg,
        background=spec.background, tile_h=GRAD_TILE, tile_w=GRAD_TILE, spp=GRAD_TILE_SPP,
        samples=GRAD_TILE_SPP)
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in GRAD_FIELDS}
    with _PlainSweep() if plain else contextlib.nullcontext():
        acc = trace(rng.PRNGKey(10), o, d, pix, bg, GRAD_TILE * GRAD_TILE,
                    st.replace(**leaves), cfg, w0=w0, spp_contiguous=GRAD_TILE_SPP)
        loss = torch.sum(acc ** 2)
        loss.backward()
    return {f: x.grad for f, x in leaves.items()}, float(loss.detach())


def _frame_pass(dev, st, spec, cfg, diffuse=None, target=None):
    """One pass over the frame of `spec` at cfg.samples, tile by tile as
    ``render._render_tiles`` keys them.  Without `diffuse`: the mean image
    as {tile origin: [P,3]} (no graph).  With `diffuse` (a leaf tensor) and
    `target`: the MSE of the mean image against `target` over the frame's
    pixels, backward run per chunk (the tables replaced per chunk, so one
    chunk's graph is alive at a time) and the gradients summed in
    diffuse.grad; returns the loss."""
    import torch
    from portrayer_tpu_torch import render, rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops.trace import trace

    w, h = spec.size
    th, tw = cfg.tile
    spp = cfg.samples
    cam = Camera(spec.camera, spec.size, dev)
    key = rng.PRNGKey(cfg.seed)
    out, loss = {}, 0.0
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            ckey = rng.fold_in(rng.fold_in(rng.fold_in(key, x0), y0), 0)
            o, d, pix, bg, w0 = render._tile_rays(ckey, cam, x0, y0, 0, cfg=cfg,
                                                  background=spec.background, tile_h=th,
                                                  tile_w=tw, spp=spp, samples=spp)
            tables = st if diffuse is None else st.replace(mat_diffuse=diffuse)
            with torch.set_grad_enabled(diffuse is not None):
                mean = trace(rng.fold_in(ckey, 1), o, d, pix, bg, th * tw, tables, cfg,
                             w0=w0, spp_contiguous=spp) / spp
            if diffuse is None:
                out[(x0, y0)] = mean
                continue
            rows = torch.arange(th, device=dev)[:, None] + y0
            cols = torch.arange(tw, device=dev)[None, :] + x0
            inside = ((rows < h) & (cols < w)).reshape(-1, 1)
            chunk = torch.where(inside, mean - target[(x0, y0)], 0.0).pow(2).sum() / (3 * w * h)
            chunk.backward()
            loss += float(chunk.detach())
    return out if diffuse is None else loss


def phase_gradients(dev):
    """Kernel against plain version under autograd on two tiles, then the
    full-width fit (see the module docstring)."""
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, scenes
    from portrayer_tpu_torch.ops import cuda_intersect

    for name in ("big-scene", "torus-showcase"):
        cuda_intersect.reset_counts()
        gk, lk = _tile_grads(dev, name, plain=False)
        counts = dict(cuda_intersect.COUNTS)
        cuda_intersect.reset_counts()
        gp, lp = _tile_grads(dev, name, plain=True)
        if counts["nearest"] == 0 or counts["plain_on_cuda"] or not cuda_intersect.COUNTS[
                "plain_on_cuda"]:
            raise AssertionError(f"{name}: kernel and plain runs were not apart: {counts}")
        notes = []
        for f in GRAD_FIELDS:
            if not (torch.isfinite(gk[f]).all() and torch.isfinite(gp[f]).all()):
                raise AssertionError(f"{name}: a {f} gradient is not finite")
            scale = gp[f].abs().max().item()
            diff = (gk[f] - gp[f]).abs().max().item()
            if scale == 0.0 or diff > GRAD_RTOL * scale:
                raise AssertionError(f"{name}: {f} gradients differ by {diff:.3g} (largest "
                                     f"entry {scale:.3g})")
            notes.append(f"{f} max |diff| {diff:.3g} of max |g| {scale:.3g}")
        print(f"[5 gradients] {name} {GRAD_TILE}x{GRAD_TILE} tile x {GRAD_TILE_SPP} spp, "
              f"sum(acc^2) {lk:.6g} (plain {lp:.6g}); kernel launches nearest "
              f"{counts['nearest']} any-hit {counts['any_hit']}; kernel against plain version: "
              + "; ".join(notes), flush=True)

    spec = scenes.load("big-scene")
    cfg = RenderConfig(device=dev, samples=1, tile=FIT_TILE, max_rays_per_launch=LAUNCH_RAYS)
    st = flatten_scene(spec.scene, dev)
    target = _frame_pass(dev, st, spec, cfg)
    x = (st.mat_diffuse * FIT_START).requires_grad_()
    losses, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_intersect.reset_counts()
    for step in range(FIT_STEPS + 1):
        x.grad = None
        t0 = time.perf_counter()
        losses.append(_frame_pass(dev, st, spec, cfg, diffuse=x, target=target))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        g = x.grad
        if not torch.isfinite(g).all() or g.abs().max() == 0.0:
            raise AssertionError(f"fit step {step}: gradient not finite or zero")
        if step < FIT_STEPS:
            with torch.no_grad():
                x -= FIT_STEP * g / g.abs().max()
    counts = dict(cuda_intersect.COUNTS)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if any(b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"fit: the loss did not fall at every step: {losses}")
    if counts["nearest"] == 0 or counts["any_hit"] == 0 or counts["plain_on_cuda"]:
        raise AssertionError(f"fit did not run through the kernels alone: {counts}")
    err = ((x.detach() - st.mat_diffuse).abs().max() / st.mat_diffuse.abs().max()).item()
    w, h = spec.size
    print(f"[5 fit] big-scene {w}x{h} x 1 spp, {-(-w // FIT_TILE[1]) * -(-h // FIT_TILE[0])} "
          f"chunks of {FIT_TILE[0] * FIT_TILE[1]} rays, mat_diffuse from {FIT_START} of the "
          f"truth: MSE per step {[f'{v:.6g}' for v in losses]}; seconds per step "
          f"(forward + backward) {[f'{v:.3f}' for v in secs]}; peak memory {peak:.3f} GiB; "
          f"kernel launches nearest {counts['nearest']} any-hit {counts['any_hit']}; "
          f"largest relative error of mat_diffuse after {FIT_STEPS} steps {err:.3g}", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: multi-device, and the beam sweep, float checks and float64 mode
# ---------------------------------------------------------------------------

def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _md_setup(dev, size):
    """big-scene's tables, its spec and the uv background of `size`."""
    import torch
    from portrayer_tpu_torch import flatten_scene, scenes
    from portrayer_tpu_torch.parallel.sharding import _pixel_uv

    spec = scenes.load("big-scene")
    bg = spec.background(_pixel_uv(size[0], size[1], torch.float32, dev))
    return spec, flatten_scene(spec.scene, dev), bg


def _train_rays(dev, spec, size):
    """The train step's rays: the frame's grid at MD_TRAIN_SPP, keyed
    MD_TRAIN_KEY, built whole (train_step slices each rank's block)."""
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.parallel import frame_rays

    w, h = size
    cam = Camera(spec.camera, size, dev)
    return frame_rays(cam, MD_TRAIN_SPP, rng.PRNGKey(MD_TRAIN_KEY), 0, w * h * MD_TRAIN_SPP,
                      cam.dtype, dev)[:3]


def _timed(dev, fn):
    """(result, seconds, kernel launch counts, peak GiB) of fn(), the counts
    zeroed just before it."""
    from portrayer_tpu_torch.ops import cuda_intersect

    _sync(dev)
    _reset_peak(dev)
    cuda_intersect.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    secs = time.perf_counter() - t0
    return out, secs, dict(cuda_intersect.COUNTS), _peak_gib(dev)


def _check_counts(label, counts, dev):
    if dev.type == "cuda" and (counts["nearest"] == 0 or counts["any_hit"] == 0
                               or counts["plain_on_cuda"]):
        raise AssertionError(f"{label} did not run through both kernel modes alone: {counts}")


def _allreduce_ms(dev, n_pixels, group=None):
    """The all-reduce's own time: a [n_pixels, 3] float32 framebuffer,
    summed over the group MD_ALLREDUCE_ITERS times (host clock around
    each, synchronised)."""
    import torch
    import torch.distributed as dist

    x = torch.ones((n_pixels, 3), device=dev)
    dist.all_reduce(x, group=group)
    _sync(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(MD_ALLREDUCE_ITERS):
        dist.all_reduce(x, group=group)
        _sync(dev)
    return (time.perf_counter() - t0) / MD_ALLREDUCE_ITERS * 1e3


def _md_run(dev, mesh, size, spp, spec, st, bg, target, label):
    """On this rank: render_frame_distributed of big-scene at `size` x
    spp, the per-rank partials of trace_sharded (reduce=False) over this
    rank's rows of that frame, and train_step with respect to MD_FIELDS.
    Returns a dict of results (tensors on the host) and prints them."""
    import torch
    from portrayer_tpu_torch import RenderConfig, parallel as par, rng
    from portrayer_tpu_torch.camera import Camera

    w, h = size
    n, r = mesh.size(), mesh.get_local_rank()
    cfg = RenderConfig(device=dev, samples=spp)
    # Twice: the first call grows the caching allocator to the trace's
    # size; the second is the one reported beside the tiled path.
    render = lambda: par.render_frame_distributed(mesh, st, spec.camera, size,
                                                  spec.background, cfg)
    cold = _timed(dev, render)[1]
    img, secs, counts, peak = _timed(dev, render)
    _check_counts(f"{label} render_frame_distributed", counts, dev)
    if img.shape != (h, w, 3) or not np.isfinite(img).all() or img.max() <= 0.0:
        raise AssertionError(f"{label}: the frame is empty, misshapen or not finite")
    ar_ms = _allreduce_ms(dev, w * h, mesh.get_group())
    # The partials over this rank's own rows (the same rows and keys).
    key = rng.PRNGKey(cfg.seed)
    R0 = w * h * spp
    per = (R0 + (-R0) % n) // n
    o, d, pix, w0 = par.frame_rays(Camera(spec.camera, size, dev), spp, key, r * per,
                                   (r + 1) * per, torch.float32, dev)
    parts = par.trace_sharded(mesh, rng.fold_in(key, 1), o, d, pix, bg, w * h, st, cfg, w0=w0,
                              reduce=False, local=True)
    del o, d, pix, w0
    to, td, tpix = _train_rays(dev, spec, size)
    st0 = st.replace(mat_diffuse=st.mat_diffuse * MD_START)
    tcfg = RenderConfig(device=dev, samples=MD_TRAIN_SPP)
    step = lambda: par.train_step(mesh, rng.PRNGKey(MD_TRAIN_KEY), to, td, tpix, bg, w * h,
                                  MD_TRAIN_SPP, target, st0, tcfg, fields=MD_FIELDS)
    tcold = _timed(dev, step)[1]
    (loss, grads), tsecs, tcounts, tpeak = _timed(dev, step)
    _check_counts(f"{label} train_step", tcounts, dev)
    print(f"[6 multi-device] {label}: render_frame_distributed big-scene {w}x{h} x {spp} spp "
          f"({R0} rays, {per} on this rank in one trace): {secs:.3f} s (the first call "
          f"{cold:.3f} s), {R0 / secs / 1e6:.3f} Mrays/s, peak memory {peak:.3f} GiB, launches "
          f"nearest "
          f"{counts['nearest']} any-hit {counts['any_hit']}; all-reduce of the "
          f"{w * h}x3 framebuffer {ar_ms:.3f} ms; train_step ({w}x{h} x {MD_TRAIN_SPP} spp, "
          f"{MD_FIELDS}) {tsecs:.3f} s a step (the first {tcold:.3f} s), peak memory "
          f"{tpeak:.3f} GiB, loss "
          f"{float(loss):.8g}, launches nearest {tcounts['nearest']} any-hit "
          f"{tcounts['any_hit']}", flush=True)
    return {"img": torch.from_numpy(img), "parts": parts.cpu(), "loss": float(loss),
            "grads": {f: g.cpu() for f, g in grads.items()}, "counts": counts,
            "train_counts": tcounts}


def _gloo_rank(rank, world, tmp, device, size, spp):
    """One of the ranks that share the card under gloo (started by
    torch.multiprocessing.spawn): _md_run, its results saved to
    tmp/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    from portrayer_tpu_torch import parallel as par

    dev = torch.device(device)
    par.initialize(f"file://{tmp}/store", world, rank, device=dev, backend="gloo")
    try:
        mesh = par.make_mesh(world, device=dev.type)
        spec, st, bg = _md_setup(dev, size)
        target = torch.load(os.path.join(tmp, "target.pt")).to(dev)
        out = _md_run(dev, mesh, size, spp, spec, st, bg, target,
                      f"{world} gloo ranks on one card, rank {rank}")
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _md_oracles(dev, size, spp, spec, st, bg, target, world):
    """The single-process oracles of `world` ranks on this device: the
    frame's shards traced one after the other, keys fold_in(fold_in(key,
    1), r), summed ([P,3] and the per-shard partials); and the train
    step's shards traced one after the other, keys fold_in(key, r),
    summed, the MSE and one backward: (loss, {field: gradient})."""
    import torch
    from portrayer_tpu_torch import RenderConfig, rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops.trace import trace
    from portrayer_tpu_torch.parallel import frame_rays

    w, h = size
    cfg = RenderConfig(device=dev, samples=spp)
    key = rng.PRNGKey(cfg.seed)
    R0 = w * h * spp
    per = (R0 + (-R0) % world) // world
    cam = Camera(spec.camera, size, dev)
    parts = []
    with torch.no_grad():
        for r in range(world):
            o, d, pix, w0 = frame_rays(cam, spp, key, r * per, (r + 1) * per, torch.float32, dev)
            parts.append(trace(rng.fold_in(rng.fold_in(key, 1), r), o, d, pix, bg, w * h, st,
                               cfg, w0=w0))
            del o, d, pix, w0
    to, td, tpix = _train_rays(dev, spec, size)
    leaves = {f: (getattr(st, f) * (MD_START if f == "mat_diffuse" else 1.0)
                  ).detach().requires_grad_() for f in MD_FIELDS}
    tables = st.replace(**leaves)
    tkey = rng.PRNGKey(MD_TRAIN_KEY)
    tper = to.shape[0] // world
    tcfg = RenderConfig(device=dev, samples=MD_TRAIN_SPP)
    acc = sum(trace(rng.fold_in(tkey, r), to[r * tper:(r + 1) * tper],
                    td[r * tper:(r + 1) * tper], tpix[r * tper:(r + 1) * tper], bg, w * h,
                    tables, tcfg) for r in range(world))
    loss = torch.mean((acc / MD_TRAIN_SPP - target) ** 2)
    loss.backward()
    return ([p.cpu() for p in parts], float(loss.detach()),
            {f: x.grad.cpu() for f, x in leaves.items()})


def _md_compare(label, got, oracle, spp):
    """A rank's results against the oracle: the linear image and each
    partial within MD_TOL absolute, the loss within MD_TOL relative and
    the gradients within MD_TOL of their largest entry."""
    import torch

    parts, loss, grads = oracle
    ref = (sum(parts) / spp).double().numpy().reshape(got["img"].shape)
    img_err = float(np.abs(got["img"].numpy() - ref).max())
    part_err = max(float((g - p).abs().max()) for g, p in zip(got["parts"], parts))
    if not (img_err <= MD_TOL and part_err <= MD_TOL and got["parts"].shape[0] == len(parts)):
        raise AssertionError(f"{label}: image differs from the shard sum by {img_err:.3g}, "
                             f"a partial by {part_err:.3g}")
    if abs(got["loss"] - loss) > MD_TOL * abs(loss):
        raise AssertionError(f"{label}: loss {got['loss']!r} against the oracle's {loss!r}")
    notes = []
    for f, g in grads.items():
        scale = float(g.abs().max())
        diff = float((got["grads"][f] - g).abs().max())
        if scale == 0.0 or not torch.isfinite(got["grads"][f]).all() or diff > MD_TOL * scale:
            raise AssertionError(f"{label}: {f} gradient differs by {diff:.3g} (largest entry "
                                 f"{scale:.3g})")
        notes.append(f"{f} max |diff| {diff:.3g} of max |g| {scale:.3g}")
    print(f"[6 multi-device] {label} against the single-process oracle: image max |diff| "
          f"{img_err:.3g}, partials {part_err:.3g}; loss {got['loss']:.8g} (oracle "
          f"{loss:.8g}); " + "; ".join(notes), flush=True)


def _one_shard_launches(dev, spec, st, err, diffs):
    """The sweep kernel at the one-shard frame's launch sizes: the rows
    that render_frame_distributed traces at world size 1 (MD_SIZE x
    MD_SPP camera rays, its jitter and key) and their shadow rays, one
    launch for each mode, against the plain version (PLAIN_ROWS rays at a
    time) under phase 2's gates and counts."""
    import torch
    from portrayer_tpu_torch import RenderConfig, rng
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.parallel import frame_rays

    w, h = MD_SIZE
    cfg = RenderConfig(device=dev, samples=MD_SPP)
    R0 = w * h * MD_SPP
    t0 = time.perf_counter()
    o, d, _, _ = frame_rays(Camera(spec.camera, MD_SIZE, dev), MD_SPP, rng.PRNGKey(cfg.seed), 0,
                            R0, torch.float32, dev)
    torus = _torus_ids(st)
    near = _hold("one-shard frame camera", o, d, cfg.epsilon, st, cfg, {}, torus, err, diffs,
                 PLAIN_ROWS)
    so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
    del o, d
    _hold("one-shard frame shadow", so, sd, st_min, st, cfg,
          dict(active=sact, src_node=snode, src_tri=stri), torus, err, diffs, PLAIN_ROWS)
    print(f"[6 multi-device] the sweep kernel at the one-shard frame's launch sizes, big-scene "
          f"{w}x{h} x {MD_SPP} spp: {R0} camera rays ({near.hit.float().mean():.3f} hit) and "
          f"{so.shape[0]} shadow rays, one launch of each mode, against the plain version in "
          f"blocks of {PLAIN_ROWS} rays: phase 2's gates hold ({time.perf_counter() - t0:.3f} "
          f"s)", flush=True)


def phase_multi_device(dev, path_counts, err, diffs):
    """World size 1 (NCCL on the card) in this process, then MD_GLOO_RANKS
    gloo ranks sharing the card, each held against the single-process
    oracle on the card; the kernel at the one-shard frame's launch sizes
    against its plain version (err, diffs as in phase 2); beside the
    one-shard render, the tiled path of Image.render at the same size and
    spp."""
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from portrayer_tpu_torch import Image, RenderConfig, parallel as par, rng
    from portrayer_tpu_torch.ops.trace import trace

    size, spp = MD_SIZE, MD_SPP
    w, h = size
    spec, st, bg = _md_setup(dev, size)
    # The fit's target: the true image of the train step's rays.
    with torch.no_grad():
        to, td, tpix = _train_rays(dev, spec, size)
        target = trace(rng.PRNGKey(MD_TRAIN_KEY), to, td, tpix, bg, w * h, st,
                       RenderConfig(device=dev, samples=MD_TRAIN_SPP)) / MD_TRAIN_SPP
        del to, td, tpix

    par.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        got = _md_run(dev, par.make_mesh(1, device=dev.type), size, spp, spec, st, bg, target,
                      f"world size 1 ({backend})")
    finally:
        dist.destroy_process_group()
    path_counts["big-scene distributed, world 1"] = got["counts"]
    path_counts["train_step, world 1"] = got["train_counts"]
    _md_compare(f"world size 1 ({backend})", got, _md_oracles(dev, size, spp, spec, st, bg,
                                                              target, 1), spp)
    _one_shard_launches(dev, spec, st, err, diffs)
    cfg = RenderConfig(device=dev, samples=spp, max_rays_per_launch=LAUNCH_RAYS)
    img = Image(None, w, h)
    _, secs, counts, peak = _timed(dev, lambda: img.render(spec.scene, spec.camera,
                                                           spec.background, cfg))
    _check_counts("tiled Image.render", counts, dev)
    path_counts[f"big-scene tiled, {spp} spp"] = counts
    print(f"[6 multi-device] beside it, Image.render's tiled path, big-scene {w}x{h} x "
          f"{spp} spp, tile {cfg.tile}, {LAUNCH_RAYS} rays/launch: {secs:.3f} s, "
          f"{w * h * spp / secs / 1e6:.3f} Mrays/s, peak memory {peak:.3f} GiB, launches "
          f"nearest {counts['nearest']} any-hit {counts['any_hit']}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(target.cpu(), os.path.join(tmp, "target.pt"))
        t0 = time.perf_counter()
        mp.spawn(_gloo_rank, args=(MD_GLOO_RANKS, tmp, str(dev), size, spp),
                 nprocs=MD_GLOO_RANKS, join=True)
        spawn_secs = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(MD_GLOO_RANKS)]
    oracle = _md_oracles(dev, size, spp, spec, st, bg, target, MD_GLOO_RANKS)
    for r, got in enumerate(ranks):
        label = f"{MD_GLOO_RANKS} gloo ranks on one card, rank {r}"
        _md_compare(label, got, oracle, spp)
        path_counts[f"big-scene distributed, gloo rank {r}"] = got["counts"]
        path_counts[f"train_step, gloo rank {r}"] = got["train_counts"]
    print(f"[6 multi-device] the {MD_GLOO_RANKS} gloo ranks took {spawn_secs:.3f} s from spawn "
          f"to exit (each starts CUDA and loads the kernels)", flush=True)


def _beam_gates(ref, got, label):
    """tests/test_beam.py's gates: .hit equal, t within rtol 1e-4 / atol
    1e-5, a node mismatch only on a tie within 1e-4 relative t."""
    import torch

    if not torch.equal(ref.hit, got.hit):
        raise AssertionError(f"{label}: hit differs on {(ref.hit != got.hit).sum().item()} rays")
    m = ref.hit
    torch.testing.assert_close(got.t[m], ref.t[m], rtol=1e-4, atol=1e-5)
    mism = ref.node[m] != got.node[m]
    tie = (ref.t[m] - got.t[m]).abs() <= 1e-4 * torch.clamp(ref.t[m].abs(), min=1.0)
    if not bool((~mism | tie).all()):
        raise AssertionError(f"{label}: node mismatch outside a tie")
    return float((got.t[m] - ref.t[m]).abs().max()) if bool(m.any()) else 0.0


def phase_checks(dev):
    """The beam sweep against the flat sweep and the kernel on big-scene,
    checked_trace on simple, and the float64 check mode against the
    float32 render."""
    import torch
    from _torch_jax import float64_tables, kernel_apart_limits, sweeps_apart
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render_linear, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.debug import checked_trace
    from portrayer_tpu_torch.ops.beam import intersect_scene_beam
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_cuda
    from portrayer_tpu_torch.ops.intersect import intersect_scene

    spec = scenes.load("big-scene")
    st = flatten_scene(spec.scene, dev)
    st64 = float64_tables(spec.scene, dev)
    w, h = spec.size
    cfg = RenderConfig(device=dev)
    bcfg = RenderConfig(device=dev, accel="beam")
    inf = float("inf")
    u = rng.uniform(rng.PRNGKey(7), (BEAM_RAYS, 2), dev)
    o, d = Camera(spec.camera, spec.size, dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    near = intersect_scene_cuda(o, d, cfg.epsilon, inf, st, cfg)
    so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
    skw = dict(active=sact, src_node=snode, src_tri=stri)
    fcfg = RenderConfig(device=dev, accel="flat")
    for label, args, kw in (("camera", (o, d, cfg.epsilon, inf), {}),
                            ("shadow", (so, sd, st_min, inf), skw)):
        stats = {}
        got = intersect_scene_beam(*args, st, bcfg, stats=stats, **kw)
        err = _beam_gates(intersect_scene(*args, st, fcfg, **kw), got, f"beam {label}")
        # Against the kernel: the kernel gates of tests/test_pallas.py by
        # category, each ray apart shown with its branches and cleared by
        # the float64 witness of sweeps_apart.
        kern = intersect_scene_cuda(*args, st, cfg, **kw)
        apart = sweeps_apart(kern, got, args[0], args[1], args[2], kw, st64, cfg)
        for cat, lines in apart["rays"].items():
            for line in lines[:BEAM_RAYS_SHOWN]:
                print(f"[6 beam] {label} {line}", flush=True)
        ms = _time_ms(lambda: intersect_scene_beam(*args, st, bcfg, **kw), 3)
        kms = _time_ms(lambda: intersect_scene_cuda(*args, st, cfg, **kw), 20)
        limits = kernel_apart_limits(args[0].shape[0])
        counts = ", ".join(f"{c} {apart[c]} (at most {limits[c]}; by branch "
                           f"{apart['branches'][c]})" for c in limits)
        print(f"[6 beam] big-scene {label} rays ({args[0].shape[0]}): beam sweep {ms:.3f} ms a "
              f"call, {stats['trips']} steps of its loop (one host sync each); the kernel "
              f"{kms:.3f} ms; the gates of tests/test_beam.py hold against the flat sweep (max "
              f"|dt| {err:.3g}); against the kernel, rays apart by {counts}, node ties "
              f"{apart['tie']} of {apart['hits']} hits, {apart['uncleared']} not cleared by the "
              f"float64 witness", flush=True)
        over = [c for c in limits if apart[c] > limits[c]]
        if over or apart["uncleared"] or apart["tie"] > 0.002 * apart["hits"]:
            raise AssertionError(f"beam {label} against the kernel: {over} over their limits, "
                                 f"{apart['uncleared']} rays not cleared, {apart['tie']} ties")

    simple = scenes.load("simple")
    ys, xs = torch.meshgrid(torch.arange(16, device=dev), torch.arange(16, device=dev),
                            indexing="ij")
    o, d = Camera(simple.camera, (16, 16), dev).rays_at(xs.reshape(-1).float() + 0.5,
                                                       ys.reshape(-1).float() + 0.5)
    err, acc = checked_trace(rng.PRNGKey(0), o, d, torch.arange(256, dtype=torch.int32,
                                                                 device=dev),
                             torch.zeros((256, 3), device=dev), 256,
                             flatten_scene(simple.scene, dev), RenderConfig(device=dev))
    err.throw()
    if not torch.isfinite(acc).all():
        raise AssertionError("checked_trace: the framebuffer is not finite")
    print(f"[6 checks] checked_trace on simple's 16x16 tile on {acc.device}: no op made or met "
          f"a NaN", flush=True)

    args = (simple.scene, simple.camera, F64_SIZE, simple.background)
    img64 = render_linear(*args, RenderConfig(device=dev, samples=F64_SPP, tile=(48, 48),
                                              accel="flat", dtype=torch.float64))
    img32 = render_linear(*args, RenderConfig(device=dev, samples=F64_SPP, tile=(48, 48)))
    diff = np.abs(img64 - img32)
    if not (diff.mean() < 2e-3 and diff.max() < 0.05) or img64.dtype != np.float64:
        raise AssertionError(f"float64 against float32: mean {diff.mean():.3g}, max "
                             f"{diff.max():.3g}")
    print(f"[6 checks] float64 check mode, simple {F64_SIZE[0]}x{F64_SIZE[1]} x {F64_SPP} spp "
          f"(accel='flat') against the float32 kernel render: mean |diff| {diff.mean():.3g}, "
          f"max {diff.max():.3g} (gate: mean < 2e-3, max < 0.05)", flush=True)


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
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import portrayer_tpu_torch  # noqa: F401
        import _torch_jax  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e})", file=sys.stderr)
        return 1
    from portrayer_tpu_torch import RenderConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_card(dev)
    err, diffs, timing, branches = phase_kernels(dev)
    phase_goldens(dev)
    path_counts = {}
    mesh, textured = _inline("procedural-meshes"), _inline("normal-mapping-numpy")
    for spec in ("big-scene", "torus-showcase", "glossy-reflection", mesh, "single-triangle",
                 textured, _inline("soft-shadows-icosphere"), "four-shapes"):
        _main_path(dev, spec, path_counts)
    _linear_vs_flat(dev, "simple", SIMPLE_SPP)
    _linear_vs_flat(dev, "glossy-reflection", GLOSSY_LINEAR_SPP)
    _linear_vs_flat(dev, mesh, MESH_LINEAR_SPP, MESH_LINEAR_SIZE)
    _linear_vs_flat(dev, textured, MESH_LINEAR_SPP, MESH_LINEAR_SIZE)
    phase_gradients(dev)
    phase_multi_device(dev, path_counts, err, diffs)
    phase_checks(dev)
    phase_device_times(timing, RenderConfig(device=dev))

    kernels = []
    for mode in ("nearest", "any_hit"):
        ms, plain_ms, bound, bound_by, one_level, _ = timing["big-scene"][mode]
        kernels.append({
            "name": f"sweep_{mode}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "branches": branches,
            "launches": sum(c[mode] for c in path_counts.values()),
            "launches_by_path": {p: c[mode] for p, c in path_counts.items()},
            "max_abs_err": err[mode], "rays_differing": diffs[mode],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_one_level": one_level, "library_ms": None,
            "by_scene": {s: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                      "bound_ms_one_level", "device_ms"), t[mode]),
                                 **dict(zip(("ms_render_order", "bound_ms_render_order",
                                             "bound_by_render_order",
                                             "bound_ms_one_level_render_order",
                                             "device_ms_render_order"),
                                            t["render_order"][mode])),
                                 **({"cull_only_ms": t["cull_only_ms"]}
                                    if mode == "nearest" else {}))
                         for s, t in timing.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
