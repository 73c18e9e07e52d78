#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``portrayer_tpu_torch/csrc`` and runs eight
phases, each printing its own lines; any failure raises and exits non-zero:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, kernel
   build seconds and, per kernel instantiation, ptxas registers and spills;
2. each sweep kernel (nearest, any-hit) against its plain PyTorch version
   on the card: camera rays of big-scene, simple, torus-showcase,
   glossy-reflection, primitives-simple, single-triangle, four-shapes and
   the inline scenes of ``tests/_torch_jax.py``: ellipsoids, the glass
   sphere, procedural meshes (73,729 triangles), normal-mapping-numpy
   (image and procedural textures, normal maps) and soft-shadows-icosphere
   (an area light); their shadow rays (towards a point of each area light
   drawn per ray, as the shading draws it), and the child rays of a real
   bounce round 0 (with their source surfaces) and those rays' shadow rays
   (in a refractive scene also the children of round 1: rays that leave
   the glass, or reflect inside it totally, from the node they start on).
   Gates: the JAX package's kernel gates, and on torus chunks its torus
   gate; every difference is counted.  Then both versions' times at
   the render's launch shapes of big-scene, torus-showcase,
   glossy-reflection, procedural-meshes, single-triangle and ellipsoids
   (a call by CUDA events), beside the bound of each launch, on the uniform camera
   rays; the kernel's times on a second set in the render's ray order (the
   middle tile of the middle tile row, as ``render._tile_rays`` builds it)
   and its shadow rays, held against the plain version too; then the
   conditional kernel of ``graphs.switch`` (``csrc/conditional.cu``)
   against the host pick, for every branch, and both their times; and the
   step kernel of ``graphs.loop``'s WHILE node (the same source) against
   the host loop, for loops of 0 to LOOP_END iterations, and both their
   times (the two kernels' own device times are taken last, in phase 8);
   then the threefry kernel (``csrc/threefry.cu``: rng.draw_lanes, the
   glossy draw) against its plain version at 8,192 and 131,072 lanes, bit
   for bit, both timed beside its bound, and the threefry launches of a
   captured glossy-reflection chunk by entry point with its plain calls on
   CUDA tensors (0), read with rng.counts().
   big-scene and procedural-meshes again on tables packed with
   ``packing="morton"`` (MORTON_SCENES): the same rays held (0 rays apart)
   and timed beside the SAH rows, with the group and chunk tests a ray.
   ``ops.shade_hits`` on big-scene's camera rays (its three lights, one
   any-hit launch, counted) against its plain version on CPU tensors: 0
   occlusion verdicts apart, colours within SHADE_HITS_TOL;
3. renders of simple (64x64), big-scene (160x82), torus-showcase (64x64),
   single-triangle (160x120) and four-shapes (256x68) against the
   committed self-goldens (on torus-showcase, the pixels of
   TORUS_JIT_PIXELS aside), through the captured render;
4. the main paths through ``Image.render``, which captures each chunk
   program as one CUDA graph (each bounce round's slices its conditional
   bodies; the rounds of the tail of equal capacity but the last one
   loop, a WHILE node whose body holds one round's slices) and replays
   it, each with the kernel launch counts
   of its run (counted on the device where the graph runs them):
   big-scene's full 1980x1020 frame, torus-showcase at 256x256,
   glossy-reflection at 910x512, procedural-meshes at 960x540,
   single-triangle at 640x480, normal-mapping-numpy and
   soft-shadows-icosphere at 910x512 and four-shapes at 1920x512, all at
   16 spp, with live rays per bounce round, host syncs (0 a captured
   chunk) and dropped throughput (from the render's TraceStats, read
   once a frame); the capture's seconds, graphs, bodies, loops and
   replays; beside it in the same call the render again with the graph
   cached, whose launches must equal those of the eager chunk loop
   (``cuda_graphs=False``), and the eager loop, whose linear
   image the captured one must equal within CAPTURED_TOL; on
   torus-showcase and glossy-reflection (DETERMINISTIC_PATHS) the
   captured program (its tail one loop) and the eager loop (every round
   unrolled) again on fresh tables under deterministic algorithms, 0
   pixels apart and 0 host reads captured; then the main paths through
   the flat and the beam sweep (SWEEP_PATHS), captured the same way (the
   beam's ordered walks WHILE nodes, in round 0, in the slices' bodies
   and in the tail loop's body in turn): big-scene 1980x1020,
   procedural-meshes 960x540 and glossy-reflection 910x512 with
   beam_min_prims=0 through the beam, glossy-reflection and
   torus-showcase at 256x256 through the flat sweep, at the spp that
   SWEEP_PATHS gives, each with the same three renders and gates, the
   flat and beam sweeps and beam steps counted on the device in place of
   kernel launches (none), peak reserved memory, and 0 u8 pixels apart
   from the eager loop; procedural-meshes at 960x540 x MORTON_SPP on
   Morton tables, the same three renders and gates, its linear image held
   against the render on SAH tables under IMAGE_GATE; glossy-reflection's
   beam path again under
   deterministic algorithms, 0 pixels apart; then simple at
   256x256, glossy-reflection, procedural-meshes and normal-mapping-numpy
   (240x136) at 4 spp through ``render_linear``, held against the flat
   oracle's render on the card (the oracle op by op);
5. gradients through ``trace``: of sum(acc^2) on a 64x64 tile of big-scene
   and of torus-showcase with respect to mat_diffuse, light_pos and inv,
   through the kernel and through its plain version on the card (op by
   op), held together; then fits at full width, each three gradient
   steps (started at 0.7 of the truth) against the true render with the
   loss falling at every step, through the captured fit program
   (``portrayer_tpu_torch/fit.py``) and op by op (``cuda_graphs=False``):
   glossy-reflection at its published 910x512 x 1 spp (465,920 rays in
   one trace; mat_diffuse and mat_reflectivity) and the glass sphere of
   ``tests/_torch_jax.py`` at 256x256 x 4 spp (262,144 rays, 4x queues of
   1,048,576 lanes; mat_diffuse and light_color), each with its seconds a
   step (the first with its capture), peak memory with every round
   checkpointed and with bounce-round checkpointing off, sweep launches in
   forward (one a mode and live round) and backward (none), host reads a
   step (0 captured), the capture's seconds, graphs, bodies and loops, and
   the captured gradients of every DIFF_FIELDS table held against the
   op-by-op ones within GRAD_RTOL; one more op-by-op step of each with
   every sweep launch held against the plain version under phase 2's gates
   (the fit's own launch sizes); one captured step (its tail one loop)
   on a fresh program and one op-by-op step (every round unrolled) of
   each under deterministic algorithms, 0 gradient entries apart and 0
   host reads captured; the same glossy-reflection fit through the flat
   sweep and through the beam (beam_min_prims=0; SWEEP_FITS), with their
   flat and beam sweeps and beam steps counted on the device, none in a
   backward; the glossy-reflection fit with remat_min_lanes=EXEMPT_LANES
   (its slices of 30,720 and 116,736 lanes keep their autograd
   temporaries in residual slots, their backward replays nothing) beside
   remat_min_lanes 0, captured: seconds a step, peak memory, 0 host reads,
   no sweep in a backward, captured against op by op under deterministic
   algorithms (0 gradient entries apart), and in phase 8 the kernels of a
   cached step's backward of each, which must fall; then big-scene
   at 1980x1020 and 1 spp,
   mat_diffuse, backward per chunk of 131,072 rays, captured, beside one
   pass op by op;
6. multi-device (``portrayer_tpu_torch.parallel``): world size 1 under
   NCCL in this process, then two gloo ranks sharing the card (started by
   torch.multiprocessing), each through render_frame_distributed on
   big-scene's full 1980x1020 frame at 4 spp (one trace per rank: 8,078,400
   rays at world size 1), trace_sharded's per-rank partials and train_step
   at 1 spp with respect to mat_diffuse; every rank's image, partials,
   loss and gradients against the single-process oracle on the card (the
   shards traced one after the other, keys fold_in(key, r), summed) within
   1e-5; wall seconds, Mrays/s, peak memory, kernel launches and the
   all-reduce's own time of each rank (train_step captured, beside one
   step op by op; the oracle runs op by op); the kernel at the one-shard
   frame's launch sizes (its 8,078,400 camera rays and their 24,235,200
   shadow rays, one launch of each mode) against its plain version under
   phase 2's gates; and beside the one-shard render Image.render's tiled
   path at the same size and spp (captured).  Then the beam sweep on big-scene's
   uniform camera rays and their shadow rays, against the flat sweep
   (tests/test_beam.py's gates) and the kernel (the kernel gates by
   category, every ray apart printed with its branches and cleared by a
   float64 witness), with its time and loop steps (counted on the
   device); checked_trace on simple's 16x16 tile, clean (op by op); the
   float64 check mode (accel="flat") through the captured render against
   its op-by-op render within CAPTURED_TOL and against the float32 kernel
   render of simple at 48x36 x 2 spp;
7. the 22 scene programs that load assets (``portrayer_tpu_torch.scenes``)
   on seeded stand-in assets (``tests/_torch_assets.py``: icospheres for
   the meshes, small images for the PNG and JPEG files) in a temporary
   folder named by PORTRAYER_ASSETS, each through
   ``portrayer_tpu_torch.run_all_examples.render_all`` at its published
   size, 2 spp, accel="cuda" (the captured chunk program): per scene the
   first render's seconds and Mrays/s, graphs, bodies, loops and replays, host
   syncs (0), sweep launches per mode, dropped_w, its linear image
   finite, and the kernel against
   its plain version under phase 2's gates on the first chunk of camera
   rays, the middle tile's chunk and their shadow rays (0 rays apart);
8. the sweep kernel alone on the device (torch.profiler) at each launch
   shape of phase 2, the conditional and step kernels alone in replays
   of phase 2's graphs, the threefry kernel at phase 2's lane counts,
   and the kernels of the exempt fit's backward against
   remat_min_lanes 0 (phase 5); last, so that the profiler cannot
   weigh on the wall times of phases 4 to 7.  That count is printed, and
   held to its bound in a process of its own that main runs before
   phase 2 (exempt_backward_alone): after phases 2 to 7 the profiler may
   see fewer of the kernels in the graph's conditional bodies.

The last two lines are a JSON object of per-kernel numbers (the sweep's
two modes, the conditional kernel, the loop's step kernel and the
threefry kernel) and the
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
# graphs.switch's conditional kernel, and the JAX package's lax.switch over
# a bounce round's slices that it replaces (port-internal control flow,
# not a TPU kernel): its check switches over COND_BRANCHES branches.
COND_SOURCE = "portrayer_tpu_torch/csrc/conditional.cu"
COND_REPLACES = "portrayer_tpu/ops/trace.py:431"
COND_BRANCHES = 4
COND_ITERS = 200
# graphs.loop's step kernel (the same source), and the JAX package's
# lax.scan over the tail of equal capacity that its WHILE node replaces:
# its check runs loops of 0 to LOOP_END iterations, ended by the live
# count or by the end, against the host loop; it is timed on LOOP_END.
LOOP_REPLACES = "portrayer_tpu/ops/trace.py:456"
LOOP_END = 9
# The threefry kernel (rng.py's draws on the card) and the JAX package's
# per-lane draws it takes the place of (jax.random, which XLA fuses; not a
# TPU kernel): each entry point against its plain version at the main
# path's shapes, THREEFRY_ITERS calls each: draw_lanes at the bounce
# rounds' smallest and largest slices, uniform at a chunk's jitter of
# JITTER_RAYS rays, fold_in at render._fold_keys' three broadcasts over a
# frame of FOLD_ROWS rows and FOLD_ROUNDS rounds (glossy-reflection's); the
# captured glossy chunk whose draws it counts is GLOSSY_TILE at THREEFRY_SPP.
THREEFRY_SOURCE = "portrayer_tpu_torch/csrc/threefry.cu"
THREEFRY_REPLACES = "portrayer_tpu/ops/shade.py:38"
THREEFRY_LANES = (8192, 131072)
JITTER_RAYS = 131072
FOLD_ROWS = 416
FOLD_ROUNDS = 11
THREEFRY_ITERS = 20
GLOSSY_TILE = ((384, 128), (511, 255))
THREEFRY_SPP = 8
# The round kernels (csrc/round.cu), not a TPU kernel: the lane work of a
# round, which the JAX package leaves to XLA.  Timed on the round-1 queue
# of one chunk (ROUND_TILE x ROUND_TILE pixels x ROUND_SPP spp) of each
# scene at the tile origin given, on each head slice of it, against the
# plain chain; held within ROUND_RTOL (float atomics, CUDA's pow, atan2
# and acos under other flags than PyTorch's kernels).
ROUND_SOURCE = "portrayer_tpu_torch/csrc/round.cu"
ROUND_REPLACES = "none: the lane work of portrayer_tpu/ops/trace.py's rounds, fused by XLA"
ROUND_CASES = (("glossy-reflection", (384, 128)), ("water-glass", (384, 256)))
ROUND_TILE = 128
ROUND_SPP = 8
ROUND_ITERS = 20
ROUND_RTOL = 1e-5
FULL_FRAME_SPP = 16
# Main paths whose captured render (its tail one loop) is also held
# against the eager loop (every round unrolled) bit for bit, under
# deterministic algorithms.
DETERMINISTIC_PATHS = ("torus-showcase", "glossy-reflection")
# Main paths through the flat and the beam sweep, captured as the kernel's
# are (the beam's ordered walks WHILE nodes): (scene, frame size (None:
# its own), accel, the RenderConfig's other settings, spp).  Full frames;
# the spp of the beam legs is cut below FULL_FRAME_SPP (never the frame)
# so that the whole run stays near 600 s: the beam is plain torch ops,
# ~1.1 s a chunk on procedural-meshes' 73,729 pairs (~230 steps), and
# its eager loops read the host once a step.  glossy-reflection with
# beam_min_prims=0 takes the beam in all ten bounce rounds (a WHILE in an
# IF in a WHILE).
SWEEP_PATHS = (("big-scene", None, "beam", {}, 2),
               ("procedural-meshes", None, "beam", {}, 1),
               ("glossy-reflection", None, "beam", {"beam_min_prims": 0}, 8),
               ("glossy-reflection", (256, 256), "flat", {}, FULL_FRAME_SPP),
               ("torus-showcase", None, "flat", {}, FULL_FRAME_SPP))
# Sweep paths also held bit for bit against the eager loop under
# deterministic algorithms: (scene, accel).
DETERMINISTIC_SWEEP_PATHS = (("glossy-reflection", "beam"),)
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
# Fits through bounce rounds: (scene, frame size (None: its own), spp,
# the fields stepped); every DIFF_FIELDS table takes a gradient.
BOUNCE_FITS = (("glossy-reflection", None, 1, ("mat_diffuse", "mat_reflectivity")),
               ("glass-sphere", (256, 256), 4, ("mat_diffuse", "light_color")))
# The same glossy-reflection fit through the flat and the beam sweep
# (accel, the RenderConfig's other settings): every round's sweeps take
# the beam with beam_min_prims=0.
SWEEP_FITS = (("flat", {}), ("beam", {"beam_min_prims": 0}))
BOUNCE_FIT_KEY = 23
# remat_min_lanes above every round's lanes: bounce-round checkpointing off.
REMAT_OFF = 1 << 40
LAUNCH_RAYS = 131072
# Scenes whose tables phase 2 also packs with packing="morton" (the JAX
# package's other order), held and timed beside their SAH rows; phase 4
# renders procedural-meshes on Morton tables at MORTON_SPP, held against
# the same render on SAH tables under IMAGE_GATE.
MORTON_SCENES = ("big-scene", "procedural-meshes")
MORTON_SPP = 1
# tests/test_torch_render.py's image gate: at most this share of pixels
# beyond the first bound, none beyond the second.
IMAGE_GATE = (0.01, 1e-4, 2e-2)
# The fit with small rounds exempt from the replay: glossy-reflection's
# BOUNCE_FITS frame at remat_min_lanes EXEMPT_LANES; its slices of 30,720
# and 116,736 lanes keep their autograd temporaries, those of 465,920 are
# replayed.
EXEMPT_LANES = 116737
# shade_hits on big-scene's camera rays (its 3 lights): colours against
# its plain version (CPU tensors) within SHADE_HITS_TOL, the atol of
# tests/test_torch_shade.py's shading gate: the card and the CPU round
# powf and sqrtf apart by an ulp, and big-scene's specular term is
# x^100, which makes that 2.15e-6 (an H100, 700 W).
SHADE_HITS_RAYS = 131072
SHADE_HITS_TOL = 1e-5
# Timed launches of the plain version per turn (it loops over the chunks in
# Python: 577 of them on procedural-meshes).
PLAIN_ITERS = 3
TORUS_TOL = 1e-3  # the JAX package's torus gate (tests/test_torus.py)
# A captured render against the eager chunk loop: the same ops on the same
# inputs, but index_add's float atomics sum in another order.
CAPTURED_TOL = 1e-6
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
# 32-bit integer operations a second: 132 SMs x 64 INT32 lanes x 1.98 GHz.
PEAK_INT32 = 132 * 64 * 1.98e9
# A threefry2x32 hash (csrc/threefry.cu) in the card's instructions: 5
# rounds of 4 x (add, funnel shift, xor) and 2 key adds (x2's key word and
# round constant join in one IADD3), 2 adds before them, and k1 ^ k2 ^ C
# in one LOP3.
HASH_OPS = 73
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


def _bounce_rays(o, d, st, cfg, rounds=1):
    """The live child rays of real rounds 0 .. rounds-1 of the trace loop
    on camera rays o, d: for each round, its children (o, d, t_min,
    src_node, src_tri), the next round's queue."""
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
    out = []
    for _ in range(rounds):
        hit = tr._nearest(q, st, cfg)
        acc, child, _ = tr._round_shade(q, hit, bg, bg, st, cfg, rng.PRNGKey(3), is_last=False)
        q, _, _, n = tr._compact(child, child.w.shape[0], acc, bg)
        n = int(n)  # the live head of the fixed-capacity queue
        q = tr._Queue(*(x[:n] for x in q))
        out.append((q.o, q.d, q.t_min, q.src_node, q.src_tri))
    return out


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


def _device_ms(fn, iters, kernel="sweep_kernel"):
    """Device time per run of the kernel `kernel` (a part of its name) that
    `fn` launches: the mean of its kernel events under torch.profiler over
    `iters` calls (the other kernels and the host time left out; a mean
    over the events recorded, as the profiler may drop some); None where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
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
        if "sweep_kernel" in name:
            # Mangled sweep_kernel<ANY_HIT, HAS_TORUS>: ...ILb<0|1>ELb<0|1>EE...
            flags = name[name.index("sweep_kernel") + len("sweep_kernel"):][:12]
            mode = "any_hit" if flags.startswith("ILb1") else "nearest"
            torus = "with torus" if "ELb1E" in flags else "no torus"
            name = f"sweep_kernel {mode}, {torus}"
        print(f"[1 ptxas] {name}: {regs} registers, spill stores {st_bytes} B, spill loads "
              f"{ld_bytes} B", flush=True)
    return smi


def _inline(name):
    """An inline scene of ``tests/_torch_jax.py`` at full size as a
    SceneSpec: procedural-meshes (73,729 triangle pairs in 577 tri_w
    chunks), normal-mapping-numpy (1024x1024 and 1024x768 textures and
    normal maps), soft-shadows-icosphere (two 5,120-triangle icospheres,
    an area light) or glass-sphere (a refractive sphere, 64x64)."""
    import portrayer_tpu_torch as T
    from portrayer_tpu_torch import scenes
    import _torch_jax  # tests/ is on sys.path (main)

    build = {"procedural-meshes": _torch_jax.procedural_meshes,
             "normal-mapping-numpy": _torch_jax.normal_mapping_numpy,
             "soft-shadows-icosphere": _torch_jax.soft_shadows_icosphere,
             "glass-sphere": _torch_jax.glass_sphere}[name]
    scene, cam, size = build(T)
    return scenes.SceneSpec(scene=scene, camera=cam, size=size,
                            background=scenes.sky_background, name=name)


# Scenes whose launches phase 2 times (ellipsoids: the sphere_g branch,
# which no main path has).  The glass sphere is held, not timed.
TIMED = ("big-scene", "torus-showcase", "glossy-reflection", "procedural-meshes",
         "single-triangle", "ellipsoids")


def _scene_cases():
    """(name, camera rays, scene, camera settings, size); the inline scenes
    come from ``tests/_torch_jax.py``."""
    import portrayer_tpu_torch as T
    from portrayer_tpu_torch import scenes
    from _torch_jax import ellipsoids, glass_sphere

    cases = []
    # The timed scenes draw at least LAUNCH_RAYS camera rays.  Each case:
    # (name, rays, scene, camera settings, size, packing).
    for name, n_rays in (("big-scene", 262144), ("simple", 65536), ("torus-showcase", 131072),
                         ("glossy-reflection", 131072), ("primitives-simple", 65536),
                         ("single-triangle", 131072), ("four-shapes", 131072)):
        spec = scenes.load(name)
        cases.append((name, n_rays, spec.scene, spec.camera, spec.size))
    cases.append(("ellipsoids", 131072) + ellipsoids(T))
    cases.append(("glass-sphere", 131072) + glass_sphere(T))
    for name in ("procedural-meshes", "normal-mapping-numpy", "soft-shadows-icosphere"):
        spec = _inline(name)
        cases.append((name, 131072, spec.scene, spec.camera, spec.size))
    cases = [case + ("sah",) for case in cases]
    # The same rays on Morton tables.
    return cases + [case[:5] + ("morton",) for case in cases if case[0] in MORTON_SCENES]


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

    for base, n_rays, scene, camset, size, packing in _scene_cases():
        name = base if packing == "sah" else f"{base} ({packing})"
        before = dict(diffs)
        w, h = size
        st = flatten_scene(scene, dev, packing=packing)
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
            for r, (bo, bd, bt, bn, btri) in enumerate(
                    _bounce_rays(o, d, st, cfg, rounds=2 if st.any_refractive else 1)):
                bhit = check(f"{name} round-{r} children", bo, bd, bt, st,
                             {"src_node": bn, "src_tri": btri}, torus)
                so, sd, st_min, sact, snode, stri = _shadow_rays(bo, bd, bhit, st, cfg, bt, bn,
                                                                 btri)
                check(f"{name} round-{r} children's shadow", so, sd, st_min, st,
                      dict(active=sact, src_node=snode, src_tri=stri), torus)
                line += (f"; {bo.shape[0]} round-{r} child rays, {bhit.hit.float().mean():.3f} "
                         f"hit, {int(sact.sum())} of their shadow rays")
        print(line + "; kernel and plain version agree", flush=True)
        if packing != "sah" and diffs != before:
            raise AssertionError(f"{name}: kernel and plain version apart on Morton tables: "
                                 f"{diffs} rays differing (before {before})")

        if base in TIMED:
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
            if packing != "sah" and diffs != before:
                raise AssertionError(f"{name}: kernel and plain version apart on Morton "
                                     f"tables in render order: {diffs} (before {before})")
            sets = {"uniform": _launch_shapes(o, d, near, st, cfg),
                    "render order": _launch_shapes(ro, rd, rnear, st, cfg)}
            timing[name] = _time_launches(name, sets, st, cfg)
            timing[name]["launch_sets"] = (sets, st)
    return err, diffs, timing, sorted(branches)


def phase_conditional(dev):
    """graphs.switch's conditional kernel (csrc/conditional.cu) against its
    plain version, the host pick: a step that clears `out` and switches
    over COND_BRANCHES branches (the first dead, branch i writes i),
    captured as one graph and replayed for every sel from 0 to
    COND_BRANCHES - 1, against the same step op by op (one host read of
    sel, then the branch) on the same sel; then the time of a replay and
    of an op-by-op step, each a mean over COND_ITERS with the card
    synchronised at the end.  Returns the kernel's line fields, and the
    replay whose kernel runs phase 8 times (_graph_kernel_ms)."""
    import functools
    import torch
    from portrayer_tpu_torch import graphs

    out = torch.zeros((), dtype=torch.int64, device=dev)
    sel = torch.zeros((), dtype=torch.int64, device=dev)
    branches = [None] + [functools.partial(out.fill_, i) for i in range(1, COND_BRANCHES)]

    def step():
        out.fill_(-1)
        graphs.switch(sel, branches)

    g = graphs.Graph(step, torch.cuda.graph_pool_handle())
    err = 0
    for i in range(COND_BRANCHES):
        sel.fill_(i)
        g.replay()
        captured = int(out)
        step()
        err = max(err, abs(captured - int(out)))
        if captured != (i or -1):
            raise AssertionError(f"conditional: sel {i} ran the branch that writes {captured}")

    def mean_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COND_ITERS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / COND_ITERS * 1e3

    replay_ms, plain_ms = mean_ms(g.replay), mean_ms(step)
    # It reads sel and its count, and writes the count: 24 bytes.
    bound_ms = 24 / PEAK_BYTES * 1e3
    print(f"[2 conditional] graphs.switch over {COND_BRANCHES} branches ({g.bodies} bodies): "
          f"captured against the host pick for every sel, largest difference {err}; a replay "
          f"{replay_ms:.4f} ms, the op-by-op step {plain_ms:.4f} ms (means of {COND_ITERS}); "
          f"bound {bound_ms:.3g} ms (bytes)", flush=True)
    return {"max_abs_err": err, "replay_ms": replay_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}, g.replay


def phase_loop(dev):
    """graphs.loop's step kernel (csrc/conditional.cu) against its plain
    version, the host loop: a step whose loop body adds one to out[index]
    and clears `live` at index `stop` - 1, captured as one graph (a WHILE
    node) and replayed for loops of 0, 1, a few and LOOP_END iterations,
    against the same step op by op (one host read of the condition an
    iteration, then the body and index += 1) on the same inputs; then the
    time of a replay and of an op-by-op step that run LOOP_END iterations,
    each a mean over COND_ITERS with the card synchronised at the end, over
    the step kernel's runs (LOOP_END + 1 a step).  Returns the kernel's
    line fields, and the replay whose kernel runs phase 8 times
    (_graph_kernel_ms)."""
    import torch
    from portrayer_tpu_torch import graphs
    from portrayer_tpu_torch.ops import cuda_intersect

    i64 = dict(dtype=torch.int64, device=dev)
    index, live, stop = (torch.zeros((), **i64) for _ in range(3))
    out = torch.zeros(LOOP_END, **i64)
    one = torch.ones(1, **i64)

    def body():
        out.index_add_(0, index.reshape(1), one)
        live.copy_((index + 1 < stop).to(torch.int64))

    def step():
        out.zero_()
        index.zero_()
        live.copy_((stop > 0).to(torch.int64))
        return graphs.loop(index, LOOP_END, live, body)

    g = graphs.Graph(step, torch.cuda.graph_pool_handle())
    err = 0
    for n in (0, 1, 3, LOOP_END, LOOP_END + 5):
        stop.fill_(n)
        cuda_intersect.reset_counts()
        g.replay()
        runs = cuda_intersect.counts()["graph_while"]
        captured, captured_index = out.clone(), int(index)
        reads = step()
        iterations = min(n, LOOP_END)
        err = max(err, int((captured - out).abs().max()), abs(captured_index - int(index)))
        if (captured.sum() != iterations or captured_index != iterations
                or runs != iterations + 1 or reads != iterations + 1):
            raise AssertionError(f"loop: stop {n} ran {int(captured.sum())} iterations to "
                                 f"index {captured_index}, the step kernel {runs} times "
                                 f"(host loop: {reads} reads)")

    def mean_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COND_ITERS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / COND_ITERS * 1e3 / (LOOP_END + 1)

    stop.fill_(LOOP_END)
    replay_ms, plain_ms = mean_ms(g.replay), mean_ms(step)
    # A run reads index, live and its count and writes index and its
    # count: 40 bytes.
    bound_ms = 40 / PEAK_BYTES * 1e3
    print(f"[2 loop] graphs.loop ({g.loops} loop, a body of three small kernels): captured "
          f"against the host loop for 0, 1, 3, {LOOP_END} and {LOOP_END} (cut by the end) "
          f"iterations, largest difference {err}; a replay's wall over its step kernel runs "
          f"{replay_ms:.4f} ms (the body's kernels and the node's own cost in it), the op-by-op "
          f"iteration {plain_ms:.4f} ms (means over {COND_ITERS} steps of {LOOP_END} "
          f"iterations and {LOOP_END + 1} runs); bound {bound_ms:.3g} ms (bytes)", flush=True)
    return {"max_abs_err": err, "replay_ms": replay_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}, g.replay


def _threefry_bound_ms(hashes, ops, nbytes):
    """Least time of a threefry launch: the larger of its 32-bit integer
    operations (`hashes` hashes of HASH_OPS each, and `ops` more) over
    PEAK_INT32 and its `nbytes` over PEAK_BYTES.  Returns (ms, "operations"
    or "bytes")."""
    t_ops = (hashes * HASH_OPS + ops) / PEAK_INT32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def phase_threefry(dev):
    """The threefry kernel (csrc/threefry.cu) against its plain version, at
    the shapes the main path gives each entry point, under keys on the
    card, bit for bit, and both their times (CUDA events over
    THREEFRY_ITERS calls) beside the bound:
    - rng.draw_lanes (shade.py's glossy draw, site 2000, two draws a lane)
      on THREEFRY_LANES lanes of sample ids up to 2^27;
    - rng.uniform, a chunk's jitter (render._tile_rays): [JITTER_RAYS, 2];
    - rng.fold_in at render._fold_keys' broadcasts over a [FOLD_ROWS, 4]
      int64 row table: a key [2] by a row column (strided), keys
      [FOLD_ROWS, 2] by a row column, and keys [FOLD_ROWS, 1, 2] by rounds
      [1, FOLD_ROUNDS];
    then glossy-reflection's GLOSSY_TILE at THREEFRY_SPP spp (one chunk of
    131,072 rays) rendered captured, and again from its cached graph,
    whose replay's draws rng.counts() reads on the device: launches per
    entry point, and 0 plain calls on CUDA tensors.  Returns the kernel's
    line fields and, per call, the kernel and the call that phase 8
    times."""
    import functools
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render_linear, rng, scenes

    g = torch.Generator(device=dev).manual_seed(18)
    words = lambda *shape: torch.randint(0, 2**32, shape, dtype=torch.int64, device=dev,
                                         generator=g)
    key = words(2)
    cases = []
    for lanes in THREEFRY_LANES:
        sid = torch.randint(0, 2**27 + 1, (lanes,), dtype=torch.int32, device=dev, generator=g)
        cases.append((f"draw_lanes on {lanes} lanes, 2 draws a lane", "draw_lanes",
                      functools.partial(rng.draw_lanes, key, 2000, sid, 2),
                      functools.partial(rng.draw_lanes_plain, key, 2000, sid, 2),
                      (lanes * 3 + 1, lanes * 2 * 3, _bytes(key, sid) + lanes * 2 * 4)))
    n = JITTER_RAYS * 2
    cases.append((f"uniform ({JITTER_RAYS}, 2), a chunk's jitter", "uniform",
                   functools.partial(rng.uniform, key, (JITTER_RAYS, 2), dev),
                   functools.partial(rng.uniform_plain, key, (JITTER_RAYS, 2), dev),
                   (n, n * 3, _bytes(key) + n * 4)))
    rows = torch.randint(0, 2**31, (FOLD_ROWS, 4), dtype=torch.int64, device=dev, generator=g)
    keys = words(FOLD_ROWS, 2)
    rounds = torch.arange(FOLD_ROUNDS, device=dev)
    for label, k, data in (
            (f"fold_in key [2] by rows[:, 0] [{FOLD_ROWS}]", key, rows[:, 0]),
            (f"fold_in keys [{FOLD_ROWS}, 2] by rows[:, 1]", keys, rows[:, 1]),
            (f"fold_in keys [{FOLD_ROWS}, 1, 2] by rounds [1, {FOLD_ROUNDS}]",
             keys[:, None, :], rounds[None, :])):
        out = rng.fold_in_plain(k, data).shape[:-1].numel()
        cases.append((label, "fold_in", functools.partial(rng.fold_in, k, data),
                      functools.partial(rng.fold_in_plain, k, data),
                      (out, 0, _bytes(k, data) + out * 16)))

    fields, calls = {"by_call": {}}, {}
    for label, entry, kernel, plain, (hashes, ops, nbytes) in cases:
        got, want = kernel(), plain()
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        apart = int((got != want).sum()) if got.shape == want.shape else got.numel()
        ms, plain_ms = _time_ms(kernel, THREEFRY_ITERS), _time_ms(plain, THREEFRY_ITERS)
        bound, by = _threefry_bound_ms(hashes, ops, nbytes)
        print(f"[2 threefry] {label}: {apart} words apart from the plain version; a call "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events over {THREEFRY_ITERS}); "
              f"bound {bound:.3g} ms ({by}: {hashes} hashes, {nbytes} bytes)", flush=True)
        if apart:
            raise AssertionError(f"threefry: {label}, {apart} words apart")
        fields["by_call"][label] = {"entry": entry, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound, "bound_by": by, "words_apart": apart}
        calls[label] = (f"{entry}_kernel", kernel)

    spec = scenes.load("glossy-reflection")
    st = flatten_scene(spec.scene, dev)
    cfg = RenderConfig(device=dev, samples=THREEFRY_SPP, max_rays_per_launch=131072,
                       queue_caps=spec.queue_caps)
    args = (st, spec.camera, spec.size, spec.background, cfg)
    render_linear(*args, region=GLOSSY_TILE)
    rng.reset_counts()
    stats = []
    render_linear(*args, region=GLOSSY_TILE, stats=stats)
    counts = rng.counts()
    (prog,) = st.chunk_programs.values()
    rounds = sum(int(k > 0) for k in stats[0].lanes.tolist()[1:])
    print(f"[2 threefry] glossy-reflection's tile {GLOSSY_TILE} x {THREEFRY_SPP} spp from its "
          f"cached graph ({len(stats)} chunk, {prog.graphs['chunk'].replays} replays in all, "
          f"{rounds} bounce rounds ran): threefry launches "
          f"{', '.join(f'{k} {counts[k]}' for k in rng.KERNELS)}; plain calls on CUDA "
          f"tensors {counts['plain_on_cuda']}", flush=True)
    if counts["plain_on_cuda"] or counts["uniform"] != len(stats):
        raise AssertionError(f"threefry: a captured glossy chunk drew {counts}")
    fields["glossy_chunk_launches"] = {k: counts[k] for k in rng.KERNELS}
    return fields, calls


def _round_bytes(st, R, cap):
    """Bytes a bounce round's two kernels need on R lanes of a queue whose
    children go to a queue of `cap` lanes, each read or written once
    (csrc/round.cu's note): shade_round reads the queue (48 B a lane), the
    hits (12 B), the node and triangle tables and a texel of each atlas a
    lane, and writes L shadow rays (37 B), lc (12 B a light), two children
    (48 B each), their take flags and acc's terms (read and written,
    12 B); resolve_round reads the occlusion (4 B), lc, the children and
    their prefix (4 B), and writes the next queue (48 B a slot) and acc."""
    L = st.n_lights
    tables = st.rec.numel() * 4 + (st.trec.numel() * 4 if st.any_reflective else 0)
    texels = R * 3 * (int(st.any_image_tex) + int(st.any_normal_map))
    shade = R * (48 + 12 + 24) + tables + texels + L * R * (37 + 12) + 2 * R * (48 + 4)
    resolve = L * R * (4 + 12) + 2 * R * (48 + 4) + cap * 48 + R * 24
    return shade, resolve


def phase_round(dev):
    """The round kernels (csrc/round.cu through ops/cuda_round.py) at the
    main path's shapes: a real round-1 queue of ROUND_TILE's chunk (128 x
    128 pixels x ROUND_SPP spp, 131,072 primary lanes) of each scene of
    ROUND_CASES, a bounce round on each head slice of it through the
    kernels and through the plain chain (ops/trace.py's, routed by
    cuda_round.takes_kernels), held against each other (the next queue's
    integer fields and live count equal, its floats and acc within
    ROUND_RTOL of 1 + |value|), and a whole round's time on each route
    (CUDA events over ROUND_ITERS rounds, both sweeps included) beside the
    two kernels' bound (_round_bytes over PEAK_BYTES).  Returns the line
    fields and, per case, the kernel round and the plain round whose
    kernels' device times and launches phase 8 reads."""
    import os
    import tempfile
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops import cuda_round, trace as tr
    from portrayer_tpu_torch.render import _tile_rays
    from _torch_assets import write_standins

    fields, calls = {"by_case": {}}, {}
    old = os.environ.get("PORTRAYER_ASSETS")
    tmp = tempfile.mkdtemp()
    write_standins(tmp, seed=STANDIN_SEED)
    os.environ["PORTRAYER_ASSETS"] = tmp
    try:
        for name, (x0, y0) in ROUND_CASES:
            spec = scenes.load(name)
            st = flatten_scene(spec.scene, dev)
            # The benchmark's queues: RenderConfig's default caps (4x with
            # a refractive material, else 1x).
            cfg = RenderConfig(device=dev, samples=ROUND_SPP)
            key = rng.PRNGKey(21)
            o, d, pix, bg, w0 = _tile_rays(
                key, Camera(spec.camera, spec.size, dev), x0, y0, 0, cfg=cfg,
                background=spec.background, tile_h=ROUND_TILE, tile_w=ROUND_TILE,
                spp=ROUND_SPP, samples=ROUND_SPP)
            P = ROUND_TILE * ROUND_TILE
            pl = tr.plan(P * ROUND_SPP, st, cfg)
            acc, q, _, n_live = tr.first_round(rng.fold_in(key, 0), tr.primary_queue(
                o, d, pix, w0, cfg), bg, P, st, cfg, pl, ROUND_SPP)
            for k in tr.slice_sizes(pl.cap[1], cfg.queue_slice_divs):
                label = f"{name}, round 1 on {k} lanes of {pl.cap[1]}"
                rk = rng.fold_in(key, 1)
                kern = lambda k=k: tr.bounce_round(rk, q, acc.clone(), bg, st, cfg, k,
                                                   pl.cap[2], False)

                def plain(k=k, real=cuda_round.takes_kernels):
                    cuda_round.takes_kernels = lambda *a, **kw: False
                    try:
                        return tr.bounce_round(rk, q, acc.clone(), bg, st, cfg, k, pl.cap[2],
                                               False)
                    finally:
                        cuda_round.takes_kernels = real

                got, ref = kern(), plain()
                apart = _round_apart(got, ref)
                ms, plain_ms = _time_ms(kern, ROUND_ITERS), _time_ms(plain, ROUND_ITERS)
                shade_b, resolve_b = _round_bytes(st, k, pl.cap[2])
                shade_bound = shade_b / PEAK_BYTES * 1e3
                resolve_bound = resolve_b / PEAK_BYTES * 1e3
                print(f"[2 round] {label}: live {int(n_live)} entering, {int(ref[3])} "
                      f"children kept; {apart}; a round {ms:.4f} ms through the kernels, "
                      f"{plain_ms:.4f} ms through the plain chain (CUDA events over "
                      f"{ROUND_ITERS}, both sweeps in each); bound shade_round "
                      f"{shade_bound:.5f} ms, resolve_round {resolve_bound:.5f} ms (bytes: "
                      f"{shade_b}, {resolve_b})", flush=True)
                fields["by_case"][label] = {
                    "lanes": k, "ms": ms, "plain_ms": plain_ms, "apart": apart,
                    "shade_bound_ms": shade_bound, "resolve_bound_ms": resolve_bound,
                    "bound_by": "bytes"}
                calls[label] = (kern, plain)
    finally:
        if old is None:
            os.environ.pop("PORTRAYER_ASSETS", None)
        else:
            os.environ["PORTRAYER_ASSETS"] = old
    return fields, calls


def _round_apart(got, ref):
    """(acc, queue, dropped, n_live) of a bounce round through the kernels
    against the plain chain's: raises where an integer field or the live
    count differs or a float is further than ROUND_RTOL of 1 + |value|;
    returns the largest float gap, as text."""
    if int(got[3]) != int(ref[3]):
        raise AssertionError(f"round kernels: live {int(got[3])} against {int(ref[3])}")
    worst = {}
    pairs = [("acc", got[0], ref[0])] + [(f, getattr(got[1], f), getattr(ref[1], f))
                                         for f in got[1]._fields]
    for f, a, b in pairs:
        if a.dtype == b.dtype and not a.is_floating_point():
            if not bool((a == b).all()):
                raise AssertionError(f"round kernels: {f} differs")
            continue
        a, b = a.double(), b.double()
        fin = b.isfinite()
        gap = ((a - b).abs()[fin] / (1.0 + b.abs()[fin])).max() if fin.any() else a.new_zeros(())
        worst[f] = float(gap)
        if worst[f] > ROUND_RTOL or not bool((a.isfinite() == fin).all()):
            raise AssertionError(f"round kernels: {f} apart by {worst[f]}")
    return "integer fields equal, floats within " + ", ".join(
        f"{f} {v:.2g}" for f, v in worst.items())


def _round_device_times(fields, calls):
    """Phase 8's part for the round kernels: each case's shade_round and
    resolve_round device times (_device_ms) and the device launches of one
    round on each route (_launches)."""
    for label, (kern, plain) in calls.items():
        f = fields["by_case"][label]
        f["shade_device_ms"] = _device_ms(kern, ROUND_ITERS, "shade_round_kernel")
        f["resolve_device_ms"] = _device_ms(kern, ROUND_ITERS, "resolve_round_kernel")
        f["launches"], f["plain_launches"] = _launches(kern), _launches(plain)
        print(f"[8 device] round {label}: shade_round {_fmt(f['shade_device_ms'])}, "
              f"resolve_round {_fmt(f['resolve_device_ms'])} on the device; a round launches "
              f"{f['launches']} kernels through them, {f['plain_launches']} through the plain "
              f"chain", flush=True)


def _launches(fn):
    """The kernels (and memsets and copies) one call of fn runs on the
    device, from a torch.profiler trace; None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def _graph_kernel_ms(fields, replay, kernel, label):
    """Set fields["ms"] to the device time of one run of the graph kernel
    `kernel` (conditional.cu) in `replay`'s graph (_device_ms, its own
    kernel events alone), and fields["ms_from"] to how it was taken: where
    the profiler records none, the replay's wall per run of the kernel
    (fields["replay_ms"], the graph's other work in it) stands in."""
    ms = _device_ms(replay, COND_ITERS, kernel)
    fields["ms"] = ms if ms is not None else fields["replay_ms"]
    fields["ms_from"] = ("device time (torch.profiler)" if ms is not None
                         else "replay wall per run (no device time recorded)")
    print(f"[8 device] {label}: {kernel} {_fmt(ms)} a run on the device; ms from "
          f"{fields['ms_from']}", flush=True)


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
                print(f"[8 device] {name} {mode}, {order}: sweep kernel {_fmt(ms)} on the "
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


def _main_path(dev, spec, path_counts, accel="cuda", spp=FULL_FRAME_SPP, size=None,
               extra=None, packing="sah"):
    """One main path: `spec` (a SceneSpec or a registry name) at its size
    (or `size`) and `spp` through Image.render on its tables, which
    captures the chunk program as one CUDA graph (its bounce rounds'
    slices conditional bodies, with accel="beam" its ordered sweeps WHILE
    nodes) and replays it, with the counts of that run alone; beside it,
    in this call, the same render again (the graph cached) and the eager
    chunk loop (cuda_graphs=False).  Captured chunks read nothing on the
    host; the cached render sweeps as often as the eager loop (kernel
    launches, flat and beam sweeps, beam steps), the first as often plus
    its warm-up; the captured linear image is held against the eager one
    within CAPTURED_TOL, and with accel "flat" or "beam" the u8 frames
    are 0 pixels apart.  `extra`: the RenderConfig's other settings;
    `packing`: the packed table's order (flatten_scene)."""
    import dataclasses
    import numpy as np
    import torch
    from portrayer_tpu_torch import Image, RenderConfig, flatten_scene, render_linear, scenes
    from portrayer_tpu_torch.image_io import read_png
    from portrayer_tpu_torch.ops import cuda_intersect

    if isinstance(spec, str):
        spec = scenes.load(spec)
    if size is not None:
        spec = dataclasses.replace(spec, size=tuple(size))
    extra = extra or {}
    name = spec.name
    label = name if accel == "cuda" else f"{name} {accel}" + "".join(
        f" {k}={v}" for k, v in extra.items())
    if packing != "sah":
        label += f" packing={packing}"
    w, h = spec.size
    cfg = RenderConfig(device=dev, samples=spp, max_rays_per_launch=LAUNCH_RAYS,
                       queue_caps=spec.queue_caps, accel=accel, **extra)
    eager = dataclasses.replace(cfg, cuda_graphs=False)
    t0 = time.perf_counter()
    st = flatten_scene(spec.scene, dev, packing=packing)
    flatten_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{label.replace(' ', '_')}.png")
    img = Image(None, w, h)
    stats = []
    args = (st, spec.camera, spec.background)
    _, secs, counts, peak = _timed(dev, lambda: img.render(*args, cfg, stats=stats))
    reserved = torch.cuda.max_memory_reserved(dev) / 2**30
    path_counts[label] = counts
    (prog,) = st.chunk_programs.values()
    graphs = prog.graphs
    replays = sum(g.replays for g in graphs.values())
    bodies = sum(g.bodies for g in graphs.values())
    loops = sum(g.loops for g in graphs.values())
    img.save_as(path)
    if not np.array_equal(read_png(path), img.buffer):
        raise AssertionError(f"{label}: saved PNG does not decode to the rendered bytes")
    if img.buffer.shape != (h, w, 3) or img.buffer.max() == 0:
        raise AssertionError(f"{label}: frame is empty or misshapen")
    if accel == "cuda" and (counts["nearest"] == 0 or counts["any_hit"] == 0):
        raise AssertionError(f"{label}: main path did not launch both kernel modes: {counts}")
    if accel != "cuda" and (counts["nearest"] or counts["any_hit"] or not counts[
            {"flat": "flat_sweep", "beam": "beam_step"}[accel]]):
        raise AssertionError(f"{label}: main path did not run through the {accel} sweep "
                             f"alone: {counts}")
    if counts["plain_on_cuda"] != 0:
        raise AssertionError(f"{label}: plain version ran on CUDA tensors: {counts}")
    _check_draws(label, counts, st)
    _check_rounds(label, counts, st)
    chunks = len(stats)  # every chunk traces the same number of rays
    if list(graphs) != ["chunk"] or graphs["chunk"].replays != chunks:
        raise AssertionError(f"{label}: graphs {list(graphs)}, {replays} replays for {chunks} "
                             f"chunks (one graph, one replay a chunk)")
    live = sum(s.live for s in stats).tolist()
    rounds = sum(n > 0 for s in stats for n in s.live.tolist())
    syncs = sum(s.syncs for s in stats)
    if syncs != 0:
        raise AssertionError(f"{label}: {syncs} host syncs over {chunks} captured chunks")
    dropped_w = sum(s.dropped_w for s in stats) / chunks
    if dropped_w > 1e-3:
        raise AssertionError(f"{label}: queue overflow dropped {dropped_w:.4%} of the "
                             f"throughput")
    again = Image(None, w, h)
    _, again_secs, again_counts, _ = _timed(dev, lambda: again.render(*args, cfg))
    eager_img, eager_stats = Image(None, w, h), []
    _, eager_secs, eager_counts, eager_peak = _timed(
        dev, lambda: eager_img.render(*args, eager, stats=eager_stats))
    eager_reserved = torch.cuda.max_memory_reserved(dev) / 2**30
    eager_syncs = sum(s.syncs for s in eager_stats)
    for mode in cuda_intersect.SWEEP_MODES:
        if (again_counts[mode] != eager_counts[mode]
                or counts[mode] != eager_counts[mode] + prog.warm_launches[mode]):
            raise AssertionError(
                f"{label}: {mode} captured {counts[mode]} (its warm-up "
                f"{prog.warm_launches[mode]}), cached {again_counts[mode]}, eager "
                f"{eager_counts[mode]}")
    if [s.live.tolist() for s in eager_stats] != [s.live.tolist() for s in stats]:
        raise AssertionError(f"{label}: live rays per round differ from the eager loop's")
    lin = render_linear(st, spec.camera, (w, h), spec.background, cfg)
    lin_eager = render_linear(st, spec.camera, (w, h), spec.background, eager)
    diff = float(np.abs(lin - lin_eager).max())
    u8_off = int((img.buffer != eager_img.buffer).any(axis=-1).sum())
    if not diff <= CAPTURED_TOL:
        raise AssertionError(f"{label}: captured render differs from the eager chunk loop by "
                             f"{diff:.3g} (limit {CAPTURED_TOL})")
    if accel != "cuda" and u8_off:
        raise AssertionError(f"{label}: captured u8 frame {u8_off} pixels apart from the "
                             f"eager loop's")
    rays = w * h * spp
    sweeps = (f"launches nearest {counts['nearest']} any-hit {counts['any_hit']} (the warm-up's "
              f"{prog.warm_launches['nearest']} and {prog.warm_launches['any_hit']} among them; "
              f"cached {again_counts['nearest']} and {again_counts['any_hit']}, "
              f"{again_counts['nearest'] / chunks:.2f} and {again_counts['any_hit'] / chunks:.2f} "
              f"per chunk; eager {eager_counts['nearest']} and {eager_counts['any_hit']})")
    if accel != "cuda":
        sweeps = (f"flat sweeps {counts['flat_sweep']}, beam sweeps {counts['beam_sweep']} and "
                  f"beam steps {counts['beam_step']} counted on the device (the warm-up's "
                  f"{prog.warm_launches['flat_sweep']}, {prog.warm_launches['beam_sweep']} and "
                  f"{prog.warm_launches['beam_step']} among them; cached "
                  f"{again_counts['flat_sweep']}, {again_counts['beam_sweep']} and "
                  f"{again_counts['beam_step']}, {again_counts['beam_step'] / chunks:.2f} beam "
                  f"steps per chunk; eager {eager_counts['flat_sweep']}, "
                  f"{eager_counts['beam_sweep']} and {eager_counts['beam_step']}), no kernel "
                  f"launch")
    print(f"[4 main path] {label} {w}x{h} x {spp} spp, accel {accel!r}, tile {cfg.tile}, "
          f"{LAUNCH_RAYS} rays/launch: captured {secs:.3f} s ({rays / secs / 1e6:.3f} Mrays/s "
          f"primary; capture {prog.capture_s:.3f} s, flatten {flatten_s:.3f} s before it), "
          f"again with the graphs cached {again_secs:.3f} s ({rays / again_secs / 1e6:.3f} "
          f"Mrays/s), eager chunk loop {eager_secs:.3f} s ({rays / eager_secs / 1e6:.3f} "
          f"Mrays/s); peak memory {peak:.3f} GiB captured, {eager_peak:.3f} eager (reserved "
          f"{reserved:.3f} and {eager_reserved:.3f}); {chunks} "
          f"chunks, {len(graphs)} graph, {bodies} conditional bodies, {loops} loops, {replays} "
          f"replays; {sweeps}, "
          f"conditional kernel {again_counts['graph_if']} cached, loop step kernel "
          f"{again_counts['graph_while']}, plain on CUDA "
          f"{counts['plain_on_cuda']}; rounds {rounds}, host syncs captured {syncs} "
          f"({syncs / chunks:.2f} per chunk), eager {eager_syncs} ({eager_syncs / chunks:.2f} "
          f"per chunk); live rays per round {live}; dropped_w "
          f"{dropped_w:.3g}; linear image against the eager loop's: max |diff| {diff:.3g}, "
          f"u8 pixels apart {u8_off}; PNG {os.path.relpath(path, ROOT)} round-trips",
          flush=True)
    return dict(spec=spec, cfg=cfg, bodies=bodies, loops=loops, label=label, lin=lin,
                syncs=syncs, chunks=chunks)


def _image_gate(got, ref):
    """(share of pixels beyond IMAGE_GATE[1], max |diff|), raising past
    IMAGE_GATE (tests/test_torch_render.py's assert_images_close)."""
    import numpy as np

    share, near, far = IMAGE_GATE
    diff = np.abs(got - ref).max(axis=-1)
    beyond, worst = float((diff > near).mean()), float(diff.max())
    if not (np.isfinite(got).all() and beyond < share and worst < far):
        raise AssertionError(f"image gate: {beyond:.4%} of pixels beyond {near}, max "
                             f"{worst:.3g} (limits {share:.0%} and {far})")
    return beyond, worst


def _morton_path(dev, spec, path_counts):
    """The main path `spec` through the captured render on Morton tables
    at MORTON_SPP (_main_path: 0 host syncs a chunk), its linear image held
    against the same render on SAH tables under IMAGE_GATE."""
    from portrayer_tpu_torch import flatten_scene, render_linear

    main = _main_path(dev, spec, path_counts, spp=MORTON_SPP, packing="morton")
    spec, cfg = main["spec"], main["cfg"]
    sah = render_linear(flatten_scene(spec.scene, dev), spec.camera, spec.size,
                        spec.background, cfg)
    beyond, worst = _image_gate(main["lin"], sah)
    print(f"[4 morton] {main['label']} {spec.size[0]}x{spec.size[1]} x {MORTON_SPP} spp: "
          f"against the render on SAH tables {beyond:.4%} of pixels beyond "
          f"{IMAGE_GATE[1]}, max |diff| {worst:.3g}; host syncs {main['syncs']} over "
          f"{main['chunks']} captured chunks", flush=True)


def _deterministic(fn):
    """fn() under torch.use_deterministic_algorithms (warn_only: index_copy_
    has no deterministic version on the card, and its targets here are
    distinct but for a trash slot), uninitialised memory left unfilled:
    index_add_ sums its rows in one order (a sort, not float atomics), so
    that two programs that run the same ops on the same inputs agree bit
    for bit."""
    import warnings
    import torch
    import torch.utils.deterministic

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _looped_against_eager(dev, main):
    """The main path `main` (_main_path's result) on fresh tables under
    _deterministic: the captured program (its tail one loop) against the
    eager chunk loop (every round unrolled, each pick read on the host),
    their linear images equal bit for bit (0 pixels apart), the same live
    rays per round and 0 host reads captured."""
    import dataclasses
    import numpy as np
    from portrayer_tpu_torch import flatten_scene, render_linear

    spec, cfg = main["spec"], main["cfg"]
    w, h = spec.size

    def both():
        fresh = flatten_scene(spec.scene, dev)
        out = []
        for c in (cfg, dataclasses.replace(cfg, cuda_graphs=False)):
            stats = []
            out.append((render_linear(fresh, spec.camera, (w, h), spec.background, c,
                                      stats=stats), stats))
        return out

    (lin, stats), (elin, estats) = _deterministic(both)
    apart = int((lin != elin).any(axis=-1).sum())
    syncs = sum(s.syncs for s in stats)
    same_live = [s.live.tolist() for s in stats] == [s.live.tolist() for s in estats]
    print(f"[4 deterministic] {main['label']}: under deterministic algorithms the captured "
          f"render "
          f"({main['bodies']} conditional bodies, {main['loops']} loops) against the eager "
          f"chunk loop: linear images {apart} pixels apart (max |diff| "
          f"{float(np.abs(lin - elin).max()):.3g}), live rays per round equal {same_live}, "
          f"host reads captured {syncs}, eager {sum(s.syncs for s in estats)}", flush=True)
    if apart or syncs or not same_live or not main["loops"]:
        raise AssertionError(f"{main['label']}: the looped capture against the eager loop: "
                             f"{apart} "
                             f"pixels apart, {syncs} host reads, live equal {same_live}, "
                             f"{main['loops']} loops")


def _linear_vs_flat(dev, spec, spp, size=None):
    """`spec` (a SceneSpec or a registry name) through render_linear and
    the kernels, held against the flat oracle's render on the card, run op
    by op (cuda_graphs=False, so that the oracle shares no captured
    program with the code under test): fewer
    than 0.1% of pixels may differ by more than 1e-4 (a silhouette sample
    that one sweep hits and the other misses moves its pixel by a large
    step; on a mesh, a ray leaving a triangle meets a neighbour that the
    kernel, which excludes the source pair, and the oracle, which raises
    its t-range start, may decide apart)."""
    import numpy as np
    import torch
    from portrayer_tpu_torch import RenderConfig, render_linear, scenes

    if isinstance(spec, str):
        spec = scenes.load(spec)
    name = spec.name
    w, h = size or spec.size
    args = (spec.scene, spec.camera, (w, h), spec.background)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    ours = render_linear(*args, RenderConfig(device=dev, samples=spp))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    if counts["nearest"] == 0 or counts["any_hit"] == 0 or counts["plain_on_cuda"] != 0:
        raise AssertionError(f"{name} did not run through the kernels alone: {counts}")
    _check_draws(name, counts)
    t0 = time.perf_counter()
    flat = render_linear(*args, RenderConfig(device=dev, samples=spp, accel="flat",
                                             cuda_graphs=False))
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


class _HeldSweep:
    """Within the block, each sweep launch is also run through the plain
    version on the same inputs (PLAIN_ROWS rays at a time) and held
    against it under phase 2's gates (_gate_nearest; .hit equal in any-hit
    mode), its error and difference counts added to err and diffs; the
    kernel's answer goes on.  `launches` lists (mode, rays) of each."""

    def __init__(self, label, err, diffs):
        self.label, self.err, self.diffs, self.launches = label, err, diffs, []

    def __enter__(self):
        from portrayer_tpu_torch.ops import cuda_intersect as ci

        self.kernel = ci.intersect_scene_cuda
        ci.intersect_scene_cuda = self._held
        return self

    def __exit__(self, *exc):
        from portrayer_tpu_torch.ops import cuda_intersect as ci

        ci.intersect_scene_cuda = self.kernel

    def _held(self, o, d, t_min, t_max, st, cfg, any_hit=False, **kw):
        k = self.kernel(o, d, t_min, t_max, st, cfg, any_hit=any_hit, **kw)
        kw = {n: v for n, v in kw.items() if v is not None}
        p = _plain(o, d, t_min, st, cfg, kw, any_hit=any_hit, rows=PLAIN_ROWS)
        mode = "any_hit" if any_hit else "nearest"
        label = f"{self.label} {mode} launch {len(self.launches)} ({o.shape[0]} rays)"
        if any_hit:
            n_any = int((k.hit != p.hit).sum())
            if n_any:
                raise AssertionError(f"{label}: hit differs on {n_any} rays")
        else:
            e, n = _gate_nearest(k, p, label)
            self.err[mode] = max(self.err[mode], e)
            self.diffs[mode] += n
        self.launches.append((mode, o.shape[0]))
        return k


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
    # Op by op: the plain version cannot be captured.
    cfg = RenderConfig(device=dev, cuda_graphs=False)
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


def _bounce_fit(dev, name, size, spp, fields, path_counts, err, diffs, accel="cuda",
                extra=None):
    """A fit through the bounce rounds (BOUNCE_FITS, SWEEP_FITS): `name`'s
    frame at `size` x spp in one trace, through the sweep of `accel`
    (`extra`: the RenderConfig's other settings); FIT_STEPS gradient steps
    on `fields`, started at FIT_START of the truth, against the true
    render, through the captured fit program and op by op, each pass's
    loss, seconds, sweeps (forward, backward: kernel launches, flat and
    beam sweeps and beam steps, counted on the device) and host reads; an
    op-by-op pass with bounce-round checkpointing off; a step's peak
    memory in each of the three; the captured gradients of every
    DIFF_FIELDS table at the first step, and those with checkpointing off,
    against the op-by-op ones (GRAD_RTOL of the largest entry); with the
    kernel, last, an op-by-op step whose every sweep launch is held
    against the plain version (_HeldSweep; err and diffs as in phase
    2)."""
    import dataclasses
    import gc
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops import cuda_intersect
    from portrayer_tpu_torch.ops.trace import slice_sizes, trace
    from portrayer_tpu_torch.parallel import DIFF_FIELDS

    spec = _inline(name) if name == "glass-sphere" else scenes.load(name)
    w, h = size or spec.size
    st = flatten_scene(spec.scene, dev)
    extra = extra or {}
    cfg = RenderConfig(device=dev, queue_caps=spec.queue_caps, accel=accel, **extra)
    label = name if accel == "cuda" else f"{name} {accel}" + "".join(
        f" {k}={v}" for k, v in extra.items())
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(BOUNCE_FIT_KEY), Camera(spec.camera, (w, h), dev), 0, 0, 0, cfg=cfg,
        background=spec.background, tile_h=h, tile_w=w, spp=spp, samples=spp)
    P, R = w * h, w * h * spp
    key = rng.PRNGKey(BOUNCE_FIT_KEY + 1)
    with torch.no_grad():
        target = trace(key, o, d, pix, bg, P, st, cfg, w0=w0, spp_contiguous=spp) / spp

    def step(c, params, memory=False, held=False):
        """A forward and backward; with `memory`, after emptying the
        allocator's cache, so that the reserved peak is this step's (a
        captured step's graph pool included: replays allocate nothing, so
        the allocated peak leaves the pool out).  `held`: the step runs
        the plain version beside the kernel, so its counts are not
        checked."""
        leaves = {f: params.get(f, getattr(st, f)).detach().clone().requires_grad_()
                  for f in DIFF_FIELDS}
        if memory:
            gc.collect()
            torch.cuda.empty_cache()
        _sync(dev)
        _reset_peak(dev)
        _reset_counts()
        t0 = time.perf_counter()
        acc, stats = trace(key, o, d, pix, bg, P, st.replace(**leaves), c, w0=w0,
                           spp_contiguous=spp, with_stats=True)
        loss = torch.mean((acc / spp - target) ** 2)
        _sync(dev)
        fwd = _counts()
        _reset_counts()
        loss.backward()
        _sync(dev)
        secs = time.perf_counter() - t0
        bwd = _counts()
        if not held and (any(bwd[m] for m in cuda_intersect.SWEEP_MODES) or bwd["plain_on_cuda"]
                         or fwd["plain_on_cuda"]):
            raise AssertionError(f"fit {label}: forward {fwd}, backward {bwd} (the backward "
                                 f"swept, or the plain version ran on the card)")
        if not held:
            _check_draws(f"fit {label} forward", fwd, st)
            _check_draws(f"fit {label} backward", bwd)
        if stats.dropped_w != 0.0:
            raise AssertionError(f"fit {label}: queue overflow dropped {stats.dropped_w:.3g}")
        return dict(loss=float(loss.detach()), grads={f: x.grad for f, x in leaves.items()},
                    stats=stats, secs=secs, fwd=fwd, bwd=bwd, peak=_peak_gib(dev),
                    reserved=torch.cuda.max_memory_reserved(dev) / 2**30)

    # Op by op first: no graph pool of this scene is alive then.
    runs, peaks = {}, {}
    start = {f: getattr(st, f) * FIT_START for f in fields}
    eager = dataclasses.replace(cfg, cuda_graphs=False)
    off_cfg = dataclasses.replace(eager, remat_min_lanes=REMAT_OFF)
    off = step(off_cfg, start)
    peaks["off"] = step(off_cfg, start, memory=True)
    for run, c in (("op by op", eager), ("captured", cfg)):
        params = dict(start)
        steps = []
        for _ in range(FIT_STEPS + 1):
            steps.append(step(c, params))
            for f in fields:
                g = steps[-1]["grads"][f]
                if not torch.isfinite(g).all() or g.abs().max() == 0.0:
                    raise AssertionError(f"fit {label} ({run}): {f} gradient not finite or 0")
                params[f] = params[f] - FIT_STEP * g / g.abs().max()
        losses = [s["loss"] for s in steps]
        if any(b >= a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"fit {label} ({run}): the loss did not fall at every step: "
                                 f"{losses}")
        runs[run] = steps
        peaks[run] = step(c, start, memory=True)
    notes = []
    for f in DIFF_FIELDS:
        got, ref = runs["captured"][0]["grads"][f], runs["op by op"][0]["grads"][f]
        scale = ref.abs().max().item()
        diff = (got - ref).abs().max().item()
        off_diff = (off["grads"][f] - ref).abs().max().item()
        if not torch.isfinite(got).all() or max(diff, off_diff) > GRAD_RTOL * scale:
            raise AssertionError(f"fit {label}: {f} gradients captured / checkpointing off "
                                 f"against op by op differ by {diff:.3g} / {off_diff:.3g} "
                                 f"(largest entry {scale:.3g})")
        notes.append(f"{f} {diff:.3g} of {scale:.3g}")
    cap, ref = runs["captured"], runs["op by op"]
    (prog,) = st.packed.fit_programs.values()
    # A captured step sweeps once a mode and live round: the kernel's two
    # modes, or the flat or beam sweep twice (nearest and shadow rays).
    swept = ((("nearest",), ("any_hit",)) if accel == "cuda"
             else (("flat_sweep", "beam_sweep"),))
    for i, s in enumerate(cap):
        rounds = int((s["stats"].live > 0).sum())
        got = tuple(sum(s["fwd"][m] for m in modes) for modes in swept)
        want = (rounds,) * 2 if accel == "cuda" else (2 * rounds,)
        # The first step's counts hold its warm-up's launches too.
        if s["stats"].syncs or i and got != want:
            raise AssertionError(f"fit {label}, captured step {i}: {s['stats'].syncs} host "
                                 f"reads, forward sweeps {s['fwd']} for {rounds} rounds")
    held_note = ""
    if accel == "cuda":
        with _HeldSweep(f"fit {name}", err, diffs) as held:
            step(eager, start, held=True)
        sizes_held = {m: sorted({n for mode, n in held.launches if mode == m}, reverse=True)
                      for m in ("nearest", "any_hit")}
        held_note = (f"; one op-by-op step with each of its {len(held.launches)} sweep launches "
                     f"held against the plain version under phase 2's gates, rays a launch: "
                     f"nearest {sizes_held['nearest']}, any-hit {sizes_held['any_hit']}")
    path_counts[f"fit {label}, captured step"] = {
        k: cap[-1]["fwd"][k] + cap[-1]["bwd"][k] for k in cap[-1]["fwd"]}
    live = cap[0]["stats"].live.tolist()
    f3 = lambda key, steps: [f"{s[key]:.3f}" for s in steps]
    gib = lambda p: f"{p['peak']:.3f} / {p['reserved']:.3f}"
    mse = lambda steps: [f"{s['loss']:.6g}" for s in steps]
    caps = sorted(set(prog.pl.cap[1:]))
    sizes = slice_sizes(caps[-1], cfg.queue_slice_divs)
    fwd, bwd, rfwd, rbwd = cap[-1]["fwd"], cap[-1]["bwd"], ref[-1]["fwd"], ref[-1]["bwd"]
    print(f"[5 fit] {label} {w}x{h} x {spp} spp ({R} rays in one trace; queue capacities "
          f"{caps}, slices {sizes}), {list(fields)} from {FIT_START} of the truth: MSE per "
          f"step captured {mse(cap)}, op by op {mse(ref)}; seconds per step (forward + "
          f"backward) captured {f3('secs', cap)} (the first with a warm-up pass op by op and "
          f"the captures: {prog.capture_s:.3f} s, {len(prog.graphs)} graphs, "
          f"{sum(g.bodies for g in prog.graphs.values())} conditional bodies, "
          f"{sum(g.loops for g in prog.graphs.values())} loops), op by op "
          f"{f3('secs', ref)}, op by op with bounce-round checkpointing off {off['secs']:.3f}; "
          f"peak memory of a step, GiB allocated / reserved: captured {gib(peaks['captured'])}, "
          f"op by op {gib(peaks['op by op'])} (every round checkpointed), "
          f"{gib(peaks['off'])} with bounce-round checkpointing off; sweep "
          f"launches a captured step nearest {fwd['nearest']} any-hit {fwd['any_hit']} in "
          f"forward, {bwd['nearest']} and {bwd['any_hit']} in backward (op by op "
          f"{rfwd['nearest']} / {rfwd['any_hit']} and {rbwd['nearest']} / {rbwd['any_hit']}); "
          f"flat sweeps, beam sweeps and beam steps a captured step {fwd['flat_sweep']}, "
          f"{fwd['beam_sweep']} and {fwd['beam_step']} in forward, {bwd['flat_sweep']}, "
          f"{bwd['beam_sweep']} and {bwd['beam_step']} in backward (op by op "
          f"{rfwd['flat_sweep']}, {rfwd['beam_sweep']} and {rfwd['beam_step']}, and "
          f"{rbwd['flat_sweep']}, {rbwd['beam_sweep']} and {rbwd['beam_step']}); "
          f"host reads a captured step {cap[-1]['stats'].syncs} (op by op "
          f"{ref[-1]['stats'].syncs}); conditional kernel runs a captured step "
          f"{fwd['graph_if']} + {bwd['graph_if']}, loop step kernel runs {fwd['graph_while']} + "
          f"{bwd['graph_while']}; live rays per round "
          f"{live}; dropped_w 0; captured against op-by-op gradients, max |diff| of max |g|: "
          + "; ".join(notes) + held_note, flush=True)

    # One captured step (the tail one loop) on a fresh program and one op
    # by op (every round unrolled), under _deterministic.
    def both():
        st.packed.fit_programs.clear()
        return [step(c, start) for c in (cfg, eager)]

    det = _deterministic(both)
    st.packed.fit_programs.clear()
    apart = sum(int((det[0]["grads"][f] != det[1]["grads"][f]).sum()) for f in DIFF_FIELDS)
    entries = sum(det[0]["grads"][f].numel() for f in DIFF_FIELDS)
    same_live = det[0]["stats"].live.tolist() == det[1]["stats"].live.tolist()
    print(f"[5 fit deterministic] {label}: under deterministic algorithms a captured step "
          f"against an op-by-op one: loss {det[0]['loss']!r} and {det[1]['loss']!r}, {apart} "
          f"of {entries} gradient entries apart, live rays per round equal {same_live}, host "
          f"reads captured {det[0]['stats'].syncs}", flush=True)
    if apart or det[0]["loss"] != det[1]["loss"] or not same_live or det[0]["stats"].syncs:
        raise AssertionError(f"fit {label}: the looped capture against op by op: {apart} "
                             f"gradient entries apart, losses {det[0]['loss']!r} and "
                             f"{det[1]['loss']!r}, live equal {same_live}, host reads "
                             f"{det[0]['stats'].syncs}")


def _exempt_fit(dev, path_counts):
    """The fit of BOUNCE_FITS[0] with remat_min_lanes=EXEMPT_LANES beside
    remat_min_lanes=0, both captured, in this call: a first step (warm-up
    and capture) and two cached steps of each, their seconds, peak
    allocated and reserved memory, host reads (0) and sweeps in the
    backward (none); captured against op by op at EXEMPT_LANES under
    _deterministic (losses equal, 0 gradient entries apart).  Returns a
    function that counts the kernels of a cached step's backward of each
    under torch.profiler (phase 8 runs it, last, and
    exempt_backward_alone)."""
    import dataclasses
    import gc
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops import cuda_intersect
    from portrayer_tpu_torch.ops.trace import trace
    from portrayer_tpu_torch.parallel import DIFF_FIELDS

    name, size, spp, fields = BOUNCE_FITS[0]
    spec = scenes.load(name)
    w, h = size or spec.size
    base = RenderConfig(device=dev, queue_caps=spec.queue_caps)
    cfgs = {0: base, EXEMPT_LANES: dataclasses.replace(base, remat_min_lanes=EXEMPT_LANES)}
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(BOUNCE_FIT_KEY), Camera(spec.camera, (w, h), dev), 0, 0, 0, cfg=base,
        background=spec.background, tile_h=h, tile_w=w, spp=spp, samples=spp)
    key = rng.PRNGKey(BOUNCE_FIT_KEY + 1)
    tables = {m: flatten_scene(spec.scene, dev) for m in cfgs}
    with torch.no_grad():
        target = trace(key, o, d, pix, bg, w * h, tables[0], base, w0=w0,
                       spp_contiguous=spp) / spp

    def step(st, c):
        leaves = {f: (getattr(st, f) * (FIT_START if f in fields else 1.0)).detach()
                  .requires_grad_() for f in DIFF_FIELDS}
        gc.collect()
        torch.cuda.empty_cache()
        _sync(dev)
        _reset_peak(dev)
        _reset_counts()
        t0 = time.perf_counter()
        acc, stats = trace(key, o, d, pix, bg, w * h, st.replace(**leaves), c, w0=w0,
                           spp_contiguous=spp, with_stats=True)
        loss = torch.mean((acc / spp - target) ** 2)
        _sync(dev)
        fwd = _counts()
        _reset_counts()
        with torch.profiler.record_function("fit_backward"):
            loss.backward()
        _sync(dev)
        secs = time.perf_counter() - t0
        bwd = _counts()
        swept = sum(bwd[m] for m in cuda_intersect.SWEEP_MODES)
        if swept or bwd["plain_on_cuda"] or fwd["plain_on_cuda"] or stats.dropped_w:
            raise AssertionError(f"exempt fit: forward {fwd}, backward {bwd}, dropped "
                                 f"{stats.dropped_w}")
        _check_draws("exempt fit forward", fwd, st)
        _check_draws("exempt fit backward", bwd)
        return dict(loss=float(loss.detach()), grads={f: x.grad for f, x in leaves.items()},
                    stats=stats, secs=secs, fwd=fwd, bwd=bwd, peak=_peak_gib(dev),
                    reserved=torch.cuda.max_memory_reserved(dev) / 2**30)

    runs = {m: [step(tables[m], c) for _ in range(3)] for m, c in cfgs.items()}
    progs = {m: next(iter(tables[m].packed.fit_programs.values())) for m in cfgs}
    prog = progs[EXEMPT_LANES]
    exempt = sorted(prog.exempt, key=str)
    if not exempt or progs[0].exempt:
        raise AssertionError(f"exempt fit: exempt bodies {exempt} (remat_min_lanes 0: "
                             f"{sorted(progs[0].exempt, key=str)})")
    for m, steps in runs.items():
        if any(s["stats"].syncs for s in steps):
            raise AssertionError(f"exempt fit, remat_min_lanes={m}: host reads "
                                 f"{[s['stats'].syncs for s in steps]}")
    last = runs[EXEMPT_LANES][-1]
    path_counts[f"fit {name} remat_min_lanes={EXEMPT_LANES}, captured step"] = {
        k: last["fwd"][k] + last["bwd"][k] for k in last["fwd"]}
    res_bytes = sum(n for sp_name, _, _, _, n in prog.state.spans if sp_name[0] == "res")
    res_bytes += sum(r.numel() for r in prog.res.rows.values())

    def both():
        fresh = flatten_scene(spec.scene, dev)
        c = cfgs[EXEMPT_LANES]
        return [step(fresh, c), step(fresh, c), step(fresh, dataclasses.replace(
            c, cuda_graphs=False))]

    _, det, eager = _deterministic(both)
    apart = sum(int((det["grads"][f] != eager["grads"][f]).sum()) for f in DIFF_FIELDS)
    entries = sum(det["grads"][f].numel() for f in DIFF_FIELDS)
    f3 = lambda steps: [f"{s['secs']:.3f}" for s in steps]
    gib = lambda s: f"{s['peak']:.3f} / {s['reserved']:.3f}"
    print(f"[5 exempt fit] {name} {w}x{h} x {spp} spp, remat_min_lanes {EXEMPT_LANES}: "
          f"exempt bodies {exempt} (the slices of fewer lanes keep their autograd "
          f"temporaries: {res_bytes / 2**30:.3f} GiB of residual slots); seconds a step "
          f"captured {f3(runs[EXEMPT_LANES])} (the first with the warm-up and a capture of "
          f"{prog.capture_s:.3f} s), remat_min_lanes 0 {f3(runs[0])} (capture "
          f"{progs[0].capture_s:.3f} s); peak memory of a cached step, GiB allocated / "
          f"reserved: {gib(last)} against {gib(runs[0][-1])}; MSE {last['loss']:.6g} and "
          f"{runs[0][-1]['loss']:.6g}; host reads a captured step "
          f"{last['stats'].syncs} and {runs[0][-1]['stats'].syncs}; sweep launches in a "
          f"backward {sum(last['bwd'][m] for m in cuda_intersect.SWEEP_MODES)} and "
          f"{sum(runs[0][-1]['bwd'][m] for m in cuda_intersect.SWEEP_MODES)}; under "
          f"deterministic algorithms captured against op by op: loss {det['loss']!r} and "
          f"{eager['loss']!r}, {apart} of {entries} gradient entries apart, host reads "
          f"captured {det['stats'].syncs}", flush=True)
    if apart or det["loss"] != eager["loss"] or det["stats"].syncs:
        raise AssertionError(f"exempt fit: captured against op by op {apart} gradient "
                             f"entries apart, losses {det['loss']!r} and {eager['loss']!r}")

    def backward_kernels(where: str, check: bool):
        """Kernels of a cached step's backward at each remat_min_lanes
        under torch.profiler, which sees the kernels of a graph replay and
        of its conditional bodies, though not after every history of the
        process (main runs the held count in a process of its own); beside
        them, what reads no trace: the device's runs of the conditional
        kernel (graph_if) and of loop steps (graph_while) in that
        backward, the step's seconds, and how far its loss and gradients
        lie from the last cached step's above (the card's gradients vary
        in their last bits).  With `check`, the exempt rounds must cut the
        kernels."""
        from portrayer_tpu_torch import profile_render as pr

        out, ran = {}, {}
        for m, c in cfgs.items():
            res = []
            ms, raw = pr._traced(lambda: res.append(step(tables[m], c)))
            out[m] = pr.summarize_trace(pr.after(json.loads(raw), "fit_backward"), ms, 1)
            ran[m] = {k: res[0]["bwd"][k] for k in ("graph_if", "graph_while")}
            ran[m]["secs"] = round(res[0]["secs"], 4)
            ref = runs[m][-1]
            ran[m]["loss_apart"] = abs(res[0]["loss"] - ref["loss"])
            ran[m]["grad_apart"] = max(float((res[0]["grads"][f] - ref["grads"][f]).abs().max())
                                       for f in DIFF_FIELDS)
        k0, k1 = out[0]["kernel_launches"], out[EXEMPT_LANES]["kernel_launches"]
        print(f"[8 exempt fit] {name}, {where}: kernels in a cached captured step's backward "
              f"{k1} with remat_min_lanes {EXEMPT_LANES} against {k0} with 0; device "
              f"{out[EXEMPT_LANES]['device_ms']:.3f} against {out[0]['device_ms']:.3f} ms; sweep "
              f"kernels {out[EXEMPT_LANES]['sweep_launches']} and {out[0]['sweep_launches']}; "
              f"conditional kernel runs, loop steps (device counts), step seconds, loss and "
              f"max |gradient| apart from the last cached step's "
              f"{ran[EXEMPT_LANES]} and {ran[0]}", flush=True)
        if check and (not k1 < k0 or out[EXEMPT_LANES]["sweep_launches"]):
            raise AssertionError(f"exempt fit: backward kernels {k1} against {k0}, sweeps "
                                 f"{out[EXEMPT_LANES]['sweep_launches']}")

    return backward_kernels


def exempt_backward_alone() -> int:
    """The held count of phase 8, run by main in a process of its own
    (``python3 chip_smoke.py --exempt-backward-kernels``) before the other
    phases: _exempt_fit built afresh, then its backward's kernels counted
    and held to their bound.  The profiler's count of the kernels in a
    graph's conditional bodies varies with what the process ran before
    (the same backward, the same device counts); on the fit alone it is
    the graph's."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _exempt_fit(torch.device("cuda", 0), {})("in a process of its own", check=True)
    return 0


def _shade_hits(dev, path_counts):
    """ops.shade_hits on big-scene's SHADE_HITS_RAYS camera rays (its three
    lights), on the card (one any-hit launch through the kernel, counted)
    against its plain version (the same inputs as CPU tensors): 0
    occlusion verdicts apart, colours within SHADE_HITS_TOL."""
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.ops import shade
    from portrayer_tpu_torch.ops.intersect import Hit, HitDetail, hit_detail, intersect_scene

    spec = scenes.load("big-scene")
    w, h = spec.size
    cfg, cpu = RenderConfig(device=dev), RenderConfig(device="cpu")
    st, st_cpu = flatten_scene(spec.scene, dev), flatten_scene(spec.scene, "cpu")
    u = rng.uniform(rng.PRNGKey(7), (SHADE_HITS_RAYS, 2), dev)
    o, d = Camera(spec.camera, spec.size, dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    hit = intersect_scene(o, d, cfg.epsilon, float("inf"), st, cfg)
    det = hit_detail(o, d, hit, st, cfg, cfg.epsilon)
    verdicts = []
    real = shade.occluded
    shade.occluded = lambda *a, **k: verdicts.append(real(*a, **k)) or verdicts[-1]
    try:
        _reset_counts()
        colour, _, _ = shade.shade_hits(d, hit, det, st, cfg, rng.PRNGKey(0), hit.hit)
        torch.cuda.synchronize()
        counts = _counts()
        host = lambda x: Hit(*(t.cpu() for t in x)) if isinstance(x, Hit) else HitDetail(
            *(t.cpu() for t in x))
        ref, _, _ = shade.shade_hits(d.cpu(), host(hit), host(det), st_cpu, cpu,
                                     rng.PRNGKey(0), hit.hit.cpu())
    finally:
        shade.occluded = real
    path_counts["shade_hits big-scene"] = counts
    apart = int((verdicts[0].cpu() != verdicts[1]).sum())
    diff = float((colour.cpu() - ref).abs().max())
    print(f"[2 shade_hits] big-scene, {SHADE_HITS_RAYS} camera rays, {st.n_lights} lights: "
          f"any-hit launches {counts['any_hit']} ({verdicts[0].numel()} shadow rays, "
          f"{int(verdicts[0].sum())} occluded); against its plain version (CPU tensors) "
          f"{apart} verdicts apart, colours max |diff| {diff:.3g}", flush=True)
    if counts["any_hit"] != 1 or counts["plain_on_cuda"] or apart or not diff <= SHADE_HITS_TOL:
        raise AssertionError(f"shade_hits: launches {counts}, {apart} verdicts apart, "
                             f"colours {diff:.3g} apart")
    _check_draws("shade_hits", counts, st)


def phase_gradients(dev, path_counts, err, diffs):
    """Kernel against plain version under autograd on two tiles, then the
    full-width fits (see the module docstring); err and diffs as in phase
    2.  Returns the exempt fit's phase-8 count (_exempt_fit)."""
    import dataclasses
    import gc
    import torch
    from portrayer_tpu_torch import RenderConfig, flatten_scene, scenes
    from portrayer_tpu_torch.ops import cuda_intersect

    for name in ("big-scene", "torus-showcase"):
        cuda_intersect.reset_counts()
        gk, lk = _tile_grads(dev, name, plain=False)
        counts = cuda_intersect.counts()
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

    for name, size, spp, fields in BOUNCE_FITS:
        _bounce_fit(dev, name, size, spp, fields, path_counts, err, diffs)
    name, size, spp, fields = BOUNCE_FITS[0]
    for accel, extra in SWEEP_FITS:
        _bounce_fit(dev, name, size, spp, fields, path_counts, err, diffs, accel, extra)
    backward_kernels = _exempt_fit(dev, path_counts)

    spec = scenes.load("big-scene")
    cfg = RenderConfig(device=dev, samples=1, tile=FIT_TILE, max_rays_per_launch=LAUNCH_RAYS)
    st = flatten_scene(spec.scene, dev)
    target = _frame_pass(dev, st, spec, cfg)
    x = (st.mat_diffuse * FIT_START).requires_grad_()
    losses, secs = [], []
    # The bounce fits' programs hold their state slabs until the cycle
    # collector frees them (a program and its tables refer to each other).
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
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
    counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    path_counts["fit big-scene, captured"] = counts
    if any(b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"fit: the loss did not fall at every step: {losses}")
    if counts["nearest"] == 0 or counts["any_hit"] == 0 or counts["plain_on_cuda"]:
        raise AssertionError(f"fit did not run through the kernels alone: {counts}")
    _check_draws("fit big-scene, captured", counts, st)
    (prog,) = st.packed.fit_programs.values()
    # Beside it, one pass op by op at the fitted values.
    x.grad = None
    eager_loss, eager_secs, _, eager_peak = _timed(dev, lambda: _frame_pass(
        dev, st, spec, dataclasses.replace(cfg, cuda_graphs=False), diffuse=x, target=target))
    err = ((x.detach() - st.mat_diffuse).abs().max() / st.mat_diffuse.abs().max()).item()
    w, h = spec.size
    print(f"[5 fit] big-scene {w}x{h} x 1 spp, {-(-w // FIT_TILE[1]) * -(-h // FIT_TILE[0])} "
          f"chunks of {FIT_TILE[0] * FIT_TILE[1]} rays, mat_diffuse from {FIT_START} of the "
          f"truth, captured: MSE per step {[f'{v:.6g}' for v in losses]}; seconds per step "
          f"(forward + backward) {[f'{v:.3f}' for v in secs]} (capture {prog.capture_s:.3f} s, "
          f"{len(prog.graphs)} graphs, replays {[g.replays for g in prog.graphs.values()]}); "
          f"peak memory {peak:.3f} GiB; kernel launches nearest {counts['nearest']} any-hit "
          f"{counts['any_hit']}; largest relative error of mat_diffuse after {FIT_STEPS} steps "
          f"{err:.3g}; one pass op by op {eager_secs:.3f} s (MSE {eager_loss:.6g}, peak "
          f"{eager_peak:.3f} GiB)", flush=True)
    return backward_kernels


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


def _reset_counts():
    """Zero the sweep module's, the threefry kernel's and the round
    kernels' launch counts."""
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.ops import cuda_intersect, cuda_round

    cuda_intersect.reset_counts()
    rng.reset_counts()
    cuda_round.reset_counts()


def _counts() -> dict:
    """The launch counts since _reset_counts: cuda_intersect.counts(),
    rng.counts() under threefry_<name> (the threefry kernel's launches per
    entry point, and threefry_plain_on_cuda) and cuda_round.counts() under
    round_<name> (shade_round, resolve_round, plain_rounds_cuda)."""
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.ops import cuda_intersect, cuda_round

    return {**cuda_intersect.counts(),
            **{f"threefry_{k}": n for k, n in rng.counts().items()},
            **{f"round_{k}": n for k, n in cuda_round.counts().items()}}


def _restore_counts(saved):
    """Set the counts back to `saved` (_counts()), what ran since left out."""
    from portrayer_tpu_torch import rng
    from portrayer_tpu_torch.ops import cuda_intersect, cuda_round

    _reset_counts()
    cuda_intersect.COUNTS.update({k: saved[k] for k in cuda_intersect.COUNTS})
    rng.COUNTS.update({k: saved[f"threefry_{k}"] for k in rng.COUNTS})
    cuda_round.COUNTS.update({k: saved[f"round_{k}"] for k in cuda_round.COUNTS})


def _check_draws(label, counts, st=None):
    """Every threefry draw went through a kernel (0 plain calls on CUDA
    tensors), and on the tables `st` of a scene that draws per lane (a
    glossy material or an area light) draw_lanes (the plain chain's draws)
    or shade_round (which draws in its lanes) ran."""
    if counts["threefry_plain_on_cuda"]:
        raise AssertionError(f"{label}: a threefry draw ran its plain version on the card: "
                             f"{counts}")
    if (st is not None and (st.any_glossy or any(st.area_flags))
            and not (counts["threefry_draw_lanes"] or counts["round_shade_round"])):
        raise AssertionError(f"{label}: the scene draws per lane, but neither draw_lanes nor "
                             f"shade_round ran: {counts}")


def _check_rounds(label, counts, st=None):
    """A render's rounds on the card took the round kernels (csrc/round.cu),
    one shade_round and one resolve_round each, and none the plain chain,
    unless the scene has a procedural texture (a torch callable that no
    kernel can run)."""
    if st is not None and st.fn_textures:
        if counts["round_shade_round"] or not counts["round_plain_rounds_cuda"]:
            raise AssertionError(f"{label}: a scene with procedural textures took the round "
                                 f"kernels: {counts}")
        return
    if (counts["round_plain_rounds_cuda"] or not counts["round_shade_round"]
            or counts["round_shade_round"] != counts["round_resolve_round"]):
        raise AssertionError(f"{label}: a render's rounds did not all take the round kernels: "
                             f"{counts}")


def _timed(dev, fn):
    """(result, seconds, kernel launch counts (_counts), peak GiB) of fn(),
    the counts zeroed just before it."""
    _sync(dev)
    _reset_peak(dev)
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    secs = time.perf_counter() - t0
    return out, secs, _counts(), _peak_gib(dev)


def _check_counts(label, counts, dev, st=None, render=True):
    """Both sweep modes ran as kernels alone and the draws through theirs;
    a render's rounds took the round kernels (a fit's, `render` False, the
    plain chain)."""
    if dev.type == "cuda" and (counts["nearest"] == 0 or counts["any_hit"] == 0
                               or counts["plain_on_cuda"]):
        raise AssertionError(f"{label} did not run through both kernel modes alone: {counts}")
    if dev.type == "cuda":
        _check_draws(label, counts, st)
        if render:
            _check_rounds(label, counts, st)


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
    import dataclasses
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
    _check_counts(f"{label} render_frame_distributed", counts, dev, st)
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
    _check_counts(f"{label} train_step", tcounts, dev, render=False)
    _, esecs, _, epeak = _timed(dev, lambda: par.train_step(
        mesh, rng.PRNGKey(MD_TRAIN_KEY), to, td, tpix, bg, w * h, MD_TRAIN_SPP, target, st0,
        dataclasses.replace(tcfg, cuda_graphs=False), fields=MD_FIELDS))
    print(f"[6 multi-device] {label}: render_frame_distributed big-scene {w}x{h} x {spp} spp "
          f"({R0} rays, {per} on this rank in one trace): {secs:.3f} s (the first call "
          f"{cold:.3f} s), {R0 / secs / 1e6:.3f} Mrays/s, peak memory {peak:.3f} GiB, launches "
          f"nearest "
          f"{counts['nearest']} any-hit {counts['any_hit']}; all-reduce of the "
          f"{w * h}x3 framebuffer {ar_ms:.3f} ms; train_step ({w}x{h} x {MD_TRAIN_SPP} spp, "
          f"{MD_FIELDS}) captured {tsecs:.3f} s a step (the first, with its capture, "
          f"{tcold:.3f} s), peak memory {tpeak:.3f} GiB, op by op {esecs:.3f} s (peak "
          f"{epeak:.3f} GiB), loss "
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
    summed, the MSE and one backward op by op: (loss, {field: gradient})."""
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
    # Op by op: the ranks' train_step replays the captured fit.
    tcfg = RenderConfig(device=dev, samples=MD_TRAIN_SPP, cuda_graphs=False)
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
    float32 render and, captured, against its op-by-op render."""
    import dataclasses
    import torch
    from _torch_jax import float64_tables, kernel_apart_limits, sweeps_apart
    from portrayer_tpu_torch import RenderConfig, flatten_scene, render_linear, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.debug import checked_trace
    from portrayer_tpu_torch.ops import cuda_intersect
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
        cuda_intersect.reset_counts()
        got = intersect_scene_beam(*args, st, bcfg, stats=stats, **kw)
        steps = int(stats["trips"])
        if cuda_intersect.counts()["beam_step"] != steps or not steps:
            raise AssertionError(f"beam {label}: {steps} steps, counted "
                                 f"{cuda_intersect.COUNTS['beam_step']} on the device")
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
              f"call, {steps} steps of its loops counted on the device (this call op by op: one "
              f"host read each; none captured); the kernel "
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
    cfg64 = RenderConfig(device=dev, samples=F64_SPP, tile=(48, 48), accel="flat",
                         dtype=torch.float64)
    st64 = flatten_scene(simple.scene, dev, dtype=torch.float64)
    args64 = (st64,) + args[1:]
    stats64 = []
    img64 = render_linear(*args64, cfg64, stats=stats64)
    (prog64,) = st64.chunk_programs.values()
    graphs64 = prog64.graphs
    eager64 = render_linear(*args64, dataclasses.replace(cfg64, cuda_graphs=False))
    img32 = render_linear(*args, RenderConfig(device=dev, samples=F64_SPP, tile=(48, 48)))
    diff = np.abs(img64 - img32)
    cap_diff = float(np.abs(img64 - eager64).max())
    syncs64 = sum(s.syncs for s in stats64)
    if not (diff.mean() < 2e-3 and diff.max() < 0.05) or img64.dtype != np.float64:
        raise AssertionError(f"float64 against float32: mean {diff.mean():.3g}, max "
                             f"{diff.max():.3g}")
    if (not cap_diff <= CAPTURED_TOL or syncs64 or list(graphs64) != ["chunk"]
            or prog64.tile_acc.dtype != torch.float64):
        raise AssertionError(f"float64 captured against op by op: max |diff| {cap_diff:.3g}, "
                             f"{syncs64} host syncs, graphs {list(graphs64)}, buffers "
                             f"{prog64.tile_acc.dtype}")
    print(f"[6 checks] float64 check mode, simple {F64_SIZE[0]}x{F64_SIZE[1]} x {F64_SPP} spp "
          f"(accel='flat') through the captured render ({len(graphs64)} graph, "
          f"{graphs64['chunk'].replays} replays, float64 buffers, {syncs64} host syncs): "
          f"against its op-by-op render max |diff| {cap_diff:.3g} (limit {CAPTURED_TOL}); "
          f"against the float32 kernel render: mean |diff| {diff.mean():.3g}, "
          f"max {diff.max():.3g} (gate: mean < 2e-3, max < 0.05)", flush=True)


# Phase 7: the scene programs that load assets, on seeded stand-in assets
# (tests/_torch_assets.py), at their published sizes and the runner's CI
# sample count.
STANDIN_SPP = 2
STANDIN_SEED = 0


def _chunk_rays(cam, size, cfg, middle):
    """The camera rays of one render chunk of `size` under cfg: the first
    (tile (0, 0)), or with `middle` the middle tile of the middle tile row,
    its pixels and samples as render._tile_rays lays them out, jittered
    with a fixed key."""
    import torch
    from portrayer_tpu_torch import render, rng

    th, tw = min(cfg.tile[0], size[1]), min(cfg.tile[1], size[0])
    spp = max(1, min(STANDIN_SPP, cfg.max_rays_per_launch // (th * tw)))
    x0 = (-(-size[0] // tw) - 1) // 2 * tw if middle else 0
    y0 = (-(-size[1] // th) - 1) // 2 * th if middle else 0
    o, d, *_ = render._tile_rays(rng.PRNGKey(11), cam, x0, y0, 0, cfg=cfg,
                                 background=render.default_background, tile_h=th, tile_w=tw,
                                 spp=spp, samples=STANDIN_SPP)
    src = torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device)
    return o, d, src


def phase_scenes(dev, path_counts, err, diffs):
    """The 22 scene programs that load assets, each through
    run_all_examples.render_all at its published size, STANDIN_SPP spp,
    accel="cuda" (the captured chunk program), on stand-in assets written
    to a temporary folder (PORTRAYER_ASSETS).  The launches of the renders
    go to path_counts, counted from 0 just before render_all and read
    just after it; the checks of each scene (run between its render and
    the next, their launches left out of the counts): its linear image
    finite (render_linear with the graphs cached), and the kernel against
    its plain version under phase 2's gates on the first chunk of camera
    rays and the middle tile's chunk, and on their shadow rays (err and
    diffs as in phase 2)."""
    import tempfile
    import numpy as np
    from portrayer_tpu_torch import render_linear, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.run_all_examples import render_all
    from _torch_assets import write_standins

    names = [n for n in scenes.names() if n not in scenes.ASSET_FREE]
    lines = []

    def check(name, spec, st, cfg, res):
        saved = _counts()
        lin = render_linear(st, spec.camera, tuple(res["size"]), spec.background, cfg)
        finite = bool(np.isfinite(lin).all())
        if not finite or lin.shape != (res["size"][1], res["size"][0], 3):
            raise AssertionError(f"{name}: linear image not finite or misshapen")
        cam = Camera(spec.camera, tuple(res["size"]), dev)
        torus = _torus_ids(st)
        apart = sum(diffs.values())
        held = []
        for which, middle in (("first", False), ("middle", True)):
            o, d, src = _chunk_rays(cam, tuple(res["size"]), cfg, middle)
            near = _hold(f"{name} {which} chunk camera", o, d, cfg.epsilon, st, cfg,
                         {"src_node": src, "src_tri": src}, torus, err, diffs)
            so, sd, st_min, sact, snode, stri = _shadow_rays(o, d, near, st, cfg)
            _hold(f"{name} {which} chunk shadow", so, sd, st_min, st, cfg,
                  dict(active=sact, src_node=snode, src_tri=stri), torus, err, diffs)
            held.append(f"{which} chunk {o.shape[0]} camera rays {near.hit.float().mean():.3f} "
                        f"hit, {int(sact.sum())} shadow rays")
        apart = sum(diffs.values()) - apart
        if apart:
            raise AssertionError(f"{name}: {apart} rays apart between the kernel and its plain "
                                 "version")
        _restore_counts(saved)
        w, h = res["size"]
        lines.append(
            f"[7 scenes] {name} (stand-in assets) {w}x{h} x {STANDIN_SPP} spp: first render "
            f"{res['secs']:.3f} s ({res['Mrays/s']:.3f} Mrays/s primary; scene build, "
            f"lowering, capture and PNG included), {res['graphs']} graphs, {res['bodies']} "
            f"conditional bodies, {res['loops']} loops, {res['replays']} replays, "
            f"{res['syncs']} host syncs; sweep "
            f"launches nearest {res['launches']['nearest']} any-hit "
            f"{res['launches']['any_hit']}; dropped_w {res['dropped_w']:.3g}; linear image "
            f"finite {finite}; kernel against plain version: {'; '.join(held)}, {apart} rays "
            f"apart")
        print(lines[-1], flush=True)
        if res["launches"]["nearest"] == 0 or res["launches"]["any_hit"] == 0 or res["syncs"]:
            raise AssertionError(f"{name}: the render launched no sweep kernel, or read on "
                                 f"the host: {res}")

    old = os.environ.get("PORTRAYER_ASSETS")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_standins(tmp, seed=STANDIN_SEED)
        os.environ["PORTRAYER_ASSETS"] = tmp
        try:
            _sync(dev)
            _reset_counts()
            render_all(names, os.path.join(OUT_DIR, "scenes"), samples=STANDIN_SPP,
                       accel="cuda", device=dev, on_scene=check)
            _sync(dev)
            counts = _counts()
        finally:
            if old is None:
                os.environ.pop("PORTRAYER_ASSETS")
            else:
                os.environ["PORTRAYER_ASSETS"] = old
    if len(lines) != len(names) or counts["plain_on_cuda"]:
        raise AssertionError(f"stand-in scenes: {len(lines)} of {len(names)} rendered, "
                             f"counts {counts}")
    _check_draws("stand-in scenes", counts)
    path_counts["stand-in scenes"] = counts
    print(f"[7 scenes] {len(names)} scene programs on stand-in assets in "
          f"{time.perf_counter() - t0:.3f} s; launches nearest {counts['nearest']} any-hit "
          f"{counts['any_hit']}", flush=True)


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
    from portrayer_tpu_torch import RenderConfig, rng
    from portrayer_tpu_torch.ops import cuda_round

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_card(dev)
    sys.stdout.flush()
    alone = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--exempt-backward-kernels"]).returncode
    if alone:
        raise AssertionError(f"exempt fit's backward kernels in a process of its own: exit "
                             f"{alone}")
    err, diffs, timing, branches = phase_kernels(dev)
    path_counts = {}
    _shade_hits(dev, path_counts)
    conditional, cond_replay = phase_conditional(dev)
    loop, loop_replay = phase_loop(dev)
    threefry, threefry_calls = phase_threefry(dev)
    round_fields, round_calls = phase_round(dev)
    phase_goldens(dev)
    mesh, textured = _inline("procedural-meshes"), _inline("normal-mapping-numpy")
    for spec in ("big-scene", "torus-showcase", "glossy-reflection", mesh, "single-triangle",
                 textured, _inline("soft-shadows-icosphere"), "four-shapes"):
        main_path = _main_path(dev, spec, path_counts)
        if spec in DETERMINISTIC_PATHS:
            _looped_against_eager(dev, main_path)
    _morton_path(dev, mesh, path_counts)
    for name, size, accel, extra, spp in SWEEP_PATHS:
        spec = mesh if name == "procedural-meshes" else name
        main_path = _main_path(dev, spec, path_counts, accel, spp, size, extra)
        if (name, accel) in DETERMINISTIC_SWEEP_PATHS:
            _looped_against_eager(dev, main_path)
    _linear_vs_flat(dev, "simple", SIMPLE_SPP)
    _linear_vs_flat(dev, "glossy-reflection", GLOSSY_LINEAR_SPP)
    _linear_vs_flat(dev, mesh, MESH_LINEAR_SPP, MESH_LINEAR_SIZE)
    _linear_vs_flat(dev, textured, MESH_LINEAR_SPP, MESH_LINEAR_SIZE)
    backward_kernels = phase_gradients(dev, path_counts, err, diffs)
    phase_multi_device(dev, path_counts, err, diffs)
    phase_checks(dev)
    phase_scenes(dev, path_counts, err, diffs)
    phase_device_times(timing, RenderConfig(device=dev))
    _graph_kernel_ms(conditional, cond_replay, "set_if_equal", "graphs.switch")
    _graph_kernel_ms(loop, loop_replay, "while_step", "graphs.loop")
    for label, (kernel, call) in threefry_calls.items():
        ms = _device_ms(call, THREEFRY_ITERS, kernel)
        threefry["by_call"][label]["device_ms"] = ms
        print(f"[8 device] threefry {label}: {_fmt(ms)} a call on the device", flush=True)
    _round_device_times(round_fields, round_calls)
    backward_kernels("after phases 2 to 7 in this process", check=False)

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
    kernels.append({
        "name": "graph_if", "route": "cuda", "source": COND_SOURCE, "replaces": COND_REPLACES,
        "launches": sum(c["graph_if"] for c in path_counts.values()),
        "launches_by_path": {p: c["graph_if"] for p, c in path_counts.items()},
        **conditional})
    kernels.append({
        "name": "graph_while", "route": "cuda", "source": COND_SOURCE,
        "replaces": LOOP_REPLACES,
        "launches": sum(c["graph_while"] for c in path_counts.values()),
        "launches_by_path": {p: c["graph_while"] for p, c in path_counts.items()},
        **loop})
    drawn = lambda c: sum(c[f"threefry_{k}"] for k in rng.KERNELS)
    kernels.append({
        "name": "threefry", "route": "cuda", "source": THREEFRY_SOURCE,
        "replaces": THREEFRY_REPLACES, "library_ms": None,
        "launches": sum(drawn(c) for c in path_counts.values()),
        "launches_by_path": {p: drawn(c) for p, c in path_counts.items()},
        "launches_by_entry": {k: sum(c[f"threefry_{k}"] for c in path_counts.values())
                              for k in rng.KERNELS},
        **threefry})
    for entry in cuda_round.KERNELS:
        kernels.append({
            "name": entry, "route": "cuda", "source": ROUND_SOURCE,
            "replaces": ROUND_REPLACES, "library_ms": None,
            "launches": sum(c[f"round_{entry}"] for c in path_counts.values()),
            "launches_by_path": {p: c[f"round_{entry}"] for p, c in path_counts.items()},
            **round_fields})
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def round_kernels_alone() -> int:
    """Phase 2's round-kernel part and its phase-8 device times, alone
    (python3 chip_smoke.py --round-kernels)."""
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    dev = torch.device("cuda", 0)
    phase_card(dev)
    fields, calls = phase_round(dev)
    _round_device_times(fields, calls)
    print(json.dumps({"round_kernels": fields}))
    return 0


if __name__ == "__main__":
    sys.exit(exempt_backward_alone() if sys.argv[1:] == ["--exempt-backward-kernels"]
             else round_kernels_alone() if sys.argv[1:] == ["--round-kernels"]
             else main())
