"""Multi-device execution: rays split over the ranks of a process group,
the scene replicated (counterpart of ``portrayer_tpu/parallel/sharding.py``).

The reference parallelizes with rayon over pixels in one process
(src/render.rs:127-150).  The JAX package shards the ray grid over a
device mesh in one process (``shard_map``) and sums the per-device
framebuffers with ``psum``.  The PyTorch idiom is one process per device
with ``torch.distributed``: rank r traces row block r of the rays against
its own copy of the scene tables, and one all-reduce (SUM) of the partial
framebuffers is the only communication of the forward pass.

Gradients.  The all-reduce is an autograd Function whose backward returns
the cotangent unchanged: the loss is computed alike on every rank from the
summed framebuffer, so the cotangent of a rank's partial is that of the
sum.  Each rank's parameters then hold the gradient through its own rays,
and ``train_step`` all-reduces them once, so that every rank holds the
full gradient, at every world size the same.  (An all-reduce whose
backward all-reduces the cotangent too, as
``torch.distributed.nn.functional.all_reduce`` does, followed by that
gradient all-reduce, would scale the gradients by the world size.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import rng
from ..camera import Camera
from ..config import RenderConfig
from ..ops.trace import trace
from ..scene.flatten import SceneTables

RAY_AXIS = "rays"

# Scene arrays a differentiable render step takes gradients for.  "inv" is
# the per-node world->local transform table (the chain rule through the
# inverse is the caller's concern).
DIFF_FIELDS = (
    "mat_diffuse", "mat_specular", "mat_reflectivity", "mat_shininess",
    "light_color", "light_pos", "ambient", "inv",
)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = RAY_AXIS,
              device="cuda") -> DeviceMesh:
    """1-D mesh over the ranks of the job's process group, one device per
    rank.  The group comes first, from torchrun or
    ``parallel.initialize`` (``initialize(num_processes=1)`` for a single
    process); `n_devices`, where given, must equal its number of ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize() "
                           "first (initialize(num_processes=1) for a single process)")
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}, but the job has {world} ranks")
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=(axis_name,))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward passes the cotangent on
    unchanged (the loss of every rank is the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...]: every rank's `x`, in rank order.  Gloo's all_gather is
    documented for CPU tensors only, so a CUDA tensor goes through the
    host there."""
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().cpu() if stage else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def trace_sharded(mesh: DeviceMesh, key, o, d, pix, bg, n_pixels: int,
                  st: SceneTables, cfg: RenderConfig, w0=None, reduce: bool = True,
                  local: bool = False):
    """Trace rays [R,3] split over the mesh: rank r traces row block r
    (R/n rows) in one ``trace`` call keyed ``fold_in(key, r)``, its lanes'
    sample ids 0..R/n-1, as each device of the JAX package's shard_map
    does.  Returns the framebuffer sum [n_pixels, 3] over all rays, the
    same on every rank; with reduce=False the per-rank partials
    [n, n_pixels, 3] instead (no gradient).

    R must be divisible by the mesh size.  With local=True, o, d, pix and
    w0 hold only this rank's block (``make_global_rays``), so that the
    whole ray grid never exists on one rank."""
    n, r = mesh.size(), mesh.get_local_rank()
    if not local:
        R = o.shape[0]
        if R % n:
            raise ValueError(f"{R} rays do not split over {n} ranks: pad them")
        rows = slice(r * (R // n), (r + 1) * (R // n))
        o, d, pix = o[rows], d[rows], pix[rows]
        w0 = None if w0 is None else w0[rows]
    acc = trace(rng.fold_in(key, r), o, d, pix, bg, n_pixels, st, cfg, w0=w0)
    if reduce:
        return _AllReduceSum.apply(acc, mesh.get_group())
    return _all_gather(acc, mesh.get_group())


def split_params(st: SceneTables, fields=DIFF_FIELDS) -> Tuple[dict, SceneTables]:
    """Split the differentiable arrays out of the scene tables."""
    params = {f: getattr(st, f) for f in fields}
    return params, st


def train_step(mesh: DeviceMesh, key, o, d, pix, bg, n_pixels: int, spp: int, target,
               st: SceneTables, cfg: RenderConfig, fields=DIFF_FIELDS):
    """One differentiable render-and-fit step over the mesh:
    loss = MSE(acc / spp, target).  Returns (loss, {field: gradient}), the
    same on every rank and at every world size: backward through each
    rank's own rays, then one all-reduce (SUM) of the gradients.  o, d and
    pix as in trace_sharded."""
    params, _ = split_params(st, fields)
    leaves = {f: p.detach().clone().requires_grad_() for f, p in params.items()}
    acc = trace_sharded(mesh, key, o, d, pix, bg, n_pixels, st.replace(**leaves), cfg)
    loss = torch.mean((acc / spp - target) ** 2)
    loss.backward()
    grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves.values()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group())
    out, at = {}, 0
    for f, g in zip(leaves, grads):
        out[f] = flat[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    return loss.detach(), out


def _pixel_uv(width: int, height: int, dtype, device):
    """Background uv at integer pixels (render.rs:31-34), [P,2], formed in
    float64 and cast, as the JAX package's sharded renderers do."""
    ys, xs = np.mgrid[0:height, 0:width]
    uv = np.stack([xs.reshape(-1) / width, ys.reshape(-1) / height], axis=-1)
    return torch.tensor(uv, dtype=dtype, device=device)


def render_tiles_sharded(mesh: DeviceMesh, st: SceneTables, camera, size, background,
                         cfg: RenderConfig, key=None) -> np.ndarray:
    """Render a whole frame with the (pixel x sample) ray grid split over
    the mesh: the multi-device form of the reference's rayon pixel
    parallelism.  The jitter is the grid's ``uniform(fold_in(key, 0),
    (R, 2))`` (in float32, then cast to cfg.dtype); the grid is padded to
    a multiple of the mesh size with rays of zero throughput and traced
    keyed ``fold_in(key, 1)``.  Each rank builds only its own rows
    (``make_global_rays``).  Returns the linear mean-radiance image
    [H,W,3] (numpy, float64), the same on every rank."""
    from .distributed import make_global_rays

    width, height = size
    dev, dt = cfg.device, cfg.dtype
    cam = Camera(camera, (width, height), dev, dt)
    spp = cfg.resolved_samples()
    P_ = width * height
    R = P_ * spp
    key = rng.PRNGKey(cfg.seed) if key is None else key

    def make_shard(lo, hi):
        real = max(0, min(hi, R) - lo)
        pixn = torch.arange(lo, lo + real, device=dev) // spp
        jitter = rng.uniform(rng.fold_in(key, 0), (real, 2), dev, start=2 * lo).to(dt)
        o, d = cam.rays_at((pixn % width).to(dt) + jitter[:, 0],
                           (pixn // width).to(dt) + jitter[:, 1])
        # Padding rows carry zero throughput.
        fill = lambda x, v, shape: torch.cat(
            [x, torch.full(shape, v, dtype=x.dtype, device=dev)])
        pad = hi - lo - real
        return (fill(o, 0.0, (pad, 3)), fill(d, 1.0, (pad, 3)),
                fill(pixn.to(torch.int32), 0, (pad,)),
                fill(torch.ones((real,), dtype=dt, device=dev), 0.0, (pad,)))

    o, d, pix, w0 = make_global_rays(mesh, make_shard, R + (-R) % mesh.size(), device=dev)
    bg = background(_pixel_uv(width, height, dt, dev)).to(dt)
    acc = trace_sharded(mesh, rng.fold_in(key, 1), o, d, pix, bg, P_, st, cfg, w0=w0,
                        local=True)
    return acc.detach().to(torch.float64).cpu().numpy().reshape(height, width, 3) / spp
