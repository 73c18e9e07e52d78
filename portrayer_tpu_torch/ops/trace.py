"""Wavefront trace (counterpart of ``portrayer_tpu/ops/trace.py``) at
depth 0: the round of primary rays, which is all the JAX package runs for
scenes whose materials do not reflect, and for mirrors at
``max_depth == 0``.

One round: nearest-hit launch, hit detail, deferred shading, then one
any-hit launch over every light's shadow rays, accumulated per pixel.
Bounce rounds and queue compaction are a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..scene.flatten import SceneTables
from .intersect import intersect_scene, hit_detail, occluded
from .shade import shade_pre


class _Queue(NamedTuple):
    o: torch.Tensor         # [Q,3]
    d: torch.Tensor         # [Q,3]
    w: torch.Tensor         # [Q] throughput
    pix: torch.Tensor       # [Q] int32 pixel index
    t_min: torch.Tensor     # [Q] per-ray t-range start
    src_node: torch.Tensor  # [Q] int32 node the ray left (-1 primary)
    src_tri: torch.Tensor   # [Q] int32 triangle the ray left


class _Shadow(NamedTuple):
    """Deferred per-round shadow batch: L lights cost one launch."""
    o: torch.Tensor         # [R,3] hit points
    dirs: torch.Tensor      # [L,R,3]
    need: torch.Tensor      # [L,R] lanes whose light contribution != 0
    lc: torch.Tensor        # [L,R,3] throughput-weighted light contribs
    t_eps: torch.Tensor     # [R]
    src_node: torch.Tensor  # [R]
    src_tri: torch.Tensor   # [R]
    pix: torch.Tensor       # [R]


def _acc_add(acc, pix, x, spp_c: int):
    """acc[pix] += x; a pixel-major queue with spp_c samples per pixel sums
    by reshape instead of scatter."""
    if spp_c:
        return acc + x.reshape(acc.shape[0], spp_c, x.shape[-1]).sum(dim=1)
    return acc.index_add(0, pix.long(), x)


def _nearest(q: _Queue, st, cfg):
    return intersect_scene(q.o, q.d, q.t_min, float("inf"), st, cfg, active=q.w > 0.0,
                           src_node=q.src_node, src_tri=q.src_tri)


def _round_shade(q: _Queue, hit, acc, bg, st: SceneTables, cfg: RenderConfig,
                 spp_c: int = 0):
    """Shade the last round, whose nearest hits are known: accumulates
    background (misses, and the reflections cut off at the depth limit,
    material.rs:102-104) and ambient; returns (acc, deferred _Shadow
    batch)."""
    active = q.w > 0.0
    det = hit_detail(q.o, q.d, hit, st, cfg, q.t_min,
                     src_node=q.src_node, src_tri=q.src_tri)
    if spp_c:  # pixel-major primary queue: broadcast instead of gather
        bgc = bg[:, None, :].expand(acc.shape[0], spp_c, 3).reshape(-1, 3)
    else:
        bgc = bg[q.pix.long()]
    miss_w = torch.where(active & ~hit.hit, q.w, 0.0)
    shade_active = active & hit.hit
    pre, children = shade_pre(q.d, hit, det, st, cfg, shade_active)
    bg_w = miss_w + (q.w * children.refl_mult + q.w * children.refr_mult)
    base = torch.where(shade_active[..., None], pre.base, 0.0)
    acc = _acc_add(acc, q.pix, bg_w[:, None] * bgc + q.w[:, None] * base, spp_c)
    lc = torch.where(shade_active[None, :, None], q.w[None, :, None] * pre.light_contrib,
                     0.0)
    shadow = _Shadow(o=det.point, dirs=pre.shadow_dir, need=pre.shadow_need, lc=lc,
                     t_eps=pre.t_eps, src_node=hit.node, src_tri=hit.tri, pix=q.pix)
    return acc, shadow


def _apply_shadows(shadow: _Shadow, acc, st, cfg, spp_c: int):
    """One any-hit launch over the L x R shadow rays, then accumulate the
    unoccluded light contributions."""
    L = shadow.dirs.shape[0]
    R = shadow.o.shape[0]
    if L == 0:
        return acc
    tile = lambda x: x.repeat((L,) + (1,) * (x.dim() - 1))
    occ = occluded(
        tile(shadow.o), shadow.dirs.reshape(L * R, 3), tile(shadow.t_eps),
        float("inf"), st, cfg, active=shadow.need.reshape(L * R),
        src_node=tile(shadow.src_node), src_tri=tile(shadow.src_tri),
    ).reshape(L, R)
    light = torch.where(occ[..., None], 0.0, shadow.lc).sum(dim=0)
    return _acc_add(acc, shadow.pix, light, spp_c)


def trace(o0, d0, pix0, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
          w0=None, spp_contiguous: int = 0):
    """Trace primary rays o0, d0 [R,3] with pixel ids pix0 [R], per-pixel
    background bg [P,3] and throughput w0 [R] (0 = dead lane).  Returns
    acc [P,3], the per-pixel radiance sums (the caller divides by spp).
    spp_contiguous > 0 asserts pix0 == repeat(arange(P), spp)."""
    # Without a reflective material no ray has children: the JAX package
    # collapses such scenes to round 0 whatever cfg.max_depth says.
    if st.any_reflective and cfg.max_depth > 0:
        raise NotImplementedError("bounce rounds: later slice")
    R0 = o0.shape[0]
    dev = o0.device
    q = _Queue(
        o=o0, d=d0,
        w=torch.ones((R0,), dtype=o0.dtype, device=dev) if w0 is None else w0,
        pix=pix0,
        t_min=torch.full((R0,), cfg.epsilon, dtype=o0.dtype, device=dev),
        src_node=torch.full((R0,), -1, dtype=torch.int32, device=dev),
        src_tri=torch.full((R0,), -1, dtype=torch.int32, device=dev),
    )
    acc = torch.zeros((n_pixels, 3), dtype=o0.dtype, device=dev)
    hit = _nearest(q, st, cfg)
    acc, sh = _round_shade(q, hit, acc, bg, st, cfg, spp_c=spp_contiguous)
    return _apply_shadows(sh, acc, st, cfg, spp_contiguous)
