"""Wavefront bounce loop (counterpart of ``portrayer_tpu/ops/trace.py``):
the reference's depth-10 recursion (ray.rs:139-148 -> material.rs ->
ray.rs) as rounds over ray queues.

A round: nearest-hit launch, hit detail, deferred shading, one any-hit
launch over every light's shadow rays, accumulation per pixel, and the
reflect/refract children packed by ``_compact`` into the next round's
queue.  Queues have the capacity schedule of ``RenderConfig.queue_caps``;
on overflow the lowest-throughput children end in the background colour
(exact for the reference's depth cut-off, which also returns the
background, material.rs:102-104) and their throughput is counted.

Where the JAX package switches between statically sized head slices of a
queue and scans the tail rounds, here each round runs on exactly its live
lanes: ``_compact`` keeps only those, in order, and reads their count on
the host (one host sync per round).  The loop ends at ``max_depth`` or
when no ray is alive.  Draws are keyed by sample id, so the slicing moves
no pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng
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
    sid: torch.Tensor       # [Q] int32 sample id of the counter-based draws
    #                         (primary: lane index; children 2*sid+{0,1})


class TraceStats(NamedTuple):
    """trace(..., with_stats=True): live [max_depth+1] int32 (on the host),
    the live rays entering each round; dropped_w, the live throughput ended
    by queue overflow as a fraction of the primary ray count; syncs, the
    host syncs of the live-count reads."""
    live: torch.Tensor
    dropped_w: float
    syncs: int


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


def _round_shade(q: _Queue, hit, acc, bg, st: SceneTables, cfg: RenderConfig, rkey,
                 is_last: bool, spp_c: int = 0):
    """Shade a round whose nearest hits are known: accumulates background
    (misses, and at the depth limit the children, material.rs:102-104) and
    ambient; returns (acc, child queue of size 2Q or, in the last round,
    None, deferred _Shadow batch)."""
    active = q.w > 0.0
    det = hit_detail(q.o, q.d, hit, st, cfg, q.t_min,
                     src_node=q.src_node, src_tri=q.src_tri)
    if spp_c:  # pixel-major primary queue: broadcast instead of gather
        bgc = bg[:, None, :].expand(acc.shape[0], spp_c, 3).reshape(-1, 3)
    else:
        bgc = bg[q.pix.long()]
    miss_w = torch.where(active & ~hit.hit, q.w, 0.0)
    shade_active = active & hit.hit
    pre, children = shade_pre(q.d, hit, det, st, cfg, rkey, shade_active, sid=q.sid)
    w_hit = q.w
    if cfg.soft_visibility > 0.0:
        # Soft silhouettes: the hit's energy is scaled by a coverage alpha
        # differentiable in the scene, and the complement goes to the
        # background.  The -3 shift puts the transition band inside the
        # silhouette: the jump left at the true edge is sigmoid(-3), ~5%.
        alpha = torch.sigmoid(det.margin / cfg.soft_visibility - 3.0)
        alpha = torch.where(shade_active & torch.isfinite(det.margin), alpha, 1.0)
        w_hit = q.w * alpha
        miss_w = miss_w + (q.w - w_hit)
    w_refl = w_hit * children.refl_mult
    w_refr = w_hit * children.refr_mult
    bg_w = miss_w + (w_refl + w_refr if is_last else 0.0)
    base = torch.where(shade_active[..., None], pre.base, 0.0)
    acc = _acc_add(acc, q.pix, bg_w[:, None] * bgc + w_hit[:, None] * base, spp_c)
    lc = torch.where(shade_active[None, :, None], w_hit[None, :, None] * pre.light_contrib,
                     0.0)
    shadow = _Shadow(o=det.point, dirs=pre.shadow_dir, need=pre.shadow_need, lc=lc,
                     t_eps=pre.t_eps, src_node=hit.node, src_tri=hit.tri, pix=q.pix)
    if is_last:
        return acc, None, shadow
    two = lambda a, b: torch.cat([a, b])
    child = _Queue(
        o=two(children.origin, children.origin), d=two(children.refl_dir, children.refr_dir),
        w=two(w_refl, w_refr), pix=two(q.pix, q.pix), t_min=two(pre.t_eps, pre.t_eps),
        src_node=two(hit.node, hit.node), src_tri=two(hit.tri, hit.tri),
        sid=two(2 * q.sid, 2 * q.sid + 1),
    )
    return acc, child, shadow


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


def _compact(child: _Queue, capacity: int, acc, bg):
    """Fit a child queue into `capacity` slots: (queue of its n_live live
    lanes, acc, dropped, n_live).  The live lanes keep their queue order
    (children are emitted pixel-major, so the next round's rays stay
    coherent).  If more than `capacity` lanes are live, the threshold is
    the capacity-th largest weight, ties fill first-come, and the lanes
    left out add their throughput times the background to acc and to
    `dropped` (a device scalar; 0.0 when the queue fits).  Dead lanes are
    never kept.  n_live is read on the host."""
    w = child.w
    dropped = 0.0
    if w.shape[0] <= capacity:
        take = w > 0.0
    else:
        kth = torch.topk(w, capacity).values[-1]
        take_gt = w > kth
        quota = capacity - take_gt.sum()
        eq = w == kth
        eq_rank = torch.cumsum(eq.to(torch.int32), dim=0)
        take = (take_gt | (eq & (eq_rank <= quota))) & (w > 0.0)
        dropped_w = torch.where(take, 0.0, w)
        pix = child.pix.long()
        acc = acc.index_add(0, pix, dropped_w[:, None] * bg[pix])
        dropped = dropped_w.sum()
    idx = torch.nonzero(take).squeeze(1)
    return _Queue(*(x[idx] for x in child)), acc, dropped, idx.shape[0]


def trace(key, o0, d0, pix0, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
          w0=None, spp_contiguous: int = 0, with_stats: bool = False):
    """Trace primary rays o0, d0 [R,3] with pixel ids pix0 [R], per-pixel
    background bg [P,3] and throughput w0 [R] (0 = dead lane); `key` seeds
    the per-round draws.  Returns acc [P,3], the per-pixel radiance sums
    (the caller divides by spp), and with with_stats also TraceStats.
    spp_contiguous > 0 asserts pix0 == repeat(arange(P), spp)."""
    R0 = o0.shape[0]
    dev = o0.device
    q = _Queue(
        o=o0, d=d0,
        w=torch.ones((R0,), dtype=o0.dtype, device=dev) if w0 is None else w0,
        pix=pix0,
        t_min=torch.full((R0,), cfg.epsilon, dtype=o0.dtype, device=dev),
        src_node=torch.full((R0,), -1, dtype=torch.int32, device=dev),
        src_tri=torch.full((R0,), -1, dtype=torch.int32, device=dev),
        sid=torch.arange(R0, dtype=torch.int32, device=dev),
    )
    acc = torch.zeros((n_pixels, 3), dtype=o0.dtype, device=dev)
    # Without a reflective material no ray has children: one round.
    max_depth = cfg.max_depth if st.any_reflective else 0

    caps = cfg.queue_caps
    if not caps:
        if cfg.queue_factor is not None:
            caps = (cfg.queue_factor,)
        else:
            caps = (4.0,) if st.any_refractive else (1.0,)
    caps = tuple(caps) + (caps[-1],) * max(0, max_depth - len(caps))
    cap_of = lambda r: max(int(round(R0 * caps[min(r, len(caps)) - 1])), 8)

    live = []  # live rays entering rounds 1.. (host ints)
    dropped = 0.0
    for ridx in range(max_depth + 1):
        spp_c = spp_contiguous if ridx == 0 else 0
        hit = _nearest(q, st, cfg)
        acc, child, sh = _round_shade(q, hit, acc, bg, st, cfg, rng.fold_in(key, ridx),
                                      is_last=ridx == max_depth, spp_c=spp_c)
        acc = _apply_shadows(sh, acc, st, cfg, spp_c)
        if ridx == max_depth:
            break
        q, acc, dr, n_live = _compact(child, cap_of(ridx + 1), acc, bg)
        dropped = dropped + dr
        live.append(n_live)
        if n_live == 0:
            break

    if not with_stats:
        return acc
    # Round 0's live count costs one more host sync, only here.
    lv = [int((w0 > 0.0).sum()) if w0 is not None else R0] + live
    lv = (lv + [0] * max_depth)[:max_depth + 1]
    return acc, TraceStats(live=torch.tensor(lv, dtype=torch.int32),
                           dropped_w=float(dropped) / R0, syncs=len(live))
