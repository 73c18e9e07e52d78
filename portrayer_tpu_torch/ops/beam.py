"""Ordered beam sweep (counterpart of ``portrayer_tpu/ops/beam.py``), the
vector-machine stand-in for the reference's kd-tree (src/kdtree/*).

  * Rays are grouped into warps of ``cfg.warp_size`` consecutive rays
    (coherent for primary and shadow rays); each warp carries interval
    bounds on its origins and directions.
  * For every (warp, primitive) pair one conservative interval slab test
    gives the least t at which the warp could enter the primitive's world
    AABB; impossible pairs get +inf.
  * Each warp's candidates are sorted by that entry t (stable, so ties
    keep index order, as ``jnp.argsort`` does) and swept front to back,
    ``cfg.beam_chunk`` at a time.  The sweep stops once every warp's next
    entry t lies beyond its current best hit (or is +inf): the early exit
    of ordered kd descent (kdtree/node.rs:132-199), per warp.

The JAX package lowers the walk through XLA with a ``lax.while_loop``;
here it is ``graphs.loop`` over a step index held on the device: its body
reads the step's candidates at that index (``index_select``), folds them
into the best-hit buffers in place and writes the next step's condition,
the count of warps that may still improve.  Inside a captured CUDA graph
the loop is a WHILE node and reads nothing on the host; op by op (the
CPU, ``cuda_graphs=False``) it reads its condition on the host once a
step.  The steps are counted on the device (``stats["trips"]``, and
``cuda_intersect.counts()["beam_step"]``, beside the sweep's calls,
``"beam_sweep"``).  Its winners are the flat
sweep's, up to ties and rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import graphs, math3d as m3
from ..config import RenderConfig
from ..scene.flatten import SceneTables, MESH
from . import cuda_intersect
from .intersect import Hit, INF, _ANALYTIC_CANDIDATES, _as_rays, triangle_candidate

BIGT = 3e38


def _pad_to(x, n, fill):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                    device=x.device)])


def _warp_entry_t(omin, omax, dmin, dmax, amin, amax):
    """Conservative entry t [W, N] of warps into AABBs: a lower bound on
    the t at which any ray of the warp can be inside the box, +inf where
    overlap is impossible for t >= 0.

    omin/omax/dmin/dmax: [W,3] warp origin and direction bounds; amin/amax:
    [N,3] boxes.  Per axis the warp reaches [omin + t*dmin, omax + t*dmax]
    at t >= 0; overlap with [amin, amax] needs dmin*t <= amax - omin and
    dmax*t >= amin - omax, each a one-sided bound on t by the sign of the
    direction bound."""
    W, N = omin.shape[0], amin.shape[0]
    t_lo = torch.zeros((W, N), dtype=omin.dtype, device=omin.device)
    t_hi = torch.full((W, N), BIGT, dtype=omin.dtype, device=omin.device)
    for a in range(3):
        A = amax[None, :, a] - omin[:, None, a]
        B = amin[None, :, a] - omax[:, None, a]
        dn = dmin[:, None, a]
        dx = dmax[:, None, a]
        # dn * t <= A
        hi1 = torch.where(dn > 0, A / torch.where(dn > 0, dn, 1.0), BIGT)
        lo1 = torch.where(dn < 0, A / torch.where(dn < 0, dn, 1.0), 0.0)
        empty1 = (dn == 0) & (A < 0)
        # dx * t >= B
        lo2 = torch.where(dx > 0, B / torch.where(dx > 0, dx, 1.0), 0.0)
        hi2 = torch.where(dx < 0, B / torch.where(dx < 0, dx, 1.0), BIGT)
        empty2 = (dx == 0) & (B > 0)
        t_lo = torch.maximum(t_lo, torch.maximum(lo1, lo2))
        t_hi = torch.minimum(t_hi, torch.minimum(hi1, hi2))
        t_hi = torch.where(empty1 | empty2, -1.0, t_hi)
    possible = t_lo <= t_hi
    # A small slack for f32 rounding.
    t_enter = torch.clamp(t_lo - 1e-3 * (torch.abs(t_lo) + 1.0), min=0.0)
    return torch.where(possible, t_enter, INF)


def _local(inv, o_w, d_w):
    """Warp rays [W,w,3] into the frames inv [W,C,3,4] of a warp's
    candidates: (lo, ld) [W,w,C,3], mul+add in the flat sweep's order."""
    m = inv[:, None]                                   # [W,1,C,3,4]
    oo = o_w[:, :, None, None, :]                      # [W,w,1,1,3]
    dd = d_w[:, :, None, None, :]
    ld = m[..., 0] * dd[..., 0] + m[..., 1] * dd[..., 1] + m[..., 2] * dd[..., 2]
    lo = m[..., 0] * oo[..., 0] + m[..., 1] * oo[..., 1] + m[..., 2] * oo[..., 2] + m[..., 3]
    return lo, ld


@torch.no_grad()
def intersect_scene_beam(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
                         active=None, src_node=None, src_tri=None,
                         stats: Optional[dict] = None) -> Hit:
    """Beam-sweep nearest hit; the contract of ``intersect_scene``.  Needs
    unit ray directions (t = world distance), as the renderer makes them.
    A dict `stats` receives "trips", the steps of the ordered sweeps (a
    0-d int64 on the rays' device, added to what it held)."""
    R0 = o.shape[0]
    dt, dev = o.dtype, o.device
    w = cfg.warp_size
    W = -(-R0 // w)
    R = W * w

    t_min = _as_rays(t_min, R0, o)
    t_max = _as_rays(t_max, R0, o)
    if active is None:
        active = torch.ones((R0,), dtype=torch.bool, device=dev)
    if src_node is None:
        src_node = torch.full((R0,), -1, dtype=torch.int32, device=dev)
    if src_tri is None:
        src_tri = torch.full((R0,), -1, dtype=torch.int32, device=dev)

    o_w = _pad_to(o, R, 0.0).reshape(W, w, 3)
    d_w = _pad_to(d, R, 1.0).reshape(W, w, 3)
    act_w = _pad_to(active, R, False).reshape(W, w)
    tmin_w = _pad_to(t_min, R, 1.0).reshape(W, w)
    tmax_w = _pad_to(t_max, R, 0.0).reshape(W, w)
    src_w = _pad_to(src_node, R, -1).reshape(W, w)
    srct_w = _pad_to(src_tri, R, -1).reshape(W, w)

    lanes = act_w[..., None]
    omin = torch.where(lanes, o_w, BIGT).amin(dim=1)                 # [W,3]
    omax = torch.where(lanes, o_w, -BIGT).amax(dim=1)
    dmin = torch.where(lanes, d_w, BIGT).amin(dim=1)
    dmax = torch.where(lanes, d_w, -BIGT).amax(dim=1)
    # Warps without an active lane: bounds that meet nothing.
    any_active = act_w.any(dim=1)[:, None]
    omin = torch.where(any_active, omin, BIGT)
    omax = torch.where(any_active, omax, -BIGT)
    dmin = torch.where(any_active, dmin, 0.0)
    dmax = torch.where(any_active, dmax, 0.0)

    C = cfg.beam_chunk
    eps = cfg.epsilon
    use_src = cfg.self_eps_local > 0.0
    i64 = dict(dtype=torch.int64, device=dev)
    trips = torch.zeros((), **i64)
    cols = torch.arange(C, **i64)

    def eff_t_min(ld, is_src):
        base = tmin_w[:, :, None]
        if not use_src:
            return base
        t_self = cfg.self_eps_local / torch.clamp(torch.sqrt(m3.dot(ld, ld)), min=1e-30)
        return torch.where(is_src, torch.maximum(base, t_self), base)

    def warp_ub(bt):
        lane_ub = torch.where(act_w, torch.minimum(bt, tmax_w), 0.0)
        return lane_ub.amax(dim=1)                                   # [W]

    def ordered_sweep(carry, t_enter, pick_tables, is_pairs):
        """Sweep each warp's candidates in entry-t order, C a step, until
        no warp's next candidate can beat its best hit: graphs.loop over
        the step index ci, the carry's buffers updated in place."""
        bt, bn, btr = carry
        n = t_enter.shape[1]
        n_pad = max(C, -(-n // C) * C)
        order = torch.argsort(t_enter, dim=1, stable=True)          # [W,N]
        te_sorted = torch.gather(t_enter, 1, order)
        order = F.pad(order, (0, n_pad - n), value=0)
        # One column of inf past the last step: the condition written after
        # it reads there.
        te_sorted = F.pad(te_sorted, (0, n_pad + 1 - n), value=INF)
        ci = torch.zeros((), **i64)
        live = torch.zeros((), **i64)

        def set_live(step):
            """live = the warps whose candidates at `step` may still beat
            their best hit; isfinite: an exhausted warp (start_t = inf)
            stops even where its bound is inf too (a warp that has hit
            nothing)."""
            start_t = te_sorted.index_select(1, (step * C).reshape(1))[:, 0]
            live.copy_((torch.isfinite(start_t) & (start_t <= warp_ub(bt))).sum())

        def body():
            at = ci * C + cols
            ids = order.index_select(1, at)                          # [W,C]
            valid = torch.isfinite(te_sorted.index_select(1, at))
            t, node_ids, tri_ids = pick_tables(ids, valid)           # t [W,w,C]
            tj, j = torch.min(t, dim=2)                              # first minimum
            better = tj < bt
            pick = lambda arr: torch.gather(arr[:, None, :].expand(W, w, arr.shape[1]), 2,
                                            j[..., None])[..., 0]
            bn.copy_(torch.where(better, pick(node_ids), bn))
            if is_pairs:
                btr.copy_(torch.where(better, pick(tri_ids), btr))
            bt.copy_(torch.where(better, tj, bt))
            trips.add_(1)
            set_live(ci + 1)

        set_live(ci)
        graphs.loop(ci, n_pad // C, live, body)

    carry = (torch.full((W, w), INF, dtype=dt, device=dev),
             torch.full((W, w), -1, dtype=torch.int32, device=dev),
             torch.full((W, w), -1, dtype=torch.int32, device=dev))

    for kind, start, count in st.groups:
        if kind == MESH or count == 0:
            continue
        t_enter = _warp_entry_t(omin, omax, dmin, dmax, st.aabb_min[start:start + count],
                                st.aabb_max[start:start + count])
        cand_fn = _ANALYTIC_CANDIDATES[kind]

        def pick_nodes(ids, valid, start=start, cand_fn=cand_fn):
            gids = ids + start                                       # [W,C]
            lo, ld = _local(st.inv[gids], o_w, d_w)
            prm = st.prim_params[gids][:, None]                      # [W,1,C,2]
            is_src = gids[:, None, :] == src_w[:, :, None]
            t = cand_fn(lo, ld, eff_t_min(ld, is_src), tmax_w[:, :, None], eps, params=prm)
            t = torch.where(valid[:, None, :] & act_w[:, :, None], t, INF)
            return t, gids.to(torch.int32), None

        ordered_sweep(carry, t_enter, pick_nodes, is_pairs=False)

    if any(kind == MESH and count > 0 for kind, _, count in st.groups) and st.n_pairs > 0:
        t_enter = _warp_entry_t(omin, omax, dmin, dmax, st.pair_aabb_min, st.pair_aabb_max)

        def pick_pairs(ids, valid):
            node_ix = st.pair_node[ids]                              # [W,C]
            tri_ix = st.pair_tri[ids]
            lo, ld = _local(st.inv[node_ix.long()], o_w, d_w)
            tl = tri_ix.long()
            a, b, c = (x[tl][:, None] for x in (st.tri_a, st.tri_b, st.tri_c))
            is_src = ((node_ix[:, None, :] == src_w[:, :, None])
                      & (tri_ix[:, None, :] == srct_w[:, :, None]))
            t = triangle_candidate(lo, ld, a, b, c, eff_t_min(ld, is_src),
                                   tmax_w[:, :, None])[0]
            t = torch.where(valid[:, None, :] & act_w[:, :, None], t, INF)
            return t, node_ix, tri_ix

        ordered_sweep(carry, t_enter, pick_pairs, is_pairs=True)

    cuda_intersect.count_on_device(dev, "beam_sweep")
    cuda_intersect.count_on_device(dev, "beam_step", trips)
    if stats is not None:
        stats["trips"] = stats.get("trips", 0) + trips
    best_t, best_node, best_tri = (x.reshape(R)[:R0] for x in carry)
    hit = torch.isfinite(best_t) & active
    neg = torch.full_like(best_node, -1)
    return Hit(t=best_t, node=torch.where(hit, best_node, neg),
               tri=torch.where(hit, best_tri, neg), hit=hit)
