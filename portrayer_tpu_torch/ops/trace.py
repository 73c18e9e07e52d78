"""Wavefront bounce loop (counterpart of ``portrayer_tpu/ops/trace.py``):
the reference's depth-10 recursion (ray.rs:139-148 -> material.rs ->
ray.rs) as rounds over ray queues.

A round: nearest-hit launch, hit detail, deferred shading, one any-hit
launch over every light's shadow rays, accumulation per pixel, and the
reflect/refract children packed by ``_compact`` into the next round's
queue.  On the card a round that autograd never sees does the work
between the sweeps in two kernels (``ops/cuda_round.py``); the chain of
ops here is their plain version (``_round``).  Queues have the JAX package's static shapes: a capacity per round
from ``RenderConfig.queue_caps``, the live lanes compacted in order to the
front and the dead slots filled with fixed values.  On overflow the
lowest-throughput children end in the background colour (exact for the
reference's depth cut-off, which also returns the background,
material.rs:102-104) and their throughput is counted.

Round 0 runs on the primary lanes.  A later round runs on the smallest
head slice of its queue that holds the live rays (``slice_sizes``, from
``RenderConfig.queue_slice_divs``), or not at all when none is alive: the
JAX package's ``lax.switch`` over the same slices.  ``first_round`` and
``bounce_round`` read nothing on the host, and ``slice_sel`` picks the
slice on the device, so a render or a fit captures a whole trace as one
CUDA graph whose rounds' slices are conditional bodies (``graphs.switch``;
render.py, fit.py), the rounds of the tail of equal capacity but the
last one loop (``tail_start``, ``rounds``; ``graphs.loop``, the JAX
package's ``lax.scan``); ``trace`` runs the rounds op by op and reads the
live count once per bounce round to pick the slice (``pick_slice``).
Draws are keyed by sample id, so the slicing moves no pixel.

Under autograd each round runs under a checkpoint, as the JAX package
runs it under ``jax.checkpoint`` saving only the sweep outputs: round 0
always, a bounce round on k lanes when k >= ``cfg.remat_min_lanes``.  The
round's sweep results are kept (``_Sweeps``); its hit detail, shading,
light sum and compaction are replayed in backward from its queue and
those results, and no sweep is launched again.  On the card with
``cfg.cuda_graphs`` (any accel) a differentiable trace replays the
fit program of ``portrayer_tpu_torch/fit.py`` instead: the same rounds,
forward and backward, as captured CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import sys
import types
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from .. import rng
from . import cuda_round
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


# _zero_queue's values of a dead slot (the JAX package's trace).
_FILL = {"o": 0.0, "d": 1.0, "w": 0.0, "pix": 0, "t_min": 1.0, "src_node": -1,
         "src_tri": -1, "sid": 0}


class TraceStats(NamedTuple):
    """trace(..., with_stats=True): live [max_depth+1] int32 (on the host),
    the live rays entering each round; dropped_w, the live throughput ended
    by queue overflow as a fraction of the primary ray count; syncs, the
    host syncs of the live-count reads; lanes [max_depth+1] int32 (on the
    host), the lanes each round ran on (launched_lanes; 0 where it did not
    run); refr [max_depth+1] int32 (on the host), the refracted children
    among the live rays entering each round (``refracted``; counted on the
    device only where the scene has a refractive material, zeros
    elsewhere; None where the trace does not count them, the fit
    program's)."""
    live: torch.Tensor
    dropped_w: float
    syncs: int
    lanes: torch.Tensor
    refr: Optional[torch.Tensor] = None


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


class _Sweeps:
    """A round's sweep results in launch order (its nearest hits, then its
    occlusion bits): launched and kept on the round's first run, read back
    on its replays, so that a checkpoint's recompute in backward launches
    no sweep.  The counterpart of the JAX package's "sweep_oracle"
    residuals (its trace.py ``_REMAT_POLICY``).  `kept` starts it with
    results kept elsewhere (the fit program's state slabs)."""

    def __init__(self, kept=()):
        self.kept, self.at = list(kept), 0

    def run(self, body):
        """body(self): the round, launching its sweeps through self."""
        self.at = 0
        return body(self)

    def __call__(self, launch):
        if self.at < len(self.kept):
            out = self.kept[self.at]
        else:
            out = launch()
            self.kept.append(out)
        self.at += 1
        return out


def _records(st: SceneTables, *tensors) -> bool:
    """Whether autograd records a round over tables `st` and `tensors`."""
    if not torch.is_grad_enabled():
        return False
    return (any(t is not None and t.requires_grad for t in tensors)
            or bool(grad_fields(st)))


# Derived or static fields of SceneTables: never a fit's parameters.
_NOT_PARAMS = ("rec", "trec", "packed", "chunk_programs")


def grad_fields(st: SceneTables) -> tuple:
    """The tensor fields of `st` that require grad (rec and trec, derived
    from them, aside)."""
    return tuple(f.name for f in dataclasses.fields(st)
                 if f.name not in _NOT_PARAMS
                 and isinstance(getattr(st, f.name), torch.Tensor)
                 and getattr(st, f.name).requires_grad)


def _remat(st, k, cfg: RenderConfig, *tensors) -> bool:
    """Whether a round of k lanes (None: round 0) runs checkpointed: when
    autograd records it and k >= cfg.remat_min_lanes (round 0 always)."""
    return _records(st, *tensors) and (k is None or k >= cfg.remat_min_lanes)


def _checkpointed(body, remat: bool):
    """Run a round, body(sweeps), with a fresh _Sweeps: under a
    non-reentrant checkpoint with `remat`, else directly."""
    sweeps = _Sweeps()
    if remat:
        return torch.utils.checkpoint.checkpoint(sweeps.run, body, use_reentrant=False,
                                                 preserve_rng_state=False)
    return sweeps.run(body)


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


def _apply_shadows(shadow: _Shadow, acc, st, cfg, spp_c: int, sweeps):
    """One any-hit launch over the L x R shadow rays, then accumulate the
    unoccluded light contributions."""
    L = shadow.dirs.shape[0]
    R = shadow.o.shape[0]
    if L == 0:
        return acc
    tile = lambda x: x.repeat((L,) + (1,) * (x.dim() - 1))
    occ = sweeps(lambda: occluded(
        tile(shadow.o), shadow.dirs.reshape(L * R, 3), tile(shadow.t_eps),
        float("inf"), st, cfg, active=shadow.need.reshape(L * R),
        src_node=tile(shadow.src_node), src_tri=tile(shadow.src_tri),
    )).reshape(L, R)
    light = torch.where(occ[..., None], 0.0, shadow.lc).sum(dim=0)
    return _acc_add(acc, shadow.pix, light, spp_c)


def _compact(child: _Queue, capacity: int, acc, bg):
    """Fit a child queue into `capacity` slots, as the JAX package's
    _compact does: (queue [capacity], acc, dropped, n_live).  The live lanes
    keep their queue order at the front (children are emitted pixel-major,
    so the next round's rays stay coherent); the dead slots hold
    _zero_queue's values.  If the queue has more lanes than `capacity`, the
    threshold is the capacity-th largest weight, ties fill first-come, and
    the live lanes left out add their throughput times the background to
    acc and to `dropped`.  dropped and n_live (int64) are device scalars:
    nothing is read on the host."""
    w = child.w
    dropped = torch.zeros((), dtype=w.dtype, device=w.device)
    take = take_flags(w, capacity)
    if w.shape[0] > capacity:
        dropped_w = torch.where(take, 0.0, w)
        pix = child.pix.long()
        acc = acc.index_add(0, pix, dropped_w[:, None] * bg[pix])
        dropped = dropped_w.sum()
    # Stable compaction: row i goes to slot (#takes before i); the rest to
    # a trash slot past the end.
    pos = torch.cumsum(take.to(torch.int64), dim=0)
    tgt = torch.where(take, pos - 1, capacity)

    def place(x, fill):
        out = torch.full((capacity + 1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
        return out.index_copy_(0, tgt, x)[:capacity]

    q = _Queue(*(place(x, _FILL[f]) for f, x in zip(_Queue._fields, child)))
    return q, acc, dropped, pos[-1]


def take_flags(w, capacity: int):
    """Which of the children of throughput `w` a queue of `capacity` lanes
    takes (bool): the live ones (w > 0) or, where they may outnumber it,
    those above the capacity-th largest weight, and of those equal to it
    as many as are left, first come first."""
    if w.shape[0] <= capacity:
        return w > 0.0
    kth = torch.topk(w, capacity).values[-1]
    take_gt = w > kth
    quota = capacity - take_gt.sum()
    eq = w == kth
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=0)
    return (take_gt | (eq & (eq_rank <= quota))) & (w > 0.0)


def refracted(sid: torch.Tensor) -> torch.Tensor:
    """How many of the live lanes of a head slice of a queue that
    ``_compact`` left are refracted children, from the slice's sample ids
    `sid`, as an int32 device scalar: a refracted child's sample id is odd
    (2 * sid + 1), and a dead slot holds sid 0 (_FILL)."""
    return (sid & 1).sum(dtype=torch.int32)


def slice_sizes(capacity: int, divs) -> tuple:
    """The head slices a round on a queue of `capacity` lanes can run on:
    capacity // div rounded up to a multiple of 2048 (at most capacity),
    div 1 always among them, sorted (the JAX package's round_r)."""
    sizes = []
    for div in tuple(divs) + (1,):
        k = min(capacity, -(-capacity // div // 2048) * 2048)
        if k not in sizes:
            sizes.append(k)
    return tuple(sorted(sizes))


def pick_slice(sizes, n_live: int) -> int:
    """The smallest of `sizes` that holds n_live lanes; 0 (the dead branch)
    when none is alive."""
    if n_live <= 0:
        return 0
    return next(k for k in sizes if k >= n_live)


def slice_sel(n_live: torch.Tensor, sizes) -> torch.Tensor:
    """pick_slice on the device, as the JAX package's round_r picks its
    lax.switch branch: 0 (the dead branch) where n_live is 0, else 1 + the
    searchsorted index of n_live in `sizes` (sizes[sel - 1] is the slice).
    An int64 tensor of n_live's shape; nothing is read on the host."""
    sel = (n_live > 0).to(torch.int64)
    for k in sizes:
        sel = sel + (n_live > k).to(torch.int64)
    return sel


def tail_start(pl: Plan) -> int:
    """The first round of the tail of equal capacity, the JAX package's
    rule (its trace.py, before its lax.scan): the first round whose
    capacity is the last round's, never round 0."""
    r = pl.max_depth
    while r > 1 and pl.cap[r - 1] == pl.cap[pl.max_depth]:
        r -= 1
    return r


def at_round(x, ridx):
    """x[ridx], ridx a round's index: an int, or in a captured program's
    loop a 0-d index on the device."""
    return x[ridx] if isinstance(ridx, int) else x.index_select(0, ridx.reshape(1))[0]


def set_at_round(x, ridx, y):
    """x[ridx] = y, ridx as in at_round."""
    if isinstance(ridx, int):
        x[ridx].copy_(y)
    else:
        x.index_copy_(0, ridx.reshape(1), y.reshape((1,) + x.shape[1:]))


class Round(NamedTuple):
    """A bounce round's static shape: its index r, the capacity of the
    queue it runs on, the head slices it can run on, the capacity of its
    children's queue (None after the last round), whether it is the last
    and whether a captured program runs it in its tail loop."""
    r: int
    cap: int
    sizes: tuple
    next_cap: "int | None"
    last: bool
    looped: bool


def rounds(pl: Plan, divs, loop: bool = False):
    """The Round of each bounce round r = 1.. max_depth.  With `loop`, the
    rounds from tail_start(pl) up to the last one, the last aside, are
    `looped`: a captured program runs them as one loop over a round index
    on the device (graphs.loop); the others are unrolled."""
    first = tail_start(pl) if loop else pl.max_depth
    for ridx in range(1, pl.max_depth + 1):
        last = ridx == pl.max_depth
        yield Round(ridx, pl.cap[ridx], slice_sizes(pl.cap[ridx], divs),
                    None if last else pl.cap[ridx + 1], last, first <= ridx < pl.max_depth)


def round_shapes(pl: Plan, divs, loop: bool = False):
    """The first Round of each distinct shape of a bounce round's step (its
    capacity, head slice of k lanes, next capacity, whether it is the last
    and whether it is looped) and that k: what a program warms before it
    captures them all."""
    seen = set()
    for rd in rounds(pl, divs, loop):
        for k in rd.sizes:
            shape = (rd.cap, k, rd.next_cap, rd.last, rd.looped)
            if shape not in seen:
                seen.add(shape)
                yield rd, k


def launched_lanes(pl: Plan, divs, live) -> torch.Tensor:
    """TraceStats.lanes of traces on the plan `pl` from their live counts
    (live [..., max_depth+1] on the host, live[..., r] entering round r):
    round 0 ran on its cap[0] primary lanes, bounce round r on the slice
    that slice_sel picks from live[..., r], 0 where it picks the dead
    branch.  Host arithmetic on counts already read."""
    live = torch.as_tensor(live, dtype=torch.int64)
    lanes = torch.zeros_like(live)
    lanes[..., 0] = pl.cap[0]
    for rd in rounds(pl, divs):
        slices = torch.tensor((0, *rd.sizes), dtype=torch.int64)
        lanes[..., rd.r] = slices[slice_sel(live[..., rd.r], rd.sizes)]
    return lanes.to(torch.int32)


def bounce_rounds(pl: Plan, divs, read_live):
    """The bounce rounds of a trace run op by op: for each round, read_live()
    reads the live count entering it on the host (one read a round) and,
    unless it is 0 (the dead branch: no later round runs), (r, k, next_cap,
    is_last) is yielded, k the head slice it runs on and next_cap the
    capacity of its children's queue (None after the last round)."""
    for ridx, _, sizes, next_cap, last, _ in rounds(pl, divs):
        n = read_live()
        if n == 0:
            return
        yield ridx, pick_slice(sizes, n), next_cap, last


class Plan(NamedTuple):
    """A trace's static shape: the last round and each round's capacity
    (cap[r] lanes in round r's queue, r >= 1)."""
    max_depth: int
    cap: tuple


def plan(R0: int, st: SceneTables, cfg: RenderConfig) -> Plan:
    # Without a reflective material no ray has children: one round.
    max_depth = cfg.max_depth if st.any_reflective else 0
    caps = cfg.queue_caps
    if not caps:
        if cfg.queue_factor is not None:
            caps = (cfg.queue_factor,)
        else:
            caps = (4.0,) if st.any_refractive else (1.0,)
    caps = tuple(caps) + (caps[-1],) * max(0, max_depth - len(caps))
    cap = (R0,) + tuple(max(int(round(R0 * caps[min(r, len(caps)) - 1])), 8)
                        for r in range(1, max_depth + 1))
    return Plan(max_depth, cap)


def primary_queue(o0, d0, pix0, w0, cfg: RenderConfig) -> _Queue:
    R0 = o0.shape[0]
    dev = o0.device
    return _Queue(
        o=o0, d=d0,
        w=torch.ones((R0,), dtype=o0.dtype, device=dev) if w0 is None else w0,
        pix=pix0,
        t_min=torch.full((R0,), cfg.epsilon, dtype=o0.dtype, device=dev),
        src_node=torch.full((R0,), -1, dtype=torch.int32, device=dev),
        src_tri=torch.full((R0,), -1, dtype=torch.int32, device=dev),
        sid=torch.arange(R0, dtype=torch.int32, device=dev),
    )


def _round(rkey, q: _Queue, acc, bg, st: SceneTables, cfg: RenderConfig, is_last: bool,
           next_cap, spp_c: int, sweeps, n_pixels: int = 0, out=None, plain: bool = False):
    """A round on queue q (as it runs, sliced): the nearest-hit sweep,
    shading, the any-hit sweep, the accumulation and, unless it is the
    last, the compaction of its children into next_cap lanes: (acc, queue
    or None, dropped or None, n_live or None).  Its sweeps go through
    `sweeps` (a _Sweeps).  acc None starts a fresh one of n_pixels.

    Where ``cuda_round.takes_kernels`` says so (a float32 round on the
    card that autograd never has to see), the lane work is two kernels
    (``cuda_round.round_``): the next queue is then written into `out`
    where given, a round with acc adds to it in place, and dropped is
    None where no child can be dropped.  Elsewhere, and with `plain` (the
    fit program's forward, whose backward replays its rounds' ops under
    autograd on tables that require grad), it is the plain chain below."""
    inputs_grad = any(x is not None and x.requires_grad for x in (*q, acc, bg))
    if not plain and cuda_round.takes_kernels(q.o.device.type, q.o.dtype, grad_fields(st),
                                              cfg.soft_visibility, st.fn_textures,
                                              inputs_grad):
        q = _Queue(*(x.contiguous() for x in q))
        return cuda_round.round_(rkey, q, acc, bg.contiguous(), st, cfg, is_last, next_cap,
                                 spp_c, sweeps, n_pixels, out)
    if q.o.is_cuda:
        cuda_round.COUNTS["plain_rounds_cuda"] += 1
    if acc is None:
        acc = torch.zeros((n_pixels, 3), dtype=q.o.dtype, device=q.o.device)
    hit = sweeps(lambda: _nearest(q, st, cfg))
    acc, child, sh = _round_shade(q, hit, acc, bg, st, cfg, rkey, is_last=is_last, spp_c=spp_c)
    acc = _apply_shadows(sh, acc, st, cfg, spp_c, sweeps)
    if is_last:
        return acc, None, None, None
    q, acc, dropped, n_live = _compact(child, next_cap, acc, bg)
    return acc, q, dropped, n_live


def first_round(rkey, q: _Queue, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
                pl: Plan, spp_c: int = 0, sweeps=None, out=None, plain: bool = False):
    """Round 0 on the primary queue, its draws keyed rkey (the trace key
    folded with 0): (acc [P,3], the queue of round 1 or None without
    bounces, dropped, n_live), the last two device scalars (dropped None
    where the kernels run and drop nothing).  Under autograd it runs
    checkpointed (the module docstring); `sweeps` (a _Sweeps) runs it
    directly, the fit program's way.  `out`: the round-1 queue's buffers,
    which the kernels fill; `plain`: the plain chain (_round)."""
    is_last = pl.max_depth == 0
    next_cap = None if is_last else pl.cap[1]

    def body(sw):
        return _round(rkey, q, None, bg, st, cfg, is_last, next_cap, spp_c, sw, n_pixels, out,
                      plain)

    if sweeps is not None:
        return sweeps.run(body)
    return _checkpointed(body, _remat(st, None, cfg, q.o, q.d, q.w, bg))


def bounce_round(rkey, q: _Queue, acc, bg, st: SceneTables, cfg: RenderConfig, k: int,
                 next_cap: int, is_last: bool, sweeps=None, out=None, plain: bool = False):
    """A bounce round, its draws keyed rkey (the trace key folded with the
    round's index), on the head slice of k lanes of its queue: (acc, the
    queue of next_cap lanes of the next round or, after the last round,
    None, dropped, n_live).  Under autograd it runs checkpointed when k >=
    cfg.remat_min_lanes; `sweeps` (a _Sweeps) runs it directly, the fit
    program's way.  Where the kernels run (_round; not with `plain`) it
    adds to acc in place and fills `out`, the next queue's buffers, where
    given."""
    q = _Queue(*(x[:k] for x in q))
    remat = sweeps is None and _remat(st, k, cfg, q.o, q.d, q.w, q.t_min, acc, bg)
    if remat:
        # The checkpoint keeps its inputs: the k lanes, not the queue.
        q = _Queue(*(x.clone() for x in q))

    def body(sw):
        return _round(rkey, q, acc, bg, st, cfg, is_last, next_cap, 0, sw, out=out,
                      plain=plain)

    if sweeps is not None:
        return sweeps.run(body)
    return _checkpointed(body, remat)


def trace(key, o0, d0, pix0, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
          w0=None, spp_contiguous: int = 0, with_stats: bool = False):
    """Trace primary rays o0, d0 [R,3] with pixel ids pix0 [R], per-pixel
    background bg [P,3] and throughput w0 [R] (0 = dead lane); `key` seeds
    the per-round draws.  Returns acc [P,3], the per-pixel radiance sums
    (the caller divides by spp), and with with_stats also TraceStats.
    spp_contiguous > 0 asserts pix0 == repeat(arange(P), spp).  The live
    count is read on the host once per bounce round, to pick its slice.
    Under autograd the rounds run checkpointed; on the card with
    cfg.cuda_graphs (cfg.captures), the captured fit program
    (``portrayer_tpu_torch/fit.py``) runs them."""
    if _records(st, o0, d0, w0, bg) and cfg.captures:
        from .. import fit

        return fit.trace_captured(key, o0, d0, pix0, bg, n_pixels, st, cfg, w0=w0,
                                      spp_contiguous=spp_contiguous, with_stats=with_stats)
    R0 = o0.shape[0]
    pl = plan(R0, st, cfg)
    q = primary_queue(o0, d0, pix0, w0, cfg)
    acc, q, dropped, n_live = first_round(rng.fold_in(key, 0), q, bg, n_pixels, st, cfg, pl,
                                          spp_contiguous)
    live = []  # live rays entering rounds 1.. (host ints)
    count_refr = with_stats and st.any_refractive
    refr = []  # refracted rays entering each bounce round that ran (device scalars)

    def read_live():
        live.append(int(n_live))
        return live[-1]

    lanes = [R0] + [0] * pl.max_depth
    for ridx, k, next_cap, last in bounce_rounds(pl, cfg.queue_slice_divs, read_live):
        if count_refr:
            refr.append(refracted(q.sid[:k]))
        acc, q, dr, n_live = bounce_round(rng.fold_in(key, ridx), q, acc, bg, st, cfg, k,
                                          next_cap, last)
        if dr is not None:
            dropped = dr if dropped is None else dropped + dr
        lanes[ridx] = k

    if not with_stats:
        return acc
    # Round 0's live count costs one more host sync, only here; the
    # refracted counts one more.
    lv = [int((w0 > 0.0).sum()) if w0 is not None else R0] + live
    lv = (lv + [0] * pl.max_depth)[:pl.max_depth + 1]
    rf = [0] * (pl.max_depth + 1)
    if refr:  # rounds 1, 2, ... as they ran
        rf[1:1 + len(refr)] = torch.stack(refr).cpu().tolist()
    return acc, TraceStats(live=torch.tensor(lv, dtype=torch.int32),
                           dropped_w=float(dropped.detach()) / R0 if dropped is not None else 0.0,
                           syncs=len(live), lanes=torch.tensor(lanes, dtype=torch.int32),
                           refr=torch.tensor(rf, dtype=torch.int32))


class _CallableModule(types.ModuleType):
    """This module, which calling runs its ``trace`` (``ops.trace(...)``,
    the JAX package's export of the function under the module's name)."""

    def __call__(self, *args, **kwargs):
        return trace(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
