"""The fit program: a differentiable trace on the card as captured CUDA
graphs, forward and backward (the counterpart of the JAX package's jitted
``train_step``, whose ``value_and_grad`` differentiates one compiled
program with every round under ``jax.checkpoint``).

``ops.trace.trace`` sends here a trace whose tables (or rays) require
grad, on the card with accel="cuda" and ``cfg.cuda_graphs``.  The whole
trace is one autograd node (``_Fit``).  Its forward runs round 0 and each
bounce round as a step on static buffers: the step sweeps, shades,
accumulates and compacts without autograd, and leaves in the round's
state slab what its backward needs, the queue it ran on and its sweep
results.  Each slab is copied out once a round, so rounds of one shape
share a step (and a graph) while each keeps its own state.  The backward
walks the rounds from the last to the first: each copies its state back,
replays the round's hit detail, shading, light sum and compaction from it
under autograd (no sweep is launched), and takes the vector-Jacobian
product into the parameters and into the cotangent of the queue it ran
on.  The cotangent of the framebuffer is the same in every round (a
round adds to it), so no round keeps its framebuffer.

The host reads each bounce round's live count once in the forward, to
pick the round's slice, as ``trace`` does; the backward reuses those
choices and reads nothing.  Each step is captured as a CUDA graph at its
first use (a program first runs one forward and backward op by op) and
replayed after; every step reads its inputs from buffers allocated outside
the graphs, so one memory pool serves them all.
Parameters change every step (``SceneTables.replace`` makes new tables),
so the program reads them from static buffers that each call fills, and
it is cached on the tables' packed table, which ``replace`` keeps.  The
all-reduces of ``parallel.train_step`` stay outside.

The captured fit checkpoints every round: ``cfg.remat_min_lanes`` > 0
(rounds that keep their autograd temporaries) raises here; the op-by-op
trace (``cuda_graphs=False``) honours it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import NamedTuple

import torch

from . import rng
from .config import RenderConfig
from .ops.intersect import Hit
from .ops.trace import (TraceStats, _Queue, _Sweeps, bounce_round, bounce_rounds, first_round,
                        grad_fields, plan, primary_queue)
from .scene.flatten import SceneTables, node_record, tri_record

# The queue fields that carry a gradient from one round to the one before.
_DIFF_QUEUE = ("o", "d", "w", "t_min")
_HIT = ("t", "node", "tri", "hit")
# Ray inputs a trace may take gradients for, beside its tables.
_RAY_INPUTS = ("o0", "d0", "w0", "bg")
# Fit programs kept per packed table (PackedPrims.fit_programs).
_MAX_PROGRAMS = 2


class _Slab:
    """Tensors of the given (name, dtype, shape) as views of one byte
    buffer, so that a round's state is copied out and back in one launch."""

    def __init__(self, specs, device):
        at, spans = 0, []
        for name, dtype, shape in specs:
            n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            spans.append((name, dtype, shape, at, n))
            at += -(-n // 16) * 16
        self.flat = torch.zeros((at,), dtype=torch.uint8, device=device)
        self.views = {name: self.flat[a:a + n].view(dtype).view(shape)
                      for name, dtype, shape, a, n in spans}


def _keep(views, sweeps: _Sweeps):
    """Write a round's kept sweep results (its nearest hits, then, with
    lights, its occlusion bits) into its slab's views."""
    hit, *occ = sweeps.kept
    for f in _HIT:
        views[f].copy_(getattr(hit, f))
    for x in occ:
        views["occ"].copy_(x)


def _kept(views) -> _Sweeps:
    """A round's sweeps that read its results from its slab's views."""
    return _Sweeps([Hit(*(views[f] for f in _HIT)), views["occ"]])


class _Run(NamedTuple):
    """What one forward of the program keeps for its backward: each step's
    name and state slab (a copy; bounce rounds with their index), the
    round keys, the live counts read, and the dropped throughput."""
    steps: list
    keys: torch.Tensor
    live: list
    dropped: torch.Tensor


class _FitProgram:
    """A differentiable trace of R0 rays into n_pixels pixels over tables
    like `st`, its parameters `fields` (and the ray inputs `ray_grads`)
    read from static buffers: see the module docstring.  Each step runs as
    a CUDA graph (render._Graph) after the warm-up."""

    def __init__(self, st: SceneTables, cfg: RenderConfig, R0: int, n_pixels: int,
                 spp_c: int, fields: tuple, ray_grads: tuple, has_w0: bool):
        dev, dt = st.device, cfg.dtype
        self.cfg, self.R0, self.P, self.spp_c = cfg, R0, n_pixels, spp_c
        self.fields, self.ray_grads = fields, ray_grads
        self.pl = plan(R0, st, cfg)
        self.L = st.n_lights
        self.params = {f: getattr(st, f).detach().clone() for f in fields}
        self.st = st.replace(**self.params)
        f32 = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
        i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
        i64 = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)
        self.inputs = {"o0": f32(R0, 3), "d0": f32(R0, 3), "pix0": i32(R0),
                       "w0": f32(R0) if has_w0 else None, "bg": f32(n_pixels, 3)}
        self.key = i64(2)
        self.rounds = torch.arange(self.pl.max_depth + 1, dtype=torch.int64, device=dev)
        self.keys = i64(self.pl.max_depth + 1, 2)
        self.ridx = i64()
        self.n_live = i64()
        self.dropped = f32()
        self.acc = f32(n_pixels, 3)
        self.zero_acc = f32(n_pixels, 3)
        self.g_acc = f32(n_pixels, 3)
        caps = sorted(set(self.pl.cap[1:]))
        self.queues = {c: _Queue(o=f32(c, 3), d=f32(c, 3), w=f32(c), pix=i32(c), t_min=f32(c),
                                 src_node=i32(c), src_tri=i32(c), sid=i32(c)) for c in caps}
        # Cotangents of each capacity's queue, and of the parameters.
        self.gq = _Slab([((c, f), dt, (c, 3) if f in ("o", "d") else (c,))
                         for c in caps for f in _DIFF_QUEUE], dev)
        grads = [(f, getattr(st, f).dtype, tuple(getattr(st, f).shape)) for f in fields]
        grads += [(n, dt, tuple(self.inputs[n].shape)) for n in ray_grads]
        self.grads = _Slab(grads, dev)
        self.slabs = {}
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.warm = False
        self.capture_s = 0.0
        self.loaded = None

    # -- state ---------------------------------------------------------------

    def _slab(self, name, k: int, queue: bool):
        """The state slab of step `name`, a round on k lanes: its hits and
        occlusion bits and, with `queue`, the queue it ran on.  Made
        outside every graph, at the step's first use."""
        slab = self.slabs.get(name)
        if slab is None:
            dt, dev = self.cfg.dtype, self.st.device
            specs = [("t", dt, (k,)), ("node", torch.int32, (k,)), ("tri", torch.int32, (k,)),
                     ("hit", torch.bool, (k,)), ("occ", torch.bool, (self.L * k,))]
            if queue:
                for f, x in zip(_Queue._fields, self.queues[self.pl.cap[1]]):
                    specs.append((f, x.dtype, (k,) + tuple(x.shape[1:])))
            slab = self.slabs[name] = _Slab(specs, dev)
        return slab

    def _load(self, token, key, o0, d0, pix0, w0, bg, params):
        """Fill the static inputs with one call's (skipped when they hold
        that call's already)."""
        if self.loaded is token:
            return
        self.key.copy_(key)
        for n, x in (("o0", o0), ("d0", d0), ("pix0", pix0), ("w0", w0), ("bg", bg)):
            if x is not None:
                self.inputs[n].copy_(x)
        for f, x in zip(self.fields, params):
            self.params[f].copy_(x)
        self.loaded = token

    def _run(self, name, fn):
        if not self.warm:
            fn()
            return
        g = self.graphs.get(name)
        if g is None:
            from . import render

            t0 = time.perf_counter()
            g = self.graphs[name] = render._Graph(fn, self.pool)
            self.capture_s += time.perf_counter() - t0
        g.replay()

    # -- forward steps -------------------------------------------------------

    def head(self):
        """Round 0: the records of the tables from the parameters, the
        round keys, the primary queue and round 0, its state in the head
        slab, the round-1 queue, acc and the live count in static
        buffers."""
        st, cfg, x = self.st, self.cfg, self.inputs
        st.rec.copy_(node_record(st))
        st.trec.copy_(tri_record(st))
        self.keys.copy_(rng.fold_in(self.key, self.rounds))
        self.ridx.fill_(1)
        q = primary_queue(x["o0"], x["d0"], x["pix0"], x["w0"], cfg)
        sweeps = _Sweeps()
        acc, q1, dropped, n_live = first_round(
            self.keys[0], q, x["bg"], self.P, st, cfg, self.pl, self.spp_c, sweeps=sweeps)
        _keep(self.slabs["head"].views, sweeps)
        self.acc.copy_(acc)
        if q1 is not None:
            self._queue_out(q1, self.pl.cap[1], n_live)
            self.dropped.copy_(dropped)

    def _queue_out(self, q, cap, n_live):
        for buf, y in zip(self.queues[cap], q):
            buf.copy_(y)
        self.n_live.copy_(n_live)

    def bounce(self, name, cap: int, k: int, next_cap, is_last: bool):
        """Bounce round ridx on the head k lanes of the capacity-cap queue:
        the slice into the round's slab, the round, its children into the
        next_cap queue."""
        v = self.slabs[name].views
        for f, x in zip(_Queue._fields, self.queues[cap]):
            v[f].copy_(x[:k])
        q = _Queue(*(v[f] for f in _Queue._fields))
        rkey = self.keys.index_select(0, self.ridx.reshape(1))[0]
        sweeps = _Sweeps()
        acc, q2, dropped, n_live = bounce_round(
            rkey, q, self.acc, self.inputs["bg"], self.st, self.cfg, k, next_cap, is_last,
            sweeps=sweeps)
        _keep(v, sweeps)
        self.acc.copy_(acc)
        self.ridx.add_(1)
        if not is_last:
            self._queue_out(q2, next_cap, n_live)
            self.dropped.add_(dropped)

    # -- backward steps ------------------------------------------------------

    def _leaves(self):
        """(tables whose parameters are leaves that record, {name: leaf}
        of the parameters and the differentiable ray inputs, the ray
        inputs)."""
        leaves = {f: p.detach().requires_grad_() for f, p in self.params.items()}
        ins = {n: (x.detach().requires_grad_() if n in self.ray_grads else x)
               for n, x in self.inputs.items()}
        leaves.update((n, ins[n]) for n in self.ray_grads)
        return self.st.replace(**{f: leaves[f] for f in self.fields}), leaves, ins

    def _vjp(self, outs, wrt: dict) -> dict:
        """{name: gradient or None} of the outputs (y, cotangent) that
        record, into the tensors of `wrt`; the parameters' and the ray
        inputs' gradients are added to self.grads."""
        outs = [(y, g) for y, g in outs if y is not None and y.requires_grad]
        names = list(wrt)
        if not outs:
            return dict.fromkeys(names)
        gs = dict(zip(names, torch.autograd.grad(
            [y for y, _ in outs], [wrt[n] for n in names], [g for _, g in outs],
            allow_unused=True)))
        for n, g in gs.items():
            if n in self.grads.views and g is not None:
                self.grads.views[n].add_(g)
        return gs

    def _queue_cotangents(self, q, cap):
        """(output, cotangent) of each differentiable field of queue q."""
        return [(getattr(q, f), self.gq.views[(cap, f)]) for f in _DIFF_QUEUE]

    def head_grad(self):
        """The backward of round 0, replayed from the inputs and the head
        slab: the gradients of its parameters and ray inputs."""
        cfg = self.cfg
        with torch.enable_grad():
            st, leaves, x = self._leaves()
            q = primary_queue(x["o0"], x["d0"], x["pix0"], x["w0"], cfg)
            acc, q1, _, _ = first_round(
                self.keys[0], q, x["bg"], self.P, st, cfg, self.pl, self.spp_c,
                sweeps=_kept(self.slabs["head"].views))
            outs = [(acc, self.g_acc)]
            if q1 is not None:
                outs += self._queue_cotangents(q1, self.pl.cap[1])
            self._vjp(outs, leaves)

    def bounce_grad(self, name, cap: int, k: int, next_cap, is_last: bool):
        """The backward of a bounce round, replayed from its slab: the
        gradients of the parameters, and the cotangent of the queue it ran
        on (its head k lanes; 0 on the rest) from that of its children's."""
        v = self.slabs[name].views
        with torch.enable_grad():
            st, leaves, x = self._leaves()
            qv = {f: (v[f].detach().requires_grad_() if f in _DIFF_QUEUE else v[f])
                  for f in _Queue._fields}
            rkey = self.keys.index_select(0, self.ridx.reshape(1))[0]
            acc, q2, _, _ = bounce_round(
                rkey, _Queue(**qv), self.zero_acc, x["bg"], st, self.cfg, k, next_cap, is_last,
                sweeps=_kept(v))
            outs = [(acc, self.g_acc)]
            if not is_last:
                outs += self._queue_cotangents(q2, next_cap)
            gs = self._vjp(outs, {**leaves, **{("q", f): qv[f] for f in _DIFF_QUEUE}})
        for f in _DIFF_QUEUE:
            g, buf = gs[("q", f)], self.gq.views[(cap, f)]
            if g is None:
                buf.zero_()
            else:
                buf[:k].copy_(g)
                buf[k:].zero_()

    # -- a call --------------------------------------------------------------

    def forward(self) -> _Run:
        """The forward of the call whose inputs are loaded: the steps run
        (or replay), each one's state copied out."""
        self._slab("head", self.R0, queue=False)
        self._run("head", self.head)
        steps = [("head", self.slabs["head"].flat.clone())]
        keys = self.keys.clone()
        live = []

        def read_live():
            live.append(int(self.n_live))
            return live[-1]

        if self.pl.max_depth:
            for ridx, k, nxt, last in bounce_rounds(self.pl, self.cfg.queue_slice_divs,
                                                    read_live):
                cap = self.pl.cap[ridx]
                name = ("bounce", cap, k, nxt, last)
                self._slab(name, k, queue=True)
                self._run(name, functools.partial(self.bounce, name, cap, k, nxt, last))
                steps.append((name, ridx, self.slabs[name].flat.clone()))
        return _Run(steps, keys, live, self.dropped.clone())

    def backward(self, run: _Run, g_acc) -> dict:
        """The gradients {name: tensor} of the call whose inputs are loaded
        and whose forward kept `run`, for the framebuffer's cotangent
        g_acc: the steps' backwards, from the last round to the first."""
        self.keys.copy_(run.keys)
        self.g_acc.copy_(g_acc)
        self.grads.flat.zero_()
        self.gq.flat.zero_()
        for name, ridx, state in reversed(run.steps[1:]):
            self.slabs[name].flat.copy_(state)
            self.ridx.fill_(ridx)
            self._run(("grad",) + name, functools.partial(self.bounce_grad, name, *name[1:]))
        self.slabs["head"].flat.copy_(run.steps[0][1])
        self._run(("grad", "head"), self.head_grad)
        return {n: g.clone() for n, g in self.grads.views.items()}

    def warm_up(self):
        """A program's first call: one forward and one backward
        op by op (building the kernel, the sweep's chunk groups, the
        allocator's blocks and autograd's threads), then forgotten."""
        run = self.forward()
        self.backward(run, self.zero_acc)
        self.warm = True


class _Fit(torch.autograd.Function):
    """A trace through the fit program as one autograd node."""

    @staticmethod
    def forward(ctx, prog: _FitProgram, box: dict, key, pix0, o0, d0, w0, bg, *params):
        token = object()
        inputs = (key, o0, d0, pix0, w0, bg, params)
        prog._load(token, *inputs)
        if not prog.warm:
            prog.warm_up()
        run = prog.forward()
        ctx.prog, ctx.run, ctx.token = prog, run, token
        ctx.save_for_backward(key, pix0, o0, d0, w0, bg, *params)
        box["run"] = run
        return prog.acc.clone()

    @staticmethod
    def backward(ctx, g_acc):
        prog = ctx.prog
        key, pix0, o0, d0, w0, bg, *params = ctx.saved_tensors
        prog._load(ctx.token, key, o0, d0, pix0, w0, bg, params)
        grads = prog.backward(ctx.run, g_acc)
        ray = [grads.get(n) for n in _RAY_INPUTS]
        return (None, None, None, None, *ray, *(grads[f] for f in prog.fields))


def _program(st: SceneTables, cfg: RenderConfig, R0: int, n_pixels: int, spp_c: int,
             fields: tuple, ray_grads: tuple, has_w0: bool) -> _FitProgram:
    """The fit program of this trace, cached on the tables' packed table by
    configuration, shape, parameters and the identity of every other table
    (the program reads those in place)."""
    others = tuple((f.name, id(v) if isinstance(v, torch.Tensor) else v)
                   for f in dataclasses.fields(st)
                   if f.name not in fields + ("rec", "trec", "packed", "chunk_programs")
                   for v in (getattr(st, f.name),))
    key = (cfg, R0, n_pixels, spp_c, fields, ray_grads, has_w0, others)
    cache = st.packed.fit_programs
    prog = cache.pop(key, None)
    if prog is None:
        prog = _FitProgram(st, cfg, R0, n_pixels, spp_c, fields, ray_grads, has_w0)
        while len(cache) >= _MAX_PROGRAMS:
            cache.pop(next(iter(cache)))
    cache[key] = prog
    return prog


def trace_captured(key, o0, d0, pix0, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
                   w0=None, spp_contiguous: int = 0, with_stats: bool = False):
    """ops.trace.trace through the fit program (same arguments and
    results), differentiable in the tables' fields that require grad and
    in the ray inputs that do."""
    if cfg.remat_min_lanes > 0:
        raise ValueError(
            f"RenderConfig(remat_min_lanes={cfg.remat_min_lanes}): the captured fit "
            "checkpoints every round; pass cuda_graphs=False to keep the temporaries of "
            "small rounds")
    fields = grad_fields(st)
    xs = dict(zip(_RAY_INPUTS, (o0, d0, w0, bg)))
    ray_grads = tuple(n for n, x in xs.items() if x is not None and x.requires_grad)
    prog = _program(st, cfg, o0.shape[0], n_pixels, spp_contiguous, fields, ray_grads,
                    w0 is not None)
    box = {}
    acc = _Fit.apply(prog, box, key, pix0, o0, d0, w0, bg, *(getattr(st, f) for f in fields))
    if not with_stats:
        return acc
    run = box["run"]
    R0, D = o0.shape[0], prog.pl.max_depth
    lv = [int((w0 > 0.0).sum()) if w0 is not None else R0] + run.live
    lv = (lv + [0] * D)[:D + 1]
    return acc, TraceStats(live=torch.tensor(lv, dtype=torch.int32),
                           dropped_w=float(run.dropped) / R0 if D else 0.0,
                           syncs=len(run.live))
