"""The fit program: a differentiable trace on the card as captured CUDA
graphs, forward and backward (the counterpart of the JAX package's jitted
``train_step``, whose ``value_and_grad`` differentiates one compiled
program with every round under ``jax.checkpoint``).

``ops.trace.trace`` sends here a trace whose tables (or rays) require
grad, on the card with ``cfg.cuda_graphs`` (``cfg.captures``), through
any of the three sweeps: the kernel, the flat sweep or the beam sweep,
whose ordered walks are WHILE nodes of the forward's rounds.  The whole
trace is one autograd node (``_Fit``).  Its forward is one step: round 0,
then each bounce round on the slice that ``slice_sel`` picks on the device
from the live count (``graphs.switch``, the JAX package's ``lax.switch``),
each slice a conditional body.  A round sweeps, shades, accumulates and
compacts without autograd, and leaves in its slot of the state slab what
its backward needs: the queue it ran on (at most its capacity) and its
sweep results.  The rounds of the tail of equal capacity, the last round
aside, run as one loop (``graphs.loop``, a WHILE node, the JAX package's
``lax.scan``) over a round index held on the device; their slots are
one stacked slot [rounds, capacity, ...], written at the index with
``index_copy_`` and read back with ``index_select`` (the scan's stacked
residuals).  The slab also holds the round keys, each round's branch
index (`sel`) and live count, and the dropped throughput; each call
copies it out once, so calls of one program keep their own state.  The backward is one step
too: it copies a call's slab back and walks the rounds from the last to
the first (the tail as a loop in reverse), each round under the
conditional body of the branch its forward took (none for a dead round),
replaying the round's hit detail, shading, light sum and compaction from
its slot under autograd (no sweep is launched) and taking the
vector-Jacobian product into the parameters and into the cotangent of
the queue it ran on.  The cotangent of the framebuffer is the same in
every round (a round adds to it), so no round keeps its framebuffer.

Forward and backward are each captured as one CUDA graph (a program
first runs them op by op, its warm-up) and replayed after; they read
nothing on the host.  Their steps read their inputs from buffers
allocated outside the graphs, so one memory pool serves both.
Parameters change every step (``SceneTables.replace`` makes new tables),
so the program reads them from static buffers that each call fills, and
it is cached on the tables' packed table, which ``replace`` keeps.  The
all-reduces of ``parallel.train_step`` stay outside.

``cfg.remat_min_lanes`` exempts the slices of fewer lanes from the
replay, as the JAX package runs a round of k < remat_min_lanes lanes
without ``jax.checkpoint`` (its trace.py ``_run`` against ``_run_ckpt``).
k is static in a slice's body, so whether it is exempt is too.  An exempt
body runs its forward under autograd, from parameter leaves that the
program owns (static, like its other buffers), with
``saved_tensors_hooks`` whose pack copies each tensor autograd saves into
the body's row of residuals and whose unpack hands back a view of it: an
unrolled round's row is a slot of the state slab; the tail loop's is a
static row that each run of the body stores into a stacked slot of the
slab at the device round index, and that the backward loads back from
there before the body's vjp (one launch each way).
The autograd graph that a body's forward records while the forward is
captured is kept: its nodes are the same for every round of that body,
only the slot's contents change.  The backward's body of an exempt slice
takes the vector-Jacobian product on that graph (``retain_graph``), so it
replays no forward op, as ``torch.cuda.make_graphed_callables`` pairs a
captured forward with a captured backward.  The slots' sizes are measured
in the warm-up, which runs op by op before the capture.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import torch

from . import graphs, rng
from .config import RenderConfig
from .ops.intersect import Hit
from .ops.trace import (TraceStats, _Queue, _Sweeps, at_round, bounce_round, first_round,
                        grad_fields, launched_lanes, plan, primary_queue, round_shapes, rounds,
                        set_at_round, slice_sel)
from .scene.flatten import SceneTables, node_record, tri_record

# The queue fields that carry a gradient from one round to the one before.
_DIFF_QUEUE = ("o", "d", "w", "t_min")
_HIT = ("t", "node", "tri", "hit")
# Ray inputs a trace may take gradients for, beside its tables.
_RAY_INPUTS = ("o0", "d0", "w0", "bg")
# Fit programs kept per packed table (PackedPrims.fit_programs).
_MAX_PROGRAMS = 2
# The slot of an exempt body's residuals in the state slab.
_RES = "res"


class _Slab:
    """Tensors of the given (name, dtype, shape) as views of one byte
    buffer, so that a state is copied out and back in one launch;
    ``views_of`` gives the same views of a copy."""

    def __init__(self, specs, device):
        at, self.spans = 0, []
        for name, dtype, shape in specs:
            n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            self.spans.append((name, dtype, shape, at, n))
            at += -(-n // 16) * 16
        self.flat = torch.zeros((at,), dtype=torch.uint8, device=device)
        self.views = self.views_of(self.flat)

    def views_of(self, flat) -> dict:
        return {name: flat[a:a + n].view(dtype).view(shape)
                for name, dtype, shape, a, n in self.spans}


def _written(buf, x):
    """buf <- x through an alias of buf, under autograd: the alias is the
    output whose history an exempt body's backward differentiates (buf
    itself records nothing)."""
    alias = buf.detach()
    alias.copy_(x)
    return alias


def _shape(rd, k: int) -> tuple:
    """The static shape of round rd's body on k lanes (round_shapes)."""
    return (rd.cap, k, rd.next_cap, rd.last, rd.looped)


def _kept_fields(sweeps: _Sweeps) -> dict:
    """{field: tensor} of a round's kept sweep results: its nearest hits
    and, with lights, its occlusion bits."""
    hit, *occ = sweeps.kept
    out = {f: getattr(hit, f) for f in _HIT}
    if occ:
        out["occ"] = occ[0]
    return out


def _kept(views) -> _Sweeps:
    """A round's sweeps that read its results from its slot's views."""
    return _Sweeps([Hit(*(views[f] for f in _HIT)), views["occ"]])


class _NoGradSweeps(_Sweeps):
    """Sweeps launched outside autograd: an exempt body's forward records
    the round, and its sweeps return results without a graph."""

    def __call__(self, launch):
        with torch.no_grad():
            return super().__call__(launch)


def _layout(saves) -> tuple:
    """(spans (dtype, shape, byte offset, bytes) of the saves that are not
    constants, None for those that are; total bytes), each span aligned
    to 16 bytes as in _Slab."""
    spans, at = [], 0
    for dtype, shape, const in saves:
        if const:
            spans.append(None)
            continue
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        spans.append((dtype, shape, at, n))
        at += -(-n // 16) * 16
    return spans, at


class _Residuals:
    """Where the tensors that autograd saves in exempt bodies live.  Each
    exempt body (an unrolled round's index and its k, or "tail" and k) has
    a row of bytes that holds its saves one after the other: for an
    unrolled body, its slot (_RES, body) of the state slab; for the tail's
    loop, a static row, whose contents the forward stores into the slab's
    stacked slot [looped rounds, bytes] at the device round index after
    each run of the body and the backward loads back before its vjp (one
    launch each way), so that a save is always read as a view.  ``shapes``
    holds each body shape's saves measured in the warm-up.  The store
    holds no graph, so the hooks that close over it make no cycle with the
    program."""

    def __init__(self, device):
        self.device = device
        self.state = None
        self.shapes = {}    # {body shape: [(dtype, shape, constant)]}
        self.views = {}     # {body: [a view of its row per save, None for a constant]}
        self.rows = {}      # {looped body: its static row}
        self.tail0 = None   # the first looped round

    def bind(self, state, bodies: dict):
        """Bind the exempt bodies ({body: saves}) to the slab `state`."""
        self.state = state
        for body, saves in bodies.items():
            spans, n = _layout(saves)
            if body[0] == "tail":
                row = self.rows[body] = torch.zeros((n,), dtype=torch.uint8, device=self.device)
            else:
                row = state.views[(_RES, body)]
            self.views[body] = [None if sp is None else
                                row[sp[2]:sp[2] + sp[3]].view(sp[0]).view(sp[1]) for sp in spans]

    def _index(self, ridx):
        return (ridx - self.tail0).reshape(1)

    def store(self, body, ridx):
        """After a looped body's forward: its row into the slab at ridx."""
        if body in self.rows:
            self.state.views[(_RES, body)].index_copy_(0, self._index(ridx), self.rows[body][None])

    def load(self, body, ridx):
        """Before a looped body's backward: its row from the slab at ridx."""
        if body in self.rows:
            torch.index_select(self.state.views[(_RES, body)], 0, self._index(ridx),
                               out=self.rows[body][None])

    def hooks(self, body, measure=None):
        """(pack, unpack) for the forward of `body`; with `measure` (a
        list), pack records each save's (dtype, shape, constant) there
        instead of storing it.  A constant is a tensor off the program's
        device (a number wrapped on the host, the same every run): it is
        kept as it is."""
        counter = iter(range(1 << 30))

        def pack(x):
            i = next(counter)
            const = x.device != self.device
            if measure is not None:
                # Nothing is kept: a graph that held its outputs here
                # would hold itself.
                measure.append((x.dtype, tuple(x.shape), const))
                return None
            if const:
                return x
            self.views[body][i].copy_(x)
            return (body, i)

        return pack, self.unpack

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        body, i = packed
        return self.views[body][i]


class _FitProgram:
    """A differentiable trace of R0 rays into n_pixels pixels over tables
    like `st`, its parameters `fields` (and the ray inputs `ray_grads`)
    read from static buffers: see the module docstring.  Forward and
    backward each run as a CUDA graph (graphs.Graph) after the warm-up."""

    def __init__(self, st: SceneTables, cfg: RenderConfig, R0: int, n_pixels: int,
                 spp_c: int, fields: tuple, ray_grads: tuple, has_w0: bool):
        dev, dt = st.device, cfg.dtype
        self.cfg, self.R0, self.P, self.spp_c = cfg, R0, n_pixels, spp_c
        self.fields, self.ray_grads = fields, ray_grads
        self.pl = plan(R0, st, cfg)
        self.rounds = list(rounds(self.pl, cfg.queue_slice_divs, loop=True))
        self.looped = [rd for rd in self.rounds if rd.looped]
        self.L = st.n_lights
        self.params = {f: getattr(st, f).detach().clone() for f in fields}
        self.st = st.replace(**self.params)
        self.res = _Residuals(dev)
        self.res.tail0 = self.looped[0].r if self.looped else None
        self.exempt = {}    # {body: (outputs, inputs) of its recorded graph}
        f32 = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
        i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
        i64 = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)
        self.inputs = {"o0": f32(R0, 3), "d0": f32(R0, 3), "pix0": i32(R0),
                       "w0": f32(R0) if has_w0 else None, "bg": f32(n_pixels, 3)}
        self.key = i64(2)
        # The live count entering the next round, the looped round in
        # flight (forward), the backward's loop counter and its live.
        self.n_live, self.r, self.j = i64(), i64(), i64()
        self.one = torch.ones((), dtype=torch.int64, device=dev)
        self.round_ix = torch.arange(self.pl.max_depth + 1, dtype=torch.int64, device=dev)
        self.acc = f32(n_pixels, 3)
        self.zero_acc = f32(n_pixels, 3)
        self.g_acc = f32(n_pixels, 3)
        caps = sorted(set(self.pl.cap[1:]))
        self.queues = {c: _Queue(o=f32(c, 3), d=f32(c, 3), w=f32(c), pix=i32(c), t_min=f32(c),
                                 src_node=i32(c), src_tri=i32(c), sid=i32(c)) for c in caps}
        self.state = self._state_slab(dev)
        # Cotangents of each capacity's queue, and of the parameters.
        self.gq = _Slab([((c, f), dt, (c, 3) if f in ("o", "d") else (c,))
                         for c in caps for f in _DIFF_QUEUE], dev)
        grads = [(f, getattr(st, f).dtype, tuple(getattr(st, f).shape)) for f in fields]
        grads += [(n, dt, tuple(self.inputs[n].shape)) for n in ray_grads]
        self.grads = _Slab(grads, dev)
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.warm = False
        self.capture_s = 0.0
        self.loaded = None

    # -- state ---------------------------------------------------------------

    def _state_slab(self, dev) -> _Slab:
        """The forward's state: keys, sel and live per round, dropped, and a
        slot ("head", then each unrolled bounce round's index, then "tail"
        stacked over the looped rounds) of its hits and occlusion bits
        and, for a bounce round, the queue it ran on, each at the round's
        capacity."""
        D, dt = self.pl.max_depth, self.cfg.dtype
        specs = [("keys", torch.int64, (D + 1, 2)), ("sel", torch.int64, (D + 1,)),
                 ("live", torch.int64, (D + 1,)), ("dropped", dt, ())]
        slots = [("head", (), self.R0, ())] + [(rd.r, (), rd.cap, self.queues[rd.cap])
                                               for rd in self.rounds if not rd.looped]
        if self.looped:
            cap = self.looped[0].cap
            slots.append(("tail", (len(self.looped),), cap, self.queues[cap]))
        for slot, lead, n, queue in slots:
            specs += [((slot, "t"), dt, lead + (n,)), ((slot, "node"), torch.int32, lead + (n,)),
                      ((slot, "tri"), torch.int32, lead + (n,)),
                      ((slot, "hit"), torch.bool, lead + (n,)),
                      ((slot, "occ"), torch.bool, lead + (self.L * n,))]
            specs += [((slot, f), x.dtype, lead + (n,) + tuple(x.shape[1:]))
                      for f, x in zip(_Queue._fields, queue)]
        # The exempt bodies' residual rows, once the warm-up has measured them.
        for body, saves in self._exempt_bodies().items():
            lead = (len(self.looped),) if body[0] == "tail" else ()
            specs.append(((_RES, body), torch.uint8, lead + (_layout(saves)[1],)))
        return _Slab(specs, dev)

    def _exempt_bodies(self) -> dict:
        """{body: its saves} of every exempt body whose saves are measured."""
        out = {}
        for rd in self.rounds:
            for k in rd.sizes:
                saves = self.res.shapes.get(_shape(rd, k))
                if self._exempt(k) and saves is not None:
                    out[self._body(rd, k)] = saves
        return out

    def _exempt(self, k: int) -> bool:
        """Whether a bounce round's slice of k lanes keeps its autograd
        temporaries (k < remat_min_lanes), the JAX package's rule."""
        return k < self.cfg.remat_min_lanes

    @staticmethod
    def _body(rd, k: int):
        """The name of round rd's body on k lanes: its index, or "tail"."""
        return ("tail" if rd.looped else rd.r, k)

    def _lanes(self, f, k: int) -> int:
        return self.L * k if f == "occ" else k

    def _slot(self, slot, k: int) -> dict:
        """{field: view} of an unrolled round's slot, cut to the k lanes it
        ran on."""
        v = self.state.views
        fields = _HIT + ("occ",) + (_Queue._fields if slot != "head" else ())
        return {f: v[(slot, f)][:self._lanes(f, k)] for f in fields}

    def _tail_index(self, ridx):
        """The looped round ridx's place in the tail slot: [1] on the device."""
        return (ridx - self.looped[0].r).reshape(1)

    def _get(self, ridx, k: int) -> dict:
        """{field: tensor} of bounce round ridx's slot on k lanes: views of
        an unrolled round's (ridx an int), copies of a looped one's (ridx
        the 0-d index on the device)."""
        if isinstance(ridx, int):
            return self._slot(ridx, k)
        v, i = self.state.views, self._tail_index(ridx)
        return {f: v[("tail", f)][:, :self._lanes(f, k)].index_select(0, i)[0]
                for f in _HIT + ("occ",) + _Queue._fields}

    def _put(self, ridx, k: int, values: dict):
        """Write {field: tensor on k lanes} into the slot of round ridx
        ("head", a bounce round's index, or the looped index r)."""
        if not isinstance(ridx, torch.Tensor):
            views = self._slot(ridx, k)
            for f, x in values.items():
                views[f].copy_(x)
            return
        v, i = self.state.views, self._tail_index(ridx)
        for f, x in values.items():
            v[("tail", f)][:, :self._lanes(f, k)].index_copy_(0, i, x[None])

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
            t0 = time.perf_counter()
            g = self.graphs[name] = graphs.Graph(fn, self.pool)
            self.capture_s += time.perf_counter() - t0
        g.replay()

    # -- forward -------------------------------------------------------------

    def _forward(self):
        """Round 0, then each bounce round on the slice its live count
        picks (the dead branch: none), the looped ones through
        graphs.loop."""
        v = self.state.views
        v["sel"].zero_()
        v["live"].zero_()
        self.head()
        for rd in self.rounds:
            if rd.looped:
                if rd is self.looped[0]:
                    self.r.fill_(rd.r)
                    graphs.loop(self.r, self.looped[-1].r + 1, self.n_live,
                                functools.partial(self._forward_round, self.r, rd))
                continue
            if self._forward_round(rd.r, rd) == 0:
                break

    def _forward_round(self, ridx, rd):
        """Round rd at index ridx on the slice its live count picks, its
        branch index kept in sel."""
        sel = slice_sel(self.n_live, rd.sizes)
        set_at_round(self.state.views["sel"], ridx, sel)
        return graphs.switch(sel, [None] + [
            functools.partial(self.bounce_exempt, ridx, rd, k) if self._exempt(k) else
            functools.partial(self.bounce, ridx, rd.cap, k, rd.next_cap, rd.last)
            for k in rd.sizes])

    def head(self):
        """Round 0: the records of the tables from the parameters, the
        round keys, the primary queue and round 0, its state in the head
        slot, the round-1 queue, acc and the live counts in static
        buffers."""
        st, cfg, x, v = self.st, self.cfg, self.inputs, self.state.views
        st.rec.copy_(node_record(st))
        st.trec.copy_(tri_record(st))
        v["keys"].copy_(rng.fold_in(self.key, self.round_ix))
        if x["w0"] is None:
            v["live"][0].fill_(self.R0)
        else:
            v["live"][0].copy_((x["w0"] > 0.0).sum())
        q = primary_queue(x["o0"], x["d0"], x["pix0"], x["w0"], cfg)
        sweeps = _Sweeps()
        acc, q1, dropped, n_live = first_round(
            v["keys"][0], q, x["bg"], self.P, st, cfg, self.pl, self.spp_c, sweeps=sweeps,
            plain=True)
        self._put("head", self.R0, _kept_fields(sweeps))
        self.acc.copy_(acc)
        if q1 is not None:
            self._queue_out(q1, self.pl.cap[1], n_live, 1)
            v["dropped"].copy_(dropped)

    def _queue_out(self, q, cap, n_live, ridx):
        for buf, y in zip(self.queues[cap], q):
            buf.copy_(y)
        self.n_live.copy_(n_live)
        set_at_round(self.state.views["live"], ridx, n_live)

    def bounce(self, ridx, cap: int, k: int, next_cap, is_last: bool):
        """Bounce round ridx (an int, or in the loop the index r) on the
        head k lanes of the capacity-cap queue: the slice into the round's
        slot, the round, its sweep results into the slot and its children
        into the next_cap queue."""
        q = _Queue(*(x[:k] for x in self.queues[cap]))
        self._put(ridx, k, q._asdict())
        sweeps = _Sweeps()
        acc, q2, dropped, n_live = bounce_round(
            at_round(self.state.views["keys"], ridx), q, self.acc, self.inputs["bg"], self.st,
            self.cfg, k, next_cap, is_last, sweeps=sweeps, plain=True)
        self._put(ridx, k, _kept_fields(sweeps))
        self.acc.copy_(acc)
        if not is_last:
            self._queue_out(q2, next_cap, n_live, ridx + 1)
            self.state.views["dropped"].add_(dropped)

    def bounce_exempt(self, ridx, rd, k: int, measure=None):
        """Bounce round ridx (as in bounce) on k lanes, exempt from the
        replay: its forward recorded by autograd from leaves that alias the
        static parameters and inputs (made here, so that their autograd
        nodes belong to the stream this body runs on), each saved tensor
        packed into the body's residual row (or, with `measure`, its shape
        recorded there), its results written to the static buffers through
        aliases whose history the backward differentiates.  The graph
        recorded while the forward is captured is kept (self.exempt);
        before the capture, the last one."""
        body = self._body(rd, k)
        leaves = {f: p.detach().requires_grad_() for f, p in self.params.items()}
        bg = self.inputs["bg"]
        if "bg" in self.ray_grads:
            bg = leaves["bg"] = bg.detach().requires_grad_()
        q = _Queue(*(x[:k] for x in self.queues[rd.cap]))
        qv = {f: (getattr(q, f).detach().requires_grad_() if f in _DIFF_QUEUE else getattr(q, f))
              for f in _Queue._fields}
        outs = []
        pack, unpack = self.res.hooks(body, measure)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            st = self.st.replace(**{f: leaves[f] for f in self.fields})
            acc, q2, dropped, n_live = bounce_round(
                at_round(self.state.views["keys"], ridx), _Queue(**qv), self.acc, bg, st,
                self.cfg, k, rd.next_cap, rd.last, sweeps=_NoGradSweeps())
            outs.append((_written(self.acc, acc), "acc"))
            if not rd.last:
                bufs = self.queues[rd.next_cap]
                outs += [(_written(getattr(bufs, f), getattr(q2, f)), (rd.next_cap, f))
                         for f in _DIFF_QUEUE]
        if not rd.last:
            with torch.no_grad():
                self._queue_out(q2, rd.next_cap, n_live, ridx + 1)
                self.state.views["dropped"].add_(dropped)
        if measure is None:
            self.res.store(body, ridx)
            wrt = {**leaves, **{("q", f): qv[f] for f in _DIFF_QUEUE}}
            if self.warm:
                self.exempt.setdefault(body, (outs, wrt))
            else:
                self.exempt[body] = (outs, wrt)

    # -- backward ------------------------------------------------------------

    def _backward(self):
        """The rounds' backwards from the last to the first, each on the
        branch its forward took; the looped ones through graphs.loop over
        j, at round index (last looped round) - j."""
        self.grads.flat.zero_()
        self.gq.flat.zero_()
        for rd in reversed(self.rounds):
            if rd.looped:
                if rd is self.looped[-1]:
                    self.j.zero_()
                    graphs.loop(self.j, len(self.looped), self.one, self._backward_looped)
                continue
            self._backward_round(rd.r, rd)
        self.head_grad()

    def _backward_looped(self):
        self._backward_round(self.looped[-1].r - self.j, self.looped[0])

    def _backward_round(self, ridx, rd):
        graphs.switch(at_round(self.state.views["sel"], ridx), [None] + [
            functools.partial(self.exempt_grad, ridx, rd, k) if self._exempt(k) else
            functools.partial(self.bounce_grad, ridx, rd.cap, k, rd.next_cap, rd.last)
            for k in rd.sizes])

    def _leaves(self):
        """(tables whose parameters are leaves that record, {name: leaf}
        of the parameters and the differentiable ray inputs, the ray
        inputs)."""
        leaves = {f: p.detach().requires_grad_() for f, p in self.params.items()}
        ins = {n: (x.detach().requires_grad_() if n in self.ray_grads else x)
               for n, x in self.inputs.items()}
        leaves.update((n, ins[n]) for n in self.ray_grads)
        return self.st.replace(**{f: leaves[f] for f in self.fields}), leaves, ins

    def _vjp(self, outs, wrt: dict, retain: bool = False) -> dict:
        """{name: gradient or None} of the outputs (y, cotangent) that
        record, into the tensors of `wrt`; the parameters' and the ray
        inputs' gradients are added to self.grads.  `retain` keeps the
        graph (an exempt body's, differentiated again at every call)."""
        outs = [(y, g) for y, g in outs if y is not None and y.requires_grad]
        names = list(wrt)
        if not outs:
            return dict.fromkeys(names)
        gs = dict(zip(names, torch.autograd.grad(
            [y for y, _ in outs], [wrt[n] for n in names], [g for _, g in outs],
            allow_unused=True, retain_graph=retain)))
        for n, g in gs.items():
            if n in self.grads.views and g is not None:
                self.grads.views[n].add_(g)
        return gs

    def _queue_cotangents(self, q, cap):
        """(output, cotangent) of each differentiable field of queue q."""
        return [(getattr(q, f), self.gq.views[(cap, f)]) for f in _DIFF_QUEUE]

    def head_grad(self):
        """The backward of round 0, replayed from the inputs and the head
        slot: the gradients of its parameters and ray inputs."""
        cfg = self.cfg
        with torch.enable_grad():
            st, leaves, x = self._leaves()
            q = primary_queue(x["o0"], x["d0"], x["pix0"], x["w0"], cfg)
            acc, q1, _, _ = first_round(
                self.state.views["keys"][0], q, x["bg"], self.P, st, cfg, self.pl, self.spp_c,
                sweeps=_kept(self._slot("head", self.R0)))
            outs = [(acc, self.g_acc)]
            if q1 is not None:
                outs += self._queue_cotangents(q1, self.pl.cap[1])
            self._vjp(outs, leaves)

    def bounce_grad(self, ridx, cap: int, k: int, next_cap, is_last: bool):
        """The backward of bounce round ridx (an int, or in the loop the
        index on the device), replayed from its slot: the gradients of the
        parameters, and the cotangent of the queue it ran on (its head k
        lanes; 0 on the rest) from that of its children's."""
        v = self._get(ridx, k)
        with torch.enable_grad():
            st, leaves, x = self._leaves()
            qv = {f: (v[f].detach().requires_grad_() if f in _DIFF_QUEUE else v[f])
                  for f in _Queue._fields}
            acc, q2, _, _ = bounce_round(
                at_round(self.state.views["keys"], ridx), _Queue(**qv), self.zero_acc, x["bg"], st,
                self.cfg, k, next_cap, is_last, sweeps=_kept(v))
            outs = [(acc, self.g_acc)]
            if not is_last:
                outs += self._queue_cotangents(q2, next_cap)
            gs = self._vjp(outs, {**leaves, **{("q", f): qv[f] for f in _DIFF_QUEUE}})
        self._queue_grads(gs, cap, k)

    def _queue_grads(self, gs, cap: int, k: int):
        """The cotangent of the capacity-cap queue a round ran on: its
        gradients on the head k lanes, 0 on the rest."""
        for f in _DIFF_QUEUE:
            g, buf = gs[("q", f)], self.gq.views[(cap, f)]
            if g is None:
                buf.zero_()
            else:
                buf[:k].copy_(g)
                buf[k:].zero_()

    def exempt_grad(self, ridx, rd, k: int):
        """The backward of an exempt body at round ridx: the vector-Jacobian
        product on the graph its forward recorded, whose saved tensors are
        read from the body's residual slot at ridx; no forward op runs."""
        body = self._body(rd, k)
        outs, wrt = self.exempt[body]
        self.res.load(body, ridx)
        cot = {"acc": self.g_acc, **{n: self.gq.views[n] for _, n in outs if n != "acc"}}
        gs = self._vjp([(y, cot[n]) for y, n in outs], wrt, retain=True)
        self._queue_grads(gs, rd.cap, k)

    # -- a call --------------------------------------------------------------

    def forward(self) -> torch.Tensor:
        """The forward of the call whose inputs are loaded (run, or
        replayed): a copy of its state slab."""
        self._run("forward", self._forward)
        return self.state.flat.clone()

    def backward(self, state, g_acc) -> dict:
        """The gradients {name: tensor} of the call whose inputs are loaded
        and whose forward left `state`, for the framebuffer's cotangent
        g_acc."""
        self.state.flat.copy_(state)
        self.g_acc.copy_(g_acc)
        self._run("backward", self._backward)
        return {n: g.clone() for n, g in self.grads.views.items()}

    def warm_up(self):
        """A program's first call: one forward and one backward op by op,
        then each bounce round's forward and backward at each of its slice
        shapes, a looped one at the device index r (building the kernel,
        the sweep's chunk groups, the allocator's blocks, autograd's
        threads and every branch's first use, as the captures record them
        all), all forgotten."""
        self._measure()
        self.backward(self.forward(), self.zero_acc)
        for rd, k in round_shapes(self.pl, self.cfg.queue_slice_divs, loop=True):
            if rd.looped:
                self.r.fill_(rd.r)
            ridx = self.r if rd.looped else rd.r
            if self._exempt(k):
                self.bounce_exempt(ridx, rd, k)
                self.exempt_grad(ridx, rd, k)
            else:
                self.bounce(ridx, rd.cap, k, rd.next_cap, rd.last)
                self.bounce_grad(ridx, rd.cap, k, rd.next_cap, rd.last)
        self.warm = True
        # The captures record the graphs the backward differentiates.
        self.exempt = {}

    def _measure(self):
        """The tensors each exempt body shape saves, from one forward of
        it; then the state slab with a residual slot for each."""
        for rd, k in round_shapes(self.pl, self.cfg.queue_slice_divs, loop=True):
            if self._exempt(k):
                if rd.looped:
                    self.r.fill_(rd.r)
                saves = self.res.shapes[_shape(rd, k)] = []
                self.bounce_exempt(self.r if rd.looped else rd.r, rd, k, measure=saves)
        if self.res.shapes:
            self.state = self._state_slab(self.st.device)
        self.res.bind(self.state, self._exempt_bodies())

    def stats(self, state) -> TraceStats:
        """The TraceStats of the call that left `state`: one read."""
        v = self.state.views_of(state)
        host = torch.cat([v["live"].double(), v["dropped"].double().reshape(1)]).cpu()
        D = self.pl.max_depth
        live = host[:D + 1].to(torch.int32)
        return TraceStats(live=live, dropped_w=float(host[D + 1]) / self.R0 if D else 0.0,
                          syncs=0, lanes=launched_lanes(self.pl, self.cfg.queue_slice_divs, live))


class _Fit(torch.autograd.Function):
    """A trace through the fit program as one autograd node."""

    @staticmethod
    def forward(ctx, prog: _FitProgram, box: dict, key, pix0, o0, d0, w0, bg, *params):
        token = object()
        inputs = (key, o0, d0, pix0, w0, bg, params)
        prog._load(token, *inputs)
        if not prog.warm:
            prog.warm_up()
        state = prog.forward()
        ctx.prog, ctx.state, ctx.token = prog, state, token
        ctx.save_for_backward(key, pix0, o0, d0, w0, bg, *params)
        box["state"] = state
        return prog.acc.clone()

    @staticmethod
    def backward(ctx, g_acc):
        prog = ctx.prog
        key, pix0, o0, d0, w0, bg, *params = ctx.saved_tensors
        prog._load(ctx.token, key, o0, d0, pix0, w0, bg, params)
        grads = prog.backward(ctx.state, g_acc)
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
    in the ray inputs that do.  With with_stats, the live counts and the
    dropped throughput are read once, after the forward."""
    fields = grad_fields(st)
    xs = dict(zip(_RAY_INPUTS, (o0, d0, w0, bg)))
    ray_grads = tuple(n for n, x in xs.items() if x is not None and x.requires_grad)
    prog = _program(st, cfg, o0.shape[0], n_pixels, spp_contiguous, fields, ray_grads,
                    w0 is not None)
    box = {}
    acc = _Fit.apply(prog, box, key, pix0, o0, d0, w0, bg, *(getattr(st, f) for f in fields))
    if not with_stats:
        return acc
    return acc, prog.stats(box["state"])
