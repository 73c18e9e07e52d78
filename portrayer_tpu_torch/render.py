"""Render loop — tiled, sample-chunked wavefront rendering (counterpart
of ``portrayer_tpu/render.py``, the reference's src/render.rs).

Per pixel the reference computes: the background gradient at integer pixel
uv (render.rs:31-34), SAMPLES jittered camera rays traced recursively
(render.rs:36-43), their mean, gamma c^(1/2.2), clamp to [0, 1] and u8
truncation (render.rs:45-50,143-147).  Here the image is processed in
pixel tiles x sample chunks; each chunk traces tile_px * spp_chunk rays.
Tiles are keyed by their origin, so re-rendering a region reproduces the
full render's samples there (the reference's Image::slice_mut,
render.rs:211-213).

A chunk is a fixed-shape program on the device (``_ChunkProgram``), as
the JAX package's ``_render_image`` is one jitted program: its tile
origin, sample offset and chunk index come from a frame-wide table on the
device, read through a counter that the program advances, and its keys,
rays, background and trace stay on the device.  On the card, through
any of the three sweeps, the render captures the program once as one
CUDA graph and replays it for every chunk: round 0, then the bounce
rounds, each as one conditional body per head slice of its queue, the
slice picked on the device from the live count (``graphs.switch``, the
JAX package's ``lax.switch``), so a chunk reads nothing on the host.  The rounds of the
tail of equal capacity, the last round aside, share one loop body
(``graphs.loop``, a WHILE node, the JAX package's ``lax.scan``) that runs
the round whose index a device counter holds.  With accel="beam" each
ordered sweep is a WHILE node too, nested in a slice's body, and in the
tail loop's body in turn (the JAX package's ``lax.while_loop`` inside its
``lax.switch`` inside its ``lax.scan``).  Anywhere else the same program
runs op by op, its rounds unrolled, and reads each bounce
round's pick on the host.  A `reporter` ticks once per tile,
when the host has issued its work (the device runs behind by the work
still queued).  A ``spans.Spans`` passed as `spans` receives the frame's
host phases and, from stamps that a program built for it writes on the
device (inside the captured graph on the card), each chunk's and bounce
round's device span, on the host's clock (``spans.py``).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import graphs, rng
from .spans import Spans, span
from .camera import Camera, CameraSettings
from .config import RenderConfig, GAMMA
from .image_io import read_png, write_png
from .ops import cuda_intersect
from .ops.trace import (TraceStats, _Queue, at_round, bounce_round, first_round,
                        launched_lanes, plan, primary_queue, refracted, round_shapes, rounds,
                        slice_sel)
from .reporter import Reporter, NullProgress
from .scene.flatten import SceneTables, flatten_scene
from .scene.node import Scene, bounding_volume_scene


def default_background(uv):
    """Flat black background (callers usually pass a gradient fn)."""
    return torch.zeros(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)


def _tile_rays(key, cam: Camera, x0: int, y0: int, sample_offset: int, *,
               cfg: RenderConfig, background, tile_h: int, tile_w: int, spp: int,
               samples: int, jitter_key=None):
    """One (tile x sample-chunk) wavefront's primary rays: (o [R,3], d [R,3],
    pixel ids [R], background [P,3], throughput [R]), pixel-major.  x0, y0
    and sample_offset are ints or 0-d int tensors; the jitter is keyed
    fold_in(key, 0), or jitter_key where the caller has it."""
    dev, dt = cfg.device, cfg.dtype
    P = tile_h * tile_w
    R = P * spp
    i32 = dict(dtype=torch.int32, device=dev)
    row = torch.arange(tile_h, **i32)[:, None].expand(tile_h, tile_w)
    col = torch.arange(tile_w, **i32)[None, :].expand(tile_h, tile_w)
    px = (col + x0).reshape(-1)
    py = (row + y0).reshape(-1)
    full = lambda v: torch.full((), v, dtype=dt, device=dev)

    # Background at integer-pixel uv (render.rs:31-34).
    bg_uv = torch.stack([px.to(dt) / full(cam.width), py.to(dt) / full(cam.height)], dim=-1)
    bg = background(bg_uv).to(dt)

    # Jittered sample positions x + U[0,1) (render.rs:38-39), pixel-major.
    # Drawn in float32 whatever cfg.dtype, so that the float64 check mode
    # samples the same positions as the float32 render.
    if jitter_key is None:
        jitter_key = rng.fold_in(key, 0)
    jitter = rng.uniform(jitter_key, (R, 2), dev).to(dt)
    xs = px.to(dt).repeat_interleave(spp) + jitter[:, 0]
    ys = py.to(dt).repeat_interleave(spp) + jitter[:, 1]
    pix_id = torch.arange(P, **i32).repeat_interleave(spp)
    # Samples beyond the requested count (chunk padding) carry zero weight.
    sample_ix = torch.arange(spp, **i32).repeat(P)
    live = (sample_ix + sample_offset) < samples

    o, d = cam.rays_at(xs, ys)
    return o, d, pix_id, bg, live.to(dt)


class _ChunkProgram:
    """One (tile x sample-chunk) of a render as a program that reads
    nothing on the host: its inputs are the next row of `rows` (x0, y0,
    sample offset, chunk index), picked by the device counter `cursor`,
    and that row's keys (`keys`, folded for the whole frame at once).
    ``head`` traces round 0 and, with bounces, leaves the round-1 queue,
    acc and the live count in static buffers; each bounce round runs
    ``bounce`` on the slice that ``slice_sel`` picks from the live count,
    through ``graphs.switch``; the chunk's radiance ends in `tile_acc`.
    Live rays per round and dropped throughput go to the per-row tables
    `live` and `dropped`, and, where the scene has a refractive material,
    the refracted children among the live rays to `refr` (None elsewhere:
    nothing is counted).  With `capture`, the chunk runs as one CUDA graph
    (``graphs.Graph``, each round's slices its conditional bodies),
    captured at its first use; its steps meet only in the static buffers,
    allocated outside the graph.  A capturing program runs the looped
    rounds (``rounds``) as one ``graphs.loop`` over the round index `r`,
    a device counter: its body is one round, whose key and live-table
    column that index addresses.  With `stamps`, each row's chunk writes
    the device's time (graphs.stamp) into its row of `stamps`: at column 0
    as it starts, 1 after round 0, 1 + r at the end of bounce round r (left
    0 where it does not run) and max_depth + 2 at its end."""

    def __init__(self, st: SceneTables, cam: Camera, cfg: RenderConfig, background, *,
                 tile_h: int, tile_w: int, spp: int, samples: int, n_rows: int,
                 capture: bool, stamps: bool = False):
        dev, dt = cfg.device, cfg.dtype
        self.st, self.cam, self.cfg, self.background = st, cam, cfg, background
        self.tile_h, self.tile_w, self.spp, self.samples = tile_h, tile_w, spp, samples
        self.P = tile_h * tile_w
        self.pl = plan(self.P * spp, st, cfg)
        i64 = dict(dtype=torch.int64, device=dev)
        self.rows = torch.zeros((n_rows, 4), **i64)
        self.cursor = torch.zeros((), **i64)
        self.row = torch.zeros((), **i64)     # the row in flight
        self.n_live = torch.zeros((), **i64)  # live rays entering its next round
        self.key = rng.PRNGKey(cfg.seed).to(dev)
        # Per row: the jitter key, then the key of each round.
        self.keys = torch.zeros((n_rows, self.pl.max_depth + 2, 2), **i64)
        self.tile_acc = torch.zeros((self.P, 3), dtype=dt, device=dev)
        self.acc = torch.zeros_like(self.tile_acc)
        self.bg = torch.zeros_like(self.tile_acc)
        self.live = torch.zeros((n_rows, self.pl.max_depth + 1), dtype=torch.int32, device=dev)
        self.dropped = torch.zeros((n_rows,), dtype=dt, device=dev)
        self.refr = torch.zeros_like(self.live) if st.any_refractive else None
        f32 = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
        i32 = lambda c: torch.zeros((c,), dtype=torch.int32, device=dev)
        self.queues = {c: _Queue(o=f32(c, 3), d=f32(c, 3), w=f32(c), pix=i32(c), t_min=f32(c),
                                 src_node=i32(c), src_tri=i32(c), sid=i32(c))
                       for c in set(self.pl.cap[1:])}
        self.capture = capture
        self.rounds = list(rounds(self.pl, cfg.queue_slice_divs, loop=capture))
        self.r = torch.zeros((), **i64)  # the looped round in flight
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.warm = False
        self.capture_s = 0.0
        self.warm_launches = {}
        self.stamps = None
        if stamps:
            self.stamps = torch.zeros((n_rows, self.pl.max_depth + 3), **i64)
            self.clock = torch.zeros((1, 1), **i64)  # the calibration stamp
            self.clock_row = torch.zeros((), **i64)

    def _stamp(self, col, shift: int = 0):
        """stamps[row, col + shift] = the device's time, with stamps."""
        if self.stamps is not None:
            graphs.stamp(self.stamps, self.row, col, shift)

    def _fold_keys(self, n: int):
        """The keys of rows [0, n), all at once: the chunk key
        fold_in(fold_in(fold_in(key, x0), y0), ci) (keyed by tile origin, a
        region re-render repeats the full render's samples), its jitter key
        fold_in(ckey, 0) and the trace key fold_in(ckey, 1) folded with each
        round's index."""
        rows = self.rows[:n]
        ckey = rng.fold_in(rng.fold_in(rng.fold_in(self.key, rows[:, 0]), rows[:, 1]),
                           rows[:, 3])
        rounds = torch.arange(self.pl.max_depth + 1, device=rows.device)
        self.keys[:n, 0] = rng.fold_in(ckey, 0)
        self.keys[:n, 1:] = rng.fold_in(rng.fold_in(ckey, 1)[:, None, :], rounds[None, :])

    def _row_key(self, col):
        """keys[row, col], col as ops.trace.at_round takes it."""
        return at_round(self.keys.index_select(0, self.row.reshape(1))[0], col)

    def head(self):
        row = self.rows.index_select(0, self.cursor.reshape(1))[0]
        self.row.copy_(self.cursor)
        self.cursor.add_(1)
        self._stamp(0)
        o, d, pix, bg, w0 = _tile_rays(
            None, self.cam, row[0], row[1], row[2], cfg=self.cfg, background=self.background,
            tile_h=self.tile_h, tile_w=self.tile_w, spp=self.spp, samples=self.samples,
            jitter_key=self._row_key(0))
        self.live[:, 0].index_put_((self.row.reshape(1),), (w0 > 0.0).sum().reshape(1).to(
            torch.int32))
        acc, q, dropped, n_live = first_round(
            self._row_key(1), primary_queue(o, d, pix, w0, self.cfg), bg, self.P, self.st,
            self.cfg, self.pl, self.spp,
            out=self.queues[self.pl.cap[1]] if self.pl.max_depth else None)
        self._stamp(1)
        if q is None:
            self.tile_acc.add_(acc)
            return
        self.acc.copy_(acc)
        self.bg.copy_(bg)
        self._queue_out(q, self.pl.cap[1], dropped, n_live, 1)

    def _queue_out(self, q, cap, dropped, n_live, ridx):
        """The queue (unless the round wrote it into its buffers), live
        count (at live[row, ridx], ridx an int or a 0-d index on the device)
        and dropped throughput (None: nothing dropped) of round ridx."""
        for buf, x in zip(self.queues[cap], q):
            if x is not buf:
                buf.copy_(x)
        self.n_live.copy_(n_live)
        self._put_row(self.live, ridx, n_live)
        if dropped is not None:
            self.dropped.index_add_(0, self.row.reshape(1), dropped.reshape(1))

    def _put_row(self, table, ridx, n):
        """table[row, ridx] = n, a device scalar, ridx an int or a 0-d index
        on the device."""
        n = n.reshape(1).to(table.dtype)
        if isinstance(ridx, int):
            table[:, ridx].index_put_((self.row.reshape(1),), n)
        else:
            table.index_put_((self.row.reshape(1), ridx.reshape(1)), n)

    def bounce(self, ridx, cap: int, k: int, next_cap, is_last: bool):
        """Bounce round ridx (an int, or in the loop the index r) on the
        head k lanes of the capacity-cap queue; where counted, the
        refracted rays among them go to refr[row, ridx]."""
        if self.refr is not None:
            self._put_row(self.refr, ridx, refracted(self.queues[cap].sid[:k]))
        acc, q, dropped, n_live = bounce_round(
            self._row_key(ridx + 1), self.queues[cap], self.acc, self.bg, self.st, self.cfg, k,
            next_cap, is_last, out=None if is_last else self.queues[next_cap])
        if acc is not self.acc:
            self.acc.copy_(acc)
        if not is_last:
            self._queue_out(q, next_cap, dropped, n_live, ridx + 1)
        self._stamp(ridx, 1)

    def _switch(self, ridx, rd) -> int | None:
        """Round rd (at index ridx) on the slice picked from the live count
        (graphs.switch)."""
        return graphs.switch(slice_sel(self.n_live, rd.sizes), [None] + [
            functools.partial(self.bounce, ridx, rd.cap, k, rd.next_cap, rd.last)
            for k in rd.sizes])

    def _trace(self) -> int:
        """The next row's chunk into tile_acc: round 0, then each bounce
        round on the slice picked from the live count (none once it is 0),
        the looped ones through graphs.loop.  Returns the host reads of
        the picks and of the loop's condition (0 under capture)."""
        self.head()
        reads = 0
        if self.pl.max_depth:
            reads = self._bounces()
            self.tile_acc.add_(self.acc)
        self._stamp(self.pl.max_depth + 2)
        return reads

    def _bounces(self) -> int:
        reads = 0
        looped = [rd for rd in self.rounds if rd.looped]
        for rd in self.rounds:
            if rd.looped:
                if rd is looped[0]:
                    self.r.fill_(rd.r)
                    n = graphs.loop(self.r, looped[-1].r + 1, self.n_live,
                                    functools.partial(self._switch, self.r, rd))
                    reads += n or 0
                continue
            taken = self._switch(rd.r, rd)
            if taken is not None:
                reads += 1
                if taken == 0:
                    break
        return reads

    def chunk(self, spans: Optional[Spans] = None) -> int:
        """Trace the next row's chunk into tile_acc; returns the host reads
        it took: 0 when it replays the captured chunk.  The capture is the
        span "capture" in `spans`."""
        if not (self.capture and self.warm):
            return self._trace()
        g = self.graphs.get("chunk")
        if g is None:
            with span(spans, "capture", clock=True) as timed:
                g = self.graphs["chunk"] = graphs.Graph(self._trace, self.pool)
            self.capture_s += timed.seconds
        g.replay()
        return 0

    def _warm_up(self):
        """One chunk op by op, then each bounce round's step at each of its
        slice shapes, a looped one at the device index r (building the
        kernel, the sweep's chunk groups and every branch's first use, as
        the capture records them all); its sweep launches, flat and beam
        sweeps and beam steps are kept in warm_launches."""
        before = cuda_intersect.counts()
        self.cursor.zero_()
        self._trace()
        for rd, k in round_shapes(self.pl, self.cfg.queue_slice_divs, loop=self.capture):
            if rd.looped:
                self.r.fill_(rd.r)
            self.bounce(self.r if rd.looped else rd.r, rd.cap, k, rd.next_cap, rd.last)
        after = cuda_intersect.counts()
        self.warm_launches = {m: after[m] - before[m] for m in cuda_intersect.SWEEP_MODES}
        self.warm = True

    def start(self, rows: np.ndarray, spans: Optional[Spans] = None):
        """Load a frame's rows; a capturing program first warms up
        (_warm_up, the span "warm_up" in `spans`) and forgets what that
        did."""
        self.rows[:rows.shape[0]].copy_(torch.from_numpy(rows))
        self._fold_keys(rows.shape[0])
        if self.capture and not self.warm:
            with span(spans, "warm_up"):
                self._warm_up()
        self.cursor.zero_()
        self.tile_acc.zero_()
        self.live.zero_()
        self.dropped.zero_()
        if self.refr is not None:
            self.refr.zero_()
        if self.stamps is not None:
            self.stamps.zero_()

    def clock_offset(self) -> tuple:
        """(offset, uncertainty) in ns of the device's stamps against
        time.perf_counter_ns, with the device idle: a stamp between two
        host times, the offset the stamp less their midpoint and the
        uncertainty half their distance; the tightest of eight (one takes
        ~15 us on the card, a few up to ~80)."""
        cuda = self.clock.is_cuda
        best = None
        for _ in range(8):
            t_a = time.perf_counter_ns()
            graphs.stamp(self.clock, self.clock_row, 0)
            if cuda:
                torch.cuda.synchronize(self.clock.device)
            t_b = time.perf_counter_ns()
            half = (t_b - t_a) // 2
            if best is None or half < best[1]:
                best = int(self.clock[0, 0]) - (t_a + half), half
        return best


# Chunk programs kept per tables (SceneTables.chunk_programs).
_MAX_PROGRAMS = 2


def _program(st, cam, cfg, background, settings, size, **shape):
    """The chunk program of this render: on the card with cuda_graphs
    (cfg.captures, any accel and dtype) a capturing one, cached on the
    tables by configuration, camera, frame size, background, chunk shape
    and whether it stamps; otherwise a fresh one that runs op by op."""
    if not cfg.captures:
        return _ChunkProgram(st, cam, cfg, background, capture=False, **shape)
    key = (cfg, background, tuple(size), tuple(sorted(shape.items())),
           tuple(tuple(np.asarray(v, dtype=np.float64).reshape(-1).tolist())
                 for v in (settings.eye, settings.center, settings.up, settings.fovy)))
    cache = st.chunk_programs
    prog = cache.pop(key, None)
    if prog is None:
        prog = _ChunkProgram(st, cam, cfg, background, capture=True, **shape)
        while len(cache) >= _MAX_PROGRAMS:
            cache.pop(next(iter(cache)))
    cache[key] = prog
    return prog


def _render_tiles(prog: _ChunkProgram, grid, *, n_chunks, as_u8, syncs, spans=None,
                  reporter=None):
    """Render every tile of `grid` ((x0, y0) origins) through `prog`, whose
    rows the caller has started: [T, th, tw, 3] mean radiance, or with
    as_u8 the gamma-encoded u8 tiles, on the device.  `syncs` receives each
    chunk's host reads, `spans` one "tile" span a tile; `reporter` ticks
    once per tile."""
    cfg = prog.cfg
    out = []
    n = torch.full((), float(prog.samples), dtype=cfg.dtype, device=cfg.device)
    for x0, y0 in grid:
        with span(spans, "tile", origin=[x0, y0]):
            for _ in range(n_chunks):
                syncs.append(prog.chunk(spans))
            mean = (prog.tile_acc / n).reshape(prog.tile_h, prog.tile_w, 3)
            prog.tile_acc.zero_()
            if as_u8:
                enc = torch.clamp(torch.clamp(mean, min=0.0) ** (1.0 / GAMMA), 0.0, 1.0)
                mean = (enc * 255.0).to(torch.uint8)
            out.append(mean)
            if reporter is not None:
                reporter.tick()
    return torch.stack(out)


def _read_counts(prog: _ChunkProgram, rows: np.ndarray, syncs, stats, spans, frame):
    """After the frame (outside its span, so that the frame's time holds
    none of this): each row's TraceStats into the list `stats`, and with
    `spans` the device spans of each chunk and of its rounds that ran,
    under the span `frame`, on the host's clock."""
    n = len(rows)
    live = prog.live[:n].cpu()
    lanes = launched_lanes(prog.pl, prog.cfg.queue_slice_divs, live)
    refr = prog.refr[:n].cpu() if prog.refr is not None else torch.zeros_like(live)
    if stats is not None:
        dropped = prog.dropped[:n].cpu().tolist()
        R0 = prog.P * prog.spp
        stats.extend(TraceStats(live=live[i], dropped_w=dropped[i] / R0, syncs=syncs[i],
                                lanes=lanes[i], refr=refr[i]) for i in range(n))
    if spans is None:
        return
    stamps = prog.stamps[:n].cpu().tolist()
    offset, unc = prog.clock_offset()
    frame.set(clock_offset_ns=offset, clock_unc_ns=unc)
    D = prog.pl.max_depth
    k_min = [prog.P * prog.spp] + [rd.sizes[0] for rd in prog.rounds]
    for i, ((x0, y0, _, ci), t, lv, ks, rf) in enumerate(zip(
            rows.tolist(), stamps, live.tolist(), lanes.tolist(), refr.tolist())):
        t = [v - offset for v in t]
        chunk = spans.add("chunk", t[0], t[D + 2], frame.rec.id, row=i, tile=[x0, y0],
                          chunk=ci)
        for r, k in enumerate(ks):
            if k:
                spans.add(f"round {r}", t[r], t[r + 1], chunk.id, r=r, k=k, k_min=k_min[r],
                          live=lv[r], refr=rf[r])


def _render_common(scene_or_tables, camera, size, background, cfg, region, as_u8,
                   stats=None, reporter=None, spans=None):
    with span(spans, "frame") as frame:
        out, prog, rows, syncs = _render_frame(scene_or_tables, camera, size, background, cfg,
                                               region, as_u8, reporter, spans, frame)
    if stats is not None or spans is not None:
        _read_counts(prog, rows, syncs, stats, spans, frame)
    return out


def _render_frame(scene_or_tables, camera, size, background, cfg, region, as_u8, reporter,
                  spans, frame):
    """The frame's host phases under the span `frame`: (image on the host,
    program, rows, host reads of each chunk)."""
    if cfg is None:
        cfg = RenderConfig()
    width, height = size
    if isinstance(scene_or_tables, SceneTables):
        st = scene_or_tables
    else:
        with span(spans, "tables"):
            scene = scene_or_tables
            if cfg.render_bounding_volumes:
                scene = bounding_volume_scene(scene)
            st = flatten_scene(scene, cfg.device, dtype=cfg.dtype)
    cam = Camera(camera, (width, height), cfg.device, cfg.dtype)
    samples = cfg.resolved_samples()

    tile_h = min(cfg.tile[0], height)
    tile_w = min(cfg.tile[1], width)
    spp_chunk = max(1, min(samples, cfg.max_rays_per_launch // (tile_h * tile_w)))
    n_chunks = -(-samples // spp_chunk)

    if region is None:
        x_lo, y_lo, x_hi, y_hi = 0, 0, width - 1, height - 1
    else:
        (x_lo, y_lo), (x_hi, y_hi) = region

    # Static tile grid: only tiles intersecting the region.
    grid = []
    for ty in range(-(-height // tile_h)):
        for tx in range(-(-width // tile_w)):
            tx0, ty0 = tx * tile_w, ty * tile_h
            if (tx0 > x_hi or ty0 > y_hi or tx0 + tile_w - 1 < x_lo
                    or ty0 + tile_h - 1 < y_lo):
                continue
            grid.append((tx0, ty0))
    rows = np.array([(x0, y0, ci * spp_chunk, ci) for x0, y0 in grid for ci in range(n_chunks)],
                    dtype=np.int64).reshape(-1, 4)
    frame.set(width=width, height=height, spp=samples, tiles=len(grid), chunks=len(rows),
              rays=(min(x_hi, width - 1) - x_lo + 1) * (min(y_hi, height - 1) - y_lo + 1)
              * samples)

    n_tiles = -(-height // tile_h) * -(-width // tile_w)
    with span(spans, "program"):
        prog = _program(st, cam, cfg, background, camera, size, tile_h=tile_h, tile_w=tile_w,
                        spp=spp_chunk, samples=samples, n_rows=n_tiles * n_chunks,
                        stamps=spans is not None)
    with span(spans, "start"):
        prog.start(rows, spans)
    reporter = reporter or NullProgress(0)
    reporter.start(total=len(grid))
    syncs = []
    with span(spans, "issue"):
        tiles = _render_tiles(prog, grid, n_chunks=n_chunks, as_u8=as_u8, syncs=syncs,
                              spans=spans, reporter=reporter)
    with span(spans, "readback"):
        tiles = tiles.cpu().numpy()
    with span(spans, "assemble"):
        out_dtype = np.uint8 if as_u8 else np.float64
        out = np.zeros((height, width, 3), dtype=out_dtype)
        for (tx0, ty0), tile in zip(grid, tiles):
            ylim = min(ty0 + tile_h, height)
            xlim = min(tx0 + tile_w, width)
            out[ty0:ylim, tx0:xlim] = tile[: ylim - ty0, : xlim - tx0]
    reporter.finish()
    return out, prog, rows, syncs


def render_linear(scene_or_tables, camera: CameraSettings, size: Tuple[int, int],
                  background: Callable = default_background,
                  cfg: Optional[RenderConfig] = None,
                  region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
                  stats: Optional[list] = None,
                  reporter: Optional[Reporter] = None,
                  spans: Optional[Spans] = None) -> np.ndarray:
    """The linear mean-radiance image [H,W,3] (float64 on the host).

    `region` = ((x1,y1),(x2,y2)) inclusive slice to render (others zero).
    A list `stats` receives the TraceStats of every (tile x sample-chunk),
    read from the device once for the frame.  `reporter` (reporter.py)
    ticks once per tile.  A `spans.Spans` receives the frame's spans."""
    return _render_common(scene_or_tables, camera, size, background, cfg, region,
                          as_u8=False, stats=stats, reporter=reporter, spans=spans)


def render_u8(scene_or_tables, camera: CameraSettings, size: Tuple[int, int],
              background: Callable = default_background,
              cfg: Optional[RenderConfig] = None,
              region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
              stats: Optional[list] = None,
              reporter: Optional[Reporter] = None,
              spans: Optional[Spans] = None) -> np.ndarray:
    """The gamma-encoded u8 image [H,W,3] (render.rs:143-147), finalised on
    the device.  `region`, `stats`, `reporter` and `spans` as in
    render_linear."""
    return _render_common(scene_or_tables, camera, size, background, cfg, region,
                          as_u8=True, stats=stats, reporter=reporter, spans=spans)


def finalize(linear: np.ndarray) -> np.ndarray:
    """Gamma-encode + clamp (render.rs:47-50). Returns float [H,W,3] 0..1."""
    return np.clip(np.maximum(linear, 0.0) ** (1.0 / GAMMA), 0.0, 1.0)


def to_u8(img01: np.ndarray) -> np.ndarray:
    """u8 quantisation by truncation, like `(c * 255.0) as u8`."""
    return (img01 * 255.0).astype(np.uint8)


class Image:
    """The reference's Image (src/render.rs:154-224): opens an existing PNG
    of matching size (a region re-render keeps the rest), renders scenes,
    saves PNGs."""

    def __init__(self, path, width: int, height: int):
        self.path = path
        self.width = width
        self.height = height
        self.buffer = np.zeros((height, width, 3), dtype=np.uint8)
        if path is not None and os.path.exists(path):
            img = read_png(path)
            if img.shape == self.buffer.shape:
                self.buffer = img

    def render(self, scene: Scene, camera: CameraSettings,
               background: Callable = default_background,
               cfg: Optional[RenderConfig] = None, region=None, stats=None,
               reporter: Optional[Reporter] = None, spans: Optional[Spans] = None):
        u8 = render_u8(scene, camera, (self.width, self.height), background, cfg,
                       region=region, stats=stats, reporter=reporter, spans=spans)
        if region is None:
            self.buffer = u8
        else:
            (x1, y1), (x2, y2) = region
            self.buffer[y1:y2 + 1, x1:x2 + 1] = u8[y1:y2 + 1, x1:x2 + 1]
        return self

    def slice_render(self, top_left, bottom_right, *args, **kwargs):
        return self.render(*args, region=(top_left, bottom_right), **kwargs)

    def save(self):
        return self.save_as(self.path)

    def save_as(self, path):
        """Write the buffer as a PNG.  The port has no other encoder: a
        path whose suffix is not ``.png`` (in any case) raises."""
        suffix = os.path.splitext(os.fspath(path))[1]
        if suffix.lower() != ".png":
            raise ValueError(f"{path}: only PNG is written, not {suffix or 'no suffix'!r}")
        return write_png(path, self.buffer)
