"""The flat sweep (ops/intersect.py ``_flat_intersect`` and ``occluded``)
inside the captured chunk program, on the CPU: the sweep reads nothing
on the host, so the chunk that the card captures as one CUDA graph with
accel="flat" does not either, and replaying it gives the op-by-op chunk
loop's image; the same in the float64 check mode, whose tables and
buffers the program holds in float64, through the flat and the beam
sweep.

The captured program runs through tests/_torch_jax.py's StandInGraph
(its switch and loop read their conditions on the host with the reads
excused; everything else a replay runs under HostReads).  One torch
thread (tests/_torch_jax.py).

Scenes: glossy-reflection at 32x18 x 1 spp in tiles of 16x16 (four
chunks; ten bounce rounds, rounds 1-9 the loop over the tail), in
float32 and float64; procedural-meshes (tests/_torch_jax.py:
analytic nodes and 769 mesh pairs) on test_torch_intersect.py's camera
and shadow rays, with the surfaces they leave.

Tolerances, with their reasons:
- the captured program against the op-by-op one: equal bit for bit (the
  same ops on the same inputs, in one thread);
- against the JAX package's jitted render_linear (accel="flat"):
  test_torch_render.py's image rule (at most 1% of pixels off by more
  than 1e-4, none by more than 2e-2), for XLA's FMA contraction.
"""

import dataclasses

import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import cuda_intersect, intersect as tx

from _torch_jax import (HostReads, beam_loops, recorded_bodies, recorded_loops,
                        stand_in_graphs)
from test_torch_intersect import T_FLAT, _t, setup
from test_torch_render import assert_images_close

SIZE = (32, 18)
CFG = dict(samples=1, tile=(16, 16), max_rays_per_launch=1024, seed=0)
INF = float("inf")


@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


def test_flat_sweep_reads_nothing_on_the_host():
    """The flat sweep's nearest and any-hit queries on procedural-meshes'
    analytic nodes and mesh pairs, camera rays and shadow rays that name
    the surfaces they leave, under HostReads: no op reads a value on the
    host or copies host data, and each call adds one to the flat sweeps
    counted on the device."""
    _, ts, prim, sh = setup("procedural-meshes")
    src = dict(active=_t(sh["active"]), src_node=_t(sh["src_node"]),
               src_tri=_t(sh["src_tri"]))
    o, d, sho, shd, tmin = (_t(x) for x in (*prim, sh["o"], sh["d"], sh["t_min"]))
    cuda_intersect.reset_counts()
    with HostReads() as reads:
        hit = tx.intersect_scene(o, d, 1e-5, INF, ts, T_FLAT)
        near = tx.intersect_scene(sho, shd, tmin, INF, ts, T_FLAT, **src)
        occ = tx.occluded(sho, shd, tmin, INF, ts, T_FLAT, **src)
    assert reads.seen == []
    assert bool(hit.hit.any()) and bool(occ.any()) and torch.equal(occ, near.hit)
    assert cuda_intersect.counts()["flat_sweep"] == 3


def _render(cfg, name="glossy-reflection"):
    """(linear image, TraceStats of each chunk, the program or None, sweep
    counts) of `name` through render_linear."""
    spec = tscenes.load(name)
    st = T.flatten_scene(spec.scene, "cpu", dtype=cfg.dtype)
    stats = []
    cuda_intersect.reset_counts()
    img = T.render_linear(st, spec.camera, SIZE, spec.background, cfg, stats=stats)
    progs = list(st.chunk_programs.values())
    return img, stats, progs[-1] if progs else None, cuda_intersect.counts()


def _check_captured(stand_in, cfg, name):
    """The captured chunk program of `name` under cfg against the op-by-op
    one (see the callers); returns the captured image."""
    img, stats, prog, counts = _render(cfg, name)
    assert stand_in.seen == []
    eimg, estats, _, eager = _render(dataclasses.replace(cfg, cuda_graphs=False), name)
    np.testing.assert_array_equal(img, eimg)
    assert img.dtype == np.float64 and prog.tile_acc.dtype == cfg.dtype
    assert [(s.live.tolist(), s.dropped_w) for s in stats] == \
        [(s.live.tolist(), s.dropped_w) for s in estats]
    assert all(s.syncs == 0 for s in stats) and any(s.syncs > 0 for s in estats)
    g = prog.graphs["chunk"]
    assert list(prog.graphs) == ["chunk"] and g.replays == len(stats) == 4
    assert g.bodies == recorded_bodies(prog.pl, cfg.queue_slice_divs)
    for mode in ("flat_sweep", "beam_sweep", "beam_step"):
        assert counts[mode] == eager[mode] + prog.warm_launches[mode], mode
    assert eager["nearest"] == eager["any_hit"] == 0
    return img, prog, eager


def test_captured_flat_chunk_equals_op_by_op_and_jax(stand_in):
    """glossy-reflection's captured chunk with accel="flat" against the
    op-by-op loop: the same image, live rays per round and dropped_w bit
    for bit, 0 host reads and host syncs a chunk; one graph, one replay a
    chunk, its bodies from the plan and its one loop the tail's (the flat
    sweep has none); the flat sweeps counted on the device those of the
    op-by-op loop (the first render's with its warm-up's).  The image
    matches the JAX package's jitted render_linear with accel="flat"."""
    cfg = T.RenderConfig(device="cpu", accel="flat", **CFG)
    img, prog, eager = _check_captured(stand_in, cfg, "glossy-reflection")
    assert prog.graphs["chunk"].loops == recorded_loops(prog.pl) == 1
    assert eager["flat_sweep"] > 0 and eager["beam_step"] == 0
    jspec = scenes.load("glossy-reflection")
    jcfg = P.RenderConfig(accel="flat", **CFG)
    ref = np.asarray(P.render_linear(jspec.scene, jspec.camera, SIZE, jspec.background, jcfg))
    assert_images_close(img, ref)


@pytest.mark.parametrize("accel", ["flat", "beam"])
def test_captured_float64_chunk_equals_op_by_op(stand_in, accel):
    """The float64 check mode through the captured chunk program: tables,
    rays and the program's buffers in float64, the replays equal to the
    op-by-op loop bit for bit, no host read; with accel="beam" (and
    beam_min_prims=0) its loops in round 0 and in every slice body."""
    extra = dict(beam_min_prims=0) if accel == "beam" else {}
    cfg = T.RenderConfig(device="cpu", accel=accel, dtype=torch.float64, **CFG, **extra)
    _, prog, eager = _check_captured(stand_in, cfg, "glossy-reflection")
    assert prog.st.inv.dtype == torch.float64
    assert (eager["beam_step"] > 0) == (accel == "beam")
    per_round = 2 * beam_loops(prog.st, cfg)  # nearest and shadow rays
    assert prog.graphs["chunk"].loops == recorded_loops(prog.pl, cfg.queue_slice_divs,
                                                        per_round)
