"""``TraceStats.refr``, the refracted children among the live rays entering
each round: counted on the device inside the chunk program (op by op, and
through the stand-in capture, whose tail rounds run in a loop on a device
round index, the same) and by the op-by-op ``trace(..., with_stats=True)``,
against a count of the refracted children that ``_compact`` kept, taken
beside the program; all zeros, with nothing counted, on a scene without a
refractive material.  The water-glass scene is the benchmark's
(``portbench/``), cut to a CPU size."""

import os
import sys

import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import render, rng
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import trace as tr

from _torch_jax import stand_in_graphs

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import bench, family  # noqa: E402

SIZE = (48, 27)
CFG = dict(device="cpu", samples=6, tile=(16, 16), max_rays_per_launch=16 * 16 * 8,
           seed=2**31 + 41)


def _water_glass():
    data = bench.Spec().config("water-glass")
    scene, cam, bg, overrides = family.lookup(data).build(T, data)
    return T.flatten_scene(scene, "cpu"), cam, bg, T.RenderConfig(**CFG, **overrides)


class _Kept:
    """A spy on ``_compact``: per chunk (a chunk starts at ``first_round``),
    the refracted children it kept for each next round (the refract half of
    the child queue, live lanes), summed at their round."""

    def __init__(self, monkeypatch, depth: int):
        self.chunks, self.depth = [], depth
        compact, first = tr._compact, tr.first_round

        def first_round(*a, **k):
            self.chunks.append([0] * (depth + 1))
            self.r = 0
            return first(*a, **k)

        def spy(child, capacity, acc, bg):
            half = child.w.shape[0] // 2
            self.r += 1
            self.chunks[-1][self.r] += int((child.w[half:] > 0.0).sum())
            return compact(child, capacity, acc, bg)

        monkeypatch.setattr(tr, "first_round", first_round)
        monkeypatch.setattr(render, "first_round", first_round)
        monkeypatch.setattr(tr, "_compact", spy)


def test_the_chunk_program_counts_the_refracted_children(monkeypatch):
    st, cam, bg, cfg = _water_glass()
    kept = _Kept(monkeypatch, cfg.max_depth)
    stats = []
    T.render_u8(st, cam, SIZE, bg, cfg, stats=stats)
    got = [s.refr.tolist() for s in stats]
    assert got == kept.chunks
    assert sum(map(sum, got)) > 0 and all(r[0] == 0 for r in got)
    assert all(f <= lv for s in stats for f, lv in zip(s.refr.tolist(), s.live.tolist()))


def test_the_captured_count_equals_the_op_by_op_one(monkeypatch):
    st, cam, bg, cfg = _water_glass()
    plain = []
    T.render_u8(st, cam, SIZE, bg, cfg, stats=plain)
    stand_in_graphs(monkeypatch)
    stats = []
    T.render_u8(st, cam, SIZE, bg, cfg)
    T.render_u8(st, cam, SIZE, bg, cfg, stats=stats)
    assert [s.refr.tolist() for s in stats] == [s.refr.tolist() for s in plain]
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in plain]


def test_the_op_by_op_trace_counts_the_refracted_children(monkeypatch):
    """trace(..., with_stats=True) on one chunk of camera rays."""
    st, cam, bg, cfg = _water_glass()
    camera = render.Camera(cam, SIZE, "cpu", torch.float32)
    key = rng.PRNGKey(7)
    o, d, pix, bgc, w0 = render._tile_rays(key, camera, 16, 8, 0, cfg=cfg, background=bg,
                                           tile_h=16, tile_w=16, spp=8, samples=6)
    kept = _Kept(monkeypatch, cfg.max_depth)
    _, s = tr.trace(key, o, d, pix, bgc, 256, st, cfg, w0=w0, spp_contiguous=8,
                    with_stats=True)
    assert s.refr.tolist() == kept.chunks[0] and sum(kept.chunks[0]) > 0


def test_no_refractive_material_counts_nothing(monkeypatch):
    """glossy-reflection's tables: no refr table, no counting op (the count
    raises if called), and TraceStats.refr all zeros from both paths."""
    spec = tscenes.load("glossy-reflection")
    st = T.flatten_scene(spec.scene, "cpu")
    cfg = T.RenderConfig(**CFG)

    def never(q):
        raise AssertionError("counted refracted children without a refractive material")

    monkeypatch.setattr(render, "refracted", never)
    monkeypatch.setattr(tr, "refracted", never)
    stats = []
    T.render_u8(st, spec.camera, SIZE, spec.background, cfg, stats=stats)
    assert stats and all(s.refr.tolist() == [0] * (cfg.max_depth + 1) for s in stats)
    assert sum(int(s.live[1:].sum()) for s in stats) > 0
    camera = render.Camera(spec.camera, SIZE, "cpu", torch.float32)
    prog = render._ChunkProgram(st, camera, cfg, spec.background, tile_h=16, tile_w=16, spp=8,
                                samples=6, n_rows=1, capture=False)
    assert prog.refr is None
    key = rng.PRNGKey(7)
    o, d, pix, bgc, w0 = render._tile_rays(key, camera, 0, 0, 0, cfg=cfg,
                                           background=spec.background, tile_h=16, tile_w=16,
                                           spp=8, samples=6)
    _, s = tr.trace(key, o, d, pix, bgc, 256, st, cfg, w0=w0, spp_contiguous=8,
                    with_stats=True)
    assert s.refr.tolist() == [0] * (cfg.max_depth + 1)
