"""The port's bounce loop against the JAX package's, on the CPU: queue
compaction, traces at max_depth 10 through reflective, glossy and
refractive scenes and an icosphere mirror among meshes, independence of
the live-count slicing, and the torus-showcase self-golden.

Tolerances, with their reasons:
- _compact: the port's queue equals the live head of the JAX package's
  padded queue; equal accumulators and dropped throughput (the same
  selection rule on the same weights).
- A traced tile's per-pixel means: atol 1e-4, the JAX side run without jit
  as in test_torch_shade.py.  The exception is a pixel whose samples hit a
  torus: the f32 quartic's roots move with rounding (the JAX package's own
  torus gate is rtol 1e-3 on t), and shading follows the hit point, so
  such pixels may differ by up to 1e-3.  TraceStats.live is equal and
  dropped_w within 1e-6.
- torus-showcase's u8 render: the rule of tests/test_golden.py (fewer
  than 0.1% of pixels off by more than 2/255) against the JAX package's
  render without jit, and against the self-golden on every pixel but
  those where that JAX render itself is off from the golden (see the
  test).
"""

import importlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
import scenes
import portrayer_tpu as P
from portrayer_tpu.ops import intersect as jx
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import intersect as tx, trace as ttrace
from portrayer_tpu_torch.render import _tile_rays

from _torch_jax import jax_arrays, torus_nodes, INLINE

# The module (portrayer_tpu.ops re-exports its function `trace`).
jtrace = importlib.import_module("portrayer_tpu.ops.trace")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (frame size, 16x16 tile origin): tiles where reflective surfaces (the
# teal torus, the glossy sphere, the glass sphere, the mirror icosphere)
# fill most pixels.
TILES = {
    "torus-showcase": ((64, 64), (32, 0)),
    "glossy-reflection": ((160, 90), (96, 32)),
    "glass-sphere": ((64, 64), (24, 24)),
    "procedural-meshes": ((96, 54), (28, 16)),
}
TILE = 16
SPP = 4


def _queue(w, seed):
    """A JAX and a port child queue with weights w [Q]."""
    g = np.random.default_rng(seed)
    Q = w.shape[0]
    f = {
        "o": g.standard_normal((Q, 3)).astype(np.float32),
        "d": g.standard_normal((Q, 3)).astype(np.float32),
        "w": w.astype(np.float32),
        "pix": g.integers(0, 16, Q).astype(np.int32),
        "t_min": g.uniform(0, 1, Q).astype(np.float32),
        "src_node": g.integers(-1, 9, Q).astype(np.int32),
        "src_tri": np.full(Q, -1, np.int32),
        "sid": g.integers(0, 2**20, Q).astype(np.int32),
    }
    jq = jtrace._Queue(**{k: jnp.asarray(v) for k, v in f.items()})
    tq = ttrace._Queue(**{k: torch.from_numpy(v) for k, v in f.items()})
    return jq, tq


@pytest.mark.parametrize("case", ["fits", "overflow-ties"])
def test_compact_matches_jax(case):
    """Order-preserving compaction: a queue that fits keeps its live lanes
    in order; one that overflows keeps the capacity largest weights, ties
    first-come, and sends the rest to the background."""
    g = np.random.default_rng(7)
    Q = 300
    w = np.where(g.uniform(size=Q) < 0.4, 0.0, g.choice([0.25, 0.5, 0.125, 0.3], Q))
    cap = Q if case == "fits" else 96
    assert case == "fits" or (w > 0).sum() > cap
    jq, tq = _queue(w, 3)
    bg = g.uniform(0, 1, (16, 3)).astype(np.float32)
    acc = g.uniform(0, 1, (16, 3)).astype(np.float32)
    jout, jacc, jdrop = jtrace._compact(jq, cap, jnp.asarray(acc), jnp.asarray(bg))
    tout, tacc, tdrop, n_live = ttrace._compact(tq, cap, torch.from_numpy(acc),
                                                torch.from_numpy(bg))
    assert n_live == int((np.asarray(jout.w) > 0).sum()) == min((w > 0).sum(), cap)
    for f in jtrace._Queue._fields:
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f))[:n_live], err_msg=f)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6, atol=1e-6)
    assert float(tdrop) == pytest.approx(float(jdrop), rel=1e-6, abs=1e-7)
    assert (float(tdrop) > 0) == (case != "fits")


def _tile(name):
    """(JAX tables, port tables, the tile's rays as the port's render loop
    builds them, chunk key) for the 16x16 tile of TILES[name], 4 spp."""
    if name in INLINE:
        jscene = INLINE[name](P)[0]
        tscene, camera, _ = INLINE[name](T)
        background = T.render.default_background
    else:
        jscene = scenes.load(name).scene
        spec = tscenes.load(name)
        camera, background = spec.camera, spec.background
    size, (x0, y0) = TILES[name]
    js = P.flatten_scene(jscene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    cfg = T.RenderConfig(device="cpu", samples=SPP, tile=(TILE, TILE), seed=0)
    ckey = rng.fold_in(rng.fold_in(rng.fold_in(rng.PRNGKey(0), x0), y0), 0)
    rays = _tile_rays(ckey, Camera(camera, size, "cpu"), x0, y0, 0, cfg=cfg,
                      background=background, tile_h=TILE, tile_w=TILE, spp=SPP, samples=SPP)
    return js, ts, rays, ckey, cfg


@pytest.mark.parametrize("name", list(TILES))
def test_trace_bounces_match_jax(name):
    """One 16x16 tile at 4 spp and max_depth 10, its rays built by the
    port's render loop, traced by both packages with the same trace key."""
    js, ts, rays, ckey, cfg = _tile(name)
    n = TILE * TILE
    x0, y0 = TILES[name][1]
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), x0), y0), 0), 1)
    jcfg = P.RenderConfig(accel="flat", node_chunk=128)
    with jax.disable_jit():
        ref, jst = jtrace.trace(jkey, *(jnp.asarray(x.numpy()) for x in rays[:4]), n, js, jcfg,
                                w0=jnp.asarray(rays[4].numpy()), spp_contiguous=SPP,
                                with_stats=True)
    o, d, pix, bg, w0 = rays
    got, st = ttrace.trace(rng.fold_in(ckey, 1), o, d, pix, bg, n, ts, cfg, w0=w0,
                           spp_contiguous=SPP, with_stats=True)
    np.testing.assert_array_equal(st.live.numpy(), np.asarray(jst.live))
    assert st.live[1] > n  # bounce rounds ran
    assert abs(float(st.dropped_w) - float(jst.dropped_w)) <= 1e-6
    got, ref = got.numpy() / SPP, np.asarray(ref) / SPP
    diff = np.abs(got - ref).max(axis=-1)
    # Pixels with a torus among their samples' primary hits.
    hit = jx.intersect_scene(rays[0].numpy(), rays[1].numpy(), 1e-5, jnp.inf, js,
                             P.RenderConfig(accel="flat"))
    torus = np.isin(np.asarray(hit.node), torus_nodes(js)).reshape(n, SPP).any(axis=1)
    assert diff[~torus].max() <= 1e-4, diff[~torus].max()
    assert diff[torus].max(initial=0.0) <= 1e-3


def test_live_slicing_moves_no_pixel(monkeypatch):
    """Bounce rounds on the live lanes of each queue, or on its full
    capacity (dead lanes padded after them, as the JAX package's queues
    are): the glossy draws are keyed by sample id, so the pixels are the
    same."""
    _, ts, rays, ckey, cfg = _tile("glossy-reflection")
    o, d, pix, bg, w0 = rays
    args = (rng.fold_in(ckey, 1), o, d, pix, bg, TILE * TILE, ts, cfg)
    sliced, st = ttrace.trace(*args, w0=w0, spp_contiguous=SPP, with_stats=True)
    assert st.live[1] > 0
    compact = ttrace._compact
    fill = {"o": 0.0, "d": 1.0, "w": 0.0, "pix": 0, "t_min": 1.0, "src_node": -1,
            "src_tri": -1, "sid": 0}

    def padded(child, capacity, acc, bg):
        q, acc, dropped, n_live = compact(child, capacity, acc, bg)
        pad = lambda f, x: torch.cat([x, torch.full((capacity - n_live,) + x.shape[1:],
                                                    fill[f], dtype=x.dtype)])
        return ttrace._Queue(*(pad(f, x) for f, x in zip(q._fields, q))), acc, dropped, n_live

    monkeypatch.setattr(ttrace, "_compact", padded)
    full, fst = ttrace.trace(*args, w0=w0, spp_contiguous=SPP, with_stats=True)
    assert fst.live.tolist() == st.live.tolist()
    np.testing.assert_allclose(full.numpy(), sliced.numpy(), rtol=0, atol=1e-6)


def test_render_u8_torus_showcase_matches_self_golden():
    """torus-showcase at the self-golden's 64x64, 4 spp, seed 0, tile 64
    (tools/gen_self_goldens.py), through the port's render loop.  Against
    the JAX package's render run op by op (no jit): the self-golden rule.
    The golden was rendered jitted, where XLA contracts the torus quartic's
    mul+adds into FMAs; the f32 roots move within the torus gate and x^160
    highlights carry that into the colour, so the JAX package's own op-by-op
    render is off from its golden on a few torus pixels.  Those pixels are
    chip_smoke.TORUS_JIT_PIXELS (chip_smoke.py's golden phase has no JAX to
    find them); on every other pixel the port keeps the self-golden rule."""
    spec = tscenes.load("torus-showcase")
    cfg = T.RenderConfig(device="cpu", samples=4, tile=(64, 64), seed=0)
    ours = T.render_u8(spec.scene, spec.camera, (64, 64), spec.background, cfg)
    jspec = scenes.load("torus-showcase")
    with jax.disable_jit():
        ref = np.asarray(P.render_u8(jspec.scene, jspec.camera, (64, 64), jspec.background,
                                     P.RenderConfig(samples=4, tile=(64, 64), seed=0,
                                                    accel="flat", node_chunk=128)))
    gold = image_io.read_png(os.path.join(ROOT, "tests", "self_golden", "torus-showcase.png"))
    assert ours.shape == gold.shape == ref.shape

    def off(a, b):
        return (np.abs(a.astype(np.int16) - b.astype(np.int16)) > 2).any(axis=-1).reshape(-1)

    assert off(ours, ref).mean() < 1e-3, f"{off(ours, ref).mean():.2%} pixels differ from JAX"
    jit_pixels = np.nonzero(off(ref, gold))[0]
    assert jit_pixels.tolist() == list(chip_smoke.TORUS_JIT_PIXELS)
    rest = off(ours, gold)
    rest[jit_pixels] = False
    assert rest.mean() < 1e-3, f"{rest.mean():.2%} pixels differ from the golden"
