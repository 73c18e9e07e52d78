"""The port's bounce loop against the JAX package's, on the CPU: queue
compaction, traces at max_depth 10 through reflective, glossy and
refractive scenes and an icosphere mirror among meshes, independence of
the live-count slicing and its branch index on the device.  The
torus-showcase self-golden is in tests/test_torch_trace_torus_golden.py.

Tolerances, with their reasons:
- _compact: the port's fixed-capacity queue equals the JAX package's on
  every field, the padding of the dead slots included; equal accumulators
  and dropped throughput (the same selection rule on the same weights).
- A traced tile's per-pixel means: atol 1e-4, the JAX side run without jit
  as in test_torch_shade.py.  The exception is a pixel whose samples hit a
  torus: the f32 quartic's roots move with rounding (the JAX package's own
  torus gate is rtol 1e-3 on t), and shading follows the hit point, so
  such pixels may differ by up to 1e-3.  TraceStats.live is equal,
  dropped_w within 1e-6, and every round runs on the same head slice.
- slice_sel against the JAX package's formula: equal.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.ops import intersect as jx
import portrayer_tpu_torch as T
from portrayer_tpu_torch import rng, scenes as tscenes
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
    assert n_live.dtype == torch.int64 and n_live.dim() == 0
    assert int(n_live) == int((np.asarray(jout.w) > 0).sum()) == min((w > 0).sum(), cap)
    for f in jtrace._Queue._fields:
        got, ref = getattr(tout, f).numpy(), np.asarray(getattr(jout, f))
        assert got.shape == ref.shape and got.shape[0] == cap, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6, atol=1e-6)
    assert float(tdrop) == pytest.approx(float(jdrop), rel=1e-6, abs=1e-7)
    assert (float(tdrop) > 0) == (case != "fits")


def _tile(name, **kw):
    """(JAX tables, port tables, the tile's rays as the port's render loop
    builds them, chunk key, config with `kw`) for the 16x16 tile of
    TILES[name], 4 spp."""
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
    cfg = T.RenderConfig(device="cpu", samples=SPP, tile=(TILE, TILE), seed=0, **kw)
    ckey = rng.fold_in(rng.fold_in(rng.fold_in(rng.PRNGKey(0), x0), y0), 0)
    rays = _tile_rays(ckey, Camera(camera, size, "cpu"), x0, y0, 0, cfg=cfg,
                      background=background, tile_h=TILE, tile_w=TILE, spp=SPP, samples=SPP)
    return js, ts, rays, ckey, cfg


def _slices(monkeypatch, module):
    """Record the lanes of every nearest-hit query of `module`'s trace: a
    bounce round's is the head slice it runs on."""
    seen = []
    nearest = module._nearest

    def spy(q, st, cfg):
        seen.append(int(q.o.shape[0]))
        return nearest(q, st, cfg)

    monkeypatch.setattr(module, "_nearest", spy)
    return seen


# On glass-sphere's tile, a round-1 queue of 4x the 1,024 primary rays
# holds its 2,008 live rays in a head slice of 2,048 lanes; the later
# queues of 1x overflow and drop children (3.3% of the throughput).
SLICED = {"queue_caps": (4.0, 1.0)}


@pytest.mark.parametrize("name, kw", [(n, {}) for n in TILES]
                         + [("glass-sphere", SLICED)],
                         ids=list(TILES) + ["glass-sphere-sliced"])
def test_trace_bounces_match_jax(name, kw, monkeypatch):
    """One 16x16 tile at 4 spp and max_depth 10, its rays built by the
    port's render loop, traced by both packages with the same trace key:
    the same live rays and head slice in every round, with small queues
    (kw) the same dropped throughput."""
    js, ts, rays, ckey, cfg = _tile(name, **kw)
    n = TILE * TILE
    x0, y0 = TILES[name][1]
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), x0), y0), 0), 1)
    jcfg = P.RenderConfig(accel="flat", node_chunk=128, **kw)
    jslices, tslices = _slices(monkeypatch, jtrace), _slices(monkeypatch, ttrace)
    with jax.disable_jit():
        ref, jst = jtrace.trace(jkey, *(jnp.asarray(x.numpy()) for x in rays[:4]), n, js, jcfg,
                                w0=jnp.asarray(rays[4].numpy()), spp_contiguous=SPP,
                                with_stats=True)
    o, d, pix, bg, w0 = rays
    got, st = ttrace.trace(rng.fold_in(ckey, 1), o, d, pix, bg, n, ts, cfg, w0=w0,
                           spp_contiguous=SPP, with_stats=True)
    np.testing.assert_array_equal(st.live.numpy(), np.asarray(jst.live))
    assert tslices == jslices
    assert st.live[1] > n  # bounce rounds ran
    assert abs(float(st.dropped_w) - float(jst.dropped_w)) <= 1e-6
    if kw:
        assert 2048 in tslices[1:] and st.dropped_w > 0  # head slices and overflow ran
    got, ref = got.numpy() / SPP, np.asarray(ref) / SPP
    diff = np.abs(got - ref).max(axis=-1)
    # Pixels with a torus among their samples' primary hits.
    hit = jx.intersect_scene(rays[0].numpy(), rays[1].numpy(), 1e-5, jnp.inf, js,
                             P.RenderConfig(accel="flat"))
    torus = np.isin(np.asarray(hit.node), torus_nodes(js)).reshape(n, SPP).any(axis=1)
    assert diff[~torus].max() <= 1e-4, diff[~torus].max()
    assert diff[torus].max(initial=0.0) <= 1e-3


def test_live_slicing_moves_no_pixel(monkeypatch):
    """Bounce rounds on the smallest head slice of each queue that holds
    its live rays (the default queue_slice_divs), or every round on the
    full capacity (queue_slice_divs=(1,)): the glossy draws are keyed by
    sample id, so the pixels and the live counts are the same."""
    _, ts, rays, ckey, cfg = _tile("glossy-reflection", queue_caps=(4.0,))
    o, d, pix, bg, w0 = rays
    args = (rng.fold_in(ckey, 1), o, d, pix, bg, TILE * TILE, ts)
    seen = _slices(monkeypatch, ttrace)
    sliced, st = ttrace.trace(*args, cfg, w0=w0, spp_contiguous=SPP, with_stats=True)
    assert st.live[1] > 0 and seen[1:] == [2048] * (len(seen) - 1)
    seen.clear()
    full, fst = ttrace.trace(*args, dataclasses.replace(cfg, queue_slice_divs=(1,)), w0=w0,
                             spp_contiguous=SPP, with_stats=True)
    assert seen[1:] == [4096] * (len(seen) - 1)
    assert fst.live.tolist() == st.live.tolist() and fst.syncs == st.syncs
    assert fst.dropped_w == st.dropped_w == 0.0
    np.testing.assert_allclose(full.numpy(), sliced.numpy(), rtol=0, atol=1e-6)


PLANS = [((4.0,), (16, 4, 1)), ((4.0, 1.0, 0.5), (16, 4, 1)), ((3.0, 0.75), (8, 2)),
         ((1.0,), (1,))]


@pytest.mark.parametrize("caps, divs", PLANS)
def test_slice_sel_matches_jax(caps, divs):
    """The branch index that slice_sel computes on the device, for every
    live count from 0 to each round's capacity (the plans of
    test_slice_sizes_match_jax), equals the JAX package's round_r formula
    (portrayer_tpu/ops/trace.py: jnp.where(n_live > 0, 1 +
    jnp.searchsorted(sizes, n_live), 0)); pick_slice, the host form of
    the op-by-op trace, takes the same branch."""
    R0, depth = 8192, 4
    st = T.flatten_scene(tscenes.load("glossy-reflection").scene, "cpu")
    pl = ttrace.plan(R0, st, T.RenderConfig(device="cpu", max_depth=depth, queue_caps=caps))
    for r in range(1, depth + 1):
        sizes = ttrace.slice_sizes(pl.cap[r], divs)
        n = np.arange(pl.cap[r] + 1)
        want = np.asarray(jnp.where(n > 0, 1 + jnp.searchsorted(jnp.asarray(sizes, jnp.int32),
                                                                 jnp.asarray(n, jnp.int32)), 0))
        sel = ttrace.slice_sel(torch.as_tensor(n), sizes)
        assert sel.dtype == torch.int64
        np.testing.assert_array_equal(sel.numpy(), want)
        branches = (0,) + sizes
        assert [ttrace.pick_slice(sizes, i) for i in n.tolist()] == \
            [branches[i] for i in want.tolist()]


@pytest.mark.parametrize("caps, divs", PLANS)
def test_slice_sizes_match_jax(monkeypatch, caps, divs):
    """The head slices a round may run on, for several capacity schedules
    and queue_slice_divs at 8,192 primary rays: the JAX package's trace,
    traced (not run) by make_jaxpr, builds one lax.switch branch per slice
    in each head round and one in the scan body of the rounds of equal
    capacity; each branch's nearest-hit query has the port's slice size."""
    R0, depth = 8192, 4
    js = P.flatten_scene(scenes.load("glossy-reflection").scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    jcfg = P.RenderConfig(accel="flat", max_depth=depth, queue_caps=caps,
                          queue_slice_divs=divs)
    seen = _slices(monkeypatch, jtrace)
    z = jnp.zeros((R0, 3), jnp.float32)
    jax.make_jaxpr(lambda o, d: jtrace.trace(jax.random.PRNGKey(0), o, d,
                                             jnp.zeros((R0,), jnp.int32), z, R0, js, jcfg))(z, z)
    pl = ttrace.plan(R0, ts, T.RenderConfig(device="cpu", max_depth=depth, queue_caps=caps))
    tail = depth
    while tail > 1 and pl.cap[tail - 1] == pl.cap[depth]:
        tail -= 1
    want = [R0] + [k for r in list(range(1, tail)) + [depth]
                   for k in ttrace.slice_sizes(pl.cap[r], divs)]
    assert seen == want
    assert ttrace.pick_slice(ttrace.slice_sizes(pl.cap[1], divs), 0) == 0
    for n in (1, 2048, 2049, pl.cap[1]):
        k = ttrace.pick_slice(ttrace.slice_sizes(pl.cap[1], divs), n)
        assert k >= n and all(s < n for s in ttrace.slice_sizes(pl.cap[1], divs) if s < k)
