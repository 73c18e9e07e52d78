"""The port's intersection against the JAX package on the same rays and
the same tables (carried across by tables_from_numpy): candidate
functions, the flat sweep and occlusion query, winner_t and hit_detail,
and the sweep kernel's plain version against the JAX Pallas kernel run in
interpret mode.

Tolerances: the JAX package's kernel gates (tests/test_pallas.py) — .hit
equal; node mismatches on at most 0.2% of hits and only within 2*2^-16
relative t; elsewhere t within rtol 1e-4 / atol 1e-5.  XLA on the CPU
contracts mul+add into FMA and divides by constants through reciprocals,
so values agree to f32 rounding, not bit for bit.  The JAX side runs op by
op (no jit), where XLA fuses least."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops.pallas_intersect import intersect_scene_pallas
import portrayer_tpu_torch as T
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops.cuda_intersect import (
    intersect_scene_cuda, intersect_scene_sweep_ref,
)

from _torch_jax import jax_arrays, assert_gates

INF = float("inf")
J_FLAT = P.RenderConfig(accel="flat")
J_PAL = P.RenderConfig(accel="pallas", pallas_interpret=True)
T_SWEEP = T.RenderConfig(device="cpu")
T_FLAT = T.RenderConfig(device="cpu", accel="flat")
SCENES = ["simple", "big-scene"]
_cache = {}


def setup(name, n=512, seed=0):
    """(JAX tables, port tables, primary rays, shadow rays) for `name`:
    camera rays through uniform numpy-drawn image points, and rays from
    their JAX flat hits toward every light with src_node/src_tri set."""
    if name in _cache:
        return _cache[name]
    spec = scenes.load(name)
    w, h = spec.size
    js = P.flatten_scene(spec.scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, w, n), jnp.float32)
    py = jnp.asarray(rng.uniform(0, h, n), jnp.float32)
    o, d = (np.array(a) for a in JaxCamera(spec.camera, (w, h)).rays_at(px, py))
    hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    t = np.where(np.asarray(hit.hit), np.asarray(hit.t), 0.0)
    p = (o + t[:, None] * d).astype(np.float32)
    # One shadow ray per camera ray, toward lights in turn (same shapes as
    # the camera rays, so the JAX side compiles once per shape).
    lp = np.asarray(js.light_pos)[np.arange(n) % js.n_lights]
    dirs = lp - p
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    shadow = dict(
        o=p, d=dirs, t_min=np.maximum(1e-5, 3e-4 * np.linalg.norm(p, axis=-1)).astype(np.float32),
        active=np.asarray(hit.hit), src_node=np.asarray(hit.node), src_tri=np.asarray(hit.tri),
    )
    _cache[name] = (js, ts, (o, d), shadow)
    return _cache[name]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["sphere", "cube", "cylinder", "cone"])
def test_candidates_match_jax(kind):
    rng = np.random.default_rng(1)
    o = (rng.standard_normal((256, 4, 3)) * 1.5).astype(np.float32)
    d = (rng.uniform(-0.6, 0.6, (256, 4, 3)) - o).astype(np.float32)
    t_min = np.full((256, 4), 1e-5, np.float32)
    t_max = np.full((256, 4), np.inf, np.float32)
    jf = getattr(jx, f"{kind}_candidate")
    tf = getattr(tx, f"{kind}_candidate")
    ref = np.asarray(jf(o, d, t_min, t_max, 1e-5))
    got = tf(_t(o), _t(d), _t(t_min), _t(t_max), 1e-5).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    assert fin.mean() > 0.1
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", SCENES)
def test_flat_sweep_and_occluded_match_jax(name):
    js, ts, (o, d), sh = setup(name)
    ref = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    got = tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT)
    assert_gates(ref, got)
    src = dict(active=sh["active"], src_node=sh["src_node"], src_tri=sh["src_tri"])
    ref = jx.intersect_scene(sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_FLAT, **src)
    got = tx.intersect_scene(_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_FLAT,
                             **{k: _t(v) for k, v in src.items()})
    assert_gates(ref, got, sh["src_node"])
    occ_ref = jx.occluded(sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_FLAT, **src)
    occ = tx.occluded(_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_FLAT,
                      **{k: _t(v) for k, v in src.items()})
    np.testing.assert_array_equal(np.asarray(occ_ref), occ.numpy())


@pytest.mark.parametrize("name", SCENES)
def test_winner_t_and_hit_detail_match_jax(name):
    js, ts, (o, d), sh = setup(name)
    for rays, src in (((o, d, 1e-5), {}),
                      ((sh["o"], sh["d"], sh["t_min"]),
                       dict(src_node=sh["src_node"], src_tri=sh["src_tri"]))):
        ro, rd, tmin = rays
        hit = jx.intersect_scene(ro, rd, tmin, jnp.inf, js, J_FLAT, **src)
        wt_ref = jx.winner_t(ro, rd, hit.node, hit.tri, js, J_FLAT, tmin, **src)
        det_ref = jx.hit_detail(ro, rd, hit, js, J_FLAT, tmin, **src)
        hm = np.asarray(hit.hit)
        assert hm.any()
        thit = tx.Hit(*(_t(np.asarray(x)) for x in hit))
        tsrc = {k: _t(v) for k, v in src.items()}
        tmin_t = tmin if np.isscalar(tmin) else _t(tmin)
        wt = tx.winner_t(_t(ro), _t(rd), thit.node, thit.tri, ts, T_FLAT, tmin_t,
                         **tsrc).numpy()
        np.testing.assert_allclose(wt[hm], np.asarray(wt_ref)[hm], rtol=1e-4, atol=1e-5)
        det = tx.hit_detail(_t(ro), _t(rd), thit, ts, T_FLAT, tmin_t, **tsrc)
        for f in ("point", "normal", "uv", "nmt"):
            np.testing.assert_allclose(getattr(det, f).numpy()[hm],
                                       np.asarray(getattr(det_ref, f))[hm],
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        for f in ("has_uv", "has_nmt", "material"):
            np.testing.assert_array_equal(getattr(det, f).numpy(),
                                          np.asarray(getattr(det_ref, f)), err_msg=f)
        np.testing.assert_array_equal(det.rec.numpy()[hm], np.asarray(det_ref.rec)[hm])


@pytest.mark.parametrize("name", SCENES)
def test_sweep_plain_version_matches_pallas_kernel(name):
    """The sweep's plain version (what the CUDA kernel computes) against the
    JAX Pallas kernel in interpret mode, nearest and any-hit, with and
    without src_node."""
    js, ts, (o, d), sh = setup(name)
    ref = intersect_scene_pallas(o, d, 1e-5, jnp.inf, js, J_PAL)
    got = intersect_scene_cuda(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP)
    assert_gates(ref, got)
    src = dict(active=sh["active"], src_node=sh["src_node"], src_tri=sh["src_tri"])
    tsrc = {k: _t(v) for k, v in src.items()}
    args_j = (sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_PAL)
    args_t = (_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_SWEEP)
    assert_gates(intersect_scene_pallas(*args_j, **src), intersect_scene_cuda(*args_t, **tsrc),
                 sh["src_node"])
    ref_any = intersect_scene_pallas(*args_j, **src, any_hit=True)
    got_any = intersect_scene_cuda(*args_t, **tsrc, any_hit=True)
    np.testing.assert_array_equal(np.asarray(ref_any.hit), got_any.hit.numpy())


@pytest.mark.parametrize("name", SCENES)
def test_sweep_plain_version_matches_port_flat(name):
    _, ts, (o, d), sh = setup(name)
    assert_gates(tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT),
                 intersect_scene_sweep_ref(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP))
    tsrc = dict(active=_t(sh["active"]), src_node=_t(sh["src_node"]),
                src_tri=_t(sh["src_tri"]))
    args = (_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts)
    flat_occ = tx.occluded(*args, T_FLAT, **tsrc)
    np.testing.assert_array_equal(
        flat_occ.numpy(), intersect_scene_sweep_ref(*args, T_SWEEP, **tsrc, any_hit=True).hit)


def test_sweep_respects_active_and_tmax():
    _, ts, (o, d), _ = setup("simple")
    o, d = _t(o), _t(d)
    active = torch.arange(o.shape[0]) % 2 == 0
    for any_hit in (False, True):
        hit = intersect_scene_cuda(o, d, 1e-5, INF, ts, T_SWEEP, active=active,
                                   any_hit=any_hit).hit
        assert not hit[1::2].any() and hit[0::2].any()
    near = intersect_scene_cuda(o, d, 1e-5, INF, ts, T_SWEEP)
    assert near.hit.any()
    # The range is half-open: t_max == t drops the hit, the next float keeps it.
    for t_max, kept in ((torch.where(near.hit, near.t * 0.5, 1e-3), False),
                        (torch.where(near.hit, near.t, 1e-3), False),
                        (torch.where(near.hit, torch.nextafter(near.t, torch.tensor(INF)),
                                     1e-3), True)):
        got = intersect_scene_cuda(o, d, 1e-5, t_max, ts, T_SWEEP)
        assert torch.equal(got.hit, near.hit & kept)
        if kept:
            assert torch.equal(got.t[got.hit], near.t[near.hit])
        occ = intersect_scene_cuda(o, d, 1e-5, t_max, ts, T_SWEEP, any_hit=True)
        assert torch.equal(occ.hit, near.hit & kept)
