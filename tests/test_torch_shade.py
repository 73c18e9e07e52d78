"""The port's shading and one-round trace against the JAX package
(accel="flat") on the same camera rays and the same tables (carried across
by tables_from_numpy), on the CPU.

Tolerances, with their reasons: shade_pre rtol 1e-4 / atol 1e-5, except
the specular term, x^(4*shininess) = x^100 on the scenes here, which turns
f32 rounding of n.h into 100x that relative error: rtol 1e-3.  A traced
tile's per-pixel means: atol 1e-4.  The JAX side runs without jit: fused,
XLA contracts mul+add into FMA, and its rounding moves.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops.shade import shade_pre as jax_shade_pre
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops.shade import shade_pre
from portrayer_tpu_torch.ops.trace import trace
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.render import _tile_rays

from _torch_jax import jax_arrays, torus_nodes, TORUS_TOL, INLINE

J_FLAT = P.RenderConfig(accel="flat")
T_CPU = T.RenderConfig(device="cpu")
SIZES = {"simple": (64, 64), "big-scene": (160, 82)}


def _specs(name):
    """(JAX spec, port spec, max_depth).  "simple-mirror" is simple with its
    ground sphere's material made a half mirror, rendered at max_depth 0:
    the reflections are cut off to the background, as the JAX package does
    at the depth limit."""
    base = name.removesuffix("-mirror")
    jspec, tspec = scenes.load(base), tscenes.load(base)
    if name == base:
        return jspec, tspec, T_CPU.max_depth
    for spec in (jspec, tspec):
        spec.scene.root.children[2].geometry.material.reflectivity = 0.5
    return jspec, tspec, 0


def _camera_rays(name, n=512, seed=3):
    if name in INLINE:
        scene, camera, (w, h) = INLINE[name](P)
    else:
        spec = _specs(name)[0]
        scene, camera, (w, h) = spec.scene, spec.camera, spec.size
    js = P.flatten_scene(scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, w, n), jnp.float32)
    py = jnp.asarray(rng.uniform(0, h, n), jnp.float32)
    o, d = (np.array(a) for a in JaxCamera(camera, (w, h)).rays_at(px, py))
    return js, ts, o, d


@pytest.mark.parametrize("name", ["simple", "big-scene", "simple-mirror", "torus-showcase",
                                  "glossy-reflection", "primitives-simple", "ellipsoids",
                                  "glass-sphere"])
def test_shade_pre_matches_jax(name):
    """Both packages shade the JAX flat sweep's hits; glossy draws use the
    same key.  Rays that hit a torus carry the torus gate's rtol 1e-3 into
    every term (their hit point moves with the quartic's rounding)."""
    js, ts, o, d = _camera_rays(name)
    hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    det = jx.hit_detail(o, d, hit, js, J_FLAT, 1e-5)
    pre, jchildren = jax_shade_pre(d, hit, det, js, J_FLAT, jax.random.PRNGKey(0), hit.hit)
    thit = tx.Hit(*(torch.from_numpy(np.array(x)) for x in hit))
    tdet = tx.hit_detail(torch.from_numpy(o), torch.from_numpy(d), thit, ts, T_CPU, 1e-5)
    tpre, children = shade_pre(torch.from_numpy(d), thit, tdet, ts, T_CPU, rng.PRNGKey(0),
                               thit.hit)
    on_torus = np.isin(np.asarray(hit.node), torus_nodes(js))

    def close(got, ref, rtol):
        got, ref = got.numpy(), np.asarray(ref)
        for m, tol in ((np.asarray(hit.hit) & ~on_torus, rtol),
                       (np.asarray(hit.hit) & on_torus, max(rtol, TORUS_TOL))):
            if got.ndim == 3:  # [L, R, 3]: select rays on the middle axis
                np.testing.assert_allclose(got[:, m], ref[:, m], rtol=tol, atol=1e-5)
            else:
                np.testing.assert_allclose(got[m], ref[m], rtol=tol, atol=1e-5)

    close(tpre.base, pre.base, 1e-4)
    close(tpre.t_eps, pre.t_eps, 1e-4)
    close(tpre.shadow_dir, pre.shadow_dir, 1e-4)
    close(tpre.light_contrib, pre.light_contrib, 1e-3)
    np.testing.assert_array_equal(tpre.shadow_need.numpy(), np.asarray(pre.shadow_need))
    for f in ("refl_mult", "refr_mult"):
        np.testing.assert_array_equal(getattr(children, f).numpy(),
                                      np.asarray(getattr(jchildren, f)), err_msg=f)
    assert children.refl_mult.any() == ts.any_reflective
    assert children.refr_mult.any() == ts.any_refractive
    close(children.refl_dir, jchildren.refl_dir, 1e-4)
    close(children.refr_dir, jchildren.refr_dir, 1e-4)


# Tile origin per scene: a 64x64 tile of the self-golden frame with
# silhouettes and shadows in it.
TILES = {"simple": (0, 0), "big-scene": (64, 0)}


@pytest.mark.parametrize("name", ["simple", "big-scene", "simple-mirror"])
def test_trace_matches_jax_on_same_rays(name):
    """One 64x64 tile of the self-golden render (4 spp, seed 0), its rays
    built by the port's render loop, traced by both packages: the per-pixel
    means agree to atol 1e-4."""
    jspec, spec, max_depth = _specs(name)
    js = P.flatten_scene(jspec.scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    assert ts.any_reflective == name.endswith("-mirror")
    cfg = T.RenderConfig(device="cpu", samples=4, tile=(64, 64), seed=0, max_depth=max_depth)
    size = SIZES[name.removesuffix("-mirror")]
    x0, y0 = TILES[name.removesuffix("-mirror")]
    tkey = rng.fold_in(rng.fold_in(rng.PRNGKey(cfg.seed), x0), y0)
    rays = _tile_rays(rng.fold_in(tkey, 0), Camera(spec.camera, size, "cpu"), x0, y0, 0,
                      cfg=cfg, background=spec.background, tile_h=64, tile_w=64, spp=4,
                      samples=4)
    n = 64 * 64
    # One node-chunk shape for every kind: fewer op-by-op compilations.
    jcfg = P.RenderConfig(accel="flat", max_depth=max_depth, node_chunk=128)
    with jax.disable_jit():
        ref = np.asarray(jax_trace(jax.random.PRNGKey(0), *(x.numpy() for x in rays[:4]),
                                   n, js, jcfg, w0=rays[4].numpy(), spp_contiguous=4)) / 4.0
    o, d, pix, bg, w0 = rays
    got = trace(rng.PRNGKey(0), o, d, pix, bg, n, ts, cfg, w0=w0, spp_contiguous=4).numpy() / 4.0
    hit = tx.intersect_scene(o, d, cfg.epsilon, float("inf"), ts, cfg).hit
    assert 0.05 < hit.float().mean() < 0.99
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("reflectivity, area, feature", [
    (0.5, None, "bounce rounds"),
    (0.0, T.Parallelogram(a=(1.0, 0.0, 0.0), b=(0.0, 0.0, 1.0)), "area lights"),
    (0.5, None, "refraction"),
])
def test_features_render_as_jax(reflectivity, area, feature):
    """Bounce rounds (a mirror sphere in a mirror box at max_depth 10),
    area lights (a parallelogram light over a matte sphere, a point of it
    drawn per sample) and refraction (a glass sphere, max_depth 0, so the
    children end in the background) were refused before; they now render
    what the JAX package renders (atol 1e-4, per pixel mean of 2 spp)."""
    scene_of = lambda pkg: _feature_scene(pkg, reflectivity, area,
                                          1.5 if feature == "refraction" else 0.0)
    cam = lambda pkg: pkg.CameraSettings(eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0))
    max_depth = 0 if feature == "refraction" else 10
    cfg = T.RenderConfig(device="cpu", samples=2, tile=(8, 8), max_depth=max_depth)
    ours = T.render_linear(scene_of(T), cam(T), (8, 8), cfg=cfg)
    ref = P.render_linear(scene_of(P), cam(P), (8, 8),
                          cfg=P.RenderConfig(accel="flat", samples=2, tile=(8, 8),
                                             max_depth=max_depth))
    assert ours.max() > 0.0
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-4)


def _feature_scene(pkg, reflectivity, area, refraction_index):
    """A sphere (mirror, glass or matte) before the camera, inside a
    mirror box when it reflects, lit by one light."""
    mat = pkg.Material(diffuse=(0.5, 0.5, 0.5), specular=(0.4, 0.4, 0.4), shininess=10.0,
                       reflectivity=reflectivity, refraction_index=refraction_index)
    light = pkg.Light(position=(0.0, 5.0, 0.0), color=(1.0, 1.0, 1.0))
    if area is not None:
        light.area = pkg.Parallelogram(a=area.a, b=area.b)
    nodes = [pkg.SceneNode(pkg.Geometry(pkg.Sphere(), mat)).scaled(2.0)
             .translated((0.0, 0.0, -5.0))]
    if reflectivity > 0.0 and refraction_index == 0.0:
        wall = pkg.Material(diffuse=(0.2, 0.4, 0.3), reflectivity=0.8)
        nodes.append(pkg.SceneNode(pkg.Geometry(pkg.Cube(), wall)).scaled(20.0)
                     .translated((0.0, 0.0, -5.0)))
    return pkg.Scene(pkg.SceneNode(nodes), [light], (0.1, 0.1, 0.1))
