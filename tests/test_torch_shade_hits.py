"""The one-shot shading API and the public root solvers against the JAX
package, on the CPU: ``ops.shade.shade_hits`` / ``apply_lights``
(``portrayer_tpu/ops/shade.py:113-155``), the seven names of ``ops``,
and ``math3d.quadratic_roots`` / ``smallest_root_in_range`` /
``normal_matrix`` (``portrayer_tpu/math3d.py:163-214``).

Tolerances, with their reasons:
- shade_hits: test_torch_shade.py's shade_pre gate (rtol 1e-4 / atol 1e-5,
  the specular x^100 term rtol 1e-3), on the JAX flat sweep's hits of
  big-scene's camera rays with 0, 1 and 3 of its lights; the occlusion
  verdicts of the port's any-hit query (its flat sweep, and the plain
  version of the sweep kernel) equal the JAX flat sweep's on every shadow
  ray, and so the lit terms of both packages add the same lights.
- apply_lights: equal bit for bit.  Both round every op once in float32
  (the JAX side runs op by op, so XLA fuses no mul+add into an FMA).
- the quadratic solver: roots within one float32 ulp (rtol 2.4e-7), the
  in-range verdicts equal.  torch's CPU sqrt is vectorised (SLEEF, 0.5001
  ulp) and rounds the other way on a few discriminants (6 of 4,096 here),
  where XLA's and numpy's are correctly rounded.
- normal_matrix: numpy float64 on both sides, equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu.math3d as jm3
import portrayer_tpu.ops as jops
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops import shade as jshade
import portrayer_tpu_torch as T
import portrayer_tpu_torch.math3d as m3
import portrayer_tpu_torch.ops as tops
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops import shade as tshade

from _torch_jax import jax_arrays


def test_ops_exports_the_jax_names():
    names = ("intersect_scene", "occluded", "hit_detail", "Hit", "HitDetail", "shade_hits",
             "trace")
    for n in names:
        assert hasattr(jops, n) and callable(getattr(tops, n)), n
    assert tops.shade_hits is tshade.shade_hits
    # ops.trace is the submodule (its helpers stay reachable) and, called,
    # its trace function.
    assert tops.trace.trace.__module__ == "portrayer_tpu_torch.ops.trace"
    st = T.flatten_scene(tscenes.load("simple").scene, "cpu")
    o, d = torch.zeros(4, 3), torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    args = (rng.PRNGKey(0), o, d, torch.arange(4, dtype=torch.int32), torch.zeros(4, 3), 4, st,
            T.RenderConfig(device="cpu"))
    assert torch.equal(tops.trace(*args), tops.trace.trace(*args))


def _big_scene(n_lights, n=512, seed=3):
    """(JAX tables, port tables, o, d) of big-scene with its first
    n_lights lights, on n seeded camera rays."""
    spec = scenes.load("big-scene")
    spec.scene.lights = spec.scene.lights[:n_lights]
    js = P.flatten_scene(spec.scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    w, h = spec.size
    r = np.random.default_rng(seed)
    o, d = (np.array(a) for a in JaxCamera(spec.camera, (w, h)).rays_at(
        jnp.asarray(r.uniform(0, w, n), jnp.float32), jnp.asarray(r.uniform(0, h, n), jnp.float32)))
    return js, ts, o, d


@pytest.mark.parametrize("accel", ["flat", "cuda"])
@pytest.mark.parametrize("n_lights", [0, 1, 3])
def test_shade_hits_matches_jax(n_lights, accel):
    js, ts, o, d = _big_scene(n_lights)
    jcfg = P.RenderConfig(accel="flat")
    tcfg = T.RenderConfig(device="cpu", accel=accel)
    hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, jcfg)
    det = jx.hit_detail(o, d, hit, js, jcfg, 1e-5)
    color, children, t_eps = jshade.shade_hits(d, hit, det, js, jcfg, jax.random.PRNGKey(0),
                                               hit.hit)
    thit = tx.Hit(*(torch.from_numpy(np.array(x)) for x in hit))
    td = torch.from_numpy(d)
    tdet = tx.hit_detail(torch.from_numpy(o), td, thit, ts, tcfg, 1e-5)
    tcolor, tchildren, tt_eps = tshade.shade_hits(td, thit, tdet, ts, tcfg, rng.PRNGKey(0),
                                                  thit.hit)
    h = np.asarray(hit.hit)
    assert h.sum() > 100 and tcolor.shape == (512, 3)
    np.testing.assert_allclose(tcolor.numpy()[h], np.asarray(color)[h], rtol=1e-3, atol=1e-5)
    assert (tcolor.numpy()[~h] == 0.0).all() and (np.asarray(color)[~h] == 0.0).all()
    np.testing.assert_allclose(tt_eps.numpy(), np.asarray(t_eps), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tchildren.refl_mult.numpy(), np.asarray(children.refl_mult))
    if n_lights:
        # The verdicts themselves, on the same shadow rays as shade_hits casts.
        pre, _ = tshade.shade_pre(td, thit, tdet, ts, tcfg, rng.PRNGKey(0), thit.hit)
        L, R = n_lights, 512
        tile = lambda x: x.repeat((L,) + (1,) * (x.dim() - 1))
        occ = tx.occluded(tile(tdet.point), pre.shadow_dir.reshape(L * R, 3), tile(pre.t_eps),
                          float("inf"), ts, tcfg,
                          active=tile(thit.hit) & pre.shadow_need.reshape(L * R),
                          src_node=tile(thit.node), src_tri=tile(thit.tri))
        jocc = jx.occluded(np.tile(np.asarray(det.point), (L, 1)),
                           pre.shadow_dir.reshape(L * R, 3).numpy(),
                           np.tile(pre.t_eps.numpy(), L), jnp.inf, js, jcfg,
                           active=np.asarray(pre.shadow_need.reshape(L * R)),
                           src_node=np.tile(np.asarray(hit.node), L),
                           src_tri=np.tile(np.asarray(hit.tri), L))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        # Light 0 is behind every surface the rays see (the query's range is
        # unbounded, so what lies past a light occludes too); light 1 is not.
        assert occ.sum() > 0 and (n_lights == 1 or occ.sum() < pre.shadow_need.sum())


@pytest.mark.parametrize("n_lights", [0, 1, 3])
def test_apply_lights_equals_jax(n_lights):
    r = np.random.default_rng(n_lights)
    R = 257
    base = r.uniform(0, 1, (R, 3)).astype(np.float32)
    contrib = r.uniform(0, 2, (n_lights, R, 3)).astype(np.float32)
    occ = r.uniform(size=(n_lights, R)) < 0.4
    active = r.uniform(size=R) < 0.8
    jpre = jshade.ShadePre(jnp.asarray(base), jnp.asarray(contrib), None, None, None)
    tpre = tshade.ShadePre(torch.from_numpy(base), torch.from_numpy(contrib), None, None, None)
    got = tshade.apply_lights(tpre, torch.from_numpy(occ), torch.from_numpy(active))
    ref = jshade.apply_lights(jpre, jnp.asarray(occ), jnp.asarray(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _coefficients(n=4096, seed=0):
    """float32 (a, b, c, t_min, t_max) with the solver's special cases:
    a == 0 (linear), b == 0, c == 0, a double root, no real root."""
    r = np.random.default_rng(seed)
    a, b, c = (r.normal(size=n).astype(np.float32) for _ in range(3))
    a[:300] = 0.0
    b[200:500] = 0.0
    c[600:700] = 0.0
    b[800:900] = 2.0 * a[800:900]        # b^2 - 4ac == 0 with c == a
    c[800:900] = a[800:900]
    a[1000:1200], c[1000:1200] = 1.0, 5.0  # disc < 0 where |b| < 4.4
    t_min = r.uniform(-1.0, 0.5, n).astype(np.float32)
    t_max = (t_min + r.uniform(0.0, 3.0, n)).astype(np.float32)
    return a, b, c, t_min, t_max


def test_quadratic_solvers_equal_jax():
    a, b, c, t_min, t_max = _coefficients()
    got = m3.quadratic_roots(*(torch.from_numpy(x) for x in (a, b, c)))
    ref = jm3.quadratic_roots(*(jnp.asarray(x) for x in (a, b, c)))
    assert len(got) == len(ref) == 2     # (r0, r1): the JAX docstring's num_roots is not returned
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2.4e-7, atol=0)
    assert np.isinf(got[0].numpy()).sum() > 100 and np.isfinite(got[1].numpy()).sum() > 1000
    t, ok = m3.smallest_root_in_range(*(torch.from_numpy(x) for x in (a, b, c, t_min, t_max)))
    jt, jok = jm3.smallest_root_in_range(*(jnp.asarray(x) for x in (a, b, c, t_min, t_max)))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < ok.sum() < len(a)


def test_intersect_has_no_private_quadratic_solver():
    assert not hasattr(tx, "_quadratic_roots") and not hasattr(tx, "smallest_root_in_range")


def test_normal_matrix_equals_jax():
    r = np.random.default_rng(1)
    for _ in range(5):
        m = np.eye(4)
        m[:3, :4] = r.normal(size=(3, 4))
        np.testing.assert_array_equal(m3.normal_matrix(m), jm3.normal_matrix(m))
    s = m3.scaling((2.0, 3.0, 4.0)) @ m3.rotation_y(0.3)
    np.testing.assert_allclose(m3.normal_matrix(s) @ s[:3, :3].T, np.eye(3), atol=1e-12)
