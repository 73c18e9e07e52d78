"""Gradients through the port's bounce loop, on the CPU, mirroring
tests/test_grad.py: against the JAX package's gradients on the same tables
and rays for every field of DIFF_FIELDS (the port's parallel.DIFF_FIELDS;
tests/test_torch_parallel.py holds it equal to the JAX package's), against central finite
differences, the sweep's plain version against the flat sweep, silhouette
gradients with soft visibility, and tables replaced without stale records.

Tolerances, with their reasons:
- Port against JAX, with soft visibility off and on: gradients and
  per-ray colours within rtol 1e-3 / atol 1e-4 of their largest entry.
  The JAX loss is jitted: XLA contracts mul+add into FMA, which moves
  hit points and colours by ulps, and x^(4 shininess) = x^80 highlights
  multiply that by the exponent.  Both losses agree to rtol 1e-5.
- Finite differences: the JAX package's own probes, steps, FD-stability
  skip and tolerances (tests/test_grad.py:45-113 and :158-269).
- The plain sweep against the flat sweep: the JAX package's rtol 2e-4 /
  atol 1e-5 (same winners, so the same smooth branch).
- Silhouette margins against JAX: rtol 1e-4 / atol 1e-5 (torus hits the
  torus gate, 1e-3, as the quartic's root moves with rounding).
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
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops.trace import trace
from portrayer_tpu_torch.parallel import DIFF_FIELDS

from _torch_jax import INLINE, jax_arrays, torus_nodes, TORUS_TOL

CFG = T.RenderConfig(device="cpu", accel="flat")
JCFG = P.RenderConfig(node_chunk=8, accel="flat")
KEY = rng.PRNGKey(0)
N_RAYS = 64
# Soft visibility width of the JAX comparison (world units of margin).
SOFT = 0.05


def _scene(pkg):
    """tests/test_grad.py's scene: a specular, 0.3 reflective sphere over a
    plane, one light."""
    return pkg.Scene(
        root=pkg.SceneNode([
            pkg.SceneNode(pkg.Geometry(pkg.Sphere(), pkg.Material(
                diffuse=(0.6, 0.3, 0.2), specular=(0.4, 0.4, 0.4), shininess=20.0,
                reflectivity=0.3))).translated((0.0, 0.0, -3.0)),
            pkg.SceneNode(pkg.Geometry(pkg.Plane(), pkg.Material(diffuse=(0.4, 0.5, 0.6))))
            .scaled(20.0).translated((0.0, -1.5, 0.0)),
        ]),
        lights=[pkg.Light(position=(2.0, 4.0, 2.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.2, 0.2, 0.2),
    )


def _fan(u, dy=-0.15):
    """Unit rays from the origin along (u, dy, -1): [n,3] numpy f32."""
    d = np.stack([u, np.full_like(u, dy), -np.ones_like(u)], axis=-1)
    return (np.zeros_like(d, dtype=np.float32),
            (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))


def _rays(n=N_RAYS):
    """tests/test_grad.py's fan covering sphere, plane and background."""
    return _fan(np.linspace(-0.4, 0.4, n, dtype=np.float32))


def _port_acc(st, o, d, cfg=CFG):
    n = o.shape[0]
    return trace(KEY, torch.from_numpy(o), torch.from_numpy(d),
                 torch.arange(n, dtype=torch.int32), torch.full((n, 3), 0.3), n, st, cfg)


def _port_loss(st, o, d, cfg=CFG):
    return torch.sum(_port_acc(st, o, d, cfg) ** 2)


def _port_grads(st, fields, cfg=CFG):
    """(loss, {field: gradient}, acc) of sum(acc^2) on the fan."""
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in fields}
    acc = _port_acc(st.replace(**leaves), *_rays(), cfg)
    loss = torch.sum(acc ** 2)
    loss.backward()
    return float(loss.detach()), {f: x.grad.numpy() for f, x in leaves.items()}, acc.detach()


def _jax_grads(soft_visibility):
    """The JAX package's loss, gradients for every DIFF_FIELDS entry and
    per-ray colours, from one jitted grad, and the tables they were taken
    on."""
    js = P.flatten_scene(_scene(P), dtype=jnp.float32)
    o, d = _rays()
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)
    jcfg = P.RenderConfig(node_chunk=8, accel="flat", soft_visibility=soft_visibility)

    def loss(vals):
        acc = jax_trace(jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d), pix, bg, n,
                        js.replace(**vals), jcfg)
        return jnp.sum(acc ** 2), acc

    (val, acc), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {f: getattr(js, f) for f in DIFF_FIELDS})
    return js, float(val), {f: np.asarray(v) for f, v in g.items()}, np.asarray(acc)


@pytest.fixture(scope="module")
def jax_grads():
    return _jax_grads(0.0)


@pytest.fixture(scope="module")
def jax_grads_soft():
    return _jax_grads(SOFT)


def _match_jax(jax_result, field, soft_visibility):
    """The port's colours, loss and gradients of sum(acc^2) on the JAX
    package's own tables (carried across) and rays, in both accel modes."""
    js, jloss, jg, jacc = jax_result
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    for accel in ("flat", "cuda"):
        cfg = T.RenderConfig(device="cpu", accel=accel, soft_visibility=soft_visibility)
        loss, g, acc = _port_grads(ts, (field,), cfg)
        np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-3, atol=1e-4 * np.abs(jacc).max(),
                                   err_msg=f"acc ({accel})")
        assert loss == pytest.approx(jloss, rel=1e-5)
        got, ref = g[field], jg[field]
        assert np.isfinite(got).all() and np.abs(ref).max() > 0, field
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f"{field} ({accel})")


@pytest.mark.parametrize("field", DIFF_FIELDS)
def test_grads_match_jax(jax_grads, field):
    """The port's gradients of sum(acc^2) on the JAX package's own tables
    (carried across) and rays, field by field, in both accel modes."""
    _match_jax(jax_grads, field, 0.0)


@pytest.mark.parametrize("field", DIFF_FIELDS)
def test_grads_match_jax_with_soft_visibility(jax_grads, jax_grads_soft, field):
    """As test_grads_match_jax with soft visibility on: the coverage alpha
    scales the ambient term, the light terms and the children of the
    sphere's edge rays, and sends the complement to the background."""
    # The fan has rays in the sphere's soft band: their colours move.
    assert np.abs(jax_grads_soft[3] - jax_grads[3]).max() > 1e-2
    _match_jax(jax_grads_soft, field, SOFT)


# ---------------------------------------------------------------------------
# Finite differences (tests/test_grad.py:45-156)
# ---------------------------------------------------------------------------

def _check_grad(field, eps=1e-2, rtol=0.08):
    st = T.flatten_scene(_scene(T), "cpu")
    o, d = _rays()
    value = getattr(st, field)

    def loss(v):
        with torch.no_grad():
            return float(_port_loss(st.replace(**{field: v}), o, d))

    g = _port_grads(st, (field,))[1][field]
    assert np.all(np.isfinite(g))
    # The largest of the non-zero gradient entries; a parameter on a
    # structural boundary (reflectivity == 0 gates the children) has none.
    order = np.argsort(-np.abs(g).ravel())
    flat_idx = [fi for fi in order if abs(g.ravel()[fi]) > 1e-6][:6]
    checked, skipped = 0, []
    for fi in flat_idx:
        idx = np.unravel_index(fi, g.shape)
        basis = torch.zeros_like(value)
        basis[idx] = 1.0

        def fd_at(e):
            return (loss(value + e * basis) - loss(value - e * basis)) / (2 * e)

        fd, fd_half = fd_at(eps), fd_at(eps / 2)
        # A ray on a visibility boundary makes the difference quotient a
        # jump / (2 eps), growing as eps shrinks: skip such coordinates.
        if abs(fd_half - fd) / max(abs(fd), abs(fd_half), 1e-6) > 0.25:
            skipped.append(idx)
            continue
        assert np.isclose(g[idx], fd, rtol=rtol, atol=5e-3), (
            f"{field}{idx}: analytic {g[idx]} vs fd {fd}")
        checked += 1
    need = max(min(2, len(flat_idx) - 1), (len(flat_idx) + 1) // 2)
    assert checked >= need, f"{field}: only {checked}/{len(flat_idx)} FD-stable ({skipped})"


@pytest.mark.parametrize("field, eps, rtol", [
    ("mat_diffuse", 1e-2, 0.08),
    ("light_color", 1e-2, 0.08),
    ("mat_specular", 1e-2, 0.08),
    # light position: through attenuation and shadow geometry
    ("light_pos", 3e-2, 0.15),
    ("mat_reflectivity", 5e-3, 0.1),
    # node transforms: through the recomputed t and the hit detail
    ("inv", 2e-3, 0.15),
])
def test_grad_matches_fd(field, eps, rtol):
    _check_grad(field, eps, rtol)


def test_grad_plain_sweep_matches_flat():
    """tests/test_grad.py:158: the sweep's plain version (what the kernel
    computes) selects, detached; hit detail recomputes t.  Its gradients
    equal the flat sweep's."""
    st = T.flatten_scene(_scene(T), "cpu")
    fields = ("mat_diffuse", "inv")
    g_flat = _port_grads(st, fields, CFG)[1]
    g_plain = _port_grads(st, fields, T.RenderConfig(device="cpu", accel="cuda"))[1]
    for f in fields:
        np.testing.assert_allclose(g_plain[f], g_flat[f], rtol=2e-4, atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# Soft visibility (tests/test_grad.py:175-269)
# ---------------------------------------------------------------------------

def _translation_loss(st, cfg, o, d):
    """sum(acc^2) as a function of a translation dx of node 0 along +x:
    its world->local inverse composes with T(-dx)."""
    basis = torch.zeros_like(st.inv)
    basis[0, 0, 3] = -1.0

    def loss(dx):
        return _port_loss(st.replace(inv=st.inv + dx * basis), o, d, cfg)

    return loss


def _silhouette_check(st, cfg, o, d, rtol, fd_tol):
    loss = _translation_loss(st, cfg, o, d)
    dx = torch.zeros((), requires_grad=True)
    loss(dx).backward()
    g = float(dx.grad)
    eps = 2e-3
    with torch.no_grad():
        f = lambda e: float(loss(torch.tensor(e)))
        fd = (f(eps) - f(-eps)) / (2 * eps)
        fd_half = (f(eps / 2) - f(-eps / 2)) / eps
    assert abs(fd_half - fd) / max(abs(fd), 1e-6) < fd_tol, (fd, fd_half)
    assert g != 0.0
    assert np.isclose(g, fd, rtol=rtol), f"analytic {g} vs fd {fd}"


def _one_prim(prim):
    return T.Scene(
        root=T.SceneNode(T.Geometry(prim, T.Material(diffuse=(0.7, 0.3, 0.2))))
        .translated((0.0, 0.0, -3.0)),
        lights=[T.Light(position=(2.0, 4.0, 2.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.3, 0.3, 0.3))


@pytest.mark.parametrize("prim, urange, n, width, rtol, fd_tol", [
    # The sphere of tests/test_grad.py's scene: edge near x/z ~ 1/sqrt(8).
    ("sphere", (0.30, 0.38), 32, 0.08, 0.1, 0.2),
    # Fans deep enough inside the body that the sigmoid's band dominates
    # the residual 5% jump at the hard edge.
    ("cylinder", (0.148, 0.176), 48, 0.05, 0.15, 0.25),   # body tangency at b = 0.5
    ("cone", (0.070, 0.092), 48, 0.05, 0.15, 0.25),       # slanted edge near y = 0
    ("torus", (0.136, 0.155), 48, 0.05, 0.15, 0.25),      # outer equator, 0.45/3
])
def test_silhouette_gradient_with_soft_visibility(prim, urange, n, width, rtol, fd_tol):
    """Translating a primitive across a fan of rays straddling its right
    silhouette: with soft visibility the render is nearly continuous in the
    translation, and the analytic gradient matches central differences."""
    if prim == "sphere":
        scene = _scene(T)
    else:
        scene = _one_prim({"cylinder": T.Cylinder, "cone": T.Cone,
                           "torus": lambda: T.Torus(center_radius=0.3, tube_radius=0.15)}[prim]())
    st = T.flatten_scene(scene, "cpu")
    cfg = T.RenderConfig(device="cpu", accel="flat", soft_visibility=width)
    o, d = _fan(np.linspace(*urange, n, dtype=np.float32), dy=0.0)
    _silhouette_check(st, cfg, o, d, rtol, fd_tol)


MARGIN_SCENES = ["big-scene", "primitives-simple", "torus-showcase", "procedural-meshes"]


@pytest.mark.parametrize("name", MARGIN_SCENES)
def test_silhouette_margin_matches_jax(name):
    """HitDetail.margin for every kind (sphere, cube, cone, cylinder in
    big-scene; plane; torus; mesh) on the JAX flat sweep's hits of 512
    camera rays: finite on every hit, equal to the JAX package's, and INF
    everywhere with soft visibility off."""
    if name in INLINE:
        scene, camera, (w, h) = INLINE[name](P)
    else:
        spec = scenes.load(name)
        scene, camera, (w, h) = spec.scene, spec.camera, spec.size
    js = P.flatten_scene(scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    g = np.random.default_rng(3)
    px = jnp.asarray(g.uniform(0, w, 512), jnp.float32)
    py = jnp.asarray(g.uniform(0, h, 512), jnp.float32)
    o, d = (np.array(a) for a in JaxCamera(camera, (w, h)).rays_at(px, py))
    jcfg = P.RenderConfig(accel="flat", soft_visibility=0.05)
    hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, jcfg)
    ref = np.asarray(jx.hit_detail(o, d, hit, js, jcfg, 1e-5).margin)
    thit = tx.Hit(*(torch.from_numpy(np.array(x)) for x in hit))
    args = (torch.from_numpy(o), torch.from_numpy(d), thit, ts)
    got = tx.hit_detail(*args, T.RenderConfig(device="cpu", soft_visibility=0.05), 1e-5)
    got = got.margin.numpy()
    hm = np.asarray(hit.hit)
    assert hm.mean() > 0.2 and np.isfinite(got[hm]).all()
    tor = np.isin(np.asarray(hit.node), torus_nodes(js))
    for m, tol in ((hm & ~tor, (1e-4, 1e-5)), (hm & tor, (TORUS_TOL, TORUS_TOL))):
        np.testing.assert_allclose(got[m], ref[m], rtol=tol[0], atol=tol[1])
    assert np.isinf(tx.hit_detail(*args, T.RenderConfig(device="cpu"), 1e-5).margin.numpy()).all()


# ---------------------------------------------------------------------------
# Replaced tables carry their own records
# ---------------------------------------------------------------------------

def test_replaced_tables_rebuild_records():
    """Replacing mat_diffuse must change what renders: the node records
    that shading reads are rebuilt from the new table (stale ones would
    render the old colour and give no gradient).  The render of replaced
    tables equals that of a scene whose materials were changed before
    lowering; the sweep's packed table is kept."""
    spec = tscenes.load("simple")
    cfg = T.RenderConfig(device="cpu", samples=1, tile=(32, 32))
    st = T.flatten_scene(spec.scene, "cpu")
    args = (spec.camera, (32, 32), spec.background, cfg)
    before = T.render_linear(st, *args)
    st2 = st.replace(mat_diffuse=st.mat_diffuse * 0.5)
    assert st2.packed is st.packed
    assert torch.equal(st2.rec[:, 12:15], st.rec[:, 12:15] * 0.5)
    after = T.render_linear(st2, *args)
    assert np.abs(after - before).max() > 0.05
    for m in {id(n.geometry.material): n.geometry.material
              for n in spec.scene.root.children}.values():
        m.diffuse = m.diffuse * 0.5
    np.testing.assert_array_equal(after, T.render_linear(spec.scene, *args))
    # The gradient reaches the replacing tensor.
    st = T.flatten_scene(_scene(T), "cpu")
    x = st.mat_diffuse.clone().requires_grad_()
    _port_loss(st.replace(mat_diffuse=x), *_rays()).backward()
    assert (x.grad.abs().sum(dim=1) > 0).all()
