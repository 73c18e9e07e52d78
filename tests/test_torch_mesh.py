"""The port's mesh path against the JAX package, on the CPU: the OBJ
parser, the lowering of mesh scenes, the triangle candidate, the flat
sweep's pair sweep, the sweep's tri_w branch (plain version) against the
Pallas kernel in interpret mode, and winner_t / hit_detail on triangles.

Scenes: single-triangle and procedural-meshes at its test size
(``_torch_jax.INLINE``: an icosphere split twice, instanced as a mirror and
a diffuse node, an 8 x 8 height field and a standalone triangle; 769
pairs in 7 chunks).

Tolerances, with their reasons:
- OBJ parser and lowering: arrays equal (the same numpy steps).
- triangle_candidate, called op by op on both sides (JAX without jit):
  the same IEEE operations in the same order, so t, beta and gamma are
  equal bit for bit, near edges and vertices too.
- Sweeps: the JAX package's kernel gates (``_torch_jax.assert_gates``);
  jitted, XLA contracts mul+add into FMA, so t agrees to rtol 1e-4.
- winner_t, hit point, normal, uv and TBN: rtol 1e-4 / atol 1e-4 (the
  same Cramer solve; the normal of a smooth hit interpolates with those
  barycentrics).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops.pallas_intersect import intersect_scene_pallas
from portrayer_tpu.scene.flatten import tri_record as jax_tri_record
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, scenes as tscenes
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_cuda
from portrayer_tpu_torch.scene.flatten import MESH, PACKED_KIND_NAMES, tables_from_numpy

from _torch_jax import jax_arrays, assert_gates, assert_tables_equal, INLINE
from test_torch_render import GOLDEN, assert_self_golden_rule

INF = float("inf")
J_FLAT = P.RenderConfig(accel="flat")
J_PAL = P.RenderConfig(accel="pallas", pallas_interpret=True)
T_SWEEP = T.RenderConfig(device="cpu")
T_FLAT = T.RenderConfig(device="cpu", accel="flat")
NAMES = ["single-triangle", "procedural-meshes"]
_cache = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(pkg, name):
    if name in INLINE:
        return INLINE[name](pkg)
    spec = (scenes if pkg is P else tscenes).load(name)
    return spec.scene, spec.camera, spec.size


# ---------------------------------------------------------------------------
# OBJ parser
# ---------------------------------------------------------------------------

OBJ_HEAD = """# v, vt, vn
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
"""

OBJS = {
    # Positions only, one quad (fan-triangulated) and one triangle.
    "v": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv 2 2 2\nf 1 2 3 4\nf 2 5 3\n",
    # v/vt/vn corners; the same position with two normals is two vertices.
    "v-vt-vn": OBJ_HEAD + "f 1/1/1 2/2/1 3/3/2\nf 1/1/1 3/3/2 4/4/2\nf 4/4/1 2/2/2 3/3/2\n",
    # v//vn and negative (relative) indices, and a quad.
    "negative-quad": OBJ_HEAD + "f -4//-2 -3//-2 -2//-1 -1//-1\nf 1//1 -3//2 -1//2\n",
    # The second `o` block is not read (mesh.rs:57-61).
    "two-objects": OBJ_HEAD + "o first\nf 1/1 2/2 3/3\nf 1/1 3/3 4/4\n"
                   "o second\nv 5 5 5\nf 1/1 2/2 5/1\n",
}


@pytest.mark.parametrize("case", list(OBJS))
def test_load_obj_matches_jax(tmp_path, case):
    path = tmp_path / f"{case}.obj"
    path.write_text(OBJS[case])
    ref = P.MeshData._load_obj_py(str(path))
    got = T.MeshData.load_obj(str(path))
    for f in ("positions", "triangles", "normals", "tex_coords", "bounds_min", "bounds_max"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert len(got.triangles) >= 2


def test_smooth_mesh_needs_normals():
    data = T.MeshData([[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]])
    with pytest.raises(ValueError, match="vertex normal"):
        T.Mesh(data, T.Shading.Smooth)
    assert T.KDMesh(data).shading == T.Shading.Flat
    with pytest.raises(ValueError, match="texture coordinates"):
        T.MeshData([[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]], tex_coords=[[0, 0]])


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

def test_procedural_meshes_lowering_equals_flatten_scene():
    """Instances share one triangle block per (data, shading), pairs
    repeat per instance, and the tri_w chunks carry the unit-triangle
    affine: the JAX package's tables array for array, directly and through
    tables_from_numpy."""
    js = P.flatten_scene(_scene(P, "procedural-meshes")[0], dtype=jnp.float32)
    ts = T.flatten_scene(_scene(T, "procedural-meshes")[0], "cpu")
    assert_tables_equal(js, ts)
    assert_tables_equal(js, tables_from_numpy(*jax_arrays(js), "cpu"))
    assert ts.n_pairs == 769 and ts.tri_a.shape[0] == 320 + 128 + 1
    assert [PACKED_KIND_NAMES[k] for k, _, _ in ts.packed.kind_ranges] == ["tri_w"]
    assert ts.packed.n_chunks == 7
    np.testing.assert_array_equal(ts.trec.numpy(), np.asarray(jax_tri_record(js)))


# ---------------------------------------------------------------------------
# Triangle candidate
# ---------------------------------------------------------------------------

def _triangle_rays(case, n=2048, seed=5):
    """(o, d, a, b, c) float32 [n,3]: triangles drawn from numpy and rays
    aimed at points of each case."""
    g = np.random.default_rng(seed)
    a, b, c = (g.standard_normal((n, 3)) for _ in range(3))
    if case == "degenerate":  # M == 0 exactly in f32
        half = np.arange(n) < n // 2
        c = np.where(half[:, None], a, c)                     # c == a
        line = ~half[:, None] & (np.arange(3) > 0)            # a, b, c on an x line
        b, c = np.where(line, a, b), np.where(line, a, c)
    w = g.dirichlet((1.0, 1.0, 1.0), n)
    if case == "edges":
        w[g.integers(0, 3, n)[:, None] == np.arange(3)] = 0.0  # one weight off
        w /= w.sum(axis=1, keepdims=True)
    elif case == "vertices":
        w = np.eye(3)[g.integers(0, 3, n)]
    aim = w[:, 0:1] * a + w[:, 1:2] * b + w[:, 2:3] * c
    if case in ("edges", "vertices"):
        aim = aim + g.uniform(-1e-6, 1e-6, (n, 3))
    o = aim + 3.0 * g.standard_normal((n, 3))
    d = aim - o
    if case == "parallel":  # directions in the triangle's plane
        nrm = np.cross(b - a, c - a)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        d = d - (d * nrm).sum(axis=1, keepdims=True) * nrm
        o = aim - d
    return tuple(x.astype(np.float32) for x in (o, d, a, b, c))


@pytest.mark.parametrize("case", ["interior", "edges", "vertices", "parallel", "degenerate"])
def test_triangle_candidate_matches_jax(case):
    o, d, a, b, c = _triangle_rays(case)
    t_min = np.full(o.shape[0], 1e-5, np.float32)
    t_max = np.full(o.shape[0], np.inf, np.float32)
    ref = [np.asarray(x) for x in jx.triangle_candidate(o, d, a, b, c, t_min, t_max)]
    got = [x.numpy() for x in tx.triangle_candidate(*(_t(x) for x in (o, d, a, b, c, t_min,
                                                                      t_max)))]
    for name, r, g_ in zip(("t", "beta", "gamma"), ref, got):
        np.testing.assert_array_equal(g_, r, err_msg=name)
    hit = np.isfinite(got[0])
    if case == "interior":
        assert hit.all()
    elif case == "degenerate":
        assert not hit.any() and (got[1] == 2.0).all() and (got[2] == 2.0).all()
    elif case == "parallel":
        # M = 0 in exact arithmetic; f32 rounding of the in-plane
        # directions leaves a tiny M, and rays through the interior may
        # then still hit.  Both packages decide alike (above).
        assert 0.5 < (~hit).mean() < 1.0
    else:  # about half the rays 1e-6 off an edge or vertex land inside
        assert 0.05 < hit.mean() < 0.95


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def setup(name, n=512, seed=0):
    """(JAX tables, port tables, ray sets): camera rays through numpy-drawn
    image points; one shadow ray per camera hit toward the lights in turn;
    the mirror reflections of the camera hits (child rays).  Shadow and
    child rays carry the hit's (node, tri) as their source pair."""
    if name in _cache:
        return _cache[name]
    scene, camera, (w, h) = _scene(P, name)
    js = P.flatten_scene(scene, dtype=jnp.float32)
    ts = tables_from_numpy(*jax_arrays(js), "cpu")
    g = np.random.default_rng(seed)
    px = jnp.asarray(g.uniform(0, w, n), jnp.float32)
    py = jnp.asarray(g.uniform(0, h, n), jnp.float32)
    o, d = (np.array(x) for x in JaxCamera(camera, (w, h)).rays_at(px, py))
    hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    det = jx.hit_detail(o, d, hit, js, J_FLAT, 1e-5)
    hm = np.asarray(hit.hit)
    p = np.asarray(det.point).astype(np.float32)
    t_eps = np.maximum(1e-5, 3e-4 * np.linalg.norm(p, axis=-1)).astype(np.float32)
    src = dict(active=hm, src_node=np.asarray(hit.node), src_tri=np.asarray(hit.tri))
    lp = np.asarray(js.light_pos)[np.arange(n) % js.n_lights]
    sd = lp - p
    sd = (sd / np.linalg.norm(sd, axis=-1, keepdims=True)).astype(np.float32)
    nrm = np.asarray(det.normal)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
    cd = d - 2.0 * (d * nrm).sum(axis=-1, keepdims=True) * nrm
    cd = (cd / np.maximum(np.linalg.norm(cd, axis=-1, keepdims=True), 1e-30)).astype(np.float32)
    rays = {"camera": (o, d, np.full(n, 1e-5, np.float32), {}),
            "shadow": (p, sd, t_eps, src), "child": (p, cd, t_eps, src)}
    _cache[name] = (js, ts, rays)
    return _cache[name]


def _targs(o, d, t_min, kw):
    return (_t(o), _t(d), _t(t_min)), {k: _t(v) for k, v in kw.items()}


@pytest.mark.parametrize("name", NAMES)
def test_flat_sweep_and_occluded_match_jax(name):
    """Camera, shadow and child rays; the shadow and child rays leave a
    (node, tri) pair, whose t-range start both flat sweeps raise."""
    js, ts, rays = setup(name)
    for label, (o, d, t_min, kw) in rays.items():
        ref = jx.intersect_scene(o, d, t_min, jnp.inf, js, J_FLAT, **kw)
        args, tkw = _targs(o, d, t_min, kw)
        got = tx.intersect_scene(*args, INF, ts, T_FLAT, **tkw)
        assert_gates(ref, got, kw.get("src_node"))
        assert np.asarray(ref.hit).any() or label != "camera"
        np.testing.assert_array_equal(got.tri.numpy()[~got.hit.numpy()], -1)
        occ_ref = jx.occluded(o, d, t_min, jnp.inf, js, J_FLAT, **kw)
        occ = tx.occluded(*args, INF, ts, T_FLAT, **tkw)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref), err_msg=label)


def test_flat_sweep_raises_the_source_pair_not_the_node():
    """A mesh folded into a narrow V: rays leave triangle 0 toward triangle
    1 of the same node, which they meet before self_eps_local / |d_local|.
    Both flat sweeps raise the t-range start of the source (node, tri)
    pair only, so the neighbour is hit; the sweep kernel's plain version
    excludes the source pair and hits it too."""
    for pkg in (P, T):
        data = pkg.MeshData([[0, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0.001, 0], [1, 0.001, 0],
                             [0, 0.001, 1]], [[0, 1, 2], [3, 5, 4]])
        node = pkg.SceneNode(pkg.Geometry(pkg.Mesh(data), pkg.Material()))
        scene = pkg.Scene(pkg.SceneNode([node]), [pkg.Light()], 0.1)
        if pkg is P:
            js = P.flatten_scene(scene, dtype=jnp.float32)
        else:
            ts = T.flatten_scene(scene, "cpu")
    g = np.random.default_rng(2)
    n = 64
    o = np.stack([g.uniform(0.05, 0.4, n), np.zeros(n), g.uniform(0.05, 0.4, n)], 1)
    d = np.tile(np.array([0.0, 1.0, 0.0]), (n, 1))
    o, d = o.astype(np.float32), d.astype(np.float32)
    kw = dict(src_node=np.zeros(n, np.int32), src_tri=np.zeros(n, np.int32))
    ref = jx.intersect_scene(o, d, 0.0, jnp.inf, js, J_FLAT, **kw)
    args, tkw = _targs(o, d, np.zeros(n, np.float32), kw)
    for got in (tx.intersect_scene(*args, INF, ts, T_FLAT, **tkw),
                intersect_scene_cuda(*args, INF, ts, T_SWEEP, **tkw)):
        assert got.hit.all() and (got.tri == 1).all()
        assert_gates(ref, got)
    assert (np.asarray(ref.t) < T_FLAT.self_eps_local).all()


def test_degenerate_triangle_is_never_hit():
    """A triangle with collinear corners packs a zero unit-triangle affine
    (|det| <= 1e-30): d'w = 0, t = +inf, and no ray hits it, in the JAX
    flat sweep, the port's flat sweep and the sweep's plain version."""
    for pkg in (P, T):
        tris = [pkg.SceneNode(pkg.Geometry(pkg.Triangle.flat(*v), pkg.Material())) for v in (
            ((-1.0, -1.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 0.0)),        # degenerate
            ((-1.0, -1.0, -2.0), (1.0, -1.0, -2.0), (0.0, 1.0, -2.0)))]
        scene = pkg.Scene(pkg.SceneNode(tris), [pkg.Light()], 0.1)
        if pkg is P:
            js = P.flatten_scene(scene, dtype=jnp.float32)
        else:
            ts = T.flatten_scene(scene, "cpu")
    f32 = ts.packed.f32.numpy()
    ids = ts.packed.ids.numpy()
    degenerate = (ids[0] == 0)
    assert degenerate.sum() == 1 and (f32[:12, degenerate] == 0.0).all()
    g = np.random.default_rng(3)
    n = 256
    aim = np.stack([g.uniform(-0.5, 0.5, n), g.uniform(-0.5, 0.5, n), np.zeros(n)], 1)
    o = np.tile(np.array([0.0, 0.0, 3.0]), (n, 1))
    d = aim - o
    o, d = o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    for got in (tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT),
                intersect_scene_cuda(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP)):
        assert_gates(ref, got)
        assert got.hit.any() and not (got.node == 0).any()


def test_sweep_plain_version_matches_pallas_kernel():
    """The tri_w branch (the plain version of what the CUDA kernel
    computes) against the JAX Pallas kernel in interpret mode on
    procedural-meshes: nearest on camera rays, nearest and any-hit on
    shadow rays and nearest on child rays, both with source pairs, which
    both exclude outright.  Four interpret calls (about 10 s each)."""
    js, ts, rays = setup("procedural-meshes")
    for label, any_hit in (("camera", False), ("shadow", False), ("shadow", True),
                           ("child", False)):
        o, d, t_min, kw = rays[label]
        ref = intersect_scene_pallas(o, d, t_min, jnp.inf, js, J_PAL, any_hit=any_hit, **kw)
        args, tkw = _targs(o, d, t_min, kw)
        got = intersect_scene_cuda(*args, INF, ts, T_SWEEP, any_hit=any_hit, **tkw)
        if any_hit:
            np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
            assert got.hit.any()
        else:
            assert_gates(ref, got, kw.get("src_node"))
            assert (got.node[got.hit] >= 0).all()


@pytest.mark.parametrize("name", NAMES)
def test_sweep_plain_version_matches_port_flat(name):
    """The sweep's unit-frame t against the flat oracle's Cramer t, and its
    source-pair exclusion against the flat oracle's raise."""
    _, ts, rays = setup(name)
    for label, (o, d, t_min, kw) in rays.items():
        args, tkw = _targs(o, d, t_min, kw)
        assert_gates(tx.intersect_scene(*args, INF, ts, T_FLAT, **tkw),
                     intersect_scene_cuda(*args, INF, ts, T_SWEEP, **tkw), tkw.get("src_node"))
        np.testing.assert_array_equal(
            tx.occluded(*args, INF, ts, T_FLAT, **tkw).numpy(),
            intersect_scene_cuda(*args, INF, ts, T_SWEEP, any_hit=True, **tkw).hit.numpy())


# ---------------------------------------------------------------------------
# winner_t and hit_detail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_winner_t_and_hit_detail_match_jax(name):
    """On the JAX flat sweep's hits of every ray set: winner_t, the hit
    point, the normal (smooth on the icospheres and the standalone
    triangle, flat on the height field and single-triangle), uv with the
    v-flip, has_uv and the TBN."""
    js, ts, rays = setup(name)
    seen = set()
    for label, (o, d, t_min, kw) in rays.items():
        hit = jx.intersect_scene(o, d, t_min, jnp.inf, js, J_FLAT, **kw)
        hm = np.asarray(hit.hit)
        kw = {k: v for k, v in kw.items() if k != "active"}
        wt_ref = np.asarray(jx.winner_t(o, d, hit.node, hit.tri, js, J_FLAT, t_min, **kw))
        det_ref = jx.hit_detail(o, d, hit, js, J_FLAT, t_min, **kw)
        thit = tx.Hit(*(_t(np.asarray(x)) for x in hit))
        args, tkw = _targs(o, d, t_min, kw)
        wt = tx.winner_t(args[0], args[1], thit.node, thit.tri, ts, T_FLAT, args[2], **tkw)
        np.testing.assert_allclose(wt.numpy()[hm], wt_ref[hm], rtol=1e-4, atol=1e-5)
        det = tx.hit_detail(args[0], args[1], thit, ts, T_FLAT, args[2], **tkw)
        for f in ("point", "normal", "uv", "nmt"):
            np.testing.assert_allclose(getattr(det, f).numpy()[hm],
                                       np.asarray(getattr(det_ref, f))[hm], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{label} {f}")
        for f in ("has_uv", "has_nmt", "material"):
            np.testing.assert_array_equal(getattr(det, f).numpy(),
                                          np.asarray(getattr(det_ref, f)), err_msg=f)
        np.testing.assert_array_equal(det.rec.numpy()[hm], np.asarray(det_ref.rec)[hm])
        trec = ts.trec.numpy()[np.asarray(hit.tri)[hm]]
        seen.update(zip(trec[:, 24] > 0.5, trec[:, 25] > 0.5))
    # (smooth, has_uv) kinds of triangle that the rays hit.
    expect = {(False, False)} if name == "single-triangle" else {(True, False), (False, True),
                                                                 (True, True)}
    assert seen == expect


def test_single_triangle_u8_matches_self_golden():
    """single-triangle at the self-golden's 160x120, 4 spp, seed 0, tile 64
    (tools/gen_self_goldens.py), through the port's render loop on the CPU:
    the self-golden rule of tests/test_golden.py."""
    spec = tscenes.load("single-triangle")
    ours = T.render_u8(spec.scene, spec.camera, (160, 120), spec.background,
                       T.RenderConfig(device="cpu", samples=4, tile=(64, 64), seed=0))
    assert_self_golden_rule(ours, image_io.read_png(f"{GOLDEN}/single-triangle.png"))
    assert MESH in {k for k, _, _ in T.flatten_scene(spec.scene, "cpu").groups}
