"""The port's intersection against the JAX package on the same rays and
the same tables (carried across by tables_from_numpy): candidate
functions, the flat sweep and occlusion query, winner_t and hit_detail,
the sweep kernel's plain version against the JAX Pallas kernel run in
interpret mode, and the beam sweep against the JAX package's.

Tolerances: the JAX package's kernel gates (tests/test_pallas.py) — .hit
equal; node mismatches on at most 0.2% of hits and only within 2*2^-16
relative t; elsewhere t within rtol 1e-4 / atol 1e-5; on torus hits the
JAX package's torus gate (tests/test_torus.py), rtol 1e-3 / atol 1e-3,
since the f32 quartic's root moves with rounding.  XLA on the CPU
contracts mul+add into FMA and divides by constants through reciprocals,
so values agree to f32 rounding, not bit for bit.  The JAX side runs op by
op (no jit), where XLA fuses least.  The beam sweep against JAX's beam
sweep and the port's flat sweep: the gates of tests/test_beam.py (.hit
equal, t within rtol 1e-4 / atol 1e-5, a node mismatch only on a tie
within 1e-4 relative t)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops.pallas_intersect import intersect_scene_pallas
from portrayer_tpu.ops.beam import intersect_scene_beam as jax_beam
import portrayer_tpu_torch as T
from portrayer_tpu_torch import _build, scenes as tscenes
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.ops.beam import intersect_scene_beam
from portrayer_tpu_torch.ops.cuda_intersect import (
    intersect_scene_cuda, intersect_scene_sweep_ref,
)

from _torch_jax import (jax_arrays, assert_gates, torus_nodes, TORUS_TOL, INLINE,
                        float64_tables, sweeps_apart)

INF = float("inf")
J_FLAT = P.RenderConfig(accel="flat")
J_PAL = P.RenderConfig(accel="pallas", pallas_interpret=True)
T_SWEEP = T.RenderConfig(device="cpu")
T_FLAT = T.RenderConfig(device="cpu", accel="flat")
SCENES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
          "ellipsoids"]
_cache = {}


def jax_scene(name):
    """(JAX scene, camera settings, size) of a registered or inline scene."""
    if name in INLINE:
        return INLINE[name](P)
    spec = scenes.load(name)
    return spec.scene, spec.camera, spec.size


def setup(name, n=512, seed=0):
    """(JAX tables, port tables, primary rays, shadow rays) for `name`:
    camera rays through uniform numpy-drawn image points, and rays from
    their JAX flat hits toward every light with src_node/src_tri set."""
    if name in _cache:
        return _cache[name]
    scene, camera, (w, h) = jax_scene(name)
    js = P.flatten_scene(scene, dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.uniform(0, w, n), jnp.float32)
    py = jnp.asarray(rng.uniform(0, h, n), jnp.float32)
    o, d = (np.array(a) for a in JaxCamera(camera, (w, h)).rays_at(px, py))
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


@pytest.mark.parametrize("kind", ["sphere", "cube", "cylinder", "cone", "plane", "torus"])
def test_candidates_match_jax(kind):
    """Rays from points around the unit primitive toward points near its
    centre; torus radii (c, a) drawn per ray.  The plane's rays aim at the
    y = 0 square.  Torus: the torus gate on t, hits equal on all but 1% of
    rays (grazing roots of the quartic may appear in one package only)."""
    rng = np.random.default_rng(1)
    o = (rng.standard_normal((256, 4, 3)) * 1.5).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, (256, 4, 3))
    if kind == "plane":
        aim[..., 1] = 0.0
    d = (aim - o).astype(np.float32)
    t_min = np.full((256, 4), 1e-5, np.float32)
    t_max = np.full((256, 4), np.inf, np.float32)
    params = np.stack([rng.uniform(0.6, 1.2, (256, 4)), rng.uniform(0.15, 0.4, (256, 4))],
                      axis=-1).astype(np.float32)
    jf = getattr(jx, f"{kind}_candidate")
    tf = getattr(tx, f"{kind}_candidate")
    ref = np.asarray(jf(o, d, t_min, t_max, 1e-5, params=params))
    got = tf(_t(o), _t(d), _t(t_min), _t(t_max), 1e-5, params=_t(params)).numpy()
    fin = np.isfinite(ref)
    assert fin.mean() > 0.1
    if kind == "torus":
        assert (fin != np.isfinite(got)).mean() < 0.01
        both = fin & np.isfinite(got)
        np.testing.assert_allclose(got[both], ref[both], rtol=TORUS_TOL, atol=TORUS_TOL)
        return
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", SCENES)
def test_flat_sweep_and_occluded_match_jax(name):
    js, ts, (o, d), sh = setup(name)
    tor = torus_nodes(js)
    ref = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
    got = tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT)
    assert_gates(ref, got, torus=tor)
    src = dict(active=sh["active"], src_node=sh["src_node"], src_tri=sh["src_tri"])
    ref = jx.intersect_scene(sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_FLAT, **src)
    got = tx.intersect_scene(_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_FLAT,
                             **{k: _t(v) for k, v in src.items()})
    assert_gates(ref, got, sh["src_node"], torus=tor)
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
        # Torus winners: the torus gate on t, and on the point and normal
        # that follow from it.
        tor = np.isin(np.asarray(hit.node), torus_nodes(js))
        for m, rtol, atol in ((hm & ~tor, 1e-4, 1e-5), (hm & tor, TORUS_TOL, TORUS_TOL)):
            np.testing.assert_allclose(wt[m], np.asarray(wt_ref)[m], rtol=rtol, atol=atol)
        det = tx.hit_detail(_t(ro), _t(rd), thit, ts, T_FLAT, tmin_t, **tsrc)
        for f in ("point", "normal", "uv", "nmt"):
            for m, tol in ((hm & ~tor, 1e-4), (hm & tor, TORUS_TOL)):
                np.testing.assert_allclose(getattr(det, f).numpy()[m],
                                           np.asarray(getattr(det_ref, f))[m],
                                           rtol=tol, atol=tol, err_msg=f)
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
    tor = torus_nodes(js)
    ref = intersect_scene_pallas(o, d, 1e-5, jnp.inf, js, J_PAL)
    got = intersect_scene_cuda(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP)
    assert_gates(ref, got, torus=tor)
    src = dict(active=sh["active"], src_node=sh["src_node"], src_tri=sh["src_tri"])
    tsrc = {k: _t(v) for k, v in src.items()}
    args_j = (sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_PAL)
    args_t = (_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_SWEEP)
    assert_gates(intersect_scene_pallas(*args_j, **src), intersect_scene_cuda(*args_t, **tsrc),
                 sh["src_node"], torus=tor)
    ref_any = intersect_scene_pallas(*args_j, **src, any_hit=True)
    got_any = intersect_scene_cuda(*args_t, **tsrc, any_hit=True)
    np.testing.assert_array_equal(np.asarray(ref_any.hit), got_any.hit.numpy())


@pytest.mark.parametrize("name", SCENES)
def test_sweep_plain_version_matches_port_flat(name):
    js, ts, (o, d), sh = setup(name)
    assert_gates(tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT),
                 intersect_scene_sweep_ref(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP),
                 torus=torus_nodes(js))
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


def _one_chunk_t(o, d, ts, ci):
    """[R]: the plain version's nearest t over chunk ci of ts alone."""
    pk = ts.packed
    cols = slice(ci * 128, (ci + 1) * 128)
    kind = [k for k, _, n in pk.kind_ranges for _ in range(n)][ci]
    one = dataclasses.replace(pk, f32=pk.f32[:, cols], ids=pk.ids[:, cols],
                              chunk_kind=pk.chunk_kind[ci:ci + 1],
                              chunk_min=pk.chunk_min[ci:ci + 1], chunk_max=pk.chunk_max[ci:ci + 1],
                              n_chunks=1, kind_ranges=((kind, 0, 1),))
    return intersect_scene_sweep_ref(o, d, 1e-5, INF, dataclasses.replace(ts, packed=one),
                                     T_SWEEP).t


@pytest.mark.parametrize("name", ["torus-showcase", "glossy-reflection",
                                  "procedural-meshes-groups"])
def test_sweep_work_counts_real_lanes(name):
    """The work count behind chip_smoke.py's bound.  A one-level cull
    (nearest mode): one test per (active ray, chunk) and, per kind, one
    evaluation per (ray, real lane) of each chunk the cull passes; padding
    lanes count nothing.  The kernel: with more than 32 chunks, one group
    test per (ray, group) and the chunk tests of each group the ray
    crosses, else one chunk test per (ray, chunk) and no group test; and
    it leaves out a group or chunk whose entry lies beyond the ray's best t
    over the chunks before it (each chunk's t from a one-chunk table).
    Any-hit mode stops at a ray's first hit: as much work as nearest mode
    on rays that hit nothing, less over all rays."""
    from portrayer_tpu_torch.ops import cuda_intersect as ci

    _, ts, (o, d), _ = setup(name)
    o, d = _t(o), _t(d)
    pk = ts.packed
    nc = pk.n_chunks
    t_min, t_max, active = ci._rays(o, 1e-5, INF, None)
    rcp = ci._safe_rcp(d)
    entry = ci._entry(o, rcp, t_min, active, pk.chunk_min, pk.chunk_max)
    cross = entry <= t_max[:, None]
    assert torch.equal(cross, ci._cull(o, rcp, t_min, t_max, active, pk.chunk_min,
                                       pk.chunk_max))
    real = (pk.ids[0].reshape(nc, -1) >= 0).sum(dim=1)
    assert int(real.sum()) < pk.ids.shape[1]  # the table has padding lanes
    kinds = [k for k, _, n in pk.kind_ranges for _ in range(n)]
    R = o.shape[0]
    # The best t before each chunk, in table order.
    t = torch.stack([_one_chunk_t(o, d, ts, c) for c in range(nc)], dim=1)
    best = torch.cat([torch.full((R, 1), INF), torch.cummin(t, dim=1).values[:, :-1]], dim=1)
    visit = cross & ~(entry > best)
    expect = {"cull": R * nc, "group_cull": 0, "chunk_cull": R * nc, "swept": {}}
    if nc > 32:
        expect["group_cull"] = R * -(-nc // 32)
        expect["chunk_cull"] = 0
        for g0 in range(0, nc, 32):
            gmin = pk.chunk_min[g0:g0 + 32].amin(0, keepdim=True)
            gmax = pk.chunk_max[g0:g0 + 32].amax(0, keepdim=True)
            e = ci._entry(o, rcp, t_min, active, gmin, gmax)[:, 0]
            g_visit = (e <= t_max) & ~(e > best[:, g0])
            expect["chunk_cull"] += int(g_visit.sum()) * min(32, nc - g0)
            visit[:, g0:g0 + 32] &= g_visit[:, None]
    for c, k in enumerate(kinds):
        if cross[:, c].any():
            expect[k] = expect.get(k, 0) + int(cross[:, c].sum()) * int(real[c])
            expect["swept"][k] = expect["swept"].get(k, 0) + int(visit[:, c].sum()) * int(real[c])

    def run(o, d, **kw):
        work = {}
        return intersect_scene_sweep_ref(o, d, 1e-5, INF, ts, T_SWEEP, work=work, **kw), work

    def total(work):
        return sum(v for k, v in work.items() if k != "swept") + sum(work["swept"].values())

    near, work = run(o, d)
    assert work == expect
    miss = ~near.hit
    assert miss.any() and near.hit.any()
    assert run(o[miss], d[miss], any_hit=True)[1] == run(o[miss], d[miss])[1]
    assert total(run(o, d, any_hit=True)[1]) < total(work)


def test_aabox_grazing_rays_fall_back_to_the_sweep_t():
    """Rays aimed within 2e-4 of the edges of glossy-reflection's table, an
    axis-aligned box swept by the aabox slab test.  winner_t recomputes t
    with the cube's 6-face fold, which loses some of these roots (+inf)
    exactly where the JAX package's does; hit_detail then keeps the sweep's
    t, as the JAX package's exact-t epilogue does."""
    js, ts, _, _ = setup("glossy-reflection")
    node = 3
    assert int(js.packed.ids[0, 128]) == node  # the aabox chunk holds the table
    rng = np.random.default_rng(4)
    n = 4096
    loc = rng.uniform(-0.5, 0.5, (n, 3))
    free = rng.integers(0, 3, n)
    for a in range(3):
        edge = np.sign(rng.uniform(-1.0, 1.0, n)) * 0.5
        loc[:, a] = np.where(free == a, loc[:, a], edge)
    tr = np.asarray(js.trans, np.float64)[node]
    world = loc @ tr[:, :3].T + tr[:, 3] + rng.uniform(-2e-4, 2e-4, (n, 3))
    o = world + rng.standard_normal((n, 3)) * 3.0 + np.array([0.0, 3.0, 6.0])
    d = world - o
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    # The slab test's t on the inflated box, as the sweep returns it (the
    # Pallas kernel's quantised key without its exact-t epilogue).
    ref = intersect_scene_pallas(o, d, 1e-5, jnp.inf, js, J_PAL, exact_t=False)
    got = intersect_scene_cuda(_t(o), _t(d), 1e-5, INF, ts, T_SWEEP)
    assert_gates(ref, got)
    hm = got.hit.numpy()
    wt_ref = np.asarray(jx.winner_t(o, d, ref.node, ref.tri, js, J_FLAT, 1e-5))
    wt = tx.winner_t(_t(o), _t(d), got.node, got.tri, ts, T_FLAT, 1e-5).numpy()
    lost = hm & ~np.isfinite(wt)
    np.testing.assert_array_equal(lost, hm & ~np.isfinite(wt_ref))
    assert lost.sum() > 0, "no ray exercised the fallback"
    keep = hm & ~lost
    np.testing.assert_allclose(wt[keep], wt_ref[keep], rtol=1e-4, atol=1e-5)
    det = tx.hit_detail(_t(o), _t(d), got, ts, T_FLAT, 1e-5)
    t_used = np.where(lost, got.t.numpy(), wt)
    np.testing.assert_allclose(det.point.numpy()[hm], (o + t_used[:, None] * d)[hm],
                               rtol=1e-6, atol=1e-6)
    # The JAX package falls back to its kernel's quantised t (2^-16
    # relative), the port to the exact f32 t of its sweep.
    det_ref = jx.hit_detail(o, d, intersect_scene_pallas(o, d, 1e-5, jnp.inf, js, J_PAL),
                            js, J_FLAT, 1e-5)
    p_ref = np.asarray(det_ref.point)
    np.testing.assert_allclose(det.point.numpy()[keep], p_ref[keep], rtol=1e-4, atol=1e-4)
    err = np.abs(det.point.numpy()[lost] - p_ref[lost]).max(axis=-1)
    assert (err <= 2.0 ** -15 * t_used[lost] + 1e-5).all()


def test_torus_root_is_the_jax_quartic_op_for_op():
    """The port's flat torus candidate against the JAX package's run op by
    op (no jit, so XLA contracts no mul+add into an FMA): 20,000 rays
    aimed at a torus of the torus-showcase's size in local units.  The
    same formulas in the same order give the same f32 root on at least 99%
    of hits (measured: 99.6% of 14,703) and stay within the torus gate on
    the rest, where cube root, arccos or cosine round differently."""
    g = np.random.default_rng(0)
    n = 20000
    o = (g.standard_normal((n, 3)) + np.array([0.0, 2.0, 5.0])).astype(np.float32)
    aim = g.uniform(-1.2, 1.2, (n, 3))
    aim[:, 1] *= 0.2
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True) / 2.2).astype(np.float32)
    params = np.tile(np.array([1.0, 0.22], np.float32), (n, 1))
    t_min = np.full(n, 1e-5, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    with jax.disable_jit():
        ref = np.asarray(jx.torus_candidate(o, d, t_min, t_max, 1e-5, params=params))
    got = tx.torus_candidate(_t(o), _t(d), _t(t_min), _t(t_max), 1e-5,
                             params=_t(params)).numpy()
    both = np.isfinite(ref) & np.isfinite(got)
    assert both.sum() > 10000
    assert (np.isfinite(ref) != np.isfinite(got)).mean() < 1e-3
    assert (got[both] == ref[both]).mean() >= 0.99
    np.testing.assert_allclose(got[both], ref[both], rtol=TORUS_TOL, atol=TORUS_TOL)


# ---------------------------------------------------------------------------
# Beam sweep (tests/test_beam.py's cases; its knobs)
# ---------------------------------------------------------------------------

J_BEAM = P.RenderConfig(accel="beam", warp_size=64, n_segments=8, beam_chunk=64)
T_BEAM = T.RenderConfig(device="cpu", accel="beam", warp_size=64, beam_chunk=64)


def _beam_gates(ref, got):
    """tests/test_beam.py's gates."""
    m = np.asarray(ref.hit)
    np.testing.assert_array_equal(m, np.asarray(got.hit))
    rt, gt = np.asarray(ref.t)[m], np.asarray(got.t)[m]
    np.testing.assert_allclose(gt, rt, rtol=1e-4, atol=1e-5)
    mism = np.asarray(ref.node)[m] != np.asarray(got.node)[m]
    tie = np.abs(rt - gt) <= 1e-4 * np.maximum(np.abs(rt), 1.0)
    assert np.all(~mism | tie)


def _beam_rays(name, n, seed, scattered):
    """tests/test_beam.py::_compare's rays: camera rays through uniform
    image points or, scattered, from 0.7 of the way to their flat hits
    along random unit directions (incoherent)."""
    scene, camera, (w, h) = jax_scene(name)
    js = P.flatten_scene(scene, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    xs = jax.random.uniform(jax.random.fold_in(key, 0), (n,)) * w
    ys = jax.random.uniform(jax.random.fold_in(key, 1), (n,)) * h
    o, d = JaxCamera(camera, (w, h), dtype=jnp.float32).rays_at(xs, ys)
    if scattered:
        hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
        o = o + jnp.where(hit.hit, hit.t, 1.0)[:, None] * d * 0.7
        d = jax.random.normal(jax.random.fold_in(key, 2), (n, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return js, np.array(o), np.array(d)


@pytest.mark.parametrize("name, scattered", [("big-scene", False), ("big-scene", True),
                                             ("procedural-meshes", False),
                                             ("procedural-meshes", True)])
def test_beam_matches_jax_beam_and_port_flat(name, scattered):
    js, o, d = _beam_rays(name, 512, 0, scattered)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    assert ts.n_nodes + ts.n_pairs >= T_BEAM.beam_min_prims
    stats = {}
    got = intersect_scene_beam(_t(o), _t(d), 1e-5, INF, ts, T_BEAM, stats=stats)
    assert np.asarray(got.hit).mean() > 0.1 and stats["trips"] > 0
    _beam_gates(jax_beam(o, d, 1e-5, jnp.inf, js, J_BEAM), got)
    _beam_gates(tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_FLAT), got)
    # The dispatch: accel="beam" reaches it for nearest and any-hit queries.
    via = tx.intersect_scene(_t(o), _t(d), 1e-5, INF, ts, T_BEAM)
    np.testing.assert_array_equal(via.t.numpy(), got.t.numpy())
    np.testing.assert_array_equal(tx.occluded(_t(o), _t(d), 1e-5, INF, ts, T_BEAM).numpy(),
                                  got.hit.numpy())


def test_beam_with_sources_matches_jax():
    """Shadow rays leaving their hit surfaces (src_node / src_tri), on the
    mesh scene, whose source is an (instance, triangle) pair."""
    js, ts, _, sh = setup("procedural-meshes")
    src = dict(active=sh["active"], src_node=sh["src_node"], src_tri=sh["src_tri"])
    ref = jax_beam(sh["o"], sh["d"], sh["t_min"], jnp.inf, js, J_BEAM, **src)
    got = intersect_scene_beam(_t(sh["o"]), _t(sh["d"]), _t(sh["t_min"]), INF, ts, T_BEAM,
                               **{k: _t(v) for k, v in src.items()})
    _beam_gates(ref, got)


def test_beam_render_matches_flat_render_and_small_scenes_stay_flat():
    """tests/test_beam.py's render check on simple (beam_min_prims=1 sends
    its nine nodes through the beam sweep), and simple under the default
    beam_min_prims renders through the flat sweep."""
    spec = tscenes.load("simple")
    args = (spec.scene, spec.camera, (48, 40), spec.background)
    kw = dict(device="cpu", samples=2, tile=(32, 32))
    flat = T.render_linear(*args, T.RenderConfig(accel="flat", **kw))
    beam = T.render_linear(*args, T.RenderConfig(accel="beam", beam_min_prims=1, warp_size=64,
                                                 **kw))
    np.testing.assert_allclose(beam, flat, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(T.render_linear(*args, T.RenderConfig(accel="beam", **kw)),
                                  flat)


def test_sweeps_apart_sorts_partings_and_its_float64_witness_holds_on_big_scene():
    """sweeps_apart (tests/_torch_jax.py), with which the card holds the
    kernel against the beam sweep.  Its witness's premise: in float64, on
    unit directions, the kernel's formulas (the plain version over the
    float64 packed table) and the flat sweep's give the same hits, t
    within rtol 1e-6 / atol 1e-9, on big-scene's camera rays and their
    shadow rays (with sources).  Partings made by hand land in their
    categories, one each."""
    from portrayer_tpu_torch.camera import Camera

    spec = tscenes.load("big-scene")
    st = T.flatten_scene(spec.scene, "cpu")
    st64 = float64_tables(spec.scene, "cpu")
    w, h = spec.size
    gen = np.random.default_rng(3)
    o, d = Camera(spec.camera, spec.size, "cpu").rays_at(
        torch.tensor(gen.uniform(0, w, 1024), dtype=torch.float32),
        torch.tensor(gen.uniform(0, h, 1024), dtype=torch.float32))
    flat = tx.intersect_scene(o, d, 1e-5, INF, st, T_FLAT)
    p = o + torch.where(flat.hit, flat.t, 0.0)[:, None] * d
    sd = st.light_pos[torch.arange(1024) % st.n_lights] - p
    sd = sd / torch.linalg.vector_norm(sd, dim=1, keepdim=True)
    skw = dict(active=flat.hit, src_node=flat.node, src_tri=flat.tri)
    f64 = T.RenderConfig(device="cpu", accel="flat", dtype=torch.float64)
    for ro, rd, t_min, kw in ((o, d, 1e-5, {}), (p, sd, 1e-3, skw)):
        o64, d64 = ro.double(), rd.double()
        d64 = d64 / torch.linalg.vector_norm(d64, dim=1, keepdim=True)
        kp = intersect_scene_sweep_ref(o64, d64, t_min, INF, st64, T_SWEEP, **kw)
        fl = tx.intersect_scene(o64, d64, t_min, INF, st64, f64, **kw)
        assert kp.t.dtype == torch.float64 and fl.hit.float().mean() > 0.2
        assert torch.equal(kp.hit, fl.hit)
        torch.testing.assert_close(kp.t[fl.hit], fl.t[fl.hit], rtol=1e-6, atol=1e-9)

    kern = intersect_scene_sweep_ref(o, d, 1e-5, INF, st, T_SWEEP)
    assert sweeps_apart(kern, flat, o, d, 1e-5, {}, st64, T_SWEEP)["uncleared"] == 0
    hits = torch.nonzero(kern.hit).squeeze(1)[:4].tolist()
    t, node, hit = kern.t.clone(), kern.node.clone(), kern.hit.clone()
    hit[hits[0]] = False
    node[hits[1]] = node[hits[1]] + 1
    t[hits[1]] *= 1.01
    t[hits[2]] *= 1.001
    node[hits[3]] = node[hits[3]] + 1
    got = kern._replace(t=t, node=node, hit=hit)
    out = sweeps_apart(kern, got, o, d, 1e-5, {}, st64, T_SWEEP)
    assert {k: out[k] for k in ("hit", "node", "t", "self_t", "tie")} == dict(
        hit=1, node=1, t=1, self_t=0, tie=1)
    assert out["uncleared"] == 0 and sum(map(len, out["rays"].values())) == 3
    assert sum(sum(b.values()) for b in out["branches"].values()) == 3


def test_kernel_wrapper_refuses_a_launch_past_its_index_range(monkeypatch):
    """The kernel indexes rays with a 32-bit int (o[3 * i + 2]): the wrapper
    refuses MAX_LAUNCH_RAYS rays or more before it builds or launches
    anything.  The shape is faked: a tensor that says it lies on the card
    and has that many rows."""
    assert cuda_intersect.MAX_LAUNCH_RAYS == (2 ** 31 - 1) // 3

    class _Fake:
        device = torch.device("cuda", 0)
        shape = (cuda_intersect.MAX_LAUNCH_RAYS, 3)

    monkeypatch.setattr(_build, "load", lambda: pytest.fail("built the kernel"))
    st = T.flatten_scene(tscenes.load("simple").scene, "cpu")
    with pytest.raises(ValueError, match="715827882 rays"):
        intersect_scene_cuda(_Fake(), _Fake(), 1e-5, INF, st, T_SWEEP)
    _Fake.shape = (cuda_intersect.MAX_LAUNCH_RAYS - 1, 3)
    with pytest.raises(pytest.fail.Exception, match="built the kernel"):
        intersect_scene_cuda(_Fake(), _Fake(), 1e-5, INF, st, T_SWEEP)
