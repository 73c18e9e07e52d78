"""The port's CUDA sweep kernel against its plain PyTorch version, on the
card.  These tests need an NVIDIA GPU with nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda.py -m cuda

single-triangle and procedural-meshes (at its test size) drive the tri_w
branch, their child rays with (node, tri) source pairs; procedural-meshes-
groups (37 chunks) the kernel's group level of the cull; normal-mapping-
numpy (textures, normal maps) and soft-shadows-icosphere (an area light)
the textured and soft-shadowed scenes.  Built here from numpy: exact ties
between duplicate triangles and spheres, and a table of more than 1,024
chunks.  Under autograd, gradients of a traced tile through the kernel
equal those through the plain version up to the order of the float
atomics that sum a gather's backward (1e-4 of the largest entry).  Two
gloo ranks sharing the card trace big-scene's rays with trace_sharded: the
framebuffer equals the shard sum traced in this process within 1e-5.  The
beam sweep on big-scene's camera rays and their shadow rays: the gates of
tests/test_beam.py against the flat sweep, and against the kernel the
kernel gates by category with a float64 witness (tests/_torch_jax.py's
sweeps_apart).

Gates: the JAX package's kernel gates (tests/test_pallas.py) for the
nearest mode, with its torus gate (tests/test_torus.py) on torus hits,
and equal .hit for the any-hit mode.  Kernel and plain version round every
op the same way (the kernel is built with -fmad=false), so in practice
they agree bit for bit.
"""

import numpy as np
import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.ops.intersect import intersect_scene
from portrayer_tpu_torch.ops.cuda_intersect import (
    intersect_scene_cuda, intersect_scene_sweep_ref,
)

from _torch_jax import (assert_gates, torus_nodes, INLINE, float64_tables, kernel_apart_limits,
                        sweeps_apart)

NAMES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
         "ellipsoids", "single-triangle", "procedural-meshes", "procedural-meshes-groups",
         "four-shapes", "normal-mapping-numpy", "soft-shadows-icosphere"]

pytestmark = pytest.mark.cuda
INF = float("inf")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cpu(hit):
    return type(hit)(*(x.cpu() for x in hit))


def _scene(name):
    if name in INLINE:
        return INLINE[name](T)
    spec = scenes.load(name)
    return spec.scene, spec.camera, spec.size


def _check(o, d, t_min, st, cfg, torus, **kw):
    """Nearest and any-hit: kernel against plain version; returns the
    kernel's nearest hits."""
    k = intersect_scene_cuda(o, d, t_min, INF, st, cfg, **kw)
    p = intersect_scene_sweep_ref(o, d, t_min, INF, st, cfg, **kw)
    assert_gates(_cpu(p), _cpu(k), None if "src_node" not in kw else kw["src_node"].cpu(),
                 torus=torus)
    ka = intersect_scene_cuda(o, d, t_min, INF, st, cfg, any_hit=True, **kw)
    pa = intersect_scene_sweep_ref(o, d, t_min, INF, st, cfg, any_hit=True, **kw)
    assert torch.equal(ka.hit, pa.hit)
    return k


def _shadow(o, d, hit, st):
    """Rays from the hits toward the first light, with src ids."""
    t = torch.where(hit.hit, hit.t, 0.0)
    pts = o + t[:, None] * d
    sd = st.light_pos[0] - pts
    sd = sd / torch.linalg.vector_norm(sd, dim=-1, keepdim=True)
    t_min = torch.clamp(3e-4 * torch.linalg.vector_norm(pts, dim=-1), min=1e-5)
    return pts, sd, t_min, dict(active=hit.hit, src_node=hit.node, src_tri=hit.tri)


@pytest.mark.parametrize("name", NAMES)
def test_sweep_kernel_matches_plain_version(dev, name):
    """Camera rays, their shadow rays and, where the scene reflects, the
    child rays of a real round 0 with their source surfaces and those rays'
    shadow rays."""
    scene, camera, (w, h) = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev)
    torus = torus_nodes(st)
    u = rng.uniform(rng.PRNGKey(11), (65536, 2), dev)
    o, d = Camera(camera, (w, h), dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    cuda_intersect.reset_counts()
    k = _check(o, d, 1e-5, st, cfg, torus)
    assert cuda_intersect.COUNTS["nearest"] == 1 and cuda_intersect.COUNTS["any_hit"] == 1
    pts, sd, t_min, kw = _shadow(o, d, k, st)
    _check(pts, sd, t_min, st, cfg, torus, **kw)
    if not st.any_reflective:
        return
    R = o.shape[0]
    q = tr._Queue(o=o, d=d, w=torch.ones(R, device=dev),
                  pix=torch.arange(R, dtype=torch.int32, device=dev),
                  t_min=torch.full((R,), 1e-5, device=dev),
                  src_node=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  src_tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  sid=torch.arange(R, dtype=torch.int32, device=dev))
    acc = torch.zeros((R, 3), device=dev)
    _, child, _ = tr._round_shade(q, tr._nearest(q, st, cfg), acc, acc, st, cfg,
                                  rng.PRNGKey(3), is_last=False)
    q1, _, _, n = tr._compact(child, 2 * R, acc, acc)
    assert n > 0
    kb = _check(q1.o, q1.d, q1.t_min, st, cfg, torus, src_node=q1.src_node,
                src_tri=q1.src_tri)
    pts, sd, t_min, kw = _shadow(q1.o, q1.d, kb, st)
    _check(pts, sd, t_min, st, cfg, torus, **kw)


def test_sweep_kernel_rejects_bad_inputs(dev):
    st = flatten_scene(scenes.load("simple").scene, dev)
    cfg = RenderConfig(device=dev)
    o = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        intersect_scene_cuda(o, o, 1e-5, INF, st, cfg)


def _same(k, p):
    """Kernel and plain version agree exactly: hit, t, node and tri."""
    for f in ("hit", "t", "node", "tri"):
        assert torch.equal(getattr(k, f).cpu(), getattr(p, f).cpu()), f


def _both_modes(o, d, st, cfg):
    k = intersect_scene_cuda(o, d, 1e-5, INF, st, cfg)
    _same(k, intersect_scene_sweep_ref(o, d, 1e-5, INF, st, cfg))
    ka = intersect_scene_cuda(o, d, 1e-5, INF, st, cfg, any_hit=True)
    assert torch.equal(ka.hit, intersect_scene_sweep_ref(o, d, 1e-5, INF, st, cfg,
                                                         any_hit=True).hit)
    return k, ka


def _down(o):
    """Rays straight down -z onto the points o [R,3] from 1 above them."""
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.zeros_like(o)
    d[:, 2] = -1.0
    return o + torch.tensor([0.0, 0.0, 1.0]), d


def _plain_scene(nodes):
    return T.Scene(T.SceneNode(nodes), [T.Light(position=(0.0, 5.0, 5.0),
                                                color=(1.0, 1.0, 1.0))], (0.2, 0.2, 0.2))


def test_sweep_kernel_breaks_exact_ties_to_the_earlier_column(dev):
    """200 copies of one triangle in one mesh (200 columns in two chunks,
    the second's 72 real lanes ending inside its third step) and 200
    copies of one sphere (one node each): every copy returns the same t,
    in the same step, in later steps and in the next chunk, so the
    earlier column must win, as in the plain version's fold."""
    mat = T.Material(diffuse=(0.5, 0.5, 0.5), specular=(0.0, 0.0, 0.0), shininess=1.0)
    tri = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]) + [-3.0, 0.0, 0.0]
    copies = T.MeshData(np.tile(tri, (200, 1)), np.arange(600).reshape(200, 3))
    spheres = [T.SceneNode(T.Geometry(T.Sphere(), mat)).translated((3.0, 0.0, 0.0))
               for _ in range(200)]
    st = flatten_scene(_plain_scene([T.SceneNode(T.Geometry(T.Mesh(copies), mat))]
                                     + spheres), dev)
    cfg = RenderConfig(device=dev)
    g = np.random.default_rng(2)
    pts = np.concatenate([np.c_[g.uniform(-3.3, -2.7, 512), g.uniform(-0.9, 0.3, 512),
                                np.zeros(512)],
                          np.c_[g.uniform(2.5, 3.5, 512), g.uniform(-0.5, 0.5, 512),
                                np.full(512, 1.5)]])
    o, d = (x.to(dev) for x in _down(pts))
    k, ka = _both_modes(o, d, st, cfg)
    assert k.hit.all() and ka.hit.all()
    node, tri = st.packed.ids.cpu()
    mesh_node = int(k.node[0])
    on_mesh = node == mesh_node
    # The earliest column of each copy set, in table order.
    first_tri = int(tri[on_mesh][0])
    first_sphere = int(node[(node >= 0) & ~on_mesh][0])
    assert (k.node[:512] == mesh_node).all() and (k.tri[:512] == first_tri).all()
    assert (k.node[512:] == first_sphere).all()


def test_sweep_kernel_over_more_than_1024_chunks(dev):
    """132,068 disjoint triangles in a plane: 1,032 chunks in 33 groups,
    so the group level takes two steps, and the last chunk's 100 real lanes
    end inside its last step.  Rays straight down onto each triangle of
    that chunk hit it and nothing else: their first hit is in the last
    step of the last group.  Plus rays onto random triangles."""
    n, side = 132068, 364
    k = np.arange(n)
    corner = np.stack([k % side, k // side, np.zeros(n)], axis=1).astype(np.float64)
    pos = np.stack([corner, corner + [0.6, 0.0, 0.0], corner + [0.0, 0.6, 0.0]], axis=1)
    mat = T.Material(diffuse=(0.5, 0.5, 0.5), specular=(0.0, 0.0, 0.0), shininess=1.0)
    mesh = T.MeshData(pos.reshape(-1, 3), np.arange(3 * n).reshape(n, 3))
    st = flatten_scene(_plain_scene([T.SceneNode(T.Geometry(T.Mesh(mesh), mat))]), dev)
    pk = st.packed
    groups = pk.groups
    assert pk.n_chunks == 1032 and groups.n_groups == 33
    assert int(groups.real_lanes[-1]) == 100
    last = pk.ids[1, (pk.n_chunks - 1) * 128:(pk.n_chunks - 1) * 128 + 100].cpu().numpy()
    g = np.random.default_rng(3)
    tris = np.concatenate([last, g.integers(0, n, 4096)])
    o, d = (x.to(dev) for x in _down(pos[tris].mean(axis=1)))
    cfg = RenderConfig(device=dev)
    hit, occ = _both_modes(o, d, st, cfg)
    assert hit.hit.all() and occ.hit.all()
    assert torch.equal(hit.tri.cpu(), torch.as_tensor(tris, dtype=torch.int32))
    # Rays that miss every triangle walk both group steps to the end.
    miss = torch.as_tensor(pos[g.integers(0, n, 1024)].mean(axis=1) + [0.45, 0.45, 0.0])
    mo, md = (x.to(dev) for x in _down(miss))
    mh, mo_hit = _both_modes(mo, md, st, cfg)
    assert not mh.hit.any() and not mo_hit.hit.any()


@pytest.mark.parametrize("name, soft, origin", [
    ("big-scene", 0.0, None), ("torus-showcase", 0.0, None),
    ("normal-mapping-numpy", 0.0, None),
    # The penumbra behind the right ball (the frame's middle is unlit).
    ("soft-shadows-icosphere", 0.05, (560, 200)),
])
def test_gradients_through_kernel_match_plain_version(dev, monkeypatch, name, soft, origin):
    """Gradients of sum(acc^2) over a 32x32 tile at 2 spp (the frame's
    middle unless `origin` is given) with respect to
    the DIFF_FIELDS tables, through the kernel and through its plain version
    (run on the card's tensors): the sweeps select the same winners, so the
    gradients agree; all finite; the kernel's inputs carried a graph from
    round 1 on (child rays depend on the tables)."""
    from portrayer_tpu_torch import render
    from portrayer_tpu_torch.ops.trace import trace

    scene, camera, (w, h) = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev, soft_visibility=soft)
    x0, y0 = origin or (w // 2 - 16, h // 2 - 16)
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(4), Camera(camera, (w, h), dev), x0, y0, 0, cfg=cfg,
        background=render.default_background, tile_h=32, tile_w=32, spp=2, samples=2)
    fields = ("mat_diffuse", "mat_specular", "mat_reflectivity", "mat_shininess",
              "light_color", "light_pos", "ambient", "inv")

    def grads():
        leaves = {f: getattr(st, f).clone().requires_grad_() for f in fields}
        acc = trace(rng.PRNGKey(5), o, d, pix, bg, 32 * 32, st.replace(**leaves), cfg, w0=w0,
                    spp_contiguous=2)
        torch.sum(acc ** 2).backward()
        return {f: x.grad for f, x in leaves.items()}

    cuda_intersect.reset_counts()
    gk = grads()
    assert cuda_intersect.COUNTS["nearest"] > 0 and cuda_intersect.COUNTS["plain_on_cuda"] == 0
    monkeypatch.setattr(cuda_intersect, "intersect_scene_cuda", intersect_scene_sweep_ref)
    gp = grads()
    assert cuda_intersect.COUNTS["plain_on_cuda"] > 0
    for f in fields:
        assert torch.isfinite(gk[f]).all(), f
        scale = gp[f].abs().max()
        torch.testing.assert_close(gk[f], gp[f], rtol=0, atol=float(1e-4 * scale), msg=f)
    # Every tile gives these a gradient; the middle of normal-mapping-numpy
    # is all textured, so its mat_diffuse gets none.
    nonzero = ("light_color", "inv")
    if name != "normal-mapping-numpy":
        nonzero += ("mat_diffuse",)
    for f in nonzero:
        assert gk[f].abs().max() > 0, f


def _gloo_rank(rank, world, store, out, n_rays):
    """One of `world` gloo ranks sharing card 0: trace_sharded of n_rays
    big-scene camera rays (reduced and per-rank partials) and the kernel
    launches of this rank, saved to out/rank<r>.pt."""
    from portrayer_tpu_torch import parallel as par

    dev = torch.device("cuda", 0)
    par.initialize(f"file://{store}", world, rank, device=dev, backend="gloo")
    try:
        mesh = par.make_mesh(world, device="cuda")
        spec = scenes.load("big-scene")
        st = flatten_scene(spec.scene, dev)
        w, h = spec.size
        u = rng.uniform(rng.PRNGKey(11), (n_rays, 2), dev)
        o, d = Camera(spec.camera, (w, h), dev).rays_at(u[:, 0] * w, u[:, 1] * h)
        pix = torch.arange(n_rays, dtype=torch.int32, device=dev) % 4096
        bg = torch.full((4096, 3), 0.25, device=dev)
        cuda_intersect.reset_counts()
        args = (rng.PRNGKey(5), o, d, pix, bg, 4096, st, RenderConfig(device=dev))
        acc = par.trace_sharded(mesh, *args)
        parts = par.trace_sharded(mesh, *args, reduce=False)
        torch.save({"acc": acc.cpu(), "parts": parts.cpu(), "counts": dict(cuda_intersect.COUNTS)},
                   f"{out}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_on_the_card_match_the_shard_sum(dev, tmp_path):
    """Two ranks share the card under gloo (NCCL refuses two ranks on one
    GPU): both hold the shard sum of this process's traces, keyed
    fold_in(key, r), within 1e-5; each rank launched both kernel modes."""
    import torch.multiprocessing as mp
    from portrayer_tpu_torch.ops.trace import trace

    world, n_rays = 2, 65536
    ctx = mp.spawn(_gloo_rank, args=(world, str(tmp_path / "store"), str(tmp_path), n_rays),
                   nprocs=world, join=False)
    while not ctx.join(timeout=600):
        pass
    spec = scenes.load("big-scene")
    st = flatten_scene(spec.scene, dev)
    w, h = spec.size
    u = rng.uniform(rng.PRNGKey(11), (n_rays, 2), dev)
    o, d = Camera(spec.camera, (w, h), dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    pix = torch.arange(n_rays, dtype=torch.int32, device=dev) % 4096
    bg = torch.full((4096, 3), 0.25, device=dev)
    per = n_rays // world
    shards = [trace(rng.fold_in(rng.PRNGKey(5), r), o[r * per:(r + 1) * per],
                    d[r * per:(r + 1) * per], pix[r * per:(r + 1) * per], bg, 4096, st,
                    RenderConfig(device=dev)).cpu() for r in range(world)]
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["counts"]["nearest"] > 0 and got["counts"]["any_hit"] > 0, got["counts"]
        assert got["counts"]["plain_on_cuda"] == 0
        torch.testing.assert_close(got["acc"], shards[0] + shards[1], rtol=0, atol=1e-5)
        for q in range(world):
            torch.testing.assert_close(got["parts"][q], shards[q], rtol=0, atol=1e-5)


def _beam_gates(ref, got):
    """tests/test_beam.py's gates: .hit equal, t within rtol 1e-4 / atol
    1e-5, a node mismatch only on a tie within 1e-4 relative t."""
    ref, got = _cpu(ref), _cpu(got)
    assert torch.equal(ref.hit, got.hit)
    m = ref.hit
    torch.testing.assert_close(got.t[m], ref.t[m], rtol=1e-4, atol=1e-5)
    mism = ref.node[m] != got.node[m]
    tie = (ref.t[m] - got.t[m]).abs() <= 1e-4 * torch.clamp(ref.t[m].abs(), min=1.0)
    assert bool((~mism | tie).all())


def test_beam_sweep_matches_the_flat_sweep_and_the_kernel(dev):
    """The gates against the flat sweep, the beam sweep's own oracle.
    Against the kernel, whose own formulas (world-space spheres among
    them) may decide a grazing ray apart from the general ones that beam
    and flat share: the kernel gates by category of sweeps_apart, at most
    the share KERNEL_APART of the rays in each, node ties on at most 0.2%
    of hits, and every ray apart cleared by its float64 witness."""
    from portrayer_tpu_torch.ops.beam import intersect_scene_beam

    spec = scenes.load("big-scene")
    st = flatten_scene(spec.scene, dev)
    st64 = float64_tables(spec.scene, dev)
    w, h = spec.size
    cfg = RenderConfig(device=dev, accel="beam")
    flat = RenderConfig(device=dev, accel="flat")
    u = rng.uniform(rng.PRNGKey(7), (131072, 2), dev)
    o, d = Camera(spec.camera, (w, h), dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    near = intersect_scene_cuda(o, d, 1e-5, INF, st, RenderConfig(device=dev))
    pts, sd, t_min, skw = _shadow(o, d, near, st)
    stats = {}
    for args, kw in (((o, d, 1e-5), {}), ((pts, sd, t_min), skw)):
        got = intersect_scene_beam(*args, INF, st, cfg, stats=stats, **kw)
        _beam_gates(intersect_scene(*args, INF, st, flat, **kw), got)
        kern = intersect_scene_cuda(*args, INF, st, RenderConfig(device=dev), **kw)
        apart = sweeps_apart(kern, got, *args, kw, st64, RenderConfig(device=dev))
        limits = kernel_apart_limits(args[0].shape[0])
        assert all(apart[c] <= limits[c] for c in limits), (apart, limits)
        assert apart["uncleared"] == 0, apart["rays"]
        assert apart["tie"] <= 0.002 * apart["hits"], apart["tie"]
    assert stats["trips"] > 0
