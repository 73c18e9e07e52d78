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
sweeps_apart).  graphs.switch under a capture runs the branch that sel
names on the device, as the host pick does.  The render replaying its
captured chunk graph (its bounce rounds' slices conditional bodies)
equals the same chunk program run op by op within 1e-6 and reads nothing
on the host, a capture that meets a host read raises, and a dead graph
that a reference cycle keeps is not collected during another capture
(its reset would end that capture).  The captured
fit (fit.py) gives the op-by-op trace's gradients within 1e-4 of their
largest entry (index_add's atomics), reads no live count on the host,
launches no sweep in its backward, and a second step on replaced tables
replays its graphs without a new capture.  Through the beam sweep the
captured render nests the sweep's loops three deep and equals its eager
loop within 1e-6, and the float64 check mode's captured render equals its
op-by-op render within 1e-6.

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
                        recorded_bodies, recorded_loops, sweeps_apart)

NAMES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
         "ellipsoids", "glass-sphere", "single-triangle", "procedural-meshes", "procedural-meshes-groups",
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
    shadow rays; in a refractive scene also the children of round 1 (rays
    that leave the glass, or reflect inside it totally, from the node they
    start on) and their shadow rays."""
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
    for _ in range(2 if st.any_refractive else 1):
        _, child, _ = tr._round_shade(q, tr._nearest(q, st, cfg), acc, acc, st, cfg,
                                      rng.PRNGKey(3), is_last=False)
        q, _, _, n = tr._compact(child, child.w.shape[0], acc, acc)
        n = int(n)
        assert n > 0
        q = tr._Queue(*(x[:n] for x in q))  # the live head
        kb = _check(q.o, q.d, q.t_min, st, cfg, torus, src_node=q.src_node, src_tri=q.src_tri)
        pts, sd, t_min, kw = _shadow(q.o, q.d, kb, st)
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
    (run on the card's tensors), both op by op (cuda_graphs=False; the
    captured fit has its own test): the sweeps select the same winners, so the
    gradients agree; all finite; the kernel's inputs carried a graph from
    round 1 on (child rays depend on the tables)."""
    from portrayer_tpu_torch import render
    from portrayer_tpu_torch.ops.trace import trace

    scene, camera, (w, h) = _scene(name)
    st = flatten_scene(scene, dev)
    # Op by op: the plain version cannot be captured.
    cfg = RenderConfig(device=dev, soft_visibility=soft, cuda_graphs=False)
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
    counts = cuda_intersect.counts()
    assert counts["nearest"] > 0 and counts["plain_on_cuda"] == 0
    monkeypatch.setattr(cuda_intersect, "intersect_scene_cuda", intersect_scene_sweep_ref)
    gp = grads()
    assert cuda_intersect.counts()["plain_on_cuda"] > 0
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
        torch.save({"acc": acc.cpu(), "parts": parts.cpu(), "counts": cuda_intersect.counts()},
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


# The middle tile of big-scene's 1980x1020 frame (region, inclusive).
BIG_TILE = ((896, 384), (1023, 511))


@pytest.mark.parametrize("name, size, region", [
    ("big-scene", (1980, 1020), BIG_TILE), ("torus-showcase", (256, 256), None)])
def test_captured_render_matches_the_eager_chunk_loop(dev, name, size, region):
    """The render replaying its captured chunk graph against the same
    chunk program run op by op (cuda_graphs=False), at the main paths' 16
    spp and 131,072 rays a chunk: within 1e-6 (index_add's float atomics
    sum in another order), the same live rays per round, the chunk graph
    replayed once a chunk and reading nothing on the host (each unrolled
    bounce round's slice a conditional body, the tail of equal capacity
    one loop whose body holds its slices), the sweep launches counted on the
    device where the bodies ran (the captured render's are the eager
    loop's plus its warm-up's)."""
    import dataclasses

    spec = scenes.load(name)
    st = flatten_scene(spec.scene, dev)
    cfg = RenderConfig(device=dev, samples=16, max_rays_per_launch=131072,
                       queue_caps=spec.queue_caps)
    args = (st, spec.camera, size, spec.background)
    runs = {}
    for graphs in (True, False):
        stats = []
        cuda_intersect.reset_counts()
        img = T.render_linear(*args, dataclasses.replace(cfg, cuda_graphs=graphs),
                              region=region, stats=stats)
        runs[graphs] = img, stats, cuda_intersect.counts()
    (img, stats, counts), (ref, ref_stats, ref_counts) = runs[True], runs[False]
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in ref_stats]
    (prog,) = st.chunk_programs.values()
    assert list(prog.graphs) == ["chunk"] and prog.graphs["chunk"].replays == len(stats)
    assert all(s.syncs == 0 for s in stats)
    assert prog.graphs["chunk"].bodies == recorded_bodies(prog.pl, cfg.queue_slice_divs)
    assert prog.graphs["chunk"].loops == recorded_loops(prog.pl)
    for mode in ("nearest", "any_hit"):
        assert counts[mode] == ref_counts[mode] + prog.warm_launches[mode], (counts, ref_counts)
    assert counts["plain_on_cuda"] == ref_counts["plain_on_cuda"] == 0
    if st.any_reflective:
        assert sum(s.syncs for s in ref_stats) > 0 and counts["graph_if"] > 0


def _captured_and_eager(dev, name, size, cfg):
    """render_linear of `name` at `size` under cfg captured and op by op
    (cuda_graphs=False), on one set of tables: ((image, stats, counts) of
    each, the program)."""
    import dataclasses

    spec = scenes.load(name)
    st = flatten_scene(spec.scene, dev, dtype=cfg.dtype)
    runs = []
    for graphs in (True, False):
        stats = []
        cuda_intersect.reset_counts()
        img = T.render_linear(st, spec.camera, size, spec.background,
                              dataclasses.replace(cfg, cuda_graphs=graphs), stats=stats)
        runs.append((img, stats, cuda_intersect.counts()))
    (prog,) = st.chunk_programs.values()
    return runs, prog


def test_captured_beam_render_nests_its_loops(dev):
    """glossy-reflection at 256x256 x 4 spp with accel="beam" and
    beam_min_prims=0: every round's sweeps take the beam, whose ordered
    walks are WHILE nodes in round 0, in each slice body of the last
    round and in each slice body of the tail loop's round (a WHILE in an
    IF in a WHILE: loops nested three deep).  The captured render against
    the eager chunk loop within 1e-6 (index_add's float atomics), the
    same live rays per round, 0 host syncs a chunk, the bodies from the
    plan and the loops from the plan and the scene's groups, and the
    beam's steps counted on the device the eager loop's plus the
    warm-up's."""
    from _torch_jax import beam_loops

    cfg = RenderConfig(device=dev, samples=4, max_rays_per_launch=131072, accel="beam",
                       beam_min_prims=0)
    ((img, stats, counts), (ref, ref_stats, ref_counts)), prog = _captured_and_eager(
        dev, "glossy-reflection", (256, 256), cfg)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in ref_stats]
    assert all(s.syncs == 0 for s in stats) and sum(s.syncs for s in ref_stats) > 0
    g = prog.graphs["chunk"]
    divs = cfg.queue_slice_divs
    assert any(rd.looped for rd in prog.rounds)
    assert g.bodies == recorded_bodies(prog.pl, divs)
    assert g.loops == recorded_loops(prog.pl, divs, 2 * beam_loops(prog.st, cfg))
    for mode in ("flat_sweep", "beam_sweep", "beam_step"):
        assert counts[mode] == ref_counts[mode] + prog.warm_launches[mode], mode
    assert ref_counts["beam_step"] > 0 and counts["nearest"] == counts["any_hit"] == 0
    assert int(sum(s.live for s in stats)[2]) > 0  # rays alive in the tail loop's rounds


def test_captured_float64_render_matches_op_by_op(dev):
    """The float64 check mode (accel="flat") through the captured chunk
    program: glossy-reflection at 96x64 x 2 spp (bounce rounds, the tail
    loop), float64 buffers, within 1e-6 of its op-by-op render, 0 host
    syncs a chunk."""
    cfg = RenderConfig(device=dev, samples=2, accel="flat", dtype=torch.float64)
    ((img, stats, _), (ref, ref_stats, _)), prog = _captured_and_eager(
        dev, "glossy-reflection", (96, 64), cfg)
    assert prog.tile_acc.dtype == torch.float64 and list(prog.graphs) == ["chunk"]
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in ref_stats]
    assert all(s.syncs == 0 for s in stats) and sum(s.syncs for s in ref_stats) > 0


def test_a_capture_that_meets_a_host_read_raises(dev, tmp_path):
    """A background that reads a value on the host runs in the warm-up
    chunk, then fails the capture: the render raises and returns no image
    (no eager path takes over).  In a process of its own, since a failed
    capture may leave the CUDA context unusable."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import portrayer_tpu_torch as T\n"
        "from portrayer_tpu_torch import scenes\n"
        "s = scenes.load('simple')\n"
        "bg = lambda uv: scenes.sky_background(uv) * float(uv.max() >= 0.0)\n"
        "try:\n"
        "    T.render_linear(s.scene, s.camera, (64, 64), bg, T.RenderConfig(samples=4))\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "    raise SystemExit(3)\n"
        "print('rendered')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root), timeout=600)
    assert out.returncode == 3 and "raised:" in out.stdout, (out.stdout, out.stderr[-2000:])


# Fields of parallel.DIFF_FIELDS; their gradients through the captured fit
# and the op-by-op trace differ by the order of the float atomics.
FIT_FIELDS = ("mat_diffuse", "mat_specular", "mat_reflectivity", "mat_shininess",
              "light_color", "light_pos", "ambient", "inv")
FIT_RTOL = 1e-4
COLOURS = ("mat_diffuse", "mat_specular", "light_color", "ambient")


@pytest.mark.parametrize("name", ["glossy-reflection", "glass-sphere"])
def test_captured_fit_matches_the_op_by_op_trace(dev, name):
    _captured_fit_against_op_by_op(dev, name, 0)


@pytest.mark.parametrize("remat_min_lanes", [8193, 1 << 30])
@pytest.mark.parametrize("name", ["glossy-reflection", "glass-sphere"])
def test_captured_exempt_fit_matches_the_op_by_op_trace(dev, name, remat_min_lanes):
    """The check below with the slices of fewer than remat_min_lanes lanes
    exempt from the replay (their forward recorded by autograd, its saved
    tensors in residual slots of the state slab, their backward the vjp
    of that graph): some slices, or all."""
    prog = _captured_fit_against_op_by_op(dev, name, remat_min_lanes)
    assert prog.exempt and prog.res.shapes


def _captured_fit_against_op_by_op(dev, name, remat_min_lanes):
    """A 64x64 tile at 4 spp of glossy-reflection (mirror and glossy
    bounces) and of the glass sphere (4x queues, refraction, total
    internal reflection): gradients of sum(acc^2) with respect to every
    DIFF_FIELDS table through the captured fit program against the trace
    run op by op (cuda_graphs=False) within FIT_RTOL of the largest entry,
    the colours within 1e-6 and the same live rays per round; the captured
    step reads no live count on the host; no sweep launched in either
    backward; a second step on tables replaced with other values replays
    the forward and backward graphs without a new capture, and matches
    the op-by-op trace too."""
    import dataclasses
    from portrayer_tpu_torch import render
    from portrayer_tpu_torch.ops.trace import trace

    scene, camera, (w, h) = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev, remat_min_lanes=remat_min_lanes)
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(4), Camera(camera, (w, h), dev), w // 2 - 32, h // 2 - 32, 0, cfg=cfg,
        background=render.default_background, tile_h=64, tile_w=64, spp=4, samples=4)

    def step(cfg, scale):
        # New colours, the same geometry: the second step's rounds keep
        # their live counts, so their slices and graphs.
        leaves = {f: (getattr(st, f) * (scale if f in COLOURS else 1.0)).detach()
                  .requires_grad_() for f in FIT_FIELDS}
        acc, stats = trace(rng.PRNGKey(5), o, d, pix, bg, 64 * 64, st.replace(**leaves), cfg,
                           w0=w0, spp_contiguous=4, with_stats=True)
        torch.cuda.synchronize()
        cuda_intersect.reset_counts()
        torch.sum(acc ** 2).backward()
        torch.cuda.synchronize()
        counts = cuda_intersect.counts()
        assert counts["nearest"] == counts["any_hit"] == counts["plain_on_cuda"] == 0
        return acc.detach(), {f: x.grad for f, x in leaves.items()}, stats

    eager = dataclasses.replace(cfg, cuda_graphs=False)
    for scale in (1.0, 0.9):
        acc, g, stats = step(cfg, scale)
        racc, rg, rstats = step(eager, scale)
        assert stats.live.tolist() == rstats.live.tolist() and int(stats.live[1]) > 0
        assert stats.syncs == 0 and rstats.syncs > 0
        torch.testing.assert_close(acc, racc, rtol=0, atol=1e-6)
        for f in FIT_FIELDS:
            assert torch.isfinite(g[f]).all(), f
            scale_f = float(rg[f].abs().max())
            torch.testing.assert_close(g[f], rg[f], rtol=0, atol=FIT_RTOL * scale_f, msg=f)
        (prog,) = st.packed.fit_programs.values()
        if scale == 1.0:
            graphs, capture_s = dict(prog.graphs), prog.capture_s
            replays = {k: v.replays for k, v in graphs.items()}
    assert sorted(prog.graphs) == ["backward", "forward"]
    assert prog.graphs == graphs and prog.capture_s == capture_s
    assert prog.graphs["forward"].replays == replays["forward"] + 1
    return prog


def test_switch_on_the_card_takes_the_branch_of_sel(dev):
    """graphs.switch under a capture: the replayed graph runs the branch
    that sel names on the device (none for a dead one), as the host pick
    does off capture, for every sel; a branch that allocates reuses its
    memory across replays; the conditional kernel counts one run a
    branch and replay, on the device."""
    from portrayer_tpu_torch import graphs

    out = torch.zeros(4, device=dev)
    sel = torch.zeros((), dtype=torch.int64, device=dev)

    def branch(i):
        return lambda: out.copy_(torch.full((4,), float(i), device=dev) * 2.0)

    branches = [None, branch(1), branch(2), branch(3)]

    def step():
        out.fill_(-1.0)
        graphs.switch(sel.clone(), branches)

    g = graphs.Graph(step, torch.cuda.graph_pool_handle())
    assert g.bodies == 3
    cuda_intersect.reset_counts()
    for i in range(4):
        sel.fill_(i)
        g.replay()
        got = out.clone()
        assert graphs.switch(sel, branches) == i
        want = -1.0 if i == 0 else 2.0 * i
        assert got.tolist() == [want] * 4
    assert cuda_intersect.counts()["graph_if"] == 4 * 3
    assert g.replays == 4


def test_loop_on_the_card_runs_as_the_host_loop(dev):
    """graphs.loop under a capture, with a switch nested in its body: the
    replayed graph runs the iterations that the host loop runs (none, one,
    several; ended by the live count or by the end), each taking the
    branch its sel names, and leaves the same index; the body's
    temporaries are reused across iterations and replays; the step kernel
    counts one run before the node and one an iteration, the conditional
    kernel one a branch and iteration, on the device."""
    from portrayer_tpu_torch import graphs

    end = 6
    i64 = dict(dtype=torch.int64, device=dev)
    index, live = torch.zeros((), **i64), torch.zeros((), **i64)
    start, stop = torch.zeros((), **i64), torch.zeros((), **i64)
    out = torch.zeros(end + 4, device=dev)

    def branch(i):
        return lambda: out.index_add_(0, index.reshape(1), torch.full((1,), float(i), device=dev))

    branches = [None, branch(1), branch(2), branch(3)]

    def body():
        graphs.switch(torch.remainder(index, 3) + 1, branches)
        live.copy_((index + 1 < stop).to(torch.int64))

    def step():
        out.fill_(-1.0)
        index.copy_(start)
        live.copy_((start < stop).to(torch.int64))
        return graphs.loop(index, end, live, body)

    g = graphs.Graph(step, torch.cuda.graph_pool_handle())
    assert g.loops == 1 and g.bodies == 3
    for s0, s1 in ((0, 0), (0, 1), (0, 4), (1, end + 3), (end, end + 2), (2, 2)):
        start.fill_(s0)
        stop.fill_(s1)
        cuda_intersect.reset_counts()
        g.replay()
        torch.cuda.synchronize()
        counts = cuda_intersect.counts()
        got, got_index = out.clone(), int(index)
        reads = step()
        iterations = max(0, min(s1, end) - s0)
        assert torch.equal(got, out) and got_index == int(index), (s0, s1)
        assert reads == iterations + 1
        assert got[s0:s0 + iterations].tolist() == [
            -1.0 + (i % 3) + 1 for i in range(s0, s0 + iterations)], (s0, s1)
        assert counts["graph_while"] == 1 + iterations and counts["graph_if"] == 3 * iterations
    assert g.replays == 6


def test_graphs_keep_their_body_streams_apart_from_the_capture_stream(dev):
    """More graphs than PyTorch's pool of 32 streams a device, each with a
    switch inside a loop: every capture succeeds, because the bodies are
    recorded on streams made outside that pool (which hands its streams
    out in turn, the capture stream among them)."""
    from portrayer_tpu_torch import graphs

    i64 = dict(dtype=torch.int64, device=dev)
    index, live, out = torch.zeros((), **i64), torch.ones((), **i64), torch.zeros(3, **i64)
    branches = [None, lambda: out.add_(1)]

    def step():
        out.zero_()
        index.zero_()
        graphs.loop(index, 3, live, lambda: graphs.switch(torch.ones((), **i64), branches))

    for _ in range(40):
        torch.cuda.Stream(dev)  # as other code takes streams from the pool
        g = graphs.Graph(step, torch.cuda.graph_pool_handle())
        g.replay()
        assert out.tolist() == [3, 3, 3] and int(index) == 3


def test_a_capture_is_not_ended_by_collecting_a_dead_graph(dev):
    """A dead graph that a reference cycle keeps is not collected while
    another graph captures (its CUDA graph's reset would end that
    capture): the captured step asks for a collection at each allocation,
    and the capture still succeeds and replays."""
    import gc
    from portrayer_tpu_torch import graphs

    x = torch.zeros(4, device=dev)

    class Cycle:
        pass

    dead = Cycle()
    dead.me = dead
    dead.graph = graphs.Graph(lambda: x.add_(1.0), torch.cuda.graph_pool_handle())
    del dead
    thresholds = gc.get_threshold()

    def step():
        gc.set_threshold(1, 1, 1)
        try:
            [[i] for i in range(2000)]
        finally:
            gc.set_threshold(*thresholds)
        x.mul_(2.0)

    g = graphs.Graph(step, torch.cuda.graph_pool_handle())
    gc.collect()
    x.fill_(1.0)
    g.replay()
    assert x.tolist() == [2.0] * 4


@pytest.mark.parametrize("name", ["big-scene", "glossy-reflection"])
def test_stamped_render_matches_the_unstamped_one(dev, name):
    """A render with spans=Spans() captures a program of its own whose
    chunk graph holds the stamps (two in the head, one in each conditional
    body, one at its end) and renders the u8 frame of the unstamped
    program bit for bit; the unstamped capture holds no stamp node.  Each
    chunk's stamps rise with their columns, its round spans lie inside its
    span, and the clock's calibration is within 50 us."""
    spec = scenes.load(name)
    st = flatten_scene(spec.scene, dev)
    cfg = RenderConfig(device=dev, samples=16, max_rays_per_launch=131072,
                       queue_caps=spec.queue_caps)
    args = (st, spec.camera, (256, 128), spec.background, cfg)
    plain = T.render_u8(*args)
    spans = T.Spans()
    np.testing.assert_array_equal(T.render_u8(*args, spans=spans), plain)
    unstamped, stamped = st.chunk_programs.values()
    assert unstamped.stamps is None and unstamped.graphs["chunk"].stamps == 0
    assert stamped.graphs["chunk"].stamps == 3 + recorded_bodies(stamped.pl,
                                                                 cfg.queue_slice_divs)
    chunks = [s for s in spans.records if s.name == "chunk"]
    table = stamped.stamps[:len(chunks)].cpu()
    for row in table:
        ran = row[row != 0]
        assert row[0] != 0 and row[-1] != 0 and bool((ran[1:] >= ran[:-1]).all()), row
    by_id = {s.id: s for s in spans.records}
    rounds = [s for s in spans.records if s.name.startswith("round ")]
    assert rounds and all(by_id[r.parent].t0_ns <= r.t0_ns <= r.t1_ns <= by_id[r.parent].t1_ns
                          for r in rounds)
    (frame,) = [s for s in spans.records if s.name == "frame"]
    assert 0 <= frame.attrs["clock_unc_ns"] < 50_000
    assert all(frame.t0_ns <= c.t0_ns <= c.t1_ns <= frame.t1_ns for c in chunks)
