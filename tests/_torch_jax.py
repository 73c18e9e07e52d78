"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: carrying JAX tables across, and the JAX package's kernel gates."""

import numpy as np

from portrayer_tpu_torch.scene.flatten import TABLE_FIELDS, PACKED_FIELDS, META_FIELDS, TORUS


def jax_arrays(st):
    """({field: numpy array}, meta) of a JAX SceneTables, the input of
    portrayer_tpu_torch.tables_from_numpy."""
    arrays = {f: np.asarray(getattr(st, f)) for f in TABLE_FIELDS}
    arrays.update({f"packed.{f}": np.asarray(getattr(st.packed, f)) for f in PACKED_FIELDS})
    meta = {f: getattr(st, f) for f in META_FIELDS if hasattr(st, f)}
    meta.update(kind_ranges=st.packed.kind_ranges, n_chunks=st.packed.n_chunks)
    # Procedural textures are callables of one package: the inline scenes'
    # jnp checker crosses as its torch twin.
    meta["fn_textures"] = tuple(_checker_torch if f is _checker_jax else f
                                for f in st.fn_textures)
    return arrays, meta


# A ray that re-hits the node it left does so near-tangentially, just past
# the self-eps raise: the root is ill-conditioned there, and the JAX
# package's own flat sweep and Pallas kernel differ by up to 2e-3 relative
# t on such rays (big-scene shadow rays).  Everywhere else the kernel
# gate's rtol 1e-4 holds.
SELF_HIT_RTOL = 5e-3

# Torus roots come out of an f32 quartic solve (Ferrari, cube roots, an
# arccos, Newton polish) whose rounding differs between the packages: the
# JAX package's own gate for them (tests/test_torus.py) is rtol 1e-3 /
# atol 1e-3 on t.
TORUS_TOL = 1e-3


def torus_nodes(st):
    """Node ids of the torus group of SceneTables `st` (JAX or port)."""
    return [i for kind, start, count in st.groups if kind == TORUS
            for i in range(start, start + count)]


def assert_gates(ref, got, src_node=None, torus=()):
    """The kernel gates of tests/test_pallas.py: .hit equal; node
    mismatches on at most 0.2% of hits and only within 2*2^-16 relative t;
    elsewhere tri equal and t within rtol 1e-4 / atol 1e-5 (SELF_HIT_RTOL
    on re-hits of the ray's own src_node, TORUS_TOL on hits of the node
    ids in `torus`)."""
    rh, gh = np.asarray(ref.hit), np.asarray(got.hit)
    np.testing.assert_array_equal(rh, gh)
    rn, gn = np.asarray(ref.node)[rh], np.asarray(got.node)[rh]
    rt, gt = np.asarray(ref.t)[rh], np.asarray(got.t)[rh]
    mism = rn != gn
    assert mism.sum() <= 0.002 * max(mism.size, 1), f"{mism.sum()} node mismatches"
    np.testing.assert_array_equal(np.asarray(ref.tri)[rh][~mism],
                                  np.asarray(got.tri)[rh][~mism])
    self_hit = np.zeros_like(mism)
    if src_node is not None:
        self_hit = rn == np.asarray(src_node)[rh]
    on_torus = np.isin(rn, np.asarray(torus, dtype=np.int64))
    plain = ~mism & ~self_hit & ~on_torus
    np.testing.assert_allclose(gt[plain], rt[plain], rtol=1e-4, atol=1e-5)
    sh = self_hit & ~mism & ~on_torus
    np.testing.assert_allclose(gt[sh], rt[sh], rtol=SELF_HIT_RTOL, atol=1e-5)
    tor = on_torus & ~mism
    np.testing.assert_allclose(gt[tor], rt[tor], rtol=TORUS_TOL, atol=TORUS_TOL)
    if mism.any():
        quantum = 2.0 ** -16 * np.maximum(np.abs(rt[mism]), np.abs(gt[mism]))
        quantum = np.where(on_torus[mism], TORUS_TOL * np.abs(rt[mism]), quantum)
        assert (np.abs(gt[mism] - rt[mism]) <= 2.0 * quantum + 1e-5).all(), (
            "node-mismatched rays outside the tie quantum")


# ---------------------------------------------------------------------------
# The sweep kernel against a general-formula sweep (flat or beam) on the card
# ---------------------------------------------------------------------------

# The most rays of a query on which the kernel and the flat or beam sweep
# may part, per category of sweeps_apart, as shares of the query's rays:
# twice the largest share read on the H100 (PERF.md), every ray of which
# the float64 witness cleared.  The readings on big-scene, chip_smoke.py's
# 131,072 camera rays / their 393,216 shadow rays / the card test's 131,072
# shadow rays: hit 2 / 0 / 0, node 1 / 1 / 0, t 7 / 4 / 1, self_t 0 / 160 /
# 58.
KERNEL_APART = {"hit": 3.1e-5, "node": 1.6e-5, "t": 1.1e-4, "self_t": 9e-4}


def kernel_apart_limits(n_rays):
    """{category: the most rays apart} for a query of n_rays rays."""
    return {c: int(share * n_rays) for c, share in KERNEL_APART.items()}


def float64_tables(scene, device):
    """`scene`'s tables in float64, the packed table too (from the float64
    arrays that the float32 one is rounded from): the float64 flat sweep
    and the kernel's plain version in float64 read them."""
    import dataclasses
    import torch
    from portrayer_tpu_torch.scene.flatten import _flatten_numpy, tables_from_numpy

    arrays, meta = _flatten_numpy(scene)
    st = tables_from_numpy(arrays, meta, device, torch.float64)
    f64 = {k: torch.tensor(np.asarray(arrays[f"packed.{k}"]), dtype=torch.float64,
                           device=device) for k in ("f32", "chunk_min", "chunk_max")}
    return st.replace(packed=dataclasses.replace(st.packed, **f64))


def _node_branches(st):
    """{node id: packed kind name} of SceneTables `st`."""
    from portrayer_tpu_torch.scene.flatten import PACK_CHUNK, PACKED_KIND_NAMES

    ids = st.packed.ids[0].cpu().numpy()
    kinds = np.repeat(st.packed.chunk_kind.cpu().numpy(), PACK_CHUNK)
    return {int(n): PACKED_KIND_NAMES[int(k)] for n, k in zip(ids, kinds) if n >= 0}


def sweeps_apart(kern, got, o, d, t_min, kw, st64, cfg):
    """Where the sweep kernel's nearest hits `kern` and a general-formula
    sweep's `got` (flat or beam) part on the float32 rays o, d (`t_min`,
    and `kw`: active, src_node, src_tri), by assert_gates' gates, with a
    second witness on every such ray.

    Categories: "hit" (.hit differs); "node" (both hit, other nodes, t
    outside the tie quantum 2*2^-16 relative + 1e-5); "t" (the same node,
    t beyond rtol 1e-4 / atol 1e-5); "self_t" (the same, on a re-hit of
    the ray's src_node, beyond SELF_HIT_RTOL); "tie" (other nodes inside
    the tie quantum), which assert_gates allows on 0.2% of hits.  The witness runs the kernel's
    formulas in float64 (its plain version over st64's float64 packed
    table) and the general ones in float64 (the flat sweep on st64) on
    the same rays, their directions normalized in float64 (the kernel's
    world-space sphere assumes |d| = 1, as the JAX package's kernel does,
    and so turns the float32 rounding of |d| into t).  Where they agree
    (.hit, and t within rtol 1e-6 / atol 1e-9), the two sets of formulas
    give one answer without float32 rounding; the kernel equals its plain
    version and the beam sweep the flat one, each code alike in float32
    and float64, so float32 rounding is what parted the sweeps.

    Returns the category counts, "hits" (rays both hit), "uncleared"
    (rays apart the witness does not clear), "branches" ({category:
    {branch of the kernel's node, else the sweep's: rays}}) and "rays"
    ({category: a line for each ray apart})."""
    import torch
    from portrayer_tpu_torch import RenderConfig
    from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_sweep_ref
    from portrayer_tpu_torch.ops.intersect import intersect_scene

    both = kern.hit & got.hit
    kt, gt = kern.t, got.t
    other = both & (kern.node != got.node)
    tie = other & ((kt - gt).abs() <= 2.0 * 2.0 ** -16 * torch.maximum(kt.abs(), gt.abs())
                   + 1e-5)
    same = both & ~other
    self_hit = (torch.zeros_like(same) if kw.get("src_node") is None
                else kern.node == kw["src_node"])
    dt = (gt - kt).abs()
    cats = {"hit": kern.hit != got.hit, "node": other & ~tie,
            "t": same & ~self_hit & (dt > 1e-5 + 1e-4 * kt.abs()),
            "self_t": same & self_hit & (dt > 1e-5 + SELF_HIT_RTOL * kt.abs())}
    out = {k: int(v.sum()) for k, v in cats.items()}
    out.update(tie=int(tie.sum()), hits=int(both.sum()), uncleared=0,
               branches={c: {} for c in cats}, rays={c: [] for c in cats})
    idx = torch.nonzero(sum(cats.values()).bool()).squeeze(1)
    if idx.numel() == 0:
        return out
    o64, d64 = o[idx].double(), d[idx].double()
    d64 = d64 / torch.linalg.vector_norm(d64, dim=1, keepdim=True)
    tm = t_min[idx].double() if isinstance(t_min, torch.Tensor) and t_min.dim() else t_min
    kw64 = {k: v[idx] for k, v in kw.items()}
    inf = float("inf")
    kp = intersect_scene_sweep_ref(o64, d64, tm, inf, st64, cfg, **kw64)
    fl = intersect_scene(o64, d64, tm, inf, st64, RenderConfig(
        device=o.device, accel="flat", dtype=torch.float64), **kw64)
    close = lambda h: (h.t.double() - fl.t).abs() <= 1e-9 + 1e-6 * fl.t.abs()
    cleared = (kp.hit == fl.hit) & (~fl.hit | close(kp))
    out["uncleared"] = int((~cleared).sum())
    branch = _node_branches(st64)
    h = lambda x, i: (f"hit {x.node[i].item()} [{branch.get(x.node[i].item(), '-')}] "
                      f"t={x.t[i].item():.9g}" if x.hit[i] else "miss")
    ks, gs = (type(kern)(*(f[idx] for f in kern)), type(got)(*(f[idx] for f in got)))
    for i, j in enumerate(idx.tolist()):
        cat = next(c for c in cats if cats[c][j])
        node = (ks if ks.hit[i] else gs).node[i].item()
        where = out["branches"][cat]
        where[branch[node]] = where.get(branch[node], 0) + 1
        out["rays"][cat].append(
            f"ray {j} ({cat}): kernel {h(ks, i)}, sweep {h(gs, i)}; in float64 the "
            f"kernel's formulas {h(kp, i)}, the flat sweep's {h(fl, i)}: "
            + ("cleared" if cleared[i] else "NOT cleared"))
    return out


# ---------------------------------------------------------------------------
# Inline scenes, built with either package's classes (`pkg` is
# portrayer_tpu or portrayer_tpu_torch): (scene, camera settings, size).
# ---------------------------------------------------------------------------

def ellipsoids(pkg):
    """Non-uniformly scaled, rotated spheres (packed as sphere_g), one of
    them a mirror, over a floor plane."""
    mat = pkg.Material(diffuse=(0.5, 0.5, 0.5), specular=(0.3, 0.3, 0.3), shininess=20.0)
    mirror = pkg.Material(diffuse=(0.2, 0.3, 0.5), specular=(0.5, 0.5, 0.5), shininess=30.0,
                          reflectivity=0.5)
    nodes = [
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), mirror if i == 2 else mat))
        .scaled((1.0 + 0.5 * (i % 3), 2.0 - 0.25 * i, 0.8 + 0.3 * i))
        .rotated_y(0.4 * i).translated((3.0 * i - 6.0, 0.0, -2.0 * i))
        for i in range(5)
    ]
    nodes.append(pkg.SceneNode(pkg.Geometry(pkg.Plane(), mat)).scaled(40.0)
                 .translated((0.0, -2.0, 0.0)))
    scene = pkg.Scene(pkg.SceneNode(nodes),
                      [pkg.Light(position=(0.0, 10.0, 10.0), color=(1.0, 1.0, 1.0))],
                      (0.2, 0.2, 0.2))
    cam = pkg.CameraSettings(eye=(0.0, 3.0, 14.0), center=(0.0, 0.0, -4.0), fovy=0.8)
    return scene, cam, (256, 256)


def glass_sphere(pkg):
    """A refractive sphere (index 1.5) before a red sphere on a floor
    plane: reflect and refract children, total internal reflection."""
    glass = pkg.Material(diffuse=(0.05, 0.05, 0.05), specular=(0.9, 0.9, 0.9), shininess=80.0,
                         reflectivity=0.9, refraction_index=1.5)
    red = pkg.Material(diffuse=(0.8, 0.1, 0.1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    floor = pkg.Material(diffuse=(0.4, 0.4, 0.45), specular=(0.2, 0.2, 0.2), shininess=10.0)
    scene = pkg.Scene(pkg.SceneNode([
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), glass)).scaled(1.2).translated((0.0, 1.2, 0.0)),
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), red)).translated((1.0, 1.0, -3.0)),
        pkg.SceneNode(pkg.Geometry(pkg.Plane(), floor)).scaled(30.0),
    ]), [pkg.Light(position=(-4.0, 8.0, 6.0), color=(0.9, 0.9, 0.9))], (0.3, 0.3, 0.3))
    cam = pkg.CameraSettings(eye=(0.0, 2.5, 7.0), center=(0.0, 1.0, 0.0), fovy=0.9)
    return scene, cam, (64, 64)


def _icosphere(subdiv):
    """(positions [V,3] on the unit sphere, triangles [F,3]): an icosahedron
    whose faces are split in four `subdiv` times (20 * 4^subdiv faces)."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p),
             (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        mid = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = verts[i] + verts[j]
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        faces = [f for a, b, c in faces for f in (
            (a, midpoint(a, b), midpoint(c, a)), (b, midpoint(b, c), midpoint(a, b)),
            (c, midpoint(c, a), midpoint(b, c)),
            (midpoint(a, b), midpoint(b, c), midpoint(c, a)))]
    return np.stack(verts), np.asarray(faces, np.int64)


def procedural_meshes(pkg, subdiv=5, grid=128):
    """Meshes built from numpy: an icosphere (subdiv splits, vertex normals
    equal to positions, smooth) instanced by two nodes sharing one MeshData,
    a mirror and a diffuse one scaled (1, 0.7, 1); a height field of grid x
    grid quads with tex coords (flat), scaled 6; a standalone triangle with
    vertex normals and tex coords; two point lights.  Pairs: 2 * 20 *
    4^subdiv + 2 * grid^2 + 1 (73,729 at the defaults, in 577 chunks)."""
    pos, tris = _icosphere(subdiv)
    sphere = pkg.MeshData(pos, tris, normals=pos)
    n = grid + 1
    u, v = np.meshgrid(np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0, n), indexing="ij")
    x, z = u - 0.5, v - 0.5
    y = 0.03 * np.sin(9.0 * x) * np.cos(7.0 * z) + 0.02 * np.cos(13.0 * (x + z))
    hpos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    ij = np.arange(n * n).reshape(n, n)
    a, b, c, d = ij[:-1, :-1], ij[1:, :-1], ij[1:, 1:], ij[:-1, 1:]
    quads = np.stack([np.stack([a, d, c], -1), np.stack([a, c, b], -1)], axis=2)
    terrain = pkg.MeshData(hpos, quads.reshape(-1, 3),
                           tex_coords=np.stack([u, v], axis=-1).reshape(-1, 2))
    mirror = pkg.Material(diffuse=(0.1, 0.1, 0.12), specular=(0.8, 0.8, 0.8), shininess=60.0,
                          reflectivity=0.6)
    clay = pkg.Material(diffuse=(0.8, 0.35, 0.2), specular=(0.4, 0.4, 0.4), shininess=25.0)
    ground = pkg.Material(diffuse=(0.35, 0.55, 0.3), specular=(0.1, 0.1, 0.1), shininess=10.0)
    panel = pkg.Material(diffuse=(0.3, 0.4, 0.85), specular=(0.3, 0.3, 0.3), shininess=20.0)
    tri = pkg.Triangle((-2.6, -0.4, -1.8), (2.6, -0.4, -1.8), (0.0, 2.4, -2.2),
                       normals=((-0.3, 0.0, 1.0), (0.3, 0.0, 1.0), (0.0, 0.3, 1.0)),
                       tex_coords=((0.0, 0.0), (1.0, 0.0), (0.5, 1.0)))
    scene = pkg.Scene(pkg.SceneNode([
        pkg.SceneNode(pkg.Geometry(pkg.Mesh(sphere, pkg.Shading.Smooth), mirror))
        .scaled(0.8).translated((-0.9, 0.45, 0.0)),
        pkg.SceneNode(pkg.Geometry(pkg.Mesh(sphere, pkg.Shading.Smooth), clay))
        .scaled((1.0, 0.7, 1.0)).scaled(0.6).rotated_y(0.5).translated((0.95, 0.25, 0.6)),
        pkg.SceneNode(pkg.Geometry(pkg.Mesh(terrain, pkg.Shading.Flat), ground))
        .scaled(6.0).translated((0.0, -0.4, 0.0)),
        pkg.SceneNode(pkg.Geometry(tri, panel)),
    ]), [pkg.Light(position=(-4.0, 6.0, 5.0), color=(0.8, 0.8, 0.8)),
         pkg.Light(position=(5.0, 4.0, 2.0), color=(0.4, 0.4, 0.5))], (0.25, 0.25, 0.25))
    cam = pkg.CameraSettings(eye=(0.0, 1.4, 5.5), center=(0.0, 0.2, 0.0), fovy=0.75)
    return scene, cam, (960, 540)


INLINE = {"ellipsoids": ellipsoids, "glass-sphere": glass_sphere,
          # The test size: 769 pairs in 7 chunks.
          "procedural-meshes": lambda pkg: procedural_meshes(pkg, subdiv=2, grid=8),
          # 4,609 pairs in 37 chunks: two groups of the sweep kernel's cull.
          "procedural-meshes-groups": lambda pkg: procedural_meshes(pkg, subdiv=3, grid=32)}


# ---------------------------------------------------------------------------
# Stand-ins for the asset-backed texture scenes, from seeded numpy data.
# ---------------------------------------------------------------------------

def _checker_torch(uv):
    """The floor's procedural checker on torch tensors."""
    import torch

    c = torch.remainder(torch.floor(uv[..., 0]) + torch.floor(uv[..., 1]), 2.0)
    return torch.stack([0.25 + 0.5 * c, 0.3 + 0.4 * c, 0.35 + 0.3 * c], dim=-1)


def _checker_jax(uv):
    """The same checker on jax arrays, op for op."""
    import jax.numpy as jnp

    c = jnp.mod(jnp.floor(uv[..., 0]) + jnp.floor(uv[..., 1]), 2.0)
    return jnp.stack([0.25 + 0.5 * c, 0.3 + 0.4 * c, 0.35 + 0.3 * c], axis=-1)


def checker(pkg):
    """The checker callable for package `pkg` (the JAX package's shading
    traces jnp, the port's torch)."""
    return _checker_jax if pkg.__name__ == "portrayer_tpu" else _checker_torch


def colour_image(seed, h, w):
    """[h, w, 3] uint8: blocks of 32 texels of random colour with per-texel
    noise."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3))
    img = np.repeat(np.repeat(base, 32, axis=0), 32, axis=1)[:h, :w]
    return np.clip(img + g.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def normal_image(seed, h, w):
    """[h, w, 3] uint8 tangent-space normal map, (n + 1) / 2 * 255, of a
    height field made of six random sinusoids."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    dx = np.zeros((h, w))
    dy = np.zeros((h, w))
    for _ in range(6):
        fx, fy = g.integers(2, 24, 2) * 2.0 * np.pi
        ph, amp = g.uniform(0.0, 2.0 * np.pi), g.uniform(0.002, 0.01)
        c = amp * np.cos(fx * x + fy * y + ph)
        dx += fx * c
        dy += fy * c
    n = np.stack([-dx, -dy, np.ones((h, w))], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.round((n + 1.0) * 127.5).astype(np.uint8)


def normal_mapping_numpy(pkg, tex=1024):
    """scenes/normal_mapping.py with its three base-colour JPGs replaced by
    seeded u8 images (two planar tex x tex, the cube's a 4x3 cube map of
    tex x 3/4 tex) and its three normal maps by maps of seeded height
    fields of the same sizes; the floor takes the procedural checker, tiled
    20 times by its uv_trans.  910x512."""
    deg = lambda x: float(np.deg2rad(x))
    cube_h = tex * 3 // 4
    tex_plane = pkg.Texture(pkg.ImageTexture(data=colour_image(1, tex, tex)))
    norm_plane = pkg.NormalMap(data=normal_image(2, tex, tex))
    tex_sphere = pkg.Texture(pkg.ImageTexture(data=colour_image(3, tex, tex)))
    norm_sphere = pkg.NormalMap(data=normal_image(4, tex, tex))
    tex_cube = pkg.Texture(pkg.ImageTexture(data=colour_image(5, cube_h, tex)))
    norm_cube = pkg.NormalMap(data=normal_image(6, cube_h, tex))
    purple = dict(diffuse=(0.37168, 0.236767, 0.692066), shininess=25.0)
    mat = lambda spec, t, nm=None: pkg.Material(specular=(spec,) * 3, texture=t, normals=nm,
                                                **purple)
    m_plane, m_plane_n = mat(0.4, tex_plane), mat(0.4, tex_plane, norm_plane)
    m_sphere, m_sphere_n = mat(0.6, tex_sphere), mat(0.6, tex_sphere, norm_sphere)
    m_cube, m_cube_n = mat(0.3, tex_cube), mat(0.3, tex_cube, norm_cube)
    floor = pkg.Material(diffuse=(0.424858, 0.531206, 0.8), specular=(0.3, 0.3, 0.3),
                         shininess=25.0, texture=pkg.Texture(checker(pkg)),
                         uv_trans=np.diag([20.0, 20.0, 1.0]))
    node = lambda prim, m: pkg.SceneNode(pkg.Geometry(prim, m))
    root = pkg.SceneNode([
        node(pkg.Plane(), floor).scaled(40.0).translated((0.0, -1.0, 0.0)),
        node(pkg.Plane(), m_plane).scaled(6.0).rotated_x(deg(90.0)).translated((-4.0, 2.0, -6.0)),
        node(pkg.Cube(), m_cube).scaled(2.0).translated((-7.0, 0.0, -1.0)),
        node(pkg.Sphere(), m_sphere).translated((-7.0, 2.0, -1.0)),
        node(pkg.Cube(), m_cube).scaled(2.0).translated((-2.0, 0.0, 3.0)),
        node(pkg.Sphere(), m_sphere).translated((-2.0, 2.0, 3.0)),
        node(pkg.Plane(), m_plane_n).scaled(6.0).rotated_x(deg(90.0)).translated((4.0, 2.0, -6.0)),
        node(pkg.Cube(), m_cube_n).scaled(2.0).translated((7.0, 0.0, -1.0)),
        node(pkg.Sphere(), m_sphere_n).translated((7.0, 2.0, -1.0)),
        node(pkg.Cube(), m_cube_n).scaled(2.0).translated((2.0, 0.0, 3.0)),
        node(pkg.Sphere(), m_sphere_n).translated((2.0, 2.0, 3.0)),
    ])
    scene = pkg.Scene(root, [pkg.Light(position=(0.0, 8.0, 10.0), color=(0.9, 0.9, 0.9))],
                      (0.2, 0.2, 0.2))
    cam = pkg.CameraSettings(eye=(0.0, 8.07551, 23.078941),
                             center=(0.0, -2.854475, -16.437334), fovy=deg(22.0))
    return scene, cam, (910, 512)


def soft_shadows_icosphere(pkg, subdiv=4):
    """scenes/soft_shadows.py with its two cows replaced by icospheres
    (subdiv splits, smooth, radius 3 in their own frame, about a cow's
    size), placed and materialled as the cows are: a point light and a
    parallelogram area light.  910x512."""
    deg = lambda x: float(np.deg2rad(x))
    pos, tris = _icosphere(subdiv)
    ball = pkg.MeshData(3.0 * pos, tris, normals=pos)
    mat_cow = pkg.Material(diffuse=(0.37168, 0.236767, 0.692066), specular=(0.3, 0.3, 0.3),
                           shininess=25.0)
    wall = pkg.Material(diffuse=(0.627459, 0.8, 0.589836), specular=(0.3, 0.3, 0.3),
                        shininess=25.0)
    node = lambda prim, m: pkg.SceneNode(pkg.Geometry(prim, m))
    scene = pkg.Scene(pkg.SceneNode([
        node(pkg.Plane(), wall).scaled(30.0),
        node(pkg.Cube(), wall).scaled((0.2, 20.0, 20.0)).translated((0.0, 8.0, 8.0)),
        node(pkg.Cube(), wall).scaled((30.0, 30.0, 0.4)).translated((0.0, 8.0, -2.0)),
        node(pkg.Mesh(ball, pkg.Shading.Smooth), mat_cow)
        .scaled(0.5).rotated_y(deg(-15.0)).translated((-4.2, 1.8, 4.0)),
        node(pkg.Mesh(ball, pkg.Shading.Smooth), mat_cow)
        .scaled(0.5).rotated_y(deg(195.0)).translated((4.2, 1.8, 4.0)),
    ]), [
        pkg.Light(position=(-2.0, 2.0, 16.0), color=(0.5, 0.5, 0.5)),
        pkg.Light(position=(2.0, 2.0, 16.0), color=(0.5, 0.5, 0.5),
                  area=pkg.Parallelogram(a=(0.0, 0.5, 0.0), b=(0.5, 0.0, 0.0))),
    ], (0.3, 0.3, 0.3))
    cam = pkg.CameraSettings(eye=(0.0, 5.04746, 24.827951),
                             center=(0.012231, -0.459716, -15.800501), fovy=deg(25.0))
    return scene, cam, (910, 512)


INLINE.update({
    # Test sizes: 64 x 64 (64 x 48) textures; icospheres of 1,280 triangles.
    "normal-mapping-numpy": lambda pkg: normal_mapping_numpy(pkg, tex=64),
    "soft-shadows-icosphere": lambda pkg: soft_shadows_icosphere(pkg, subdiv=3),
})
