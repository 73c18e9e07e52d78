"""Lower a hierarchical Scene to flat device tables (counterpart of
``portrayer_tpu/scene/flatten.py``).

The numpy lowering is the JAX package's, step for step, so the tables are
equal array for array: the BFS transform compose (src/flat_scene.rs:27-40),
the kind grouping, the material and light tables, the 8-corner world AABBs
(src/bounding_box.rs:123-148), the mesh triangle soup shared between
instances with its (instance, triangle) pair lists, and the packed chunk
table of the sweep kernel with its SAH chunk order and specialised kinds,
and the texture and normal-map atlases.  Only the last step differs: the
arrays become torch tensors on the configured device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import math3d as m3
from .mesh import Mesh, Shading, Triangle
from .node import Scene, SceneNode, Sphere, Plane, Cube, Cylinder, Cone, Torus
from .texture import Texture

# Primitive kind codes (order = group order in the tables).
SPHERE, PLANE, CUBE, CYLINDER, CONE, MESH, TORUS = range(7)
KIND_NAMES = ("sphere", "plane", "cube", "cylinder", "cone", "mesh", "torus")

# Specialised packed kinds (see the JAX package): world-space spheres and
# axis-aligned boxes carry world parameters instead of an affine.
PACKED_SPHERE_W = 7
PACKED_AABOX = 8

# Names of the sweep kernel's branches, indexed by packed chunk kind.
PACKED_KIND_NAMES = ("sphere_g", "plane_g", "cube_g", "cylinder_g", "cone_g",
                     "tri_w", "torus_g", "sphere_w", "aabox")

PACK_CHUNK = 128

# Array fields of SceneTables / PackedPrims, in the JAX package's names.
TABLE_FIELDS = (
    "trans", "inv", "normal_mat", "material_id", "prim_params", "mesh_range",
    "aabb_min", "aabb_max",
    "tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc", "tri_smooth",
    "tri_uva", "tri_uvb", "tri_uvc", "tri_has_uv",
    "pair_node", "pair_tri", "pair_aabb_min", "pair_aabb_max",
    "mat_diffuse", "mat_specular", "mat_shininess", "mat_reflectivity",
    "mat_glossy", "mat_refraction", "mat_uv_trans", "mat_tex_id",
    "mat_normal_map_id",
    "light_pos", "light_color", "light_falloff", "light_area_a",
    "light_area_b", "light_is_area", "ambient",
    "tex_data", "tex_meta", "nm_data", "nm_meta",
)
PACKED_FIELDS = ("f32", "ids", "chunk_kind", "chunk_min", "chunk_max")
META_FIELDS = (
    "groups", "kind_ranges", "n_chunks", "n_lights", "area_flags",
    "any_reflective", "any_refractive", "any_glossy", "any_image_tex",
    "any_normal_map", "fn_textures",
)
_INT_FIELDS = {"material_id", "mat_tex_id", "mat_normal_map_id", "ids", "chunk_kind",
               "mesh_range", "pair_node", "pair_tri", "tex_meta", "nm_meta"}
_BOOL_FIELDS = {"light_is_area", "tri_smooth", "tri_has_uv"}
_U8_FIELDS = {"tex_data", "nm_data"}


@dataclasses.dataclass
class PackedPrims:
    """The sweep kernel's chunk table: one column per primitive, 128-wide
    single-kind chunks.  Rows of ``f32`` [21, NCOL] by packed kind:
    general (sphere_g, plane_g, cube_g, cylinder_g, cone_g, torus_g): 0..11
    world->local affine, torus radii (center, tube) in 12..13;
    tri_w: 0..11 the world -> (beta, gamma, w) affine of the unit-triangle
    frame (zeros where the triangle is degenerate);
    sphere_w: 0..2 world center, 3 radius^2, 4 scale (self-eps raise);
    aabox: 0..2 / 3..5 inflated world min / max, 6..8 per-axis inverse
    scale (self-eps raise).
    ``ids`` [2, NCOL] int32: node id, triangle id (-1 = padding/analytic)."""

    f32: torch.Tensor         # [21, NCOL] float32
    ids: torch.Tensor         # [2, NCOL] int32
    chunk_kind: torch.Tensor  # [Nc] int32
    chunk_min: torch.Tensor   # [Nc, 3] inflated world AABB
    chunk_max: torch.Tensor   # [Nc, 3]
    n_chunks: int
    kind_ranges: tuple        # ((kind, chunk_start, chunk_count), ...)

    @functools.cached_property
    def groups(self):
        """The sweep kernel's chunk groups and real lanes per chunk
        (``ops.cuda_intersect.chunk_groups``), derived once per table."""
        from ..ops.cuda_intersect import chunk_groups

        return chunk_groups(self)


@dataclasses.dataclass
class SceneTables:
    """The scene as device tables.  ``rec`` and ``trec``, the fused node
    and triangle records that hit detail and shading gather from, are
    derived from the other fields when the tables are made, and again by
    ``replace``: a material, light or transform table replaced by a tensor
    that requires grad carries its gradient into the render.  ``packed``,
    the sweep kernel's table, is not rebuilt: the sweeps only select the
    winners (their outputs carry no gradient), so replaced tables select
    on the old geometry, as the JAX package's ``replace`` does."""

    trans: torch.Tensor        # [N,3,4] local->world
    inv: torch.Tensor          # [N,3,4] world->local
    normal_mat: torch.Tensor   # [N,3,3]
    material_id: torch.Tensor  # [N] int32
    prim_params: torch.Tensor  # [N,2]
    mesh_range: torch.Tensor   # [N,2] int32 (tri_start, tri_count); zeros if not mesh
    aabb_min: torch.Tensor     # [N,3]
    aabb_max: torch.Tensor     # [N,3]
    # Mesh triangle soup, shared between instances ([T,...]; one zero row
    # when the scene has no triangle).
    tri_a: torch.Tensor
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_na: torch.Tensor       # vertex normals (zeros when flat)
    tri_nb: torch.Tensor
    tri_nc: torch.Tensor
    tri_smooth: torch.Tensor   # [T] bool
    tri_uva: torch.Tensor      # [T,2]
    tri_uvb: torch.Tensor
    tri_uvc: torch.Tensor
    tri_has_uv: torch.Tensor   # [T] bool
    # (instance node, triangle) pairs and their world AABBs ([P,...]; one
    # zero entry when there is none).
    pair_node: torch.Tensor    # [P] int32
    pair_tri: torch.Tensor     # [P] int32
    pair_aabb_min: torch.Tensor
    pair_aabb_max: torch.Tensor
    mat_diffuse: torch.Tensor
    mat_specular: torch.Tensor
    mat_shininess: torch.Tensor
    mat_reflectivity: torch.Tensor
    mat_glossy: torch.Tensor
    mat_refraction: torch.Tensor
    mat_uv_trans: torch.Tensor
    mat_tex_id: torch.Tensor
    mat_normal_map_id: torch.Tensor
    light_pos: torch.Tensor
    light_color: torch.Tensor
    light_falloff: torch.Tensor
    light_area_a: torch.Tensor
    light_area_b: torch.Tensor
    light_is_area: torch.Tensor
    ambient: torch.Tensor
    # Texture atlases: texels of every image (every normal map) back to
    # back, and per image (offset, width, height).
    tex_data: torch.Tensor     # [Ptex,3] uint8 sRGB texels
    tex_meta: torch.Tensor     # [K,3] int32
    nm_data: torch.Tensor      # [Pnm,3] uint8 normal-map texels
    nm_meta: torch.Tensor      # [Knm,3] int32
    packed: PackedPrims
    groups: Tuple[Tuple[int, int, int], ...]
    fn_textures: Tuple[Callable, ...]  # procedural textures (mat_tex_id -(i+2))
    n_lights: int
    area_flags: Tuple[bool, ...]
    any_reflective: bool
    any_refractive: bool
    any_glossy: bool
    any_image_tex: bool
    any_normal_map: bool
    rec: torch.Tensor = dataclasses.field(init=False, repr=False)   # [N,34] node_record
    trec: torch.Tensor = dataclasses.field(init=False, repr=False)  # [T,26] tri_record

    def __post_init__(self):
        self.rec = node_record(self)
        self.trec = tri_record(self)

    def replace(self, **fields) -> "SceneTables":
        """New tables with `fields` replaced and the records rebuilt from
        them (``packed`` is kept; see the class docstring).  The same as
        ``dataclasses.replace(self, **fields)``; it is here so that code
        written against the JAX package's ``SceneTables.replace`` (a flax
        struct method) reads the same on the port's tables."""
        return dataclasses.replace(self, **fields)

    @property
    def n_nodes(self) -> int:
        return self.trans.shape[0]

    @property
    def n_pairs(self) -> int:
        """Instance-triangle pairs (the padding entry when there is none)."""
        return self.pair_node.shape[0]

    @property
    def device(self) -> torch.device:
        return self.inv.device


# ---------------------------------------------------------------------------
# Packing (numpy; same steps as the JAX package's _build_packed)
# ---------------------------------------------------------------------------

def _sah_chunk_order(amin: np.ndarray, amax: np.ndarray,
                     leaf: int = PACK_CHUNK) -> np.ndarray:
    """Spatial order by recursive SAH bisection at chunk granularity: the
    (axis, multiple-of-`leaf` split) minimising
    ceil(k/leaf)*SA(left) + ceil((n-k)/leaf)*SA(right)."""
    n = amin.shape[0]
    if n <= leaf:
        return np.arange(n)
    cent = 0.5 * (amin + amax)
    out: List[np.ndarray] = []

    def area(mn, mx):
        e = np.maximum(mx - mn, 0.0)
        return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

    stack = [np.arange(n)]
    while stack:
        ids = stack.pop()
        m = ids.shape[0]
        if m <= leaf:
            out.append(ids)
            continue
        best_cost = np.inf
        best_order = None
        best_k = leaf
        ks = np.arange(leaf, m, leaf)
        for axis in range(3):
            order = ids[np.argsort(cent[ids, axis], kind="stable")]
            pmin = np.minimum.accumulate(amin[order], axis=0)
            pmax = np.maximum.accumulate(amax[order], axis=0)
            smin = np.minimum.accumulate(amin[order][::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(amax[order][::-1], axis=0)[::-1]
            cost = (np.ceil(ks / leaf) * area(pmin[ks - 1], pmax[ks - 1])
                    + np.ceil((m - ks) / leaf) * area(smin[ks], smax[ks]))
            j = int(np.argmin(cost))
            if cost[j] < best_cost:
                best_cost = cost[j]
                best_order = order
                best_k = int(ks[j])
        stack.append(best_order[best_k:])
        stack.append(best_order[:best_k])
    return np.concatenate(out)


def _uniform_similarity(t3):
    """[N] bool: forward 3x3 is rotation x uniform scale; and [N] scale."""
    M = t3[:, :, :3]
    G = np.einsum("nij,nkj->nik", M, M)
    s2 = np.einsum("nii->n", G) / 3.0
    dev = np.abs(G - s2[:, None, None] * np.eye(3)).max(axis=(1, 2))
    return dev <= 1e-7 * np.maximum(s2, 1e-30), np.sqrt(np.maximum(s2, 0.0))


def _axis_aligned(t3):
    """[N] bool: forward 3x3 is signed-permutation x per-axis scale (aspect
    <= 128); and [N,3] per-world-axis scale."""
    A = np.abs(t3[:, :, :3])
    rmax = A.max(axis=2)
    cmax = A.max(axis=1)
    ok = (
        ((A.sum(axis=2) - rmax) <= 1e-7 * np.maximum(rmax, 1e-30)).all(axis=1)
        & ((A.sum(axis=1) - cmax) <= 1e-7 * np.maximum(cmax, 1e-30)).all(axis=1)
        & (rmax.max(axis=1) <= 128.0 * np.maximum(rmax.min(axis=1), 1e-30))
    )
    return ok, rmax


def _build_packed(groups, trans, inv, aabb_min, aabb_max, prim_params,
                  pair_node, pair_tri, pair_amin, pair_amax, pair_world):
    """Packed chunk table (numpy) from the node and pair tables."""
    f_cols: List[np.ndarray] = []
    id_cols: List[np.ndarray] = []
    a_cols_min: List[np.ndarray] = []
    a_cols_max: List[np.ndarray] = []
    kinds: List[int] = []

    def inflate(amin, amax):
        """Conservative chunk-AABB inflation: extent-relative (local
        0.5+EPSILON containment) plus position-relative (f32 corners)."""
        ext = amax - amin
        pad = 1e-5 * ext + 1e-6 * np.maximum(np.abs(amin), np.abs(amax)) + 1e-7
        return amin - pad, amax + pad

    def add_group(kind, f, ids, amin, amax):
        k = f.shape[0]
        pad = -(-k // PACK_CHUNK) * PACK_CHUNK - k
        if pad:
            f = np.concatenate([f, np.zeros((pad, f.shape[1]))], axis=0)
            ids = np.concatenate([ids, np.full((pad, 2), -1, np.int64)], axis=0)
            amin = np.concatenate([amin, np.full((pad, 3), 1e30)], axis=0)
            amax = np.concatenate([amax, np.full((pad, 3), -1e30)], axis=0)
        f_cols.append(f)
        id_cols.append(ids)
        amin, amax = inflate(amin, amax)
        a_cols_min.append(amin)
        a_cols_max.append(amax)
        kinds.extend([kind] * ((k + pad) // PACK_CHUNK))

    def add_general(kind, order):
        count = order.shape[0]
        if count == 0:
            return
        extra = np.zeros((count, 9))
        extra[:, 0:2] = prim_params[order]
        f = np.concatenate([inv[order].reshape(-1, 12), extra], axis=1)
        ids = np.stack([order, np.full(count, -1)], axis=1)
        add_group(kind, f, ids, aabb_min[order], aabb_max[order])

    for kind, start, count in groups:
        if kind == MESH:
            if len(pair_node) == 0:
                continue
            order = _sah_chunk_order(pair_amin, pair_amax)
            pn, pt = pair_node[order], pair_tri[order]
            # Unit-triangle affine: rows map world points into the (beta,
            # gamma, w) frame where the triangle is beta, gamma >= 0,
            # beta + gamma <= 1, w == 0 (p = a + beta e1 + gamma e2 + w n);
            # a degenerate triangle keeps a zero inverse, so no ray hits it.
            wv = pair_world[order]
            k = len(pn)
            a = wv[:, 0]
            e1 = wv[:, 1] - a
            e2 = wv[:, 2] - a
            A = np.stack([e1, e2, np.cross(e1, e2)], axis=2)
            good = np.abs(np.linalg.det(A)) > 1e-30
            Minv = np.zeros((k, 3, 3))
            if good.any():
                Minv[good] = np.linalg.inv(A[good])
            off = -np.einsum("kij,kj->ki", Minv, a)
            f = np.concatenate([Minv[:, 0, :], off[:, 0:1], Minv[:, 1, :], off[:, 1:2],
                                Minv[:, 2, :], off[:, 2:3], np.zeros((k, 9))], axis=1)
            add_group(MESH, f, np.stack([pn, pt], axis=1), pair_amin[order], pair_amax[order])
            continue
        idx = np.arange(start, start + count)
        sub_order = lambda ids: ids[_sah_chunk_order(aabb_min[ids], aabb_max[ids])]
        if kind == SPHERE:
            uni, s = _uniform_similarity(trans)
            spec = sub_order(idx[uni[idx]])
            rest = sub_order(idx[~uni[idx]])
            if spec.size:
                f = np.zeros((spec.size, 21))
                f[:, 0:3] = trans[spec][:, :, 3]
                f[:, 3] = s[spec] ** 2
                f[:, 4] = s[spec]
                ids = np.stack([spec, np.full(spec.size, -1)], axis=1)
                add_group(PACKED_SPHERE_W, f, ids, aabb_min[spec], aabb_max[spec])
            add_general(SPHERE, rest)
        elif kind == CUBE:
            aa, srow = _axis_aligned(trans)
            spec = sub_order(idx[aa[idx]])
            rest = sub_order(idx[~aa[idx]])
            if spec.size:
                ext = aabb_max[spec] - aabb_min[spec]
                pad = 1e-5 * ext
                f = np.zeros((spec.size, 21))
                f[:, 0:3] = aabb_min[spec] - pad
                f[:, 3:6] = aabb_max[spec] + pad
                f[:, 6:9] = 1.0 / np.maximum(srow[spec], 1e-30)
                ids = np.stack([spec, np.full(spec.size, -1)], axis=1)
                add_group(PACKED_AABOX, f, ids, aabb_min[spec], aabb_max[spec])
            add_general(CUBE, rest)
        else:
            add_general(kind, sub_order(idx))

    if not kinds:  # empty scene: one all-padding chunk
        kinds = [SPHERE]
        f_cols = [np.zeros((PACK_CHUNK, 21))]
        id_cols = [np.full((PACK_CHUNK, 2), -1, np.int64)]
        a_cols_min = [np.full((PACK_CHUNK, 3), 1e30)]
        a_cols_max = [np.full((PACK_CHUNK, 3), -1e30)]

    f_all = np.concatenate(f_cols, axis=0)
    id_all = np.concatenate(id_cols, axis=0)
    amin_all = np.concatenate(a_cols_min, axis=0)
    amax_all = np.concatenate(a_cols_max, axis=0)
    n_chunks = f_all.shape[0] // PACK_CHUNK
    chunk_min = amin_all.reshape(n_chunks, PACK_CHUNK, 3).min(axis=1)
    chunk_max = amax_all.reshape(n_chunks, PACK_CHUNK, 3).max(axis=1)
    ranges = []
    for k in kinds:
        if ranges and ranges[-1][0] == k:
            ranges[-1][2] += 1
        else:
            ranges.append([k, sum(r[2] for r in ranges), 1])
    arrays = {
        "f32": f_all.T, "ids": id_all.T.astype(np.int32),
        "chunk_kind": np.asarray(kinds, np.int32),
        "chunk_min": chunk_min, "chunk_max": chunk_max,
    }
    return arrays, n_chunks, tuple(tuple(r) for r in ranges)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

_LOCAL_BOUNDS = {
    SPHERE: (np.full(3, -1.0), np.full(3, 1.0)),
    PLANE: (np.array([-0.5, 0.0, -0.5]), np.array([0.5, 0.0, 0.5])),
    CUBE: (np.full(3, -0.5), np.full(3, 0.5)),
    CYLINDER: (np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5])),
    CONE: (np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5])),
}

_PRIM_KINDS = ((Sphere, SPHERE), (Plane, PLANE), (Cube, CUBE),
               (Cylinder, CYLINDER), (Cone, CONE))


@dataclasses.dataclass
class _FlatNode:
    kind: int
    trans: np.ndarray  # 4x4
    material: Any
    local_min: np.ndarray = None
    local_max: np.ndarray = None
    params: Tuple[float, float] = (0.0, 0.0)  # torus (center_r, tube_r)
    tri_range: Tuple[int, int] = (0, 0)       # mesh (tri_start, tri_count)


_TRI_KEYS = ("tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc",
             "tri_uva", "tri_uvb", "tri_uvc")


class _TriangleSoup:
    """The triangle blocks of the scene's meshes and triangles: one block
    per (mesh data identity, shading), shared by every instance."""

    def __init__(self):
        self.blocks: List[Dict[str, np.ndarray]] = []
        self.total = 0
        self.cache: Dict[Tuple[int, Any], Tuple[int, int]] = {}

    def _push(self, corners, smooth, has_uv):
        K = len(corners[0])
        block = dict(zip(_TRI_KEYS, corners))
        block["tri_smooth"] = np.full(K, smooth, bool)
        block["tri_has_uv"] = np.full(K, has_uv, bool)
        self.blocks.append(block)
        rng = (self.total, K)
        self.total += K
        return rng

    def mesh(self, mesh: Mesh) -> Tuple[int, int]:
        key = (id(mesh.data), mesh.shading)
        if key not in self.cache:
            d = mesh.data
            t = np.asarray(d.triangles, np.int64).reshape(-1, 3)
            K = len(t)
            smooth = mesh.shading == Shading.Smooth
            has_uv = len(d.tex_coords) > 0
            pos = [d.positions[t[:, i]] for i in range(3)]
            nrm = [d.normals[t[:, i]] if smooth else np.zeros((K, 3)) for i in range(3)]
            uv = [d.tex_coords[t[:, i]] if has_uv else np.zeros((K, 2)) for i in range(3)]
            self.cache[key] = self._push(pos + nrm + uv, smooth, has_uv)
        return self.cache[key]

    def triangle(self, tri: Triangle) -> Tuple[int, int]:
        smooth = tri.normals is not None
        has_uv = tri.tex_coords is not None
        nrm = tri.normals if smooth else (np.zeros(3),) * 3
        uv = tri.tex_coords if has_uv else (np.zeros(2),) * 3
        row = lambda x: np.asarray(x, np.float64)[None]
        return self._push([row(x) for x in (tri.a, tri.b, tri.c, *nrm, *uv)], smooth, has_uv)

    def arrays(self) -> Dict[str, np.ndarray]:
        if self.blocks:
            return {k: np.concatenate([b[k] for b in self.blocks], axis=0)
                    for k in self.blocks[0]}
        out = {k: np.zeros((1, 2 if k.startswith("tri_uv") else 3)) for k in _TRI_KEYS}
        out.update(tri_smooth=np.zeros(1, bool), tri_has_uv=np.zeros(1, bool))
        return out


def _flatten_numpy(scene: Scene):
    """The JAX package's lowering in numpy: ({field: array}, meta)."""
    flat: List[_FlatNode] = []
    soup = _TriangleSoup()
    queue: List[Tuple[np.ndarray, SceneNode]] = [(m3.identity4(), scene.root)]
    while queue:
        parent_trans, node = queue.pop(0)
        total = parent_trans @ node.trans
        if node.geometry is not None:
            prim = node.geometry.primitive
            mat = node.geometry.material
            if isinstance(prim, Torus):
                cr, tr = prim.center_radius, prim.tube_radius
                r_out = cr + tr
                flat.append(_FlatNode(
                    TORUS, total, mat,
                    local_min=np.array([-r_out, -tr, -r_out]),
                    local_max=np.array([r_out, tr, r_out]), params=(cr, tr)))
            elif isinstance(prim, Mesh):
                flat.append(_FlatNode(MESH, total, mat, prim.data.bounds_min,
                                      prim.data.bounds_max, tri_range=soup.mesh(prim)))
            elif isinstance(prim, Triangle):
                rng = soup.triangle(prim)
                verts = np.stack([prim.a, prim.b, prim.c])
                flat.append(_FlatNode(MESH, total, mat, verts.min(axis=0), verts.max(axis=0),
                                      tri_range=rng))
            else:
                kind = next((k for cls, k in _PRIM_KINDS if isinstance(prim, cls)), None)
                if kind is None:
                    raise TypeError(f"Unsupported primitive: {prim!r}")
                flat.append(_FlatNode(kind, total, mat))
        for child in node.children:
            queue.append((total, child))

    flat.sort(key=lambda fn_: fn_.kind)
    groups = []
    start = 0
    for kind in range(7):
        count = sum(1 for f in flat if f.kind == kind)
        if count:
            groups.append((kind, start, count))
        start += count

    materials: List[Any] = []
    mat_index: Dict[int, int] = {}
    for f in flat:
        if id(f.material) not in mat_index:
            mat_index[id(f.material)] = len(materials)
            materials.append(f.material)

    image_textures: List[Any] = []
    img_index: Dict[int, int] = {}
    fn_textures: List[Callable] = []
    fn_index: Dict[int, int] = {}
    normal_maps: List[Any] = []
    nm_index: Dict[int, int] = {}

    def tex_code(tex) -> int:
        """-1 none; i >= 0 the i-th image; -(i+2) the i-th procedural."""
        if tex is None:
            return -1
        if not isinstance(tex, Texture):
            tex = Texture(tex)
        if tex.is_image:
            img = tex.image
            if id(img) not in img_index:
                img_index[id(img)] = len(image_textures)
                image_textures.append(img)
            return img_index[id(img)]
        fn = tex.fn
        if id(fn) not in fn_index:
            fn_index[id(fn)] = len(fn_textures)
            fn_textures.append(fn)
        return -(fn_index[id(fn)] + 2)

    def nm_code(nm) -> int:
        if nm is None:
            return -1
        if id(nm) not in nm_index:
            nm_index[id(nm)] = len(normal_maps)
            normal_maps.append(nm)
        return nm_index[id(nm)]

    M = max(len(materials), 1)
    a = {
        "mat_diffuse": np.zeros((M, 3)), "mat_specular": np.zeros((M, 3)),
        "mat_shininess": np.zeros(M), "mat_reflectivity": np.zeros(M),
        "mat_glossy": np.zeros(M), "mat_refraction": np.zeros(M),
        "mat_uv_trans": np.tile(np.eye(3), (M, 1, 1)),
        "mat_tex_id": np.full(M, -1, dtype=np.int32),
        "mat_normal_map_id": np.full(M, -1, dtype=np.int32),
    }
    for i, m in enumerate(materials):
        a["mat_diffuse"][i] = m.diffuse
        a["mat_specular"][i] = m.specular
        a["mat_shininess"][i] = m.shininess
        a["mat_reflectivity"][i] = m.reflectivity
        a["mat_glossy"][i] = m.glossy_side_length
        a["mat_refraction"][i] = m.refraction_index
        if m.uv_trans is not None:
            a["mat_uv_trans"][i] = m.uv_trans
        a["mat_tex_id"][i] = tex_code(m.texture)
        a["mat_normal_map_id"][i] = nm_code(m.normals)

    N = max(len(flat), 1)
    if flat:
        t4 = np.stack([f.trans for f in flat])            # [N,4,4]
        inv4 = np.linalg.inv(t4)
        trans = t4[:, :3, :4].copy()
        inv = inv4[:, :3, :4].copy()
        normal_mat = np.linalg.inv(t4[:, :3, :3]).transpose(0, 2, 1).copy()
        material_id = np.asarray([mat_index[id(f.material)] for f in flat], np.int32)
        prim_params = np.asarray([f.params for f in flat], np.float64)
        mesh_range = np.asarray([f.tri_range if f.kind == MESH else (0, 0) for f in flat],
                                np.int32)
        lmin = np.stack([f.local_min if f.kind in (MESH, TORUS) else _LOCAL_BOUNDS[f.kind][0]
                         for f in flat])
        lmax = np.stack([f.local_max if f.kind in (MESH, TORUS) else _LOCAL_BOUNDS[f.kind][1]
                         for f in flat])
        world_min = np.full((N, 3), np.inf)
        world_max = np.full((N, 3), -np.inf)
        for ci in range(8):
            sel = np.array([(ci >> 2) & 1, (ci >> 1) & 1, ci & 1], bool)
            corner = np.where(sel, lmax, lmin)
            w = np.einsum("nij,nj->ni", t4[:, :3, :3], corner) + t4[:, :3, 3]
            world_min = np.minimum(world_min, w)
            world_max = np.maximum(world_max, w)
        aabb_min, aabb_max = world_min, world_max
    else:
        trans = np.tile(np.eye(3, 4), (N, 1, 1))
        inv = np.tile(np.eye(3, 4), (N, 1, 1))
        normal_mat = np.tile(np.eye(3), (N, 1, 1))
        material_id = np.zeros(N, np.int32)
        prim_params = np.zeros((N, 2))
        mesh_range = np.zeros((N, 2), np.int32)
        aabb_min = np.zeros((N, 3))
        aabb_max = np.zeros((N, 3))
    a.update(trans=trans, inv=inv, normal_mat=normal_mat,
             material_id=material_id, prim_params=prim_params, mesh_range=mesh_range,
             aabb_min=aabb_min, aabb_max=aabb_max)

    # Instance-triangle pairs: instances repeat pairs, not triangle data.
    tri = soup.arrays()
    a.update(tri)
    mesh_ids = np.asarray([i for i, f in enumerate(flat) if f.kind == MESH], np.int64)
    if mesh_ids.size:
        starts = np.asarray([flat[i].tri_range[0] for i in mesh_ids])
        counts = np.asarray([flat[i].tri_range[1] for i in mesh_ids])
        pair_node = np.repeat(mesh_ids, counts).astype(np.int64)
        pair_tri = np.concatenate([np.arange(s, s + c) for s, c in zip(starts, counts)]
                                  ).astype(np.int64)
        verts3 = np.stack([tri["tri_a"][pair_tri], tri["tri_b"][pair_tri],
                           tri["tri_c"][pair_tri]], axis=1)             # [P,3,3]
        rot = t4[pair_node][:, :3, :3]
        off = t4[pair_node][:, :3, 3]
        pair_world = np.einsum("pij,pkj->pki", rot, verts3) + off[:, None, :]
        pair_amin = pair_world.min(axis=1)
        pair_amax = pair_world.max(axis=1)
    else:
        pair_node = pair_tri = np.zeros((0,), np.int64)
        pair_amin = pair_amax = np.zeros((0, 3))
        pair_world = np.zeros((0, 3, 3))
    a["pair_node"] = pair_node if pair_node.size else np.zeros(1, np.int64)
    a["pair_tri"] = pair_tri if pair_tri.size else np.zeros(1, np.int64)
    a["pair_aabb_min"] = pair_amin if pair_amin.size else np.zeros((1, 3))
    a["pair_aabb_max"] = pair_amax if pair_amax.size else np.zeros((1, 3))

    L = max(len(scene.lights), 1)
    a["light_pos"] = np.zeros((L, 3))
    a["light_color"] = np.zeros((L, 3))
    a["light_falloff"] = np.tile(np.array([1.0, 0.0, 0.0]), (L, 1))
    a["light_area_a"] = np.zeros((L, 3))
    a["light_area_b"] = np.zeros((L, 3))
    a["light_is_area"] = np.zeros(L, dtype=bool)
    for i, lt in enumerate(scene.lights):
        a["light_pos"][i] = lt.position
        a["light_color"][i] = lt.color
        a["light_falloff"][i] = (lt.falloff.c0, lt.falloff.c1, lt.falloff.c2)
        a["light_area_a"][i] = lt.area.a
        a["light_area_b"][i] = lt.area.b
        a["light_is_area"][i] = not lt.area.is_empty()
    a["ambient"] = scene.ambient
    a["tex_data"], a["tex_meta"] = _build_atlas(image_textures)
    a["nm_data"], a["nm_meta"] = _build_atlas(normal_maps)

    packed, n_chunks, kind_ranges = _build_packed(
        groups, trans, inv, aabb_min, aabb_max, prim_params,
        pair_node, pair_tri, pair_amin, pair_amax, pair_world)
    a.update({f"packed.{k}": v for k, v in packed.items()})
    meta = dict(
        groups=tuple(groups), kind_ranges=kind_ranges, n_chunks=n_chunks,
        n_lights=len(scene.lights),
        area_flags=tuple(not lt.area.is_empty() for lt in scene.lights),
        any_reflective=any(m.reflectivity > 0.0 for m in materials),
        any_refractive=any(
            m.reflectivity > 0.0 and m.refraction_index > 0.0 for m in materials),
        any_glossy=any(
            m.reflectivity > 0.0 and m.glossy_side_length > 0.0 for m in materials),
        any_image_tex=len(image_textures) > 0, any_normal_map=len(normal_maps) > 0,
        fn_textures=tuple(fn_textures),
    )
    return a, meta


def _build_atlas(images: List):
    """(texels [P,3] uint8 of every image back to back, meta [K,3] int32
    (offset, width, height)); one zero texel and meta row without images."""
    if not images:
        return np.zeros((1, 3), np.uint8), np.zeros((1, 3), np.int32)
    metas, chunks, off = [], [], 0
    for img in images:
        data = img.raw
        h, w = data.shape[:2]
        metas.append((off, w, h))
        chunks.append(data.reshape(-1, 3))
        off += h * w
    return np.concatenate(chunks, axis=0), np.asarray(metas, np.int32)


def tables_from_numpy(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                      device, dtype=torch.float32) -> SceneTables:
    """SceneTables on `device` from numpy arrays named as the JAX package's
    fields (``packed.f32`` etc. for the packed table) and the static
    metadata of META_FIELDS.  Carries the JAX package's own tables across,
    so that a sweep mismatch can never be a table mismatch.  The JAX
    package's procedural textures are jnp callables: pass torch ones as
    ``meta["fn_textures"]`` to render with them here.  Float tables take
    `dtype`; the packed table, which only the float32 sweep kernel reads,
    stays float32."""

    def t(name, x):
        base = name.split(".")[-1]
        dt = (torch.int32 if base in _INT_FIELDS else
              torch.bool if base in _BOOL_FIELDS else
              torch.uint8 if base in _U8_FIELDS else
              torch.float32 if name.startswith("packed.") else dtype)
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    packed = PackedPrims(
        **{k: t(f"packed.{k}", arrays[f"packed.{k}"]) for k in PACKED_FIELDS},
        n_chunks=int(meta["n_chunks"]),
        kind_ranges=tuple(tuple(int(v) for v in r) for r in meta["kind_ranges"]),
    )
    return SceneTables(
        **{k: t(k, arrays[k]) for k in TABLE_FIELDS},
        packed=packed,
        groups=tuple(tuple(int(v) for v in g) for g in meta["groups"]),
        fn_textures=tuple(meta["fn_textures"]),
        n_lights=int(meta["n_lights"]),
        area_flags=tuple(bool(v) for v in meta["area_flags"]),
        **{k: bool(meta[k]) for k in (
            "any_reflective", "any_refractive", "any_glossy",
            "any_image_tex", "any_normal_map")},
    )


def flatten_scene(scene: Scene, device="cuda", dtype=torch.float32) -> SceneTables:
    """Lower `scene` to SceneTables on `device` (same tables as
    ``portrayer_tpu.flatten_scene``), float tables in `dtype`."""
    arrays, meta = _flatten_numpy(scene)
    return tables_from_numpy(arrays, meta, device, dtype)


# ---------------------------------------------------------------------------
# Fused node record (the JAX package's node_record layout):
#   0..11 world->local affine   12..14 diffuse  15..17 specular
#   18 shininess  19 reflectivity  20 glossy  21 refraction
#   22 tex_id  23 normal_map_id  24 material_id   (float-encoded ints)
#   25..30 uv_trans rows 0..1   31 primitive kind   32..33 params
# ---------------------------------------------------------------------------
REC_KIND = 31
REC_PARAMS = slice(32, 34)


def node_record(st: SceneTables) -> torch.Tensor:
    """[N,34] fused per-node shading record."""
    N = st.n_nodes
    dt = st.inv.dtype
    mid = st.material_id.long()
    kinds = torch.zeros(N, dtype=dt, device=st.inv.device)
    for kind, start, count in st.groups:
        kinds[start:start + count] = kind
    col = lambda x: x[:, None].to(dt)
    return torch.cat(
        [
            st.inv.reshape(N, 12),
            st.mat_diffuse[mid],
            st.mat_specular[mid],
            col(st.mat_shininess[mid]),
            col(st.mat_reflectivity[mid]),
            col(st.mat_glossy[mid]),
            col(st.mat_refraction[mid]),
            col(st.mat_tex_id[mid]),
            col(st.mat_normal_map_id[mid]),
            col(st.material_id),
            st.mat_uv_trans[mid][:, :2, :].reshape(N, 6),
            kinds[:, None],
            st.prim_params,
        ],
        dim=1,
    )


# Fused triangle record (the JAX package's tri_record layout):
#   0..8 a, b, c   9..17 na, nb, nc   18..23 uva, uvb, uvc   24 smooth  25 has_uv
def tri_record(st: SceneTables) -> torch.Tensor:
    """[T,26] fused per-triangle detail record."""
    dt = st.tri_a.dtype
    col = lambda x: x[:, None].to(dt)
    return torch.cat([st.tri_a, st.tri_b, st.tri_c, st.tri_na, st.tri_nb, st.tri_nc,
                      st.tri_uva, st.tri_uvb, st.tri_uvc, col(st.tri_smooth),
                      col(st.tri_has_uv)], dim=1)
