"""Scene intersection: the plain oracle and the sweep dispatch
(counterpart of ``portrayer_tpu/ops/intersect.py``).

Rays are SoA batches [R,3].  The flat sweep walks each analytic group in
node chunks and then the mesh (instance, triangle) pairs in pair chunks,
computes every candidate in the node's local frame and folds the nearest
hit; ``hit_detail`` then recomputes the winner's t, normal, uv and tangent
frame from the tables.  Selection follows the reference: half-open range
t_min <= t < t_max, the smallest quadratic root in range with cap checks
and no second-root fallback, strict-< folds over cube faces
(cube.rs:70-82) and over cylinder/cone parts, the Shirley/Cramer triangle
test (triangle.rs:39-80).

``accel="cuda"`` sends nearest and any-hit queries to the sweep in
``cuda_intersect`` (its kernel on CUDA tensors, its plain version on CPU
tensors); ``accel="beam"`` sends nearest queries (and shadow rays, as
nearest queries) to the beam sweep of ``ops/beam.py`` on scenes of at
least ``cfg.beam_min_prims`` nodes + mesh pairs; ``accel="flat"`` and
smaller scenes stay here.

Gradients: every sweep only selects the winners and returns tensors
without a graph; ``hit_detail`` recomputes the winner's t from the tables,
so autograd reaches the node, material and triangle tables through it, and
through ``HitDetail.margin`` the silhouettes when
``RenderConfig.soft_visibility`` > 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import math3d as m3
from ..config import RenderConfig
from ..scene.flatten import (
    SceneTables, SPHERE, PLANE, CUBE, CYLINDER, CONE, MESH, TORUS, REC_KIND, REC_PARAMS,
)

INF = math.inf

# Nodes per step of the flat (oracle) sweep: bounds its [R, chunk] temps.
# The result does not depend on it (first minimum within a step, strict <
# across steps).
NODE_CHUNK = 512
# Mesh pairs per step of the flat sweep (the JAX package's tri_chunk).
PAIR_CHUNK = 512


class Hit(NamedTuple):
    t: torch.Tensor       # [R] hit parameter (inf when no hit)
    node: torch.Tensor    # [R] int32 node id (-1 when no hit)
    tri: torch.Tensor     # [R] int32 triangle id (-1 for analytic prims)
    hit: torch.Tensor     # [R] bool


class HitDetail(NamedTuple):
    point: torch.Tensor    # [R,3] world hit point
    normal: torch.Tensor   # [R,3] world normal (not normalized, ray.rs:19-22)
    uv: torch.Tensor       # [R,2]
    has_uv: torch.Tensor   # [R] bool
    nmt: torch.Tensor      # [R,3,3] normal-map transform (primitive-local)
    has_nmt: torch.Tensor  # [R] bool
    material: torch.Tensor  # [R] int32
    rec: torch.Tensor      # [R,34] the hit node's fused record
    margin: torch.Tensor   # [R] differentiable silhouette margin in local
    #                        units (> 0 inside, -> 0 at the silhouette; inf
    #                        when RenderConfig.soft_visibility is 0)


def _guarded_div(n, d, fill=INF):
    """n / d where d != 0, else `fill`."""
    ok = d != 0.0
    return torch.where(ok, n / torch.where(ok, d, torch.ones_like(d)),
                       torch.full_like(n, fill))


def _finite(t):
    """inf/nan -> 0 before point arithmetic (validity tests already reject
    such t, so the forward result is unchanged)."""
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _in_range(t, t_min, t_max):
    return (t >= t_min) & (t < t_max)


def _quadratic_roots(a, b, c):
    """(r0, r1), r0 <= r1, +inf where invalid; exact a == 0 falls back to
    the linear equation (the roots crate, src/math.rs:107-114)."""
    disc = b * b - 4.0 * a * c
    sq = m3.safe_sqrt(disc)
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    one = torch.ones_like(a)
    inf = torch.full_like(a, INF)
    safe_a = torch.where(a == 0.0, one, a)
    safe_q = torch.where(q == 0.0, one, q)
    ra = torch.where(a == 0.0, inf, q / safe_a)
    rb = torch.where(q == 0.0, -b / (2.0 * safe_a), c / safe_q)
    r0 = torch.minimum(ra, rb)
    r1 = torch.maximum(ra, rb)
    safe_b = torch.where(b == 0.0, one, b)
    lin = torch.where(b == 0.0, inf, -c / safe_b)
    quad_ok = (a != 0.0) & (disc >= 0.0)
    r0 = torch.where(a == 0.0, lin, torch.where(quad_ok, r0, inf))
    r1 = torch.where(a == 0.0, inf, torch.where(quad_ok, r1, inf))
    return r0, r1


def smallest_root_in_range(a, b, c, t_min, t_max):
    """Smallest root with t_min <= t < t_max (src/math.rs:94-96): (t, ok)."""
    r0, r1 = _quadratic_roots(a, b, c)
    ok0 = (r0 >= t_min) & (r0 < t_max)
    ok1 = (r1 >= t_min) & (r1 < t_max)
    t = torch.where(ok0, r0, torch.where(ok1, r1, torch.full_like(r1, INF)))
    return t, ok0 | ok1


# ---------------------------------------------------------------------------
# Candidate-t functions.  o, d: [..., 3] local rays; t_min/t_max
# broadcastable.  Return t [...] with inf where invalid.
# ---------------------------------------------------------------------------

def sphere_candidate(o, d, t_min, t_max, eps, params=None):
    a = m3.dot(d, d)
    b = 2.0 * m3.dot(o, d)
    c = m3.dot(o, o) - 1.0
    t, ok = smallest_root_in_range(a, b, c, t_min, t_max)
    return torch.where(ok, t, INF)


def plane_candidate(o, d, t_min, t_max, eps, params=None):
    """Unit XZ square at y = 0 (plane.rs)."""
    t = _guarded_div(-o[..., 1], d[..., 1])
    tc = _finite(t)
    p_x = o[..., 0] + tc * d[..., 0]
    p_z = o[..., 2] + tc * d[..., 2]
    r = 0.5 + eps
    ok = _in_range(t, t_min, t_max) & (torch.abs(p_x) <= r) & (torch.abs(p_z) <= r)
    return torch.where(ok, t, INF)


# Cube faces (axis, point) in the FACES order of cube.rs:46-65
# (right, left, top, bottom, near, far).
_CUBE_FACES = ((0, +0.5), (0, -0.5), (1, +0.5), (1, -0.5), (2, +0.5), (2, -0.5))


def _cube_face_fold(o, d, t_min, t_max, eps):
    """(best_t, best_face) over the 6 faces, strictly-smaller wins.  The
    containment test skips the solved axis (on the plane by construction;
    checking it in f32 rejects hits on thin-scaled cubes)."""
    r = 0.5 + eps
    best_t = torch.full(o.shape[:-1], INF, dtype=o.dtype, device=o.device)
    best_face = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
    for fi, (axis, sign) in enumerate(_CUBE_FACES):
        sg = 1.0 if sign > 0 else -1.0
        t = _guarded_div(-(o[..., axis] - sign) * sg, d[..., axis] * sg)
        p = o + _finite(t)[..., None] * d
        contains = torch.ones_like(t, dtype=torch.bool)
        for ax in range(3):
            if ax != axis:
                contains = contains & (torch.abs(p[..., ax]) <= r)
        ok = _in_range(t, t_min, t_max) & contains & (t < best_t)
        best_face = torch.where(ok, fi, best_face)
        best_t = torch.where(ok, t, best_t)
    return best_t, best_face


def cube_candidate(o, d, t_min, t_max, eps, params=None):
    return _cube_face_fold(o, d, t_min, t_max, eps)[0]


def _cyl_parts(o, d, t_min, t_max):
    """Cylinder candidates (body, top cap, bottom cap); r=0.5, h=1."""
    R2 = 0.25
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    c = o[..., 0] ** 2 + o[..., 2] ** 2 - R2
    t_body, ok = smallest_root_in_range(a, b, c, t_min, t_max)
    y = o[..., 1] + _finite(t_body) * d[..., 1]
    ok = ok & ~(y > 0.5) & ~(y < -0.5)
    t_body = torch.where(ok, t_body, INF)

    def cap(h):
        t = _guarded_div(h - o[..., 1], d[..., 1])
        tc = _finite(t)
        px = o[..., 0] + tc * d[..., 0]
        pz = o[..., 2] + tc * d[..., 2]
        okc = _in_range(t, t_min, t_max) & ~(px * px + pz * pz > R2)
        return torch.where(okc, t, INF)

    return t_body, cap(0.5), cap(-0.5)


def cylinder_candidate(o, d, t_min, t_max, eps, params=None):
    t_body, t_top, t_bot = _cyl_parts(o, d, t_min, t_max)
    t = t_body
    t = torch.where(t_top < t, t_top, t)
    t = torch.where(t_bot < t, t_bot, t)
    return t


def _cone_parts(o, d, t_min, t_max):
    """Cone candidates (body, bottom cap); r=0.5, h=1, apex at y=+0.5."""
    H = 1.0
    h2 = H * H
    r2 = 0.25
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = 4.0 * dy * dy * r2 - 4.0 * h2 * (dx * dx + dz * dz)
    b = -8.0 * h2 * (dx * ox + dz * oz) - 4.0 * r2 * (dy * H - 2.0 * dy * oy)
    c = -4.0 * h2 * (ox * ox + oz * oz) + r2 * (h2 - 4.0 * H * oy + 4.0 * oy * oy)
    t_body, ok = smallest_root_in_range(a, b, c, t_min, t_max)
    y = oy + _finite(t_body) * dy
    ok = ok & ~(y > 0.5) & ~(y < -0.5)
    t_body = torch.where(ok, t_body, INF)

    t_cap = _guarded_div(-0.5 - oy, dy)
    tcc = _finite(t_cap)
    px = ox + tcc * dx
    pz = oz + tcc * dz
    okc = _in_range(t_cap, t_min, t_max) & ~(px * px + pz * pz > r2)
    t_cap = torch.where(okc, t_cap, INF)
    return t_body, t_cap


def cone_candidate(o, d, t_min, t_max, eps, params=None):
    t_body, t_cap = _cone_parts(o, d, t_min, t_max)
    return torch.where(t_cap < t_body, t_cap, t_body)


def torus_coeffs(o, d, c_r, a_r):
    """Quartic coefficients of the torus (primitive/torus.rs:56-110): hole
    along y, center radius c_r, tube radius a_r."""
    dd = m3.dot(d, d)
    pp = m3.dot(o, o)
    dp = m3.dot(d, o)
    a2 = a_r * a_r
    c2 = c_r * c_r
    k = pp - (a2 + c2)
    A = dd * dd
    B = 4.0 * dd * dp
    C = 2.0 * dd * k + 4.0 * dp * dp + 4.0 * c2 * d[..., 1] * d[..., 1]
    D = 4.0 * k * dp + 8.0 * c2 * o[..., 1] * d[..., 1]
    E = k * k - 4.0 * c2 * (a2 - o[..., 1] * o[..., 1])
    return A, B, C, D, E


def torus_candidate(o, d, t_min, t_max, eps, params=None):
    """params [..., 2]: (center radius, tube radius).  The solved root is
    detached and taken through one Newton step with the coefficients, as
    the JAX package does for its implicit-function gradient; the step
    moves the value by rounding only."""
    A, B, C, D, E = torus_coeffs(o, d, params[..., 0], params[..., 1])
    full = lambda x: torch.broadcast_to(torch.as_tensor(x, dtype=A.dtype, device=A.device),
                                        A.shape)
    t, ok = m3.quartic_smallest_root_in_range(A, B, C, D, E, full(t_min), full(t_max))
    t0 = torch.where(ok, t, INF).detach()
    t0c = _finite(t0)
    f = (((A * t0c + B) * t0c + C) * t0c + D) * t0c + E
    fp = ((4.0 * A * t0c + 3.0 * B) * t0c + 2.0 * C) * t0c + D
    t_imp = t0c - f / torch.where(fp == 0.0, 1.0, fp)
    return torch.where(torch.isfinite(t0), t_imp, INF)


_ANALYTIC_CANDIDATES = {
    SPHERE: sphere_candidate,
    PLANE: plane_candidate,
    CUBE: cube_candidate,
    CYLINDER: cylinder_candidate,
    CONE: cone_candidate,
    TORUS: torus_candidate,
}


def triangle_candidate(o, d, a, b, c, t_min, t_max):
    """Shirley/Cramer triangle intersection (triangle.rs:39-80): (t, beta,
    gamma), t = inf where invalid; beta and gamma are 2 where the system is
    singular.  All operands broadcast elementwise ([..., 3] points)."""
    e1 = a - b
    e2 = a - c
    A, B, C_ = e1[..., 0], e1[..., 1], e1[..., 2]
    D, E, F = e2[..., 0], e2[..., 1], e2[..., 2]
    G, H, I = d[..., 0], d[..., 1], d[..., 2]
    rhs = a - o
    J, K, L = rhs[..., 0], rhs[..., 1], rhs[..., 2]

    ei_hf = E * I - H * F
    gf_di = G * F - D * I
    dh_eg = D * H - E * G
    M = A * ei_hf + B * gf_di + C_ * dh_eg

    ak_jb = A * K - J * B
    jc_al = J * C_ - A * L
    bl_ck = B * L - C_ * K

    t = _guarded_div(-(F * ak_jb + E * jc_al + D * bl_ck), M)
    gamma = _guarded_div(I * ak_jb + H * jc_al + G * bl_ck, M, 2.0)
    beta = _guarded_div(J * ei_hf + K * gf_di + L * dh_eg, M, 2.0)
    ok = (_in_range(t, t_min, t_max) & ~(gamma < 0.0) & ~(gamma > 1.0)
          & ~(beta < 0.0) & ~(beta > 1.0 - gamma))
    return torch.where(ok, t, INF), beta, gamma


# ---------------------------------------------------------------------------
# Flat sweep
# ---------------------------------------------------------------------------

def _local_rays(inv34, o, d):
    """Rays [R,3] into the local frames of nodes [C,3,4] -> [R,C,3]."""
    m = inv34[None]                                    # [1,C,3,4]
    oo = o[:, None, None, :]
    dd = d[:, None, None, :]
    ld = m[..., 0] * dd[..., 0] + m[..., 1] * dd[..., 1] + m[..., 2] * dd[..., 2]
    lo = m[..., 0] * oo[..., 0] + m[..., 1] * oo[..., 1] + m[..., 2] * oo[..., 2] + m[..., 3]
    return lo, ld


def _as_rays(x, R, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(R)


@torch.no_grad()
def _flat_intersect(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
                    active=None, src_node=None, src_tri=None):
    R = o.shape[0]
    dev = o.device
    t_min = _as_rays(t_min, R, o)
    t_max = _as_rays(t_max, R, o)
    best_t = torch.full((R,), INF, dtype=o.dtype, device=dev)
    best_node = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    eps = cfg.epsilon
    use_src = src_node is not None and cfg.self_eps_local > 0.0
    if use_src and src_tri is None:
        src_tri = torch.full_like(src_node, -1)

    def eff_t_min(ld, is_src):
        """[R, C] t-range start: raised to self_eps_local / |d_local| on
        the ray's source surface."""
        if not use_src:
            return t_min[:, None]
        t_self = cfg.self_eps_local / torch.clamp(m3.norm(ld, eps=1e-20), min=1e-30)
        return torch.where(is_src, torch.maximum(t_min[:, None], t_self), t_min[:, None])

    def fold(t, node, tri):
        nonlocal best_t, best_node, best_tri
        tj, j = torch.min(t, dim=1)
        better = tj < best_t
        best_node = torch.where(better, node[j], best_node)
        best_tri = torch.where(better, tri[j], best_tri)
        best_t = torch.where(better, tj, best_t)

    for kind, start, count in st.groups:
        if kind == MESH:
            continue
        for c0 in range(start, start + count, NODE_CHUNK):
            c1 = min(c0 + NODE_CHUNK, start + count)
            ids = torch.arange(c0, c1, dtype=torch.int32, device=dev)
            lo, ld = _local_rays(st.inv[c0:c1], o, d)
            is_src = (ids[None, :] == src_node[:, None]) if use_src else None
            t = _ANALYTIC_CANDIDATES[kind](lo, ld, eff_t_min(ld, is_src), t_max[:, None], eps,
                                           params=st.prim_params[None, c0:c1])
            fold(t, ids, torch.full_like(ids, -1))

    # Mesh (instance, triangle) pairs, in the node's local frame; the
    # source pair's t-range start is raised (the sweep kernel excludes it).
    if any(kind == MESH for kind, _, _ in st.groups):
        for p0 in range(0, st.n_pairs, PAIR_CHUNK):
            pn = st.pair_node[p0:p0 + PAIR_CHUNK]
            pt = st.pair_tri[p0:p0 + PAIR_CHUNK]
            lo, ld = _local_rays(st.inv[pn.long()], o, d)
            tri_ix = pt.long()
            is_src = ((pn[None, :] == src_node[:, None]) & (pt[None, :] == src_tri[:, None])
                      if use_src else None)
            t = triangle_candidate(lo, ld, st.tri_a[tri_ix][None], st.tri_b[tri_ix][None],
                                   st.tri_c[tri_ix][None], eff_t_min(ld, is_src),
                                   t_max[:, None])[0]
            fold(t, pn, pt)

    hit = torch.isfinite(best_t)
    if active is not None:
        hit = hit & active
    neg = torch.full_like(best_node, -1)
    return Hit(t=best_t, node=torch.where(hit, best_node, neg),
               tri=torch.where(hit, best_tri, neg), hit=hit)


def intersect_scene(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
                    active=None, src_node=None, src_tri=None) -> Hit:
    """Nearest hit for world rays [R,3].  t_min/t_max: [R] or scalar;
    `active` [R] bool masks rays out; src_node/src_tri [R] int32 name the
    surface each ray left, whose t-range start is raised to
    ``self_eps_local / |d_local|`` in that node's local units."""
    if cfg.accel == "cuda":
        from .cuda_intersect import intersect_scene_cuda

        return intersect_scene_cuda(o, d, t_min, t_max, st, cfg, active=active,
                                    src_node=src_node, src_tri=src_tri)
    if cfg.accel == "beam" and st.n_nodes + st.n_pairs >= cfg.beam_min_prims:
        from .beam import intersect_scene_beam

        return intersect_scene_beam(o, d, t_min, t_max, st, cfg, active=active,
                                    src_node=src_node, src_tri=src_tri)
    return _flat_intersect(o, d, t_min, t_max, st, cfg, active, src_node, src_tri)


def occluded(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
             active=None, src_node=None, src_tri=None):
    """Any-hit query for shadow rays.  The reference casts the full query
    with an unbounded range (material.rs:174-179): objects beyond the light
    occlude too, which is preserved."""
    if cfg.accel == "cuda":
        from .cuda_intersect import intersect_scene_cuda

        return intersect_scene_cuda(o, d, t_min, t_max, st, cfg, active=active,
                                    src_node=src_node, src_tri=src_tri,
                                    any_hit=True).hit
    return intersect_scene(o, d, t_min, t_max, st, cfg, active=active, src_node=src_node,
                           src_tri=src_tri).hit


# ---------------------------------------------------------------------------
# Hit detail — recompute t, normal, uv and tangent frame for the winners.
# ---------------------------------------------------------------------------

def _vec(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _sphere_detail(p, eps):
    """p: [R,3] local hit point on the unit sphere."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u = (math.pi + torch.atan2(-z, x)) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(y, -1.0, 1.0)) / math.pi
    uv = torch.stack([u, v], dim=-1)
    normal = p
    # tangent basis (sphere.rs:72-96): to_top = normalize((0,1,0) - p)
    to_top = m3.normalize(torch.stack([-x, 1.0 - y, -z], dim=-1), eps=1e-30)
    degenerate = (torch.abs(to_top[..., 0]) < eps) & (torch.abs(to_top[..., 2]) < eps)
    h_tan = m3.cross(to_top, normal)
    v_tan = m3.cross(normal, h_tan)
    pole_col2 = torch.where((y > 0.0)[..., None], _vec([0.0, 0.0, 1.0], p),
                            _vec([0.0, 0.0, -1.0], p))
    right = _vec([1.0, 0.0, 0.0], p).expand_as(p)
    col0 = torch.where(degenerate[..., None], right, h_tan)
    col2 = torch.where(degenerate[..., None], pole_col2, v_tan)
    nmt = torch.stack([col0, normal, col2], dim=-1)
    ones = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    return normal, uv, ones, nmt, ones


# Cube face uv data (cube.rs FACES): (axis, sign, uv_axis(u,v), uv_offset(u,v))
_CUBE_FACE_UV = (
    (0, +0.5, (-1.0, 1.0), (1.0 / 2.0, 1.0 / 3.0)),   # right
    (0, -0.5, (1.0, 1.0), (0.0, 1.0 / 3.0)),          # left
    (1, +0.5, (1.0, -1.0), (1.0 / 4.0, 0.0)),         # top
    (1, -0.5, (1.0, 1.0), (1.0 / 4.0, 2.0 / 3.0)),    # bottom
    (2, +0.5, (1.0, 1.0), (1.0 / 4.0, 1.0 / 3.0)),    # near
    (2, -0.5, (-1.0, 1.0), (3.0 / 4.0, 1.0 / 3.0)),   # far
)


def _cube_detail(o, d, t_min, t_max, p, eps):
    _, face = _cube_face_fold(o, d, t_min, t_max, eps)
    face = torch.clamp(face, min=0)
    n = torch.zeros_like(p)
    u = torch.zeros_like(p[..., 0])
    v = torch.zeros_like(p[..., 0])
    for fi, (axis, sign, uvax, uvoff) in enumerate(_CUBE_FACE_UV):
        mask = face == fi
        nvec = [0.0, 0.0, 0.0]
        nvec[axis] = 1.0 if sign > 0 else -1.0
        n = torch.where(mask[:, None], _vec(nvec, p), n)
        # face_uv: normal.x!=0 -> (z,y); normal.y!=0 -> (x,z); else (x,y)
        s0, s1 = (2, 1) if axis == 0 else ((0, 2) if axis == 1 else (0, 1))
        norm_u = p[..., s0] * uvax[0] + 0.5
        norm_v = 0.5 - p[..., s1] * uvax[1]
        u = torch.where(mask, norm_u / 4.0 + uvoff[0], u)
        v = torch.where(mask, norm_v / 3.0 + uvoff[1], v)
    uv = torch.stack([u, v], dim=-1)
    # tangent basis (cube.rs:111-136): to_top = normalize((0,1,0) - p)
    to_top = m3.normalize(
        torch.stack([-p[..., 0], 1.0 - p[..., 1], -p[..., 2]], dim=-1), eps=1e-30)
    degenerate = (torch.abs(to_top[..., 0]) < eps) & (torch.abs(to_top[..., 2]) < eps)
    h_tan = m3.cross(to_top, n)
    v_tan = m3.cross(n, h_tan)
    pole_col2 = torch.where((n[..., 1] > 0.0)[..., None], _vec([0.0, 0.0, 1.0], p),
                            _vec([0.0, 0.0, -1.0], p))
    right = _vec([1.0, 0.0, 0.0], p).expand_as(p)
    col0 = torch.where(degenerate[..., None], right, h_tan)
    col2 = torch.where(degenerate[..., None], pole_col2, v_tan)
    nmt = torch.stack([col0, n, col2], dim=-1)
    ones = torch.ones_like(u, dtype=torch.bool)
    return n, uv, ones, nmt, ones


def _no_uv(p, n):
    zeros = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return n, torch.zeros_like(p[..., :2]), zeros, eye, zeros


def _cylinder_detail(o, d, t_min, t_max, p):
    t_body, t_top, t_bot = _cyl_parts(o, d, t_min, t_max)
    t = t_body
    part = torch.zeros_like(t, dtype=torch.int32)
    part = torch.where(t_top < t, 1, part)
    t = torch.minimum(t, t_top)
    part = torch.where(t_bot < t, 2, part)
    n_body = torch.stack([p[..., 0], torch.zeros_like(p[..., 1]), p[..., 2]], dim=-1)
    n = torch.where((part == 0)[..., None], n_body,
                    torch.where((part == 1)[..., None], _vec([0.0, 1.0, 0.0], p),
                                _vec([0.0, -1.0, 0.0], p)))
    return _no_uv(p, n)


def _cone_detail(o, d, t_min, t_max, p):
    t_body, t_cap = _cone_parts(o, d, t_min, t_max)
    is_cap = t_cap < t_body
    # body normal (cone.rs:78-104)
    tangent1 = _vec([0.0, 0.5, 0.0], p) - p
    across = torch.stack([-2.0 * p[..., 0], torch.zeros_like(p[..., 1]),
                          -2.0 * p[..., 2]], dim=-1)
    tangent2 = m3.cross(tangent1, across)
    n_body = m3.cross(tangent1, tangent2)
    n = torch.where(is_cap[..., None], _vec([0.0, -1.0, 0.0], p), n_body)
    return _no_uv(p, n)


def _plane_detail(p):
    n = _vec([0.0, 1.0, 0.0], p).expand_as(p)
    uv = torch.stack([p[..., 0] + 0.5, p[..., 2] + 0.5], dim=-1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    ones = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    return n, uv, ones, eye, ones


def _torus_detail(p, params):
    """Hit point minus the nearest tube-center point (the construction
    torus.rs:112-125 sketches); no uv (torus.rs:126-130)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxz = torch.sqrt(x * x + z * z)
    scale = params[..., 0] / torch.clamp(rxz, min=1e-30)
    tube_center = torch.stack([x * scale, torch.zeros_like(y), z * scale], dim=-1)
    return _no_uv(p, p - tube_center)


def _mesh_detail(lo, ld, trec, t_min, t_max):
    """Barycentrics on the winning triangle (its fused record `trec`):
    interpolated (smooth) or face (flat) normal, uv with the v-flip and the
    TBN (triangle.rs:82-138)."""
    a, b, c = trec[:, 0:3], trec[:, 3:6], trec[:, 6:9]
    _, beta, gamma = triangle_candidate(lo, ld, a, b, c, t_min, t_max)
    alpha = 1.0 - beta - gamma
    smooth = trec[:, 24] > 0.5
    na, nb, nc = trec[:, 9:12], trec[:, 12:15], trec[:, 15:18]
    n_smooth = na * alpha[:, None] + nb * beta[:, None] + nc * gamma[:, None]
    n = torch.where(smooth[:, None], n_smooth, m3.cross(b - a, c - a))

    has_uv = trec[:, 25] > 0.5
    uva, uvb, uvc = trec[:, 18:20], trec[:, 20:22], trec[:, 22:24]
    uv_i = uva * alpha[:, None] + uvb * beta[:, None] + uvc * gamma[:, None]
    uv = torch.stack([uv_i[:, 0], 1.0 - uv_i[:, 1]], dim=-1)  # v-flip (triangle.rs:98)

    edge1, edge2 = b - a, c - a
    duv1, duv2 = uvb - uva, uvc - uva
    tangent = duv2[:, 1:2] * edge1 - duv1[:, 1:2] * edge2
    bitangent = -duv2[:, 0:1] * edge1 + duv1[:, 0:1] * edge2
    coeff = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    coeff_safe = torch.where(coeff != 0.0, coeff, 1.0)[:, None]
    tangent = m3.normalize(tangent / coeff_safe, eps=1e-30)
    bitangent = m3.normalize(bitangent / coeff_safe, eps=1e-30)
    nmt = torch.stack([tangent, m3.normalize(n, eps=1e-30), bitangent], dim=-1)
    return n, uv, has_uv, nmt, has_uv


def _winner_candidate_t(lo, ld, ray_kind, params, trec, t_min, t_max, eps, present):
    """Per-ray candidate t of each ray's selected primitive, recomputed in
    its local frame (the aabox packing maps back to the cube's 6-face
    fold: the record's kind is the node's; a mesh pair to the Cramer solve
    on its triangle record `trec`)."""
    t_re = torch.full(lo.shape[:-1], INF, dtype=lo.dtype, device=lo.device)
    for kind in sorted(present):
        if kind == MESH:
            tk = triangle_candidate(lo, ld, trec[:, 0:3], trec[:, 3:6], trec[:, 6:9],
                                    t_min, t_max)[0]
        else:
            tk = _ANALYTIC_CANDIDATES[kind](lo, ld, t_min, t_max, eps, params=params)
        t_re = torch.where(ray_kind == kind, tk, t_re)
    return t_re


def _winner_trec(st, tri, present):
    """[R,26] triangle records of the winners (None without meshes)."""
    return st.trec[torch.clamp(tri, min=0).long()] if MESH in present else None


def _winner_frame(o, d, node, st, cfg, t_min, src_node, src_tri, tri):
    """(rec, inv, lo, ld, t_min_e) for per-ray winners."""
    R = o.shape[0]
    rec = st.rec[torch.clamp(node, min=0).long()]
    inv = rec[:, 0:12].reshape(R, 3, 4)
    lo = m3.transform_point(inv, o)
    ld = m3.transform_dir(inv, d)
    t_min = _as_rays(t_min, R, o)
    if src_node is not None and cfg.self_eps_local > 0.0:
        is_src = node == src_node
        if src_tri is not None:
            is_src = is_src & (tri == src_tri)
        dn = m3.norm(ld, eps=1e-20)
        t_self = cfg.self_eps_local / torch.clamp(dn, min=1e-30)
        t_min = torch.where(is_src, torch.maximum(t_min, t_self), t_min)
    return rec, inv, lo, ld, t_min


def winner_t(o, d, node, tri, st: SceneTables, cfg: RenderConfig,
             t_min, t_max=INF, src_node=None, src_tri=None):
    """Exact candidate t for per-ray winners (node, tri); INF where float
    asymmetry loses the winner's root."""
    rec, _, lo, ld, t_min = _winner_frame(o, d, node, st, cfg, t_min,
                                          src_node, src_tri, tri)
    t_max = _as_rays(t_max, o.shape[0], o)
    present = {k for (k, _, _) in st.groups}
    return _winner_candidate_t(lo, ld, rec[:, REC_KIND].to(torch.int32), rec[:, REC_PARAMS],
                               _winner_trec(st, tri, present), t_min, t_max, cfg.epsilon,
                               present)


def _silhouette_margin(kind, lo, ld, p_local, trec, params):
    """Differentiable distance-to-silhouette proxy in local units: > 0
    inside the primitive's visible region, -> 0 at the silhouette.
    sphere: tangency; plane and cube: face-edge distance; mesh: barycentric
    edge distance; cylinder, cone and torus: the grazing margin
    (n-hat . d-hat)^2, 0 where the surface normal is perpendicular to the
    ray, with the rim distance of caps and part edges (min)."""

    def grazing(n):
        nd = m3.dot(n, ld)
        n2 = torch.clamp(m3.dot(n, n), min=1e-30)
        d2 = torch.clamp(m3.dot(ld, ld), min=1e-30)
        return nd * nd / (n2 * d2)

    if kind == SPHERE:
        # 1 - (distance of the ray line from the centre)^2: 0 at tangency.
        cr = m3.cross(lo, ld)
        ld2 = torch.clamp(m3.dot(ld, ld), min=1e-30)
        return 1.0 - m3.dot(cr, cr) / ld2
    if kind == PLANE:
        return torch.minimum(0.5 - torch.abs(p_local[..., 0]), 0.5 - torch.abs(p_local[..., 2]))
    if kind == CUBE:
        # The face axis carries |p| == 0.5 (the largest): the margin is 0.5
        # minus the second-largest coordinate magnitude.
        ap = torch.abs(p_local)
        top = torch.amax(ap, dim=-1)
        second = torch.sum(ap, dim=-1) - top - torch.amin(ap, dim=-1)
        return 0.5 - second
    x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
    if kind in (CYLINDER, CONE):
        r2 = x * x + z * z
        m_cap = (0.25 - r2) / 0.25  # 0 at the cap rim
        if kind == CYLINDER:
            is_cap = torch.abs(y) > 0.5 - 1e-4
            n_body = torch.stack([x, torch.zeros_like(y), z], dim=-1)
            m_body = torch.minimum(grazing(n_body), 2.0 * (0.5 - torch.abs(y)))
        else:
            is_cap = y < -0.5 + 1e-4
            tangent1 = _vec([0.0, 0.5, 0.0], p_local) - p_local
            across = torch.stack([-2.0 * x, torch.zeros_like(y), -2.0 * z], dim=-1)
            n_body = m3.cross(tangent1, m3.cross(tangent1, across))
            m_body = torch.minimum(grazing(n_body), 2.0 * (y + 0.5))
        return torch.where(is_cap, m_cap, m_body)
    if kind == TORUS:
        rxz = torch.sqrt(torch.clamp(x * x + z * z, min=1e-30))
        scale = params[..., 0] / rxz
        tube_center = torch.stack([x * scale, torch.zeros_like(y), z * scale], dim=-1)
        return grazing(p_local - tube_center)
    # MESH: the barycentric distance to the nearest edge, over the whole line.
    R = lo.shape[0]
    _, beta, gamma = triangle_candidate(
        lo, ld, trec[:, 0:3], trec[:, 3:6], trec[:, 6:9],
        torch.full((R,), -INF, dtype=lo.dtype, device=lo.device),
        torch.full((R,), INF, dtype=lo.dtype, device=lo.device))
    return torch.minimum(torch.minimum(beta, gamma), 1.0 - beta - gamma)


def hit_detail(o, d, hit: Hit, st: SceneTables, cfg: RenderConfig, t_min,
               src_node=None, src_tri=None) -> HitDetail:
    """World hit point, normal, uv and tangent frame of the winners.  The
    winner's t is recomputed from the tables and becomes the value used
    downstream, differentiable in them; the sweep's t, which carries no
    gradient, is the fallback where the recompute loses the root to float
    asymmetry.  With ``cfg.soft_visibility`` > 0 the silhouette margin is
    filled in too."""
    R = o.shape[0]
    t = torch.where(hit.hit, hit.t, torch.ones_like(hit.t)).detach()
    rec, inv, lo, ld, t_min = _winner_frame(o, d, hit.node, st, cfg, t_min,
                                            src_node, src_tri, hit.tri)
    # Normal matrix = transposed rotation of world->local (scene.rs:204).
    nmat = inv[:, :, :3].transpose(1, 2)
    t_max = torch.full((R,), INF, dtype=o.dtype, device=o.device)
    ray_kind = rec[:, REC_KIND].to(torch.int32)
    present = {k for (k, _, _) in st.groups}
    eps = cfg.epsilon

    params = rec[:, REC_PARAMS]
    trec = _winner_trec(st, hit.tri, present)
    t_re = _winner_candidate_t(lo, ld, ray_kind, params, trec, t_min, t_max, eps, present)
    t = torch.where(hit.hit & torch.isfinite(t_re), t_re, t)

    p_local = lo + t[:, None] * ld
    point = o + t[:, None] * d

    normal = torch.zeros_like(o)
    uv = torch.zeros_like(o[:, :2])
    has_uv = torch.zeros(R, dtype=torch.bool, device=o.device)
    nmt = torch.eye(3, dtype=o.dtype, device=o.device).expand(R, 3, 3)
    has_nmt = has_uv
    margin = torch.full((R,), INF, dtype=o.dtype, device=o.device)
    for kind in sorted(present):
        if kind == SPHERE:
            parts = _sphere_detail(p_local, eps)
        elif kind == PLANE:
            parts = _plane_detail(p_local)
        elif kind == TORUS:
            parts = _torus_detail(p_local, params)
        elif kind == CUBE:
            parts = _cube_detail(lo, ld, t_min, t_max, p_local, eps)
        elif kind == CYLINDER:
            parts = _cylinder_detail(lo, ld, t_min, t_max, p_local)
        elif kind == CONE:
            parts = _cone_detail(lo, ld, t_min, t_max, p_local)
        elif kind == MESH:
            parts = _mesh_detail(lo, ld, trec, t_min, t_max)
        mask = ray_kind == kind
        n_k, uv_k, huv_k, nmt_k, hnmt_k = parts
        normal = torch.where(mask[:, None], n_k, normal)
        uv = torch.where(mask[:, None], uv_k, uv)
        has_uv = torch.where(mask, huv_k, has_uv)
        nmt = torch.where(mask[:, None, None], nmt_k, nmt)
        has_nmt = torch.where(mask, hnmt_k, has_nmt)
        if cfg.soft_visibility > 0.0:
            margin = torch.where(mask, _silhouette_margin(kind, lo, ld, p_local, trec, params),
                                 margin)

    normal_w = m3.matvec3(nmat, normal)
    material = rec[:, 24].to(torch.int32)
    return HitDetail(
        point=point, normal=normal_w, uv=uv, has_uv=has_uv, nmt=nmt,
        has_nmt=has_nmt,
        material=torch.where(hit.hit, material, torch.zeros_like(material)),
        rec=rec, margin=margin,
    )
