"""The plain reference of the water-glass family (sunjay/portrayer
``examples/water-glass.rs``): the first family's Whitted ray tracer
(``render.py``, whose samples, keys, camera, background, shadows and
glossy jitter it shares) with what this scene adds, from the upstream's
semantics (src/material.rs, src/texture.rs, src/primitive/plane.rs and
cube.rs), in plain PyTorch, brute force over every node:

- the plane: the unit square |x|, |z| <= 0.5 at y = 0 of its node's frame,
  normal +y, uv (x + 0.5, z + 0.5), its tangent frame the identity;
- the cube's faces (cube.rs FACES: right, left, top, bottom, near, far),
  each with its uv rectangle of the cube-map cross and the tangent frame
  (to_top x n, n, n x (to_top x n)), to_top = unit((0, 1, 0) - p), and
  (+x, n, +-z) where to_top is vertical;
- image textures: nearest texel, x = trunc(u (w - 1)) mod w (the
  euclidean remainder, so negative uv wraps), the same for y; colour
  texels (c / 255)^2.2 in place of the diffuse colour (material.rs:137-143,
  texture.rs:104-168);
- normal maps (texture.rs:192-221): a texel c / 255 read as the
  left-handed (2r - 1, 2g - 1, -(2b - 1)), turned right-handed as
  (x, -z, -y), made unit and taken through the hit's tangent frame.  The
  upstream applies that frame in the primitive's own local space and
  never turns the result into world space: kept here, so a normal-mapped
  wall (a plane rotated to face +z) shades as if it faced +y;
- dielectric children (material.rs:247-310): a material of refraction
  index eta > 0 sends a reflected child of throughput reflectivity x
  Schlick's R and a refracted child of reflectivity x (1 - R), where
  R = R0 + (1 - R0)(1 - cos)^5, R0 = ((eta - 1) / (eta + 1))^2; entering
  (d.n < 0, from the air) the refracted direction is refract(d, n, eta)
  and cos = -d.n; exiting, refract(d, -n, 1 / eta) and cos its dot with n,
  and where that has no real root (total internal reflection) all of the
  reflectivity goes to the reflected child.  A reflected child takes
  sample id 2 sid, a refracted one 2 sid + 1.

Departures from the upstream, as the first family's: float32 (not f64),
secondary rays start at max(eps, 3e-4 |p|) and past 2e-3 local units on
the node they leave, the samples are the program's by specification.
Besides: no uv transform (the scene has none), light falloff from the
configuration (the upstream's default, 1 + 0 d + 0 d^2), and one rule for
surfaces in contact.  The water's bottom cap lies in the plane of the
table's top, so the two candidates of a ray through the bottom of the
glass differ by rounding alone, and rounding would pick the winner ray by
ray.  The selection takes a cube with its faces grown to the containment
margin, 0.5 + eps local units (``grown_cube_t``), as the program's
axis-aligned box does: the table wins the contact.  The hit's t, point,
normal and uv are then worked out on the exact faces.
"""

# Annotations stay evaluated (no __future__ import): harness/family.py runs
# this file without entering it in sys.modules, where dataclasses would look
# up string annotations.
import dataclasses
import math

import numpy as np
import torch

from . import texels
from . import threefry as tf
from .render import (EPS, EPS_REL, INF, MAX_DEPTH, Rays, _FACES, _div, _finite,
                     _glossy_uniform, _start, affine, background, camera_rays, chunking,
                     cross, cube_faces, cylinder_parts, dot, encode, length, unit)
from .scene import _rotation, camera_to_world

KINDS = ("plane", "cube", "cylinder")


# ---------------------------------------------------------------------------
# Tables.
# ---------------------------------------------------------------------------

def _step(op: str, v) -> np.ndarray:
    m = np.eye(4)
    if op == "translate":
        m[:3, 3] = v
    elif op == "scale":
        m[0, 0], m[1, 1], m[2, 2] = v
    elif op in ("rotate_x", "rotate_z"):  # degrees, as the upstream writes them
        m = _rotation("xyz".index(op[-1]), math.radians(v))
    else:
        raise ValueError(f"unknown transform step {op!r}")
    return m


def world_transform(steps) -> np.ndarray:
    """A node's transform: each step left-multiplied, in the listed order."""
    m = np.eye(4)
    for op, v in steps:
        m = _step(op, v) @ m
    return m


@dataclasses.dataclass
class Tables:
    """The scene's tables, nodes in configuration order."""
    kind_nodes: dict             # kind -> int64 tensor of node ids
    node_kind: torch.Tensor      # [N] int64: the kind's index in KINDS
    node_material: torch.Tensor  # [N] int64
    inv: torch.Tensor            # [N, 3, 4] world -> node
    mat: dict                    # name -> [M] or [M, 3]
    mat_texture: torch.Tensor    # [M] int64: index into maps, -1 for none
    mat_normals: torch.Tensor    # [M] int64
    maps: list                   # uint8 [H, W, 3] tensors
    light_pos: torch.Tensor      # [L, 3]
    light_color: torch.Tensor    # [L, 3]
    light_falloff: torch.Tensor  # [L, 3]
    ambient: torch.Tensor        # [3]
    eye: torch.Tensor
    cam34: torch.Tensor
    width: int
    height: int
    fov_factor: float
    dtype: torch.dtype


MAT_KEYS = ("diffuse", "specular", "shininess", "reflectivity", "glossy_side_length",
            "refraction_index")


def tables(data: dict, device, dtype=torch.float32) -> Tables:
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
    i64 = lambda x: torch.tensor(x, dtype=torch.int64, device=device)
    nodes, mats = data["nodes"], data["materials"]
    kind_of = [n["primitive"] for n in nodes]
    unknown = set(kind_of) - set(KINDS)
    if unknown:
        raise ValueError(f"the water-glass reference has no {sorted(unknown)}")
    maps = texels.make(data["texels"])
    names = list(maps)
    index = lambda name: -1 if name is None else names.index(name)
    cam = data["camera"]
    width, height = data["size"]
    return Tables(
        kind_nodes={k: i64([i for i, x in enumerate(kind_of) if x == k])
                    for k in KINDS if k in kind_of},
        node_kind=i64([KINDS.index(k) for k in kind_of]),
        node_material=i64([n["material"] for n in nodes]),
        inv=t(np.stack([np.linalg.inv(world_transform(n["transform"]))[:3, :4]
                        for n in nodes])),
        mat={k: t([m[k] for m in mats]) for k in MAT_KEYS},
        mat_texture=i64([index(m.get("texture")) for m in mats]),
        mat_normals=i64([index(m.get("normals")) for m in mats]),
        maps=[torch.from_numpy(maps[n]).to(device) for n in names],
        light_pos=t([lt["position"] for lt in data["lights"]]),
        light_color=t([lt["color"] for lt in data["lights"]]),
        light_falloff=t([lt["falloff"] for lt in data["lights"]]),
        ambient=t(data["ambient"]),
        eye=t(cam["eye"]), cam34=t(camera_to_world(cam["eye"], cam["center"], cam["up"])[:3]),
        width=width, height=height,
        fov_factor=math.tan(math.radians(cam["fovy_deg"]) / 2.0), dtype=dtype)


# ---------------------------------------------------------------------------
# Primitives in their node's frame.
# ---------------------------------------------------------------------------

def plane_t(o, d, t_min, t_max):
    """The unit square at y = 0 (to 0.5 + eps): t in range, inf where none."""
    t = _div(-o[..., 1], d[..., 1])
    px = o[..., 0] + _finite(t) * d[..., 0]
    pz = o[..., 2] + _finite(t) * d[..., 2]
    ok = (t >= t_min) & (t < t_max) & (torch.abs(px) <= 0.5 + EPS) \
        & (torch.abs(pz) <= 0.5 + EPS)
    return torch.where(ok, t, INF)


def grown_cube_t(o, d, t_min, t_max, half: float = 0.5 + EPS):
    """The nearest face in range of the cube grown to |x|, |y|, |z| <= half
    (the containment margin 0.5 + eps on the face planes too): what a ray
    selects the cube by (``nearest``)."""
    best = torch.full(o.shape[:-1], INF, dtype=o.dtype, device=o.device)
    for ax in range(3):
        for h in (half, -half):
            t = _div(h - o[..., ax], d[..., ax])
            p = o + _finite(t)[..., None] * d
            ok = (t >= t_min) & (t < t_max) & (t < best)
            for other in range(3):
                if other != ax:
                    ok = ok & (torch.abs(p[..., other]) <= half)
            best = torch.where(ok, t, best)
    return best


def candidate(kind: str, o, d, t_min, t_max, select: bool = False):
    """t of the kind's surface in range, inf where none; with `select`, a
    cube's grown faces (grown_cube_t)."""
    if kind == "plane":
        return plane_t(o, d, t_min, t_max)
    if kind == "cube":
        return grown_cube_t(o, d, t_min, t_max) if select else cube_faces(o, d, t_min, t_max)[0]
    body, top, bot = cylinder_parts(o, d, t_min, t_max)
    t = torch.where(top < body, top, body)
    return torch.where(bot < t, bot, t)


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device).expand_as(like)


def plane_detail(p):
    """(normal, uv, tangent frame [R, 3, 3] by columns) on the plane."""
    n = _const([0.0, 1.0, 0.0], p)
    uv = torch.stack([p[..., 0] + 0.5, p[..., 2] + 0.5], dim=-1)
    frame = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return n, uv, frame


# cube.rs FACES, in _FACES' order: (u axis, v axis) of the face's uv, the
# signs they are read with, and the offset of the face in the cross.
_FACE_UV = (
    ((2, 1), (-1.0, 1.0), (1.0 / 2.0, 1.0 / 3.0)),   # right
    ((2, 1), (1.0, 1.0), (0.0, 1.0 / 3.0)),          # left
    ((0, 2), (1.0, -1.0), (1.0 / 4.0, 0.0)),         # top
    ((0, 2), (1.0, 1.0), (1.0 / 4.0, 2.0 / 3.0)),    # bottom
    ((0, 1), (1.0, 1.0), (1.0 / 4.0, 1.0 / 3.0)),    # near
    ((0, 1), (-1.0, 1.0), (3.0 / 4.0, 1.0 / 3.0)),   # far
)


def cube_detail(o, d, t_min, p):
    """(normal, uv, tangent frame) on the cube face hit: u = (s_u p_u + 0.5)
    / 4 + its offset, v = (0.5 - s_v p_v) / 3 + its offset."""
    face = cube_faces(o, d, t_min, INF)[1].clamp(min=0)
    zero = torch.zeros_like(p[..., 0])
    n, u, v = torch.zeros_like(p), zero, zero
    for f, ((ax, h), ((iu, iv), (su, sv), (ou, ov))) in enumerate(zip(_FACES, _FACE_UV)):
        on = face == f
        nf = [0.0, 0.0, 0.0]
        nf[ax] = 1.0 if h > 0 else -1.0
        n = torch.where(on[..., None], _const(nf, p), n)
        u = torch.where(on, (p[..., iu] * su + 0.5) / 4.0 + ou, u)
        v = torch.where(on, (0.5 - p[..., iv] * sv) / 3.0 + ov, v)
    to_top = unit(torch.stack([-p[..., 0], 1.0 - p[..., 1], -p[..., 2]], dim=-1))
    vertical = (torch.abs(to_top[..., 0]) < EPS) & (torch.abs(to_top[..., 2]) < EPS)
    h_tan = cross(to_top, n)
    v_tan = cross(n, h_tan)
    pole = torch.where((n[..., 1] > 0.0)[..., None], _const([0.0, 0.0, 1.0], p),
                       _const([0.0, 0.0, -1.0], p))
    col0 = torch.where(vertical[..., None], _const([1.0, 0.0, 0.0], p), h_tan)
    col2 = torch.where(vertical[..., None], pole, v_tan)
    return n, torch.stack([u, v], dim=-1), torch.stack([col0, n, col2], dim=-1)


def cylinder_normal(o, d, t_min, p):
    body, top, bot = cylinder_parts(o, d, t_min, INF)
    zero, one = torch.zeros_like(p[..., 0]), torch.ones_like(p[..., 0])
    cap_y = torch.where(bot < torch.minimum(body, top), -one,
                        torch.where(top < body, one, zero))
    side = torch.stack([p[..., 0], zero, p[..., 2]], dim=-1)
    return torch.where((cap_y != 0.0)[..., None], torch.stack([zero, cap_y, zero], dim=-1),
                       side)


# ---------------------------------------------------------------------------
# Textures.
# ---------------------------------------------------------------------------

def sample(texels_u8, uv, srgb: bool):
    """The nearest texel of each uv [R, 2], wrapped (euclidean remainder):
    [R, 3] as c / 255, then c^2.2 where `srgb`."""
    h, w = texels_u8.shape[:2]
    x = torch.remainder(torch.trunc(uv[..., 0] * (w - 1)).to(torch.int64), w)
    y = torch.remainder(torch.trunc(uv[..., 1] * (h - 1)).to(torch.int64), h)
    c = texels_u8[y, x].to(uv.dtype) * (1.0 / 255.0)
    return c ** 2.2 if srgb else c


def sample_maps(sc: Tables, which, uv, srgb: bool, out):
    """`out` [R, 3] with each ray whose map index `which` is >= 0 replaced
    by its map's texel at uv."""
    out = out.clone()
    for i, m in enumerate(sc.maps):
        sel = (which == i).nonzero()[:, 0]
        if sel.numel():
            out[sel] = sample(m, uv[sel], srgb)
    return out


def decode_normal(c):
    """A normal-map texel (c / 255) as a right-handed tangent-space vector."""
    x, y, z = 2.0 * c[..., 0] - 1.0, 2.0 * c[..., 1] - 1.0, -(2.0 * c[..., 2] - 1.0)
    return torch.stack([x, -z, -y], dim=-1)


# ---------------------------------------------------------------------------
# Selection over every node (no gradient).
# ---------------------------------------------------------------------------

@torch.no_grad()
def nearest(sc: Tables, o, d, t_min, src, block: int = 1 << 24):
    """(t, node): each ray's nearest hit over every node, node -1 on a miss."""
    R = o.shape[0]
    best_t = torch.full((R,), INF, dtype=o.dtype, device=o.device)
    best_n = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    for kind, ids in sc.kind_nodes.items():
        step = max(1, block // max(1, ids.numel()))
        m = sc.inv[ids][None]
        for r0 in range(0, R, step):
            sl = slice(r0, r0 + step)
            lo = affine(m, o[sl, None, :])
            ld = affine(m, d[sl, None, :], point=False)
            tm = _start(t_min[sl, None], ld, ids[None, :] == src[sl, None])
            tk, j = torch.min(candidate(kind, lo, ld, tm, INF, select=True), dim=1)
            better = tk < best_t[sl]
            best_n[sl] = torch.where(better, ids[j], best_n[sl])
            best_t[sl] = torch.where(better, tk, best_t[sl])
    return best_t, torch.where(torch.isfinite(best_t), best_n, -1)


@torch.no_grad()
def occluded(sc: Tables, o, d, t_min, src, need):
    """Whether any node lies on each ray's line past t_min (rays outside
    `need` read False)."""
    out = torch.zeros_like(need)
    idx = need.nonzero()[:, 0]
    if idx.numel():
        t, _ = nearest(sc, o[idx], d[idx], t_min[idx], src[idx])
        out[idx] = torch.isfinite(t)
    return out


# ---------------------------------------------------------------------------
# One round of rays: hit, shading, shadows, children.
# ---------------------------------------------------------------------------

def surface(sc: Tables, rays: Rays, node, t_sel):
    """(world point, unit world normal, uv, tangent frame, has uv) of each
    ray's hit on `node`, its t recomputed in the node's frame."""
    inv = sc.inv[node]
    lo = affine(inv, rays.o)
    ld = affine(inv, rays.d, point=False)
    tm = _start(rays.t_min, ld, node == rays.src)
    kind = sc.node_kind[node]
    t = torch.full_like(t_sel, INF)
    for code, name in enumerate(KINDS):
        if name in sc.kind_nodes:
            t = torch.where(kind == code, candidate(name, lo, ld, tm, INF), t)
    t = torch.where(torch.isfinite(t), t, t_sel)
    p = lo + t[:, None] * ld
    n_local = torch.zeros_like(lo)
    uv = torch.zeros_like(lo[:, :2])
    frame = torch.eye(3, dtype=lo.dtype, device=lo.device).expand(lo.shape[0], 3, 3)
    for code, name in enumerate(KINDS):
        if name not in sc.kind_nodes:
            continue
        on = kind == code
        if name == "cylinder":
            n_local = torch.where(on[:, None], cylinder_normal(lo, ld, tm, p), n_local)
            continue
        n_k, uv_k, frame_k = plane_detail(p) if name == "plane" else cube_detail(lo, ld, tm, p)
        n_local = torch.where(on[:, None], n_k, n_local)
        uv = torch.where(on[:, None], uv_k, uv)
        frame = torch.where(on[:, None, None], frame_k, frame)
    point = rays.o + t[:, None] * rays.d
    # World normal: the transposed linear part of world -> local.
    n = unit(inv[:, 0, :3] * n_local[:, 0:1] + inv[:, 1, :3] * n_local[:, 1:2]
             + inv[:, 2, :3] * n_local[:, 2:3])
    return point, n, uv, frame, kind != KINDS.index("cylinder")


def dielectric(d, n, eta):
    """(refracted direction, Schlick's R, total internal reflection) at
    index eta (outside 1)."""
    dn = dot(d, n)
    entering = dn < 0.0
    tangential = d - n * dn[:, None]
    under_in = 1.0 - (1.0 - dn * dn) / (eta * eta)
    into = tangential / eta[:, None] - n * torch.sqrt(torch.clamp(under_in, min=0.0))[:, None]
    under_out = 1.0 - (1.0 - dn * dn) * (eta * eta)
    out = tangential * eta[:, None] + n * torch.sqrt(torch.clamp(under_out, min=0.0))[:, None]
    cos = torch.where(entering, -dn, dot(out, n))
    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos) ** 5
    return torch.where(entering[:, None], into, out), schlick, ~entering & (under_out < 0.0)


def shares(d, n, refl, eta):
    """(refracted direction, reflected share, refracted share) of a hit's
    reflectivity `refl` at index `eta` (0: no refraction, all of it
    reflected; total internal reflection likewise)."""
    glass = (refl > 0.0) & (eta > 0.0)
    t_dir, schlick, tir = dielectric(d, n, torch.where(glass, eta, 1.0))
    split = glass & ~tir
    return (t_dir, torch.where(split, refl * schlick, refl),
            torch.where(split, refl * (1.0 - schlick), 0.0))


def shade_round(sc: Tables, rays: Rays, r: int, acc, bg):
    """Round r over `rays`: returns (acc, the children or None)."""
    dt = rays.o.dtype
    t_sel, node = nearest(sc, rays.o, rays.d, rays.t_min, rays.src)
    hit = node >= 0
    miss = ~hit
    acc = acc.index_add(0, rays.pix[miss], rays.w[miss, None] * bg[rays.pix[miss]])
    rays, t_sel, node = rays.take(hit), t_sel[hit], node[hit]
    if node.numel() == 0:
        return acc, None
    point, n, uv, frame, has_uv = surface(sc, rays, node, t_sel)
    mat = sc.node_material[node]
    m = {k: v[mat] for k, v in sc.mat.items()}
    nm = torch.where(has_uv, sc.mat_normals[mat], -1)
    if bool((nm >= 0).any()):
        tangent = unit(decode_normal(sample_maps(sc, nm, uv, False, torch.zeros_like(n))))
        # The upstream's quirk: the tangent frame is the primitive's local
        # one, and the mapped normal is not turned into world space.
        mapped = frame[..., 0] * tangent[:, 0:1] + frame[..., 1] * tangent[:, 1:2] \
            + frame[..., 2] * tangent[:, 2:3]
        n = torch.where((nm >= 0)[:, None], mapped, n)
    diffuse = sample_maps(sc, torch.where(has_uv, sc.mat_texture[mat], -1), uv, True,
                          m["diffuse"])
    color = sc.ambient[None, :] * diffuse
    t_eps = torch.clamp(EPS_REL * length(point), min=EPS)
    spec_possible = torch.amax(m["specular"], dim=-1) > 0.0
    view = -rays.d
    for li in range(sc.light_pos.shape[0]):
        to_light = sc.light_pos[li] - point
        dist = length(to_light)
        ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]
        c0, c1, c2 = sc.light_falloff[li]
        attn = c0 + c1 * dist + c2 * dist * dist
        nl = torch.clamp(dot(n, ldir), min=0.0)
        nh_raw = dot(n, unit(view + ldir))
        spec_on = (nh_raw > 0.0) | (m["shininess"] == 0.0)
        nh = torch.where(spec_on, torch.clamp(nh_raw, min=1e-20) ** (4.0 * m["shininess"]), 0.0)
        lc = sc.light_color[li][None, :]
        contrib = (diffuse * lc * nl[:, None] + m["specular"] * lc * nh[:, None]) / attn[:, None]
        need = (nl > 0.0) | (spec_possible & spec_on)
        blocked = occluded(sc, point, ldir, t_eps, node, need)
        color = color + torch.where(blocked[:, None], 0.0, contrib)
    acc = acc.index_add(0, rays.pix, rays.w[:, None] * color)

    d = rays.d
    r_dir = d - 2.0 * dot(d, n)[:, None] * n
    t_dir, reflected, refracted = shares(d, n, m["reflectivity"], m["refraction_index"])
    w_refl, w_refr = rays.w * reflected, rays.w * refracted
    if r == MAX_DEPTH:
        return acc.index_add(0, rays.pix, (w_refl + w_refr)[:, None] * bg[rays.pix]), None
    glossy = m["glossy_side_length"]
    if bool((glossy > 0.0).any()):
        along_z = (torch.abs(r_dir[:, 0]) < EPS) & (torch.abs(r_dir[:, 1]) < EPS)
        off = torch.stack([torch.zeros_like(glossy), torch.where(along_z, 0.1, 0.0),
                           torch.where(along_z, 0.0, 0.1)], dim=-1).to(dt)
        u_axis = cross(r_dir, r_dir + off)
        v_axis = cross(r_dir, u_axis)
        g = _glossy_uniform(rays.tkey, r, rays.sid).to(dt)
        g_dir = r_dir + ((g[:, 0] - 0.5) * glossy)[:, None] * u_axis \
            + ((g[:, 1] - 0.5) * glossy)[:, None] * v_axis
        r_dir = torch.where((glossy > 0.0)[:, None], g_dir, r_dir)
    two = lambda a, b: torch.cat([a, b])
    children = Rays(two(point, point), two(unit(r_dir), unit(t_dir)), two(w_refl, w_refr),
                    two(rays.pix, rays.pix), two(t_eps, t_eps), two(node, node),
                    two(2 * rays.sid, 2 * rays.sid + 1), two(rays.tkey, rays.tkey))
    return acc, children.take(children.w > 0.0)


def trace(sc: Tables, rays: Rays, n_pix: int, bg):
    """Radiance sums [n_pix, 3] of `rays` through every round."""
    acc = torch.zeros((n_pix, 3), dtype=rays.o.dtype, device=rays.o.device)
    for r in range(MAX_DEPTH + 1):
        acc, rays = shade_round(sc, rays, r, acc, bg)
        if rays is None or rays.w.numel() == 0:
            break
    return acc


def render_u8(data: dict, sc: Tables, seed: int, spp: int, *, tile: int = 128,
              launch: int = 131072, max_lanes: int = 1 << 22):
    """The frame [H, W, 3] u8, its samples the first family's (render.py's
    render_u8): chunks of `tile` x `tile` pixels x `launch // tile^2`
    samples, keyed by tile origin and chunk index.  Chunks go together
    while their primary lanes fit in `max_lanes`."""
    W, H = sc.width, sc.height
    dev, dt = sc.eye.device, sc.dtype
    th, tw, per, n_chunks = chunking(W, H, spp, tile, launch)
    base = tf.key(seed, dev)
    lane = torch.arange(th * tw * per, dtype=torch.int64, device=dev)
    tpx, s_in = lane // per, lane % per
    row, col = tpx // tw, tpx % tw
    bg = background(data, sc, torch.arange(H * W, device=dev) % W,
                    torch.arange(H * W, device=dev) // W)
    acc = torch.zeros((H * W, 3), dtype=dt, device=dev)
    jobs = [(x0, y0, ci) for y0 in range(0, H, th) for x0 in range(0, W, tw)
            for ci in range(n_chunks)]
    group = max(1, max_lanes // lane.numel())
    for j0 in range(0, len(jobs), group):
        parts = []
        for x0, y0, ci in jobs[j0:j0 + group]:
            px, py = col + x0, row + y0
            keep = (px < W) & (py < H) & (s_in + ci * per < spp)
            ckey = tf.fold(tf.fold(tf.fold(base, x0), y0), ci)
            jit = tf.uniform_at(tf.fold(ckey, 0), torch.stack([2 * lane, 2 * lane + 1], -1))
            tkey = tf.fold(ckey, 1).expand(lane.numel(), 2)
            parts.append([x[keep] for x in (px.to(torch.float32) + jit[:, 0],
                                             py.to(torch.float32) + jit[:, 1],
                                             py * W + px, lane, tkey)])
        xs, ys, pix, sid, tkey = (torch.cat(c) for c in zip(*parts))
        o, d = camera_rays(sc, xs, ys)
        n = xs.numel()
        rays = Rays(o, d, torch.ones((n,), dtype=dt, device=dev), pix,
                    torch.full((n,), EPS, dtype=dt, device=dev),
                    torch.full((n,), -1, dtype=torch.int64, device=dev), sid, tkey)
        acc = acc + trace(sc, rays, H * W, bg)
    return encode(acc / spp).reshape(H, W, 3)


def reference_frame(data: dict, traffic: dict, seed: int, device, dtype=torch.float32):
    """The frame of a cell of this family ([H, W, 3] u8): `data`'s tables in
    `dtype`, the samples of `traffic`'s spp, tile and rays a launch."""
    return render_u8(data, tables(data, device, dtype), seed, traffic["spp"],
                     tile=traffic["tile"], launch=traffic["launch_rays"])


def numbers(record: dict) -> dict:
    """The program's dropped throughput: the largest share of a chunk's
    primary rays' throughput that queue overflow ended, over the frame
    counted after the window (0 where no child was dropped)."""
    return {"dropped_w": max(s.dropped_w for s in record["stats"])}
