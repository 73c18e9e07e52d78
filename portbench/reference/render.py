"""The plain reference renderer: the upstream's Whitted ray tracer
(src/render.rs, src/ray.rs, src/material.rs) over flat batches of rays,
brute force over every node, in plain PyTorch.

Per primary sample it traces the camera ray; at a hit it adds the ambient
term and, per light that no node occludes (a shadow ray over the whole
unbounded line past the hit, as the upstream casts it), Lambert diffuse
plus Blinn-Phong specular with the 4x shininess; a reflective material
spawns a reflected ray of throughput `reflectivity`, jittered on a
`glossy_side_length` square where that is > 0.  A miss adds the
background; at depth 10 a reflected ray ends in the background.  The
frame is the mean of the samples, gamma 1/2.2, truncated to u8.

The samples are the program's by specification, not by its code: pixel
tiles of `tile` x `tile`, `launch // tile^2` samples a chunk (at most the
frame's), the chunk's key folded from the seed with its tile origin and
chunk index, the jitter `uniform(fold(ckey, 0))` at the lane's flat
position, round r's draws keyed by `fold(fold(ckey, 1), r)` and the
lane's sample id (the lane index, then 2 * id for a reflected ray).
Secondary rays start at max(eps, 3e-4 |p|) and, on the node they leave,
past 2e-3 of its local units.

Selection (which node a ray hits, whether a shadow ray is blocked) takes
no gradient; the winner's t, the hit point, normal and shading are
computed again from the tables, differentiable in them.
"""

from __future__ import annotations

import math

import torch

from . import threefry as tf
from .scene import BACKGROUNDS, KINDS, Tables, tables

EPS = 1e-5          # the upstream's EPSILON
EPS_REL = 3e-4      # secondary ray start, relative to |p|
SELF_EPS = 2e-3     # start on the node a ray leaves, in its local units
MAX_DEPTH = 10
GAMMA = 2.2
INF = math.inf
GLOSSY_SITE = 2000  # the fold of a round key that keys the glossy jitter


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def length(v, floor=1.2e-38):
    return torch.sqrt(torch.clamp(dot(v, v), min=floor))


def unit(v):
    return v / length(v)[..., None]


def affine(m, p, point=True):
    """m [..., 3, 4] applied to p [..., 3]."""
    out = m[..., :, 0] * p[..., None, 0] + m[..., :, 1] * p[..., None, 1] \
        + m[..., :, 2] * p[..., None, 2]
    return out + m[..., :, 3] if point else out


# ---------------------------------------------------------------------------
# Candidates in a node's frame: t in [t_min, t_max), inf where none.
# ---------------------------------------------------------------------------

def _div(n, d):
    ok = d != 0.0
    return torch.where(ok, n / torch.where(ok, d, torch.ones_like(d)), INF)


def _finite(t):
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _first_root(a, b, c, t_min, t_max):
    """The smaller root of a t^2 + b t + c if it is in range, else the
    larger if that is; the linear root where a == 0.  inf where none."""
    disc = b * b - 4.0 * a * c
    sq = torch.where(disc > 0.0, torch.sqrt(torch.clamp(disc, min=1e-30)), 0.0)
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    ra = _div(q, torch.where(a == 0.0, 0.0, a))
    rb = torch.where(q == 0.0, _div(-b, 2.0 * a), _div(c, q))
    lo, hi = torch.minimum(ra, rb), torch.maximum(ra, rb)
    ok_quad = (a != 0.0) & (disc >= 0.0)
    lo = torch.where(a == 0.0, _div(-c, b), torch.where(ok_quad, lo, INF))
    hi = torch.where(a == 0.0, INF, torch.where(ok_quad, hi, INF))
    inr = lambda t: (t >= t_min) & (t < t_max)
    return torch.where(inr(lo), lo, torch.where(inr(hi), hi, INF))


def sphere_t(o, d, t_min, t_max):
    return _first_root(dot(d, d), 2.0 * dot(o, d), dot(o, o) - 1.0, t_min, t_max)


_FACES = ((0, 0.5), (0, -0.5), (1, 0.5), (1, -0.5), (2, 0.5), (2, -0.5))


def cube_faces(o, d, t_min, t_max):
    """(t, face): the nearest face of [-0.5, 0.5]^3 in range whose square
    holds the point (to 0.5 + eps); the first face in _FACES on a tie."""
    best_t = torch.full(o.shape[:-1], INF, dtype=o.dtype, device=o.device)
    best_f = torch.full(o.shape[:-1], -1, dtype=torch.int64, device=o.device)
    for f, (ax, h) in enumerate(_FACES):
        s = 1.0 if h > 0 else -1.0
        t = _div(-(o[..., ax] - h) * s, d[..., ax] * s)
        p = o + _finite(t)[..., None] * d
        inside = torch.ones_like(t, dtype=torch.bool)
        for other in range(3):
            if other != ax:
                inside = inside & (torch.abs(p[..., other]) <= 0.5 + EPS)
        better = (t >= t_min) & (t < t_max) & inside & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_f = torch.where(better, f, best_f)
    return best_t, best_f


def _disc_cap(o, d, y, t_min, t_max):
    t = _div(y - o[..., 1], d[..., 1])
    px = o[..., 0] + _finite(t) * d[..., 0]
    pz = o[..., 2] + _finite(t) * d[..., 2]
    ok = (t >= t_min) & (t < t_max) & ~(px * px + pz * pz > 0.25)
    return torch.where(ok, t, INF)


def _in_height(o, d, t):
    y = o[..., 1] + _finite(t) * d[..., 1]
    return torch.where(~(y > 0.5) & ~(y < -0.5), t, INF)


def cylinder_parts(o, d, t_min, t_max):
    """(body, top cap, bottom cap) t; the body's first root in range only."""
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    c = o[..., 0] ** 2 + o[..., 2] ** 2 - 0.25
    body = _in_height(o, d, _first_root(a, b, c, t_min, t_max))
    return body, _disc_cap(o, d, 0.5, t_min, t_max), _disc_cap(o, d, -0.5, t_min, t_max)


def cone_parts(o, d, t_min, t_max):
    """(body, base cap) t: x^2 + z^2 = (0.5 - y)^2 / 4, scaled by -4."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dy * dy - 4.0 * (dx * dx + dz * dz)
    b = -8.0 * (dx * ox + dz * oz) - dy * (1.0 - 2.0 * oy)
    c = -4.0 * (ox * ox + oz * oz) + 0.25 * (1.0 - 2.0 * oy) ** 2
    body = _in_height(o, d, _first_root(a, b, c, t_min, t_max))
    return body, _disc_cap(o, d, -0.5, t_min, t_max)


def candidate(kind: str, o, d, t_min, t_max):
    if kind == "sphere":
        return sphere_t(o, d, t_min, t_max)
    if kind == "cube":
        return cube_faces(o, d, t_min, t_max)[0]
    if kind == "cylinder":
        body, top, bot = cylinder_parts(o, d, t_min, t_max)
        t = torch.where(top < body, top, body)
        return torch.where(bot < t, bot, t)
    body, cap = cone_parts(o, d, t_min, t_max)
    return torch.where(cap < body, cap, body)


def local_normal(kind: str, o, d, t_min, t_max, p):
    """The outward normal (not unit) at local point p of the part hit."""
    if kind == "sphere":
        return p
    zero, one = torch.zeros_like(p[..., 0]), torch.ones_like(p[..., 0])
    if kind == "cube":
        face = cube_faces(o, d, t_min, t_max)[1].clamp(min=0)
        axis = torch.tensor([f[0] for f in _FACES], device=p.device)[face]
        sign = torch.tensor([1.0 if f[1] > 0 else -1.0 for f in _FACES], dtype=p.dtype,
                            device=p.device)[face]
        return torch.stack([torch.where(axis == k, sign, zero) for k in range(3)], dim=-1)
    if kind == "cylinder":
        body, top, bot = cylinder_parts(o, d, t_min, t_max)
        side = torch.stack([p[..., 0], zero, p[..., 2]], dim=-1)
        cap_y = torch.where(bot < torch.minimum(body, top), -one,
                            torch.where(top < body, one, zero))
        return torch.where((cap_y != 0.0)[..., None],
                           torch.stack([zero, cap_y, zero], dim=-1), side)
    body, cap = cone_parts(o, d, t_min, t_max)
    # The gradient of x^2 + z^2 - (0.5 - y)^2 / 4: outward on the side.
    side = torch.stack([2.0 * p[..., 0], 0.5 * (0.5 - p[..., 1]), 2.0 * p[..., 2]], dim=-1)
    return torch.where((cap < body)[..., None], torch.stack([zero, -one, zero], dim=-1), side)


# ---------------------------------------------------------------------------
# Selection over every node (no gradient).
# ---------------------------------------------------------------------------

def _start(t_min, ld, is_src):
    raised = torch.maximum(t_min, SELF_EPS / torch.clamp(length(ld), min=1e-30))
    return torch.where(is_src, raised, t_min)


@torch.no_grad()
def nearest(sc: Tables, o, d, t_min, src, block: int = 1 << 24):
    """(t, node): each ray's nearest hit over every node, node -1 on a miss.
    Rays go in blocks of about `block` ray-node pairs."""
    inv = sc.params["inv"].detach()
    R = o.shape[0]
    best_t = torch.full((R,), INF, dtype=o.dtype, device=o.device)
    best_n = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    for kind, ids in sc.kind_nodes.items():
        step = max(1, block // max(1, ids.numel()))
        m = inv[ids][None]
        for r0 in range(0, R, step):
            sl = slice(r0, r0 + step)
            lo = affine(m, o[sl, None, :])
            ld = affine(m, d[sl, None, :], point=False)
            tm = _start(t_min[sl, None], ld, ids[None, :] == src[sl, None])
            t = candidate(kind, lo, ld, tm, INF)
            tk, j = torch.min(t, dim=1)
            better = tk < best_t[sl]
            best_n[sl] = torch.where(better, ids[j], best_n[sl])
            best_t[sl] = torch.where(better, tk, best_t[sl])
    return best_t, torch.where(torch.isfinite(best_t), best_n, -1)


# ---------------------------------------------------------------------------
# One round of rays: hit, shading, shadows, children.
# ---------------------------------------------------------------------------

class Rays:
    """A batch of live rays: origin, direction, throughput, pixel, start
    t, the node each left (-1 for camera rays), its sample id and the key
    of its chunk's trace ([R, 2])."""

    def __init__(self, o, d, w, pix, t_min, src, sid, tkey):
        self.o, self.d, self.w, self.pix = o, d, w, pix
        self.t_min, self.src, self.sid, self.tkey = t_min, src, sid, tkey

    def take(self, keep):
        return Rays(*(x[keep] for x in (self.o, self.d, self.w, self.pix, self.t_min,
                                         self.src, self.sid, self.tkey)))


def _glossy_uniform(tkey, r: int, sid):
    """The two glossy draws of lane `sid` in round r: [R, 2] float32."""
    k = tf.fold(tf.fold(tf.fold(tkey, r), GLOSSY_SITE), sid)
    n = torch.arange(2, dtype=torch.int64, device=sid.device)
    return tf.uniform_at(k[:, None, :], n[None, :])


def shade_round(sc: Tables, rays: Rays, r: int, acc, bg):
    """Round r over `rays`: returns (acc, the reflected rays or None)."""
    p_ = sc.params
    dt = rays.o.dtype
    t_sel, node = nearest(sc, rays.o, rays.d, rays.t_min, rays.src)
    hit = node >= 0
    miss = ~hit
    acc = acc.index_add(0, rays.pix[miss], rays.w[miss, None] * bg[rays.pix[miss]])
    rays, t_sel, node = rays.take(hit), t_sel[hit], node[hit]
    if node.numel() == 0:
        return acc, None
    inv = p_["inv"][node]
    lo = affine(inv, rays.o)
    ld = affine(inv, rays.d, point=False)
    tm = _start(rays.t_min, ld, node == rays.src)
    kind = sc.node_kind[node]
    t = torch.full_like(t_sel, INF)
    for code, name in enumerate(KINDS):
        if name in sc.kind_nodes:
            t = torch.where(kind == code, candidate(name, lo, ld, tm, INF), t)
    t = torch.where(torch.isfinite(t), t, t_sel)
    p_local = lo + t[:, None] * ld
    n_local = torch.zeros_like(lo)
    for code, name in enumerate(KINDS):
        if name in sc.kind_nodes:
            n_local = torch.where((kind == code)[:, None],
                                  local_normal(name, lo, ld, tm, INF, p_local), n_local)
    point = rays.o + t[:, None] * rays.d
    # World normal: the transposed linear part of world -> local.
    n = unit(inv[:, 0, :3] * n_local[:, 0:1] + inv[:, 1, :3] * n_local[:, 1:2]
             + inv[:, 2, :3] * n_local[:, 2:3])
    mat = sc.node_material[node]
    diffuse = p_["mat_diffuse"][mat]
    specular = p_["mat_specular"][mat]
    shininess = p_["mat_shininess"][mat]
    w = rays.w
    color = p_["ambient"][None, :] * diffuse
    t_eps = torch.clamp(EPS_REL * length(point), min=EPS)
    spec_possible = torch.amax(specular, dim=-1) > 0.0
    view = -rays.d
    for li in range(p_["light_pos"].shape[0]):
        to_light = p_["light_pos"][li] - point
        dist = length(to_light)
        ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]
        nl = torch.clamp(dot(n, ldir), min=0.0)
        half = unit(view + ldir)
        nh_raw = dot(n, half)
        spec_on = (nh_raw > 0.0) | (shininess == 0.0)
        nh = torch.where(spec_on, torch.clamp(nh_raw, min=1e-20) ** (4.0 * shininess), 0.0)
        lc = p_["light_color"][li][None, :]
        contrib = diffuse * lc * nl[:, None] + specular * lc * nh[:, None]
        need = (nl > 0.0) | (spec_possible & spec_on)
        blocked = occluded(sc, point.detach(), ldir.detach(), t_eps.detach(), node, need)
        color = color + torch.where(blocked[:, None], 0.0, contrib)
    acc = acc.index_add(0, rays.pix, w[:, None] * color)
    if not sc.reflective:
        return acc, None
    refl = p_["mat_reflectivity"][mat]
    live = refl > 0.0
    w_child = torch.where(live, w * refl, 0.0)
    if r == MAX_DEPTH:
        return acc.index_add(0, rays.pix, w_child[:, None] * bg[rays.pix]), None
    d = rays.d
    r_dir = d - 2.0 * dot(d, n)[:, None] * n
    glossy = sc.mat_glossy[mat]
    if bool((glossy > 0.0).any()):
        along_z = (torch.abs(r_dir[:, 0]) < EPS) & (torch.abs(r_dir[:, 1]) < EPS)
        off = torch.stack([torch.zeros_like(glossy), torch.where(along_z, 0.1, 0.0),
                           torch.where(along_z, 0.0, 0.1)], dim=-1).to(dt)
        u_axis = cross(r_dir, r_dir + off)
        v_axis = cross(r_dir, u_axis)
        uv = _glossy_uniform(rays.tkey, r, rays.sid).to(dt)
        g_dir = r_dir + ((uv[:, 0] - 0.5) * glossy)[:, None] * u_axis \
            + ((uv[:, 1] - 0.5) * glossy)[:, None] * v_axis
        r_dir = torch.where((glossy > 0.0)[:, None], g_dir, r_dir)
    child = Rays(point, unit(r_dir), w_child, rays.pix, t_eps, node, 2 * rays.sid, rays.tkey)
    return acc, child.take(live)


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


def trace(sc: Tables, rays: Rays, n_pix: int, bg):
    """Radiance sums [n_pix, 3] of `rays` through every round."""
    acc = torch.zeros((n_pix, 3), dtype=rays.o.dtype, device=rays.o.device)
    depth = MAX_DEPTH if sc.reflective else 0
    for r in range(depth + 1):
        acc, rays = shade_round(sc, rays, r, acc, bg)
        if rays is None or rays.w.numel() == 0:
            break
    return acc


# ---------------------------------------------------------------------------
# Camera rays and frames.
# ---------------------------------------------------------------------------

def camera_rays(sc: Tables, x, y):
    """Unit world rays through pixel positions x, y (float32 [R])."""
    dt = sc.dtype
    x, y = x.to(dt), y.to(dt)
    aspect = sc.width / sc.height
    vx = (2.0 * (x / sc.width) - 1.0) * aspect * sc.fov_factor
    vy = (1.0 - 2.0 * (y / sc.height)) * sc.fov_factor
    on_plane = torch.stack([vx, vy, -torch.ones_like(vx)], dim=-1)
    delta = affine(sc.cam34, on_plane) - sc.eye
    d = delta / torch.sqrt(dot(delta, delta))[:, None]
    return sc.eye.expand_as(d), d


def background(data: dict, sc: Tables, px, py):
    uv = torch.stack([px.to(sc.dtype) / sc.width, py.to(sc.dtype) / sc.height], dim=-1)
    return BACKGROUNDS[data["background"]](uv).to(sc.dtype)


def chunking(width: int, height: int, spp: int, tile: int, launch: int):
    """(tile height, tile width, samples a chunk, chunks a tile)."""
    th, tw = min(tile, height), min(tile, width)
    per = max(1, min(spp, launch // (th * tw)))
    return th, tw, per, -(-spp // per)


def render_u8(data: dict, sc: Tables, seed: int, spp: int, tiles=None, *, tile: int = 128,
              launch: int = 131072, max_lanes: int = 1 << 23):
    """The frame [H, W, 3] u8 (tiles not in `tiles`, a list of tile origins
    (x0, y0), left 0).  Chunks go together while their lanes fit in
    `max_lanes`."""
    W, H = sc.width, sc.height
    dev, dt = sc.eye.device, sc.dtype
    th, tw, per, n_chunks = chunking(W, H, spp, tile, launch)
    grid = [(x0, y0) for y0 in range(0, H, th) for x0 in range(0, W, tw)]
    if tiles is not None:
        grid = [g for g in grid if tuple(g) in {tuple(t) for t in tiles}]
    base = tf.key(seed, dev)
    # Lanes of one chunk, pixel-major: (tile pixel, sample in chunk).
    lane = torch.arange(th * tw * per, dtype=torch.int64, device=dev)
    tpx, s_in = lane // per, lane % per
    row, col = tpx // tw, tpx % tw
    acc = torch.zeros((H * W, 3), dtype=dt, device=dev)
    jobs = [(x0, y0, ci) for x0, y0 in grid for ci in range(n_chunks)]
    per_job = lane.numel()
    group = max(1, max_lanes // per_job)
    for j0 in range(0, len(jobs), group):
        parts = []
        for x0, y0, ci in jobs[j0:j0 + group]:
            px, py = col + x0, row + y0
            keep = (px < W) & (py < H) & (s_in + ci * per < spp)
            ckey = tf.fold(tf.fold(tf.fold(base, x0), y0), ci)
            jit = tf.uniform_at(tf.fold(ckey, 0), torch.stack([2 * lane, 2 * lane + 1], -1))
            xs = px.to(torch.float32) + jit[:, 0]
            ys = py.to(torch.float32) + jit[:, 1]
            tkey = tf.fold(ckey, 1).expand(lane.numel(), 2)
            parts.append([x[keep] for x in (xs, ys, py * W + px, lane, tkey)])
        xs, ys, pix, sid, tkey = (torch.cat(c) for c in zip(*parts))
        o, d = camera_rays(sc, xs, ys)
        n = xs.numel()
        rays = Rays(o, d, torch.ones((n,), dtype=dt, device=dev), pix,
                    torch.full((n,), EPS, dtype=dt, device=dev),
                    torch.full((n,), -1, dtype=torch.int64, device=dev), sid, tkey)
        bg = background(data, sc, torch.arange(H * W, device=dev) % W,
                        torch.arange(H * W, device=dev) // W)
        acc = acc + trace(sc, rays, H * W, bg)
    return encode(acc / spp).reshape(H, W, 3)


def reference_frame(data: dict, traffic: dict, seed: int, device, dtype=torch.float32):
    """The frame of a cell of this family ([H, W, 3] u8): `data`'s tables in
    `dtype`, the samples of `traffic`'s spp, tile and rays a launch."""
    return render_u8(data, tables(data, device, dtype), seed, traffic["spp"],
                     tile=traffic["tile"], launch=traffic["launch_rays"])


def encode(mean):
    """Gamma 1/2.2, clamped to [0, 1], truncated to u8."""
    enc = torch.clamp(torch.clamp(mean, min=0.0) ** (1.0 / GAMMA), 0.0, 1.0)
    return (enc * 255.0).to(torch.uint8)
