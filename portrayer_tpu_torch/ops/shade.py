"""Shading (counterpart of ``portrayer_tpu/ops/shade.py``).

Ambient + per light [Lambert diffuse + Blinn-Phong specular with the 4x
shininess compensation (material.rs:196-204)] / attenuation, with the
occlusion deferred: ``shade_pre`` returns the per-light contributions,
directions and shadow-need masks, and the trace loop resolves all lights'
shadow rays in one any-hit launch.  ``shade_hits`` is the one-shot form
(``shade_pre``, one ``occluded`` launch over every light, ``apply_lights``)
that the JAX package keeps for tests and tools; the trace loop does not use
it.  An area light is sampled at one point
of its parallelogram per lane (per-sample-id draws).  Image and
procedural textures override the diffuse colour, a normal map the shading
normal (in the primitive's local tangent frame, as the reference leaves
it).  Children are the reflect and refract rays with their throughput
multipliers (material.rs:216-317): mirror and glossy reflection and
Schlick/TIR refraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import math3d as m3
from .. import rng
from ..config import RenderConfig
from ..scene.flatten import SceneTables
from .intersect import Hit, HitDetail, _vec, occluded


def _uniform(key, site: int, sid, n: int):
    """[R, n] f32 uniforms keyed per (site, sample id): a lane's draws do
    not depend on the batch it is in, so slicing a queue to its live head
    or compacting it moves no pixel (shade.py ``_uniform``); on the card one
    launch of the threefry kernel (rng.draw_lanes)."""
    return rng.draw_lanes(key, site, sid, n)


def sample_atlas(data, meta, tex_ix, uv, srgb: bool = True):
    """Nearest-neighbour, euclidean-wraparound atlas sampling
    (src/texture.rs:104-141): x = trunc(u*(w-1)) rem_euclid w, the same
    for y; texels [R,3] as c/255, then c^2.2 for sRGB (texture.rs:162-168).
    data: [P,3] uint8; meta: [K,3] int32 (offset, w, h); tex_ix: [R]."""
    m = meta[torch.clamp(tex_ix, min=0).long()]
    off, w, h = m[..., 0], m[..., 1], m[..., 2]
    x = torch.trunc(uv[..., 0] * (w - 1).to(uv.dtype)).to(torch.int32)
    y = torch.trunc(uv[..., 1] * (h - 1).to(uv.dtype)).to(torch.int32)
    # jnp.mod: the remainder takes the divisor's sign (torch.remainder,
    # not torch.fmod).
    x = torch.remainder(x, torch.clamp(w, min=1))
    y = torch.remainder(y, torch.clamp(h, min=1))
    idx = off.long() + y.long() * w.long() + x.long()
    texel = data[idx].to(uv.dtype) * (1.0 / 255.0)
    if srgb:
        texel = texel ** 2.2
    return texel


def _apply_uv_trans(uvt6, uv):
    """uv' = (uv_trans @ (u, v, 1)).xy (material.rs:113-117); uvt6 [R,6] is
    the first two rows of the 3x3 transform (node record cols 25..30)."""
    u = uvt6[..., 0] * uv[..., 0] + uvt6[..., 1] * uv[..., 1] + uvt6[..., 2]
    v = uvt6[..., 3] * uv[..., 0] + uvt6[..., 4] * uv[..., 1] + uvt6[..., 5]
    return torch.stack([u, v], dim=-1)


def _decode_normal_map(texel):
    """RGB -> right-handed tangent-space normal (texture.rs:192-221): the
    left-handed (2r-1, 2g-1, -(2b-1)), then (nx, ny, nz) -> (nx, -nz, -ny)."""
    nx = 2.0 * texel[..., 0] - 1.0
    ny = 2.0 * texel[..., 1] - 1.0
    nz = -(2.0 * texel[..., 2] - 1.0)
    return torch.stack([nx, -nz, -ny], dim=-1)


class Children(NamedTuple):
    origin: torch.Tensor     # [R,3]
    refl_dir: torch.Tensor   # [R,3]
    refl_mult: torch.Tensor  # [R] throughput multiplier
    refr_dir: torch.Tensor   # [R,3]
    refr_mult: torch.Tensor  # [R]


class ShadePre(NamedTuple):
    """Occlusion-independent shading results (deferred lighting)."""
    base: torch.Tensor           # [R,3] ambient term
    light_contrib: torch.Tensor  # [L,R,3] per-light (diffuse+spec)/attn
    shadow_dir: torch.Tensor     # [L,R,3] unit dirs to the lights
    shadow_need: torch.Tensor    # [L,R] bool: lanes whose contribution != 0
    t_eps: torch.Tensor          # [R] secondary-ray start offsets


def shade_pre(d, hit: Hit, det: HitDetail, st: SceneTables, cfg: RenderConfig, key, active,
              sid=None):
    """Occlusion-independent shading: returns (ShadePre, Children).  `key`
    seeds the glossy and area-light draws, per sample id `sid` [R]
    (default: lane index)."""
    R = d.shape[0]
    if sid is None:
        sid = torch.arange(R, dtype=torch.int32, device=d.device)
    p = det.point
    rec = det.rec
    mat_diffuse = rec[:, 12:15]
    mat_specular = rec[:, 15:18]
    mat_shininess = rec[:, 18]

    view = -d
    n = m3.normalize(det.normal, eps=1e-30)
    # Scenes without textures or normal maps skip this block entirely.
    if st.any_normal_map or st.any_image_tex or st.fn_textures:
        uv = _apply_uv_trans(rec[:, 25:31], det.uv)
        mat_tex = rec[:, 22].to(torch.int32)
    if st.any_normal_map:
        mat_nm = rec[:, 23].to(torch.int32)
        use_nm = (mat_nm >= 0) & det.has_nmt & det.has_uv
        nm_vec = m3.normalize(_decode_normal_map(
            sample_atlas(st.nm_data, st.nm_meta, mat_nm, uv, srgb=False)), eps=1e-30)
        n = torch.where(use_nm[..., None], m3.matvec3(det.nmt, nm_vec), n)
    # Diffuse colour: texture override (material.rs:137-143).
    if st.any_image_tex:
        texel = sample_atlas(st.tex_data, st.tex_meta, mat_tex, uv)
        mat_diffuse = torch.where((mat_tex >= 0)[..., None], texel, mat_diffuse)
    for fi, fn in enumerate(st.fn_textures):
        mat_diffuse = torch.where((mat_tex == -(fi + 2))[..., None], fn(uv).to(d.dtype),
                                  mat_diffuse)
    color = st.ambient[None, :] * mat_diffuse

    # Secondary-ray start offset: EPSILON plus a relative term for f32
    # robustness on large scenes (the reference is f64 with plain EPSILON).
    if cfg.eps_rel:
        t_eps = torch.clamp(cfg.eps_rel * m3.norm(p, eps=1e-20), min=cfg.epsilon)
    else:
        t_eps = torch.full((R,), cfg.epsilon, dtype=d.dtype, device=d.device)

    # A shadow ray matters only where the light can contribute: diffuse
    # needs n.l > 0; specular needs a specular material and n.h > 0, or
    # shininess 0 (x^0 == 1 even for n.h <= 0).
    spec_possible = torch.amax(mat_specular, dim=-1) > 0.0
    dirs, contribs, needs = [], [], []
    for li in range(st.n_lights):
        lpos = st.light_pos[li]
        lcol = st.light_color[li]
        c0, c1, c2 = st.light_falloff[li]
        if st.area_flags[li]:  # one point of the parallelogram per lane
            ab = _uniform(key, 1000 + 2 * li, sid, 2) * 2.0 - 1.0
            lpos = lpos + ab[:, :1] * st.light_area_a[li] + ab[:, 1:] * st.light_area_b[li]
        hit_to_light = lpos - p
        light_dist = m3.norm(hit_to_light, eps=1e-20)
        ldir = hit_to_light / torch.clamp(light_dist, min=1e-30)[..., None]
        dirs.append(ldir)
        attn = c0 + c1 * light_dist + c2 * light_dist * light_dist
        nl = torch.clamp(m3.dot(n, ldir), min=0.0)
        diffuse = mat_diffuse * lcol[None, :] * nl[..., None]
        half = m3.normalize(view + ldir, eps=1e-30)
        nh_raw = m3.dot(n, half)
        # max(n.h, 0)^(4s) is exactly 0 for n.h <= 0 when s > 0.
        spec_on = (nh_raw > 0.0) | (mat_shininess == 0.0)
        nh = torch.where(spec_on, torch.clamp(nh_raw, min=1e-20) ** (4.0 * mat_shininess),
                         0.0)
        specular = mat_specular * lcol[None, :] * nh[..., None]
        contribs.append((diffuse + specular) / attn[..., None])
        needs.append((nl > 0.0) | (spec_possible & spec_on))
    if st.n_lights:
        shadow_dir = torch.stack(dirs)
        light_contrib = torch.stack(contribs)
        shadow_need = torch.stack(needs) & active[None]
    else:
        shadow_dir = torch.zeros((0, R, 3), dtype=d.dtype, device=d.device)
        light_contrib = torch.zeros((0, R, 3), dtype=d.dtype, device=d.device)
        shadow_need = torch.zeros((0, R), dtype=torch.bool, device=d.device)

    pre = ShadePre(base=color, light_contrib=light_contrib, shadow_dir=shadow_dir,
                   shadow_need=shadow_need, t_eps=t_eps)
    zeros = torch.zeros((R,), dtype=d.dtype, device=d.device)
    if not st.any_reflective:
        return pre, Children(origin=p, refl_dir=d, refl_mult=zeros, refr_dir=d,
                             refr_mult=zeros)
    mat_reflect = rec[:, 19]
    mat_glossy = rec[:, 20]
    mat_refr = rec[:, 21]
    dn = m3.dot(d, n)
    reflect_dir = d - 2.0 * dn[..., None] * n

    if st.any_glossy:  # glossy perturbation (material.rs:221-239)
        aligned_z = ((torch.abs(reflect_dir[..., 0]) < cfg.epsilon)
                     & (torch.abs(reflect_dir[..., 1]) < cfg.epsilon))
        offset = reflect_dir + torch.where(aligned_z[..., None],
                                           _vec([0.0, 0.1, 0.0], d), _vec([0.0, 0.0, 0.1], d))
        u_basis = m3.cross(reflect_dir, offset)
        v_basis = m3.cross(reflect_dir, u_basis)
        uvc = _uniform(key, 2000, sid, 2)
        u_coord = (-0.5 + uvc[:, 0]) * mat_glossy
        v_coord = (-0.5 + uvc[:, 1]) * mat_glossy
        glossy_dir = reflect_dir + u_coord[..., None] * u_basis + v_coord[..., None] * v_basis
        reflect_dir = torch.where((mat_glossy > 0.0)[..., None], glossy_dir, reflect_dir)

    if st.any_refractive:
        is_dielectric = mat_refr > 0.0
        eta = torch.where(is_dielectric, mat_refr, 1.0)
        entering = dn < 0.0
        # Entering (material.rs:253-264): refract(d, n, eta), outside 1.
        under_e = 1.0 - (1.0 - dn * dn) / (eta * eta)
        refr_e = (d - n * dn[..., None]) / eta[..., None] - n * m3.safe_sqrt(under_e)[..., None]
        # Exiting (material.rs:265-275): refract(d, -n, 1/eta), maybe TIR.
        under_x = 1.0 - (1.0 - dn * dn) * (eta * eta)
        tir = under_x < 0.0
        refr_x = (d - n * dn[..., None]) * eta[..., None] + n * m3.safe_sqrt(under_x)[..., None]
        refr_dir = torch.where(entering[..., None], refr_e, refr_x)
        cos_inc = torch.where(entering, -dn, m3.dot(refr_x, n))
        # Integer powers as products, in the order of XLA's integer_pow.
        r0 = (eta - 1.0) / (eta + 1.0)
        r0 = r0 * r0
        om = 1.0 - cos_inc
        om2 = om * om
        schlick = r0 + (1.0 - r0) * (om * (om2 * om2))
        tir_exit = ~entering & tir
        refl_mult = torch.where(is_dielectric,
                                torch.where(tir_exit, mat_reflect, mat_reflect * schlick),
                                mat_reflect)
        refr_mult = torch.where(is_dielectric & ~tir_exit, mat_reflect * (1.0 - schlick), 0.0)
    else:
        refl_mult = mat_reflect
        refr_mult = zeros
        refr_dir = d

    live = (mat_reflect > 0.0) & active
    return pre, Children(origin=p, refl_dir=m3.normalize(reflect_dir, eps=1e-30),
                         refl_mult=torch.where(live, refl_mult, 0.0),
                         refr_dir=m3.normalize(refr_dir, eps=1e-30),
                         refr_mult=torch.where(live, refr_mult, 0.0))


def shade_hits(d, hit: Hit, det: HitDetail, st: SceneTables, cfg: RenderConfig, key, active):
    """(local colour [R,3], Children, t_eps [R]) with the occlusion resolved
    here: one ``occluded`` launch over the L x R shadow rays (the lights
    tiled along the batch; with ``accel="cuda"`` the any-hit kernel on the
    card), then ``apply_lights``."""
    pre, children = shade_pre(d, hit, det, st, cfg, key, active)
    L, R = st.n_lights, d.shape[0]
    if not L:
        return torch.where(active[..., None], pre.base, 0.0), children, pre.t_eps
    tile = lambda x: x.repeat((L,) + (1,) * (x.dim() - 1))
    occ = occluded(tile(det.point), pre.shadow_dir.reshape(L * R, 3), tile(pre.t_eps),
                   float("inf"), st, cfg, active=tile(active) & pre.shadow_need.reshape(L * R),
                   src_node=tile(hit.node), src_tri=tile(hit.tri)).reshape(L, R)
    return apply_lights(pre, occ, active), children, pre.t_eps


def apply_lights(pre: ShadePre, occ, active):
    """base + the sum over lights of the unoccluded light_contrib, 0 on
    inactive lanes; occ [L,R] bool."""
    color = pre.base
    for li in range(pre.light_contrib.shape[0]):
        color = color + (~occ[li])[..., None].to(color.dtype) * pre.light_contrib[li]
    return torch.where(active[..., None], color, 0.0)
