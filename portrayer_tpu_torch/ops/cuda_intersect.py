"""The packed-chunk sweep: hand-written CUDA kernel and its plain version
(counterpart of ``portrayer_tpu/ops/pallas_intersect.py``).

``intersect_scene_cuda`` has the contract of ``intersect_scene_pallas``:
nearest (t, node, tri) per ray over ``st.packed`` or, with ``any_hit``,
only whether an in-range hit exists.  On CUDA tensors it launches
``csrc/sweep.cu`` (built at first use) or raises; on CPU tensors it runs
``intersect_scene_sweep_ref``, the same computation in PyTorch ops: the
same per-ray chunk cull, the same branch formulas in the same op order,
and the same fold, in which ties go to the earlier (chunk, lane).
Unlike the TPU kernel's 2^-16 quantised key, t is exact f32.  Both select
only: they read rays without their graph (child rays carry the tables'
gradients) and return tensors without one, as the JAX package
``stop_gradient``s its sweeps.

The kernel culls in two levels: ``chunk_groups`` derives, from the packed
table alone, the boxes of groups of GROUP consecutive chunks and each
chunk's count of real lanes (``PackedPrims.groups`` keeps them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import counters
from ..config import RenderConfig
from ..scene.flatten import (
    SceneTables, PACK_CHUNK, SPHERE, PLANE, CUBE, CYLINDER, CONE, MESH, TORUS,
    PACKED_SPHERE_W, PACKED_AABOX,
)
from .intersect import Hit

INF = math.inf
# Chunks per group of the kernel's first cull level: one per lane of a warp.
GROUP = 32

# Kernel launches per mode, and plain-version calls on CUDA tensors; runs
# of graphs.Graph's conditional kernel and loop step kernel
# (csrc/conditional.cu); and the calls of the flat sweep and the beam
# sweep and the steps of the beam sweep's ordered loops (ops/intersect.py,
# ops/beam.py; counted on the device of their rays, captured or not, by
# count_on_device).  A caller zeroes them (reset_counts) before a run and
# reads them after it (counts()).  A launch recorded into a captured CUDA
# graph counts on the device, in the graph, where it runs: per device,
# [nearest, any-hit, conditional kernel, loop step kernel, flat sweeps,
# beam sweeps, beam steps].
_MODES = ("nearest", "any_hit", "graph_if", "graph_while", "flat_sweep", "beam_sweep",
          "beam_step")
_COUNTERS = counters.Group(_MODES, host_only=("plain_on_cuda",))
COUNTS = _COUNTERS.host
device_counts = _COUNTERS.on
count_on_device = _COUNTERS.add_on_device
reset_counts = _COUNTERS.reset
counts = _COUNTERS.read
# The counts of the sweeps, whichever the accel.
SWEEP_MODES = ("nearest", "any_hit", "flat_sweep", "beam_sweep", "beam_step")

# The kernel reads ray i's origin at o[3 * i + 2] with a 32-bit int: a
# launch of this many rays or more would overflow it.
MAX_LAUNCH_RAYS = (2 ** 31 - 1) // 3


def _f32(x: float) -> float:
    """x rounded to float32, so kernel and plain version see one value."""
    return float(np.float32(x))


def _rays(o, t_min, t_max, active):
    """t_min, t_max as [R] tensors (a number is filled in on the device:
    a tensor made from it would be copied from the host, which waits for
    the device) in the rays' dtype, and `active`, all true where None."""
    R = o.shape[0]

    def full(x):
        if isinstance(x, torch.Tensor) or np.ndim(x):
            return torch.as_tensor(x, dtype=o.dtype, device=o.device).expand(R)
        return torch.full((R,), float(x), dtype=o.dtype, device=o.device)

    if active is None:
        active = torch.ones(R, dtype=torch.bool, device=o.device)
    return full(t_min), full(t_max), active


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _smallest_root(a, b, c, t_min, t_max):
    """Smallest root of a t^2 + b t + c in [t_min, t_max) (sweep.cu)."""
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_q = torch.where(q == 0.0, 1.0, q)
    ra = torch.where(a == 0.0, INF, q / safe_a)
    rb = torch.where(q == 0.0, -b / (2.0 * safe_a), c / safe_q)
    r0 = torch.minimum(ra, rb)
    r1 = torch.maximum(ra, rb)
    safe_b = torch.where(b == 0.0, 1.0, b)
    lin = torch.where(b == 0.0, INF, -c / safe_b)
    quad_ok = (a != 0.0) & (disc >= 0.0)
    r0 = torch.where(a == 0.0, lin, torch.where(quad_ok, r0, INF))
    r1 = torch.where(a == 0.0, INF, torch.where(quad_ok, r1, INF))
    ok0 = (r0 >= t_min) & (r0 < t_max)
    ok1 = (r1 >= t_min) & (r1 < t_max)
    return torch.where(ok0, r0, torch.where(ok1, r1, INF))


def _gd(n, d):
    return torch.where(d != 0.0, n / d, INF)


def _in_range(t, t_min, t_max):
    return (t >= t_min) & (t < t_max)


_THIRD = _f32(1.0 / 3.0)
_RCP27 = _f32(1.0 / 27.0)


def _acos(x):
    """arccos by Abramowitz-Stegun 4.4.45 (|err| < 2e-7 on [-1, 1]), as the
    TPU kernel computes it; the quartic's Newton polish cleans it up."""
    ax = torch.clamp(torch.abs(x), 0.0, 1.0)
    p = torch.full_like(ax, _f32(-0.0012624911))
    for c in (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050):
        p = p * ax + _f32(c)
    r = p * torch.sqrt(1.0 - ax)
    return torch.where(x < 0.0, _f32(math.pi) - r, r)


def _cbrt(x):
    """Signed cube root through exp/log, as the TPU kernel computes it."""
    ax = torch.clamp(torch.abs(x), min=1e-30)
    r = torch.exp(torch.log(ax) * _THIRD)
    return torch.where(x == 0.0, 0.0, torch.sign(x) * r)


def _safe_rcp(dc):
    """1/d with |d| < 1e-30 replaced by +-1e-30 (the slab tests' guard)."""
    tiny = torch.where(dc < 0.0, -1e-30, 1e-30)
    return 1.0 / torch.where(torch.abs(dc) < 1e-30, tiny, dc)


class _Chunk:
    """One chunk's columns ([1,128] rows) against a subset of rays ([k,1])."""

    def __init__(self, pf_cols, node, ray, rcp, is_src, eps_r, self_eps):
        self.m = pf_cols
        self.node = node
        self.ox, self.oy, self.oz, self.dx, self.dy, self.dz, self.t_min, self.t_max = ray
        self.rdx, self.rdy, self.rdz = rcp
        self.is_src = is_src
        self.eps_r = eps_r
        self.self_eps = self_eps

    def row(self, r):
        return self.m[r:r + 1]

    def local_frame(self):
        m = [self.row(r) for r in range(12)]
        ox, oy, oz, dx, dy, dz = self.ox, self.oy, self.oz, self.dx, self.dy, self.dz
        return (m[0] * ox + m[1] * oy + m[2] * oz + m[3],
                m[4] * ox + m[5] * oy + m[6] * oz + m[7],
                m[8] * ox + m[9] * oy + m[10] * oz + m[11],
                m[0] * dx + m[1] * dy + m[2] * dz,
                m[4] * dx + m[5] * dy + m[6] * dz,
                m[8] * dx + m[9] * dy + m[10] * dz)

    def general_tmin(self, ld2):
        t_self = self.self_eps * (1.0 / torch.sqrt(torch.clamp(ld2, min=1e-30)))
        return torch.where(self.is_src, torch.maximum(self.t_min, t_self), self.t_min)

    def sphere_g(self):
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        a = ldx * ldx + ldy * ldy + ldz * ldz
        b = 2.0 * (lox * ldx + loy * ldy + loz * ldz)
        c = lox * lox + loy * loy + loz * loz - 1.0
        return _smallest_root(a, b, c, self.general_tmin(a), self.t_max)

    def plane_g(self):
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        t = _gd(-loy, ldy)
        px = lox + t * ldx
        pz = loz + t * ldz
        ld2 = ldx * ldx + ldy * ldy + ldz * ldz
        ok = (_in_range(t, self.general_tmin(ld2), self.t_max)
              & (torch.abs(px) <= self.eps_r) & (torch.abs(pz) <= self.eps_r))
        return torch.where(ok, t, INF)

    def cube_g(self):
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        ld2 = ldx * ldx + ldy * ldy + ldz * ldz
        t_min_e = self.general_tmin(ld2)
        o3, d3 = (lox, loy, loz), (ldx, ldy, ldz)
        best = None
        for axis, sign in ((0, 0.5), (0, -0.5), (1, 0.5), (1, -0.5), (2, 0.5), (2, -0.5)):
            sg = 1.0 if sign > 0 else -1.0
            t = _gd(-(o3[axis] - sign) * sg, d3[axis] * sg)
            p = (lox + t * ldx, loy + t * ldy, loz + t * ldz)
            contains = None
            for ax in range(3):
                if ax != axis:
                    c = torch.abs(p[ax]) <= self.eps_r
                    contains = c if contains is None else contains & c
            ok = _in_range(t, t_min_e, self.t_max) & contains
            if best is None:
                best = torch.where(ok, t, INF)
            else:
                best = torch.where(ok & (t < best), t, best)
        return best

    def cylinder_g(self):
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        R2 = 0.25
        a = ldx * ldx + ldz * ldz
        b = 2.0 * (lox * ldx + loz * ldz)
        c = lox * lox + loz * loz - R2
        ld2 = a + ldy * ldy
        t_min_e = self.general_tmin(ld2)
        t_body = _smallest_root(a, b, c, t_min_e, self.t_max)
        y = loy + t_body * ldy
        best = torch.where(~(y > 0.5) & ~(y < -0.5), t_body, INF)
        for h in (0.5, -0.5):
            t = _gd(h - loy, ldy)
            px = lox + t * ldx
            pz = loz + t * ldz
            ok = _in_range(t, t_min_e, self.t_max) & ~(px * px + pz * pz > R2)
            t = torch.where(ok, t, INF)
            best = torch.where(t < best, t, best)
        return best

    def cone_g(self):
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        r2 = 0.25
        a = 4.0 * ldy * ldy * r2 - 4.0 * (ldx * ldx + ldz * ldz)
        b = -8.0 * (ldx * lox + ldz * loz) - 1.0 * (ldy * 1.0 - 2.0 * ldy * loy)
        c = -4.0 * (lox * lox + loz * loz) + r2 * (1.0 - 4.0 * loy + 4.0 * loy * loy)
        ld2 = ldx * ldx + ldy * ldy + ldz * ldz
        t_min_e = self.general_tmin(ld2)
        t_body = _smallest_root(a, b, c, t_min_e, self.t_max)
        y = loy + t_body * ldy
        t_body = torch.where(~(y > 0.5) & ~(y < -0.5), t_body, INF)
        t_cap = _gd(-0.5 - loy, ldy)
        px = lox + t_cap * ldx
        pz = loz + t_cap * ldz
        okc = _in_range(t_cap, t_min_e, self.t_max) & ~(px * px + pz * pz > r2)
        t_cap = torch.where(okc, t_cap, INF)
        return torch.where(t_cap < t_body, t_cap, t_body)

    def torus_g(self):
        """Quartic torus (primitive/torus.rs:56-110), radii in rows 12..13:
        Ferrari through the resolvent cubic, 2 resolvent and 3 root Newton
        steps.  Division by 3 and 27 multiplies by the f32 reciprocal
        (PyTorch on CUDA does so for any scalar divisor)."""
        lox, loy, loz, ldx, ldy, ldz = self.local_frame()
        c_r, a_r = self.row(12), self.row(13)
        dd = ldx * ldx + ldy * ldy + ldz * ldz
        pp = lox * lox + loy * loy + loz * loz
        dp = ldx * lox + ldy * loy + ldz * loz
        t_min_e = self.general_tmin(dd)
        a2 = a_r * a_r
        c2 = c_r * c_r
        k = pp - (a2 + c2)
        A = dd * dd
        Bq = 4.0 * dd * dp
        C4 = 2.0 * dd * k + 4.0 * dp * dp + 4.0 * c2 * ldy * ldy
        D = 4.0 * k * dp + 8.0 * c2 * loy * ldy
        E = k * k - 4.0 * c2 * (a2 - loy * loy)

        safe_A = torch.where(A == 0.0, 1.0, A)
        b = Bq / safe_A
        c = C4 / safe_A
        d_ = D / safe_A
        e = E / safe_A
        b2 = b * b
        p = c - 3.0 * b2 / 8.0
        q = d_ - b * c / 2.0 + b2 * b / 8.0
        r = e - b * d_ / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

        # Resolvent cubic z^3 + 2p z^2 + (p^2-4r) z - q^2.
        a2c = 2.0 * p
        a1c = p * p - 4.0 * r
        a0c = -q * q
        pc = a1c - a2c * a2c * _THIRD
        qc = 2.0 * (a2c * (a2c * a2c)) * _RCP27 - a2c * a1c * _THIRD + a0c
        half_q = qc / 2.0
        third_p = pc * _THIRD
        disc = half_q * half_q + third_p * (third_p * third_p)
        safe_tp = torch.clamp(third_p, max=-1e-30)
        mm = 2.0 * torch.sqrt(-safe_tp)
        cos_arg = torch.clamp(3.0 * qc / (pc * torch.where(pc == 0.0, 1.0, mm)), -1.0, 1.0)
        phi = _acos(cos_arg)
        z_trig = mm * torch.cos(phi * _THIRD) - a2c * _THIRD
        sqd = torch.sqrt(torch.clamp(disc, min=0.0))
        z_card = _cbrt(-half_q + sqd) + _cbrt(-half_q - sqd) - a2c * _THIRD
        z = torch.where(disc > 0.0, z_card, z_trig)
        for _ in range(2):  # polish the resolvent (Cardano cancellation)
            fz = ((z + a2c) * z + a1c) * z + a0c
            fpz = (3.0 * z + 2.0 * a2c) * z + a1c
            z = z - fz / torch.where(fpz == 0.0, 1.0, fpz)
        z = torch.clamp(z, min=0.0)

        sz = torch.sqrt(z)
        biquad = z < 1e-6 * (1.0 + torch.abs(p))
        s_safe = torch.where(biquad, 1.0, sz)
        half = (p + z) / 2.0
        shift = q / (2.0 * s_safe)
        c1 = half - shift
        c2q = half + shift
        d1 = sz * sz - 4.0 * c1
        sq1 = torch.sqrt(torch.clamp(d1, min=0.0))
        d2 = sz * sz - 4.0 * c2q
        sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
        ydisc = p * p - 4.0 * r
        ysq = torch.sqrt(torch.clamp(ydisc, min=0.0))
        y1 = (-p - ysq) / 2.0
        y2 = (-p + ysq) / 2.0
        okb1 = (ydisc >= 0.0) & (y1 >= 0.0)
        okb2 = (ydisc >= 0.0) & (y2 >= 0.0)
        r1s = torch.sqrt(torch.clamp(y1, min=0.0))
        r2s = torch.sqrt(torch.clamp(y2, min=0.0))
        ok12 = torch.where(biquad, okb1, d1 >= 0.0)
        ok34 = torch.where(biquad, okb2, d2 >= 0.0)

        best = None
        for u, ok in ((torch.where(biquad, -r1s, (-sz - sq1) / 2.0), ok12),
                      (torch.where(biquad, r1s, (-sz + sq1) / 2.0), ok12),
                      (torch.where(biquad, -r2s, (sz - sq2) / 2.0), ok34),
                      (torch.where(biquad, r2s, (sz + sq2) / 2.0), ok34)):
            t = u - b / 4.0
            for _ in range(3):  # Newton polish on the quartic
                fv = (((A * t + Bq) * t + C4) * t + D) * t + E
                fp = ((4.0 * A * t + 3.0 * Bq) * t + 2.0 * C4) * t + D
                t = t - fv / torch.where(fp == 0.0, 1.0, fp)
            t = torch.where(ok & _in_range(t, t_min_e, self.t_max), t, INF)
            best = t if best is None else torch.where(t < best, t, best)
        return best

    def tri_w(self):
        """World triangle in its unit-triangle frame (rows 0..11 map o and
        d to (beta, gamma, w)): t = -o'w / d'w, then the barycentric
        compares, written so that a NaN passes them as the TPU kernel's
        do.  The source pair is excluded outright: a ray leaving a planar
        triangle never re-hits it."""
        ou, ov, ow, du, dv, dw = self.local_frame()
        t = _gd(-ow, dw)
        beta = ou + t * du
        gamma = ov + t * dv
        ok = (_in_range(t, self.t_min, self.t_max) & ~(beta < 0.0) & ~(gamma < 0.0)
              & ~(beta + gamma > 1.0) & ~self.is_src)
        return torch.where(ok, t, INF)

    def aabox(self):
        """Slab test on the pack-time inflated world box: the entry face if
        in range, else the exit face (the cube's 6-face fold semantics)."""
        t1x = (self.row(0) - self.ox) * self.rdx
        t2x = (self.row(3) - self.ox) * self.rdx
        t1y = (self.row(1) - self.oy) * self.rdy
        t2y = (self.row(4) - self.oy) * self.rdy
        t1z = (self.row(2) - self.oz) * self.rdz
        t2z = (self.row(5) - self.oz) * self.rdz
        ten = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                            torch.minimum(t1z, t2z))
        tex = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                            torch.maximum(t1z, t2z))
        dlx = self.dx * self.row(6)
        dly = self.dy * self.row(7)
        dlz = self.dz * self.row(8)
        t_min_e = self.general_tmin(dlx * dlx + dly * dly + dlz * dlz)
        t = torch.where(ten >= t_min_e, ten, tex)
        ok = (ten <= tex) & _in_range(t, t_min_e, self.t_max)
        return torch.where(ok, t, INF)

    def sphere_w(self):
        ocx = self.ox - self.row(0)
        ocy = self.oy - self.row(1)
        ocz = self.oz - self.row(2)
        b = 2.0 * (ocx * self.dx + ocy * self.dy + ocz * self.dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - self.row(3)
        t_min_e = torch.where(
            self.is_src, torch.maximum(self.t_min, self.self_eps * self.row(4)), self.t_min)
        disc = b * b - 4.0 * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        sgn = torch.where(b >= 0.0, 1.0, -1.0)
        q = -0.5 * (b + sgn * sq)
        safe_q = torch.where(q == 0.0, 1.0, q)
        cq = c / safe_q
        r0 = torch.minimum(q, cq)
        r1 = torch.maximum(q, cq)
        ok = disc >= 0.0
        ok0 = ok & (r0 >= t_min_e) & (r0 < self.t_max)
        ok1 = ok & (r1 >= t_min_e) & (r1 < self.t_max)
        return torch.where(ok0, r0, torch.where(ok1, r1, INF))


_BRANCHES = {
    SPHERE: _Chunk.sphere_g,
    PLANE: _Chunk.plane_g,
    CUBE: _Chunk.cube_g,
    CYLINDER: _Chunk.cylinder_g,
    CONE: _Chunk.cone_g,
    MESH: _Chunk.tri_w,
    TORUS: _Chunk.torus_g,
    PACKED_SPHERE_W: _Chunk.sphere_w,
    PACKED_AABOX: _Chunk.aabox,
}


def _entry(o, rcp, t_min, active, bmin, bmax):
    """[R, B]: each ray's entry distance into each box of bmin, bmax [B, 3]
    by the TPU prologue's conservative slab rule (1e-30 reciprocal guard
    in `rcp`, slack 1e-4|t_enter| + 1e-5), NaN where the ray misses the
    box, leaves it before t_min or is inactive.  No hit inside a box is
    nearer than its entry."""
    ten = torch.full((o.shape[0], bmin.shape[0]), -INF, dtype=o.dtype, device=o.device)
    tex = torch.full_like(ten, INF)
    for axis in range(3):
        ta = (bmin[None, :, axis] - o[:, None, axis]) * rcp[:, None, axis]
        tb = (bmax[None, :, axis] - o[:, None, axis]) * rcp[:, None, axis]
        ten = torch.maximum(ten, torch.minimum(ta, tb))
        tex = torch.minimum(tex, torch.maximum(ta, tb))
    te = ten - (1e-4 * torch.abs(ten) + 1e-5)
    te = torch.where(te > 0.0, te, 0.0)
    return torch.where((ten <= tex) & (tex >= t_min[:, None]) & active[:, None], te, math.nan)


def _cull(o, rcp, t_min, t_max, active, bmin, bmax):
    """[R, B] bool: rays that cross each box of bmin, bmax [B, 3] (an
    entry at most t_max)."""
    return _entry(o, rcp, t_min, active, bmin, bmax) <= t_max[:, None]


class ChunkGroups(NamedTuple):
    """What the kernel's two-level cull reads beside the packed table."""

    box_min: torch.Tensor     # [G, 3]: elementwise min of GROUP chunks' chunk_min
    box_max: torch.Tensor     # [G, 3]
    real_lanes: torch.Tensor  # [Nc] int32: count of node ids >= 0 (a prefix)

    @property
    def n_groups(self) -> int:
        return self.box_min.shape[0]


def chunk_groups(pk) -> ChunkGroups:
    """The groups of GROUP consecutive chunks (in table order: the SAH or
    Morton order the lowering packed) and the real lanes of each chunk, on
    the table's device, with no host sync.  A group's box is the exact f32
    min/max of its members' boxes, so it contains them; the slab rule is
    monotone in the box, so a group passes whenever one of its chunks
    does.  The kernel reads them through ``PackedPrims.groups``, which
    derives them once per table."""
    nc = pk.n_chunks
    pad = -nc % GROUP
    fill = lambda v: torch.full((pad, 3), v, dtype=pk.chunk_min.dtype, device=pk.chunk_min.device)
    gmin = torch.cat([pk.chunk_min, fill(INF)]).reshape(-1, GROUP, 3).amin(dim=1)
    gmax = torch.cat([pk.chunk_max, fill(-INF)]).reshape(-1, GROUP, 3).amax(dim=1)
    real = (pk.ids[0].reshape(nc, PACK_CHUNK) >= 0).sum(dim=1).to(torch.int32)
    return ChunkGroups(gmin.contiguous(), gmax.contiguous(), real)


@torch.no_grad()
def intersect_scene_sweep_ref(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
                              active=None, src_node=None, src_tri=None,
                              any_hit=False, work=None) -> Hit:
    """Plain PyTorch version of the sweep kernel (same contract).

    A dict `work` receives the work done on these rays, in any-hit mode
    each count up to a ray's first hit:
    - "cull", and per packed kind: a one-level cull's slab tests, one per
      (ray, chunk), and the (ray, real lane) evaluations of the chunks it
      passes (a hit's chunk up to its first hitting lane);
    - "group_cull", "chunk_cull" and "swept" ({kind: evaluations}): the
      kernel's.  With more than GROUP chunks a ray tests every group box,
      GROUP a step, and the chunk boxes of each group it crosses, else
      every chunk box; it sweeps the chunks it crosses.  Nearest mode
      skips a group or chunk whose entry lies beyond the ray's best t so
      far, as the kernel does.

    It computes in the rays' dtype: float64 rays over a float64 packed
    table evaluate the kernel's formulas in double precision."""
    if o.device.type == "cuda":
        COUNTS["plain_on_cuda"] += 1
    pk = st.packed
    R = o.shape[0]
    dev = o.device
    t_min, t_max, active = _rays(o, t_min, t_max, active)
    # Without a source surface (or with the raise off) every ray's is -1,
    # which no node id matches.
    if src_node is None or cfg.self_eps_local <= 0.0:
        src_node = src_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    elif src_tri is None:
        src_tri = torch.full_like(src_node, -1)
    eps_r = _f32(0.5 + cfg.epsilon)
    self_eps = _f32(cfg.self_eps_local)
    rcp = _safe_rcp(d)
    entry = _entry(o, rcp, t_min, active, pk.chunk_min, pk.chunk_max)
    cross = entry <= t_max[:, None]
    kinds = [k for k, _, n in pk.kind_ranges for _ in range(n)]
    nc = pk.n_chunks
    if work is not None:
        G = pk.groups.n_groups
        g_entry = _entry(o, rcp, t_min, active, pk.groups.box_min, pk.groups.box_max)
        for k in ("cull", "group_cull", "chunk_cull"):
            work.setdefault(k, 0)
        swept = work.setdefault("swept", {})

    best_t = torch.full((R,), INF, dtype=o.dtype, device=dev)
    best_node = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    for ci, kind in enumerate(kinds):
        if work is not None:
            live = active & ~found
            work["cull"] += int(live.sum())
            if ci % GROUP == 0:  # the kernel reaches group g
                g = ci // GROUP
                g_visit = live
                if G > 1:
                    if g % GROUP == 0:  # a step of group tests
                        work["group_cull"] += int(live.sum()) * min(GROUP, G - g)
                    e = g_entry[:, g]
                    g_visit = live & (e <= t_max) & ~(e > best_t)
                work["chunk_cull"] += int(g_visit.sum()) * min(GROUP, nc - ci)
        sel = cross[:, ci]
        if any_hit:
            sel = sel & ~found
        idx = torch.nonzero(sel).squeeze(1)
        if idx.numel() == 0:
            continue
        cols = slice(ci * PACK_CHUNK, (ci + 1) * PACK_CHUNK)
        node = pk.ids[0, cols][None, :]
        tri = pk.ids[1, cols][None, :]
        ray = tuple(x[idx, None] for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                                           d[:, 2], t_min, t_max))
        is_src = (node == src_node[idx, None]) & (tri == src_tri[idx, None])
        chunk = _Chunk(pk.f32[:, cols], node, ray, tuple(rcp[idx, a, None] for a in range(3)),
                       is_src, eps_r, self_eps)
        t = torch.where(node >= 0, _BRANCHES[kind](chunk), INF)
        if work is not None:
            real = torch.cumsum((node[0] >= 0).to(torch.int64), dim=0)
            last = torch.full((idx.numel(),), PACK_CHUNK - 1, device=dev)
            if any_hit:  # up to the first hitting lane
                lanes = t < INF
                last = torch.where(lanes.any(dim=1), lanes.to(torch.int32).argmax(dim=1), last)
            n = real[last]
            work[kind] = work.get(kind, 0) + int(n.sum())
            kept = g_visit[idx] & ~(entry[idx, ci] > best_t[idx])
            swept[kind] = swept.get(kind, 0) + int(n[kept].sum())
        if any_hit:
            found[idx] = (t < INF).any(dim=1)
            continue
        tj, j = torch.min(t, dim=1)
        better = tj < best_t[idx]
        best_t[idx] = torch.where(better, tj, best_t[idx])
        best_node[idx] = torch.where(better, node[0, j], best_node[idx])
        best_tri[idx] = torch.where(better, tri[0, j], best_tri[idx])

    if any_hit:
        return _any_hit_result(found & active)
    hit = torch.isfinite(best_t) & active
    neg = torch.full_like(best_node, -1)
    return Hit(t=best_t, node=torch.where(hit, best_node, neg),
               tri=torch.where(hit, best_tri, neg), hit=hit)


def _any_hit_result(hit):
    neg = torch.full(hit.shape, -1, dtype=torch.int32, device=hit.device)
    return Hit(t=torch.where(hit, 0.0, INF), node=neg, tri=neg, hit=hit)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_cuda:
        raise ValueError(f"{name}: expected CUDA {dtype} {tuple(shape)}, got "
                         f"{x.device} {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def intersect_scene_cuda(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
                         active=None, src_node=None, src_tri=None,
                         any_hit=False) -> Hit:
    """Nearest hit (or, with any_hit, occlusion) through the sweep kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Only `.hit` is meaningful in any-hit mode."""
    if o.device.type == "cpu":
        return intersect_scene_sweep_ref(o, d, t_min, t_max, st, cfg, active=active,
                                         src_node=src_node, src_tri=src_tri,
                                         any_hit=any_hit)
    out, active = sweep_launch(o, d, t_min, t_max, st, cfg, active, src_node, src_tri, any_hit)
    if any_hit:
        return _any_hit_result((out != 0) & active)
    t, node, tri = out
    hit = torch.isfinite(t) & active
    return Hit(t=t, node=node, tri=tri, hit=hit)


def sweep_launch(o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig, active=None,
                 src_node=None, src_tri=None, any_hit=False):
    """One launch of the sweep kernel on CUDA tensors: (its outputs, the
    active mask [R] bool it ran under).  The outputs are (t, node, tri) [R],
    node and tri -1 where nothing is hit, or with any_hit found [R] int32,
    0 on inactive rays."""
    R = o.shape[0]
    if R >= MAX_LAUNCH_RAYS:
        raise ValueError(f"sweep kernel: {R} rays in one launch; it indexes rays with a "
                         f"32-bit int and takes fewer than {MAX_LAUNCH_RAYS} rays: split "
                         f"the launch")
    from .. import _build

    lib = _build.load()
    pk = st.packed
    o, d = o.detach(), d.detach()
    if isinstance(t_min, torch.Tensor):
        t_min = t_min.detach()
    t_min, t_max, active = _rays(o, t_min, t_max, active)
    o = _check("o", o, torch.float32, (R, 3))
    d = _check("d", d, torch.float32, (R, 3))
    t_min = _check("t_min", t_min, torch.float32, (R,))
    t_max = _check("t_max", t_max, torch.float32, (R,))
    active = _check("active", active, torch.bool, (R,))
    ncol = pk.n_chunks * PACK_CHUNK
    pf = _check("packed.f32", pk.f32, torch.float32, (21, ncol))
    pid = _check("packed.ids", pk.ids, torch.int32, (2, ncol))
    kinds = _check("packed.chunk_kind", pk.chunk_kind, torch.int32, (pk.n_chunks,))
    cmin = _check("packed.chunk_min", pk.chunk_min, torch.float32, (pk.n_chunks, 3))
    cmax = _check("packed.chunk_max", pk.chunk_max, torch.float32, (pk.n_chunks, 3))
    groups = pk.groups
    src_ptr = srct_ptr = None
    if src_node is not None and cfg.self_eps_local > 0.0:
        src_node = _check("src_node", src_node, torch.int32, (R,))
        if src_tri is None:
            src_tri = torch.full_like(src_node, -1)
        src_tri = _check("src_tri", src_tri, torch.int32, (R,))
        src_ptr, srct_ptr = src_node.data_ptr(), src_tri.data_ptr()
    stream = torch.cuda.current_stream(o.device).cuda_stream
    args = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), src_ptr, srct_ptr, pf.data_ptr(), pid.data_ptr(),
            kinds.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), groups.box_min.data_ptr(),
            groups.box_max.data_ptr(), groups.real_lanes.data_ptr(), R, pk.n_chunks,
            groups.n_groups, ncol,
            _f32(0.5 + cfg.epsilon), _f32(cfg.self_eps_local),
            int(any(k == TORUS for k, _, _ in pk.kind_ranges)))
    if any_hit:
        found = torch.empty(R, dtype=torch.int32, device=o.device)
        rc = lib.sweep_any_hit(*args, found.data_ptr(), stream)
        mode = "any_hit"
    else:
        t = torch.empty(R, dtype=torch.float32, device=o.device)
        node = torch.empty(R, dtype=torch.int32, device=o.device)
        tri = torch.empty(R, dtype=torch.int32, device=o.device)
        rc = lib.sweep_nearest(*args, t.data_ptr(), node.data_ptr(), tri.data_ptr(), stream)
        mode = "nearest"
    if rc != 0:
        raise RuntimeError(f"sweep kernel ({mode}) launch failed: CUDA error {rc}")
    if R and torch.cuda.is_current_stream_capturing():
        count_on_device(o.device, mode)
    elif R:
        COUNTS[mode] += 1
    return (found if any_hit else (t, node, tri)), active
