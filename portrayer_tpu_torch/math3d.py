"""Vector math (counterpart of ``portrayer_tpu/math3d.py``).

Device side: elementwise torch helpers over [..., 3] tensors.  Geometry is
written as elementwise mul+add, never ``matmul``/``einsum``, so each op
rounds once in f32 and the op order follows the JAX package's.

Host side: numpy float64 transform builders for scene construction.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Batched torch helpers (device side)
# ---------------------------------------------------------------------------

def dot(a, b):
    """Dot product over the last axis ([..., 3] -> [...])."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def safe_sqrt(x, tiny=1e-30):
    """sqrt(max(x, 0)) whose derivative stays finite at x <= 0."""
    return torch.where(x > 0.0, torch.sqrt(torch.clamp(x, min=tiny)), torch.zeros_like(x))


def norm(v, eps=0.0):
    """|v|; with eps, clamps |v|^2 at max(eps^2, 1.2e-38) before the sqrt
    (eps^2 = 1e-60 underflows to 0 in f32; 1.2e-38 is the smallest normal)."""
    s = dot(v, v)
    if eps:
        s = torch.clamp(s, min=max(eps * eps, 1.2e-38))
    return torch.sqrt(s)


def normalize(v, eps=0.0):
    return v / norm(v, eps=eps)[..., None]


def transform_point(m34, p):
    """Apply affine [..., 3, 4] to points [..., 3]."""
    return transform_dir(m34, p) + m34[..., :, 3]


def transform_dir(m34, d):
    """Apply the linear part of affine [..., 3, 4] to directions [..., 3]."""
    return (m34[..., :, 0] * d[..., None, 0] + m34[..., :, 1] * d[..., None, 1]
            + m34[..., :, 2] * d[..., None, 2])


def matvec3(m33, v):
    return (m33[..., :, 0] * v[..., None, 0] + m33[..., :, 1] * v[..., None, 1]
            + m33[..., :, 2] * v[..., None, 2])


# ---------------------------------------------------------------------------
# Quadratic solver: the roots crate's find_roots_quadratic (src/math.rs:
# 107-114), roots sorted ascending, the linear equation when a == 0.
# ---------------------------------------------------------------------------

def quadratic_roots(a, b, c):
    """(r0, r1), r0 <= r1, +inf where invalid; exact a == 0 falls back to
    the linear equation and disc == 0 gives a double root."""
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)
    # Numerically stable: q = -(b + sign(b) sq) / 2; roots q/a and c/q.
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    one = torch.ones_like(a)
    inf = torch.full_like(a, torch.inf)
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
    """Smallest quadratic root t with t_min <= t < t_max (Solutions::
    find_in_range, src/math.rs:94-96): (t, valid)."""
    r0, r1 = quadratic_roots(a, b, c)
    ok0 = (r0 >= t_min) & (r0 < t_max)
    ok1 = (r1 >= t_min) & (r1 < t_max)
    t = torch.where(ok0, r0, torch.where(ok1, r1, torch.full_like(r1, torch.inf)))
    return t, ok0 | ok1


# ---------------------------------------------------------------------------
# Quartic solver for the torus (the reference's Quartic over the roots
# crate, src/math.rs:126-133): Ferrari through the resolvent cubic, then
# Newton polish.  Integer powers are written as products, in the order of
# XLA's integer_pow (x^3 = x * x^2).
# ---------------------------------------------------------------------------

def _cbrt(x):
    """Signed real cube root.  Torch has no cbrt: |x|^(1/3) through pow
    with the f32 exponent 0.33333334 is within ~|ln|x||*1e-8 relative of
    the true root (a few ulps here), and the resolvent's Newton polish
    removes the rest."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _solve_cubic_largest(a2, a1, a0):
    """Largest real root of z^3 + a2 z^2 + a1 z + a0 (trigonometric form
    with three real roots, Cardano with one)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * (a2 * (a2 * a2)) / 27.0 - a2 * a1 / 3.0 + a0
    half_q = q / 2.0
    third_p = p / 3.0
    disc = half_q * half_q + third_p * (third_p * third_p)
    safe_tp = torch.clamp(third_p, max=-1e-30)
    m = 2.0 * torch.sqrt(-safe_tp)
    cos_arg = torch.clamp(3.0 * q / (p * torch.where(p == 0.0, 1.0, m)), -1.0, 1.0)
    phi = torch.acos(cos_arg)
    z_trig = m * torch.cos(phi / 3.0) - a2 / 3.0
    sq = safe_sqrt(disc)
    z_card = _cbrt(-half_q + sq) + _cbrt(-half_q - sq) - a2 / 3.0
    return torch.where(disc > 0.0, z_card, z_trig)


def quartic_roots(A, B, C, D, E):
    """Real roots of A t^4 + B t^3 + C t^2 + D t + E (A != 0): (roots
    [..., 4], valid [..., 4]), invalid entries +inf.  Newton-polished (3
    steps) for float32."""
    safe_A = torch.where(A == 0.0, 1.0, A)
    b = B / safe_A
    c = C / safe_A
    d = D / safe_A
    e = E / safe_A
    # Depressed quartic u^4 + p u^2 + q u + r with t = u - b/4.
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent z^3 + 2p z^2 + (p^2 - 4r) z - q^2; a root z > 0 factors
    # the quartic into two quadratics.
    a2c = 2.0 * p
    a1c = p * p - 4.0 * r
    a0c = -q * q
    z = _solve_cubic_largest(a2c, a1c, a0c)
    for _ in range(2):  # Cardano cancels near q ~ 0
        fz = ((z + a2c) * z + a1c) * z + a0c
        fpz = (3.0 * z + 2.0 * a2c) * z + a1c
        z = z - fz / torch.where(fpz == 0.0, 1.0, fpz)
    z = torch.clamp(z, min=0.0)
    s = safe_sqrt(z)
    biquad = z < 1e-6 * (1.0 + torch.abs(p))
    s_safe = torch.where(biquad, 1.0, s)

    half = (p + z) / 2.0
    shift = q / (2.0 * s_safe)
    c1 = half - shift
    c2 = half + shift

    def quad(bq, cq):
        disc = bq * bq - 4.0 * cq
        sqd = safe_sqrt(disc)
        return (-bq - sqd) / 2.0, (-bq + sqd) / 2.0, disc >= 0.0

    u1, u2, ok12 = quad(s, c1)
    u3, u4, ok34 = quad(-s, c2)

    # Biquadratic: y^2 + p y + r = 0; u = +-sqrt(y).
    ydisc = p * p - 4.0 * r
    ysq = safe_sqrt(ydisc)
    y1 = (-p - ysq) / 2.0
    y2 = (-p + ysq) / 2.0
    okb = ydisc >= 0.0
    okb1 = okb & (y1 >= 0.0)
    okb2 = okb & (y2 >= 0.0)

    u_all = torch.stack([
        torch.where(biquad, -safe_sqrt(y1), u1),
        torch.where(biquad, safe_sqrt(y1), u2),
        torch.where(biquad, -safe_sqrt(y2), u3),
        torch.where(biquad, safe_sqrt(y2), u4),
    ], dim=-1)
    ok_all = torch.stack([
        torch.where(biquad, okb1, ok12),
        torch.where(biquad, okb1, ok12),
        torch.where(biquad, okb2, ok34),
        torch.where(biquad, okb2, ok34),
    ], dim=-1)

    t = u_all - (b / 4.0)[..., None]
    A4, B4, C4, D4, E4 = (x[..., None] for x in (A, B, C, D, E))
    for _ in range(3):
        f = (((A4 * t + B4) * t + C4) * t + D4) * t + E4
        fp = ((4.0 * A4 * t + 3.0 * B4) * t + 2.0 * C4) * t + D4
        t = t - f / torch.where(fp == 0.0, 1.0, fp)

    valid = ok_all & (A4 != 0.0)
    return torch.where(valid, t, torch.inf), valid


def quartic_smallest_root_in_range(A, B, C, D, E, t_min, t_max):
    """Smallest real quartic root with t_min <= t < t_max: (t, ok)."""
    roots, valid = quartic_roots(A, B, C, D, E)
    ok = valid & (roots >= t_min[..., None]) & (roots < t_max[..., None])
    t = torch.amin(torch.where(ok, roots, torch.inf), dim=-1)
    return t, ok.any(dim=-1)


# ---------------------------------------------------------------------------
# Host-side (numpy f64) transform builders
# ---------------------------------------------------------------------------

def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translation(v) -> np.ndarray:
    m = identity4()
    m[:3, 3] = np.asarray(v, dtype=np.float64)
    return m


def scaling(v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    if v.ndim == 0:
        v = np.full(3, float(v))
    m = identity4()
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = identity4()
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """World-to-view matrix (vek's Mat4::look_at_rh, src/camera.rs:38)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = identity4()
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m)


def to_affine34(m: np.ndarray) -> np.ndarray:
    """Top 3x4 of a 4x4 affine."""
    return np.asarray(m, dtype=np.float64)[:3, :4]


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the upper-left 3x3, the reference's
    normal_trans (src/scene.rs:204)."""
    return np.linalg.inv(m[:3, :3]).T


def radians(deg: float) -> float:
    return float(np.deg2rad(deg))
