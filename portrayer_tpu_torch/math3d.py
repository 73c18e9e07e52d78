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


def radians(deg: float) -> float:
    return float(np.deg2rad(deg))
