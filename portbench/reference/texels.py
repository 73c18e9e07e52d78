"""Stand-in texels for a configuration whose upstream example loads image
files that the repository does not hold: fixed patterns drawn by numpy
from a texel seed in the configuration (not from a run's ``--seed``, so a
run's seed changes its samples and not its scene).  The builder hands the
arrays to the program as ``ImageTexture(data=...)`` / ``NormalMap(data=...)``
and the reference samples the same arrays as tensors.

Patterns, each [H, W, 3] uint8:

- ``brick``: running-bond bricks (one brick 1/8 of the width by 1/16 of the
  height, every other row offset by half a brick) in red-brown tones, a
  grey mortar line around each, and a little texel noise;
- ``wood``: bent growth rings along the height in brown tones, with grain
  noise;
- ``normals``: the usual normal-map encoding (r, g, b) = 255 (n + 1) / 2
  of the normals of a smooth height field, a sum of a few sinusoids of
  whole periods over the map (so it tiles), scaled so that no normal
  tilts more than `max_tilt_deg` from (0, 0, 1): a flat texel reads
  (128, 128, 255).

Imports numpy alone."""

from __future__ import annotations

import numpy as np


def _grid(h: int, w: int):
    """Texel rows and columns as float64 [H, W] in [0, 1)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return y / h, x / w


def _to_u8(rgb):
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def brick(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    rows, cols = 16, 8
    y, x = _grid(h, w)
    row = np.floor(y * rows).astype(np.int64)
    shifted = x * cols + 0.5 * (row % 2)
    col = np.floor(shifted).astype(np.int64) % cols
    tone = rng.uniform(0.75, 1.15, size=(rows, cols))[row, col]
    base = np.array([0.62, 0.25, 0.17])
    rgb = base * tone[..., None]
    # Mortar: within 3% of a brick's height or width from its edge.
    fy, fx = y * rows % 1.0, shifted % 1.0
    mortar = (np.minimum(fy, 1.0 - fy) < 0.06) | (np.minimum(fx, 1.0 - fx) < 0.03)
    rgb = np.where(mortar[..., None], np.array([0.72, 0.70, 0.66]), rgb)
    rgb = rgb * rng.uniform(0.92, 1.08, size=(h, w))[..., None]
    return _to_u8(np.clip(rgb, 0.0, 1.0))


def wood(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    y, x = _grid(h, w)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=2)
    bend = 0.08 * np.sin(2.0 * np.pi * 2.0 * x + phase[0]) \
        + 0.03 * np.sin(2.0 * np.pi * 5.0 * x + phase[1])
    rings = 0.5 + 0.5 * np.sin(2.0 * np.pi * 24.0 * (y + bend))
    light, dark = np.array([0.66, 0.46, 0.26]), np.array([0.42, 0.25, 0.12])
    rgb = dark + (light - dark) * rings[..., None] ** 1.5
    grain = rng.uniform(0.9, 1.1, size=(h, 1)) * rng.uniform(0.96, 1.04, size=(h, w))
    return _to_u8(np.clip(rgb * grain[..., None], 0.0, 1.0))


def normals(rng: np.random.Generator, h: int, w: int, max_tilt_deg: float = 20.0,
            waves: int = 6) -> np.ndarray:
    y, x = _grid(h, w)
    fx = rng.integers(1, 9, size=waves)
    fy = rng.integers(1, 9, size=waves)
    amp = rng.uniform(0.5, 1.0, size=waves)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=waves)
    # dh/dx and dh/dy of sum(amp sin(2 pi (fx x + fy y) + phase)), up to scale.
    gx = np.zeros((h, w))
    gy = np.zeros((h, w))
    for a, kx, ky, p in zip(amp, fx, fy, phase):
        c = a * np.cos(2.0 * np.pi * (kx * x + ky * y) + p)
        gx += kx * c
        gy += ky * c
    slope = np.sqrt(gx * gx + gy * gy)
    scale = np.tan(np.radians(max_tilt_deg)) / max(float(slope.max()), 1e-12)
    n = np.stack([-scale * gx, -scale * gy, np.ones_like(gx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return _to_u8((n + 1.0) / 2.0)


PATTERNS = {"brick": brick, "wood": wood, "normals": normals}


def make(spec: dict) -> dict:
    """{name: uint8 [H, W, 3]} of spec = {"seed": s, "size": [H, W], "maps":
    {name: pattern}}: each map drawn from its own generator, seeded by
    (s, its place in the listed maps)."""
    h, w = spec["size"]
    return {name: PATTERNS[pattern](np.random.default_rng([int(spec["seed"]), i]), h, w)
            for i, (name, pattern) in enumerate(spec["maps"].items())}
