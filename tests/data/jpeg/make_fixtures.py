#!/usr/bin/env python
"""Write the three JPEG fixtures of this folder with PIL, from a seed:

    python tests/data/jpeg/make_fixtures.py

colour_420.jpg   a 56x40 colour texture, 4:2:0, quality 85;
normal_444.jpg   a 48x48 tangent-space normal map, 4:4:4, quality 92;
grey.jpg         a 40x24 greyscale image, quality 80.

``tests/_torch_assets.py`` copies them under the names of the JPEG files
that the scene programs load; ``tests/test_torch_jpeg.py`` decodes them.
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017


def _colour(rng):
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 6.0 + c) * np.cos(yy / 4.0 - c) for c in range(3)],
                    axis=-1)
    return np.clip(base + rng.normal(0.0, 20.0, (h, w, 3)), 0, 255).astype(np.uint8)


def _normal_map(rng):
    h = w = 48
    yy, xx = np.mgrid[0:h, 0:w] / (h - 1.0)
    bumps = rng.uniform(0.0, 1.0, (4, 3))
    dx = sum(a * np.cos(8.0 * xx + b) for a, b, _ in bumps)
    dy = sum(a * np.sin(8.0 * yy + c) for a, _, c in bumps)
    n = np.stack([-0.3 * dx, -0.3 * dy, np.ones_like(dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.clip(np.round((n * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)


def _grey(rng):
    h, w = 24, 40
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
    return np.clip(base + rng.normal(0.0, 15.0, (h, w)), 0, 255).astype(np.uint8)


def main():
    rng = np.random.default_rng(SEED)
    Image.fromarray(_colour(rng)).save(os.path.join(HERE, "colour_420.jpg"), quality=85,
                                       subsampling=2)
    Image.fromarray(_normal_map(rng)).save(os.path.join(HERE, "normal_444.jpg"), quality=92,
                                           subsampling=0)
    Image.fromarray(_grey(rng), mode="L").save(os.path.join(HERE, "grey.jpg"), quality=80)


if __name__ == "__main__":
    main()
