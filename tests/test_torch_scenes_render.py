"""One tile of four of the port's scene programs rendered against the JAX
package's, on the stand-in assets of tests/_torch_assets.py (the fixture
of tests/test_torch_scenes.py): texture-mapping and cube-mapping (image
textures from JPEG and PNG, a mirror), robot-alarm-clock (glossy metal,
normal maps, an area light) and graphics-castle (glossy, refractive
water).

Tolerances, with their reasons:
- the port's flat oracle: tests/test_torch_render.py's image gate, at
  most 1% of pixels beyond 1e-4 and none beyond 2e-2 (XLA on the CPU
  contracts mul+add into FMA; a grazed shadow or silhouette flips a
  sample).
- the kernel's plain version: the same, but fewer than 0.1% of pixels
  (chip_smoke.py's share for the kernel's render against the flat
  oracle's) may lie beyond 2e-2.  The kernel skips a ray's source
  triangle pair, where the flat sweeps of both packages only raise its
  t-range start: a shadow ray that leaves a mesh triangle and meets the
  pair's other triangle is occluded for one and not the other, and its
  sample moves the pixel by a large step (on the robot's tile one shadow
  ray of its 2,048 samples meets its source pair at t = 0.0156 by the
  flat formulas and not by the kernel's, in float64 as in float32).
Most of this file's time is the JAX package's compile of each render
program.
"""

import numpy as np
import pytest

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes

from test_torch_render import assert_images_close
from test_torch_scenes import standins  # noqa: F401  (the fixture)


# One 32x32 tile of the published frame (one tile of the render's grid):
# the textured cube and plane of the mapping scenes over their mirror, the
# robot's glossy metal under its area light (one bounce round; a tile whose
# rays bounce up to ten rounds takes the flat oracle minutes on a loaded
# CPU), castle's glossy refracting water.
TILES = {"texture-mapping": (320, 288), "cube-mapping": (384, 288),
         "robot-alarm-clock": (864, 512), "graphics-castle": (1184, 864)}


@pytest.mark.parametrize("name", list(TILES))
def test_render_tile_matches_jax(standins, name):
    """render_linear of one tile at 2 spp: the port's flat oracle and the
    kernel's plain version (accel="cuda" on the CPU) against the JAX
    package's flat render."""
    x0, y0 = TILES[name]
    region = ((x0, y0), (x0 + 31, y0 + 31))
    tile = (slice(y0, y0 + 32), slice(x0, x0 + 32))
    js, ts = scenes.load(name), tscenes.load(name)
    kw = dict(samples=2, tile=(32, 32), seed=0, queue_caps=js.queue_caps)
    ref = np.asarray(P.render_linear(js.scene, js.camera, js.size, js.background,
                                     P.RenderConfig(accel="flat", **kw), region=region))[tile]
    st = T.flatten_scene(ts.scene, "cpu")
    flat, kernel = (T.render_linear(st, ts.camera, ts.size, ts.background,
                                    T.RenderConfig(device="cpu", accel=accel, **kw),
                                    region=region)[tile] for accel in ("flat", "cuda"))
    assert flat.std() > 1e-3, f"{name}: a flat tile tests little"
    assert_images_close(flat, ref)
    diff = np.abs(kernel - ref).max(axis=-1)
    assert np.isfinite(kernel).all() and (diff > 1e-4).mean() < 0.01, (diff > 1e-4).mean()
    assert (diff > 2e-2).mean() < 1e-3, f"{int((diff > 2e-2).sum())} pixels beyond 2e-2"
