"""The stand-ins of the asset-backed texture scenes (tests/_torch_jax.py:
normal-mapping-numpy, with image and procedural textures and normal maps,
and soft-shadows-icosphere, with an area light) traced through the bounce
loop by the port and the JAX package, on the CPU, from the same rays.

Tolerance: a traced tile's per-pixel means agree to atol 1e-4, the JAX
side run without jit (fused, XLA contracts mul+add into FMA and its
rounding moves), as in test_torch_trace.py; the live counts are equal.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import trace as ttrace
from portrayer_tpu_torch.render import _tile_rays

from _torch_jax import INLINE, jax_arrays

# The module (portrayer_tpu.ops re-exports its function `trace`).
jtrace = importlib.import_module("portrayer_tpu.ops.trace")
STAND_INS = ["normal-mapping-numpy", "soft-shadows-icosphere"]
# (frame size, 16x16 tile origin): the tile of normal-mapping-numpy holds
# the normal-mapped plane, sphere and cube and the checker floor; that of
# soft-shadows-icosphere the area light's penumbra behind the right ball.
TILES = {"normal-mapping-numpy": ((182, 102), (144, 40)),
         "soft-shadows-icosphere": ((182, 102), (112, 40))}


@pytest.mark.parametrize("name", STAND_INS)
def test_stand_in_trace_matches_jax(name):
    """One 16x16 tile at 4 spp, its rays built by the port's render loop,
    traced through the bounce loop by both packages with the same key."""
    js = P.flatten_scene(INLINE[name](P)[0], dtype=jnp.float32)
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    _, camera, _ = INLINE[name](T)
    size, (x0, y0) = TILES[name]
    cfg = T.RenderConfig(device="cpu", samples=4, tile=(16, 16), seed=0)
    ckey = rng.fold_in(rng.fold_in(rng.fold_in(rng.PRNGKey(0), x0), y0), 0)
    rays = _tile_rays(ckey, Camera(camera, size, "cpu"), x0, y0, 0, cfg=cfg,
                      background=tscenes.sky_background, tile_h=16, tile_w=16, spp=4, samples=4)
    n = 16 * 16
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), x0), y0), 0), 1)
    with jax.disable_jit():
        ref, jst = jtrace.trace(jkey, *(jnp.asarray(x.numpy()) for x in rays[:4]), n, js,
                                P.RenderConfig(accel="flat", node_chunk=128),
                                w0=jnp.asarray(rays[4].numpy()), spp_contiguous=4,
                                with_stats=True)
    o, d, pix, bg, w0 = rays
    got, st = ttrace.trace(rng.fold_in(ckey, 1), o, d, pix, bg, n, ts, cfg, w0=w0,
                           spp_contiguous=4, with_stats=True)
    np.testing.assert_array_equal(st.live.numpy(), np.asarray(jst.live))
    got, ref = got.numpy() / 4, np.asarray(ref) / 4
    assert got.max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
