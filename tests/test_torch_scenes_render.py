"""One tile of four of the port's scene programs rendered against the JAX
package's, on the stand-in assets of tests/_torch_assets.py (the fixture
of tests/test_torch_scenes.py): texture-mapping and cube-mapping (image
textures from JPEG and PNG, a mirror), robot-alarm-clock (glossy metal,
normal maps, an area light) and graphics-castle (glossy, refractive
water).

Tolerances, with their reasons:
- the port's flat oracle against the JAX package's flat render:
  tests/test_torch_render.py's image gate, at most 1% of pixels beyond
  1e-4 and none beyond 2e-2 (XLA on the CPU contracts mul+add into FMA; a
  grazed shadow or silhouette flips a sample).
- the kernel's plain version (accel="cuda" on the CPU) against the JAX
  package's kernel (accel="pallas" in interpret mode), like for like: the
  same gate.  Both kernels skip a ray's source triangle pair outright,
  where both flat sweeps only raise its t-range start (so the kernel leg
  no longer needs the share of pixels beyond 2e-2 it had against the flat
  render: on the robot's tile one shadow ray meets its source pair by the
  flat formulas and by neither kernel).  On the robot's tile the port's
  sweep launches are replayed through the JAX kernel: every any-hit
  verdict is equal, and so is every nearest pick but where the JAX
  kernel's fold decides a tie of its own making: it keeps a hit's t with
  its 7 low bits cleared and the lane in them (pallas_intersect.py:
  608-668), so two surfaces within 128 ulps are one t to it and the lane
  order picks; the port's kernel keeps t exact and picks the nearer, as
  the JAX package's flat sweep does.  The pixels of those rays (one, of a
  primary ray meeting two surfaces 1e-4 apart) are left out of the image
  gate, each shown to be such a tie.
Most of this file's time is the JAX package's compile of each render
program, and its kernel's interpret mode.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops.pallas_intersect import intersect_scene_pallas
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import cuda_intersect

from _torch_jax import jax_arrays
from test_torch_render import assert_images_close
from test_torch_scenes import standins  # noqa: F401  (the fixture)


# One 32x32 tile of the published frame (one tile of the render's grid):
# the textured cube and plane of the mapping scenes over their mirror, the
# robot's glossy metal under its area light (one bounce round; a tile whose
# rays bounce up to ten rounds takes the flat oracle minutes on a loaded
# CPU), castle's glossy refracting water.
TILES = {"texture-mapping": (320, 288), "cube-mapping": (384, 288),
         "robot-alarm-clock": (864, 512), "graphics-castle": (1184, 864)}
# The tile whose sweep launches are replayed through the JAX kernel.
REPLAYED = "robot-alarm-clock"
SPP = 2


def _fold_ties(calls, jst, jcfg):
    """Replay the port's recorded sweep launches (o, d, t_min, t_max,
    active, src_node, src_tri, any_hit, its Hit) through the JAX kernel:
    asserts every any-hit verdict equal and every nearest pick but the
    JAX fold's ties (see the module docstring); returns {launch index:
    the rays of such ties}."""
    ties = {}
    for n, (o, d, t_min, t_max, active, src_node, src_tri, any_hit, got) in enumerate(calls):
        R = o.shape[0]
        j = lambda x: None if x is None else jnp.asarray(x.numpy())
        t_min = t_min.numpy() if torch.is_tensor(t_min) else np.full(R, t_min, np.float32)
        ref = intersect_scene_pallas(j(o), j(d), jnp.asarray(t_min),
                                     jnp.full((R,), t_max, jnp.float32), jst, jcfg,
                                     active=j(active), src_node=j(src_node),
                                     src_tri=j(src_tri), any_hit=any_hit)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit), err_msg=str(n))
        if any_hit:
            continue
        apart = np.nonzero((got.node.numpy() != np.asarray(ref.node))
                           | (got.tri.numpy() != np.asarray(ref.tri)))[0]
        for i in apart:
            # One t to the JAX fold: the same bits above the low 7.
            bits = np.array([got.t[i].item(), float(ref.t[i])], np.float32).view(np.int32)
            assert bits[0] >> 7 == bits[1] >> 7 and got.t[i] < float(ref.t[i]), (n, i)
            flat = jx.intersect_scene(j(o)[i:i + 1], j(d)[i:i + 1], t_min[i:i + 1], jnp.inf,
                                      jst, P.RenderConfig(accel="flat"))
            assert (int(flat.node[0]), int(flat.tri[0])) == (got.node[i], got.tri[i]), (n, i)
        ties[n] = apart
    return ties


@pytest.mark.parametrize("name", list(TILES))
def test_render_tile_matches_jax(standins, monkeypatch, name):
    """render_linear of one tile at 2 spp: the port's flat oracle against
    the JAX package's flat render, and the kernel's plain version
    (accel="cuda" on the CPU) against the JAX package's kernel in
    interpret mode."""
    x0, y0 = TILES[name]
    region = ((x0, y0), (x0 + 31, y0 + 31))
    tile = (slice(y0, y0 + 32), slice(x0, x0 + 32))
    js, ts = scenes.load(name), tscenes.load(name)
    kw = dict(samples=SPP, tile=(32, 32), seed=0, queue_caps=js.queue_caps)
    ref_flat, ref_kernel = (
        np.asarray(P.render_linear(js.scene, js.camera, js.size, js.background,
                                   P.RenderConfig(**kw, **accel), region=region))[tile]
        for accel in (dict(accel="flat"), dict(accel="pallas", pallas_interpret=True)))
    st = T.flatten_scene(ts.scene, "cpu")
    calls = []
    real = cuda_intersect.intersect_scene_cuda

    def recorded(o, d, t_min, t_max, st_, cfg, active=None, src_node=None, src_tri=None,
                 any_hit=False):
        out = real(o, d, t_min, t_max, st_, cfg, active=active, src_node=src_node,
                   src_tri=src_tri, any_hit=any_hit)
        keep = lambda x: x.clone() if torch.is_tensor(x) else x   # the queues are reused
        calls.append(tuple(map(keep, (o, d, t_min, t_max, active, src_node, src_tri)))
                     + (any_hit, out))
        return out

    flat = T.render_linear(st, ts.camera, ts.size, ts.background,
                           T.RenderConfig(device="cpu", accel="flat", **kw), region=region)[tile]
    monkeypatch.setattr(cuda_intersect, "intersect_scene_cuda", recorded)
    kernel = T.render_linear(st, ts.camera, ts.size, ts.background,
                             T.RenderConfig(device="cpu", accel="cuda", **kw),
                             region=region)[tile]
    assert flat.std() > 1e-3, f"{name}: a flat tile tests little"
    assert_images_close(flat, ref_flat)
    keep = np.ones((32, 32), bool)
    if name == REPLAYED:
        jst = P.flatten_scene(js.scene, dtype=jnp.float32)
        ties = _fold_ties(calls, jst, P.RenderConfig(accel="pallas", pallas_interpret=True,
                                                     **kw))
        assert len(calls) >= 4 and len(np.concatenate(list(ties.values()))) == 1, ties
        # The ties are primary rays (launch 0), SPP contiguous rays a pixel.
        assert set(n for n, rays in ties.items() if len(rays)) == {0}
        keep.reshape(-1)[ties[0] // SPP] = False
    assert_images_close(kernel[keep][:, None], ref_kernel[keep][:, None])
