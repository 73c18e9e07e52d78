"""The bounce queues' overflow on graphics-castle's stand-in assets
(tests/_torch_assets.py), held against the JAX package's: live rays per
round and dropped_w of one trace over a full-frame-aspect grid of pixel
centres, as tests/test_render.py::test_castle_queue_caps_full_frame
traces the real assets, at the scene's queue_caps.  Graphics-temple's:
tests/test_torch_queue_overflow_temple.py.

Both sides sweep with their kernel, the path a render takes: the port's
accel="cuda" (its plain PyTorch version on the CPU) and the JAX package's
Pallas kernel in interpret mode, which agree on the rays they drop (both
skip a ray's source triangle pair; the flat sweeps only raise the start
of its t-range, and keep more rays alive on these meshes).  The JAX side
runs with unroll_tail False (its tail one lax.scan) and True.  The grid is
32x18, not test_render.py's 320x180: the JAX package's interpret-mode
kernel takes 20-55 s a setting to compile and run at this size.

Tolerance: live rays per round and dropped_w within rtol 1e-4 (a ray
whose hit moves with rounding would move a count; none does here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.ops.trace import trace

from _torch_assets import write_standins
from test_torch_scenes import _clear_jax_caches, _point_at

GRID = (32, 18)


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    directory = tmp_path_factory.mktemp("assets")
    write_standins(directory, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        _point_at(mp, directory)
        yield directory
    _clear_jax_caches()


def check_overflow(name, unroll):
    """The port's TraceStats of `name` on the stand-ins against the JAX
    package's with unroll_tail `unroll`."""
    spec, tspec = scenes.load(name), tscenes.load(name)
    w, h = GRID
    cam = JaxCamera(spec.camera, spec.size)
    sx, sy = spec.size[0] / w, spec.size[1] / h
    ys, xs = np.mgrid[0:h, 0:w]
    o, d = cam.rays_at(jnp.asarray((xs.reshape(-1) + 0.5) * sx, jnp.float32),
                       jnp.asarray((ys.reshape(-1) + 0.5) * sy, jnp.float32))
    n = w * h
    jcfg = P.RenderConfig(samples=1, accel="pallas", pallas_interpret=True,
                          queue_caps=spec.queue_caps, unroll_tail=unroll)
    js = P.flatten_scene(spec.scene, dtype=jnp.float32)
    _, ref = jax_trace(jax.random.PRNGKey(0), o, d, jnp.arange(n, dtype=jnp.int32),
                       jnp.zeros((n, 3), jnp.float32), n, js, jcfg, spp_contiguous=1,
                       with_stats=True)
    st = T.flatten_scene(tspec.scene, "cpu")
    cfg = T.RenderConfig(device="cpu", samples=1, queue_caps=tspec.queue_caps)
    _, got = trace(rng.PRNGKey(0), torch.tensor(np.array(o)), torch.tensor(np.array(d)),
                   torch.arange(n, dtype=torch.int32), torch.zeros((n, 3)), n, st, cfg,
                   spp_contiguous=1, with_stats=True)
    live = np.asarray(ref.live)
    np.testing.assert_allclose(got.live.numpy(), live, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.dropped_w, float(ref.dropped_w), rtol=1e-4, err_msg=name)
    assert live[1] > 0 and live[-1] > 0  # rays alive to the last round
    return got


@pytest.mark.parametrize("unroll", [False, True])
def test_castle_overflow_matches_jax(standins, unroll):
    """graphics-castle (queue_caps (1.0, 0.8, 0.6)): the same live rays per
    round and dropped_w as the JAX package's trace, scanned or unrolled."""
    check_overflow("graphics-castle", unroll)
