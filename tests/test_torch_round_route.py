"""Which rounds take the round kernels (ops/cuda_round.py, csrc/round.cu)
and which the plain chain of ops/trace.py: the route is decided before the
call from what the round's queue and tables are (cuda_round.takes_kernels),
never by trying.  The kernels run only on the card; here a trace on the
CPU runs the plain chain and counts no kernel launch."""

import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import RenderConfig, flatten_scene, rng
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_round
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.render import _tile_rays, default_background

from _torch_jax import INLINE

F32, F64 = torch.float32, torch.float64


def _route(device="cuda", dtype=F32, grad=(), soft=0.0, fn=(), inputs_grad=False):
    return cuda_round.takes_kernels(device, dtype, grad, soft, fn, inputs_grad)


def test_a_float32_render_on_the_card_takes_the_kernels():
    assert _route()


@pytest.mark.parametrize("why, kw", [
    ("the CPU", dict(device="cpu")),
    ("float64, the check mode", dict(dtype=F64)),
    ("tables that require grad", dict(grad=("mat_diffuse",))),
    ("inputs that require grad", dict(inputs_grad=True)),
    ("soft silhouettes", dict(soft=0.05)),
    ("procedural textures", dict(fn=(lambda uv: uv,))),
])
def test_the_plain_chain_where_a_kernel_cannot_run_or_autograd_must_see(why, kw):
    assert not _route(**kw), why


def test_tables_that_require_grad_route_plain_under_no_grad():
    """The captured fit runs some forwards without recording and replays
    them under autograd: the route reads the tables, not the grad mode."""
    scene, _, _ = INLINE["glass-sphere"](T)
    st = flatten_scene(scene, "cpu")
    st = st.replace(mat_diffuse=st.mat_diffuse.detach().requires_grad_())
    with torch.no_grad():
        assert tr.grad_fields(st) == ("mat_diffuse",)
        assert not _route(grad=tr.grad_fields(st))
    assert _route(grad=tr.grad_fields(flatten_scene(scene, "cpu")))


@pytest.mark.parametrize("name", ["glass-sphere", "glossy-reflection"])
def test_a_cpu_trace_launches_no_round_kernel(name):
    scene, camera, _ = INLINE[name](T) if name in INLINE else (None, None, None)
    if scene is None:
        from portrayer_tpu_torch import scenes

        spec = scenes.load(name)
        scene, camera = spec.scene, spec.camera
    st = flatten_scene(scene, "cpu")
    cfg = RenderConfig(device="cpu", samples=2)
    o, d, pix, bg, w0 = _tile_rays(rng.PRNGKey(3), Camera(camera, (64, 64), "cpu"), 16, 16, 0,
                                   cfg=cfg, background=default_background, tile_h=16, tile_w=16,
                                   spp=2, samples=2)
    cuda_round.reset_counts()
    acc, stats = tr.trace(rng.PRNGKey(4), o, d, pix, bg, 256, st, cfg, w0=w0, spp_contiguous=2,
                          with_stats=True)
    assert torch.isfinite(acc).all() and int(stats.live[1]) > 0
    assert cuda_round.counts() == {"shade_round": 0, "resolve_round": 0, "plain_rounds_cuda": 0}
