"""The port's CUDA sweep kernel against its plain PyTorch version, on the
card.  These tests need an NVIDIA GPU with nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda.py -m cuda

Gates: the JAX package's kernel gates (tests/test_pallas.py) for the
nearest mode, equal .hit for the any-hit mode.  Kernel and plain version
round every op the same way (the kernel is built with -fmad=false), so in
practice they agree bit for bit.
"""

import pytest
import torch

from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.ops.cuda_intersect import (
    intersect_scene_cuda, intersect_scene_sweep_ref,
)

from _torch_jax import assert_gates

pytestmark = pytest.mark.cuda
INF = float("inf")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cpu(hit):
    return type(hit)(*(x.cpu() for x in hit))


@pytest.mark.parametrize("name", ["simple", "big-scene"])
def test_sweep_kernel_matches_plain_version(dev, name):
    spec = scenes.load(name)
    w, h = spec.size
    st = flatten_scene(spec.scene, dev)
    cfg = RenderConfig(device=dev)
    u = rng.uniform(rng.PRNGKey(11), (65536, 2), dev)
    o, d = Camera(spec.camera, spec.size, dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    cuda_intersect.reset_counts()
    k = intersect_scene_cuda(o, d, 1e-5, INF, st, cfg)
    p = intersect_scene_sweep_ref(o, d, 1e-5, INF, st, cfg)
    assert cuda_intersect.COUNTS["nearest"] == 1
    assert_gates(_cpu(p), _cpu(k))

    # Shadow rays toward the first light, from the hits, with src ids.
    t = torch.where(k.hit, k.t, 0.0)
    pts = o + t[:, None] * d
    sd = st.light_pos[0] - pts
    sd = sd / torch.linalg.vector_norm(sd, dim=-1, keepdim=True)
    t_min = torch.clamp(3e-4 * torch.linalg.vector_norm(pts, dim=-1), min=1e-5)
    kw = dict(active=k.hit, src_node=k.node, src_tri=k.tri)
    ka = intersect_scene_cuda(pts, sd, t_min, INF, st, cfg, any_hit=True, **kw)
    pa = intersect_scene_sweep_ref(pts, sd, t_min, INF, st, cfg, any_hit=True, **kw)
    assert torch.equal(ka.hit, pa.hit)
    assert cuda_intersect.COUNTS["any_hit"] == 1
    assert_gates(_cpu(intersect_scene_sweep_ref(pts, sd, t_min, INF, st, cfg, **kw)),
                 _cpu(intersect_scene_cuda(pts, sd, t_min, INF, st, cfg, **kw)),
                 kw["src_node"].cpu())


def test_sweep_kernel_rejects_bad_inputs(dev):
    st = flatten_scene(scenes.load("simple").scene, dev)
    cfg = RenderConfig(device=dev)
    o = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        intersect_scene_cuda(o, o, 1e-5, INF, st, cfg)
