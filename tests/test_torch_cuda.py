"""The port's CUDA sweep kernel against its plain PyTorch version, on the
card.  These tests need an NVIDIA GPU with nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda.py -m cuda

single-triangle and procedural-meshes (at its test size) drive the tri_w
branch, their child rays with (node, tri) source pairs.

Gates: the JAX package's kernel gates (tests/test_pallas.py) for the
nearest mode, with its torus gate (tests/test_torus.py) on torus hits,
and equal .hit for the any-hit mode.  Kernel and plain version round every
op the same way (the kernel is built with -fmad=false), so in practice
they agree bit for bit.
"""

import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.ops.cuda_intersect import (
    intersect_scene_cuda, intersect_scene_sweep_ref,
)

from _torch_jax import assert_gates, torus_nodes, INLINE

NAMES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
         "ellipsoids", "single-triangle", "procedural-meshes"]

pytestmark = pytest.mark.cuda
INF = float("inf")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cpu(hit):
    return type(hit)(*(x.cpu() for x in hit))


def _scene(name):
    if name in INLINE:
        return INLINE[name](T)
    spec = scenes.load(name)
    return spec.scene, spec.camera, spec.size


def _check(o, d, t_min, st, cfg, torus, **kw):
    """Nearest and any-hit: kernel against plain version; returns the
    kernel's nearest hits."""
    k = intersect_scene_cuda(o, d, t_min, INF, st, cfg, **kw)
    p = intersect_scene_sweep_ref(o, d, t_min, INF, st, cfg, **kw)
    assert_gates(_cpu(p), _cpu(k), None if "src_node" not in kw else kw["src_node"].cpu(),
                 torus=torus)
    ka = intersect_scene_cuda(o, d, t_min, INF, st, cfg, any_hit=True, **kw)
    pa = intersect_scene_sweep_ref(o, d, t_min, INF, st, cfg, any_hit=True, **kw)
    assert torch.equal(ka.hit, pa.hit)
    return k


def _shadow(o, d, hit, st):
    """Rays from the hits toward the first light, with src ids."""
    t = torch.where(hit.hit, hit.t, 0.0)
    pts = o + t[:, None] * d
    sd = st.light_pos[0] - pts
    sd = sd / torch.linalg.vector_norm(sd, dim=-1, keepdim=True)
    t_min = torch.clamp(3e-4 * torch.linalg.vector_norm(pts, dim=-1), min=1e-5)
    return pts, sd, t_min, dict(active=hit.hit, src_node=hit.node, src_tri=hit.tri)


@pytest.mark.parametrize("name", NAMES)
def test_sweep_kernel_matches_plain_version(dev, name):
    """Camera rays, their shadow rays and, where the scene reflects, the
    child rays of a real round 0 with their source surfaces and those rays'
    shadow rays."""
    scene, camera, (w, h) = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev)
    torus = torus_nodes(st)
    u = rng.uniform(rng.PRNGKey(11), (65536, 2), dev)
    o, d = Camera(camera, (w, h), dev).rays_at(u[:, 0] * w, u[:, 1] * h)
    cuda_intersect.reset_counts()
    k = _check(o, d, 1e-5, st, cfg, torus)
    assert cuda_intersect.COUNTS["nearest"] == 1 and cuda_intersect.COUNTS["any_hit"] == 1
    pts, sd, t_min, kw = _shadow(o, d, k, st)
    _check(pts, sd, t_min, st, cfg, torus, **kw)
    if not st.any_reflective:
        return
    R = o.shape[0]
    q = tr._Queue(o=o, d=d, w=torch.ones(R, device=dev),
                  pix=torch.arange(R, dtype=torch.int32, device=dev),
                  t_min=torch.full((R,), 1e-5, device=dev),
                  src_node=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  src_tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
                  sid=torch.arange(R, dtype=torch.int32, device=dev))
    acc = torch.zeros((R, 3), device=dev)
    _, child, _ = tr._round_shade(q, tr._nearest(q, st, cfg), acc, acc, st, cfg,
                                  rng.PRNGKey(3), is_last=False)
    q1, _, _, n = tr._compact(child, 2 * R, acc, acc)
    assert n > 0
    kb = _check(q1.o, q1.d, q1.t_min, st, cfg, torus, src_node=q1.src_node,
                src_tri=q1.src_tri)
    pts, sd, t_min, kw = _shadow(q1.o, q1.d, kb, st)
    _check(pts, sd, t_min, st, cfg, torus, **kw)


def test_sweep_kernel_rejects_bad_inputs(dev):
    st = flatten_scene(scenes.load("simple").scene, dev)
    cfg = RenderConfig(device=dev)
    o = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        intersect_scene_cuda(o, o, 1e-5, INF, st, cfg)
