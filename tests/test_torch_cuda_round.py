"""A round's lane work through its two kernels (csrc/round.cu, launched by
ops/cuda_round.py) against the plain chain of ops/trace.py, on the card.
These tests need an NVIDIA GPU with nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda_round.py -m cuda --noconftest

Round 0 and the bounce rounds, each from the same queue, acc and hits on
both routes: every kind (sphere, plane, cube, cylinder, cone, torus,
mesh), mirror, glossy and refracted children with total internal
reflection, image textures and normal maps, an area light, and the last
round (max_depth 2).  The next queue and its live count are equal, bit
for bit: the children's origins, directions (the glossy draws among
them), throughputs and t-range starts take no function whose rounding
differs between the routes.  acc agrees within ROUND_RTOL of
(1 + |value|): bounce rounds add to acc with float atomics in any order
on both routes (index_add), and the texels' sRGB power, the specular
power, atan2 and acos are CUDA's functions built under other flags than
PyTorch's kernels, a last bit apart.  Torus hits carry the JAX package's
torus gate (1e-3) on every float: the quartic's root, solved with the
same formulas and functions, moves with that rounding where it is ill
conditioned (grazing rays).  A captured
render equals the op-by-op one, both through the kernels, and a render
counts the kernels' launches and no plain round on the card; procedural
textures and a differentiable trace (the fit, captured) keep the plain
chain.  The wrapper raises on a CPU tensor, a float64 one and a
non-contiguous one.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_round
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.render import _tile_rays, default_background

from _torch_assets import write_standins
from _torch_jax import INLINE

pytestmark = pytest.mark.cuda

ROUND_RTOL = 1e-5
TORUS_RTOL = 1e-3
SCENES = ["glossy-reflection", "big-scene", "water-glass", "glass-sphere", "torus-showcase",
          "procedural-meshes", "single-triangle", "soft-shadows-icosphere", "ellipsoids",
          "four-shapes"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def assets():
    """The asset-loading programs' stand-in files (PORTRAYER_ASSETS)."""
    old = os.environ.get("PORTRAYER_ASSETS")
    with tempfile.TemporaryDirectory() as tmp:
        write_standins(tmp, seed=0)
        os.environ["PORTRAYER_ASSETS"] = tmp
        yield tmp
    if old is None:
        os.environ.pop("PORTRAYER_ASSETS", None)
    else:
        os.environ["PORTRAYER_ASSETS"] = old


def _scene(name):
    """(scene, camera settings, background)."""
    if name in INLINE:
        scene, camera, _ = INLINE[name](T)
        return scene, camera, default_background
    spec = scenes.load(name)
    return spec.scene, spec.camera, spec.background


def _plain(monkeypatch):
    """Route every round through the plain chain until undone."""
    monkeypatch.setattr(cuda_round, "takes_kernels", lambda *a, **k: False)


def _close(name, got, ref, rtol):
    got, ref = got.double().cpu(), ref.double().cpu()
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref)), name
    fin = torch.isfinite(ref)
    err = (got - ref).abs()[fin] / (1.0 + ref.abs()[fin])
    worst = float(err.max()) if err.numel() else 0.0
    assert worst <= rtol, (name, worst)


def _same_queue(where, got, ref, rtol):
    """got, ref: (queue, n_live); the floats equal, or within rtol."""
    assert int(got[1]) == int(ref[1]), (where, int(got[1]), int(ref[1]))
    qg, qr = got[0], ref[0]
    for f in ("pix", "src_node", "src_tri", "sid"):
        assert torch.equal(getattr(qg, f), getattr(qr, f)), (where, f)
    for f in ("o", "d", "w", "t_min"):
        if rtol:
            _close(f"{where} {f}", getattr(qg, f), getattr(qr, f), rtol)
        else:
            assert torch.equal(getattr(qg, f), getattr(qr, f)), (where, f)


@pytest.mark.parametrize("max_depth", [10, 2])
@pytest.mark.parametrize("name", SCENES)
def test_round_kernels_match_the_plain_chain(dev, assets, monkeypatch, name, max_depth):
    scene, camera, background = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev, samples=4, max_depth=max_depth, cuda_graphs=False)
    torus = name == "torus-showcase"
    rtol = TORUS_RTOL if torus else ROUND_RTOL
    qtol = TORUS_RTOL if torus else 0.0
    key = rng.PRNGKey(11)
    size = 64
    o, d, pix, bg, w0 = _tile_rays(key, Camera(camera, (512, 512), dev), 224, 224, 0, cfg=cfg,
                                   background=background, tile_h=size, tile_w=size, spp=4,
                                   samples=4)
    P = size * size
    pl = tr.plan(P * 4, st, cfg)
    q = tr.primary_queue(o, d, pix, w0, cfg)

    def both(call):
        cuda_round.reset_counts()
        got = call()
        c = cuda_round.counts()
        assert c["shade_round"] == c["resolve_round"] == 1 and c["plain_rounds_cuda"] == 0, c
        with monkeypatch.context() as m:
            _plain(m)
            ref = call()
        torch.cuda.synchronize()
        return got, ref

    out = lambda cap: tr._Queue(*(torch.empty((cap, 3) if f in ("o", "d") else (cap,),
                                              dtype=x.dtype, device=dev)
                                  for f, x in zip(tr._Queue._fields, q)))
    got, ref = both(lambda: tr.first_round(rng.fold_in(key, 0), q, bg, P, st, cfg, pl, 4,
                                           out=None if pl.max_depth == 0 else out(pl.cap[1])))
    _close("acc 0", got[0], ref[0], rtol)
    if pl.max_depth == 0:
        return
    _same_queue("round 0", (got[1], got[3]), (ref[1], ref[3]), qtol)
    acc, q, n_live = ref[0], ref[1], int(ref[3])
    ran = 0
    for ridx, k, next_cap, last in tr.bounce_rounds(pl, cfg.queue_slice_divs, lambda: n_live):
        rk = rng.fold_in(key, ridx)
        got, ref = both(lambda: tr.bounce_round(rk, q, acc.clone(), bg, st, cfg, k, next_cap,
                                                last))
        _close(f"acc {ridx}", got[0], ref[0], rtol)
        ran += 1
        if last:
            break
        _same_queue(f"round {ridx}", (got[1], got[3]), (ref[1], ref[3]), qtol)
        acc, q, n_live = ref[0], ref[1], int(ref[3])
        if ridx >= 3 and max_depth > 2:
            break
    if st.any_reflective:
        assert ran > 0


@pytest.mark.parametrize("name, size, spp", [
    ("glossy-reflection", (182, 102), 16), ("water-glass", (182, 102), 16),
    ("big-scene", (396, 204), 1), ("torus-showcase", (128, 128), 4)])
def test_captured_render_through_the_kernels(dev, assets, name, size, spp):
    """A render on the card, captured and op by op, both through the
    kernels: within 1e-6 (float atomics in another order), the same live
    rays; shade_round and resolve_round counted where they ran (the
    captured replays on the device), no round on the plain chain."""
    scene, camera, background = _scene(name)
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev, samples=spp)
    runs = []
    for graphs in (True, False):
        stats = []
        cuda_round.reset_counts()
        img = T.render_linear(st, camera, size, background,
                              dataclasses.replace(cfg, cuda_graphs=graphs), stats=stats)
        runs.append((img, stats, cuda_round.counts()))
    (img, stats, counts), (ref, ref_stats, ref_counts) = runs
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-6)
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in ref_stats]
    for c in (counts, ref_counts):
        assert c["shade_round"] > 0 and c["shade_round"] == c["resolve_round"], c
        assert c["plain_rounds_cuda"] == 0, c
    with_bounces = sum(int(s.lanes[1:].gt(0).sum()) for s in ref_stats)
    assert ref_counts["shade_round"] == len(ref_stats) + with_bounces


def test_procedural_textures_keep_the_plain_chain(dev):
    """normal-mapping-numpy's floor is a procedural texture (a torch
    callable): its rounds run the plain chain, counted."""
    scene, camera, background = _scene("normal-mapping-numpy")
    cuda_round.reset_counts()
    T.render_linear(scene, camera, (32, 32), background,
                    RenderConfig(device=dev, samples=1, cuda_graphs=False))
    c = cuda_round.counts()
    assert c["shade_round"] == c["resolve_round"] == 0 and c["plain_rounds_cuda"] > 0, c


def test_a_captured_fit_step_launches_no_round_kernel(dev):
    """A differentiable trace on the card (the captured fit program, then
    op by op) runs the plain chain: autograd sees its ops."""
    from portrayer_tpu_torch import render

    scene, camera, _ = _scene("glossy-reflection")
    st = flatten_scene(scene, dev)
    for graphs in (True, False):
        cfg = RenderConfig(device=dev, cuda_graphs=graphs)
        o, d, pix, bg, w0 = render._tile_rays(
            rng.PRNGKey(4), Camera(camera, (128, 128), dev), 32, 32, 0, cfg=cfg,
            background=render.default_background, tile_h=64, tile_w=64, spp=1, samples=1)
        leaf = st.mat_diffuse.detach().requires_grad_()
        cuda_round.reset_counts()
        acc = tr.trace(rng.PRNGKey(5), o, d, pix, bg, 64 * 64, st.replace(mat_diffuse=leaf),
                       cfg, w0=w0, spp_contiguous=1)
        acc.sum().backward()
        torch.cuda.synchronize()
        c = cuda_round.counts()
        assert c["shade_round"] == c["resolve_round"] == 0, (graphs, c)
        assert torch.isfinite(leaf.grad).all() and float(leaf.grad.abs().max()) > 0


def test_the_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    """A CPU tensor, a float64 tensor, a non-contiguous one."""
    scene, camera, _ = _scene("glossy-reflection")
    st = flatten_scene(scene, dev)
    cfg = RenderConfig(device=dev, samples=1, cuda_graphs=False)
    R = 2048
    q = tr.primary_queue(torch.zeros(R, 3, device=dev), torch.ones(R, 3, device=dev),
                         torch.zeros(R, dtype=torch.int32, device=dev), None, cfg)
    bg = torch.zeros(1, 3, device=dev)
    call = lambda q, bg=bg: cuda_round.round_(rng.PRNGKey(1), q, None, bg, st, cfg, True, None,
                                             0, lambda f: f(), 1)
    call(q)
    with pytest.raises(ValueError, match="CUDA"):
        call(q._replace(w=q.w.cpu()))
    with pytest.raises(ValueError, match="float32"):
        call(q._replace(t_min=q.t_min.double()))
    with pytest.raises(ValueError, match="contiguous"):
        call(q._replace(o=torch.zeros(3, R, device=dev).t()))
    with pytest.raises(ValueError, match="CUDA"):
        call(q, bg.cpu())
