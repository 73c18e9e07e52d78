"""The port's render loop against the JAX package's (accel="flat") and
the committed self-goldens, on the CPU, where the sweep runs its plain
PyTorch version; PNG I/O, region re-render, SAMPLES, config checks and the
no-JAX import rule.

Tolerances, with their reasons:
- render_linear against JAX's jitted render, an image-level check on top
  of the atol-1e-4 one in test_torch_shade.py (a tile traced by both
  packages from the same rays, JAX unfused): both draw the same jitter
  (bit-equal threefry), but fused, XLA on the CPU contracts mul+add into
  FMA, so camera rays and hit points differ by ulps.  Where a shadow or
  silhouette is grazed that flips a sample, so at most 1% of pixels may
  differ by more than 1e-4 and none by more than 2e-2 (measured:
  big-scene 0.42% of pixels, max 9.6e-3).
- u8 images: the self-golden rule of tests/test_golden.py, fewer than 0.1%
  of pixels off by more than 2/255.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, scenes as tscenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "self_golden")
# The self-goldens' sizes (tools/gen_self_goldens.py).
SIZES = {"simple": (64, 64), "big-scene": (160, 82), "four-shapes": (256, 68)}
_cache = {}


def _render(which, name, size=None, as_u8=False, **kw):
    """Cached render of `name` by the JAX package ("jax") or the port."""
    size = size or SIZES[name]
    kw = dict(dict(samples=4, tile=(64, 64), seed=0), **kw)
    key = (which, name, size, as_u8, tuple(sorted(kw.items())))
    if key not in _cache:
        if which == "jax":
            spec = scenes.load(name)
            fn = P.render_u8 if as_u8 else P.render_linear
            cfg = P.RenderConfig(accel="flat", **kw)
        else:
            spec = tscenes.load(name)
            fn = T.render_u8 if as_u8 else T.render_linear
            cfg = T.RenderConfig(device="cpu", **kw)
        _cache[key] = fn(spec.scene, spec.camera, size, spec.background, cfg)
    return _cache[key]


def assert_images_close(ours, ref):
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert (diff > 1e-4).mean() < 0.01, f"{(diff > 1e-4).mean():.3%} pixels off"
    assert diff.max() < 2e-2, diff.max()


def assert_self_golden_rule(ours, ref):
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    frac = (diff > 2).any(axis=-1).mean()
    assert frac < 1e-3, f"{frac:.2%} pixels differ (max {diff.max()})"


@pytest.mark.parametrize("name", ["simple", "big-scene"])
def test_render_linear_matches_jax(name):
    assert_images_close(_render("port", name), _render("jax", name))


@pytest.mark.parametrize("name", ["simple", "big-scene", "four-shapes"])
def test_render_u8_matches_self_golden_and_jax(name):
    ours = _render("port", name, as_u8=True)
    assert ours.dtype == np.uint8
    assert_self_golden_rule(ours, image_io.read_png(os.path.join(GOLDEN, f"{name}.png")))
    assert_self_golden_rule(ours, _render("jax", name, as_u8=True))


def test_region_rerender_keeps_the_rest(tmp_path):
    spec = tscenes.load("simple")
    cfg = T.RenderConfig(device="cpu", samples=2, tile=(32, 32), seed=0)
    full = T.render_u8(spec.scene, spec.camera, (64, 64), spec.background, cfg)
    path = str(tmp_path / "prev.png")
    prev = np.full((64, 64, 3), 7, np.uint8)
    image_io.write_png(path, prev)
    img = T.Image(path, 64, 64)
    np.testing.assert_array_equal(img.buffer, prev)
    region = ((10, 5), (40, 30))
    img.slice_render(region[0], region[1], spec.scene, spec.camera, spec.background, cfg)
    inside = (slice(5, 31), slice(10, 41))
    np.testing.assert_array_equal(img.buffer[inside], full[inside])
    outside = np.ones((64, 64), bool)
    outside[inside] = False
    assert (img.buffer[outside] == 7).all()
    img.save()
    np.testing.assert_array_equal(image_io.read_png(path), img.buffer)


def test_samples_env(monkeypatch):
    monkeypatch.setenv("SAMPLES", "3")
    assert T.RenderConfig(device="cpu").resolved_samples() == 3
    assert T.RenderConfig(device="cpu", samples=5).resolved_samples() == 5
    for bad in ("0", "-2", "x"):
        monkeypatch.setenv("SAMPLES", bad)
        assert T.RenderConfig(device="cpu").resolved_samples() == 100
    monkeypatch.setenv("SAMPLES", "2")
    spec = tscenes.load("simple")
    env = T.render_linear(spec.scene, spec.camera, (24, 24), spec.background,
                          T.RenderConfig(device="cpu", tile=(16, 16)))
    explicit = T.render_linear(spec.scene, spec.camera, (24, 24), spec.background,
                               T.RenderConfig(device="cpu", tile=(16, 16), samples=2))
    np.testing.assert_array_equal(env, explicit)


def test_odd_frame_70x33():
    """A frame that no tile divides: same image as the JAX package, and the
    flat oracle and the sweep give the same render."""
    kw = dict(size=(70, 33), samples=2, tile=(32, 32))
    ours = _render("port", "simple", **kw)
    assert ours.shape == (33, 70, 3)
    assert_images_close(ours, _render("jax", "simple", **kw))
    flat = _render("port", "simple", accel="flat", **kw)
    np.testing.assert_allclose(ours, flat, atol=1e-6)


def test_config_needs_a_device_and_a_known_accel():
    """A render without a config runs on the card: with no card it raises
    rather than fall back to the CPU."""
    with pytest.raises(ValueError):
        T.RenderConfig(device="cpu", accel="pallas")
    if not torch.cuda.is_available():
        spec = tscenes.load("simple")
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            T.render_u8(spec.scene, spec.camera, (8, 8), spec.background)


def test_config_defaults_to_the_card():
    """RenderConfig() names cuda; a caller asks for the CPU by name."""
    assert T.RenderConfig().device.type == "cuda"
    assert T.RenderConfig(device="cpu").device == torch.device("cpu")
    assert T.RenderConfig(samples=3).device.type == "cuda"


def test_png_io_against_pil():
    from PIL import Image as PILImage

    for name in ("simple", "big-scene"):
        path = os.path.join(GOLDEN, f"{name}.png")
        np.testing.assert_array_equal(image_io.read_png(path),
                                      np.asarray(PILImage.open(path).convert("RGB")))
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    import io

    np.testing.assert_array_equal(
        np.asarray(PILImage.open(io.BytesIO(image_io.encode_png(rgb)))), rgb)
    np.testing.assert_array_equal(image_io.decode_png(image_io.encode_png(rgb)), rgb)
    # Every filter type, as PIL's encoder may pick them per row.
    buf = io.BytesIO()
    big = np.random.default_rng(1).integers(0, 256, (40, 33, 3), dtype=np.uint8)
    big[:, :16] = np.arange(16)[None, :, None] * 9
    PILImage.fromarray(big).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(image_io.decode_png(buf.getvalue()), big)


def test_port_imports_no_jax():
    """`import portrayer_tpu_torch`, a CPU render of each of its scenes and
    of the textured and area-lit stand-ins of tests/_torch_jax.py (which
    chip_smoke.py imports on the card) and a gradient through trace leave
    JAX, flax, PIL and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "import portrayer_tpu_torch as T\n"
        "from portrayer_tpu_torch import scenes\n"
        "assert len(scenes.names()) == 7, scenes.names()\n"
        "for name in scenes.names():\n"
        "    s = scenes.load(name)\n"
        "    T.render_u8(s.scene, s.camera, (12, 8), s.background,\n"
        "                T.RenderConfig(device='cpu', samples=1))\n"
        "sys.path.insert(0, 'tests')\n"
        "from _torch_jax import INLINE\n"
        "for name in ('normal-mapping-numpy', 'soft-shadows-icosphere'):\n"
        "    scene, cam, _ = INLINE[name](T)\n"
        "    T.render_u8(scene, cam, (12, 8), cfg=T.RenderConfig(device='cpu', samples=1))\n"
        "import torch\n"
        "from portrayer_tpu_torch import rng\n"
        "from portrayer_tpu_torch.ops.trace import trace\n"
        "st = T.flatten_scene(scenes.load('simple').scene, 'cpu')\n"
        "x = st.mat_diffuse.clone().requires_grad_()\n"
        "o = torch.zeros(4, 3); d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)\n"
        "pix = torch.arange(4, dtype=torch.int32)\n"
        "acc = trace(rng.PRNGKey(0), o, d, pix, torch.zeros(4, 3), 4, st.replace(mat_diffuse=x),\n"
        "            T.RenderConfig(device='cpu', soft_visibility=0.05))\n"
        "acc.sum().backward()\n"
        "assert x.grad.abs().sum() > 0\n"
        "bad = [m for m in ('jax', 'flax', 'PIL', 'portrayer_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
